"""The plain version of the port's gather + segment-sum kernel against the
JAX package's row gather + Pallas sorted segment-sum (interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.ops.pallas.segment_sum import sorted_segment_sum_pallas
from primekg_rgcn_tpu_torch.ops.cuda import build
from primekg_rgcn_tpu_torch.ops.cuda import dense_segment_sum as pds
from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as pss


def _case(e, d, kind, seed):
    """x [rows, D] with a zero last row, dst-sorted (src, dst), scale."""
    rng = np.random.default_rng(seed)
    n = 300
    x = rng.standard_normal((n + 1, d)).astype(np.float32)
    x[n] = 0.0
    if kind == "random":
        dst = np.sort(rng.integers(0, n + 1, e))
    elif kind == "giant_run":
        # Positive rows: a sum of 1024 signed terms can cancel to near zero,
        # where the two summation orders' rounding exceeds any atol.
        x[:n] = rng.random((n, d), dtype=np.float32)
        dst = np.full(e, n - 1)
    else:  # every edge into a distinct row
        n = 3 * e
        x = rng.standard_normal((n + 1, d)).astype(np.float32)
        x[n] = 0.0
        dst = np.arange(e) * 3
    src = rng.integers(0, n + 1, e)
    scale = rng.random(e).astype(np.float32)
    rowptr = np.searchsorted(dst, np.arange(n + 2))
    return x, src.astype(np.int32), dst.astype(np.int32), rowptr, scale, n + 1


def _jax_ref(x, src, dst, scale, s):
    msg = jnp.take(jnp.asarray(x), jnp.asarray(src), axis=0)
    if scale is not None:
        msg = msg * jnp.asarray(scale)[:, None]
    return np.asarray(sorted_segment_sum_pallas(
        msg, jnp.asarray(dst), dst, s, interpret=True))


@pytest.mark.parametrize("e,d,kind,scaled", [
    (512, 64, "random", False),
    (1024, 64, "random", True),
    (512, 128, "random", True),
    (1024, 128, "random", False),
    (1024, 128, "giant_run", False),
    (512, 64, "distinct", True),
])
def test_plain_matches_jax_gather_and_pallas_segment_sum(e, d, kind, scaled):
    x, src, dst, rowptr, scale, s = _case(e, d, kind, seed=e + d)
    scale = scale if scaled else None
    ref = _jax_ref(x, src, dst, scale, s)
    out = pss.gather_segment_sum_plain(
        torch.from_numpy(x), torch.from_numpy(src),
        torch.from_numpy(rowptr.astype(np.int32)),
        None if scale is None else torch.from_numpy(scale))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    x, src, dst, rowptr, scale, s = _case(512, 8, "random", seed=7)
    args = (torch.from_numpy(x), torch.from_numpy(src),
            torch.from_numpy(rowptr.astype(np.int32)), torch.from_numpy(scale))
    before = pss.gather_segment_sum.launches
    out = pss.gather_segment_sum(*args)
    assert pss.gather_segment_sum.launches == before
    assert torch.equal(out, pss.gather_segment_sum_plain(*args))
    assert out.shape == (s, 8)


def test_wrapper_validates_inputs():
    x = torch.zeros(5, 4)
    src = torch.zeros(3, dtype=torch.int32)
    rowptr = torch.tensor([0, 1, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="x must be float32"):
        pss.gather_segment_sum(x.double(), src, rowptr)
    with pytest.raises(ValueError, match="src must be int32"):
        pss.gather_segment_sum(x, src.long(), rowptr)
    with pytest.raises(ValueError, match="rowptr must be int32"):
        pss.gather_segment_sum(x, src, rowptr.long())
    with pytest.raises(ValueError, match="scale must be float32"):
        pss.gather_segment_sum(x, src, rowptr, torch.ones(2))
    with pytest.raises(ValueError, match="contiguous"):
        pss.gather_segment_sum(torch.zeros(4, 5).T, src, rowptr)


@pytest.mark.parametrize("rowptr", [[1, 1, 3], [0, 1, 2], [0, 2, 4]])
def test_wrapper_rejects_csr_that_does_not_cover_src(rowptr):
    x = torch.zeros(5, 4)
    src = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="rowptr must run from 0"):
        pss.gather_segment_sum(x, src, torch.tensor(rowptr, dtype=torch.int32))


@pytest.mark.parametrize("d,vec", [(128, 4), (256, 4), (64, 4), (96, 4),
                                   (8, 4), (6, 2), (1, 1), (3, 1)])
def test_vector_width(d, vec):
    # B2's float32 rows: 16 bytes a lane wherever D % 4 == 0.
    t = torch.zeros(4, d)
    assert pds.b2_width(d, t)[0] == vec


@pytest.mark.parametrize("d,offset,vec,lanes", [
    (128, 0, 4, 32),   # one row per warp load, 16 bytes a lane
    (64, 0, 4, 16),    # two rows per warp load, a half-warp each
    (96, 0, 4, 32),    # 24 vectors: lanes 24-31 idle
    (256, 0, 4, 32),   # 64 vectors: two column chunks
    (8, 0, 4, 2),
    (4, 0, 4, 1),
    (6, 0, 2, 4),
    (3, 0, 1, 4),
    (1, 0, 1, 1),
    (128, 1, 1, 32),   # a table 4 bytes off: float loads
    (128, 2, 2, 32),   # 8 bytes off: float2 loads
    (64, 2, 2, 32),
])
def test_b1_width(d, offset, vec, lanes):
    table = torch.zeros(4 * d + offset)[offset:].view(4, d)
    assert pss.b1_width(d, table, torch.zeros(4, d)) == (vec, lanes)


def test_b1_width_leaves_the_shared_helper_alone():
    # B1 and B2 pick their float32 widths each for itself; at D = 64 both
    # read two rows per warp load, 16 bytes a lane.
    t = torch.zeros(4, 64)
    assert pds.b2_width(64, t) == pss.b1_width(64, t) == (4, 16)


@pytest.mark.parametrize("s,e,sms,per_piece,pieces", [
    # The main path's buckets on 132 SMs: 4,224 warps fill one wave.
    (30927, 102912, 132, 32, 4183),
    (30927, 322048, 132, 84, 4203),
    (30927, 1284608, 132, 312, 4217),
    # Small CSRs keep pieces of 32 items.
    (3, 5, 132, 32, 1),
    (50, 0, 132, 32, 2),
    (1, 200000, 132, 48, 4167),
    (1000, 201000, 2, 3157, 64),
])
def test_piece_plan(s, e, sms, per_piece, pieces):
    assert pss.piece_plan(s, e, sms) == (per_piece, pieces)


@pytest.mark.parametrize("s,e,sms", [(30927, 1284608, 132), (7, 0, 132),
                                     (1, 1, 1), (4000, 124000, 132),
                                     (12345, 678901, 114)])
def test_piece_plan_covers_the_items_once(s, e, sms):
    per_piece, pieces = pss.piece_plan(s, e, sms)
    assert per_piece >= pss.MIN_ITEMS_PER_PIECE
    # The last piece holds between 1 and per_piece items.
    assert (pieces - 1) * per_piece < s + e <= pieces * per_piece
    assert pieces <= max(sms * pss.WAVE_WARPS_PER_SM,
                         -(-(s + e) // pss.MIN_ITEMS_PER_PIECE))


@pytest.mark.parametrize("pieces,d", [(4217, 128), (4183, 64), (1, 3),
                                      (2, 1)])
def test_carry_scratch(pieces, d):
    carry, carry_row = pss.carry_scratch(pieces, d, "cpu")
    assert carry.shape == (pieces, d) and carry.dtype == torch.float32
    assert carry_row.shape == (pieces,) and carry_row.dtype == torch.int32
    assert carry.is_contiguous() and carry_row.is_contiguous()
    # One allocation: the row ids follow the carries, without overlap.
    assert carry_row.data_ptr() == carry.data_ptr() + pieces * d * 4
    assert carry.untyped_storage().data_ptr() == \
        carry_row.untyped_storage().data_ptr()
    # Each carry row is aligned to the kernel's widest load at its D.
    vec, _ = pss.b1_width(d, carry)
    assert all(carry[i].data_ptr() % (4 * vec) == 0
               for i in range(min(pieces, 3)))


def test_library_is_keyed_by_source():
    path = pss.LIBRARY.library_path()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libgather_segment_sum_")
    assert pss.LIBRARY.source.exists()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
