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


# -- the options of the stacked relation transform -----------------------------

OPTIONS = {
    "none": set(),
    "strided": {"strided"},
    "row_scale": {"row_scale"},
    "seg_scale": {"seg_scale"},
    "strided_seg_scale": {"strided", "seg_scale"},
    "edge_scale_seg": {"scale", "seg_scale"},
    "all": {"strided", "row_scale", "seg_scale"},
}


def _dyadic(rng, shape, top=7):
    """Multiples of 1/8 in [0, top / 8]: every sum and product below is
    exact in float32, and each value exact in bf16."""
    return (rng.integers(0, top + 1, shape) / 8).astype(np.float32)


def _options_case(kind, opts, seed, d=8):
    """(x, src, rowptr, kwargs) of one CSR shape with the options
    ``opts``: x a column block of a [rows, 3D] buffer when strided, scales
    dyadic, seg_scale powers of two."""
    rng = np.random.default_rng(seed)
    rows = 60
    if kind == "long_row":   # one row across many pieces
        dst = np.sort(np.concatenate([rng.integers(0, 40, 100),
                                      np.full(700, 17)]))
        s = 40
    elif kind == "drifting":  # rows one item longer than a piece
        dst, s = np.repeat(np.arange(30), 9), 30
    elif kind == "empty_rows":
        dst, s = np.sort(rng.integers(0, 200, 150)), 200
    else:  # "random"
        dst, s = np.sort(rng.integers(0, 50, 400)), 50
    src = rng.integers(0, rows, dst.shape[0]).astype(np.int32)
    rowptr = np.searchsorted(dst, np.arange(s + 1)).astype(np.int32)
    wide = _dyadic(rng, (rows, 3 * d))
    x = torch.from_numpy(wide)
    x = x[:, d:2 * d] if "strided" in opts else x[:, :d].contiguous()
    kw = {}
    if "scale" in opts:
        kw["scale"] = torch.from_numpy(_dyadic(rng, dst.shape[0], 8))
    if "row_scale" in opts:
        kw["row_scale"] = torch.from_numpy(_dyadic(rng, rows, 8))
    if "seg_scale" in opts:
        kw["seg_scale"] = torch.from_numpy(
            2.0 ** rng.integers(-2, 2, s).astype(np.float32))
    return x, torch.from_numpy(src), torch.from_numpy(rowptr), kw


def _direct(x, src, rowptr, kw):
    """The options written out directly, in float64: index_add_ of the
    weighted rows, times seg_scale."""
    s = rowptr.shape[0] - 1
    dst = torch.repeat_interleave(torch.arange(s),
                                  torch.diff(rowptr).long())
    w = torch.ones(src.shape[0], dtype=torch.float64)
    if kw.get("scale") is not None:
        w = kw["scale"].double()
    if kw.get("row_scale") is not None:
        w = kw["row_scale"].double()[src.long()]
    total = torch.zeros(s, x.shape[1], dtype=torch.float64).index_add_(
        0, dst, x.double()[src.long()] * w[:, None])
    if kw.get("seg_scale") is not None:
        total = total * kw["seg_scale"].double()[:, None]
    return total


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("opts", list(OPTIONS))
@pytest.mark.parametrize("kind", ["long_row", "random"])
def test_plain_options_match_a_direct_formulation(kind, opts, dtype):
    x, src, rowptr, kw = _options_case(kind, OPTIONS[opts], seed=3)
    x = x.to(dtype)
    wide_out = torch.full((rowptr.shape[0] - 1, 3 * x.shape[1]), -1.0)
    out = wide_out[:, x.shape[1]:2 * x.shape[1]]
    got = pss.gather_segment_sum(x, src, rowptr, **kw, out=out)
    assert got.data_ptr() == out.data_ptr()
    # Exact inputs: the float32 result is the float64 one, bit for bit.
    assert torch.equal(got.double(), _direct(x.float(), src, rowptr, kw))
    # The columns outside the block are left alone.
    assert (wide_out[:, :x.shape[1]] == -1).all()
    assert (wide_out[:, 2 * x.shape[1]:] == -1).all()
    assert torch.equal(pss.gather_segment_sum(x, src, rowptr, **kw), got)


def test_plain_options_on_random_inputs():
    rng = np.random.default_rng(4)
    x, src, rowptr, kw = _options_case("random", OPTIONS["all"], 4)
    x = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    got = pss.gather_segment_sum(x, src, rowptr, **kw)
    np.testing.assert_allclose(got.numpy(),
                               _direct(x, src, rowptr, kw).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_wrapper_validates_the_options():
    x = torch.zeros(5, 4)
    src = torch.zeros(3, dtype=torch.int32)
    rowptr = torch.tensor([0, 1, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="not both"):
        pss.gather_segment_sum(x, src, rowptr, torch.ones(3),
                               row_scale=torch.ones(5))
    with pytest.raises(ValueError, match="row_scale must be float32"):
        pss.gather_segment_sum(x, src, rowptr, row_scale=torch.ones(3))
    with pytest.raises(ValueError, match="seg_scale must be float32"):
        pss.gather_segment_sum(x, src, rowptr, seg_scale=torch.ones(5))
    with pytest.raises(ValueError, match="out must be float32"):
        pss.gather_segment_sum(x, src, rowptr, out=torch.zeros(3, 4))
    with pytest.raises(ValueError, match="out must have contiguous rows"):
        pss.gather_segment_sum(x, src, rowptr, out=torch.zeros(4, 2).T)
    with pytest.raises(ValueError, match="must not require a gradient"):
        pss.gather_segment_sum(x, src, rowptr,
                               seg_scale=torch.ones(2, requires_grad=True))
    # A column block of a wider buffer is a table of contiguous rows.
    wide = torch.arange(40.0).view(5, 8)
    assert torch.equal(pss.gather_segment_sum(wide[:, 4:], src, rowptr),
                       pss.gather_segment_sum(wide[:, 4:].contiguous(), src,
                                              rowptr))
    # The kernel takes row strides in int32 and offsets rows in int64: a
    # block of a buffer of 2**32 elements passes the checks (and a meta
    # tensor then stops at the device), a row stride of 2**31 does not.
    meta = dict(device="meta")
    src_m, rowptr_m = src.to(**meta), rowptr.to(**meta)
    with pytest.raises(ValueError, match="unsupported device meta"):
        pss.gather_segment_sum(torch.empty(2 ** 16, 2 ** 16, **meta)[:, :4],
                               src_m, rowptr_m)
    with pytest.raises(ValueError, match="beyond int32"):
        pss.gather_segment_sum(torch.empty(5, 2 ** 31, **meta)[:, :4],
                               src_m, rowptr_m)


def test_b1_width_reads_row_strides():
    # A 64-wide block of a 192-wide buffer keeps 16-byte loads; a 6-wide
    # block of a 10-wide one (8-byte rows apart) takes float2.
    wide = torch.zeros(4, 192)
    assert pss.b1_width(64, wide[:, 64:128]) == (4, 16)
    assert pss.b1_width(6, torch.zeros(4, 10)[:, 4:]) == (2, 4)


# -- the kernel's algorithm with the options, in numpy --------------------------


def emulate_b1(x, src, rowptr, per_piece, scale=None, row_scale=None,
               seg_scale=None):
    """``csrc/gather_segment_sum.cu`` with its options, step for step, in
    float32: the merge path's pieces of ``per_piece`` items one after
    another (rows closed as their ends are reached, scaled unless they began
    in an earlier piece; the carry of the row a piece ends in), then the
    fix-up (each run of carries added in piece order to what the row's last
    piece stored, then scaled). Returns the output and how often each row's
    final value was stored."""
    x = x.float().numpy()
    src, rowptr = src.numpy(), rowptr.numpy()
    s, e, d = rowptr.shape[0] - 1, src.shape[0], x.shape[1]
    out = np.full((s, d), np.nan, np.float32)
    finished = np.zeros(s, np.int64)
    pieces = -(-(s + e) // per_piece)
    carry = np.full((pieces, d), np.nan, np.float32)
    carry_row = np.full(pieces, -2)

    def rows_before(diag):  # the least i with rowptr[i + 1] + i >= diag
        lo, hi = max(0, diag - e), min(diag, s)
        while lo < hi:
            mid = (lo + hi) // 2
            if rowptr[mid + 1] + mid >= diag:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def scaled(row, v):
        return v if seg_scale is None else v * np.float32(seg_scale[row])

    for p in range(pieces):
        d0, d1 = p * per_piece, min((p + 1) * per_piece, s + e)
        r0, r1 = rows_before(d0), rows_before(d1)
        e0, e1 = d0 - r0, d1 - r1
        carried = rowptr[r0] < e0
        state = {"row": r0, "open": e0, "acc": np.zeros(d, np.float32)}

        def close(consumed):
            while state["row"] < r1 and rowptr[state["row"] + 1] == consumed:
                row = state["row"]
                if row == r0 and carried:
                    out[row] = state["acc"]
                else:
                    out[row] = scaled(row, state["acc"])
                    finished[row] += 1
                state["acc"] = np.zeros(d, np.float32)
                state["open"] = consumed
                state["row"] += 1

        close(e0)
        for j in range(e0, e1):
            w = (scale[j] if scale is not None else
                 row_scale[src[j]] if row_scale is not None else 1.0)
            state["acc"] = state["acc"] + np.float32(w) * x[src[j]]
            close(j + 1)
        has_carry = r1 < s and e1 > state["open"]
        carry_row[p] = r1 if has_carry else -1
        if has_carry:
            carry[p] = state["acc"]
    for p in range(pieces):
        row = carry_row[p]
        if row < 0 or (p > 0 and carry_row[p - 1] == row):
            continue
        count = 0
        while p + count < pieces and carry_row[p + count] == row:
            count += 1
        total = np.zeros(d, np.float32)
        for c in carry[p:p + count]:
            total = total + c
        assert not np.isnan(out[row]).any(), "a part the kernel never stored"
        out[row] = scaled(row, out[row] + total)
        finished[row] += 1
    return out, finished


@pytest.mark.parametrize("per_piece", [4, 9, 32])
@pytest.mark.parametrize("opts", ["none", "row_scale", "seg_scale",
                                  "edge_scale_seg", "all"])
@pytest.mark.parametrize("kind", ["long_row", "drifting", "empty_rows"])
def test_kernel_walk_stores_each_row_once_and_equals_plain(kind, opts,
                                                           per_piece):
    x, src, rowptr, kw = _options_case(kind, OPTIONS[opts], seed=5)
    got, finished = emulate_b1(x, src, rowptr, per_piece, **{
        k: v.numpy() for k, v in kw.items()})
    # Each output row's final value stored exactly once a launch: by the
    # main kernel or, for a row that crosses pieces, by the fix-up.
    assert (finished == 1).all()
    want = pss.gather_segment_sum_plain(x, src, rowptr, **kw)
    assert torch.equal(torch.from_numpy(got), want)
