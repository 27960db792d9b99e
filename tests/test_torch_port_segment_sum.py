"""The plain version of the port's gather + segment-sum kernel against the
JAX package's row gather + Pallas sorted segment-sum (interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.ops.pallas.segment_sum import sorted_segment_sum_pallas
from primekg_rgcn_tpu_torch.ops.cuda import build
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


@pytest.mark.parametrize("d,vec", [(128, 4), (256, 4), (64, 2), (96, 2),
                                   (8, 4), (6, 2), (1, 1), (3, 1)])
def test_vector_width(d, vec):
    t = torch.zeros(4, d)
    assert build.vec_width(d, t) == vec


def test_library_is_keyed_by_source():
    path = pss.LIBRARY.library_path()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libgather_segment_sum_")
    assert pss.LIBRARY.source.exists()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
