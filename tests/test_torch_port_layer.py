"""The port's relation-typed convolution against the JAX package's
``rgcn_layer_segment`` (XLA on the CPU) and against the port's own dense
oracle, on tiny_graph-sized inputs. Tolerances as in test_torch_parity.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.data.graph import build_rel_graph as j_build
from primekg_rgcn_tpu.ops.rgcn_segment import rgcn_layer_segment as j_layer
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph as p_build
from primekg_rgcn_tpu_torch.ops.rgcn_dense import rgcn_layer_dense
from primekg_rgcn_tpu_torch.ops.rgcn_segment import (build_layer_agg_ops,
                                                     rgcn_layer_segment)


def _inputs(seed, din, dout, bases):
    rng = np.random.default_rng(seed)
    n, r, e = 50, 3, 400
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    rel = rng.integers(0, r, e)
    x = rng.standard_normal((n, din)).astype(np.float32)
    params = {
        "w_root": rng.standard_normal((din, dout)).astype(np.float32) * 0.1,
        "bias": rng.standard_normal(dout).astype(np.float32) * 0.1,
    }
    if bases:
        params["basis"] = rng.standard_normal((2, din, dout)).astype(np.float32) * 0.1
        params["coef"] = rng.standard_normal((r, 2)).astype(np.float32)
    else:
        params["w_rel"] = rng.standard_normal((r, din, dout)).astype(np.float32) * 0.1
    return src, dst, rel, n, r, x, params


@pytest.mark.parametrize("norm", ["dense", "edge"])
@pytest.mark.parametrize("bases", [False, True])
@pytest.mark.parametrize("din,dout", [(16, 24), (24, 16)])
def test_layer_matches_jax_and_dense_oracle(norm, bases, din, dout):
    src, dst, rel, n, r, x, params = _inputs(din * 7 + dout, din, dout, bases)
    jg = j_build(src, dst, rel, n, r, bucket_pad_multiple=32, norm=norm,
                 use_native="never")
    pg = p_build(src, dst, rel, n, r, bucket_pad_multiple=32, norm=norm)
    expected = np.asarray(j_layer({k: jnp.asarray(v) for k, v in params.items()},
                                  jnp.asarray(x), jg, impl="auto"))

    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    ours = rgcn_layer_segment(tparams, torch.from_numpy(x), pg)
    np.testing.assert_allclose(ours.numpy(), expected, rtol=2e-4, atol=2e-5)

    oracle = rgcn_layer_dense(tparams, torch.from_numpy(x),
                              torch.from_numpy(src), torch.from_numpy(dst),
                              torch.from_numpy(rel), n, r)
    np.testing.assert_allclose(ours.numpy(), oracle.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_prebuilt_agg_ops_slice_the_graph():
    src, dst, rel, n, r, x, params = _inputs(11, 8, 8, False)
    pg = p_build(src, dst, rel, n, r, bucket_pad_multiple=32, norm="edge")
    ops = build_layer_agg_ops(pg)
    assert len(ops) == r
    for i, op in enumerate(ops):
        s, e = pg.bucket_slice(i)
        assert torch.equal(op.src, pg.src[s:e])
        assert torch.equal(op.scale, pg.edge_scale[s:e])
        assert torch.equal(op.rowptr, pg.rowptr[i])
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    a = rgcn_layer_segment(tparams, torch.from_numpy(x), pg, agg_ops=ops)
    b = rgcn_layer_segment(tparams, torch.from_numpy(x), pg)
    assert torch.equal(a, b)
