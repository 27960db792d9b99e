"""The port's relation-typed convolution against the JAX package's
``rgcn_layer_segment`` (XLA on the CPU) and against the port's own dense
oracle, on tiny_graph-sized inputs; the stacked relation transform (the
float32 aggregate-first path) against the JAX layer's values and gradients
and against the per-relation loop it replaces. Tolerances as in
test_torch_parity.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.data.graph import build_rel_graph as j_build
from primekg_rgcn_tpu.ops.rgcn_segment import rgcn_layer_segment as j_layer
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph as p_build
from primekg_rgcn_tpu_torch.ops import rgcn_segment
from primekg_rgcn_tpu_torch.ops.rgcn_dense import rgcn_layer_dense
from primekg_rgcn_tpu_torch.ops.rgcn_segment import (aggregate,
                                                     aggregate_plain,
                                                     build_layer_agg_ops,
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


def _empty_bucket_inputs(seed, din, dout, bases):
    """_inputs with relation 1 of 4 given no edge: its bucket holds padding
    alone, and the layer may be handed no operands for it (an empty bucket,
    which the stacked weights skip)."""
    src, dst, rel, n, _, x, params = _inputs(seed, din, dout, bases)
    rel = np.array([0, 2, 3])[rel]
    rng = np.random.default_rng(seed + 1)
    if bases:
        params["coef"] = rng.standard_normal((4, 2)).astype(np.float32)
    else:
        params["w_rel"] = rng.standard_normal(
            (4, din, dout)).astype(np.float32) * 0.1
    return src, dst, rel, n, 4, x, params


def _no_middle_bucket(graph):
    ops = build_layer_agg_ops(graph)
    ops[1] = None
    return ops


def _port_run(params, x, graph, gy, **kw):
    """The layer's output and the gradients of x and each parameter under
    the cotangent gy, through autograd."""
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = rgcn_layer_segment(tp, tx, graph, **kw)
    out.backward(torch.from_numpy(gy))
    return out.detach(), tx.grad, {k: v.grad for k, v in tp.items()}


def _counts():
    return rgcn_layer_segment.stacked, rgcn_layer_segment.looped


STACKED_CASES = pytest.mark.parametrize(
    "bases,norm,empty_bucket",
    [(b, n, e) for e in (False, True) for n in ("dense", "edge")
     for b in (False, True)])


@STACKED_CASES
def test_stacked_layer_matches_jax_and_the_loop(norm, bases, empty_bucket):
    _check_stacked_layer(norm, bases, empty_bucket)


@STACKED_CASES
def test_stacked_layer_in_relation_groups(norm, bases, empty_bucket,
                                          monkeypatch):
    # A stacked buffer of one relation: one transform a relation.
    monkeypatch.setattr(rgcn_segment, "MAX_STACKED", 1)
    _check_stacked_layer(norm, bases, empty_bucket)


def _check_stacked_layer(norm, bases, empty_bucket):
    """The stacked layer's output and gradients against the JAX layer and
    the per-relation loop, and two identical calls bit for bit."""
    din, dout = 16, 24
    src, dst, rel, n, r, x, params = _empty_bucket_inputs(
        din * 5 + dout + bases, din, dout, bases)
    jg = j_build(src, dst, rel, n, r, bucket_pad_multiple=32, norm=norm,
                 use_native="never")
    pg = p_build(src, dst, rel, n, r, bucket_pad_multiple=32, norm=norm)
    ops = _no_middle_bucket(pg) if empty_bucket else None
    gy = np.random.default_rng(7).standard_normal(
        (n, dout)).astype(np.float32)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    j_out, vjp = jax.vjp(lambda p, v: j_layer(p, v, jg, impl="auto"), jp,
                         jnp.asarray(x))
    j_gp, j_gx = vjp(jnp.asarray(gy))

    before = _counts()
    out, gx, gp = _port_run(params, x, pg, gy, agg_ops=ops)
    assert _counts() == (before[0] + 1, before[1])
    tol = dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **tol)
    np.testing.assert_allclose(gx.numpy(), np.asarray(j_gx), **tol)
    for k in params:
        np.testing.assert_allclose(gp[k].numpy(), np.asarray(j_gp[k]), **tol,
                                   err_msg=k)

    # The per-relation loop, through the plain version and autograd.
    before = _counts()
    l_out, l_gx, l_gp = _port_run(params, x, pg, gy, agg_ops=ops,
                                  agg_fn=aggregate_plain)
    assert _counts() == (before[0], before[1] + 1)
    np.testing.assert_allclose(out.numpy(), l_out.numpy(), **tol)
    np.testing.assert_allclose(gx.numpy(), l_gx.numpy(), **tol)
    for k in params:
        np.testing.assert_allclose(gp[k].numpy(), l_gp[k].numpy(), **tol,
                                   err_msg=k)

    # Two identical calls give the same bits, values and gradients.
    again = _port_run(params, x, pg, gy, agg_ops=ops)
    assert torch.equal(again[0], out) and torch.equal(again[1], gx)
    assert all(torch.equal(again[2][k], gp[k]) for k in params)


def test_stacked_layer_under_no_grad_saves_nothing_and_agrees():
    src, dst, rel, n, r, x, params = _empty_bucket_inputs(3, 16, 24, False)
    pg = p_build(src, dst, rel, n, r, bucket_pad_multiple=32, norm="dense")
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    ops = _no_middle_bucket(pg)
    with torch.no_grad():
        out = rgcn_layer_segment(tp, torch.from_numpy(x), pg, agg_ops=ops)
    assert out.grad_fn is None and out.dtype == torch.float32
    want = rgcn_layer_segment(tp, torch.from_numpy(x), pg, agg_ops=ops,
                              agg_fn=aggregate_plain)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("case", ["bf16", "din_above_dout", "own_agg_fn"])
def test_the_loop_takes_what_the_stacked_path_does_not(case):
    din, dout = (24, 16) if case == "din_above_dout" else (16, 24)
    src, dst, rel, n, r, x, params = _inputs(9, din, dout, False)
    pg = p_build(src, dst, rel, n, r, bucket_pad_multiple=32, norm="dense")
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    kw = {"bf16": {"compute_dtype": torch.bfloat16},
          "din_above_dout": {},
          "own_agg_fn": {"agg_fn": functools.partial(aggregate)}}[case]
    before = _counts()
    rgcn_layer_segment(tp, torch.from_numpy(x), pg, **kw)
    assert _counts() == (before[0], before[1] + 1)
