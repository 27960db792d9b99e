"""The port's gradients against the JAX package's: the transpose CSR,
``GatherSegmentSum``'s backward (the plain version on the CPU) against the
VJP of ``make_gather_segment_sum``, and ``rgcn_layer_segment``'s gradients.

Tolerance as in test_torch_parity.py: rtol 2e-4, and atol 2e-5 times each
tensor's largest magnitude (the two packages sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.data.graph import build_rel_graph as j_build
from primekg_rgcn_tpu.ops.rgcn_segment import make_gather_segment_sum
from primekg_rgcn_tpu.ops.rgcn_segment import rgcn_layer_segment as j_layer
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph as p_build
from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as pss
from primekg_rgcn_tpu_torch.ops.rgcn_segment import rgcn_layer_segment


def assert_close(ours, expected):
    ours, expected = np.asarray(ours), np.asarray(expected)
    scale = max(float(np.abs(expected).max()), 1e-30) if expected.size else 1.0
    np.testing.assert_allclose(ours, expected, rtol=2e-4, atol=2e-5 * scale)


@pytest.mark.parametrize("pad", [32, 512])
@pytest.mark.parametrize("norm", ["dense", "edge"])
def test_transpose_csr_covers_t_src(pad, norm):
    rng = np.random.default_rng(pad)
    n, r, e = 70, 3, 900
    # Directed edges with a skew, so the transpose differs from the forward.
    src = rng.integers(0, n // 3, e)
    dst = rng.integers(0, n, e)
    rel = rng.integers(0, r, e)
    g = p_build(src, dst, rel, n, r, bucket_pad_multiple=pad, norm=norm)
    assert g.t_rowptr.shape == (r, n + 2) and g.t_rowptr.dtype == torch.int32
    t_src = g.t_src.numpy()
    asymmetric = False
    for b in range(r):
        s, end = g.bucket_slice(b)
        tr = g.t_rowptr[b].numpy()
        assert tr[0] == 0 and tr[-1] == end - s
        assert np.all(np.diff(tr) >= 0)
        rows = np.repeat(np.arange(n + 1), np.diff(tr))
        np.testing.assert_array_equal(rows, t_src[s:end])
        # Row N collects the padding and nothing else.
        real = int((g.src[s:end] < n).sum())
        assert tr[n] == real
        asymmetric |= not np.array_equal(tr, g.rowptr[b].numpy())
    assert asymmetric
    moved = g.to("cpu")
    assert torch.equal(moved.t_rowptr, g.t_rowptr)


def _bucket(kind, seed, e=600, n=120):
    """One bucket's forward (dst-sorted) and transpose (src-sorted) arrays."""
    rng = np.random.default_rng(seed)
    if kind == "random":            # directed, non-symmetric
        src = rng.integers(0, n // 2, e)
        dst = rng.integers(0, n, e)
    elif kind == "giant_row":       # one destination and one source take most
        src = np.where(rng.random(e) < 0.7, 5, rng.integers(0, n, e))
        dst = np.where(rng.random(e) < 0.7, n - 7, rng.integers(0, n, e))
    else:                           # "empty_rows": most rows have no edge
        e = 40
        src = rng.integers(0, n, e) // 10 * 10
        dst = rng.integers(0, n, e) // 10 * 10 + 3
    order = np.argsort(dst, kind="stable")
    src, dst = src[order].astype(np.int32), dst[order].astype(np.int32)
    t_order = np.argsort(src, kind="stable")
    t_src, t_dst = src[t_order], dst[t_order]
    scale = rng.random(e).astype(np.float32)
    rows = np.arange(n + 2)
    return dict(n=n, src=src, dst=dst, t_src=t_src, t_dst=t_dst,
                scale=scale, t_scale=scale[t_order],
                rowptr=np.searchsorted(dst, rows).astype(np.int32),
                t_rowptr=np.searchsorted(t_src, rows).astype(np.int32))


@pytest.mark.parametrize("kind,scaled,d,impl", [
    ("random", False, 16, "xla"),
    ("random", True, 16, "xla"),
    ("giant_row", False, 8, "xla"),
    ("giant_row", True, 24, "xla"),
    ("empty_rows", True, 16, "xla"),
    ("random", True, 64, "pallas"),
])
def test_segment_sum_gradient_matches_jax_vjp(kind, scaled, d, impl):
    b = _bucket(kind, seed=d + scaled, e=512 if impl == "pallas" else 600)
    n = b["n"]
    rng = np.random.default_rng(d)
    x = rng.standard_normal((n + 1, d)).astype(np.float32)
    g = rng.standard_normal((n + 1, d)).astype(np.float32)
    scale = b["scale"] if scaled else None
    t_scale = b["t_scale"] if scaled else None

    f = make_gather_segment_sum(
        b["src"], b["dst"], b["t_src"], b["t_dst"], n + 1, impl=impl,
        scale=None if scale is None else jnp.asarray(scale),
        t_scale=None if t_scale is None else jnp.asarray(t_scale))
    out_j, vjp = jax.vjp(f, jnp.asarray(x))
    (gx_j,) = vjp(jnp.asarray(g))

    t = lambda a: None if a is None else torch.from_numpy(a)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = pss.GatherSegmentSum.apply(
        xt, (t(b["src"]), t(b["rowptr"]), t(scale)),
        (t(b["t_dst"]), t(b["t_rowptr"]), t(t_scale)))
    out.backward(torch.from_numpy(g))
    assert_close(out.detach().numpy(), out_j)
    assert_close(xt.grad.numpy(), gx_j)
    if kind == "empty_rows":
        # Sources with no out-edge get an exact zero gradient.
        no_out = np.diff(b["t_rowptr"])[: n + 1] == 0
        assert no_out.sum() > n // 2
        assert not xt.grad.numpy()[no_out].any()


def test_function_refuses_a_scale_that_requires_grad():
    b = _bucket("random", seed=1)
    x = torch.ones(b["n"] + 1, 4, requires_grad=True)
    scale = torch.from_numpy(b["scale"]).requires_grad_(True)
    fwd = (torch.from_numpy(b["src"]), torch.from_numpy(b["rowptr"]), scale)
    bwd = (torch.from_numpy(b["t_dst"]), torch.from_numpy(b["t_rowptr"]),
           torch.from_numpy(b["t_scale"]))
    with pytest.raises(ValueError, match="scale"):
        pss.GatherSegmentSum.apply(x, fwd, bwd)
    with pytest.raises(ValueError, match="scale"):
        pss.gather_segment_sum(x.detach(), *fwd)
    # The bare wrapper records no gradient: it sends the caller to the
    # Function instead of dropping the gradient silently.
    with pytest.raises(ValueError, match="GatherSegmentSum"):
        pss.gather_segment_sum(x, fwd[0], fwd[1])


def _layer_inputs(seed, din, dout, bases):
    rng = np.random.default_rng(seed)
    n, r, e = 50, 3, 400
    src = rng.integers(0, n // 2, e)       # directed: transpose != forward
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
    cot = rng.standard_normal((n, dout)).astype(np.float32)
    return src, dst, rel, n, r, x, params, cot


@pytest.mark.parametrize("norm", ["dense", "edge"])
@pytest.mark.parametrize("bases", [False, True])
@pytest.mark.parametrize("din,dout", [(16, 24), (24, 16)])
def test_layer_gradients_match_jax(norm, bases, din, dout):
    src, dst, rel, n, r, x, params, cot = _layer_inputs(
        din * 5 + dout + bases, din, dout, bases)
    jg = j_build(src, dst, rel, n, r, bucket_pad_multiple=32, norm=norm,
                 use_native="never")
    pg = p_build(src, dst, rel, n, r, bucket_pad_multiple=32, norm=norm)

    def j_loss(p, xx):
        return jnp.sum(j_layer(p, xx, jg, impl="xla") * jnp.asarray(cot))

    gp_j, gx_j = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))

    tparams = {k: torch.from_numpy(v).requires_grad_(True)
               for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    (rgcn_layer_segment(tparams, xt, pg) * torch.from_numpy(cot)).sum().backward()
    assert_close(xt.grad.numpy(), gx_j)
    for k in params:
        assert_close(tparams[k].grad.numpy(), gp_j[k])
