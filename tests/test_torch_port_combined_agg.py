"""The combined layer's three per-(node, relation) reductions, on the CPU,
against the JAX package: ``RowwiseRelSum`` and ``ChunkedRelApply`` (forward
and every gradient, against ``rowwise_rel_sum`` and ``chunked_rel_apply``
with their custom VJPs), ``_pick_chunks``, ``_block_aggregate_combined``
under each ``PRIMEKG_COMBINED_AGG`` value on the same JAX-sampled block
(identity and dedup), the sampler's per-row tag sort (blocks sampled for
the rowwise reduction equal JAX's field for field on the JAX draws), and
the refusal of a block sampled for the einsum.

Tolerance: float32, rtol 2e-4 and atol 2e-5 of each tensor's largest
magnitude (test_torch_parity.py); bf16, 2e-2 of it and rtol 2e-2
(test_torch_port_bf16_paths.py). Integer fields are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.data import sampling as js
from primekg_rgcn_tpu.ops.rgcn_segment import \
    materialize_relation_weights as j_materialize
from primekg_rgcn_tpu_torch.data import sampling as ps
from test_torch_port_sampling import JaxDraws, _graphs

BF16_TOL = 2e-2


def _close(ours, expected, dtype=torch.float32):
    ours = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) \
        else np.asarray(ours, np.float32)
    expected = np.asarray(expected, np.float32)
    scale = max(float(np.abs(expected).max()), 1e-30)
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(ours, expected, rtol=BF16_TOL,
                                   atol=BF16_TOL * scale)
    else:
        np.testing.assert_allclose(ours, expected, rtol=2e-4,
                                   atol=2e-5 * scale)


def _jdt(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _sorted_rows(rng, m, f, r):
    """Per-row ascending tags, some rows with one relation only, and their
    ends table (JAX's count form)."""
    rtag = np.sort(rng.integers(0, r, (m, f)), 1).astype(np.int32)
    rtag[::5] = r - 1
    ends = np.stack([(rtag <= k).sum(1) for k in range(r)], 1).astype(
        np.int32)
    return rtag, ends


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rowwise_rel_sum_matches_jax(dtype):
    rng = np.random.default_rng(0)
    m, f, d, r = 40, 9, 6, 5
    rtag, ends = _sorted_rows(rng, m, f, r)
    msg = rng.normal(size=(m, f, d)).astype(np.float32)
    g = rng.normal(size=(m, r, d)).astype(np.float32)
    jdt = _jdt(dtype)
    out_j, vjp = jax.vjp(lambda x: js.rowwise_rel_sum(
        x, jnp.asarray(rtag), jnp.asarray(ends)), jnp.asarray(msg, jdt))
    (dmsg_j,) = vjp(jnp.asarray(g, jdt))
    x = torch.from_numpy(msg).to(dtype).requires_grad_(True)
    out = ps.RowwiseRelSum.apply(x, torch.from_numpy(rtag),
                                 torch.from_numpy(ends))
    assert out.dtype == dtype and out.shape == (m, r, d)
    out.backward(torch.from_numpy(g).to(dtype))
    _close(out, out_j, dtype)
    # The backward is a gather: exact.
    np.testing.assert_array_equal(x.grad.float().numpy(),
                                  np.asarray(dmsg_j, np.float32))


@pytest.mark.parametrize("n_chunks,dtype", [
    (1, torch.float32), (3, torch.float32), (4, torch.float32),
    (2, torch.bfloat16)])
def test_chunked_rel_apply_matches_jax(n_chunks, dtype):
    """Forward and the gradients of the rows, the slot weights and the
    relation weights, at one and at several chunks."""
    rng = np.random.default_rng(n_chunks)
    m, f, d, r, h = 48, 7, 6, 5, 4
    rtag, ends = _sorted_rows(rng, m, f, r)
    rows = rng.normal(size=(m, f, d)).astype(np.float32)
    slot_w = rng.random((m, f)).astype(np.float32)
    w_all = rng.normal(size=(r, d, h)).astype(np.float32)
    g = rng.normal(size=(m, h)).astype(np.float32)
    jdt = _jdt(dtype)
    out_j, vjp = jax.vjp(
        lambda a, b, c: js.chunked_rel_apply(
            n_chunks, a, jnp.asarray(rtag), b, jnp.asarray(ends), c),
        *(jnp.asarray(t, jdt) for t in (rows, slot_w, w_all)))
    grads_j = vjp(jnp.asarray(g, jdt))
    ours = [torch.from_numpy(t).to(dtype).requires_grad_(True)
            for t in (rows, slot_w, w_all)]
    out = ps.ChunkedRelApply.apply(n_chunks, ours[0], torch.from_numpy(rtag),
                                   ours[1], torch.from_numpy(ends), ours[2])
    assert out.dtype == dtype and out.shape == (m, h)
    out.backward(torch.from_numpy(g).to(dtype))
    _close(out, out_j, dtype)
    for t, want in zip(ours, grads_j):
        assert t.grad.dtype == dtype
        _close(t.grad, want, dtype)


def test_chunked_rel_apply_equals_rowwise_then_matmul():
    """The chunked reduction is the rowwise sums times the stacked relation
    weights, whatever the chunk count."""
    rng = np.random.default_rng(9)
    m, f, d, r, h = 64, 5, 4, 3, 6
    rtag, ends = (torch.from_numpy(a) for a in _sorted_rows(rng, m, f, r))
    rows = torch.from_numpy(rng.normal(size=(m, f, d)).astype(np.float32))
    slot_w = torch.from_numpy(rng.random((m, f)).astype(np.float32))
    w_all = torch.from_numpy(rng.normal(size=(r, d, h)).astype(np.float32))
    want = ps.RowwiseRelSum.apply(rows * slot_w[..., None], rtag,
                                  ends).reshape(m, r * d) @ w_all.reshape(
                                      r * d, h)
    for nc in (1, 2, 8, 16):
        got = ps.ChunkedRelApply.apply(nc, rows, rtag, slot_w, ends, w_all)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("m", [1, 8192, 8193, 16384, 65536, 196608, 100003,
                               786432])
def test_pick_chunks_matches_jax(m):
    """The divisor rule at m with and without divisors that leave chunks of
    8,192 rows or more (100,003 is prime: one chunk)."""
    nc = ps._pick_chunks(m)
    assert nc == js._pick_chunks(m)
    assert m % nc == 0 and 1 <= nc <= 64


# -- the aggregation over a sampled block ---------------------------------------


def _port_block(jb):
    """A JAX CombinedBlock as the port's, field for field."""
    return ps.CombinedBlock(**{
        f: torch.from_numpy(np.array(v)) if isinstance(v, jax.Array) else v
        for f, v in jb._asdict().items()})


def _layer(rng, r, din, dout):
    return {"w_rel": rng.normal(0, 0.3, (r, din, dout)).astype(np.float32),
            "w_root": rng.normal(0, 0.3, (din, dout)).astype(np.float32),
            "bias": rng.normal(0, 0.1, dout).astype(np.float32)}


def _aggregate_both(monkeypatch, impl, ident, dtype=torch.float32):
    """The inner block of one batch sampled by the JAX sampler under
    ``impl``, aggregated by both packages (table or frontier rows in, a
    random cotangent back). Returns ((out, grads) port, (out, grads) JAX)."""
    monkeypatch.setenv("PRIMEKG_COMBINED_AGG", impl)
    if not ident:
        monkeypatch.setenv("PRIMEKG_IDENT_FRACTION", "1000")
    jg, _ = _graphs("sparse", seed=3)
    jc = js.build_combined_csr(jg)
    seeds = jnp.asarray(np.arange(0, 60, 3, dtype=np.int32))
    batch = js.sample_batch_combined(jax.random.PRNGKey(4), jc, seeds,
                                     (6, 5), allow_ident=True)
    jb = batch.blocks[0]
    assert bool(jb.ident) == ident and jb.tags_sorted == (impl != "einsum")
    rng = np.random.default_rng(5)
    din, dout = 8, 6
    x = rng.normal(size=(jg.num_nodes if ident else jb.m_in, din)).astype(
        np.float32)
    layer = _layer(rng, jg.num_relations, din, dout)
    g = rng.normal(size=(jb.m_out, dout)).astype(np.float32)
    cdt = _jdt(dtype) if ident else None
    x_j = jnp.asarray(x) if ident else jnp.asarray(x, _jdt(dtype))
    out_j, vjp = jax.vjp(lambda p, xi: js._block_aggregate_combined(
        p, xi, jb, j_materialize, compute_dtype=cdt),
        jax.tree_util.tree_map(jnp.asarray, layer), x_j)
    gp_j, gx_j = vjp(jnp.asarray(g, out_j.dtype))

    pb = _port_block(jb)
    lp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in layer.items()}
    xt = torch.from_numpy(x)
    xt = (xt if ident else xt.to(dtype)).requires_grad_(True)
    out = ps._block_aggregate_combined(lp, xt, pb,
                                       dtype if ident else None)
    out.backward(torch.from_numpy(g).to(out.dtype))
    return ((out, {**{k: v.grad for k, v in lp.items()}, "x": xt.grad}),
            (out_j, {**gp_j, "x": gx_j}))


@pytest.mark.parametrize("ident", [True, False])
@pytest.mark.parametrize("impl", ["einsum", "rowwise", "chunked", "scan"])
def test_block_aggregate_combined_matches_jax(impl, ident, monkeypatch):
    """Every value of PRIMEKG_COMBINED_AGG (any but einsum and rowwise is
    the chunked reduction, as in JAX), on an identity and a dedup block."""
    (out, grads), (out_j, grads_j) = _aggregate_both(monkeypatch, impl,
                                                     ident)
    _close(out, out_j)
    assert grads.keys() == grads_j.keys()
    for k in grads_j:
        _close(grads[k], grads_j[k])


@pytest.mark.parametrize("impl", ["rowwise", "chunked"])
def test_block_aggregate_combined_bf16_matches_jax(impl, monkeypatch):
    """bf16 compute on the identity block: the rows gathered from the
    float32 table and converted, the sums and transforms in bf16."""
    (out, grads), (out_j, grads_j) = _aggregate_both(
        monkeypatch, impl, True, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    _close(out, out_j, torch.bfloat16)
    for k in grads_j:
        _close(grads[k], grads_j[k], torch.bfloat16)


@pytest.mark.parametrize("mode", ["uniform", "block4", "block", "truncate"])
def test_blocks_sampled_for_rowwise_equal_jax(mode, monkeypatch):
    """Under the rowwise reduction the sampler sorts uniform and blockN rows
    by tag (stably, carrying picks and weights); both packages' blocks then
    agree field for field on the JAX draws, the tags ascending in every
    row."""
    monkeypatch.setenv("PRIMEKG_COMBINED_AGG", "rowwise")
    jg, pg = _graphs("sparse", seed=1)
    jc, pc = js.build_combined_csr(jg), ps.build_combined_csr(pg)
    seeds = np.arange(0, 48, 2, dtype=np.int32)
    budgets = (8, 8)
    jb = js.sample_batch_combined(jax.random.PRNGKey(2), jc,
                                  jnp.asarray(seeds), budgets, mode=mode,
                                  allow_ident=True)
    pb = ps.sample_batch_combined(JaxDraws(jax.random.PRNGKey(2)), pc,
                                  torch.from_numpy(seeds), budgets,
                                  mode=mode, allow_ident=True)
    for x, y in zip(pb.blocks, jb.blocks):
        assert x.tags_sorted and y.tags_sorted
        for f in x._fields:
            u, v = getattr(x, f), getattr(y, f)
            if isinstance(u, torch.Tensor):
                v = np.asarray(v)
                assert u.numpy().dtype == v.dtype, f
                np.testing.assert_array_equal(u.numpy(), v, err_msg=f)
            else:
                assert u == v, f
        assert bool((x.rel_tag[:, 1:] >= x.rel_tag[:, :-1]).all())


@pytest.mark.parametrize("impl", ["rowwise", "chunked"])
def test_einsum_block_into_sorted_reduction_raises(impl, monkeypatch):
    """A block sampled for the einsum keeps its uniform rows unsorted; the
    rowwise and chunked reductions refuse it."""
    _, pg = _graphs("sparse")
    pc = ps.build_combined_csr(pg)
    batch = ps.sample_batch_combined(JaxDraws(jax.random.PRNGKey(0)), pc,
                                     torch.arange(12), (6, 5))
    block = batch.blocks[1]
    assert not block.tags_sorted
    monkeypatch.setenv("PRIMEKG_COMBINED_AGG", impl)
    layer = {k: torch.from_numpy(v) for k, v in _layer(
        np.random.default_rng(0), pg.num_relations, 4, 4).items()}
    with pytest.raises(ValueError, match="PRIMEKG_COMBINED_AGG"):
        ps._block_aggregate_combined(layer, torch.zeros(block.m_in, 4),
                                     block)
