"""The batch-restricted final layer (``ops/rgcn_final_layer.py``) against the
JAX package's: the plan's capacities and row pointers, the tri-state
resolution, the restricted rows (both norms, basis decomposition, duplicate
nodes, float32 and bf16), the overflow fallback, and the loss and every
gradient of ``loss_from_candidates`` with a plan against
``jax.value_and_grad(_batch_loss(..., final_plan=))`` (at bf16 the loss
against JAX, the gradients against the port's full-layer step); and the
Trainer with the layer on and off.

Inputs come from ``np.random.default_rng``; JAX's candidates and dropout
masks are handed to the port. Tolerance at float32 as in ROADMAP.md's parity
rules: rtol 2e-4, atol 2e-5 times each tensor's largest magnitude. At bf16,
the bf16 tests': rtol 2e-2, atol 2e-2 times the largest magnitude (the JAX fast path
sums in bf16 where the port sums in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.config import ModelConfig as JModelConfig
from primekg_rgcn_tpu.config import TrainConfig as JTrainConfig
from primekg_rgcn_tpu.data.graph import build_rel_graph as j_build
from primekg_rgcn_tpu.models.rgcn import init_params as j_init
from primekg_rgcn_tpu.ops import rgcn_final_layer as jfl
from primekg_rgcn_tpu.ops.rgcn_segment import rgcn_layer_segment as j_layer
from primekg_rgcn_tpu.train import loop as jloop
from primekg_rgcn_tpu.train import neg_sampling as jneg
from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph as p_build
from primekg_rgcn_tpu_torch.models.rgcn import param_leaves
from primekg_rgcn_tpu_torch.ops import rgcn_final_layer as pfl
from primekg_rgcn_tpu_torch.ops.rgcn_segment import rgcn_layer_segment
from primekg_rgcn_tpu_torch.train import loop
from primekg_rgcn_tpu_torch.train.torch_interop import params_from_jax

BF16 = torch.bfloat16
N, R, E = 120, 4, 1500


def assert_close(ours, expected, bf16=False, name=""):
    ours = np.asarray(ours, np.float32)
    expected = np.asarray(expected, np.float32)
    tol = 2e-2 if bf16 else 2e-4
    scale = max(float(np.abs(expected).max()), 1e-30)
    np.testing.assert_allclose(ours, expected, rtol=tol,
                               atol=tol * scale if bf16 else 2e-5 * scale,
                               err_msg=name)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _graphs(seed, norm, n=N, e=E):
    """A skewed graph (hub destinations) in both packages."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = np.minimum((n * rng.random(e) ** 2.0).astype(np.int64), n - 1)
    rel = rng.integers(0, R, e)
    edges = np.stack([src, dst, rel], 1).astype(np.int32)
    jg = j_build(src, dst, rel, n, R, bucket_pad_multiple=64, norm=norm,
                 use_native="never")
    pg = p_build(src, dst, rel, n, R, bucket_pad_multiple=64, norm=norm,
                 use_native="never")
    return edges, jg, pg


def _plans(jg, pg, edges, batch=16, neg=1):
    jplan = jfl.plan_final_layer(jg, edges.astype(np.int64), batch, neg,
                                 sims=8, seed=3)
    pplan = pfl.plan_final_layer(pg, edges.astype(np.int64), batch, neg,
                                 sims=8, seed=3)
    return jplan, pplan


def _layer_params(rng, din, dout, bases):
    p = {"w_root": rng.standard_normal((din, dout)) * 0.2,
         "bias": rng.standard_normal(dout) * 0.2}
    if bases:
        p["basis"] = rng.standard_normal((2, din, dout)) * 0.2
        p["coef"] = rng.standard_normal((R, 2))
    else:
        p["w_rel"] = rng.standard_normal((R, din, dout)) * 0.2
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("norm", ["dense", "edge"])
@pytest.mark.parametrize("batch,neg", [(16, 1), (64, 2)])
def test_plan_capacities_and_rowptr_equal_jax(norm, batch, neg):
    edges, jg, pg = _graphs(1, norm)
    jplan, pplan = _plans(jg, pg, edges, batch, neg)
    assert pplan.e_cap == jplan.e_cap and pplan.group == jplan.group == 8
    for r in range(R):
        np.testing.assert_array_equal(pplan.rowptr[r].numpy(),
                                      np.asarray(jplan.rowptr[r]))
    # The plan reuses the graph's CSR: a view, not a second array.
    assert pplan.rowptr.untyped_storage().data_ptr() == \
        pg.rowptr.untyped_storage().data_ptr()
    assert torch.equal(pplan.rowptr, pg.rowptr[:, :N + 1])
    assert pplan.cap.tolist() == list(jplan.e_cap)
    assert pplan.cap_start.tolist() == np.concatenate(
        [[0], np.cumsum(jplan.e_cap)[:-1]]).tolist()


@pytest.mark.parametrize("mode", ["auto", None, "on", True, "off", False])
@pytest.mark.parametrize("batch", [2, 512])
def test_resolve_final_plan_chooses_as_jax(mode, batch):
    rng = np.random.default_rng(2)
    n, e = 2000, 40_000
    src, dst, rel = rng.integers(0, n, e), rng.integers(0, n, e), \
        rng.integers(0, R, e)
    edges = np.stack([src, dst, rel], 1).astype(np.int32)
    jg = j_build(src, dst, rel, n, R, use_native="never")
    pg = p_build(src, dst, rel, n, R, use_native="never")
    j = jfl.resolve_final_plan(jg, edges, batch, 1, seed=5, mode=mode)
    p = pfl.resolve_final_plan(pg, edges, batch, 1, seed=5, mode=mode)
    assert (p is None) == (j is None)
    if p is not None:
        assert p.e_cap == j.e_cap
    if mode in ("auto", None):
        # batch 2 resolves on, batch 512 off: both branches of "auto".
        assert (p is not None) == (batch == 2)
        assert pfl.AUTO_EDGE_RATIO == jfl.AUTO_EDGE_RATIO == 6.0


def _nodes(rng, extra_dups=True):
    nodes = rng.integers(0, N, 24)
    if extra_dups:
        nodes[[3, 9, 17]] = nodes[0]
        nodes[20] = nodes[5]
    return nodes.astype(np.int64)


@pytest.mark.parametrize("norm", ["dense", "edge"])
@pytest.mark.parametrize("bases", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restricted_rows_equal_jax_and_the_full_layer(norm, bases, dtype):
    edges, jg, pg = _graphs(3 + bases, norm)
    jplan, pplan = _plans(jg, pg, edges, batch=16)
    rng = np.random.default_rng(7)
    din, dout = 16, 24
    params = _layer_params(rng, din, dout, bases)
    h1 = np.maximum(rng.standard_normal((N, din)), 0).astype(np.float32)
    h1p = np.concatenate([h1, np.zeros((1, din), np.float32)])
    nodes = _nodes(rng)
    bf16 = dtype == "bfloat16"
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    pdt = BF16 if bf16 else torch.float32

    expected = jax.jit(lambda p, h, ns: jfl.final_layer_restricted(
        p, h, jg, jplan, ns, compute_dtype=jdt))(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(h1p),
            jnp.asarray(nodes, jnp.int32))
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    before = pfl.final_layer_restricted.fallbacks
    ours = pfl.final_layer_restricted(
        tparams, torch.from_numpy(h1p), pg, pplan, torch.from_numpy(nodes),
        compute_dtype=pdt)
    assert pfl.final_layer_restricted.fallbacks == before
    assert ours.dtype == torch.float32 and ours.shape == (24, dout)
    assert_close(ours.numpy(), expected, bf16)
    full = rgcn_layer_segment(tparams, torch.from_numpy(h1), pg,
                              compute_dtype=pdt)[torch.from_numpy(nodes)]
    # Against the port's full layer the rounding points are the same.
    assert_close(ours.numpy(), full.numpy())
    # Repeated nodes get identical rows.
    assert torch.equal(ours[3], ours[0]) and torch.equal(ours[20], ours[5])


@pytest.mark.parametrize("norm", ["dense", "edge"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restricted_gradients_equal_the_full_layers(norm, dtype):
    """Duplicate rows receive the sum of their cotangents: the gradients of
    a weighted sum of the rows equal the full layer's."""
    edges, jg, pg = _graphs(5, norm)
    _, pplan = _plans(jg, pg, edges)
    rng = np.random.default_rng(8)
    din, dout = 16, 24
    pdt = BF16 if dtype == "bfloat16" else torch.float32
    params = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in _layer_params(rng, din, dout, False).items()}
    h1 = torch.from_numpy(rng.standard_normal((N, din)).astype(np.float32))
    nodes = torch.from_numpy(_nodes(rng))
    cot = torch.from_numpy(rng.standard_normal((24, dout)).astype(np.float32))
    grads = []
    for restricted in (False, True):
        x = h1.clone().requires_grad_(True)
        if restricted:
            x_pad = torch.cat([x, x.new_zeros(1, din)])
            out = pfl.final_layer_restricted(params, x_pad, pg, pplan, nodes,
                                             compute_dtype=pdt)
        else:
            out = rgcn_layer_segment(params, x, pg, compute_dtype=pdt)[nodes]
        g = torch.autograd.grad((out * cot).sum(), [x, *params.values()])
        grads.append(g)
    # At bf16 both sum bf16 cotangents (root term and aggregate) in bf16,
    # in another order: the bf16 tolerance.
    for a, b in zip(*grads):
        assert a.dtype == b.dtype == torch.float32
        assert_close(b.numpy(), a.numpy(), pdt == BF16)


@pytest.mark.parametrize("norm", ["dense", "edge"])
def test_forced_overflow_falls_back_exactly_and_counts(norm):
    edges, jg, pg = _graphs(6, norm)
    _, pplan = _plans(jg, pg, edges)
    tiny = pfl.plan_final_layer(pg, edges.astype(np.int64), 16, 1, sims=8,
                                seed=3)
    cap = torch.full_like(tiny.cap, 8)
    tiny = pfl.FinalLayerPlan(tiny.rowptr, (8,) * R, 8, cap,
                              torch.arange(R) * 8, tiny.bucket_start)
    rng = np.random.default_rng(9)
    params = {k: torch.from_numpy(v)
              for k, v in _layer_params(rng, 16, 24, False).items()}
    h1 = torch.from_numpy(rng.standard_normal((N, 16)).astype(np.float32))
    h1p = torch.cat([h1, h1.new_zeros(1, 16)])
    nodes = torch.from_numpy(_nodes(rng))
    before = pfl.final_layer_restricted.fallbacks
    got = pfl.final_layer_restricted(params, h1p, pg, tiny, nodes)
    assert pfl.final_layer_restricted.fallbacks == before + 1
    # The fallback is the full layer itself: equal bit for bit.
    assert torch.equal(got, rgcn_layer_segment(params, h1, pg)[nodes])
    pfl.final_layer_restricted(params, h1p, pg, pplan, nodes)
    assert pfl.final_layer_restricted.fallbacks == before + 1


@pytest.mark.parametrize("norm,bases,drop,dtype", [
    ("dense", None, False, "float32"),
    ("edge", 2, False, "float32"),
    ("dense", None, True, "float32"),
    ("edge", None, True, "bfloat16"),
    ("dense", 2, False, "bfloat16"),
])
def test_loss_and_every_gradient_match_jax_batch_loss(norm, bases, drop,
                                                      dtype):
    # The batch covers a small share of the nodes, so that the padded
    # ranges fit the plan and the fast path runs.
    n = 600
    edges, jg, pg = _graphs(11 + len(norm), norm, n=n, e=3000)
    jplan, pplan = _plans(jg, pg, edges, batch=32)
    bf16 = dtype == "bfloat16"
    jcfg = JModelConfig(num_nodes=n, num_relations=R, embedding_dim=8,
                        hidden_dim=16, dropout=0.5 if drop else 0.0,
                        decoder_dropout=0.25 if drop else 0.0,
                        num_bases=bases, compute_dtype=dtype)
    tcfg = JTrainConfig(batch_size=32, num_neg_samples=1)
    jp = j_init(jax.random.PRNGKey(4), jcfg)
    e = edges.shape[0]
    edges_pad = jnp.asarray(np.concatenate([edges,
                                            np.zeros((1, 3), np.int32)]))
    batch_idx = np.random.default_rng(5).integers(0, e, 32).astype(np.int32)
    batch_idx[28:] = e     # a partial batch: padding slots index row E
    key = jax.random.PRNGKey(13)
    (loss_j, (correct_j, count_j)), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jloop._batch_loss(
            p, jg, edges_pad, jnp.asarray(batch_idx), key, jcfg, tcfg,
            train=True, layer_fn=j_layer, final_plan=jplan),
        has_aux=True))(jp)

    k_neg, k_drop = jax.random.split(key)
    batch = np.asarray(edges_pad)[batch_idx]
    cands = jneg.candidate_batch(
        k_neg, jnp.asarray(batch[:, 0]), jnp.asarray(batch[:, 1]),
        jnp.asarray(batch[:, 2]), n, 1, mask=jnp.asarray(batch_idx < e))
    heads, tails, rels, labels, weights = (
        torch.from_numpy(np.array(c)) for c in cands)
    masks = {}
    if drop:
        k_enc, k_dec = jax.random.split(k_drop)
        masks = {
            "enc_mask": torch.from_numpy(np.array(jax.random.bernoulli(
                k_enc, 0.5, (n, jcfg.hidden_dim)))),
            "dec_mask": torch.from_numpy(np.array(jax.random.bernoulli(
                k_dec, 0.75, (heads.shape[0], jcfg.hidden_dim))))}
    pp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    for p in param_leaves(pp):
        p.requires_grad_(True)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    before = pfl.final_layer_restricted.fallbacks
    loss, (correct, count) = loop.loss_from_candidates(
        pp, pg, heads.long(), tails.long(), rels.long(), labels, weights,
        cfg, train=True, final_plan=pplan, **masks)
    loss.backward()
    assert pfl.final_layer_restricted.fallbacks == before
    assert_close(loss.item(), float(loss_j), bf16)
    assert count.item() == float(count_j) == 56
    assert abs(correct.item() - float(correct_j)) <= (2 if bf16 else 0)
    ours, theirs = _flat(pp), _flat(grads_j)
    assert ours.keys() == theirs.keys()
    if bf16:
        # The JAX step sums bf16 in bf16 (XLA's segment_sum, both layers);
        # the port sums in float32 as kernel B1 does. Its gradients are
        # held against the port's full-layer step, whose bf16 path the
        # tests hold against the JAX Pallas layer.
        full = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
        for p in param_leaves(full):
            p.requires_grad_(True)
        loop.loss_from_candidates(
            full, pg, heads.long(), tails.long(), rels.long(), labels,
            weights, cfg, train=True, **masks)[0].backward()
        theirs = {k: v.grad.numpy() for k, v in _flat(full).items()}
    for k in theirs:
        assert ours[k].grad.dtype == torch.float32
        assert_close(ours[k].grad.numpy(), theirs[k], bf16, k)


def test_trainer_restrict_final_on_and_off_give_the_same_losses(tmp_path):
    n = 600
    edges, _, pg = _graphs(21, "dense", n=n, e=3000)
    cfg = ModelConfig(num_nodes=n, num_relations=R, embedding_dim=8,
                      hidden_dim=16)
    losses = []
    for flag in ("off", "on"):
        tc = TrainConfig(batch_size=32, epochs=2, seed=3,
                         restrict_final=flag)
        trainer = loop.Trainer(cfg, tc, pg, pg, edges[:640], edges[:32],
                               tmp_path / flag, device="cpu")
        assert (trainer.final_plan is None) == (flag == "off")
        before = pfl.final_layer_restricted.fallbacks
        losses.append(trainer.train()["history"]["train_losses"])
        # 40 steps; the simulated capacity holds for all but a few.
        assert pfl.final_layer_restricted.fallbacks - before <= 4
    np.testing.assert_allclose(losses[0], losses[1], rtol=2e-4, atol=1e-6)
