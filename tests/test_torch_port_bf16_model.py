"""bf16 compute through the full-graph path on the CPU against the JAX
package's Pallas path at bf16 (``rgcn_layer_segment(..., impl="pallas")``,
the path the TPU ran; its kernels run interpreted): the layer, the encoder,
and the loss and every gradient of ``jax.value_and_grad(_batch_loss)``,
plus the dtype of each intermediate in ``ops/rgcn_segment.py``'s table.

The graphs are built with buckets padded to the TPU kernel's 512-edge
chunk and stay under 256 runs a chunk, so no bucket falls to the JAX
layer's XLA path, which sums in bf16 (asserted). Tolerance: 2e-2 of each
tensor's largest magnitude (atol) and rtol 2e-2: the two packages round the
same bf16 products and matmul outputs, but sum in other orders, so a value
near a bf16 rounding boundary may round to a neighbour. The largest
deviation measured here is 1.2e-2 of the largest magnitude, on the bias
gradients (sums over every node of bf16 cotangents, which XLA and torch
accumulate differently); every other tensor stays under 5e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.config import ModelConfig as JModelConfig
from primekg_rgcn_tpu.config import TrainConfig as JTrainConfig
from primekg_rgcn_tpu.data.graph import build_rel_graph as j_build
from primekg_rgcn_tpu.models import rgcn as jmodel
from primekg_rgcn_tpu.ops.pallas.segment_sum import SEG_K
from primekg_rgcn_tpu.ops.rgcn_segment import rgcn_layer_segment as j_layer
from primekg_rgcn_tpu.train import loop as jloop
from primekg_rgcn_tpu.train import neg_sampling as jneg
from primekg_rgcn_tpu_torch.config import ModelConfig
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph as p_build
from primekg_rgcn_tpu_torch.models import rgcn as pmodel
from primekg_rgcn_tpu_torch.ops import rgcn_segment as prs
from primekg_rgcn_tpu_torch.train import loop
from primekg_rgcn_tpu_torch.train.torch_interop import params_from_jax

BF16 = torch.bfloat16
N, R, E = 150, 3, 900
j_pallas_layer = functools.partial(j_layer, impl="pallas")


def assert_close(ours, expected, name=""):
    ours = np.asarray(ours, np.float32)
    expected = np.asarray(expected, np.float32)
    scale = max(float(np.abs(expected).max()), 1e-30)
    np.testing.assert_allclose(ours, expected, rtol=2e-2, atol=2e-2 * scale,
                               err_msg=name)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _graphs(seed, norm):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N // 2, E)
    dst = rng.integers(0, N, E)
    rel = rng.integers(0, R, E)
    jg = j_build(src, dst, rel, N, R, bucket_pad_multiple=SEG_K, norm=norm,
                 use_native="never")
    pg = p_build(src, dst, rel, N, R, bucket_pad_multiple=SEG_K, norm=norm)
    # Every chunk of every bucket, forward and transpose, has at most 256
    # runs: the JAX layer runs the Pallas kernel on it, not XLA's bf16 sum.
    for ids in (np.asarray(jg.dst), np.asarray(jg.t_src)):
        chunks = ids.reshape(-1, SEG_K)
        assert int((1 + (np.diff(chunks, axis=1) != 0).sum(1)).max()) <= 256
    edges = np.stack([src, dst, rel], 1).astype(np.int32)
    return edges, jg, pg


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
@pytest.mark.parametrize("din,dout,bases", [(16, 32, False), (32, 16, False),
                                            (16, 32, True)])
def test_layer_matches_the_jax_pallas_layer_at_bf16(norm, din, dout, bases):
    _, jg, pg = _graphs(din + dout + bases, norm)
    rng = np.random.default_rng(din)
    params = _layer_params(rng, din, dout, bases)
    x = rng.standard_normal((N, din)).astype(np.float32)
    expected = j_pallas_layer({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(x), jg, compute_dtype=jnp.bfloat16)
    assert expected.dtype == jnp.float32

    seen = []

    def spy(table, op):
        out = prs.aggregate(table, op)
        seen.append((table.dtype, out.dtype))
        return out

    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    ours = prs.rgcn_layer_segment(tparams, torch.from_numpy(x), pg,
                                  agg_fn=spy, compute_dtype=BF16)
    assert ours.dtype == torch.float32
    # The table reaching the aggregation is bf16; the sum comes back f32.
    assert seen == [(BF16, torch.float32)] * R
    assert_close(ours.numpy(), expected)
    # bf16 is not float32: the f32 layer differs beyond the bf16 rounding.
    f32 = prs.rgcn_layer_segment(tparams, torch.from_numpy(x), pg)
    assert not torch.allclose(ours, f32, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("norm", ["dense", "edge"])
def test_encoder_matches_jax_at_bf16(norm):
    _, jg, pg = _graphs(3, norm)
    jcfg = JModelConfig(num_nodes=N, num_relations=R, embedding_dim=16,
                        hidden_dim=32, compute_dtype="bfloat16")
    jp = jmodel.init_params(jax.random.PRNGKey(2), jcfg)
    expected = jmodel.encoder_apply(jp, jg, jcfg, layer_fn=j_pallas_layer)
    pp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    assert cfg.compute_dtype == "bfloat16"
    with torch.no_grad():
        ours = pmodel.get_embeddings(pp, pg, cfg)
    assert ours.dtype == torch.float32
    assert_close(ours.numpy(), expected)


@pytest.mark.parametrize("norm,drop,bases", [("dense", False, None),
                                             ("edge", False, 2),
                                             ("dense", True, None)])
def test_loss_and_every_gradient_match_jax_at_bf16(norm, drop, bases):
    edges, jg, pg = _graphs(11, norm)
    jcfg = JModelConfig(num_nodes=N, num_relations=R, embedding_dim=16,
                        hidden_dim=32, dropout=0.5 if drop else 0.0,
                        decoder_dropout=0.25 if drop else 0.0,
                        num_bases=bases, compute_dtype="bfloat16")
    tcfg = JTrainConfig(batch_size=64, num_neg_samples=1)
    jp = jmodel.init_params(jax.random.PRNGKey(5), jcfg)
    e = edges.shape[0]
    edges_pad = jnp.asarray(np.concatenate([edges,
                                            np.zeros((1, 3), np.int32)]))
    batch_idx = np.random.default_rng(4).integers(0, e, 64).astype(np.int32)
    key = jax.random.PRNGKey(9)
    (loss_j, (correct_j, count_j)), grads_j = jax.value_and_grad(
        lambda p: jloop._batch_loss(
            p, jg, edges_pad, jnp.asarray(batch_idx), key, jcfg, tcfg,
            train=True, layer_fn=j_pallas_layer), has_aux=True)(jp)

    k_neg, k_drop = jax.random.split(key)
    batch = np.asarray(edges_pad)[batch_idx]
    cands = jneg.candidate_batch(
        k_neg, jnp.asarray(batch[:, 0]), jnp.asarray(batch[:, 1]),
        jnp.asarray(batch[:, 2]), N, 1, mask=jnp.asarray(batch_idx < e))
    heads, tails, rels, labels, weights = (
        torch.from_numpy(np.array(c)) for c in cands)
    masks = {}
    if drop:
        k_enc, k_dec = jax.random.split(k_drop)
        masks = {
            "enc_mask": torch.from_numpy(np.array(jax.random.bernoulli(
                k_enc, 0.5, (N, jcfg.hidden_dim)))),
            "dec_mask": torch.from_numpy(np.array(jax.random.bernoulli(
                k_dec, 0.75, (heads.shape[0], jcfg.hidden_dim))))}
    pp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    for p in pmodel.param_leaves(pp):
        p.requires_grad_(True)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    loss, (correct, count) = loop.loss_from_candidates(
        pp, pg, heads.long(), tails.long(), rels.long(), labels, weights,
        cfg, train=True, **masks)
    loss.backward()
    assert loss.dtype == torch.float32
    assert loss.item() == pytest.approx(float(loss_j), rel=1e-3)
    assert count.item() == float(count_j)
    assert abs(correct.item() - float(correct_j)) <= 2
    ours, theirs = _flat(pp), _flat(grads_j)
    assert ours.keys() == theirs.keys()
    for k in theirs:
        # Parameters and their gradients stay float32 (adam's input).
        assert ours[k].grad.dtype == torch.float32
        assert_close(ours[k].grad.numpy(), theirs[k], k)


def test_bf16_gradients_reach_adam_in_float32():
    edges, _, pg = _graphs(2, "dense")
    cfg = ModelConfig(num_nodes=N, num_relations=R, embedding_dim=16,
                      hidden_dim=32, compute_dtype="bfloat16")
    from primekg_rgcn_tpu_torch.config import TrainConfig

    tcfg = TrainConfig(batch_size=32)
    params = pmodel.init_params(torch.Generator().manual_seed(0), cfg)
    for p in pmodel.param_leaves(params):
        p.requires_grad_(True)
    opt = loop.make_optimizer(tcfg, params)
    edges_pad = loop.edges_with_sentinel(edges, "cpu")
    stats = loop.train_step(params, opt, pg, edges_pad,
                            torch.arange(32)[None], cfg, tcfg,
                            generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(stats).all()
    for p in pmodel.param_leaves(params):
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        for v in opt.state[p].values():
            assert not torch.is_floating_point(v) or v.dtype == torch.float32


def test_promote_matmul_casts_up_where_jnp_promotes():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((5, 4)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    b16 = b.to(BF16)
    got = prs.promote_matmul(a, b16)
    want = np.asarray(jnp.asarray(a.numpy()) @ jnp.asarray(
        b16.float().numpy()).astype(jnp.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert prs.promote_matmul(a.to(BF16), b16).dtype == BF16
