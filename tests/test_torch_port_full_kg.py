"""BASELINE config 3 and 4 pieces on the CPU against the JAX package: the
full-PrimeKG generator draw for draw, ``TrainConfig.restrict_final`` across
the two packages, the ``"auto"`` choice of the batch-restricted final layer
on the full-PrimeKG graph (on) and the ``bench.py`` graph (off) with equal
capacities, and a sampled block-mode step over the slim CSR at 30 relations
(config 4's layout) against the JAX step.

The JAX negatives, sampler draws and dropout mask are handed to the port.
Tolerance as in ROADMAP.md's parity rules: rtol 2e-4, atol 2e-5 times each
tensor's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.config import ModelConfig as JModelConfig
from primekg_rgcn_tpu.config import TrainConfig as JTrainConfig
from primekg_rgcn_tpu.data import graph as jgraph
from primekg_rgcn_tpu.data import synthetic as jsyn
from primekg_rgcn_tpu.models import rgcn as jmodel
from primekg_rgcn_tpu.ops import rgcn_final_layer as jfl
from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.data import graph as pgraph
from primekg_rgcn_tpu_torch.data import sampling as ps
from primekg_rgcn_tpu_torch.data import synthetic as psyn
from primekg_rgcn_tpu_torch.ops import rgcn_final_layer as pfl
from primekg_rgcn_tpu_torch.train import sampled as psampled
from test_torch_port_sampled_train import (JaxDraws, _flat, _j_loss,
                                           _jax_batch, _port_params, _torch)


def assert_close(ours, expected):
    ours, expected = np.asarray(ours), np.asarray(expected)
    scale = max(float(np.abs(expected).max()), 1e-30)
    np.testing.assert_allclose(ours, expected, rtol=2e-4, atol=2e-5 * scale)


@pytest.mark.parametrize("seed,scale", [(0, 0.05), (3, 0.1), (7, 0.02)])
def test_primekg_full_like_equals_jax(seed, scale):
    ours = psyn.primekg_full_like(seed, scale)
    theirs = jsyn.primekg_full_like(seed, scale)
    assert ours.keys() == theirs.keys()
    for k in ("src", "dst", "rel"):
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])
    for k in ("num_nodes", "num_relations", "relation_names",
              "type_ranges"):
        assert ours[k] == theirs[k]
    assert ours["num_relations"] == 30
    assert psyn.PRIMEKG_FULL_RELATIONS == jsyn.PRIMEKG_FULL_RELATIONS
    assert psyn.PRIMEKG_FULL_TYPE_SIZES == jsyn.PRIMEKG_FULL_TYPE_SIZES


@pytest.mark.parametrize("value", ["auto", "on", "off", True, False, None])
def test_restrict_final_round_trips_a_jax_dict(value):
    jcfg = JTrainConfig(batch_size=512, restrict_final=value)
    ours = TrainConfig.from_dict(jcfg.to_dict())
    assert ours.restrict_final == value
    assert JTrainConfig.from_dict(ours.to_dict()).restrict_final == value
    assert TrainConfig().restrict_final == JTrainConfig().restrict_final


@pytest.mark.parametrize("graph_name,on", [("full", True), ("bench", False)])
def test_auto_resolves_as_jax_at_full_scale(graph_name, on):
    """Config 3's graph takes the restricted layer, the bench.py graph does
    not, in both packages, with equal capacities (batch 1024, one negative,
    the trainer's seed 42)."""
    raw = (psyn.primekg_full_like(0, 1.0) if graph_name == "full"
           else psyn.primekg_like(0, 1.0))
    src, dst, rel = psyn.bidirect(raw["src"], raw["dst"], raw["rel"])
    n, r = raw["num_nodes"], raw["num_relations"]
    edges = np.stack([src, dst, rel], 1)
    pg = pgraph.build_rel_graph(src, dst, rel, n, r)
    jg = jgraph.build_rel_graph(src, dst, rel, n, r)
    plan = pfl.resolve_final_plan(pg, edges, 1024, 1, seed=42, mode="auto")
    jplan = jfl.resolve_final_plan(jg, edges, 1024, 1, seed=42, mode="auto")
    assert (plan is not None) == (jplan is not None) == on
    forced = pfl.resolve_final_plan(pg, edges, 1024, 1, seed=42, mode="on")
    jforced = jfl.resolve_final_plan(jg, edges, 1024, 1, seed=42, mode="on")
    assert forced.e_cap == jforced.e_cap
    ratio = pfl.edge_ratio(pg, forced)
    assert (ratio >= pfl.AUTO_EDGE_RATIO) == on
    if on:
        assert (n, r, pg.num_edges, pg.padded_num_edges) == (
            129375, 30, 4601678, 4609024)


def test_sampled_block_step_over_the_slim_csr_at_30_relations():
    raw = psyn.primekg_full_like(seed=0, scale=0.05)
    src, dst, rel = psyn.bidirect(raw["src"], raw["dst"], raw["rel"])
    n, r = raw["num_nodes"], raw["num_relations"]
    assert r == 30
    jg = jgraph.build_rel_graph(src, dst, rel, n, r, use_native="never")
    pg = pgraph.build_rel_graph(src, dst, rel, n, r, use_native="never")
    jcfg = JModelConfig(num_nodes=n, num_relations=r, embedding_dim=8,
                        hidden_dim=12, dropout=0.5)
    jp = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(1), jcfg))
    edges = np.stack([src, dst, rel], 1).astype(np.int32)
    pos = jnp.asarray(edges[np.random.default_rng(4).integers(
        0, len(edges), 32)])
    csr_kw = {"slim": True, "window_pairs": True}
    fanouts = (15, 10)
    jcsr, cands, jb, k_sample, k_drop, mask = _jax_batch(
        jg, jcfg, pos, jax.random.PRNGKey(5), fanouts, "block", csr_kw)
    (loss_j, acc_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: _j_loss(p, jb, cands, jcfg, k_drop), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, jp))

    cfg = ModelConfig.from_dict(jcfg.to_dict())
    step = psampled.build_sampled_train_step(
        ps.build_combined_csr(pg, **csr_kw), cfg, TrainConfig(),
        fanouts=fanouts, mode="block", device="cpu")
    assert step.use_combined
    pb = step.sample(torch.cat([_torch(cands[0]), _torch(cands[1])]),
                     JaxDraws(k_sample))
    # The sampled blocks equal the JAX sampler's, field for field.
    for jblk, pblk in zip(jb.blocks, pb.blocks):
        for f in jblk._fields:
            a, b = getattr(pblk, f), getattr(jblk, f)
            if isinstance(a, torch.Tensor):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f)
            else:
                assert a == b, f
    pp = _port_params(jp)
    pcands = tuple(_torch(c, long=i < 3) for i, c in enumerate(cands))
    loss, acc = psampled.sampled_loss(pp, pb, pcands, cfg, train=True,
                                      enc_mask=_torch(mask))
    loss.backward()
    assert_close(loss.item(), float(loss_j))
    assert acc.item() == pytest.approx(float(acc_j))
    ours, theirs = _flat(pp), _flat(grads_j)
    assert ours.keys() == theirs.keys()
    for k in theirs:
        assert_close(ours[k].grad.numpy(), theirs[k])
