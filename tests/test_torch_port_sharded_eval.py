"""The port's sharded evaluation on the CPU: against the JAX package's at its
shard count (``len(jax.devices())``, 8 under the conftest), and against the
port's own dense ranker and scorer at 2 and 3 shards. The parameters are
the JAX package's, moved across through the state-dict layout; 617 nodes
leave one padding row in the last shard at 2 and 3 shards, and 7 at 8.

Tolerances: ranks equal on every query whose true score is more than 1e-5
x the row's largest |score| away from every other candidate's (the rule
leaves out ``LEFT_OUT`` of the 256 queries on these random weights);
logits at rtol 2e-4, atol 2e-5 (the JAX scorer's psum / n against the
port's assembled rows); ranking blocks within 1e-6 of the JAX node
evaluator's; the node-sharded Evaluator's ranking blocks within 1e-12 of
the port's dense one's (the same ranks give the same floats).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.config import EvalConfig as JEvalConfig
from primekg_rgcn_tpu.config import ModelConfig as JModelConfig
from primekg_rgcn_tpu.data import synthetic as jsyn
from primekg_rgcn_tpu.data.graph import build_rel_graph as j_build
from primekg_rgcn_tpu.evaluate import evaluator as jev
from primekg_rgcn_tpu.evaluate import sharded_ranking as jsr
from primekg_rgcn_tpu.models.rgcn import encoder_apply as j_encode
from primekg_rgcn_tpu.models.rgcn import init_params as j_init
from primekg_rgcn_tpu.parallel import node_shard as jns
from primekg_rgcn_tpu.parallel.mesh import make_mesh as j_mesh
from primekg_rgcn_tpu_torch.config import EvalConfig, ModelConfig
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph
from primekg_rgcn_tpu_torch.evaluate import evaluator as pev
from primekg_rgcn_tpu_torch.evaluate import sharded_ranking as sr
from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh
from primekg_rgcn_tpu_torch.parallel.node_shard import (
    build_node_sharded_forward, partition_nodes)
from primekg_rgcn_tpu_torch.train.torch_interop import (
    params_from_jax, params_from_state_dict, state_dict_from_params)

NEAR_TIE = 1e-5
LEFT_OUT = 0
N_JAX = len(jax.devices())
RANKING = ("ranking", "ranking_head", "ranking_both")


@pytest.fixture(scope="module")
def setup():
    raw = jsyn.primekg_like(seed=2, scale=0.02)
    s, t, r = jsyn.bidirect(raw["src"], raw["dst"], raw["rel"])
    n = raw["num_nodes"]
    jcfg = JModelConfig(num_nodes=n, num_relations=3, embedding_dim=16,
                        hidden_dim=16)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    # Parameters cross through the reference state-dict layout.
    params = params_from_state_dict(state_dict_from_params(
        params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))))
    graph = build_rel_graph(s, t, r, n, 3)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    rng = np.random.default_rng(1)
    edges = np.stack([s, t, r], 1)
    test_edges = edges[rng.choice(len(edges), 256, replace=False)]
    dense = pev.Evaluator(params, cfg, graph, test_edges,
                          EvalConfig(batch_size=64))
    return dict(graph=graph, cfg=cfg, params=params, n=n,
                jgraph=j_build(s, t, r, n, 3, use_native="never"),
                jcfg=jcfg, jparams=jparams, test_edges=test_edges,
                dense=dense)


def _queries(setup):
    e = torch.from_numpy(setup["test_edges"].astype(np.int64))
    return e[:, 0], e[:, 2], e[:, 1]


def _untied(setup):
    emb = setup["dense"]._node_emb.double().numpy()
    rel = setup["params"]["decoder"]["rel_emb"].double().numpy()
    e = setup["test_edges"]
    s = (emb[e[:, 0]] * rel[e[:, 2]]) @ emb.T
    true = s[np.arange(len(e)), e[:, 1]]
    gap = np.abs(s - true[:, None])
    gap[np.arange(len(e)), e[:, 1]] = np.inf
    clean = gap.min(axis=1) > NEAR_TIE * np.abs(s).max(axis=1)
    assert (~clean).sum() == LEFT_OUT
    return clean


def _dense_ranks(setup):
    h, r, t = _queries(setup)
    with torch.no_grad():
        return setup["dense"]._rank_batch_impl(h, r, t).numpy()


def _port_eval_from_sharded(setup, n_shards):
    mesh = make_mesh(n_shards, "cpu")
    nsg = partition_nodes(setup["graph"], n_shards)
    assert nsg.n_loc * n_shards - setup["n"] == -setup["n"] % n_shards
    with torch.no_grad():
        emb_dm = build_node_sharded_forward(
            mesh, nsg, setup["cfg"], gather=False)(setup["params"])
        rank, score = sr.build_sharded_eval_from_sharded(
            mesh, emb_dm, setup["params"]["decoder"]["rel_emb"], setup["n"])
        h, r, t = _queries(setup)
        return rank(h, r, t).numpy(), score(h, t, r).double().numpy()


def _close(got, want, tol):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_eval_from_sharded_matches_dense(setup, n_shards):
    got, logits = _port_eval_from_sharded(setup, n_shards)
    with torch.no_grad():
        h, r, t = _queries(setup)
        want_logits = torch.logit(
            setup["dense"]._score_triples_impl(h, t, r).double())
    clean = _untied(setup)
    np.testing.assert_array_equal(got[clean], _dense_ranks(setup)[clean])
    np.testing.assert_allclose(logits, want_logits.numpy(),
                               rtol=2e-4, atol=2e-5)


def test_sharded_eval_from_sharded_matches_jax(setup):
    """The port's node-sharded encode + sharded rank/score at the JAX
    package's shard count against ``jsr.build_sharded_eval_from_sharded``
    over the JAX node-sharded encode: ranks on the untied queries, and the
    port's logits against the JAX scorer's psum / n."""
    assert N_JAX >= 2
    got, logits = _port_eval_from_sharded(setup, N_JAX)
    mesh = j_mesh(N_JAX)
    nsg = jns.partition_nodes(setup["jgraph"], N_JAX)
    emb_dm = jns.build_node_sharded_forward(
        mesh, nsg, setup["jcfg"], gather=False)(setup["jparams"])
    rank, score = jsr.build_sharded_eval_from_sharded(
        mesh, emb_dm, setup["jparams"]["decoder"]["rel_emb"], setup["n"])
    e = jnp.asarray(setup["test_edges"].astype(np.int32))
    want = np.asarray(rank(e[:, 0], e[:, 2], e[:, 1]))
    want_logits = np.asarray(score(e[:, 0], e[:, 1], e[:, 2]), np.float64)
    clean = _untied(setup)
    np.testing.assert_array_equal(got[clean], want[clean])
    np.testing.assert_allclose(logits, want_logits, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_ranker_matches_dense(setup, n_shards):
    rank = sr.build_sharded_ranker(make_mesh(n_shards, "cpu"),
                                   setup["dense"]._node_emb,
                                   setup["params"]["decoder"]["rel_emb"])
    with torch.no_grad():
        got = rank(*_queries(setup)).numpy()
    np.testing.assert_array_equal(got, _dense_ranks(setup))


def test_sharded_ranker_matches_jax(setup):
    """Both packages' ``build_sharded_ranker`` at the JAX shard count over
    one [N, D] table (the JAX dense encode): ranks equal on the untied
    queries."""
    jparams = setup["jparams"]
    table = np.array(j_encode(jparams, setup["jgraph"], setup["jcfg"]))
    np.testing.assert_allclose(table, setup["dense"]._node_emb.numpy(),
                               rtol=2e-4, atol=2e-5)
    rel = np.array(jparams["decoder"]["rel_emb"])
    e = setup["test_edges"].astype(np.int32)
    want = np.asarray(jsr.build_sharded_ranker(
        j_mesh(N_JAX), jnp.asarray(table), jnp.asarray(rel))(
            e[:, 0], e[:, 2], e[:, 1]))
    with torch.no_grad():
        got = sr.build_sharded_ranker(
            make_mesh(N_JAX, "cpu"), torch.from_numpy(table),
            torch.from_numpy(rel))(*_queries(setup)).numpy()
    clean = _untied(setup)
    np.testing.assert_array_equal(got[clean], want[clean])


def test_padding_rows_never_count(setup):
    """Padding rows are zero: they score 0, above a negative true score,
    and must still not count."""
    emb = torch.randn(5, 4, generator=torch.Generator().manual_seed(0))
    rel = torch.ones(1, 4)
    heads = torch.zeros(5, dtype=torch.long)
    rels = torch.zeros(5, dtype=torch.long)
    tails = torch.arange(5)
    all_s = (emb[0] * emb).sum(1)
    want = 1 + (all_s[None, :] > all_s[:, None]).sum(1)
    for n_shards in (2, 3, 4):
        got = sr.build_sharded_ranker(make_mesh(n_shards, "cpu"), emb, rel)(
            heads, rels, tails)
        assert torch.equal(got, want), n_shards


@pytest.mark.parametrize("n_shards", [2, 3])
def test_node_evaluator_gives_the_dense_ranking(setup, n_shards):
    cfg = EvalConfig(batch_size=64)
    node = pev.Evaluator(setup["params"], setup["cfg"], setup["graph"],
                         setup["test_edges"], cfg, shard_encode="node",
                         n_shards=n_shards)
    dense = pev.Evaluator(setup["params"], setup["cfg"], setup["graph"],
                          setup["test_edges"], cfg)
    for direction in ("tail", "head", "both"):
        got = node.compute_ranking_metrics(direction=direction)
        want = dense.compute_ranking_metrics(direction=direction)
        _close(got, want, 1e-12)
    # The fully sharded ranks are cached under sharded=False.
    assert set(node._raw_ranks) == {("tail", False), ("head", False)}
    # Its probabilities are the dense ones (same default negatives).
    np.testing.assert_allclose(node.compute_scores_and_labels()[0],
                               dense.compute_scores_and_labels()[0],
                               rtol=2e-4, atol=2e-5)


def test_node_evaluator_matches_jax(setup):
    """``Evaluator(shard_encode="node")`` at the JAX shard count against
    the JAX node evaluator: the ranking blocks of ``evaluate()`` within
    1e-6; the classification block's keys (its negatives differ)."""
    kw = dict(batch_size=64, k_values=(1, 10))
    want = jev.Evaluator(setup["jparams"], setup["jcfg"], setup["jgraph"],
                         setup["test_edges"], JEvalConfig(**kw),
                         shard_encode="node").evaluate(rank_direction="both")
    got = pev.Evaluator(setup["params"], setup["cfg"], setup["graph"],
                        setup["test_edges"], EvalConfig(**kw),
                        shard_encode="node", n_shards=N_JAX).evaluate(
                            rank_direction="both")
    assert got.keys() == want.keys()
    for block in RANKING:
        _close(got[block], want[block], 1e-6)
    assert got["classification"].keys() == want["classification"].keys()


def test_dense_evaluator_ranks_sharded_with_two_shards(setup):
    ev = pev.Evaluator(setup["params"], setup["cfg"], setup["graph"],
                       setup["test_edges"], EvalConfig(batch_size=64),
                       n_shards=2)
    dense = ev._compute_raw_ranks()
    assert set(ev._raw_ranks) == {("tail", False)}  # dense unless asked
    sharded = ev._compute_raw_ranks(sharded=True)
    assert set(ev._raw_ranks) == {("tail", True), ("tail", False)}
    np.testing.assert_array_equal(sharded, dense)
