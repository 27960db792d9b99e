"""The port's dense Evaluator against the JAX package's, on one graph, one
set of parameters (moved across through the state-dict layout) and the
same negatives, which the port takes from the JAX key chain through its
injectable ``negatives``.

Tolerances: embeddings and probabilities at rtol 2e-4, atol 2e-5 (the
port's parity rule); labels and filter lists equal; raw and filtered
ranks equal on every query whose true score is more than 1e-5 x the row's
largest |score| away from every other candidate's (the tests assert how
many queries that rule leaves out: 5 of the 300 tail queries and 4 of the
300 head queries, on these random weights); every value of
``evaluate()`` within 1e-4; ``save_results`` files byte-equal.
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
from primekg_rgcn_tpu.models.rgcn import init_params as j_init
from primekg_rgcn_tpu.train import neg_sampling as jneg
from primekg_rgcn_tpu_torch.config import EvalConfig, ModelConfig
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph as p_build
from primekg_rgcn_tpu_torch.evaluate import evaluator as pev
from primekg_rgcn_tpu_torch.train.torch_interop import (
    params_from_state_dict, state_dict_from_params, params_from_jax)

PARITY = dict(rtol=2e-4, atol=2e-5)
NEAR_TIE = 1e-5
# Queries of the 300 that the near-tie rule leaves out, per direction.
LEFT_OUT = {"tail": 5, "head": 4}


def jax_negatives(num_nodes, num_neg):
    """The JAX evaluator's draws: from ``PRNGKey(seed)``, per batch
    ``key, k = split(key)`` then ``sample_negatives(k, ...)`` on int32
    ids."""

    def negatives(seed):
        state = {"key": jax.random.PRNGKey(seed)}

        def sample(h, t, r):
            state["key"], k = jax.random.split(state["key"])
            out = jneg.sample_negatives(
                k, *(jnp.asarray(x.numpy().astype(np.int32))
                     for x in (h, t, r)), num_nodes, num_neg)
            return tuple(torch.from_numpy(np.asarray(x).astype(np.int64))
                         for x in out)

        return sample

    return negatives


@pytest.fixture(scope="module")
def setup():
    raw = jsyn.primekg_like(seed=1, scale=0.02)
    s, t, r = jsyn.bidirect(raw["src"], raw["dst"], raw["rel"])
    n = raw["num_nodes"]
    jg = j_build(s, t, r, n, 3, use_native="never")
    pg = p_build(s, t, r, n, 3)
    rng = np.random.default_rng(0)
    edges = np.stack([s, t, r], 1)
    test_edges = edges[rng.choice(len(edges), 300, replace=False)]
    jcfg = JModelConfig(num_nodes=n, num_relations=3, embedding_dim=16,
                        hidden_dim=16)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    # Parameters cross through the reference state-dict layout.
    pparams = params_from_state_dict(state_dict_from_params(
        params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))))
    pcfg = ModelConfig.from_dict(jcfg.to_dict())
    return dict(jg=jg, pg=pg, n=n, edges=edges, test_edges=test_edges,
                jcfg=jcfg, jparams=jparams, pcfg=pcfg, pparams=pparams)


@pytest.fixture(scope="module")
def pair(setup):
    """The two evaluators: batches of 128 (the last one short), 2
    negatives per positive, seed 3."""
    kw = dict(batch_size=128, num_neg_samples=2, seed=3)
    j = jev.Evaluator(setup["jparams"], setup["jcfg"], setup["jg"],
                      setup["test_edges"], JEvalConfig(**kw))
    p = pev.Evaluator(setup["pparams"], setup["pcfg"], setup["pg"],
                      setup["test_edges"], EvalConfig(**kw),
                      negatives=jax_negatives(setup["n"], 2))
    return j, p


def untied(p, edges):
    """Mask of queries whose true score is more than NEAR_TIE x the row's
    largest |score| away from every other candidate's (float64 scores of
    the port's embeddings)."""
    emb = p._node_emb.double().numpy()
    rel = p._rel_emb.double().numpy()
    s = (emb[edges[:, 0]] * rel[edges[:, 2]]) @ emb.T
    true = s[np.arange(len(edges)), edges[:, 1]]
    gap = np.abs(s - true[:, None])
    gap[np.arange(len(edges)), edges[:, 1]] = np.inf
    return gap.min(axis=1) > NEAR_TIE * np.abs(s).max(axis=1)


def test_eval_config_matches_jax_without_impl():
    j = JEvalConfig(batch_size=7, k_values=(1, 3)).to_dict()
    assert j.pop("impl") == "segment"
    assert EvalConfig(batch_size=7, k_values=(1, 3)).to_dict() == j
    assert EvalConfig.from_dict({**j, "impl": "xla"}) == EvalConfig(
        batch_size=7, k_values=(1, 3))


def test_embeddings_and_probabilities_match_jax(pair):
    j, p = pair
    np.testing.assert_allclose(p._node_emb.numpy(), np.asarray(j._node_emb),
                               **PARITY)
    js, jl = j.compute_scores_and_labels()
    ps, pl = p.compute_scores_and_labels()
    assert ps.dtype == np.float32 and ps.shape == js.shape == (900,)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_allclose(ps, js, **PARITY)


@pytest.mark.parametrize("direction", ["tail", "head"])
def test_filter_lists_match_jax(pair, setup, direction):
    j, p = pair
    np.testing.assert_array_equal(
        p._filter_lists(setup["edges"], direction),
        j._filter_lists(setup["edges"], direction))


@pytest.mark.parametrize("direction", ["tail", "head"])
def test_raw_and_filtered_ranks_match_jax(pair, setup, direction):
    j, p = pair
    e = setup["test_edges"]
    if direction == "head":
        e = e[:, [1, 0, 2]]
    clean = untied(p, e)
    assert (~clean).sum() == LEFT_OUT[direction]
    want_raw = j._compute_raw_ranks(direction=direction)
    got_raw = p._compute_raw_ranks(direction=direction)
    np.testing.assert_array_equal(got_raw[clean], want_raw[clean])
    want_f = j._filtered_ranks(setup["edges"], direction)
    got_f = p._filtered_ranks(setup["edges"], direction)
    np.testing.assert_array_equal(got_f[clean], want_f[clean])
    assert got_f.min() >= 1 and (got_f <= got_raw).all()
    # The filtered pass cached its raw ranks under the dense key.
    np.testing.assert_array_equal(p._raw_ranks[(direction, False)], got_raw)


def _assert_close_dicts(got, want, tol=1e-4):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_close_dicts(got[k], v, tol)
        else:
            assert abs(got[k] - v) <= tol, (k, got[k], v)


@pytest.mark.parametrize("direction", ["tail", "both"])
@pytest.mark.parametrize("filtered", [False, True])
def test_evaluate_matches_jax(pair, setup, direction, filtered):
    j, p = pair
    known = setup["edges"] if filtered else None
    want = j.evaluate(known_triples=known, rank_direction=direction)
    got = p.evaluate(known_triples=known, rank_direction=direction)
    _assert_close_dicts(got, want)
    assert ("ranking_filtered_both" in got) == (filtered
                                                and direction == "both")
    # A second call draws the same negatives again, in both packages.
    first = p.scores.copy()
    np.testing.assert_array_equal(p.compute_scores_and_labels()[0], first)


def test_save_results_files_are_byte_equal(tmp_path, pair, setup):
    j, _ = pair
    metrics = j.evaluate(known_triples=setup["edges"], rank_direction="both")
    info = {"checkpoint_path": "m.pt", "epoch": 3, "num_nodes": setup["n"],
            "best_val_loss": float("inf"), "best_val_acc": 0.5}
    for info_arg in (info, None):
        jev.save_results(metrics, tmp_path / "jax", info_arg)
        pev.save_results(metrics, tmp_path / "port", info_arg)
        for name in ("results.json", "metrics_summary.txt"):
            assert ((tmp_path / "port" / name).read_bytes()
                    == (tmp_path / "jax" / name).read_bytes())


def test_bad_rank_direction_raises_before_any_compute(setup):
    calls = []
    p = pev.Evaluator(setup["pparams"], setup["pcfg"], setup["pg"],
                      setup["test_edges"], negatives=calls.append)
    with pytest.raises(ValueError, match="rank_direction"):
        p.evaluate(rank_direction="x")
    assert calls == [] and p.scores is None and p._raw_ranks == {}
    with pytest.raises(ValueError, match="rank direction"):
        p.compute_ranking_metrics(direction="x")


def test_filtered_with_node_encode_raises_before_any_compute(setup):
    calls = []
    p = pev.Evaluator(setup["pparams"], setup["pcfg"], setup["pg"],
                      setup["test_edges"], shard_encode="node", n_shards=2,
                      negatives=calls.append)
    with pytest.raises(ValueError, match="dense evaluator"):
        p.evaluate(known_triples=setup["edges"])
    assert calls == [] and p.scores is None
    with pytest.raises(ValueError, match="dense evaluator"):
        p.compute_filtered_ranking_metrics(setup["edges"])


@pytest.mark.parametrize("kwargs,match", [
    (dict(shard_encode="node", n_shards=1), "n_shards >= 2"),
    (dict(shard_encode="node"), "n_shards >= 2"),
    (dict(shard_encode="edge"), "unknown shard_encode"),
])
def test_bad_shard_encode_raises(setup, kwargs, match):
    with pytest.raises(ValueError, match=match):
        pev.Evaluator(setup["pparams"], setup["pcfg"], setup["pg"],
                      setup["test_edges"], **kwargs)


def test_default_negatives_are_seeded(setup):
    a = pev.Evaluator(setup["pparams"], setup["pcfg"], setup["pg"],
                      setup["test_edges"], EvalConfig(batch_size=64))
    s1, labels = a.compute_scores_and_labels()
    s2, _ = a.compute_scores_and_labels()
    s3, _ = a.compute_scores_and_labels(seed=5)
    np.testing.assert_array_equal(s1, s2)
    assert not np.array_equal(s1, s3)
    pos = labels == 1
    np.testing.assert_array_equal(s1[pos], s3[pos])


def test_evaluate_ranks_each_direction_once(setup):
    """``evaluate(known, "both")`` runs one filtered pass per direction
    (3 batches each) and no raw pass: the raw ranks and the ``both``
    blocks come from the passes' caches. Another filter set ranks anew."""
    p = pev.Evaluator(setup["pparams"], setup["pcfg"], setup["pg"],
                      setup["test_edges"], EvalConfig(batch_size=128))
    calls = {"filtered": 0, "raw": 0}

    def counted(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    p._rank_filtered_impl = counted("filtered", p._rank_filtered_impl)
    p._rank_batch = counted("raw", p._rank_batch)
    p.evaluate(known_triples=setup["edges"], rank_direction="both")
    assert calls == {"filtered": 6, "raw": 0}
    again = p._filtered_ranks(setup["edges"].copy(), "tail")
    assert calls == {"filtered": 9, "raw": 0}
    np.testing.assert_array_equal(again, p._filtered_ranks(setup["edges"],
                                                           "tail"))
