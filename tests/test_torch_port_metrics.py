"""The port's evaluation metrics against the JAX package's on the same numpy
arrays, ties included. Tolerances: AUC-ROC within 1e-6 (the port counts in
float64, the JAX package in float32); AP, precision, recall, F1, ranks and
ranking metrics exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.evaluate import metrics as jm
from primekg_rgcn_tpu_torch.evaluate import metrics as pm


def _cases():
    rng = np.random.default_rng(0)
    n = 2000
    yield "random", rng.random(n).astype(np.float32), \
        (rng.random(n) < 0.3).astype(np.float64)
    # Heavy ties: 7 distinct scores over 2,000 examples.
    yield "heavy_ties", (rng.integers(0, 7, n) / 7).astype(np.float32), \
        (rng.random(n) < 0.5).astype(np.float64)
    yield "all_ties", np.full(300, 0.5, np.float32), \
        (np.arange(300) % 3 == 0).astype(np.float64)
    yield "one_pos_one_neg", np.array([0.2, 0.9], np.float32), \
        np.array([1.0, 0.0])
    yield "separable", np.linspace(0, 1, 101, dtype=np.float32), \
        (np.arange(101) > 50).astype(np.float64)
    yield "threshold_ties", np.array([0.5, 0.5, 0.49, 0.51, 0.5], np.float32), \
        np.array([1.0, 0.0, 1.0, 0.0, 1.0])


CASES = list(_cases())


@pytest.mark.parametrize("name,scores,labels", CASES,
                         ids=[c[0] for c in CASES])
def test_classification_metrics_match_jax(name, scores, labels):
    got = pm.classification_metrics(scores, labels)
    want = jm.classification_metrics(scores, labels)
    assert got.keys() == want.keys()
    assert abs(got["auc_roc"] - want["auc_roc"]) <= 1e-6
    for k in ("auc_pr", "precision", "recall", "f1_score", "threshold"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("name,scores,labels", CASES,
                         ids=[c[0] for c in CASES])
def test_auc_and_midranks_match_jax(name, scores, labels):
    got = pm.auc_roc(torch.from_numpy(scores), torch.from_numpy(labels))
    assert got.dtype == torch.float64
    assert abs(float(got) - float(jm.auc_roc(jnp.asarray(scores),
                                             jnp.asarray(labels)))) <= 1e-6
    np.testing.assert_array_equal(
        pm._midranks(torch.from_numpy(scores)).numpy(),
        np.asarray(jm._midranks(jnp.asarray(scores)), np.float64))


@pytest.mark.parametrize("ties", [False, True])
def test_ranks_of_true_tails_match_jax(ties):
    rng = np.random.default_rng(1)
    b, n = 64, 500
    scores = rng.normal(size=(b, n)).astype(np.float32)
    if ties:
        scores = np.round(scores, 1)
    tails = rng.integers(0, n, b)
    got = pm.ranks_of_true_tails(torch.from_numpy(scores),
                                 torch.from_numpy(tails))
    want = jm.ranks_of_true_tails(jnp.asarray(scores), jnp.asarray(tails))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ranking_metrics_from_ranks_match_jax():
    rng = np.random.default_rng(2)
    for ranks in (rng.integers(1, 400, 333), np.ones(5, np.int64),
                  np.array([1, 2, 2, 50, 51, 10])):
        for k_values in ((10, 50), (1, 3, 100)):
            assert (pm.ranking_metrics_from_ranks(ranks, k_values)
                    == jm.ranking_metrics_from_ranks(ranks, k_values))


@pytest.mark.parametrize("name,scores,labels", CASES[:3],
                         ids=[c[0] for c in CASES[:3]])
def test_visualizer_points_match_jax(tmp_path, name, scores, labels):
    pytest.importorskip("matplotlib")
    from primekg_rgcn_tpu.evaluate.visualize import ResultsVisualizer as JViz
    from primekg_rgcn_tpu_torch.evaluate.visualize import ResultsVisualizer

    got = ResultsVisualizer(scores, labels, tmp_path)
    want = JViz(scores, labels, tmp_path)
    for a, b in zip(got._roc_points(), want._roc_points()):
        np.testing.assert_array_equal(a, b)
    preds = scores >= 0.5
    cm = got._confusion(0.5)
    assert cm.sum() == len(scores)
    assert cm[1, 1] == np.sum(preds & (labels == 1))
    assert cm[0, 1] == np.sum(preds & (labels == 0))
