"""Evaluation metrics.

The counterpart of ``primekg_rgcn_tpu/evaluate/metrics.py``: closed-form
vectorised metrics in place of the reference's sklearn calls and per-example
argsort loop.

- AUC-ROC is the Mann-Whitney statistic with midrank ties, which equals
  sklearn's trapezoidal ROC integral. It runs on the scores' device, in
  float64 here where the JAX package counts in float32: the midrank sum
  reaches about n^2 / 2, beyond float32's integer range at a few thousand
  scores, so the two agree to float32 rounding (the tests hold them within
  1e-6 at their sizes).
- Average precision is sklearn's step-function integral over the distinct
  scores, on the host in numpy.
- rank(true tail) = 1 + #{entities with a strictly higher score}.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def _midranks(scores: torch.Tensor) -> torch.Tensor:
    """1-indexed midranks (average rank over ties) of each element, in
    float64."""
    sorted_scores, _ = torch.sort(scores)
    lo = torch.searchsorted(sorted_scores, scores, side="left")
    hi = torch.searchsorted(sorted_scores, scores, side="right")
    return (lo + hi + 1).to(torch.float64) / 2.0


def auc_roc(scores, labels) -> torch.Tensor:
    """Exact AUC-ROC (Mann-Whitney with midrank ties), a float64 0-d tensor
    on the scores' device."""
    scores = torch.as_tensor(scores)
    labels = torch.as_tensor(labels, device=scores.device).to(torch.float64)
    ranks = _midranks(scores)
    n_pos = labels.sum()
    n_neg = labels.shape[0] - n_pos
    rank_sum_pos = (ranks * labels).sum()
    return (rank_sum_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


def average_precision(scores: np.ndarray, labels: np.ndarray) -> float:
    """sklearn-exact average precision (host-side numpy).

    AP = sum_n (R_n - R_{n-1}) * P_n over thresholds at distinct scores,
    descending: the step-function integral sklearn uses.
    """
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.float64)
    order = np.argsort(-scores, kind="mergesort")
    scores_s, labels_s = scores[order], labels[order]
    # Threshold boundaries: the last index of each distinct score value.
    distinct = np.where(np.diff(scores_s))[0]
    idx = np.concatenate([distinct, [labels_s.size - 1]])
    tp = np.cumsum(labels_s)[idx]
    fp = (idx + 1) - tp
    precision = tp / (tp + fp)
    recall = tp / max(labels_s.sum(), 1.0)
    recall_prev = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - recall_prev) * precision))


def classification_metrics(
    scores: np.ndarray, labels: np.ndarray, threshold: float = 0.5
) -> Dict[str, float]:
    """AUC-ROC, AUC-PR, precision, recall and F1 at a probability threshold:
    the reference's metric dict. ``scores`` are probabilities in [0, 1]."""
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    preds = (scores >= threshold).astype(np.int64)
    tp = float(np.sum((preds == 1) & (labels == 1)))
    fp = float(np.sum((preds == 1) & (labels == 0)))
    fn = float(np.sum((preds == 0) & (labels == 1)))
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) > 0 else 0.0)
    return {
        "auc_roc": float(auc_roc(scores, labels)),
        "auc_pr": average_precision(scores, labels),
        "precision": precision,
        "recall": recall,
        "f1_score": f1,
        "threshold": threshold,
    }


def ranks_of_true_tails(all_scores: torch.Tensor,
                        true_tails: torch.Tensor) -> torch.Tensor:
    """1-indexed raw (unfiltered) rank of each true tail in its row of the
    [B, N] score matrix: 1 + #{strictly higher}."""
    true_scores = all_scores.gather(1, true_tails[:, None])
    return 1 + (all_scores > true_scores).sum(dim=1)


def ranking_metrics_from_ranks(
    ranks: np.ndarray, k_values: Sequence[int] = (10, 50)
) -> Dict[str, float]:
    """MRR, mean and median rank, and Hits@K from 1-indexed ranks."""
    ranks = np.asarray(ranks, dtype=np.float64)
    out = {
        "mrr": float(np.mean(1.0 / ranks)),
        "mean_rank": float(np.mean(ranks)),
        "median_rank": float(np.median(ranks)),
    }
    for k in k_values:
        out[f"hits@{k}"] = float(np.mean(ranks <= k))
    return out
