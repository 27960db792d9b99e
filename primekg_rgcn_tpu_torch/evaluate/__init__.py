"""Evaluation and serving entry points."""

from primekg_rgcn_tpu_torch.evaluate.evaluator import Evaluator
from primekg_rgcn_tpu_torch.evaluate.metrics import (
    auc_roc,
    average_precision,
    classification_metrics,
    ranking_metrics_from_ranks,
)

__all__ = [
    "auc_roc",
    "average_precision",
    "classification_metrics",
    "ranking_metrics_from_ranks",
    "Evaluator",
]
