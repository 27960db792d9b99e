"""Evaluation plots: confusion matrix, ROC, PR, score distributions.

The counterpart of ``primekg_rgcn_tpu/evaluate/visualize.py``: the same four
PNGs under the same file names. matplotlib is imported inside the plotting
functions only, so this module imports where matplotlib is not installed;
the points and counts behind the plots are numpy.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from primekg_rgcn_tpu_torch.evaluate.metrics import auc_roc, average_precision


def _pyplot():
    """matplotlib's pyplot on the non-interactive Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class ResultsVisualizer:
    def __init__(self, scores: np.ndarray, labels: np.ndarray, output_dir):
        self.scores = np.asarray(scores)
        self.labels = np.asarray(labels)
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)

    def _confusion(self, threshold: float) -> np.ndarray:
        """[true, predicted] counts at ``threshold``."""
        preds = (self.scores >= threshold).astype(int)
        labels = self.labels.astype(int)
        cm = np.zeros((2, 2), dtype=np.int64)
        for t, p in [(0, 0), (0, 1), (1, 0), (1, 1)]:
            cm[t, p] = int(np.sum((labels == t) & (preds == p)))
        return cm

    def plot_confusion_matrix(self, threshold: float = 0.5,
                              filename: str = "confusion_matrix.png"):
        plt = _pyplot()
        cm = self._confusion(threshold)
        fig, ax = plt.subplots(figsize=(8, 6))
        im = ax.imshow(cm, cmap="Blues")
        for i in range(2):
            for j in range(2):
                ax.text(j, i, f"{cm[i, j]:,}", ha="center", va="center",
                        color="black" if cm[i, j] < cm.max() / 2 else "white")
        ax.set_xticks([0, 1], ["Negative", "Positive"])
        ax.set_yticks([0, 1], ["Negative", "Positive"])
        ax.set_xlabel("Predicted")
        ax.set_ylabel("True")
        ax.set_title(f"Confusion Matrix (threshold={threshold})")
        fig.colorbar(im)
        fig.tight_layout()
        fig.savefig(self.output_dir / filename, dpi=150)
        plt.close(fig)

    def _roc_points(self):
        order = np.argsort(-self.scores, kind="mergesort")
        labels = self.labels[order]
        tps = np.cumsum(labels)
        fps = np.cumsum(1 - labels)
        tpr = tps / max(labels.sum(), 1)
        fpr = fps / max((1 - labels).sum(), 1)
        return np.concatenate([[0], fpr]), np.concatenate([[0], tpr])

    def plot_roc_curve(self, filename: str = "roc_curve.png"):
        plt = _pyplot()
        fpr, tpr = self._roc_points()
        auc = float(auc_roc(self.scores, self.labels))
        fig, ax = plt.subplots(figsize=(8, 6))
        ax.plot(fpr, tpr, label=f"ROC (AUC = {auc:.4f})")
        ax.plot([0, 1], [0, 1], "k--", alpha=0.5, label="Random")
        ax.set_xlabel("False Positive Rate")
        ax.set_ylabel("True Positive Rate")
        ax.set_title("ROC Curve")
        ax.legend()
        fig.tight_layout()
        fig.savefig(self.output_dir / filename, dpi=150)
        plt.close(fig)

    def plot_precision_recall_curve(
            self, filename: str = "precision_recall_curve.png"):
        plt = _pyplot()
        order = np.argsort(-self.scores, kind="mergesort")
        labels = self.labels[order]
        tps = np.cumsum(labels)
        precision = tps / np.arange(1, len(labels) + 1)
        recall = tps / max(labels.sum(), 1)
        ap = average_precision(self.scores, self.labels)
        fig, ax = plt.subplots(figsize=(8, 6))
        ax.plot(recall, precision, label=f"PR (AP = {ap:.4f})")
        ax.set_xlabel("Recall")
        ax.set_ylabel("Precision")
        ax.set_title("Precision-Recall Curve")
        ax.legend()
        fig.tight_layout()
        fig.savefig(self.output_dir / filename, dpi=150)
        plt.close(fig)

    def plot_score_distribution(self,
                                filename: str = "score_distribution.png"):
        plt = _pyplot()
        fig, axes = plt.subplots(1, 2, figsize=(14, 6))
        pos = self.scores[self.labels == 1]
        neg = self.scores[self.labels == 0]
        axes[0].hist(pos, bins=50, alpha=0.6, label="Positive",
                     color="tab:blue")
        axes[0].hist(neg, bins=50, alpha=0.6, label="Negative",
                     color="tab:orange")
        axes[0].set_xlabel("Predicted probability")
        axes[0].set_ylabel("Count")
        axes[0].set_title("Score Distribution by Class")
        axes[0].legend()
        axes[1].boxplot([neg, pos], tick_labels=["Negative", "Positive"])
        axes[1].set_ylabel("Predicted probability")
        axes[1].set_title("Score Spread")
        fig.tight_layout()
        fig.savefig(self.output_dir / filename, dpi=150)
        plt.close(fig)

    def generate_all_plots(self, threshold: float = 0.5):
        self.plot_confusion_matrix(threshold)
        self.plot_roc_curve()
        self.plot_precision_recall_curve()
        self.plot_score_distribution()
