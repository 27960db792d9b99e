"""Baseline method comparison.

The counterpart of ``primekg_rgcn_tpu/analyze/compare_methods.py`` (the
reference's MethodComparator and its baseline zoo, src/compare_methods.py):
RandomBaseline (88-102),
NodeDegreeBaseline — geometric mean of max-normalized degrees (105-163),
SimpleTransE — from-scratch margin-loss TransE trained with SGD (166-318,
re-done in vectorized numpy), and RGCNMethod — checkpoint embeddings scored
by cosine similarity (321-397).

The evaluation protocol is the reference's own (and is knowingly degenerate,
see SURVEY.md §2.3/A6): sampled drug-disease pairs with proxy labels
(top-50% of each method's scores = positive, compare_methods.py:500-521),
plus a 100-pair all-disease ranking loop, per-disease-frequency breakdown,
and MOCK p-value significance (labeled as mock, 701-740). AUC-ROC and
average precision are the port's ``evaluate/metrics``. Outputs:
test_results.csv (with ``csv``, as pandas writes it), LaTeX + Markdown
tables, a report, and bar charts where matplotlib is installed.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from primekg_rgcn_tpu_torch.analyze.core import (AnalysisContext, pyplot,
                                                 write_csv)
from primekg_rgcn_tpu_torch.evaluate.metrics import auc_roc, average_precision

logger = logging.getLogger(__name__)


class BaselineMethod:
    """Abstract baseline (reference: compare_methods.py:55-85)."""

    name = "base"

    def fit(self, train_edges: np.ndarray, num_nodes: int) -> None:
        raise NotImplementedError

    def predict(self, heads: np.ndarray, tails: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class RandomBaseline(BaselineMethod):
    name = "Random"

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def fit(self, train_edges, num_nodes):
        pass

    def predict(self, heads, tails):
        return self.rng.random(len(heads))


class NodeDegreeBaseline(BaselineMethod):
    """Geometric mean of max-normalized node degrees
    (reference: compare_methods.py:105-163)."""

    name = "NodeDegree"

    def fit(self, train_edges, num_nodes):
        deg = np.bincount(train_edges[:, 0], minlength=num_nodes) \
            + np.bincount(train_edges[:, 1], minlength=num_nodes)
        self.norm_deg = deg / max(deg.max(), 1)

    def predict(self, heads, tails):
        return np.sqrt(self.norm_deg[heads] * self.norm_deg[tails])


class SimpleTransE(BaselineMethod):
    """Margin-loss TransE with vectorized SGD (reference has a per-batch
    python loop, compare_methods.py:166-318; this is a fresh vectorized
    implementation of the same objective: ||h + r - t|| margin ranking)."""

    name = "TransE"

    def __init__(self, dim: int = 50, epochs: int = 50, lr: float = 0.01,
                 margin: float = 1.0, batch_size: int = 4096, seed: int = 0):
        self.dim, self.epochs, self.lr = dim, epochs, lr
        self.margin, self.batch_size, self.seed = margin, batch_size, seed

    def fit(self, train_edges, num_nodes):
        rng = np.random.default_rng(self.seed)
        e = train_edges
        n_rel = int(e[:, 2].max()) + 1 if len(e) else 1
        self.ent = rng.normal(0, 0.1, (num_nodes, self.dim))
        self.rel = rng.normal(0, 0.1, (n_rel, self.dim))
        for _ in range(self.epochs):
            perm = rng.permutation(len(e))
            for s in range(0, len(e), self.batch_size):
                b = e[perm[s:s + self.batch_size]]
                h, t, r = b[:, 0], b[:, 1], b[:, 2]
                corrupt = rng.integers(0, num_nodes, len(b))
                swap = rng.random(len(b)) < 0.5
                nh = np.where(swap, corrupt, h)
                nt = np.where(swap, t, corrupt)

                d_pos = self.ent[h] + self.rel[r] - self.ent[t]
                d_neg = self.ent[nh] + self.rel[r] - self.ent[nt]
                pos = np.linalg.norm(d_pos, axis=1)
                neg = np.linalg.norm(d_neg, axis=1)
                active = (self.margin + pos - neg) > 0
                if not active.any():
                    continue
                g_pos = d_pos[active] / np.maximum(pos[active, None], 1e-9)
                g_neg = d_neg[active] / np.maximum(neg[active, None], 1e-9)
                lr = self.lr
                np.add.at(self.ent, h[active], -lr * g_pos)
                np.add.at(self.ent, t[active], lr * g_pos)
                np.add.at(self.rel, r[active], -lr * (g_pos - g_neg))
                np.add.at(self.ent, nh[active], lr * g_neg)
                np.add.at(self.ent, nt[active], -lr * g_neg)
        norms = np.linalg.norm(self.ent, axis=1, keepdims=True)
        self.ent = self.ent / np.maximum(norms, 1e-9)

    def predict(self, heads, tails):
        # Score = -min distance over relations, rescaled to [0, 1].
        d = np.stack([
            np.linalg.norm(self.ent[heads] + self.rel[r] - self.ent[tails],
                           axis=1)
            for r in range(len(self.rel))
        ])
        dist = d.min(axis=0)
        return 1.0 / (1.0 + dist)


class RGCNMethod(BaselineMethod):
    """The trained model, scored by embedding cosine similarity exactly like
    the analysis suite (reference: compare_methods.py:321-397)."""

    name = "RGCN"

    def __init__(self, ctx: AnalysisContext):
        self.ctx = ctx

    def fit(self, train_edges, num_nodes):
        pass

    def predict(self, heads, tails):
        e = self.ctx.embeddings_norm
        return ((e[heads] * e[tails]).sum(axis=1) + 1.0) / 2.0


class MethodComparator:
    def __init__(self, ctx: AnalysisContext, output_dir,
                 methods: Optional[Sequence[str]] = None,
                 transe_epochs: int = 50):
        self.ctx = ctx
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        zoo = {
            "random": RandomBaseline(),
            "degree": NodeDegreeBaseline(),
            "transe": SimpleTransE(epochs=transe_epochs),
            "rgcn": RGCNMethod(ctx),
        }
        keys = list(methods or zoo)
        self.methods = {k: zoo[k] for k in keys if k in zoo}

    def fit_all(self):
        n = self.ctx.full_graph.num_nodes
        for name, m in self.methods.items():
            logger.info("Training %s...", m.name)
            m.fit(self.ctx.train_edges, n)

    def evaluate_method(self, method: BaselineMethod,
                        k_values=(1, 5, 10, 20, 50),
                        num_samples: int = 1000, seed: int = 42) -> Dict:
        """The reference's proxy-label protocol
        (compare_methods.py:476-585)."""
        ctx = self.ctx
        rng = np.random.default_rng(seed)
        drugs = rng.choice(ctx.drug_indices, num_samples, replace=True)
        diseases = rng.choice(ctx.disease_indices, num_samples, replace=True)
        scores = np.asarray(method.predict(drugs, diseases), dtype=np.float64)

        neg_drugs = rng.choice(ctx.drug_indices, num_samples, replace=True)
        neg_dis = rng.choice(ctx.disease_indices, num_samples, replace=True)
        neg_scores = np.asarray(method.predict(neg_drugs, neg_dis),
                                dtype=np.float64)

        combined = np.concatenate([scores, neg_scores])
        labels = np.concatenate([np.ones(num_samples), np.zeros(num_samples)])
        metrics = {
            "auc_roc": self._auc(combined, labels),
            "avg_precision": average_precision(combined, labels),
        }

        # Ranking over all diseases for a 100-pair subsample.
        n_rank = min(100, num_samples)
        ranks = []
        sel = rng.choice(num_samples, n_rank, replace=False)
        all_dis = np.asarray(ctx.disease_indices)
        for i in sel:
            s = method.predict(np.full(len(all_dis), drugs[i]), all_dis)
            true_pos = np.flatnonzero(all_dis == diseases[i])
            if len(true_pos) == 0:
                ranks.append(len(all_dis))
                continue
            ranks.append(1 + int(np.sum(s > s[true_pos[0]])))
        ranks = np.asarray(ranks, dtype=np.float64)
        metrics["mrr"] = float(np.mean(1.0 / ranks))
        for k in k_values:
            metrics[f"hits@{k}"] = float(np.mean(ranks <= k))
        return metrics

    def frequency_breakdown(self, method: BaselineMethod,
                            num_samples: int = 1000, seed: int = 1) -> Dict:
        """AUC split by disease degree tertiles
        (reference: compare_methods.py:616-699)."""
        ctx = self.ctx
        deg = np.bincount(ctx.full_edges[:, 0],
                          minlength=ctx.full_graph.num_nodes) \
            + np.bincount(ctx.full_edges[:, 1],
                          minlength=ctx.full_graph.num_nodes)
        dis_deg = deg[ctx.disease_indices]
        terciles = np.quantile(dis_deg, [1 / 3, 2 / 3])
        groups = {"rare": ctx.disease_indices[dis_deg <= terciles[0]],
                  "medium": ctx.disease_indices[(dis_deg > terciles[0])
                                                & (dis_deg <= terciles[1])],
                  "frequent": ctx.disease_indices[dis_deg > terciles[1]]}
        rng = np.random.default_rng(seed)
        out = {}
        for gname, dis in groups.items():
            if len(dis) == 0:
                continue
            n = min(num_samples, 500)
            d = rng.choice(ctx.drug_indices, n, replace=True)
            s1 = method.predict(d, rng.choice(dis, n, replace=True))
            s2 = method.predict(rng.choice(ctx.drug_indices, n, replace=True),
                                rng.choice(dis, n, replace=True))
            combined = np.concatenate([s1, s2])
            labels = np.concatenate([np.ones(n), np.zeros(n)])
            out[gname] = self._auc(combined, labels)
        return out

    def _auc(self, scores: np.ndarray, labels: np.ndarray) -> float:
        """AUC-ROC on the context's device, of the scores rounded to
        float32 as the JAX tool ranks them (so that ties are the same)."""
        return float(auc_roc(
            torch.as_tensor(scores, dtype=torch.float32,
                            device=self.ctx.device),
            torch.as_tensor(labels, device=self.ctx.device)))

    def mock_significance(self, results: Dict[str, Dict],
                          seed: int = 7) -> Dict:
        """MOCK pairwise p-values, as in the reference
        (compare_methods.py:701-740). Labeled mock; not a real test."""
        rng = np.random.default_rng(seed)
        names = list(results)
        pvals = {}
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                gap = abs(results[a]["auc_roc"] - results[b]["auc_roc"])
                pvals[f"{a}_vs_{b}"] = float(
                    np.clip(0.5 * np.exp(-10 * gap) + rng.normal(0, 0.02),
                            1e-4, 1.0))
        return pvals

    def plot_significance_heatmap(self, results: Dict[str, Dict],
                                  pvals: Dict, metric: str = "auc_roc"):
        """Method x method p-value heatmap PNG (MOCK values, like the
        source dict). Mirrors the reference's seaborn heatmap contract
        (reference: src/compare_methods.py:846-877 — annotated cells,
        RdYlGn_r at vmin=0/vmax=0.1, black gridlines,
        ``significance_heatmap_{metric}.png``); rendered with matplotlib
        directly (no seaborn); skipped where matplotlib is not installed."""
        plt = pyplot(logger, "the significance heatmap PNG")
        if plt is None:
            return
        names = list(results)
        n = len(names)
        mat = np.zeros((n, n))
        for i, a in enumerate(names):
            for j, b in enumerate(names):
                if i == j:
                    mat[i, j] = 1.0
                else:
                    mat[i, j] = pvals.get(f"{a}_vs_{b}",
                                          pvals.get(f"{b}_vs_{a}", np.nan))
        fig, ax = plt.subplots(figsize=(10, 8))
        im = ax.imshow(mat, cmap="RdYlGn_r", vmin=0.0, vmax=0.1)
        ax.set_xticks(range(n), names, rotation=30, ha="right")
        ax.set_yticks(range(n), names)
        for i in range(n):
            for j in range(n):
                ax.text(j, i, f"{mat[i, j]:.3f}", ha="center", va="center",
                        fontsize=9,
                        color="black" if mat[i, j] > 0.05 else "white")
        # Black cell borders, matching the reference's linewidths=1 style.
        ax.set_xticks(np.arange(-0.5, n), minor=True)
        ax.set_yticks(np.arange(-0.5, n), minor=True)
        ax.grid(which="minor", color="black", linewidth=1)
        ax.tick_params(which="minor", length=0)
        fig.colorbar(im, ax=ax, label="p-value (MOCK)")
        ax.set_title(f"Statistical Significance (MOCK p-values) - {metric}",
                     fontweight="bold")
        ax.set_xlabel("Method")
        ax.set_ylabel("Method")
        fig.tight_layout()
        out = self.output_dir / f"significance_heatmap_{metric}.png"
        fig.savefig(out, dpi=150, bbox_inches="tight")
        plt.close(fig)
        logger.info("Saved significance heatmap to %s", out)

    # -- outputs -------------------------------------------------------------
    def save_outputs(self, results: Dict[str, Dict],
                     freq: Optional[Dict] = None,
                     pvals: Optional[Dict] = None):
        names = list(results)
        columns = list(results[names[0]]) if names else []
        write_csv(self.output_dir / "test_results.csv", ["method", *columns],
                  [[n, *(results[n][c] for c in columns)] for n in names])
        plt = pyplot(logger, "the comparison PNGs")
        if plt is not None:
            self._plot(plt, results, freq)

        # Markdown + LaTeX paper tables (reference: 742-799, 879-949).
        md = ["| Method | AUC-ROC | AP | MRR | Hits@10 |",
              "|---|---|---|---|---|"]
        tex = ["\\begin{tabular}{lcccc}", "\\toprule",
               "Method & AUC-ROC & AP & MRR & Hits@10 \\\\", "\\midrule"]
        for name, m in results.items():
            md.append(f"| {name} | {m['auc_roc']:.4f} | "
                      f"{m['avg_precision']:.4f} | {m['mrr']:.4f} | "
                      f"{m.get('hits@10', 0):.4f} |")
            tex.append(f"{name} & {m['auc_roc']:.4f} & "
                       f"{m['avg_precision']:.4f} & {m['mrr']:.4f} & "
                       f"{m.get('hits@10', 0):.4f} \\\\")
        tex += ["\\bottomrule", "\\end{tabular}"]
        (self.output_dir / "results_table.md").write_text("\n".join(md))
        (self.output_dir / "results_table.tex").write_text("\n".join(tex))

        lines = ["=" * 60, "METHOD COMPARISON", "=" * 60, "",
                 "Protocol note: proxy labels (top-50% of sampled-pair",
                 "scores treated as positive), as in the reference;",
                 "absolute numbers are not meaningful, only relative.", ""]
        for name, m in results.items():
            lines.append(f"{name}: " + ", ".join(
                f"{k}={v:.4f}" for k, v in m.items()))
        if freq:
            lines += ["", "Per-frequency AUC (all methods):"]
            for mname, per_bin in sorted(freq.items()):
                lines.append(f"  {mname}: "
                             + str({k: round(v, 4)
                                    for k, v in per_bin.items()}))
        if pvals:
            lines += ["", "MOCK significance p-values:",
                      str({k: round(v, 4) for k, v in pvals.items()})]
        (self.output_dir / "comparison_report.txt").write_text(
            "\n".join(lines))

    def _plot(self, plt, results: Dict[str, Dict], freq: Optional[Dict]):
        # Multi-panel metric comparison (reference: 2x3 grid with value
        # labels, src/compare_methods.py:742-799).
        metrics = [("auc_roc", "AUC-ROC"), ("avg_precision", "Avg Precision"),
                   ("mrr", "MRR"), ("hits@10", "Hits@10"),
                   ("hits@50", "Hits@50")]
        fig, axes = plt.subplots(2, 3, figsize=(15, 10))
        axes = axes.flatten()
        names = list(results)
        palette = plt.cm.Set3(np.linspace(0, 1, len(names)))
        for ax, (metric, label) in zip(axes, metrics):
            if not names or metric not in results[names[0]]:
                ax.axis("off")
                continue
            bars = ax.bar(names, [results[n][metric] for n in names],
                          alpha=0.8, edgecolor="black", color=palette)
            for bar in bars:
                ax.text(bar.get_x() + bar.get_width() / 2, bar.get_height(),
                        f"{bar.get_height():.3f}", ha="center", va="bottom",
                        fontsize=9)
            if metric == "auc_roc":
                ax.axhline(0.5, color="gray", linestyle="--", label="chance")
                ax.legend()
            ax.set_ylabel(label)
            ax.set_ylim(0, 1.0)
            ax.grid(axis="y", alpha=0.3)
            ax.tick_params(axis="x", rotation=30)
        fig.delaxes(axes[-1])
        fig.suptitle("Method comparison (proxy-label protocol)",
                     fontweight="bold")
        fig.tight_layout()
        fig.savefig(self.output_dir / "method_comparison.png", dpi=150)
        plt.close(fig)

        # Grouped per-disease-frequency AUC chart, every method
        # (reference: src/compare_methods.py:616-699 evaluates all methods
        # per frequency bin).
        if freq:
            bins = ["rare", "medium", "frequent"]
            fig, ax = plt.subplots(figsize=(11, 6))
            width = 0.8 / max(len(freq), 1)
            x = np.arange(len(bins))
            for i, (mname, per_bin) in enumerate(sorted(freq.items())):
                vals = [per_bin.get(b, np.nan) for b in bins]
                bars = ax.bar(x + (i - (len(freq) - 1) / 2) * width, vals,
                              width, label=mname, alpha=0.85,
                              edgecolor="black")
                for bar in bars:
                    if np.isfinite(bar.get_height()):
                        ax.text(bar.get_x() + bar.get_width() / 2,
                                bar.get_height(), f"{bar.get_height():.2f}",
                                ha="center", va="bottom", fontsize=8)
            ax.axhline(0.5, color="gray", linestyle="--")
            ax.set_xticks(x, [b.capitalize() for b in bins])
            ax.set_xlabel("Disease training-degree tercile")
            ax.set_ylabel("AUC-ROC")
            ax.set_ylim(0, 1.0)
            ax.set_title("Per-disease-frequency AUC by method")
            ax.legend()
            fig.tight_layout()
            fig.savefig(self.output_dir / "frequency_breakdown.png", dpi=150)
            plt.close(fig)

    def run(self, num_samples: int = 1000, frequency_analysis: bool = False,
            statistical_tests: bool = False) -> Dict[str, Dict]:
        self.fit_all()
        results = {}
        for name, m in self.methods.items():
            logger.info("Evaluating %s...", m.name)
            results[m.name] = self.evaluate_method(m, num_samples=num_samples)
        freq = None
        if frequency_analysis:
            # Every method, not just RGCN (reference:
            # src/compare_methods.py:616-699 bins ALL methods).
            freq = {m.name: self.frequency_breakdown(m, num_samples)
                    for m in self.methods.values()}
        pvals = self.mock_significance(results) if statistical_tests else None
        self.save_outputs(results, freq, pvals)
        if pvals:
            self.plot_significance_heatmap(results, pvals)
        return results


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Compare RGCN against baselines")
    p.add_argument("--model_path", default="output/models/best_model.pt")
    p.add_argument("--data_dir", default="data/processed")
    p.add_argument("--methods", nargs="+",
                   default=["random", "degree", "transe", "rgcn"])
    p.add_argument("--output_dir", default="results/comparison")
    p.add_argument("--frequency_analysis", action="store_true")
    p.add_argument("--statistical_tests", action="store_true")
    p.add_argument("--transe_epochs", type=int, default=50)
    p.add_argument("--num_samples", type=int, default=1000)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    ctx = AnalysisContext(args.model_path, args.data_dir, device=args.device)
    cmp = MethodComparator(ctx, args.output_dir, args.methods,
                           args.transe_epochs)
    return cmp.run(args.num_samples, args.frequency_analysis,
                   args.statistical_tests)


if __name__ == "__main__":
    main()
