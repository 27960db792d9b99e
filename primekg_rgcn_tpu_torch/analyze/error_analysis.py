"""Prediction error analysis.

The counterpart of ``primekg_rgcn_tpu/analyze/error_analysis.py`` (the
reference's ErrorAnalyzer, src/error_analysis.py): score every test edge
(all positives) with the DistMult decoder over the context's embeddings on
its device, bucket the mistakes, aggregate their patterns, and write the
report, the CSVs (with ``csv``, as pandas writes them) and, where
matplotlib is installed, the plots.

Preserved semantics:
- "false negatives" = positive test edges with sigmoid score < threshold
  (error_analysis.py:216-242)
- "low-confidence" = correct positives in [threshold, 0.7)
  (error_analysis.py:169-201)
- pattern aggregation by relation, node type and entity frequency
  (error_analysis.py:244-295)
Outputs: error_patterns.png, score_distribution.png, entity_analysis.png,
error_analysis_report.txt, false_negatives.csv, low_confidence.csv.
"""

from __future__ import annotations

import logging
from collections import Counter
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from primekg_rgcn_tpu_torch.analyze.core import (AnalysisContext, pyplot,
                                                 write_csv)

logger = logging.getLogger(__name__)


class ErrorAnalyzer:
    def __init__(self, ctx: AnalysisContext, test_edges: np.ndarray,
                 output_dir, *, threshold: float = 0.5,
                 batch_size: int = 4096):
        self.ctx = ctx
        self.test_edges = np.asarray(test_edges)
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.threshold = threshold
        self.batch_size = batch_size
        self.scores: np.ndarray = np.array([])

    def score_test_edges(self) -> np.ndarray:
        """Sigmoid DistMult scores of all test triples, in batches on the
        context's device."""
        from primekg_rgcn_tpu_torch.ops.distmult import distmult_score

        emb = torch.tensor(self.ctx.embeddings, device=self.ctx.device)
        rel_emb = self.ctx.params["decoder"]["rel_emb"]
        e = torch.as_tensor(self.test_edges, dtype=torch.long,
                            device=emb.device)
        out = []
        with torch.no_grad():
            for s in range(0, len(e), self.batch_size):
                b = e[s:s + self.batch_size]
                out.append(torch.sigmoid(distmult_score(
                    emb[b[:, 0]], emb[b[:, 1]], rel_emb[b[:, 2]])).cpu())
        self.scores = (torch.cat(out).numpy() if out
                       else np.zeros(0, np.float32))
        return self.scores

    # -- error buckets -------------------------------------------------------
    def false_negatives(self) -> np.ndarray:
        """Indices of positives scored below threshold."""
        return np.flatnonzero(self.scores < self.threshold)

    def low_confidence(self) -> np.ndarray:
        """Correct but weakly-scored positives in [threshold, 0.7)."""
        return np.flatnonzero((self.scores >= self.threshold)
                              & (self.scores < 0.7))

    def analyze_patterns(self, idxs: np.ndarray) -> Dict:
        """Counter-based aggregation (reference: error_analysis.py:244-295)."""
        e = self.test_edges[idxs]
        types = self.ctx.node_types
        rel_names = {0: "drug-gene", 1: "gene-disease", 2: "gene-gene"}
        if self.ctx.mappings:
            rel_names = self.ctx.mappings["idx2relation"]
        by_rel = Counter(rel_names.get(int(r), str(int(r))) for r in e[:, 2])
        by_head_type = Counter(str(types[h]) for h in e[:, 0])
        by_tail_type = Counter(str(types[t]) for t in e[:, 1])
        by_entity = Counter()
        by_head = Counter()
        by_tail = Counter()
        for h, t in e[:, :2]:
            by_entity[int(h)] += 1
            by_entity[int(t)] += 1
            by_head[int(h)] += 1
            by_tail[int(t)] += 1
        return {
            "count": int(len(idxs)),
            "by_relation": dict(by_rel),
            "by_head_type": dict(by_head_type),
            "by_tail_type": dict(by_tail_type),
            "top_entities": by_entity.most_common(20),
            # Separate head/tail problem lists (reference:
            # src/error_analysis.py:283-284 top_problematic_heads/tails).
            "top_heads": by_head.most_common(10),
            "top_tails": by_tail.most_common(10),
        }

    # -- outputs -------------------------------------------------------------
    # Three figures at the reference's multi-panel depth (reference:
    # src/error_analysis.py:297-462 — overview bar+pie, 2x2 by-node-type,
    # 2x2 problematic entities + per-bucket score histograms), under this
    # repo's established filenames.
    def plot_all(self, fn_patterns: Dict, lc_patterns: Dict):
        plt = pyplot(logger, "the error-analysis PNGs")
        if plt is None:
            return
        fn_scores = self.scores[self.false_negatives()]
        lc_scores = self.scores[self.low_confidence()]

        # error_patterns.png (2x2): counts-by-type bar + accuracy pie +
        # per-bucket by-relation bars.
        fig, axes = plt.subplots(2, 2, figsize=(15, 11))
        ax = axes[0, 0]
        counts = [lc_patterns["count"], fn_patterns["count"]]
        bars = ax.bar(["Low Confidence\nPredictions", "False Negatives"],
                      counts, color=["tab:orange", "tab:red"], alpha=0.8,
                      edgecolor="black")
        for bar in bars:
            ax.text(bar.get_x() + bar.get_width() / 2, bar.get_height(),
                    f"{int(bar.get_height()):,}", ha="center", va="bottom")
        ax.set_ylabel("Count")
        ax.set_title("Prediction Errors by Type")

        ax = axes[0, 1]
        total = len(self.scores)
        correct = int((self.scores >= self.threshold).sum())
        if total:
            ax.pie([correct, total - correct],
                   labels=["Correct", "Incorrect"], autopct="%1.1f%%",
                   colors=["tab:green", "tab:red"], startangle=90)
        ax.set_title("Overall Prediction Accuracy")

        for ax, pat, title, color in [
                (axes[1, 0], fn_patterns, "False negatives", "tab:red"),
                (axes[1, 1], lc_patterns, "Low confidence", "tab:orange")]:
            items = sorted(pat["by_relation"].items())
            ax.bar([k for k, _ in items], [v for _, v in items], color=color)
            ax.set_title(f"{title} by relation (n={pat['count']})")
            ax.tick_params(axis="x", rotation=20)
        fig.tight_layout()
        fig.savefig(self.output_dir / "error_patterns.png", dpi=150)
        plt.close(fig)

        # score_distribution.png (1x3): all positives + each error bucket.
        fig, axes = plt.subplots(1, 3, figsize=(18, 5.5))
        ax = axes[0]
        ax.hist(self.scores, bins=60, color="tab:blue", alpha=0.8)
        ax.axvline(self.threshold, color="tab:red", linestyle="--",
                   label=f"threshold={self.threshold}")
        ax.axvline(0.7, color="tab:orange", linestyle="--",
                   label="low-confidence bound (0.7)")
        ax.set_xlabel("Sigmoid score of positive test edges")
        ax.set_ylabel("Count")
        ax.set_title("Test-edge score distribution")
        ax.legend()
        for ax, s, title, color in [
                (axes[1], fn_scores, "False-negative scores", "tab:red"),
                (axes[2], lc_scores, "Low-confidence scores", "tab:orange")]:
            if len(s):
                ax.hist(s, bins=30, color=color, alpha=0.8,
                        edgecolor="black")
            ax.axvline(self.threshold, color="black", linestyle="--",
                       label=f"threshold={self.threshold}")
            ax.set_xlabel("Sigmoid score")
            ax.set_ylabel("Count")
            ax.set_title(title)
            ax.legend()
        fig.tight_layout()
        fig.savefig(self.output_dir / "score_distribution.png", dpi=150)
        plt.close(fig)

        # entity_analysis.png (2x2): top problematic FN heads/tails +
        # by-node-type breakdowns for both buckets.
        fig, axes = plt.subplots(2, 2, figsize=(16, 12))
        names = self.ctx.node_names
        for ax, tops, title in [
                (axes[0, 0], fn_patterns["top_heads"],
                 "Top problematic head entities (FN)"),
                (axes[0, 1], fn_patterns["top_tails"],
                 "Top problematic tail entities (FN)")]:
            if tops:
                labels = [str(names[i])[:30] for i, _ in tops]
                ax.barh(labels[::-1], [c for _, c in tops][::-1],
                        color="tab:red", alpha=0.8, edgecolor="black")
            ax.set_xlabel("False-negative count")
            ax.set_title(title)

        for ax, pat, title, color in [
                (axes[1, 0], fn_patterns, "False negatives by node type",
                 "tab:red"),
                (axes[1, 1], lc_patterns, "Low confidence by node type",
                 "tab:orange")]:
            keys = sorted(set(pat["by_head_type"]) | set(pat["by_tail_type"]))
            x = np.arange(len(keys))
            ax.bar(x - 0.2, [pat["by_head_type"].get(k, 0) for k in keys],
                   width=0.4, label="head", color=color, alpha=0.9)
            ax.bar(x + 0.2, [pat["by_tail_type"].get(k, 0) for k in keys],
                   width=0.4, label="tail", color=color, alpha=0.5)
            ax.set_xticks(x)
            ax.set_xticklabels(keys, rotation=20)
            ax.set_ylabel("Count")
            ax.set_title(title)
            ax.legend()
        fig.tight_layout()
        fig.savefig(self.output_dir / "entity_analysis.png", dpi=150)
        plt.close(fig)

    def save_csvs(self, fn_idx: np.ndarray, lc_idx: np.ndarray):
        names = self.ctx.node_names
        for idxs, fname in [(fn_idx, "false_negatives.csv"),
                            (lc_idx, "low_confidence.csv")]:
            e = self.test_edges[idxs]
            write_csv(self.output_dir / fname,
                      ["head_idx", "tail_idx", "relation", "head_name",
                       "tail_name", "score"],
                      zip(e[:, 0], e[:, 1], e[:, 2],
                          [names[i] for i in e[:, 0]],
                          [names[i] for i in e[:, 1]], self.scores[idxs]))

    def save_report(self, fn_patterns: Dict, lc_patterns: Dict):
        lines = ["=" * 60, "PREDICTION ERROR ANALYSIS", "=" * 60, "",
                 f"Test edges scored: {len(self.scores):,}",
                 f"Threshold: {self.threshold}",
                 f"Mean score: {self.scores.mean():.4f}", ""]
        for title, pat in [("FALSE NEGATIVES (score < threshold)",
                            fn_patterns),
                           ("LOW-CONFIDENCE CORRECT (threshold <= s < 0.7)",
                            lc_patterns)]:
            lines += [title, "-" * 60, f"count: {pat['count']:,}"]
            lines += [f"  by relation: {pat['by_relation']}"]
            lines += [f"  by head type: {pat['by_head_type']}"]
            lines += [f"  by tail type: {pat['by_tail_type']}"]
            lines += ["  top entities:"]
            for idx, c in pat["top_entities"][:10]:
                lines.append(f"    {self.ctx.node_names[idx][:40]}: {c}")
            lines.append("")
        (self.output_dir / "error_analysis_report.txt").write_text(
            "\n".join(lines))

    def run(self) -> Dict:
        self.score_test_edges()
        fn_idx = self.false_negatives()
        lc_idx = self.low_confidence()
        fn_p = self.analyze_patterns(fn_idx)
        lc_p = self.analyze_patterns(lc_idx)
        self.plot_all(fn_p, lc_p)
        self.save_csvs(fn_idx, lc_idx)
        self.save_report(fn_p, lc_p)
        logger.info("Error analysis: %d false negatives, %d low-confidence "
                    "of %d test edges", len(fn_idx), len(lc_idx),
                    len(self.scores))
        return {"false_negatives": fn_p, "low_confidence": lc_p}


def main(argv=None):
    import argparse

    from primekg_rgcn_tpu_torch.data import artifacts

    p = argparse.ArgumentParser(description="Analyze prediction errors")
    p.add_argument("--model_path", required=True)
    p.add_argument("--data_dir", default="data/processed")
    p.add_argument("--output_dir", default="results/error_analysis")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--top_k", type=int, default=20)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    ctx = AnalysisContext(args.model_path, args.data_dir, device=args.device)
    ds = artifacts.load_dataset(args.data_dir, require_train=False)
    if ds["test"] is None:
        raise FileNotFoundError("no test split")
    analyzer = ErrorAnalyzer(ctx, artifacts.split_to_edges(ds["test"]),
                             args.output_dir, threshold=args.threshold)
    return analyzer.run()


if __name__ == "__main__":
    main()
