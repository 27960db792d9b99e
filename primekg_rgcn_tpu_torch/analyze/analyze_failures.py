"""Failure-mode analysis.

The counterpart of ``primekg_rgcn_tpu/analyze/analyze_failures.py`` (the
reference's FailureAnalyzer, src/analyze_failures.py): build proxy ground
truth — positives are (drug, disease) pairs sharing a gene neighbor,
negatives random pairs (analyze_failures.py:201-271); score by embedding
cosine similarity; failures are confident-wrong predictions (false
positive: score > 0.7 on label 0; false negative: score < 0.3 on label 1,
273-343); compare structural subgraph statistics of failures vs successes
(368-489); render subgraph PNGs on request, where matplotlib and networkx
are installed (491-609); generate rule-based hypotheses and improvement
suggestions (611-793); write the report.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from primekg_rgcn_tpu_torch.analyze.core import (AnalysisContext, networkx,
                                                 pyplot)

logger = logging.getLogger(__name__)

FP_THRESHOLD = 0.7
FN_THRESHOLD = 0.3


class FailureAnalyzer:
    def __init__(self, ctx: AnalysisContext, output_dir):
        self.ctx = ctx
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)

    # -- proxy dataset -------------------------------------------------------
    def build_proxy_dataset(self, num_samples: int = 5000,
                            seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
        """[(drug, disease)] pairs + labels: 1 if they share a gene neighbor."""
        ctx = self.ctx
        rng = np.random.default_rng(seed)
        pos = []
        # Positives: walk diseases, pick drugs sharing >= 1 gene.
        for d in rng.permutation(ctx.disease_indices):
            dg = ctx.gene_neighbors(int(d))
            if not dg:
                continue
            # Drugs touching any of the disease's genes.
            cands = set()
            for g in list(dg)[:20]:
                cands |= {n for n in ctx.neighbor_sets.get(g, set())
                          if ctx.node_types[n] == "drug"}
            for dr in list(cands)[:5]:
                pos.append((dr, int(d)))
            if len(pos) >= num_samples // 2:
                break
        n_pos = len(pos)
        neg = list(zip(rng.choice(ctx.drug_indices, n_pos, replace=True),
                       rng.choice(ctx.disease_indices, n_pos, replace=True)))
        pairs = np.asarray(pos + neg, dtype=np.int64)
        labels = np.concatenate([np.ones(n_pos), np.zeros(n_pos)])
        return pairs, labels

    def score_pairs(self, pairs: np.ndarray) -> np.ndarray:
        e = self.ctx.embeddings_norm
        return ((e[pairs[:, 0]] * e[pairs[:, 1]]).sum(axis=1) + 1.0) / 2.0

    # -- failure identification ---------------------------------------------
    def find_failures(self, pairs, labels, scores,
                      num_failures: int = 5, num_successes: int = 5) -> Dict:
        fp = np.flatnonzero((labels == 0) & (scores > FP_THRESHOLD))
        fn = np.flatnonzero((labels == 1) & (scores < FN_THRESHOLD))
        tp = np.flatnonzero((labels == 1) & (scores > FP_THRESHOLD))
        tn = np.flatnonzero((labels == 0) & (scores < FN_THRESHOLD))
        rngsort = np.argsort  # most-confident-wrong first
        fp = fp[rngsort(-scores[fp])][:num_failures]
        fn = fn[rngsort(scores[fn])][:num_failures]
        tp = tp[rngsort(-scores[tp])][:num_successes]
        tn = tn[rngsort(scores[tn])][:num_successes]
        return {"false_positives": fp, "false_negatives": fn,
                "true_positives": tp, "true_negatives": tn}

    # -- structural statistics ----------------------------------------------
    def pair_structure(self, drug: int, disease: int) -> Dict:
        ctx = self.ctx
        nd = ctx.neighbor_sets.get(int(drug), set())
        ns = ctx.neighbor_sets.get(int(disease), set())
        common = nd & ns
        paths = ctx.find_paths(int(drug), int(disease), max_length=3,
                               max_paths=10)
        return {
            "drug_degree": len(nd),
            "disease_degree": len(ns),
            "common_neighbors": len(common),
            "num_short_paths": len(paths),
            "shortest_path": min((len(p) - 1 for p in paths), default=-1),
        }

    def compare_structures(self, pairs, buckets: Dict) -> Dict[str, Dict]:
        out = {}
        for name, idxs in buckets.items():
            stats = [self.pair_structure(*pairs[i]) for i in idxs]
            if not stats:
                out[name] = {}
                continue
            keys = stats[0].keys()
            out[name] = {k: float(np.mean([s[k] for s in stats]))
                         for k in keys}
        return out

    # -- hypotheses ----------------------------------------------------------
    def generate_hypotheses(self, comparison: Dict[str, Dict]) -> List[str]:
        """Rule-based failure hypotheses (reference:
        analyze_failures.py:611-702)."""
        hyp = []
        fp = comparison.get("false_positives", {})
        fn = comparison.get("false_negatives", {})
        tp = comparison.get("true_positives", {})
        if fp and tp:
            if fp.get("drug_degree", 0) > 1.5 * tp.get("drug_degree", 1):
                hyp.append("False positives involve hub drugs: high-degree "
                           "nodes get inflated similarity scores.")
            if fp.get("common_neighbors", 0) < tp.get("common_neighbors", 0):
                hyp.append("False positives lack common gene neighbors: the "
                           "embedding proximity is not structurally "
                           "supported.")
        if fn and tp:
            if fn.get("drug_degree", 1) < 0.5 * tp.get("drug_degree", 1):
                hyp.append("False negatives involve low-degree drugs: "
                           "sparse neighborhoods give weak embeddings.")
            if fn.get("num_short_paths", 0) > 0:
                hyp.append("False negatives still have connecting paths: "
                           "the encoder under-weights multi-hop evidence.")
        if not hyp:
            hyp.append("No strong structural separation between failures "
                       "and successes was detected.")
        return hyp

    def improvement_suggestions(self, hypotheses: List[str]) -> List[str]:
        sugg = ["Add degree-normalized or attention-based aggregation to "
                "reduce hub-node bias.",
                "Increase negative sampling around high-degree entities.",
                "Incorporate path-based features or distance encodings.",
                "Calibrate scores (e.g. Platt scaling) before thresholding."]
        if any("low-degree" in h for h in hypotheses):
            sugg.append("Pre-train embeddings with a structural objective so "
                        "sparse nodes start from informative vectors.")
        return sugg

    def plot_subgraph(self, plt, nx, drug: int, disease: int, tag: str):
        """The pair with up to 15 neighbours of each and the edges among
        them; ``plt`` is matplotlib's pyplot, ``nx`` networkx."""
        ctx = self.ctx
        nodes = {int(drug), int(disease)}
        nodes |= set(list(ctx.neighbor_sets.get(int(drug), set()))[:15])
        nodes |= set(list(ctx.neighbor_sets.get(int(disease), set()))[:15])
        g = nx.Graph()
        g.add_nodes_from(nodes)
        g.add_edges_from((u, v) for u in nodes
                         for v in ctx.neighbor_sets.get(u, set()) & nodes)
        fig, ax = plt.subplots(figsize=(10, 8))
        pos = nx.spring_layout(g, seed=0)
        colors = ["tab:red" if n in (drug, disease) else "lightgray"
                  for n in g.nodes]
        nx.draw_networkx(g, pos, ax=ax, node_color=colors, node_size=300,
                         with_labels=False)
        ax.set_title(f"{tag}: {ctx.node_names[drug][:25]} / "
                     f"{ctx.node_names[disease][:35]}")
        ax.axis("off")
        fig.tight_layout()
        fig.savefig(self.output_dir / f"subgraph_{tag}.png", dpi=150)
        plt.close(fig)

    def run(self, num_failures: int = 5, num_successes: int = 5,
            num_samples: int = 5000, visualize_subgraphs: bool = False,
            seed: int = 42) -> Dict:
        pairs, labels = self.build_proxy_dataset(num_samples, seed)
        scores = self.score_pairs(pairs)
        buckets = self.find_failures(pairs, labels, scores, num_failures,
                                     num_successes)
        comparison = self.compare_structures(pairs, buckets)
        hypotheses = self.generate_hypotheses(comparison)
        suggestions = self.improvement_suggestions(hypotheses)

        if visualize_subgraphs:
            plt = pyplot(logger, "the subgraph PNGs")
            nx = (networkx(logger, "the subgraph PNGs") if plt is not None
                  else None)
            if nx is not None:
                for tag in ["false_positives", "false_negatives"]:
                    for i in buckets[tag][:2]:
                        self.plot_subgraph(plt, nx, pairs[i][0], pairs[i][1],
                                           f"{tag}_{i}")

        names = self.ctx.node_names
        lines = ["=" * 60, "FAILURE ANALYSIS", "=" * 60, "",
                 "Proxy ground truth: positives share >=1 gene neighbor; "
                 "negatives are random pairs (reference protocol).", "",
                 f"Pairs: {len(pairs):,} "
                 f"(pos {int(labels.sum()):,})", ""]
        for tag, idxs in buckets.items():
            lines.append(f"{tag} ({len(idxs)}):")
            for i in idxs:
                d, s = pairs[i]
                lines.append(f"  {names[d][:28]:30s} / {names[s][:32]:34s} "
                             f"score={scores[i]:.3f}")
            lines.append("")
        lines += ["Structural comparison (means):"]
        for tag, stats in comparison.items():
            lines.append(f"  {tag}: "
                         + ", ".join(f"{k}={v:.2f}"
                                     for k, v in stats.items()))
        lines += ["", "Hypotheses:"] + [f"  - {h}" for h in hypotheses]
        lines += ["", "Suggestions:"] + [f"  - {s}" for s in suggestions]
        (self.output_dir / "failure_analysis_report.txt").write_text(
            "\n".join(lines))
        logger.info("Failure analysis written to %s", self.output_dir)
        return {"buckets": {k: v.tolist() for k, v in buckets.items()},
                "comparison": comparison, "hypotheses": hypotheses}


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Analyze model failure modes")
    p.add_argument("--model_path", default="output/models/best_model.pt")
    p.add_argument("--data_dir", default="data/processed")
    p.add_argument("--num_failures", type=int, default=5)
    p.add_argument("--num_successes", type=int, default=5)
    p.add_argument("--num_samples", type=int, default=5000)
    p.add_argument("--visualize_subgraphs", action="store_true")
    p.add_argument("--output_dir", default="results/failure_analysis")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    ctx = AnalysisContext(args.model_path, args.data_dir, device=args.device)
    return FailureAnalyzer(ctx, args.output_dir).run(
        args.num_failures, args.num_successes, args.num_samples,
        args.visualize_subgraphs)


if __name__ == "__main__":
    main()
