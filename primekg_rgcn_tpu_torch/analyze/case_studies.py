"""Drug-repurposing case studies.

The counterpart of ``primekg_rgcn_tpu/analyze/case_studies.py`` (the
reference's DrugDiseaseCaseStudy, src/case_studies.py): given a disease
name, rank all drugs by cosine similarity of encoder embeddings (rescaled
to [0, 1], case_studies.py:261-275), mark known direct associations
(case_studies.py:286-317), find connecting paths (cutoff 4,
case_studies.py:319-351), and write predictions.json and a text report per
disease, plus a bar chart and path-network PNGs where matplotlib (and, for
the networks, networkx) is installed.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, Optional

from primekg_rgcn_tpu_torch.analyze.core import (AnalysisContext, networkx,
                                                 pyplot)

logger = logging.getLogger(__name__)


class DrugDiseaseCaseStudy:
    def __init__(self, ctx: AnalysisContext, output_dir):
        self.ctx = ctx
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)

    def analyze_prediction(self, drug_idx: int, disease_idx: int,
                           max_paths: int = 5) -> Dict:
        paths = self.ctx.find_paths(drug_idx, disease_idx, max_length=4,
                                    max_paths=max_paths)
        genes = set(int(g) for g in self.ctx.gene_indices)
        path_genes = sorted({n for p in paths for n in p[1:-1] if n in genes})
        return {
            "num_paths": len(paths),
            "paths": [[self.ctx.node_names[n] for n in p] for p in paths],
            # Per-hop relation names, parallel to each path (reference:
            # src/case_studies.py:344-349 records path relations).
            "path_relations": [
                [self.ctx.edge_relation_name(a, b)
                 for a, b in zip(p, p[1:])] for p in paths],
            "shortest_path_length": min((len(p) - 1 for p in paths),
                                        default=None),
            "connecting_genes": [self.ctx.node_names[g] for g in path_genes],
        }

    def run_case_study(self, disease_name: str, top_k: int = 10,
                       threshold: float = 0.0) -> Optional[Dict]:
        ctx = self.ctx
        disease_idx = ctx.find_node(disease_name, "disease")
        if disease_idx is None:
            logger.error("Disease not found: %s", disease_name)
            return None
        resolved = ctx.node_names[disease_idx]
        logger.info("Case study: %s (node %d)", resolved, disease_idx)

        preds = ctx.top_drugs_for_disease(disease_idx, top_k, threshold)
        known = ctx.known_direct_associations(disease_idx,
                                             [d for d, _ in preds])
        results = []
        for rank, (drug_idx, score) in enumerate(preds, 1):
            detail = self.analyze_prediction(drug_idx, disease_idx)
            results.append({
                "rank": rank,
                "drug": ctx.node_names[drug_idx],
                "drug_idx": int(drug_idx),
                "score": float(score),
                "known_association": bool(known[drug_idx]),
                **detail,
            })

        out = {
            "disease": resolved,
            "disease_idx": int(disease_idx),
            "top_k": top_k,
            "predictions": results,
        }
        self._save(out)
        return out

    # -- outputs -------------------------------------------------------------
    def _save(self, out: Dict):
        safe = out["disease"].replace(" ", "_").replace("/", "_")[:80]
        d = self.output_dir / safe
        d.mkdir(parents=True, exist_ok=True)

        with open(d / "predictions.json", "w") as f:
            json.dump(out, f, indent=2)

        plt = pyplot(logger, "the case-study PNGs")
        if plt is not None:
            self._plot(plt, d, out)

        # Text report.
        lines = ["=" * 60, f"CASE STUDY: {out['disease']}", "=" * 60, ""]
        for p in out["predictions"]:
            tag = "KNOWN" if p["known_association"] else "novel"
            lines.append(f"#{p['rank']:2d} {p['drug'][:40]:42s} "
                         f"score={p['score']:.4f} [{tag}] "
                         f"paths={p['num_paths']}")
            if p["connecting_genes"]:
                lines.append(f"      via genes: "
                             f"{', '.join(p['connecting_genes'][:6])}")
        (d / "report.txt").write_text("\n".join(lines))
        logger.info("Saved case study to %s", d)

    def _plot(self, plt, d: Path, out: Dict):
        # Bar chart of prediction scores (reference style: known/novel
        # legend + value labels, src/case_studies.py:448-478).
        from matplotlib.patches import Patch

        fig, ax = plt.subplots(figsize=(12, 6))
        names = [p["drug"][:30] for p in out["predictions"]]
        scores = [p["score"] for p in out["predictions"]]
        colors = ["tab:green" if p["known_association"] else "tab:blue"
                  for p in out["predictions"]]
        bars = ax.barh(names[::-1], scores[::-1], color=colors[::-1],
                       alpha=0.8)
        for bar, score in zip(bars, scores[::-1]):
            ax.text(score + 0.01, bar.get_y() + bar.get_height() / 2,
                    f"{score:.3f}", va="center", fontsize=9)
        ax.set_xlim(0, 1.05)
        ax.set_xlabel("Prediction score (cosine, rescaled)")
        ax.set_title(f"Top drug predictions: {out['disease'][:60]}")
        ax.legend(handles=[
            Patch(facecolor="tab:green", alpha=0.8, label="Known treatment"),
            Patch(facecolor="tab:blue", alpha=0.8, label="Novel prediction"),
        ], loc="lower right")
        fig.tight_layout()
        fig.savefig(d / "predictions.png", dpi=150)
        plt.close(fig)

        # Path network of the top prediction (reference scope,
        # src/case_studies.py:483-555) ...
        top_with_paths = next((p for p in out["predictions"]
                               if p["num_paths"] > 0), None)
        if top_with_paths:
            self._plot_path_network(plt, d, out["disease"], top_with_paths)
        # ... plus a combined network spanning ALL top-k predictions'
        # paths around the disease hub (exceeds the reference's
        # top-prediction-only figure).
        if any(p["num_paths"] > 0 for p in out["predictions"]):
            self._plot_path_network_all(plt, d, out)

    @staticmethod
    def _draw_typed_network(ax, g, drugs, diseases):
        """Reference node styling: drugs green, diseases coral, connectors
        blue; relation names as edge labels (src/case_studies.py:513-545)."""
        import networkx as nx

        pos = nx.spring_layout(g, k=2, iterations=50, seed=42)
        colors, sizes = [], []
        for node in g.nodes():
            if node in drugs:
                colors.append("lightgreen")
                sizes.append(2600)
            elif node in diseases:
                colors.append("lightcoral")
                sizes.append(2600)
            else:
                colors.append("lightblue")
                sizes.append(1700)
        nx.draw_networkx_nodes(g, pos, node_color=colors, node_size=sizes,
                               alpha=0.9, ax=ax)
        nx.draw_networkx_edges(g, pos, edge_color="gray", width=2,
                               alpha=0.6, ax=ax)
        labels = {n: n if len(n) <= 25 else n[:25] + "..."
                  for n in g.nodes()}
        nx.draw_networkx_labels(g, pos, labels, font_size=8, ax=ax)
        edge_labels = {k: v for k, v in
                       nx.get_edge_attributes(g, "relation").items() if v}
        if edge_labels:
            nx.draw_networkx_edge_labels(g, pos, edge_labels, font_size=6,
                                         ax=ax)

    def _plot_path_network(self, plt, outdir: Path, disease: str,
                           pred: Dict):
        nx = networkx(logger, "the path-network PNGs")
        if nx is None:
            return

        g = nx.Graph()
        rels = pred.get("path_relations") or [[] for _ in pred["paths"]]
        for path, prels in list(zip(pred["paths"], rels))[:3]:
            for i, (a, b) in enumerate(zip(path, path[1:])):
                g.add_edge(a[:24], b[:24],
                           relation=prels[i] if i < len(prels) else "")
        if not g.nodes:
            return
        fig, ax = plt.subplots(figsize=(14, 10))
        self._draw_typed_network(ax, g, {pred["drug"][:24]}, {disease[:24]})
        tag = "KNOWN" if pred["known_association"] else "novel"
        ax.set_title(f"Drug-disease connection paths\n"
                     f"{pred['drug'][:30]} -> {disease[:40]}\n"
                     f"score {pred['score']:.3f} ({tag})")
        ax.axis("off")
        fig.tight_layout()
        fig.savefig(outdir / "path_network.png", dpi=150)
        plt.close(fig)

    def _plot_path_network_all(self, plt, outdir: Path, out: Dict):
        """One network spanning every top-k prediction's paths (the
        disease is the hub; each drug's shortest stored path contributes
        its hops)."""
        nx = networkx(logger, "the path-network PNGs")
        if nx is None:
            return

        disease = out["disease"][:24]
        g = nx.Graph()
        drugs = set()
        for pred in out["predictions"]:
            if not pred["num_paths"]:
                continue
            drugs.add(pred["drug"][:24])
            rels = pred.get("path_relations") or [[] for _ in pred["paths"]]
            for path, prels in list(zip(pred["paths"], rels))[:2]:
                for i, (a, b) in enumerate(zip(path, path[1:])):
                    g.add_edge(a[:24], b[:24],
                               relation=prels[i] if i < len(prels) else "")
        if not g.nodes:
            return
        fig, ax = plt.subplots(figsize=(16, 12))
        self._draw_typed_network(ax, g, drugs, {disease})
        ax.set_title(f"All top-{out['top_k']} prediction paths: "
                     f"{out['disease'][:50]}")
        ax.axis("off")
        fig.tight_layout()
        fig.savefig(outdir / "path_network_all.png", dpi=150)
        plt.close(fig)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Drug-disease case studies")
    p.add_argument("--disease", required=True)
    p.add_argument("--top_k", type=int, default=10)
    p.add_argument("--threshold", type=float, default=0.0)
    p.add_argument("--model_path", default="output/models/best_model.pt")
    p.add_argument("--data_dir", default="data/processed")
    p.add_argument("--output_dir", default="results/case_studies")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    ctx = AnalysisContext(args.model_path, args.data_dir, device=args.device)
    study = DrugDiseaseCaseStudy(ctx, args.output_dir)
    return study.run_case_study(args.disease, args.top_k, args.threshold)


if __name__ == "__main__":
    main()
