"""Path-based prediction explanations.

The counterpart of ``primekg_rgcn_tpu/analyze/explain_predictions.py`` (the
reference's PredictionExplainer, src/explain_predictions.py): for a (drug,
disease) pair, compute the cosine prediction score, enumerate connecting
simple paths (cutoff 4, explain_predictions.py:255-295), score each path as
the mean cosine similarity of consecutive nodes times the length penalty
``1 / (1 + 0.2 * (len - 2))`` (explain_predictions.py:297-324), rank them,
and render templated natural-language explanations into a text report, plus
a path-score chart, a network PNG and a Sankey diagram where matplotlib
(networkx for the network, plotly for an HTML Sankey) is installed.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from primekg_rgcn_tpu_torch.analyze.core import (AnalysisContext, networkx,
                                                 pyplot)

logger = logging.getLogger(__name__)


class PredictionExplainer:
    def __init__(self, ctx: AnalysisContext, output_dir):
        self.ctx = ctx
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)

    def score_path(self, path: List[int]) -> float:
        """Mean consecutive-node cosine similarity x length penalty."""
        if len(path) < 2:
            return 0.0
        emb = self.ctx.embeddings_norm
        sims = [float(emb[a] @ emb[b]) for a, b in zip(path, path[1:])]
        mean_sim = (np.mean(sims) + 1.0) / 2.0
        penalty = 1.0 / (1.0 + 0.2 * (len(path) - 2))
        return float(mean_sim * penalty)

    def explain_path(self, path: List[int]) -> str:
        """Templated natural-language rendering per path length
        (reference: explain_predictions.py:393-462)."""
        names = [self.ctx.node_names[n] for n in path]
        types = [str(self.ctx.node_types[n]) or "entity" for n in path]
        if len(path) == 2:
            return (f"{names[0]} is directly connected to {names[1]} "
                    f"in the knowledge graph.")
        if len(path) == 3:
            return (f"{names[0]} interacts with the {types[1]} {names[1]}, "
                    f"which is associated with {names[2]}.")
        if len(path) == 4:
            return (f"{names[0]} targets {names[1]}, which interacts with "
                    f"{names[2]}, a {types[2]} associated with {names[3]}.")
        chain = " -> ".join(names)
        return (f"{names[0]} reaches {names[-1]} through the multi-step "
                f"chain: {chain}.")

    def explain(self, drug_name: str, disease_name: str,
                top_k: int = 5) -> Optional[Dict]:
        ctx = self.ctx
        drug_idx = ctx.find_node(drug_name, "drug")
        disease_idx = ctx.find_node(disease_name, "disease")
        if drug_idx is None or disease_idx is None:
            logger.error("Not found: drug=%s (%s) disease=%s (%s)",
                         drug_name, drug_idx, disease_name, disease_idx)
            return None

        score = ctx.cosine_score(drug_idx, disease_idx)
        paths = ctx.find_paths(drug_idx, disease_idx, max_length=4,
                               max_paths=20)
        ranked = sorted(
            ({"path": p,
              "names": [ctx.node_names[n] for n in p],
              "score": self.score_path(p),
              "explanation": self.explain_path(p)} for p in paths),
            key=lambda d: -d["score"])[:top_k]

        out = {
            "drug": ctx.node_names[drug_idx],
            "disease": ctx.node_names[disease_idx],
            "prediction_score": float(score),
            "num_paths_found": len(paths),
            "top_paths": ranked,
        }
        self._save(out)
        return out

    def _save(self, out: Dict):
        safe = f"{out['drug']}__{out['disease']}".replace(" ", "_")[:90]
        d = self.output_dir / safe
        d.mkdir(parents=True, exist_ok=True)

        lines = ["=" * 60, "PREDICTION EXPLANATION", "=" * 60, "",
                 f"Drug:    {out['drug']}",
                 f"Disease: {out['disease']}",
                 f"Prediction score: {out['prediction_score']:.4f}",
                 f"Paths found: {out['num_paths_found']}", ""]
        for i, p in enumerate(out["top_paths"], 1):
            lines += [f"Path {i} (score {p['score']:.4f}):",
                      "  " + " -> ".join(n[:28] for n in p["names"]),
                      "  " + p["explanation"], ""]
        (d / "explanation_report.txt").write_text("\n".join(lines))

        if out["top_paths"]:
            plt = pyplot(logger, "the explanation PNGs")
            if plt is not None:
                self._plot(plt, out, d)
            self._save_sankey(out, d, plt)
        logger.info("Saved explanation to %s", d)

    def _plot(self, plt, out: Dict, d: Path):
        # Path-score bar chart.
        fig, ax = plt.subplots(figsize=(10, 5))
        labels = [f"Path {i+1} (len {len(p['path'])-1})"
                  for i, p in enumerate(out["top_paths"])]
        ax.barh(labels[::-1],
                [p["score"] for p in out["top_paths"]][::-1],
                color="tab:purple")
        ax.set_xlabel("Path score")
        ax.set_title(f"{out['drug'][:25]} -> {out['disease'][:35]}")
        fig.tight_layout()
        fig.savefig(d / "path_scores.png", dpi=150)
        plt.close(fig)

        # Importance-weighted network.
        nx = networkx(logger, "the explanation network PNG")
        if nx is None:
            return
        g = nx.Graph()
        weights = {}
        for p in out["top_paths"]:
            for a, b in zip(p["names"], p["names"][1:]):
                e = (a[:22], b[:22])
                weights[e] = max(weights.get(e, 0.0), p["score"])
                g.add_edge(*e)
        fig, ax = plt.subplots(figsize=(12, 8))
        pos = nx.spring_layout(g, seed=42)
        widths = [1 + 4 * weights[(a, b)] if (a, b) in weights
                  else 1 + 4 * weights.get((b, a), 0.2)
                  for a, b in g.edges]
        nx.draw_networkx(g, pos, ax=ax, width=widths,
                         node_color="lightsalmon", node_size=800,
                         font_size=7)
        ax.axis("off")
        fig.tight_layout()
        fig.savefig(d / "explanation_network.png", dpi=150)
        plt.close(fig)

    def _save_sankey(self, out: Dict, d: Path, plt):
        """Pathway-flow (Sankey) diagram of the top paths.

        Mirrors the reference's plotly Sankey (reference:
        src/explain_predictions.py:732-797: unique node labels, one link per
        consecutive pair, link value = path score x 10, HTML output) when
        plotly is importable; otherwise a matplotlib layered-flow PNG
        renders the same structure where ``plt`` (matplotlib's pyplot) is
        given.
        """
        labels: List[str] = []
        index: Dict[str, int] = {}
        links: Dict[tuple, float] = {}
        col: Dict[str, int] = {}
        for p in out["top_paths"]:
            for pos, name in enumerate(p["names"]):
                if name not in index:
                    index[name] = len(labels)
                    labels.append(name)
                col[name] = min(col.get(name, pos), pos)
            for a, b in zip(p["names"], p["names"][1:]):
                key = (index[a], index[b])
                links[key] = links.get(key, 0.0) + p["score"] * 10.0
        if not links:
            return
        safe = f"{out['drug']}__{out['disease']}".replace(" ", "_")[:90]

        try:
            import plotly.graph_objects as go  # optional dependency

            fig = go.Figure(data=[go.Sankey(
                node=dict(pad=15, thickness=20,
                          line=dict(color="black", width=0.5),
                          label=labels, color="lightblue"),
                link=dict(source=[s for s, _ in links],
                          target=[t for _, t in links],
                          value=list(links.values())),
            )])
            fig.update_layout(
                title=f"Pathway Flow: {out['drug']} -> {out['disease']}",
                font_size=10, height=600)
            fig.write_html(d / f"sankey_{safe}.html")
            logger.info("Saved plotly Sankey to %s",
                        d / f"sankey_{safe}.html")
            return
        except ImportError:
            if plt is None:
                return

        # Matplotlib layered-flow fallback: columns = path position, curved
        # links with width proportional to accumulated flow.
        ncols = max(col.values()) + 1
        rows: Dict[int, int] = {}
        ys: Dict[str, float] = {}
        for name in labels:
            c = col[name]
            ys[name] = -rows.get(c, 0)
            rows[c] = rows.get(c, 0) + 1
        fig, ax = plt.subplots(figsize=(2.5 * ncols + 2, 6))
        vmax = max(links.values())
        for (si, ti), v in links.items():
            a, b = labels[si], labels[ti]
            x0, y0 = col[a], ys[a]
            x1, y1 = col[b], ys[b]
            xs = np.linspace(x0, x1, 30)
            # Smoothstep vertical interpolation ~ Sankey ribbon centerline.
            t = (xs - x0) / max(x1 - x0, 1e-9)
            curve = y0 + (y1 - y0) * (3 * t ** 2 - 2 * t ** 3)
            ax.plot(xs, curve, color="steelblue", alpha=0.55,
                    lw=1.0 + 9.0 * v / vmax, zorder=1,
                    solid_capstyle="round")
        for name in labels:
            ax.scatter([col[name]], [ys[name]], s=420, zorder=2,
                       color=("#2ecc71" if name == out["drug"] else
                              "#e74c3c" if name == out["disease"] else
                              "#3498db"))
            ax.annotate(name[:24], (col[name], ys[name]),
                        textcoords="offset points", xytext=(0, 14),
                        ha="center", fontsize=7)
        ax.set_title(f"Pathway Flow: {out['drug'][:25]} -> "
                     f"{out['disease'][:35]}")
        ax.axis("off")
        fig.tight_layout()
        fig.savefig(d / f"sankey_{safe}.png", dpi=150)
        plt.close(fig)
        logger.info("Saved Sankey fallback to %s", d / f"sankey_{safe}.png")


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Explain a drug-disease "
                                            "prediction via graph paths")
    p.add_argument("--drug", required=True)
    p.add_argument("--disease", required=True)
    p.add_argument("--top_k", type=int, default=5)
    p.add_argument("--model_path", default="output/models/best_model.pt")
    p.add_argument("--data_dir", default="data/processed")
    p.add_argument("--output_dir", default="results/explanations")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    ctx = AnalysisContext(args.model_path, args.data_dir, device=args.device)
    return PredictionExplainer(ctx, args.output_dir).explain(
        args.drug, args.disease, args.top_k)


if __name__ == "__main__":
    main()
