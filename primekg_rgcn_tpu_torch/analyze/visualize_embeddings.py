"""Embedding-space visualization and exploration.

The counterpart of ``primekg_rgcn_tpu/analyze/visualize_embeddings.py`` (the
reference's EmbeddingVisualizer, src/visualize_embeddings.py): t-SNE/UMAP
projection with optional sampling (visualize_embeddings.py:176-238),
node-type scatter (240-285), optional plotly interactive HTML (287-381),
cosine k-NN queries (383-456), per-type distance-matrix heatmaps (577-649),
k-means + silhouette clustering (651-777) and a statistics report
(779-824). t-SNE, k-means and the silhouette are ``embed_tools``'s, on the
context's device, in place of sklearn's; the PNGs are drawn where
matplotlib is installed.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from primekg_rgcn_tpu_torch.analyze import embed_tools
from primekg_rgcn_tpu_torch.analyze.core import AnalysisContext, pyplot

logger = logging.getLogger(__name__)

TYPE_COLORS = {"drug": "tab:blue", "disease": "tab:red",
               "gene/protein": "tab:green", "": "tab:gray"}


class EmbeddingVisualizer:
    def __init__(self, ctx: AnalysisContext, output_dir):
        self.ctx = ctx
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)

    # -- projection ----------------------------------------------------------
    def reduce(self, method: str = "tsne",
               sample_size: Optional[int] = None, seed: int = 42):
        """2-D projection of (optionally sampled) embeddings.

        Returns (coords [M, 2], sampled indices [M]).
        """
        emb = self.ctx.embeddings
        n = emb.shape[0]
        rng = np.random.default_rng(seed)
        idx = (np.arange(n) if sample_size is None or sample_size >= n
               else rng.choice(n, sample_size, replace=False))
        x = emb[idx]
        if method == "umap":
            try:
                import umap  # type: ignore

                coords = umap.UMAP(random_state=seed).fit_transform(x)
                return coords, idx
            except ImportError:
                logger.warning("umap not installed; falling back to t-SNE")
        perplexity = min(30.0, max(5.0, (len(x) - 1) / 4))
        coords = embed_tools.tsne(x, perplexity=perplexity, seed=seed,
                                  init="pca", device=self.ctx.device)
        return coords, idx

    def plot_projection(self, coords, idx, filename="embeddings_2d.png"):
        plt = pyplot(logger, f"{filename} and the distance heatmaps")
        if plt is None:
            return
        types = self.ctx.node_types[idx]
        fig, ax = plt.subplots(figsize=(12, 10))
        for t in ["drug", "disease", "gene/protein", ""]:
            mask = types == t
            if not mask.any():
                continue
            ax.scatter(coords[mask, 0], coords[mask, 1], s=4, alpha=0.5,
                       c=TYPE_COLORS[t], label=t or "unknown")
        ax.legend(markerscale=3)
        ax.set_title("Node embeddings (2-D projection)")
        fig.tight_layout()
        fig.savefig(self.output_dir / filename, dpi=150)
        plt.close(fig)

    def plot_interactive(self, coords, idx,
                         filename="embeddings_interactive.html") -> bool:
        """Optional plotly HTML (skipped gracefully when plotly absent)."""
        try:
            import plotly.express as px  # type: ignore
        except ImportError:
            logger.info("plotly not installed; skipping interactive plot")
            return False
        names = [self.ctx.node_names[i] for i in idx]
        types = [str(t) or "unknown" for t in self.ctx.node_types[idx]]
        fig = px.scatter(x=coords[:, 0], y=coords[:, 1], color=types,
                         hover_name=names, title="Node embeddings")
        fig.write_html(self.output_dir / filename)
        return True

    # -- queries -------------------------------------------------------------
    def nearest_neighbors(self, query: str, k: int = 10,
                          node_type: Optional[str] = None) -> List[Dict]:
        """Cosine k-NN of a node found by (fuzzy) name."""
        ctx = self.ctx
        qidx = None
        for t in ([node_type] if node_type
                  else ["drug", "disease", "gene/protein"]):
            qidx = ctx.find_node(query, t)
            if qidx is not None:
                break
        if qidx is None:
            logger.error("Query node not found: %s", query)
            return []
        sims = ctx.embeddings_norm @ ctx.embeddings_norm[qidx]
        order = np.argsort(-sims)
        out = []
        for i in order:
            if i == qidx:
                continue
            out.append({"name": ctx.node_names[i],
                        "type": str(ctx.node_types[i]),
                        "similarity": float(sims[i])})
            if len(out) >= k:
                break
        return out

    # -- heatmaps & clustering ----------------------------------------------
    def distance_heatmaps(self, per_type: int = 40, seed: int = 0
                          ) -> Dict[str, np.ndarray]:
        """Cosine distances among up to ``per_type`` sampled nodes of each
        type ({type: [n, n]}), drawn as heatmaps where matplotlib is
        installed."""
        rng = np.random.default_rng(seed)
        plt = pyplot()   # plot_projection logs the skip
        out = {}
        for t, fname in [("drug", "drug_distances.png"),
                         ("disease", "disease_distances.png"),
                         ("gene/protein", "gene_distances.png")]:
            idx = self.ctx.indices_of_type(t)
            if len(idx) == 0:
                continue
            if len(idx) > per_type:
                idx = rng.choice(idx, per_type, replace=False)
            e = self.ctx.embeddings_norm[idx]
            dist = 1.0 - e @ e.T
            out[t] = dist
            if plt is None:
                continue
            fig, ax = plt.subplots(figsize=(8, 7))
            im = ax.imshow(dist, cmap="viridis")
            ax.set_title(f"Cosine distances: {t} (n={len(idx)})")
            fig.colorbar(im)
            fig.tight_layout()
            fig.savefig(self.output_dir / fname, dpi=150)
            plt.close(fig)
        return out

    def cluster(self, n_clusters: int = 10, seed: int = 0) -> Dict[str, Dict]:
        """k-means + silhouette per node type, with per-cluster example files
        and a summary (reference: visualize_embeddings.py:651-777 and the
        {drug,disease}_cluster_examples.txt / clustering_summary.txt outputs
        in the reference's results/embeddings/)."""
        dev = self.ctx.device
        out = {}
        summary = ["=" * 60, "CLUSTERING SUMMARY", "=" * 60, ""]
        for t, stem in [("drug", "drug"), ("disease", "disease"),
                        ("gene/protein", "gene")]:
            idx = self.ctx.indices_of_type(t)
            if len(idx) < n_clusters * 2:
                continue
            x = self.ctx.embeddings[idx]
            labels, centers, _ = embed_tools.kmeans(
                x, n_clusters, n_init=4, seed=seed, device=dev)
            sil = (embed_tools.silhouette(x, labels, device=dev)
                   if len(idx) > n_clusters else 0.0)
            sizes = np.bincount(labels).tolist()
            out[t] = {"n_clusters": n_clusters, "silhouette": sil,
                      "cluster_sizes": sizes}
            summary.append(f"{t}: k={n_clusters}, silhouette={sil:.4f}, "
                           f"sizes={sizes}")

            # Example members nearest each centroid.
            lines = [f"Cluster examples for {t} (k={n_clusters})", "-" * 60]
            for c in range(n_clusters):
                members = np.flatnonzero(labels == c)
                if len(members) == 0:
                    continue
                dists = np.linalg.norm(x[members] - centers[c], axis=1)
                nearest = members[np.argsort(dists)[:8]]
                names = [self.ctx.node_names[idx[m]][:40] for m in nearest]
                lines.append(f"cluster {c} ({len(members)} members): "
                             + "; ".join(names))
            (self.output_dir / f"{stem}_cluster_examples.txt").write_text(
                "\n".join(lines))
        (self.output_dir / "clustering_summary.txt").write_text(
            "\n".join(summary))
        return out

    def stats_report(self, cluster_info: Optional[Dict] = None,
                     filename="embedding_stats.txt"):
        emb = self.ctx.embeddings
        lines = ["=" * 60, "EMBEDDING STATISTICS", "=" * 60, "",
                 f"Nodes: {emb.shape[0]:,}   dim: {emb.shape[1]}",
                 f"Norm: mean {np.linalg.norm(emb, axis=1).mean():.4f}, "
                 f"std {np.linalg.norm(emb, axis=1).std():.4f}", ""]
        for t in ["drug", "disease", "gene/protein"]:
            idx = self.ctx.indices_of_type(t)
            if len(idx) == 0:
                continue
            e = emb[idx]
            lines.append(f"{t}: n={len(idx):,}, mean-norm "
                         f"{np.linalg.norm(e, axis=1).mean():.4f}")
        if cluster_info:
            lines += ["", "Clustering:"]
            for t, info in cluster_info.items():
                lines.append(f"  {t}: k={info['n_clusters']}, "
                             f"silhouette={info['silhouette']:.4f}")
        (self.output_dir / filename).write_text("\n".join(lines))

    def run(self, method="tsne", sample_size=None, query=None, k_neighbors=10,
            do_cluster=False, n_clusters=10, skip_interactive=False) -> Dict:
        coords, idx = self.reduce(method, sample_size)
        self.plot_projection(coords, idx)
        if not skip_interactive:
            self.plot_interactive(coords, idx)
        self.distance_heatmaps()
        result: Dict = {"projected": int(len(idx))}
        if query:
            result["neighbors"] = self.nearest_neighbors(query, k_neighbors)
        cluster_info = self.cluster(n_clusters) if do_cluster else None
        if cluster_info:
            result["clusters"] = cluster_info
        self.stats_report(cluster_info)
        return result


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Visualize learned embeddings")
    p.add_argument("--model_path", default="output/models/best_model.pt")
    p.add_argument("--data_dir", default="data/processed")
    p.add_argument("--output_dir", default="results/embeddings")
    p.add_argument("--method", choices=["tsne", "umap"], default="tsne")
    p.add_argument("--sample_size", type=int, default=None)
    p.add_argument("--query", default=None)
    p.add_argument("--k_neighbors", type=int, default=10)
    p.add_argument("--cluster", action="store_true")
    p.add_argument("--n_clusters", type=int, default=10)
    p.add_argument("--skip_interactive", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    ctx = AnalysisContext(args.model_path, args.data_dir, device=args.device)
    viz = EmbeddingVisualizer(ctx, args.output_dir)
    return viz.run(args.method, args.sample_size, args.query,
                   args.k_neighbors, args.cluster, args.n_clusters,
                   args.skip_interactive)


if __name__ == "__main__":
    main()
