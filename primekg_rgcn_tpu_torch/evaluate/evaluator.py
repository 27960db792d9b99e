"""End-to-end model evaluation producing the reference's results contract.

The counterpart of ``primekg_rgcn_tpu/evaluate/evaluator.py``, with its two
departures from the reference's compute plan, neither of which changes a
result:

- The graph is encoded **once** per ``Evaluator`` (under ``torch.no_grad``)
  and the embeddings serve every classification and ranking batch; the
  reference re-encodes for every batch although the eval-mode encode is
  deterministic. On the card the dense encode is 6 launches of kernel B1;
  with ``shard_encode="node"`` it is the node-sharded encode (B1 per
  bucket, the halo exchange B4).
- Ranking is one [B, D] x [D, N] matmul per batch and a rank count on the
  device; the ranks of all batches stay there and reach the host in one
  copy.

Negatives come from an injectable ``negatives(seed)``, called once per
``compute_scores_and_labels`` with its seed, which returns the batch
sampler ``sample(h, t, r) -> (nh, nt, nr)``, called once per batch in batch
order. The default corrupts with ``train/neg_sampling.sample_negatives``
over a ``torch.Generator`` seeded ``seed`` (``EvalConfig.seed`` by default)
on the evaluator's device; ``jax.random`` cannot be matched, so a test
hands the port the JAX draws through it.

``results.json`` and ``metrics_summary.txt`` are written byte for byte as
the JAX package writes them for the same metrics dict.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from primekg_rgcn_tpu_torch.config import EvalConfig, ModelConfig
from primekg_rgcn_tpu_torch.data.graph import RelGraph
from primekg_rgcn_tpu_torch.evaluate.metrics import (
    classification_metrics, ranking_metrics_from_ranks, ranks_of_true_tails)
from primekg_rgcn_tpu_torch.models.rgcn import encoder_apply
from primekg_rgcn_tpu_torch.ops.distmult import (distmult_score,
                                                 distmult_score_all_tails)
from primekg_rgcn_tpu_torch.ops.rgcn_segment import rgcn_layer_segment
from primekg_rgcn_tpu_torch.train.neg_sampling import sample_negatives

logger = logging.getLogger(__name__)

Triples = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Sampler = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], Triples]
Negatives = Callable[[int], Sampler]


class Evaluator:
    """Classification and ranking metrics of a model on a test split.

    The evaluator runs on the device of the parameters. ``n_shards`` is the
    number of shards of the port's mesh (all on that device; the JAX
    package counts its devices): ``shard_encode="node"`` needs 2 or more.
    The dense evaluator ranks through ``build_sharded_ranker`` only when a
    call asks for ``sharded=True`` with 2 or more shards; the JAX package
    splits by default because its shards are separate chips, while here
    every shard shares one device, so the split saves neither time nor
    memory.
    """

    def __init__(
        self,
        params,
        model_cfg: ModelConfig,
        full_graph: RelGraph,
        test_edges: np.ndarray,  # [E, 3] (head, tail, rel)
        eval_cfg: Optional[EvalConfig] = None,
        *,
        layer_fn=rgcn_layer_segment,
        shard_encode: str = "none",
        n_shards: int = 0,
        negatives: Optional[Negatives] = None,
    ):
        self.params = params
        self.model_cfg = model_cfg
        self.graph = full_graph
        self.test_edges = np.asarray(test_edges, dtype=np.int32)
        self.cfg = eval_cfg or EvalConfig()
        self.n_shards = int(n_shards)
        self.negatives = negatives or self._generator_negatives
        self.scores: Optional[np.ndarray] = None
        self.labels: Optional[np.ndarray] = None
        # Keyed (direction, sharded): the dense and sharded rankers are
        # different code, so a direction-only key would serve one's ranks
        # for the other.
        self._raw_ranks: Dict[tuple, Optional[np.ndarray]] = {}
        # direction -> (known_triples, filtered ranks): ``evaluate`` asks
        # for each direction twice (alone and in the ``both`` block).
        self._franks: Dict[str, tuple] = {}
        self._rel_emb = params["decoder"]["rel_emb"]
        self.device = self._rel_emb.device
        self._edges = torch.as_tensor(self.test_edges, dtype=torch.long,
                                      device=self.device)

        if shard_encode == "node" and self.n_shards < 2:
            raise ValueError(
                "shard_encode='node' needs n_shards >= 2: a silent dense "
                "fallback would build the [N, D] table this mode exists to "
                "avoid")
        if shard_encode == "node":
            # The node-partitioned encode keeps the table shard-major
            # [n, N/n, D]; rank and score fetch query endpoints with
            # owner-masked psums, so no [N, D] table is ever built.
            from primekg_rgcn_tpu_torch.evaluate.sharded_ranking import (
                build_sharded_eval_from_sharded)
            from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh
            from primekg_rgcn_tpu_torch.parallel.node_shard import (
                build_node_sharded_forward, partition_nodes)

            mesh = make_mesh(self.n_shards, self.device)
            nsg = partition_nodes(full_graph, self.n_shards)
            with torch.no_grad():
                emb_dm = build_node_sharded_forward(
                    mesh, nsg, model_cfg, gather=False)(params)
            rank_fn, score_fn = build_sharded_eval_from_sharded(
                mesh, emb_dm, self._rel_emb, full_graph.num_nodes)
            self._node_emb = None
            self._score_triples = lambda h, t, r: torch.sigmoid(
                score_fn(h, t, r))
            self._rank_batch = rank_fn
        elif shard_encode != "none":
            raise ValueError(f"unknown shard_encode: {shard_encode!r}")
        else:
            # One deterministic full-graph encode, reused everywhere.
            with torch.no_grad():
                self._node_emb = encoder_apply(
                    params, full_graph.to(self.device), model_cfg,
                    layer_fn=layer_fn)
            self._score_triples = self._score_triples_impl
            self._rank_batch = self._rank_batch_impl

    def _generator_negatives(self, seed: int) -> Sampler:
        """The default sampler: ``sample_negatives`` over a generator on
        the evaluator's device seeded ``seed``."""
        gen = torch.Generator(self.device).manual_seed(seed)
        return lambda h, t, r: sample_negatives(
            h, t, r, self.graph.num_nodes, self.cfg.num_neg_samples,
            generator=gen)

    # -- batch kernels -------------------------------------------------------
    def _score_triples_impl(self, heads, tails, rels):
        return torch.sigmoid(distmult_score(
            self._node_emb[heads], self._node_emb[tails], self._rel_emb[rels]))

    def _rank_batch_impl(self, heads, rels, true_tails):
        all_scores = distmult_score_all_tails(
            self._node_emb[heads], self._rel_emb[rels], self._node_emb)
        return ranks_of_true_tails(all_scores, true_tails)

    def _directed_edges(self, direction: str) -> torch.Tensor:
        """The test edges on the device; ``head`` swaps the endpoints
        (DistMult is symmetric in (h, t), so head ranking is tail ranking
        of the swapped triples)."""
        return self._edges[:, [1, 0, 2]] if direction == "head" \
            else self._edges

    # -- public API ----------------------------------------------------------
    @torch.no_grad()
    def compute_scores_and_labels(self, seed: Optional[int] = None):
        """Probabilities and labels over the positives and 1:num_neg sampled
        negatives drawn from ``negatives(seed)`` (default
        ``EvalConfig.seed``)."""
        cfg = self.cfg
        sample = self.negatives(cfg.seed if seed is None else seed)
        e = self._edges
        n = e.shape[0]
        all_probs, all_labels = [], []
        for start in range(0, n, cfg.batch_size):
            stop = min(start + cfg.batch_size, n)
            h, t, r = e[start:stop, 0], e[start:stop, 1], e[start:stop, 2]
            nh, nt, nr = sample(h, t, r)
            all_probs.append(self._score_triples(
                torch.cat([h, nh]), torch.cat([t, nt]), torch.cat([r, nr])))
            all_labels.append(np.concatenate([
                np.ones(stop - start),
                np.zeros((stop - start) * cfg.num_neg_samples)]))
        self.scores = torch.cat(all_probs).cpu().numpy()
        self.labels = np.concatenate(all_labels)
        return self.scores, self.labels

    @torch.no_grad()
    def _compute_raw_ranks(self, sharded: bool = False,
                           direction: str = "tail") -> np.ndarray:
        """1-indexed raw rank of every test edge's true tail (cached).
        ``direction="head"`` ranks the head against all entities given
        (r, t)."""
        if direction not in ("tail", "head"):
            raise ValueError(f"unknown rank direction {direction!r}")
        if self._node_emb is None:
            # shard_encode="node": _rank_batch already is the fully sharded
            # ranker over the shard-major table; there is only one.
            sharded = False
        else:
            sharded = bool(sharded) and self.n_shards > 1
        cache_key = (direction, sharded)
        if self._raw_ranks.get(cache_key) is not None:
            return self._raw_ranks[cache_key]
        e = self._directed_edges(direction)
        b = self.cfg.batch_size

        rank_fn = self._rank_batch
        if sharded:
            from primekg_rgcn_tpu_torch.evaluate.sharded_ranking import (
                build_sharded_ranker)
            from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh

            rank_fn = build_sharded_ranker(
                make_mesh(self.n_shards, self.device), self._node_emb,
                self._rel_emb)
        ranks = [rank_fn(e[s:s + b, 0], e[s:s + b, 2], e[s:s + b, 1])
                 for s in range(0, e.shape[0], b)]
        self._raw_ranks[cache_key] = torch.cat(ranks).cpu().numpy()
        return self._raw_ranks[cache_key]

    def compute_ranking_metrics(
        self, k_values: Optional[Sequence[int]] = None,
        *, sharded: bool = False, direction: str = "tail",
    ) -> Dict[str, float]:
        """Raw ranking metrics. With ``sharded=True`` and ``n_shards >= 2``
        the all-tails scoring is split over the mesh's shards.

        ``direction``: "tail" (the reference's protocol), "head", or "both"
        (the head and tail ranks of every query pooled)."""
        k_values = list(k_values or self.cfg.k_values)
        if direction == "both":
            ranks = np.concatenate([self._compute_raw_ranks(sharded, "tail"),
                                    self._compute_raw_ranks(sharded, "head")])
        else:
            ranks = self._compute_raw_ranks(sharded, direction)
        return ranking_metrics_from_ranks(ranks, k_values)

    # -- filtered ranking (an extension: the reference ranks raw only) ------
    def _rank_filtered_impl(self, heads, rels, true_tails, filt):
        """(raw_rank, filtered_rank) from ONE [B, N] score matrix.

        ``filt`` is int64[B, W]: each query's known true tails, padded with
        the query's own tail. The raw count and the filter adjustment both
        gather from the same ``all_scores`` tensor, so ties are exact by
        construction: re-scoring the filter tails through the triple
        scorer drifts by ulps from the matmul, and the own-tail pads then
        count as strictly higher about half the time, driving filtered
        ranks below 1."""
        all_scores = distmult_score_all_tails(
            self._node_emb[heads], self._rel_emb[rels], self._node_emb)
        s_true = all_scores.gather(1, true_tails[:, None])
        raw = 1 + (all_scores > s_true).sum(dim=1)
        fs = all_scores.gather(1, filt)                       # [B, W]
        adj = (fs > s_true).sum(dim=1)  # own-tail pads are exact ties
        return raw, raw - adj

    def _filter_lists(self, known_triples: np.ndarray,
                      direction: str = "tail"):
        """int32[n_test, W] known-true-tail lists per test query, padded
        with the query's own tail (an exact tie: contributes 0).
        ``direction="head"``: known heads of (r, t), endpoints swapped."""
        e = self.test_edges
        kt = np.asarray(known_triples, dtype=np.int64)  # [K, 3] (h, t, r)
        if direction == "head":
            e = e[:, [1, 0, 2]]
            kt = kt[:, [1, 0, 2]]
        r_count = int(max(self.model_cfg.num_relations,
                          kt[:, 2].max() + 1 if len(kt) else 1))
        # Dedupe triples: multigraph data (and bidirected unions) repeat
        # (h, r, t), which would count one candidate twice in the rank
        # adjustment (each raw rank counts it once).
        n_nodes = int(self.graph.num_nodes)
        full_key = (kt[:, 0] * r_count + kt[:, 2]) * n_nodes + kt[:, 1]
        kt = kt[np.unique(full_key, return_index=True)[1]]
        key_known = kt[:, 0] * r_count + kt[:, 2]
        order = np.argsort(key_known, kind="stable")
        key_sorted = key_known[order]
        tails_sorted = kt[order, 1].astype(np.int32)
        key_q = e[:, 0].astype(np.int64) * r_count + e[:, 2]
        lo = np.searchsorted(key_sorted, key_q, side="left")
        hi = np.searchsorted(key_sorted, key_q, side="right")
        counts = hi - lo
        w = int(max(counts.max() if len(e) else 0, 1))
        filt = np.repeat(e[:, 1].astype(np.int32)[:, None], w, axis=1)
        total = int(counts.sum())
        if total:
            # Ragged lists flattened with the repeat-offset trick.
            qidx = np.repeat(np.arange(len(e), dtype=np.int64), counts)
            base = np.repeat(np.cumsum(counts) - counts, counts)
            slot = np.arange(total) - base
            pos = np.repeat(lo, counts) + slot
            filt[qidx, slot] = tails_sorted[pos]
        return filt

    def compute_filtered_ranking_metrics(
        self, known_triples: np.ndarray,
        k_values: Optional[Sequence[int]] = None,
        direction: str = "tail",
    ) -> Dict[str, float]:
        """Filtered ranking metrics (Bordes et al.): candidates that are
        themselves true tails of (h, r) anywhere in ``known_triples`` do not
        count against the test tail's rank. Dense evaluator only: the
        filter gathers from the ranker's own [B, N] score rows, which the
        fully sharded path never builds."""
        if self._node_emb is None:
            raise ValueError(
                "filtered ranking needs the dense evaluator "
                "(shard_encode='none'): the exact-tie filter gather reads "
                "the ranker's own score rows, which the fully-sharded "
                "path never materializes")
        k_values = list(k_values or self.cfg.k_values)
        if direction == "both":
            ranks = np.concatenate([
                self._filtered_ranks(known_triples, "tail"),
                self._filtered_ranks(known_triples, "head")])
            return ranking_metrics_from_ranks(ranks, k_values)
        return ranking_metrics_from_ranks(
            self._filtered_ranks(known_triples, direction), k_values)

    @torch.no_grad()
    def _filtered_ranks(self, known_triples: np.ndarray,
                        direction: str) -> np.ndarray:
        hit = self._franks.get(direction)
        if hit is not None and hit[0] is known_triples:
            return hit[1]
        e = self._directed_edges(direction)
        b = self.cfg.batch_size
        filt = torch.as_tensor(self._filter_lists(known_triples, direction),
                               dtype=torch.long, device=self.device)
        raws, franks = [], []
        for s in range(0, e.shape[0], b):
            raw, frk = self._rank_filtered_impl(
                e[s:s + b, 0], e[s:s + b, 2], e[s:s + b, 1], filt[s:s + b])
            raws.append(raw)
            franks.append(frk)
        raws = torch.cat(raws).cpu().numpy()
        franks = torch.cat(franks).cpu().numpy()
        if self._raw_ranks.get((direction, False)) is None:
            # The same matmul and comparisons as the dense ranker: cached
            # under the dense key (a sharded request still runs the sharded
            # ranker; the two must not share a slot).
            self._raw_ranks[(direction, False)] = raws
        if len(franks) and franks.min() < 1:
            raise AssertionError(
                "filtered rank < 1: adjustment exceeded raw rank despite "
                "single-tensor gathers")
        self._franks[direction] = (known_triples, franks)
        return franks

    def evaluate(self, known_triples: Optional[np.ndarray] = None,
                 rank_direction: str = "tail") -> Dict:
        """The full evaluation dict in the reference's results.json schema.
        ``known_triples`` adds a ``ranking_filtered`` block;
        ``rank_direction="both"`` adds ``ranking_head`` / ``ranking_both``
        (and their filtered variants)."""
        # Fail before any compute.
        if rank_direction not in ("tail", "both"):
            raise ValueError(f"rank_direction {rank_direction!r} — "
                             f"use 'tail' (reference protocol) or 'both'")
        if known_triples is not None and self._node_emb is None:
            raise ValueError(
                "filtered ranking needs the dense evaluator "
                "(shard_encode='none')")
        scores, labels = self.compute_scores_and_labels()
        cls = classification_metrics(scores, labels)
        filtered = None
        if known_triples is not None:
            # First: it also caches the dense raw ranks, so both blocks
            # come from one score tensor per batch.
            filtered = self.compute_filtered_ranking_metrics(known_triples)
        rnk = self.compute_ranking_metrics()
        out = {
            "classification": cls,
            "ranking": rnk,
            "test_edges": int(self.test_edges.shape[0]),
            "num_nodes": int(self.graph.num_nodes),
        }
        if filtered is not None:
            out["ranking_filtered"] = filtered
        if rank_direction == "both":
            # The filtered head pass first, for the same reason; the
            # blocks keep the JAX package's key order.
            fhead = None if known_triples is None else \
                self.compute_filtered_ranking_metrics(known_triples,
                                                      direction="head")
            out["ranking_head"] = self.compute_ranking_metrics(
                direction="head")
            out["ranking_both"] = self.compute_ranking_metrics(
                direction="both")
            if fhead is not None:
                out["ranking_filtered_head"] = fhead
                out["ranking_filtered_both"] = \
                    self.compute_filtered_ranking_metrics(
                        known_triples, direction="both")
        return out


def save_results(metrics: Dict, output_dir, model_info: Optional[Dict] = None):
    """Write results.json and metrics_summary.txt (the reference's files)."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    with open(output_dir / "results.json", "w") as f:
        json.dump({"metrics": metrics, "model_info": model_info or {}}, f,
                  indent=2)
    with open(output_dir / "metrics_summary.txt", "w") as f:
        f.write("=" * 60 + "\nEVALUATION RESULTS SUMMARY\n" + "=" * 60 + "\n\n")
        if model_info:
            f.write("Model Information:\n" + "-" * 60 + "\n")
            for k, v in model_info.items():
                f.write(f"{k}: {v}\n")
            f.write("\n")
        f.write("Dataset Statistics:\n" + "-" * 60 + "\n")
        f.write(f"Test edges: {metrics['test_edges']:,}\n")
        f.write(f"Number of nodes: {metrics['num_nodes']:,}\n\n")
        f.write("Classification Metrics:\n" + "-" * 60 + "\n")
        for k, v in metrics["classification"].items():
            f.write(f"{k}: {v:.4f}\n")
        f.write("\nRanking Metrics:\n" + "-" * 60 + "\n")
        for k, v in metrics["ranking"].items():
            f.write(f"{k}: {v:.4f}\n")
        titles = {
            "ranking_filtered": "Filtered Ranking Metrics (known true "
                                "tails removed from candidates)",
            "ranking_head": "Head Ranking Metrics",
            "ranking_both": "Head+Tail Ranking Metrics",
            "ranking_filtered_head": "Filtered Head Ranking Metrics",
            "ranking_filtered_both": "Filtered Head+Tail Ranking Metrics",
        }
        for key, title in titles.items():
            if key in metrics:
                f.write(f"\n{title}:\n" + "-" * 60 + "\n")
                for k, v in metrics[key].items():
                    f.write(f"{k}: {v:.4f}\n")
        f.write("\n" + "=" * 60 + "\n")
    logger.info("Saved results to %s", output_dir)
