"""Shared inference layer of the analysis suite.

The counterpart of ``primekg_rgcn_tpu/analyze/core.py``: one context object
loads the checkpoint and the processed data once, encodes the full graph
once (kernel B1 on the card, its plain version on the CPU) and serves every
analysis tool the cached embeddings, the name indexes and an undirected
view of the graph.

Drug-disease pairs are scored by the cosine similarity of encoder
embeddings rescaled to [0, 1], not by the DistMult decoder: the processed
graph has no direct drug-disease edges.

The JAX context keeps a NetworkX graph. Here the undirected graph is a CSR
in numpy, each node's neighbours in NetworkX's insertion order, and
``find_paths`` returns what ``nx.all_simple_paths`` gives, in its order,
with a depth-first search pruned by the hop distance to the target.
"""

from __future__ import annotations

import csv
import itertools
import logging
from functools import cached_property
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


def pyplot(log: Optional[logging.Logger] = None, what: str = ""):
    """matplotlib's pyplot on the Agg backend, or None where matplotlib is
    not installed (logged on ``log``, if given: ``what`` were not
    written)."""
    try:
        import matplotlib
    except ImportError:
        if log is not None:
            log.info("matplotlib is not installed: %s were not written",
                     what)
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def networkx(log: logging.Logger, what: str):
    """networkx, or None where it is not installed (logged on ``log``:
    ``what`` were not written)."""
    try:
        import networkx as nx
    except ImportError:
        log.info("networkx is not installed: %s were not written", what)
        return None
    return nx


def write_csv(path, header: Sequence[str], rows) -> None:
    """A CSV as ``pandas.DataFrame.to_csv(index=False)`` writes it: minimal
    quoting, ``\\n`` line ends, each value as ``str`` gives it (so a numpy
    float32 keeps its shortest float32 form). No header and no rows give
    one empty line, as an empty DataFrame does."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


def simple_paths(indptr: np.ndarray, nbrs: np.ndarray, source: int,
                 target: int, cutoff: int,
                 dist: Optional[np.ndarray] = None) -> Iterator[List[int]]:
    """Simple paths from ``source`` to ``target`` of at most ``cutoff``
    edges over the CSR (``indptr``, ``nbrs``), in the depth-first order of
    ``nx.all_simple_paths`` over the same adjacency order.

    With ``dist`` (each node's hop distance to ``target``; anything above
    ``cutoff - 1`` for nodes beyond), a node reached after ``k`` edges is
    entered only if ``dist <= cutoff - k``: that drops only subtrees that
    hold no path, so the paths and their order are unchanged.
    """
    if cutoff < 0:
        return
    if source == target:
        yield [source]
        return

    def children(u: int, depth: int):
        nb = nbrs[indptr[u]:indptr[u + 1]]
        if dist is not None:
            nb = nb[dist[nb] <= cutoff - depth]
        return iter(nb.tolist())

    if cutoff == 0 or (dist is not None and dist[source] > cutoff):
        return
    path = [source]
    on_path = {source}
    stack = [children(source, 1)]
    while stack:
        c = next(stack[-1], None)
        if c is None:
            stack.pop()
            on_path.discard(path.pop())
            continue
        if c in on_path:
            continue
        if c == target:
            yield path + [c]
        elif len(path) < cutoff:
            path.append(c)
            on_path.add(c)
            stack.append(children(c, len(path)))


class PathIndex:
    """The undirected graph of an edge list (``edges`` [E, >= 2], node ids
    in ``[0, num_nodes)``), as NetworkX would hold it, for simple-path
    searches."""

    def __init__(self, edges: np.ndarray, num_nodes: int):
        self.edges = np.asarray(edges)
        self.num_nodes = int(num_nodes)

    @cached_property
    def adjacency(self) -> Tuple[np.ndarray, np.ndarray]:
        """The undirected graph as a CSR (``indptr`` [N+1], ``nbrs``): each
        node's neighbours in NetworkX's insertion order for these edges,
        the order of the first edge of ``edges`` that joins the pair,
        in either direction."""
        n = self.num_nodes
        h = self.edges[:, 0].astype(np.int64)
        t = self.edges[:, 1].astype(np.int64)
        a = np.concatenate([h, t])
        b = np.concatenate([t, h])
        first = np.tile(np.arange(len(h), dtype=np.int64), 2)
        order = np.lexsort((first, a * n + b))
        key = (a * n + b)[order]
        keep = np.ones(len(order), bool)
        keep[1:] = key[1:] != key[:-1]
        sel = order[keep]
        o = np.lexsort((first[sel], a[sel]))
        nbrs = b[sel][o]
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(a[sel], minlength=n), out=indptr[1:])
        return indptr, nbrs

    def distances_to(self, target: int, depth: int) -> np.ndarray:
        """Hop distance of every node to ``target`` over the undirected
        graph, up to ``depth`` (``depth + 1`` beyond it): a breadth-first
        search, one numpy pass per level."""
        indptr, nbrs = self.adjacency
        n = len(indptr) - 1
        dist = np.full(n, depth + 1, np.int32)
        dist[target] = 0
        frontier = np.array([target], np.int64)
        for d in range(1, depth + 1):
            starts = indptr[frontier]
            counts = indptr[frontier + 1] - starts
            total = int(counts.sum())
            if total == 0:
                break
            offsets = np.repeat(starts - np.cumsum(counts) + counts, counts)
            seen = np.zeros(n, bool)
            seen[nbrs[offsets + np.arange(total)]] = True
            frontier = np.flatnonzero(seen & (dist > d))
            dist[frontier] = d
        return dist

    def find_paths(self, source: int, target: int, max_length: int = 4,
                   max_paths: int = 20) -> List[List[int]]:
        """The JAX context's bounded simple-path enumeration: the first
        ``max_paths * 5`` paths of ``nx.all_simple_paths(source, target,
        cutoff=max_length)`` (at least one), stably sorted by length, cut to
        ``max_paths``. The search skips nodes farther from ``target`` than
        the edges left (``distances_to``)."""
        n = self.num_nodes
        source, target = int(source), int(target)
        if not (0 <= source < n and 0 <= target < n):
            return []
        indptr, nbrs = self.adjacency
        dist = self.distances_to(target, max(max_length - 1, 0))
        paths = list(itertools.islice(
            simple_paths(indptr, nbrs, source, target, max_length, dist),
            max(max_paths * 5, 1)))
        paths.sort(key=len)
        return paths[:max_paths]


class AnalysisContext:
    """Loads the checkpoint and artifacts once; serves every analysis tool.

    ``device`` runs the encode ("cuda" by default; it raises without a
    card). ``embeddings`` ([N, D], optional) stands in for the encode, so
    that a caller can hand the tools embeddings computed elsewhere.
    """

    def __init__(self, model_path, data_dir, *, device="cuda",
                 embeddings: Optional[np.ndarray] = None):
        from primekg_rgcn_tpu_torch.config import ModelConfig
        from primekg_rgcn_tpu_torch.data import artifacts
        from primekg_rgcn_tpu_torch.device import resolve_device
        from primekg_rgcn_tpu_torch.models.rgcn import encoder_apply
        from primekg_rgcn_tpu_torch.train import checkpoint as ckpt

        self.device = resolve_device(device)
        self.model_path = str(model_path)
        self.data_dir = Path(data_dir)

        payload = ckpt.load(model_path, device=self.device)
        self.params = payload["params"]
        self.model_cfg = ModelConfig.from_dict(payload["model_config"])
        self.checkpoint_meta = {k: v for k, v in payload.items()
                                if k != "params"}

        ds = artifacts.load_dataset(data_dir, require_train=False)
        self.mappings = ds["mappings"]
        self.train_split = ds["train"]
        self.full_split = ds["full"] or ds["train"] or ds["test"]
        if self.full_split is None:
            raise FileNotFoundError(f"no graph artifacts in {data_dir}")
        self.full_graph = artifacts.split_to_rel_graph(self.full_split)
        self.full_edges = artifacts.split_to_edges(self.full_split)
        self.train_edges = (artifacts.split_to_edges(self.train_split)
                            if self.train_split else self.full_edges)

        if embeddings is None:
            logger.info("Encoding full graph (%d nodes, %d edges) on %s...",
                        self.full_graph.num_nodes, self.full_graph.num_edges,
                        self.device)
            with torch.no_grad():
                emb = encoder_apply(self.params,
                                    self.full_graph.to(self.device),
                                    self.model_cfg)
            embeddings = emb.cpu().numpy()
        self.embeddings = np.asarray(embeddings, dtype=np.float32)
        norms = np.linalg.norm(self.embeddings, axis=1, keepdims=True)
        self.embeddings_norm = self.embeddings / np.maximum(norms, 1e-12)

    # -- node naming ---------------------------------------------------------
    @cached_property
    def node_names(self) -> List[str]:
        n = self.full_graph.num_nodes
        names = [f"node_{i}" for i in range(n)]
        if self.mappings:
            for idx, (nid, name, ntype) in self.mappings["idx2node"].items():
                if 0 <= idx < n:
                    names[idx] = str(name)
        return names

    @cached_property
    def node_types(self) -> np.ndarray:
        """Array of type strings per node ('' when unmapped)."""
        n = self.full_graph.num_nodes
        types = np.array([""] * n, dtype=object)
        if self.mappings:
            for idx, (nid, name, ntype) in self.mappings["idx2node"].items():
                if 0 <= idx < n:
                    types[idx] = ntype
        return types

    def indices_of_type(self, node_type: str) -> np.ndarray:
        return np.flatnonzero(self.node_types == node_type)

    @cached_property
    def drug_indices(self) -> np.ndarray:
        return self.indices_of_type("drug")

    @cached_property
    def disease_indices(self) -> np.ndarray:
        return self.indices_of_type("disease")

    @cached_property
    def gene_indices(self) -> np.ndarray:
        return self.indices_of_type("gene/protein")

    def find_node(self, name: str, node_type: str) -> Optional[int]:
        """Exact, then case-insensitive, then shortest case-insensitive
        substring name match among the nodes of ``node_type``."""
        cand = self.indices_of_type(node_type)
        names = self.node_names
        for i in cand:
            if names[i] == name:
                return int(i)
        low = name.lower()
        for i in cand:
            if low == names[i].lower():
                return int(i)
        matches = [int(i) for i in cand if low in names[i].lower()]
        if matches:
            matches.sort(key=lambda i: len(names[i]))
            return matches[0]
        return None

    # -- scoring -------------------------------------------------------------
    def cosine_score(self, a_idx: int, b_idx: int) -> float:
        """Cosine similarity rescaled to [0, 1]."""
        s = float(self.embeddings_norm[a_idx] @ self.embeddings_norm[b_idx])
        return (s + 1.0) / 2.0

    def cosine_scores_against(self, idx: int,
                              candidates: np.ndarray) -> np.ndarray:
        sims = self.embeddings_norm[candidates] @ self.embeddings_norm[idx]
        return (sims + 1.0) / 2.0

    def top_drugs_for_disease(self, disease_idx: int, top_k: int = 10,
                              threshold: float = 0.0
                              ) -> List[Tuple[int, float]]:
        scores = self.cosine_scores_against(disease_idx, self.drug_indices)
        order = np.argsort(-scores)
        out = []
        for i in order:
            if scores[i] < threshold:
                continue
            out.append((int(self.drug_indices[i]), float(scores[i])))
            if len(out) >= top_k:
                break
        return out

    def known_direct_associations(self, disease_idx: int,
                                  drug_indices: Sequence[int]
                                  ) -> Dict[int, bool]:
        """Direct drug-disease train edges (in PrimeKG's processed graph
        there are none, so every prediction reports novel)."""
        drug_set = set(int(d) for d in drug_indices)
        known = {d: False for d in drug_set}
        e = self.train_edges
        hit_head = np.isin(e[:, 0], list(drug_set)) & (e[:, 1] == disease_idx)
        hit_tail = (e[:, 0] == disease_idx) & np.isin(e[:, 1], list(drug_set))
        for d in e[hit_head, 0]:
            known[int(d)] = True
        for d in e[hit_tail, 1]:
            known[int(d)] = True
        return known

    # -- graph views ---------------------------------------------------------
    @cached_property
    def path_index(self) -> "PathIndex":
        """The undirected graph of ``full_edges`` for path searches."""
        return PathIndex(self.full_edges, self.full_graph.num_nodes)

    @cached_property
    def neighbor_sets(self) -> Dict[int, set]:
        """Adjacency as python sets, built in the JAX context's insertion
        order so that their iteration order is the same."""
        indptr, nbrs = self.path_index.adjacency
        deg = np.diff(indptr)
        return {int(u): set(nbrs[indptr[u]:indptr[u + 1]].tolist())
                for u in np.flatnonzero(deg)}

    @cached_property
    def _gene_set(self) -> set:
        return set(int(g) for g in self.gene_indices)

    def gene_neighbors(self, idx: int) -> set:
        return self.neighbor_sets.get(int(idx), set()) & self._gene_set

    @cached_property
    def pair_relation(self) -> Dict[Tuple[int, int], int]:
        """(head, tail) -> relation id of every stored edge; the last edge
        of a pair wins."""
        e = self.full_edges
        return dict(zip(zip(e[:, 0].tolist(), e[:, 1].tolist()),
                        e[:, 2].tolist()))

    def relation_name(self, rel: int) -> str:
        if self.mappings:
            return str(self.mappings["idx2relation"].get(
                int(rel), str(int(rel))))
        return str(int(rel))

    def edge_relation_name(self, a: int, b: int) -> str:
        r = self.pair_relation.get((int(a), int(b)))
        if r is None:
            r = self.pair_relation.get((int(b), int(a)))
        return self.relation_name(r) if r is not None else ""

    def find_paths(self, source: int, target: int, max_length: int = 4,
                   max_paths: int = 20) -> List[List[int]]:
        """The JAX context's bounded simple-path enumeration
        (``PathIndex.find_paths``)."""
        return self.path_index.find_paths(source, target, max_length,
                                          max_paths)
