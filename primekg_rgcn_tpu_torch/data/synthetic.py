"""Synthetic PrimeKG-shaped graphs.

Numpy code kept draw for draw equal to the JAX package's generator, so the
same seed gives byte-identical edges in both packages. Statistics follow the
reference's processed PrimeKG: 30,926 nodes (disease < drug < gene in id
order) and 854,278 undirected rows over three relations, each stored as a
forward and a reverse directed edge.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

PRIMEKG_NUM_DISEASE = 5593
PRIMEKG_NUM_DRUG = 6282
PRIMEKG_NUM_GENE = 19051
PRIMEKG_NUM_NODES = PRIMEKG_NUM_DISEASE + PRIMEKG_NUM_DRUG + PRIMEKG_NUM_GENE

# Undirected row counts per standardized relation.
PRIMEKG_REL_ROWS = {"drug-gene": 51306, "gene-gene": 642150, "gene-disease": 160822}
# Relation ids follow sorted(unique) order: drug-gene=0, gene-disease=1,
# gene-gene=2.
PRIMEKG_RELATIONS = ("drug-gene", "gene-disease", "gene-gene")

# Generator shape: power-law exponent over degree ranks, number of latent
# node communities, and the share of rows drawn inside a community.
ALPHA = 2.5
N_COMMUNITIES = 64
P_STRUCTURED = 0.8


def _sample_powerlaw_endpoints(
    rng: np.random.Generator, n_rows: int, lo: int, hi: int, alpha: float
) -> np.ndarray:
    """Node ids in [lo, hi) with a Zipf-like skew (hub genes with thousands
    of interactions), by inverse-CDF sampling of a truncated power law over
    ranks."""
    n = hi - lo
    u = rng.random(n_rows)
    ranks = np.floor(n * u ** alpha).astype(np.int64)
    perm = rng.permutation(n)
    return lo + perm[np.clip(ranks, 0, n - 1)]


def primekg_like(seed: int = 0, scale: float = 1.0) -> Dict[str, np.ndarray]:
    """Generate a PrimeKG-shaped heterogeneous graph.

    Returns undirected rows ``src``, ``dst``, ``rel`` (int64) plus
    ``num_nodes``, ``num_relations`` and ``type_ranges``. ``scale`` < 1
    shrinks node counts linearly and row counts quadratically (for tests).
    ``P_STRUCTURED`` of each relation's rows are drawn inside a latent node
    community, so held-out edges are predictable from the graph.
    """
    rng = np.random.default_rng(seed)
    nd = max(int(PRIMEKG_NUM_DISEASE * scale), 4)
    ng = max(int(PRIMEKG_NUM_DRUG * scale), 4)
    npr = max(int(PRIMEKG_NUM_GENE * scale), 8)
    disease = (0, nd)
    drug = (nd, nd + ng)
    gene = (nd + ng, nd + ng + npr)
    num_nodes = nd + ng + npr

    rows_src, rows_dst, rows_rel = [], [], []
    specs = {
        # relation id -> (src range, dst range, rows); the forward direction
        # matches the raw PrimeKG rows (drug->gene, disease->gene, gene->gene).
        0: (drug, gene, int(PRIMEKG_REL_ROWS["drug-gene"] * scale * scale) or 16),
        1: (disease, gene, int(PRIMEKG_REL_ROWS["gene-disease"] * scale * scale) or 16),
        2: (gene, gene, int(PRIMEKG_REL_ROWS["gene-gene"] * scale * scale) or 16),
    }
    community = rng.integers(0, N_COMMUNITIES, num_nodes)

    for rid, (srange, drange, n_rows) in specs.items():
        s = _sample_powerlaw_endpoints(rng, n_rows, srange[0], srange[1], ALPHA)
        d = _sample_powerlaw_endpoints(rng, n_rows, drange[0], drange[1], ALPHA)
        # Rewire a fraction of destinations to a member of the source's
        # community (inside the destination type range), picked by a
        # power-law rank so the hub-node degree profile survives.
        dst_ids = np.arange(drange[0], drange[1])
        dst_comm = community[dst_ids]
        order = np.argsort(dst_comm, kind="stable")
        sorted_ids = dst_ids[order]
        bounds = np.searchsorted(dst_comm[order], np.arange(N_COMMUNITIES + 1))
        rewire = rng.random(n_rows) < P_STRUCTURED
        cs = community[s]
        lo, hi = bounds[cs], bounds[np.minimum(cs + 1, N_COMMUNITIES)]
        has_member = hi > lo
        u = rng.random(n_rows)
        offset = np.floor(np.maximum(hi - lo, 1) * u ** ALPHA).astype(np.int64)
        pick = lo + np.minimum(offset, np.maximum(hi - lo - 1, 0))
        d = np.where(rewire & has_member, sorted_ids[pick], d)
        # Every source-type entity appears in at least one row: overwrite the
        # first |range| rows, keeping the row counts.
        n_src = srange[1] - srange[0]
        if n_rows >= n_src:
            s[:n_src] = np.arange(srange[0], srange[1])
        rows_src.append(s)
        rows_dst.append(d)
        rows_rel.append(np.full(n_rows, rid, dtype=np.int64))

    return {
        "src": np.concatenate(rows_src),
        "dst": np.concatenate(rows_dst),
        "rel": np.concatenate(rows_rel),
        "num_nodes": num_nodes,
        "num_relations": 3,
        "type_ranges": {"disease": disease, "drug": drug, "gene/protein": gene},
    }


def bidirect(src: np.ndarray, dst: np.ndarray, rel: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Add a reverse edge with the same relation id for every row."""
    return (
        np.concatenate([src, dst]),
        np.concatenate([dst, src]),
        np.concatenate([rel, rel]),
    )


def synthetic_mappings(raw: Dict[str, np.ndarray]) -> Dict:
    """Reference-format mappings (ids, names, types) for a primekg_like
    graph, so that tools which print names work on synthetic data."""
    idx2node = {}
    node2idx = {}
    for ntype, (lo, hi) in raw["type_ranges"].items():
        tag = {"drug": "drug", "disease": "disease",
               "gene/protein": "gene"}[ntype]
        for i in range(lo, hi):
            nid = f"SYN{tag.upper()}{i - lo}"
            name = f"synthetic {tag} {i - lo}"
            idx2node[i] = (nid, name, ntype)
            node2idx[(nid, ntype)] = i
    relation2idx = {r: i for i, r in enumerate(PRIMEKG_RELATIONS)}
    return {
        "node2idx": node2idx,
        "idx2node": idx2node,
        "relation2idx": relation2idx,
        "idx2relation": {i: r for r, i in relation2idx.items()},
    }
