"""Synthetic PrimeKG-shaped graphs.

Numpy code kept draw for draw equal to the JAX package's generator, so the
same seed gives byte-identical edges in both packages. Statistics follow the
reference's processed PrimeKG: 30,926 nodes (disease < drug < gene in id
order) and 854,278 undirected rows over three relations, each stored as a
forward and a reverse directed edge. ``primekg_full_like`` draws the
unfiltered PrimeKG's shape instead (BASELINE.json config 3): 129,375 nodes
and 30 relations. ``rmat`` draws the R-MAT power-law graph of BASELINE.json
config 5 (10M nodes, 100M edges, 50 relations); ``native.rmat_native`` is
its parallel C++ counterpart.
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



# Full (unfiltered) PrimeKG stand-in, BASELINE.json config 3: 129,375 nodes
# over ten node types and 30 relation buckets of 200 to 800,000 undirected
# rows (~2.26M, ~4.6M directed after bidirect), with the same power-law
# endpoint skew as primekg_like. Type sizes and row counts follow the public
# PrimeKG census; the table is the JAX package's, so both packages draw the
# same graph from a seed.
PRIMEKG_FULL_TYPE_SIZES = {
    "gene/protein": 27671, "drug": 7957, "disease": 17080,
    "anatomy": 14035, "biological_process": 28642,
    "molecular_function": 11169, "cellular_component": 4176,
    "pathway": 2516, "effect/phenotype": 15311, "exposure": 818,
}
PRIMEKG_FULL_RELATIONS = (
    # (name, src_type, dst_type, undirected rows)
    ("anatomy_protein_present", "anatomy", "gene/protein", 800_000),
    ("protein_protein", "gene/protein", "gene/protein", 321_075),
    ("drug_drug", "drug", "drug", 300_000),
    ("bioprocess_protein", "biological_process", "gene/protein", 180_000),
    ("cellcomp_protein", "cellular_component", "gene/protein", 90_000),
    ("disease_phenotype_positive", "disease", "effect/phenotype", 90_000),
    ("disease_protein", "disease", "gene/protein", 80_411),
    ("molfunc_protein", "molecular_function", "gene/protein", 70_000),
    ("bioprocess_bioprocess", "biological_process", "biological_process",
     60_000),
    ("drug_effect", "drug", "effect/phenotype", 50_000),
    ("pathway_protein", "pathway", "gene/protein", 40_000),
    ("disease_disease", "disease", "disease", 35_000),
    ("anatomy_anatomy", "anatomy", "anatomy", 30_000),
    ("contraindication", "drug", "disease", 30_000),
    ("drug_protein", "drug", "gene/protein", 25_653),
    ("phenotype_phenotype", "effect/phenotype", "effect/phenotype", 25_000),
    ("anatomy_protein_absent", "anatomy", "gene/protein", 20_000),
    ("indication", "drug", "disease", 18_000),
    ("molfunc_molfunc", "molecular_function", "molecular_function", 13_000),
    ("phenotype_protein", "effect/phenotype", "gene/protein", 6_000),
    ("cellcomp_cellcomp", "cellular_component", "cellular_component", 4_000),
    ("off_label_use", "drug", "disease", 2_500),
    ("pathway_pathway", "pathway", "pathway", 2_500),
    ("exposure_disease", "exposure", "disease", 2_000),
    ("exposure_exposure", "exposure", "exposure", 1_500),
    ("exposure_bioprocess", "exposure", "biological_process", 1_500),
    ("exposure_protein", "exposure", "gene/protein", 1_200),
    ("disease_phenotype_negative", "disease", "effect/phenotype", 1_000),
    ("exposure_molfunc", "exposure", "molecular_function", 300),
    ("exposure_cellcomp", "exposure", "cellular_component", 200),
)


def primekg_full_like(seed: int = 0, scale: float = 1.0,
                      *, alpha: float = ALPHA) -> Dict[str, np.ndarray]:
    """Full-PrimeKG-shaped graph: 129,375*scale nodes, 30 relations,
    ~2.26M*scale^2 undirected rows (~4.5M*scale^2 directed after
    :func:`bidirect`).

    Returns what :func:`primekg_like` returns, plus ``relation_names``;
    relation ids follow sorted(name) order and node types are laid out in
    sorted type order.
    """
    rng = np.random.default_rng(seed)
    ranges: Dict[str, Tuple[int, int]] = {}
    lo = 0
    for t in sorted(PRIMEKG_FULL_TYPE_SIZES):
        n_t = max(int(PRIMEKG_FULL_TYPE_SIZES[t] * scale), 4)
        ranges[t] = (lo, lo + n_t)
        lo += n_t
    num_nodes = lo

    names = sorted(r[0] for r in PRIMEKG_FULL_RELATIONS)
    rel_id = {n: i for i, n in enumerate(names)}
    rows_src, rows_dst, rows_rel = [], [], []
    for name, st, dt, rows in PRIMEKG_FULL_RELATIONS:
        n_rows = max(int(rows * scale * scale), 8)
        rows_src.append(
            _sample_powerlaw_endpoints(rng, n_rows, *ranges[st], alpha))
        rows_dst.append(
            _sample_powerlaw_endpoints(rng, n_rows, *ranges[dt], alpha))
        rows_rel.append(np.full(n_rows, rel_id[name], dtype=np.int64))

    return {
        "src": np.concatenate(rows_src),
        "dst": np.concatenate(rows_dst),
        "rel": np.concatenate(rows_rel),
        "num_nodes": num_nodes,
        "num_relations": len(names),
        "relation_names": tuple(names),
        "type_ranges": ranges,
    }

def bidirect(src: np.ndarray, dst: np.ndarray, rel: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Add a reverse edge with the same relation id for every row."""
    return (
        np.concatenate([src, dst]),
        np.concatenate([dst, src]),
        np.concatenate([rel, rel]),
    )


def rmat(num_nodes: int, num_edges: int, num_relations: int, seed: int = 0,
         *, a: float = 0.57, b: float = 0.19, c: float = 0.19
         ) -> Dict[str, np.ndarray]:
    """R-MAT power-law graph (Chakrabarti et al. 2004), vectorised: each of
    ceil(log2 N) rounds draws one uniform per edge and picks a quadrant (a,
    b, c, or d = 1 - a - b - c), appending one bit to the edge's source and
    destination ids; ids are then folded into [0, N) and each edge gets a
    uniform relation. The draws are the JAX package's, in its order, so
    one seed gives the same arrays."""
    rng = np.random.default_rng(seed)
    n_bits = max(int(np.ceil(np.log2(max(num_nodes, 2)))), 1)
    src = np.zeros(num_edges, dtype=np.int64)
    dst = np.zeros(num_edges, dtype=np.int64)
    for _ in range(n_bits):
        r = rng.random(num_edges)
        src_bit = (r >= a + b).astype(np.int64)          # quadrants c, d
        dst_bit = ((r >= a) & (r < a + b) | (r >= a + b + c)).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    src %= num_nodes
    dst %= num_nodes
    rel = rng.integers(0, num_relations, num_edges, dtype=np.int64)
    return {"src": src, "dst": dst, "rel": rel, "num_nodes": num_nodes,
            "num_relations": num_relations}


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
