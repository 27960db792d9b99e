"""Frozen copies of the PrimeKG-statistics graph makers, numpy only.

Copied from ``primekg_rgcn_tpu_torch/data/synthetic.py`` (``primekg_like``,
``primekg_full_like``, ``bidirect``) so that a later change to the port's
generators cannot change what the benchmark trains on. Draw for draw the
same as the copied functions: one seed gives the same arrays, except that
full PrimeKG's relations here have the census's row counts, where the
port's generator approximates them (2,300,839 rows).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

PRIMEKG_NUM_DISEASE = 5593
PRIMEKG_NUM_DRUG = 6282
PRIMEKG_NUM_GENE = 19051

# Undirected row counts per standardized relation; relation ids follow
# sorted(name) order: drug-gene 0, gene-disease 1, gene-gene 2.
PRIMEKG_REL_ROWS = {"drug-gene": 51306, "gene-gene": 642150,
                    "gene-disease": 160822}
PRIMEKG_RELATIONS = ("drug-gene", "gene-disease", "gene-gene")

ALPHA = 2.5
N_COMMUNITIES = 64
P_STRUCTURED = 0.8


def _powerlaw_endpoints(rng: np.random.Generator, n_rows: int, lo: int,
                        hi: int, alpha: float) -> np.ndarray:
    n = hi - lo
    u = rng.random(n_rows)
    ranks = np.floor(n * u ** alpha).astype(np.int64)
    perm = rng.permutation(n)
    return lo + perm[np.clip(ranks, 0, n - 1)]


def primekg_like(seed: int, scale: float = 1.0) -> Dict:
    """The processed PrimeKG's shape: 30,926 nodes (disease < drug < gene)
    and 854,278 undirected rows over 3 relations at scale 1; node counts
    scale linearly and row counts quadratically."""
    rng = np.random.default_rng(seed)
    nd = max(int(PRIMEKG_NUM_DISEASE * scale), 4)
    ng = max(int(PRIMEKG_NUM_DRUG * scale), 4)
    npr = max(int(PRIMEKG_NUM_GENE * scale), 8)
    disease, drug, gene = (0, nd), (nd, nd + ng), (nd + ng, nd + ng + npr)
    num_nodes = nd + ng + npr
    specs = {
        0: (drug, gene,
            int(PRIMEKG_REL_ROWS["drug-gene"] * scale * scale) or 16),
        1: (disease, gene,
            int(PRIMEKG_REL_ROWS["gene-disease"] * scale * scale) or 16),
        2: (gene, gene,
            int(PRIMEKG_REL_ROWS["gene-gene"] * scale * scale) or 16),
    }
    community = rng.integers(0, N_COMMUNITIES, num_nodes)
    rows_src, rows_dst, rows_rel = [], [], []
    for rid, (srange, drange, n_rows) in specs.items():
        s = _powerlaw_endpoints(rng, n_rows, srange[0], srange[1], ALPHA)
        d = _powerlaw_endpoints(rng, n_rows, drange[0], drange[1], ALPHA)
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
        n_src = srange[1] - srange[0]
        if n_rows >= n_src:
            s[:n_src] = np.arange(srange[0], srange[1])
        rows_src.append(s)
        rows_dst.append(d)
        rows_rel.append(np.full(n_rows, rid, dtype=np.int64))
    return {"src": np.concatenate(rows_src), "dst": np.concatenate(rows_dst),
            "rel": np.concatenate(rows_rel), "num_nodes": num_nodes,
            "num_relations": 3, "relation_names": PRIMEKG_RELATIONS}


# Full PrimeKG (Chandak, Huang and Zitnik, Scientific Data 2023): the type
# sizes of its 129,375 nodes and the undirected row count of each of its 30
# relations, 4,050,249 in all: half of each relation's rows in the released
# kg.csv (8,100,498 rows, each relationship listed in both directions).
PRIMEKG_FULL_TYPE_SIZES = {
    "gene/protein": 27671, "drug": 7957, "disease": 17080,
    "anatomy": 14035, "biological_process": 28642,
    "molecular_function": 11169, "cellular_component": 4176,
    "pathway": 2516, "effect/phenotype": 15311, "exposure": 818,
}
PRIMEKG_FULL_RELATIONS = (
    ("anatomy_protein_present", "anatomy", "gene/protein", 1_518_203),
    ("drug_drug", "drug", "drug", 1_336_314),
    ("protein_protein", "gene/protein", "gene/protein", 321_075),
    ("disease_phenotype_positive", "disease", "effect/phenotype", 150_317),
    ("bioprocess_protein", "biological_process", "gene/protein", 144_805),
    ("cellcomp_protein", "cellular_component", "gene/protein", 83_402),
    ("disease_protein", "disease", "gene/protein", 80_411),
    ("molfunc_protein", "molecular_function", "gene/protein", 69_530),
    ("drug_effect", "drug", "effect/phenotype", 64_784),
    ("bioprocess_bioprocess", "biological_process", "biological_process",
     52_886),
    ("pathway_protein", "pathway", "gene/protein", 42_646),
    ("disease_disease", "disease", "disease", 32_194),
    ("contraindication", "drug", "disease", 30_675),
    ("drug_protein", "drug", "gene/protein", 25_653),
    ("anatomy_protein_absent", "anatomy", "gene/protein", 19_887),
    ("phenotype_phenotype", "effect/phenotype", "effect/phenotype", 18_736),
    ("anatomy_anatomy", "anatomy", "anatomy", 14_032),
    ("molfunc_molfunc", "molecular_function", "molecular_function", 13_574),
    ("indication", "drug", "disease", 9_388),
    ("cellcomp_cellcomp", "cellular_component", "cellular_component", 4_845),
    ("phenotype_protein", "effect/phenotype", "gene/protein", 3_330),
    ("off_label_use", "drug", "disease", 2_568),
    ("pathway_pathway", "pathway", "pathway", 2_535),
    ("exposure_disease", "exposure", "disease", 2_304),
    ("exposure_exposure", "exposure", "exposure", 2_070),
    ("exposure_bioprocess", "exposure", "biological_process", 1_625),
    ("exposure_protein", "exposure", "gene/protein", 1_212),
    ("disease_phenotype_negative", "disease", "effect/phenotype", 1_193),
    ("exposure_molfunc", "exposure", "molecular_function", 45),
    ("exposure_cellcomp", "exposure", "cellular_component", 10),
)


def primekg_full_like(seed: int, scale: float = 1.0) -> Dict:
    """Full PrimeKG's shape: 129,375 nodes of ten types and 30 relations,
    4,050,249 undirected rows at scale 1; relation ids in sorted(name)
    order, node types laid out in sorted type order."""
    rng = np.random.default_rng(seed)
    ranges: Dict[str, Tuple[int, int]] = {}
    lo = 0
    for t in sorted(PRIMEKG_FULL_TYPE_SIZES):
        n_t = max(int(PRIMEKG_FULL_TYPE_SIZES[t] * scale), 4)
        ranges[t] = (lo, lo + n_t)
        lo += n_t
    names = tuple(sorted(r[0] for r in PRIMEKG_FULL_RELATIONS))
    rel_id = {n: i for i, n in enumerate(names)}
    rows_src, rows_dst, rows_rel = [], [], []
    for name, st, dt, rows in PRIMEKG_FULL_RELATIONS:
        n_rows = max(int(rows * scale * scale), 8)
        rows_src.append(_powerlaw_endpoints(rng, n_rows, *ranges[st], ALPHA))
        rows_dst.append(_powerlaw_endpoints(rng, n_rows, *ranges[dt], ALPHA))
        rows_rel.append(np.full(n_rows, rel_id[name], dtype=np.int64))
    return {"src": np.concatenate(rows_src), "dst": np.concatenate(rows_dst),
            "rel": np.concatenate(rows_rel), "num_nodes": lo,
            "num_relations": len(names), "relation_names": names}


MAKERS = {"primekg_like": primekg_like,
          "primekg_full_like": primekg_full_like}


def bidirect(src: np.ndarray, dst: np.ndarray, rel: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A reverse edge with the same relation id for every row."""
    return (np.concatenate([src, dst]), np.concatenate([dst, src]),
            np.concatenate([rel, rel]))
