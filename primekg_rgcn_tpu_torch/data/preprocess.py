"""PrimeKG preprocessing: raw kg.csv -> processed artifacts, numpy only.

The counterpart of ``primekg_rgcn_tpu/data/preprocess.py``, written with
numpy and the ``csv`` module in place of pandas and sklearn, so that it
runs where neither is installed, and writing the same artifacts:

- node-type filter {drug, gene/protein, disease}; relation filter
  {drug_protein, protein_protein, disease_protein} standardised to
  {drug-gene, gene-gene, gene-disease}; ``keep_all_relations`` keeps every
  row, the trio still renamed;
- node ids keyed by (id, type), sorted by (type, id, name); relations
  sorted alphabetically;
- only the target relation's rows (drug-gene, else gene-disease) are split
  70/15/15, with sklearn's ``train_test_split`` reproduced exactly
  (:func:`train_test_indices`); every other row stays in train;
- every kept row emits a forward and a reverse directed edge with the same
  relation id;
- outputs: ``{train,val,test}_data`` and ``full_graph`` as ``.npz`` (and
  ``.pt`` unless ``write_torch=False``), ``mappings.json`` (and ``.pt``),
  the three split CSVs and ``statistics.csv``.

Values are read as pandas reads them where that matters to the output: a
column whose every value is an integer is an integer column to pandas, so
its values are normalised with ``str(int(v))`` ("007" -> "7"); every other
value keeps its text. Where pandas would read a float (decimals, or an
integer column with an empty cell) or a missing value (an empty cell,
"NA", ...), this module keeps the text (ROADMAP.md, queue C).
"""

from __future__ import annotations

import csv
import logging
import math
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from primekg_rgcn_tpu_torch.config import DataConfig

logger = logging.getLogger(__name__)

TARGET_NODE_TYPES = {"drug", "gene/protein", "disease"}
RELATION_STANDARDIZATION = {
    "drug_protein": "drug-gene",
    "protein_protein": "gene-gene",
    "disease_protein": "gene-disease",
}
_INTEGER = re.compile(r"\s*[+-]?\d+\s*")


def train_test_indices(n: int, test_size: float,
                       seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(train, test) row indices exactly as
    ``sklearn.model_selection.train_test_split(rows, test_size=test_size,
    random_state=seed)`` picks them: a ``RandomState(seed)`` permutation,
    the first ceil(test_size * n) rows the test set, the rest train."""
    if not 0 < test_size < 1:
        raise ValueError(f"test_size={test_size} should be a float in the "
                         f"(0, 1) range")
    n_test = math.ceil(test_size * n)
    if n - n_test == 0:
        raise ValueError(f"With n_samples={n}, test_size={test_size}, the "
                         f"resulting train set will be empty")
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:], perm[:n_test]


class Table:
    """Named columns of equal length (object arrays of str), in file
    order: what the preprocessor keeps of a CSV."""

    def __init__(self, columns: Dict[str, np.ndarray]):
        self.columns = columns

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def take(self, rows) -> "Table":
        return Table({k: v[rows] for k, v in self.columns.items()})

    def concat(self, other: "Table") -> "Table":
        return Table({k: np.concatenate([v, other.columns[k]])
                      for k, v in self.columns.items()})

    def with_column(self, name: str, values: np.ndarray) -> "Table":
        return Table({**self.columns, name: values})

    @classmethod
    def read_csv(cls, path) -> "Table":
        with open(path, newline="") as f:
            reader = csv.reader(f)
            header = next(reader)
            rows = list(reader)
        columns = {}
        for j, name in enumerate(header):
            values = [row[j] for row in rows]
            if values and all(_INTEGER.fullmatch(v) for v in values):
                values = [str(int(v)) for v in values]
            col = np.empty(len(values), dtype=object)
            col[:] = values
            columns[name] = col
        return cls(columns)

    def write_csv(self, path) -> None:
        with open(path, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(list(self.columns))
            writer.writerows(zip(*self.columns.values()))


def _isin(values: np.ndarray, allowed) -> np.ndarray:
    return np.fromiter((v in allowed for v in values), dtype=bool,
                       count=len(values))


class PrimeKGPreprocessor:
    """The reference's preprocessor surface (load, filter, map, split,
    convert, save), over :class:`Table` in place of a DataFrame."""

    def __init__(self, raw_data_path: str, processed_data_path: str,
                 *, write_torch: bool = True,
                 keep_all_relations: bool = False):
        self.raw_data_path = Path(raw_data_path)
        self.processed_data_path = Path(processed_data_path)
        self.processed_data_path.mkdir(parents=True, exist_ok=True)
        self.write_torch = write_torch
        # Full PrimeKG (~129K nodes, ~30 relations): skip the 3-relation /
        # 3-node-type filter and keep every row; the trio keeps its
        # standardised names, so the drug-gene split target is the same.
        self.keep_all_relations = keep_all_relations
        self.node2idx: Dict[Tuple[str, str], int] = {}
        self.idx2node: Dict[int, Tuple[str, str, str]] = {}
        self.relation2idx: Dict[str, int] = {}
        self.idx2relation: Dict[int, str] = {}
        self.stats: Dict[str, int] = {}

    # -- pipeline stages -----------------------------------------------------
    def load_data(self) -> Table:
        logger.info("Loading %s", self.raw_data_path)
        df = Table.read_csv(self.raw_data_path)
        self.stats["total_edges"] = len(df)
        self.stats["total_node_types"] = len(set(df["x_type"]))
        self.stats["total_relation_types"] = len(set(df["relation"]))
        return df

    def filter_subgraph(self, df: Table) -> Table:
        rel = df["relation"]
        if not self.keep_all_relations:
            mask = (_isin(df["x_type"], TARGET_NODE_TYPES)
                    & _isin(df["y_type"], TARGET_NODE_TYPES)
                    & _isin(rel, RELATION_STANDARDIZATION))
            df = df.take(np.flatnonzero(mask))
            rel = df["relation"]
        std = np.empty(len(rel), dtype=object)
        std[:] = [RELATION_STANDARDIZATION.get(r, r) for r in rel]
        out = df.with_column("relation_standard", std)
        self.stats["filtered_edges"] = len(out)
        self.stats["filtered_relations"] = len(set(std))
        logger.info("Filtered to %d rows", len(out))
        return out

    def build_mappings(self, df: Table) -> None:
        nodes = sorted(
            set(zip(df["x_type"], df["x_id"], df["x_name"]))
            | set(zip(df["y_type"], df["y_id"], df["y_name"])))
        # A (id, type) listed under two names keeps both idx2node rows and
        # the later index in node2idx, as the reference's dict does.
        self.node2idx = {(i, t): idx for idx, (t, i, _) in enumerate(nodes)}
        self.idx2node = {idx: (i, name, t)
                         for idx, (t, i, name) in enumerate(nodes)}
        rels = sorted(set(df["relation_standard"]))
        self.relation2idx = {r: i for i, r in enumerate(rels)}
        self.idx2relation = {i: r for i, r in enumerate(rels)}

        types = [t for t, _, _ in nodes]
        for t in sorted(set(types)):
            self.stats[f"num_{t}_nodes"] = types.count(t)
        std = list(df["relation_standard"])
        for r in rels:
            self.stats[f"num_{r}_edges"] = std.count(r)
        logger.info("Mapped %d nodes, %d relations", len(self.node2idx),
                    len(self.relation2idx))

    def split_edges(self, df: Table, train_ratio=0.7, val_ratio=0.15,
                    test_ratio=0.15, random_seed=42,
                    target_relation="drug-gene"):
        mask = df["relation_standard"] == target_relation
        if not mask.any():
            logger.warning("No %s rows; falling back to gene-disease",
                           target_relation)
            target_relation = "gene-disease"
            mask = df["relation_standard"] == target_relation
        target_df = df.take(np.flatnonzero(mask))
        other_df = df.take(np.flatnonzero(~mask))

        train_i, valtest_i = train_test_indices(
            len(target_df), val_ratio + test_ratio, random_seed)
        train_t, valtest_t = target_df.take(train_i), target_df.take(valtest_i)
        val_adj = val_ratio / (val_ratio + test_ratio)
        val_i, test_i = train_test_indices(len(valtest_t), 1 - val_adj,
                                           random_seed)
        val_t, test_t = valtest_t.take(val_i), valtest_t.take(test_i)
        train_df = train_t.concat(other_df)
        self.stats["train_edges"] = len(train_df)
        self.stats["val_edges"] = len(val_t)
        self.stats["test_edges"] = len(test_t)
        self.stats["train_target_edges"] = len(train_t)
        logger.info("Split: train %d (target %d) / val %d / test %d",
                    len(train_df), len(train_t), len(val_t), len(test_t))
        return train_df, val_t, test_t

    def convert_split(self, df: Table) -> Dict:
        """Rows -> bidirectional edge arrays by index lookup."""
        sidx = self._lookup(df["x_id"], df["x_type"])
        tidx = self._lookup(df["y_id"], df["y_type"])
        rid = np.fromiter((self.relation2idx[r]
                           for r in df["relation_standard"]),
                          dtype=np.int64, count=len(df))
        valid = (sidx >= 0) & (tidx >= 0)
        dropped = int((~valid).sum())
        if dropped:
            logger.warning("Skipped %d rows with unmapped endpoints", dropped)
        s, t, r = sidx[valid], tidx[valid], rid[valid]
        # Forward + reverse edge per row, interleaved like the reference.
        edge_index = np.empty((2, 2 * len(s)), dtype=np.int64)
        edge_index[0, 0::2], edge_index[1, 0::2] = s, t
        edge_index[0, 1::2], edge_index[1, 1::2] = t, s
        return {
            "edge_index": edge_index,
            "edge_type": np.repeat(r, 2),
            "num_nodes": len(self.node2idx),
            "num_relations": len(self.relation2idx),
        }

    def _lookup(self, ids: Sequence[str], types: Sequence[str]) -> np.ndarray:
        return np.fromiter((self.node2idx.get(k, -1) for k in zip(ids, types)),
                           dtype=np.int64, count=len(ids))

    def save_processed_data(self, train_df: Table, val_df: Table,
                            test_df: Table, full_df: Table) -> None:
        from primekg_rgcn_tpu_torch.data import artifacts

        out = self.processed_data_path
        splits = {
            "train_data": self.convert_split(train_df),
            "val_data": self.convert_split(val_df),
            "test_data": self.convert_split(test_df),
            "full_graph": self.convert_split(full_df),
        }
        for name, split in splits.items():
            if self.write_torch:
                artifacts.save_split_pt(out / f"{name}.pt", split)
            artifacts.save_split_npz(out / f"{name}.npz", split)

        mappings = {
            "node2idx": self.node2idx,
            "idx2node": self.idx2node,
            "relation2idx": self.relation2idx,
            "idx2relation": self.idx2relation,
        }
        if self.write_torch:
            artifacts.save_mappings(out / "mappings.pt", mappings)
        artifacts.save_mappings(out / "mappings.json", mappings)

        train_df.write_csv(out / "train_edges.csv")
        val_df.write_csv(out / "val_edges.csv")
        test_df.write_csv(out / "test_edges.csv")
        Table({k: np.array([v]) for k, v in self.stats.items()}).write_csv(
            out / "statistics.csv")
        logger.info("Saved processed data to %s", out)

    def process(self, train_ratio=0.7, val_ratio=0.15, test_ratio=0.15,
                random_seed=42, target_relation="drug-gene") -> None:
        df = self.load_data()
        filtered = self.filter_subgraph(df)
        self.build_mappings(filtered)
        train_df, val_df, test_df = self.split_edges(
            filtered, train_ratio, val_ratio, test_ratio, random_seed,
            target_relation)
        self.save_processed_data(train_df, val_df, test_df, filtered)
        logger.info("Preprocessing complete")


def main(argv: Optional[List[str]] = None):
    import argparse

    d = DataConfig()
    p = argparse.ArgumentParser(
        description="Preprocess PrimeKG data for RGCN link prediction")
    p.add_argument("--raw-data", default=d.raw_data)
    p.add_argument("--processed-dir", default=d.processed_dir)
    p.add_argument("--train-ratio", type=float, default=d.train_ratio)
    p.add_argument("--val-ratio", type=float, default=d.val_ratio)
    p.add_argument("--test-ratio", type=float, default=d.test_ratio)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--target-relation", default=d.target_relation)
    p.add_argument("--keep-all-relations", action="store_true",
                   help="skip the 3-relation/3-node-type filter and keep the "
                        "FULL knowledge graph (~129K nodes, ~30 relations); "
                        "the drug-gene trio still gets standardized names so "
                        "the split target is unchanged")
    p.add_argument("--no-torch", action="store_true",
                   help="write only the native .npz/.json artifacts")
    args = p.parse_args(argv)
    cfg = DataConfig(raw_data=args.raw_data,
                     processed_dir=args.processed_dir,
                     train_ratio=args.train_ratio, val_ratio=args.val_ratio,
                     test_ratio=args.test_ratio, seed=args.seed,
                     target_relation=args.target_relation)

    if abs(cfg.train_ratio + cfg.val_ratio + cfg.test_ratio - 1.0) > 1e-6:
        raise ValueError("train/val/test ratios must sum to 1.0")

    logging.basicConfig(level=logging.INFO)
    pp = PrimeKGPreprocessor(cfg.raw_data, cfg.processed_dir,
                             write_torch=not args.no_torch,
                             keep_all_relations=args.keep_all_relations)
    pp.process(cfg.train_ratio, cfg.val_ratio, cfg.test_ratio, cfg.seed,
               cfg.target_relation)


if __name__ == "__main__":
    main()
