"""Artifact IO: the reference's on-disk contract plus a ``.npz`` format.

The reference's processed-data contract is a set of torch pickles:
    {train,val,test}_data.pt: {'edge_index': LongTensor[2, E],
                               'edge_type': LongTensor[E],
                               'num_nodes': int, 'num_relations': int}
    full_graph.pt: same schema over all filtered edges
    mappings.pt: {'node2idx', 'idx2node', 'relation2idx', 'idx2relation'}

This module reads and writes that schema, and the same payloads as ``.npz``
and ``mappings.json``, with the same filtering as the JAX package.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from primekg_rgcn_tpu_torch.data.graph import RelGraph, build_rel_graph


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def load_split_pt(path) -> Dict[str, Any]:
    """Load a reference-format ``*_data.pt`` / ``full_graph.pt`` dict.

    The file is a pickle: load only trusted files."""
    data = torch.load(path, map_location="cpu", weights_only=False)
    return {
        "edge_index": _to_numpy(data["edge_index"]).astype(np.int64),
        "edge_type": _to_numpy(data["edge_type"]).astype(np.int64),
        "num_nodes": int(data["num_nodes"]),
        "num_relations": int(data["num_relations"]),
    }


def save_split_pt(path, split: Dict[str, Any]) -> None:
    """Write the reference-format torch pickle."""
    torch.save(
        {
            "edge_index": torch.as_tensor(split["edge_index"],
                                          dtype=torch.long),
            "edge_type": torch.as_tensor(split["edge_type"], dtype=torch.long),
            "num_nodes": int(split["num_nodes"]),
            "num_relations": int(split["num_relations"]),
        },
        path,
    )


def save_split_npz(path, split: Dict[str, Any]) -> None:
    np.savez_compressed(
        path,
        edge_index=np.asarray(split["edge_index"], np.int64),
        edge_type=np.asarray(split["edge_type"], np.int64),
        num_nodes=np.int64(split["num_nodes"]),
        num_relations=np.int64(split["num_relations"]),
    )


def load_split_npz(path) -> Dict[str, Any]:
    with np.load(path) as z:
        return {
            "edge_index": z["edge_index"],
            "edge_type": z["edge_type"],
            "num_nodes": int(z["num_nodes"]),
            "num_relations": int(z["num_relations"]),
        }


def load_split(path) -> Dict[str, Any]:
    """Load either format by extension."""
    path = Path(path)
    if path.suffix == ".npz":
        return load_split_npz(path)
    return load_split_pt(path)


def load_mappings(path) -> Dict[str, Any]:
    """Load mappings.pt (torch pickle of plain dicts) or mappings.json."""
    path = Path(path)
    if path.suffix == ".json":
        with open(path) as f:
            raw = json.load(f)
        return _mappings_from_json(raw)
    return torch.load(path, map_location="cpu", weights_only=False)


def save_mappings(path, mappings: Dict[str, Any]) -> None:
    path = Path(path)
    if path.suffix == ".json":
        with open(path, "w") as f:
            json.dump(_mappings_to_json(mappings), f)
    else:
        torch.save(mappings, path)


def _mappings_to_json(m: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "node2idx": [[list(k), v] for k, v in m["node2idx"].items()],
        "idx2node": [[k, list(v)] for k, v in m["idx2node"].items()],
        "relation2idx": m["relation2idx"],
        "idx2relation": {str(k): v for k, v in m["idx2relation"].items()},
    }


def _mappings_from_json(raw: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "node2idx": {tuple(k): v for k, v in raw["node2idx"]},
        "idx2node": {int(k): tuple(v) for k, v in raw["idx2node"]},
        "relation2idx": raw["relation2idx"],
        "idx2relation": {int(k): v for k, v in raw["idx2relation"].items()},
    }


def split_to_edges(split: Dict[str, Any]) -> np.ndarray:
    """[E, 3] (head, tail, rel) rows, dropping out-of-range node and
    relation ids."""
    ei = np.asarray(split["edge_index"])
    et = np.asarray(split["edge_type"])
    n = split["num_nodes"]
    r = split["num_relations"]
    valid = (ei[0] >= 0) & (ei[0] < n) & (ei[1] >= 0) & (ei[1] < n)
    valid &= (et >= 0) & (et < r)
    return np.stack([ei[0][valid], ei[1][valid], et[valid]], axis=1)


def split_to_rel_graph(split: Dict[str, Any], **kwargs) -> RelGraph:
    """Build the relation-bucketed graph (on the CPU) from a split."""
    ei = np.asarray(split["edge_index"])
    return build_rel_graph(ei[0], ei[1], np.asarray(split["edge_type"]),
                           split["num_nodes"], split["num_relations"],
                           **kwargs)


def load_dataset(data_dir, *, require_train: bool = True
                 ) -> Dict[str, Any]:
    """Load a processed-data directory (reference layout, either format).

    Returns a dict with the splits "train", "val", "test" and "full" (None
    where absent) and "mappings" (None if absent).
    """
    data_dir = Path(data_dir)
    out: Dict[str, Any] = {}
    names = {"train": "train_data", "val": "val_data", "test": "test_data",
             "full": "full_graph"}
    for key, stem in names.items():
        for ext in (".npz", ".pt"):
            p = data_dir / f"{stem}{ext}"
            if p.exists():
                out[key] = load_split(p)
                break
        else:
            if key == "train" and require_train:
                raise FileNotFoundError(
                    f"missing {stem}.pt/.npz in {data_dir}")
            out[key] = None
    mp = data_dir / "mappings.pt"
    mj = data_dir / "mappings.json"
    out["mappings"] = (load_mappings(mp) if mp.exists()
                       else load_mappings(mj) if mj.exists() else None)
    return out
