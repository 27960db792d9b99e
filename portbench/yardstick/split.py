"""The reference's split rule, frozen.

A copy of ``data/preprocess.split_edges`` and ``convert_split`` of the
reference's preprocessing (as the port reproduces it): only the target
relation's rows are split, train against validation and test 70/15/15 by a
``RandomState(seed)`` permutation as ``sklearn``'s ``train_test_split``
draws it; every other relation's rows stay in train; each kept row gives a
forward and a reverse directed edge, interleaved.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np


def _train_test(n: int, test_size: float, seed: int):
    n_test = math.ceil(test_size * n)
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:], perm[:n_test]


def directed(src: np.ndarray, dst: np.ndarray, rel: np.ndarray) -> np.ndarray:
    """[2n, 3] int64 (head, tail, rel): each row forward, then reversed."""
    out = np.empty((2 * len(src), 3), dtype=np.int64)
    out[0::2, 0], out[0::2, 1] = src, dst
    out[1::2, 0], out[1::2, 1] = dst, src
    out[:, 2] = np.repeat(rel, 2)
    return out


def split_rows(src: np.ndarray, dst: np.ndarray, rel: np.ndarray,
               target_relation: int, seed: int, train_ratio: float = 0.7,
               val_ratio: float = 0.15, test_ratio: float = 0.15
               ) -> Dict[str, np.ndarray]:
    """Directed [E, 3] edges of the train, validation and test splits of
    undirected rows ``(src, dst, rel)``; ``seed`` in [0, 2**32)."""
    if not math.isclose(train_ratio + val_ratio + test_ratio, 1.0):
        raise ValueError("split ratios must sum to 1")
    target = np.flatnonzero(rel == target_relation)
    other = np.flatnonzero(rel != target_relation)
    if target.size == 0:
        raise ValueError(f"no rows of target relation {target_relation}")
    train_i, valtest_i = _train_test(len(target), val_ratio + test_ratio,
                                     seed)
    valtest = target[valtest_i]
    val_i, test_i = _train_test(len(valtest),
                                1 - val_ratio / (val_ratio + test_ratio),
                                seed)
    train = np.concatenate([target[train_i], other])
    return {name: directed(src[rows], dst[rows], rel[rows])
            for name, rows in (("train", train), ("val", valtest[val_i]),
                               ("test", valtest[test_i]))}
