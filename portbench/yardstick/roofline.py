"""The card's peaks, the kernels' bounds and the update's required
operations: the arithmetic behind every roofline and peak share.

Peaks are NVIDIA's data-sheet figures for one H100 SXM at its full 700 W
limit, as ``bench/roofline.py`` of the port states them. A bound is the
larger of a call's bytes at the HBM rate and its operations at the float32
peak, each input byte read once and each output byte written once: B1's as
``bench/roofline.b1_bound`` counts it, except that a call reads only the
table rows its ids name, B2's as ``chip_smoke.b2_bound``.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    """Seconds: the larger of ``nbytes`` at the HBM rate and ``ops`` at the
    float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)


def b1_bound_s(table_rows: int, d: int, num_edges: int, num_segments: int,
               *, scaled: bool = False) -> float:
    """One float32 B1 call (gather + segment-sum over a CSR): the
    ``table_rows`` distinct rows of width ``d`` that its ids gather,
    ``num_edges`` int32 ids (and float32 scales when ``scaled``), a CSR of
    ``num_segments + 1`` int32 offsets and a [num_segments, d] output;
    ``2 * num_edges * d`` operations."""
    nbytes = (table_rows * d * 4
              + (num_edges + num_segments + 1 + num_segments * d) * 4
              + (num_edges * 4 if scaled else 0))
    return bound_s(nbytes, 2 * num_edges * d)


def b2_bound_s(real_rows: int, num_ids: int, d: int,
               num_segments: int) -> float:
    """One float32 B2 call (sorted segment-sum of dense rows): the real rows
    read once, every int32 id, the [num_segments, d] output; one addition
    per real row element."""
    nbytes = real_rows * d * 4 + num_ids * 4 + num_segments * d * 4
    return bound_s(nbytes, real_rows * d)


def bucket_rows(src: np.ndarray, dst: np.ndarray, rel: np.ndarray,
                num_nodes: int, num_relations: int
                ) -> Tuple[List[int], List[int]]:
    """Each relation bucket's distinct sources and distinct destinations:
    the table rows that its forward and its backward B1 call gather."""
    def distinct(ids: np.ndarray) -> List[int]:
        keys = np.unique(rel.astype(np.int64) * num_nodes + ids)
        return np.bincount(keys // num_nodes,
                           minlength=num_relations).tolist()

    return distinct(src), distinct(dst)


def full_layer_b1_bound_s(bucket_sizes: Sequence[int],
                          src_rows: Sequence[int], dst_rows: Sequence[int],
                          num_nodes: int, d: int, *, scaled: bool) -> float:
    """One full-graph layer's B1 calls over each non-empty bucket: forward,
    gathering the bucket's ``src_rows`` distinct source rows, and backward
    over its transpose, gathering its ``dst_rows`` distinct destination
    rows; each writes all ``num_nodes + 1`` rows."""
    return sum(b1_bound_s(s, d, size, num_nodes + 1, scaled=scaled)
               + b1_bound_s(t, d, size, num_nodes + 1, scaled=scaled)
               for size, s, t in zip(bucket_sizes, src_rows, dst_rows)
               if size)


def restricted_b2_bound_s(e_cap_total: int, group: int, num_relations: int,
                          batch_nodes: int, d: int) -> float:
    """The restricted final layer's one B2 call: ``sum(e_cap) / group``
    pre-reduced rows of width ``d``, all real, summed into
    ``num_relations * batch_nodes`` segments."""
    rows = e_cap_total // group
    return b2_bound_s(rows, rows, d, num_relations * batch_nodes)


class InEdges:
    """Each node's in-edges over all relations, grouped by destination, to
    count what an update must compute at a set of nodes."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, rel: np.ndarray,
                 num_nodes: int):
        order = np.argsort(dst, kind="stable")
        self.src = src[order]
        self.rel = rel[order]
        self.dst = dst[order]
        self.ptr = np.searchsorted(self.dst, np.arange(num_nodes + 1))
        self.num_nodes = num_nodes

    def at(self, nodes: np.ndarray):
        """(in-edge count, in-neighbours, distinct (node, relation) pairs
        with an in-edge) of ``nodes`` (unique ids)."""
        lo, hi = self.ptr[nodes], self.ptr[nodes + 1]
        count = int((hi - lo).sum())
        if count == 0:
            return 0, np.zeros(0, np.int64), 0
        idx = np.repeat(lo - np.cumsum(np.r_[0, (hi - lo)[:-1]]),
                        hi - lo) + np.arange(count)
        pairs = np.unique(self.dst[idx] * (int(self.rel.max()) + 1)
                          + self.rel[idx])
        return count, np.unique(self.src[idx]), int(pairs.size)


def layer_forward_flops(edges: int, pairs: int, rows: int, din: int,
                        dout: int) -> int:
    """One RGCN layer's forward at ``rows`` output rows: one addition per
    in-edge element, the mean's multiply per (row, relation) element, each
    relation's [din, dout] transform at the rows with an in-edge of it, the
    self-loop transform at every row and the bias."""
    return (edges * din + pairs * din + 2 * pairs * din * dout
            + 2 * rows * din * dout + rows * dout)


def update_flops(in_edges: InEdges, candidates: Iterable[np.ndarray],
                 d_emb: int, d_hid: int) -> float:
    """The mean float32 operations that one full-graph update requires over
    the given candidate batches (each the heads and tails of its scored
    triples): conv2 and the DistMult decoder at the batch's nodes, conv1 at
    those nodes and their in-neighbours; backward twice the forward."""
    totals = []
    for cand in candidates:
        n_scored = cand.size // 2
        s2 = np.unique(cand)
        e2, nbrs, p2 = in_edges.at(s2)
        s1 = np.union1d(s2, nbrs)
        e1, _, p1 = in_edges.at(s1)
        fwd = (layer_forward_flops(e1, p1, s1.size, d_emb, d_hid)
               + layer_forward_flops(e2, p2, s2.size, d_hid, d_hid)
               + 3 * d_hid * n_scored)
        totals.append(3 * fwd)
    return float(np.mean(totals))

