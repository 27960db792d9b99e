"""Relation-bucketed, destination-sorted, sentinel-padded graph format.

Edges are bucketed by relation and sorted by destination node on the host,
once. Each bucket is padded to a static capacity with sentinel edges that
point at a dummy node row (index ``num_nodes``) whose features are zero and
whose aggregate is dropped, so padding contributes exactly zero.

Mean normalisation has two storage modes:
- "dense": a float32[R, N+1] reciprocal in-degree table, multiplied into the
  aggregate (N multiplies per relation).
- "edge": per-edge reciprocal-degree scales aligned with the (src, dst) and
  transpose orders, multiplied into the messages; O(E) instead of O(R*N).

Besides the arrays of the JAX package's ``RelGraph`` (kept bit for bit), the
graph carries each bucket's CSR ``rowptr`` over its N+1 destination rows,
the schedule of the CUDA gather + segment-sum kernel in the forward, and
the transpose CSR ``t_rowptr`` over its N+1 source rows, the schedule of the
same kernel in the backward. Large graphs are built by the C++ builder of
``native/`` (``use_native``), bit for bit as numpy builds them.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class RelGraph:
    """Relation-bucketed, destination-sorted, statically padded graph.

    Attributes:
        src: int32[E_pad] source node ids; padding slots hold ``num_nodes``.
        dst: int32[E_pad] destination ids, non-decreasing within each
            relation bucket; padding slots hold ``num_nodes``.
        t_src / t_dst: the same edges re-sorted by source within each bucket
            (the transpose graph, for the backward pass).
        inv_in_deg: float32[R, N+1] reciprocal per-relation in-degree
            ("dense" mode; [0, 0] in "edge" mode), zero on empty rows and on
            the dummy row.
        edge_scale / t_edge_scale: float32[E_pad] reciprocal in-degree of each
            edge's destination ("edge" mode; [0] in "dense" mode), zero on
            padding.
        rowptr: int32[R, N+2] per-bucket CSR row pointers, offsets into the
            bucket: the edges into row d of bucket r are
            ``rowptr[r, d] <= e < rowptr[r, d+1]``; row N collects padding.
        t_rowptr: int32[R, N+2] the transpose CSR, offsets into the bucket's
            ``t_src``/``t_dst``: the edges out of source row s are
            ``t_rowptr[r, s] <= e < t_rowptr[r, s+1]``; row N collects
            padding (``t_src`` pads with N, the largest id).
        rel_offsets: (R+1,) bucket start offsets into src/dst.
        num_nodes / num_relations / num_edges: sizes (``num_edges`` counts
            real, unpadded edges).
    """

    src: torch.Tensor
    dst: torch.Tensor
    t_src: torch.Tensor
    t_dst: torch.Tensor
    inv_in_deg: torch.Tensor
    edge_scale: torch.Tensor
    t_edge_scale: torch.Tensor
    rowptr: torch.Tensor
    t_rowptr: torch.Tensor
    rel_offsets: Tuple[int, ...]
    num_nodes: int
    num_relations: int
    num_edges: int

    @property
    def norm_mode(self) -> str:
        return "edge" if self.edge_scale.shape[0] > 0 else "dense"

    @property
    def padded_num_edges(self) -> int:
        return int(self.src.shape[0])

    def bucket_slice(self, r: int) -> Tuple[int, int]:
        return self.rel_offsets[r], self.rel_offsets[r + 1]

    def bucket_sizes(self) -> Tuple[int, ...]:
        return tuple(
            self.rel_offsets[r + 1] - self.rel_offsets[r]
            for r in range(self.num_relations)
        )

    def to(self, device) -> "RelGraph":
        """The same graph with every array on ``device``."""
        names = ("src", "dst", "t_src", "t_dst", "inv_in_deg", "edge_scale",
                 "t_edge_scale", "rowptr", "t_rowptr")
        return replace(self, **{k: getattr(self, k).to(device)
                                for k in names})


def _pick_norm(norm: str, num_relations: int, num_nodes: int,
               total_pad: int) -> str:
    if norm != "auto":
        return norm
    dense_size = num_relations * (num_nodes + 1)
    return "edge" if dense_size > 4 * total_pad else "dense"


# Edge count from which ``use_native="auto"`` takes the C++ builder, as in
# the JAX package.
NATIVE_MIN_EDGES = 1_000_000


def build_rel_graph(
    src: np.ndarray,
    dst: np.ndarray,
    rel: np.ndarray,
    num_nodes: int,
    num_relations: int,
    *,
    bucket_pad_multiple: int = 512,
    use_native: str = "auto",
    norm: str = "auto",
) -> RelGraph:
    """Build a RelGraph (on the CPU) from raw COO edge arrays.

    Edges with an out-of-range node or relation id are dropped.

    Args:
        bucket_pad_multiple: each relation bucket is padded up to a multiple
            of this (at least one multiple).
        use_native: "auto" (the C++ builder of ``native/`` from
            ``NATIVE_MIN_EDGES`` input edges, when it can be built, else
            numpy), "always" (the C++ builder, raising when it cannot be
            built) or "never" (numpy). Both give bit-identical arrays.
        norm: "dense", "edge", or "auto" (see the module docstring).
    """
    src = np.asarray(src, dtype=np.int64).ravel()
    dst = np.asarray(dst, dtype=np.int64).ravel()
    rel = np.asarray(rel, dtype=np.int64).ravel()
    if not (src.shape == dst.shape == rel.shape):
        raise ValueError(
            f"edge array shapes differ: {src.shape}, {dst.shape}, {rel.shape}")
    if use_native not in ("auto", "always", "never"):
        raise ValueError(f"unknown use_native {use_native!r}")

    lib = None
    if use_native == "always" or (use_native == "auto"
                                  and src.shape[0] >= NATIVE_MIN_EDGES):
        from primekg_rgcn_tpu_torch import native

        lib = native.get_lib()
        if lib is None and use_native == "always":
            raise RuntimeError("native graph builder unavailable (no C++ "
                               f"compiler {native.COMPILER!r} or a failed "
                               "build; see the log)")
    if lib is not None:
        counts, num_edges = native.count_buckets(lib, src, dst, rel,
                                                 num_nodes, num_relations)
    else:
        valid = ((src >= 0) & (src < num_nodes) & (dst >= 0)
                 & (dst < num_nodes) & (rel >= 0) & (rel < num_relations))
        src, dst, rel = src[valid], dst[valid], rel[valid]
        num_edges = int(src.shape[0])
        counts = np.bincount(rel, minlength=num_relations)
    caps = [max(_round_up(int(c), bucket_pad_multiple), bucket_pad_multiple)
            for c in counts]

    total = int(sum(caps))
    norm_mode = _pick_norm(norm, num_relations, num_nodes, total)
    offsets = [0]
    for c in caps:
        offsets.append(offsets[-1] + int(c))

    if lib is not None:
        arrays = native.build_rel_graph_native(
            lib, src, dst, rel, num_nodes, num_relations, caps,
            norm_mode=norm_mode)
    else:
        arrays = _build_numpy(src, dst, rel, num_nodes, num_relations,
                              counts, offsets, norm_mode)

    # Per-bucket CSR row pointers over the dst-sorted and the src-sorted
    # (transpose) orders; row N+1's pointer is the bucket's end.
    rows = np.arange(num_nodes + 2)
    rowptr = np.zeros((num_relations, num_nodes + 2), dtype=np.int32)
    t_rowptr = np.zeros((num_relations, num_nodes + 2), dtype=np.int32)
    for r in range(num_relations):
        s, e = offsets[r], offsets[r + 1]
        rowptr[r] = np.searchsorted(arrays["dst"][s:e], rows)
        t_rowptr[r] = np.searchsorted(arrays["t_src"][s:e], rows)

    return RelGraph(
        **{k: torch.from_numpy(v) for k, v in arrays.items()},
        rowptr=torch.from_numpy(rowptr),
        t_rowptr=torch.from_numpy(t_rowptr),
        rel_offsets=tuple(offsets),
        num_nodes=int(num_nodes),
        num_relations=int(num_relations),
        num_edges=num_edges,
    )


def _build_numpy(src, dst, rel, num_nodes: int, num_relations: int, counts,
                 offsets, norm_mode: str):
    """The numpy builder of :func:`build_rel_graph` over valid edges."""
    total = offsets[-1]
    # Sort by (relation, dst) so each bucket is contiguous and dst-sorted.
    order = np.lexsort((dst, rel))
    src, dst, rel = src[order], dst[order], rel[order]

    sentinel = num_nodes
    src_pad = np.full(total, sentinel, dtype=np.int32)
    dst_pad = np.full(total, sentinel, dtype=np.int32)
    t_src_pad = np.full(total, sentinel, dtype=np.int32)
    t_dst_pad = np.full(total, sentinel, dtype=np.int32)
    if norm_mode == "dense":
        inv_deg = np.zeros((num_relations, num_nodes + 1), dtype=np.float32)
        edge_scale = np.zeros((0,), np.float32)
        t_edge_scale = np.zeros((0,), np.float32)
    else:
        inv_deg = np.zeros((0, 0), dtype=np.float32)
        edge_scale = np.zeros(total, np.float32)
        t_edge_scale = np.zeros(total, np.float32)

    in_start = 0
    for r in range(num_relations):
        c = int(counts[r])
        start = offsets[r]
        bsrc = src[in_start : in_start + c]
        bdst = dst[in_start : in_start + c]
        src_pad[start : start + c] = bsrc
        dst_pad[start : start + c] = bdst
        # Transpose bucket: same edges sorted by source node.
        t_order = np.argsort(bsrc, kind="stable")
        t_src_pad[start : start + c] = bsrc[t_order]
        t_dst_pad[start : start + c] = bdst[t_order]

        deg = np.bincount(bdst, minlength=num_nodes + 1)
        if norm_mode == "dense":
            nz = deg > 0
            inv_deg[r, nz] = 1.0 / deg[nz]
            inv_deg[r, sentinel] = 0.0
        else:
            inv = np.zeros(num_nodes + 1, np.float32)
            nz = deg > 0
            inv[nz] = 1.0 / deg[nz]
            inv[sentinel] = 0.0
            edge_scale[start : start + c] = inv[bdst]
            t_edge_scale[start : start + c] = inv[bdst[t_order]]
        in_start += c

    return {"src": src_pad, "dst": dst_pad, "t_src": t_src_pad,
            "t_dst": t_dst_pad, "inv_in_deg": inv_deg,
            "edge_scale": edge_scale, "t_edge_scale": t_edge_scale}


def edge_arrays_from_graph(graph: RelGraph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Recover real (src, dst, rel) COO arrays from a RelGraph (host-side)."""
    src = graph.src.cpu().numpy()
    dst = graph.dst.cpu().numpy()
    outs, outd, outr = [], [], []
    for r in range(graph.num_relations):
        s, e = graph.bucket_slice(r)
        bucket_src = src[s:e]
        bucket_dst = dst[s:e]
        real = bucket_src < graph.num_nodes
        outs.append(bucket_src[real])
        outd.append(bucket_dst[real])
        outr.append(np.full(int(real.sum()), r, dtype=np.int64))
    return (
        np.concatenate(outs).astype(np.int64),
        np.concatenate(outd).astype(np.int64),
        np.concatenate(outr),
    )
