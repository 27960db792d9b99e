"""Batch-restricted final RGCN layer: aggregate only the rows the loss reads.

The counterpart of ``primekg_rgcn_tpu/ops/rgcn_final_layer.py``. A training
step scores one batch, and the BCE loss reads the final layer's output only
at the batch's heads and tails (positives and their corruptions). Computing
the final layer at those rows alone gives the same values and the same
parameter gradients (the other rows carry zero cotangent) and skips most
of that layer's gather and aggregation both ways. Layer 1 still runs over
the whole graph through kernel B1.

Construction:

- Each batch node's in-edges under relation r are one contiguous range of
  the dst-sorted bucket, ``graph.rowptr[r, v] .. graph.rowptr[r, v+1]``; the
  plan reuses that array. Each range is padded to a multiple of ``group``
  (G) with sentinel slots, so the gathered rows pre-reduce G to one by a
  reshape before the segment-sum.
- All relations go in one pass, where the JAX package loops over them: the
  ranges of every (relation, node) pair are laid out in one static buffer of
  ``sum(e_cap)`` slots, relation r's at its own offset. One gather and
  grouped sum (``GatherGroupSum``), one sorted segment-sum
  (``SortedSegmentSum``: kernel B2 on the card) into ``[R * B, Din]`` and
  one ``[B, R * Din] @ [R * Din, Dout]`` product follow. The sums are
  taken in another order than the JAX loop's.
- Batch duplicates are found by a stable sort: a repeated node gets an
  empty range and copies its first occurrence's output row, so duplicate
  rows receive the sum of their cotangents in the backward.
- The static buffer overflows only for hub-heavy batches. JAX branches on
  the device (``lax.cond``) to the full layer; the port reads the overflow
  flag on the host and takes the full layer (kernel B1 both ways) when any
  relation's total exceeds its ``e_cap``. The work splits at that read:
  :func:`final_layer_ranges` (the sorted batch and its B-sized range
  metadata, which give the flag) and the two branches, the restricted rows
  or the full layer. Eagerly, :func:`final_layer_restricted` runs both
  parts and reads the flag between them, once per micro-batch; the
  graphed trainer (``train/loop.py``) captures the ranges with the
  candidates, reads the flag after their replay and replays the captured
  branch, handing the ranges and the answer in as ``ranges``.
  ``final_layer_restricted.fallbacks`` counts the reads that took the full
  layer. ``e_cap`` is sized by simulating the negative sampler on the real
  degree table when the plan is built.

The JAX package leaves both segment-sums to XLA; no TPU kernel is replaced
here. The forward one has sorted ids, which is kernel B2's contract, and
goes through it on the card (``ops/cuda/dense_segment_sum.
SortedSegmentSum``; its backward is a gather): deterministic, and faster
than ``index_add`` on this stream. The gather's backward scatters into the
table's rows by unsorted ids and stays ``index_add``, which on the card sums
with atomics, in no fixed order.

bf16 compute keeps the rounding points of ``ops/rgcn_segment.py``'s table: bf16
table rows (an edge-norm product rounded to bf16), float32 sums, a float32
aggregate times the bf16 ``1/in-degree``, a float32 product with the
relation weights, the bf16 root term added in float32. (The JAX fast path
sums in bf16 at this dtype.)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from primekg_rgcn_tpu_torch.data.graph import RelGraph
from primekg_rgcn_tpu_torch.ops.cuda.dense_segment_sum import \
    SortedSegmentSum
from primekg_rgcn_tpu_torch.ops.rgcn_segment import (
    materialize_relation_weights, promote_matmul, rgcn_layer_segment)


@dataclasses.dataclass(frozen=True)
class FinalLayerPlan:
    """Static schedule of the batch-restricted final layer.

    Attributes:
        rowptr: int32 [R, N+1] per-relation CSR offsets into the relation's
            dst-sorted bucket: a view of ``graph.rowptr[:, :N+1]``.
        e_cap: per-relation capacity of the enumeration buffer (a multiple
            of ``group``).
        group: G; every batch node's range is padded to a multiple of G.
        cap: int64 [R] ``e_cap`` on the graph's device.
        cap_start: int64 [R] each relation's first slot in the buffer.
        bucket_start: int64 [R] each relation's first edge in the graph's
            ``src`` / ``edge_scale``.
    """

    rowptr: torch.Tensor
    e_cap: Tuple[int, ...]
    group: int
    cap: torch.Tensor
    cap_start: torch.Tensor
    bucket_start: torch.Tensor


def plan_final_layer(
    graph: RelGraph,
    train_edges: np.ndarray,
    batch_size: int,
    num_neg_samples: int = 1,
    *,
    group: int = 8,
    safety: float = 1.3,
    sims: int = 64,
    seed: int = 0,
) -> FinalLayerPlan:
    """The restricted layer's schedule for one batch shape.

    ``e_cap`` is sized as the JAX package sizes it: simulate ``sims``
    batches with the negative sampler's composition (positive endpoints as
    drawn, corrupted entities uniform), take each relation's largest padded
    in-edge total and multiply by ``safety``, capped at the bucket. Numpy
    draws from ``seed``, so both packages plan the same capacities.
    """
    n = graph.num_nodes
    num_rel = graph.num_relations
    rowptr = graph.rowptr[:, : n + 1]
    degs = np.diff(rowptr.cpu().numpy().astype(np.int64), axis=1)

    rng = np.random.default_rng(seed)
    b = batch_size
    k = max(int(num_neg_samples), 1)
    maxima = np.zeros(num_rel, dtype=np.int64)
    for _ in range(max(int(sims), 1)):
        bi = rng.integers(0, max(len(train_edges), 1), b)
        h = train_edges[bi, 0].astype(np.int64)
        t = train_edges[bi, 1].astype(np.int64)
        nh = np.repeat(h, k)
        nt = np.repeat(t, k)
        coin = rng.random(b * k) < 0.5
        ent = rng.integers(0, n, b * k)
        nh = np.where(coin, ent, nh)
        nt = np.where(~coin, ent, nt)
        uniq = np.unique(np.concatenate([h, t, nh, nt]))
        for r in range(num_rel):
            d = degs[r][uniq]
            padded = ((d + group - 1) // group) * group
            maxima[r] = max(maxima[r], int(padded.sum()))
    e_cap = []
    for r in range(num_rel):
        s, e = graph.bucket_slice(r)
        cap = int(maxima[r] * safety) + group
        cap = min(-(-cap // group) * group, -(-(e - s) // group) * group)
        e_cap.append(max(cap, group))

    dev = rowptr.device
    starts = np.concatenate([[0], np.cumsum(e_cap)[:-1]])
    return FinalLayerPlan(
        rowptr=rowptr, e_cap=tuple(e_cap), group=int(group),
        cap=torch.tensor(e_cap, dtype=torch.int64, device=dev),
        cap_start=torch.from_numpy(starts.astype(np.int64)).to(dev),
        bucket_start=torch.tensor(graph.rel_offsets[:-1], dtype=torch.int64,
                                  device=dev))


# The JAX package's break-even, kept so that both packages pick the same
# path on the same graph; the JAX package set it between two measurements
# on its own accelerator. On one H100 (NVIDIA H100 80GB HBM3, 700 W;
# chip_smoke.py, phases full_kg_train and train_restricted_on), device busy
# a step, restricted against full: 19.5 against 39.2 ms on the
# full-PrimeKG graph (ratio 7.25; step 56.3 against 76.2 ms on that run's
# host), 3.85 against 2.76 ms on the bench.py graph (ratio 3.48). 6.0 picks
# the faster path at both.
AUTO_EDGE_RATIO = 6.0


def resolve_final_plan(
    graph: RelGraph,
    train_edges: np.ndarray,
    batch_size: int,
    num_neg_samples: int,
    *,
    seed: int = 0,
    mode="auto",
) -> Optional[FinalLayerPlan]:
    """A :class:`FinalLayerPlan`, or None, per the config tri-state.

    ``mode``: "auto"/None builds the plan and keeps it only when the graph's
    edge count is >= ``AUTO_EDGE_RATIO`` x the plan's total capacity;
    "on"/True always; "off"/False never.
    """
    if mode in (False, "off"):
        return None
    plan = plan_final_layer(graph, np.asarray(train_edges, np.int64),
                            batch_size, num_neg_samples, seed=seed)
    if mode in (True, "on"):
        return plan
    if graph.num_edges >= AUTO_EDGE_RATIO * sum(plan.e_cap):
        return plan
    return None


def edge_ratio(graph: RelGraph, plan: FinalLayerPlan) -> float:
    """The graph's edges over the plan's total capacity (``"auto"`` takes
    the plan from ``AUTO_EDGE_RATIO``)."""
    return graph.num_edges / sum(plan.e_cap)


class GatherGroupSum(torch.autograd.Function):
    """``out[q] = sum_{j < G} table[ids[q*G + j]] * scale[q*G + j]``: a row
    gather and the sum of each run of G rows, in float32.

    The table is float32 or bf16; a bf16 product with a scale is rounded to
    bf16 before the sum, as kernel B1 rounds it. The backward spreads each
    group's float32 cotangent over its G slots, scales it and sums it into
    the table's rows in float32 (``index_add``), then casts to the table's
    dtype. ``ids`` and ``scale`` are constants.
    """

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor,
                scale: Optional[torch.Tensor], group: int) -> torch.Tensor:
        rows = table.index_select(0, ids)
        if scale is not None:
            rows = (rows.float() * scale[:, None]).to(table.dtype)
        ctx.save_for_backward(ids, scale)
        ctx.table_shape = table.shape
        ctx.table_dtype = table.dtype
        ctx.group = group
        return rows.view(-1, group, table.shape[1]).sum(
            1, dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        ids, scale = ctx.saved_tensors
        g = grad.float().repeat_interleave(ctx.group, dim=0)
        if scale is not None:
            g = g * scale[:, None]
        out = torch.zeros(ctx.table_shape, dtype=torch.float32,
                          device=grad.device).index_add_(0, ids, g)
        return out.to(ctx.table_dtype), None, None, None


def sorted_batch(nodes: torch.Tensor):
    """``(ns, perm, is_dup)``: the batch's node ids sorted (stable), the
    sorting permutation, and whether each sorted id repeats the one before
    it."""
    ns, perm = torch.sort(nodes.long(), stable=True)
    is_dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=ns.device),
                        ns[1:] == ns[:-1]])
    return ns, perm, is_dup


def batch_ranges(plan: FinalLayerPlan, ns: torch.Tensor,
                 is_dup: torch.Tensor):
    """The B-sized range metadata of sorted batch nodes ``ns``: per
    (relation, position) the first bucket edge ``start`` [R, B], the
    in-degree ``deg`` (0 for a repeated node) and the exclusive offset of
    the G-padded range within its relation's slots ``off``; and ``ok``, a
    0-d bool tensor that holds when every relation's total fits its
    ``e_cap``."""
    g = plan.group
    start = plan.rowptr[:, ns].long()
    deg = plan.rowptr[:, ns + 1].long() - start
    deg = torch.where(is_dup[None, :], torch.zeros_like(deg), deg)
    deg_g = (deg + g - 1) // g * g
    csum = deg_g.cumsum(1)
    ok = (csum[:, -1] <= plan.cap).all()
    return start, deg, csum - deg_g, ok


class BatchRanges(NamedTuple):
    """Part (a) of the restricted layer for one batch, which gives the
    overflow flag: :func:`sorted_batch`'s ``ns``, ``perm`` and ``is_dup``,
    :func:`batch_ranges`' ``start``, ``deg``, ``off`` and ``ok`` (0-d bool
    tensor), and ``fits``: None, or the flag as the host read it."""

    ns: torch.Tensor
    perm: torch.Tensor
    is_dup: torch.Tensor
    start: torch.Tensor
    deg: torch.Tensor
    off: torch.Tensor
    ok: torch.Tensor
    fits: Optional[bool] = None


def final_layer_ranges(plan: FinalLayerPlan,
                       nodes: torch.Tensor) -> BatchRanges:
    """The sorted batch and its range metadata for ``nodes`` (the batch's
    heads, then its tails), on the device, with no host read."""
    ns, perm, is_dup = sorted_batch(nodes)
    return BatchRanges(ns, perm, is_dup, *batch_ranges(plan, ns, is_dup))


def enumerate_slots(graph: RelGraph, plan: FinalLayerPlan, start, deg,
                    off):
    """The static buffer of ``sum(e_cap)`` slots for ranges that fit:
    ``seg`` int64 [S], the flat (relation * B + position) row each slot
    sums into (non-decreasing); ``src`` int64 [S] its source node (N,
    the zero dummy row, on padding slots); ``scale`` float32 [S]
    its edge-norm scale (0 on padding), or None in dense mode."""
    b = start.shape[1]
    slots = sum(plan.e_cap)
    flat_off = (off + plan.cap_start[:, None]).reshape(-1)
    j = torch.arange(slots, device=flat_off.device)
    seg = torch.searchsorted(flat_off, j, right=True) - 1
    local = j - flat_off[seg]
    valid = local < deg.reshape(-1)[seg]
    eid = plan.bucket_start[seg // b] + start.reshape(-1)[seg] + local
    eid = eid.clamp(max=graph.src.shape[0] - 1)
    src = torch.where(valid, graph.src[eid].long(), graph.num_nodes)
    scale = None
    if graph.norm_mode == "edge":
        scale = torch.where(valid, graph.edge_scale[eid],
                            torch.zeros((), device=eid.device))
    return seg, src, scale


def final_layer_restricted(
    layer_params: Dict[str, torch.Tensor],
    h1_pad: torch.Tensor,
    graph: RelGraph,
    plan: FinalLayerPlan,
    nodes: torch.Tensor,
    *,
    compute_dtype: torch.dtype = torch.float32,
    ranges: Optional[BatchRanges] = None,
) -> torch.Tensor:
    """Final-layer output rows for ``nodes`` only (duplicates allowed).

    Args:
        layer_params: the final RGCN layer's parameter dict.
        h1_pad: float32 [N+1, Din] post-activation (and dropout) features
            with the zero dummy row appended.
        graph: the relation-bucketed graph the plan was built on.
        plan: from :func:`plan_final_layer`.
        nodes: int [B] node ids (the batch's heads, then its tails).
        compute_dtype: float32, or bfloat16 (see the module docstring).
        ranges: :func:`final_layer_ranges` of ``nodes`` with ``fits`` set
            by the caller, who has read the flag; None computes them here
            and reads the flag.

    Returns float32 [B, Dout], equal to
    ``rgcn_layer_segment(layer_params, h1_pad[:N], graph)[nodes]`` up to
    summation order. Without ``ranges`` it reads one flag from the device
    (the overflow check); on overflow it computes exactly that, through
    kernel B1 on the card.
    """
    n = graph.num_nodes
    num_rel = graph.num_relations
    b = nodes.shape[0]
    g = plan.group
    if ranges is None:
        ranges = final_layer_ranges(plan, nodes)
        fits = bool(ranges.ok)  # the step's one host read
        if not fits:
            final_layer_restricted.fallbacks += 1
    else:
        fits = ranges.fits
        if fits is None:
            raise ValueError("ranges.fits must hold the flag as read")
    if not fits:
        return rgcn_layer_segment(layer_params, h1_pad[:n], graph,
                                  compute_dtype=compute_dtype)[nodes]
    ns, perm, is_dup, start, deg, off = ranges[:6]

    w_rel = materialize_relation_weights(layer_params).to(compute_dtype)
    w_root = layer_params["w_root"].to(compute_dtype)
    bias = layer_params["bias"].to(compute_dtype)
    din, dout = w_rel.shape[1], w_rel.shape[2]
    h1c = h1_pad.to(compute_dtype)

    seg, src, scale = enumerate_slots(graph, plan, start, deg, off)
    grp = GatherGroupSum.apply(h1c, src, scale, g)
    agg = SortedSegmentSum.apply(grp, seg[::g], num_rel * b)
    if graph.norm_mode == "dense":
        inv = graph.inv_in_deg[:, ns].reshape(-1, 1).to(compute_dtype)
        agg = agg * inv
    agg = agg.view(num_rel, b, din).transpose(0, 1).reshape(b, num_rel * din)
    out = h1c[ns] @ w_root + bias[None, :]
    out = out + promote_matmul(agg, w_rel.reshape(num_rel * din, dout))

    # Duplicates copy their first occurrence's row; unsort to input order.
    first = torch.cummax(
        torch.where(is_dup, 0, torch.arange(b, device=ns.device)), 0).values
    pos = torch.empty_like(first)
    pos[perm] = first
    return out.float()[pos]


final_layer_restricted.fallbacks = 0
