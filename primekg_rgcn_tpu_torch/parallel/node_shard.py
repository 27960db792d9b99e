"""Node-sharded RGCN with a halo exchange, one process driving the shards.

The counterpart of ``primekg_rgcn_tpu/parallel/node_shard.py``:

- Nodes are partitioned contiguously over the mesh's n shards; shard d owns
  feature rows [d*n_loc, (d+1)*n_loc) (the last shard padded).
- Edges live with their destination's owner, so aggregation writes are
  local. Each shard's edges are pre-split into a LOCAL-source group (both
  endpoints owned here) and a HALO-source group.
- The only exchange is the **halo exchange**: before aggregating, each shard
  sends the rows its peers' edges need (precomputed, deduped, padded serve
  lists) through one exchange per layer, ``HaloExchange``
  (``ops/cuda/halo.py``): kernel B4 on the card, its plain version on the
  CPU.
- Every index is computed once on the host by :func:`partition_nodes`, with
  the arrays of the JAX partitioner bit for bit (``pallas=False``). In place
  of the Pallas schedules, each (shard, group, relation) bucket carries the
  CSR ``rowptr`` over its n_loc + 1 destination rows and the transpose CSR
  ``t_rowptr`` over its table's rows (n_loc + 1 local, n*P + 1 halo), so
  ``GatherSegmentSum`` runs kernel B1 both ways, per shard. The CSRs cover
  each bucket's real edges only, and a bucket without real edges is
  skipped: the sentinel padding, which the JAX layer gathers and drops, up
  to a cap set by the fullest shard, would all fall on the dummy row, and
  B1 walks a row with one warp (174,336 padding edges on one bucket of the
  ``bench.py`` graph at n = 4). Padding adds exactly zero either way.

Under bf16 compute (``cfg.compute_dtype``) each layer converts its rows to
bf16 before the exchange, so the serve rows ship in bf16 (B4's bf16
payload) and B1 gathers bf16 tables; the aggregates, normalisation and
relation products are float32 and the layer returns float32, as the JAX
layer does. Its B1 kept the default ``mxu_dtype`` there, so its backward
summed float32 cotangents; here the bf16 table's backward rounds the
cotangent to bf16 first (``ROADMAP.md``, queue C).

All shards of a mesh live on one device (``parallel/mesh.py``): a sharded
function is a loop over the shards and the collectives are plain functions.

Two relation loops, as in the JAX layer. A partition without
``uniform_caps`` (the default below 16 relations) runs the unrolled loop,
whose backward keeps each relation's normalised partial. A ``uniform_caps``
partition (the default from 16 relations: full PrimeKG's 30) runs
:class:`ScanAccumulate`, the counterpart of ``_scan_accumulate``: one
accumulator in the forward, and a backward that recomputes each relation's
partial (B1 over ``rowptr``) before it routes the cotangent back to the
table (B1 over ``t_rowptr``), so that nothing of size R x n_loc x D is kept
between the two. Its buckets are the real edges too: the uniform padding
only shapes the partition arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.data.graph import RelGraph, edge_arrays_from_graph
from primekg_rgcn_tpu_torch.models.rgcn import (Params, compute_dtype,
                                                dropout)
from primekg_rgcn_tpu_torch.ops.cuda.dense_segment_sum import \
    dense_sorted_segment_sum
from primekg_rgcn_tpu_torch.ops.cuda.halo import HaloExchange
from primekg_rgcn_tpu_torch.ops.distmult import distmult_score
from primekg_rgcn_tpu_torch.ops.rgcn_segment import (
    AggOp, aggregate, materialize_relation_weights, promote_matmul)
from primekg_rgcn_tpu_torch.parallel.mesh import (Mesh, all_gather, psum,
                                                  refuse_across_processes)
from primekg_rgcn_tpu_torch.train.loop import Candidates, apply_update
from primekg_rgcn_tpu_torch.train.neg_sampling import (bce_stats,
                                                       candidate_batch)

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class NodeShardedGraph:
    """Shard-major node partition + halo metadata.

    n_loc: rows per shard (the last shard padded).
    Local-source group (needs no received row):
        src_local: int32[n, E_l] indices into [x_local (n_loc) | zero (1)].
        dst_local: int32[n, E_l] local destination rows (sentinel = n_loc).
        offsets_local: per-relation offsets along E_l.
    Halo-source group (needs the exchange):
        src_halo: int32[n, E_h] indices into the received halo table
            [halo rows (n*P) | zero sentinel (1)].
        dst_halo: int32[n, E_h] local destination rows (sentinel = n_loc).
        offsets_halo: per-relation offsets along E_h.
    t_src_* / t_dst_*: the same edges sorted by source within each
        (shard, relation) bucket (the transpose, for the backward).
    inv_deg: float32[n, R, n_loc + 1] local reciprocal in-degrees over both
        groups.
    serve: int32[n, n, P] local row ids each shard serves to each peer
        (sentinel n_loc -> the zero row).
    rowptr_local / rowptr_halo: int32[n, R, n_loc + 2] each bucket's CSR
        of its real edges over its n_loc + 1 destination rows, offsets into
        the bucket (the padding after ``rowptr[..., -1]`` is left out).
    t_rowptr_local: int32[n, R, n_loc + 2] the transpose CSR over the local
        table's n_loc + 1 rows; t_rowptr_halo: int32[n, R, n*P + 2] over
        the halo table's n*P + 1 rows (real edges only, as above).
    halo_width: P (per peer-pair request capacity).
    """

    src_local: torch.Tensor
    dst_local: torch.Tensor
    src_halo: torch.Tensor
    dst_halo: torch.Tensor
    t_src_local: torch.Tensor
    t_dst_local: torch.Tensor
    t_src_halo: torch.Tensor
    t_dst_halo: torch.Tensor
    inv_deg: torch.Tensor
    serve: torch.Tensor
    rowptr_local: torch.Tensor
    t_rowptr_local: torch.Tensor
    rowptr_halo: torch.Tensor
    t_rowptr_halo: torch.Tensor
    offsets_local: Tuple[int, ...]
    offsets_halo: Tuple[int, ...]
    n_loc: int
    halo_width: int
    num_nodes: int
    num_relations: int
    n_devices: int
    uniform_caps: bool


def partition_nodes(graph: RelGraph, n_devices: int, *,
                    pad_multiple: int = 256,
                    uniform_caps: Optional[bool] = None) -> NodeShardedGraph:
    """Host-side partitioner (runs once per graph and mesh size), on the CPU.

    ``uniform_caps`` pads every relation bucket to the same capacity, the
    layout of the JAX package's ``lax.scan`` layer; default on when
    num_relations >= 16. The layer then runs :class:`ScanAccumulate`.
    """
    n = n_devices
    if uniform_caps is None:
        uniform_caps = graph.num_relations >= 16
    num_nodes = graph.num_nodes
    r_count = graph.num_relations
    n_loc = -(-num_nodes // n)

    src_g, dst_g, rel_g = edge_arrays_from_graph(graph)
    owner_dst = dst_g // n_loc

    # Per-shard edge lists sorted by (rel, dst), split by source locality.
    per_dev = []
    counts_l = np.zeros((n, r_count), np.int64)
    counts_h = np.zeros((n, r_count), np.int64)
    for d in range(n):
        mask = owner_dst == d
        s, t, r = src_g[mask], dst_g[mask], rel_g[mask]
        # One combined-key sort (r < R, t < num_nodes: collision-free).
        order = np.argsort(r.astype(np.int64) * num_nodes + t,
                           kind="stable")
        s, t, r = s[order], t[order], r[order]
        is_local = s // n_loc == d
        per_dev.append(((s[is_local], t[is_local], r[is_local]),
                        (s[~is_local], t[~is_local], r[~is_local])))
        counts_l[d] = np.bincount(r[is_local], minlength=r_count)
        counts_h[d] = np.bincount(r[~is_local], minlength=r_count)

    def _caps(counts):
        caps = [max(_round_up(int(counts[:, r].max()), pad_multiple),
                    pad_multiple) for r in range(r_count)]
        if uniform_caps:
            caps = [max(caps)] * r_count
        offsets = [0]
        for c in caps:
            offsets.append(offsets[-1] + c)
        return offsets

    offs_l = _caps(counts_l)
    offs_h = _caps(counts_h)
    e_l, e_h = offs_l[-1], offs_h[-1]

    # Halo requests: req[d][o] = sorted unique global ids d needs from o.
    req = [[np.zeros(0, np.int64) for _ in range(n)] for _ in range(n)]
    for d in range(n):
        remote = per_dev[d][1][0]
        for o in range(n):
            req[d][o] = np.unique(remote[remote // n_loc == o])
    halo_p = max(max((len(req[d][o]) for o in range(n)), default=0)
                 for d in range(n))
    halo_p = max(_round_up(max(halo_p, 1), 8), 8)

    src_local = np.full((n, e_l), n_loc, np.int32)   # sentinel -> zero row
    dst_local = np.full((n, e_l), n_loc, np.int32)
    src_halo = np.full((n, e_h), n * halo_p, np.int32)  # halo-table sentinel
    dst_halo = np.full((n, e_h), n_loc, np.int32)
    inv_deg = np.zeros((n, r_count, n_loc + 1), np.float32)
    serve = np.full((n, n, halo_p), n_loc, np.int32)

    for d in range(n):
        (ls, lt, lr), (hs, ht, hr) = per_dev[d]
        # Vectorised gid -> halo-slot map.
        req_cat = np.concatenate([req[d][o] for o in range(n)]) \
            if any(len(req[d][o]) for o in range(n)) else np.zeros(0, np.int64)
        pos_cat = np.concatenate(
            [o * halo_p + np.arange(len(req[d][o]), dtype=np.int64)
             for o in range(n)]) if len(req_cat) else np.zeros(0, np.int64)
        order = np.argsort(req_cat, kind="stable")
        req_sorted, pos_sorted = req_cat[order], pos_cat[order]

        # Edges are (rel, dst)-sorted: per-relation buckets are slices.
        bl = np.searchsorted(lr, np.arange(r_count + 1))
        bh = np.searchsorted(hr, np.arange(r_count + 1))
        halo_slot_all = (pos_sorted[np.searchsorted(req_sorted, hs)]
                         .astype(np.int32) if len(hs) else
                         np.zeros(0, np.int32))

        for r in range(r_count):
            a, bnd = int(bl[r]), int(bl[r + 1])
            c = bnd - a
            off = offs_l[r]
            src_local[d, off:off + c] = ls[a:bnd] - d * n_loc
            dst_local[d, off:off + c] = lt[a:bnd] - d * n_loc

            ah, bndh = int(bh[r]), int(bh[r + 1])
            ch = bndh - ah
            offh = offs_h[r]
            if ch:
                src_halo[d, offh:offh + ch] = halo_slot_all[ah:bndh]
            dst_halo[d, offh:offh + ch] = ht[ah:bndh] - d * n_loc

            deg = np.bincount(lt[a:bnd] - d * n_loc, minlength=n_loc + 1) \
                + np.bincount(ht[ah:bndh] - d * n_loc, minlength=n_loc + 1)
            nz = deg > 0
            inv_deg[d, r, nz] = 1.0 / deg[nz]
            inv_deg[d, r, n_loc] = 0.0
        for o in range(n):
            ids = req[d][o]
            serve[o, d, : len(ids)] = ids - o * n_loc

    # Per-(shard, relation, group) transpose order (sorted by source); the
    # sentinel tails are already in place and sort last, so only each
    # bucket's real prefix is sorted.
    t_src_local = src_local.copy()
    t_dst_local = dst_local.copy()
    t_src_halo = src_halo.copy()
    t_dst_halo = dst_halo.copy()
    for d in range(n):
        for r in range(r_count):
            for (S, D_, TS, TD, offs, cnts) in (
                    (src_local, dst_local, t_src_local, t_dst_local, offs_l,
                     counts_l),
                    (src_halo, dst_halo, t_src_halo, t_dst_halo, offs_h,
                     counts_h)):
                a = offs[r]
                c = int(cnts[d, r])
                if c == 0:
                    continue
                order = np.argsort(S[d, a:a + c], kind="stable")
                TS[d, a:a + c] = S[d, a:a + c][order]
                TD[d, a:a + c] = D_[d, a:a + c][order]

    def csr(keys, offs, counts, rows):
        """int32[n, R, rows + 1]: each bucket's CSR over ``rows`` rows of
        its real, sorted ``keys`` (the padding after them left out): row
        i starts at the count of keys below i, a running sum of the keys'
        histogram (``searchsorted(keys, arange(rows + 1))``, in linear
        time)."""
        out = np.zeros((n, r_count, rows + 1), np.int32)
        for d in range(n):
            for r in range(r_count):
                a = offs[r]
                np.cumsum(np.bincount(keys[d, a:a + counts[d, r]],
                                      minlength=rows)[:rows],
                          out=out[d, r, 1:])
        return out

    t = torch.from_numpy
    return NodeShardedGraph(
        src_local=t(src_local), dst_local=t(dst_local),
        src_halo=t(src_halo), dst_halo=t(dst_halo),
        t_src_local=t(t_src_local), t_dst_local=t(t_dst_local),
        t_src_halo=t(t_src_halo), t_dst_halo=t(t_dst_halo),
        inv_deg=t(inv_deg), serve=t(serve),
        rowptr_local=t(csr(dst_local, offs_l, counts_l, n_loc + 1)),
        t_rowptr_local=t(csr(t_src_local, offs_l, counts_l, n_loc + 1)),
        rowptr_halo=t(csr(dst_halo, offs_h, counts_h, n_loc + 1)),
        t_rowptr_halo=t(csr(t_src_halo, offs_h, counts_h, n * halo_p + 1)),
        offsets_local=tuple(offs_l), offsets_halo=tuple(offs_h),
        n_loc=n_loc, halo_width=halo_p, num_nodes=num_nodes,
        num_relations=r_count, n_devices=n, uniform_caps=bool(uniform_caps))


class ShardOps(NamedTuple):
    """One shard's operands: its serve list (int64 [n, P]) with its sort
    (``_sort_ids``, for the deterministic backward of ``_take``), its
    ``inv_deg`` rows [R, n_loc + 1] and, per relation, the local and halo
    groups' ``GatherSegmentSum`` operands over the bucket's real edges
    (``None`` for a bucket without any)."""

    serve: torch.Tensor
    serve_sort: Tuple[torch.Tensor, torch.Tensor]
    inv_deg: torch.Tensor
    local: List[Optional[AggOp]]
    halo: List[Optional[AggOp]]


def build_shard_ops(sg: NodeShardedGraph, device=None) -> List[ShardOps]:
    """Per-shard operands on ``device`` (default: the partition's). Each
    group's real edges are packed into one array (its buckets' slices), so
    only they reach the device: a ``uniform_caps`` partition pads every
    bucket to the largest one's capacity (1.6M edges at config 3), which
    the layer never reads. Reads each bucket's real edge count back to the
    host once."""
    device = sg.src_local.device if device is None else torch.device(device)

    def group(d, src, t_dst, rowptr, t_rowptr, offs):
        reals = rowptr[d, :, -1].tolist()
        spans = [(offs[r], offs[r] + c) for r, c in enumerate(reals)]
        packed = [torch.cat([a[d, s:e] for s, e in spans]).to(device)
                  for a in (src, t_dst)]
        rp, t_rp = rowptr[d].to(device), t_rowptr[d].to(device)
        ops: List[Optional[AggOp]] = []
        pos = 0
        for r, c in enumerate(reals):
            ops.append(None if c == 0 else AggOp(
                src=packed[0][pos:pos + c], rowptr=rp[r], scale=None,
                t_ids=packed[1][pos:pos + c], t_rowptr=t_rp[r],
                t_scale=None))
            pos += c
        return ops

    return [ShardOps(
        serve=sg.serve[d].to(device).long(),
        serve_sort=_sort_ids(sg.serve[d].to(device)),
        inv_deg=sg.inv_deg[d].to(device),
        local=group(d, sg.src_local, sg.t_dst_local, sg.rowptr_local,
                    sg.t_rowptr_local, sg.offsets_local),
        halo=group(d, sg.src_halo, sg.t_dst_halo, sg.rowptr_halo,
                   sg.t_rowptr_halo, sg.offsets_halo))
        for d in range(sg.n_devices)]


def _sort_ids(ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int32 sorted ids, int64 order) of ``ids`` flattened, by a stable
    sort, which is deterministic on the card."""
    srt, order = torch.sort(ids.reshape(-1), stable=True)
    return srt.to(torch.int32), order


class TakeRows(torch.autograd.Function):
    """``table[ids]`` as ``jnp.take``: rows of ``table`` at ``ids`` of any
    shape, ``apply(table, ids, sort)``; ``sort`` is ``_sort_ids(ids)`` when
    the ids are a constant (a serve list), else None.

    The forward is ``index_select``. The backward sorts the cotangent rows
    by id (each step's ids sorted there, a constant's sort given) and sums
    them into the table's rows with kernel B2 (``dense_sorted_segment_sum``,
    its plain version on the CPU), in float32, cast to the table's dtype.
    An id recurs thousands of times in a serve list (the sentinel), a fetch
    (the sentinel) or a relation lookup: the backward of advanced indexing
    adds a repeated index serially (51 ms of a 66 ms step of device time on
    an H100, ``bench.py`` graph, n = 4), and ``index_select``'s own,
    ``index_add_``, adds it with float atomics, in an order that changes
    from run to run. Sorted, the sum is the same bits every time.
    """

    @staticmethod
    def forward(ctx, table, ids, sort):
        flat = ids.reshape(-1)
        ctx.rows, ctx.dtype, ctx.sort = table.shape[0], table.dtype, sort
        if sort is None:
            ctx.save_for_backward(flat)
        return table.index_select(0, flat).view(*ids.shape, table.shape[1])

    @staticmethod
    def backward(ctx, g):
        srt, order = ctx.sort or _sort_ids(*ctx.saved_tensors)
        rows = g.reshape(-1, g.shape[-1]).index_select(0, order)
        return (dense_sorted_segment_sum(rows, srt, ctx.rows).to(ctx.dtype),
                None, None)


def _take(table: torch.Tensor, ids: torch.Tensor,
          sort: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
          ) -> torch.Tensor:
    """``TakeRows``: ``table[ids]`` with a sorted, deterministic backward."""
    return TakeRows.apply(table, ids, sort)


def exchange(sends: List[torch.Tensor]) -> List[torch.Tensor]:
    """The differentiable halo exchange: ``recv[o][d] = sends[d][o]``."""
    return list(HaloExchange.apply(*sends))


def _one_relation(table, inv, w_r, *, op, n_loc, aggregate_first, agg_fn):
    if aggregate_first:
        return promote_matmul(agg_fn(table, op)[:n_loc] * inv, w_r)
    return agg_fn((table @ w_r).contiguous(), op)[:n_loc] * inv


def _accumulate(out, table, ops, inv_deg, w_rel, n_loc, aggregate_first,
                agg_fn):
    """Fold one edge group's per-relation partials into ``out``.

    Normalisation and the relation transform are linear, so the local and
    halo groups are scaled and transformed separately: (l + h) * inv @ W ==
    l * inv @ W + h * inv @ W. The JAX layer runs each relation under
    ``jax.checkpoint``; here the backward keeps the normalised partials
    instead of recomputing them: on an H100 at the ``bench.py`` graph
    (n = 4) ``torch.utils.checkpoint`` cost 24 ms of host time a step and
    saved 1.5 MB of a 596 MB peak.
    """
    for r, op in enumerate(ops):
        if op is not None:
            out = out + _one_relation(
                table, inv_deg[r, :n_loc, None], w_rel[r], op=op,
                n_loc=n_loc, aggregate_first=aggregate_first, agg_fn=agg_fn)
    return out


def _transposed(op: AggOp) -> AggOp:
    """The bucket's operands over its transpose CSR: gathering rows of an
    [n_loc + 1, D] cotangent and summing them into the table's rows."""
    return AggOp(src=op.t_ids, rowptr=op.t_rowptr, scale=op.t_scale,
                 t_ids=op.src, t_rowptr=op.rowptr, t_scale=op.scale)


class ScanAccumulate(torch.autograd.Function):
    """``sum_r norm(B1_r(table)) @ W_r`` over one edge group's relations
    with memory O(1) in R both ways, the counterpart of the JAX package's
    ``_scan_accumulate`` and its custom VJP
    (``primekg_rgcn_tpu/parallel/node_shard.py:355-458``).

    ``apply(table, inv, w_all, ops, n_loc, aggregate_first, agg_fn)``:
    table [rows, Din] (the local or halo table with its zero row), inv
    [R, n_loc] and w_all [R, Din, Dout], all in the compute dtype; ``ops``
    the group's R bucket operands (``None`` for a bucket without real
    edges); ``agg_fn(table, op)`` the bucket's gather + segment-sum
    (``aggregate``: kernel B1 on the card). Returns the float32 [n_loc,
    Dout] sum, each relation's term computed as the unrolled loop's
    ``_one_relation`` computes it.

    The forward keeps one accumulator; only the inputs are saved. The
    backward walks the relations again: it recomputes each partial with B1
    over ``rowptr``, forms ``dW_r`` and ``d_inv_r``, and routes the
    cotangent to the table's rows with B1 over ``t_rowptr`` (the halo
    group's transpose runs over the halo table's n*P + 1 rows), as
    ``_scan_acc_bwd`` does. B1's calls inside carry no autograd graph (the
    Function is their gradient); a bf16 table's cotangent is rounded to
    bf16 before B1, as ``GatherSegmentSum`` rounds it, and ``d_table`` is
    summed over the relations in float32 and rounded once.
    """

    @staticmethod
    def forward(ctx, table, inv, w_all, ops, n_loc, aggregate_first,
                agg_fn):
        ctx.save_for_backward(table, inv, w_all)
        ctx.ops, ctx.n_loc = ops, n_loc
        ctx.aggregate_first, ctx.agg_fn = aggregate_first, agg_fn
        out = torch.zeros(n_loc, w_all.shape[2], dtype=torch.float32,
                          device=table.device)
        for r, op in enumerate(ops):
            if op is not None:
                out += _one_relation(table, inv[r, :, None], w_all[r], op=op,
                                     n_loc=n_loc,
                                     aggregate_first=aggregate_first,
                                     agg_fn=agg_fn)
        return out

    @staticmethod
    def backward(ctx, g):
        table, inv, w_all = ctx.saved_tensors
        n_loc, agg_fn = ctx.n_loc, ctx.agg_fn
        need_table, need_inv, need_w = ctx.needs_input_grad[:3]
        g = g.float()
        d_table = (torch.zeros(table.shape, dtype=torch.float32,
                               device=table.device) if need_table else None)
        d_inv = torch.zeros_like(inv) if need_inv else None
        d_w = torch.zeros_like(w_all) if need_w else None

        def to_table(cot, op):
            # The cotangent of the bucket's [n_loc + 1, D] aggregate (its
            # dummy row zero) summed into the table's rows, float32.
            pad = torch.cat([cot, cot.new_zeros(1, cot.shape[1])])
            return agg_fn(pad.to(table.dtype).contiguous(), _transposed(op))

        for r, op in enumerate(ctx.ops):
            if op is None:
                continue
            w_r, inv_r = w_all[r], inv[r, :, None]
            wf = w_r.float()
            if ctx.aggregate_first:
                part = agg_fn(table, op)[:n_loc] if (need_inv or need_w) \
                    else None
                gw = g @ wf.T                              # [n_loc, Din]
                if need_w:
                    d_w[r] = ((part * inv_r).T @ g).to(w_all.dtype)
                if need_inv:
                    d_inv[r] = (part * gw).sum(1).to(inv.dtype)
                if need_table:
                    d_table += to_table(gw * inv_r, op)
            else:
                if need_inv:
                    part = agg_fn((table @ w_r).contiguous(), op)[:n_loc]
                    d_inv[r] = (part * g).sum(1).to(inv.dtype)
                if need_table or need_w:
                    d_tw = to_table(g * inv_r, op).to(table.dtype)
                    if need_w:
                        d_w[r] = (table.T @ d_tw).to(w_all.dtype)
                    if need_table:
                        d_table += d_tw @ w_r.T
        if d_table is not None:
            d_table = d_table.to(table.dtype)
        return d_table, d_inv, d_w, None, None, None, None


def _scan(out, table, ops, inv_deg, w_rel, n_loc, aggregate_first, agg_fn):
    """Fold one edge group into ``out`` through :class:`ScanAccumulate`."""
    return out + ScanAccumulate.apply(table, inv_deg[:, :n_loc], w_rel, ops,
                                      n_loc, aggregate_first, agg_fn)


def node_sharded_layer(layer_params, xs: Sequence[torch.Tensor],
                       sg: NodeShardedGraph, shard_ops: Sequence[ShardOps],
                       *, agg_fn=aggregate, exchange_fn=exchange,
                       compute_dtype: torch.dtype = torch.float32
                       ) -> List[torch.Tensor]:
    """One RGCN layer over every shard: ``xs[d]`` is shard d's float32
    [n_loc, Din] rows; returns the shards' float32 [n_loc, Dout] outputs.
    The rows, weights and ``inv_deg`` are converted to ``compute_dtype``
    first, so a bf16 layer exchanges and aggregates bf16 rows.

    The exchange comes first; then each shard aggregates its local-source
    group (which needs no received row), then its halo-source group over
    the received rows. Both groups normalise by the dense ``inv_deg``
    table; a ``uniform_caps`` partition folds each group through
    :class:`ScanAccumulate`. ``agg_fn(table, op)`` is the per-bucket
    gather + segment-sum (default: ``GatherSegmentSum``, kernel B1 both
    ways on the card);
    ``exchange_fn(sends)`` the exchange (default: ``HaloExchange``, kernel
    B4 both ways on the card). Only a reference passes the plain versions.
    """
    n, n_loc = sg.n_devices, sg.n_loc
    w_rel = materialize_relation_weights(layer_params).to(compute_dtype)
    w_root = layer_params["w_root"].to(compute_dtype)
    bias = layer_params["bias"].to(compute_dtype)
    din, dout = w_rel.shape[1], w_rel.shape[2]
    xs = [x.to(compute_dtype) for x in xs]
    x_pads = [torch.cat([x, x.new_zeros(1, din)]) for x in xs]

    # 1) the exchange: shard d sends rows x_pad[d][serve[d][o]] to peer o.
    recvs = exchange_fn([_take(x_pads[d], shard_ops[d].serve,
                               shard_ops[d].serve_sort) for d in range(n)])

    aggregate_first = din <= dout
    fold = _scan if sg.uniform_caps else _accumulate
    outs = []
    for d in range(n):
        out = xs[d] @ w_root + bias[None, :]
        inv_deg = shard_ops[d].inv_deg.to(compute_dtype)
        # 2) local-source group, 3) halo-source group.
        out = fold(out, x_pads[d], shard_ops[d].local, inv_deg, w_rel,
                   n_loc, aggregate_first, agg_fn)
        halo_table = torch.cat([recvs[d].reshape(-1, din),
                                recvs[d].new_zeros(1, din)])
        out = fold(out, halo_table, shard_ops[d].halo, inv_deg, w_rel,
                   n_loc, aggregate_first, agg_fn)
        outs.append(out.float())
    return outs


def sharded_encoder(params: Params, sg: NodeShardedGraph,
                    shard_ops: Sequence[ShardOps], cfg: ModelConfig, *,
                    train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    masks: Optional[Sequence[torch.Tensor]] = None,
                    agg_fn=aggregate,
                    exchange_fn=exchange) -> List[torch.Tensor]:
    """The encoder over the shards: each shard's slice of the (replicated)
    embedding table -> conv1 -> ReLU -> dropout -> conv2; returns the
    shards' [n_loc, hidden] rows. With ``train``, each shard's dropout mask
    is drawn from ``generator`` in shard order, or given as ``masks[d]``.
    Both layers run in ``cfg.compute_dtype``."""
    enc = params["encoder"]
    emb = enc["node_emb"]
    cdt = compute_dtype(cfg)
    n, n_loc = sg.n_devices, sg.n_loc
    pad = n * n_loc - cfg.num_nodes
    if pad:
        emb = torch.cat([emb, emb.new_zeros(pad, emb.shape[1])])
    xs = list(emb.view(n, n_loc, -1).unbind(0))
    xs = node_sharded_layer(enc["conv1"], xs, sg, shard_ops, agg_fn=agg_fn,
                            exchange_fn=exchange_fn, compute_dtype=cdt)
    xs = [torch.relu(x) for x in xs]
    if train and cfg.dropout > 0.0:
        xs = [dropout(x, cfg.dropout, generator=generator,
                      mask=None if masks is None else masks[d])
              for d, x in enumerate(xs)]
    return node_sharded_layer(enc["conv2"], xs, sg, shard_ops, agg_fn=agg_fn,
                              exchange_fn=exchange_fn, compute_dtype=cdt)


def _on_mesh(mesh: Mesh, sg: NodeShardedGraph) -> List[ShardOps]:
    refuse_across_processes(mesh, "the node layout")
    if sg.n_devices != mesh.n_shards:
        raise ValueError(f"partition has {sg.n_devices} shards, mesh "
                         f"{mesh.n_shards}")
    return build_shard_ops(sg, mesh.device)


def build_node_sharded_forward(mesh: Mesh, sg: NodeShardedGraph,
                               model_cfg: ModelConfig, *,
                               gather: bool = True):
    """Full-graph encode over the shards: ``encode(params)``.

    gather=True returns the [N, hidden] output; gather=False the
    shard-major [n, n_loc, hidden] tensor, the input of
    ``evaluate/sharded_ranking.build_sharded_topk``.
    """
    ops = _on_mesh(mesh, sg)

    def encode(params: Params) -> torch.Tensor:
        xs = sharded_encoder(params, sg, ops, model_cfg)
        if not gather:
            return torch.stack(xs)
        return torch.cat(xs)[:sg.num_nodes]

    return encode


def _fetch(x_pads: Sequence[torch.Tensor], ids: Sequence[torch.Tensor],
           n_loc: int) -> List[torch.Tensor]:
    """Endpoint rows for every shard's request list: all-gather the ids,
    each shard serves its owner-masked local rows (the zero row elsewhere),
    psum; shard d keeps row block d. Nothing builds the full table."""
    all_ids = all_gather(ids)                      # [n, C]
    owner = all_ids // n_loc
    rows = [_take(x_pad, torch.where(owner == my, all_ids - my * n_loc,
                                     n_loc))
            for my, x_pad in enumerate(x_pads)]    # each [n, C, H]
    full = psum(rows)
    return list(full.unbind(0))


def build_node_sharded_train_step(mesh: Mesh, sg: NodeShardedGraph,
                                  model_cfg: ModelConfig,
                                  train_cfg: TrainConfig, *,
                                  agg_fn=aggregate, exchange_fn=exchange):
    """Training update over the node-sharded graph:
    ``step(params, optimizer, batch, generator) -> stats``.

    ``batch`` is int64 [B, 4] (head, tail, rel, mask) on the mesh device,
    split over the shards (B must divide by n; padding rows have mask 0).
    ``step.draw(batch, generator)`` draws each shard's candidates
    (``candidate_batch``, shard order); ``step.update(params, optimizer,
    cands, generator=, enc_masks=)`` computes the update from given
    candidates: the encode with its per-shard dropout, endpoint rows by an
    owner-masked fetch, the loss ``sum(loss_sum) / max(sum(count), 1)``
    with one ``backward()`` over every shard, then ``apply_update`` (clip,
    then the optimizer). No decoder dropout, as in the JAX step. Both
    return [loss_sum, correct, count] summed over the shards, on the
    device (the step's mean loss is ``loss_sum / count``).
    """
    ops = _on_mesh(mesh, sg)
    n, n_loc = mesh.n_shards, sg.n_loc

    def draw(batch: torch.Tensor,
             generator: Optional[torch.Generator]) -> List[Candidates]:
        b = batch.shape[0]
        if b % n:
            raise ValueError(f"batch {b} must divide by the {n}-shard mesh")
        return [candidate_batch(p[:, 0], p[:, 1], p[:, 2], sg.num_nodes,
                                train_cfg.num_neg_samples, mask=p[:, 3],
                                generator=generator)
                for p in batch.view(n, b // n, 4)]

    def update(params: Params, optimizer: torch.optim.Optimizer,
               cands: Sequence[Candidates], *,
               generator: Optional[torch.Generator] = None,
               enc_masks: Optional[Sequence[torch.Tensor]] = None
               ) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        xs = sharded_encoder(params, sg, ops, model_cfg, train=True,
                             generator=generator, masks=enc_masks,
                             agg_fn=agg_fn, exchange_fn=exchange_fn)
        x_pads = [torch.cat([x, x.new_zeros(1, x.shape[1])]) for x in xs]
        he = _fetch(x_pads, [c[0] for c in cands], n_loc)
        te = _fetch(x_pads, [c[1] for c in cands], n_loc)
        rel_table = params["decoder"]["rel_emb"]
        stats = torch.stack([
            torch.stack(bce_stats(
                distmult_score(h, t, _take(rel_table, c[2])), c[3], c[4]))
            for h, t, c in zip(he, te, cands)]).sum(0)
        (stats[0] / stats[2].clamp(min=1.0)).backward()
        apply_update(optimizer, train_cfg)
        return stats.detach()

    def step(params: Params, optimizer: torch.optim.Optimizer,
             batch: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return update(params, optimizer, draw(batch, generator),
                      generator=generator)

    step.draw = draw
    step.update = update
    return step
