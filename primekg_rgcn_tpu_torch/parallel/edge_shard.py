"""Edge-sharded RGCN: one process driving every shard, or each process of
a group its own.

The counterpart of ``primekg_rgcn_tpu/parallel/edge_shard.py``, the JAX
``ShardedTrainer``'s default layout:

- Every relation bucket is split into n contiguous chunks, one a shard,
  each padded with the sentinel to a common length (contiguity keeps each
  chunk destination-sorted). Every shard sees the whole, replicated
  feature table and computes its partial per-node aggregate over its own
  edges; the shards' partials are then summed (the JAX ``lax.psum``).
  Mean normalisation is linear, so normalising each partial before the sum
  is exact; edge-norm graphs carry the global degrees in their per-edge
  scales.
- The batch is data-parallel over the same shards: each takes its B/n
  slice, draws its own negatives and decoder-dropout mask, and the loss
  sums and counts are summed over the shards, so one micro-batch's gradient
  is that of its global masked mean.
- Every array is built once on the host by :func:`shard_rel_graph`, equal
  to the JAX arrays bit for bit at either alignment. In place of the JAX
  Pallas schedules, each (shard, relation) bucket carries the CSR
  ``rowptr`` over its N + 1 destination rows and the transpose CSR
  ``t_rowptr`` over the table's N + 1 rows, so ``GatherSegmentSum`` runs
  kernel B1 both ways, per shard. The CSRs cover each chunk's real edges
  (a prefix of the chunk: the sentinel sorts last both ways) and a chunk
  without one is skipped, as in the node layout's buckets.

All shards live on the mesh's one device (``parallel/mesh.py``): the
psum is the sum of the shards' partials in shard order. Across processes
each process aggregates its own shards' chunks, sums them, and the sum
runs across the processes through the autograd psum (its backward is a
psum too); each process scores its own shards' slices of the batch and
backpropagates their loss sum over the global count, and the replicated
parameters' gradients are summed across the processes before the clip.
Every process draws every shard's negatives and dropout masks from the one
generator and keeps its own, so the generators stay equal, and the
encoder's dropout mask, drawn from it, is the same in every process.

Under bf16 compute each aggregate is rounded to bf16 before its
normalisation, and the partials, their sum and the relation products stay
bf16 up to the layer's float32 result, as the JAX edge layer does
(``ops/rgcn_segment.py``'s dtype table).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.data.graph import RelGraph
from primekg_rgcn_tpu_torch.models.rgcn import (Params, compute_dtype,
                                                dropout, param_leaves)
from primekg_rgcn_tpu_torch.ops.distmult import distmult_score
from primekg_rgcn_tpu_torch.ops.rgcn_segment import (
    AggOp, aggregate, materialize_relation_weights)
from primekg_rgcn_tpu_torch.parallel.mesh import Mesh, all_reduce_, psum
from primekg_rgcn_tpu_torch.train.loop import Candidates, apply_update
from primekg_rgcn_tpu_torch.train.neg_sampling import (bce_stats,
                                                       candidate_batch)


@dataclass(frozen=True)
class ShardedGraph:
    """Shard-major edge shards.

    src / dst: int32[n, E_local], destination-sorted within each local
        bucket (sentinel N on padding); t_src / t_dst: the same local edges
        in stable source order (the transpose, for the backward).
    local_offsets: per-relation bucket offsets along E_local, the same on
        every shard.
    inv_in_deg: float32[R, N+1] replicated (dense-norm graphs).
    scale / t_scale: float32[n, E_local] per-edge reciprocal global
        in-degrees in local and local-transpose order (edge-norm graphs),
        else None.
    rowptr / t_rowptr: int32[n, R, N+2] each (shard, relation) bucket's
        CSR of its real edges over the N + 1 destination rows, and its
        transpose CSR over the table's N + 1 rows; offsets into the bucket.
    """

    src: torch.Tensor
    dst: torch.Tensor
    t_src: torch.Tensor
    t_dst: torch.Tensor
    inv_in_deg: torch.Tensor
    rowptr: torch.Tensor
    t_rowptr: torch.Tensor
    local_offsets: Tuple[int, ...]
    num_nodes: int
    num_relations: int
    n_devices: int
    scale: Optional[torch.Tensor] = None
    t_scale: Optional[torch.Tensor] = None

    _TENSORS = ("src", "dst", "t_src", "t_dst", "inv_in_deg", "rowptr",
                "t_rowptr", "scale", "t_scale")

    def to(self, device) -> "ShardedGraph":
        """The same shards with every array on ``device``."""
        return replace(self, **{
            k: getattr(self, k).to(device) for k in self._TENSORS
            if getattr(self, k) is not None})


def shard_rel_graph(graph: RelGraph, n_devices: int, *,
                    align: Optional[int] = None) -> ShardedGraph:
    """Split a RelGraph into equal per-shard edge chunks, on the CPU.

    Each bucket is padded with the sentinel to a multiple of ``align``
    (default ``n_devices``, the JAX ``pallas=False`` layout; ``SEG_K * n``
    = 512 n is its ``pallas=True`` one) and cut into ``n_devices``
    contiguous chunks; each chunk gets its stable source-sorted transpose
    order, its per-edge scales in both orders on an edge-norm graph, and
    its two CSRs.
    """
    n = n_devices
    align = n if align is None else align
    if align % n:
        raise ValueError(f"align {align} must be a multiple of {n} shards")
    src, dst = graph.src.cpu().numpy(), graph.dst.cpu().numpy()
    edge_norm = graph.norm_mode == "edge"
    g_scale = graph.edge_scale.cpu().numpy() if edge_norm else None
    sentinel = num = graph.num_nodes
    r_count = graph.num_relations
    rows = np.arange(num + 2)

    per_dev = [([], [], [], [], [], []) for _ in range(n)]
    rowptr = np.zeros((n, r_count, num + 2), np.int32)
    t_rowptr = np.zeros((n, r_count, num + 2), np.int32)
    offsets = [0]
    for r in range(r_count):
        s, e = graph.bucket_slice(r)
        cap = e - s
        cap_pad = -(-cap // align) * align
        loc = cap_pad // n
        bsrc = np.full(cap_pad, sentinel, np.int32)
        bdst = np.full(cap_pad, sentinel, np.int32)
        bsrc[:cap], bdst[:cap] = src[s:e], dst[s:e]
        if edge_norm:
            bscale = np.zeros(cap_pad, np.float32)
            bscale[:cap] = g_scale[s:e]
        for d in range(n):
            ls, ld = bsrc[d * loc:(d + 1) * loc], bdst[d * loc:(d + 1) * loc]
            t_order = np.argsort(ls, kind="stable")
            parts = [ls, ld, ls[t_order], ld[t_order]]
            if edge_norm:
                lscale = bscale[d * loc:(d + 1) * loc]
                parts += [lscale, lscale[t_order]]
            for i, a in enumerate(parts):
                per_dev[d][i].append(a)
            real = int(np.count_nonzero(ld < num))
            rowptr[d, r] = np.searchsorted(ld[:real], rows)
            t_rowptr[d, r] = np.searchsorted(parts[2][:real], rows)
        offsets.append(offsets[-1] + loc)

    def stack(i):
        return torch.from_numpy(np.stack(
            [np.concatenate(per_dev[d][i]) for d in range(n)]))

    return ShardedGraph(
        src=stack(0), dst=stack(1), t_src=stack(2), t_dst=stack(3),
        inv_in_deg=graph.inv_in_deg.cpu(), rowptr=torch.from_numpy(rowptr),
        t_rowptr=torch.from_numpy(t_rowptr), local_offsets=tuple(offsets),
        num_nodes=num, num_relations=r_count, n_devices=n,
        scale=stack(4) if edge_norm else None,
        t_scale=stack(5) if edge_norm else None)


def build_edge_ops(sg: ShardedGraph) -> List[List[Optional[AggOp]]]:
    """``ops[d][r]``: shard d's ``GatherSegmentSum`` operands for relation
    r over its chunk's real edges (``None`` without any); slices of the
    shards' arrays, no copies. Reads each bucket's real edge count back to
    the host once."""
    reals = sg.rowptr[..., -1].tolist()
    ops = []
    for d in range(sg.n_devices):
        row: List[Optional[AggOp]] = []
        for r in range(sg.num_relations):
            s = sg.local_offsets[r]
            e = s + reals[d][r]
            row.append(None if e == s else AggOp(
                src=sg.src[d, s:e], rowptr=sg.rowptr[d, r],
                scale=None if sg.scale is None else sg.scale[d, s:e],
                t_ids=sg.t_dst[d, s:e], t_rowptr=sg.t_rowptr[d, r],
                t_scale=None if sg.t_scale is None else sg.t_scale[d, s:e]))
        ops.append(row)
    return ops


def rgcn_layer_edge_sharded(layer_params, x: torch.Tensor, sg: ShardedGraph,
                            ops: Sequence[Sequence[Optional[AggOp]]], *,
                            agg_fn=aggregate,
                            compute_dtype: torch.dtype = torch.float32,
                            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One RGCN layer over every shard's edges: x is the replicated float32
    [N, Din] table; returns the float32 [N, Dout] layer output.

    Per relation, each shard's bucket is aggregated (``agg_fn``: kernel B1
    both ways on the card), rounded to the compute dtype and normalised.
    With ``aggregate_first`` (Din <= Dout) the shards' normalised [N, Din]
    partials are summed and then transformed, one relation at a time (the
    JAX layer stacks all R before its one psum; the sums are the same, in
    the same shard order); otherwise each shard sums its transformed
    partials over the relations first and the shards' totals are summed.
    With a ``mesh`` that spans processes, ``ops`` are this process's
    shards' and each sum also runs across the processes, for every
    relation, whether or not this process's shards have its edges.
    """
    n = sg.num_nodes
    w_rel = materialize_relation_weights(layer_params).to(compute_dtype)
    din, dout = w_rel.shape[1], w_rel.shape[2]
    xc = x.to(compute_dtype)
    x_pad = torch.cat([xc, xc.new_zeros(1, din)])
    out = xc @ layer_params["w_root"].to(compute_dtype) \
        + layer_params["bias"].to(compute_dtype)[None, :]
    aggregate_first = din <= dout

    def partial(op, table, r):
        p = agg_fn(table, op).to(compute_dtype)[:n]
        if sg.scale is not None:          # the scales normalised each edge
            return p
        return p * sg.inv_in_deg[r][:n, None].to(compute_dtype)

    across = mesh is not None and mesh.world > 1
    if aggregate_first:
        for r in range(sg.num_relations):
            parts = [partial(row[r], x_pad, r) for row in ops
                     if row[r] is not None]
            if across:
                # Without edges of r here, a zero partial that still
                # requires grad: the psum's backward is a collective, which
                # every process must join.
                parts = parts or [xc.new_zeros(n, din).requires_grad_(
                    torch.is_grad_enabled() and x.requires_grad)]
                out = out + psum(parts, mesh) @ w_rel[r]
            elif parts:
                out = out + psum(parts) @ w_rel[r]
        return out.float()
    totals = []
    for row in ops:
        total = xc.new_zeros(n, dout)
        for r, op in enumerate(row):
            if op is not None:
                total = total + partial(op, (x_pad @ w_rel[r]).contiguous(),
                                        r)
        totals.append(total)
    return (out + psum(totals, mesh)).float()


def sharded_encoder(params: Params, sg: ShardedGraph,
                    ops: Sequence[Sequence[Optional[AggOp]]],
                    cfg: ModelConfig, *, train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    mask: Optional[torch.Tensor] = None,
                    agg_fn=aggregate,
                    mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The encoder over the edge shards: node_emb -> conv1 -> ReLU ->
    dropout -> conv2, the replicated [N, hidden] rows. With ``train`` the
    layer-1 dropout is one mask over the replicated rows, the same on every
    shard as in the JAX layer, drawn from ``generator`` or given as
    ``mask``. ``ops`` and ``mesh`` as in :func:`rgcn_layer_edge_sharded`."""
    enc = params["encoder"]
    cdt = compute_dtype(cfg)
    x = rgcn_layer_edge_sharded(enc["conv1"], enc["node_emb"], sg, ops,
                                agg_fn=agg_fn, compute_dtype=cdt, mesh=mesh)
    x = torch.relu(x)
    if train and cfg.dropout > 0.0:
        x = dropout(x, cfg.dropout, generator=generator, mask=mask)
    return rgcn_layer_edge_sharded(enc["conv2"], x, sg, ops, agg_fn=agg_fn,
                                   compute_dtype=cdt, mesh=mesh)


def _on_mesh(mesh: Mesh, sg: ShardedGraph):
    """The shards on the mesh's device and the ops of this process's."""
    if sg.n_devices != mesh.n_shards:
        raise ValueError(f"edge shards {sg.n_devices}, mesh "
                         f"{mesh.n_shards}")
    sg = sg.to(mesh.device)
    ops = build_edge_ops(sg)
    return sg, [ops[d] for d in mesh.local]


def build_sharded_forward(mesh: Mesh, sg: ShardedGraph,
                          model_cfg: ModelConfig, *, agg_fn=aggregate):
    """Full-graph encode over the edge shards: ``encode(params)`` returns
    the replicated [N, hidden] rows."""
    sg, ops = _on_mesh(mesh, sg)

    def encode(params: Params) -> torch.Tensor:
        return sharded_encoder(params, sg, ops, model_cfg, agg_fn=agg_fn,
                               mesh=mesh)

    return encode


def build_sharded_train_step(mesh: Mesh, sg: ShardedGraph,
                             model_cfg: ModelConfig, train_cfg: TrainConfig,
                             *, accum_steps: int = 1, agg_fn=aggregate):
    """Training update over the edge shards:
    ``step(params, optimizer, batch, generator) -> stats``.

    ``batch`` is int64 [B, 4] (head, tail, rel, mask), or [accum, B, 4]
    with ``accum_steps`` > 1, on the mesh device; B must divide by n
    (padding rows have mask 0). ``step.draw(batch, generator)`` draws, per
    micro-batch, each shard's candidates over its B/n slice (shard order).
    ``step.update(params, optimizer, micro_cands, generator=, enc_masks=,
    dec_masks=)`` computes one update from given candidates: per micro-batch
    one encode (its layer-1 mask ``enc_masks[i]``), each shard's scores with
    its own decoder-dropout mask (``dec_masks[i][d]``), and one
    ``backward()`` of ``sum(loss_sum) / max(sum(count), 1)`` over the
    shards; then the summed gradients are divided by the number of
    micro-batches, clipped and applied (``apply_update``), as the JAX step
    does. Masks not given are drawn from ``generator``. Both return
    [loss_sum, correct, count] summed over the shards and micro-batches, on
    the device.

    Across processes ``draw`` draws every shard's candidates and keeps its
    own (None for another process's), ``update`` scores its own shards and
    draws the others' decoder masks by shape, each process backpropagates
    its shards' loss sum over the global count, and the gradients are
    summed across the processes before ``apply_update``.
    """
    sg, ops = _on_mesh(mesh, sg)
    n = mesh.n_shards
    accum = max(int(accum_steps), 1)
    local = mesh.local

    def draw(batch: torch.Tensor, generator: Optional[torch.Generator]
             ) -> List[List[Optional[Candidates]]]:
        micro = batch.view(-1, *batch.shape[-2:])
        if micro.shape[0] != accum:
            raise ValueError(f"batch holds {micro.shape[0]} micro-batches, "
                             f"the step accumulates {accum}")
        b = micro.shape[1]
        if b % n:
            raise ValueError(f"batch {b} must divide by the {n}-shard mesh")
        return [[c if d in local else None for d, c in enumerate(
                    candidate_batch(p[:, 0], p[:, 1], p[:, 2], sg.num_nodes,
                                    train_cfg.num_neg_samples, mask=p[:, 3],
                                    generator=generator)
                    for p in m.view(n, b // n, 4))] for m in micro]

    def update(params: Params, optimizer: torch.optim.Optimizer,
               micro_cands: Sequence[Sequence[Candidates]], *,
               generator: Optional[torch.Generator] = None,
               enc_masks: Optional[Sequence[torch.Tensor]] = None,
               dec_masks: Optional[Sequence[Sequence[torch.Tensor]]] = None
               ) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        rel_table = params["decoder"]["rel_emb"]
        stats = torch.zeros(3, device=rel_table.device)
        for i, cands in enumerate(micro_cands):
            node_emb = sharded_encoder(
                params, sg, ops, model_cfg, train=True, generator=generator,
                mask=None if enc_masks is None else enc_masks[i],
                agg_fn=agg_fn, mesh=mesh)
            mine = [c for c in cands if c is not None]
            shard_stats = []
            for d, c in enumerate(cands):
                drop = model_cfg.decoder_dropout > 0.0
                if c is None:
                    # Another process's shard: its mask, drawn and dropped.
                    if drop and dec_masks is None:
                        torch.rand((mine[0][2].shape[0], rel_table.shape[1]),
                                   generator=generator,
                                   device=rel_table.device)
                    continue
                h, t, r, y, w = c
                re = rel_table[r]
                if drop:
                    re = dropout(re, model_cfg.decoder_dropout,
                                 generator=generator,
                                 mask=None if dec_masks is None
                                 else dec_masks[i][d])
                shard_stats.append(torch.stack(bce_stats(
                    distmult_score(node_emb[h], node_emb[t], re), y, w)))
            own = psum(shard_stats)
            micro = psum([own.detach()], mesh)
            (own[0] / micro[2].clamp(min=1.0)).backward()
            stats += micro
        all_reduce_([p.grad for p in param_leaves(params)
                     if p.grad is not None], mesh)
        apply_update(optimizer, train_cfg, accum=len(micro_cands))
        return stats

    def step(params: Params, optimizer: torch.optim.Optimizer,
             batch: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return update(params, optimizer, draw(batch, generator),
                      generator=generator)

    step.draw = draw
    step.update = update
    return step
