"""Relation-typed graph convolution over the relation-bucketed graph, with
one fused gather + sorted segment-sum per relation bucket (the CUDA kernel
in ``ops/cuda/segment_sum.py``, or its plain version on the CPU).

- **Transpose-graph backward.** Each bucket's aggregation goes through
  ``GatherSegmentSum``, whose backward is the same kernel over the bucket's
  transpose CSR (edges sorted by source), as the JAX package's custom VJP
  does: the gradient is a sorted gather + segment-sum, not a scatter.
- **Aggregation order picked per layer.** mean_r(X) @ W_r == mean_r(X @ W_r)
  (the mean is linear), so the layer aggregates in the narrower of Din and
  Dout: both default layers (64 -> 128, 128 -> 128) aggregate first.
- **Sentinel padding.** Padding edges gather the all-zero dummy row N and
  land in the dummy output row, which is dropped.
- **Mean normalisation.** Dense mode multiplies the aggregate by the
  ``1/in-degree`` table after the sum; edge mode passes the per-edge scale
  into the kernel, which multiplies each gathered row. The matmuls, the
  dense-mode multiply and the padding stay outside the Function, where
  autograd differentiates them.
- **bf16 compute** (``compute_dtype=torch.bfloat16``) keeps the dtype of
  every intermediate of the JAX package's Pallas path (``impl="pallas"``,
  the one the TPU ran), not of its XLA CPU path, which sums in bf16:

  ==================  ===========================  =====================
  step                JAX (primekg_rgcn_tpu/...)   dtype
  ==================  ===========================  =====================
  weights, root,      ops/rgcn_segment.py:284-289  bf16 copies of the
  bias, input cast                                 float32 parameters
  ``x_pad``, the      :291                         bf16
  table B1 gathers
  B1 forward, dense   ops/pallas/segment_sum.py    bf16 rows, float32
  norm                :326-329                     sum and output
  B1 forward, edge    rgcn_segment.py:163,         bf16 row x float32
  norm                segment_sum.py:286, :328     scale, rounded to
                                                   bf16, float32 sum
  ``agg * inv_deg``,  rgcn_segment.py:311-319      float32 x bf16 ->
  ``@ w_rel[r]``                                   float32, float32
                                                   matmul
  ``out``, the        :298, :321                   bf16 root term +
  layer's result                                   float32 -> float32
  B1 backward         rgcn_segment.py:181-186      float32 cotangent,
                                                   bf16 rows, float32
                                                   sum, cast to bf16
  decoder, BCE, adam  models/rgcn.py:170-178       float32 (parameters
                                                   stay float32)
  sampled identity    data/sampling.py:814-836,    float32 rows gathered,
  gather              models/rgcn.py:243-260       then converted to bf16
  its backward (B2)   data/sampling.py:822-836     bf16 cotangents,
                                                   float32 sum, cast to
                                                   the float32 table
  node layer, halo    parallel/node_shard.py       serve rows in bf16
  payload             :476-485, :493-494, :544     through B4; B1 over
                                                   bf16 tables
  node relation scan  parallel/node_shard.py       as the unrolled loop;
                      :355-458                     the table's gradient
                                                   summed over the
                                                   relations in float32,
                                                   rounded once
  node ``_take``      ``jnp.take``'s VJP, a        float32 sum (B2),
  backward            scatter-add in the rows'     cast to the table's
                      dtype                        dtype
  edge layer          parallel/edge_shard.py       aggregate rounded to
                      :157-245                     bf16, normalised,
                                                   summed over the
                                                   shards and transformed
                                                   in bf16; float32 out
  ==================  ===========================  =====================

  Torch refuses a matmul of two dtypes where ``jnp`` promotes, so
  :func:`promote_matmul` casts up explicitly. The backward rounds the
  cotangent before the edge-mode scale, where JAX rounds after it
  (``ops/cuda/segment_sum.GatherSegmentSum``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from primekg_rgcn_tpu_torch.data.graph import RelGraph
from primekg_rgcn_tpu_torch.ops.cuda.segment_sum import (
    GatherSegmentSum, gather_segment_sum_plain)


class AggOp(NamedTuple):
    """One relation bucket's operands for ``GatherSegmentSum``."""

    src: torch.Tensor               # int32[E_b], destination order
    rowptr: torch.Tensor            # int32[N+2], CSR over N+1 dst rows
    scale: Optional[torch.Tensor]   # float32[E_b] in edge mode, else None
    t_ids: torch.Tensor             # int32[E_b] destinations, source order
    t_rowptr: torch.Tensor          # int32[N+2], CSR over N+1 src rows
    t_scale: Optional[torch.Tensor]  # float32[E_b] in edge mode, else None


def aggregate(x: torch.Tensor, op: AggOp) -> torch.Tensor:
    """The bucket's gather + segment-sum of x [N+1, D] (float32 or bf16)
    into float32, differentiable in x through the transpose CSR (the kernel
    both ways on a CUDA tensor)."""
    return GatherSegmentSum.apply(x, (op.src, op.rowptr, op.scale),
                                  (op.t_ids, op.t_rowptr, op.t_scale))


def aggregate_plain(x: torch.Tensor, op: AggOp) -> torch.Tensor:
    """The same function through the plain version, differentiated by
    autograd (index_add_ forward, gather + index_put backward)."""
    return gather_segment_sum_plain(x, op.src, op.rowptr, op.scale)


def promote_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two (f32 x bf16 -> f32), as
    ``jnp`` computes a product of mixed dtypes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def materialize_relation_weights(
        layer_params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Return [R, Din, Dout] relation weights, expanding the basis
    decomposition W_r = sum_b a_{rb} V_b."""
    if "w_rel" in layer_params:
        return layer_params["w_rel"]
    return torch.einsum("rb,bio->rio", layer_params["coef"],
                        layer_params["basis"])


def build_layer_agg_ops(graph: RelGraph) -> List[Optional[AggOp]]:
    """Per-relation aggregation operands (``None`` for an empty bucket):
    slices of the graph's arrays, no copies."""
    edge_norm = graph.norm_mode == "edge"
    ops: List[Optional[AggOp]] = []
    for r in range(graph.num_relations):
        s, e = graph.bucket_slice(r)
        if e == s:
            ops.append(None)
            continue
        ops.append(AggOp(
            src=graph.src[s:e], rowptr=graph.rowptr[r],
            scale=graph.edge_scale[s:e] if edge_norm else None,
            t_ids=graph.t_dst[s:e], t_rowptr=graph.t_rowptr[r],
            t_scale=graph.t_edge_scale[s:e] if edge_norm else None))
    return ops


def rgcn_layer_segment(
    layer_params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    graph: RelGraph,
    *,
    agg_ops: Optional[List[Optional[AggOp]]] = None,
    agg_fn=aggregate,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Relation-typed mean-aggregated graph convolution over a RelGraph.

    Args:
        layer_params: see ``ops/rgcn_dense.py`` for the schema.
        x: float32 [N, Din] node features (without the dummy row), on the
            graph's device.
        graph: relation-bucketed graph.
        agg_ops: optional prebuilt operands from :func:`build_layer_agg_ops`.
        agg_fn: the per-bucket gather + segment-sum ``agg_fn(x_pad, op)``;
            the default launches the CUDA kernel on a CUDA tensor, forward
            and backward.
        compute_dtype: float32, or bfloat16 for the flow of the module
            docstring's table.

    Returns:
        float32 [N, Dout] updated node features.
    """
    n = graph.num_nodes
    w_rel = materialize_relation_weights(layer_params).to(compute_dtype)
    w_root = layer_params["w_root"].to(compute_dtype)
    bias = layer_params["bias"].to(compute_dtype)
    din, dout = w_rel.shape[1], w_rel.shape[2]
    xc = x.to(compute_dtype)
    # Dummy row n is zero: sentinel edges contribute nothing.
    x_pad = torch.cat([xc, xc.new_zeros(1, din)], dim=0)
    if agg_ops is None:
        agg_ops = build_layer_agg_ops(graph)

    edge_norm = graph.norm_mode == "edge"
    out = xc @ w_root + bias[None, :]
    aggregate_first = din <= dout
    for r in range(graph.num_relations):
        op = agg_ops[r]
        if op is None:
            continue
        if edge_norm:
            # Messages are scaled by 1/deg(dst) per edge; no table.
            if aggregate_first:
                out = out + promote_matmul(agg_fn(x_pad, op)[:n], w_rel[r])
            else:
                out = out + agg_fn((x_pad @ w_rel[r]).contiguous(), op)[:n]
            continue
        inv_deg = graph.inv_in_deg[r][:n, None].to(compute_dtype)
        if aggregate_first:
            # mean_r(x) @ W_r : gather bandwidth scales with Din.
            agg = agg_fn(x_pad, op)[:n]
            out = out + promote_matmul(agg * inv_deg, w_rel[r])
        else:
            # mean_r(x @ W_r) : gather bandwidth scales with Dout.
            agg = agg_fn((x_pad @ w_rel[r]).contiguous(), op)[:n]
            out = out + agg * inv_deg
    return out.float()
