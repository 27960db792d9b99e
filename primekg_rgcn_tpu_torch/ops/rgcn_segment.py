"""Relation-typed graph convolution over the relation-bucketed graph, with
one fused gather + sorted segment-sum per relation bucket (the CUDA kernel
in ``ops/cuda/segment_sum.py``, or its plain version on the CPU).

- **Aggregation order picked per layer.** mean_r(X) @ W_r == mean_r(X @ W_r)
  (the mean is linear), so the layer aggregates in the narrower of Din and
  Dout: both serving layers (64 -> 128, 128 -> 128) aggregate first.
- **Sentinel padding.** Padding edges gather the all-zero dummy row N and
  land in the dummy output row, which is dropped.
- **Mean normalisation.** Dense mode multiplies the aggregate by the
  ``1/in-degree`` table after the sum; edge mode passes the per-edge scale
  into the kernel, which multiplies each gathered row.

Forward only: the transpose-graph backward is still to port, so the CUDA
wrapper refuses inputs that require a gradient.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from primekg_rgcn_tpu_torch.data.graph import RelGraph
from primekg_rgcn_tpu_torch.ops.cuda.segment_sum import gather_segment_sum


class AggOp(NamedTuple):
    """One relation bucket's operands for ``gather_segment_sum``."""

    src: torch.Tensor               # int32[E_b], destination order
    rowptr: torch.Tensor            # int32[N+2], CSR over N+1 rows
    scale: Optional[torch.Tensor]   # float32[E_b] in edge mode, else None


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
        ops.append(AggOp(src=graph.src[s:e], rowptr=graph.rowptr[r],
                         scale=graph.edge_scale[s:e] if edge_norm else None))
    return ops


def rgcn_layer_segment(
    layer_params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    graph: RelGraph,
    *,
    agg_ops: Optional[List[Optional[AggOp]]] = None,
    agg_fn=gather_segment_sum,
) -> torch.Tensor:
    """Relation-typed mean-aggregated graph convolution over a RelGraph.

    Args:
        layer_params: see ``ops/rgcn_dense.py`` for the schema.
        x: float32 [N, Din] node features (without the dummy row), on the
            graph's device.
        graph: relation-bucketed graph.
        agg_ops: optional prebuilt operands from :func:`build_layer_agg_ops`.
        agg_fn: the per-bucket gather + segment-sum; the default launches the
            CUDA kernel on a CUDA tensor.

    Returns:
        float32 [N, Dout] updated node features.
    """
    n = graph.num_nodes
    w_rel = materialize_relation_weights(layer_params)
    din, dout = w_rel.shape[1], w_rel.shape[2]
    # Dummy row n is zero: sentinel edges contribute nothing.
    x_pad = torch.cat([x, x.new_zeros(1, din)], dim=0)
    if agg_ops is None:
        agg_ops = build_layer_agg_ops(graph)

    edge_norm = graph.norm_mode == "edge"
    out = x @ layer_params["w_root"] + layer_params["bias"][None, :]
    aggregate_first = din <= dout
    for r in range(graph.num_relations):
        op = agg_ops[r]
        if op is None:
            continue
        if edge_norm:
            # Messages are scaled by 1/deg(dst) per edge; no table.
            if aggregate_first:
                out = out + agg_fn(x_pad, op.src, op.rowptr, op.scale)[:n] @ w_rel[r]
            else:
                out = out + agg_fn((x_pad @ w_rel[r]).contiguous(), op.src,
                                   op.rowptr, op.scale)[:n]
            continue
        inv_deg = graph.inv_in_deg[r][:n, None]
        if aggregate_first:
            # mean_r(x) @ W_r : gather bandwidth scales with Din.
            agg = agg_fn(x_pad, op.src, op.rowptr, None)[:n]
            out = out + (agg * inv_deg) @ w_rel[r]
        else:
            # mean_r(x @ W_r) : gather bandwidth scales with Dout.
            agg = agg_fn((x_pad @ w_rel[r]).contiguous(), op.src, op.rowptr,
                         None)[:n]
            out = out + agg * inv_deg
    return out
