"""The card's floors for the bench modules: the least time one H100 could
take for the aggregation work kernel B1 does in a step.

The JAX package's suite and probes divide by TPU figures (a measured
gather time a row, an HBM rate); the port states its floors from the
card's published peaks instead, the way ``chip_smoke.py``'s ``bound``
does for one B1 call: each input byte read once and each output byte
written once at the HBM rate, and the call's ``2 * E * D`` float32
operations at the float32 peak, the larger of the two. A step's floor is
the sum of its B1 calls' floors.
"""

from __future__ import annotations

from typing import Dict, Optional

# NVIDIA H100 SXM (80 GB HBM3), the data sheet's figures at the full
# 700 W power limit: HBM bandwidth, and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
FLOOR_OF = ("NVIDIA H100 SXM peaks: 3.35e12 B/s HBM3, 67e12 float32 FLOP/s "
            "outside the tensor cores; each byte read or written once, "
            "2*E*D operations a B1 call, the larger time, summed over the "
            "step's B1 calls")


def b1_bound(table_rows: int, d: int, num_edges: int, num_segments: int, *,
             table_bytes: int = 4, scaled: bool = False) -> Dict:
    """The floor of one B1 call, as ``chip_smoke.bound`` counts it: a
    [table_rows, d] table read once (``table_bytes`` an element: 4
    float32, 2 bf16), ``num_edges`` int32 ids (and float32 scales when
    ``scaled``), a CSR of ``num_segments + 1`` int32 offsets, and a float32
    [num_segments, d] output written once; ``2 * num_edges * d`` float32
    operations. Returns bytes, byte_ms, op_ms, bound_ms and bound_by."""
    nbytes = (table_rows * d * table_bytes
              + (num_edges + num_segments + 1 + num_segments * d) * 4
              + (num_edges * 4 if scaled else 0))
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = 2 * num_edges * d / F32_FLOPS * 1e3
    return {"bytes": nbytes, "byte_ms": byte_ms, "op_ms": op_ms,
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations"}


def layer_widths(model_cfg):
    """Each layer's aggregation width: the narrower of its input and output
    widths (``ops/rgcn_segment.py`` aggregates first when Din <= Dout)."""
    emb, hid = model_cfg.embedding_dim, model_cfg.hidden_dim
    return [min(emb, hid), min(hid, hid)]


def step_aggregation_floor_ms(graph, model_cfg, final_plan=None, *,
                              batch_nodes: Optional[int] = None) -> float:
    """The floor of a full-graph training step's aggregation, in ms: both
    layers' B1 calls, forward over each relation bucket's padded edges and
    backward over its transpose, at the compute dtype's table width. With
    a batch-restricted ``final_plan`` the final layer gathers only the
    plan's ``sum(e_cap)`` slots, each way, into ``R * batch_nodes`` rows
    (``batch_nodes``: the batch's heads and tails)."""
    return sum(aggregation_floors_ms(graph, model_cfg, final_plan,
                                     batch_nodes=batch_nodes))


def aggregation_floors_ms(graph, model_cfg, final_plan=None, *,
                          batch_nodes: Optional[int] = None):
    """[conv1, conv2] floors of :func:`step_aggregation_floor_ms`, each
    forward and backward."""
    n = graph.num_nodes
    scaled = graph.norm_mode == "edge"
    el = 2 if model_cfg.compute_dtype == "bfloat16" else 4
    floors = []
    for layer, d in enumerate(layer_widths(model_cfg)):
        if layer == 1 and final_plan is not None:
            if batch_nodes is None:
                raise ValueError("a restricted plan's floor needs "
                                 "batch_nodes")
            segs = graph.num_relations * batch_nodes
            floors.append(2 * b1_bound(
                n + 1, d, int(sum(final_plan.e_cap)), segs,
                table_bytes=el, scaled=scaled)["bound_ms"])
            continue
        floors.append(2 * sum(
            b1_bound(n + 1, d, size, n + 1, table_bytes=el,
                     scaled=scaled)["bound_ms"]
            for size in graph.bucket_sizes() if size))
    return floors


def floor_fields(floor_ms: float, step_s: float) -> Dict:
    """``floor_ms``, ``floor_fraction`` (floor over the measured step) and
    ``floor_of`` (what the floor counts, on which card's figures)."""
    return {"floor_ms": floor_ms,
            "floor_fraction": floor_ms / (step_s * 1e3),
            "floor_of": FLOOR_OF}
