"""Dense oracle for the relation-typed graph convolution:

    h_i' = W_root h_i + b + sum_r (1/|N_r(i)|) * sum_{j in N_r(i)} W_r h_j

where N_r(i) are the in-neighbours of i under relation r, the mean is per
relation, and a node with no in-edges under r receives zero from it. With
basis decomposition, W_r = sum_b a_{rb} V_b.

Only for small graphs: it builds R dense [N, N] adjacencies.
"""

from __future__ import annotations

from typing import Dict

import torch

from primekg_rgcn_tpu_torch.ops.rgcn_segment import materialize_relation_weights


def rgcn_layer_dense(
    layer_params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    rel: torch.Tensor,
    num_nodes: int,
    num_relations: int,
) -> torch.Tensor:
    """Dense-oracle relation-typed graph convolution.

    Args:
        layer_params: {"w_rel": [R, Din, Dout]} or
            {"basis": [B, Din, Dout], "coef": [R, B]}, plus
            "w_root": [Din, Dout], "bias": [Dout].
        x: [N, Din] node features.
        src / dst / rel: int[E] COO edges (no padding; messages flow src->dst).
    """
    w_rel = materialize_relation_weights(layer_params)
    n = num_nodes
    src, dst, rel = src.long(), dst.long(), rel.long()
    out = x @ layer_params["w_root"] + layer_params["bias"][None, :]
    for r in range(num_relations):
        # Dense adjacency A[i, j] = number of edges j->i under relation r.
        a = torch.zeros(n, n, dtype=x.dtype, device=x.device)
        a.index_put_((dst, src), (rel == r).to(x.dtype), accumulate=True)
        deg = a.sum(dim=1, keepdim=True)
        a = torch.where(deg > 0, a / deg.clamp(min=1.0), torch.zeros_like(a))
        out = out + a @ (x @ w_rel[r])
    return out
