"""Entity-sharded top-K retrieval over a node-sharded embedding table.

The counterpart of ``build_sharded_topk`` (and the owner-masked fetch it
uses) in ``primekg_rgcn_tpu/evaluate/sharded_ranking.py``: each shard scores
the queries against its own [n_loc, D] slice, keeps its K best, and a final
top-K over the n * K gathered candidates picks the global winners (top-K is
distributive over partitions), so no [B, N] score row is ever built. The
ranker and evaluator of that module are not ported yet (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from primekg_rgcn_tpu_torch.parallel.mesh import Mesh, all_gather, psum


def _owner_masked_fetch(locals_: Sequence[torch.Tensor], ids: torch.Tensor,
                        n_loc: int) -> torch.Tensor:
    """[B] global ids -> [B, D] rows: each shard contributes the rows it
    owns (zero elsewhere), and the psum assembles the batch."""
    owner = ids // n_loc
    rows = []
    for my, local in enumerate(locals_):
        mine = owner == my
        r = local[torch.where(mine, ids - my * n_loc, 0)]
        rows.append(torch.where(mine[:, None], r,
                                torch.zeros((), device=r.device)))
    return psum(rows)


def build_sharded_topk(mesh: Mesh, emb_dm: torch.Tensor,
                       rel_emb: torch.Tensor, num_nodes: int, k: int):
    """Distributed top-K tail retrieval: ``topk(heads, rels) -> (scores
    [B, K], tail_ids [B, K])``.

    ``emb_dm`` is the shard-major [n, n_loc, D] encoder output
    (``build_node_sharded_forward(gather=False)``). Padded tail rows score
    -inf. Winners are exact by score; among equal scores the order may
    differ from a dense top-K's.
    """
    n, n_loc, _ = emb_dm.shape
    if n != mesh.n_shards:
        raise ValueError(f"table has {n} shards, mesh {mesh.n_shards}")
    if k > n_loc:
        raise ValueError(f"k={k} exceeds per-shard slice {n_loc}")
    locals_ = list(emb_dm.unbind(0))
    dev = emb_dm.device
    valid = [(my * n_loc + torch.arange(n_loc, device=dev)) < num_nodes
             for my in range(n)]

    def topk(heads, rels):
        heads = torch.as_tensor(heads, dtype=torch.long, device=dev)
        rels = torch.as_tensor(rels, dtype=torch.long, device=dev)
        q = _owner_masked_fetch(locals_, heads, n_loc) * rel_emb[rels]
        s_parts, i_parts = [], []
        for my, local in enumerate(locals_):
            scores = torch.where(valid[my][None, :], q @ local.T,
                                 torch.full((), -torch.inf, device=dev))
            s_k, i_k = torch.topk(scores, k, dim=1)  # [B, K] local winners
            s_parts.append(s_k)
            i_parts.append(i_k + my * n_loc)
        b = q.shape[0]
        s_flat = all_gather(s_parts).transpose(0, 1).reshape(b, -1)
        i_flat = all_gather(i_parts).transpose(0, 1).reshape(b, -1)
        s_top, pos = torch.topk(s_flat, k, dim=1)
        return s_top, torch.gather(i_flat, 1, pos)

    return topk
