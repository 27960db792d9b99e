"""Entity-sharded ranking, scoring and top-K over a sharded embedding table.

The counterpart of ``primekg_rgcn_tpu/evaluate/sharded_ranking.py``. Each
shard scores the queries against its own [n_loc, D] slice of the entity
table, so no [B, N] score row is ever built whole:

- ranking: the true tail's score comes from its owner through a psum, and
  the rank is 1 + the psum of each shard's count of strictly higher
  scores, the semantics of ``metrics.ranks_of_true_tails``. Padding rows
  (global id >= N) are masked out of the count; scoring them -inf instead
  would give NaN (sum(hr * -inf) is NaN on mixed signs).
- top-K: each shard keeps its K best and a final top-K over the n * K
  gathered candidates picks the global winners (top-K is distributive over
  partitions).

Query endpoints are fetched from the shard-major table by owner-masked
psums. All shards of a mesh live on its one device (``parallel/mesh.py``):
a sharded function is a loop over the shards.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from primekg_rgcn_tpu_torch.ops.distmult import (distmult_score,
                                                 distmult_score_all_tails)
from primekg_rgcn_tpu_torch.parallel.mesh import (Mesh, all_gather, psum,
                                                  refuse_across_processes)


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


def _shard_slices(mesh: Mesh, emb_dm: torch.Tensor, num_nodes: int):
    """The shards' [n_loc, D] slices and their masks of real (< N) rows."""
    refuse_across_processes(mesh, "the sharded evaluator")
    n, n_loc, _ = emb_dm.shape
    if n != mesh.n_shards:
        raise ValueError(f"table has {n} shards, mesh {mesh.n_shards}")
    dev = emb_dm.device
    valid = [(my * n_loc + torch.arange(n_loc, device=dev)) < num_nodes
             for my in range(n)]
    return list(emb_dm.unbind(0)), valid


def _sharded_rank(locals_: List[torch.Tensor], valid: List[torch.Tensor],
                  head_emb: torch.Tensor, rel_vecs: torch.Tensor,
                  true_tails: torch.Tensor) -> torch.Tensor:
    """1-indexed raw ranks of ``true_tails`` from per-shard score slices."""
    n_loc = locals_[0].shape[0]
    owner = true_tails // n_loc
    scores = [distmult_score_all_tails(head_emb, rel_vecs, local)
              for local in locals_]                     # each [B, n_loc]
    picked = []
    for my, s in enumerate(scores):
        mine = owner == my
        loc = torch.where(mine, true_tails - my * n_loc, 0)
        picked.append(torch.where(mine, s.gather(1, loc[:, None])[:, 0],
                                  torch.zeros((), device=s.device)))
    true_scores = psum(picked)
    better = [((s > true_scores[:, None]) & valid[my][None, :]).sum(dim=1)
              for my, s in enumerate(scores)]
    return 1 + psum(better)


def build_sharded_ranker(mesh: Mesh, node_emb: torch.Tensor,
                         rel_emb: torch.Tensor):
    """``rank(heads, rels, true_tails) -> int64[B]`` 1-indexed raw ranks,
    with the [N, D] encoder output split into the mesh's shards (zero
    padding rows, masked out of the count)."""
    n = mesh.n_shards
    num_nodes, d = node_emb.shape
    n_loc = -(-num_nodes // n)
    pad = n * n_loc - num_nodes
    emb_pad = (torch.cat([node_emb, node_emb.new_zeros(pad, d)])
               if pad else node_emb)
    locals_, valid = _shard_slices(mesh, emb_pad.view(n, n_loc, d), num_nodes)
    dev = node_emb.device

    def rank(heads, rels, true_tails):
        heads, rels, true_tails = (
            torch.as_tensor(x, dtype=torch.long, device=dev)
            for x in (heads, rels, true_tails))
        return _sharded_rank(locals_, valid, node_emb[heads], rel_emb[rels],
                             true_tails)

    return rank


def build_sharded_eval_from_sharded(mesh: Mesh, emb_dm: torch.Tensor,
                                    rel_emb: torch.Tensor, num_nodes: int):
    """Fully sharded evaluation over the shard-major [n, n_loc, D] table of
    ``build_node_sharded_forward(gather=False)``: no [N, D] table is built.

    Returns ``(rank, score)``:
      rank(heads, rels, true_tails) -> int64[B] 1-indexed raw ranks;
      score(heads, tails, rels) -> float32[B] DistMult logits. (The JAX
        scorer psums the n identical replicated copies and divides by n;
        here the fetch returns the assembled rows once, so the logits are
        the triple scorer's, equal to that quotient within rounding.)
    """
    n_loc = emb_dm.shape[1]
    locals_, valid = _shard_slices(mesh, emb_dm, num_nodes)
    dev = emb_dm.device

    def ids(x):
        return torch.as_tensor(x, dtype=torch.long, device=dev)

    def rank(heads, rels, true_tails):
        head_emb = _owner_masked_fetch(locals_, ids(heads), n_loc)
        return _sharded_rank(locals_, valid, head_emb, rel_emb[ids(rels)],
                             ids(true_tails))

    def score(heads, tails, rels):
        return distmult_score(_owner_masked_fetch(locals_, ids(heads), n_loc),
                              _owner_masked_fetch(locals_, ids(tails), n_loc),
                              rel_emb[ids(rels)])

    return rank, score


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
    if k > n_loc:
        raise ValueError(f"k={k} exceeds per-shard slice {n_loc}")
    locals_, valid = _shard_slices(mesh, emb_dm, num_nodes)
    dev = emb_dm.device

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
