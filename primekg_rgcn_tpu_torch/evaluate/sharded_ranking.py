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
a sharded function is a loop over the shards. Across processes (a mesh
whose shards are split over a ``torch.distributed`` group) each process
holds and scores its own shards' slices, the psums and the top-K's gather
run across the processes, and every process returns the one-process
answer; every process calls each function with the same queries.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from primekg_rgcn_tpu_torch.ops.distmult import (distmult_score,
                                                 distmult_score_all_tails)
from primekg_rgcn_tpu_torch.parallel.mesh import Mesh, all_gather, psum


class Slices(NamedTuple):
    """This process's shards of the table: their global indices
    ``shards``, their [n_loc, D] slices and masks of real (< N) rows, and
    the ``mesh`` the sums run over."""

    shards: range
    tables: List[torch.Tensor]
    valid: List[torch.Tensor]
    mesh: Mesh


def _owner_masked_fetch(sl: Slices, ids: torch.Tensor) -> torch.Tensor:
    """[B] global ids -> [B, D] rows: each shard contributes the rows it
    owns (zero elsewhere), and the psum assembles the batch."""
    n_loc = sl.tables[0].shape[0]
    owner = ids // n_loc
    rows = []
    for my, table in zip(sl.shards, sl.tables):
        mine = owner == my
        r = table[torch.where(mine, ids - my * n_loc, 0)]
        rows.append(torch.where(mine[:, None], r,
                                torch.zeros((), device=r.device)))
    return psum(rows, sl.mesh)


def _shard_slices(mesh: Mesh, emb_dm: torch.Tensor, num_nodes: int
                  ) -> Slices:
    """The slices of this process's shards (``mesh.local``: all on one
    process) of the shard-major ``emb_dm``, which holds either every
    shard or, across processes, only those."""
    n_loc = emb_dm.shape[1]
    local = mesh.local
    if emb_dm.shape[0] == mesh.n_shards:
        emb_dm = emb_dm[local.start:local.stop]
    elif emb_dm.shape[0] != len(local):
        raise ValueError(f"table has {emb_dm.shape[0]} shards, mesh "
                         f"{mesh.n_shards}")
    dev = emb_dm.device
    valid = [(my * n_loc + torch.arange(n_loc, device=dev)) < num_nodes
             for my in local]
    return Slices(local, list(emb_dm.unbind(0)), valid, mesh)


def _sharded_rank(sl: Slices, head_emb: torch.Tensor, rel_vecs: torch.Tensor,
                  true_tails: torch.Tensor) -> torch.Tensor:
    """1-indexed raw ranks of ``true_tails`` from per-shard score slices."""
    n_loc = sl.tables[0].shape[0]
    owner = true_tails // n_loc
    scores = [distmult_score_all_tails(head_emb, rel_vecs, table)
              for table in sl.tables]                   # each [B, n_loc]
    picked = []
    for my, s in zip(sl.shards, scores):
        mine = owner == my
        loc = torch.where(mine, true_tails - my * n_loc, 0)
        picked.append(torch.where(mine, s.gather(1, loc[:, None])[:, 0],
                                  torch.zeros((), device=s.device)))
    true_scores = psum(picked, sl.mesh)
    better = [((s > true_scores[:, None]) & v[None, :]).sum(dim=1)
              for s, v in zip(scores, sl.valid)]
    return 1 + psum(better, sl.mesh)


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
    sl = _shard_slices(mesh, emb_pad.view(n, n_loc, d), num_nodes)
    dev = node_emb.device

    def rank(heads, rels, true_tails):
        heads, rels, true_tails = (
            torch.as_tensor(x, dtype=torch.long, device=dev)
            for x in (heads, rels, true_tails))
        return _sharded_rank(sl, node_emb[heads], rel_emb[rels], true_tails)

    return rank


def build_sharded_eval_from_sharded(mesh: Mesh, emb_dm: torch.Tensor,
                                    rel_emb: torch.Tensor, num_nodes: int):
    """Fully sharded evaluation over the shard-major [n, n_loc, D] table of
    ``build_node_sharded_forward(gather=False)``: no [N, D] table is built.
    Across processes ``emb_dm`` is this process's shards' [k, n_loc, D].

    Returns ``(rank, score)``:
      rank(heads, rels, true_tails) -> int64[B] 1-indexed raw ranks;
      score(heads, tails, rels) -> float32[B] DistMult logits. (The JAX
        scorer psums the n identical replicated copies and divides by n;
        here the fetch returns the assembled rows once, so the logits are
        the triple scorer's, equal to that quotient within rounding.)
    """
    sl = _shard_slices(mesh, emb_dm, num_nodes)
    dev = emb_dm.device

    def ids(x):
        return torch.as_tensor(x, dtype=torch.long, device=dev)

    def rank(heads, rels, true_tails):
        head_emb = _owner_masked_fetch(sl, ids(heads))
        return _sharded_rank(sl, head_emb, rel_emb[ids(rels)],
                             ids(true_tails))

    def score(heads, tails, rels):
        return distmult_score(_owner_masked_fetch(sl, ids(heads)),
                              _owner_masked_fetch(sl, ids(tails)),
                              rel_emb[ids(rels)])

    return rank, score


def build_sharded_topk(mesh: Mesh, emb_dm: torch.Tensor,
                       rel_emb: torch.Tensor, num_nodes: int, k: int):
    """Distributed top-K tail retrieval: ``topk(heads, rels) -> (scores
    [B, K], tail_ids [B, K])``.

    ``emb_dm`` is the shard-major [n, n_loc, D] encoder output
    (``build_node_sharded_forward(gather=False)``; across processes this
    process's shards', [k, n_loc, D]). Padded tail rows score -inf.
    Winners are exact by score; among equal scores the order may differ
    from a dense top-K's. Across processes the n K candidates are gathered
    from every process, and each returns the whole answer.
    """
    n_loc = emb_dm.shape[1]
    if k > n_loc:
        raise ValueError(f"k={k} exceeds per-shard slice {n_loc}")
    sl = _shard_slices(mesh, emb_dm, num_nodes)
    dev = emb_dm.device

    def topk(heads, rels):
        heads = torch.as_tensor(heads, dtype=torch.long, device=dev)
        rels = torch.as_tensor(rels, dtype=torch.long, device=dev)
        q = _owner_masked_fetch(sl, heads) * rel_emb[rels]
        s_parts, i_parts = [], []
        for my, table, v in zip(sl.shards, sl.tables, sl.valid):
            scores = torch.where(v[None, :], q @ table.T,
                                 torch.full((), -torch.inf, device=dev))
            s_k, i_k = torch.topk(scores, k, dim=1)  # [B, K] local winners
            s_parts.append(s_k)
            i_parts.append(i_k + my * n_loc)
        b = q.shape[0]
        s_flat = all_gather(s_parts, mesh=mesh).transpose(0, 1).reshape(b, -1)
        i_flat = all_gather(i_parts, mesh=mesh).transpose(0, 1).reshape(b, -1)
        s_top, pos = torch.topk(s_flat, k, dim=1)
        return s_top, torch.gather(i_flat, 1, pos)

    return topk
