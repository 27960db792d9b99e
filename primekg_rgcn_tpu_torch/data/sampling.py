"""Mini-batch neighbor sampling for large-graph training.

The counterpart of ``primekg_rgcn_tpu/data/sampling.py``; its docstring
gives the reasoning, which holds here unchanged:

- Host side, once per graph: the per-relation CSR (``build_csr_cache``) and
  the merged (dst, rel)-sorted CSR (``build_combined_csr``) in its fat,
  slim packed, slim unpacked and granule-pairs layouts, every array equal
  bit for bit to the JAX package's. The pairs form is a view of the packed
  record table here, so block mode may read either form.
- Device side, every step: static-capacity frontier dedup that keeps its
  sort (``_sorted_unique``; stable sort, ``is_new``, cumsum, scatter into a
  ``cap``-sized table filled with N, never a ``torch.unique`` whose
  data-dependent size would read back to the host), the per-relation
  layout (``sample_batch``) and the combined layout
  (``sample_batch_combined``: truncate, uniform, block and blockN, and the
  identity regime of a near-saturated innermost layer).
- Gradients as ``torch.autograd.Function``s where the JAX package has a
  ``custom_vjp``: ``DedupGather``, ``TableGatherSorted`` and
  ``IdentPickGather``, whose backwards gather the cotangent rows into id
  order and sum them with kernel B2 (``ops/cuda/dense_segment_sum``) on
  the card, deterministically.
- Block mode over a slim packed CSR fetches each node's window of records
  with kernel B3 (``ops/cuda/window_fetch``) on the card and with its plain
  version on the CPU.
- The combined layer's per-(node, relation) reduction, picked by
  ``PRIMEKG_COMBINED_AGG`` as in the JAX package: the one-hot einsum
  (default), ``rowwise`` (``RowwiseRelSum``: cumsum, a row gather at each
  relation's end, difference) or anything else, ``chunked``
  (``ChunkedRelApply``: the same sums and the relation transforms over node
  chunks, with a manual backward that keeps no full-size residual). The two
  need each row's slots in ascending tag order, so the sampler sorts uniform
  and blockN rows for them.

Randomness comes from one injectable source: every function that samples
takes ``draw(shape) -> float32 uniforms in [0, 1)``, called in the JAX
package's key order (per layer, outermost first; per relation within a
per-relation layer), so a test can hand the port the JAX draws.
``uniform_draw`` makes one from a ``torch.Generator``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from primekg_rgcn_tpu_torch.data.graph import RelGraph, edge_arrays_from_graph
from primekg_rgcn_tpu_torch.ops.cuda.dense_segment_sum import (
    dense_sorted_segment_sum, dense_sorted_segment_sum_plain)
from primekg_rgcn_tpu_torch.ops.cuda.window_fetch import (GRANULE,
                                                          window_rows_fetch)
from primekg_rgcn_tpu_torch.ops.rgcn_segment import (
    materialize_relation_weights, promote_matmul)

Draw = Callable[[Tuple[int, ...]], torch.Tensor]


def uniform_draw(generator: torch.Generator, device) -> Draw:
    """``draw(shape)``: float32 uniforms in [0, 1) from ``generator`` on
    ``device``."""
    return lambda shape: torch.rand(shape, generator=generator,
                                    device=device)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[idx]`` with indices clamped into range (the caller masks the
    slots whose index was out of range, as JAX's clamped takes do)."""
    if a.shape[0] == 0:
        return torch.zeros(idx.shape, dtype=a.dtype, device=a.device)
    return a[idx.clamp(0, a.shape[0] - 1).long()]


# -- per-relation CSR ---------------------------------------------------------


@dataclass(frozen=True)
class CsrCache:
    """Per-relation CSR over destination nodes.

    ``row_start[r][v]``, ``row_count[r][v]``: the slice of ``col[r]``
    holding v's in-neighbours; ``col[r]``: the relation bucket's src ids
    (dst-sorted, padded). Row ``num_nodes`` (sentinel) has count 0.
    """

    row_start: Tuple[torch.Tensor, ...]
    row_count: Tuple[torch.Tensor, ...]
    col: Tuple[torch.Tensor, ...]
    num_nodes: int
    num_relations: int

    def to(self, device) -> "CsrCache":
        def move(ts):
            return tuple(t.to(device) for t in ts)

        return replace(self, row_start=move(self.row_start),
                       row_count=move(self.row_count), col=move(self.col))


def build_csr_cache(graph: RelGraph) -> CsrCache:
    """Host-side, once per graph: CSR row tables from the sorted buckets."""
    starts, counts, cols = [], [], []
    dst_h = graph.dst.cpu().numpy()
    src = graph.src.cpu()
    n = graph.num_nodes
    for r in range(graph.num_relations):
        s, e = graph.bucket_slice(r)
        bucket = dst_h[s:e]
        row_start = np.searchsorted(bucket, np.arange(n + 1)).astype(np.int32)
        row_count = np.zeros(n + 1, np.int32)
        row_count[:n] = (np.searchsorted(bucket, np.arange(1, n + 1))
                         - row_start[:n])
        starts.append(torch.from_numpy(row_start))
        counts.append(torch.from_numpy(row_count))
        cols.append(src[s:e].clone())
    return CsrCache(tuple(starts), tuple(counts), tuple(cols), n,
                    graph.num_relations)


# -- sampled blocks -----------------------------------------------------------


class SampledBlock(NamedTuple):
    """One message-passing layer over a sampled bipartite block
    (per-relation layout); fields as in the JAX package: ``src_local``
    int32 [R, M, f] rows of the deduped input table, ``self_idx`` [M],
    ``out_ids`` [M] global ids (sentinel = N), ``inv_cnt`` float32 [R, M],
    ``sort_perm``/``sort_uid`` the dedup's sort, ``m_out``/``m_in``."""

    src_local: torch.Tensor
    self_idx: torch.Tensor
    out_ids: torch.Tensor
    inv_cnt: torch.Tensor
    sort_perm: torch.Tensor
    sort_uid: torch.Tensor
    m_out: int
    m_in: int


class CombinedBlock(NamedTuple):
    """One sampled layer in the combined layout: ``src_local`` int32
    [M, F], ``rel_tag`` int32 [M, F], ``slot_w`` float32 [M, F] importance
    weights (0 on invalid slots), the rest as in :class:`SampledBlock`.
    ``ident`` marks a near-saturated innermost block whose ids are global
    node ids into the embedding table (``m_in == num_nodes``); its
    ``sort_uid`` holds the sorted raw ids."""

    src_local: torch.Tensor
    rel_tag: torch.Tensor
    slot_w: torch.Tensor
    self_idx: torch.Tensor
    out_ids: torch.Tensor
    sort_perm: torch.Tensor
    sort_uid: torch.Tensor
    m_out: int
    m_in: int
    ident: bool = False
    tags_sorted: bool = True


class SampledBatch(NamedTuple):
    """Input to a sampled encoder pass: ``frontier`` int32 [M0] deduped
    global ids feeding the embedding table (None when the innermost block
    is identity), ``blocks`` innermost first, ``seed_gather`` int32
    [num_seeds] rows of the top table holding each seed, in seed order."""

    frontier: Optional[torch.Tensor]
    blocks: Tuple
    seed_gather: torch.Tensor


def _unique_cap(raw_len: int, num_nodes: int) -> int:
    """Static dedup capacity: distinct ids can't exceed N+1 (incl sentinel)."""
    return min(_round_up(raw_len, 64), _round_up(num_nodes + 1, 64))


def _compact_unique(raw: torch.Tensor, cap: int, n: int):
    """Sorted distinct ids of ``raw`` in a ``cap``-sized table filled with
    ``n``: (uniq [cap], inv [L], perm [L], uid [L]), ``perm`` the stable
    argsort and ``uid`` each sorted element's dense rank, with no host
    synchronise (``jnp.unique(size=cap, fill_value=n)`` plus its sort)."""
    perm = torch.argsort(raw, stable=True)
    srt = raw[perm]
    is_new = torch.ones_like(srt, dtype=torch.bool)
    is_new[1:] = srt[1:] != srt[:-1]
    uid = (torch.cumsum(is_new, 0) - 1).to(torch.int32)
    uniq = torch.full((cap,), n, dtype=raw.dtype, device=raw.device)
    uniq.scatter_(0, uid.long(), srt)
    inv = torch.empty_like(uid).scatter_(0, perm, uid)
    return uniq, inv, perm.to(torch.int32), uid


def _sorted_unique(raw: torch.Tensor, cap: int, n: int):
    """:func:`_compact_unique`, except for a SATURATED frontier (raw slots
    >= N+1 at the capacity ceiling), whose table is the identity over the
    node space: ``inv`` is raw itself and ``uid`` the sorted ids."""
    if cap >= _round_up(n + 1, 64) and int(raw.shape[0]) >= n + 1:
        perm = torch.argsort(raw, stable=True)
        uniq = torch.arange(cap, device=raw.device).clamp(max=n).to(raw.dtype)
        return uniq, raw, perm.to(torch.int32), raw[perm].to(torch.int32)
    return _compact_unique(raw, cap, n)


def _unique_seeds(seeds: torch.Tensor, n: int):
    """(frontier, seed_gather): the seeds' sorted distinct ids, padded with
    n, and each seed's row in it."""
    seeds = seeds.to(torch.int32)
    cap0 = _unique_cap(int(seeds.shape[0]), n)
    uniq, inv, _, _ = _compact_unique(seeds, cap0, n)
    return uniq, inv


# -- gathers with sorted backwards ---------------------------------------------


def _sorted_accumulate(gp: torch.Tensor, ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Sorted segment-sum of the dedup and table-gather backwards (and of
    zero3's row fetch, ``train/sampled.ShardedRowFetch``); ``ids`` are
    int32, sorted and inside [0, num_segments). Sums in float32 and
    returns gp's dtype.

    On the card this is :func:`dense_sorted_segment_sum`, kernel B2, at
    every size: deterministic, no float atomics, and faster than
    ``index_add_`` on these streams, whose in-range fill run B2 splits
    across warps (``PERF.md`` §6). The JAX package sends only targets of
    2^18 rows or more to its dense kernel, a TPU scatter-cost crossover;
    below that it sums bf16 cotangents in bf16 (XLA's ``segment_sum``),
    where the port sums in float32. On the CPU it is B2's plain version,
    ``index_add_`` in float32.
    """
    if gp.device.type == "cpu":
        return dense_sorted_segment_sum_plain(gp, ids, num_segments).to(
            gp.dtype)
    return dense_sorted_segment_sum(gp.contiguous(), ids,
                                    num_segments).to(gp.dtype)


class DedupGather(torch.autograd.Function):
    """``x[inv]`` whose backward is a sorted segment-sum: the cotangents
    reordered by ``perm`` arrive grouped by their row ``uid``
    (``dedup_gather`` in the JAX package)."""

    @staticmethod
    def forward(ctx, x, inv, perm, uid):
        ctx.save_for_backward(perm, uid)
        ctx.m_in = x.shape[0]
        return x[inv.long()]

    @staticmethod
    def backward(ctx, g):
        perm, uid = ctx.saved_tensors
        return (_sorted_accumulate(g[perm.long()], uid, ctx.m_in), None,
                None, None)


class TableGatherSorted(torch.autograd.Function):
    """``table[ids]`` for sorted ids, whose backward is one sorted
    segment-sum into the table (``table_gather_sorted``)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table[ids.long()]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return _sorted_accumulate(g.contiguous(), ids, ctx.rows), None


class IdentPickGather(torch.autograd.Function):
    """``table[ids]`` for global node ids, the sentinel N giving a zero row
    (``_ident_pick_gather``), converted to ``out_dtype`` when one is given
    (bf16 compute: gather, then convert; never the whole table). (perm,
    srt) are the argsort of ids and the sorted ids: the backward gathers the
    cotangent rows (``out_dtype``) into id order and sums them in float32
    with :func:`dense_sorted_segment_sum` (kernel B2 on the card), whose
    sentinel run drops, into a gradient of the table's dtype."""

    @staticmethod
    def forward(ctx, table, ids, perm, srt, out_dtype=None):
        ctx.save_for_backward(perm, srt)
        n = table.shape[0]
        ctx.rows = n
        ctx.dtype = table.dtype
        rows = table[ids.clamp(max=n - 1).long()]
        rows = rows.masked_fill((ids >= n)[:, None], 0.0)
        return rows if out_dtype is None else rows.to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        perm, srt = ctx.saved_tensors
        dt = dense_sorted_segment_sum(g[perm.long()], srt, ctx.rows)
        return dt.to(ctx.dtype), None, None, None, None


# -- per-relation layout -------------------------------------------------------


def _sample_layer(draw: Draw, csr: CsrCache, frontier: torch.Tensor,
                  fanout: int, mode: str):
    """Expand one layer: (new_frontier (deduped), block)."""
    m = frontier.shape[0]
    n = csr.num_nodes
    r_count = csr.num_relations
    fl = frontier.long()
    dev = frontier.device
    picks_flat, inv_cnt = [], []
    for r in range(r_count):
        start = csr.row_start[r][fl]
        count = csr.row_count[r][fl]
        if mode == "uniform":
            u = draw((m, fanout))
            idx = torch.floor(u * count[:, None]).to(torch.int32)
            valid = (count > 0)[:, None].expand(m, fanout)
            n_valid = torch.where(count > 0, fanout, 0)
        else:  # truncate: first min(deg, f) neighbours
            idx = torch.arange(fanout, dtype=torch.int32,
                               device=dev).expand(m, fanout)
            valid = idx < count[:, None]
            n_valid = count.clamp(max=fanout)
        pos = start[:, None] + torch.minimum(
            idx, (count[:, None] - 1).clamp(min=0))
        picks = torch.where(valid, _take(csr.col[r], pos), n)
        picks_flat.append(picks.reshape(-1))
        inv_cnt.append(torch.where(n_valid > 0, 1.0 / n_valid, 0.0))

    raw = torch.cat([frontier] + picks_flat)
    cap = _unique_cap(int(raw.shape[0]), n)
    uniq, inv, perm, uid = _sorted_unique(raw, cap, n)
    block = SampledBlock(
        src_local=inv[m:].reshape(r_count, m, fanout), self_idx=inv[:m],
        out_ids=frontier, inv_cnt=torch.stack(inv_cnt),
        sort_perm=perm, sort_uid=uid, m_out=m, m_in=cap)
    return uniq, block


def sample_batch(draw: Draw, csr: CsrCache, seeds: torch.Tensor,
                 fanouts: Sequence[int], *, mode: str = "uniform"
                 ) -> SampledBatch:
    """Sample an L-layer computation block for ``seeds``; ``fanouts`` are
    per relation, outermost first (e.g. [15, 10])."""
    if mode not in ("uniform", "truncate"):
        raise ValueError(
            f"per-relation layout supports mode 'uniform' or 'truncate', "
            f"got {mode!r} ('block' needs the combined layout — its "
            f"contiguous windows ride the merged CSR)")
    frontier, seed_gather = _unique_seeds(seeds, csr.num_nodes)
    blocks: List[SampledBlock] = []
    for f in fanouts:
        frontier, block = _sample_layer(draw, csr, frontier, int(f), mode)
        blocks.append(block)
    return SampledBatch(frontier=frontier, blocks=tuple(reversed(blocks)),
                        seed_gather=seed_gather)


def block_aggregate(layer_params, x_in: torch.Tensor, block,
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """One RGCN layer over a sampled block: x_in [M_in, Din] deduped
    input-table features (sentinel rows zero), or the raw [N, Din]
    embedding table for an identity block, whose gathered rows are then
    converted to ``compute_dtype``. Returns [M_out, Dout].

    The weights take x_in's dtype (the combined layout: ``compute_dtype``
    when given), as in the JAX package; under bf16 the per-relation
    layout's mean times its float32 ``inv_cnt`` promotes to float32, so
    its output is float32 and the next layer runs in float32, and the
    combined layout stays bf16 throughout."""
    if isinstance(block, CombinedBlock):
        return _block_aggregate_combined(layer_params, x_in, block,
                                         compute_dtype)
    w_rel = materialize_relation_weights(layer_params).to(x_in.dtype)
    w_root = layer_params["w_root"].to(x_in.dtype)
    bias = layer_params["bias"].to(x_in.dtype)
    r_count, m, fanout = block.src_local.shape
    # One dedup gather over the whole raw id stream, so the backward is a
    # single sorted segment-sum.
    inv_all = torch.cat([block.self_idx, block.src_local.reshape(-1)])
    rows = DedupGather.apply(x_in, inv_all, block.sort_perm, block.sort_uid)
    out = rows[:m] @ w_root + bias[None, :]
    for r in range(r_count):
        nbr = rows[m + r * m * fanout: m + (r + 1) * m * fanout]
        nbr = nbr.reshape(m, fanout, x_in.shape[1])
        mean = nbr.sum(dim=1) * block.inv_cnt[r][:, None]
        out = out + promote_matmul(mean, w_rel[r])
    return out


# -- combined layout -----------------------------------------------------------


@dataclass(frozen=True)
class CombinedCsr:
    """(dst, rel)-sorted merged CSR with degree annotations, in one of the
    JAX package's layouts:

    - fat: ``rel`` int32 [E], ``deg_rel_flat`` float16 [(N+1) * R] (the
      (node, rel) in-degree, node-major), ``edge_deg`` and ``packed`` empty;
    - slim packed: ``packed`` int32 [Ep, 2] records (src id,
      ``rel << 16 | float16 bits`` of the edge's (dst, rel) in-degree) with
      ``_window_pad(E)`` sentinel records appended, or its granule-pairs
      view [Ep / 64, 128]; ``col`` and ``rel`` empty;
    - slim unpacked (R > 32767 or a float16-overflowing run): ``col``,
      ``rel`` (int8 when R <= 127) and ``edge_deg`` per edge.

    ``row_start`` int32 [N+2] (row N the empty sentinel row), ``deg_total``
    int32 [N+1].
    """

    row_start: torch.Tensor
    col: torch.Tensor
    rel: torch.Tensor
    edge_deg: torch.Tensor
    deg_total: torch.Tensor
    num_nodes: int
    num_relations: int
    avg_present_relations: float
    deg_rel_flat: torch.Tensor
    packed: torch.Tensor

    def to(self, device) -> "CombinedCsr":
        names = ("row_start", "col", "rel", "edge_deg", "deg_total",
                 "deg_rel_flat", "packed")
        return replace(self, **{k: getattr(self, k).to(device)
                                for k in names})


# The fat [(N+1) * R] degree table is kept below this size.
SLIM_TABLE_BYTES = 128 * 2**20


def _window_pad(e: int) -> int:
    """Sentinel records appended to the packed table: >= 128 so a window of
    up to 64 records may start at any real record (or at E) and stay inside
    the table, plus filler to a whole number of 64-record granules."""
    return 128 + (-e) % 64


def packed_is_pairs(packed: Optional[torch.Tensor]) -> bool:
    """True when a packed record table is in granule-pairs form
    (int32 [G, 128])."""
    return (packed is not None and packed.dim() == 2
            and packed.shape[1] == 2 * GRANULE)


def csr_to_pairs_form(ccsr: CombinedCsr) -> CombinedCsr:
    """The CSR with its packed table in granule-pairs form: a view of the
    same bytes, on any device. No-op for fat, unpacked or pairs CSRs."""
    p = ccsr.packed
    if not p.shape[0] or packed_is_pairs(p):
        return ccsr
    return replace(ccsr, packed=p.view(-1, 2 * GRANULE))


def build_combined_csr(graph: RelGraph, *, slim: Optional[bool] = None,
                       window_pairs: bool = False) -> CombinedCsr:
    """Host-side, once per graph: the merged (dst, rel)-sorted CSR.

    ``slim`` picks the degree layout (see :class:`CombinedCsr`); ``None``
    picks slim only when the fat table would exceed ``SLIM_TABLE_BYTES``.
    ``window_pairs`` returns the packed table in granule-pairs form.
    """
    src, dst, rel = edge_arrays_from_graph(graph)
    n, r_count = graph.num_nodes, graph.num_relations
    if slim is None:
        slim = (n + 1) * r_count * 2 > SLIM_TABLE_BYTES
    order = np.lexsort((rel, dst))
    col = src[order].astype(np.int32)
    rel_s = rel[order].astype(np.int32)
    d = dst[order]
    row_start = np.searchsorted(d, np.arange(n + 2)).astype(np.int32)
    deg_total = np.diff(row_start).astype(np.int32)
    # Per-edge (dst, rel) degree from run lengths. float16 is exact below
    # 2048 and overflows beyond 65504, so runs of 60,000 or more keep
    # float32.
    e = d.shape[0]
    edge_deg = np.zeros(0, np.float16)
    deg_rel_flat = np.zeros(0, np.float16)
    packed = np.zeros((0, 2), np.int32)
    if e:
        key64 = d.astype(np.int64) * r_count + rel_s
        starts = np.concatenate(
            [[0], np.flatnonzero(np.diff(key64)) + 1, [e]])
        lens = np.diff(starts)
        deg_dtype = np.float16 if lens.max() < 60000 else np.float32
        if slim:
            deg_edge = np.repeat(lens, lens).astype(deg_dtype)
            if r_count <= 32767 and deg_dtype == np.float16:
                meta = ((rel_s.astype(np.int32) << 16)
                        | deg_edge.view(np.uint16).astype(np.int32))
                packed = np.stack([col, meta], axis=1)
                # Sentinel records (src = the sentinel node, last relation,
                # degree 0, so weight 0) absorb window over-reads.
                pad = np.empty((_window_pad(e), 2), np.int32)
                pad[:, 0] = n
                pad[:, 1] = (r_count - 1) << 16
                packed = np.concatenate([packed, pad])
                col = np.zeros(0, np.int32)
                rel_s = np.zeros(0, np.int32)
            else:
                edge_deg = deg_edge
        else:
            deg_rel_flat = np.zeros((n + 1) * r_count, deg_dtype)
            deg_rel_flat[key64[starts[:-1]]] = lens.astype(deg_dtype)
        present = float(
            np.bincount(d[starts[:-1]], minlength=n + 1).mean())
    else:
        present = 0.0
    rel_dtype = (np.int8 if r_count <= 127 else np.int32) if slim \
        else np.int32
    if packed.shape[0]:
        rel_dtype = np.int32  # rel is empty; its dtype is moot
    packed_t = torch.from_numpy(np.ascontiguousarray(packed))
    if window_pairs and packed.shape[0]:
        packed_t = packed_t.view(-1, 2 * GRANULE)
    return CombinedCsr(
        row_start=torch.from_numpy(row_start), col=torch.from_numpy(col),
        rel=torch.from_numpy(rel_s.astype(rel_dtype)),
        edge_deg=torch.from_numpy(edge_deg),
        deg_total=torch.from_numpy(deg_total), num_nodes=n,
        num_relations=r_count, avg_present_relations=present,
        deg_rel_flat=torch.from_numpy(deg_rel_flat), packed=packed_t)


def _combined_agg_impl() -> str:
    """The per-(node, relation) reduction (``PRIMEKG_COMBINED_AGG``, as in
    the JAX package): "einsum" (the default), "rowwise", and any other
    value the chunked one. Read by the sampler (whether rows need their
    tags sorted) and by the aggregation."""
    return os.environ.get("PRIMEKG_COMBINED_AGG", "einsum")


def _rowwise_sums(msg: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """[M, R, D] per-(node, relation) sums of ``msg`` [M, F, D] whose rows
    hold their slots in ascending tag order: ``ends[m, r]`` is the number
    of row m's slots with tag <= r. A cumsum along the slots (a zero
    prepended), one flat row gather at the ends, then the difference of
    neighbouring relations."""
    m, f, d = msg.shape
    s = torch.cat([msg.new_zeros(m, 1, d), torch.cumsum(msg, dim=1)], dim=1)
    flat = (torch.arange(m, device=msg.device)[:, None] * (f + 1)
            + ends).reshape(-1)
    csum = s.reshape(m * (f + 1), d)[flat].reshape(m, -1, d)
    return torch.diff(csum, dim=1, prepend=csum.new_zeros(m, 1, d))


def _slot_cotangents(g_rel: torch.Tensor, rtag: torch.Tensor) -> torch.Tensor:
    """[M, F, D]: each slot's cotangent is its relation's row of ``g_rel``
    [M, R, D] (one flat row gather)."""
    m, r, d = g_rel.shape
    flat = (torch.arange(m, device=g_rel.device)[:, None] * r
            + rtag).reshape(-1)
    return g_rel.reshape(m * r, d)[flat].reshape(m, -1, d)


class RowwiseRelSum(torch.autograd.Function):
    """``apply(msg, rtag, ends)``: per-(node, relation) slot sums, [M, F,
    D] -> [M, R, D] (``rowwise_rel_sum``). ``rtag`` int32 [M, F] ascending
    in every row, ``ends`` int32 [M, R] each relation's end slot. The
    forward streams O(M F D) (:func:`_rowwise_sums`), without the einsum's
    [M, F, R] one-hot; the backward is one gather, each slot's cotangent
    its relation's row."""

    @staticmethod
    def forward(ctx, msg, rtag, ends):
        ctx.save_for_backward(rtag)
        return _rowwise_sums(msg, ends.long())

    @staticmethod
    def backward(ctx, g):
        (rtag,) = ctx.saved_tensors
        return _slot_cotangents(g, rtag.long()), None, None


def _pick_chunks(m: int, target: int = 8192) -> int:
    """Largest divisor of m up to 64 that leaves chunks of at least
    ``target`` rows (1 when none does)."""
    best = 1
    for nc in range(1, 65):
        if m % nc == 0 and m // nc >= target:
            best = nc
    return best


class ChunkedRelApply(torch.autograd.Function):
    """``apply(n_chunks, rows3, rtag, slot_w, ends, w_all)``: [M, H], the
    per-(node, relation) sums of the weighted slots ``rows3 * slot_w``
    times their relation's weights, summed over relations
    (``chunked_rel_apply``). rows3 [M, F, D] unweighted gathered rows,
    rtag int32 [M, F] ascending per row, slot_w [M, F], ends int32 [M, R],
    w_all [R, D, H]; M divisible by ``n_chunks``.

    Forward and backward walk the rows in ``n_chunks`` chunks (a Python
    loop where JAX has a ``lax.scan``), so the weighted messages, their
    cumsum and the [C, R, D] sums exist one chunk at a time. The backward
    is the JAX package's manual one: per chunk it recomputes the sums for
    dW, takes d_sums = g @ W^T and routes each slot's cotangent from its
    relation's row; it saves only the inputs. dW accumulates in g's dtype
    across chunks, as in JAX."""

    @staticmethod
    def forward(ctx, n_chunks, rows3, rtag, slot_w, ends, w_all):
        m = rows3.shape[0]
        r, d, h = w_all.shape
        w_flat = w_all.reshape(r * d, h)
        c = m // n_chunks
        ends_l = ends.long()
        out = [_rowwise_sums(rows3[i:i + c] * slot_w[i:i + c, :, None],
                             ends_l[i:i + c]).reshape(c, r * d) @ w_flat
               for i in range(0, m, c)]
        ctx.n_chunks = n_chunks
        ctx.save_for_backward(rows3, rtag, slot_w, ends, w_all)
        return torch.cat(out)

    @staticmethod
    def backward(ctx, g):
        rows3, rtag, slot_w, ends, w_all = ctx.saved_tensors
        m, f, d = rows3.shape
        r, _, h = w_all.shape
        c = m // ctx.n_chunks
        w_flat = w_all.reshape(r * d, h)
        rtag_l, ends_l = rtag.long(), ends.long()
        dw = torch.zeros(r * d, h, dtype=g.dtype, device=g.device)
        d_rows, d_slotw = [], []
        for i in range(0, m, c):
            rows_c, w_c, g_c = rows3[i:i + c], slot_w[i:i + c], g[i:i + c]
            agg = _rowwise_sums(rows_c * w_c[..., None],
                                ends_l[i:i + c]).reshape(c, r * d)
            dw = dw + agg.T @ g_c
            d_msg = _slot_cotangents((g_c @ w_flat.T).reshape(c, r, d),
                                     rtag_l[i:i + c])
            d_rows.append(d_msg * w_c[..., None])
            if ctx.needs_input_grad[3]:
                d_slotw.append((d_msg * rows_c).sum(2))
        d_slotw = torch.cat(d_slotw) if ctx.needs_input_grad[3] else None
        return (None, torch.cat(d_rows), None, d_slotw, None,
                dw.reshape(r, d, h))


def _ident_fraction() -> float:
    """Innermost-layer frontiers whose raw slot count reaches this fraction
    of the node space skip dedup (``CombinedBlock.ident``). The same
    variable and default as the JAX package, so both take the same
    regime."""
    return float(os.environ.get("PRIMEKG_IDENT_FRACTION", "0.03"))


def parse_sample_mode(mode: str):
    """Split a sampling-mode string into (base, n_windows): ``"block"`` is 1
    window, ``"blockN"`` N sub-windows of F/N records per node."""
    if mode.startswith("block") and mode != "block":
        try:
            n = int(mode[len("block"):])
        except ValueError:
            raise ValueError(f"unknown sampling mode {mode!r}")
        if n < 1:
            raise ValueError(f"block window count must be >= 1: {mode!r}")
        return "block", n
    return mode, 1


def _degree_from_bits(meta: torch.Tensor) -> torch.Tensor:
    """The float16 degree in a packed record's low 16 bits, as float32. The
    bits become a signed 16-bit value first, so the cast to int16 keeps
    them on every device."""
    bits = meta & 0xFFFF
    bits = bits - ((bits >> 15) << 16)
    return bits.to(torch.int16).view(torch.float16).float()


def _sample_layer_combined(draw: Draw, ccsr: CombinedCsr,
                           frontier: torch.Tensor, budget: int, mode: str,
                           allow_ident: bool = False):
    mode, n_win = parse_sample_mode(mode)
    m = frontier.shape[0]
    n = ccsr.num_nodes
    r_count = ccsr.num_relations
    dev = frontier.device
    fl = frontier.long()
    start = ccsr.row_start[fl]
    dtot = ccsr.deg_total[fl]
    if mode == "uniform":
        u = draw((m, budget))
        idx = torch.floor(u * dtot[:, None]).to(torch.int32)
        valid = (dtot > 0)[:, None].expand(m, budget)
    elif mode == "block":
        # n_win independent uniformly random ALIGNED windows of F/n_win
        # consecutive merged-CSR records per node; see the JAX package for
        # why the estimator stays unbiased.
        if budget % n_win:
            raise ValueError(
                f"block window count {n_win} must divide the layer "
                f"budget {budget}")
        f_win = budget // n_win
        n_blocks = (dtot + f_win - 1) // f_win  # ceil; 0 when deg == 0
        u = draw((m, n_win))
        blk = torch.floor(u * n_blocks.clamp(min=1).float()[:, None]).to(
            torch.int32)
        blk = torch.minimum(blk, (n_blocks - 1).clamp(min=0)[:, None])
        idx = ((blk * f_win)[:, :, None]
               + torch.arange(f_win, dtype=torch.int32, device=dev)
               ).reshape(m, budget)
        valid = idx < dtot[:, None]
    else:  # truncate: the first min(deg_total, F) merged edges
        idx = torch.arange(budget, dtype=torch.int32,
                           device=dev).expand(m, budget)
        valid = idx < dtot[:, None]
    pos = start[:, None] + torch.minimum(idx, (dtot[:, None] - 1).clamp(min=0))
    if ccsr.packed.shape[0]:
        pairs = packed_is_pairs(ccsr.packed)
        if pairs and mode != "block":
            raise ValueError(
                f"packed CSR is in granule-pairs form, which only block-"
                f"mode window fetches can read — build it without "
                f"window_pairs for mode={mode!r}")
        if mode == "block":
            # One contiguous window of records per node and sub-window
            # (kernel B3 on the card); the sentinel records absorb the
            # over-read past a row's end, masked below like any invalid
            # slot.
            rec = window_rows_fetch(
                ccsr.packed,
                (start[:, None] + blk * f_win).reshape(-1).to(torch.int32),
                f_win).reshape(m, budget, 2)
        else:
            rec = ccsr.packed[pos.long()]
        picks = torch.where(valid, rec[..., 0], n)
        meta = rec[..., 1]
        # Invalid slots tag the LAST relation (weight 0), as in JAX.
        rtag = torch.where(valid, meta >> 16, r_count - 1)
        deg_r = torch.where(valid, _degree_from_bits(meta), 0.0)
    else:
        picks = torch.where(valid, _take(ccsr.col, pos), n)
        rtag = torch.where(valid, _take(ccsr.rel, pos).to(torch.int32),
                           r_count - 1)
        if ccsr.edge_deg.shape[0]:
            deg_r = torch.where(valid, _take(ccsr.edge_deg, pos),
                                0).float()
        else:
            deg_r = ccsr.deg_rel_flat[
                (fl[:, None] * r_count + rtag).long()].float()
            deg_r = torch.where(valid, deg_r, 0.0)
    if mode == "uniform":
        w = dtot[:, None].float() / (budget * deg_r.clamp(min=1.0))
    elif mode == "block":
        w = n_blocks[:, None].float() / (n_win * deg_r.clamp(min=1.0))
    else:
        w = 1.0 / deg_r.clamp(min=1.0)
    w = torch.where(valid & (deg_r > 0), w, 0.0)
    # Uniform and blockN rows arrive with their tags out of order (blockN:
    # ascending within each sub-window). The einsum reduction ignores slot
    # order, so it keeps them as drawn; the rowwise and chunked ones walk
    # each row's relations in order, so their rows are sorted by tag,
    # stably, as in the JAX package. Truncate and block rows are CSR order,
    # sorted already.
    tags_sorted = True
    if mode == "uniform" or (mode == "block" and n_win > 1):
        if _combined_agg_impl() != "einsum":
            order = torch.argsort(rtag, dim=1, stable=True)
            picks, rtag, w = (torch.gather(a, 1, order)
                              for a in (picks, rtag, w))
        else:
            tags_sorted = False

    raw = torch.cat([frontier, picks.reshape(-1)])
    raw_len = int(raw.shape[0])
    if allow_ident and raw_len >= _ident_fraction() * (n + 1):
        # Near-saturated innermost frontier: skip dedup, keep global ids;
        # the backward sums the raw stream's cotangents in sorted order.
        perm = torch.argsort(raw, stable=True)
        block = CombinedBlock(
            src_local=picks, rel_tag=rtag, slot_w=w, self_idx=frontier,
            out_ids=frontier, sort_perm=perm.to(torch.int32),
            sort_uid=raw[perm], m_out=m, m_in=n, ident=True,
            tags_sorted=tags_sorted)
        return None, block
    cap = _unique_cap(raw_len, n)
    uniq, inv, perm, uid = _sorted_unique(raw, cap, n)
    block = CombinedBlock(
        src_local=inv[m:].reshape(m, budget), rel_tag=rtag, slot_w=w,
        self_idx=inv[:m], out_ids=frontier, sort_perm=perm, sort_uid=uid,
        m_out=m, m_in=cap, tags_sorted=tags_sorted)
    return uniq, block


def sample_batch_combined(draw: Draw, ccsr: CombinedCsr,
                          seeds: torch.Tensor, budgets: Sequence[int], *,
                          mode: str = "uniform",
                          allow_ident: bool = False) -> SampledBatch:
    """Combined-layout analogue of :func:`sample_batch`: ``budgets`` are
    each layer's total per-node budget over all relations, outermost
    first. ``allow_ident`` lets the innermost layer go identity when its raw
    slot stream covers >= ``PRIMEKG_IDENT_FRACTION`` (default 0.03) of the
    node space; ``batch.frontier`` is then None. Modes: "uniform", "block"
    / "blockN", "truncate"."""
    if parse_sample_mode(mode)[0] not in ("uniform", "block", "truncate"):
        raise ValueError(f"unknown sampling mode {mode!r}")
    frontier, seed_gather = _unique_seeds(seeds, ccsr.num_nodes)
    blocks: List[CombinedBlock] = []
    for li, f in enumerate(budgets):
        frontier, block = _sample_layer_combined(
            draw, ccsr, frontier, int(f), mode,
            allow_ident=allow_ident and li == len(budgets) - 1)
        blocks.append(block)
    return SampledBatch(frontier=frontier, blocks=tuple(reversed(blocks)),
                        seed_gather=seed_gather)


def _block_aggregate_combined(layer_params, x_in: torch.Tensor,
                              block: CombinedBlock,
                              compute_dtype: Optional[torch.dtype] = None
                              ) -> torch.Tensor:
    dt = compute_dtype if compute_dtype is not None else x_in.dtype
    w_rel = materialize_relation_weights(layer_params).to(dt)  # [R, Din, Dout]
    r_count, din, dout = w_rel.shape
    inv_all = torch.cat([block.self_idx, block.src_local.reshape(-1)])
    if block.ident:
        # x_in is the raw table; ids are global, the sentinel gives zeros;
        # the gathered rows are converted to dt inside the op.
        rows = IdentPickGather.apply(x_in, inv_all, block.sort_perm,
                                     block.sort_uid, dt)
    else:
        rows = DedupGather.apply(x_in, inv_all, block.sort_perm,
                                 block.sort_uid)
    m = block.m_out
    out = (rows[:m] @ layer_params["w_root"].to(dt)
           + layer_params["bias"].to(dt)[None, :])
    budget = block.src_local.shape[1]
    # Per-(node, relation) sums, then all R relation transforms as one
    # [M, R*Din] @ [R*Din, Dout] matmul; the sums by a one-hot einsum
    # (default), by RowwiseRelSum, or chunked with the transforms
    # (ChunkedRelApply), per _combined_agg_impl.
    impl = _combined_agg_impl()
    msg3 = rows[m:].reshape(m, budget, din)
    slot_w = block.slot_w.to(dt)
    w_flat = w_rel.reshape(r_count * din, dout)
    if impl == "einsum":
        msg = msg3 * slot_w[..., None]
        onehot = (block.rel_tag[..., None] == torch.arange(
            r_count, dtype=torch.int32, device=msg.device)).to(msg.dtype)
        agg = torch.einsum("mfr,mfd->mrd", onehot, msg)
        return out + agg.reshape(m, r_count * din) @ w_flat
    if not block.tags_sorted:
        raise ValueError(
            "PRIMEKG_COMBINED_AGG changed between sampling and aggregation: "
            f"the '{impl}' reduction needs per-row ascending relation tags, "
            "but this block was sampled for the order-independent einsum "
            "path (tag sort skipped). Keep the env var constant per step.")
    # ends[m, r]: row m's slots with tag <= r (the rows are sorted).
    rtag = block.rel_tag.contiguous()
    ends = torch.searchsorted(
        rtag, torch.arange(r_count, dtype=rtag.dtype,
                           device=rtag.device).expand(m, r_count).contiguous(),
        right=True).to(torch.int32)
    if impl == "rowwise":
        agg = RowwiseRelSum.apply(msg3 * slot_w[..., None], rtag, ends)
        return out + agg.reshape(m, r_count * din) @ w_flat
    return out + ChunkedRelApply.apply(_pick_chunks(m), msg3, rtag, slot_w,
                                       ends, w_rel)
