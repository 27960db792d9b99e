"""Mini-batch (neighbor-sampled) training: one device, and data-parallel
over the shards of a mesh.

The counterpart of ``primekg_rgcn_tpu/train/sampled.py``: each step samples
the L-hop neighbourhoods of the batch's candidate endpoints on the device
and differentiates through the sampled encoder, O(B * fanout^L) work instead
of O(E). ``resolve_sampler`` picks the pick layout,
``build_sampled_train_step`` builds the one-device step (dense adam, or the
sparse-embedding update: SGD, or adafactor with ``table_opt``; with
``cache_layer1`` one sampled hop and a table of layer-1 histories),
``build_sampled_eval_epoch`` the sampled validation, ``SampledEpoch`` the
one-device epoch in chunks of steps, and ``SampledTrainer`` runs epochs,
validation, checkpoints, early stopping and resume.

The data-parallel steps split the batch over the n shards of a mesh
(``parallel/mesh.py``; every shard on the one device): each shard samples
the frontier of its B/n seeds and scores its candidates, and the shards'
loss sums are added and backpropagated once, the psum of the gradients.
``build_sampled_train_step_dp`` keeps one optimizer over replicated
parameters; ``build_sampled_train_step_zero1`` updates the embedding table
in n row slices, each with its own optimizer state (ZeRO-1);
``build_sampled_train_step_zero3`` shards the table itself, fetching each
shard's frontier rows from their owners (``ShardedRowFetch``), optionally
on an (n_dp, n_tp) mesh and with the factored adafactor table rule.

Each step draws its random numbers from one ``torch.Generator`` in the JAX
step's stream order: negatives, then sampling, then dropout, shard after
shard in the data-parallel steps (JAX derives each device's streams with
``fold_in(key, device)`` instead). A test may hand a step its candidates,
sampler draws and dropout masks, per shard in the data-parallel steps.

Across processes (a mesh whose shards ``parallel/mesh.py`` splits over a
process group) each process samples and scores only its own shards, but
draws every shard's random numbers, another process's sampler uniforms
and dropout mask by shape, so its generator stays where a one-process run
leaves it. Each process backpropagates its own shards' loss sum; the
replicated parameters' gradients are then summed across the processes,
the slice gradients of the sharded table stay with their owners, and the
trio (loss sum, correct, count) is summed across the processes.
On one device the trainer runs the JAX trainer's ``lax.scan`` chunks as
CUDA graphs of ``steps_per_scan`` steps (``train/graphs.py``); the
data-parallel steps run eagerly. Either way the host reads the losses once
per epoch.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.data import sampling
from primekg_rgcn_tpu_torch.data.sampling import (
    CombinedCsr, CsrCache, SampledBatch, build_combined_csr, build_csr_cache,
    csr_to_pairs_form, parse_sample_mode, sample_batch,
    sample_batch_combined, uniform_draw)
from primekg_rgcn_tpu_torch.device import resolve_device
from primekg_rgcn_tpu_torch.models.rgcn import (Params, compute_dtype,
                                                encoder_apply_cached,
                                                encoder_apply_sampled,
                                                param_leaves)
from primekg_rgcn_tpu_torch.ops.rgcn_segment import rgcn_layer_segment
from primekg_rgcn_tpu_torch.ops.distmult import distmult_score
from primekg_rgcn_tpu_torch.parallel.mesh import (Mesh, all_gather,
                                                  all_reduce_,
                                                  check_same_across,
                                                  make_mesh, make_mesh_2d,
                                                  psum, psum_scatter,
                                                  shard_groups)
from primekg_rgcn_tpu_torch.train.graphs import (StepGraphs, run_segments,
                                                 steps_per_graph)
from primekg_rgcn_tpu_torch.train.loop import (Candidates, Trainer,
                                               apply_update,
                                               build_eval_epoch,
                                               clip_by_global_norm_,
                                               edges_with_sentinel,
                                               make_optimizer,
                                               sample_candidates)
from primekg_rgcn_tpu_torch.train.neg_sampling import (bce_stats,
                                                       candidate_batch)
from primekg_rgcn_tpu_torch.utils.telemetry import device_memory_stats

logger = logging.getLogger(__name__)


LAYOUTS = ("auto", "combined", "per-relation")


def resolve_sampler(graph_or_csr, fanouts, layout: str = "auto",
                    mode: str = "uniform"):
    """Pick the pick-tensor layout for the graph's relation sparsity:
    (csr_like, budgets, use_combined), on the CPU.

    The per-relation layout ([R, M, f] picks) suits graphs where most
    (node, relation) pairs have edges; the combined one (one merged budget
    per node with relation tags and importance weights) suits
    relation-sparse ones. A CsrCache takes the per-relation layout and a
    CombinedCsr the combined one. ``layout="per-relation"`` or
    ``"combined"`` forces the layout of a graph (a CombinedCsr cannot be
    made per-relation: ``ValueError``); ``"auto"`` takes combined when the
    average number of present relations per node is under half the
    relation count, and always for block modes, whose windows ride the
    merged CSR. Block modes get the packed table in granule-pairs form (a
    view here). Combined budgets are the fanout times the present-relation
    average, rounded up to a multiple of 8 and capped at 48, as in the JAX
    package.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r} (one of {LAYOUTS})")
    base_mode = parse_sample_mode(mode)[0]
    want_pairs = base_mode == "block"
    fanouts = tuple(int(f) for f in fanouts)
    if isinstance(graph_or_csr, (CsrCache, CombinedCsr)):
        csr, graph = graph_or_csr, None
    else:
        csr, graph = None, graph_or_csr

    if layout == "per-relation" or isinstance(csr, CsrCache):
        if isinstance(csr, CombinedCsr):
            raise ValueError("layout='per-relation' needs a graph or a "
                             "CsrCache, not a CombinedCsr")
        return (csr if csr is not None else build_csr_cache(graph),
                fanouts, False)
    if csr is None:
        ccsr = build_combined_csr(graph, window_pairs=want_pairs)
        if layout == "auto" and base_mode != "block" and \
                ccsr.avg_present_relations >= 0.5 * ccsr.num_relations:
            return build_csr_cache(graph), fanouts, False
    else:
        ccsr = csr_to_pairs_form(csr) if want_pairs else csr
    factor = max(1.0, ccsr.avg_present_relations)
    budgets = tuple(min(-(-int(np.ceil(f * factor)) // 8) * 8, 48)
                    for f in fanouts)
    return ccsr, budgets, True


def _sampler(csr, fanouts, mode: str, device, allow_ident: bool,
             layout: str = "auto", hops: Optional[int] = None):
    """``sample(seeds, draw) -> SampledBatch`` over ``csr`` (resolved by
    :func:`resolve_sampler` and kept on ``device``), with ``.csr``,
    ``.budgets`` and ``.use_combined``. ``allow_ident`` lets the innermost
    block go identity: the one-device steps allow it, the data-parallel
    ones do not (the JAX package's multi-device default). ``hops`` samples
    only the outermost ``hops`` layers (the cached step's one)."""
    csr, budgets, use_combined = resolve_sampler(csr, fanouts, layout, mode)
    csr = csr.to(device)
    sampled = budgets[:hops]

    def sample(seeds: torch.Tensor, draw) -> SampledBatch:
        if use_combined:
            return sample_batch_combined(draw, csr, seeds, sampled, mode=mode,
                                         allow_ident=allow_ident)
        return sample_batch(draw, csr, seeds, sampled, mode=mode)

    sample.csr, sample.budgets, sample.use_combined = (csr, budgets,
                                                       use_combined)
    sample.draw_shapes = lambda n_seeds: sampling.draw_shapes(
        csr, n_seeds, sampled, mode, combined=use_combined,
        allow_ident=allow_ident)
    return sample


def sampled_stats(params: Params, batch: SampledBatch, cands: Candidates,
                  model_cfg: ModelConfig, *, train: bool,
                  generator: Optional[torch.Generator] = None,
                  enc_mask: Optional[torch.Tensor] = None,
                  x0: Optional[torch.Tensor] = None,
                  cache: Optional[torch.Tensor] = None):
    """(loss_sum, correct, count) of one candidate batch through the sampled
    encoder, or with a layer-1 ``cache`` through ``encoder_apply_cached``
    (which updates it), 0-d tensors (``bce_stats``; no decoder dropout, as
    in the JAX steps)."""
    heads, tails, rels, labels, weights = cands
    if cache is not None:
        emb, _ = encoder_apply_cached(params, batch, cache, model_cfg,
                                      train=train, generator=generator,
                                      mask=enc_mask, x0=x0)
    else:
        emb = encoder_apply_sampled(params, batch, model_cfg, train=train,
                                    generator=generator, mask=enc_mask,
                                    x0=x0)
    m = heads.shape[0]
    scores = distmult_score(emb[:m], emb[m:],
                            params["decoder"]["rel_emb"][rels])
    return bce_stats(scores, labels, weights)


def sampled_loss(params: Params, batch: SampledBatch, cands: Candidates,
                 model_cfg: ModelConfig, *, train: bool,
                 generator: Optional[torch.Generator] = None,
                 enc_mask: Optional[torch.Tensor] = None,
                 x0: Optional[torch.Tensor] = None,
                 cache: Optional[torch.Tensor] = None):
    """Mean BCE loss and accuracy of one candidate batch through the
    sampled encoder (or the cached one, see :func:`sampled_stats`), 0-d
    tensors (the JAX step's ``loss_fn`` body after sampling)."""
    loss_sum, correct, count = sampled_stats(
        params, batch, cands, model_cfg, train=train, generator=generator,
        enc_mask=enc_mask, x0=x0, cache=cache)
    return loss_sum / count, correct / count


def _split_emb(params: Params):
    """(the embedding table, every other parameter as a dict without it)."""
    enc = {k: v for k, v in params["encoder"].items() if k != "node_emb"}
    return params["encoder"]["node_emb"], {"encoder": enc,
                                           "decoder": params["decoder"]}


def _merge_emb(rest: Params, emb: torch.Tensor) -> Params:
    """``rest`` with ``emb`` as its embedding table (a new dict)."""
    return {"encoder": {"node_emb": emb, **rest["encoder"]},
            "decoder": rest["decoder"]}


# -- the factored (adafactor) table rule --------------------------------------


def factored_slice_init(n_loc: int, d: int, *, device="cpu",
                        n_slices: Optional[int] = None
                        ) -> Dict[str, torch.Tensor]:
    """Zero state for :func:`factored_slice_update` (step 0): float32
    ``v_row`` [D], ``v_col`` [n_loc] and int32 ``count``; with ``n_slices``
    each stacked over a leading slice axis, device-major as the JAX zero3
    state."""
    lead = () if n_slices is None else (n_slices,)
    return {"v_row": torch.zeros(*lead, d, device=device),
            "v_col": torch.zeros(*lead, n_loc, device=device),
            "count": torch.zeros(lead, dtype=torch.int32, device=device)}


def factored_slice_update(g: torch.Tensor, state: Dict[str, torch.Tensor],
                          *, axis_name: Optional[str],
                          row_valid: torch.Tensor, n_valid: int, lr: float,
                          decay_rate: float = 0.8, eps: float = 1e-30,
                          clip_threshold: float = 1.0,
                          mesh: Optional[Mesh] = None):
    """Adafactor update of a row-sliced [N, D] table: ``(update, new_state)``
    (``factored_slice_update`` in the JAX package).

    ``axis_name=None`` is the one-device form: ``g`` [n_loc, D] is the
    whole table. Otherwise ``g`` is [n, n_loc, D], the slices of that mesh
    axis stacked, and the two statistics that couple rows across slices,
    the [D] column second moment (``v_row``, the mean of ``g**2 + eps``
    over the N rows) and the block-RMS update clip, are summed over the
    slices (the JAX psums), so the rule equals ``optax.adafactor(lr,
    min_dim_size_to_factor=2, multiply_by_parameter_scale=False)`` on the
    unpadded dense table for any slicing. ``row_valid`` (float32, g's shape
    without D) masks the padded tail rows out of every cross-row statistic
    and out of the update; ``n_valid`` is the true row count N. The
    statistics are float32. With a ``mesh`` whose processes split the
    slices, ``g`` holds this process's and the two sums run across them.
    """
    g = g.float()
    sliced = axis_name is not None

    def across(x):
        # One total, read by every slice.
        return psum(x, mesh).expand_as(x) if sliced else x

    t = (state["count"] + 1).float()            # optax: count + 1
    decay = (1.0 - t ** (-decay_rate))[..., None]
    gsq = g * g + eps
    col_stat = across((gsq * row_valid[..., None]).sum(-2))
    new_v_row = decay * state["v_row"] + (1.0 - decay) * (col_stat / n_valid)
    new_v_col = decay * state["v_col"] + (1.0 - decay) * gsq.mean(-1)
    row_factor = (new_v_row / new_v_row.mean(-1, keepdim=True)) ** -0.5
    col_factor = new_v_col ** -0.5
    u = (g * row_factor[..., None, :] * col_factor[..., :, None]
         * row_valid[..., None])
    ms = across((u * u).sum((-2, -1))) / (n_valid * g.shape[-1])
    u = u / (ms.sqrt() / clip_threshold).clamp(min=1.0)[..., None, None]
    return -lr * u, {"v_row": new_v_row, "v_col": new_v_col,
                     "count": state["count"] + 1}


def factored_rows_update(g_rows: torch.Tensor, frontier: torch.Tensor,
                         table: torch.Tensor, state: Dict[str, torch.Tensor],
                         *, lr: float, decay_rate: float = 0.8,
                         eps: float = 1e-30, clip_threshold: float = 1.0
                         ) -> Dict[str, torch.Tensor]:
    """Adafactor update of ``table`` [N, D] from a sparse row gradient, in
    place; returns the new state (``factored_rows_update``).

    ``g_rows`` [cap, D] is the gradient of the gathered frontier rows,
    ``frontier`` int32 [cap] their sorted-unique ids, filled with N (the
    fill slots' gradients drop). Every untouched row's squared gradient is
    exactly ``eps``, so the [D] column statistic, the [N] row statistic (an
    affine map everywhere plus the touched rows' term) and the block-RMS
    clip follow from the touched rows alone: the rule equals dense
    adafactor (``factored_slice_update`` with ``axis_name=None``) on the
    scattered [N, D] gradient, with no [N, D] gradient, update or
    statistic.
    """
    n, d = table.shape
    valid = (frontier < n)[:, None]
    g = torch.where(valid, g_rows.float(), 0.0)
    t = (state["count"] + 1).float()
    decay = 1.0 - t ** (-decay_rate)
    gsq = g * g
    new_v_row = decay * state["v_row"] + (1.0 - decay) * (
        (gsq.sum(0) + n * eps) / n)
    # Frontier ids are sorted-unique (fill value n), so each real row's
    # statistic receives one value; the fill slots add zeros to row n - 1.
    rows = frontier.clamp(max=n - 1).long()
    new_v_col = decay * state["v_col"] + (1.0 - decay) * eps
    new_v_col.index_add_(0, rows, (1.0 - decay) * gsq.mean(1))
    row_factor = (new_v_row / new_v_row.mean()) ** -0.5
    u = g * row_factor[None, :] * (new_v_col[rows] ** -0.5)[:, None]
    u = torch.where(valid, u, 0.0)
    ms = (u * u).sum() / (n * d)
    u = u / (ms.sqrt() / clip_threshold).clamp(min=1.0)
    # The same unique rows: each receives its update once.
    table.index_add_(0, rows, (-lr * u).to(table.dtype))
    return {"v_row": new_v_row, "v_col": new_v_col,
            "count": state["count"] + 1}


class SplitOptimizer:
    """The optimizer state of a step that updates the embedding table apart
    from the other parameters (JAX: ``opt_state = (rest_state,
    table_state)``): ``rest``, a torch optimizer over every other leaf, and
    ``table``, either a torch optimizer over the table's stacked row slices
    [n, n_loc, D] (zero1, and zero3 with ``table_opt="sgd"``) or the
    factored adafactor statistics, a dict of tensors
    (:func:`factored_slice_init`). ``state_dict`` holds both, so checkpoints
    and resume keep the per-slice state.

    ``mesh``: where the slices are split over processes (each holds those
    of its shards, ``mesh.local``), ``state_dict`` gathers every process's
    slices of the table state (its tensors of one or more axes, stacked
    over the slices), so a checkpoint holds all n as on one process, and
    ``load_state_dict`` keeps this process's."""

    def __init__(self, rest: torch.optim.Optimizer, table,
                 mesh: Optional[Mesh] = None):
        self.rest = rest
        self.table = table
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.rest.zero_grad(set_to_none=set_to_none)
        if isinstance(self.table, torch.optim.Optimizer):
            self.table.zero_grad(set_to_none=set_to_none)

    def state_dict(self):
        table = (self.table.state_dict()
                 if isinstance(self.table, torch.optim.Optimizer)
                 else dict(self.table))
        if self.mesh is not None:
            table = _map_slices(table, lambda t: all_gather(t,
                                                            mesh=self.mesh))
        return {"rest": self.rest.state_dict(), "table": table}

    def load_state_dict(self, state) -> None:
        self.rest.load_state_dict(state["rest"])
        table = state["table"]
        if self.mesh is not None:
            own = self.mesh.local
            table = _map_slices(table, lambda t: t[own.start:own.stop])
        if isinstance(self.table, torch.optim.Optimizer):
            self.table.load_state_dict(table)
        else:
            # In place: a captured step reads these tensors.
            for k, v in table.items():
                self.table[k].copy_(v)


def _map_slices(obj, fn):
    """``obj`` with ``fn`` applied to every tensor of one or more axes (the
    per-slice state; a 0-d tensor, such as adam's step, is shared)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj) if obj.dim() else obj
    if isinstance(obj, dict):
        return type(obj)((k, _map_slices(v, fn)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_slices(v, fn) for v in obj)
    return obj


def _assign_(table: Dict[str, torch.Tensor],
             state: Dict[str, torch.Tensor]) -> None:
    """Write a factored rule's new statistics into ``table``'s tensors, in
    place, so that a captured step that reads them sees each update."""
    for k, v in state.items():
        table[k].copy_(v)


class CachedOptimizer:
    """The optimizer state of the cached step (JAX: ``opt_state = (base,
    cache)``): ``base``, the sparse step's optimizer (a torch optimizer over
    the other leaves, or a :class:`SplitOptimizer` with the factored
    table rule), and ``cache``, the [N, hidden_dim] layer-1 histories in
    the compute dtype, which each step updates in place. ``state_dict``
    holds both, so checkpoints and resume keep the histories."""

    def __init__(self, base, cache: torch.Tensor):
        self.base = base
        self.cache = cache

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.base.zero_grad(set_to_none=set_to_none)

    def state_dict(self):
        return {"base": self.base.state_dict(), "cache": self.cache}

    def load_state_dict(self, state) -> None:
        self.base.load_state_dict(state["base"])
        self.cache.copy_(state["cache"])


def build_sampled_train_step(csr, model_cfg: ModelConfig,
                             train_cfg: TrainConfig, *,
                             fanouts: Sequence[int] = (15, 10),
                             mode: str = "uniform", layout: str = "auto",
                             sparse_emb: bool = False,
                             table_opt: str = "sgd",
                             cache_layer1: bool = False, cache_init=None,
                             device="cuda"):
    """Returns ``step(params, optimizer, pos_edges, generator) -> (loss,
    acc)``, 0-d tensors on the device, nothing read back to the host.

    ``csr`` is a RelGraph (layout resolved by :func:`resolve_sampler` with
    ``layout``), a CsrCache or a CombinedCsr, on the CPU; the step keeps it
    on ``device``. ``pos_edges`` is int64 [B, 3] (head, tail, rel) on the
    device. A step draws the negatives, then the sampler's uniforms, then
    the dropout mask from ``generator``; a test may hand it ``cands``,
    ``draw`` and ``enc_mask`` instead.

    Dense (default): ``optimizer`` covers every parameter, and the update
    is ``apply_update`` (clip, then the optimizer step). ``sparse_emb``: the
    embedding table is updated apart from the other parameters, from its
    gathered rows' gradient, or, when the innermost block is identity, from
    the dense table gradient; ``optimizer`` covers the other parameters.
    ``table_opt="sgd"``: plain SGD (``train_cfg.lr``), a row scatter with
    the frontier's sentinel rows dropped, or ``table - lr * grad``.
    ``table_opt="adafactor"`` (needs ``sparse_emb``): the factored rule,
    :func:`factored_rows_update`, or :func:`factored_slice_update` on the
    identity block's dense gradient; the optimizer is then a
    :class:`SplitOptimizer` whose ``table`` holds the [N] + [D] statistics.

    ``cache_layer1`` (needs ``sparse_emb``; forces the combined layout when
    ``layout`` is "auto"): one sampled hop (the outermost budget, never
    identity) through ``models/rgcn.encoder_apply_cached``, whose [N,
    hidden_dim] history table rides with the optimizer, a
    :class:`CachedOptimizer`: zeros, or ``cache_init``, in the compute
    dtype. Each step pushes its fresh layer-1 rows into it.

    Build the optimizer with ``step.init_optimizer(params)``.
    ``step.sample(seeds, draw)`` samples a batch over the step's CSR.
    """
    if table_opt == "adafactor":
        if not sparse_emb:
            raise ValueError("table_opt='adafactor' requires sparse_emb")
    elif table_opt != "sgd":
        raise ValueError(f"unknown table_opt {table_opt!r}")
    factored = table_opt == "adafactor"
    if cache_layer1:
        if not sparse_emb:
            raise ValueError("cache_layer1 requires sparse_emb (the "
                             "single-chip memory mode)")
        if layout == "auto":
            # The hop's frontier ids address the history table, so the
            # cache needs the combined layout even where "auto" would pick
            # the per-relation one.
            layout = "combined"
    device = resolve_device(device)
    sample = _sampler(csr, fanouts, mode, device,
                      allow_ident=not cache_layer1, layout=layout,
                      hops=1 if cache_layer1 else None)
    if cache_layer1 and not sample.use_combined:
        raise ValueError(
            "cache_layer1 needs the combined pick layout (the hop's "
            "frontier global ids address the history table); pass "
            "layout='combined'")
    n = model_cfg.num_nodes
    lr = train_cfg.lr

    def step(params: Params, optimizer, pos_edges: torch.Tensor,
             generator: torch.Generator, *,
             cands: Optional[Candidates] = None, draw=None,
             enc_mask: Optional[torch.Tensor] = None):
        if cands is None:
            cands = candidate_batch(pos_edges[:, 0], pos_edges[:, 1],
                                    pos_edges[:, 2], n,
                                    train_cfg.num_neg_samples,
                                    generator=generator)
        seeds = torch.cat([cands[0], cands[1]]).to(torch.int32)
        batch = sample(seeds, draw if draw is not None
                       else uniform_draw(generator, device))
        optimizer.zero_grad(set_to_none=True)
        base = optimizer.base if cache_layer1 else optimizer
        emb = params["encoder"]["node_emb"]
        x0 = None
        if sparse_emb:
            emb.grad = None
            if not getattr(batch.blocks[0], "ident", False):
                sentinel = (batch.frontier == n)[:, None]
                rows_idx = batch.frontier.clamp(max=n - 1).long()
                with torch.no_grad():
                    x0 = emb[rows_idx].masked_fill(sentinel, 0.0)
                x0.requires_grad_(True)
        loss, acc = sampled_loss(params, batch, cands, model_cfg, train=True,
                                 generator=generator, enc_mask=enc_mask,
                                 x0=x0, cache=optimizer.cache
                                 if cache_layer1 else None)
        loss.backward()
        if sparse_emb:
            with torch.no_grad():
                if factored and x0 is None:
                    # Identity block: the dense table gradient.
                    upd, state = factored_slice_update(
                        emb.grad, base.table, axis_name=None,
                        row_valid=torch.ones(n, device=emb.device),
                        n_valid=n, lr=lr)
                    emb.add_(upd.to(emb.dtype))
                    _assign_(base.table, state)
                elif factored:
                    _assign_(base.table, factored_rows_update(
                        x0.grad, batch.frontier, emb, base.table, lr=lr))
                elif x0 is None:
                    emb.sub_(lr * emb.grad)
                else:
                    # Frontier ids are sorted-unique, filled with n: each
                    # real row gets its gradient once; the fill slots add
                    # zeros to row n - 1.
                    emb.index_add_(0, rows_idx, (-lr * x0.grad).masked_fill(
                        sentinel, 0.0))
            emb.grad = None
        apply_update(base.rest if factored else base, train_cfg)
        return loss.detach(), acc.detach()

    def init_optimizer(params: Params):
        if not sparse_emb:
            return make_optimizer(train_cfg, params)
        emb, rest = _split_emb(params)
        base = make_optimizer(train_cfg, rest)
        if factored:
            base = SplitOptimizer(base, factored_slice_init(
                n, emb.shape[1], device=emb.device))
        if not cache_layer1:
            return base
        shape = (n, model_cfg.hidden_dim)
        cdt = compute_dtype(model_cfg)
        if cache_init is None:
            # Cold start: zero histories fill as nodes appear as seeds.
            cache = torch.zeros(shape, dtype=cdt, device=emb.device)
        else:
            cache = torch.as_tensor(cache_init).to(emb.device, cdt,
                                                   copy=True)
            if tuple(cache.shape) != shape:
                raise ValueError(f"cache_init shape {tuple(cache.shape)} != "
                                 f"{shape}")
        return CachedOptimizer(base, cache)

    step.sample = sample
    step.init_optimizer = init_optimizer
    step.csr, step.budgets, step.use_combined = (sample.csr, sample.budgets,
                                                 sample.use_combined)
    return step


def build_sampled_eval_epoch(csr, val_edges: np.ndarray,
                             model_cfg: ModelConfig, train_cfg: TrainConfig,
                             *, fanouts: Sequence[int] = (15, 10),
                             mode: str = "uniform", device="cuda"):
    """Sampled-encoder validation: each batch of ``val_edges`` with its
    negatives is scored against its own sampled neighbourhood encode (no
    dropout), O(frontier) per batch instead of a full-graph encode.
    Messages ride the given (training) graph's CSR. Padding slots weigh 0,
    so the totals are exact over the validation set.

    Returns ``eval_fn(params, generator) -> (loss, acc)``, 0-d tensors on
    the device, the contract of ``train/loop.build_eval_epoch``.
    """
    device = resolve_device(device)
    sample = _sampler(csr, fanouts, mode, device, allow_ident=True)
    num_edges = int(val_edges.shape[0])
    b = train_cfg.batch_size
    n_steps = max(-(-num_edges // b), 1)
    edges_pad = edges_with_sentinel(val_edges, device)
    idx = torch.cat([torch.arange(num_edges),
                     torch.full((n_steps * b - num_edges,), num_edges)])
    idx = idx.view(n_steps, b).to(device)
    n = model_cfg.num_nodes

    def eval_fn(params: Params, generator: torch.Generator):
        stats = torch.zeros(3, device=device)
        draw = uniform_draw(generator, device)
        with torch.no_grad():
            for batch_idx in idx:
                cands = sample_candidates(edges_pad, batch_idx, n,
                                          train_cfg.num_neg_samples,
                                          generator=generator)
                seeds = torch.cat([cands[0], cands[1]]).to(torch.int32)
                stats += torch.stack(sampled_stats(
                    params, sample(seeds, draw), cands, model_cfg,
                    train=False))
        denom = stats[2].clamp(min=1.0)
        return stats[0] / denom, stats[1] / denom

    return eval_fn


# -- data-parallel steps over a mesh ------------------------------------------


def _local(mesh: Mesh) -> Optional[range]:
    """The shards this process holds, or None when it holds them all."""
    return mesh.local if mesh.world > 1 else None


def _recording(draw, drawn: list):
    """``draw``, appending the shape of each call to ``drawn``."""
    def recorded(shape):
        drawn.append(tuple(shape))
        return draw(shape)
    return recorded


def _draw_shards(pos_edges: torch.Tensor, n: int, model_cfg: ModelConfig,
                 train_cfg: TrainConfig, generator, sample, *, cands=None,
                 draw=None, enc_mask=None, train: bool = True,
                 local: Optional[range] = None):
    """Each shard's (candidates, sampled batch, dropout mask): shard i
    takes rows [i B/n, (i + 1) B/n) of ``pos_edges`` ([B, 3], or [B, 4]
    whose last column marks the real rows) and draws its negatives, its
    sampler uniforms and its dropout mask, shard after shard. ``cands``,
    ``draw`` and ``enc_mask`` are per-shard lists that replace the draws.

    ``local``: the shards this process holds (all when None). Every
    shard's numbers are drawn from ``generator`` in the same order; a shard
    outside ``local`` is not sampled: its sampler uniforms and its mask are
    drawn by shape (``sample.draw_shapes``) and dropped, and its entry is
    None.
    """
    b = pos_edges.shape[0]
    if b % n:
        raise ValueError(f"batch size {b} must divide by the {n}-device mesh")
    device = pos_edges.device
    out = []
    for i, pos in enumerate(pos_edges.reshape(n, b // n, -1)):
        c = cands[i] if cands is not None else candidate_batch(
            pos[:, 0], pos[:, 1], pos[:, 2], model_cfg.num_nodes,
            train_cfg.num_neg_samples,
            mask=pos[:, 3] > 0 if pos.shape[1] > 3 else None,
            generator=generator)
        seeds = torch.cat([c[0], c[1]]).to(torch.int32)
        own_mask = train and model_cfg.dropout > 0.0 and enc_mask is None
        shard_draw = draw[i] if draw is not None else uniform_draw(generator,
                                                                   device)
        if local is not None:
            # What this shard draws from the generator, by shape.
            shapes, rows = sample.draw_shapes(seeds.shape[0])
            shapes = ([] if draw is not None else shapes) + (
                [(rows, model_cfg.hidden_dim)] if own_mask else [])
            if i not in local:
                for shape in shapes:
                    torch.rand(shape, generator=generator, device=device)
                out.append(None)
                continue
            drawn = []
            if draw is None:
                shard_draw = _recording(shard_draw, drawn)
        batch = sample(seeds, shard_draw)
        mask = None
        if train and model_cfg.dropout > 0.0:
            # The encoder's keep mask over layer 1's rows, drawn as
            # models/rgcn.dropout draws it.
            shape = (batch.blocks[0].m_out, model_cfg.hidden_dim)
            mask = enc_mask[i] if enc_mask is not None else torch.rand(
                shape, generator=generator, device=device
            ) < 1.0 - model_cfg.dropout
            if local is not None and own_mask:
                drawn.append(shape)
        if local is not None and drawn != shapes:
            raise RuntimeError(
                f"shard {i} drew {drawn} where sampling.draw_shapes says "
                f"{shapes}: the processes' generators would part")
        out.append((c, batch, mask))
    return out


def _shard_stats(params: Params, shards, model_cfg: ModelConfig, *,
                 train: bool, x0s=None) -> torch.Tensor:
    """[3] (loss_sum, correct, count) summed over this process's shards
    (their psum; None entries are another process's), the loss sum
    differentiable."""
    stats = []
    for i, shard in enumerate(shards):
        if shard is not None:
            cands, batch, mask = shard
            stats.append(torch.stack(sampled_stats(
                params, batch, cands, model_cfg, train=train, enc_mask=mask,
                x0=None if x0s is None else x0s[i])))
    return psum(stats)


def _backward_stats(params: Params, shards, model_cfg: ModelConfig, *,
                    x0s=None, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every shard's loss sum, added and backpropagated once (the psum of
    the gradients; across processes each backpropagates its own shards').
    Returns the stats [3], detached and summed across ``mesh``'s
    processes."""
    trio = _shard_stats(params, shards, model_cfg, train=True, x0s=x0s)
    trio[0].backward()
    return psum([trio.detach()], mesh)


def build_sampled_train_step_dp(csr, model_cfg: ModelConfig,
                                train_cfg: TrainConfig, mesh: Mesh, *,
                                fanouts: Sequence[int] = (15, 10),
                                mode: str = "uniform"):
    """Data-parallel sampled step over ``mesh``
    (``build_sampled_train_step_dp``): ``step(params, optimizer, pos_edges,
    generator, *, cands=None, draw=None, enc_mask=None) -> (loss, acc)``.

    Each of the n shards takes B/n seeds, samples its own frontier (no
    identity block), encodes it and scores its candidates; the shards' loss
    sums are backpropagated once, the gradients divided by the total
    candidate count, then ``apply_update`` (clip, then the optimizer step,
    ``step.init_optimizer(params)``: every parameter). The CSR and the
    parameters are replicated; across processes the gradients are summed
    across them before the division. ``B % n`` raises.
    """
    sample = _sampler(csr, fanouts, mode, mesh.device, allow_ident=False)

    def step(params: Params, optimizer, pos_edges: torch.Tensor,
             generator: torch.Generator, *, cands=None, draw=None,
             enc_mask=None):
        shards = _draw_shards(pos_edges, mesh.n_shards, model_cfg, train_cfg,
                              generator, sample, cands=cands, draw=draw,
                              enc_mask=enc_mask, local=_local(mesh))
        optimizer.zero_grad(set_to_none=True)
        trio = _backward_stats(params, shards, model_cfg, mesh=mesh)
        total = trio[2].clamp(min=1.0)
        grads = [p.grad for p in param_leaves(params) if p.grad is not None]
        all_reduce_(grads, mesh)
        for g in grads:
            g.div_(total)
        apply_update(optimizer, train_cfg)
        return trio[0] / total, trio[1] / total

    step.sample, step.mesh = sample, mesh
    step.init_optimizer = lambda params: make_optimizer(train_cfg, params)
    return step


def build_sampled_train_step_zero1(csr, model_cfg: ModelConfig,
                                   train_cfg: TrainConfig, mesh: Mesh, *,
                                   fanouts: Sequence[int] = (15, 10),
                                   mode: str = "uniform"):
    """The data-parallel step with ZeRO-1 sharding of the embedding table's
    optimizer state (``build_sampled_train_step_zero1``).

    The table stays replicated. After the shards' backward (as
    :func:`build_sampled_train_step_dp`), the whole gradient is clipped by
    its global norm; then each shard's row slice of n_loc = ceil(N/n) rows
    (the last padded with zero rows) is updated with its own optimizer
    state, and the table is rebuilt from the slices (their ``all_gather``,
    ``[:N]``). The other parameters are updated once. The optimizer
    (``step.init_optimizer(params)``) is a :class:`SplitOptimizer` whose
    ``table`` steps the slices stacked [n, n_loc, D], so its moments are
    the per-slice ones, [n, n_loc, D]. Across processes each holds the
    slices of its own shards and their state, and the table is rebuilt
    from every process's slices.
    """
    sample = _sampler(csr, fanouts, mode, mesh.device, allow_ident=False)
    n = mesh.n_shards
    n_nodes = model_cfg.num_nodes
    n_loc = -(-n_nodes // n)
    # This process's slices hold the table's rows [lo, hi).
    lo = mesh.local.start * n_loc
    hi = max(min(mesh.local.stop * n_loc, n_nodes), lo)

    def init_optimizer(params: Params) -> SplitOptimizer:
        emb, rest = _split_emb(params)
        slices = torch.zeros(len(mesh.local), n_loc, emb.shape[1],
                             dtype=emb.dtype, device=emb.device)
        return SplitOptimizer(make_optimizer(train_cfg, rest),
                              make_optimizer(train_cfg, [slices]),
                              mesh=mesh)

    def step(params: Params, optimizer: SplitOptimizer,
             pos_edges: torch.Tensor, generator: torch.Generator, *,
             cands=None, draw=None, enc_mask=None):
        shards = _draw_shards(pos_edges, n, model_cfg, train_cfg, generator,
                              sample, cands=cands, draw=draw,
                              enc_mask=enc_mask, local=_local(mesh))
        emb = params["encoder"]["node_emb"]
        optimizer.zero_grad(set_to_none=True)
        emb.grad = None
        trio = _backward_stats(params, shards, model_cfg, mesh=mesh)
        total = trio[2].clamp(min=1.0)
        grads = [p.grad for p in param_leaves(params) if p.grad is not None]
        all_reduce_(grads, mesh)
        for g in grads:
            g.div_(total)
        if train_cfg.grad_clip and train_cfg.grad_clip > 0:
            # The full gradient's global norm, before the slices.
            clip_by_global_norm_(grads, train_cfg.grad_clip)
        slices = optimizer.table.param_groups[0]["params"][0]
        with torch.no_grad():
            # Each shard's row slice of the replicated table and of its
            # gradient; the pad rows stay zero.
            d = slices.shape[-1]
            slices.view(-1, d)[:hi - lo].copy_(emb[lo:hi])
            slices.grad = torch.zeros_like(slices)
            slices.grad.view(-1, d)[:hi - lo].copy_(emb.grad[lo:hi])
            optimizer.table.step()
            emb.copy_(all_gather(slices, tiled=True, mesh=mesh)[:n_nodes])
        optimizer.rest.step()
        return trio[0] / total, trio[1] / total

    step.sample, step.mesh = sample, mesh
    step.init_optimizer = init_optimizer
    return step


class ShardedRowFetch(torch.autograd.Function):
    """The rows a tp group's requesters ask of a row-sharded table
    (``_make_sharded_row_fetch``).

    ``apply(emb_dm, owned, loc_ids)``: ``emb_dm`` [n, n_loc, D] is the
    table's n slices; ``owned`` bool and ``loc_ids`` int32 [n, n * cap] say,
    for each owner and each requested id (the requesters' frontiers
    concatenated, their ``all_gather``), whether the owner holds that row
    and at which local row (clipped into the slice). Forward: each owner's
    masked take from its slice, and one ``psum_scatter`` routes requester r
    its [cap, D] rows: [n, cap, D]. Backward: the ``all_gather`` of the
    requesters' row cotangents, masked by the owner, then for each owner n
    sorted segment-sums into its slice, one per requester's chunk, through
    ``data/sampling._sorted_accumulate`` (kernel B2 on the card). Each
    chunk is a frontier, sorted-unique, so its clipped local ids stay
    sorted, and the rows an owner does not hold add zeros.

    ``apply(emb_dm, owned, loc_ids, mesh)``, with a ``mesh`` whose
    processes split the tp group: ``emb_dm``, ``owned`` and ``loc_ids``
    hold this process's k owners (the same shards are its requesters) and
    the forward returns its requesters' rows [k, cap, D]; the
    ``psum_scatter`` and the cotangents' ``all_gather`` run across the
    processes, and each owner still sums all n requesters' chunks.
    """

    @staticmethod
    def forward(ctx, emb_dm, owned, loc_ids, mesh=None):
        ctx.save_for_backward(owned, loc_ids)
        ctx.n_loc, ctx.dtype, ctx.mesh = emb_dm.shape[1], emb_dm.dtype, mesh
        owner = torch.arange(emb_dm.shape[0], device=emb_dm.device)[:, None]
        contrib = torch.where(owned[..., None], emb_dm[owner, loc_ids.long()],
                              torch.zeros((), dtype=emb_dm.dtype,
                                          device=emb_dm.device))
        return psum_scatter(contrib, mesh)

    @staticmethod
    def backward(ctx, g_rows):
        owned, loc_ids = ctx.saved_tensors
        cap = g_rows.shape[1]
        # psum_scatter's transpose: every owner sees every requester's rows.
        g_all = all_gather(g_rows, tiled=True, mesh=ctx.mesh)
        zero = torch.zeros((), dtype=g_all.dtype, device=g_all.device)
        slices = []
        for o in range(owned.shape[0]):
            g_o = torch.where(owned[o][:, None], g_all, zero)
            parts = [sampling._sorted_accumulate(
                g_o[r * cap:(r + 1) * cap], loc_ids[o, r * cap:(r + 1) * cap],
                ctx.n_loc) for r in range(g_all.shape[0] // cap)]
            slices.append(psum(parts))
        return torch.stack(slices).to(ctx.dtype), None, None, None


def build_sampled_train_step_zero3(csr, model_cfg: ModelConfig,
                                   train_cfg: TrainConfig, mesh: Mesh, *,
                                   fanouts: Sequence[int] = (15, 10),
                                   mode: str = "uniform",
                                   table_opt: str = "sgd"):
    """The data-parallel step with the embedding table itself sharded
    (``build_sampled_train_step_zero3``).

    The table is a [n_tp, n_loc, D] leaf (``step.to_sharded`` /
    ``step.to_full`` convert it, ``step.shard_params`` /
    ``step.full_params`` a parameter dict), row slice t owned by tp index
    t. Each
    shard samples its frontier; each tp group gathers its shards' frontier
    ids and fetches their rows from the owners (:class:`ShardedRowFetch`),
    which feed ``encoder_apply_sampled(x0=rows)``. The gradient of each
    slice is local: the owners' sorted sums of their rows' cotangents. On
    an (n_dp, n_tp) mesh each dp row fetches from its own replica of the
    slices and serves only its own requesters; the replicas' slice
    gradients are then summed over dp. Clip: the global norm over the
    slices and the other leaves. ``table_opt="sgd"`` steps the slices with
    the clip-free optimizer (adam by default), ``"adafactor"`` with
    :func:`factored_slice_update` over the tp slices (no clip allowed);
    ``step.init_optimizer(params)`` builds the :class:`SplitOptimizer`.
    ``step.eval_batch(params, pos_mask, generator)`` is the sharded sampled
    validation of one [B, 4] batch, (loss_sum, correct, count). The flat
    n_dp * n_tp mesh gives the same parameters as the (n_dp, n_tp) one, up
    to summation order.

    Across processes: where a tp row is split over them (a 1-D mesh, or
    an (n_dp, n_tp) mesh with more processes than rows) each process
    holds the slices of its own shards' tp indices, [k, n_loc, D]
    (``step.owners``), the fetch runs across the row's processes
    (``mesh.tp_axis``) and the clip sums the slices' squared norms across
    them; ``step.to_full`` and ``step.full_params`` gather the slices, so
    every process calls them. The dp sum of the slice gradients runs
    across the processes that hold the same slices (``mesh.dp_axis``); a
    process that holds whole dp rows holds the whole table, and then only
    that sum crosses processes.
    """
    if table_opt not in ("sgd", "adafactor"):
        raise ValueError(f"unknown table_opt {table_opt!r}")
    factored = table_opt == "adafactor"
    if factored and train_cfg.grad_clip:
        # The factored rule clips its own update (block RMS), as on one
        # device; a global-norm clip on top would train another rule.
        raise ValueError(
            "--table_opt adafactor cannot honor global-norm grad_clip; "
            "disable --grad_clip")
    dev = mesh.device
    sample = _sampler(csr, fanouts, mode, dev, allow_ident=False)
    n_tp = mesh.n_tp
    n_nodes = model_cfg.num_nodes
    n_loc = -(-n_nodes // n_tp)
    pad_rows = n_tp * n_loc - n_nodes
    # The mesh's axes that cross processes: a tp row split over them (a
    # 1-D mesh's one row among them), the dp axis of several rows.
    tp_across, dp_across = mesh.tp_axis, mesh.dp_axis
    owners = tp_across.local if tp_across is not None else range(n_tp)
    row_valid = (torch.arange(n_tp * n_loc, device=dev)
                 < n_nodes).float().view(n_tp, n_loc)[owners.start:
                                                      owners.stop]
    offsets = torch.arange(owners.start, owners.stop,
                           device=dev)[:, None] * n_loc
    ends = (offsets + n_loc).clamp(max=n_nodes)

    def to_sharded(emb_full: torch.Tensor) -> torch.Tensor:
        return F.pad(emb_full, (0, 0, 0, pad_rows)).view(
            n_tp, n_loc, -1)[owners.start:owners.stop]

    def to_full(emb_dm: torch.Tensor) -> torch.Tensor:
        return all_gather(emb_dm, mesh=tp_across).reshape(
            n_tp * n_loc, -1)[:n_nodes]

    def shard_params(params: Params) -> Params:
        """A new parameter dict whose table is a sharded copy of
        ``params``'s, a leaf that requires grad (the step's layout)."""
        emb, rest = _split_emb(params)
        return _merge_emb(rest, to_sharded(emb.detach()).clone()
                          .requires_grad_(True))

    def full_params(params: Params) -> Params:
        """``params`` with the table gathered whole, [N, D] (a view on one
        process)."""
        emb, rest = _split_emb(params)
        return _merge_emb(rest, to_full(emb))

    def fetch(emb_dm: torch.Tensor, batches) -> torch.Tensor:
        """One tp group's frontier rows, [n_tp, cap, D] (across processes
        this process's requesters'). Sentinel ids and pad rows are owned
        by nobody: their rows are zero."""
        all_ids = all_gather([b.frontier for b in batches], tiled=True,
                             mesh=tp_across)
        owned = (all_ids >= offsets) & (all_ids < ends)
        loc_ids = (all_ids - offsets).clamp(0, n_loc - 1).to(torch.int32)
        return ShardedRowFetch.apply(emb_dm, owned, loc_ids, tp_across)

    def fetch_all(replicas, shards) -> List[Optional[torch.Tensor]]:
        """Each shard's frontier rows, by flat index (None: another
        process's)."""
        rows: List[Optional[torch.Tensor]] = [None] * mesh.n_shards
        for emb_dm, group in zip(replicas, shard_groups(mesh)):
            for s, r in zip(group, fetch(emb_dm,
                                         [shards[s][1] for s in group])):
                rows[s] = r
        return rows

    def init_optimizer(params: Params) -> SplitOptimizer:
        emb_dm, rest = _split_emb(params)
        table = (factored_slice_init(n_loc, emb_dm.shape[-1], device=dev,
                                     n_slices=len(owners)) if factored
                 else make_optimizer(train_cfg, [emb_dm]))
        return SplitOptimizer(make_optimizer(train_cfg, rest), table,
                              mesh=tp_across)

    def step(params: Params, optimizer: SplitOptimizer,
             pos_edges: torch.Tensor, generator: torch.Generator, *,
             cands=None, draw=None, enc_mask=None):
        shards = _draw_shards(pos_edges, mesh.n_shards, model_cfg, train_cfg,
                              generator, sample, cands=cands, draw=draw,
                              enc_mask=enc_mask, local=_local(mesh))
        emb_dm, rest = _split_emb(params)
        optimizer.zero_grad(set_to_none=True)
        # Each dp row's replica of the slices: a view of the one table with
        # a gradient of its own, that row's partial gradient.
        replicas = [emb_dm.detach().requires_grad_(True)
                    for _ in shard_groups(mesh)]
        trio = _backward_stats(params, shards, model_cfg,
                               x0s=fetch_all(replicas, shards), mesh=mesh)
        total = trio[2].clamp(min=1.0)
        g_emb = psum([r.grad / total for r in replicas], dp_across)
        rest_grads = [p.grad for p in param_leaves(rest) if p.grad is not None]
        all_reduce_(rest_grads, mesh)
        for g in rest_grads:
            g.div_(total)
        if train_cfg.grad_clip and train_cfg.grad_clip > 0:
            # The slices partition the rows: their squared norms add up to
            # the dense table's.
            if tp_across is None:
                clip_by_global_norm_([g_emb, *rest_grads],
                                     train_cfg.grad_clip)
            else:
                clip_by_global_norm_(rest_grads, train_cfg.grad_clip,
                                     sharded=[g_emb], mesh=tp_across)
        emb_dm.grad = g_emb
        with torch.no_grad():
            if factored:
                upd, state = factored_slice_update(
                    g_emb, optimizer.table, axis_name="tp",
                    row_valid=row_valid, n_valid=n_nodes, lr=train_cfg.lr,
                    mesh=tp_across)
                emb_dm.add_(upd.to(emb_dm.dtype))
                optimizer.table.update(state)
            else:
                optimizer.table.step()
        optimizer.rest.step()
        return trio[0] / total, trio[1] / total

    def eval_batch(params: Params, pos_mask: torch.Tensor,
                   generator: torch.Generator, *, cands=None, draw=None):
        """[3] (loss_sum, correct, count) of one [B, 4] (head, tail, rel,
        valid) batch, with the same sharded fetch and no dropout, summed
        across processes; add them over the batches for exact epoch
        means."""
        shards = _draw_shards(pos_mask, mesh.n_shards, model_cfg, train_cfg,
                              generator, sample, cands=cands, draw=draw,
                              train=False, local=_local(mesh))
        emb_dm = params["encoder"]["node_emb"]
        with torch.no_grad():
            return psum([_shard_stats(
                params, shards, model_cfg, train=False,
                x0s=fetch_all([emb_dm] * len(shard_groups(mesh)), shards))],
                mesh)

    step.sample, step.mesh, step.owners = sample, mesh, owners
    step.init_optimizer = init_optimizer
    step.to_full, step.to_sharded = to_full, to_sharded
    step.shard_params, step.full_params = shard_params, full_params
    step.eval_batch = eval_batch
    return step


class SampledEpoch:
    """The one-device sampled epoch as the JAX trainer runs it: the whole
    batches in chunks of K = ``train_cfg.steps_per_scan`` steps (0:
    ``graphs.DEFAULT_STEPS_PER_GRAPH``), then the remaining steps
    one at a time, the wrapped last batch among them. Through ``graphs``
    each chunk, and each lone step, is a CUDA graph on the card and its
    eager body on the CPU; with ``graphs`` None every step runs eagerly.

    ``epoch(order)`` takes the epoch's batches, flat (``steps * B``
    indices into ``train_edges``, int64 [n, 3] on the device), copies them
    to the device once, into a buffer that each step reads at a step
    counter on the device and advances, and returns [steps, 2] (loss, acc)
    on the device. ``step_fn`` is a one-device
    :func:`build_sampled_train_step`, or a data-parallel step, which the
    JAX trainer does not chunk: its epoch takes ``graphs`` None."""

    def __init__(self, step_fn, params: Params, optimizer,
                 train_edges: torch.Tensor, generator: torch.Generator,
                 train_cfg: TrainConfig, *,
                 graphs: Optional[StepGraphs] = None):
        self.step_fn, self.params, self.optimizer = step_fn, params, optimizer
        self.train_edges, self.generator = train_edges, generator
        self.graphs = graphs
        n, b = train_edges.shape[0], train_cfg.batch_size
        self.steps = -(-n // b)
        self.n_full = n // b  # chunks take whole batches
        self.k = min(steps_per_graph(train_cfg.steps_per_scan),
                     self.n_full)
        device = train_edges.device
        # Read and written by every replay: allocated once.
        self.batches = torch.empty(self.steps, b, dtype=torch.long,
                                   device=device)
        self.stats = torch.zeros(self.steps, 2, device=device)
        self.slot = torch.zeros((), dtype=torch.long, device=device)

    def _step(self) -> None:
        at = self.slot.view(1)
        pos = self.train_edges.index_select(
            0, self.batches.index_select(0, at).view(-1))
        loss, acc = self.step_fn(self.params, self.optimizer, pos,
                                 self.generator)
        self.stats.index_copy_(0, at, torch.stack([loss, acc])[None])
        self.slot.add_(1)

    def __call__(self, order: np.ndarray) -> torch.Tensor:
        self.batches.copy_(torch.from_numpy(
            np.asarray(order, np.int64).reshape(self.batches.shape)))
        self.slot.zero_()
        chunked = self.n_full // self.k * self.k if self.k > 1 else 0
        run_segments(self.graphs, "steps", self._step, chunked, self.k)
        run_segments(self.graphs, "steps", self._step,
                     self.steps - chunked, 1)
        return self.stats.clone()


# The cached trainer warm-starts its histories with one full-graph conv1
# pass on graphs of at most this many padded edges; larger ones (config 5's
# 100M) start cold.
CACHE_WARM_MAX_EDGES = 20_000_000


class SampledTrainer(Trainer):
    """Host-driven mini-batch trainer over sampled neighbourhoods, on one
    device or data-parallel over the shards of a mesh on it.

    The epoch order is the JAX trainer's: ``np.random.default_rng(seed +
    start_epoch)`` permutes the training edges each epoch and the last
    batch wraps around to the permutation's start. ``n_devices`` > 1 runs
    the data-parallel step over that many shards: the dp step, or with
    ``zero1`` / ``zero3`` the sharded-optimizer / sharded-table one;
    ``zero3`` with ``dp_pods`` > 1 on a (dp_pods, n_devices / dp_pods)
    mesh, and with ``table_opt="adafactor"`` the factored table rule (as
    ``sparse_emb`` with it on one device). ``cache_layer1`` (one device,
    with ``sparse_emb``) trains the cached step over the combined layout;
    its histories start as one full-graph conv1 pass of the initial
    parameters (kernel B1 on the card) on graphs of at most
    ``CACHE_WARM_MAX_EDGES`` padded edges, else as zeros, and ride in the
    checkpoints' optimizer state. On one device the epoch is a
    :class:`SampledEpoch`, its chunks CUDA graphs on the card, and the
    full-graph validation one graph; the data-parallel steps and the
    sampled validation run eagerly. Every combination the JAX trainer
    refuses raises ``ValueError`` with its message. Validation
    encodes the full graph once per epoch (``train/loop.build_eval_epoch``;
    with zero3 from the gathered table), or, with ``val_sampled``, scores
    each batch through its sampled encode, through the sharded fetch with
    zero3. ``models/best_model.pt`` is written on each new best validation
    loss and ``models/final_model.pt`` after every epoch (the resume point);
    a zero3 checkpoint holds the full [N, D] table, so evaluation and
    serving load it unchanged, and its per-slice optimizer state. The
    checkpoint layout, ``metrics.jsonl`` and ``resume`` are the
    :class:`~primekg_rgcn_tpu_torch.train.loop.Trainer`'s.
    """

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 graph, full_graph, train_edges: np.ndarray,
                 val_edges: np.ndarray, output_dir, *,
                 fanouts: Sequence[int] = (15, 10), mode: str = "uniform",
                 n_devices: Optional[int] = None, zero1: bool = False,
                 zero3: bool = False, dp_pods: int = 0,
                 sparse_emb: bool = False, val_sampled: bool = False,
                 table_opt: str = "sgd", cache_layer1: bool = False,
                 device="cuda", args=None):
        multi = bool(n_devices and n_devices > 1)
        # Sharding flags must not degrade silently (the JAX trainer's
        # refusals, in its order and words).
        if (zero1 or zero3 or dp_pods) and not multi:
            raise ValueError(
                "--zero1/--zero3/--dp_pods need a multi-device mesh: pass "
                "--shard (and --n_devices > 1) to enable one")
        if sparse_emb and multi:
            raise ValueError(
                "--sparse_emb is the single-chip memory mode; the "
                "multi-device analogue is --zero3 (sharded table)")
        if cache_layer1 and multi:
            raise ValueError(
                "--cache_layer1 is the single-chip historical-embedding "
                "mode; sharded layouts keep exact frontier collectives "
                "(a sharded history table is future work)")
        if cache_layer1 and not sparse_emb:
            raise ValueError("--cache_layer1 requires --sparse_emb (it "
                             "extends the single-chip sparse-table step)")
        if table_opt != "sgd" and multi and not zero3:
            raise ValueError(
                "--table_opt with a multi-device mesh requires --zero3 "
                "(per-slice factored stats); --zero1/--dp layouts train "
                "the dense optimizer and would ignore it")
        if dp_pods and dp_pods > 1 and not zero3:
            raise ValueError("--dp_pods requires --zero3")
        if multi and zero1 and zero3:
            raise ValueError("--zero1 and --zero3 are exclusive")
        if multi and zero3 and dp_pods and dp_pods > 1 and \
                n_devices % dp_pods:
            raise ValueError(f"--dp_pods {dp_pods} must divide the "
                             f"{n_devices}-device mesh")
        if not multi:
            if table_opt != "sgd" and not sparse_emb:
                raise ValueError("--table_opt needs --sparse_emb")
            if sparse_emb and table_opt == "sgd" and (
                    train_cfg.optimizer != "sgd" or train_cfg.grad_clip
                    or train_cfg.weight_decay):
                raise ValueError(
                    "sparse_emb requires --optimizer sgd with grad_clip "
                    "disabled: the embedding update is a -lr*g scatter, so "
                    "any rule coupling the table with other leaves (adam "
                    "moments, global-norm clip) would diverge from the "
                    "dense step — or pass --table_opt adafactor, whose "
                    "factored adaptive rule lifts the restriction on the "
                    "rest params")
            if sparse_emb and table_opt != "sgd" and train_cfg.grad_clip:
                raise ValueError(
                    "--table_opt adafactor cannot honor global-norm "
                    "grad_clip (the table gradient is updated separately "
                    "from the rest); disable --grad_clip")
        self._setup(model_cfg, train_cfg, output_dir, device, args,
                    train_edges)
        # Resolve the pick layout once; the step and the sampled validation
        # share the CSR. The cache needs the combined layout.
        csr_like = resolve_sampler(
            graph, fanouts, "combined" if cache_layer1 else "auto",
            mode=mode)[0]
        kw = dict(fanouts=fanouts, mode=mode)
        self._zero3 = bool(multi and zero3)
        if multi:
            mesh = (make_mesh_2d(dp_pods, n_devices // dp_pods, self.device)
                    if zero3 and dp_pods and dp_pods > 1
                    else make_mesh(n_devices, self.device))
            if zero3:
                self.step_fn = build_sampled_train_step_zero3(
                    csr_like, model_cfg, train_cfg, mesh,
                    table_opt=table_opt, **kw)
                self.params = self.step_fn.shard_params(self.params)
            elif zero1:
                self.step_fn = build_sampled_train_step_zero1(
                    csr_like, model_cfg, train_cfg, mesh, **kw)
            else:
                self.step_fn = build_sampled_train_step_dp(
                    csr_like, model_cfg, train_cfg, mesh, **kw)
            logger.info("SampledTrainer: %s over a %d x %d mesh on %s",
                        "zero3" if zero3 else "zero1" if zero1 else "dp",
                        mesh.n_dp, mesh.n_tp, self.device)
        else:
            cache_init = None
            if cache_layer1 and \
                    graph.padded_num_edges <= CACHE_WARM_MAX_EDGES:
                # Warm start: every history row exact for the initial
                # parameters, instead of zeros that the first N / |seeds|
                # steps would aggregate.
                enc = self.params["encoder"]
                with torch.no_grad():
                    cache_init = rgcn_layer_segment(
                        enc["conv1"], enc["node_emb"], graph.to(self.device),
                        compute_dtype=compute_dtype(model_cfg))
            self.step_fn = build_sampled_train_step(
                csr_like, model_cfg, train_cfg, sparse_emb=sparse_emb,
                table_opt=table_opt, cache_layer1=cache_layer1,
                cache_init=cache_init, device=self.device, **kw)
        self.optimizer = self.step_fn.init_optimizer(self.params)
        if not multi:
            self.graphs = StepGraphs(self.device, self.device_gen)
        self.train_edges = torch.from_numpy(
            np.asarray(train_edges, np.int64)).to(self.device)
        self._epoch = SampledEpoch(self.step_fn, self.params, self.optimizer,
                                   self.train_edges, self.device_gen,
                                   train_cfg, graphs=self.graphs)
        if val_sampled and self._zero3:
            self.eval_epoch_fn = self._sharded_eval(np.asarray(val_edges))
        elif val_sampled:
            self.eval_epoch_fn = build_sampled_eval_epoch(
                csr_like, np.asarray(val_edges), model_cfg, train_cfg,
                device=self.device, **kw)
        else:
            full_eval = build_eval_epoch(
                full_graph.to(self.device), np.asarray(val_edges), model_cfg,
                train_cfg, graphs=self.graphs)
            self.eval_epoch_fn = lambda params, gen: full_eval(
                self._full_params(params), gen)

    def _full_params(self, params: Params) -> Params:
        """``params`` with the table whole, [N, D] (zero3 gathers its
        slices)."""
        return self.step_fn.full_params(params) if self._zero3 else params

    def _saved_params(self) -> Params:
        return self._full_params(self.params)

    def _restore_params(self, params: Params) -> None:
        if self._zero3:
            emb, rest = _split_emb(params)
            params = _merge_emb(rest, self.step_fn.to_sharded(emb))
        super()._restore_params(params)

    def _sharded_eval(self, val_edges: np.ndarray):
        """zero3's sampled validation: each batch of ``val_edges`` (padded
        with weight-0 rows) through ``step.eval_batch``; the table never
        gathers."""
        b = self.train_cfg.batch_size
        n_steps = max(-(-len(val_edges) // b), 1)
        padded = np.zeros((n_steps * b, 4), np.int64)
        padded[:len(val_edges), :3] = val_edges
        padded[:len(val_edges), 3] = 1
        batches = torch.from_numpy(padded).to(self.device).view(n_steps, b, 4)
        eval_batch = self.step_fn.eval_batch

        def eval_fn(params: Params, generator: torch.Generator):
            tot = psum([eval_batch(params, batch, generator)
                        for batch in batches])
            denom = tot[2].clamp(min=1.0)
            return tot[0] / denom, tot[1] / denom

        return eval_fn

    def train(self) -> Dict:
        cfg = self.train_cfg
        b = cfg.batch_size
        n = self.num_train_edges
        steps = -(-n // b)
        rng = np.random.default_rng(cfg.seed + self.epoch)
        logger.info("Starting sampled training for %d epochs (batch %d, lr "
                    "%g) on %s", cfg.epochs, b, cfg.lr, self.device)
        t_start = time.time()
        epoch_times = []
        for epoch in range(self.epoch + 1, cfg.epochs + 1):
            self.epoch = epoch
            te = time.time()
            perm = rng.permutation(n)
            # The last batch wraps around to the permutation's start.
            order = np.concatenate([perm, perm[:steps * b - n]])
            stats = self._epoch(order)
            val_loss, val_acc = self.eval_epoch_fn(self.params,
                                                   self.device_gen)
            # The one host read of the epoch.
            vals = torch.cat([stats.view(-1),
                              torch.stack([val_loss, val_acc])]).tolist()
            tr_loss = float(np.mean(vals[0:2 * steps:2]))
            tr_acc = float(np.mean(vals[1:2 * steps:2]))
            val_loss, val_acc = vals[-2:]
            check_same_across(val_loss, self.device, "the validation loss")
            epoch_time = time.time() - te
            epoch_times.append(epoch_time)
            for k, v in (("train_losses", tr_loss), ("val_losses", val_loss),
                         ("train_accs", tr_acc), ("val_accs", val_acc)):
                self.history[k].append(v)
            edges_per_s = n / max(epoch_time, 1e-9)
            logger.info(
                "Epoch %d/%d | Time: %.2fs | Sampled Train Loss: %.4f | "
                "Train Acc: %.4f | Val Loss: %.4f | Val Acc: %.4f | %.0f "
                "edges/s", epoch, cfg.epochs, epoch_time, tr_loss, tr_acc,
                val_loss, val_acc, edges_per_s)
            self.metrics.log(
                "epoch", epoch=epoch, train_loss=tr_loss, train_acc=tr_acc,
                val_loss=val_loss, val_acc=val_acc,
                epoch_time_s=round(epoch_time, 3),
                edges_per_s=round(edges_per_s, 1),
                **{f"mem_{k}": v
                   for k, v in device_memory_stats(self.device).items()})
            if val_loss < self.best_val_loss:
                self.best_val_loss = val_loss
                self.save_checkpoint(is_best=True)
            self.best_val_acc = max(self.best_val_acc, val_acc)
            self.save_checkpoint(is_final=True)
            # The full-graph Trainer's quirk-preserving window.
            if cfg.early_stopping > 0 and \
                    len(self.history["val_losses"]) > cfg.early_stopping:
                recent = self.history["val_losses"][-cfg.early_stopping:]
                if all(r >= recent[0] for r in recent):
                    logger.info("Early stopping at epoch %d", epoch)
                    break
        total = time.time() - t_start
        logger.info("Sampled training completed in %.2fs (best val loss "
                    "%.4f)", total, self.best_val_loss)
        self.metrics.close()
        return {
            "total_time_s": total,
            "epoch_times_s": epoch_times,
            "best_val_loss": self.best_val_loss,
            "best_val_acc": self.best_val_acc,
            "history": self.history,
        }
