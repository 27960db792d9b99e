"""Full-graph training on one device: optimizer, loss, step, epochs and the
Trainer.

The counterpart of ``primekg_rgcn_tpu/train/loop.py``. There an epoch is
``lax.scan`` segments of ``steps_per_scan`` updates; here it is segments of
that many updates captured as CUDA graphs and replayed
(``train/graphs.py``), or, on the CPU, the same bodies run eagerly. What the
JAX host sees is kept: shuffling, negative sampling, the full-graph encode,
the BCE loss, gradient accumulation, clipping and the optimizer update all
stay on the device, and the host reads one (loss, accuracy) pair per
epoch, with no ``.item()`` per step. The one exception is the
batch-restricted final layer (``final_plan``): it reads its overflow flags
once per update, where the JAX package branches on the device.

Semantics kept from the JAX package:

- every batch differentiates through the full-graph encoder forward; the
  encoder's gradient goes through kernel B1's transpose-graph backward;
- the last partial batch is padded with a sentinel edge index of weight 0,
  so its loss is the mean over its real rows only;
- gradient accumulation averages the micro-batch gradients before the clip
  and the step;
- the global-norm clip has no epsilon (``optax.clip_by_global_norm``);
- adam with weight decay is coupled L2 (``torch.optim.Adam``), adamw is
  decoupled (``torch.optim.AdamW``), sgd is plain; eps 1e-8, betas
  (0.9, 0.999), as optax's defaults;
- validation encodes the full graph once and scores every batch against the
  cached embeddings;
- ``TrainConfig.restrict_final`` resolves the batch-restricted final layer's
  plan once per trainer (``ops/rgcn_final_layer.resolve_final_plan``); the
  sampled and node-sharded trainers and validation do not use it.

Random numbers come from two explicit generators: one on the CPU (the
initial parameters and each epoch's permutation, the same on any device for
a seed) and one on the training device (negatives and dropout masks).
"""

from __future__ import annotations

import argparse
import functools
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.data.graph import RelGraph
from primekg_rgcn_tpu_torch.device import resolve_device
from primekg_rgcn_tpu_torch.models.rgcn import (Params, encoder_apply,
                                                init_params, model_apply,
                                                param_leaves)
from primekg_rgcn_tpu_torch.ops.distmult import distmult_score
from primekg_rgcn_tpu_torch.ops.rgcn_final_layer import (
    BatchRanges, FinalLayerPlan, final_layer_ranges, final_layer_restricted,
    resolve_final_plan)
from primekg_rgcn_tpu_torch.ops.rgcn_segment import rgcn_layer_segment
from primekg_rgcn_tpu_torch.parallel.mesh import (check_same_across,
                                                  process_group_size)
from primekg_rgcn_tpu_torch.train import checkpoint as ckpt_lib
from primekg_rgcn_tpu_torch.train.graphs import (StepGraphs, run_segments,
                                                 steps_per_graph)
from primekg_rgcn_tpu_torch.train.neg_sampling import (bce_stats,
                                                       candidate_batch)
from primekg_rgcn_tpu_torch.train.torch_interop import state_dict_from_params
from primekg_rgcn_tpu_torch.utils import telemetry
from primekg_rgcn_tpu_torch.utils.telemetry import (MetricsLogger,
                                                    device_memory_stats)

logger = logging.getLogger(__name__)

# (heads, tails, rels, labels, weights) of one scoring batch.
Candidates = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                   torch.Tensor]


def make_optimizer(cfg: TrainConfig,
                   params: Union[Params, Sequence[torch.Tensor]]
                   ) -> torch.optim.Optimizer:
    """The optimizer over the parameter leaves (a parameter dict, or the
    tensors themselves), matching the JAX package's optax chain without its
    clip: ``make_optimizer(cfg, include_clip=False)``. The clip is
    :func:`clip_by_global_norm_`, which :func:`apply_update` runs before
    the step; the sharded sampled steps clip the full gradient themselves
    and then step the table's row slices with an optimizer of their own
    (``train/sampled.py``). Every rule here is elementwise but for the step
    count, so one optimizer over a stacked [n, n_loc, D] tensor of row
    slices keeps exactly each slice's state and update.

    On CUDA, adam and adamw are ``capturable``: their step count lives on
    the device, so a CUDA graph can replay the update (without it the bias
    correction reads a host count). The eager path on the card takes the
    same rule, so that the two agree bit for bit. The CPU keeps
    ``capturable=False``, which is all torch allows there; a loaded state
    keeps the optimizer's own setting (:func:`_keep_capturable`)."""
    leaves = (list(param_leaves(params)) if isinstance(params, dict)
              else list(params))
    adam = dict(lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=cfg.weight_decay,
                capturable=bool(leaves) and leaves[0].is_cuda)
    if cfg.optimizer in ("adam", "adamw"):
        # adam: coupled L2, decay joins the gradient before the moments, as
        # add_decayed_weights before scale_by_adam; adamw: decoupled.
        cls = torch.optim.Adam if cfg.optimizer == "adam" else \
            torch.optim.AdamW
        opt = cls(leaves, **adam)
        opt.register_load_state_dict_post_hook(functools.partial(
            _keep_capturable, capturable=adam["capturable"]))
        return opt
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(leaves, lr=cfg.lr,
                               weight_decay=cfg.weight_decay)
    raise ValueError(f"Unknown optimizer: {cfg.optimizer}")


def _keep_capturable(optimizer: torch.optim.Optimizer, *,
                     capturable: bool) -> None:
    """``load_state_dict`` takes the saved groups' hyperparameters,
    ``capturable`` among them: a state saved on the CPU, or before the rule
    was capturable, would turn it off on the card, and one saved on the
    card would turn it on on the CPU. Keep the optimizer's own setting;
    a capturable rule's step counts go to their parameters' device as
    float32."""
    for group in optimizer.param_groups:
        group["capturable"] = capturable
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            if capturable and "step" in state:
                state["step"] = torch.as_tensor(
                    state["step"], dtype=torch.float32).to(p.device)


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float, *,
                         sharded: Optional[torch.Tensor] = None,
                         sharded_sq: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` where their global L2
    norm exceeds ``max_norm``, with no epsilon, as
    ``optax.clip_by_global_norm`` (``torch.nn.utils.clip_grad_norm_``
    divides by ``norm + 1e-6``). Returns the norm as a 0-d tensor on the
    device, without a host synchronise. ``sharded`` is this process's
    slices of a gradient split over processes, ``sharded_sq`` the whole
    gradient's squared norm (``parallel/mesh.Slices.sq_norm``): it counts
    in the norm, and ``sharded`` is scaled too."""
    norms = [torch.linalg.vector_norm(g) for g in grads]
    if sharded is not None:
        norms.insert(0, sharded_sq.sqrt())
    norm = torch.linalg.vector_norm(torch.stack(norms))
    factor = torch.where(norm > max_norm, max_norm / norm,
                         torch.ones_like(norm))
    for g in ((sharded,) if sharded is not None else ()) + tuple(grads):
        g.mul_(factor)
    return norm


def edges_with_sentinel(edges: np.ndarray, device) -> torch.Tensor:
    """[E+1, 3] int64 (head, tail, rel) rows on ``device``; row E is the
    sentinel that padded batch slots index (weight 0)."""
    pad = np.concatenate([np.asarray(edges, np.int64),
                          np.zeros((1, 3), np.int64)], axis=0)
    return torch.from_numpy(pad).to(device)


def sample_candidates(edges_pad: torch.Tensor, batch_idx: torch.Tensor,
                      num_nodes: int, num_neg_samples: int, *,
                      generator: Optional[torch.Generator] = None
                      ) -> Candidates:
    """The batch's positives (slots equal to E are padding) and their
    negatives, as ``candidate_batch`` lays them out."""
    mask = batch_idx < edges_pad.shape[0] - 1
    batch = edges_pad[batch_idx]
    return candidate_batch(batch[:, 0], batch[:, 1], batch[:, 2], num_nodes,
                           num_neg_samples, mask=mask, generator=generator)


def loss_from_candidates(params: Params, graph: RelGraph, heads, tails, rels,
                         labels, weights, model_cfg: ModelConfig, *,
                         train: bool,
                         generator: Optional[torch.Generator] = None,
                         enc_mask: Optional[torch.Tensor] = None,
                         dec_mask: Optional[torch.Tensor] = None,
                         layer_fn=rgcn_layer_segment,
                         final_plan: Optional[FinalLayerPlan] = None,
                         final_ranges: Optional[BatchRanges] = None):
    """Masked BCE-with-logits loss of one candidate batch through the
    full-graph model (the final layer batch-restricted with a
    ``final_plan``, with ``final_ranges`` as ``model_apply`` takes them):
    (loss_mean, (correct, count)), all 0-d tensors."""
    scores = model_apply(params, graph, heads, tails, rels, model_cfg,
                         train=train, generator=generator, enc_mask=enc_mask,
                         dec_mask=dec_mask, layer_fn=layer_fn,
                         final_plan=final_plan, final_ranges=final_ranges)
    loss_sum, correct, count = bce_stats(scores, labels, weights)
    return loss_sum / count.clamp(min=1.0), (correct, count)


def update_step(params: Params, optimizer: torch.optim.Optimizer,
                graph: RelGraph, micro_batches: Sequence[Candidates],
                model_cfg: ModelConfig, train_cfg: TrainConfig, *,
                generator: Optional[torch.Generator] = None,
                final_plan: Optional[FinalLayerPlan] = None) -> torch.Tensor:
    """One optimizer update over the micro-batches: the mean of their loss
    gradients, clipped by global norm, then the optimizer step. The
    gradient that was applied stays in each leaf's ``.grad``.

    Returns [loss * count, correct, count] summed over the micro-batches,
    on the device."""
    optimizer.zero_grad(set_to_none=True)
    stats = torch.zeros(3, device=graph.src.device)
    for cands in micro_batches:
        loss, (correct, count) = loss_from_candidates(
            params, graph, *cands, model_cfg, train=True,
            generator=generator, final_plan=final_plan)
        loss.backward()
        stats += torch.stack([loss.detach() * count, correct, count])
    apply_update(optimizer, train_cfg, accum=len(micro_batches))
    return stats


def apply_update(optimizer: torch.optim.Optimizer, train_cfg: TrainConfig,
                 accum: int = 1) -> None:
    """Divide the summed ``.grad`` of ``accum`` micro-batches by ``accum``,
    clip it by global norm (when ``grad_clip`` > 0) and take the optimizer
    step."""
    grads = [p.grad for group in optimizer.param_groups
             for p in group["params"] if p.grad is not None]
    if accum > 1:
        for g in grads:
            g.div_(accum)
    if train_cfg.grad_clip and train_cfg.grad_clip > 0:
        clip_by_global_norm_(grads, train_cfg.grad_clip)
    optimizer.step()


def train_step(params: Params, optimizer: torch.optim.Optimizer,
               graph: RelGraph, edges_pad: torch.Tensor,
               batch_indices: torch.Tensor, model_cfg: ModelConfig,
               train_cfg: TrainConfig, *,
               generator: Optional[torch.Generator] = None,
               final_plan: Optional[FinalLayerPlan] = None) -> torch.Tensor:
    """The step ``bench.py`` times: candidates for each micro-batch row of
    ``batch_indices`` [accum, B] (indices into ``edges_pad``), then
    :func:`update_step`. Returns its stats tensor. Without a
    ``final_plan`` nothing is read back to the host; with one, the
    restricted layer reads its overflow flag once per micro-batch."""
    micro = [sample_candidates(edges_pad, bi, graph.num_nodes,
                               train_cfg.num_neg_samples, generator=generator)
             for bi in batch_indices]
    return update_step(params, optimizer, graph, micro, model_cfg, train_cfg,
                       generator=generator, final_plan=final_plan)


def build_train_epoch(graph: RelGraph, edges: np.ndarray,
                      model_cfg: ModelConfig, train_cfg: TrainConfig,
                      params: Params, optimizer: torch.optim.Optimizer, *,
                      graphs: Optional[StepGraphs] = None,
                      plan_edges: Optional[np.ndarray] = None):
    """One training epoch over ``edges`` ([E, 3] real train edges) on the
    graph's device. Returns ``epoch_fn(host_gen, device_gen) -> (loss,
    acc)``, 0-d tensors on the device; the permutation comes from
    ``host_gen`` (CPU), negatives and dropout from ``device_gen``.

    With ``graphs`` (a :class:`~primekg_rgcn_tpu_torch.train.graphs.
    StepGraphs` whose generator is ``device_gen``) the updates run in
    segments, as the JAX package's scan segments: ``n_updates // K`` of K
    updates, then one of the remainder, K = ``train_cfg.steps_per_scan``
    (0: ``graphs.DEFAULT_STEPS_PER_GRAPH``). Each segment is a CUDA graph
    on the card and its eager body on the CPU. The epoch's batch indices go
    to the device once, into a buffer that each update reads at a step
    counter on the device and advances. With a batch-restricted final
    layer the update splits at its overflow flags, read on the host once
    per update: one graph draws the candidates of every micro-batch and
    their ranges, then each micro-batch's forward and backward (and after
    the last, the clip and the optimizer step) replays the graph of the
    branch its flag picks, whatever K. The gradients then stay in
    tensors of the epoch's own that every micro-batch accumulates into.
    Without ``graphs`` each update runs eagerly through
    :func:`train_step`.

    The batch-restricted final layer's plan is resolved here, once, per
    ``train_cfg.restrict_final`` (seeded by ``train_cfg.seed``, as the JAX
    package plans it) from ``plan_edges`` (default: ``edges``; a benchmark
    that runs an epoch over a sample of the edges sizes the plan on all of
    them), and kept as ``epoch_fn.final_plan`` (None when the full layer
    runs)."""
    device = graph.src.device
    num_edges = int(edges.shape[0])
    b = train_cfg.batch_size
    accum = max(int(train_cfg.gradient_accumulation_steps), 1)
    n_steps = -(-num_edges // b)
    n_updates = -(-n_steps // accum)
    pad = n_updates * accum * b - num_edges
    edges_pad = edges_with_sentinel(edges, device)
    final_plan = resolve_final_plan(graph,
                                    edges if plan_edges is None
                                    else plan_edges, b,
                                    train_cfg.num_neg_samples,
                                    seed=train_cfg.seed,
                                    mode=train_cfg.restrict_final)
    # What every update reads and writes across replays.
    idx = torch.empty(n_updates, accum, b, dtype=torch.long, device=device)
    slot = torch.zeros((), dtype=torch.long, device=device)
    stats = torch.zeros(3, device=device)
    update_stats = torch.zeros(3, device=device)
    leaves = list(param_leaves(params))
    grads: List[torch.Tensor] = []

    def candidates(gen):
        bi = idx.index_select(0, slot.view(1))[0]
        slot.add_(1)
        return [sample_candidates(edges_pad, bi[a], graph.num_nodes,
                                  train_cfg.num_neg_samples, generator=gen)
                for a in range(accum)]

    def update(gen):
        stats.add_(update_step(params, optimizer, graph, candidates(gen),
                               model_cfg, train_cfg, generator=gen))

    def ranges(gen):
        micro = candidates(gen)
        rs = [final_layer_ranges(final_plan, torch.cat([c[0], c[1]]))
              for c in micro]
        return micro, rs, torch.stack([r.ok for r in rs])

    def micro_step(a, cands, r, gen):
        if a == 0:
            optimizer.zero_grad(set_to_none=False)
            update_stats.zero_()
        loss, (correct, count) = loss_from_candidates(
            params, graph, *cands, model_cfg, train=True, generator=gen,
            final_plan=final_plan, final_ranges=r)
        loss.backward()
        update_stats.add_(torch.stack([loss.detach() * count, correct,
                                       count]))
        if a == accum - 1:
            apply_update(optimizer, train_cfg, accum=accum)
            stats.add_(update_stats)

    def restricted_update(gen):
        if not grads:
            grads.extend(torch.zeros_like(p) for p in leaves)
        for p, g in zip(leaves, grads):
            p.grad = g
        micro, rs, ok = graphs.run(("ranges",), lambda: ranges(gen))
        with telemetry.span("restricted.host_read", wait=True):
            flags = ok.tolist()  # the update's one host read
        for a, fits in enumerate(flags):
            final_layer_restricted.fallbacks += not fits
            r = rs[a]._replace(fits=fits)
            # One graph per micro-batch and branch: each reads its own
            # candidates and ranges, at the addresses the ranges graph
            # writes them to.
            graphs.run(("micro", fits, a),
                       functools.partial(micro_step, a, micro[a], r, gen))

    def epoch_fn(host_gen: torch.Generator, device_gen: torch.Generator):
        with telemetry.span("epoch.permute", wait=True):
            perm = torch.randperm(num_edges, generator=host_gen)
            perm = torch.cat([perm, torch.full((pad,), num_edges)])
        if graphs is None:
            batch_indices = perm.view(n_updates, accum, b).to(device)
            total = torch.zeros(3, device=device)
            for u in range(n_updates):
                total += train_step(params, optimizer, graph, edges_pad,
                                    batch_indices[u], model_cfg, train_cfg,
                                    generator=device_gen,
                                    final_plan=final_plan)
            return total[0] / total[2], total[1] / total[2]
        if device_gen is not graphs.generator:
            raise ValueError("the epoch's graphs draw from the generator "
                             "registered with them")
        with telemetry.span("epoch.upload", wait=True):
            idx.copy_(perm.view(n_updates, accum, b))
        slot.zero_()
        stats.zero_()
        if final_plan is not None:
            for _ in range(n_updates):
                with telemetry.span("train.update", updates=1):
                    restricted_update(device_gen)
        else:
            run_segments(graphs, "updates", lambda: update(device_gen),
                         n_updates, steps_per_graph(
                             train_cfg.steps_per_scan))
        return stats[0] / stats[2], stats[1] / stats[2]

    epoch_fn.final_plan = final_plan
    return epoch_fn


def build_eval_epoch(graph: RelGraph, edges: np.ndarray,
                     model_cfg: ModelConfig, train_cfg: TrainConfig, *,
                     graphs: Optional[StepGraphs] = None):
    """A validation epoch: no shuffle, no dropout, one full-graph encode,
    then every batch of ``edges`` with its sampled negatives scored against
    the cached embeddings. Returns ``eval_fn(params, generator) -> (loss,
    acc)``, 0-d tensors on the graph's device.

    With ``graphs`` the whole epoch, the encode and every batch, is one
    graph (the counterpart of the JAX package's one ``jax.jit``), captured
    for the ``params`` of its first calls and ``graphs``' generator: other
    tensors raise ``ValueError``."""
    device = graph.src.device
    num_edges = int(edges.shape[0])
    b = train_cfg.batch_size
    n_steps = -(-num_edges // b)
    edges_pad = edges_with_sentinel(edges, device)
    idx = torch.cat([torch.arange(num_edges),
                     torch.full((n_steps * b - num_edges,), num_edges)])
    idx = idx.view(n_steps, b).to(device)
    result = torch.zeros(2, device=device)
    captured_for: List[Tuple[int, ...]] = []

    def eval_body(params: Params, generator: torch.Generator):
        stats = torch.zeros(3, device=device)
        with torch.no_grad():
            node_emb = encoder_apply(params, graph, model_cfg)
            rel_table = params["decoder"]["rel_emb"]
            for batch_idx in idx:
                heads, tails, rels, labels, weights = sample_candidates(
                    edges_pad, batch_idx, graph.num_nodes,
                    train_cfg.num_neg_samples, generator=generator)
                scores = distmult_score(node_emb[heads], node_emb[tails],
                                        rel_table[rels])
                stats += torch.stack(bce_stats(scores, labels, weights))
        return stats[0] / stats[2], stats[1] / stats[2]

    def eval_fn(params: Params, generator: torch.Generator):
        if graphs is None:
            return eval_body(params, generator)
        ptrs = tuple(p.data_ptr() for p in param_leaves(params))
        if not captured_for:
            captured_for.append(ptrs)
        if ptrs != captured_for[0] or generator is not graphs.generator:
            raise ValueError("the validation graph reads the parameters "
                             "and the generator of its first calls")
        graphs.run(("eval",), lambda: result.copy_(
            torch.stack(eval_body(params, generator))))
        out = result.clone()
        return out[0], out[1]

    return eval_fn


def _copy_params_(dst: Params, src: Params) -> None:
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_params_(v, src[k])
        else:
            v.copy_(src[k])


class Trainer:
    """Epochs, validation, checkpoints, early stopping and resume.

    Checkpoints are reference-layout ``.pt`` files (``train/checkpoint``):
    ``models/best_model.pt`` on each new best validation loss,
    ``checkpoints/checkpoint_epoch_{n}.pt`` every ``save_every`` epochs and
    ``models/final_model.pt`` at the end. The best and periodic ones are
    written by a background thread (``checkpoint.AsyncSaver``) from a host
    copy taken at the call; the final one is written at once, after the
    pending writes. ``resume`` also takes a checkpoint of the JAX package,
    and ``jax_checkpoint_payload`` gives the state in its layout
    (``checkpoint.save_jax``). Each epoch appends one event to
    ``metrics.jsonl``.

    Across processes every process runs this loop and calls each save (the
    snapshot may gather shards); process 0 alone writes the files. The
    best-checkpoint and early-stop decisions read the validation loss,
    whose bits are checked to agree across the processes each epoch.
    """

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 train_graph: RelGraph, full_graph: RelGraph,
                 train_edges: np.ndarray, val_edges: np.ndarray,
                 output_dir, *, device="cuda",
                 args: Optional[argparse.Namespace] = None):
        self._setup(model_cfg, train_cfg, output_dir, device, args,
                    train_edges)
        self.optimizer = make_optimizer(train_cfg, self.params)
        self.graphs = StepGraphs(self.device, self.device_gen)
        self.train_epoch_fn = build_train_epoch(
            train_graph.to(self.device), train_edges, model_cfg, train_cfg,
            self.params, self.optimizer, graphs=self.graphs)
        self.final_plan = self.train_epoch_fn.final_plan
        self.eval_epoch_fn = build_eval_epoch(
            full_graph.to(self.device), val_edges, model_cfg, train_cfg,
            graphs=self.graphs)

    def _setup(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
               output_dir, device, args: Optional[argparse.Namespace],
               train_edges: np.ndarray) -> None:
        """What every trainer holds: device, directories, the CLI namespace,
        both generators, the parameters (from the host generator, then the
        device generator seeded from it), history and metrics. A trainer
        whose epochs run as CUDA graphs sets ``graphs``, its
        :class:`~primekg_rgcn_tpu_torch.train.graphs.StepGraphs`."""
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.output_dir = Path(output_dir)
        self.checkpoint_dir = self.output_dir / "checkpoints"
        self.model_dir = self.output_dir / "models"
        if process_group_size()[1] == 0:
            # Across processes the files are process 0's alone.
            self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
            self.model_dir.mkdir(parents=True, exist_ok=True)
        # The reference's checkpoints carry the CLI namespace; a Trainer
        # built without the CLI records the model's dimensions there.
        self.args = args or argparse.Namespace(
            embedding_dim=model_cfg.embedding_dim,
            hidden_dim=model_cfg.hidden_dim, dropout=model_cfg.dropout,
            decoder_dropout=model_cfg.decoder_dropout,
            num_bases=model_cfg.num_bases)

        self.host_gen = torch.Generator().manual_seed(train_cfg.seed)
        self.params = init_params(self.host_gen, model_cfg,
                                  device=self.device)
        for p in param_leaves(self.params):
            p.requires_grad_(True)
        self.device_gen = torch.Generator(self.device).manual_seed(
            int(torch.randint(2 ** 62, (1,), generator=self.host_gen)))
        self.best_val_loss = float("inf")
        self.best_val_acc = 0.0
        self.history: Dict[str, List[float]] = {
            "train_losses": [], "val_losses": [],
            "train_accs": [], "val_accs": [],
        }
        self.epoch = 0
        self.num_train_edges = int(train_edges.shape[0])
        self.metrics = MetricsLogger(self.output_dir / "metrics.jsonl")
        self.saver = ckpt_lib.AsyncSaver()
        self.graphs: Optional[StepGraphs] = None

    # -- checkpoint plumbing -------------------------------------------------
    def _checkpoint_payload(self) -> Dict[str, Any]:
        return {
            "model_state_dict": state_dict_from_params(self._saved_params()),
            "optimizer_state_dict": self.optimizer.state_dict(),
            "epoch": self.epoch,
            "best_val_loss": self.best_val_loss,
            "best_val_acc": self.best_val_acc,
            "history": self.history,
            "args": self.args,
            "model_config": self.model_cfg.to_dict(),
            "train_config": self.train_cfg.to_dict(),
            # Generator positions, so a resumed run continues the streams
            # instead of replaying earlier epochs' shuffles and negatives.
            "rng_state": self.host_gen.get_state(),
            "device_rng_state": self.device_gen.get_state(),
        }

    def save_checkpoint(self, *, is_best=False, is_final=False):
        payload = self._checkpoint_payload()
        if is_final:
            self.saver.wait_for_saves()
            ckpt_lib.save(self.model_dir / "final_model.pt", payload)
        elif is_best:
            self.saver.save_async(self.model_dir / "best_model.pt", payload)
        else:
            self.saver.save_async(self.checkpoint_dir /
                                  f"checkpoint_epoch_{self.epoch}.pt",
                                  payload)

    def jax_checkpoint_payload(self) -> Dict[str, Any]:
        """This trainer's state as :func:`checkpoint.save_jax` takes it:
        what the JAX trainer of the same layout saves (parameters,
        optimizer state and step; epoch, best values, history and the
        configs), without ``rng_key``, which no torch generator can
        make. ``step`` is the count that the optimizer state keeps (adam,
        the factored table rule), else 0. Across processes every process
        calls it (the sharded leaves are gathered)."""
        opt_state = ckpt_lib.optimizer_state_to_jax(
            self.optimizer, self.params, self.train_cfg)
        return {
            "state": {"params": self._saved_params(),
                      "opt_state": opt_state,
                      "step": torch.tensor(ckpt_lib.jax_step(opt_state),
                                           dtype=torch.int32)},
            "epoch": self.epoch,
            "best_val_loss": self.best_val_loss,
            "best_val_acc": self.best_val_acc,
            "history": self.history,
            "model_config": self.model_cfg.to_dict(),
            "train_config": self.train_cfg.to_dict(),
        }

    def resume(self, path) -> None:
        """Continue from a ``.pt`` checkpoint or a JAX one (its stem,
        ``.msgpack`` or ``.json``): parameters, optimizer state, epoch, best
        values and history. A JAX file's optimizer state is mapped by path
        (``checkpoint.optimizer_state_from_jax``); its ``rng_key`` cannot
        carry over, so both generators are seeded from its
        ``train_config`` seed and its epoch, the same on every resume."""
        payload = ckpt_lib.load(path, device=self.device)
        stored = payload["model_config"]["compute_dtype"]
        if stored != self.model_cfg.compute_dtype:
            raise ValueError(
                f"{path} was trained with compute_dtype {stored!r}, this "
                f"trainer runs {self.model_cfg.compute_dtype!r}")
        self._restore_params(payload["params"])
        from_jax = "opt_state" in payload
        self.optimizer.load_state_dict(
            ckpt_lib.optimizer_state_from_jax(
                self.optimizer, payload["opt_state"], self.params)
            if from_jax else payload["optimizer_state_dict"])
        if self.graphs is not None:
            # The loaded state is new tensors: capture again.
            self.graphs.reset()
        self.epoch = payload["epoch"]
        self.best_val_loss = payload["best_val_loss"]
        self.best_val_acc = payload["best_val_acc"]
        # A JAX sampled run keeps two of the four lists.
        history = {k: [] for k in self.history}
        history.update({k: list(v)
                        for k, v in payload.get("history", {}).items()})
        self.history = history
        if "rng_state" in payload:
            self.host_gen.set_state(payload["rng_state"])
            self.device_gen.set_state(payload["device_rng_state"])
        elif from_jax:
            seed = int(payload["train_config"].get("seed",
                                                   self.train_cfg.seed))
            self.host_gen.manual_seed(int(np.random.SeedSequence(
                [seed, int(self.epoch)]).generate_state(1, np.uint64)[0]))
            self.device_gen.manual_seed(
                int(torch.randint(2 ** 62, (1,), generator=self.host_gen)))
            logger.info(
                "%s is a JAX checkpoint: its jax.random stream (rng_key) "
                "does not carry over; the generators are seeded from seed "
                "%d and epoch %d", path, seed, self.epoch)

    def _saved_params(self) -> Params:
        """The parameters a checkpoint holds (the live ones)."""
        return self.params

    def _restore_params(self, params: Params) -> None:
        """Copy a checkpoint's parameters into the live ones."""
        with torch.no_grad():
            _copy_params_(self.params, params)

    # -- main loop -----------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        cfg = self.train_cfg
        logger.info("Starting training for %d epochs (batch %d, lr %g) on %s",
                    cfg.epochs, cfg.batch_size, cfg.lr, self.device)
        t0 = time.time()
        epoch_times = []
        for epoch in range(self.epoch + 1, cfg.epochs + 1):
            self.epoch = epoch
            te = time.time()
            tr_loss, tr_acc = self.train_epoch_fn(self.host_gen,
                                                  self.device_gen)
            val_loss, val_acc = self.eval_epoch_fn(self.params,
                                                   self.device_gen)
            # The one host read of the epoch.
            tr_loss, tr_acc, val_loss, val_acc = torch.stack(
                [tr_loss, tr_acc, val_loss, val_acc]).tolist()
            # The checkpoint and early-stop decisions below read it.
            check_same_across(val_loss, self.device, "the validation loss")
            epoch_time = time.time() - te
            epoch_times.append(epoch_time)

            self.history["train_losses"].append(tr_loss)
            self.history["val_losses"].append(val_loss)
            self.history["train_accs"].append(tr_acc)
            self.history["val_accs"].append(val_acc)

            edges_per_s = self.num_train_edges / max(epoch_time, 1e-9)
            logger.info(
                "Epoch %d/%d | Time: %.2fs | Train Loss: %.4f | Train Acc: "
                "%.4f | Val Loss: %.4f | Val Acc: %.4f | %.0f edges/s",
                epoch, cfg.epochs, epoch_time, tr_loss, tr_acc, val_loss,
                val_acc, edges_per_s)
            self.metrics.log(
                "epoch", epoch=epoch, train_loss=tr_loss, train_acc=tr_acc,
                val_loss=val_loss, val_acc=val_acc,
                epoch_time_s=round(epoch_time, 3),
                edges_per_s=round(edges_per_s, 1),
                **{f"mem_{k}": v
                   for k, v in device_memory_stats(self.device).items()})

            is_best = val_loss < self.best_val_loss
            if is_best:
                self.best_val_loss = val_loss
            self.best_val_acc = max(self.best_val_acc, val_acc)
            # The periodic snapshot is written on its schedule whether or
            # not the epoch is also a new best, so resume points have no
            # gaps.
            if epoch % cfg.save_every == 0:
                self.save_checkpoint()
            if is_best:
                self.save_checkpoint(is_best=True)

            # Reference quirk kept for parity: the window compares against
            # its own first element, so patience 1 always stops at the first
            # eligible epoch.
            if cfg.early_stopping > 0 and \
                    len(self.history["val_losses"]) > cfg.early_stopping:
                recent = self.history["val_losses"][-cfg.early_stopping:]
                if all(r >= recent[0] for r in recent):
                    logger.info("Early stopping at epoch %d", epoch)
                    break

        total = time.time() - t0
        logger.info("Training completed in %.2fs (best val loss %.4f)",
                    total, self.best_val_loss)
        self.save_checkpoint(is_final=True)
        self.metrics.close()
        return {
            "total_time_s": total,
            "epoch_times_s": epoch_times,
            "best_val_loss": self.best_val_loss,
            "best_val_acc": self.best_val_acc,
            "history": self.history,
        }
