"""Mini-batch (neighbor-sampled) training on one device.

The counterpart of the single-device parts of
``primekg_rgcn_tpu/train/sampled.py``: each step samples the L-hop
neighbourhoods of the batch's candidate endpoints on the device and
differentiates through the sampled encoder, O(B * fanout^L) work instead of
O(E). ``resolve_sampler`` picks the pick layout, ``build_sampled_train_step``
builds the step (dense adam or the sparse-embedding SGD update),
``build_sampled_eval_epoch`` the sampled validation, and ``SampledTrainer``
runs epochs, validation, checkpoints, early stopping and resume.

Each step draws its random numbers from one ``torch.Generator`` in the JAX
step's stream order: negatives, then sampling, then dropout. There is no
``lax.scan`` chunking: PyTorch runs eagerly, and the host reads the losses
once per epoch.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.data.sampling import (
    CombinedCsr, CsrCache, SampledBatch, build_combined_csr, build_csr_cache,
    csr_to_pairs_form, parse_sample_mode, sample_batch,
    sample_batch_combined, uniform_draw)
from primekg_rgcn_tpu_torch.device import resolve_device
from primekg_rgcn_tpu_torch.models.rgcn import Params, encoder_apply_sampled
from primekg_rgcn_tpu_torch.ops.distmult import distmult_score
from primekg_rgcn_tpu_torch.train.loop import (Candidates, Trainer,
                                               apply_update,
                                               build_eval_epoch,
                                               edges_with_sentinel,
                                               make_optimizer,
                                               sample_candidates)
from primekg_rgcn_tpu_torch.train.neg_sampling import (bce_stats,
                                                       candidate_batch)
from primekg_rgcn_tpu_torch.utils.telemetry import device_memory_stats

logger = logging.getLogger(__name__)


def resolve_sampler(graph_or_csr, fanouts, mode: str = "uniform"):
    """Pick the pick-tensor layout for the graph's relation sparsity:
    (csr_like, budgets, use_combined), on the CPU.

    The per-relation layout ([R, M, f] picks) suits graphs where most
    (node, relation) pairs have edges; the combined one (one merged budget
    per node with relation tags and importance weights) suits
    relation-sparse ones. A CsrCache takes the per-relation layout and a
    CombinedCsr the combined one. A graph takes combined when the average
    number of present relations per node is under half the relation count,
    and always for block modes, whose windows ride the merged CSR. Block
    modes get the packed table in granule-pairs form (a view here).
    Combined budgets are the fanout times the present-relation average,
    rounded up to a multiple of 8 and capped at 48, as in the JAX package.
    """
    base_mode = parse_sample_mode(mode)[0]
    want_pairs = base_mode == "block"
    fanouts = tuple(int(f) for f in fanouts)
    if isinstance(graph_or_csr, (CsrCache, CombinedCsr)):
        csr, graph = graph_or_csr, None
    else:
        csr, graph = None, graph_or_csr

    if isinstance(csr, CsrCache):
        return csr, fanouts, False
    if csr is None:
        ccsr = build_combined_csr(graph, window_pairs=want_pairs)
        if base_mode != "block" and \
                ccsr.avg_present_relations >= 0.5 * ccsr.num_relations:
            return build_csr_cache(graph), fanouts, False
    else:
        ccsr = csr_to_pairs_form(csr) if want_pairs else csr
    factor = max(1.0, ccsr.avg_present_relations)
    budgets = tuple(min(-(-int(np.ceil(f * factor)) // 8) * 8, 48)
                    for f in fanouts)
    return ccsr, budgets, True


def sampled_loss(params: Params, batch: SampledBatch, cands: Candidates,
                 model_cfg: ModelConfig, *, train: bool,
                 generator: Optional[torch.Generator] = None,
                 enc_mask: Optional[torch.Tensor] = None,
                 x0: Optional[torch.Tensor] = None):
    """Mean BCE loss and accuracy of one candidate batch through the
    sampled encoder, 0-d tensors (the JAX step's ``loss_fn`` body after
    sampling; no decoder dropout, as there)."""
    heads, tails, rels, labels, weights = cands
    emb = encoder_apply_sampled(params, batch, model_cfg, train=train,
                                generator=generator, mask=enc_mask, x0=x0)
    m = heads.shape[0]
    scores = distmult_score(emb[:m], emb[m:],
                            params["decoder"]["rel_emb"][rels])
    loss_sum, correct, count = bce_stats(scores, labels, weights)
    return loss_sum / count, correct / count


def _rest_params(params: Params) -> Params:
    """Every parameter but the embedding table (the sparse update's
    optimizer leaves)."""
    enc = {k: v for k, v in params["encoder"].items() if k != "node_emb"}
    return {"encoder": enc, "decoder": params["decoder"]}


def build_sampled_train_step(csr, model_cfg: ModelConfig,
                             train_cfg: TrainConfig, *,
                             fanouts: Sequence[int] = (15, 10),
                             mode: str = "uniform", sparse_emb: bool = False,
                             device="cuda"):
    """Returns ``step(params, optimizer, pos_edges, generator) -> (loss,
    acc)``, 0-d tensors on the device, nothing read back to the host.

    ``csr`` is a RelGraph (layout resolved by :func:`resolve_sampler`), a
    CsrCache or a CombinedCsr, on the CPU; the step keeps it on ``device``.
    ``pos_edges`` is int64 [B, 3] (head, tail, rel) on the device. A step
    draws the negatives, then the sampler's uniforms, then the dropout mask
    from ``generator``; a test may hand it ``cands``, ``draw`` and
    ``enc_mask`` instead.

    Dense (default): ``optimizer`` covers every parameter, and the update
    is ``apply_update`` (clip, then the optimizer step). ``sparse_emb``: the
    embedding table is updated by plain SGD (``train_cfg.lr``) from its
    gathered rows' gradient, as a row scatter with the frontier's sentinel
    rows dropped, or, when the innermost block is identity, as the dense
    ``table - lr * grad``; ``optimizer`` covers the other parameters. Build
    it with ``step.init_optimizer(params)``. ``step.sample(seeds, draw)``
    samples a batch over the step's CSR.
    """
    device = resolve_device(device)
    csr, budgets, use_combined = resolve_sampler(csr, fanouts, mode)
    csr = csr.to(device)
    n = model_cfg.num_nodes
    lr = train_cfg.lr

    def sample(seeds: torch.Tensor, draw) -> SampledBatch:
        if use_combined:
            return sample_batch_combined(draw, csr, seeds, budgets, mode=mode,
                                         allow_ident=True)
        return sample_batch(draw, csr, seeds, budgets, mode=mode)

    def step(params: Params, optimizer: torch.optim.Optimizer,
             pos_edges: torch.Tensor, generator: torch.Generator, *,
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
                                 x0=x0)
        loss.backward()
        if sparse_emb:
            with torch.no_grad():
                if x0 is None:
                    # Identity block: the gradient is the dense table's.
                    emb.sub_(lr * emb.grad)
                else:
                    # Frontier ids are sorted-unique, filled with n: each
                    # real row gets its gradient once; the fill slots add
                    # zeros to row n - 1.
                    emb.index_add_(0, rows_idx, (-lr * x0.grad).masked_fill(
                        sentinel, 0.0))
            emb.grad = None
        apply_update(optimizer, train_cfg)
        return loss.detach(), acc.detach()

    def init_optimizer(params: Params) -> torch.optim.Optimizer:
        return make_optimizer(train_cfg,
                              _rest_params(params) if sparse_emb else params)

    step.sample = sample
    step.init_optimizer = init_optimizer
    step.csr = csr
    step.budgets = budgets
    step.use_combined = use_combined
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
    csr, budgets, use_combined = resolve_sampler(csr, fanouts, mode)
    csr = csr.to(device)
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
                if use_combined:
                    sb = sample_batch_combined(draw, csr, seeds, budgets,
                                               mode=mode, allow_ident=True)
                else:
                    sb = sample_batch(draw, csr, seeds, budgets, mode=mode)
                emb = encoder_apply_sampled(params, sb, model_cfg)
                m = cands[0].shape[0]
                scores = distmult_score(emb[:m], emb[m:],
                                        params["decoder"]["rel_emb"][cands[2]])
                stats += torch.stack(bce_stats(scores, cands[3], cands[4]))
        denom = stats[2].clamp(min=1.0)
        return stats[0] / denom, stats[1] / denom

    return eval_fn


class SampledTrainer(Trainer):
    """Host-driven mini-batch trainer over sampled neighbourhoods, one
    device.

    The epoch order is the JAX trainer's: ``np.random.default_rng(seed +
    start_epoch)`` permutes the training edges each epoch and the last
    batch wraps around to the permutation's start. Validation encodes the
    full graph once per epoch (``train/loop.build_eval_epoch``), or, with
    ``val_sampled``, scores each batch through its sampled encode.
    ``models/best_model.pt`` is written on each new best validation loss and
    ``models/final_model.pt`` after every epoch (the resume point); the
    checkpoint layout, ``metrics.jsonl`` and ``resume`` are the
    :class:`~primekg_rgcn_tpu_torch.train.loop.Trainer`'s.
    """

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 graph, full_graph, train_edges: np.ndarray,
                 val_edges: np.ndarray, output_dir, *,
                 fanouts: Sequence[int] = (15, 10), mode: str = "uniform",
                 sparse_emb: bool = False, val_sampled: bool = False,
                 device="cuda", args=None):
        if sparse_emb and (train_cfg.optimizer != "sgd" or train_cfg.grad_clip
                           or train_cfg.weight_decay):
            raise ValueError(
                "sparse_emb requires --optimizer sgd with grad_clip and "
                "weight_decay disabled: the embedding update is a -lr*g "
                "scatter, so any rule coupling the table with other leaves "
                "(adam moments, global-norm clip) would diverge from the "
                "dense step")
        self._setup(model_cfg, train_cfg, output_dir, device, args,
                    train_edges)
        # Resolve the pick layout once; the step and the sampled validation
        # share the CSR.
        csr_like = resolve_sampler(graph, fanouts, mode=mode)[0]
        self.step_fn = build_sampled_train_step(
            csr_like, model_cfg, train_cfg, fanouts=fanouts, mode=mode,
            sparse_emb=sparse_emb, device=self.device)
        self.optimizer = self.step_fn.init_optimizer(self.params)
        self.train_edges = torch.from_numpy(
            np.asarray(train_edges, np.int64)).to(self.device)
        if val_sampled:
            self.eval_epoch_fn = build_sampled_eval_epoch(
                csr_like, np.asarray(val_edges), model_cfg, train_cfg,
                fanouts=fanouts, mode=mode, device=self.device)
        else:
            self.eval_epoch_fn = build_eval_epoch(
                full_graph.to(self.device), np.asarray(val_edges), model_cfg,
                train_cfg)

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
            batches = torch.from_numpy(order.reshape(steps, b)).to(
                self.device)
            stats = []
            for s in range(steps):
                stats.extend(self.step_fn(
                    self.params, self.optimizer,
                    self.train_edges[batches[s]], self.device_gen))
            val_loss, val_acc = self.eval_epoch_fn(self.params,
                                                   self.device_gen)
            # The one host read of the epoch.
            vals = torch.stack(stats + [val_loss, val_acc]).tolist()
            tr_loss = float(np.mean(vals[0:2 * steps:2]))
            tr_acc = float(np.mean(vals[1:2 * steps:2]))
            val_loss, val_acc = vals[-2:]
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
