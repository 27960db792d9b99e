"""Sharded training: the CLI-reachable face of ``parallel/``.

The counterpart of ``primekg_rgcn_tpu/train/multichip.py``:
``ShardedTrainer`` runs the edge layout's step (``parallel/edge_shard``:
replicated features, each shard's edge chunk, the partials summed) or the
node layout's (``parallel/node_shard``: features partitioned over the
shards, halo exchange) through the epoch, validation, checkpoint and
early-stop loop of the full-graph ``Trainer``, so ``python -m
primekg_rgcn_tpu_torch.train.cli --shard edge --n_devices 4`` is a whole
training run. Validation is the full-graph one on the mesh's device
(parameters are replicated, so it is exact).

``maybe_initialize_distributed`` brings up ``torch.distributed`` for the
CLI's ``--distributed``: one process a ``--process_id``, each driving its
shards of a mesh that spans them (``parallel/mesh.py``). The backend rule:

- ``nccl`` when the device is a card and each process on the host has one
  of its own;
- ``gloo`` on the CPU;
- ``gloo`` when processes share a card: NCCL refuses a communicator two of
  whose ranks sit on one device.

Both layouts' ``ShardedTrainer`` run across processes, each process
stepping its own shards (the node layout's halo exchange joining them
through an all-to-all).
"""

from __future__ import annotations

import atexit
import datetime
import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.data.graph import RelGraph
from primekg_rgcn_tpu_torch.parallel import edge_shard, node_shard
from primekg_rgcn_tpu_torch.device import resolve_device
from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh
from primekg_rgcn_tpu_torch.train.loop import (Trainer, build_eval_epoch,
                                               edges_with_sentinel,
                                               make_optimizer)

logger = logging.getLogger(__name__)


class ShardedTrainer(Trainer):
    """Trainer whose train epochs run a sharded step over a mesh of
    ``n_devices`` shards on ``device``: ``shard="edge"`` (the default, as
    in the JAX package) or ``"node"``.

    Each epoch permutes the training edges with the host generator and
    pads the last batch with mask-0 rows. The edge layout groups
    ``gradient_accumulation_steps`` batches into one update, accumulated
    inside its step (the group after the last batch padded with whole
    mask-0 batches); the node layout takes one update per batch and ignores
    accumulation, with a warning, as the JAX trainer does. Each batch is
    split over the shards; negatives and dropout come from the device
    generator. The epoch's loss and accuracy weigh every batch by its
    candidate count, as the JAX package's sharded trainer does.
    Checkpoints, metrics, early stopping, resume and validation are the
    ``Trainer``'s. Across processes (either layout) every process runs the
    epoch over the same batches, stepping its own shards, and validates
    the replicated parameters itself; process 0 alone writes.
    """

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 train_graph: RelGraph, full_graph: RelGraph,
                 train_edges: np.ndarray, val_edges: np.ndarray, output_dir,
                 *, shard: str = "edge", n_devices: Optional[int] = None,
                 device="cuda", args=None):
        if shard not in ("edge", "node"):
            raise ValueError(f"unknown shard layout: {shard!r}")
        self._setup(model_cfg, train_cfg, output_dir, device, args,
                    train_edges)
        self.mesh = make_mesh(n_devices, self.device)
        n = self.mesh.n_shards
        if train_cfg.batch_size % n:
            raise ValueError(f"batch_size {train_cfg.batch_size} must divide "
                             f"by the {n}-shard mesh")
        self.optimizer = make_optimizer(train_cfg, self.params)
        self.accum = 1
        if shard == "edge":
            self.accum = max(train_cfg.gradient_accumulation_steps, 1)
            self.step_fn = edge_shard.build_sharded_train_step(
                self.mesh, edge_shard.shard_rel_graph(train_graph, n),
                model_cfg, train_cfg, accum_steps=self.accum)
        else:
            if train_cfg.gradient_accumulation_steps > 1:
                logger.warning(
                    "gradient_accumulation_steps ignored by the node-sharded "
                    "step (memory already scales with the partition; raise "
                    "batch_size instead)")
            self.step_fn = node_shard.build_node_sharded_train_step(
                self.mesh, node_shard.partition_nodes(train_graph, n),
                model_cfg, train_cfg)
        self._edges_pad = edges_with_sentinel(train_edges, self.device)
        self.train_epoch_fn = self._sharded_epoch
        self.eval_epoch_fn = build_eval_epoch(
            full_graph.to(self.device), val_edges, model_cfg, train_cfg)
        logger.info("ShardedTrainer: %s layout over %d shards on %s (%d "
                    "train edges)", shard, n, self.device,
                    self.num_train_edges)

    def _sharded_epoch(self, host_gen: torch.Generator,
                       device_gen: torch.Generator):
        e = self.num_train_edges
        b = self.train_cfg.batch_size
        n_updates = -(-e // (b * self.accum))
        perm = torch.cat([torch.randperm(e, generator=host_gen),
                          torch.full((n_updates * self.accum * b - e,), e)])
        groups = perm.view(n_updates, self.accum, b).to(self.device)
        stats = torch.zeros(3, device=self.device)
        for idx in groups:
            mask = (idx < e)[..., None].long()
            batch = torch.cat([self._edges_pad[idx], mask], dim=-1)
            stats += self.step_fn(self.params, self.optimizer,
                                  batch[0] if self.accum == 1 else batch,
                                  device_gen)
        return stats[0] / stats[2], stats[1] / stats[2]


# Seconds that the rendezvous, and each collective, may wait for a peer
# (jax.distributed.initialize's own default).
DIST_TIMEOUT_S = 300


def _destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def maybe_initialize_distributed(coordinator_address: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None, *,
                                 device="cuda") -> bool:
    """Multi-process runtime bring-up (``torch.distributed``), the
    counterpart of the JAX package's ``maybe_initialize_distributed``.

    ``coordinator_address`` is process 0's ``host:port``, with
    ``num_processes`` and ``process_id``; without it the environment that
    ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``) is read, as JAX detects its cluster. Returns True when more
    than one process is live afterwards; a second call is a no-op. Where no
    cluster is found, or the rendezvous fails (``DIST_TIMEOUT_S``), it warns
    and returns False.

    On a card each process first takes its own (``LOCAL_RANK``, else
    ``process_id`` modulo the cards), before the group forms and before
    anything touches CUDA. The backend follows the rule in the module
    docstring; processes share a card when the host's process count
    (``LOCAL_WORLD_SIZE``, else ``num_processes``) exceeds its cards. The
    group is destroyed at exit, so that a process that raises closes its
    connections instead of leaving its peers waiting.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator_address needs --num_processes "
                             "and --process_id")
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    elif all(k in env for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                                "RANK")):
        init_method = "env://"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        logger.warning("--distributed: no --coordinator_address and no "
                       "torchrun environment (MASTER_ADDR, MASTER_PORT, "
                       "WORLD_SIZE, RANK); continuing single-process")
        return False
    backend, where = "gloo", "cpu"
    if resolve_device(device).type == "cuda":
        cards = torch.cuda.device_count()
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank % cards)))
        on_host = int(env.get("LOCAL_WORLD_SIZE", world))
        backend = "nccl" if on_host <= cards else "gloo"
        where = f"cuda:{torch.cuda.current_device()}"
    try:
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    except dist.DistError as exc:
        logger.warning("torch.distributed rendezvous at %s failed (%s); "
                       "continuing single-process", init_method, exc)
        return False
    atexit.register(_destroy_process_group)
    logger.info("torch.distributed: backend %s, process %d of %d on %s",
                backend, rank, world, where)
    return dist.get_world_size() > 1
