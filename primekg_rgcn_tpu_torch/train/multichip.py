"""Sharded training: the CLI-reachable face of ``parallel/``.

The counterpart of ``primekg_rgcn_tpu/train/multichip.py``, node layout
only: ``ShardedTrainer`` runs ``parallel/node_shard``'s step (features
partitioned over the mesh's shards, halo exchange) through the epoch,
validation, checkpoint and early-stop loop of the full-graph ``Trainer``,
so ``python -m primekg_rgcn_tpu_torch.train.cli --shard node --n_devices 4``
is a whole training run. Validation is the full-graph one on the mesh's
device (parameters are replicated, so it is exact). The edge layout
(``parallel/edge_shard.py``) is not ported yet (``ROADMAP.md``).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.data.graph import RelGraph
from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh
from primekg_rgcn_tpu_torch.parallel.node_shard import (
    build_node_sharded_train_step, partition_nodes)
from primekg_rgcn_tpu_torch.train.loop import (Trainer, build_eval_epoch,
                                               edges_with_sentinel,
                                               make_optimizer)

logger = logging.getLogger(__name__)


class ShardedTrainer(Trainer):
    """Trainer whose train epochs run the node-sharded step over a mesh of
    ``n_devices`` shards on ``device``.

    Each epoch permutes the training edges with the host generator, pads
    the last batch with mask-0 rows, and takes one update per batch (the
    batch split over the shards); negatives and dropout come from the device
    generator. The epoch's loss and accuracy weigh every batch by its
    candidate count, as the JAX package's sharded trainer does.
    Checkpoints, metrics, early stopping, resume and validation are the
    ``Trainer``'s.
    """

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 train_graph: RelGraph, full_graph: RelGraph,
                 train_edges: np.ndarray, val_edges: np.ndarray, output_dir,
                 *, shard: str = "node", n_devices: Optional[int] = None,
                 device="cuda", args=None):
        if shard == "edge":
            raise NotImplementedError(
                "the edge layout (parallel/edge_shard.py) is not ported yet; "
                "see ROADMAP.md A10")
        if shard != "node":
            raise ValueError(f"unknown shard layout: {shard!r}")
        self._setup(model_cfg, train_cfg, output_dir, device, args,
                    train_edges)
        self.mesh = make_mesh(n_devices, self.device)
        n = self.mesh.n_shards
        if train_cfg.batch_size % n:
            raise ValueError(f"batch_size {train_cfg.batch_size} must divide "
                             f"by the {n}-shard mesh")
        if train_cfg.gradient_accumulation_steps > 1:
            logger.warning(
                "gradient_accumulation_steps ignored by the node-sharded "
                "step (memory already scales with the partition; raise "
                "batch_size instead)")
        self.optimizer = make_optimizer(train_cfg, self.params)
        self.step_fn = build_node_sharded_train_step(
            self.mesh, partition_nodes(train_graph, n), model_cfg, train_cfg)
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
        n_steps = -(-e // b)
        perm = torch.cat([torch.randperm(e, generator=host_gen),
                          torch.full((n_steps * b - e,), e)])
        batches = perm.view(n_steps, b).to(self.device)
        stats = torch.zeros(3, device=self.device)
        for idx in batches:
            mask = (idx < e)[:, None].long()
            batch = torch.cat([self._edges_pad[idx], mask], dim=1)
            stats += self.step_fn(self.params, self.optimizer, batch,
                                  device_gen)
        return stats[0] / stats[2], stats[1] / stats[2]
