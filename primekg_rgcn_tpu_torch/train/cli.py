"""Training CLI: full-graph, neighbor-sampled or node-sharded training.

    python -m primekg_rgcn_tpu_torch.train.cli --epochs 100 --lr 0.001 \
        --batch_size 1024 --data_dir data/processed --output_dir output \
        [--sample_fanouts 15 10 --sample_mode block] \
        [--shard edge|node --n_devices 4] [--device cuda|cpu]
    python -m primekg_rgcn_tpu_torch.train.cli --sample_fanouts 15 10 \
        --shard edge --n_devices 4 [--zero1 | --zero3 [--dp_pods 2] \
        [--table_opt adafactor --grad_clip 0]]

The reference's flags, plus --resume, --synthetic (train on a
PrimeKG-statistics synthetic graph and write its splits under
``<output_dir>/synthetic_data``), --profile_dir (a ``torch.profiler`` trace
of the run) and --device (default ``cuda``; without a card it raises unless
``--device cpu`` is given). --sample_fanouts trains with neighbor
sampling (``train/sampled.SampledTrainer``; --sample_mode, --sparse_emb,
--table_opt, --val_sampled and --cache_layer1 as in the JAX CLI); with
--shard (either
layout) it is data-parallel over --n_devices shards, with --zero1 or
--zero3 (--dp_pods) as in the JAX CLI. Without --sample_fanouts, --shard
edge trains the edge-partitioned layout and --shard node the
node-partitioned one
(``train/multichip.ShardedTrainer``) over --n_devices shards, all on the
one --device; the edge layout accumulates --gradient_accumulation_steps
batches per update, the node layout ignores it; the node layout's halo
exchange is kernel B4 on the card (the JAX CLI's --halo_impl has no
counterpart). --steps_per_scan K sets the work per CUDA-graph replay:
optimizer updates per captured segment of the full-graph epoch, steps per
captured chunk of the one-device sampled one (the sharded trainers run
eagerly). --compute_dtype bfloat16 runs the
layers in bf16 on every one of these paths (float32 by default, or with
--resume the checkpoint's); the checkpoints record it, and serving and
evaluation follow it. Checkpoints are reference-layout
``.pt`` files under ``<output_dir>/models`` and
``<output_dir>/checkpoints``; the log goes to stdout and
``<output_dir>/training.log``.

--distributed runs one process a --process_id of --num_processes, which
meet at --coordinator_address (process 0's host:port; without it the
``torchrun`` environment), the mesh's --n_devices shards split over them
(``train/multichip.maybe_initialize_distributed``: NCCL on cards of their
own, gloo on the CPU or on a shared card). Across processes it trains
--shard edge or --shard node, or --sample_fanouts with --shard (dp,
--zero1, --zero3, --dp_pods whose tp rows may span processes,
--table_opt); a layout without a mesh raises. Process 0 alone writes the
checkpoints, metrics.jsonl, training.log and the synthetic splits.
"""

from __future__ import annotations

import argparse
import logging
import re
import sys
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Train RGCN model for drug-disease link prediction")
    p.add_argument("--data_dir", default="data/processed")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--embedding_dim", type=int, default=64)
    p.add_argument("--hidden_dim", type=int, default=128)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--decoder_dropout", type=float, default=0.1)
    p.add_argument("--num_bases", type=int, default=None)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--optimizer", choices=["adam", "adamw", "sgd"],
                   default="adam")
    p.add_argument("--num_neg_samples", type=int, default=1)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--save_every", type=int, default=10)
    p.add_argument("--early_stopping", type=int, default=0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--steps_per_scan", type=int, default=0,
                   help="split each epoch into CUDA-graph segments of this "
                        "many optimizer updates, then one of the remainder "
                        "(0 = the default, 1); with the batch-restricted "
                        "final layer the graphs hold one micro-batch each, "
                        "the overflow flag read between them, whatever "
                        "this value; with --sample_fanouts on one device: "
                        "steps per captured chunk (0 = the default, 1). "
                        "On the CPU the same steps run eagerly")
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                   default=None,
                   help="layer compute dtype (default float32, or with "
                        "--resume the checkpoint's)")
    p.add_argument("--resume", default=None,
                   help="checkpoint to resume from: a .pt, or a JAX "
                        "checkpoint (its stem, stem.msgpack or stem.json)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on a PrimeKG-statistics synthetic graph")
    p.add_argument("--synthetic_scale", type=float, default=1.0)
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of the run here")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--sample_fanouts", type=int, nargs="+", default=None,
                   help="train with neighbor sampling at these per-relation "
                        "fanouts, outermost layer first (e.g. "
                        "--sample_fanouts 15 10)")
    p.add_argument("--sample_mode", default="uniform",
                   help="with --sample_fanouts: uniform (per-slot picks with "
                        "replacement), block (one random aligned window of "
                        "the merged CSR per node), blockN (N windows of F/N "
                        "records) or truncate (the first F neighbors)")
    p.add_argument("--sparse_emb", action="store_true",
                   help="with --sample_fanouts and --optimizer sgd "
                        "(grad_clip and weight_decay 0), or with --table_opt "
                        "adafactor (grad_clip 0): update only the "
                        "frontier's embedding rows each step")
    p.add_argument("--zero1", action="store_true",
                   help="with --sample_fanouts and --shard: shard the "
                        "embedding-table optimizer state (ZeRO-1) over the "
                        "mesh — dense Adam at the 10M-node config exceeds "
                        "one chip without it")
    p.add_argument("--zero3", action="store_true",
                   help="with --sample_fanouts and --shard: shard the "
                        "embedding TABLE itself (params + moments + "
                        "update all stay slice-local; frontier rows are "
                        "fetched via psum_scatter) — per-device memory "
                        "O(N/n + frontier), dense adam at any N that "
                        "fits the POD")
    p.add_argument("--dp_pods", type=int, default=0,
                   help="with --zero3: hierarchical 2-D mesh — the table "
                        "shards over n_devices/dp_pods chips (lay on ICI) "
                        "and dp_pods data-parallel replicas span pods "
                        "(DCN); only the [N/tp, D] slice-gradient psum "
                        "crosses pods")
    p.add_argument("--val_sampled", action="store_true",
                   help="with --sample_fanouts: validate with the sampled "
                        "encoder (O(frontier) per batch) instead of a "
                        "full-graph encode — required at scales where the "
                        "full encode cannot materialize; with --zero3 the "
                        "table stays sharded through validation too")
    p.add_argument("--table_opt", choices=["sgd", "adafactor"],
                   default="sgd",
                   help="with --sparse_emb (single chip) or --zero3 (any "
                        "mesh): the embedding-TABLE update rule. adafactor "
                        "= factored-second-moment adaptive updates "
                        "([N]+[D] state, ~40 MB at 10M nodes vs dense "
                        "adam's 7.7 GB; per-slice [N/n]+[D] under --zero3 "
                        "with mesh-size-invariant cross-slice stats) — "
                        "adaptive training at scales where adam cannot "
                        "fit; the rest params are then free to use "
                        "--optimizer adam")
    p.add_argument("--cache_layer1", action="store_true",
                   help="with --sample_fanouts and --sparse_emb: historical "
                        "layer-1 embeddings (GAS / VR-GCN style): one "
                        "sampled hop serves both convolutions, conv2 "
                        "reading out-of-batch neighbours from an [N, "
                        "hidden] history table that refreshes as nodes "
                        "appear as seeds (stale by design)")
    p.add_argument("--shard", choices=["none", "edge", "node"],
                   default="none",
                   help="edge: edge-partitioned layout (replicated features, "
                        "the shards' partials summed); node: node-partitioned "
                        "layout with a halo exchange; every shard on the one "
                        "--device; none: one device")
    p.add_argument("--n_devices", type=int, default=0,
                   help="shards for --shard (0 = the visible devices)")
    p.add_argument("--distributed", action="store_true",
                   help="initialize the torch.distributed runtime before "
                        "building the mesh: NCCL when each process has a "
                        "card of its own, gloo on the CPU or on a shared "
                        "card")
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of process 0 (default: torchrun's "
                        "MASTER_ADDR and MASTER_PORT)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    args = p.parse_args(argv)
    if not re.fullmatch(r"uniform|truncate|block([1-9]\d*)?",
                        args.sample_mode):
        p.error(f"invalid --sample_mode {args.sample_mode!r} "
                f"(uniform | block | blockN | truncate)")
    if (args.sparse_emb or args.val_sampled) and not args.sample_fanouts:
        p.error("--sparse_emb and --val_sampled need --sample_fanouts")
    if (args.zero1 or args.zero3 or args.dp_pods
            or args.table_opt != "sgd") and not args.sample_fanouts:
        p.error("--zero1, --zero3, --dp_pods and --table_opt need "
                "--sample_fanouts")
    if args.zero1 and args.zero3:
        p.error("--zero1 and --zero3 are exclusive")
    if args.cache_layer1 and not args.sample_fanouts:
        p.error("--cache_layer1 needs --sample_fanouts (it is a sampled-"
                "trainer mode)")
    return args


def _load_graphs(args, write: bool = True):
    """(train_graph, full_graph, train_edges, val_edges, num_nodes,
    num_relations), all on the CPU. With ``--synthetic`` the splits are
    written under ``<output_dir>/synthetic_data`` when ``write``."""
    from primekg_rgcn_tpu_torch.data import artifacts
    from primekg_rgcn_tpu_torch.data.graph import build_rel_graph
    from primekg_rgcn_tpu_torch.data.synthetic import (bidirect, primekg_like,
                                                       synthetic_mappings)

    log = logging.getLogger("train")
    if args.synthetic:
        raw = primekg_like(seed=args.seed, scale=args.synthetic_scale)
        n, r = raw["num_nodes"], raw["num_relations"]
        # Hold out drug-gene rows as val/test before bidirecting, as the
        # reference splits undirected rows; splitting after bidirect would
        # leave the reverse copy of every held-out edge in the training
        # set, which DistMult's head/tail symmetry trains on directly. The
        # draws are the JAX CLI's, so the written splits are the same.
        dg_rows = np.flatnonzero(raw["rel"] == 0)
        rng = np.random.default_rng(args.seed)
        heldout = rng.choice(dg_rows, size=max(2 * (len(dg_rows) // 7), 2),
                             replace=False)
        val_rows = heldout[: len(heldout) // 2]
        test_rows = heldout[len(heldout) // 2:]
        mask = np.ones(len(raw["src"]), bool)
        mask[heldout] = False

        def _bid(rows):
            bs, bd, br = bidirect(raw["src"][rows], raw["dst"][rows],
                                  raw["rel"][rows])
            return np.stack([bs, bd, br], 1)

        train_edges = _bid(mask)
        val_edges = _bid(val_rows)
        test_edges = _bid(test_rows)
        src, dst, rel = bidirect(raw["src"], raw["dst"], raw["rel"])
        train_graph = build_rel_graph(train_edges[:, 0], train_edges[:, 1],
                                      train_edges[:, 2], n, r)
        full_graph = build_rel_graph(src, dst, rel, n, r)
        log.info("Synthetic graph: %d nodes, %d train edges", n,
                 len(train_edges))
        if not write:
            return train_graph, full_graph, train_edges, val_edges, n, r

        out = Path(args.output_dir) / "synthetic_data"
        out.mkdir(parents=True, exist_ok=True)

        def _save(name, e):
            artifacts.save_split_npz(out / f"{name}.npz", {
                "edge_index": e[:, :2].T, "edge_type": e[:, 2],
                "num_nodes": n, "num_relations": r})

        _save("train_data", train_edges)
        _save("val_data", val_edges)
        _save("test_data", test_edges)
        _save("full_graph", np.stack([src, dst, rel], 1))
        artifacts.save_mappings(out / "mappings.json",
                                synthetic_mappings(raw))
        log.info("Saved synthetic splits to %s", out)
        return train_graph, full_graph, train_edges, val_edges, n, r

    ds = artifacts.load_dataset(args.data_dir)
    train, val, full = ds["train"], ds["val"], ds["full"]
    if full is None:
        full = train
    train_edges = artifacts.split_to_edges(train)
    val_edges = artifacts.split_to_edges(val) if val else train_edges[:1024]
    train_graph = artifacts.split_to_rel_graph(train)
    full_graph = artifacts.split_to_rel_graph(full)
    log.info("Loaded %s: %d nodes, %d train / %d val edges", args.data_dir,
             train["num_nodes"], len(train_edges), len(val_edges))
    return (train_graph, full_graph, train_edges, val_edges,
            train["num_nodes"], train["num_relations"])


def _check_across_processes(args, world: int) -> None:
    """Raise for a layout that does not train across ``world`` processes:
    it would train alone in each of them."""
    if world == 1:
        return
    if args.shard == "none":
        raise ValueError(
            f"--num_processes {world} trains a mesh that spans the "
            f"processes: pass --shard edge or node, or --sample_fanouts "
            f"with --shard (each process would otherwise train alone)")


def main(argv=None):
    args = parse_args(argv)
    fmt = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
    logging.basicConfig(level=logging.INFO, format=fmt,
                        handlers=[logging.StreamHandler(sys.stdout)])
    world, rank = 1, 0
    if args.distributed:
        # First thing: each process takes its card before anything
        # touches CUDA, and the mesh reads the group.
        import torch.distributed as dist

        from primekg_rgcn_tpu_torch.train.multichip import (
            maybe_initialize_distributed)

        live = maybe_initialize_distributed(
            args.coordinator_address, args.num_processes, args.process_id,
            device=args.device)
        if not live and (args.num_processes or 0) > 1:
            raise RuntimeError(
                "--distributed with --num_processes > 1 did not yield a "
                "multi-process runtime")
        if dist.is_initialized():
            world, rank = dist.get_world_size(), dist.get_rank()
    _check_across_processes(args, world)
    from primekg_rgcn_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    root = logging.getLogger()
    file_log = None
    if rank == 0:
        # training.log is process 0's: appends from several would tear.
        Path(args.output_dir).mkdir(parents=True, exist_ok=True)
        file_log = logging.FileHandler(Path(args.output_dir) /
                                       "training.log")
        file_log.setFormatter(logging.Formatter(fmt))
        root.addHandler(file_log)
    try:
        import torch

        from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
        from primekg_rgcn_tpu_torch.train.loop import Trainer
        from primekg_rgcn_tpu_torch.train.multichip import ShardedTrainer
        from primekg_rgcn_tpu_torch.train.sampled import SampledTrainer
        from primekg_rgcn_tpu_torch.utils.telemetry import profile_trace

        (train_graph, full_graph, train_edges, val_edges,
         num_nodes, num_relations) = _load_graphs(args, write=rank == 0)
        if args.compute_dtype is None:
            args.compute_dtype = "float32"
            if args.resume:
                from primekg_rgcn_tpu_torch.train import checkpoint

                args.compute_dtype = checkpoint.stored_model_config(
                    args.resume)["compute_dtype"]
        model_cfg = ModelConfig(
            num_nodes=num_nodes, num_relations=num_relations,
            embedding_dim=args.embedding_dim, hidden_dim=args.hidden_dim,
            dropout=args.dropout, decoder_dropout=args.decoder_dropout,
            num_bases=args.num_bases, compute_dtype=args.compute_dtype)
        train_cfg = TrainConfig(
            epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
            weight_decay=args.weight_decay, optimizer=args.optimizer,
            num_neg_samples=args.num_neg_samples, grad_clip=args.grad_clip,
            gradient_accumulation_steps=args.gradient_accumulation_steps,
            save_every=args.save_every, early_stopping=args.early_stopping,
            seed=args.seed, steps_per_scan=args.steps_per_scan)
        if args.sample_fanouts:
            # Sampled training on a mesh is data-parallel: either --shard
            # layout splits the seed batch, and its frontier, over the
            # shards.
            sample_ndev = None
            if args.shard != "none":
                sample_ndev = args.n_devices or (
                    torch.cuda.device_count() if device.type == "cuda"
                    else 1)
            trainer = SampledTrainer(
                model_cfg, train_cfg, train_graph, full_graph, train_edges,
                val_edges, args.output_dir,
                fanouts=tuple(args.sample_fanouts), mode=args.sample_mode,
                n_devices=sample_ndev, zero1=args.zero1, zero3=args.zero3,
                dp_pods=args.dp_pods, sparse_emb=args.sparse_emb,
                val_sampled=args.val_sampled, table_opt=args.table_opt,
                cache_layer1=args.cache_layer1, device=device, args=args)
        elif args.shard != "none":
            trainer = ShardedTrainer(
                model_cfg, train_cfg, train_graph, full_graph, train_edges,
                val_edges, args.output_dir, shard=args.shard,
                n_devices=args.n_devices or None, device=device, args=args)
        else:
            trainer = Trainer(model_cfg, train_cfg, train_graph, full_graph,
                              train_edges, val_edges, args.output_dir,
                              device=device, args=args)
        if args.resume:
            trainer.resume(args.resume)
        with profile_trace(args.profile_dir):
            result = trainer.train()
        logging.getLogger("train").info("Training completed successfully!")
        return result
    finally:
        if file_log is not None:
            root.removeHandler(file_log)
            file_log.close()


if __name__ == "__main__":
    main()
