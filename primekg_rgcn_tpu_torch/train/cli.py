"""Training CLI: full-graph, neighbor-sampled or node-sharded training.

    python -m primekg_rgcn_tpu_torch.train.cli --epochs 100 --lr 0.001 \
        --batch_size 1024 --data_dir data/processed --output_dir output \
        [--sample_fanouts 15 10 --sample_mode block] \
        [--shard edge|node --n_devices 4] [--device cuda|cpu]

The reference's flags, plus --resume, --synthetic (train on a
PrimeKG-statistics synthetic graph and write its splits under
``<output_dir>/synthetic_data``), --profile_dir (a ``torch.profiler`` trace
of the run) and --device (default ``cuda``; without a card it raises unless
``--device cpu`` is given). --sample_fanouts trains with neighbor
sampling (``train/sampled.SampledTrainer``; --sample_mode, --sparse_emb and
--val_sampled as in the JAX CLI). --shard edge trains the edge-partitioned
layout and --shard node the node-partitioned one
(``train/multichip.ShardedTrainer``) over --n_devices shards, all on the
one --device; the edge layout accumulates --gradient_accumulation_steps
batches per update, the node layout ignores it; the node layout's halo
exchange is kernel B4 on the card (the JAX CLI's --halo_impl has no
counterpart). --compute_dtype bfloat16 runs the
layers in bf16 on every one of these paths (float32 by default, or with
--resume the checkpoint's); the checkpoints record it, and serving and
evaluation follow it. Checkpoints are reference-layout
``.pt`` files under ``<output_dir>/models`` and
``<output_dir>/checkpoints``; the log goes to stdout and
``<output_dir>/training.log``.
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
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                   default=None,
                   help="layer compute dtype (default float32, or with "
                        "--resume the checkpoint's)")
    p.add_argument("--resume", default=None,
                   help="checkpoint (.pt) to resume from")
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
                        "(grad_clip and weight_decay 0): update only the "
                        "frontier's embedding rows each step")
    p.add_argument("--val_sampled", action="store_true",
                   help="with --sample_fanouts: validate through the sampled "
                        "encoder instead of a full-graph encode")
    p.add_argument("--shard", choices=["none", "edge", "node"],
                   default="none",
                   help="edge: edge-partitioned layout (replicated features, "
                        "the shards' partials summed); node: node-partitioned "
                        "layout with a halo exchange; every shard on the one "
                        "--device; none: one device")
    p.add_argument("--n_devices", type=int, default=0,
                   help="shards for --shard (0 = the visible devices)")
    args = p.parse_args(argv)
    if args.shard != "none" and args.sample_fanouts:
        p.error("--shard with --sample_fanouts (the sampled data-parallel "
                "steps) is not ported yet; see ROADMAP.md A10.2")
    if not re.fullmatch(r"uniform|truncate|block([1-9]\d*)?",
                        args.sample_mode):
        p.error(f"invalid --sample_mode {args.sample_mode!r} "
                f"(uniform | block | blockN | truncate)")
    if (args.sparse_emb or args.val_sampled) and not args.sample_fanouts:
        p.error("--sparse_emb and --val_sampled need --sample_fanouts")
    return args


def _load_graphs(args):
    """(train_graph, full_graph, train_edges, val_edges, num_nodes,
    num_relations), all on the CPU."""
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


def main(argv=None):
    args = parse_args(argv)
    from primekg_rgcn_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        handlers=[logging.StreamHandler(sys.stdout)])
    file_log = logging.FileHandler(Path(args.output_dir) / "training.log")
    file_log.setFormatter(logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
    root = logging.getLogger()
    root.addHandler(file_log)
    try:
        from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
        from primekg_rgcn_tpu_torch.train.loop import Trainer
        from primekg_rgcn_tpu_torch.train.multichip import ShardedTrainer
        from primekg_rgcn_tpu_torch.train.sampled import SampledTrainer
        from primekg_rgcn_tpu_torch.utils.telemetry import profile_trace

        (train_graph, full_graph, train_edges, val_edges,
         num_nodes, num_relations) = _load_graphs(args)
        if args.compute_dtype is None:
            args.compute_dtype = "float32"
            if args.resume:
                from primekg_rgcn_tpu_torch.train import checkpoint

                args.compute_dtype = checkpoint.load(
                    args.resume)["model_config"]["compute_dtype"]
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
            seed=args.seed)
        if args.sample_fanouts:
            trainer = SampledTrainer(
                model_cfg, train_cfg, train_graph, full_graph, train_edges,
                val_edges, args.output_dir,
                fanouts=tuple(args.sample_fanouts), mode=args.sample_mode,
                sparse_emb=args.sparse_emb, val_sampled=args.val_sampled,
                device=device, args=args)
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
        root.removeHandler(file_log)
        file_log.close()


if __name__ == "__main__":
    main()
