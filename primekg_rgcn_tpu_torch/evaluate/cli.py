"""Evaluation CLI producing the reference's results contract.

    python -m primekg_rgcn_tpu_torch.evaluate.cli --model_path model.pt \
        --data_dir data/processed --output_dir results --k_values 10 50 100 \
        [--filtered] [--rank_direction both] [--shard node --n_devices 4] \
        [--device cuda|cpu]

Loads a reference-layout ``.pt`` checkpoint, encodes the full graph once
(kernel B1 on the card; ``--shard node``: the node-sharded encode with the
halo exchange B4, every shard on the one ``--device``), and writes
results.json, metrics_summary.txt and evaluation.log into --output_dir,
plus the four evaluation PNGs where matplotlib is installed. The JAX CLI's
--impl has no counterpart: the layer follows the device. --device defaults
to cuda and raises without a card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Evaluate trained RGCN model for link prediction")
    p.add_argument("--model_path", required=True,
                   help="reference-layout .pt checkpoint")
    p.add_argument("--data_dir", default="data/processed")
    p.add_argument("--output_dir", default="results")
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--num_neg_samples", type=int, default=1)
    p.add_argument("--k_values", type=int, nargs="+", default=[10, 50])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--shard", choices=["none", "node"], default="none",
                   help="node: fully sharded evaluation: the node-"
                        "partitioned encode feeds shard-major rank/score "
                        "functions, and no [N, D] table is built")
    p.add_argument("--n_devices", type=int, default=0,
                   help="mesh shards of --shard node, all on --device "
                        "(0 = dense)")
    p.add_argument("--rank_direction", choices=["tail", "both"],
                   default="tail",
                   help="both: also rank HEADS given (r, t) and report "
                        "head / head+tail blocks (the reference ranks "
                        "tails only)")
    p.add_argument("--filtered", action="store_true",
                   help="also report FILTERED ranking metrics (known true "
                        "tails of (h, r) across all splits removed from "
                        "the candidate set; the reference reports raw "
                        "ranks only)")
    args = p.parse_args(argv)
    if args.filtered and args.shard == "node":
        # Fail before the node-sharded encode: the filter gathers from the
        # dense ranker's own [B, N] score rows, which that path never
        # builds.
        p.error("--filtered needs the dense evaluator (--shard none): "
                "the exact-tie filter gather reads the ranker's own score "
                "rows, which the fully-sharded path never materializes")
    return args


def main(argv=None):
    args = parse_args(argv)
    from primekg_rgcn_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fmt = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
    logging.basicConfig(level=logging.INFO, format=fmt,
                        handlers=[logging.StreamHandler(sys.stdout)])
    file_log = logging.FileHandler(out_dir / "evaluation.log")
    file_log.setFormatter(logging.Formatter(fmt))
    root = logging.getLogger()
    root.addHandler(file_log)
    try:
        return _evaluate(args, device)
    finally:
        root.removeHandler(file_log)
        file_log.close()


def _evaluate(args, device):
    import numpy as np

    from primekg_rgcn_tpu_torch.config import EvalConfig, ModelConfig
    from primekg_rgcn_tpu_torch.data import artifacts
    from primekg_rgcn_tpu_torch.evaluate.evaluator import (Evaluator,
                                                           save_results)
    from primekg_rgcn_tpu_torch.evaluate.visualize import ResultsVisualizer
    from primekg_rgcn_tpu_torch.models.rgcn import count_params
    from primekg_rgcn_tpu_torch.train import checkpoint as ckpt

    log = logging.getLogger("evaluate")
    out_dir = Path(args.output_dir)
    payload = ckpt.load(args.model_path, device=device)
    params = payload["params"]
    model_cfg = ModelConfig.from_dict(payload["model_config"])
    log.info("Loaded checkpoint (epoch %s, %s params, compute_dtype %s)",
             payload.get("epoch"), count_params(params),
             model_cfg.compute_dtype)

    ds = artifacts.load_dataset(args.data_dir, require_train=False)
    test = ds["test"]
    if test is None:
        raise FileNotFoundError(f"no test split in {args.data_dir}")
    full = ds["full"] or ds["train"] or test
    test_edges = artifacts.split_to_edges(test)
    full_graph = artifacts.split_to_rel_graph(full)
    log.info("Test edges: %d over %d nodes", len(test_edges),
             full_graph.num_nodes)

    n_shards = args.n_devices
    if args.shard == "node" and n_shards < 2:
        raise SystemExit(f"--shard node needs at least 2 shards, got "
                         f"{n_shards}; pass --n_devices N (every shard "
                         f"lives on {device})")
    evaluator = Evaluator(
        params, model_cfg, full_graph, test_edges,
        EvalConfig(batch_size=args.batch_size,
                   num_neg_samples=args.num_neg_samples,
                   k_values=tuple(args.k_values), seed=args.seed),
        shard_encode=args.shard, n_shards=n_shards)
    known = None
    if args.filtered:
        # Filter set = the union of true triples over every available split
        # (the 'full' artifact is that union when present).
        if ds["full"] is not None:
            known = artifacts.split_to_edges(ds["full"])
        else:
            parts = [artifacts.split_to_edges(ds[k])
                     for k in ("train", "val", "test") if ds.get(k)]
            known = np.concatenate(parts) if parts else test_edges
        log.info("Filtered ranking over %d known triples", len(known))
    metrics = evaluator.evaluate(known_triples=known,
                                 rank_direction=args.rank_direction)

    model_info = {
        "checkpoint_path": str(args.model_path),
        "epoch": payload.get("epoch"),
        "num_nodes": model_cfg.num_nodes,
        "num_relations": model_cfg.num_relations,
        "embedding_dim": model_cfg.embedding_dim,
        "hidden_dim": model_cfg.hidden_dim,
        "num_parameters": count_params(params),
        "best_val_loss": payload.get("best_val_loss"),
        "best_val_acc": payload.get("best_val_acc"),
    }
    save_results(metrics, out_dir, model_info)

    try:
        import matplotlib  # noqa: F401
    except ImportError:
        log.info("matplotlib is not installed: the four evaluation PNGs "
                 "were not written")
    else:
        ResultsVisualizer(evaluator.scores, evaluator.labels,
                          out_dir).generate_all_plots()
    log.info("Evaluation complete: AUC-ROC %.4f, MRR %.4f",
             metrics["classification"]["auc_roc"], metrics["ranking"]["mrr"])
    return metrics


if __name__ == "__main__":
    main()
