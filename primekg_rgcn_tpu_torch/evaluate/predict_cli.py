"""Top-K tail prediction CLI (serving entry point).

Loads a reference-layout ``.pt`` checkpoint and a processed-data directory,
encodes the whole graph once, scores every entity as tail for the given
(head, relation) queries, and returns the K best: dense on one device, or
node-sharded (``--shard node``: the node-partitioned encode with the halo
exchange, kernel B4, and a distributed top-K, so no shard holds the [N, D]
table or a [B, N] score row; every shard lives on the one ``--device``):

    python -m primekg_rgcn_tpu_torch.evaluate.predict_cli \
        --model_path model.pt --data_dir data/processed \
        --heads 12 844 --relation 0 --topk 10 [--device cuda|cpu] \
        [--shard node --n_devices 4] [--output predictions.json] \
        [--export scorer.pt2 --export_batch 32]

``--export`` (dense only) also writes a ``torch.export`` program of the
top-K scorer over the frozen embeddings of the same encode
(``evaluate/export.py``), which serves without the graph or this package.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Top-K tail prediction")
    p.add_argument("--model_path", required=True,
                   help="reference-layout .pt checkpoint")
    p.add_argument("--data_dir", default="data/processed")
    p.add_argument("--heads", type=int, nargs="+", required=True,
                   help="head entity ids to query")
    p.add_argument("--relation", type=int, default=0)
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--shard", choices=["none", "node"], default="none")
    p.add_argument("--n_devices", type=int, default=0,
                   help="shards of --shard node (0 = the visible devices)")
    p.add_argument("--output", default=None,
                   help="optional JSON file for the predictions")
    p.add_argument("--export", default=None,
                   help="also write a self-contained top-K scorer "
                        "(torch.export; the frozen embeddings of this "
                        "encode and the relation table) to this path; load "
                        "it with evaluate.export.load_predictor or "
                        "torch.export.load(path).module()")
    p.add_argument("--export_batch", type=int, default=32,
                   help="fixed query batch size of the exported program")
    args = p.parse_args(argv)
    if args.export and args.shard == "node":
        # The artifact freezes the [N, D] table, which the sharded path
        # never builds.
        p.error("--export needs the dense encode (--shard none): the "
                "artifact freezes the [N, D] embeddings, which --shard node "
                "never assembles")
    return args


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(name)s - %(message)s",
                        handlers=[logging.StreamHandler(sys.stdout)])
    log = logging.getLogger("predict")

    import torch

    from primekg_rgcn_tpu_torch.config import ModelConfig
    from primekg_rgcn_tpu_torch.data import artifacts
    from primekg_rgcn_tpu_torch.device import resolve_device
    from primekg_rgcn_tpu_torch.models.rgcn import get_embeddings
    from primekg_rgcn_tpu_torch.ops.distmult import distmult_score_all_tails
    from primekg_rgcn_tpu_torch.train import checkpoint as ckpt

    device = resolve_device(args.device)
    payload = ckpt.load(args.model_path, device=device)
    params = payload["params"]
    model_cfg = ModelConfig.from_dict(payload["model_config"])
    log.info("Loaded %s (compute_dtype %s)", args.model_path,
             model_cfg.compute_dtype)
    ds = artifacts.load_dataset(args.data_dir, require_train=False)
    full = ds["full"] or ds["train"] or ds["test"]
    if full is None:
        raise SystemExit(
            f"no graph artifacts (full_graph/train_data/test_data) found "
            f"under {args.data_dir}")
    graph = artifacts.split_to_rel_graph(full)
    n = graph.num_nodes
    for h in args.heads:
        if not 0 <= h < n:
            raise SystemExit(f"head id {h} out of range [0, {n})")
    if not 0 <= args.relation < graph.num_relations:
        raise SystemExit(f"relation {args.relation} out of range "
                         f"[0, {graph.num_relations})")

    names = None
    if ds.get("mappings"):
        names = {int(i): str(v[1])
                 for i, v in ds["mappings"]["idx2node"].items()}

    heads = torch.tensor(args.heads, dtype=torch.long, device=device)
    rels = torch.full((len(args.heads),), args.relation, dtype=torch.long,
                      device=device)
    if args.shard == "node":
        from primekg_rgcn_tpu_torch.evaluate.sharded_ranking import (
            build_sharded_topk)
        from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh
        from primekg_rgcn_tpu_torch.parallel.node_shard import (
            build_node_sharded_forward, partition_nodes)

        try:
            mesh = make_mesh(args.n_devices or None, device)
        except ValueError as exc:
            raise SystemExit(f"--shard node: {exc}") from exc
        nsg = partition_nodes(graph, mesh.n_shards)
        with torch.no_grad():
            emb_dm = build_node_sharded_forward(
                mesh, nsg, model_cfg, gather=False)(params)
            topk = build_sharded_topk(mesh, emb_dm,
                                      params["decoder"]["rel_emb"], n,
                                      args.topk)
            scores, ids = topk(heads, rels)
    else:
        rel_emb = params["decoder"]["rel_emb"]
        with torch.no_grad():
            node_emb = get_embeddings(params, graph.to(device), model_cfg)
            scores, ids = torch.topk(distmult_score_all_tails(
                node_emb[heads], rel_emb[rels], node_emb), args.topk, dim=1)
        if args.export:
            from primekg_rgcn_tpu_torch.evaluate.export import (
                export_topk_predictor)

            out = export_topk_predictor(node_emb, rel_emb, args.export,
                                        batch_size=args.export_batch,
                                        topk=args.topk)
            log.info("Exported serving artifact: %s (%d bytes)", out,
                     out.stat().st_size)
    scores, ids = scores.cpu().numpy(), ids.cpu().numpy()

    results = []
    for qi, h in enumerate(args.heads):
        rows = [{"tail_id": int(t), "score": float(s),
                 **({"tail_name": names.get(int(t), "")} if names else {})}
                for t, s in zip(ids[qi], scores[qi])]
        results.append({"head_id": int(h),
                        **({"head_name": names.get(int(h), "")}
                           if names else {}),
                        "relation": int(args.relation),
                        "predictions": rows})
        log.info("head %s -> top-%d tails: %s", h, args.topk,
                 ", ".join(f"{r['tail_id']}({r['score']:.3f})"
                           for r in rows[:5]))
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
        log.info("Wrote %s", args.output)
    return results


if __name__ == "__main__":
    main()
