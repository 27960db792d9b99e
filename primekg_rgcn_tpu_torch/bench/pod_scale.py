"""BASELINE config 5 at its real scale (10M nodes, 100M edges, 50
relations): the node-sharded training step and the zero3 sampled step,
every shard on one card.

The counterpart of ``primekg_rgcn_tpu/bench/pod_scale.py``, which runs
them on an 8-device CPU mesh. It reports:

- the host's partition cost (sorts, halo request lists) at 100M edges,
- the partition itself (halo width, per-shard edge capacities),
- the per-device byte model of the sharded layouts
  (``bench/scaling.comms_bytes_model``), which does not depend on the
  hardware,
- what the node step would hold on the card (:func:`node_step_bytes`),
  printed before the step is built,
- one measured step (the first, with the kernel libraries' load, and the
  second), its loss, the kernel launches of the two, the card's peak
  memory and the host's peak RSS (the process's, since it started: a run
  alone in its process reports its own).

A port mesh puts every shard on one card (``parallel/mesh.py``), so the
step time is the cost of the sharded program on one card, not a pod's.

Run:  ``python -m primekg_rgcn_tpu_torch.bench.pod_scale [--nodes
10000000 --edges 100000000 --relations 50 --devices 8] [--partition_only]
[--sampled_zero3 [--table_opt adafactor]] [--out bench_report_torch.json]
[--device cpu]``. A scaled-down run of the same path is in
``tests/test_torch_port_pod_scale.py``.
"""

from __future__ import annotations

import argparse
import gc
import json
import time
from typing import Dict, List, Optional

import numpy as np

DISCLAIMER = ("every shard on one card: capability, memory and partition "
              "proof at real scale; the step time is the sharded program's "
              "cost on one card, not a pod's")
POSITIVES = 200_000  # the batches' positives: the graph's first edges


def peak_host_rss_gb() -> float:
    """The process's peak resident set in GiB since it started: Linux's
    ``ru_maxrss`` (KiB), which a sandboxed kernel keeps where its
    ``/proc/self/status`` has no VmHWM. A process that a larger one forked
    and exec'd starts from that one's high-water mark: run this module
    from a small process, or from a shell that forks it."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def _peaks(report: Dict, dev) -> None:
    import torch

    report["peak_host_rss_gb"] = peak_host_rss_gb()
    if dev.type == "cuda":
        report["peak_device_mb"] = torch.cuda.max_memory_allocated(dev) / 2**20


def node_step_bytes(sg, model_cfg, num_params: int) -> Dict:
    """Bytes the node step holds on the card, by the arrays that grow with
    the shard count n (every shard lives on the one card): each bucket's
    CSRs and inverse degrees, the halo exchange's send and receive buffers
    of each layer (n * n * P rows of the layer's width, each way), the real
    edges' ids, and the parameters with their gradient and adam's two
    moments (float32). A reckoning of these arrays, not of every
    temporary."""
    n, p = sg.n_devices, sg.halo_width
    el = 2 if model_cfg.compute_dtype == "bfloat16" else 4
    out = {name: getattr(sg, name).numel() * 4 for name in (
        "rowptr_local", "rowptr_halo", "t_rowptr_local", "t_rowptr_halo",
        "inv_deg")}
    real = int(sg.rowptr_local[..., -1].sum() + sg.rowptr_halo[..., -1].sum())
    out["edge_ids"] = real * 2 * 4           # src and t_dst, int32
    for i, d in enumerate((model_cfg.embedding_dim, model_cfg.hidden_dim)):
        # send + receive, forward and backward
        out[f"halo_layer{i + 1}"] = 4 * n * n * p * d * el
    out["params_grads_adam"] = num_params * 4 * 4
    out["total"] = sum(out.values())
    return out


def run_pod_scale(num_nodes: int, num_edges: int, num_relations: int,
                  n_devices: int = 8, batch_size: int = 1024,
                  emb_dim: int = 64, hidden_dim: int = 128,
                  run_step: bool = True, checkpoint=None,
                  device="cuda") -> Dict:
    """The node-sharded step at this scale. ``checkpoint(report)``
    (optional) is called after each phase, so that a later failure still
    leaves the finished phases recorded. ``run_step=False`` stops after the
    partition, the byte model and the memory reckoning."""
    import torch

    from primekg_rgcn_tpu_torch.bench.scaling import (comms_bytes_model,
                                                      device_name,
                                                      kernel_launches,
                                                      launches_since, sync)
    from primekg_rgcn_tpu_torch.bench.suite import (_fresh_params,
                                                    rmat_rel_graph)
    from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
    from primekg_rgcn_tpu_torch.device import resolve_device
    from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh
    from primekg_rgcn_tpu_torch.parallel.node_shard import (
        build_node_sharded_train_step, partition_nodes)
    from primekg_rgcn_tpu_torch.train.loop import make_optimizer

    dev = resolve_device(device)
    report: Dict = {"nodes": num_nodes, "edges": num_edges,
                    "relations": num_relations, "devices": n_devices,
                    "platform": dev.type, "device": device_name(dev),
                    "disclaimer": DISCLAIMER}

    graph, edges, times = rmat_rel_graph(num_nodes, num_edges,
                                         num_relations)
    report.update(times)

    t0 = time.perf_counter()
    sg = partition_nodes(graph, n_devices)
    report["partition_s"] = time.perf_counter() - t0
    report["halo_width"] = int(sg.halo_width)
    report["n_loc"] = int(sg.n_loc)
    report["e_local_cap"] = int(sg.offsets_local[-1])
    report["e_halo_cap"] = int(sg.offsets_halo[-1])
    # The (shard, group, relation) buckets with real edges, local and halo,
    # and whether the relation scan runs: what a step's B1 launches follow.
    report["halo_buckets_with_edges"] = int(
        (sg.rowptr_halo[..., -1] > 0).sum())
    report["buckets_with_edges"] = int((sg.rowptr_local[..., -1] > 0).sum()
                                       + report["halo_buckets_with_edges"])
    report["uniform_caps"] = bool(sg.uniform_caps)
    if checkpoint:
        checkpoint(report)

    model_cfg = ModelConfig(num_nodes=num_nodes,
                            num_relations=num_relations,
                            embedding_dim=emb_dim, hidden_dim=hidden_dim)
    train_cfg = TrainConfig(batch_size=batch_size)
    report["comms_model"] = comms_bytes_model(
        graph, model_cfg, n_devices, batch_size=batch_size, sg=sg)
    del graph
    gc.collect()
    reckoning = node_step_bytes(sg, model_cfg,
                                num_nodes * emb_dim + _rest_params(model_cfg))
    if dev.type == "cuda":
        reckoning["card_bytes"] = torch.cuda.get_device_properties(
            dev).total_memory
    report["node_step_bytes"] = reckoning
    print(json.dumps({"node_step_bytes": reckoning}), flush=True)
    if checkpoint:
        checkpoint(report)
    if not run_step:
        report["note"] = "step skipped (--partition_only)"
        return report

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mesh = make_mesh(n_devices, dev)
    t0 = time.perf_counter()
    step = build_node_sharded_train_step(mesh, sg, model_cfg, train_cfg)
    params = _fresh_params(model_cfg, dev)
    opt = make_optimizer(train_cfg, params)
    sync()
    report["step_build_s"] = time.perf_counter() - t0
    del sg
    gc.collect()

    rng = np.random.default_rng(0)
    head = edges[:POSITIVES].astype(np.int64)
    gen = torch.Generator(dev).manual_seed(1)

    def batch():
        idx = rng.integers(0, len(head), batch_size)
        return torch.from_numpy(np.concatenate(
            [head[idx], np.ones((batch_size, 1), np.int64)], axis=1)).to(dev)

    before = kernel_launches()
    t0 = time.perf_counter()
    step(params, opt, batch(), gen)
    sync()
    report["first_step_incl_compile_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    stats = step(params, opt, batch(), gen)
    sync()
    report["step_ms"] = (time.perf_counter() - t0) * 1e3
    report["launches"] = launches_since(before)  # of the two steps
    loss, acc = (float(stats[0] / stats[2]), float(stats[1] / stats[2]))
    report["loss"], report["acc"] = loss, acc
    if not np.isfinite(loss):
        raise FloatingPointError(f"node step loss {loss}")
    _peaks(report, dev)
    if checkpoint:
        checkpoint(report)
    return report


def _rest_params(model_cfg) -> int:
    """Parameters other than the table (no bases)."""
    r, e, h = (model_cfg.num_relations, model_cfg.embedding_dim,
               model_cfg.hidden_dim)
    return r * e * h + e * h + h + r * h * h + h * h + h + r * h


def zero3_comms_model(num_nodes: int, n_devices: int, batch_size: int,
                      budgets, use_combined: bool, num_relations: int,
                      emb_dim: int, num_neg_samples: int = 1) -> Dict:
    """Per-device bytes of zero3's collectives a step (the ids'
    all-gather, the rows' psum_scatter, the row cotangents' all-gather),
    from the frontier capacity ladder: seeds per shard are the heads and
    tails of its candidate batch, 2 * B/n * (1 + num_neg)."""
    from primekg_rgcn_tpu_torch.data.sampling import _unique_cap

    per_dev = batch_size // n_devices
    cap = _unique_cap(2 * per_dev * (1 + num_neg_samples), num_nodes)
    for f in budgets:
        slots = int(f) if use_combined else int(f) * num_relations
        cap = _unique_cap(cap * (1 + slots), num_nodes)
    row_bytes = emb_dim * 4
    return {"frontier_cap": int(cap),
            "ids_allgather_bytes": int(n_devices * cap * 4),
            "rows_psum_scatter_bytes": int(n_devices * cap * row_bytes),
            "cotangent_allgather_bytes": int(n_devices * cap * row_bytes),
            "note": "per device per step; independent of N (zero1 moves "
                    "two table-sized [N, D] collectives instead)"}


def run_pod_scale_zero3(num_nodes: int, num_edges: int, num_relations: int,
                        n_devices: int = 8, batch_size: int = 1024,
                        emb_dim: int = 64, hidden_dim: int = 128,
                        fanouts=(15, 10), table_opt: str = "sgd",
                        checkpoint=None, device="cuda") -> Dict:
    """Config 5 at full scale as zero3 sampled training: the table and its
    optimizer state in n row slices, every collective frontier-sized, bf16
    compute. ``table_opt`` "sgd" steps the slices with the dense optimizer
    (adam, clip 1.0; reported as ``sampled-zero3-adam``, as in the JAX
    module), "adafactor" with the factored rule (no clip)."""
    import torch

    from primekg_rgcn_tpu_torch.bench.scaling import (device_name,
                                                      kernel_launches,
                                                      launches_since, sync)
    from primekg_rgcn_tpu_torch.bench.suite import _fresh_params, config5
    from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
    from primekg_rgcn_tpu_torch.device import resolve_device
    from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh
    from primekg_rgcn_tpu_torch.train.sampled import (
        build_sampled_train_step_zero3, resolve_sampler)

    dev = resolve_device(device)
    table_factored = table_opt == "adafactor"
    report: Dict = {"nodes": num_nodes, "edges": num_edges,
                    "relations": num_relations, "devices": n_devices,
                    "mode": ("sampled-zero3-adafactor" if table_factored
                             else "sampled-zero3-adam"),
                    "platform": dev.type, "device": device_name(dev),
                    "disclaimer": DISCLAIMER}

    csr, edges, times = config5(num_nodes, num_edges, num_relations)
    report.update(times)
    if checkpoint:
        checkpoint(report)

    model_cfg = ModelConfig(num_nodes=num_nodes,
                            num_relations=num_relations,
                            embedding_dim=emb_dim, hidden_dim=hidden_dim,
                            compute_dtype="bfloat16")
    # adam + clip for the rest by default; the factored table rule clips
    # its own update and refuses a global-norm clip.
    train_cfg = TrainConfig(batch_size=batch_size,
                            grad_clip=0.0 if table_factored else 1.0)
    _, budgets, use_combined = resolve_sampler(csr, fanouts)
    report["layout"] = "combined" if use_combined else "per-relation"
    report["budgets"] = list(budgets)
    report["zero3_comms_model"] = zero3_comms_model(
        num_nodes, n_devices, batch_size, budgets, use_combined,
        num_relations, emb_dim, train_cfg.num_neg_samples)
    if checkpoint:
        checkpoint(report)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mesh = make_mesh(n_devices, dev)
    # The original fanouts: the builder resolves them against the same CSR
    # to the same budgets.
    step = build_sampled_train_step_zero3(csr, model_cfg, train_cfg, mesh,
                                          fanouts=fanouts,
                                          table_opt=table_opt)
    params = step.shard_params(_fresh_params(model_cfg, dev))
    opt = step.init_optimizer(params)
    gc.collect()
    report["table_slice_mb"] = (-(-num_nodes // n_devices) * emb_dim * 4
                                / 2 ** 20)
    if checkpoint:
        checkpoint(report)

    rng = np.random.default_rng(0)
    head = edges[:POSITIVES].astype(np.int64)
    gen = torch.Generator(dev).manual_seed(1)

    def batch():
        return torch.from_numpy(
            head[rng.integers(0, len(head), batch_size)]).to(dev)

    before = kernel_launches()
    t0 = time.perf_counter()
    step(params, opt, batch(), gen)
    sync()
    report["first_step_incl_compile_s"] = time.perf_counter() - t0
    if checkpoint:
        checkpoint(report)

    t0 = time.perf_counter()
    loss, acc = step(params, opt, batch(), gen)
    sync()
    report["step_ms"] = (time.perf_counter() - t0) * 1e3
    report["launches"] = launches_since(before)  # of the two steps
    report["loss"], report["acc"] = float(loss), float(acc)
    if not np.isfinite(report["loss"]):
        raise FloatingPointError(f"zero3 step loss {report['loss']}")
    _peaks(report, dev)
    if checkpoint:
        checkpoint(report)
    return report


def main(argv: Optional[List[str]] = None):
    from primekg_rgcn_tpu_torch.bench.scaling import merge_report

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--nodes", type=int, default=10_000_000)
    p.add_argument("--edges", type=int, default=100_000_000)
    p.add_argument("--relations", type=int, default=50)
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--partition_only", action="store_true",
                   help="stop after the partition, the byte model and the "
                        "memory reckoning")
    p.add_argument("--sampled_zero3", action="store_true",
                   help="run the sharded-table sampled step instead of the "
                        "node-sharded full-graph step")
    p.add_argument("--table_opt", choices=["sgd", "adafactor"],
                   default="sgd",
                   help="with --sampled_zero3: 'adafactor' steps the table "
                        "slices with the factored rule")
    p.add_argument("--tag", default="config5-pod-dryrun",
                   help="results key in the report file")
    p.add_argument("--out", default="bench_report_torch.json")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    def merge(report):
        merge_report(args.out, args.tag, report)

    if args.sampled_zero3:
        report = run_pod_scale_zero3(args.nodes, args.edges,
                                     args.relations,
                                     n_devices=args.devices,
                                     batch_size=args.batch_size,
                                     table_opt=args.table_opt,
                                     checkpoint=merge, device=args.device)
    else:
        report = run_pod_scale(args.nodes, args.edges, args.relations,
                               n_devices=args.devices,
                               batch_size=args.batch_size,
                               run_step=not args.partition_only,
                               checkpoint=merge, device=args.device)
    print(json.dumps(report, indent=2))
    merge(report)
    print(f"merged into {args.out}")
    return report


if __name__ == "__main__":
    main()
