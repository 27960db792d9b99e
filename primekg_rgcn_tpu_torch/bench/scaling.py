"""Step time over 1-8 shards on the one card, and the per-layer byte model
of the sharded layouts.

The counterpart of ``primekg_rgcn_tpu/bench/scaling.py``. Two products:

1. **Measured step time of every sharded layout** at n in {1, 2, 4, 8}
   shards: the edge and node layouts and the data-parallel sampled steps
   (dp, zero1, zero3). A port mesh puts every shard on one device
   (``parallel/mesh.py``), so these numbers show the mechanics and the
   cost of the partition on one card, not multi-card scaling; the report
   says so.
2. **The analytic per-device bytes a step moves between shards**, from the
   real partition (``partition_nodes``'s halo width, the sampler's budgets
   and frontier capacities), which does not depend on the hardware:
   - edge layout: each RGCN layer sums the stacked per-relation partial
     aggregates [R, N, D_agg] over the shards; a ring all-reduce moves
     2 (n - 1) / n of the bytes per device.
   - node layout: each layer runs one exchange of the halo serve lists;
     each device ships (n - 1) * halo_width * D rows. The training step
     adds the batch endpoint assembly (the ids' all-gather and the
     candidate rows' psum).
   - the sampled steps: the gradients' psum; zero1 adds the table's
     all-gather; zero3 moves only frontier-sized collectives.

:func:`comms_bytes_model` returns the JAX function's dict key for key and
int for int on the same graph.

Run: ``python -m primekg_rgcn_tpu_torch.bench.scaling [--scale 0.25]
[--out bench_report_torch.json] [--device cpu]`` (the card by default).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

DISCLAIMER = ("shards on one card: mechanics and partition cost, not "
              "multi-card scaling")


def _ring_allreduce_bytes(payload_bytes: int, n: int) -> int:
    """Per-device bytes sent by a ring all-reduce (reduce-scatter+all-gather)."""
    if n <= 1:
        return 0
    return int(2 * (n - 1) / n * payload_bytes)


def comms_bytes_model(graph, model_cfg, n_devices: int,
                      batch_size: int = 1024,
                      num_neg_samples: int = 1, *, sg=None) -> Dict:
    """Analytic per-device bytes per training step for both layouts.

    Uses the real partition: ``partition_nodes`` runs for the node layout
    (or ``sg``, the caller's partition of ``graph`` over ``n_devices``
    shards), so halo widths are the actual boundary cut of this graph.
    """
    from primekg_rgcn_tpu_torch.parallel.node_shard import partition_nodes

    n = n_devices
    N = graph.num_nodes
    R = graph.num_relations
    emb, hid = model_cfg.embedding_dim, model_cfg.hidden_dim
    f32 = 4

    # Edge layout: each layer aggregates in min(Din, Dout) width
    # (aggregate-first, ops/rgcn_segment.py) and sums the stacked
    # [R, N, D_agg] partials over the shards.
    d1 = min(emb, hid)       # conv1 aggregation width
    d2 = min(hid, hid)       # conv2
    edge_fwd = sum(_ring_allreduce_bytes(R * N * d * f32, n)
                   for d in (d1, d2))
    # The backward sums the same shapes (transpose aggregation partials).
    edge_step = 2 * edge_fwd

    result = {
        "edge_shard": {
            "per_layer_psum_bytes": [R * N * d1 * f32, R * N * d2 * f32],
            "per_device_step_bytes": edge_step,
            "note": "O(R*N*D) per device, independent of n — replication "
                    "tax; dominates at large N",
        },
    }

    if n > 1:
        if sg is None:
            sg = partition_nodes(graph, n)
        elif sg.n_devices != n:
            raise ValueError(f"partition over {sg.n_devices} shards, "
                             f"model over {n}")
        halo_rows = (n - 1) * sg.halo_width
        node_fwd = sum(halo_rows * d * f32 for d in (emb, hid))
        # Batch endpoint assembly (build_node_sharded_train_step's fetch):
        # 2 endpoint lists x all_gather[C ids] + psum[n, C, H] rows.
        C = (batch_size // n) * (1 + num_neg_samples)
        fetch = 2 * (_ring_allreduce_bytes(n * C * hid * f32, n)
                     + (n - 1) * C * 4)
        node_step = 2 * node_fwd + fetch
        result["node_shard"] = {
            "halo_width": int(sg.halo_width),
            "per_layer_alltoall_bytes": [halo_rows * emb * f32,
                                         halo_rows * hid * f32],
            "batch_fetch_bytes": int(fetch),
            "per_device_step_bytes": int(node_step),
            "note": "O(boundary cut) per device — shrinks as partitions "
                    "localize; the scalable layout",
        }
        result["node_over_edge_traffic"] = round(
            node_step / max(edge_step, 1), 4)

    # Sampled data-parallel (train/sampled.py): the only collective is the
    # gradients' psum over every parameter; zero1 adds the all-gather that
    # rebuilds the table from the updated slices, with the same psum.
    # Parameter bytes of the no-basis model (models/rgcn.init_params).
    p_emb = N * emb * f32
    p_rest = (R * emb * hid + emb * hid + hid          # conv1
              + R * hid * hid + hid * hid + hid        # conv2
              + R * hid) * f32                         # decoder rel_emb
    grads_psum = _ring_allreduce_bytes(p_emb + p_rest, n)
    result["sampled_dp"] = {
        "grads_psum_bytes": int(grads_psum),
        "per_device_step_bytes": int(grads_psum),
        "note": "frontier work splits n-fold; comms = one grads psum, "
                "independent of graph size beyond the embedding table",
    }
    if n > 1:
        n_loc = -(-N // n)
        ag = (n - 1) * n_loc * emb * f32
        result["sampled_zero1"] = {
            "emb_allgather_bytes": int(ag),
            "per_device_step_bytes": int(grads_psum + ag),
            "per_device_moment_bytes_saved": int(2 * p_emb * (n - 1) / n),
            "note": "adds the table-rebuild all-gather; buys an n-fold cut "
                    "of the 2x-params Adam moment memory",
        }
        # Sharded table (zero3): every collective is frontier-sized (the
        # ids' all-gather, the rows' psum_scatter, the row cotangents'
        # all-gather); only the n-fold sliced parameters scale with N.
        from primekg_rgcn_tpu_torch.data.sampling import _unique_cap
        from primekg_rgcn_tpu_torch.train.sampled import resolve_sampler

        _, budgets, comb = resolve_sampler(graph, (15, 10))
        # Seeds per device = heads + tails = 2 * per_dev * (1 + num_neg=1).
        cap = _unique_cap(2 * max(batch_size // n, 1) * 2, N)
        for f in budgets:
            slots = int(f) if comb else int(f) * R
            cap = _unique_cap(cap * (1 + slots), N)
        row = emb * f32
        result["sampled_zero3"] = {
            "frontier_cap": int(cap),
            "per_device_step_bytes": int(n * cap * (4 + 2 * row)
                                         + _ring_allreduce_bytes(p_rest,
                                                                 n)),
            "per_device_table_bytes": int(n_loc * row * 3),
            "note": "frontier-proportional ICI, independent of N; params "
                    "+ adam moments sliced n-fold (no table-sized object "
                    "per device)",
        }
    return result


def one_shard_mesh(device):
    """A mesh of one shard on ``device``: ``make_mesh`` refuses fewer than
    two, since a sharded layout on one shard is the dense path with extra
    copies, which is what the 1-shard rows measure."""
    import torch

    from primekg_rgcn_tpu_torch.device import resolve_device
    from primekg_rgcn_tpu_torch.parallel.mesh import Mesh

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(1, dev)


def sync() -> None:
    """Wait for the card's queue where the card is in use (a no-op on the
    CPU)."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def device_name(device) -> str:
    """The card's name, or "cpu"."""
    import torch

    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def kernel_launches() -> Dict[str, int]:
    """The launches that the wrappers of kernels B1-B4 have counted in this
    process: each counts where it launches its kernel, so a CPU run counts
    none, and a CUDA graph's replays none."""
    from primekg_rgcn_tpu_torch.ops.cuda import dense_segment_sum as pds
    from primekg_rgcn_tpu_torch.ops.cuda import halo
    from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as ss
    from primekg_rgcn_tpu_torch.ops.cuda import window_fetch as pwf

    return {"B1": ss.gather_segment_sum.launches,
            "B2": pds.dense_sorted_segment_sum.launches,
            "B3": pwf.window_rows_fetch.launches,
            "B4": halo.halo_exchange.launches}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """:func:`kernel_launches` less ``before``."""
    return {k: v - before[k] for k, v in kernel_launches().items()}


def sim_graph(scale: float):
    """The scaling harness's graph: ``primekg_like`` (seed 0) at
    ``scale``, both ways, 3 relations. Returns (graph, edges [E, 3] int64,
    model config)."""
    import numpy as np

    from primekg_rgcn_tpu_torch.config import ModelConfig
    from primekg_rgcn_tpu_torch.data.graph import build_rel_graph
    from primekg_rgcn_tpu_torch.data.synthetic import bidirect, primekg_like

    raw = primekg_like(seed=0, scale=scale)
    src, dst, rel = bidirect(raw["src"], raw["dst"], raw["rel"])
    graph = build_rel_graph(src, dst, rel, raw["num_nodes"], 3)
    edges = np.stack([src, dst, rel], 1).astype(np.int64)
    return graph, edges, ModelConfig(num_nodes=raw["num_nodes"],
                                     num_relations=3)


def measure_sim_mesh(scale: float = 0.25,
                     device_counts: List[int] = (1, 2, 4, 8),
                     batch_size: int = 256,
                     n_steps: int = 8, device="cuda") -> Dict:
    """Step-time measurements of every layout at each shard count, all
    shards on ``device`` (mechanics and partition cost: see the module
    docstring). Every step runs eagerly, as the sharded trainers run it."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.config import TrainConfig
    from primekg_rgcn_tpu_torch.device import resolve_device
    from primekg_rgcn_tpu_torch.models.rgcn import init_params, param_leaves
    from primekg_rgcn_tpu_torch.parallel.edge_shard import (
        build_sharded_train_step, shard_rel_graph)
    from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh
    from primekg_rgcn_tpu_torch.parallel.node_shard import (
        build_node_sharded_train_step, partition_nodes)
    from primekg_rgcn_tpu_torch.train.loop import make_optimizer
    from primekg_rgcn_tpu_torch.train.sampled import (
        build_sampled_train_step_dp, build_sampled_train_step_zero1,
        build_sampled_train_step_zero3)

    dev = resolve_device(device)
    graph, edges, model_cfg = sim_graph(scale)
    train_cfg = TrainConfig(batch_size=batch_size)

    def fresh_params():
        params = init_params(torch.Generator().manual_seed(0), model_cfg,
                             device=dev)
        for p in param_leaves(params):
            p.requires_grad_(True)
        return params

    rng = np.random.default_rng(0)

    def batches(i):
        idx = rng.integers(0, len(edges), batch_size)
        b = np.concatenate([edges[idx], np.ones((batch_size, 1), np.int64)],
                           axis=1)
        return torch.from_numpy(b).to(dev)

    out: Dict = {"graph": {"nodes": graph.num_nodes,
                           "edges": graph.num_edges,
                           "scale": scale},
                 "batch_size": batch_size,
                 "platform": dev.type,
                 "device": device_name(dev),
                 "disclaimer": DISCLAIMER,
                 "graphed": False,
                 "layouts": {}}

    for layout in ("edge", "node", "sampled-dp", "sampled-zero1",
                   "sampled-zero3"):
        rows = {}
        for n in device_counts:
            if layout.startswith("sampled") and n == 1:
                continue  # the data-parallel steps need a mesh axis; the
                # one-device sampled step is the suite's sampled rows
            mesh = one_shard_mesh(dev) if n == 1 else make_mesh(n, dev)
            params = fresh_params()
            gen = torch.Generator(dev).manual_seed(0)
            t0 = time.perf_counter()
            if layout.startswith("sampled"):
                build = {"sampled-dp": build_sampled_train_step_dp,
                         "sampled-zero1": build_sampled_train_step_zero1,
                         "sampled-zero3": build_sampled_train_step_zero3
                         }[layout]
                step = build(graph, model_cfg, train_cfg, mesh,
                             fanouts=(5, 3))
                if layout == "sampled-zero3":
                    params = step.shard_params(params)
                opt = step.init_optimizer(params)

                def run(i, _s=step, _p=params, _o=opt, _g=gen):
                    return _s(_p, _o, batches(i)[:, :3], _g)[0]
            else:
                if layout == "edge":
                    step = build_sharded_train_step(
                        mesh, shard_rel_graph(graph, n), model_cfg,
                        train_cfg)
                else:
                    step = build_node_sharded_train_step(
                        mesh, partition_nodes(graph, n), model_cfg,
                        train_cfg)
                opt = make_optimizer(train_cfg, params)

                def run(i, _s=step, _p=params, _o=opt, _g=gen):
                    return _s(_p, _o, batches(i), _g)
            setup_s = time.perf_counter() - t0

            before = kernel_launches()
            run(0)
            sync()
            t0 = time.perf_counter()
            for i in range(n_steps):
                run(i)
            sync()
            dt = (time.perf_counter() - t0) / n_steps
            rows[str(n)] = {"step_ms": dt * 1e3,
                            "edges_per_s": batch_size / dt,
                            "setup_s": setup_s,
                            "steps": n_steps + 1,
                            "launches": launches_since(before)}
            del step, opt, params, run
        base = rows.get("1", {}).get("edges_per_s")
        for k, v in rows.items():
            if base:
                v["speedup_vs_1"] = v["edges_per_s"] / base
                v["parallel_efficiency"] = v["edges_per_s"] / (base * int(k))
        out["layouts"][layout] = rows

    # Flat metric for tracking across runs (the nested per-layout cells
    # stay): the 1-shard edge-layout step.
    ref_row = out["layouts"].get("edge", {}).get("1")
    if ref_row:
        out["step_ms"] = ref_row["step_ms"]
        out["edges_per_s"] = ref_row["edges_per_s"]

    out["comms_model"] = {
        str(n): comms_bytes_model(graph, model_cfg, n,
                                  batch_size=batch_size)
        for n in device_counts}
    return out


def merge_report(path, key: str, result: Dict) -> None:
    """Write ``result`` under ``results[key]`` of the JSON report at
    ``path``, keeping what the report already holds."""
    try:
        with open(path) as f:
            report = json.load(f)
    except (OSError, ValueError):
        report = {"results": {}}
    report.setdefault("results", {})[key] = result
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--scale", type=float, default=0.25)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--out", default="bench_report_torch.json")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    result = measure_sim_mesh(scale=args.scale,
                              batch_size=args.batch_size,
                              n_steps=args.steps, device=args.device)
    print(json.dumps(result, indent=2))
    merge_report(args.out, "scaling-sim-mesh", result)
    print(f"merged into {args.out}")
    return result


if __name__ == "__main__":
    main()
