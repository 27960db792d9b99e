#!/usr/bin/env python3
"""Kernel B1 of the PyTorch + CUDA port, timed at its main-path shapes, for
the package in the current directory.

    cd TREE && python3 /path/to/repo/scripts/port_time_b1.py LABEL

TREE is a checkout of the port (``primekg_rgcn_tpu_torch/`` at its root),
this repository or an older commit unpacked beside it, so that two versions
of the kernel are timed in one run on one card: run it in the old tree, the
new, the new and the old again. The timer is ``chip_smoke.time_calls`` of
this repository (device time of each call from a ``torch.profiler`` trace,
and ``call_ms``, one call between two CUDA events); it reads the trace with
``primekg_rgcn_tpu_torch.utils.telemetry.device_us_by_range``, so an older
tree needs that module of this repository in its place.

On the ``bench.py`` graph and the default model with random weights (seed
0), as ``chip_smoke.py`` builds them, it times B1 forward at the six
(bucket, D) shapes of one encode and over the six transpose CSRs of one
step's backward, with cuSPARSE's CSR @ dense of the same function beside
it (the kernel held against its plain version first); it prints one JSON
line per shape, each tagged with LABEL, then the sums. It needs one CUDA
card.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path


def main(label):
    import torch

    if not torch.cuda.is_available():
        print("port_time_b1.py needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path.cwd()))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import numpy as np

    from primekg_rgcn_tpu_torch.config import ModelConfig
    from primekg_rgcn_tpu_torch.data import artifacts, synthetic
    from primekg_rgcn_tpu_torch.models import rgcn
    from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as ss
    from primekg_rgcn_tpu_torch.ops.rgcn_segment import (aggregate_plain,
                                                         build_layer_agg_ops,
                                                         rgcn_layer_segment)

    dev = torch.device("cuda")
    raw = synthetic.primekg_like(seed=0, scale=1.0)
    src_u, dst_u, rel_u = synthetic.bidirect(raw["src"], raw["dst"],
                                             raw["rel"])
    graph = artifacts.split_to_rel_graph({
        "edge_index": np.stack([src_u, dst_u]), "edge_type": rel_u,
        "num_nodes": raw["num_nodes"], "num_relations": 3}).to(dev)
    n = graph.num_nodes
    cfg = ModelConfig(num_nodes=n, num_relations=3)
    params = rgcn.init_params(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    enc = params["encoder"]
    with torch.no_grad():
        h1 = torch.relu(rgcn_layer_segment(enc["conv1"], enc["node_emb"],
                                           graph, agg_fn=aggregate_plain))
    pad = lambda t: torch.cat([t, t.new_zeros(1, t.shape[1])]).contiguous()
    gen = torch.Generator(dev).manual_seed(1)
    ops = build_layer_agg_ops(graph)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    rows = []
    for direction, tables in (
            ("forward", [pad(enc["node_emb"]), pad(h1)]),
            ("backward", [torch.randn(n + 1, d, device=dev, generator=gen)
                          for d in (64, 128)])):
        for x in tables:
            for r, op in enumerate(ops):
                ids, rowptr = ((op.src, op.rowptr) if direction == "forward"
                               else (op.t_ids, op.t_rowptr))
                with torch.no_grad():
                    got = ss.gather_segment_sum(x, ids, rowptr)
                    err = smoke.close_scaled(
                        got, ss.gather_segment_sum_plain(x, ids, rowptr),
                        f"{label}/{direction}/D{x.shape[1]}/bucket{r}")
                    csr = smoke.library_csr(x, ids, rowptr, None)
                    t = smoke.time_calls({
                        "kernel": lambda: ss.launch(x, ids, rowptr),
                        "library": lambda: csr @ x})
                b = smoke.bound(x, ids, rowptr, None, rowptr.numel() - 1)
                row = dict(label=label, direction=direction,
                           shape=f"D{x.shape[1]}/bucket{r}",
                           edges=ids.numel(), **t, max_abs_err=err,
                           bound_ms=max(b["byte_ms"], b["op_ms"]),
                           gather_tb_per_s=ids.numel() * x.shape[1] * 4
                           / t["kernel_ms"] / 1e9, card=smi)
                rows.append(row)
                print(json.dumps(row), flush=True)
    sums = {}
    for direction in ("forward", "backward"):
        part = [r for r in rows if r["direction"] == direction]
        for key in ("kernel_ms", "kernel_call_ms", "library_ms",
                    "library_call_ms", "bound_ms"):
            sums[f"{direction}_{key}"] = sum(r[key] for r in part)
        sums[f"{direction}_worst_kernel_over_library"] = max(
            r["kernel_ms"] / r["library_ms"] for r in part)
    print(json.dumps({"label": label, "sums": sums, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "tree"))
