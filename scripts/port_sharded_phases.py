#!/usr/bin/env python3
"""The sharded layouts' phases of ``chip_smoke.py`` alone, on one CUDA card.

    python3 scripts/port_sharded_phases.py [node] [edge] [dp] [dist]

Run from the repository's root; no argument runs all four groups. It
builds kernels B1, B2, B3 and B4 (and the C++ graph builder), then drives
``chip_smoke.py``'s own phase functions at their full sizes, the node and
edge groups with fewer timed steps:

- node: on the ``bench.py`` graph the node-sharded step's gradients and
  its training (10 steps float32, 5 bf16); on config 3's graph
  (``primekg_full_like`` + ``bidirect``) the node step through the
  relation scan (gradients, 4 timed steps) beside the kept-partials step
  (``uniform_caps=False``, 4 steps), the sharded encode and top-10 against
  the dense ones;
- edge: the edge-sharded step's gradients (float32 and bf16) and training
  (10 steps), on config 3's graph the edge step (gradients, 4 steps), then
  the edge CLI;
- dp: the data-parallel sampled steps (``sampled_dp_grad``, the fetch
  backward's B2 stream, ``sampled_dp_train``, ``sampled_dp_cli``) and
  ``full_kg_zero3`` on config 4's graph, as in ``chip_smoke.py``;
- dist: ``--distributed`` (``phase_distributed``): the one-process NCCL
  edge CLI against the plain one, and the edge and zero3 steps on two
  processes of the one card against one process.

Each phase prints its ``chip_smoke.py`` line, and a ``##`` line gives the
seconds since the start: a quick check of these paths before a whole
``chip_smoke.py`` run.
"""

import concurrent.futures
import dataclasses
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from primekg_rgcn_tpu_torch import native
    from primekg_rgcn_tpu_torch.config import ModelConfig
    from primekg_rgcn_tpu_torch.data import artifacts, synthetic
    from primekg_rgcn_tpu_torch.ops.cuda import dense_segment_sum as pds
    from primekg_rgcn_tpu_torch.ops.cuda import halo
    from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as ss
    from primekg_rgcn_tpu_torch.ops.cuda import window_fetch as pwf
    from primekg_rgcn_tpu_torch.parallel.node_shard import partition_nodes

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    def mark(what):
        print(f"## {what} at {time.perf_counter() - t_start:.1f}s",
              flush=True)

    groups = set(sys.argv[1:]) or {"node", "edge", "dp", "dist"}
    if groups - {"node", "edge", "dp", "dist"}:
        print(f"unknown groups {sorted(groups)}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    libs = [ss.LIBRARY, ss.LIBRARY_BF16, pds.LIBRARY, pds.LIBRARY_BF16,
            pwf.LIBRARY, halo.LIBRARY]
    with concurrent.futures.ThreadPoolExecutor(len(libs) + 1) as pool:
        builder = pool.submit(native.native_available)
        list(pool.map(lambda lib: lib.build(verbose=False), libs))
        if not builder.result():
            raise AssertionError("the native graph builder did not build")
    mark("built")
    raw = synthetic.primekg_like(seed=0, scale=1.0)
    su, du, ru = synthetic.bidirect(raw["src"], raw["dst"], raw["rel"])
    graph = artifacts.split_to_rel_graph({
        "edge_index": np.stack([su, du]), "edge_type": ru,
        "num_nodes": raw["num_nodes"], "num_relations": 3}).to(dev)
    edges = np.stack([su, du, ru], 1)
    cfg = ModelConfig(num_nodes=graph.num_nodes, num_relations=3)
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if "node" in groups:
            psg = partition_nodes(graph, cs.N_SHARDS)
            cs.phase_node_grad(graph, psg, cfg, edges, dev)
            mark("node_grad")
            cs.phase_node_train(psg, cfg, edges, dev, tmp, steps=10)
            mark("node_train")
            cs.phase_node_train(psg, cfg16, edges, dev, tmp, steps=5)
            mark("node_bf16")
        if "edge" in groups:
            _, f32 = cs.phase_edge_grad(graph, cfg, edges, dev)
            mark("edge_grad")
            cs.phase_edge_grad(graph, cfg16, edges, dev, label="edge_bf16",
                               f32_run=f32)
            mark("edge_bf16")
            del f32
            cs.phase_edge_train(graph, cfg, edges, dev, tmp, steps=10)
            mark("edge_train")
        if "dp" in groups:
            _, calls = cs.phase_sampled_dp_grad(graph, cfg, edges, dev)
            mark("sampled_dp_grad")
            cs.phase_kernel_b2_fetch(calls, -(-graph.num_nodes
                                               // cs.N_SHARDS))
            del calls
            mark("kernel_b2_fetch")
            cs.phase_sampled_dp_train(graph, cfg, edges, dev, tmp)
            mark("sampled_dp_train")
            cs.phase_sampled_dp_cli(tmp)
            mark("sampled_dp_cli")
        if "dist" in groups:
            cs.phase_distributed(REPO, tmp, graph, cfg, edges, dev)
            mark("distributed")
        if groups & {"node", "edge", "dp"}:
            g3_cpu, edges3 = cs.phase_full_kg_graph(REPO)
            g3 = g3_cpu.to(dev)
            cfg3 = ModelConfig(num_nodes=g3.num_nodes,
                               num_relations=g3.num_relations)
            if "node" in groups:
                psg3 = partition_nodes(g3_cpu, cs.N_SHARDS)
                mark("full_kg_node_partition")
                cs.phase_node_grad(g3, psg3, cfg3, edges3, dev,
                                   label="full_kg_node_grad")
                mark("full_kg_node_grad")
                cs.phase_node_train(psg3, cfg3, edges3, dev, tmp, steps=4,
                                    label="full_kg_node_train")
                mark("full_kg_node_train")
                kept = partition_nodes(g3_cpu, cs.N_SHARDS, uniform_caps=False)
                cs.phase_node_train(kept, cfg3, edges3, dev, tmp, steps=4,
                                    label="full_kg_node_train_kept")
                mark("full_kg_node_train_kept")
                del kept
                cs.phase_full_kg_node_serve(g3, psg3, dev)
                mark("full_kg_node_serve")
            if "edge" in groups:
                cs.phase_edge_grad(g3, cfg3, edges3, dev,
                                   label="full_kg_edge_grad")
                mark("full_kg_edge_grad")
                cs.phase_edge_train(g3, cfg3, edges3, dev, tmp, steps=4,
                                    label="full_kg_edge_train")
                mark("full_kg_edge_train")
                cs.phase_edge_cli(tmp)
                mark("edge_cli")
            if "dp" in groups:
                cs.phase_full_kg_zero3(g3, cfg3, edges3, dev, tmp)
                mark("full_kg_zero3")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
