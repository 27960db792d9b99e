#!/usr/bin/env python3
"""The graphed-epoch phases of ``chip_smoke.py`` alone, on one CUDA card.

    python3 scripts/port_graphed_phases.py [bench] [kg] [rmat]

Run from the repository's root; no argument runs all three groups. It
builds kernels B1, B2 and B3 (and the C++ graph builder), then drives
``chip_smoke.py``'s own phase functions at their full sizes:

- bench: on the ``bench.py`` graph, ``train_graphed`` (the full-graph
  epoch as CUDA graphs at K = 1, 4 and 32 against the eager epoch, bit
  for bit, each timed and profiled), ``eval_graphed``,
  ``sampled_train_graphed`` (block over the slim CSR, K = 1, 4, 32) and
  ``train_cli_graphed`` (``--steps_per_scan 2``, resumed twice);
- kg: BASELINE config 3, ``full_kg_trainer`` (the ``Trainer``'s graphed
  epoch, its launches counted in a profile) and ``full_kg_train_graphed``
  (the restricted final layer's split update, graphed against eager at
  the grad criterion, at one and at four micro-batches an update, and a
  forced overflow);
- rmat: BASELINE config 5, ``rmat10m_graph`` then
  ``rmat10m_cache_graphed`` (the cached step, bit for bit).

Each phase prints its ``chip_smoke.py`` line, and a ``##`` line gives the
seconds since the start: the quick check of these paths, and the source
of the K figures in PERF.md.
"""

import concurrent.futures
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
    from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as ss
    from primekg_rgcn_tpu_torch.ops.cuda import window_fetch as pwf

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    def mark(what):
        print(f"## {what} at {time.perf_counter() - t_start:.1f}s",
              flush=True)

    groups = set(sys.argv[1:]) or {"bench", "kg", "rmat"}
    if groups - {"bench", "kg", "rmat"}:
        print(f"unknown groups {sorted(groups)}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    cs.emit("env", torch=torch.__version__, cuda=torch.version.cuda,
            register_generator_state=hasattr(torch.cuda.CUDAGraph,
                                             "register_generator_state"))
    dev = torch.device("cuda")
    libs = [ss.LIBRARY, pds.LIBRARY, pds.LIBRARY_BF16, pwf.LIBRARY]
    with concurrent.futures.ThreadPoolExecutor(len(libs) + 1) as pool:
        builder = pool.submit(native.native_available)
        list(pool.map(lambda lib: lib.build(verbose=False), libs))
        if not builder.result():
            raise AssertionError("the native graph builder did not build")
    mark("built")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if "bench" in groups:
            raw = synthetic.primekg_like(seed=0, scale=1.0)
            su, du, ru = synthetic.bidirect(raw["src"], raw["dst"],
                                            raw["rel"])
            graph = artifacts.split_to_rel_graph({
                "edge_index": np.stack([su, du]), "edge_type": ru,
                "num_nodes": raw["num_nodes"], "num_relations": 3}).to(dev)
            cfg = ModelConfig(num_nodes=graph.num_nodes, num_relations=3)
            edges = np.stack([su, du, ru], 1)
            cs.phase_train_graphed(graph, cfg, edges, dev, tmp)
            mark("train_graphed")
            cs.phase_eval_graphed(graph, cfg, edges, dev, tmp)
            mark("eval_graphed")
            cs.phase_sampled_train_graphed(graph, cfg, edges, dev, tmp)
            mark("sampled_train_graphed")
            cs.phase_train_cli_graphed(tmp)
            mark("train_cli_graphed")
            del graph
        if "kg" in groups:
            g3_cpu, edges3 = cs.phase_full_kg_graph(REPO)
            g3 = g3_cpu.to(dev)
            cs.phase_full_kg_trainer(g3, edges3, dev, tmp)
            mark("full_kg_trainer")
            cs.phase_full_kg_train_graphed(g3, edges3, dev, tmp)
            mark("full_kg_train_graphed")
            del g3, g3_cpu, edges3
        if "rmat" in groups:
            ccsr, edges = cs.phase_rmat10m_graph(dev)
            mark("rmat10m_graph")
            cfg5 = ModelConfig(num_nodes=cs.RMAT10M[0],
                               num_relations=ccsr.num_relations,
                               compute_dtype="bfloat16")
            cs.phase_rmat10m_cache_graphed(ccsr, cfg5, edges, dev, tmp)
            mark("rmat10m_cache_graphed")
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
