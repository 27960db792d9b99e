#!/usr/bin/env python3
"""The phases that ``chip_smoke.py`` runs last, alone, on one CUDA card.

    python3 scripts/port_config5_phases.py [agg] [cache] [rmat]

Run from the repository's root; no argument runs all three groups. It
builds kernels B1, B2 and B3 (and the C++ graph builder), then drives
``chip_smoke.py``'s own phase functions at their full sizes:

- agg: ``combined_agg``, config 4 (``primekg_full_like`` + ``bidirect``,
  uniform at fanouts 15/10) under the einsum, rowwise and chunked
  reductions;
- cache: ``sampled_cache``, the layer-1 cache on the ``bench.py`` graph
  (warm start, one cached step against the plain versions, the CLI);
- rmat: BASELINE config 5 (``rmat10m_graph``, ``rmat10m_grad`` with B2 on
  its two streams, B3 at its block and block4 windows, ``rmat10m_sampled``
  and ``rmat10m_cache``).

Each phase prints its ``chip_smoke.py`` line, and a ``##`` line gives the
seconds since the start: a quick check of these paths before a whole
``chip_smoke.py`` run.
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

    groups = set(sys.argv[1:]) or {"agg", "cache", "rmat"}
    if groups - {"agg", "cache", "rmat"}:
        print(f"unknown groups {sorted(groups)}", file=sys.stderr)
        return 2
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
        if "agg" in groups:
            g3_cpu, edges3 = cs.phase_full_kg_graph(REPO)
            g3 = g3_cpu.to(dev)
            cfg3 = ModelConfig(num_nodes=g3.num_nodes,
                               num_relations=g3.num_relations)
            cs.phase_combined_agg(g3, cfg3, edges3, dev, tmp)
            mark("combined_agg")
            del g3, g3_cpu, edges3
        if "cache" in groups:
            raw = synthetic.primekg_like(seed=0, scale=1.0)
            su, du, ru = synthetic.bidirect(raw["src"], raw["dst"],
                                            raw["rel"])
            graph = artifacts.split_to_rel_graph({
                "edge_index": np.stack([su, du]), "edge_type": ru,
                "num_nodes": raw["num_nodes"], "num_relations": 3}).to(dev)
            cfg = ModelConfig(num_nodes=graph.num_nodes, num_relations=3)
            cs.phase_sampled_cache(graph, cfg, np.stack([su, du, ru], 1),
                                   dev, tmp)
            mark("sampled_cache")
            del graph
        if "rmat" in groups:
            ccsr, edges = cs.phase_rmat10m_graph(dev)
            mark("rmat10m_graph")
            cfg5 = ModelConfig(num_nodes=cs.RMAT10M[0],
                               num_relations=ccsr.num_relations,
                               compute_dtype="bfloat16")
            cs.phase_rmat10m_grad(ccsr, cfg5, edges, dev)
            mark("rmat10m_grad")
            cs.phase_rmat10m_b3(ccsr, cfg5, edges, dev)
            mark("rmat10m_b3")
            cs.phase_rmat10m_sampled(ccsr, cfg5, edges, dev, tmp)
            mark("rmat10m_sampled")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
