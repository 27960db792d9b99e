#!/usr/bin/env python3
"""The bench-module phases of ``chip_smoke.py`` alone, on one CUDA card.

    python3 scripts/port_bench_phases.py [grad] [suite] [roofline] \
        [traces] [probes] [scaling] [pod] [psum] [--rows ROW ...]

Run from the repository's root; no group runs all eight. It builds the four
kernels (and the C++ graph builder), then drives ``chip_smoke.py``'s own
phase functions:

- grad: ``grad_bases``, one full-size step of the ``bench.py`` graph with
  the basis decomposition (``num_bases=2``) against the plain versions;
- suite: ``bench_suite``, ``python -m primekg_rgcn_tpu_torch.bench.suite``
  over every row of its ``CONFIGS`` (or ``--rows``) as a child;
- roofline: ``ici_roofline``, ``python -m
  primekg_rgcn_tpu_torch.bench.ici_roofline`` over the suite's report at
  the NVLink rate (run after suite, or every layout reads "not
  measured");
- traces: ``bench_trace``, 10-step traces of the primekg-bases and
  rmat-large rows;
- probes: ``config3_probe`` and ``restricted_probe`` at scale 1.0;
- scaling: ``scaling``, every sharded layout at 1-8 shards, scale 0.25;
- pod: ``pod_scale``, config 5's node-sharded and zero3 steps, each in a
  child;
- psum: ``psum_probe``, the mesh's collectives alone: one process on a
  2-shard mesh, one through NCCL, two sharing the card through gloo.

Each phase prints its ``chip_smoke.py`` lines, and a ``##`` line gives the
seconds since the start.
"""

import argparse
import concurrent.futures
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
GROUPS = ("grad", "suite", "roofline", "traces", "probes", "scaling", "pod",
          "psum")


def main():
    import functools

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
    from primekg_rgcn_tpu_torch.ops.rgcn_segment import (aggregate_plain,
                                                         rgcn_layer_segment)

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("groups", nargs="*", help=f"any of {GROUPS}")
    p.add_argument("--rows", nargs="+", default=None,
                   help="the suite's rows (default: all)")
    args = p.parse_args()
    groups = set(args.groups) or set(GROUPS)
    if groups - set(GROUPS):
        p.error(f"unknown groups {sorted(groups - set(GROUPS))}")
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    def mark(what):
        print(f"## {what} at {time.perf_counter() - t_start:.1f}s",
              flush=True)

    dev = torch.device("cuda")
    libs = [ss.LIBRARY, ss.LIBRARY_BF16, pds.LIBRARY, pds.LIBRARY_BF16,
            pwf.LIBRARY, halo.LIBRARY]
    with concurrent.futures.ThreadPoolExecutor(len(libs) + 1) as pool:
        builder = pool.submit(native.native_available)
        list(pool.map(lambda lib: lib.build(verbose=False), libs))
        if not builder.result():
            raise AssertionError("the native graph builder did not build")
    mark("built")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if "grad" in groups:
            raw = synthetic.primekg_like(seed=0, scale=1.0)
            su, du, ru = synthetic.bidirect(raw["src"], raw["dst"],
                                            raw["rel"])
            graph = artifacts.split_to_rel_graph({
                "edge_index": np.stack([su, du]), "edge_type": ru,
                "num_nodes": raw["num_nodes"], "num_relations": 3}).to(dev)
            cfg = ModelConfig(num_nodes=graph.num_nodes, num_relations=3,
                              num_bases=2)
            cs.phase_grad(graph, cfg, np.stack([su, du, ru], 1), dev,
                          functools.partial(rgcn_layer_segment,
                                            agg_fn=aggregate_plain),
                          label="grad_bases")
            mark("grad_bases")
            del graph
        suite_rows = {}
        if "suite" in groups:
            suite_rows = cs.phase_bench_suite(REPO, tmp, args.rows)
            mark("bench_suite")
        if "roofline" in groups:
            cs.phase_ici_roofline(REPO, tmp)
            mark("ici_roofline")
        if "traces" in groups:
            cs.phase_bench_traces(tmp, suite_rows)
            mark("bench_traces")
        if "probes" in groups:
            cs.phase_bench_probes()
            mark("bench_probes")
        if "scaling" in groups:
            cs.phase_bench_scaling()
            mark("scaling")
        if "pod" in groups:
            cs.phase_pod_scale(REPO)
            mark("pod_scale")
        if "psum" in groups:
            cs.phase_psum_probe()
            mark("psum_probe")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
