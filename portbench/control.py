"""The readings that a training cell's limits are set from:
``python -m portbench.control --workload <name> --seeds <n> ...``.

For each seed, in one process: the cell's set-up and warm epoch (the
program's first updates, as a run takes them), then against the plain
reference in float32:

- ``program``: the program's numbers, the sound runs (lower readings);
- ``control``: the reference computed with TF32 matmuls, the nearest
  precision below the configuration's float32 (an upper reading);
- ``half`` and ``answer``: the reference with half of the batch left out
  (the mean over the rest) and with its first score altered, two of the
  faults a training cell can have. A state left unchanged reads 1 in
  ``change_gap`` by its definition and needs no run.

One JSON line a seed, with the step or leaf that each number comes from
(``worst``); the benchmark's runs never run this. It also prints
the restricted final layer's edge ratio at the cell's batch (the graph's
edges over the plan's capacity, which ``"auto"`` compares with 6.0).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import check, spec
from portbench.run import Run, sub_seeds


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    bench = spec.benchmark(spec.PKG.parent)
    cell_spec = spec.workload(bench, args.workload)
    driver = spec.driver(spec.traffic(cell_spec["traffic"])["driver"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = Run(config=spec.config(cell_spec["config"]),
                  traffic=spec.traffic(cell_spec["traffic"]), seconds=0.0,
                  trace=False, device=args.device, started=t0,
                  seeds=sub_seeds(seed))
        cell = driver.Cell(run)
        ratio = edge_ratio(cell)
        cell.release()
        ref = cell.reference()
        line = {"workload": args.workload, "seed": seed,
                "setup_s": cell.setup_s, "edge_ratio": ratio, "worst": {}}
        for name, kw in (("program", None),
                         ("control", {"precision": "tf32"}),
                         ("half", {"fault": "half"}),
                         ("answer", {"fault": "answer"})):
            worst: dict = {}
            got = cell.got if kw is None else cell.reference(**kw)
            line[name] = check.readings(got, ref, worst)
            line["worst"][name] = worst
        print(json.dumps(line), flush=True)
    return 0


def edge_ratio(cell) -> float:
    """The graph's edges over the capacity of a restricted plan at the
    cell's batch (the port's ``plan_final_layer`` and ``edge_ratio``)."""
    from primekg_rgcn_tpu_torch.ops.rgcn_final_layer import (
        edge_ratio as ratio, plan_final_layer)

    plan = cell.plan or plan_final_layer(
        cell.graph, cell.train, cell.b, cell.k, seed=cell.train_cfg.seed)
    return ratio(cell.graph, plan)


if __name__ == "__main__":
    sys.exit(main())
