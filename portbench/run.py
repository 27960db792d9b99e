"""One run of one cell: ``python -m portbench --workload <name> --seed <n>
--seconds <s> --trace <0|1>``.

The harness finds the cell's files by name (``spec.py``), hands the cell
to its traffic driver, which builds the program's training object, warms
it up, measures for ``--seconds`` and checks its first updates against the
plain reference, then prints one JSON line as its last line of standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer ones with ``--trace
1``), ``device`` and, traced, ``breakdown``; last, ``checks``, each number
compared beside its limit (the numbers that ``limits/<cell>.json`` names,
each read by the driver), which also close standard error.

Without a CUDA device, or with fewer devices than the cell asks for, it
exits 2 and prints no result. ``--device cpu`` rehearses a tiny cell on
the CPU, for the tests; its lines name the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np

from portbench import check, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "primekg_rgcn_tpu")
SUB_SEEDS = ("weights", "sample", "perm", "device", "flops")


@dataclass
class Run:
    """What a driver gets: the cell's configuration and traffic, the run's
    arguments, the seeds drawn from ``--seed``, and where the process
    started."""
    config: Dict
    traffic: Dict
    seconds: float
    trace: bool
    device: str
    started: float
    seeds: Dict[str, int]
    log: Callable[[str], None] = field(
        default=lambda msg: print(msg, file=sys.stderr, flush=True))


def sub_seeds(seed: int) -> Dict[str, int]:
    """Independent 32-bit seeds, one a use, drawn from ``seed`` (any
    non-negative int)."""
    words = np.random.SeedSequence(seed).generate_state(len(SUB_SEEDS),
                                                        np.uint32)
    return {k: int(w) for k, w in zip(SUB_SEEDS, words)}


def forbidden_modules() -> list:
    """Top-level names of loaded modules that no run may load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cpu: a rehearsal for the tests, never a measurement")
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be >= 0")
    return args


def _device_fields(device: str, count: int, peak: int) -> Dict:
    import torch

    kind = "cpu" if device == "cpu" else torch.cuda.get_device_name(0)
    return {"platform": "cpu" if device == "cpu" else "gpu", "kind": kind,
            "count": count, "memory_peak_bytes": peak}


def main(argv=None, started: Optional[float] = None) -> int:
    started = time.perf_counter() if started is None else started
    args = _parse(argv)
    try:
        bench = spec.benchmark(spec.PKG.parent)
        cell = spec.workload(bench, args.workload)
        run = Run(config=spec.config(cell["config"]),
                  traffic=spec.traffic(cell["traffic"]), seconds=args.seconds,
                  trace=bool(args.trace), device=args.device,
                  started=started, seeds=sub_seeds(args.seed))
        limits = spec.limits(args.workload)
        layer_metrics = spec.metrics_of(bench["per_layer"], args.workload)
        readers = {m["name"]: spec.reader(m["name"]) for m in layer_metrics}
        driver = spec.driver(run.traffic["driver"])
    except spec.SpecError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2

    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
                  "device(s); none or too few found", file=sys.stderr)
            return 2

    out = driver.run(run)

    metrics = {}
    summary = out.get("trace")
    if args.trace:
        for m in layer_metrics:
            value = readers[m["name"]].read(out["layer"], summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec.metrics_of(bench["end_to_end"], args.workload):
            if m["name"] not in out["end_to_end"]:
                print(f"portbench: the driver measured no {m['name']}",
                      file=sys.stderr)
                return 3
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                  "unit": m["unit"]}

    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3

    read = out["readings"]
    if check.unmatched(read, limits):
        print(f"portbench: limits/{args.workload}.json and the driver's "
              f"readings differ: {check.unmatched(read, limits)}",
              file=sys.stderr)
        return 3
    correct = (check.judge(read, limits) and out["failed"] == 0
               and all(math.isfinite(v["value"]) for v in metrics.values()))
    device = _device_fields(args.device, cell["chips"],
                            out["memory_peak_bytes"])
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace and summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        line["breakdown"] = {
            "device_ops": [list(x) for x in summary.device_ops],
            "idle_gaps": [list(x) for x in summary.idle_gaps]}
    line["checks"] = {k: {"value": read[k], "limit": limits[k]}
                      for k in limits}
    for k in limits:
        print(f"check {k} {read[k]!r} limit {limits[k]!r}",
              file=sys.stderr)
    print(json.dumps(_plain(line), allow_nan=False), flush=True)
    return 0


def _plain(obj):
    """``obj`` with each non-finite float as its text, so the line stays
    strict JSON."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_plain(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    return obj
