"""Probe: what the mesh's collectives cost by themselves.

The counterpart of ``primekg_rgcn_tpu/bench/psum_probe.py``, which timed
``shard_map`` collectives on a 1-device mesh to see whether a backend
mediates them through the host. The port's sharded steps take their
collectives from ``parallel/mesh.py``: a local loop over the shards in one
process, and across processes one ``dist.all_reduce`` each (gloo stages
CUDA tensors through the host; NCCL runs on the cards). This probe times
the same four things on x = [31000, 64] float32 of ones:

(a) a plain elementwise ``x * 2 + 1``;
(b) one ``mesh.psum`` of every shard's copy of x;
(c) 11 chained psums, each scaled by 0.5;
(d) 12 leaves of [100, 8], the gradients' shape, summed across the
    processes by ``mesh.all_reduce_`` (the path the steps' gradients take;
    on one process it does nothing).

A port mesh needs 2 shards or more, so each setting is a path that the
port runs: ``local``, one process with a 2-shard mesh (the loop that every
single-controller sharded step pays); P processes meeting through
``train/multichip.maybe_initialize_distributed`` (the backend rule: gloo
on the CPU or when processes share the card, as ``distributed_steps``
pays); and with P = 1 the same bring-up alone (NCCL on a card, gloo on the
CPU, as ``distributed_cli`` pays: a mesh on one process never calls a
collective). A setting with a process group also times (e) one
``dist.all_reduce`` of x, the backend's own cost of one collective, and
(f) one ``dist.all_reduce`` of ones at each payload that the port's steps
send across processes (``STEP_PAYLOADS``).

Every probe returns a number whose closed form the run reports beside it,
with n shards over P processes and x of ones: (a) 3; (b) n; (c) n^11 *
0.5^10; (d) P * 800 * (12 + 66), the sum over the leaves of every
process's copy; (e) and (f) P. Times are the median of ``reps`` calls:
host ms from the call until the card is idle again, device ms between two CUDA
events around the call on its stream (not measured on the CPU).

Run: ``python -m primekg_rgcn_tpu_torch.bench.psum_probe [--device
cuda|cpu] [--processes 1 2] [--reps 20]`` (the card by default). Each
setting prints one JSON line; on the card the first line is the card's
name and power limit from ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

SHAPE = (31000, 64)
CHAIN = 11
LEAVES = 12
LEAF = (100, 8)
CHILD_TIMEOUT_S = 300
# The float32 payloads that the port's steps all-reduce across processes
# on the bench.py graph (30,926 nodes, 3 relations, ModelConfig's widths
# 64 and 128), as chip_smoke.py's distributed phase runs them: the edge
# step's partial sums ([N, 64] six times a step, [N, 128] six times), the
# gradient of every parameter (2,078,208 floats, once a step in the edge
# and node steps), and zero3's fetch buffer at 4 shards (the requesters'
# rows forward and their cotangents backward, [4, cap, 64] each; at batch
# 1,024 and fanouts 15/10 the frontier's cap saturates at N + 1 rounded up
# to 64, 30,976).
STEP_PAYLOADS = {"edge_partial_64": (30926, 64),
                 "edge_partial_128": (30926, 128),
                 "gradient": (2078208,),
                 "zero3_fetch": (4, 30976, 64)}


def probes(mesh) -> Dict[str, Callable]:
    """The probes over ``mesh``: each takes x and returns a tensor."""
    from primekg_rgcn_tpu_torch.parallel.mesh import all_reduce_, psum

    k = len(mesh.local)

    def one_psum(x):
        return psum([x] * k, mesh)

    def chained(x):
        a = x
        for _ in range(CHAIN - 1):
            a = psum([a] * k, mesh) * 0.5
        return psum([a] * k, mesh)

    def leaves(x):
        parts = [x[:LEAF[0], :LEAF[1]] + i for i in range(LEAVES)]
        all_reduce_(parts, mesh)
        return sum(p.sum() for p in parts)

    return {"elementwise": lambda x: x * 2 + 1, "psum": one_psum,
            f"psum_chain_{CHAIN}": chained,
            f"all_reduce_{LEAVES}_leaves": leaves}


def closed_forms(n_shards: int, world: int) -> Dict[str, float]:
    """Each probe's value (an element of (a)-(c), the sum of (d), an
    element of (e)) for x of ones, n shards over ``world`` processes."""
    cells = LEAF[0] * LEAF[1]
    return {"elementwise": 3.0, "psum": float(n_shards),
            f"psum_chain_{CHAIN}": float(n_shards) ** CHAIN
            * 0.5 ** (CHAIN - 1),
            f"all_reduce_{LEAVES}_leaves": float(
                world * cells * sum(1 + i for i in range(LEAVES))),
            "dist_all_reduce": float(world),
            **{f"dist_all_reduce_{k}": float(world) for k in STEP_PAYLOADS}}


def _value(out) -> float:
    return float(out.reshape(-1)[0])


def time_calls(fn: Callable, x, reps: int) -> Dict:
    """``fn(x)`` twice to warm up, then ``reps`` calls, each alone: the
    median host ms (the call until the card is idle) and device ms (CUDA
    events around it; None on the CPU), and the last value."""
    import torch

    cuda = x.device.type == "cuda"
    for _ in range(2):
        out = fn(x)
    host, device = [], []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        out = fn(x)
        if cuda:
            end.record()
            torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            device.append(start.elapsed_time(end))
    return {"host_ms": statistics.median(host),
            "device_ms": statistics.median(device) if cuda else None,
            "value": _value(out)}


def run_setting(setting: str, device: str, reps: int) -> Dict:
    """Every probe in this process on a mesh over the live process group
    (none: one process), x of ones: {setting, processes, backend, shards,
    device, probes: {name: times, value, closed form}}."""
    import torch
    import torch.distributed as dist

    from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh

    group = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if group else 1
    n = max(2, world)
    mesh = make_mesh(n, device)
    x = torch.ones(SHAPE, device=mesh.device)
    fns = probes(mesh)
    if group:
        def raw(a):
            out = a.clone()
            dist.all_reduce(out)
            return out
        fns["dist_all_reduce"] = raw
    want = closed_forms(n, world)
    rows = {}
    for name, fn in fns.items():
        rows[name] = time_calls(fn, x, reps)
    if group:
        for name, shape in STEP_PAYLOADS.items():
            payload = torch.ones(shape, device=mesh.device)
            rows[f"dist_all_reduce_{name}"] = {
                **time_calls(raw, payload, reps),
                "mb": payload.numel() * payload.element_size() / 2 ** 20}
            del payload
    for name, row in rows.items():
        row["closed_form"] = want[name]
    return {"setting": setting, "processes": world,
            "backend": dist.get_backend() if group else None,
            "shards": n, "device": str(mesh.device),
            "x_mb": x.numel() * x.element_size() / 2 ** 20,
            "reps": reps, "probes": rows}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child(argv: Sequence[str]) -> int:
    """One process of a setting: ``setting rank world port device
    reps``. Process 0 prints the setting's JSON line."""
    from primekg_rgcn_tpu_torch.train.multichip import (
        maybe_initialize_distributed)

    setting, rank, world, port, device, reps = argv
    rank, world = int(rank), int(world)
    maybe_initialize_distributed(f"localhost:{port}", world, rank,
                                 device=device)
    row = run_setting(setting, device, int(reps))
    if rank == 0:
        print(json.dumps(row), flush=True)
    return 0


def run_group(setting: str, world: int, device: str, reps: int) -> Dict:
    """``world`` child processes of this module meeting at a free port;
    returns process 0's row. Raises with the children's errors if one
    fails; every child is killed in ``finally``."""
    port = _free_port()
    root = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "primekg_rgcn_tpu_torch.bench.psum_probe",
         "--child", setting, str(r), str(world), str(port), device,
         str(reps)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=CHILD_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"psum_probe {setting}: a process exited "
                               f"{p.returncode}: {err[-3000:]}")
    return json.loads(outs[0][0].strip().splitlines()[-1])


def run_probe(device: str = "cuda", processes: Sequence[int] = (1, 2),
              reps: int = 20) -> List[Dict]:
    """Each setting's row: for P = 1 ``local`` (this process, no group)
    and ``group_1`` (one process through the bring-up), for P > 1
    ``group_P`` (P processes, each its own copy of x)."""
    rows = []
    for world in processes:
        if world == 1:
            rows.append(run_setting("local", device, reps))
        rows.append(run_group(f"group_{world}", world, device, reps))
    return rows


def card_line() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--child"]:
        sys.exit(_child(argv[1:]))
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--processes", type=int, nargs="+", default=[1, 2])
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    if args.device == "cuda":
        print(json.dumps({"card": card_line()}), flush=True)
    rows = run_probe(args.device, args.processes, args.reps)
    for row in rows:
        print(json.dumps({"psum_probe": row}), flush=True)
    return rows


if __name__ == "__main__":
    main()
