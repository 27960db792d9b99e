#!/usr/bin/env python3
"""Kernel B4 of the PyTorch + CUDA port, timed at the node-sharded step's
exchange shapes beside ``copy_`` of the same bytes and, optionally, other
B4 sources.

    python3 scripts/port_time_b4.py [--old OLD.cu ...] [--cold] [--host]
        [--rounds 11]

Run from the repository's root on a machine with one CUDA card. The six
shapes are the exchanges of a 4-shard node step (``partition_nodes``): on
the ``bench.py`` graph (P = 7,736) at D 64 and 128 in float32 and bf16,
and on config 3's graph (``primekg_full_like`` + ``bidirect``, P =
31,856) at D 64 and 128 in float32, each shard sending the rows of its
serve lists of a random table (``chip_smoke.b4_sends``). At each shape the
kernel is held against its plain version and two launches against each
other (``chip_smoke.b4_equal``), then timed in ``--rounds`` interleaved
rounds of ``chip_smoke.time_calls`` (device time of each call from a
``torch.profiler`` trace, and ``call_ms``) beside ``copy_`` of the same
bytes, the order of the callables turned each round: each callable's
median, least and largest device ms, and its ratio to ``copy_`` round by
round (median, least, largest). The plain version is timed once, and
``chip_smoke.b4_bound`` is beside it all.

``--old`` names other B4 sources, each named by its directory and
unpacked under ``chipcheck/``: the parent commit's
``csrc/halo_exchange.cu``, or variants of the current source. Their entry
points take the current one's arguments; each is built beside the current
source, held against the plain version too, and timed in the same rounds
(every callable once a trace). ``--cold`` adds the same rounds with
128 MB written before each call (``chip_smoke.l2_flush``). ``--host``
times the host work of each piece of the wrapper (``ops/cuda/halo.py``:
``launch``) over 1,000 calls at the four ``bench.py`` shapes, each call
from an idle stream, the previous wrapper's launch path in Python beside
it, and ``call_ms`` of the kernel, that path and ``copy_``. One JSON line
a shape (and a host shape), then the card's name and power limit.
"""

import argparse
import concurrent.futures
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def other_kernel(source):
    """A launcher for another B4 source on the current launch path: the
    recvs allocated, the step offsets and the vector (``vec_width``) as
    the wrapper makes them; no launch is counted."""
    import torch

    from primekg_rgcn_tpu_torch.ops.cuda import halo
    from primekg_rgcn_tpu_torch.ops.cuda.build import (CudaLibrary,
                                                       call_on_stream,
                                                       check_rc)

    lib = CudaLibrary("halo_exchange.cu", {"halo_exchange_f32": halo._ARGS,
                                           "halo_exchange_bf16": halo._ARGS})
    lib.source = Path(source).resolve()

    def launch(sends):
        s0 = sends[0]
        n, p, d = s0.shape
        recvs = [torch.empty_like(s0) for _ in range(n)]
        ptrs = [s.data_ptr() for s in sends] + [r.data_ptr() for r in recvs]
        table = ctypes.c_uint64 * n
        loaded = lib.load()
        entry = (loaded.halo_exchange_bf16 if s0.dtype == torch.bfloat16
                 else loaded.halo_exchange_f32)
        rc = call_on_stream(entry, s0.get_device(), table(*ptrs[:n]),
                            table(*ptrs[n:]), halo._offsets(n), n, p, d,
                            halo.vec_width(p, d, s0.element_size(), ptrs))
        check_rc(rc, f"halo_exchange from {source}")
        return recvs

    return lib, launch


def previous_launch(sends):
    """The previous wrapper's launch path (``torch.empty_like`` for each
    recv, the offsets and the library looked up every call), launching the
    current kernel: the yardstick of ``--host``."""
    import torch

    from primekg_rgcn_tpu_torch.ops.cuda import halo
    from primekg_rgcn_tpu_torch.ops.cuda.build import call_on_stream, check_rc

    n, p, d = sends[0].shape
    recvs = [torch.empty_like(sends[0]) for _ in range(n)]
    ptrs = [s.data_ptr() for s in sends] + [r.data_ptr() for r in recvs]
    wide = 16 // sends[0].element_size()
    vec = wide if d % wide == 0 and all(q % 16 == 0 for q in ptrs) else 1
    table = ctypes.c_uint64 * n
    bf16 = sends[0].dtype == torch.bfloat16
    lib = halo.LIBRARY.load()
    entry = lib.halo_exchange_bf16 if bf16 else lib.halo_exchange_f32
    rc = call_on_stream(
        entry, sends[0].get_device(), table(*ptrs[:n]), table(*ptrs[n:]),
        (ctypes.c_int * n)(*halo.step_offsets(n)), n, p, d, vec)
    check_rc(rc, "halo_exchange")
    return recvs


def partitions(smoke):
    """The 4-shard node partitions of the ``bench.py`` graph and of config
    3's graph."""
    from primekg_rgcn_tpu_torch.data import graph as pgraph
    from primekg_rgcn_tpu_torch.data import synthetic
    from primekg_rgcn_tpu_torch.parallel.node_shard import partition_nodes

    sys.path.insert(0, str(REPO / "scripts"))
    from port_time_b3 import bench_graph

    import torch

    graph, _, _ = bench_graph(torch.device("cpu"))
    raw = synthetic.primekg_full_like(seed=0, scale=1.0)
    src, dst, rel = synthetic.bidirect(raw["src"], raw["dst"], raw["rel"])
    g3 = pgraph.build_rel_graph(src, dst, rel, raw["num_nodes"],
                                raw["num_relations"])
    return (("main_path", partition_nodes(graph, smoke.N_SHARDS)),
            ("full_kg", partition_nodes(g3, smoke.N_SHARDS)))


def host_us(fn, calls=1000):
    """Host microseconds of one call of ``fn`` from an idle stream, the
    median over ``calls`` calls (the device is waited for after each call,
    outside the time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def host_pieces(smoke, name, sends):
    """The host time of each piece of ``halo_exchange`` / ``launch`` at one
    shape (the entry point called with no rows: its checks and parameter
    block, no launch), the previous launch path beside it, and ``call_ms``
    of the kernel, that path and ``copy_``."""
    import torch

    from primekg_rgcn_tpu_torch.ops.cuda import halo
    from primekg_rgcn_tpu_torch.ops.cuda.build import call_on_stream

    s0 = sends[0]
    n, p, d = s0.shape
    dev = s0.device
    recvs = halo.launch(sends)
    ptrs = [s.data_ptr() for s in sends] + [r.data_ptr() for r in recvs]
    table = ctypes.c_uint64 * n
    sp, rp = table(*ptrs[:n]), table(*ptrs[n:])
    loaded = halo.LIBRARY.load()
    entry = (loaded.halo_exchange_bf16 if s0.dtype == torch.bfloat16
             else loaded.halo_exchange_f32)
    vec = halo.vec_width(p, d, s0.element_size(), ptrs)
    src = torch.zeros(sum(t.numel() for t in sends), device=dev,
                      dtype=s0.dtype)
    dst = torch.empty_like(src)
    pieces = {
        "check": lambda: halo._check(sends),
        "empty_like_n": lambda: [torch.empty_like(s0) for _ in range(n)],
        "new_empty_n": lambda: [s0.new_empty((n, p, d)) for _ in range(n)],
        "torch_empty_n": lambda: [torch.empty((n, p, d), dtype=s0.dtype,
                                              device=dev) for _ in range(n)],
        "data_ptrs": lambda: [s.data_ptr() for s in (*sends, *recvs)],
        "vec_width": lambda: halo.vec_width(p, d, s0.element_size(), ptrs),
        "pointer_tables": lambda: (table(*ptrs[:n]), table(*ptrs[n:])),
        "offsets_built": lambda: (ctypes.c_int * n)(*halo.step_offsets(n)),
        "offsets_cached": lambda: halo._offsets(n),
        "library_load_entry": lambda: halo.LIBRARY.load().halo_exchange_f32,
        "get_device": s0.get_device,
        "entry_no_launch": lambda: call_on_stream(
            entry, dev.index, sp, rp, halo._offsets(n), n, 0, d, vec),
        "launch": lambda: halo.launch(sends),
        "previous_launch": lambda: previous_launch(sends),
        "halo_exchange": lambda: halo.halo_exchange(sends),
        "copy_": lambda: dst.copy_(src)}
    us = {k: host_us(fn) for k, fn in pieces.items()}
    calls = {"kernel": lambda: halo.launch(sends),
             "previous_launch": lambda: previous_launch(sends),
             "library": lambda: dst.copy_(src)}
    call_ms = {f"{k}_call_ms": smoke.event_ms(fn) for k, fn in calls.items()}
    return dict(shape=name, dtype=str(s0.dtype).split(".")[-1], host_us=us,
                **call_ms,
                kernel_minus_library_call_us=(call_ms["kernel_call_ms"]
                                              - call_ms["library_call_ms"])
                * 1e3,
                previous_minus_library_call_us=(
                    call_ms["previous_launch_call_ms"]
                    - call_ms["library_call_ms"]) * 1e3)


def rounds_of(smoke, fns, rounds, before=None):
    """``rounds`` rounds of ``time_calls`` over ``fns``, the order turned
    each round (rotated by the round, reversed every other): each name's
    device ms and call ms, round by round."""
    names = list(fns)
    seen = {k: [] for k in names}
    calls = {k: [] for k in names}
    for r in range(rounds):
        order = names[r % len(names):] + names[:r % len(names)]
        if r % 2:
            order.reverse()
        t = smoke.time_calls({k: fns[k] for k in order}, before=before)
        for k in names:
            seen[k].append(t[f"{k}_ms"])
            calls[k].append(t[f"{k}_call_ms"])
    return seen, calls


def summary(seen, calls, suffix=""):
    """Median, least and largest device ms of each name, its median
    call ms, and its ratio to ``library`` round by round."""
    out = {}
    for k, v in seen.items():
        ratio = [a / b for a, b in zip(v, seen["library"])]
        out.update({f"{k}{suffix}_ms_median": statistics.median(v),
                    f"{k}{suffix}_ms_min": min(v),
                    f"{k}{suffix}_ms_max": max(v),
                    f"{k}{suffix}_call_ms_median":
                        statistics.median(calls[k])})
        if k != "library":
            out.update({f"{k}{suffix}_over_library_median":
                            statistics.median(ratio),
                        f"{k}{suffix}_over_library_min": min(ratio),
                        f"{k}{suffix}_over_library_max": max(ratio)})
    return out


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", nargs="+", default=[])
    ap.add_argument("--cold", action="store_true")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--rounds", type=int, default=11)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_time_b4.py needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    from primekg_rgcn_tpu_torch.ops.cuda import halo

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    others = {}  # the other sources' launchers, by their directory's name
    libs = [halo.LIBRARY]
    for source in args.old:
        lib, others[Path(source).resolve().parent.name] = other_kernel(source)
        libs.append(lib)
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        built = list(pool.map(lambda lib: lib.build(verbose=True), libs))
    for lib, (_, text) in zip(libs, built):
        print(json.dumps({"build": lib.library_path().name,
                          "source": os.path.relpath(lib.source, REPO),
                          "ptxas": [ln.strip() for ln in text.splitlines()
                                    if "registers" in ln or "spill" in ln
                                    or "smem" in ln]}), flush=True)

    gen = torch.Generator(dev).manual_seed(6)
    shapes = []
    for where, psg in partitions(smoke):
        for dtype in ((torch.float32, torch.bfloat16)
                      if where == "main_path" else (torch.float32,)):
            for d in (64, 128):
                name = (f"{where}/n{psg.n_devices}/P{psg.halo_width}/D{d}/"
                        f"{str(dtype).split('.')[-1]}")
                shapes.append((name, smoke.b4_sends(psg, d, dtype, gen, dev)))

    if args.host:
        for name, sends in shapes[:4]:
            print(json.dumps({"host": True, **host_pieces(smoke, name, sends),
                              "card": smi}), flush=True)

    for name, sends in shapes:
        smoke.b4_equal(name, sends)
        want = halo.halo_exchange_plain(sends)
        for k, fn in others.items():
            for a, b, w in zip(fn(sends), fn(sends), want):
                if not (torch.equal(a, w) and torch.equal(b, w)):
                    raise AssertionError(f"{name}: the {k} kernel differs")
        flat = sum(t.numel() for t in sends)
        src = torch.randn(flat, device=dev, generator=gen).to(sends[0].dtype)
        dst = torch.empty_like(src)
        fns = {**{k: (lambda f=f: f(sends)) for k, f in others.items()},
               "kernel": lambda: halo.launch(sends),
               "library": lambda: dst.copy_(src)}
        row = dict(shape=name, rounds=args.rounds,
                   **summary(*rounds_of(smoke, fns, args.rounds)))
        if args.cold:
            row.update(summary(*rounds_of(smoke, fns, args.rounds,
                                          before=smoke.l2_flush(dev)),
                               suffix="_cold"))
        plain = smoke.time_calls(
            {"plain": lambda: halo.halo_exchange_plain(sends)})
        b = smoke.bound_fields(smoke.b4_bound(sends))
        row.update(plain_ms=plain["plain_ms"], l2_warm=flat * src.element_size()
                   <= smoke.l2_bytes(dev), **b, card=smi)
        print(json.dumps(row), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
