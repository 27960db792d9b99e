#!/usr/bin/env python3
"""Kernel B3 of the PyTorch + CUDA port, timed on the window streams the
main paths give it, beside the row gather and, optionally, other B3
sources.

    python3 scripts/port_time_b3.py [--config5] [--old OLD.cu ...]
        [--cold] [--host]

Run from the repository's root on a machine with one CUDA card. It records
B3's real window streams, as ``chip_smoke.py`` makes them (its helpers are
imported from there): the outer and inner layers of one block and one
block4 step on the ``bench.py`` graph (fanouts 15/10, seed 0), 30,976
windows of 64 at random starts and, with ``--config5``, the block and
block4 layers of one config-5 batch over its 100M-record table (the graph
takes about a minute of host work and 21 GB of host memory). For each
stream it holds the kernel against its plain version and two launches
against each other (``chip_smoke.b3_equal``: ``torch.equal``), then times
it with ``chip_smoke.time_calls`` (device time of each call from a
``torch.profiler`` trace, and ``call_ms``) beside the row gather
(``rec[idx]``, the index precomputed), the plain version and
``chip_smoke.b3_bound``.

``--old`` names other B3 sources, each named by its directory and
unpacked under ``chipcheck/``: for example the parent commit's
``csrc/window_fetch.cu`` (the first design, one warp a window) or
variants of the current source, whose entry point takes the current
one's arguments (``packed, starts, out, M, width, rows, stream``) and,
where it names ``magic``, a window multiplier (``magic, shift``) before
the stream. Each is built beside the current source, held against the
plain version too, and timed with it in two traces in one process: the
other sources first, then the current one, then the other way round
(``_ms`` and ``_b_ms``); no trace times one callable under two names.
``--cold`` adds cold-L2 times (128 MB written
before each call). ``--host`` times the host work of each piece of the
wrapper over 1,000 calls at the four block and block4 shapes of the
``bench.py`` graph, the launch path before ``call_on_stream`` beside it,
and ``call_ms`` of the kernel and the row gather (kernel B4's rounds
against ``copy_`` are ``scripts/port_time_b4.py``). One JSON line per
stream (and per host shape), then the card's name and power limit.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def window_magic(width):
    """``(magic, shift)`` with ``r // width == umulhi(2 * r, magic) >>
    shift`` for every record index ``0 <= r < 2**31``, for a variant whose
    entry takes them."""
    shift = (width - 1).bit_length()
    return (2 ** (31 + shift) + width - 1) // width, shift


def other_kernel(source):
    """A launcher for another B3 source, on the current launch path
    (``call_on_stream``): its entry point takes the current one's
    arguments and, when its parameter list names ``magic``, a window
    multiplier (``window_magic``) before the stream."""
    from primekg_rgcn_tpu_torch.ops.cuda.build import (CudaLibrary,
                                                       call_on_stream,
                                                       check_rc)

    params = re.search(r"window_rows_fetch_i32\(([^)]*)\)",
                       Path(source).read_text()).group(1)
    magic = "magic" in params
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib = CudaLibrary("window_fetch.cu", {"window_rows_fetch_i32": (
        p, p, p, i, i, i, *((u, i) if magic else ()), p)})
    lib.source = Path(source).resolve()

    def launch(rows, starts, width):
        m = starts.shape[0]
        out = rows.new_empty((m, width, 2))
        rc = call_on_stream(lib.load().window_rows_fetch_i32,
                            rows.get_device(), rows.data_ptr(),
                            starts.data_ptr(), out.data_ptr(), m, width,
                            rows.shape[0],
                            *(window_magic(width) if magic else ()))
        check_rc(rc, f"window_rows_fetch from {source}")
        return out

    return lib, launch


def bench_graph(dev):
    """The ``bench.py`` graph on ``dev``, its config and its edges."""
    import numpy as np

    from primekg_rgcn_tpu_torch.config import ModelConfig
    from primekg_rgcn_tpu_torch.data import artifacts, synthetic

    raw = synthetic.primekg_like(seed=0, scale=1.0)
    src_u, dst_u, rel_u = synthetic.bidirect(raw["src"], raw["dst"],
                                             raw["rel"])
    graph = artifacts.split_to_rel_graph({
        "edge_index": np.stack([src_u, dst_u]), "edge_type": rel_u,
        "num_nodes": raw["num_nodes"], "num_relations": 3}).to(dev)
    cfg = ModelConfig(num_nodes=graph.num_nodes, num_relations=3)
    return graph, cfg, np.stack([src_u, dst_u, rel_u], 1)


def host_us(fn, calls=1000):
    """Host microseconds a call of ``fn`` over ``calls`` calls (the device
    is waited for after the loop, outside the time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def host_pieces(smoke, name, packed, starts, width):
    """The host time of each piece of ``window_rows_fetch`` / ``launch``
    at one shape (the entry point called with no window: no launch), the
    launch path before ``call_on_stream`` beside it, and ``call_ms`` of
    the kernel and the row gather."""
    import torch

    from primekg_rgcn_tpu_torch.ops.cuda import window_fetch as pwf
    from primekg_rgcn_tpu_torch.ops.cuda.build import (call_on_stream,
                                                       check_rc)

    rows = pwf._rows(packed)
    dev = rows.device
    m = starts.shape[0]
    entry = pwf.LIBRARY.load().window_rows_fetch_i32
    stream = torch.cuda.current_stream(dev).cuda_stream
    no_windows = (rows.data_ptr(), starts.data_ptr(), 0, 0, width,
                  rows.shape[0])

    def device_context():
        with torch.cuda.device(dev):
            pass

    def context_and_stream():  # every wrapper's launch path before
        with torch.cuda.device(dev):
            entry(*no_windows, torch.cuda.current_stream().cuda_stream)

    idx = starts.long()[:, None] + torch.arange(width, device=dev)
    pieces = {
        "rows_and_check": lambda: pwf._check(pwf._rows(packed), starts,
                                             width),
        "empty": lambda: torch.empty((m, width, 2), dtype=torch.int32,
                                     device=dev),
        "new_empty": lambda: rows.new_empty((m, width, 2)),
        "data_ptr_check": lambda: rows.data_ptr() % 8,
        "library_load": lambda: pwf.LIBRARY.load(),
        "current_device": torch.cuda.current_device,
        "get_device_int": rows.get_device,
        "cuda_get_device": torch._C._cuda_getDevice,
        "device_context": device_context,
        "current_stream_dev": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "ctypes_no_launch": lambda: entry(*no_windows, stream),
        "call_on_stream_no_launch": lambda: call_on_stream(
            entry, dev.index, *no_windows),
        "context_and_stream_no_launch": context_and_stream,
        "check_rc": lambda: check_rc(0, "window_rows_fetch"),
        "launch": lambda: pwf.launch(rows, starts, width),
        "window_rows_fetch": lambda: pwf.window_rows_fetch(packed, starts,
                                                           width),
        "row_gather": lambda: rows[idx]}
    us = {k: host_us(fn) for k, fn in pieces.items()}
    calls = {"kernel": lambda: pwf.launch(rows, starts, width),
             "library": lambda: rows[idx]}
    call_ms = {f"{k}_call_ms": smoke.event_ms(fn) for k, fn in calls.items()}
    return dict(shape=name, windows=m, width=width, host_us=us, **call_ms,
                kernel_over_library_call=call_ms["kernel_call_ms"]
                / call_ms["library_call_ms"])


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config5", action="store_true")
    ap.add_argument("--old", nargs="+", default=[])
    ap.add_argument("--cold", action="store_true")
    ap.add_argument("--host", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_time_b3.py needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    from primekg_rgcn_tpu_torch.config import ModelConfig
    from primekg_rgcn_tpu_torch.ops.cuda import window_fetch as pwf

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    libs = [pwf.LIBRARY]
    others = {}  # the other sources' launchers, by their directory's name
    for source in args.old:
        lib, others[Path(source).resolve().parent.name] = other_kernel(source)
        libs.append(lib)
    for lib in libs:
        _, text = lib.build(verbose=True)
        print(json.dumps({"build": lib.library_path().name,
                          "source": os.path.relpath(lib.source, REPO),
                          "ptxas": [ln.strip() for ln in text.splitlines()
                                    if "registers" in ln or "spill" in ln]}),
              flush=True)

    graph, cfg, edges = bench_graph(dev)
    streams = smoke.b3_streams(graph, cfg, edges, dev)
    if args.host:
        for name, packed, starts, width in streams[:4]:
            print(json.dumps({"host": True, **host_pieces(
                smoke, name, packed, starts, width), "card": smi}),
                flush=True)
    if args.config5:
        ccsr, edges5 = smoke.phase_rmat10m_graph(dev)
        cfg5 = ModelConfig(num_nodes=smoke.RMAT10M[0],
                           num_relations=ccsr.num_relations,
                           compute_dtype="bfloat16")
        streams += smoke.rmat10m_b3_streams(ccsr, cfg5, edges5, dev)

    for name, packed, starts, width in streams:
        smoke.b3_equal(name, packed, starts, width)
        rows = packed.view(-1, 2)
        want = pwf.window_rows_fetch_plain(packed, starts, width)
        kernels = {k: (lambda f=f: f(rows, starts, width))
                   for k, f in others.items()}
        for k, fn in kernels.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"{name}: the {k} kernel differs")
        kernels["kernel"] = lambda: pwf.launch(rows, starts, width)
        idx = starts.long()[:, None] + torch.arange(width, device=dev)
        t = smoke.time_calls({
            **kernels, "library": lambda: rows[idx],
            "plain": lambda: pwf.window_rows_fetch_plain(packed, starts,
                                                         width)})
        if others:  # the turns the other way round, in a trace of their own
            t_b = smoke.time_calls(dict(reversed(kernels.items())))
            t.update({f"{k}_b_ms": t_b[f"{k}_ms"] for k in kernels})
        if args.cold:
            cold = {**kernels, "library": lambda: rows[idx]}
            c = smoke.time_calls(cold, before=smoke.l2_flush(dev))
            t.update({f"{k}_cold_ms": c[f"{k}_ms"] for k in cold})
        bnd = smoke.b3_bound(starts, width)
        b = smoke.bound_fields(bnd)
        row = dict(stream=name, records=rows.shape[0], windows=starts.numel(),
                   width=width, distinct_records=bnd["distinct_records"], **t,
                   vs_library=t["kernel_ms"] / t["library_ms"],
                   bound_share=b["bound_us"] / 1e3 / t["kernel_ms"], **b,
                   card=smi)
        print(json.dumps(row), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
