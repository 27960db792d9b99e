#!/usr/bin/env python3
"""Kernel B2 of the PyTorch + CUDA port, timed on the streams the main paths
give it, beside ``index_add_`` and, optionally, an older B2 source.

    python3 scripts/port_time_b2.py [--old OLD.cu] [--alt ALT.cu]
        [--no_config4] [--wave WARPS] [--breakdown]

Run from the repository's root on a machine with one CUDA card. It records
B2's real input streams, as ``chip_smoke.py`` makes them (its helpers are
imported from there): the identity and dedup backwards of one block-mode
sampled step on the ``bench.py`` graph (fanouts 15/10, seed 0), float32 and
bf16; the batch-restricted final layer's segment-sum stream of one config-3
step; and, unless ``--no_config4``, the identity and dedup streams of one
config-4 sampled step. For each stream it holds the kernel against its
plain version (``close_scaled``) and two launches against each other
(``torch.equal``), then times it with ``chip_smoke.time_calls`` (device time
of each call from a ``torch.profiler`` trace, and ``call_ms``) beside
``index_add_`` of the float32 rows and ``chip_smoke.b2_bound``.

``--old`` names a B2 source with the entry points of the design before the
row split (``dense_sorted_segment_sum_f32`` / ``_bf16(msg, ids, out, L, D,
N, vec, stream)``, both in one library), for example the parent commit's
``csrc/dense_segment_sum.cu`` unpacked under ``chipcheck/``. It is built
into the same build directory, held against the plain version too, and
timed in turns with the new kernel (old, new, new, old) in this one
process. ``--alt`` names another source with this version's entry points
and scratch (or more of it), timed the same way (``alt_a``, ``alt_b``).
``--wave`` sets ``WAVE_WARPS_PER_SM`` of the piece plan for this
run; ``--breakdown`` adds each stream's device time by kernel name (the zeros,
the split and its fix-up), from a ``torch.profiler`` table of 20 calls. One
JSON line per stream, then the card.
"""

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def old_kernel(source):
    """A launcher for the pre-split B2 source at ``source``."""
    import torch

    from primekg_rgcn_tpu_torch.ops.cuda.build import CudaLibrary

    args = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
    lib = CudaLibrary("dense_segment_sum.cu", {
        "dense_sorted_segment_sum_f32": args,
        "dense_sorted_segment_sum_bf16": args})
    lib.source = Path(source).resolve()

    def vec_width(d, *tensors):  # the old design's load width
        for vec, min_d in ((4, 128), (2, 64), (4, 4), (2, 2)):
            if d % vec == 0 and d >= min_d and all(
                    t.data_ptr() % (t.element_size() * vec) == 0
                    for t in tensors):
                return vec
        return 1

    def launch(msg, srt, n):
        out = torch.empty(n, msg.shape[1], device=msg.device)
        loaded = lib.load()
        entry = (loaded.dense_sorted_segment_sum_bf16
                 if msg.dtype == torch.bfloat16
                 else loaded.dense_sorted_segment_sum_f32)
        rc = entry(msg.data_ptr(), srt.data_ptr(), out.data_ptr(),
                   msg.shape[0], msg.shape[1], n,
                   vec_width(msg.shape[1], msg, out),
                   torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"old B2 launch failed: {rc}")
        return out

    return lib, launch


def alt_kernel(source):
    """A launcher for another source with the entry points of
    ``ops/cuda/dense_segment_sum``'s libraries, built from ``source``."""
    import torch

    from primekg_rgcn_tpu_torch.ops.cuda import dense_segment_sum as pds
    from primekg_rgcn_tpu_torch.ops.cuda.build import CudaLibrary
    from primekg_rgcn_tpu_torch.ops.cuda.segment_sum import _num_sms

    libs = {}
    for dtype, base, defines in (
            (torch.float32, pds.LIBRARY, ()),
            (torch.bfloat16, pds.LIBRARY_BF16, ("-DB2_ROWS_BF16",))):
        libs[dtype] = CudaLibrary(base.source.name, base.functions, defines)
        libs[dtype].source = Path(source).resolve()

    def launch(msg, srt, n):
        ln, d = msg.shape
        out = torch.empty(n, d, device=msg.device)
        vec, lanes = pds.b2_width(d, msg, out)
        min_rows, pieces = pds.piece_plan(ln, _num_sms(msg.device))
        carry = torch.empty(pieces * d, device=msg.device)
        meta = torch.empty(2 + pieces, dtype=torch.int32, device=msg.device)
        loaded = libs[msg.dtype].load()
        entry = getattr(loaded, next(iter(libs[msg.dtype].functions)))
        rc = entry(msg.data_ptr(), srt.data_ptr(), out.data_ptr(),
                   carry.data_ptr(), meta.data_ptr(), ln, d, n, vec, lanes,
                   min_rows, pieces, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"alt B2 launch failed: {rc}")
        return out

    return list(libs.values()), launch


def record_streams(smoke, dev, config4):
    """{name: (msg, ids, n)} of B2's real streams (see the docstring)."""
    import dataclasses

    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
    from primekg_rgcn_tpu_torch.data import artifacts, synthetic
    from primekg_rgcn_tpu_torch.models import rgcn
    from primekg_rgcn_tpu_torch.ops import rgcn_final_layer as pfl
    from primekg_rgcn_tpu_torch.ops.rgcn_segment import rgcn_layer_segment
    from primekg_rgcn_tpu_torch.train.sampled import build_sampled_train_step

    def sampled_streams(graph, cfg, edges, prefix):
        params, _, pos, csrs = smoke.sampled_setup(graph, cfg, edges, dev)
        step = build_sampled_train_step(csrs["slim"], cfg, TrainConfig(),
                                        fanouts=(15, 10), mode="block",
                                        device=dev)
        calls = {}
        with smoke.sampler_kernels(("record", calls)):
            _, _, batch = smoke.sampled_forward_backward(step, params, cfg,
                                                         pos, dev)
        got = {}
        for msg, srt, n in calls["b2"]:
            for name, block in (("ident", batch.blocks[0]),
                                ("dedup", batch.blocks[1])):
                if srt.data_ptr() == block.sort_uid.data_ptr():
                    got[f"{prefix}_{name}"] = (msg, srt, n)
        if len(got) != 2:
            raise AssertionError(f"{prefix}: B2 calls {len(calls['b2'])}, "
                                 f"matched {sorted(got)}")
        return got

    raw = synthetic.primekg_like(seed=0, scale=1.0)
    src_u, dst_u, rel_u = synthetic.bidirect(raw["src"], raw["dst"],
                                             raw["rel"])
    graph = artifacts.split_to_rel_graph({
        "edge_index": np.stack([src_u, dst_u]), "edge_type": rel_u,
        "num_nodes": raw["num_nodes"], "num_relations": 3}).to(dev)
    edges = np.stack([src_u, dst_u, rel_u], 1)
    cfg = ModelConfig(num_nodes=graph.num_nodes, num_relations=3)
    streams = sampled_streams(graph, cfg, edges, "bench")
    streams.update(sampled_streams(
        graph, dataclasses.replace(cfg, compute_dtype="bfloat16"), edges,
        "bench_bf16"))
    del graph

    g3_cpu, edges3 = smoke.phase_full_kg_graph(REPO)
    g3 = g3_cpu.to(dev)
    cfg3 = ModelConfig(num_nodes=g3.num_nodes, num_relations=g3.num_relations)
    plan = pfl.resolve_final_plan(g3, edges3, 1024, 1, seed=42, mode="on")
    params = rgcn.init_params(torch.Generator().manual_seed(0), cfg3,
                              device=dev)
    enc = params["encoder"]
    with torch.no_grad():
        h1 = torch.relu(rgcn_layer_segment(enc["conv1"], enc["node_emb"],
                                           g3))
        h1p = torch.cat([h1, h1.new_zeros(1, h1.shape[1])])
        cands = smoke.full_kg_candidates(g3, edges3, dev, plan, seed=1)
        nodes = torch.cat([cands[0], cands[1]])
        ns, _, is_dup = pfl.sorted_batch(nodes)
        start, deg, off, _ = pfl.batch_ranges(plan, ns, is_dup)
        seg, src, scale = pfl.enumerate_slots(g3, plan, start, deg, off)
        grp = pfl.GatherGroupSum.apply(h1p, src, scale, plan.group)
    streams["config3_restricted"] = (
        grp, seg[::plan.group].to(torch.int32).contiguous(),
        g3.num_relations * nodes.numel())
    if config4:
        streams.update(sampled_streams(g3, cfg3, edges3, "config4"))
    return streams


def kernel_breakdown(fn, calls=20):
    """Mean device microseconds a call by kernel name over ``calls`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total",
                        getattr(evt, "cuda_time_total", 0.0))
        if total > 0 and "dense_segment_sum" in evt.key:
            name = next((f"dense_segment_sum_{k}_kernel"
                         for k in ("zero", "fixup") if k in evt.key),
                        "dense_segment_sum_kernel")
            out[name] = out.get(name, 0.0) + total / calls
    return out


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", default=None)
    ap.add_argument("--alt", default=None)
    ap.add_argument("--no_config4", action="store_true")
    ap.add_argument("--wave", type=int, default=None)
    ap.add_argument("--breakdown", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_time_b2.py needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    from primekg_rgcn_tpu_torch.ops.cuda import dense_segment_sum as pds

    if args.wave:
        pds.WAVE_WARPS_PER_SM = args.wave
        pds.piece_plan.cache_clear()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    libs = [pds.LIBRARY, pds.LIBRARY_BF16]
    old = None
    if args.old:
        old_lib, old = old_kernel(args.old)
        libs.append(old_lib)
    alt = None
    if args.alt:
        alt_libs, alt = alt_kernel(args.alt)
        libs += alt_libs
    for lib in libs:
        _, text = lib.build(verbose=True)
        print(json.dumps({"build": lib.library_path().name, "ptxas": [
            ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln]}), flush=True)

    streams = record_streams(smoke, dev, not args.no_config4)
    for name, (msg, srt, n) in streams.items():
        want = pds.dense_sorted_segment_sum_plain(msg, srt, n)
        first = pds.dense_sorted_segment_sum(msg, srt, n)
        second = pds.dense_sorted_segment_sum(msg, srt, n)
        torch.cuda.synchronize()
        err = smoke.close_scaled(first, want, f"{name}/new")
        if not torch.equal(first, second):
            raise AssertionError(f"{name}: two launches differ")
        fns = {"kernel": lambda: pds.launch(msg, srt, n)}
        if old is not None:
            smoke.close_scaled(old(msg, srt, n), want, f"{name}/old")
            fns = {"old_a": lambda: old(msg, srt, n), **fns}
        if alt is not None:
            smoke.close_scaled(alt(msg, srt, n), want, f"{name}/alt")
            fns = {"alt_a": lambda: alt(msg, srt, n), **fns}
        idx = srt.clamp(max=n).long()
        buf = torch.zeros(n + 1, msg.shape[1], device=dev)
        t = smoke.time_calls({
            **fns, "library": lambda: buf.index_add_(0, idx, msg.float())})
        late = {"kernel_b": lambda: pds.launch(msg, srt, n)}
        if alt is not None:
            late["alt_b"] = lambda: alt(msg, srt, n)
        if old is not None:
            late["old_b"] = lambda: old(msg, srt, n)
        if len(late) > 1:
            t.update(smoke.time_calls(late))
        b = smoke.b2_bound(msg, srt, n)
        runs = torch.unique_consecutive(srt[srt < n], return_counts=True)[1]
        bound = smoke.bound_fields(b)
        if args.breakdown:
            t["kernel_us_by_name"] = kernel_breakdown(
                lambda: pds.launch(msg, srt, n))
        row = dict(stream=name, dtype=str(msg.dtype).replace("torch.", ""),
                   wave_warps_per_sm=pds.WAVE_WARPS_PER_SM,
                   rows=msg.shape[0], d=msg.shape[1], segments=n,
                   real_rows=b["real_rows"], runs=int(runs.numel()),
                   longest_run=int(runs.max()), **t, max_abs_err=err,
                   bound_share=bound["bound_us"] / 1e3 / t["kernel_ms"],
                   **bound, card=smi)
        print(json.dumps(row), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
