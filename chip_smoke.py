#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing JSON lines (any failure raises and exits non-zero):

1. env: torch and CUDA versions, the card's name and power limit.
2. build: compiles the gather + segment-sum kernel from
   ``primekg_rgcn_tpu_torch/csrc/gather_segment_sum.cu`` with nvcc (sm_90a).
3. kernel: the kernel against its plain PyTorch version on the card, at the
   six (relation bucket, D) shapes one encode of the full default model
   gives it (with those inputs), in edge-norm mode, at several widths and on
   the edge cases (empty CSR, one giant row, every edge to its own row,
   an unaligned table); per main-path shape, kernel, plain and cuSPARSE
   times (CUDA events, median) beside the memory bound. The kernel is timed
   bare (``launch``) and through its wrapper. Three child processes hand it
   a CSR that does not cover ``src`` or a ``src`` id outside the table and
   must stop on the kernel's device-side assert.
4. serve: the top-K serving entry point ``predict_cli.main`` on the full
   PrimeKG-shaped synthetic graph (30,926 nodes, 1,709,568 padded edges) and
   the default 64 -> 128 -> 128 model with random weights from seed 0, for
   three relations; checks 6 kernel launches per encode and the top-K
   against an encode through the plain version; times encode and query.
5. kernel_bwd: the kernel over each bucket's transpose CSR (the backward)
   against the plain version at the six backward shapes of one training
   step, in edge-norm mode, and ``GatherSegmentSum``'s gradient on a random
   non-symmetric graph against autograd through the plain version; kernel,
   plain and cuSPARSE times beside the memory bound.
6. grad: one full-size training step (the ``bench.py`` configuration)
   through the kernel and through the plain version, with the same
   parameters, batch, negatives and dropout mask; every parameter's
   gradient must agree; 6 forward and 6 backward launches.
7. train: the ``bench.py`` step on the port (``train/loop.train_step``):
   3 warm-up then 50 timed steps on the host clock, 12 launches per step,
   edges/s, peak memory; then a ``torch.profiler`` trace of 10 steps, read
   for where the step's device time goes and the device's idle share.
8. train_cli: ``train.cli.main`` on the synthetic graph at scale 0.1 for 2
   epochs at full width, then ``predict_cli.main`` from its final model.
9. the kernel summary line, then the card line, then the result line.

It needs one CUDA card and exits non-zero without one.
"""

import json
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

TOL = dict(rtol=1e-4, atol=1e-4)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
WARMUP, REPS = 3, 25


# Child process for one malformed input: it must die on the kernel's
# device-side assert and never reach the last line.
BAD_INPUT_CHILD = """
import torch
from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as ss
i32 = dict(dtype=torch.int32, device="cuda")
x = torch.ones(5, 64, device="cuda")
src = torch.zeros(3, **i32)
{case}
with torch.no_grad():
    ss.gather_segment_sum(x, src, rowptr)
torch.cuda.synchronize()
print("no fault")
"""


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps=REPS, warmup=WARMUP):
    """Median device time of ``fn`` in ms, one CUDA event pair per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, reps=10, warmup=2):
    """Median wall time of ``fn`` in ms, ended by a device synchronise."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(x, src, rowptr, scale, s):
    """Least time for the function, in ms, both ways: each input byte read
    once and the output written once at the HBM rate, and its 2*E*D float32
    operations at the float32 peak. The bound is the larger of the two."""
    d = x.shape[1]
    nbytes = (x.numel() + src.numel() + rowptr.numel() + s * d) * 4
    if scale is not None:
        nbytes += scale.numel() * 4
    return {"bytes": nbytes, "byte_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "op_ms": 2 * src.numel() * d / F32_FLOPS * 1e3}


def library_csr(x, src, rowptr, scale):
    """cuSPARSE's CSR @ dense for the same function (columns sorted within
    rows); timed as a yardstick only, the port never calls it."""
    import numpy as np
    import torch

    rp = rowptr.cpu().numpy()
    s_host = src.cpu().numpy()
    dst = np.repeat(np.arange(rp.shape[0] - 1), np.diff(rp))
    order = np.lexsort((s_host, dst))
    vals = (torch.ones(src.shape[0], device=x.device) if scale is None
            else scale[torch.from_numpy(order).to(x.device)])
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
        warnings.filterwarnings("ignore", "Sparse invariant checks")
        return torch.sparse_csr_tensor(
            rowptr, torch.from_numpy(s_host[order]).to(x.device), vals,
            size=(rp.shape[0] - 1, x.shape[0]), device=x.device,
            check_invariants=False)


def close_scaled(got, want, name):
    """rtol and atol 1e-4, the atol scaled to the case's largest magnitude:
    the kernel sums each row in CSR order and the plain version's
    index_add_ on the card in atomic order, so two sums of the same signed
    terms differ by rounding relative to the terms, not to the result.
    Returns the largest absolute difference."""
    import torch

    top = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * max(top, 1e-30),
                               msg=lambda m: f"{name}: {m}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def named_leaves(params, prefix=""):
    if isinstance(params, dict):
        for k, v in params.items():
            yield from named_leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], params


def phase_kernel_bwd(graph, dev):
    """The backward's launches: the kernel over each bucket's transpose CSR
    against the plain version; returns the six main-path rows and the
    largest error."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as ss
    from primekg_rgcn_tpu_torch.ops.rgcn_segment import build_layer_agg_ops

    kern, plain = ss.gather_segment_sum, ss.gather_segment_sum_plain
    n = graph.num_nodes
    ops = build_layer_agg_ops(graph)
    gen = torch.Generator(dev).manual_seed(1)
    rows, max_err = [], 0.0
    grads = {}
    for d in (64, 128):
        # A layer aggregate's gradient: [N+1, D], its dummy row zero (the
        # forward drops that row).
        g = torch.randn(n + 1, d, device=dev, generator=gen)
        g[n] = 0.0
        grads[d] = g
        for r, op in enumerate(ops):
            name = f"bwd/D{d}/bucket{r}"
            with torch.no_grad():
                got = kern(g, op.t_ids, op.t_rowptr)
                want = plain(g, op.t_ids, op.t_rowptr)
            torch.cuda.synchronize()
            err = close_scaled(got, want, name)
            max_err = max(max_err, err)
            csr = library_csr(g, op.t_ids, op.t_rowptr, None)
            with torch.no_grad():
                close_scaled(csr @ g, want, f"{name}/cusparse")
                k_ms = cuda_ms(lambda: ss.launch(g, op.t_ids, op.t_rowptr))
                p_ms = cuda_ms(lambda: plain(g, op.t_ids, op.t_rowptr))
                l_ms = cuda_ms(lambda: csr @ g)
            b = bound(g, op.t_ids, op.t_rowptr, None, n + 1)
            deg = torch.diff(op.t_rowptr[:n + 1])
            row = dict(shape=name, edges=op.t_ids.numel(), d=d,
                       max_out_degree=int(deg.max()),
                       nonempty_rows=int((deg > 0).sum()),
                       kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                       bound_us=max(b["byte_ms"], b["op_ms"]) * 1e3,
                       bound_by="bytes" if b["byte_ms"] >= b["op_ms"] else "operations",
                       byte_us=b["byte_ms"] * 1e3, op_us=b["op_ms"] * 1e3,
                       bytes=b["bytes"], max_abs_err=err)
            rows.append(row)
            emit("kernel_bwd_main_path", **row)

    # Edge-norm mode: the gene-gene bucket's transpose with its per-edge
    # 1/in-degree(dst) scales in source order.
    op = ops[2]
    in_deg = torch.diff(op.rowptr).float().clamp(min=1.0)
    t_scale = torch.where(op.t_ids < n, 1.0 / in_deg[op.t_ids.long()],
                          torch.zeros((), device=dev)).contiguous()
    with torch.no_grad():
        got = kern(grads[128], op.t_ids, op.t_rowptr, t_scale)
        want = plain(grads[128], op.t_ids, op.t_rowptr, t_scale)
    err = close_scaled(got, want, "bwd/edge_norm/bucket2/D128")
    max_err = max(max_err, err)
    emit("kernel_bwd_case", case="edge_norm/bucket2/D128",
         edges=op.t_ids.numel(), max_abs_err=err)

    # A non-symmetric graph (sources concentrated on a quarter of the rows):
    # the Function's gradient, the kernel over the transpose CSR, against
    # autograd through the plain version over the forward CSR.
    rng = np.random.default_rng(5)
    rows_n, e = 5000, 60000
    src = rng.integers(0, rows_n // 4, e)
    dst = np.sort(rng.integers(0, rows_n, e))
    t_order = np.argsort(src, kind="stable")
    scale = rng.random(e).astype(np.float32)
    ar = np.arange(rows_n + 1)

    def on_dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(dev)

    fwd = (on_dev(src, np.int32), on_dev(np.searchsorted(dst, ar), np.int32),
           on_dev(scale, np.float32))
    bwd = (on_dev(dst[t_order], np.int32),
           on_dev(np.searchsorted(src[t_order], ar), np.int32),
           on_dev(scale[t_order], np.float32))
    for d in (64, 128):
        for scaled in (False, True):
            f = fwd if scaled else (*fwd[:2], None)
            bk = bwd if scaled else (*bwd[:2], None)
            x = torch.rand(rows_n, d, device=dev, requires_grad=True)
            g = torch.randn(rows_n, d, device=dev)
            ss.GatherSegmentSum.apply(x, f, bk).backward(g)
            x_ref = x.detach().clone().requires_grad_(True)
            plain(x_ref, *f).backward(g)
            torch.cuda.synchronize()
            name = f"bwd/nonsymmetric/D{d}/{'scaled' if scaled else 'plain'}"
            err = close_scaled(x.grad, x_ref.grad, name)
            max_err = max(max_err, err)
            emit("kernel_bwd_case", case=name, edges=e, max_abs_err=err)
    return rows, max_err


def phase_grad(graph, cfg, edges, dev, plain_layer):
    """One full-size training step's gradients through the kernel and
    through the plain version on the same inputs."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.models import rgcn
    from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as ss
    from primekg_rgcn_tpu_torch.ops.rgcn_segment import rgcn_layer_segment
    from primekg_rgcn_tpu_torch.train import loop

    kern = ss.gather_segment_sum
    n = graph.num_nodes
    params = rgcn.init_params(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    leaves = list(named_leaves(params))
    for _, p in leaves:
        p.requires_grad_(True)
    edges_pad = loop.edges_with_sentinel(edges, dev)
    batch_idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, edges.shape[0], 1024)).to(dev)
    gen = torch.Generator(dev).manual_seed(0)
    cands = loop.sample_candidates(edges_pad, batch_idx, n, 1, generator=gen)
    enc_mask = torch.rand(n, cfg.hidden_dim, generator=gen,
                          device=dev) < 1.0 - cfg.dropout
    runs = {}
    for name, layer_fn in (("kernel", rgcn_layer_segment),
                           ("plain", plain_layer)):
        for _, p in leaves:
            p.grad = None
        start = kern.launches
        loss, _ = loop.loss_from_candidates(
            params, graph, *cands, cfg, train=True, enc_mask=enc_mask,
            layer_fn=layer_fn)
        fwd = kern.launches - start
        loss.backward()
        torch.cuda.synchronize()
        runs[name] = (loss.item(), [p.grad.clone() for _, p in leaves], fwd,
                      kern.launches - start - fwd)
    if runs["kernel"][2:] != (6, 6) or runs["plain"][2:] != (0, 0):
        raise AssertionError(
            f"launches (forward, backward): kernel {runs['kernel'][2:]}, "
            f"plain {runs['plain'][2:]}; expected (6, 6) and (0, 0)")
    if not np.isfinite(runs["kernel"][0]):
        raise AssertionError("non-finite loss")
    np.testing.assert_allclose(runs["kernel"][0], runs["plain"][0], rtol=1e-4)
    per_leaf, max_err = {}, 0.0
    for (name, _), got, want in zip(leaves, runs["kernel"][1], runs["plain"][1]):
        err = close_scaled(got, want, f"grad/{name}")
        max_err = max(max_err, err)
        per_leaf[name] = {"max_abs_err": err,
                          "max_abs": float(want.abs().max())}
    emit("grad", loss_kernel=runs["kernel"][0], loss_plain=runs["plain"][0],
         launches_fwd=runs["kernel"][2], launches_bwd=runs["kernel"][3],
         leaves=per_leaf)
    return max_err


def phase_train(graph, cfg, edges, dev, tmp, steps=50):
    """The bench.py step on the port: timing, launches, memory, profile."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.config import TrainConfig
    from primekg_rgcn_tpu_torch.models import rgcn
    from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as ss
    from primekg_rgcn_tpu_torch.train import loop
    from primekg_rgcn_tpu_torch.utils.telemetry import (profile_trace,
                                                        trace_breakdown)

    kern = ss.gather_segment_sum
    tcfg = TrainConfig(batch_size=1024)
    params = rgcn.init_params(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    for _, p in named_leaves(params):
        p.requires_grad_(True)
    opt = loop.make_optimizer(tcfg, params)
    edges_pad = loop.edges_with_sentinel(edges, dev)
    gen = torch.Generator(dev).manual_seed(0)
    rng = np.random.default_rng(0)
    b = tcfg.batch_size

    def step(pinned=True):
        # bench.py draws each batch on the host. A copy from pageable memory
        # makes CUDA drain the stream first, so the host could not queue the
        # next step while the device works; a pinned buffer copies without
        # that wait. Both are timed; the pinned one is the step's figure.
        batch = torch.from_numpy(rng.integers(0, graph.num_edges, b))
        if pinned:
            batch = batch.pin_memory().to(dev, non_blocking=True)
        else:
            batch = batch.to(dev)
        return loop.train_step(params, opt, graph, edges_pad, batch.view(1, b),
                               cfg, tcfg, generator=gen)

    def timed(pinned):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            out = step(pinned)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3, out

    first = step()
    for _ in range(2):
        step()
    pageable_ms, _ = timed(pinned=False)
    torch.cuda.reset_peak_memory_stats()
    kern.launches = 0
    step_ms, last = timed(pinned=True)
    launches = kern.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    if launches != 12 * steps:
        raise AssertionError(f"{launches} kernel launches in {steps} steps, "
                             f"expected {12 * steps}")
    first_loss = float(first[0] / first[2])
    last_loss = float(last[0] / last[2])
    if not (np.isfinite(first_loss) and np.isfinite(last_loss)):
        raise AssertionError(f"non-finite loss {first_loss}, {last_loss}")
    emit("train", steps=steps, batch_size=b, train_edges=graph.num_edges,
         train_edges_per_s=b / step_ms * 1e3, step_ms=step_ms,
         step_ms_pageable_batch_copy=pageable_ms,
         launches=launches, launches_per_step=launches / steps,
         peak_memory_mb=peak_mb, first_loss=first_loss, last_loss=last_loss)

    # The profiler slows the host, which widens the device's idle gaps in
    # its own window: `idle_share` is read from that one window and is an
    # upper bound for an un-profiled run. `idle_share_two_windows` sets the
    # profiled window's device-busy time per step against the step time
    # measured above without the profiler, two windows; busy time per step
    # does not depend on the host, so it is the estimate for the un-profiled
    # step.
    prof_steps = 10
    torch.cuda.synchronize()
    with profile_trace(tmp / "profile"):
        t0 = time.perf_counter()
        for _ in range(prof_steps):
            step()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) / prof_steps * 1e3
    breakdown = trace_breakdown(tmp / "profile" / "trace.json")
    if breakdown is None:
        emit("train_profile", steps=prof_steps, device_events=0,
             idle_share="not measured")
    else:
        busy_ms = breakdown["busy_us"] / prof_steps / 1e3
        emit("train_profile", steps=prof_steps, step_ms_under_profiler=prof_ms,
             device_busy_ms_per_step=busy_ms,
             idle_share_two_windows=1.0 - busy_ms / step_ms, **breakdown)
    return launches


def phase_train_cli(tmp):
    """train.cli.main on the synthetic graph at scale 0.1, full width, then
    predict_cli.main from the model it wrote."""
    import numpy as np

    from primekg_rgcn_tpu_torch.evaluate import predict_cli
    from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as ss
    from primekg_rgcn_tpu_torch.train import cli as train_cli

    kern = ss.gather_segment_sum
    out = tmp / "train_cli"
    kern.launches = 0
    t0 = time.perf_counter()
    result = train_cli.main([
        "--synthetic", "--synthetic_scale", "0.1", "--epochs", "2",
        "--seed", "0", "--device", "cuda", "--output_dir", str(out)])
    seconds = time.perf_counter() - t0
    launches = kern.launches
    events = [json.loads(ln) for ln in
              (out / "metrics.jsonl").read_text().splitlines()]
    hist = result["history"]
    problems = []
    if [e["event"] for e in events] != ["epoch", "epoch"]:
        problems.append(f"metrics.jsonl events {[e['event'] for e in events]}")
    for f in ("best_model.pt", "final_model.pt"):
        if not (out / "models" / f).exists():
            problems.append(f"missing models/{f}")
    if not all(np.isfinite(hist["val_losses"])):
        problems.append(f"val losses {hist['val_losses']}")
    if not hist["train_losses"][1] < hist["train_losses"][0]:
        problems.append(f"train loss did not fall: {hist['train_losses']}")
    if launches == 0:
        problems.append("no kernel launch")
    served = predict_cli.main([
        "--model_path", str(out / "models" / "final_model.pt"),
        "--data_dir", str(out / "synthetic_data"), "--heads", "0", "7",
        "--relation", "0", "--topk", "5", "--device", "cuda"])
    scores = [p["score"] for q in served for p in q["predictions"]]
    if len(scores) != 10 or not np.all(np.isfinite(scores)):
        problems.append(f"served scores {scores}")
    if problems:
        raise AssertionError("train_cli: " + "; ".join(problems))
    emit("train_cli", seconds=seconds, launches=launches,
         history=hist, epoch_time_s=[e["epoch_time_s"] for e in events],
         edges_per_s=[e["edges_per_s"] for e in events],
         peak_bytes=[e.get("mem_peak_bytes_in_use") for e in events],
         served_top=[[p["tail_id"] for p in q["predictions"]] for q in served])
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is "
              "False", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    import functools

    import numpy as np

    from primekg_rgcn_tpu_torch.config import ModelConfig
    from primekg_rgcn_tpu_torch.data import artifacts, synthetic
    from primekg_rgcn_tpu_torch.evaluate import predict_cli
    from primekg_rgcn_tpu_torch.models import rgcn
    from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as ss
    from primekg_rgcn_tpu_torch.ops.distmult import distmult_score_all_tails
    from primekg_rgcn_tpu_torch.ops.rgcn_segment import (aggregate_plain,
                                                         build_layer_agg_ops,
                                                         rgcn_layer_segment)
    from primekg_rgcn_tpu_torch.train import checkpoint, torch_interop

    # float32 products in full float32 (both are PyTorch's defaults for
    # matmul; convolutions are not used).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kern, plain = ss.gather_segment_sum, ss.gather_segment_sum_plain

    # -- 1. env -------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
        f"nvidia-smi failed: {smi.stderr.strip()}")
    print(card, flush=True)
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, compiler_out = ss.build(verbose=True)
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         library=str(lib_path.relative_to(repo)),
         ptxas=[ln.strip() for ln in compiler_out.splitlines()
                if "registers" in ln or "spill" in ln])

    # -- 3. kernel vs plain on the card --------------------------------------
    raw = synthetic.primekg_like(seed=0, scale=1.0)
    src_u, dst_u, rel_u = synthetic.bidirect(raw["src"], raw["dst"],
                                             raw["rel"])
    split = {"edge_index": np.stack([src_u, dst_u]), "edge_type": rel_u,
             "num_nodes": raw["num_nodes"], "num_relations": 3}
    graph = artifacts.split_to_rel_graph(split)
    n = graph.num_nodes
    if (n, graph.padded_num_edges) != (30926, 1709568):
        raise AssertionError(
            f"unexpected graph size {n}, {graph.padded_num_edges}")
    graph = graph.to(dev)
    cfg = ModelConfig(num_nodes=n, num_relations=3)
    params = rgcn.init_params(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    plain_layer = functools.partial(rgcn_layer_segment,
                                    agg_fn=aggregate_plain)
    enc = params["encoder"]
    with torch.no_grad():
        h1 = torch.relu(plain_layer(enc["conv1"], enc["node_emb"], graph))
    pad = lambda t: torch.cat([t, t.new_zeros(1, t.shape[1])]).contiguous()
    layer_inputs = [(1, pad(enc["node_emb"])), (2, pad(h1))]
    ops = build_layer_agg_ops(graph)

    max_err = 0.0
    main_rows = []

    def check(name, x, src, rowptr, scale=None):
        nonlocal max_err
        with torch.no_grad():
            got = kern(x, src, rowptr, scale)
            want = plain(x, src, rowptr, scale)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL, msg=lambda m: f"{name}: {m}")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        max_err = max(max_err, err)
        return err

    for layer, x in layer_inputs:
        for r, op in enumerate(ops):
            s = op.rowptr.numel() - 1
            name = f"layer{layer}/bucket{r}"
            err = check(name, x, op.src, op.rowptr)
            csr = library_csr(x, op.src, op.rowptr, None)
            with torch.no_grad():
                torch.testing.assert_close(csr @ x, plain(x, op.src, op.rowptr),
                                           **TOL)
                k_ms = cuda_ms(lambda: ss.launch(x, op.src, op.rowptr))
                w_ms = cuda_ms(lambda: kern(x, op.src, op.rowptr))
                p_ms = cuda_ms(lambda: plain(x, op.src, op.rowptr))
                l_ms = cuda_ms(lambda: csr @ x)
            b = bound(x, op.src, op.rowptr, None, s)
            deg = torch.diff(op.rowptr[:n + 1])
            # The hub row alone: one warp walks all of its in-edges.
            hub = int(deg.argmax())
            hub_rowptr = torch.zeros_like(op.rowptr)
            hub_rowptr[hub + 1:] = int(deg[hub])
            hub_src = op.src[int(op.rowptr[hub]):int(op.rowptr[hub + 1])].contiguous()
            with torch.no_grad():
                hub_ms = cuda_ms(lambda: ss.launch(x, hub_src, hub_rowptr))
            row = dict(shape=name, edges=op.src.numel(), d=x.shape[1],
                       max_in_degree=int(deg.max()), hub_row_only_ms=hub_ms,
                       nonempty_rows=int((deg > 0).sum()),
                       kernel_ms=k_ms, wrapper_ms=w_ms, plain_ms=p_ms,
                       library_ms=l_ms,
                       bound_us=max(b["byte_ms"], b["op_ms"]) * 1e3,
                       bound_by="bytes" if b["byte_ms"] >= b["op_ms"] else "operations",
                       byte_us=b["byte_ms"] * 1e3, op_us=b["op_ms"] * 1e3,
                       bytes=b["bytes"],
                       gathered_bytes=op.src.numel() * x.shape[1] * 4,
                       max_abs_err=err)
            main_rows.append(row)
            emit("kernel_main_path", **row)

    rng = np.random.default_rng(0)
    cases = []
    # Edge-norm mode at the gene-gene shape: per-edge 1/in-degree scales.
    op = ops[2]
    deg = torch.diff(op.rowptr).float()
    dst_e = torch.repeat_interleave(torch.arange(n + 1, device=dev),
                                    torch.diff(op.rowptr).long(),
                                    output_size=op.src.numel())
    scale = torch.where(dst_e < n, 1.0 / deg.clamp(min=1)[dst_e],
                        torch.zeros((), device=dev)).contiguous()
    cases.append(("edge_norm/bucket2/D128", layer_inputs[1][1], op.src,
                  op.rowptr, scale))

    def csr_case(rows, s, dst, d, scaled, offset=0):
        # Positive inputs keep rounding relative to the result: a sum that
        # cancels to near zero would make any absolute tolerance arbitrary.
        flat = torch.rand(rows * d + offset, device=dev,
                          generator=torch.Generator(dev).manual_seed(d))
        x = flat[offset:].view(rows, d)
        src = torch.from_numpy(
            rng.integers(0, rows, dst.shape[0]).astype(np.int32)).to(dev)
        rowptr = torch.from_numpy(np.searchsorted(
            dst, np.arange(s + 1)).astype(np.int32)).to(dev)
        sc = (torch.from_numpy(rng.random(dst.shape[0], dtype=np.float32)).to(dev)
              if scaled else None)
        return x, src, rowptr, sc

    for d in (1, 3, 8, 64, 96, 128, 256):
        for scaled in (False, True):
            dst = np.sort(rng.integers(0, 5000, 40000))
            cases.append((f"random/D{d}/{'scaled' if scaled else 'plain'}",
                          *csr_case(4000, 5000, dst, d, scaled)))
    cases.append(("empty_csr/D64", *csr_case(100, 50, np.zeros(0, np.int64), 64, False)))
    cases.append(("no_rows/D64", *csr_case(100, 0, np.zeros(0, np.int64), 64, False)))
    cases.append(("giant_run/D128", *csr_case(
        3000, 200, np.full(20000, 123), 128, False)))
    cases.append(("distinct_rows/D128", *csr_case(
        3000, 3 * 4096, np.arange(4096) * 3, 128, True)))
    cases.append(("unaligned_table/D128", *csr_case(
        4000, 5000, np.sort(rng.integers(0, 5000, 40000)), 128, False,
        offset=1)))
    for name, x, src, rowptr, sc in cases:
        err = check(name, x, src, rowptr, sc)
        emit("kernel_case", case=name, edges=src.numel(), d=x.shape[1],
             rows=rowptr.numel() - 1, max_abs_err=err,
             vec=ss._vec_width(x.shape[1], x))

    # Malformed inputs fault loudly on the card. A device-side assert ends
    # the CUDA context, so each case runs in a child process of its own.
    bad_cases = {
        "rowptr_not_from_0": "rowptr = torch.tensor([1, 2, 3], **i32)",
        "rowptr_not_to_E": "rowptr = torch.tensor([0, 1, 2], **i32)",
        "src_outside_x": "rowptr = torch.tensor([0, 1, 3], **i32); "
                         "src[2] = 5",
    }
    children = {name: subprocess.Popen(
        [sys.executable, "-c", BAD_INPUT_CHILD.format(case=body)], cwd=repo,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, body in bad_cases.items()}
    for name, child in children.items():
        out, _ = child.communicate(timeout=300)
        if child.returncode == 0 or "device-side assert" not in out:
            raise AssertionError(
                f"bad input {name} did not stop on the device-side assert "
                f"(exit {child.returncode}):\n{out[-2000:]}")
        emit("kernel_bad_input", case=name, exit_code=child.returncode,
             faulted=True)

    # -- 4. serve -----------------------------------------------------------
    tr = raw["type_ranges"]
    heads = [tr["disease"][0], tr["disease"][0] + 100, tr["drug"][0],
             tr["drug"][0] + 500, tr["drug"][0] + 3000,
             tr["gene/protein"][0], tr["gene/protein"][0] + 1000,
             tr["gene/protein"][0] + 15000]
    topk = 10
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        artifacts.save_split_npz(tmp / "full_graph.npz", split)
        artifacts.save_mappings(tmp / "mappings.json",
                                synthetic.synthetic_mappings(raw))
        torch_interop.save_reference_pt(params, cfg, tmp / "model.pt")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kern.launches = 0
        served, cli_s = [], []
        for r in range(3):
            before = kern.launches
            t0 = time.perf_counter()
            served.append(predict_cli.main([
                "--model_path", str(tmp / "model.pt"), "--data_dir", str(tmp),
                "--heads", *map(str, heads), "--relation", str(r),
                "--topk", str(topk), "--device", "cuda"]))
            cli_s.append(time.perf_counter() - t0)
            if kern.launches - before != 6:
                raise AssertionError(
                    f"relation {r}: {kern.launches - before} kernel launches "
                    "in one encode, expected 6")
        launches = kern.launches
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20

        # The same queries through the plain version on the card.
        payload = checkpoint.load(tmp / "model.pt", device=dev)
        p_params = payload["params"]
        p_graph = artifacts.split_to_rel_graph(
            artifacts.load_dataset(tmp, require_train=False)["full"]).to(dev)
    q_heads = torch.tensor(heads, device=dev)
    score_err = top_score = 0.0
    for r in range(3):
        rels = torch.full((len(heads),), r, device=dev)
        with torch.no_grad():
            ref = rgcn.predict_all_tails(p_params, p_graph, q_heads, rels, cfg,
                                         layer_fn=plain_layer)
            ref_s, ref_i = torch.topk(ref, topk + 1, dim=1)
        ref_s, ref_i = ref_s.cpu().numpy(), ref_i.cpu().numpy()
        top_score = max(top_score, float(np.abs(ref_s).max()))
        for qi, res in enumerate(served[r]):
            got_s = np.array([p["score"] for p in res["predictions"]])
            got_i = np.array([p["tail_id"] for p in res["predictions"]])
            np.testing.assert_allclose(got_s, ref_s[qi, :topk], **TOL)
            # Random weights give scores far below atol, so the ids are held
            # with the absolute part taken relative to the row's top score.
            tol = TOL["rtol"] * (np.abs(ref_s[qi, :topk])
                                 + np.abs(ref_s[qi]).max())
            np.testing.assert_array_less(np.abs(got_s - ref_s[qi, :topk]), tol)
            score_err = max(score_err, float(np.abs(got_s - ref_s[qi, :topk]).max()))
            gaps = np.abs(np.diff(ref_s[qi]))
            tied = np.zeros(topk, bool)
            tied[1:] |= gaps[:topk - 1] <= tol[1:]
            tied |= gaps[:topk] <= tol
            if not np.array_equal(got_i[~tied], ref_i[qi, :topk][~tied]):
                raise AssertionError(
                    f"relation {r} head {heads[qi]}: top-{topk} ids "
                    f"{got_i.tolist()} vs plain {ref_i[qi, :topk].tolist()}")
            if not np.all(np.isfinite(got_s)):
                raise AssertionError("non-finite scores")

    with torch.no_grad():
        encode_ms = host_ms(lambda: rgcn.get_embeddings(p_params, p_graph, cfg))
        plain_encode_ms = host_ms(lambda: rgcn.get_embeddings(
            p_params, p_graph, cfg, layer_fn=plain_layer), reps=5)
        emb = rgcn.get_embeddings(p_params, p_graph, cfg)
        rels = torch.zeros(len(heads), dtype=torch.long, device=dev)
        rel_emb = p_params["decoder"]["rel_emb"]
        query_ms = cuda_ms(lambda: torch.topk(distmult_score_all_tails(
            emb[q_heads], rel_emb[rels], emb), topk, dim=1))
    emit("serve", nodes=n, padded_edges=p_graph.padded_num_edges,
         params=rgcn.count_params(p_params), relations_served=3,
         queries_per_call=len(heads), topk=topk, launches=launches,
         launches_per_encode=launches / 3, max_score_err=score_err,
         max_abs_top_score=top_score,
         cli_seconds=cli_s, encode_ms=encode_ms,
         plain_encode_ms=plain_encode_ms, query_ms=query_ms,
         peak_memory_mb=peak_mb)

    # -- 5-8. training ------------------------------------------------------
    bwd_rows, bwd_err = phase_kernel_bwd(graph, dev)
    edges = np.stack([src_u, dst_u, rel_u], 1)
    grad_err = phase_grad(graph, cfg, edges, dev, plain_layer)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        train_launches = phase_train(graph, cfg, edges, dev, Path(tmp))
        cli_launches = phase_train_cli(Path(tmp))

    # -- 9. summary ---------------------------------------------------------
    def total(rows, key):
        return sum(r[key] for r in rows)

    def bound_by(rows):
        return ("bytes" if total(rows, "byte_us") >= total(rows, "op_us")
                else "operations")

    print(json.dumps({"kernels": [{
        "name": "gather_segment_sum", "id": "B1", "route": "cuda",
        "source": "primekg_rgcn_tpu_torch/csrc/gather_segment_sum.cu",
        "replaces": "primekg_rgcn_tpu/ops/pallas/segment_sum.py:291",
        "launches": train_launches,
        "launches_by_path": {"serve": launches, "train": train_launches,
                             "train_cli": cli_launches},
        "launches_per_step": {"forward": 6, "backward": 6},
        "max_abs_err": max(max_err, bwd_err, grad_err),
        "ms": total(main_rows, "kernel_ms"),
        "bwd_ms": total(bwd_rows, "kernel_ms"),
        "wrapper_ms": total(main_rows, "wrapper_ms"),
        "plain_ms": total(main_rows, "plain_ms"),
        "bwd_plain_ms": total(bwd_rows, "plain_ms"),
        "bound_ms": total(main_rows, "bound_us") / 1e3,
        "bwd_bound_ms": total(bwd_rows, "bound_us") / 1e3,
        "bound_by": bound_by(main_rows), "bwd_bound_by": bound_by(bwd_rows),
        "library_ms": total(main_rows, "library_ms"),
        "bwd_library_ms": total(bwd_rows, "library_ms"),
        "per": "one training step: ms, plain_ms, bound_ms and library_ms sum "
               "the six forward launches (one encode), the bwd_ keys the six "
               "backward launches over the transpose CSR; launches is the "
               "train phase's count"}]}), flush=True)
    print(card, flush=True)
    # The run uses one card (cuda:0) whatever the machine holds.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
