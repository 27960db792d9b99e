#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing JSON lines (any failure raises and exits non-zero):

1. env: torch and CUDA versions, the card's name and power limit.
2. build: compiles the four kernels under ``primekg_rgcn_tpu_torch/csrc/``
   with nvcc (sm_90a), one process per library, all at once (B1's and B2's
   sources twice each: their float32 and bf16 entries, each with its
   kernel instances).
3. kernel: the kernel against its plain PyTorch version on the card, at the
   six (relation bucket, D) shapes one encode of the full default model
   gives it (with those inputs), in edge-norm mode, at several widths and on
   the edge cases (empty CSR, one giant row, every edge to its own row,
   an unaligned table) and the cases of its edge-balanced partition (a row
   of 200,000 edges, the gene-gene hub row alone, every edge in the last
   row, rows alternating between empty and one edge, pieces on row
   boundaries, fewer edges than one piece), those also over their
   transpose CSR; two launches on the same inputs must be bit-identical.
   Per main-path shape, kernel, plain and cuSPARSE times beside the memory
   bound, and the hub row alone. Every per-kernel time in this script is
   taken by ``time_calls``: the device time of the work one call launches
   (a ``torch.profiler`` trace, median of 25 calls) and, as ``call_ms``, one
   call from an idle stream between two CUDA events, host work included.
   Three child processes hand it a CSR that does not cover ``src`` or a
   ``src`` id outside the table and must stop on the kernel's device-side
   assert; two more do the same to the bf16 variant.
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
   epochs at full width (best and periodic checkpoints through the async
   writer; the best and final ``.pt`` files, loaded back, must hold the
   trainer's parameters and epoch of their save), then ``predict_cli.main``
   from its final model and ``evaluate.cli.main`` on it (eval_cli: AUC-ROC
   and MRR finite).
9. kernel_b2: kernel B2 (``csrc/dense_segment_sum.cu``) against its plain
   version on the two real streams of one block-mode step, recorded from
   the step: the identity backward's (774,400 rows, D = 64, N = 30,926)
   and the outer layer's dedup backward's (135,168 rows, D = 128), and on
   edge cases, among them its row split's (a run of 250,000 rows, runs cut
   at every piece boundary, a leading gap, one real row then sentinels, an
   output of N·D just under 2^31); two launches ``torch.equal`` at each;
   kernel, plain and ``index_add_`` times beside the bound. Children hand
   B2 unsorted ids and B3 a window past its table; both must stop on the
   device-side assert.
10. kernel_b3: kernel B3 (``csrc/window_fetch.cu``) against its plain
   version at the window shapes of a block and a block4 step over the slim
   CSR (their real starts) and at width 64, exactly equal; kernel, plain and
   row-gather times beside the bound.
11. sampled_grad: one full-size block-mode step's loss and gradients
   through B2 and B3 and through their plain versions, over the fat CSR
   (2 B2 launches: identity and dedup backward) and the slim pairs CSR
   (2 B2, 2 B3); the slim loss must equal the fat one.
12. sampled_train: ``build_sampled_train_step`` at fanouts 15/10, 3
   warm-up and 30 timed steps, block over the fat CSR, block over the slim
   CSR and block4 over the slim CSR: step_ms, edges/s, launches per step
   (2 B2), peak memory; a 10-step profile of block over the slim CSR.
13. sampled_cli: ``train.cli.main --sample_fanouts 15 10`` at scale 0.1 in
   block mode, and in block4 mode with ``--sparse_emb --val_sampled``, each
   then served by ``predict_cli.main`` and evaluated by
   ``evaluate.cli.main``; B2 must launch in both.
14. kernel_b4: kernel B4 (``csrc/halo_exchange.cu``) against its plain
   version, bit for bit, at the node-sharded step's shapes (n = 4 shards,
   P = 7,736, D = 64 and 128, the real serve lists of the ``bench.py``
   graph) and on edge cases (n = 2 and 8, P = 1, D = 8, odd D, unaligned
   views); kernel, plain and ``copy_`` times beside the byte bound.
15. node_grad: one node-sharded step (4 shards on the card, dropout off) on
   given candidates through B1, B4 and B2 (2 B1 launches per layer and
   bucket with real edges, 4 B4 launches, 20 B2: the sorted backward of
   every ``_take``), against the same step through the plain versions and
   against the full-graph step's gradients on the same candidates.
16. node_train: ``build_node_sharded_train_step`` with B4, batch 1024,
   adam, dropout 0.5: 3 warm-up and 30 timed steps, launches per step
   asserted, peak memory, a 10-step profile; ``step_twice_equal`` (one
   step run twice from one state: the same bits?), printed, and the same
   with ``_take``'s backward the atomic ``index_add_``.
17. node_serve: ``predict_cli.main --shard node --n_devices 4`` for the
   serve phase's queries; its top-10 ids must equal the dense ones;
   sharded encode and query times.
18. node_cli: ``train.cli.main --shard node --n_devices 4`` at scale 0.1
   for 2 epochs, then served and evaluated with ``--shard node``.
18a. the edge layout (``parallel/edge_shard.py``), 4 shards on the card:
   edge_grad: one step (dropout masks given) through B1 (2 launches per
   layer and (shard, relation) chunk with real edges: 48) against the same
   step through B1's plain version and against the full-graph step on the
   same candidates and masks, at the grad criterion; edge_bf16: the same
   at bf16 (bf16 launches only; grad_bf16's tolerances, and within 5e-2
   in norm of the float32 edge step and the bf16 full-graph step).
   edge_train: 3 warm-up and 30 timed steps, launches asserted, peak
   memory, a 10-step profile, ``step_twice_equal`` asserted. edge_cli:
   ``train.cli.main --shard edge --n_devices 4
   --gradient_accumulation_steps 2`` at scale 0.1 for 2 epochs, then
   ``evaluate.cli.main`` on its best model.
19. eval: ``evaluate.cli.main --filtered --rank_direction both`` at full
   width on the full-size graph with the train CLI's drug-gene hold-out
   (14,658 directed test edges): 6 B1 launches, every results.json key
   finite and in range, TF32 off; the same evaluation through the kernel
   and through the plain version on the card with the same negatives
   (probabilities within rtol 1e-4, ranks equal on every query whose true
   score is more than 1e-5 of the row's largest |score| from every other
   candidate's, classification metrics within 1e-5, every ranking metric
   over those untied queries within 1e-5); encode, score matmul and
   ranking batch timed.
20. node_eval: the same checkpoint with ``--shard node --n_devices 4``: 30
   B1 and 2 B4 launches, ranks and ranking metrics held against the eval
   phase's as above; the sharded encode timed.
21. analysis: ``analyze.run_full_analysis.main --device cuda``, all eight
   analyses, on the eval phase's data and model (two case-study diseases,
   two explanation pairs): all OK, 12 B1 launches (the context's encode and
   the evaluate analysis'), the context's embeddings within TOL of an
   encode through the plain version, every JSON and CSV output parsed with
   its scores in [0, 1]; ``find_paths`` on the case-study and explanation
   pairs equal to the same search without its distance pruning (each at
   most 30 s; at least one must end); k-means + silhouette per node type,
   the silhouette within 1e-5 of a plain ``torch.cdist`` recomputation;
   per-analysis seconds, the encode's device time, t-SNE at 5,000 points,
   k-means + silhouette per type and ``find_paths`` per pair timed.
22. export: ``predict_cli.main --export`` on the same model (6 B1
   launches); the artifact, loaded by ``load_predictor``, serves the serve
   phase's 8 heads for relations 0-2 with scores within TOL of
   ``predict_cli``'s and ids equal on untied entries; its query timed
   beside the serve phase's ``query_ms``.
23-27. BASELINE config 3 (full PrimeKG: ``primekg_full_like(seed=0,
   scale=1.0)`` + ``bidirect``, 129,375 nodes, 30 relations, 4,601,678
   directed edges) and config 4 (it sampled at fanouts 15/10):
   full_kg_graph: the graph built by the C++ builder of ``native/`` and by
   numpy, every array equal, both times and the sizes printed, ``"auto"``
   taking the C++ builder. full_kg_grad: one step, dropout off, given
   candidates, with the batch-restricted final layer (60 B1 launches, 1
   B2: its forward segment-sum) and with the full one (120, no B2),
   losses within 1e-6 relative and gradients
   within the grad criterion; the restricted layer on the card against its
   CPU computation; the same in bf16 (bf16 launches only, grad_bf16's
   tolerances). full_kg_overflow: a plan cut to one group a relation takes
   the fallback, equal to the full step, one fallback and 120 launches.
   full_kg_train: ``restrict_final="auto"`` resolves to a plan (the edge
   ratio printed); the step with it (float32 and bf16) and with "off", 3
   warm-up and 30 timed steps each, launches (1 B2 a restricted step
   that takes the fast path), fallbacks, peak memory and a 10-step
   profile; the restricted and the full final layer alone; B2 on the
   restricted layer's segment-sum stream beside ``index_add_``.
   full_kg_trainer: ``Trainer`` for one epoch (45 steps of 1,024,
   validation, checkpoints; 1 B2 a step), losses finite. full_kg_sampled:
   config 4, the block-mode step over the slim CSR: gradients through B2
   and B3 against their plain versions (``full_kg_sampled_grad``, fat and
   slim CSR), B2 on the step's identity and dedup streams
   (``full_kg_b2_streams``), then 3 warm-up and 30 timed steps with a
   profile.
   The sharded layouts on config 3's graph, 4 shards: the node partition
   (``uniform_caps`` by default at 30 relations, so the layer runs the
   relation scan, ``ScanAccumulate``: 3 B1 launches a bucket in a step)
   and full_kg_node_grad (node_grad's checks); full_kg_node_train, 10
   timed steps, beside the same step with ``uniform_caps=False`` (the
   kept partials, 2 B1 a bucket), whose peak memory the scan exists to
   save (full_kg_node_memory); full_kg_node_serve: the sharded encode
   against the dense one within rtol 2e-4 and its top-10 ids against the
   dense ones; full_kg_edge_grad and full_kg_edge_train (10 timed steps)
   as edge_grad and edge_train.
28. the kernel summary line, then the card line, then the result line.

bf16 compute (``compute_dtype="bfloat16"``, full width) adds, each beside
its float32 counterpart:

- kernel_bf16: after 5, B1's bf16-table variant against its plain version
  at the six forward and six transpose-CSR shapes (the tables rounded to
  bf16), the partition cases bit for bit on their dyadic inputs, edge
  cases (D = 8, odd D, D = 320, unaligned bf16 views, an empty CSR, edge
  scales); kernel, wrapper, plain and library times (cuSPARSE on a bf16
  CSR, or the float32 call on the upcast table, named) beside the bf16
  bound and the float32 kernel's time. After 9, B2's bf16 variant at a bf16
  block step's identity- and dedup-backward streams and edge cases,
  ``index_add_`` of the upcast rows beside it; after 14, B4's at the node step's shapes, bit
  for bit, ``copy_`` beside it. Two children feed B1's bf16 variant a bad
  CSR and one B2's unsorted ids: each must stop on the device-side assert.
- grad_bf16 (after 6): one full-size step in bf16 through the kernels and
  through their plain versions: 6 + 6 bf16 B1 launches and no float32 one,
  every gradient within 1e-2 of its largest magnitude, the losses within
  1e-3, each gradient within 5e-2 of the float32 step's in norm.
- train_bf16 (after 7): 3 warm-up and 50 timed bf16 steps, 12 bf16 B1
  launches a step, and a 10-step profile.
- train_restricted_on (after train_bf16): the train phase with the
  batch-restricted final layer forced on at this graph's edge ratio (3.48;
  "auto" leaves it off), 6 B1 launches a step.
- cli_bf16 (after 8): ``train.cli --compute_dtype bfloat16`` at scale 0.1
  for 2 epochs, then ``predict_cli`` and ``evaluate.cli`` on its final
  model: both report bfloat16, every B1 launch a bf16 one.
- sampled_bf16 (after 12): a block-over-slim step's loss and gradients
  through B2's bf16 variant and B3 against their plain versions (as
  grad_bf16), then 30 timed steps, 2 bf16 B2 and 2 B3 launches a step.
- node_bf16 (after 16): the 4-shard encode against the dense bf16 encode
  within 2e-2, 2 bf16 B4 and 30 bf16 B1 launches; 30 timed steps, 4 bf16
  B4 and 60 bf16 B1 launches a step.

The kernel summary line gives B1, B2 and B4 a ``bf16`` object each.

It needs one CUDA card and exits non-zero without one.
"""

import concurrent.futures
import contextlib
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
TIMES = ("ms, plain_ms and library_ms are device times (time_calls: the "
         "median over 25 calls of the kernel, memcpy and memset time each "
         "call launches, from a torch.profiler trace); call_ms is one call "
         "from an idle stream between two CUDA events, host work included")


# Child process for one malformed input: it must die on the kernel's
# device-side assert and never reach the last line.
BAD_INPUT_CHILD = """
import torch
from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as ss
i32 = dict(dtype=torch.int32, device="cuda")
x = torch.ones(5, 64, device="cuda", dtype={dtype})
src = torch.zeros(3, **i32)
{case}
with torch.no_grad():
    ss.gather_segment_sum(x, src, rowptr)
torch.cuda.synchronize()
print("no fault")
"""


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def event_ms(fn, reps=REPS, warmup=WARMUP):
    """Median time of one call of ``fn`` from an idle stream in ms, one CUDA
    event pair per call: the host's work inside the call falls between the
    two events, so it counts too."""
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


def time_calls(fns, reps=REPS, warmup=WARMUP):
    """Each named call of ``fns`` timed two ways, in ms:

    - ``<name>_ms``, its device time: the median over ``reps`` calls of the
      summed durations of every kernel, memcpy and memset that one call
      launches, read from a ``torch.profiler`` trace
      (``utils/telemetry.device_us_by_range``). A call that launches
      several kernels is charged for all of them, and for no gap between.
      A trace that lost the events of most calls of a name is taken again.
    - ``<name>_call_ms``: ``event_ms``, host work included.
    """
    import torch

    from primekg_rgcn_tpu_torch.utils.telemetry import (device_us_by_range,
                                                        profile_trace)

    out = {f"{name}_call_ms": event_ms(fn, reps, warmup)
           for name, fn in fns.items()}
    # A trace that lost a call's device events is taken again, twice at most.
    pending = dict(fns)
    for _ in range(3):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_timer_") as tmp:
            with profile_trace(tmp):
                for name, fn in pending.items():
                    for i in range(reps):
                        with torch.profiler.record_function(
                                f"timed:{name}#{i}"):
                            fn()
                        torch.cuda.synchronize()
            us = device_us_by_range(Path(tmp) / "trace.json", "timed:")
        for name in list(pending):
            # Every timed call launches device work: a call that reads 0
            # lost its events, and is left out of the median.
            seen = [v for v in (us.get(f"timed:{name}#{i}", 0.0)
                                for i in range(reps)) if v > 0]
            if 2 * len(seen) > reps:
                out[f"{name}_ms"] = statistics.median(seen) / 1e3
                del pending[name]
        if not pending:
            return out
    raise AssertionError(f"timing {sorted(pending)}: the profiler saw no "
                         f"device work in most of {reps} calls, 3 times")


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
    once (a bf16 table at 2 bytes an element) and the float32 output
    written once at the HBM rate, and its 2*E*D float32 operations at the
    float32 peak. The bound is the larger of the two."""
    d = x.shape[1]
    nbytes = (x.numel() * x.element_size()
              + (src.numel() + rowptr.numel() + s * d) * 4)
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


def close_rel(got, want, rel, name):
    """``got`` within ``rel`` of ``want``'s largest magnitude, element by
    element; returns the largest difference over that magnitude."""
    top = max(float(want.abs().max()), 1e-30) if want.numel() else 1.0
    diff = float((got.float() - want.float()).abs().max()) / top \
        if got.numel() else 0.0
    if diff > rel:
        raise AssertionError(f"{name}: differs by {diff:.3g} of the largest "
                             f"magnitude, more than {rel}")
    return diff


def twice_equal(name, x, src, rowptr, scale=None):
    """Two launches of B1 on the same inputs must agree bit for bit."""
    import torch

    from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as ss

    with torch.no_grad():
        first = ss.gather_segment_sum(x, src, rowptr, scale)
        second = ss.gather_segment_sum(x, src, rowptr, scale)
    if not torch.equal(first, second):
        raise AssertionError(f"{name}: two launches on the same inputs "
                             f"differ")


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
            twice_equal(name, g, op.t_ids, op.t_rowptr)
            csr = library_csr(g, op.t_ids, op.t_rowptr, None)
            with torch.no_grad():
                close_scaled(csr @ g, want, f"{name}/cusparse")
                t = time_calls({
                    "kernel": lambda: ss.launch(g, op.t_ids, op.t_rowptr),
                    "plain": lambda: plain(g, op.t_ids, op.t_rowptr),
                    "library": lambda: csr @ g})
            b = bound(g, op.t_ids, op.t_rowptr, None, n + 1)
            deg = torch.diff(op.t_rowptr[:n + 1])
            row = dict(shape=name, edges=op.t_ids.numel(), d=d,
                       max_out_degree=int(deg.max()),
                       nonempty_rows=int((deg > 0).sum()), **t,
                       gathered_bytes=op.t_ids.numel() * d * 4,
                       gather_tb_per_s=op.t_ids.numel() * d * 4
                       / t["kernel_ms"] / 1e9,
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


def b1_bf16_library(x, src, rowptr, scale):
    """The library calls beside B1's bf16 variant, timed as yardsticks only
    (the port never calls them): cuSPARSE's CSR @ dense on a bf16 CSR and
    the bf16 table where ``torch.sparse`` takes them, and the float32 call
    on the upcast table. Returns ({name: call}, {name: result as
    float32}); the bf16 product has a bf16 output and sums in its own
    precision, so it is held to nothing and its error is printed."""
    import torch

    csr32 = library_csr(x.float(), src, rowptr, scale)
    x32 = x.float()
    calls = {"library_f32_upcast": lambda: csr32 @ x32}
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        csr = torch.sparse_csr_tensor(
            csr32.crow_indices(), csr32.col_indices(),
            csr32.values().to(x.dtype), size=csr32.shape,
            check_invariants=False)
    try:
        with torch.no_grad():
            (csr @ x).float()
        torch.cuda.synchronize()
        calls["library"] = lambda: csr @ x
    except RuntimeError:
        calls["library"] = calls["library_f32_upcast"]
    with torch.no_grad():
        out = {k: fn().float() for k, fn in calls.items()}
    return calls, out


def phase_kernel_bf16_b1(graph, dev, layer_inputs, exact, f32_rows,
                         f32_bwd_rows):
    """Kernel B1's bf16-table variant against its plain version on the
    card (rtol 1e-4, atol 1e-4 of the output's largest magnitude: both sum
    the same bf16-exact values in float32): at the six forward shapes of
    one encode (the float32 layer inputs rounded to bf16) and the six
    transpose-CSR shapes of one step's backward, with kernel, wrapper,
    plain and library times beside the bf16 bound and the float32 kernel's
    time; the float32 kernel's partition cases on their dyadic inputs (exact
    in bf16) bit for bit against the float32 plain version; edge cases (D
    = 8, odd D, D = 320 in column chunks, unaligned bf16 views, an empty
    CSR, edge-norm scales); two launches on the same inputs bit-identical.
    Every launch must be a bf16 one. Returns (forward rows, backward rows,
    largest error, library call's name)."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as ss
    from primekg_rgcn_tpu_torch.ops.rgcn_segment import build_layer_agg_ops

    bf16 = torch.bfloat16
    kern, plain = ss.gather_segment_sum, ss.gather_segment_sum_plain
    n = graph.num_nodes
    ops = build_layer_agg_ops(graph)
    max_err, library = 0.0, None

    def check(name, x, src, rowptr, scale=None, exact_to=None):
        nonlocal max_err
        reset_counts()
        with torch.no_grad():
            got = kern(x, src, rowptr, scale)
            want = plain(x, src, rowptr, scale)
        torch.cuda.synchronize()
        if (kern.launches, kern.launches_bf16) != (1, 1):
            raise AssertionError(f"kernel_bf16/{name}: not the bf16 variant")
        if exact_to is not None and not (torch.equal(got, want)
                                         and torch.equal(got, exact_to)):
            raise AssertionError(f"kernel_bf16/{name}: not equal to the "
                                 f"plain versions on exact inputs")
        err = close_scaled(got, want, f"kernel_bf16/{name}")
        twice_equal(f"kernel_bf16/{name}", x, src, rowptr, scale)
        max_err = max(max_err, err)
        return err

    def shape_row(name, x, src, rowptr, f32_row):
        nonlocal library
        err = check(name, x, src, rowptr)
        lib_calls, lib_out = b1_bf16_library(x, src, rowptr, None)
        library = ("cusparse_bf16" if lib_calls["library"] is not
                   lib_calls["library_f32_upcast"]
                   else "cusparse_float32_on_upcast_table")
        with torch.no_grad():
            want = plain(x, src, rowptr)
            lib_err = {f"{k}_rel_err": float((v - want).abs().max()
                                             / want.abs().max())
                       for k, v in lib_out.items()}
            close_scaled(lib_out["library_f32_upcast"], want,
                         f"kernel_bf16/{name}/library_f32_upcast")
            t = time_calls({
                "kernel": lambda: ss.launch(x, src, rowptr),
                "wrapper": lambda: kern(x, src, rowptr),
                "plain": lambda: plain(x, src, rowptr), **lib_calls})
        b = bound(x, src, rowptr, None, rowptr.numel() - 1)
        gathered = src.numel() * x.shape[1] * x.element_size()
        row = dict(shape=name, edges=src.numel(), d=x.shape[1], **t,
                   library=library, **lib_err,
                   f32_kernel_ms=f32_row["kernel_ms"],
                   f32_bound_us=f32_row["bound_us"],
                   gathered_bytes=gathered,
                   gather_tb_per_s=gathered / t["kernel_ms"] / 1e9,
                   vec_lanes=ss.b1_width(x.shape[1], x), **bound_fields(b),
                   max_abs_err=err)
        emit("kernel_bf16_b1_shape", **row)
        return row

    rows, bwd_rows = [], []
    f32_fwd = iter(f32_rows)
    for layer, x32 in layer_inputs:
        x = x32.to(bf16)
        for r, op in enumerate(ops):
            rows.append(shape_row(f"layer{layer}/bucket{r}", x, op.src,
                                  op.rowptr, next(f32_fwd)))
    gen = torch.Generator(dev).manual_seed(1)
    f32_bwd = iter(f32_bwd_rows)
    for d in (64, 128):
        # The backward's table: a layer aggregate's float32 gradient rounded
        # to bf16, its dummy row zero.
        g = torch.randn(n + 1, d, device=dev, generator=gen)
        g[n] = 0.0
        g = g.to(bf16)
        for r, op in enumerate(ops):
            bwd_rows.append(shape_row(f"bwd/D{d}/bucket{r}", g, op.t_ids,
                                      op.t_rowptr, next(f32_bwd)))

    # The partition cases on dyadic inputs: exact in bf16 too, so the bf16
    # variant must equal the float32 plain version bit for bit.
    for name, x32, src, rowptr, sc in exact:
        with torch.no_grad():
            want32 = plain(x32, src, rowptr, sc)
        err = check(f"exact/{name}", x32.to(bf16), src, rowptr, sc,
                    exact_to=want32)
        emit("kernel_bf16_b1_case", case=f"exact/{name}", edges=src.numel(),
             d=x32.shape[1], max_abs_err=err, exact=True)

    rng = np.random.default_rng(8)

    def case(rows_n, s, dst, d, scaled, offset=0):
        flat = torch.rand(rows_n * d + offset, device=dev,
                          generator=gen).to(bf16)
        x = flat[offset:].view(rows_n, d)
        src = torch.from_numpy(
            rng.integers(0, rows_n, dst.shape[0]).astype(np.int32)).to(dev)
        rowptr = torch.from_numpy(np.searchsorted(
            dst, np.arange(s + 1)).astype(np.int32)).to(dev)
        sc = (torch.rand(dst.shape[0], device=dev, generator=gen)
              if scaled else None)
        return x, src, rowptr, sc

    def random_dst():
        return np.sort(rng.integers(0, 5000, 40000))

    cases = {f"random/D{d}/{'scaled' if sc else 'plain'}":
             case(4000, 5000, random_dst(), d, sc)
             for d in (8, 3, 37, 64, 128, 320) for sc in (False, True)}
    cases["unaligned_view_2_bytes/D128"] = case(4000, 5000, random_dst(), 128,
                                                False, offset=1)
    cases["unaligned_view_4_bytes/D64"] = case(4000, 5000, random_dst(), 64,
                                               True, offset=2)
    cases["empty_csr/D64"] = case(100, 50, np.zeros(0, np.int64), 64, False)
    cases["giant_run/D128"] = case(3000, 200, np.full(20000, 123), 128, False)
    # Edge-norm mode at the gene-gene shape: per-edge 1/in-degree scales.
    op = ops[2]
    deg = torch.diff(op.rowptr).float()
    dst_e = torch.repeat_interleave(torch.arange(n + 1, device=dev),
                                    torch.diff(op.rowptr).long(),
                                    output_size=op.src.numel())
    scale = torch.where(dst_e < n, 1.0 / deg.clamp(min=1)[dst_e],
                        torch.zeros((), device=dev)).contiguous()
    cases["edge_norm/bucket2/D128"] = (layer_inputs[1][1].to(bf16), op.src,
                                       op.rowptr, scale)
    for name, (x, src, rowptr, sc) in cases.items():
        err = check(name, x, src, rowptr, sc)
        emit("kernel_bf16_b1_case", case=name, edges=src.numel(),
             d=x.shape[1], rows=rowptr.numel() - 1, max_abs_err=err,
             vec_lanes=ss.b1_width(x.shape[1], x))
    return rows, bwd_rows, max_err, library


@contextlib.contextmanager
def b1_plain():
    """While open, ``ss.gather_segment_sum`` (which ``GatherSegmentSum``
    calls both ways) runs B1's plain version on the card instead of the
    kernel, with the Function's casts unchanged."""
    from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as ss

    saved = ss.gather_segment_sum
    ss.gather_segment_sum = ss.gather_segment_sum_plain
    try:
        yield
    finally:
        ss.gather_segment_sum = saved


def phase_grad(graph, cfg, edges, dev, plain_layer, f32_run=None):
    """One full-size training step's gradients through the kernel and
    through the plain version on the same inputs.

    At ``cfg.compute_dtype`` bf16 (phase ``grad_bf16``) every B1 launch must
    be a bf16 one, and the plain run swaps B1 for its plain version inside
    ``GatherSegmentSum`` (``b1_plain``), so both runs round the same bf16
    cotangents; the gradients agree within 1e-2 of each tensor's largest
    magnitude (a bf16 gradient is a float32 sum rounded to bf16, and the
    kernel and ``index_add_`` sum in other orders, so a value near a
    rounding boundary rounds to a neighbour), the losses within 1e-3, and
    each gradient within 5e-2 of ``f32_run``'s, the float32 step on the
    same inputs, in norm (||bf16 - f32|| / ||f32||): a check that it is the
    same function. Element by element the two differ by more (the JAX
    package's own bf16 and f32 layer-1 gradients by 5-8 % of their largest
    magnitude on a small graph at random weights, where the tiny gradients
    are sums that cancel); that figure is printed, not held. Returns
    (largest error, the kernel run: loss and grads)."""
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
    bf16 = cfg.compute_dtype == "bfloat16"
    label = "grad_bf16" if bf16 else "grad"
    runs = {}
    for name, layer_fn, scope in (
            ("kernel", rgcn_layer_segment, contextlib.nullcontext()),
            ("plain", rgcn_layer_segment, b1_plain()) if bf16 else
            ("plain", plain_layer, contextlib.nullcontext())):
        for _, p in leaves:
            p.grad = None
        reset_counts()
        with scope:
            loss, _ = loop.loss_from_candidates(
                params, graph, *cands, cfg, train=True, enc_mask=enc_mask,
                layer_fn=layer_fn)
            fwd = (kern.launches, kern.launches_bf16)
            loss.backward()
        torch.cuda.synchronize()
        runs[name] = (loss.item(), [p.grad.clone() for _, p in leaves],
                      fwd[0], kern.launches - fwd[0],
                      fwd[1], kern.launches_bf16 - fwd[1])
    want_launches = (6, 6, 6, 6) if bf16 else (6, 6, 0, 0)
    if runs["kernel"][2:] != want_launches or \
            runs["plain"][2:] != (0, 0, 0, 0):
        raise AssertionError(
            f"{label} launches (forward, backward, bf16 forward, bf16 "
            f"backward): kernel {runs['kernel'][2:]}, plain "
            f"{runs['plain'][2:]}; expected {want_launches} and none")
    if not np.isfinite(runs["kernel"][0]):
        raise AssertionError("non-finite loss")
    np.testing.assert_allclose(runs["kernel"][0], runs["plain"][0],
                               rtol=1e-3 if bf16 else 1e-4)
    per_leaf, max_err, vs_f32 = {}, 0.0, {}
    for i, ((name, _), got, want) in enumerate(
            zip(leaves, runs["kernel"][1], runs["plain"][1])):
        if bf16:
            err = close_rel(got, want, 1e-2, f"{label}/{name}") * float(
                want.abs().max())
            ref = f32_run["grads"][i]
            norm_rel = float((got - ref).norm() / ref.norm().clamp(min=1e-30))
            if norm_rel > 5e-2:
                raise AssertionError(f"{label}/{name}: differs from the "
                                     f"float32 gradient by {norm_rel:.3g} in "
                                     f"norm, more than 5e-2")
            vs_f32[name] = {"norm_rel": norm_rel, "max_rel": float(
                (got - ref).abs().max() / ref.abs().max().clamp(min=1e-30))}
        else:
            err = close_scaled(got, want, f"grad/{name}")
        max_err = max(max_err, err)
        per_leaf[name] = {"max_abs_err": err,
                          "max_abs": float(want.abs().max())}
    extra = {}
    if bf16:
        extra = dict(loss_float32=f32_run["loss"],
                     max_rel_err=max(v["max_abs_err"] / v["max_abs"]
                                     for v in per_leaf.values()),
                     vs_float32=vs_f32,
                     launches_bf16_fwd=runs["kernel"][4],
                     launches_bf16_bwd=runs["kernel"][5])
    emit(label, loss_kernel=runs["kernel"][0], loss_plain=runs["plain"][0],
         launches_fwd=runs["kernel"][2], launches_bwd=runs["kernel"][3],
         leaves=per_leaf, **extra)
    return max_err, {"loss": runs["kernel"][0], "grads": runs["kernel"][1]}


def phase_train(graph, cfg, edges, dev, tmp, steps=50, label=None,
                final_plan=None, launches_per_step=12):
    """The bench.py step on the port: timing, launches, memory, profile.
    At ``cfg.compute_dtype`` bf16 (phase ``train_bf16``) every B1 launch
    must be a bf16 one. With ``final_plan`` the step runs the
    batch-restricted final layer (phase ``full_kg_train``), and the
    fallbacks over the timed steps are counted; each step that takes the
    layer's fast path makes one B2 launch, on float32 grouped sums at
    either dtype, and a fallback none. Returns the launches and the
    profile's breakdown, and the step's figures."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.config import TrainConfig
    from primekg_rgcn_tpu_torch.models import rgcn
    from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as ss
    from primekg_rgcn_tpu_torch.ops.rgcn_final_layer import \
        final_layer_restricted
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
                               cfg, tcfg, generator=gen,
                               final_plan=final_plan)

    def timed(pinned):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            out = step(pinned)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3, out

    bf16 = cfg.compute_dtype == "bfloat16"
    label = label or ("train_bf16" if bf16 else "train")
    first = step()
    for _ in range(2):
        step()
    pageable_ms, _ = timed(pinned=False)
    torch.cuda.reset_peak_memory_stats()
    fallbacks = final_layer_restricted.fallbacks
    reset_counts()
    step_ms, last = timed(pinned=True)
    launches = kern.launches
    counts, counts_bf16 = read_counts(), read_bf16_counts()
    fallbacks = final_layer_restricted.fallbacks - fallbacks
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    # A restricted step that overflowed its plan runs the full final layer:
    # two more B1 launches a relation.
    want = launches_per_step * steps + 2 * graph.num_relations * fallbacks
    if launches != want:
        raise AssertionError(f"{launches} kernel launches in {steps} steps "
                             f"({fallbacks} fallbacks), expected {want}")
    want_b2 = (steps - fallbacks) if final_plan is not None else 0
    if (counts["B2"], counts_bf16["B2"]) != (want_b2, 0):
        raise AssertionError(f"{label}: B2 launches {counts['B2']} (bf16 "
                             f"{counts_bf16['B2']}), expected {want_b2} "
                             f"float32 ones")
    if bf16 and counts["B1"] != counts_bf16["B1"]:
        raise AssertionError(f"{label}: B1 launches {counts['B1']}, bf16 "
                             f"ones {counts_bf16['B1']}")
    first_loss = float(first[0] / first[2])
    last_loss = float(last[0] / last[2])
    if not (np.isfinite(first_loss) and np.isfinite(last_loss)):
        raise AssertionError(f"non-finite loss {first_loss}, {last_loss}")
    figures = dict(step_ms=step_ms, train_edges_per_s=b / step_ms * 1e3,
                   launches=launches, launches_per_step=launches / steps,
                   b2_launches=counts["B2"], fallbacks=fallbacks,
                   peak_memory_mb=peak_mb)
    emit(label, steps=steps, batch_size=b, train_edges=graph.num_edges,
         step_ms_pageable_batch_copy=pageable_ms, first_loss=first_loss,
         last_loss=last_loss, restricted_final_layer=final_plan is not None,
         **figures)

    # The profiler slows the host, which widens the device's idle gaps in
    # its own window: `idle_share` is read from that one window and is an
    # upper bound for an un-profiled run. `idle_share_two_windows` sets the
    # profiled window's device-busy time per step against the step time
    # measured above without the profiler, two windows; busy time per step
    # does not depend on the host, so it is the estimate for the un-profiled
    # step.
    prof_steps = 10
    torch.cuda.synchronize()
    with profile_trace(tmp / f"{label}_profile"):
        t0 = time.perf_counter()
        for _ in range(prof_steps):
            step()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) / prof_steps * 1e3
    breakdown = trace_breakdown(tmp / f"{label}_profile" / "trace.json")
    if breakdown is None:
        emit(f"{label}_profile", steps=prof_steps, device_events=0,
             idle_share="not measured")
    else:
        busy_ms = breakdown["busy_us"] / prof_steps / 1e3
        breakdown = dict(device_busy_ms_per_step=busy_ms,
                         idle_share_two_windows=1.0 - busy_ms / step_ms,
                         **breakdown)
        emit(f"{label}_profile", steps=prof_steps,
             step_ms_under_profiler=prof_ms, **breakdown)
    return launches, breakdown, figures


@contextlib.contextmanager
def trainer_states():
    """While open, every ``Trainer.save_checkpoint`` call records the
    trainer's parameters (host copies) and epoch under the file it writes,
    and whether it went through the async writer; yields that record."""
    from primekg_rgcn_tpu_torch.train import checkpoint
    from primekg_rgcn_tpu_torch.train import loop

    states = {"async": []}
    save_checkpoint = loop.Trainer.save_checkpoint
    save_async = checkpoint.AsyncSaver.save_async

    def recording(self, *, is_best=False, is_final=False):
        name = ("final_model.pt" if is_final else
                "best_model.pt" if is_best else
                f"checkpoint_epoch_{self.epoch}.pt")
        states[name] = (self.epoch, {k: v.detach().cpu().clone() for k, v
                                     in named_leaves(self.params)})
        return save_checkpoint(self, is_best=is_best, is_final=is_final)

    def async_recording(self, path, payload):
        states["async"].append(Path(path).name)
        return save_async(self, path, payload)

    loop.Trainer.save_checkpoint = recording
    checkpoint.AsyncSaver.save_async = async_recording
    try:
        yield states
    finally:
        loop.Trainer.save_checkpoint = save_checkpoint
        checkpoint.AsyncSaver.save_async = save_async


def check_checkpoints(out, states):
    """The best and final ``.pt`` files, loaded back, hold the trainer's
    parameters and epoch of their last save; the best went through
    ``AsyncSaver``, the final did not."""
    import torch

    from primekg_rgcn_tpu_torch.train import checkpoint

    problems = []
    for name in ("best_model.pt", "final_model.pt"):
        if name not in states:
            problems.append(f"{name} was never saved")
            continue
        epoch, want = states[name]
        got = checkpoint.load(out / "models" / name)
        leaves = dict(named_leaves(got["params"]))
        if got["epoch"] != epoch or sorted(leaves) != sorted(want) or not all(
                torch.equal(leaves[k], want[k]) for k in want):
            problems.append(f"{name} differs from the trainer's state at "
                            f"epoch {epoch}")
    if "best_model.pt" not in states["async"] or \
            "final_model.pt" in states["async"]:
        problems.append(f"async writes {states['async']}")
    return problems


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
    with trainer_states() as states:
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
    problems += check_checkpoints(out, states)
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
         served_top=[[p["tail_id"] for p in q["predictions"]] for q in served],
         async_writes=states["async"])
    return launches


SAMPLED_BAD_INPUT_CHILD = """
import torch
from primekg_rgcn_tpu_torch.ops.cuda import dense_segment_sum as pds
from primekg_rgcn_tpu_torch.ops.cuda import window_fetch as pwf
i32 = dict(dtype=torch.int32, device="cuda")
{case}
torch.cuda.synchronize()
print("no fault")
"""

SAMPLED_BAD_CASES = {
    # B2: ids that decrease between neighbours.
    "b2_unsorted_ids": "pds.dense_sorted_segment_sum(torch.ones(600, 64, "
                       "device='cuda'), torch.arange(600, **i32).flip(0)"
                       ".contiguous(), 1000)",
    # B3: a window that runs past the record table.
    "b3_start_past_table": "pwf.window_rows_fetch(torch.zeros(256, 2, **i32),"
                           " torch.tensor([0, 250], **i32), 8)",
    # B2's bf16 variant: the same unsorted ids.
    "b2_bf16_unsorted_ids": "pds.dense_sorted_segment_sum(torch.ones(600, "
                            "64, device='cuda', dtype=torch.bfloat16), "
                            "torch.arange(600, **i32).flip(0).contiguous(), "
                            "1000)",
}


@contextlib.contextmanager
def sampler_kernels(mode):
    """Swap what the sampler (``data/sampling``) calls for kernels B2 and
    B3: ``"plain"`` runs their plain versions on the card, for comparison;
    ``("record", calls)`` records each call's inputs in ``calls`` and then
    launches the kernel."""
    from primekg_rgcn_tpu_torch.data import sampling
    from primekg_rgcn_tpu_torch.ops.cuda import dense_segment_sum as pds
    from primekg_rgcn_tpu_torch.ops.cuda import window_fetch as pwf

    saved = sampling.dense_sorted_segment_sum, sampling.window_rows_fetch
    if mode == "plain":
        sampling.dense_sorted_segment_sum = pds.dense_sorted_segment_sum_plain
        sampling.window_rows_fetch = pwf.window_rows_fetch_plain
    else:
        calls = mode[1]

        def b2(*args):
            calls.setdefault("b2", []).append(args)
            return saved[0](*args)

        def b3(*args):
            calls.setdefault("b3", []).append(args)
            return saved[1](*args)

        sampling.dense_sorted_segment_sum, sampling.window_rows_fetch = b2, b3
    try:
        yield
    finally:
        sampling.dense_sorted_segment_sum, sampling.window_rows_fetch = saved


def fresh_params(params):
    """A copy of the parameter dict whose leaves require a gradient."""
    if isinstance(params, dict):
        return {k: fresh_params(v) for k, v in params.items()}
    return params.detach().clone().requires_grad_(True)


def reset_counts():
    from primekg_rgcn_tpu_torch.ops.cuda import dense_segment_sum as pds
    from primekg_rgcn_tpu_torch.ops.cuda import halo
    from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as ss
    from primekg_rgcn_tpu_torch.ops.cuda import window_fetch as pwf

    for fn in (ss.gather_segment_sum, pds.dense_sorted_segment_sum,
               halo.halo_exchange):
        fn.launches = fn.launches_bf16 = 0
    pwf.window_rows_fetch.launches = 0


def read_counts():
    from primekg_rgcn_tpu_torch.ops.cuda import dense_segment_sum as pds
    from primekg_rgcn_tpu_torch.ops.cuda import halo
    from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as ss
    from primekg_rgcn_tpu_torch.ops.cuda import window_fetch as pwf

    return {"B1": ss.gather_segment_sum.launches,
            "B2": pds.dense_sorted_segment_sum.launches,
            "B3": pwf.window_rows_fetch.launches,
            "B4": halo.halo_exchange.launches}


def read_bf16_counts():
    """The bf16-variant launches of B1, B2 and B4 since ``reset_counts``
    (each also counts in ``read_counts``)."""
    from primekg_rgcn_tpu_torch.ops.cuda import dense_segment_sum as pds
    from primekg_rgcn_tpu_torch.ops.cuda import halo
    from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as ss

    return {"B1": ss.gather_segment_sum.launches_bf16,
            "B2": pds.dense_sorted_segment_sum.launches_bf16,
            "B4": halo.halo_exchange.launches_bf16}


def only_bf16(label, counts, bf16_counts, expect=None,
              kinds=("B1", "B2", "B4")):
    """Every launch of ``kinds`` (B1, B2 and B4) in a bf16 run went to its
    bf16 variant (and, with ``expect``, the counts are those)."""
    mixed = {k: (counts[k], bf16_counts[k]) for k in kinds
             if counts[k] != bf16_counts[k]}
    if mixed or (expect is not None and counts != expect):
        raise AssertionError(f"{label}: launches {counts}, bf16 "
                             f"{bf16_counts}; expected {expect} all bf16")


def sampled_forward_backward(step, params, cfg, pos, dev, seed=0):
    """One sampled step's loss and gradients (no update) through
    ``step.sample`` and ``sampled_loss``, every draw from one generator
    seeded ``seed``. Returns (loss, {leaf: grad}, batch)."""
    import torch

    from primekg_rgcn_tpu_torch.data.sampling import uniform_draw
    from primekg_rgcn_tpu_torch.train.neg_sampling import candidate_batch
    from primekg_rgcn_tpu_torch.train.sampled import sampled_loss

    gen = torch.Generator(dev).manual_seed(seed)
    cands = candidate_batch(pos[:, 0], pos[:, 1], pos[:, 2], cfg.num_nodes, 1,
                            generator=gen)
    seeds = torch.cat([cands[0], cands[1]]).to(torch.int32)
    batch = step.sample(seeds, uniform_draw(gen, dev))
    leaves = list(named_leaves(params))
    for _, p in leaves:
        p.grad = None
    loss, _ = sampled_loss(params, batch, cands, cfg, train=True,
                           generator=gen)
    loss.backward()
    torch.cuda.synchronize()
    return loss.item(), {k: p.grad.clone() for k, p in leaves}, batch


def sampled_setup(graph, cfg, edges, dev):
    """The parameters, a batch of 1,024 positives and the three CSRs of the
    sampled phases: the fat CSR the step builds from the graph, and the
    slim packed CSR in granule-pairs form."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.data.sampling import build_combined_csr
    from primekg_rgcn_tpu_torch.models import rgcn

    params = rgcn.init_params(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    for _, p in named_leaves(params):
        p.requires_grad_(True)
    edges_dev = torch.from_numpy(edges.astype(np.int64)).to(dev)
    pos = edges_dev[torch.from_numpy(np.random.default_rng(0).integers(
        0, edges.shape[0], 1024)).to(dev)]
    slim = build_combined_csr(graph, slim=True, window_pairs=True)
    return params, edges_dev, pos, {"fat": graph, "slim": slim}


def b2_bound(msg, srt, n):
    """Least time of B2, in ms, both ways: the rows of real ids (2 bytes an
    element in bf16), every id and the float32 output, each moved once at
    the HBM rate, and one float32 addition per real row element at the
    float32 peak."""
    real = int((srt < n).sum())
    d = msg.shape[1]
    nbytes = real * d * msg.element_size() + srt.numel() * 4 + n * d * 4
    return {"bytes": nbytes, "real_rows": real,
            "byte_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "op_ms": real * d / F32_FLOPS * 1e3}


def b3_bound(starts, width):
    """Least time of B3, in ms: each window's records read once and written
    once, and the starts read once, at the HBM rate (no arithmetic)."""
    nbytes = starts.numel() * (width * 8 * 2 + 4)
    return {"bytes": nbytes, "byte_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "op_ms": 0.0}


def bound_fields(b):
    return dict(bound_us=max(b["byte_ms"], b["op_ms"]) * 1e3,
                bound_by="bytes" if b["byte_ms"] >= b["op_ms"] else "operations",
                byte_us=b["byte_ms"] * 1e3, op_us=b["op_ms"] * 1e3,
                bytes=b["bytes"])


def b2_twice_equal(name, msg, srt, n, first=None):
    """Two launches of B2 on the same inputs must agree bit for bit (the
    row split and its fix-up add in a fixed order); ``first`` is one
    launch's result when the caller has it."""
    import torch

    from primekg_rgcn_tpu_torch.ops.cuda import dense_segment_sum as pds

    if first is None:
        first = pds.dense_sorted_segment_sum(msg, srt, n)
    second = pds.dense_sorted_segment_sum(msg, srt, n)
    if not torch.equal(first, second):
        raise AssertionError(f"{name}: two B2 launches on the same inputs "
                             f"differ")


def b2_stream_row(label, name, msg, srt, n):
    """B2 on one recorded stream: held against its plain version
    (``close_scaled``) and two launches against each other, then kernel,
    plain and ``index_add_`` (of the float32 rows, the upcast included)
    times beside ``b2_bound``, with the stream's real rows, runs and longest
    run and the kernel's share of the bound. Emits ``<label>`` and returns
    the row."""
    import torch

    from primekg_rgcn_tpu_torch.ops.cuda import dense_segment_sum as pds

    got = pds.dense_sorted_segment_sum(msg, srt, n)
    want = pds.dense_sorted_segment_sum_plain(msg, srt, n)
    torch.cuda.synchronize()
    err = close_scaled(got, want, f"{label}/{name}")
    b2_twice_equal(f"{label}/{name}", msg, srt, n, got)
    del got, want
    idx = srt.clamp(max=n).long()
    buf = torch.zeros(n + 1, msg.shape[1], device=msg.device)
    t = time_calls({
        "kernel": lambda: pds.launch(msg, srt, n),
        "plain": lambda: pds.dense_sorted_segment_sum_plain(msg, srt, n),
        "library": lambda: buf.index_add_(0, idx, msg.float())})
    b = bound_fields(b2_bound(msg, srt, n))
    runs = torch.unique_consecutive(srt[srt < n], return_counts=True)[1]
    row = dict(shape=name, dtype=str(msg.dtype).replace("torch.", ""),
               rows=msg.shape[0], d=msg.shape[1], segments=n,
               real_rows=int((srt < n).sum()), longest_run=int(runs.max()),
               runs=int(runs.numel()), **t, max_abs_err=err,
               bound_share=b["bound_us"] / 1e3 / t["kernel_ms"],
               over_library=t["kernel_ms"] / t["library_ms"], **b)
    emit(label, **row)
    return row


def sampled_b2_streams(label, step, params, cfg, pos, dev):
    """The B2 calls of one sampled step, recorded: ``{"ident": (msg, srt,
    n), "dedup": ...}``, told apart by the sorted ids each block holds (the
    outer block's dedup backward runs first). Every call must be one of
    the two."""
    calls = {}
    with sampler_kernels(("record", calls)):
        _, _, batch = sampled_forward_backward(step, params, cfg, pos, dev)
    blocks = {"ident": batch.blocks[0], "dedup": batch.blocks[1]}
    if not blocks["ident"].ident or blocks["dedup"].ident:
        raise AssertionError(f"{label}: expected an identity inner block and "
                             f"a dedup outer block")
    streams = {}
    for msg, srt, n in calls.get("b2", []):
        name = [k for k, blk in blocks.items()
                if srt.data_ptr() == blk.sort_uid.data_ptr()]
        if len(name) != 1 or name[0] in streams:
            raise AssertionError(f"{label}: a B2 call of no block "
                                 f"({len(calls['b2'])} calls)")
        streams[name[0]] = (msg, srt, n)
    if sorted(streams) != ["dedup", "ident"]:
        raise AssertionError(f"{label}: B2 streams {sorted(streams)}")
    return streams


def close_scaled_chunked(got, want, name, rows=1 << 22):
    """``close_scaled`` over chunks of ``rows`` rows: for outputs too large
    for its temporaries."""
    import torch

    top = max(float(want[i:i + rows].abs().max())
              for i in range(0, want.shape[0], rows))
    err = 0.0
    for i in range(0, want.shape[0], rows):
        a, b = got[i:i + rows], want[i:i + rows]
        torch.testing.assert_close(
            a, b, rtol=1e-4, atol=1e-4 * max(top, 1e-30),
            msg=lambda m: f"{name} rows {i}..: {m}")
        err = max(err, float((a - b).abs().max()))
    return err


def phase_kernel_b2(graph, cfg, edges, dev, repo):
    """Kernel B2 against its plain version on the card: the two streams one
    block-mode step gives it (the identity backward's, the main path, and
    the outer layer's dedup backward), recorded from the step, and edge
    cases, among them the row split's: one run of 200,000 rows across many
    pieces, runs cut at every piece boundary, a leading gap, one real row
    then sentinels, and an output of N·D just under 2^31 elements (8.6 GB);
    two launches ``torch.equal`` at every stream and case; kernel, plain
    and index_add_ times beside the bound; child processes hand B2 (both
    variants) unsorted ids and B3 a window past its table, and must stop
    on the device-side assert.

    At ``cfg.compute_dtype`` bf16 (phase ``kernel_bf16``, lines
    ``kernel_bf16_b2_*``) the step's streams are bf16 cotangent rows: the
    bf16 variant, every case in bf16, ``index_add_`` of the upcast rows
    (the upcast included) as the library call, and no children."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.config import TrainConfig
    from primekg_rgcn_tpu_torch.ops.cuda import dense_segment_sum as pds
    from primekg_rgcn_tpu_torch.ops.cuda.segment_sum import _num_sms
    from primekg_rgcn_tpu_torch.train.sampled import build_sampled_train_step

    bf16 = cfg.compute_dtype == "bfloat16"
    label = "kernel_bf16_b2" if bf16 else "kernel_b2"
    children = {} if bf16 else {name: subprocess.Popen(
        [sys.executable, "-c", SAMPLED_BAD_INPUT_CHILD.format(case=body)],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, body in SAMPLED_BAD_CASES.items()}

    params, _, pos, csrs = sampled_setup(graph, cfg, edges, dev)
    step = build_sampled_train_step(csrs["fat"], cfg, TrainConfig(),
                                    fanouts=(15, 10), mode="block", device=dev)
    streams = sampled_b2_streams(label, step, params, cfg, pos, dev)
    dtype = torch.bfloat16 if bf16 else torch.float32
    if any(m.dtype != dtype for m, _, _ in streams.values()):
        raise AssertionError(f"{label}: the step's streams are "
                             f"{[m.dtype for m, _, _ in streams.values()]}")
    rows = [b2_stream_row(f"{label}_shape", name, *streams[key])
            for name, key in (("ident_backward/main_path", "ident"),
                              ("dedup_backward", "dedup"))]
    max_err = max(r["max_abs_err"] for r in rows)
    del streams

    gen = torch.Generator(dev).manual_seed(2)
    rng = np.random.default_rng(3)

    def case(ids, d, segs, offset=0):
        flat = torch.rand(ids.shape[0] * d + offset, device=dev,
                          generator=gen).to(dtype)
        return (flat[offset:].view(ids.shape[0], d),
                torch.from_numpy(ids.astype(np.int32)).to(dev), segs)

    # The device's piece length for a stream of 100,000 real rows.
    min_rows, pieces = pds.piece_plan(100000, _num_sms(dev))
    per = max(min_rows, -(-100000 // pieces))
    cases = {
        "empty": case(np.zeros(0, np.int64), 64, 500),
        "only_sentinels": case(np.full(3000, 500), 64, 500),
        "giant_run": case(np.concatenate([np.full(20000, 123), [124, 900]]),
                          128, 1000),
        "distinct_ids": case(np.arange(4096) * 3, 128, 3 * 4096),
        "odd_d": case(np.sort(rng.integers(0, 2000, 30000)), 3, 2100),
        "unaligned_table": case(np.sort(rng.integers(0, 2000, 30000)), 128,
                                2100, offset=1),
        "sentinel_tail": case(np.concatenate([np.sort(rng.integers(
            0, 5000, 40000)), np.full(30000, 5000)]), 64, 5000),
        "run_across_many_pieces": case(np.concatenate([
            np.sort(rng.integers(0, 100, 5000)), np.full(250000, 100),
            np.sort(rng.integers(101, 3000, 5000))]), 64, 3000),
        "runs_cut_at_every_piece_boundary": case(
            np.arange(100000) // (per - 1), 128, 100000 // (per - 1) + 1),
        "leading_gap": case(np.sort(rng.integers(900000, 1000000, 50000)),
                            64, 1000000),
        "one_real_row_then_sentinels": case(np.concatenate([
            [17], np.full(100000, 40000)]), 64, 40000),
    }
    for name, (m, s, segs) in cases.items():
        got = pds.dense_sorted_segment_sum(m, s, segs)
        want = pds.dense_sorted_segment_sum_plain(m, s, segs)
        torch.cuda.synchronize()
        err = close_scaled(got, want, f"{label}/{name}")
        b2_twice_equal(f"{label}/{name}", m, s, segs, got)
        max_err = max(max_err, err)
        emit(f"{label}_case", case=name, rows=m.shape[0], d=m.shape[1],
             segments=segs, max_abs_err=err, twice_equal=True)
    del cases, got, want

    # N·D just under 2^31: 64-bit output offsets, 8.6 GB of float32 (the
    # zeros and the sums of the rows near the end lie past 2^31 bytes).
    segs = (2 ** 31 - 1) // 64
    ids = np.concatenate([np.sort(rng.integers(0, segs, 300000)),
                          [segs - 1] * 5, [segs] * 7])
    m, s, _ = case(ids, 64, segs)
    got = pds.dense_sorted_segment_sum(m, s, segs)
    want = pds.dense_sorted_segment_sum_plain(m, s, segs)
    torch.cuda.synchronize()
    err = close_scaled_chunked(got, want, f"{label}/huge_output")
    del want
    b2_twice_equal(f"{label}/huge_output", m, s, segs, got)
    del got
    torch.cuda.empty_cache()
    max_err = max(max_err, err)
    emit(f"{label}_case", case="huge_output", rows=m.shape[0], d=64,
         segments=segs, output_elements=segs * 64, max_abs_err=err,
         twice_equal=True)

    for name, child in children.items():
        out, _ = child.communicate(timeout=300)
        if child.returncode == 0 or "device-side assert" not in out:
            raise AssertionError(
                f"bad input {name} did not stop on the device-side assert "
                f"(exit {child.returncode}):\n{out[-2000:]}")
        emit("sampled_kernel_bad_input", case=name,
             exit_code=child.returncode, faulted=True)
    return rows, max_err


def phase_kernel_b3(graph, cfg, edges, dev):
    """Kernel B3 against its plain version on the card, at the window
    shapes of a block and a block4 step over the slim CSR (their real
    starts) and at width 64; kernel, plain and row-gather times beside the
    bound. Results must be exactly equal."""
    import torch

    from primekg_rgcn_tpu_torch.config import TrainConfig
    from primekg_rgcn_tpu_torch.ops.cuda import window_fetch as pwf
    from primekg_rgcn_tpu_torch.train.sampled import build_sampled_train_step

    params, _, pos, csrs = sampled_setup(graph, cfg, edges, dev)
    shapes = []
    for mode in ("block", "block4"):
        step = build_sampled_train_step(csrs["slim"], cfg, TrainConfig(),
                                        fanouts=(15, 10), mode=mode,
                                        device=dev)
        calls = {}
        with sampler_kernels(("record", calls)):
            sampled_forward_backward(step, params, cfg, pos, dev)
        for layer, (packed, starts, width) in zip(("outer", "inner"),
                                                  calls["b3"]):
            shapes.append((f"{mode}/{layer}", packed, starts, width))
    packed = shapes[0][1]
    e = int(step.csr.row_start[-1])
    gen = torch.Generator(dev).manual_seed(4)
    starts64 = torch.randint(0, e + 1, (30976,), generator=gen, device=dev,
                             dtype=torch.int32)
    shapes.append(("width64", packed, starts64, 64))
    rows = []
    for name, packed, starts, width in shapes:
        got = pwf.window_rows_fetch(packed, starts, width)
        want = pwf.window_rows_fetch_plain(packed, starts, width)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"b3/{name}: kernel and plain differ")
        rec = packed.view(-1, 2)
        idx = starts.long()[:, None] + torch.arange(width, device=dev)
        t = time_calls({
            "kernel": lambda: pwf.launch(rec, starts, width),
            "plain": lambda: pwf.window_rows_fetch_plain(packed, starts,
                                                         width),
            "library": lambda: rec[idx]})
        row = dict(shape=name, windows=starts.numel(), width=width, **t,
                   max_abs_err=0, **bound_fields(b3_bound(starts, width)))
        rows.append(row)
        emit("kernel_b3_shape", **row)
    return rows


def phase_sampled_grad(graph, cfg, edges, dev, label=None):
    """One full-size block-mode step's loss and gradients through kernels
    B2 and B3 and through their plain versions, over the fat CSR (2 B2
    launches: the identity and the dedup backward; no B3) and the slim
    pairs CSR (2 B2, 2 B3), with the same parameters, batch, negatives,
    draws and dropout mask.

    At ``cfg.compute_dtype`` bf16 (phase ``sampled_bf16``) over the slim
    CSR only, its B2 launches bf16 ones, within ``grad_bf16``'s tolerance:
    gradients within 1e-2 of each tensor's largest magnitude, the losses
    within 1e-3. ``label`` names the phase (``full_kg_sampled_grad``: the
    config-3 graph)."""
    import numpy as np

    from primekg_rgcn_tpu_torch.config import TrainConfig
    from primekg_rgcn_tpu_torch.train.sampled import build_sampled_train_step

    bf16 = cfg.compute_dtype == "bfloat16"
    label = label or ("sampled_bf16" if bf16 else "sampled_grad")
    params, _, pos, csrs = sampled_setup(graph, cfg, edges, dev)
    if bf16:
        del csrs["fat"]
    expect = {"fat": {"B1": 0, "B2": 2, "B3": 0, "B4": 0},
              "slim": {"B1": 0, "B2": 2, "B3": 2, "B4": 0}}
    losses, max_err, out = {}, 0.0, {}
    for csr_name, csr in csrs.items():
        step = build_sampled_train_step(csr, cfg, TrainConfig(),
                                        fanouts=(15, 10), mode="block",
                                        device=dev)
        runs = {}
        for impl in ("kernel", "plain"):
            reset_counts()
            with (sampler_kernels("plain") if impl == "plain"
                  else contextlib.nullcontext()):
                loss, grads, batch = sampled_forward_backward(
                    step, params, cfg, pos, dev)
            runs[impl] = (loss, grads, read_counts(), read_bf16_counts())
        if runs["kernel"][2] != expect[csr_name] or \
                any(runs["plain"][2].values()):
            raise AssertionError(
                f"{label}/{csr_name}: launches kernel "
                f"{runs['kernel'][2]}, plain {runs['plain'][2]}; expected "
                f"{expect[csr_name]} and none")
        if bf16:
            only_bf16(f"{label}/{csr_name}", *runs["kernel"][2:])
        if not np.isfinite(runs["kernel"][0]):
            raise AssertionError("non-finite sampled loss")
        np.testing.assert_allclose(runs["kernel"][0], runs["plain"][0],
                                   rtol=1e-3 if bf16 else 1e-5)
        per_leaf = {}
        for name, want in runs["plain"][1].items():
            got = runs["kernel"][1][name]
            where = f"{label}/{csr_name}/{name}"
            err = (close_rel(got, want, 1e-2, where) * float(want.abs().max())
                   if bf16 else close_scaled(got, want, where))
            max_err = max(max_err, err)
            per_leaf[name] = {"max_abs_err": err,
                              "max_abs": float(want.abs().max())}
        losses[csr_name] = runs["kernel"][0]
        out[csr_name] = dict(loss_kernel=runs["kernel"][0],
                             loss_plain=runs["plain"][0],
                             launches=runs["kernel"][2], leaves=per_leaf,
                             budgets=list(step.budgets),
                             ident_rows=batch.blocks[0].sort_uid.numel())
        if bf16:
            out[csr_name]["max_rel_err"] = max(
                v["max_abs_err"] / v["max_abs"] for v in per_leaf.values())
    if not bf16 and losses["slim"] != losses["fat"]:
        raise AssertionError(f"loss over the slim CSR {losses['slim']} != "
                             f"over the fat CSR {losses['fat']}")
    emit(label, **out)
    return max_err


def phase_sampled_train(graph, cfg, edges, dev, tmp, steps=30,
                        configs=("block/fat", "block/slim", "block4/slim"),
                        label=None):
    """``build_sampled_train_step`` timed as the JAX package's
    ``bench_sampled`` times it: a fresh batch of 1,024 positives drawn on
    the host each step, 3 warm-up then 30 timed steps on the host clock;
    block over the fat CSR, block over the slim pairs CSR (the main path of
    kernels B2 and B3) and block4 over the slim CSR. Then a 10-step profile
    of the main path; 2 B2 launches a step (identity and dedup backward),
    2 B3 over the slim CSR. At ``cfg.compute_dtype`` bf16 (phase
    ``sampled_bf16``, block over the slim CSR) every B2 launch must be a
    bf16 one. ``label`` names the phase (``full_kg_sampled``: config 4)."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.config import TrainConfig
    from primekg_rgcn_tpu_torch.train.sampled import build_sampled_train_step
    from primekg_rgcn_tpu_torch.utils.telemetry import (profile_trace,
                                                        trace_breakdown)

    bf16 = cfg.compute_dtype == "bfloat16"
    label = label or ("sampled_bf16" if bf16 else "sampled_train")
    tcfg = TrainConfig(batch_size=1024)
    params0, edges_dev, _, csrs = sampled_setup(graph, cfg, edges, dev)
    results = {}
    for name in configs:
        mode, csr_name = name.split("/")
        csr = csrs[csr_name]
        params = fresh_params(params0)
        step = build_sampled_train_step(csr, cfg, tcfg, fanouts=(15, 10),
                                        mode=mode, device=dev)
        opt = step.init_optimizer(params)
        gen = torch.Generator(dev).manual_seed(0)
        rng = np.random.default_rng(0)

        def one():
            idx = torch.from_numpy(rng.integers(0, edges.shape[0],
                                                tcfg.batch_size))
            idx = idx.pin_memory().to(dev, non_blocking=True)
            return step(params, opt, edges_dev[idx], gen)

        first = one()
        for _ in range(2):
            one()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(steps):
            last = one()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / steps * 1e3
        counts = read_counts()
        first_loss, last_loss = float(first[0]), float(last[0])
        if not (np.isfinite(first_loss) and np.isfinite(last_loss)):
            raise AssertionError(f"{name}: non-finite loss")
        # B2: the identity and the dedup backward.
        want = {"B1": 0, "B2": 2 * steps,
                "B3": 2 * steps if name.endswith("slim") else 0, "B4": 0}
        if counts != want:
            raise AssertionError(f"{name}: launches {counts}, expected {want}")
        if bf16:
            only_bf16(f"{label}/{name}", counts, read_bf16_counts())
        results[name] = dict(
            step_ms=step_ms, train_edges_per_s=tcfg.batch_size / step_ms * 1e3,
            launches=counts,
            launches_per_step={k: v / steps for k, v in counts.items()},
            peak_memory_mb=torch.cuda.max_memory_allocated() / 2 ** 20,
            budgets=list(step.budgets), first_loss=first_loss,
            last_loss=last_loss)
        emit(label, config=name, steps=steps,
             batch_size=tcfg.batch_size, **results[name])
        if name == "block/slim":
            main_counts = counts
            prof_steps = 10
            torch.cuda.synchronize()
            with profile_trace(tmp / f"{label}_profile"):
                t0 = time.perf_counter()
                for _ in range(prof_steps):
                    one()
                torch.cuda.synchronize()
                prof_ms = (time.perf_counter() - t0) / prof_steps * 1e3
            bd = trace_breakdown(tmp / f"{label}_profile" / "trace.json")
            if bd is None:
                emit(f"{label}_profile", steps=prof_steps,
                     device_events=0, idle_share="not measured")
            else:
                busy_ms = bd["busy_us"] / prof_steps / 1e3
                results[name]["device_busy_ms_per_step"] = busy_ms
                emit(f"{label}_profile", config=name, steps=prof_steps,
                     step_ms_under_profiler=prof_ms,
                     device_busy_ms_per_step=busy_ms,
                     idle_share_two_windows=1.0 - busy_ms / step_ms, **bd)
    return results, main_counts


def phase_sampled_cli(tmp):
    """train.cli.main with --sample_fanouts 15 10 at synthetic scale 0.1,
    block mode, then predict_cli from its final model; then block4 with
    --sparse_emb --optimizer sgd --grad_clip 0 --val_sampled. B2 must
    launch in both runs."""
    import numpy as np

    from primekg_rgcn_tpu_torch.evaluate import predict_cli
    from primekg_rgcn_tpu_torch.train import cli as train_cli

    base = ["--synthetic", "--synthetic_scale", "0.1", "--epochs", "2",
            "--seed", "0", "--device", "cuda", "--sample_fanouts", "15", "10"]
    runs = {"block": ["--sample_mode", "block"],
            "block4_sparse": ["--sample_mode", "block4", "--sparse_emb",
                              "--optimizer", "sgd", "--grad_clip", "0",
                              "--val_sampled", "--lr", "0.5"]}
    launches = {}
    for name, extra in runs.items():
        out = tmp / f"sampled_cli_{name}"
        reset_counts()
        t0 = time.perf_counter()
        result = train_cli.main([*base, *extra, "--output_dir", str(out)])
        seconds = time.perf_counter() - t0
        launches[name] = read_counts()
        hist = result["history"]
        problems = []
        if not np.all(np.isfinite(hist["train_losses"] + hist["val_losses"])):
            problems.append(f"losses {hist}")
        for f in ("best_model.pt", "final_model.pt"):
            if not (out / "models" / f).exists():
                problems.append(f"missing models/{f}")
        if launches[name]["B2"] == 0:
            problems.append("no B2 launch")
        served = predict_cli.main([
            "--model_path", str(out / "models" / "final_model.pt"),
            "--data_dir", str(out / "synthetic_data"), "--heads", "0", "7",
            "--relation", "0", "--topk", "5", "--device", "cuda"])
        scores = [p["score"] for q in served for p in q["predictions"]]
        if len(scores) != 10 or not np.all(np.isfinite(scores)):
            problems.append(f"served scores {scores}")
        if problems:
            raise AssertionError(f"sampled_cli/{name}: " + "; ".join(problems))
        emit("sampled_cli", run=name, seconds=seconds,
             launches=launches[name], history=hist,
             epoch_time_s=result["epoch_times_s"])
    return launches

N_SHARDS = 4


def node_launches(psg, step=True):
    """Launches of one node-sharded step (or, ``step=False``, one encode):
    B1 once per layer and (shard, group, relation) bucket with real edges,
    twice in a step (forward, backward over the transpose CSR), three times
    through the relation scan of a ``uniform_caps`` partition (its backward
    recomputes the partial first); B4 once per layer, twice in a step; B2
    in a step's backward of every ``_take``: each shard's serve list per
    layer, its two endpoint fetches and its relation lookup, 5 n."""
    buckets = int((psg.rowptr_local[..., -1] > 0).sum()
                  + (psg.rowptr_halo[..., -1] > 0).sum())
    if not step:
        return {"B1": 2 * buckets, "B2": 0, "B3": 0, "B4": 2}
    per_bucket = 3 if psg.uniform_caps else 2
    return {"B1": 2 * buckets * per_bucket, "B2": 5 * psg.n_devices,
            "B3": 0, "B4": 4}


def edge_launches(esg, step=True):
    """Launches of one edge-sharded step (or, ``step=False``, one encode):
    B1 once per layer and (shard, relation) chunk with real edges, twice in
    a step (forward, backward over the transpose CSR); no other kernel."""
    buckets = int((esg.rowptr[..., -1] > 0).sum())
    return {"B1": 2 * buckets * (2 if step else 1), "B2": 0, "B3": 0,
            "B4": 0}


@contextlib.contextmanager
def node_plain():
    """While open, the node layer's ``_take`` backward sums with B2's plain
    version, so that a plain reference step (B1's and B4's plain versions
    passed as ``agg_fn`` and ``exchange_fn``) launches no kernel."""
    from primekg_rgcn_tpu_torch.ops.cuda import dense_segment_sum as pds
    from primekg_rgcn_tpu_torch.parallel import node_shard

    saved = node_shard.dense_sorted_segment_sum
    node_shard.dense_sorted_segment_sum = pds.dense_sorted_segment_sum_plain
    try:
        yield
    finally:
        node_shard.dense_sorted_segment_sum = saved


@contextlib.contextmanager
def take_index_add():
    """While open, the node layer's ``_take`` is ``index_select``, whose
    backward is the atomic ``index_add_``: the layer as it was before its
    sorted backward, for the determinism check's comparison."""
    from primekg_rgcn_tpu_torch.parallel import node_shard

    saved = node_shard._take
    node_shard._take = lambda table, ids, sort=None: table.index_select(
        0, ids.reshape(-1)).view(*ids.shape, table.shape[1])
    try:
        yield
    finally:
        node_shard._take = saved


def step_twice_equal(step, params, opt, batch, dev, seed=1):
    """Runs ``step(params, opt, batch, generator)`` twice from the same
    parameters, optimizer state and generator seed; True when both runs
    leave the same bits in every parameter, gradient and the stats. The
    parameters and optimizer state are put back after."""
    import copy

    import torch

    leaves = list(named_leaves(params))
    snap = [p.detach().clone() for _, p in leaves]
    state = copy.deepcopy(opt.state_dict())
    runs = []
    for _ in range(2):
        with torch.no_grad():
            for (_, p), v in zip(leaves, snap):
                p.copy_(v)
        opt.load_state_dict(copy.deepcopy(state))
        stats = step(params, opt, batch, torch.Generator(dev).manual_seed(
            seed))
        torch.cuda.synchronize()
        runs.append([stats.clone()]
                    + [t.detach().clone() for _, p in leaves
                       for t in (p, p.grad)])
    with torch.no_grad():
        for (_, p), v in zip(leaves, snap):
            p.copy_(v)
    opt.load_state_dict(state)
    return all(torch.equal(a, b) for a, b in zip(*runs))


def b4_bound(sends):
    """Least time of B4, in ms: every send byte read once and every recv
    byte written once at the HBM rate (no arithmetic)."""
    nbytes = 2 * sum(t.numel() for t in sends) * sends[0].element_size()
    return {"bytes": nbytes, "byte_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "op_ms": 0.0}


def phase_kernel_b4(psg, dev, dtype=None):
    """Kernel B4 against its plain version on the card, exactly equal: at
    the node-sharded step's two shapes (the real serve lists over random
    [n_loc + 1, D] tables, D = 64 and 128) and on edge cases; kernel, plain
    and ``copy_`` of the same bytes timed beside the bound. With ``dtype``
    bf16 (phase ``kernel_bf16``, lines ``kernel_bf16_b4_*``) every payload
    is bf16 and launches the bf16 variant, 16-byte vectors of 8 elements."""
    import torch

    from primekg_rgcn_tpu_torch.ops.cuda import halo

    dtype = dtype or torch.float32
    label = "kernel_bf16_b4" if dtype == torch.bfloat16 else "kernel_b4"
    gen = torch.Generator(dev).manual_seed(6)
    serve = psg.serve.to(dev).long()
    n, p = psg.n_devices, psg.halo_width

    def check(name, sends):
        reset_counts()
        got = halo.halo_exchange(sends)
        want = halo.halo_exchange_plain(sends)
        torch.cuda.synchronize()
        if halo.halo_exchange.launches_bf16 != (dtype == torch.bfloat16):
            raise AssertionError(f"{label}/{name}: not its dtype's variant")
        for o, (g, w) in enumerate(zip(got, want)):
            if not torch.equal(g, w):
                raise AssertionError(f"{label}/{name}: recv {o} differs "
                                     f"from the plain version")

    rows = []
    for d in (64, 128):
        tables = [torch.randn(psg.n_loc + 1, d, device=dev,
                              generator=gen).to(dtype) for _ in range(n)]
        sends = [tables[i][serve[i]] for i in range(n)]
        name = f"main_path/n{n}/P{p}/D{d}"
        check(name, sends)
        flat = sum(t.numel() for t in sends)
        src = torch.randn(flat, device=dev, generator=gen).to(dtype)
        dst = torch.empty_like(src)
        row = dict(shape=name, n=n, p=p, d=d, **time_calls({
            "kernel": lambda: halo.launch(sends),
            "plain": lambda: halo.halo_exchange_plain(sends),
            "library": lambda: dst.copy_(src)}),
            max_abs_err=0, **bound_fields(b4_bound(sends)))
        rows.append(row)
        emit(f"{label}_shape", **row)

    def sends_of(n_, p_, d_, offset=0):
        out = []
        for _ in range(n_):
            buf = torch.randn(n_ * p_ * d_ + offset, device=dev,
                              generator=gen).to(dtype)
            out.append(buf[offset:].view(n_, p_, d_))
        return out

    cases = {"n2": sends_of(2, 7736, 64), "n8": sends_of(8, 3872, 128),
             "p1": sends_of(4, 1, 64), "d8": sends_of(4, 7736, 8),
             "odd_d": sends_of(4, 999, 37),
             "unaligned_views": sends_of(4, 7736, 64, offset=1),
             "unaligned_odd": sends_of(3, 5, 3, offset=1)}
    wide = 16 // torch.empty((), dtype=dtype).element_size()
    for name, sends in cases.items():
        check(name, sends)
        aligned = all(t.data_ptr() % 16 == 0 for t in sends)
        emit(f"{label}_case", case=name, n=len(sends),
             shape=list(sends[0].shape),
             vec=wide if sends[0].shape[2] % wide == 0 and aligned else 1,
             max_abs_err=0)
    return rows


def node_setup(cfg, edges, dev, dropout):
    """The config with the given encoder dropout, its parameters (seed 0)
    and the train edges with their sentinel row, on the card."""
    import dataclasses

    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.models import rgcn
    from primekg_rgcn_tpu_torch.train import loop

    ncfg = dataclasses.replace(cfg, dropout=dropout)
    params = rgcn.init_params(torch.Generator().manual_seed(0), ncfg,
                              device=dev)
    for _, p in named_leaves(params):
        p.requires_grad_(True)
    edges_pad = loop.edges_with_sentinel(edges, dev)
    return ncfg, params, edges_pad


def node_batch(edges_pad, idx):
    """[B, 4] (head, tail, rel, mask) rows for edge indices ``idx``."""
    import torch

    e = edges_pad.shape[0] - 1
    return torch.cat([edges_pad[idx], (idx < e)[:, None].long()], dim=1)


def phase_node_grad(graph, psg, cfg, edges, dev, label="node_grad"):
    """One node-sharded step's loss and gradients (dropout off) on given
    candidates, through B1, B4 and B2 (the ``_take`` backward), against the
    same step through their plain versions and against the full-graph step
    on the same candidates. The update is plain SGD at lr 0, so every run
    starts from the same parameters and leaves its gradient in ``.grad``.
    On a ``uniform_caps`` partition (phase ``full_kg_node_grad``) the layer
    runs the relation scan."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.config import TrainConfig
    from primekg_rgcn_tpu_torch.ops.cuda.halo import halo_exchange_plain
    from primekg_rgcn_tpu_torch.ops.rgcn_segment import aggregate_plain
    from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh
    from primekg_rgcn_tpu_torch.parallel.node_shard import (
        build_node_sharded_train_step)
    from primekg_rgcn_tpu_torch.train import loop

    ncfg, params, edges_pad = node_setup(cfg, edges, dev, dropout=0.0)
    leaves = list(named_leaves(params))
    tcfg = TrainConfig(optimizer="sgd", lr=0.0, grad_clip=0.0)
    opt = loop.make_optimizer(tcfg, params)
    mesh = make_mesh(N_SHARDS, dev)
    idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, edges.shape[0], 1024)).to(dev)
    gen = torch.Generator(dev).manual_seed(0)
    steps = {"kernel": build_node_sharded_train_step(mesh, psg, ncfg, tcfg),
             "plain": build_node_sharded_train_step(
                 mesh, psg, ncfg, tcfg, agg_fn=aggregate_plain,
                 exchange_fn=halo_exchange_plain)}
    cands = steps["kernel"].draw(node_batch(edges_pad, idx), gen)
    runs = {}
    for name, step in steps.items():
        reset_counts()
        with node_plain() if name == "plain" else contextlib.nullcontext():
            stats = step.update(params, opt, cands)
        torch.cuda.synchronize()
        runs[name] = (float(stats[0] / stats[2]),
                      {k: p.grad.clone() for k, p in leaves}, read_counts())
    opt.zero_grad(set_to_none=True)
    full = tuple(torch.cat([c[i] for c in cands]) for i in range(5))
    loss, _ = loop.loss_from_candidates(params, graph, *full, ncfg,
                                        train=True)
    loss.backward()
    torch.cuda.synchronize()
    runs["full_graph"] = (loss.item(), {k: p.grad.clone() for k, p in leaves},
                          None)
    if runs["kernel"][2] != node_launches(psg) or \
            any(runs["plain"][2].values()):
        raise AssertionError(
            f"{label} launches: kernel {runs['kernel'][2]}, plain "
            f"{runs['plain'][2]}; expected {node_launches(psg)} and none")
    if not np.isfinite(runs["kernel"][0]):
        raise AssertionError(f"{label}: non-finite node-sharded loss")
    out, max_err = {}, 0.0
    for ref in ("plain", "full_graph"):
        np.testing.assert_allclose(runs["kernel"][0], runs[ref][0], rtol=1e-5)
        per_leaf = {}
        for k, want in runs[ref][1].items():
            err = close_scaled(runs["kernel"][1][k], want,
                               f"{label}/{ref}/{k}")
            max_err = max(max_err, err)
            per_leaf[k] = {"max_abs_err": err,
                           "max_abs": float(want.abs().max())}
        out[ref] = dict(loss=runs[ref][0], leaves=per_leaf)
    emit(label, loss_kernel=runs["kernel"][0], scan=psg.uniform_caps,
         launches=runs["kernel"][2], against=out)
    return max_err


def phase_node_train(psg, cfg, edges, dev, tmp, steps=30, label=None):
    """``build_node_sharded_train_step`` with B4 at batch 1024, adam and
    dropout 0.5: a fresh host batch each step, 3 warm-up then 30 timed
    steps on the host clock, the launches of every kernel counted and
    asserted; then a 10-step profile, and whether the step run twice from
    one state gives the same bits (``step_twice_equal``, also with the
    ``_take`` backward the atomic ``index_add_``, printed). At
    ``cfg.compute_dtype`` bf16 (phase ``node_bf16``) every B1 and B4 launch
    must be a bf16 one, and B2's on the serve lists' bf16 rows (2 n a
    step; the fetches and the relation lookup take float32 rows)."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.config import TrainConfig
    from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh
    from primekg_rgcn_tpu_torch.parallel.node_shard import (
        build_node_sharded_train_step)
    from primekg_rgcn_tpu_torch.train import loop
    from primekg_rgcn_tpu_torch.utils.telemetry import (profile_trace,
                                                        trace_breakdown)

    bf16 = cfg.compute_dtype == "bfloat16"
    label = label or ("node_bf16" if bf16 else "node_train")
    tcfg = TrainConfig(batch_size=1024)
    ncfg, params, edges_pad = node_setup(cfg, edges, dev, dropout=0.5)
    step = build_node_sharded_train_step(make_mesh(N_SHARDS, dev), psg, ncfg,
                                         tcfg)
    opt = loop.make_optimizer(tcfg, params)
    gen = torch.Generator(dev).manual_seed(0)
    rng = np.random.default_rng(0)

    def one():
        idx = torch.from_numpy(rng.integers(0, edges.shape[0],
                                            tcfg.batch_size))
        idx = idx.pin_memory().to(dev, non_blocking=True)
        return step(params, opt, node_batch(edges_pad, idx), gen)

    first = one()
    for _ in range(2):
        one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        last = one()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    counts = read_counts()
    want = {k: v * steps for k, v in node_launches(psg).items()}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    if bf16:
        bf16_counts = read_bf16_counts()
        only_bf16(label, counts, bf16_counts, kinds=("B1", "B4"))
        if bf16_counts["B2"] != 2 * psg.n_devices * steps:
            raise AssertionError(f"{label}: bf16 B2 launches "
                                 f"{bf16_counts['B2']}")
    first_loss = float(first[0] / first[2])
    last_loss = float(last[0] / last[2])
    if not (np.isfinite(first_loss) and np.isfinite(last_loss)):
        raise AssertionError(f"{label}: non-finite loss {first_loss}, "
                             f"{last_loss}")
    result = dict(steps=steps, batch_size=tcfg.batch_size, shards=N_SHARDS,
                  scan=psg.uniform_caps, step_ms=step_ms,
                  train_edges_per_s=tcfg.batch_size / step_ms * 1e3,
                  launches=counts,
                  launches_per_step={k: v / steps for k, v in counts.items()},
                  peak_memory_mb=torch.cuda.max_memory_allocated() / 2 ** 20,
                  first_loss=first_loss, last_loss=last_loss)
    batch = node_batch(edges_pad, torch.from_numpy(rng.integers(
        0, edges.shape[0], tcfg.batch_size)).to(dev))
    result["step_twice_equal"] = step_twice_equal(step, params, opt, batch,
                                                  dev)
    with take_index_add():
        result["step_twice_equal_index_add"] = step_twice_equal(
            step, params, opt, batch, dev)
    emit(label, **result)

    prof_steps = 10
    torch.cuda.synchronize()
    with profile_trace(tmp / f"{label}_profile"):
        t0 = time.perf_counter()
        for _ in range(prof_steps):
            one()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) / prof_steps * 1e3
    bd = trace_breakdown(tmp / f"{label}_profile" / "trace.json")
    if bd is None:
        emit(f"{label}_profile", steps=prof_steps, device_events=0,
             idle_share="not measured")
    else:
        busy_ms = bd["busy_us"] / prof_steps / 1e3
        b4_us = bd["us_by_kind"].get("halo_exchange", 0.0)
        emit(f"{label}_profile", steps=prof_steps,
             step_ms_under_profiler=prof_ms, device_busy_ms_per_step=busy_ms,
             idle_share_two_windows=1.0 - busy_ms / step_ms,
             b4_share_of_busy=b4_us / bd["busy_us"], **bd)
        result.update(device_busy_ms_per_step=busy_ms,
                      idle_share=bd.get("idle_share"),
                      idle_share_two_windows=1.0 - busy_ms / step_ms)
    return counts, result


def phase_node_bf16_encode(graph, psg, cfg, dev):
    """The 4-shard encode at bf16 (phase ``node_bf16``): one encode's
    launches (B1 per bucket with real edges, 2 B4, all bf16) and its rows
    against the dense bf16 encode within 2e-2 of the largest magnitude
    (both sum the same bf16 rows in float32, so the measured figure is far
    smaller); the sharded encode timed. Returns its launches."""
    import torch

    from primekg_rgcn_tpu_torch.models import rgcn
    from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh
    from primekg_rgcn_tpu_torch.parallel.node_shard import (
        build_node_sharded_forward)

    params = rgcn.init_params(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    encode = build_node_sharded_forward(make_mesh(N_SHARDS, dev), psg, cfg)
    with torch.no_grad():
        reset_counts()
        got = encode(params)
        torch.cuda.synchronize()
        counts, bf16_counts = read_counts(), read_bf16_counts()
        want = rgcn.get_embeddings(params, graph, cfg)
        encode_ms = host_ms(lambda: encode(params))
    only_bf16("node_bf16/encode", counts, bf16_counts,
              node_launches(psg, step=False))
    rel = close_rel(got, want, 2e-2, "node_bf16/encode")
    emit("node_bf16_encode", shards=N_SHARDS, launches=counts,
         launches_bf16=bf16_counts, max_rel_err_vs_dense=rel,
         max_abs=float(want.abs().max()), encode_ms=encode_ms)
    return counts


def phase_cli_bf16(tmp):
    """``train.cli.main --compute_dtype bfloat16`` at synthetic scale 0.1,
    full width, 2 epochs, then ``predict_cli.main`` and
    ``evaluate.cli.main`` on its final model: both must report bfloat16
    (the predict log line, the evaluation log's first line), every B1
    launch of all three must be a bf16 one, AUC-ROC and MRR finite. Then
    the same training with ``--sample_fanouts 15 10`` (block mode) and with
    ``--shard node --n_devices 4``: every B1, B2 and B4 launch a bf16 one,
    the losses finite. Returns the runs' launches."""
    import logging

    import numpy as np

    from primekg_rgcn_tpu_torch.evaluate import cli as eval_cli
    from primekg_rgcn_tpu_torch.evaluate import predict_cli
    from primekg_rgcn_tpu_torch.train import checkpoint
    from primekg_rgcn_tpu_torch.train import cli as train_cli

    out = tmp / "cli_bf16"
    model = out / "models" / "final_model.pt"
    counts = {}
    reset_counts()
    t0 = time.perf_counter()
    result = train_cli.main([
        "--synthetic", "--synthetic_scale", "0.1", "--epochs", "2",
        "--seed", "0", "--device", "cuda", "--compute_dtype", "bfloat16",
        "--output_dir", str(out)])
    seconds = time.perf_counter() - t0
    counts["train"] = read_counts()
    only_bf16("cli_bf16/train", counts["train"], read_bf16_counts())
    hist = result["history"]
    problems = []
    if not np.all(np.isfinite(hist["train_losses"] + hist["val_losses"])):
        problems.append(f"losses {hist}")
    if counts["train"]["B1"] == 0:
        problems.append("no B1 launch")
    stored = checkpoint.load(model)["model_config"]["compute_dtype"]
    if stored != "bfloat16":
        problems.append(f"the checkpoint holds compute_dtype {stored}")

    said = []

    class Said(logging.Handler):
        def emit(self, record):
            said.append(record.getMessage())

    handler = Said()
    logging.getLogger("predict").addHandler(handler)
    reset_counts()
    try:
        served = predict_cli.main([
            "--model_path", str(model), "--data_dir",
            str(out / "synthetic_data"), "--heads", "0", "7", "--relation",
            "0", "--topk", "5", "--device", "cuda"])
    finally:
        logging.getLogger("predict").removeHandler(handler)
    counts["predict"] = read_counts()
    only_bf16("cli_bf16/predict", counts["predict"], read_bf16_counts(),
              {"B1": 6, "B2": 0, "B3": 0, "B4": 0})
    if not said or "compute_dtype bfloat16" not in said[0]:
        problems.append(f"predict_cli's first line {said[:1]}")
    scores = [p["score"] for q in served for p in q["predictions"]]
    if len(scores) != 10 or not np.all(np.isfinite(scores)):
        problems.append(f"served scores {scores}")

    reset_counts()
    m = eval_cli.main(["--model_path", str(model), "--data_dir",
                       str(out / "synthetic_data"), "--output_dir",
                       str(out / "eval"), "--device", "cuda"])
    counts["evaluate"] = read_counts()
    only_bf16("cli_bf16/evaluate", counts["evaluate"], read_bf16_counts(),
              {"B1": 6, "B2": 0, "B3": 0, "B4": 0})
    first = (out / "eval" / "evaluation.log").read_text().splitlines()[:1]
    if not first or "compute_dtype bfloat16" not in first[0]:
        problems.append(f"evaluation.log's first line {first}")
    auc, mrr = m["classification"]["auc_roc"], m["ranking"]["mrr"]
    if not (np.isfinite(auc) and np.isfinite(mrr)):
        problems.append(f"auc {auc}, mrr {mrr}")
    for name, extra in (("sampled", ["--sample_fanouts", "15", "10",
                                     "--sample_mode", "block"]),
                        ("node", ["--shard", "node", "--n_devices",
                                  str(N_SHARDS)])):
        reset_counts()
        run = train_cli.main([
            "--synthetic", "--synthetic_scale", "0.1", "--epochs", "2",
            "--seed", "0", "--device", "cuda", "--compute_dtype",
            "bfloat16", "--output_dir", str(tmp / f"cli_bf16_{name}"),
            *extra])
        counts[name] = read_counts()
        bf16_counts = read_bf16_counts()
        if name == "node":
            # The sorted _take backwards: bf16 rows on the serve lists (2 of
            # the 5 a shard makes in a step), float32 on the fetches and
            # the relation lookup.
            only_bf16("cli_bf16/node", counts[name], bf16_counts,
                      kinds=("B1", "B4"))
            if 5 * bf16_counts["B2"] != 2 * counts[name]["B2"]:
                problems.append(f"node B2 launches {counts[name]['B2']}, "
                                f"bf16 {bf16_counts['B2']}")
        else:
            only_bf16(f"cli_bf16/{name}", counts[name], bf16_counts)
        losses = run["history"]["train_losses"] + run["history"]["val_losses"]
        if not np.all(np.isfinite(losses)):
            problems.append(f"{name} losses {losses}")
        used = ("B2",) if name == "sampled" else ("B1", "B4")
        if not all(counts[name][k] for k in used):
            problems.append(f"{name} launches {counts[name]}")
    if problems:
        raise AssertionError("cli_bf16: " + "; ".join(problems))
    emit("cli_bf16", seconds=seconds, launches=counts, history=hist,
         epoch_time_s=result["epoch_times_s"], auc_roc=auc, mrr=mrr,
         predict_first_line=said[0], evaluation_log_first_line=first[0])
    return counts


def untied_ids_equal(got_s, got_i, ref_s, ref_i):
    """Top-K ids equal where the reference's neighbouring scores are
    further apart than rtol 1e-4 of the row's scale (the serve phase's
    rule); returns whether they are equal everywhere."""
    import numpy as np

    np.testing.assert_allclose(got_s, ref_s, **TOL)
    tol = TOL["rtol"] * (np.abs(ref_s) + np.abs(ref_s).max())
    gaps = np.abs(np.diff(ref_s))
    tied = np.zeros(len(ref_s), bool)
    tied[1:] |= gaps <= tol[1:]
    tied[:-1] |= gaps <= tol[:-1]
    if not np.array_equal(got_i[~tied], ref_i[~tied]):
        raise AssertionError(f"top-K ids {got_i.tolist()} vs dense "
                             f"{ref_i.tolist()}")
    return bool(np.array_equal(got_i, ref_i))


def phase_node_serve(tmp, psg, cfg, heads, served, dev):
    """``predict_cli.main --shard node --n_devices 4`` for the serve phase's
    queries (3 relations, 8 heads, top-10) from the same checkpoint and
    data: the launches of one encode per call, ids equal to the dense
    serve's; then the sharded encode and query timed."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.evaluate import predict_cli
    from primekg_rgcn_tpu_torch.evaluate.sharded_ranking import (
        build_sharded_topk)
    from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh
    from primekg_rgcn_tpu_torch.parallel.node_shard import (
        build_node_sharded_forward)
    from primekg_rgcn_tpu_torch.train import checkpoint

    topk = len(served[0][0]["predictions"])
    per_call, exact, cli_s = [], [], []
    for r in range(3):
        reset_counts()
        t0 = time.perf_counter()
        got = predict_cli.main([
            "--model_path", str(tmp / "model.pt"), "--data_dir", str(tmp),
            "--heads", *map(str, heads), "--relation", str(r),
            "--topk", str(topk), "--device", "cuda", "--shard", "node",
            "--n_devices", str(N_SHARDS)])
        cli_s.append(time.perf_counter() - t0)
        per_call.append(read_counts())
        if per_call[-1] != node_launches(psg, step=False):
            raise AssertionError(f"node_serve relation {r}: launches "
                                 f"{per_call[-1]}")
        for res, ref in zip(got, served[r]):
            g = res["predictions"]
            w = ref["predictions"]
            if not np.all(np.isfinite([x["score"] for x in g])):
                raise AssertionError("non-finite sharded scores")
            exact.append(untied_ids_equal(
                np.array([x["score"] for x in g]),
                np.array([x["tail_id"] for x in g]),
                np.array([x["score"] for x in w]),
                np.array([x["tail_id"] for x in w])))

    params = checkpoint.load(tmp / "model.pt", device=dev)["params"]
    mesh = make_mesh(N_SHARDS, dev)
    encode = build_node_sharded_forward(mesh, psg, cfg, gather=False)
    q_heads = torch.tensor(heads, device=dev)
    rels = torch.zeros(len(heads), dtype=torch.long, device=dev)
    with torch.no_grad():
        encode_ms = host_ms(lambda: encode(params))
        emb_dm = encode(params)
        query = build_sharded_topk(mesh, emb_dm, params["decoder"]["rel_emb"],
                                   cfg.num_nodes, topk)
        query_ms = event_ms(lambda: query(q_heads, rels))
    emit("node_serve", shards=N_SHARDS, relations_served=3,
         queries_per_call=len(heads), topk=topk, launches_per_call=per_call,
         ids_equal_dense_exactly=all(exact), cli_seconds=cli_s,
         encode_ms=encode_ms, query_ms=query_ms)
    return per_call


def phase_node_cli(tmp):
    """train.cli.main --shard node --n_devices 4 at
    synthetic scale 0.1 for 2 epochs, then predict_cli --shard node from
    its final model; B4 must launch in both."""
    import numpy as np

    from primekg_rgcn_tpu_torch.evaluate import predict_cli
    from primekg_rgcn_tpu_torch.train import cli as train_cli

    out = tmp / "node_cli"
    reset_counts()
    t0 = time.perf_counter()
    result = train_cli.main([
        "--synthetic", "--synthetic_scale", "0.1", "--epochs", "2",
        "--seed", "0", "--device", "cuda", "--shard", "node",
        "--n_devices", str(N_SHARDS), "--output_dir", str(out)])
    seconds = time.perf_counter() - t0
    train_counts = read_counts()
    hist = result["history"]
    problems = []
    if not np.all(np.isfinite(hist["train_losses"] + hist["val_losses"])):
        problems.append(f"losses {hist}")
    for f in ("best_model.pt", "final_model.pt"):
        if not (out / "models" / f).exists():
            problems.append(f"missing models/{f}")
    if train_counts["B4"] == 0:
        problems.append("no B4 launch in training")
    reset_counts()
    served = predict_cli.main([
        "--model_path", str(out / "models" / "final_model.pt"),
        "--data_dir", str(out / "synthetic_data"), "--heads", "0", "7",
        "--relation", "0", "--topk", "5", "--device", "cuda",
        "--shard", "node", "--n_devices", str(N_SHARDS)])
    serve_counts = read_counts()
    scores = [p["score"] for q in served for p in q["predictions"]]
    if len(scores) != 10 or not np.all(np.isfinite(scores)):
        problems.append(f"served scores {scores}")
    if serve_counts["B4"] != 2:
        problems.append(f"serve launches {serve_counts}")
    if problems:
        raise AssertionError("node_cli: " + "; ".join(problems))
    emit("node_cli", seconds=seconds, launches=train_counts,
         serve_launches=serve_counts, history=hist,
         epoch_time_s=result["epoch_times_s"])
    return train_counts


def edge_setup(graph, cfg, edges, dev):
    """The edge shards of ``graph`` over N_SHARDS (host build timed), the
    mesh, parameters from seed 0 that require a gradient and the train
    edges with their sentinel row, on the card."""
    import torch

    from primekg_rgcn_tpu_torch.models import rgcn
    from primekg_rgcn_tpu_torch.parallel.edge_shard import shard_rel_graph
    from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh
    from primekg_rgcn_tpu_torch.train import loop

    t0 = time.perf_counter()
    esg = shard_rel_graph(graph, N_SHARDS)
    shard_s = time.perf_counter() - t0
    params = rgcn.init_params(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    for _, p in named_leaves(params):
        p.requires_grad_(True)
    return (esg, shard_s, make_mesh(N_SHARDS, dev), params,
            loop.edges_with_sentinel(edges, dev))


def phase_edge_grad(graph, cfg, edges, dev, label="edge_grad",
                    f32_run=None):
    """One edge-sharded step (4 shards on the card, encoder dropout 0.5 and
    decoder dropout 0.1 with their masks given) on given candidates,
    through B1 (2 launches per layer and (shard, relation) chunk with real
    edges), against the same step through B1's plain version and against
    the full-graph step (``loss_from_candidates``) on the same candidates
    and masks: the loss within rtol 1e-5 and every gradient at the ``grad``
    criterion. SGD at lr 0 leaves each run's gradient in ``.grad``.

    At ``cfg.compute_dtype`` bf16 (``edge_bf16``, ``f32_run`` the float32
    step on the same inputs): every B1 launch a bf16 one, the plain run
    swapping B1 for its plain version inside ``GatherSegmentSum``
    (``b1_plain``), the gradients within 1e-2 of each largest magnitude and
    the losses within 1e-3 of the plain run's, each gradient within 5e-2 in
    norm of the float32 edge step's and of the bf16 full-graph step's (the
    edge layer rounds each partial to bf16, the full-graph one sums in
    float32: the same function at other rounding points). Returns (largest
    error, the kernel run)."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.config import TrainConfig
    from primekg_rgcn_tpu_torch.ops.rgcn_segment import (aggregate,
                                                         aggregate_plain)
    from primekg_rgcn_tpu_torch.parallel.edge_shard import (
        build_sharded_train_step)
    from primekg_rgcn_tpu_torch.train import loop

    bf16 = cfg.compute_dtype == "bfloat16"
    esg, shard_s, mesh, params, edges_pad = edge_setup(graph, cfg, edges,
                                                       dev)
    leaves = list(named_leaves(params))
    tcfg = TrainConfig(optimizer="sgd", lr=0.0, grad_clip=0.0)
    opt = loop.make_optimizer(tcfg, params)
    steps = {"kernel": build_sharded_train_step(mesh, esg, cfg, tcfg),
             "plain": build_sharded_train_step(
                 mesh, esg, cfg, tcfg,
                 agg_fn=aggregate if bf16 else aggregate_plain)}
    idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, edges.shape[0], 1024)).to(dev)
    gen = torch.Generator(dev).manual_seed(0)
    cands = steps["kernel"].draw(node_batch(edges_pad, idx), gen)
    enc_mask = torch.rand(graph.num_nodes, cfg.hidden_dim, generator=gen,
                          device=dev) < 1.0 - cfg.dropout
    dec = [torch.rand(c[2].shape[0], cfg.hidden_dim, generator=gen,
                      device=dev) < 1.0 - cfg.decoder_dropout
           for c in cands[0]]
    runs = {}
    for name, step in steps.items():
        reset_counts()
        with b1_plain() if bf16 and name == "plain" else \
                contextlib.nullcontext():
            stats = step.update(params, opt, cands, enc_masks=[enc_mask],
                                dec_masks=[dec])
        torch.cuda.synchronize()
        runs[name] = dict(loss=float(stats[0] / stats[2]),
                          grads={k: p.grad.clone() for k, p in leaves},
                          counts=read_counts(),
                          bf16_counts=read_bf16_counts())
    opt.zero_grad(set_to_none=True)
    full = tuple(torch.cat([c[i] for c in cands[0]]) for i in range(5))
    loss, _ = loop.loss_from_candidates(params, graph, *full, cfg,
                                        train=True, enc_mask=enc_mask,
                                        dec_mask=torch.cat(dec))
    loss.backward()
    torch.cuda.synchronize()
    runs["full_graph"] = dict(loss=loss.item(),
                              grads={k: p.grad.clone() for k, p in leaves})
    opt.zero_grad(set_to_none=True)
    want = edge_launches(esg)
    if runs["kernel"]["counts"] != want or \
            any(runs["plain"]["counts"].values()):
        raise AssertionError(
            f"{label} launches: kernel {runs['kernel']['counts']}, plain "
            f"{runs['plain']['counts']}; expected {want} and none")
    if bf16:
        only_bf16(label, runs["kernel"]["counts"],
                  runs["kernel"]["bf16_counts"])
    if not np.isfinite(runs["kernel"]["loss"]):
        raise AssertionError(f"{label}: non-finite loss")
    out, max_err = {}, 0.0
    for ref in ("plain", "full_graph"):
        got_loss, want_loss = runs["kernel"]["loss"], runs[ref]["loss"]
        per_leaf = {}
        if bf16 and ref == "full_graph":
            for k, want_g in runs[ref]["grads"].items():
                per_leaf[k] = {"norm_rel": norm_rel(
                    runs["kernel"]["grads"][k], want_g, f"{label}/{ref}/{k}")}
            out[ref] = dict(loss=want_loss, leaves=per_leaf)
            continue
        np.testing.assert_allclose(got_loss, want_loss,
                                   rtol=1e-3 if bf16 else 1e-5)
        for k, want_g in runs[ref]["grads"].items():
            got = runs["kernel"]["grads"][k]
            err = (close_rel(got, want_g, 1e-2, f"{label}/{ref}/{k}")
                   * float(want_g.abs().max()) if bf16 else
                   close_scaled(got, want_g, f"{label}/{ref}/{k}"))
            max_err = max(max_err, err)
            per_leaf[k] = {"max_abs_err": err,
                           "max_abs": float(want_g.abs().max())}
        out[ref] = dict(loss=want_loss, leaves=per_leaf)
    if bf16:
        out["float32_edge_step"] = dict(loss=f32_run["loss"], leaves={
            k: {"norm_rel": norm_rel(runs["kernel"]["grads"][k], want_g,
                                     f"{label}/float32/{k}")}
            for k, want_g in f32_run["grads"].items()})
    emit(label, shards=N_SHARDS, shard_s=shard_s,
         local_edges=esg.src.shape[1], loss_kernel=runs["kernel"]["loss"],
         launches=runs["kernel"]["counts"],
         launches_bf16=runs["kernel"]["bf16_counts"], against=out)
    return max_err, runs["kernel"]


def norm_rel(got, want, name, limit=5e-2):
    """||got - want|| / ||want||, which must stay within ``limit``."""
    rel = float((got.float() - want.float()).norm()
                / want.float().norm().clamp(min=1e-30))
    if rel > limit:
        raise AssertionError(f"{name}: differs by {rel:.3g} in norm, more "
                             f"than {limit}")
    return rel


def phase_edge_train(graph, cfg, edges, dev, tmp, steps=30,
                     label="edge_train"):
    """``build_sharded_train_step`` over 4 edge shards at batch 1024, adam,
    clip 1.0, dropout 0.5: a fresh host batch each step (pinned copy), 3
    warm-up then ``steps`` timed steps on the host clock, the B1 launches
    asserted (``edge_launches``), peak memory, a 10-step profile, and
    ``step_twice_equal``, which must hold: B1 and the shard-order sum are
    deterministic. Returns the launches and the figures."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.config import TrainConfig
    from primekg_rgcn_tpu_torch.parallel.edge_shard import (
        build_sharded_train_step)
    from primekg_rgcn_tpu_torch.train import loop
    from primekg_rgcn_tpu_torch.utils.telemetry import (profile_trace,
                                                        trace_breakdown)

    tcfg = TrainConfig(batch_size=1024)
    esg, shard_s, mesh, params, edges_pad = edge_setup(graph, cfg, edges,
                                                       dev)
    t0 = time.perf_counter()
    step = build_sharded_train_step(mesh, esg, cfg, tcfg)
    build_s = time.perf_counter() - t0
    opt = loop.make_optimizer(tcfg, params)
    gen = torch.Generator(dev).manual_seed(0)
    rng = np.random.default_rng(0)

    def one():
        idx = torch.from_numpy(rng.integers(0, edges.shape[0],
                                            tcfg.batch_size))
        idx = idx.pin_memory().to(dev, non_blocking=True)
        return step(params, opt, node_batch(edges_pad, idx), gen)

    first = one()
    for _ in range(2):
        one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        last = one()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    counts = read_counts()
    want = {k: v * steps for k, v in edge_launches(esg).items()}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    losses = [float(first[0] / first[2]), float(last[0] / last[2])]
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    batch = node_batch(edges_pad, torch.from_numpy(rng.integers(
        0, edges.shape[0], tcfg.batch_size)).to(dev))
    twice = step_twice_equal(step, params, opt, batch, dev)
    if not twice:
        raise AssertionError(f"{label}: two runs of one step from one state "
                             f"differ")
    result = dict(steps=steps, batch_size=tcfg.batch_size, shards=N_SHARDS,
                  shard_s=shard_s, build_s=build_s, step_ms=step_ms,
                  train_edges_per_s=tcfg.batch_size / step_ms * 1e3,
                  launches=counts,
                  launches_per_step={k: v / steps for k, v in counts.items()},
                  peak_memory_mb=torch.cuda.max_memory_allocated() / 2 ** 20,
                  first_loss=losses[0], last_loss=losses[1],
                  step_twice_equal=twice)
    prof_steps = 10
    torch.cuda.synchronize()
    with profile_trace(tmp / f"{label}_profile"):
        t0 = time.perf_counter()
        for _ in range(prof_steps):
            one()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) / prof_steps * 1e3
    bd = trace_breakdown(tmp / f"{label}_profile" / "trace.json")
    if bd is None:
        result["idle_share"] = "not measured"
    else:
        busy_ms = bd["busy_us"] / prof_steps / 1e3
        result.update(step_ms_under_profiler=prof_ms,
                      device_busy_ms_per_step=busy_ms,
                      idle_share=bd["idle_share"],
                      idle_share_two_windows=1.0 - busy_ms / step_ms,
                      us_by_kind=bd["us_by_kind"])
    emit(label, **result)
    return counts, result


def phase_edge_cli(tmp):
    """``train.cli.main --shard edge --n_devices 4
    --gradient_accumulation_steps 2`` at synthetic scale 0.1 for 2 epochs
    (B1 launches, no B4), then ``evaluate.cli.main`` on its best model.
    Returns the training's and the evaluation's launches."""
    import numpy as np

    from primekg_rgcn_tpu_torch.train import cli as train_cli

    out = tmp / "edge_cli"
    reset_counts()
    t0 = time.perf_counter()
    result = train_cli.main([
        "--synthetic", "--synthetic_scale", "0.1", "--epochs", "2",
        "--seed", "0", "--device", "cuda", "--shard", "edge",
        "--n_devices", str(N_SHARDS), "--gradient_accumulation_steps", "2",
        "--output_dir", str(out)])
    seconds = time.perf_counter() - t0
    counts = read_counts()
    hist = result["history"]
    problems = []
    if not np.all(np.isfinite(hist["train_losses"] + hist["val_losses"])):
        problems.append(f"losses {hist}")
    for f in ("best_model.pt", "final_model.pt"):
        if not (out / "models" / f).exists():
            problems.append(f"missing models/{f}")
    if counts["B1"] == 0 or counts["B4"] or counts["B2"]:
        problems.append(f"launches {counts}")
    if problems:
        raise AssertionError("edge_cli: " + "; ".join(problems))
    emit("edge_cli", seconds=seconds, launches=counts, history=hist,
         epoch_time_s=result["epoch_times_s"])
    return counts, eval_cli_after(out, "edge_cli", model="best_model.pt")


def phase_full_kg_node_serve(graph, psg, dev):
    """The node-sharded encode on config 3's graph (``uniform_caps`` at R =
    30, so the relation scan's forward) against the dense encode, at rtol
    2e-4 with atol 2e-4 of the largest magnitude; one encode's launches
    (``node_launches``); then the sharded top-10 of 8 heads against the
    dense top-10, ids equal where the scores are untied. Returns the
    encode's launches."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.config import ModelConfig
    from primekg_rgcn_tpu_torch.evaluate.sharded_ranking import (
        build_sharded_topk)
    from primekg_rgcn_tpu_torch.models import rgcn
    from primekg_rgcn_tpu_torch.ops.distmult import distmult_score_all_tails
    from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh
    from primekg_rgcn_tpu_torch.parallel.node_shard import (
        build_node_sharded_forward)

    cfg = ModelConfig(num_nodes=graph.num_nodes,
                      num_relations=graph.num_relations)
    params = rgcn.init_params(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    mesh = make_mesh(N_SHARDS, dev)
    encode = build_node_sharded_forward(mesh, psg, cfg, gather=False)
    k = 10
    heads = torch.arange(0, graph.num_nodes, graph.num_nodes // 8,
                         device=dev)[:8]
    rels = torch.arange(8, device=dev) % graph.num_relations
    with torch.no_grad():
        reset_counts()
        emb_dm = encode(params)
        torch.cuda.synchronize()
        counts = read_counts()
        dense = rgcn.get_embeddings(params, graph, cfg)
        got = emb_dm.reshape(-1, cfg.hidden_dim)[:graph.num_nodes]
        top = float(dense.abs().max())
        torch.testing.assert_close(got, dense, rtol=2e-4, atol=2e-4 * top,
                                   msg=lambda m: f"full_kg_node_serve: {m}")
        rel_emb = params["decoder"]["rel_emb"]
        s_i = build_sharded_topk(mesh, emb_dm, rel_emb, graph.num_nodes,
                                 k)(heads, rels)
        ref = torch.topk(distmult_score_all_tails(
            dense[heads], rel_emb[rels], dense), k, dim=1)
        encode_ms = host_ms(lambda: encode(params), reps=5)
    if counts != node_launches(psg, step=False):
        raise AssertionError(f"full_kg_node_serve: launches {counts}, "
                             f"expected {node_launches(psg, step=False)}")
    exact = [untied_ids_equal(*(a[q].cpu().numpy() for a in (
        s_i[0], s_i[1], ref.values, ref.indices))) for q in range(8)]
    emit("full_kg_node_serve", shards=N_SHARDS, scan=psg.uniform_caps,
         launches=counts,
         max_abs_err=float((got - dense).abs().max()), max_abs=top,
         queries=8, topk=k, ids_equal_dense_exactly=all(exact),
         encode_ms=encode_ms)
    return counts


EVAL_KEYS = {
    "classification": {"auc_roc", "auc_pr", "precision", "recall",
                       "f1_score", "threshold"},
    "ranking": {"mrr", "mean_rank", "median_rank", "hits@10", "hits@50"},
}
RANKING_BLOCKS = ("ranking", "ranking_filtered", "ranking_head",
                  "ranking_both", "ranking_filtered_head",
                  "ranking_filtered_both")
MODEL_INFO_KEYS = {"checkpoint_path", "epoch", "num_nodes", "num_relations",
                   "embedding_dim", "hidden_dim", "num_parameters",
                   "best_val_loss", "best_val_acc"}


def eval_cli_after(out, label, *extra, model="final_model.pt"):
    """``evaluate.cli.main`` on a CLI phase's ``model`` (its final one by
    default) and synthetic data; AUC-ROC and MRR must be finite (2 epochs
    at scale 0.1 is a smoke run, so no value is asserted). Returns the
    launches of the call."""
    import numpy as np

    from primekg_rgcn_tpu_torch.evaluate import cli as eval_cli

    reset_counts()
    t0 = time.perf_counter()
    m = eval_cli.main([
        "--model_path", str(out / "models" / model),
        "--data_dir", str(out / "synthetic_data"),
        "--output_dir", str(out / "eval"), "--device", "cuda", *extra])
    seconds = time.perf_counter() - t0
    counts = read_counts()
    auc, mrr = m["classification"]["auc_roc"], m["ranking"]["mrr"]
    if not (np.isfinite(auc) and np.isfinite(mrr)) or counts["B1"] == 0:
        raise AssertionError(f"eval_cli after {label}: auc {auc}, mrr {mrr}, "
                             f"launches {counts}")
    emit("eval_cli", after=label, seconds=seconds, auc_roc=auc, mrr=mrr,
         test_edges=m["test_edges"], launches=counts)
    return counts


def check_results_json(path, num_nodes, blocks):
    """results.json holds every contract key with finite values in range."""
    import math

    blob = json.loads(path.read_text())
    m = blob["metrics"]
    problems = []
    if set(blob["model_info"]) != MODEL_INFO_KEYS:
        problems.append(f"model_info keys {sorted(blob['model_info'])}")
    want = {"classification", "test_edges", "num_nodes", *blocks}
    if set(m) != want:
        problems.append(f"metrics keys {sorted(m)}")
    if m.get("num_nodes") != num_nodes or not m.get("test_edges", 0) > 0:
        problems.append(f"num_nodes {m.get('num_nodes')}, test_edges "
                        f"{m.get('test_edges')}")
    cls = m.get("classification", {})
    if set(cls) != EVAL_KEYS["classification"] or not all(
            math.isfinite(v) and 0 <= v <= 1 for v in cls.values()):
        problems.append(f"classification {cls}")
    for b in blocks:
        r = m.get(b, {})
        ok = (set(r) == EVAL_KEYS["ranking"]
              and all(math.isfinite(v) for v in r.values())
              and 0 < r["mrr"] <= 1
              and 1 <= r["mean_rank"] <= num_nodes
              and 1 <= r["median_rank"] <= num_nodes
              and all(0 <= r[k] <= 1 for k in ("hits@10", "hits@50")))
        if not ok:
            problems.append(f"{b} {r}")
    if not (path.parent / "metrics_summary.txt").exists():
        problems.append("no metrics_summary.txt")
    if problems:
        raise AssertionError(f"{path}: " + "; ".join(problems))


def untied_queries(emb, rel_emb, edges, rel_tol=1e-5, batch=1024):
    """Mask of queries (rows of ``edges``, (head, tail, rel) on the card)
    whose true tail's score is more than ``rel_tol`` x the row's largest
    |score| away from every other candidate's, in float64: the queries
    whose rank no rounding of the encode can move."""
    import torch

    emb64, rel64 = emb.double(), rel_emb.double()
    masks = []
    for s in range(0, edges.shape[0], batch):
        e = edges[s:s + batch]
        sc = (emb64[e[:, 0]] * rel64[e[:, 2]]) @ emb64.T
        true = sc.gather(1, e[:, 1:2])
        gap = (sc - true).abs().scatter_(1, e[:, 1:2], torch.inf)
        masks.append(gap.min(dim=1).values
                     > rel_tol * sc.abs().max(dim=1).values)
    return torch.cat(masks).cpu().numpy()


def compare_ranks(name, got, want, untied):
    """Ranks equal on every untied query; the counts beside."""
    import numpy as np

    if not np.array_equal(got[untied], want[untied]):
        bad = int((got[untied] != want[untied]).sum())
        raise AssertionError(f"{name}: {bad} untied queries rank apart")
    return {"queries": int(len(got)), "near_tied": int((~untied).sum()),
            "ranks_differ": int((got != want).sum())}


def heldout_test_split(raw):
    """The test split that ``train/cli._load_graphs`` holds out of a
    synthetic graph at seed 0: half of 2/7 of the drug-gene rows, drawn
    before bidirecting, then bidirected."""
    import numpy as np

    from primekg_rgcn_tpu_torch.data import synthetic

    dg_rows = np.flatnonzero(raw["rel"] == 0)
    heldout = np.random.default_rng(0).choice(
        dg_rows, size=max(2 * (len(dg_rows) // 7), 2), replace=False)
    rows = heldout[len(heldout) // 2:]
    s, t, r = synthetic.bidirect(raw["src"][rows], raw["dst"][rows],
                                 raw["rel"][rows])
    return {"edge_index": np.stack([s, t]), "edge_type": r,
            "num_nodes": raw["num_nodes"], "num_relations": 3}


def check_untied_metrics(name, ranks, k_values):
    """Every ranking metric recomputed over the untied queries alone, from
    each side's ranks ({block: (got ranks, want ranks, untied mask)}),
    within 1e-5; returns the largest difference. Over all queries the
    near-tied ones may rank apart and move a metric further."""
    from primekg_rgcn_tpu_torch.evaluate.metrics import (
        ranking_metrics_from_ranks)

    worst = 0.0
    for block, (a, b, keep) in ranks.items():
        got = ranking_metrics_from_ranks(a[keep], k_values)
        want = ranking_metrics_from_ranks(b[keep], k_values)
        for k, v in want.items():
            err = abs(got[k] - v)
            worst = max(worst, err)
            if err > 1e-5:
                raise AssertionError(f"{name}: {block}/{k} over the untied "
                                     f"queries {got[k]} vs {v}")
    return worst


def max_metric_diff(got, want, blocks):
    """The largest difference of any ranking metric over all queries."""
    return max(abs(got[b][k] - v) for b in blocks for k, v in want[b].items())


def phase_eval(tmp, data, raw, params, cfg, graph, dev, plain_layer):
    """``evaluate.cli.main --filtered --rank_direction both`` on the card at
    full width over the full-size graph (``data`` holds it and the model),
    with the train CLI's drug-gene hold-out as its test split: 6 B1
    launches (one encode whatever the number of batches), every
    results.json key finite and in range, TF32 off; then the same
    evaluation through the kernel and through the plain version on the
    card, with the same negatives (the default generator, seed 42, on this
    device): probabilities within rtol 1e-4, the classification metrics
    within 1e-5, ranks equal on the untied queries and every ranking metric
    over those queries within 1e-5; then the encode and one ranking batch
    timed."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.config import EvalConfig
    from primekg_rgcn_tpu_torch.data import artifacts
    from primekg_rgcn_tpu_torch.evaluate import cli as eval_cli
    from primekg_rgcn_tpu_torch.evaluate.evaluator import Evaluator
    from primekg_rgcn_tpu_torch.models.rgcn import encoder_apply
    from primekg_rgcn_tpu_torch.ops.distmult import distmult_score_all_tails

    root = tmp / "eval"
    artifacts.save_split_npz(data / "test_data.npz", heldout_test_split(raw))
    ds = artifacts.load_dataset(data, require_train=False)
    test_edges = artifacts.split_to_edges(ds["test"])
    known = artifacts.split_to_edges(ds["full"])
    argv = ["--model_path", str(data / "model.pt"), "--data_dir", str(data),
            "--device", "cuda"]

    def tf32_off(when):
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.get_float32_matmul_precision() != "highest"):
            raise AssertionError(f"eval: TF32 matmuls are on {when}")

    tf32_off("before the CLI")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    cli_m = eval_cli.main([*argv, "--output_dir", str(root / "results"),
                           "--filtered", "--rank_direction", "both"])
    seconds = time.perf_counter() - t0
    counts = read_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    tf32_off("after the CLI")
    if counts != {"B1": 6, "B2": 0, "B3": 0, "B4": 0}:
        raise AssertionError(f"eval: launches {counts}, expected 6 B1")
    check_results_json(root / "results" / "results.json", graph.num_nodes,
                       RANKING_BLOCKS)

    ecfg = EvalConfig(seed=42)  # the CLI's defaults
    ev = Evaluator(params, cfg, graph, test_edges, ecfg)
    ref = Evaluator(params, cfg, graph, test_edges, ecfg,
                    layer_fn=plain_layer)
    got = ev.evaluate(known_triples=known, rank_direction="both")
    want = ref.evaluate(known_triples=known, rank_direction="both")
    if got != cli_m:
        raise AssertionError("eval: the CLI's metrics differ from its "
                             "Evaluator's")
    np.testing.assert_array_equal(ev.labels, ref.labels)
    np.testing.assert_allclose(ev.scores, ref.scores, rtol=1e-4, atol=0)
    prob_err = float(np.abs(ev.scores - ref.scores).max())
    edges = torch.as_tensor(test_edges, dtype=torch.long, device=dev)
    rank_stats, untied, ranks = {}, {}, {}
    for d, e in (("tail", edges), ("head", edges[:, [1, 0, 2]])):
        untied[d] = untied_queries(ref._node_emb, ref._rel_emb, e)
        suffix = "" if d == "tail" else "_head"
        ranks["ranking" + suffix] = (ev._raw_ranks[(d, False)],
                                     ref._raw_ranks[(d, False)], untied[d])
        ranks["ranking_filtered" + suffix] = (ev._filtered_ranks(known, d),
                                              ref._filtered_ranks(known, d),
                                              untied[d])
        for block in ("ranking" + suffix, "ranking_filtered" + suffix):
            rank_stats[block] = compare_ranks(f"eval {block}", *ranks[block])
    for block in ("ranking", "ranking_filtered"):
        head = block + "_head"
        ranks[block + "_both"] = tuple(
            np.concatenate([ranks[block][i], ranks[head][i]])
            for i in range(3))
    cls_err = max(abs(got["classification"][k] - v)
                  for k, v in want["classification"].items())
    if cls_err > 1e-5:
        raise AssertionError(f"eval: classification {got['classification']}"
                             f" vs plain {want['classification']}")
    rank_err = check_untied_metrics("eval", ranks, ecfg.k_values)
    rank_diff = max_metric_diff(got, want, ranks)

    b = ecfg.batch_size
    h, r, t = edges[:b, 0], edges[:b, 2], edges[:b, 1]
    filt = torch.as_tensor(ev._filter_lists(known)[:b], dtype=torch.long,
                           device=dev)
    with torch.no_grad():
        times = time_calls({
            "encode": lambda: encoder_apply(params, graph, cfg),
            "plain_encode": lambda: encoder_apply(params, graph, cfg,
                                                  layer_fn=plain_layer),
            "rank_batch": lambda: ev._rank_batch(h, r, t),
            "score_batch": lambda: distmult_score_all_tails(
                ev._node_emb[h], ev._rel_emb[r], ev._node_emb),
            "rank_filtered_batch": lambda: ev._rank_filtered_impl(
                h, r, t, filt)})
    # Least time of a ranking batch: the [B, D] x [D, N] product at the
    # float32 peak, or its table read and rank write at the HBM rate.
    n, d = ev._node_emb.shape
    rank_bound_ms = max(2 * b * d * n / F32_FLOPS,
                        (n * d + b * 2 * d) * 4 / HBM_BYTES_PER_S) * 1e3
    emit("eval", nodes=graph.num_nodes, test_edges=int(len(test_edges)),
         known_triples=int(len(known)), filter_width=int(filt.shape[1]),
         batch_size=b, batches=-(-len(test_edges) // b), launches=counts,
         seconds=seconds, peak_memory_mb=peak_mb,
         tf32=False, auc_roc=cli_m["classification"]["auc_roc"],
         mrr=cli_m["ranking"]["mrr"],
         mrr_filtered=cli_m["ranking_filtered"]["mrr"],
         max_prob_err=prob_err, max_classification_err=cls_err,
         max_untied_metric_err=rank_err, max_metric_diff_all=rank_diff,
         ranks=rank_stats,
         encode_ms=times["encode_ms"],
         encode_call_ms=times["encode_call_ms"],
         plain_encode_ms=times["plain_encode_ms"],
         rank_ms_per_batch=times["rank_batch_ms"],
         rank_call_ms_per_batch=times["rank_batch_call_ms"],
         score_ms_per_batch=times["score_batch_ms"],
         rank_bound_ms=rank_bound_ms,
         rank_filtered_ms_per_batch=times["rank_filtered_batch_ms"])
    return dict(argv=argv, root=root, ev=ev, untied=untied, metrics=cli_m,
                test_edges=test_edges, ecfg=ecfg, counts=counts)


def phase_node_eval(ctx, params, cfg, graph, psg, dev):
    """``evaluate.cli.main --shard node --n_devices 4 --rank_direction
    both`` from the same checkpoint and data: the launches of one sharded
    encode (30 B1, 2 B4 on this graph), ranks equal to the eval phase's on
    the untied queries and every ranking metric over those queries within
    1e-5 of its; the sharded encode timed."""
    import numpy as np

    import torch

    from primekg_rgcn_tpu_torch.evaluate import cli as eval_cli
    from primekg_rgcn_tpu_torch.evaluate.evaluator import Evaluator
    from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh
    from primekg_rgcn_tpu_torch.parallel.node_shard import (
        build_node_sharded_forward)

    reset_counts()
    t0 = time.perf_counter()
    m = eval_cli.main([*ctx["argv"], "--output_dir",
                       str(ctx["root"] / "results_node"), "--rank_direction",
                       "both", "--shard", "node", "--n_devices",
                       str(N_SHARDS)])
    seconds = time.perf_counter() - t0
    counts = read_counts()
    want = node_launches(psg, step=False)
    if counts != want or (counts["B1"], counts["B4"]) != (30, 2):
        raise AssertionError(f"node_eval: launches {counts}, expected "
                             f"{want}")
    blocks = ("ranking", "ranking_head", "ranking_both")
    check_results_json(ctx["root"] / "results_node" / "results.json",
                       graph.num_nodes, blocks)
    node = Evaluator(params, cfg, graph, ctx["test_edges"], ctx["ecfg"],
                     shard_encode="node", n_shards=N_SHARDS)
    rank_stats, ranks = {}, {}
    for d, block in (("tail", "ranking"), ("head", "ranking_head")):
        ranks[block] = (node._compute_raw_ranks(direction=d),
                        ctx["ev"]._raw_ranks[(d, False)], ctx["untied"][d])
        rank_stats[block] = compare_ranks(f"node_eval {block}",
                                          *ranks[block])
    ranks["ranking_both"] = tuple(
        np.concatenate([ranks["ranking"][i], ranks["ranking_head"][i]])
        for i in range(3))
    if node.evaluate(rank_direction="both") != m:
        raise AssertionError("node_eval: the CLI's metrics differ from its "
                             "Evaluator's")
    metric_err = check_untied_metrics("node_eval", ranks,
                                      ctx["ecfg"].k_values)
    metric_diff = max_metric_diff(m, ctx["metrics"], ranks)
    encode = build_node_sharded_forward(make_mesh(N_SHARDS, dev), psg, cfg,
                                        gather=False)
    with torch.no_grad():
        times = time_calls({"encode": lambda: encode(params)})
    emit("node_eval", shards=N_SHARDS, launches=counts, seconds=seconds,
         auc_roc=m["classification"]["auc_roc"], mrr=m["ranking"]["mrr"],
         max_untied_metric_err_vs_dense=metric_err,
         max_metric_diff_all_vs_dense=metric_diff, ranks=rank_stats,
         encode_ms=times["encode_ms"],
         encode_call_ms=times["encode_call_ms"])
    return counts


ANALYSES = ("evaluate", "error_analysis", "case_studies", "embeddings",
            "explanations", "validation", "comparison", "failures")
UNIT_SCORES = {"score", "prediction_score", "validation_score", "auc_roc",
               "avg_precision", "mrr"}


class SearchTimeout(Exception):
    pass


def unpruned_paths(ctx, source, target, max_length, max_paths, seconds):
    """``find_paths`` without the distance pruning (the same depth-first
    search over the same CSR, no ``dist``), or None if it takes more than
    ``seconds``."""
    import itertools
    import signal

    from primekg_rgcn_tpu_torch.analyze.core import simple_paths

    def alarm(signum, frame):
        raise SearchTimeout

    indptr, nbrs = ctx.path_index.adjacency
    old = signal.signal(signal.SIGALRM, alarm)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        paths = list(itertools.islice(
            simple_paths(indptr, nbrs, int(source), int(target), max_length),
            max(max_paths * 5, 1)))
    except SearchTimeout:
        return None
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
    paths.sort(key=len)
    return paths[:max_paths]


def plain_silhouette(x, labels, chunk=1024):
    """The mean silhouette by ``torch.cdist`` in float64 and a mask per
    cluster: the plain recomputation ``embed_tools.silhouette`` is held
    against."""
    import torch

    x = x.double()
    labels = torch.as_tensor(labels, device=x.device)
    ks = torch.unique(labels)
    sizes = torch.stack([(labels == k).sum() for k in ks]).double()
    total = 0.0
    for s in range(0, len(x), chunk):
        d = torch.cdist(x[s:s + chunk], x)
        sums = torch.stack([d[:, labels == k].sum(1) for k in ks], 1)
        own = torch.searchsorted(ks, labels[s:s + chunk])
        n_own = sizes[own]
        a = sums.gather(1, own[:, None])[:, 0] / (n_own - 1).clamp(min=1)
        other = sums / sizes
        other.scatter_(1, own[:, None], float("inf"))
        b = other.min(1).values
        sil = torch.where(n_own > 1, (b - a) / torch.maximum(a, b), 0.0)
        total += float(torch.nan_to_num(sil).sum())
    return total / len(x)


def check_tool_outputs(root, num_nodes):
    """Every JSON and CSV file under ``root`` parses; every score column or
    key the tools define in [0, 1] is finite and in range. Returns the
    number of files read."""
    import csv
    import math

    files = 0
    bad = []

    def unit(v, where):
        v = float(v)
        if not (math.isfinite(v) and 0.0 <= v <= 1.0):
            bad.append(f"{where} = {v}")

    def walk(obj, where):
        if isinstance(obj, dict):
            for k, v in obj.items():
                if k in UNIT_SCORES and not isinstance(v, (dict, list)):
                    unit(v, f"{where}/{k}")
                else:
                    walk(v, f"{where}/{k}")
        elif isinstance(obj, list):
            for i, v in enumerate(obj):
                walk(v, f"{where}[{i}]")

    for path in sorted(root.rglob("*.json")):
        files += 1
        blob = json.loads(path.read_text())
        if path.name != "results.json":
            walk(blob, str(path.relative_to(root)))
    for path in sorted(root.rglob("*.csv")):
        files += 1
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
        for i, row in enumerate(rows):
            for k, v in row.items():
                if k in UNIT_SCORES or k.startswith("ev_") or \
                        k.startswith("hits@"):
                    unit(v, f"{path.relative_to(root)}[{i}]/{k}")
    check_results_json(root / "results.json", num_nodes, ("ranking",))
    if bad:
        raise AssertionError("analysis outputs out of [0, 1]: "
                             + "; ".join(bad[:10]))
    return files


def phase_analysis(tmp, data, params, cfg, graph, dev, plain_layer, raw):
    """``analyze.run_full_analysis.main --device cuda``, all eight
    analyses, on the eval phase's data and model: every analysis OK, 12 B1
    launches (the context's encode and the evaluate analysis'), the
    context's embeddings within TOL of an encode through the plain version,
    every JSON and CSV output parsed and its scores in [0, 1]; then
    ``find_paths`` on the case-study and explanation pairs against the same
    search without its pruning (each at most 30 s, at least one must end),
    k-means + silhouette per node type with the silhouette against a plain
    recomputation within 1e-5, and the times of t-SNE at 5,000 points, of
    k-means + silhouette per type and of ``find_paths`` per pair."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.analyze import core, embed_tools
    from primekg_rgcn_tpu_torch.analyze import run_full_analysis
    from primekg_rgcn_tpu_torch.models.rgcn import encoder_apply

    out = tmp / "analysis"
    tr = raw["type_ranges"]
    pairs = [("synthetic drug 1", "synthetic disease 0"),
             ("synthetic drug 2000", "synthetic disease 100")]
    explain = [a for d, s in pairs for a in ("--explain", d, s)]
    made = []
    init = core.AnalysisContext.__init__

    def capture(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    core.AnalysisContext.__init__ = capture
    reset_counts()
    t0 = time.perf_counter()
    try:
        results = run_full_analysis.main([
            "--model_path", str(data / "model.pt"), "--data_dir", str(data),
            "--output_dir", str(out), "--device", "cuda", "--diseases",
            "synthetic disease 0", "synthetic disease 100", *explain])
    finally:
        core.AnalysisContext.__init__ = init
    seconds = time.perf_counter() - t0
    counts = read_counts()
    status = {k: r["success"] for k, r in results.items()}
    if status != {k: True for k in ANALYSES}:
        raise AssertionError(f"analysis: {status}")
    if counts != {"B1": 12, "B2": 0, "B3": 0, "B4": 0}:
        raise AssertionError(f"analysis: launches {counts}, expected 12 B1")
    if len(made) != 1:
        raise AssertionError(f"analysis: {len(made)} contexts")
    ctx = made[0]
    with torch.no_grad():
        want = encoder_apply(params, graph, cfg, layer_fn=plain_layer).cpu()
    got = torch.from_numpy(ctx.embeddings)
    torch.testing.assert_close(got, want, **TOL)
    emb_err = float((got - want).abs().max())
    n_files = check_tool_outputs(out, graph.num_nodes)
    summary = (out / "analysis_summary.txt").read_text().splitlines()
    if [ln.split("\t")[:2] for ln in summary] != [[k, "OK"] for k in ANALYSES]:
        raise AssertionError(f"analysis_summary.txt: {summary}")

    # find_paths: the case studies' (drug, disease) pairs at their
    # max_paths 5 and the explanations' at 20, pruned against unpruned.
    searches = []
    for f in sorted((out / "case_studies").rglob("predictions.json")):
        blob = json.loads(f.read_text())
        searches += [(p["drug_idx"], blob["disease_idx"], 5)
                     for p in blob["predictions"]]
    for drug, disease in pairs:
        searches.append((ctx.find_node(drug, "drug"),
                         ctx.find_node(disease, "disease"), 20))
    path_ms, plain_ms, n_paths = [], [], []
    compared, timed_out, deadline = 0, 0, time.perf_counter() + 60
    for a, b, max_paths in searches:
        t1 = time.perf_counter()
        pruned = ctx.find_paths(a, b, 4, max_paths)
        path_ms.append((time.perf_counter() - t1) * 1e3)
        n_paths.append(len(pruned))
        budget = min(30.0, deadline - time.perf_counter())
        if budget <= 0:
            continue
        t1 = time.perf_counter()
        plain = unpruned_paths(ctx, a, b, 4, max_paths, budget)
        plain_ms.append((time.perf_counter() - t1) * 1e3)
        if plain is None:
            timed_out += 1
        elif plain != pruned:
            raise AssertionError(f"find_paths({a}, {b}): pruned {pruned} "
                                 f"vs unpruned {plain}")
        else:
            compared += 1
    if compared == 0:
        raise AssertionError("find_paths: no unpruned search ended in 30 s")

    # k-means + silhouette per node type, on the card.
    clusters = {}
    for t in ("drug", "disease", "gene/protein"):
        x = ctx.embeddings[ctx.indices_of_type(t)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        labels, _, inertia = embed_tools.kmeans(x, 10, n_init=4, seed=0,
                                                device=dev)
        t2 = time.perf_counter()
        sil = embed_tools.silhouette(x, labels, device=dev)
        t3 = time.perf_counter()
        ref = plain_silhouette(torch.from_numpy(x).to(dev), labels)
        if abs(sil - ref) > 1e-5:
            raise AssertionError(f"silhouette {t}: {sil} vs plain {ref}")
        clusters[t] = dict(n=len(x), inertia=inertia, silhouette=sil,
                           silhouette_err=abs(sil - ref),
                           kmeans_s=t2 - t1, silhouette_s=t3 - t2)
    sample = np.random.default_rng(42).choice(
        graph.num_nodes, min(5000, graph.num_nodes), replace=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    coords = embed_tools.tsne(ctx.embeddings[sample], perplexity=30.0,
                              seed=42, device=dev)
    tsne_s = time.perf_counter() - t1
    if coords.shape != (len(sample), 2) or not np.isfinite(coords).all():
        raise AssertionError(f"tsne: {coords.shape}, finite "
                             f"{np.isfinite(coords).all()}")
    with torch.no_grad():
        times = time_calls({"encode": lambda: encoder_apply(
            ctx.params, graph, ctx.model_cfg)})
    emit("analysis", seconds=seconds, launches=counts,
         duration_s={k: r["duration_s"] for k, r in results.items()},
         encode_ms=times["encode_ms"], encode_call_ms=times["encode_call_ms"],
         max_embedding_err=emb_err, files_checked=n_files,
         find_paths_pairs=len(searches), find_paths_ms=path_ms,
         find_paths_ms_median=statistics.median(path_ms),
         find_paths_found=n_paths, unpruned_ms=plain_ms,
         unpruned_equal=compared, unpruned_timed_out=timed_out,
         tsne_5000_s=tsne_s, clusters=clusters,
         type_sizes={k: int(v[1] - v[0]) for k, v in tr.items()})
    return counts


def phase_export(tmp, data, heads, served, query_ms, dev):
    """``predict_cli.main --export`` from the serve phase's model and data:
    6 B1 launches; then the artifact, loaded by ``load_predictor``, serves
    the serve phase's 8 heads for relations 0-2, its scores within TOL of
    ``predict_cli``'s and its ids equal on untied entries; the exported
    query is timed beside the same query run directly (device time and
    ``call_ms``) and the serve phase's ``query_ms``."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.evaluate import predict_cli
    from primekg_rgcn_tpu_torch.evaluate.export import load_predictor
    from primekg_rgcn_tpu_torch.ops.distmult import distmult_score_all_tails

    topk = len(served[0][0]["predictions"])
    artifact = tmp / "export" / "scorer.pt2"
    reset_counts()
    t0 = time.perf_counter()
    predict_cli.main([
        "--model_path", str(data / "model.pt"), "--data_dir", str(data),
        "--heads", *map(str, heads), "--relation", "0", "--topk", str(topk),
        "--device", "cuda", "--export", str(artifact), "--export_batch",
        str(len(heads))])
    seconds = time.perf_counter() - t0
    counts = read_counts()
    if counts != {"B1": 6, "B2": 0, "B3": 0, "B4": 0}:
        raise AssertionError(f"export: launches {counts}, expected 6 B1")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("export: TF32 matmuls are on")
    predict = load_predictor(artifact)
    q_heads = torch.tensor(heads, device=dev)
    exact, score_err = [], 0.0
    for r in range(3):
        rels = torch.full((len(heads),), r, dtype=torch.long, device=dev)
        with torch.no_grad():
            scores, ids = predict(q_heads, rels)
        scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
        for qi, ref in enumerate(served[r]):
            ref_s = np.array([p["score"] for p in ref["predictions"]])
            ref_i = np.array([p["tail_id"] for p in ref["predictions"]])
            exact.append(untied_ids_equal(scores[qi], ids[qi], ref_s, ref_i))
            score_err = max(score_err, float(np.abs(scores[qi] - ref_s).max()))
    # The exported query and the same query as the serve phase times it,
    # on one encode's embeddings: device time and call_ms of each.
    rels = torch.zeros(len(heads), dtype=torch.long, device=dev)
    emb, rel_emb = predict.node_emb, predict.rel_emb
    with torch.no_grad():
        times = time_calls({
            "exported": lambda: predict(q_heads, rels),
            "direct": lambda: torch.topk(distmult_score_all_tails(
                emb[q_heads], rel_emb[rels], emb), topk, dim=1)})
    emit("export", seconds=seconds, launches=counts,
         artifact_bytes=artifact.stat().st_size, batch=len(heads), topk=topk,
         relations_served=3, max_score_err=score_err,
         ids_equal_served_exactly=all(exact), tf32=False,
         export_query_ms=times["exported_ms"],
         export_query_call_ms=times["exported_call_ms"],
         direct_query_ms=times["direct_ms"],
         direct_query_call_ms=times["direct_call_ms"],
         serve_query_ms=query_ms)
    return counts


# -- BASELINE config 3 (full PrimeKG) and config 4 (it sampled) -------------

FULL_KG_ARRAYS = ("src", "dst", "t_src", "t_dst", "inv_in_deg", "edge_scale",
                  "t_edge_scale", "rowptr", "t_rowptr")
FULL_KG_SIZE = (129375, 30, 4601678, 4609024)


def phase_full_kg_graph(repo):
    """BASELINE config 3's graph, ``primekg_full_like(seed=0, scale=1.0)`` +
    ``bidirect``, built by the C++ builder of ``native/`` (``use_native=
    "always"``) and by numpy (``"never"``): every array equal, both build
    times, the sizes; ``"auto"`` takes the C++ builder at this size.
    Returns the graph (on the CPU) and its directed edges [E, 3]."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch import native
    from primekg_rgcn_tpu_torch.data import graph as pgraph
    from primekg_rgcn_tpu_torch.data import synthetic

    if not native.native_available():
        raise AssertionError("full_kg_graph: the native graph builder did "
                             "not build")
    t0 = time.perf_counter()
    raw = synthetic.primekg_full_like(seed=0, scale=1.0)
    src, dst, rel = synthetic.bidirect(raw["src"], raw["dst"], raw["rel"])
    generate_s = time.perf_counter() - t0
    n, r = raw["num_nodes"], raw["num_relations"]
    built, seconds = {}, {}
    for mode in ("always", "never", "auto"):
        calls = []
        real = native.build_rel_graph_native
        native.build_rel_graph_native = \
            lambda *a, **k: calls.append(1) or real(*a, **k)
        try:
            t0 = time.perf_counter()
            built[mode] = pgraph.build_rel_graph(src, dst, rel, n, r,
                                                 use_native=mode)
            seconds[mode] = time.perf_counter() - t0
        finally:
            native.build_rel_graph_native = real
        if len(calls) != (mode != "never"):
            raise AssertionError(f"full_kg_graph: use_native={mode!r} made "
                                 f"{len(calls)} native builds")
    for mode in ("never", "auto"):
        for name in FULL_KG_ARRAYS:
            a, b = getattr(built["always"], name), getattr(built[mode], name)
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"full_kg_graph: {name} of the native "
                                     f"build differs from use_native={mode!r}")
    g = built["always"]
    size = (g.num_nodes, g.num_relations, g.num_edges, g.padded_num_edges)
    if size != FULL_KG_SIZE:
        raise AssertionError(f"full_kg_graph: size {size}, expected "
                             f"{FULL_KG_SIZE}")
    deg = torch.diff(g.rowptr[:, :n + 1].long(), dim=1)
    buckets = g.bucket_sizes()
    emit("full_kg_graph", nodes=n, relations=r, edges=g.num_edges,
         padded_edges=g.padded_num_edges, norm_mode=g.norm_mode,
         max_in_degree=int(deg.max()), bucket_padded_edges_min=min(buckets),
         bucket_padded_edges_max=max(buckets),
         native_library=str(native.library_path().relative_to(repo)),
         generate_s=generate_s, build_native_s=seconds["always"],
         build_numpy_s=seconds["never"], build_auto_s=seconds["auto"],
         arrays_equal=list(FULL_KG_ARRAYS))
    return g, np.stack([src, dst, rel], 1)


def full_kg_candidates(graph, edges, dev, plan, seed=0):
    """One batch of 1,024 positives and their negatives, as a step draws
    them, from the first seed from ``seed`` on whose batch fits ``plan``
    (about one batch in a hundred overflows it at config 3), so that the
    restricted layer's fast path is the one checked."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.ops import rgcn_final_layer as pfl
    from primekg_rgcn_tpu_torch.train import loop

    edges_pad = loop.edges_with_sentinel(edges, dev)
    for s in range(seed, seed + 10):
        batch_idx = torch.from_numpy(np.random.default_rng(s).integers(
            0, edges.shape[0], 1024)).to(dev)
        gen = torch.Generator(dev).manual_seed(s)
        cands = loop.sample_candidates(edges_pad, batch_idx, graph.num_nodes,
                                       1, generator=gen)
        ns, _, is_dup = pfl.sorted_batch(torch.cat([cands[0], cands[1]]))
        if bool(pfl.batch_ranges(plan, ns, is_dup)[3]):
            return cands
    raise AssertionError("ten batches in a row overflow the plan")


def phase_full_kg_grad(graph_cpu, graph, edges, dev):
    """One config-3 step at full width, dropout off, on given candidates,
    through B1 on the card: with the batch-restricted final layer ("on") and
    with the full one ("off"). Losses within 1e-6 relative, every gradient
    within the ``grad`` criterion (``close_scaled``: rtol 1e-4, atol 1e-4 x
    the tensor's largest magnitude), 2R = 60 and 4R = 120 B1 launches. The
    restricted layer on the card against its plain computation on the CPU
    (the same function on CPU tensors), rows and gradients, at the same
    criterion. One B2 launch (float32, at either dtype) in a restricted
    step, none in a full one. The same steps in bf16: bf16 B1 launches
    only, the restricted step's gradients within 1e-2 of the largest magnitude of the full bf16
    step's and within 5e-2 of the float32 restricted step's in norm
    (``grad_bf16``'s tolerances). Then ``full_kg_overflow``: a plan whose
    capacities are cut to one group takes the fallback; its loss and
    gradients equal the full step's, one fallback counted, 120 launches.
    Returns the largest gradient error of the float32 steps through B1
    (restricted against full, and the fallback)."""
    import dataclasses

    import torch

    from primekg_rgcn_tpu_torch.config import ModelConfig
    from primekg_rgcn_tpu_torch.models import rgcn
    from primekg_rgcn_tpu_torch.ops import rgcn_final_layer as pfl
    from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as ss
    from primekg_rgcn_tpu_torch.ops.rgcn_segment import rgcn_layer_segment
    from primekg_rgcn_tpu_torch.train import loop

    n, r = graph.num_nodes, graph.num_relations
    kern = ss.gather_segment_sum
    cfg = ModelConfig(num_nodes=n, num_relations=r, dropout=0.0)
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    plan = pfl.resolve_final_plan(graph, edges, 1024, 1, seed=42, mode="on")
    params = rgcn.init_params(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    leaves = list(named_leaves(params))
    for _, p in leaves:
        p.requires_grad_(True)
    cands = full_kg_candidates(graph, edges, dev, plan)

    def run(run_cfg, final_plan):
        for _, p in leaves:
            p.grad = None
        reset_counts()
        fallbacks = pfl.final_layer_restricted.fallbacks
        loss, _ = loop.loss_from_candidates(params, graph, *cands, run_cfg,
                                            train=True, final_plan=final_plan)
        loss.backward()
        torch.cuda.synchronize()
        return dict(loss=loss.item(),
                    grads=[p.grad.clone() for _, p in leaves],
                    launches=kern.launches, launches_bf16=kern.launches_bf16,
                    b2=(read_counts()["B2"], read_bf16_counts()["B2"]),
                    fallbacks=pfl.final_layer_restricted.fallbacks
                    - fallbacks)

    def check_launches(label, run_, want, bf16=False, fallbacks=0):
        # The restricted layer's segment-sum: one float32 B2 launch on its
        # fast path, at either dtype; none on the full layer or a fallback.
        b2 = (int(want == 2 * r and not fallbacks), 0)
        got = (run_["launches"], run_["launches_bf16"], run_["b2"],
               run_["fallbacks"])
        expect = (want, want if bf16 else 0, b2, fallbacks)
        if got != expect:
            raise AssertionError(f"{label}: (B1 launches, bf16 launches, "
                                 f"(B2, bf16 B2), fallbacks) {got}, "
                                 f"expected {expect}")

    def compare(label, got, want):
        if abs(got["loss"] - want["loss"]) > 1e-6 * abs(want["loss"]):
            raise AssertionError(f"{label}: loss {got['loss']} against "
                                 f"{want['loss']}")
        per_leaf, max_err = {}, 0.0
        for (name, _), a, b in zip(leaves, got["grads"], want["grads"]):
            err = close_scaled(a, b, f"{label}/{name}")
            max_err = max(max_err, err)
            per_leaf[name] = {"max_abs_err": err,
                              "max_abs": float(b.abs().max())}
        return per_leaf, max_err

    runs = {"on": run(cfg, plan), "off": run(cfg, None)}
    check_launches("full_kg_grad/on", runs["on"], 2 * r)
    check_launches("full_kg_grad/off", runs["off"], 4 * r)
    per_leaf, max_err = compare("full_kg_grad", runs["on"], runs["off"])

    # The restricted layer alone, on the card and on the CPU.
    enc = params["encoder"]
    with torch.no_grad():
        h1 = torch.relu(rgcn_layer_segment(enc["conv1"], enc["node_emb"],
                                           graph))
    h1p = torch.cat([h1, h1.new_zeros(1, h1.shape[1])])
    nodes = torch.cat([cands[0], cands[1]])
    cot = torch.randn(nodes.numel(), cfg.hidden_dim, device=dev,
                      generator=torch.Generator(dev).manual_seed(1))
    plan_cpu = pfl.resolve_final_plan(graph_cpu, edges, 1024, 1, seed=42,
                                      mode="on")
    if plan_cpu.e_cap != plan.e_cap:
        raise AssertionError("full_kg_grad: the CPU plan differs")
    layer_runs = {}
    for where, g, pl in (("card", graph, plan), ("cpu", graph_cpu,
                                                 plan_cpu)):
        conv2 = {k: v.detach().to(g.src.device).requires_grad_(True)
                 for k, v in enc["conv2"].items()}
        x = h1p.detach().to(g.src.device).requires_grad_(True)
        reset_counts()
        t0 = time.perf_counter()
        out = pfl.final_layer_restricted(conv2, x, g, pl,
                                         nodes.to(g.src.device))
        out.backward(cot.to(g.src.device))
        if where == "card":
            torch.cuda.synchronize()
        if read_counts()["B2"] != (where == "card"):
            raise AssertionError(f"full_kg_grad/restricted_layer/{where}: "
                                 f"B2 launches {read_counts()['B2']}")
        layer_runs[where] = dict(
            seconds=time.perf_counter() - t0,
            tensors={"rows": out.detach().cpu(), "h1_pad": x.grad.cpu(),
                     **{k: v.grad.cpu() for k, v in conv2.items()}})
    layer_err = {name: {"max_abs_err": close_scaled(
        layer_runs["card"]["tensors"][name], want,
        f"full_kg_grad/restricted_layer/{name}"),
        "max_abs": float(want.abs().max())}
        for name, want in layer_runs["cpu"]["tensors"].items()}

    # bf16: the restricted and the full step, every B1 launch a bf16 one.
    runs16 = {"on": run(cfg16, plan), "off": run(cfg16, None)}
    check_launches("full_kg_grad_bf16/on", runs16["on"], 2 * r, bf16=True)
    check_launches("full_kg_grad_bf16/off", runs16["off"], 4 * r, bf16=True)
    if abs(runs16["on"]["loss"] - runs16["off"]["loss"]) > \
            1e-3 * abs(runs16["off"]["loss"]):
        raise AssertionError("full_kg_grad_bf16: losses differ")
    vs_full16, vs_f32 = {}, {}
    for i, (name, _) in enumerate(leaves):
        got = runs16["on"]["grads"][i]
        vs_full16[name] = close_rel(got, runs16["off"]["grads"][i], 1e-2,
                                    f"full_kg_grad_bf16/{name}")
        ref = runs["on"]["grads"][i]
        norm_rel = float((got - ref).norm() / ref.norm().clamp(min=1e-30))
        if norm_rel > 5e-2:
            raise AssertionError(f"full_kg_grad_bf16/{name}: differs from "
                                 f"the float32 gradient by {norm_rel:.3g} "
                                 "in norm, more than 5e-2")
        vs_f32[name] = norm_rel
    emit("full_kg_grad", loss_restricted=runs["on"]["loss"],
         loss_full=runs["off"]["loss"],
         launches_restricted=runs["on"]["launches"],
         launches_full=runs["off"]["launches"], e_cap_sum=sum(plan.e_cap),
         leaves=per_leaf, restricted_layer_vs_cpu=layer_err,
         restricted_layer_cpu_s=layer_runs["cpu"]["seconds"],
         bf16=dict(loss_restricted=runs16["on"]["loss"],
                   loss_full=runs16["off"]["loss"],
                   launches_restricted=runs16["on"]["launches_bf16"],
                   launches_full=runs16["off"]["launches_bf16"],
                   max_rel_err_vs_full_bf16=max(vs_full16.values()),
                   norm_rel_vs_float32=vs_f32))
    del runs16

    # The forced overflow: every relation's capacity cut to one group.
    g_ = plan.group
    tiny = dataclasses.replace(
        plan, e_cap=(g_,) * r, cap=torch.full_like(plan.cap, g_),
        cap_start=torch.arange(r, device=dev) * g_)
    over = run(cfg, tiny)
    check_launches("full_kg_overflow", over, 4 * r, fallbacks=1)
    over_leaf, over_err = compare("full_kg_overflow", over, runs["off"])
    emit("full_kg_overflow", e_cap=g_, loss=over["loss"],
         loss_full=runs["off"]["loss"], fallbacks=over["fallbacks"],
         launches=over["launches"],
         max_abs_err=max(v["max_abs_err"] for v in over_leaf.values()))
    return max(max_err, over_err)


def phase_full_kg_train(graph, edges, dev, tmp):
    """Config 3's training step (``train/loop.train_step``, batch 1024, one
    negative, adam, clip 1.0, dropout 0.5) with ``restrict_final="auto"``,
    which must resolve to a plan (the ratio printed), float32 and bf16, and
    with ``"off"``: 3 warm-up and 30 timed steps each, launches asserted
    (2R and 4R B1 a step, 2R more per fallback), fallbacks, peak memory and
    a 10-step profile (``phase_train``). Then the restricted layer's own
    device time against the full final layer's (forward and backward, on
    one step's inputs), and kernel B2 on that step's segment-sum stream (the
    grouped rows by their sorted (relation, node) ids: the restricted
    layer's one B2 launch a step) beside ``index_add_``. Returns the runs'
    figures and the B2 row."""
    import dataclasses

    import torch

    from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
    from primekg_rgcn_tpu_torch.models import rgcn
    from primekg_rgcn_tpu_torch.ops import rgcn_final_layer as pfl
    from primekg_rgcn_tpu_torch.ops.rgcn_segment import rgcn_layer_segment

    n, r = graph.num_nodes, graph.num_relations
    cfg = ModelConfig(num_nodes=n, num_relations=r)
    tcfg = TrainConfig(batch_size=1024)
    plan = pfl.resolve_final_plan(graph, edges, tcfg.batch_size,
                                  tcfg.num_neg_samples, seed=tcfg.seed,
                                  mode=tcfg.restrict_final)
    forced = plan or pfl.resolve_final_plan(
        graph, edges, tcfg.batch_size, tcfg.num_neg_samples, seed=tcfg.seed,
        mode="on")
    ratio = pfl.edge_ratio(graph, forced)
    emit("full_kg_plan", restrict_final=tcfg.restrict_final,
         resolved=plan is not None, edge_ratio=ratio,
         auto_edge_ratio=pfl.AUTO_EDGE_RATIO, e_cap_sum=sum(forced.e_cap),
         e_cap=list(forced.e_cap), group=forced.group)
    if plan is None:
        raise AssertionError(f"full_kg_train: restrict_final='auto' did not "
                             f"resolve to a plan (edge ratio {ratio:.3f})")
    out = {}
    for label, run_cfg, final_plan, per_step in (
            ("full_kg_train_auto", cfg, plan, 2 * r),
            ("full_kg_train_off", cfg, None, 4 * r),
            ("full_kg_train_auto_bf16",
             dataclasses.replace(cfg, compute_dtype="bfloat16"), plan,
             2 * r)):
        launches, breakdown, figures = phase_train(
            graph, run_cfg, edges, dev, tmp, steps=30, label=label,
            final_plan=final_plan, launches_per_step=per_step)
        out[label] = dict(figures, device_busy_ms_per_step=(
            breakdown or {}).get("device_busy_ms_per_step"),
            idle_share=(breakdown or {}).get("idle_share"),
            idle_share_two_windows=(breakdown or {}).get(
                "idle_share_two_windows"))

    # The final layer alone: restricted against full, forward + backward.
    params = rgcn.init_params(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    enc = params["encoder"]
    conv2 = {k: v.requires_grad_(True) for k, v in enc["conv2"].items()}
    with torch.no_grad():
        h1 = torch.relu(rgcn_layer_segment(enc["conv1"], enc["node_emb"],
                                           graph))
    h1p = torch.cat([h1, h1.new_zeros(1, h1.shape[1])])
    x_r, x_f = h1p.requires_grad_(True), h1.clone().requires_grad_(True)
    cands = full_kg_candidates(graph, edges, dev, plan, seed=1)
    nodes = torch.cat([cands[0], cands[1]])
    cot = torch.randn(nodes.numel(), cfg.hidden_dim, device=dev,
                      generator=torch.Generator(dev).manual_seed(2))

    def restricted():
        pfl.final_layer_restricted(conv2, x_r, graph, plan,
                                   nodes).backward(cot)

    def full():
        rgcn_layer_segment(conv2, x_f, graph)[nodes].backward(cot)

    def restricted_forward():
        with torch.no_grad():
            pfl.final_layer_restricted(conv2, x_r, graph, plan, nodes)

    layer_t = time_calls({"restricted_fwd_bwd": restricted,
                          "full_fwd_bwd": full,
                          "restricted_fwd": restricted_forward})
    emit("full_kg_final_layer", nodes=nodes.numel(), **layer_t)

    # B2 on the restricted layer's segment-sum stream, index_add_ beside it.
    ns, _, is_dup = pfl.sorted_batch(nodes)
    start, deg, off, _ = pfl.batch_ranges(plan, ns, is_dup)
    seg, src, scale = pfl.enumerate_slots(graph, plan, start, deg, off)
    with torch.no_grad():
        grp = pfl.GatherGroupSum.apply(h1p, src, scale, plan.group)
    ids = seg[::plan.group].to(torch.int32).contiguous()
    b2_row = b2_stream_row("full_kg_b2_restricted_stream",
                           "restricted_final_layer_stream", grp, ids,
                           r * nodes.numel())
    return out, b2_row


def phase_full_kg_b2_streams(graph, cfg, edges, dev):
    """Config 4's two B2 streams, recorded from one block-mode step over the
    slim CSR (the identity and the dedup backward), each held against its
    plain version, twice ``torch.equal``, and timed beside ``index_add_``
    and the bound (``b2_stream_row``). Returns the rows."""
    from primekg_rgcn_tpu_torch.config import TrainConfig
    from primekg_rgcn_tpu_torch.train.sampled import build_sampled_train_step

    params, _, pos, csrs = sampled_setup(graph, cfg, edges, dev)
    step = build_sampled_train_step(csrs["slim"], cfg, TrainConfig(),
                                    fanouts=(15, 10), mode="block",
                                    device=dev)
    streams = sampled_b2_streams("full_kg_b2_streams", step, params, cfg,
                                 pos, dev)
    return [b2_stream_row("full_kg_b2_streams", name, *streams[key])
            for name, key in (("config4_ident_backward", "ident"),
                              ("config4_dedup_backward", "dedup"))]


def phase_full_kg_trainer(graph, edges, dev, tmp):
    """``Trainer`` for one epoch on the config-3 graph: 46,080 training
    edges (45 steps of 1,024), 4,096 validation edges, ``restrict_final=
    "auto"`` (which must resolve to a plan), validation and best, periodic
    and final checkpoints; B1 launches 2R a step (2R more per fallback) and
    2R for the validation encode, B2 one a step that took the restricted
    layer's fast path; every loss finite. Returns the counts."""
    import numpy as np

    from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
    from primekg_rgcn_tpu_torch.ops import rgcn_final_layer as pfl
    from primekg_rgcn_tpu_torch.train import loop

    n, r = graph.num_nodes, graph.num_relations
    pick = np.random.default_rng(1).permutation(edges.shape[0])
    train_edges, val_edges = edges[pick[:46080]], edges[pick[46080:50176]]
    cfg = ModelConfig(num_nodes=n, num_relations=r)
    tcfg = TrainConfig(epochs=1, batch_size=1024, save_every=1,
                       restrict_final="auto")
    out = tmp / "full_kg_trainer"
    fallbacks = pfl.final_layer_restricted.fallbacks
    reset_counts()
    t0 = time.perf_counter()
    trainer = loop.Trainer(cfg, tcfg, graph, graph, train_edges, val_edges,
                           out, device=dev)
    setup_s = time.perf_counter() - t0
    if trainer.final_plan is None:
        raise AssertionError("full_kg_trainer: restrict_final='auto' did not "
                             "resolve to a plan")
    result = trainer.train()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    fallbacks = pfl.final_layer_restricted.fallbacks - fallbacks
    steps = 45
    want = {"B1": 2 * r * (steps + fallbacks + 1), "B2": steps - fallbacks,
            "B3": 0, "B4": 0}
    if counts != want:
        raise AssertionError(f"full_kg_trainer: launches {counts}, expected "
                             f"{want} ({fallbacks} fallbacks)")
    hist = result["history"]
    losses = hist["train_losses"] + hist["val_losses"]
    if len(hist["train_losses"]) != 1 or not np.all(np.isfinite(losses)):
        raise AssertionError(f"full_kg_trainer: losses {losses}")
    files = ("models/best_model.pt", "models/final_model.pt",
             "checkpoints/checkpoint_epoch_1.pt")
    missing = [f for f in files if not (out / f).exists()]
    if missing:
        raise AssertionError(f"full_kg_trainer: missing {missing}")
    emit("full_kg_trainer", train_edges=len(train_edges),
         val_edges=len(val_edges), steps=steps, fallbacks=fallbacks,
         launches=counts, train_loss=hist["train_losses"][0],
         val_loss=hist["val_losses"][0], epoch_s=result["epoch_times_s"][0],
         setup_s=setup_s, seconds=seconds,
         train_edges_per_s=len(train_edges) / result["epoch_times_s"][0],
         e_cap_sum=sum(trainer.final_plan.e_cap), checkpoints=list(files))
    return counts


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is "
              "False", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    import dataclasses
    import functools

    import numpy as np

    from primekg_rgcn_tpu_torch import native
    from primekg_rgcn_tpu_torch.config import ModelConfig
    from primekg_rgcn_tpu_torch.data import artifacts, synthetic
    from primekg_rgcn_tpu_torch.evaluate import predict_cli
    from primekg_rgcn_tpu_torch.models import rgcn
    from primekg_rgcn_tpu_torch.ops import rgcn_final_layer as pfl
    from primekg_rgcn_tpu_torch.ops.cuda import dense_segment_sum as pds
    from primekg_rgcn_tpu_torch.ops.cuda import halo
    from primekg_rgcn_tpu_torch.ops.cuda import segment_sum as ss
    from primekg_rgcn_tpu_torch.ops.cuda import window_fetch as pwf
    from primekg_rgcn_tpu_torch.ops.distmult import distmult_score_all_tails
    from primekg_rgcn_tpu_torch.ops.rgcn_segment import (aggregate_plain,
                                                         build_layer_agg_ops,
                                                         rgcn_layer_segment)
    from primekg_rgcn_tpu_torch.parallel.node_shard import partition_nodes
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
    # One nvcc per kernel source, all started together, and g++ for the
    # graph builder beside them.
    t0 = time.perf_counter()
    libraries = [ss.LIBRARY, ss.LIBRARY_BF16, pds.LIBRARY, pds.LIBRARY_BF16,
                 pwf.LIBRARY,
                 halo.LIBRARY]
    with concurrent.futures.ThreadPoolExecutor(len(libraries) + 1) as pool:
        graph_builder = pool.submit(native.native_available)
        built = list(pool.map(lambda lib: lib.build(verbose=True), libraries))
        if not graph_builder.result():
            raise AssertionError("the native graph builder did not build")
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         libraries={str(path.relative_to(repo)): [
             ln.strip() for ln in out.splitlines()
             if "registers" in ln or "spill" in ln] for path, out in built},
         graph_builder=str(native.library_path().relative_to(repo)))

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

    def check(name, x, src, rowptr, scale=None, exact=False):
        nonlocal max_err
        with torch.no_grad():
            got = kern(x, src, rowptr, scale)
            want = plain(x, src, rowptr, scale)
        torch.cuda.synchronize()
        if exact and not torch.equal(got, want):
            raise AssertionError(f"{name}: not equal to the plain version on "
                                 f"inputs whose sums are exact")
        torch.testing.assert_close(got, want, **TOL, msg=lambda m: f"{name}: {m}")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        max_err = max(max_err, err)
        return err

    def hub_only(op):
        """The bucket's CSR with every row emptied but its hub row."""
        deg = torch.diff(op.rowptr)
        hub = int(deg[:n].argmax())
        hub_rowptr = torch.zeros_like(op.rowptr)
        hub_rowptr[hub + 1:] = int(deg[hub])
        return (op.src[int(op.rowptr[hub]):int(op.rowptr[hub + 1])]
                .contiguous(), hub_rowptr)

    for layer, x in layer_inputs:
        for r, op in enumerate(ops):
            s = op.rowptr.numel() - 1
            name = f"layer{layer}/bucket{r}"
            err = check(name, x, op.src, op.rowptr)
            twice_equal(name, x, op.src, op.rowptr)
            csr = library_csr(x, op.src, op.rowptr, None)
            hub_src, hub_rowptr = hub_only(op)
            with torch.no_grad():
                torch.testing.assert_close(csr @ x, plain(x, op.src, op.rowptr),
                                           **TOL)
                t = time_calls({
                    "kernel": lambda: ss.launch(x, op.src, op.rowptr),
                    "wrapper": lambda: kern(x, op.src, op.rowptr),
                    "plain": lambda: plain(x, op.src, op.rowptr),
                    "library": lambda: csr @ x,
                    "hub_row_only": lambda: ss.launch(x, hub_src, hub_rowptr)})
            b = bound(x, op.src, op.rowptr, None, s)
            deg = torch.diff(op.rowptr[:n + 1])
            gathered = op.src.numel() * x.shape[1] * 4
            row = dict(shape=name, edges=op.src.numel(), d=x.shape[1],
                       max_in_degree=int(deg.max()),
                       nonempty_rows=int((deg > 0).sum()), **t,
                       gathered_bytes=gathered,
                       gather_tb_per_s=gathered / t["kernel_ms"] / 1e9,
                       bound_us=max(b["byte_ms"], b["op_ms"]) * 1e3,
                       bound_by="bytes" if b["byte_ms"] >= b["op_ms"] else "operations",
                       byte_us=b["byte_ms"] * 1e3, op_us=b["op_ms"] * 1e3,
                       bytes=b["bytes"], max_abs_err=err)
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

    def dyadic(shape, top, gen):
        """Multiples of 1/8 in [0, top / 8]: sums of up to 2**18 products of
        two of them are exact in float32, in any order."""
        return torch.randint(0, top + 1, shape, device=dev,
                             generator=gen).float() / 8

    def csr_case(rows, s, dst, d, scaled, offset=0, exact=False):
        # Positive inputs keep rounding relative to the result: a sum that
        # cancels to near zero would make any absolute tolerance arbitrary.
        gen = torch.Generator(dev).manual_seed(d)
        flat = (dyadic((rows * d + offset,), 7, gen) if exact else
                torch.rand(rows * d + offset, device=dev, generator=gen))
        x = flat[offset:].view(rows, d)
        src = torch.from_numpy(
            rng.integers(0, rows, dst.shape[0]).astype(np.int32)).to(dev)
        rowptr = torch.from_numpy(np.searchsorted(
            dst, np.arange(s + 1)).astype(np.int32)).to(dev)
        sc = None
        if scaled:
            sc = (dyadic((dst.shape[0],), 8, gen) if exact else torch.from_numpy(
                rng.random(dst.shape[0], dtype=np.float32)).to(dev))
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
    # The edge-balanced partition's cases (ops/cuda/segment_sum.piece_plan):
    # a row longer than many pieces; the gene-gene hub row alone; every
    # edge in the last row; rows alternating between empty and one edge;
    # pieces that start and end exactly on row boundaries (each row one
    # piece of items, its edges and its end), and rows one edge longer, so
    # that the boundaries drift through the rows; fewer edges than one piece
    # (no edge at all is empty_csr above). Their inputs are multiples of 1/8 (dyadic), so every sum is exact and
    # the kernel must equal the plain version bit for bit, whatever the
    # order in which the pieces and their carries add up.
    long_dst = np.sort(np.concatenate([rng.integers(0, 1000, 5000),
                                       np.full(200000, 500)]))
    exact = []
    for d in (64, 128):
        exact.append((f"long_row_200000/D{d}",
                      *csr_case(4000, 1000, long_dst, d, d == 128, exact=True)))
    exact.append(("last_row_all_edges/D64", *csr_case(
        4000, 3000, np.full(50000, 2999), 64, False, exact=True)))
    exact.append(("alternating_empty_one/D128", *csr_case(
        4000, 20000, np.arange(0, 20000, 2), 128, True, exact=True)))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows_b = 4000
    per_row = next(k for k in range(1, 4096)
                   if ss.piece_plan(rows_b, rows_b * k, sms)[0] == k + 1)
    for extra, label in ((0, "on_row_boundaries"), (1, "drifting")):
        k = per_row + extra
        exact.append((f"pieces_{label}/{k}_per_row/D64", *csr_case(
            4000, rows_b, np.repeat(np.arange(rows_b), k), 64, False,
            exact=True)))
    exact.append(("e_below_one_piece/D64", *csr_case(
        100, 3, np.array([0, 0, 2, 2, 2]), 64, True, exact=True)))
    hub_src, hub_rowptr = hub_only(ops[2])
    hub_case = ("hub_row_alone/bucket2/D128", layer_inputs[1][1], hub_src,
                hub_rowptr, None)

    def transposed(name, x, src, rowptr, sc, exact_inputs=True):
        """The case's transpose CSR, as the backward walks it: the rows of
        x become the output rows, and each edge gathers its destination's
        row of a gradient over the case's rows."""
        s = rowptr.numel() - 1
        src_h = src.cpu().numpy()
        dst_h = np.repeat(np.arange(s), np.diff(rowptr.cpu().numpy()))
        order = np.argsort(src_h, kind="stable")
        t_ids = torch.from_numpy(dst_h[order].astype(np.int32)).to(dev)
        t_rowptr = torch.from_numpy(np.searchsorted(
            src_h[order], np.arange(x.shape[0] + 1)).astype(np.int32)).to(dev)
        t_sc = None if sc is None else sc[torch.from_numpy(order).to(dev)]
        gen = torch.Generator(dev).manual_seed(s)
        shape = (max(s, 1), x.shape[1])
        g = (dyadic(shape, 7, gen) if exact_inputs else
             torch.rand(shape, device=dev, generator=gen))
        return f"transpose/{name}", g, t_ids, t_rowptr, t_sc

    exact += [transposed(*c) for c in exact]
    cases += [hub_case, transposed(*hub_case, exact_inputs=False)]
    exact_names = {c[0] for c in exact}
    for name, x, src, rowptr, sc in cases + exact:
        err = check(name, x, src, rowptr, sc, exact=name in exact_names)
        twice_equal(name, x, src, rowptr, sc)
        emit("kernel_case", case=name, edges=src.numel(), d=x.shape[1],
             rows=rowptr.numel() - 1, max_abs_err=err,
             exact=name in exact_names, vec_lanes=ss.b1_width(x.shape[1], x))
    # The cases' tensors would otherwise count in the later phases' peaks;
    # the exact ones wait for the bf16 variant's phase.
    del cases, x, src, rowptr, sc, hub_src, hub_rowptr, hub_case

    # Malformed inputs fault loudly on the card. A device-side assert ends
    # the CUDA context, so each case runs in a child process of its own.
    bad_cases = {
        "rowptr_not_from_0": "rowptr = torch.tensor([1, 2, 3], **i32)",
        "rowptr_not_to_E": "rowptr = torch.tensor([0, 1, 2], **i32)",
        "src_outside_x": "rowptr = torch.tensor([0, 1, 3], **i32); "
                         "src[2] = 5",
    }
    # The bf16 variant stops on the same asserts (phase kernel_bf16).
    bad_cases.update({f"bf16_{k}": v for k, v in bad_cases.items()
                      if k != "rowptr_not_from_0"})
    children = {name: subprocess.Popen(
        [sys.executable, "-c", BAD_INPUT_CHILD.format(
            case=body, dtype="torch.bfloat16" if name.startswith("bf16_")
            else "torch.float32")], cwd=repo,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, body in bad_cases.items()}
    for name, child in children.items():
        out, _ = child.communicate(timeout=300)
        if child.returncode == 0 or "device-side assert" not in out:
            raise AssertionError(
                f"bad input {name} did not stop on the device-side assert "
                f"(exit {child.returncode}):\n{out[-2000:]}")
        emit("kernel_bf16_bad_input" if name.startswith("bf16_")
             else "kernel_bad_input", case=name, exit_code=child.returncode,
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
        query_ms = event_ms(lambda: torch.topk(distmult_score_all_tails(
            emb[q_heads], rel_emb[rels], emb), topk, dim=1))
    emit("serve", nodes=n, padded_edges=p_graph.padded_num_edges,
         params=rgcn.count_params(p_params), relations_served=3,
         queries_per_call=len(heads), topk=topk, launches=launches,
         launches_per_encode=launches / 3, max_score_err=score_err,
         max_abs_top_score=top_score,
         cli_seconds=cli_s, encode_ms=encode_ms,
         plain_encode_ms=plain_encode_ms, query_ms=query_ms,
         peak_memory_mb=peak_mb)

    # -- 5-8. training, float32 and bf16 --------------------------------------
    bwd_rows, bwd_err = phase_kernel_bwd(graph, dev)
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    b1_16, b1_16_bwd, b1_16_err, b1_16_library = phase_kernel_bf16_b1(
        graph, dev, layer_inputs, exact, main_rows, bwd_rows)
    del exact, layer_inputs
    edges = np.stack([src_u, dst_u, rel_u], 1)
    grad_err, f32_run = phase_grad(graph, cfg, edges, dev, plain_layer)
    grad16_err, _ = phase_grad(graph, cfg16, edges, dev, plain_layer,
                               f32_run)
    del f32_run
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        train_launches, _, _ = phase_train(graph, cfg, edges, dev, Path(tmp))
        train16_launches, _, _ = phase_train(graph, cfg16, edges, dev,
                                             Path(tmp))
        # The batch-restricted final layer forced on at the bench.py
        # graph's edge ratio, where "auto" leaves it off: one side of the
        # break-even that AUTO_EDGE_RATIO stands for.
        bench_plan = pfl.resolve_final_plan(graph, edges, 1024, 1, seed=42,
                                            mode="on")
        emit("train_restricted_plan", edge_ratio=pfl.edge_ratio(
            graph, bench_plan), e_cap_sum=sum(bench_plan.e_cap),
            auto_resolves=pfl.resolve_final_plan(
                graph, edges, 1024, 1, seed=42) is not None)
        restricted_launches, _, restricted_figures = phase_train(
            graph, cfg, edges, dev, Path(tmp), label="train_restricted_on",
            final_plan=bench_plan, launches_per_step=6)
        restricted_b2 = restricted_figures["b2_launches"]
        cli_launches = phase_train_cli(Path(tmp))
        cli_eval = {"train_cli": eval_cli_after(Path(tmp) / "train_cli",
                                                "train_cli")}
        cli16_launches = phase_cli_bf16(Path(tmp))

        # -- 9-13. sampled training, float32 and bf16 -----------------------
        b2_rows, b2_err = phase_kernel_b2(graph, cfg, edges, dev, repo)
        b2_16_rows, b2_16_err = phase_kernel_b2(graph, cfg16, edges, dev, repo)
        b3_rows = phase_kernel_b3(graph, cfg, edges, dev)
        sgrad_err = phase_sampled_grad(graph, cfg, edges, dev)
        sampled, main_counts = phase_sampled_train(graph, cfg, edges, dev,
                                                   Path(tmp))
        sgrad16_err = phase_sampled_grad(graph, cfg16, edges, dev)
        sampled16, _ = phase_sampled_train(
            graph, cfg16, edges, dev, Path(tmp), configs=("block/slim",))
        scli_launches = phase_sampled_cli(Path(tmp))
        for name in scli_launches:
            cli_eval[f"sampled_cli_{name}"] = eval_cli_after(
                Path(tmp) / f"sampled_cli_{name}", f"sampled_cli_{name}")

        # -- 14-18. node-sharded training and serving ------------------------
        t0 = time.perf_counter()
        psg = partition_nodes(graph, N_SHARDS)
        emit("node_partition", seconds=time.perf_counter() - t0,
             shards=N_SHARDS, n_loc=psg.n_loc, halo_width=psg.halo_width,
             offsets_local=list(psg.offsets_local),
             offsets_halo=list(psg.offsets_halo),
             real_local_edges=int((psg.dst_local < psg.n_loc).sum()),
             real_halo_edges=int((psg.dst_halo < psg.n_loc).sum()),
             real_serve_slots=int((psg.serve < psg.n_loc).sum()))
        b4_rows = phase_kernel_b4(psg, dev)
        b4_16_rows = phase_kernel_b4(psg, dev, torch.bfloat16)
        ngrad_err = phase_node_grad(graph, psg, cfg, edges, dev)
        node_counts, _ = phase_node_train(psg, cfg, edges, dev, Path(tmp))
        node16_encode = phase_node_bf16_encode(graph, psg, cfg16, dev)
        node16_counts, _ = phase_node_train(psg, cfg16, edges, dev,
                                            Path(tmp))
        node_data = Path(tmp) / "node_serve"
        node_data.mkdir()
        artifacts.save_split_npz(node_data / "full_graph.npz", split)
        artifacts.save_mappings(node_data / "mappings.json",
                                synthetic.synthetic_mappings(raw))
        torch_interop.save_reference_pt(params, cfg, node_data / "model.pt")
        nserve_counts = phase_node_serve(node_data, psg, cfg, heads, served,
                                         dev)
        ncli_counts = phase_node_cli(Path(tmp))
        cli_eval["node_cli"] = eval_cli_after(
            Path(tmp) / "node_cli", "node_cli", "--shard", "node",
            "--n_devices", str(N_SHARDS))

        # -- the edge-sharded layout ----------------------------------------
        edge_err, edge_f32 = phase_edge_grad(graph, cfg, edges, dev)
        edge16_err, _ = phase_edge_grad(graph, cfg16, edges, dev,
                                        label="edge_bf16", f32_run=edge_f32)
        del edge_f32
        edge_counts, _ = phase_edge_train(graph, cfg, edges, dev, Path(tmp))
        edge_cli_counts, cli_eval["edge_cli"] = phase_edge_cli(Path(tmp))

        # -- 19-20. evaluation --------------------------------------------
        eval_ctx = phase_eval(Path(tmp), node_data, raw, params, cfg, graph,
                              dev, plain_layer)
        neval_counts = phase_node_eval(eval_ctx, params, cfg, graph, psg,
                                       dev)

        # -- 21-22. analysis and export -----------------------------------
        analysis_counts = phase_analysis(Path(tmp), node_data, params, cfg,
                                         graph, dev, plain_layer, raw)
        export_counts = phase_export(Path(tmp), node_data, heads, served,
                                     query_ms, dev)

        # -- 24-28. BASELINE configs 3 and 4: full PrimeKG ----------------
        g3_cpu, edges3 = phase_full_kg_graph(repo)
        g3 = g3_cpu.to(dev)
        cfg3 = ModelConfig(num_nodes=g3.num_nodes,
                           num_relations=g3.num_relations)
        kg_grad_err = phase_full_kg_grad(g3_cpu, g3, edges3, dev)
        kg_train, kg_b2 = phase_full_kg_train(g3, edges3, dev, Path(tmp))
        kg_trainer = phase_full_kg_trainer(g3, edges3, dev, Path(tmp))
        kg_sgrad_err = phase_sampled_grad(g3, cfg3, edges3, dev,
                                          label="full_kg_sampled_grad")
        kg_b2_streams = phase_full_kg_b2_streams(g3, cfg3, edges3, dev)
        kg_sampled, kg_sampled_counts = phase_sampled_train(
            g3, cfg3, edges3, dev, Path(tmp), configs=("block/slim",),
            label="full_kg_sampled")

        # -- the sharded layouts on config 3's graph ------------------------
        t0 = time.perf_counter()
        psg3 = partition_nodes(g3_cpu, N_SHARDS)
        partition_s = time.perf_counter() - t0
        psg3_kept = partition_nodes(g3_cpu, N_SHARDS, uniform_caps=False)
        emit("full_kg_node_partition", seconds=partition_s,
             shards=N_SHARDS, uniform_caps=psg3.uniform_caps,
             n_loc=psg3.n_loc, halo_width=psg3.halo_width,
             local_cap=psg3.offsets_local[1], halo_cap=psg3.offsets_halo[1],
             real_local_edges=int((psg3.dst_local < psg3.n_loc).sum()),
             real_halo_edges=int((psg3.dst_halo < psg3.n_loc).sum()),
             launches_per_step=node_launches(psg3),
             launches_per_step_kept_partials=node_launches(psg3_kept))
        kg_ngrad_err = phase_node_grad(g3, psg3, cfg3, edges3, dev,
                                       label="full_kg_node_grad")
        kg_node = {}
        for name, part in (("full_kg_node_train", psg3),
                           ("full_kg_node_train_kept_partials", psg3_kept)):
            kg_node[name] = phase_node_train(part, cfg3, edges3, dev,
                                             Path(tmp), steps=10, label=name)
        scan_mb, kept_mb = (kg_node[k][1]["peak_memory_mb"] for k in kg_node)
        emit("full_kg_node_memory", scan_peak_memory_mb=scan_mb,
             kept_partials_peak_memory_mb=kept_mb, saved_mb=kept_mb - scan_mb)
        del psg3_kept
        kg_nserve = phase_full_kg_node_serve(g3, psg3, dev)
        kg_egrad_err, _ = phase_edge_grad(g3, cfg3, edges3, dev,
                                          label="full_kg_edge_grad")
        kg_edge_counts, _ = phase_edge_train(g3, cfg3, edges3, dev, Path(tmp),
                                             steps=10,
                                             label="full_kg_edge_train")

    # -- 23. summary --------------------------------------------------------
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
                             "train_cli": cli_launches,
                             "sampled_cli": {k: v["B1"] for k, v in
                                             scli_launches.items()},
                             "node_train": node_counts["B1"],
                             "node_serve": [c["B1"] for c in nserve_counts],
                             "node_cli": ncli_counts["B1"],
                             "eval": eval_ctx["counts"]["B1"],
                             "node_eval": neval_counts["B1"],
                             "analysis": analysis_counts["B1"],
                             "export": export_counts["B1"],
                             "eval_after_cli": {k: v["B1"] for k, v in
                                                cli_eval.items()},
                             "full_kg_train": {
                                 k: v["launches"]
                                 for k, v in kg_train.items()},
                             "full_kg_trainer": kg_trainer["B1"],
                             "train_restricted_on": restricted_launches,
                             "edge_train": edge_counts["B1"],
                             "edge_cli": edge_cli_counts["B1"],
                             "full_kg_node_train": {
                                 k: v[0]["B1"] for k, v in kg_node.items()},
                             "full_kg_node_serve": kg_nserve["B1"],
                             "full_kg_edge_train": kg_edge_counts["B1"]},
        "launches_per_step": {"forward": 6, "backward": 6},
        "launches_per_step_sharded": {
            "node_train": node_counts["B1"] / 30,
            "edge_train": edge_counts["B1"] / 30,
            **{k: v[1]["launches_per_step"]["B1"]
               for k, v in kg_node.items()},
            "full_kg_edge_train": kg_edge_counts["B1"] / 10},
        "launches_per_step_full_kg": {
            k: v["launches_per_step"] for k, v in kg_train.items()},
        "max_abs_err": max(max_err, bwd_err, grad_err, ngrad_err,
                           kg_grad_err, edge_err, kg_ngrad_err,
                           kg_egrad_err),
        "ms": total(main_rows, "kernel_ms"),
        "call_ms": total(main_rows, "kernel_call_ms"),
        "wrapper_call_ms": total(main_rows, "wrapper_call_ms"),
        "bwd_ms": total(bwd_rows, "kernel_ms"),
        "bwd_call_ms": total(bwd_rows, "kernel_call_ms"),
        "plain_ms": total(main_rows, "plain_ms"),
        "bwd_plain_ms": total(bwd_rows, "plain_ms"),
        "bound_ms": total(main_rows, "bound_us") / 1e3,
        "bwd_bound_ms": total(bwd_rows, "bound_us") / 1e3,
        "bound_by": bound_by(main_rows), "bwd_bound_by": bound_by(bwd_rows),
        "library_ms": total(main_rows, "library_ms"),
        "bwd_library_ms": total(bwd_rows, "library_ms"),
        "bf16": {
            "ms": total(b1_16, "kernel_ms"),
            "call_ms": total(b1_16, "kernel_call_ms"),
            "wrapper_call_ms": total(b1_16, "wrapper_call_ms"),
            "plain_ms": total(b1_16, "plain_ms"),
            "bound_ms": total(b1_16, "bound_us") / 1e3,
            "bound_by": bound_by(b1_16),
            "library_ms": total(b1_16, "library_ms"),
            "library": b1_16_library,
            "library_f32_upcast_ms": total(b1_16, "library_f32_upcast_ms"),
            "bwd_ms": total(b1_16_bwd, "kernel_ms"),
            "bwd_call_ms": total(b1_16_bwd, "kernel_call_ms"),
            "bwd_plain_ms": total(b1_16_bwd, "plain_ms"),
            "bwd_bound_ms": total(b1_16_bwd, "bound_us") / 1e3,
            "bwd_bound_by": bound_by(b1_16_bwd),
            "bwd_library_ms": total(b1_16_bwd, "library_ms"),
            "bwd_library_f32_upcast_ms": total(b1_16_bwd,
                                               "library_f32_upcast_ms"),
            "launches_by_path": {
                "train_bf16": train16_launches,
                "cli_bf16": {k: v["B1"] for k, v in cli16_launches.items()},
                "node_bf16": node16_counts["B1"],
                "node_bf16_encode": node16_encode["B1"]},
            "max_abs_err": max(b1_16_err, grad16_err, edge16_err),
            "per": "the bf16-table variant (gather_segment_sum_bf16) at the "
                   "same twelve shapes, the tables rounded to bf16; every "
                   "launch on these paths is a bf16 one (grad_bf16: 6 "
                   "forward and 6 backward)"},
        "per": "one training step: ms, plain_ms, bound_ms and library_ms sum "
               "the six forward launches (one encode), the bwd_ keys the six "
               "backward launches over the transpose CSR; launches is the "
               "train phase's count; launches_per_step_sharded gives the "
               "node and edge steps' (4 shards; config 3's node step "
               "through the relation scan, 3 launches a bucket, beside the "
               "kept partials' 2). " + TIMES}, {
        "name": "dense_sorted_segment_sum", "id": "B2", "route": "cuda",
        "source": "primekg_rgcn_tpu_torch/csrc/dense_segment_sum.cu",
        "replaces": "primekg_rgcn_tpu/ops/pallas/segment_sum.py:420",
        "launches": main_counts["B2"],
        "launches_by_path": {
            "sampled_train": {k: v["launches"]["B2"]
                              for k, v in sampled.items()},
            "sampled_cli": {k: v["B2"] for k, v in scli_launches.items()},
            "full_kg_sampled": kg_sampled_counts["B2"],
            "full_kg_train": {k: v["b2_launches"]
                              for k, v in kg_train.items()},
            "full_kg_trainer": kg_trainer["B2"],
            "train_restricted_on": restricted_b2,
            "node_train": node_counts["B2"],
            "node_bf16": node16_counts["B2"],
            "full_kg_node_train": {k: v[0]["B2"]
                                   for k, v in kg_node.items()}},
        "launches_per_step": {"sampled_block": 2, "restricted_step": 1,
                              "node_step": 5 * N_SHARDS},
        "max_abs_err": max(b2_err, sgrad_err, kg_sgrad_err,
                           kg_b2["max_abs_err"],
                           *(r["max_abs_err"] for r in kg_b2_streams)),
        "ms": b2_rows[0]["kernel_ms"],
        "call_ms": b2_rows[0]["kernel_call_ms"],
        "plain_ms": b2_rows[0]["plain_ms"],
        "bound_ms": b2_rows[0]["bound_us"] / 1e3,
        "bound_by": b2_rows[0]["bound_by"],
        "library_ms": b2_rows[0]["library_ms"],
        "streams": {
            f"{r['shape']}/{r['dtype']}": {k: r[k] for k in (
                "rows", "d", "segments", "real_rows", "runs", "longest_run",
                "kernel_ms", "kernel_call_ms", "plain_ms", "library_ms",
                "bound_us", "bound_by", "bound_share", "over_library",
                "max_abs_err")}
            for r in (*b2_rows, *b2_16_rows, kg_b2, *kg_b2_streams)},
        "bf16": {
            "ms": b2_16_rows[0]["kernel_ms"],
            "call_ms": b2_16_rows[0]["kernel_call_ms"],
            "plain_ms": b2_16_rows[0]["plain_ms"],
            "bound_ms": b2_16_rows[0]["bound_us"] / 1e3,
            "bound_by": b2_16_rows[0]["bound_by"],
            "library_ms": b2_16_rows[0]["library_ms"],
            "launches_by_path": {
                "sampled_bf16": {k: v["launches"]["B2"]
                                 for k, v in sampled16.items()},
                "cli_bf16_sampled": cli16_launches["sampled"]["B2"]},
            "max_abs_err": max(b2_16_err, sgrad16_err),
            "per": "the bf16-row variant (dense_sorted_segment_sum_bf16) at "
                   "a bf16 block step's identity-backward stream; "
                   "library_ms is index_add_ of the rows upcast to float32, "
                   "the upcast included"},
        "per": "one block-mode step's identity-backward launch (L = %d, "
               "D = %d, N = %d); a block step makes 2 (identity and dedup "
               "backward), a config-3 restricted step 1; streams gives "
               "every timed stream (the step's identity and dedup streams "
               "at float32 and bf16, the config-3 restricted layer's, "
               "config 4's identity and dedup); a node-sharded step makes "
               "20 (the sorted backward of each shard's serve lists, "
               "endpoint fetches and relation lookup); library_ms is "
               "index_add_; "
               "launches is the sampled_train block/slim count. "
               % (b2_rows[0]["rows"], b2_rows[0]["d"],
                  b2_rows[0]["segments"]) + TIMES}, {
        "name": "window_rows_fetch", "id": "B3", "route": "cuda",
        "source": "primekg_rgcn_tpu_torch/csrc/window_fetch.cu",
        "replaces": "primekg_rgcn_tpu/ops/pallas/window_fetch.py:92",
        "launches": main_counts["B3"],
        "launches_by_path": {
            "sampled_train": {k: v["launches"]["B3"]
                              for k, v in sampled.items()},
            "full_kg_sampled": kg_sampled_counts["B3"]},
        "launches_per_step": 2,
        "max_abs_err": 0,
        "ms": total(b3_rows[:2], "kernel_ms"),
        "call_ms": total(b3_rows[:2], "kernel_call_ms"),
        "plain_ms": total(b3_rows[:2], "plain_ms"),
        "bound_ms": total(b3_rows[:2], "bound_us") / 1e3,
        "bound_by": bound_by(b3_rows[:2]),
        "library_ms": total(b3_rows[:2], "library_ms"),
        "block4_ms": total(b3_rows[2:4], "kernel_ms"),
        "block4_bound_ms": total(b3_rows[2:4], "bound_us") / 1e3,
        "per": "one block-mode step over the slim CSR: ms, plain_ms, "
               "bound_ms and library_ms sum its two launches (outer and "
               "inner layer); library_ms is packed[starts[:, None] + "
               "arange(F)]; launches is the sampled_train block/slim "
               "count. " + TIMES}, {
        "name": "halo_exchange", "id": "B4", "route": "cuda",
        "source": "primekg_rgcn_tpu_torch/csrc/halo_exchange.cu",
        "replaces": "primekg_rgcn_tpu/ops/pallas/halo.py:60",
        "launches": node_counts["B4"],
        "launches_by_path": {"node_train": node_counts["B4"],
                             "node_serve": [c["B4"] for c in nserve_counts],
                             "node_cli": ncli_counts["B4"],
                             "node_eval": neval_counts["B4"],
                             "eval_after_node_cli":
                                 cli_eval["node_cli"]["B4"],
                             "full_kg_node_train": {
                                 k: v[0]["B4"] for k, v in kg_node.items()},
                             "full_kg_node_serve": kg_nserve["B4"]},
        "launches_per_step": {"forward": 2, "backward": 2},
        "max_abs_err": 0,
        "ms": total(b4_rows, "kernel_ms"),
        "call_ms": total(b4_rows, "kernel_call_ms"),
        "plain_ms": total(b4_rows, "plain_ms"),
        "bound_ms": total(b4_rows, "bound_us") / 1e3,
        "bound_by": bound_by(b4_rows),
        "library_ms": total(b4_rows, "library_ms"),
        "bf16": {
            "ms": total(b4_16_rows, "kernel_ms"),
            "call_ms": total(b4_16_rows, "kernel_call_ms"),
            "plain_ms": total(b4_16_rows, "plain_ms"),
            "bound_ms": total(b4_16_rows, "bound_us") / 1e3,
            "bound_by": bound_by(b4_16_rows),
            "library_ms": total(b4_16_rows, "library_ms"),
            "launches_by_path": {
                "node_bf16": node16_counts["B4"],
                "node_bf16_encode": node16_encode["B4"],
                "cli_bf16_node": cli16_launches["node"]["B4"]},
            "max_abs_err": 0,
            "per": "the 2-byte-element variant (halo_exchange_bf16): one "
                   "encode's two launches with bf16 payloads, bit for bit; "
                   "library_ms is copy_ of the same bf16 bytes"},
        "per": "one encode over %d shards (P = %d): ms, plain_ms, bound_ms "
               "and library_ms sum its two launches (D = 64 and 128); a "
               "training step runs each twice (forward, backward); "
               "library_ms is one copy_ of the same bytes; launches is the "
               "node_train count. " % (b4_rows[0]["n"], b4_rows[0]["p"])
               + TIMES}]}),
        flush=True)
    print(card, flush=True)
    # The run uses one card (cuda:0) whatever the machine holds.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
