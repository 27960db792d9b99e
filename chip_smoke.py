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
   gradient must agree; 6 forward and 6 backward launches. grad_bases
   (after grad_bf16): the same with the basis decomposition
   (``num_bases=2``, BASELINE config 2).
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
   CSR (their real starts) and at width 64, exactly equal, and two launches
   ``torch.equal``; kernel, plain and row-gather times beside the bound,
   with the kernel's time over the row gather's (``vs_library``) and the
   bound's share of it (``bound_share``). Then its edge cases, each equal to
   the plain version: every width 1-64 on one stream of random starts, one
   window, windows at 0 and at rows - width, an odd count of records, odd
   starts only, a table that starts one record in (8-byte aligned only).
11. sampled_grad: one full-size block-mode step's loss and gradients
   through B2 and B3 and through their plain versions, over the fat CSR
   (2 B2 launches: identity and dedup backward) and the slim pairs CSR
   (2 B2, 2 B3); the slim loss must equal the fat one.
12. sampled_train: ``build_sampled_train_step`` at fanouts 15/10, 3
   warm-up and 30 timed steps, block over the fat CSR, block over the slim
   CSR and block4 over the slim CSR: step_ms, edges/s, launches per step
   (2 B2), peak memory; a 10-step profile of each step over the slim CSR
   (B3's share of the block and block4 steps).
13. sampled_cli: ``train.cli.main --sample_fanouts 15 10`` at scale 0.1 in
   block mode, and in block4 mode with ``--sparse_emb --val_sampled``, each
   then served by ``predict_cli.main`` and evaluated by
   ``evaluate.cli.main``; B2 must launch in both.
14. kernel_b4: kernel B4 (``csrc/halo_exchange.cu``) against its plain
   version, bit for bit, two launches equal, at the node-sharded step's
   shapes (n = 4 shards, P = 7,736, D = 64 and 128, the real serve lists
   of the ``bench.py`` graph), there also in its form across two
   processes (kernel_b4_local_pairs: each process's 2 x 2 pairs, one
   launch over [2, P, D] views into views of full recv tensors, 16-byte
   vectors), and on edge cases (n = 1, 2, 3 and 8, P = 1,
   D = 8, odd D in whole 16-byte units a pair or not, pairs that are not a
   multiple of the 16 KB tile below and past the L2, views offset by one
   element and by 4 bytes: the element-wise kernel); kernel, plain and
   ``copy_`` times beside the byte bound, warm and with a cold L2.
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
18b. the data-parallel sampled steps (``train/sampled.py``), 4 shards on
   the card, batch 1024 (1,024 seeds a shard), fanouts 15/10, block over
   the slim pairs CSR, adam lr 1e-3, clip 1.0: sampled_dp_grad: one step
   each of dp, zero1 and zero3 on given per-shard candidates, draws and
   dropout masks, through B2 and B3 against their plain versions (the
   grad criterion), launches asserted (dp and zero1 12 B2 and 8 B3, zero3
   24 B2: its fetch backward's 16 chunk sums), then zero1's parameters
   after the step against dp's and zero3's against zero1's. kernel_b2
   gains one stream: an (owner, requester) chunk of zero3's fetch
   backward, recorded from that step, with all 16 chunks' device time
   beside it. sampled_dp_train: dp, zero1, zero3, zero3 with
   ``table_opt="adafactor"`` (clip 0), zero3 on a (2, 2) mesh and the
   one-device ``--sparse_emb --table_opt adafactor`` step: 3 warm-up and
   20 timed steps each, launches asserted, peak memory, a 10-step profile
   and ``step_twice_equal``, asserted. sampled_dp_cli: ``train.cli.main
   --sample_fanouts 15 10 --shard edge --n_devices 4`` at scale 0.1 with
   ``--zero1`` (2 epochs) and with ``--zero3 --table_opt adafactor
   --grad_clip 0 --val_sampled`` (2 epochs, then resumed for a third),
   each final model evaluated by ``evaluate.cli.main``.
18c. the same layouts across processes (``--distributed``,
   ``phase_distributed``), run last, after 27e: distributed_cli: ``train.cli
   --shard edge`` and ``--shard node``, ``--n_devices 4``, at scale 0.1
   for 2 epochs, each as one process over NCCL (``--distributed
   --num_processes 1``) and without ``--distributed``, history and final
   parameters torch.equal, the backend printed. distributed_steps: two
   processes on the one card (``python3 chip_smoke.py dist_child``; gloo,
   by the backend rule) run the edge step, the node step (its halo
   exchange B4 on each process's 2 x 2 pairs and an all-to-all between
   the processes), the zero3 block/slim step and that step on a (1, 4)
   mesh whose tp row the two processes split, at full width, 4 shards, 3
   steps each from one saved state, against this process's run from it:
   losses within rel 1e-5, parameters within rtol 2e-6, atol 2e-7; each
   process's launches asserted a step (edge 24 B1; node 4 B4, 10 B2 and
   its buckets' B1, the pair's summing to the one-process 60; zero3 12 B2
   and 4 B3) and its zero3 table two of the four slices; the node
   layout's sharded top-10 of 64 heads over the pair, ids equal to one
   process's, scores within rtol 1e-5; which collective kinds gloo runs
   on CUDA tensors; two more processes (``nccl_shared_child``) put an
   NCCL communicator on the one card, which NCCL must refuse. step_ms is
   printed as mechanics, not speed. The children run at once, about a
   minute in all.
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
   validation, checkpoints; graphed: its launches counted in a profile
   of the epoch, and those of its Python runs), losses finite. full_kg_sampled:
   config 4, the block-mode step over the slim CSR: gradients through B2
   and B3 against their plain versions (``full_kg_sampled_grad``, fat and
   slim CSR), B2 on the step's identity and dedup streams
   (``full_kg_b2_streams``), then 3 warm-up and 30 timed steps with a
   profile.
   The sharded layouts on config 3's graph, 4 shards: the node partition
   (``uniform_caps`` by default at 30 relations, so the layer runs the
   relation scan, ``ScanAccumulate``: 3 B1 launches a bucket in a step),
   B4 at its node step's two shapes (full_kg_kernel_b4: P = 31,856, D = 64
   and 128, float32, as kernel_b4's shapes) and full_kg_node_grad
   (node_grad's checks); full_kg_node_train, 10 timed steps, beside the
   same step with ``uniform_caps=False`` (the
   kept partials, 2 B1 a bucket), whose peak memory the scan exists to
   save (full_kg_node_memory); full_kg_node_serve: the sharded encode
   against the dense one within rtol 2e-4 and its top-10 ids against the
   dense ones; full_kg_edge_grad and full_kg_edge_train (10 timed steps)
   as edge_grad and edge_train. full_kg_zero3: zero3 at 4 shards on
   config 4's graph, one step against the plain versions and 10 timed
   steps.
27a. combined_agg: config 4 at uniform 15/10 under each per-(node,
   relation) reduction (``PRIMEKG_COMBINED_AGG``: einsum, rowwise,
   chunked): the rowwise and chunked step's loss within 1e-5 and
   gradients at the grad criterion of the einsum's on the same draws,
   then 10 timed steps each (2 B2 a step, peak memory, a profile,
   ``step_twice_equal``). Config 3's tensors are then dropped.
27b. sampled_cache: the layer-1 cache on the ``bench.py`` graph:
   ``SampledTrainer(cache_layer1=True)``'s warm start (one conv1 pass, 3
   B1) against B1's plain version; one cached step's loss, gradients and
   pushed cache (2 B2) against the plain versions; ``train.cli
   --sample_fanouts 15 10 --sparse_emb --cache_layer1`` at scale 0.1 for
   2 epochs, then ``evaluate.cli`` on its model.
27c. BASELINE config 5 (``bench/suite.py:175-272``): rmat10m_graph:
   ``native.rmat_native(10M, 100M, 50, seed=0)``, ``build_rel_graph``
   and ``build_combined_csr`` (slim packed), each timed with the host's
   peak RSS, the layout, the budgets and the bytes moved to the card
   (only the CSR). rmat10m_grad: one uniform bf16 step (batch 1024,
   fanouts 15/10, SGD, no clip), identity inner block asserted, through
   B2 against its plain version under the bf16 criterion; kernel_b2 on
   the step's identity (~8.2M rows into 10M segments) and dedup streams;
   kernel_b3 on the windows one block and one block4 batch fetch from
   the 100M-record table, exactly equal to its plain version, with cold-L2
   times of the kernel and the row gather at the two inner layers
   (``kernel_cold_ms`` / ``library_cold_ms``: 128 MB written between
   calls).
   rmat10m_sampled: the sparse step in uniform, block and block4 mode,
   3 warm-up and 15 timed steps each (2 B2 a step, 2 B3 in block modes),
   peak memory, a profile, ``step_twice_equal``; rmat10m_cache: the
   cached step from a cold cache, the same figures and the cache's MB.
27d. the device-resident epochs (``train/graphs.py``, the port's
   ``--steps_per_scan``): train_graphed (after train_restricted_on): the
   ``bench.py`` full-graph epoch of 34 updates as CUDA graphs at K = 1
   (the default), 4 and 32 against the eager epoch from one state, two
   epochs each, every parameter, adam state tensor, the epochs' (loss,
   acc) and the generator's state ``torch.equal``; per K one timed and
   one profiled epoch (12 B1 an update counted in the trace), peak
   memory, capture seconds. eval_graphed: the validation epoch as one
   graph against eager, ``torch.equal`` over three epochs, 6 B1 an epoch
   in the trace. train_cli_graphed (after train_cli): ``train.cli
   --steps_per_scan 2 --save_every 1``, through ``check_checkpoints``,
   then resumed from its epoch-1 checkpoint and from a copy of it with
   adam's step counts on the host and ``capturable`` off: both equal to
   the uninterrupted run bit for bit. sampled_train_graphed (after
   sampled_train): the block/slim epoch (``SampledEpoch``, 34 steps) at
   K = 1, 4, 32 against eager, ``torch.equal``, 2 B2 and 2 B3 a step in
   the trace. full_kg_train_graphed (after full_kg_trainer): config 3's
   split restricted update against eager at the grad criterion (SGD, two
   epochs of 24), one host read an update, the generator equal; the same
   at four micro-batches an update (full_kg_train_graphed_accum4, one
   graph each) and with every update overflowing
   (full_kg_graphed_overflow); the adam
   update timed and profiled, 60 B1 and 1 B2 an update. rmat10m_cache_
   graphed (after rmat10m_sampled): config 5's cached epoch graphed
   against eager, ``torch.equal``, 2 B2 a step in the trace. The
   ``train``, ``sampled_train`` and ``node_train`` phases assert
   ``step_twice_equal``; the restricted steps print it. A wrapper's
   launch counter counts a graphed body at its warm-up and its capture,
   not at a replay: the graphed phases count kernels in their traces.
27e. the bench modules (``primekg_rgcn_tpu_torch/bench/``), last:
   bench_suite: ``python -m primekg_rgcn_tpu_torch.bench.suite`` as a
   child over ``SMOKE_SUITE_ROWS`` (its ``CONFIGS``, the JAX suite's rows
   but the four that pick an implementation the port does not have, all
   but config 5's and one of those; ``scripts/port_bench_phases.py`` runs
   every row): exit 0, no row holding ``error``, one line a row
   (``step_ms``, edges/s, ``graphed``, the card's floor and
   ``floor_fraction``). bench_trace: a
   10-step trace of the primekg-bases and rmat-large rows' graphed update,
   device busy and idle share beside the suite's ``step_ms``, the kernels
   in the trace asserted against the relation buckets (12 B1 a step for
   primekg-bases). config3_probe and restricted_probe at scale 1.0, each
   component a replayed CUDA graph; the restricted probe's static rows
   must equal the full layer's first. scaling: every sharded layout at
   1, 2, 4 and 8 shards on the card, scale 0.25, and the byte model.
   pod_scale: config 5 in two children, the node-sharded adam step at
   ``POD_NODE``'s scale (its memory reckoning printed first), and zero3
   at full scale over 8 shards with the sgd and adafactor table rules,
   every loss finite. The wrappers' launches in the probes, in every
   scaling row and in each pod-scale run are held against their buckets
   (``probe_launches``, ``scaling_launches``, ``node_step_launches``,
   ``zero3_launches``). A profile whose kernel counts disagree is taken
   again only when it lacks marker kernels (``profiled``), and the
   retakes are printed before the summary.
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
  ``index_add_`` of the upcast rows beside it; after 14, B4's at the node
  step's shapes and edge cases, as kernel_b4. Two children feed B1's bf16
  variant a bad CSR and one B2's unsorted ids: each must stop on the
  device-side assert.
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
import gc
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


def event_ms(fn, reps=REPS, warmup=WARMUP, before=None):
    """Median time of one call of ``fn`` from an idle stream in ms, one CUDA
    event pair per call: the host's work inside the call falls between the
    two events, so it counts too. ``before``, when given, runs before each
    call, outside the events (it must leave the stream idle)."""
    import torch

    for _ in range(warmup):
        if before is not None:
            before()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_calls(fns, reps=REPS, warmup=WARMUP, before=None):
    """Each named call of ``fns`` timed two ways, in ms (``before``, when
    given, runs before every call, outside what is timed):

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

    out = {f"{name}_call_ms": event_ms(fn, reps, warmup, before)
           for name, fn in fns.items()}
    # A trace that lost a call's device events is taken again, twice at most.
    pending = dict(fns)
    for _ in range(3):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_timer_") as tmp:
            with profile_trace(tmp):
                for name, fn in pending.items():
                    for i in range(reps):
                        if before is not None:
                            before()
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


def phase_grad(graph, cfg, edges, dev, plain_layer, f32_run=None,
               label=None):
    """One full-size training step's gradients through the kernel and
    through the plain version on the same inputs (``label``: the phase's
    name; ``grad_bases`` runs it with ``cfg.num_bases`` set, the basis
    decomposition of BASELINE config 2).

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
    label = label or ("grad_bf16" if bf16 else "grad")
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
            err = close_scaled(got, want, f"{label}/{name}")
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
    # One step twice from one state: the same bits? Asserted for the full
    # final layer; the restricted one's gradient sums with index_add_
    # (GatherGroupSum.backward), not bit-deterministic on the card, so
    # its answer is printed.
    twice = step_twice_equal(
        lambda p, o, bi, g: loop.train_step(p, o, graph, edges_pad, bi, cfg,
                                            tcfg, generator=g,
                                            final_plan=final_plan),
        params, opt, torch.from_numpy(rng.integers(
            0, graph.num_edges, b)).to(dev).view(1, b), dev)
    if final_plan is None and not twice:
        raise AssertionError(f"{label}: one step twice from one state gave "
                             f"other bits")
    figures = dict(step_ms=step_ms, train_edges_per_s=b / step_ms * 1e3,
                   launches=launches, launches_per_step=launches / steps,
                   b2_launches=counts["B2"], fallbacks=fallbacks,
                   peak_memory_mb=peak_mb, step_twice_equal=twice)
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
    from primekg_rgcn_tpu_torch.bench.scaling import kernel_launches

    return kernel_launches()


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
    """Least time of B3, in ms, at the HBM rate (no arithmetic): the
    records that the windows cover read once (windows that overlap share
    them: a block4 node's windows, a short row's window running into the
    next row's), each window's records written once and the starts read
    once."""
    import torch

    m = starts.numel()
    distinct = 0
    if m:
        gaps = torch.diff(torch.sort(starts.long())[0]).clamp(max=width)
        distinct = int(gaps.sum()) + width
    nbytes = distinct * 8 + m * (width * 8 + 4)
    return {"bytes": nbytes, "distinct_records": distinct,
            "byte_ms": nbytes / HBM_BYTES_PER_S * 1e3, "op_ms": 0.0}


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


def b3_streams(graph, cfg, edges, dev):
    """The windows that B3 fetches in one block and one block4 step over the
    slim CSR of ``graph`` (outer and inner layer, real starts, recorded
    from the step), and 30,976 windows of 64 records at random starts:
    ``[(name, packed, starts, width)]``."""
    import torch

    from primekg_rgcn_tpu_torch.config import TrainConfig
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
    return shapes


def rmat10m_b3_streams(ccsr, cfg, edges, dev):
    """The windows that B3 fetches for one block and one block4 batch of
    config 5 (1,024 positives and their negatives) from the 100M-record
    table in granule-pairs form, recorded from the sampler: ``[(name,
    packed, starts, width)]``."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.data.sampling import uniform_draw
    from primekg_rgcn_tpu_torch.train.neg_sampling import candidate_batch

    gen = torch.Generator(dev).manual_seed(0)
    pos = torch.from_numpy(edges[np.random.default_rng(0).integers(
        0, edges.shape[0], 1024)].astype(np.int64)).to(dev)
    shapes = []
    for mode in ("block", "block4"):
        step, _ = rmat10m_step(ccsr, cfg, dev, mode)
        cands = candidate_batch(pos[:, 0], pos[:, 1], pos[:, 2],
                                cfg.num_nodes, 1, generator=gen)
        calls = {}
        with sampler_kernels(("record", calls)):
            step.sample(torch.cat(cands[:2]).to(torch.int32),
                        uniform_draw(gen, dev))
        for layer, (packed, starts, width) in zip(("outer", "inner"),
                                                  calls["b3"]):
            shapes.append((f"config5_{mode}/{layer}", packed, starts, width))
    return shapes


def b3_equal(name, packed, starts, width):
    """B3 on one input must equal its plain version, and two launches each
    other, bit for bit."""
    import torch

    from primekg_rgcn_tpu_torch.ops.cuda import window_fetch as pwf

    got = pwf.window_rows_fetch(packed, starts, width)
    again = pwf.window_rows_fetch(packed, starts, width)
    want = pwf.window_rows_fetch_plain(packed, starts, width)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"b3/{name}: kernel and plain differ")
    if not torch.equal(got, again):
        raise AssertionError(f"b3/{name}: two launches differ")


def l2_flush(dev, mb=128):
    """A call that writes ``mb`` MB on the card (the H100's L2 holds 50)
    and waits for it: ``time_calls``'s ``before`` for cold-L2 times."""
    import torch

    buf = torch.empty(mb << 18, dtype=torch.int32, device=dev)

    def flush():
        buf.add_(1)
        torch.cuda.synchronize()
    return flush


def b3_shape_row(name, packed, starts, width, cold=False, **extra):
    """B3 at one shape: ``b3_equal``, then kernel, plain and row-gather
    (``rec[idx]``, its index precomputed) times beside ``b3_bound``, the
    kernel's time over the row gather's (``vs_library``) and the bound's
    share of it (``bound_share``); with ``cold``, the kernel's and the row
    gather's with the L2 flushed before each call (``kernel_cold_ms``,
    ``library_cold_ms``). Emits ``kernel_b3_shape`` and returns the row."""
    import torch

    from primekg_rgcn_tpu_torch.ops.cuda import window_fetch as pwf

    b3_equal(name, packed, starts, width)
    rec = packed.view(-1, 2)
    idx = starts.long()[:, None] + torch.arange(width, device=rec.device)
    fns = {"kernel": lambda: pwf.launch(rec, starts, width),
           "library": lambda: rec[idx]}
    t = time_calls({**fns, "plain": lambda: pwf.window_rows_fetch_plain(
        packed, starts, width)})
    if cold:
        c = time_calls(fns, before=l2_flush(rec.device))
        t.update(kernel_cold_ms=c["kernel_ms"],
                 library_cold_ms=c["library_ms"],
                 kernel_cold_call_ms=c["kernel_call_ms"],
                 library_cold_call_ms=c["library_call_ms"])
    bnd = b3_bound(starts, width)
    b = bound_fields(bnd)
    row = dict(shape=name, windows=starts.numel(), width=width,
               distinct_records=bnd["distinct_records"], **extra, **t,
               max_abs_err=0, vs_library=t["kernel_ms"] / t["library_ms"],
               bound_share=b["bound_us"] / 1e3 / t["kernel_ms"], **b)
    emit("kernel_b3_shape", **row)
    return row


def b3_cases(packed, dev):
    """B3's edge cases, each ``b3_equal``: every width 1-64 on one stream of
    3,001 random starts; one window; windows at 0 and at rows - width; an
    odd count of records (1,001 windows of 7); odd starts only (records at
    8-byte but not 16-byte offsets); the table viewed from its second
    record (8-byte aligned only). Emits ``kernel_b3_cases``."""
    import torch

    rec = packed.view(-1, 2)
    n = rec.shape[0]
    gen = torch.Generator(dev).manual_seed(5)

    def rand(m, hi):  # m starts in [0, hi]
        return torch.randint(0, hi + 1, (m,), generator=gen, device=dev,
                             dtype=torch.int32)

    stream = rand(3001, n - 64)
    for width in range(1, 65):
        b3_equal(f"width{width}", packed, stream, width)
    at = lambda *s: torch.tensor(s, dtype=torch.int32, device=dev)
    cases = {"one_window": (rand(1, n - 10), 10),
             "ends": (at(0, n - 6, 0, n - 6), 6),
             "ends_64": (at(n - 64, 0), 64),
             "odd_records": (rand(1001, n - 7), 7),
             # x | 1 <= x + 1: every start odd, none past rows - width.
             "odd_starts": (rand(4097, n - 11) | 1, 10),
             "odd_starts_odd_width": (rand(513, n - 4) | 1, 3)}
    for name, (starts, width) in cases.items():
        b3_equal(name, packed, starts, width)
    b3_equal("table_from_record_1", rec[1:], rand(2049, n - 13), 12)
    emit("kernel_b3_cases", widths=[1, 64], stream_windows=3001,
         cases=[*cases, "table_from_record_1"], all_equal=True,
         twice_equal=True)


def phase_kernel_b3(graph, cfg, edges, dev):
    """Kernel B3 against its plain version on the card, at the window
    shapes of a block and a block4 step over the slim CSR (their real
    starts) and at width 64 (``b3_shape_row``: exactly equal, two launches
    equal, timed beside the row gather and the bound), then its edge cases
    (``b3_cases``). Returns the shape rows."""
    shapes = b3_streams(graph, cfg, edges, dev)
    rows = [b3_shape_row(*shape) for shape in shapes]
    b3_cases(shapes[0][1], dev)
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
    of each slim step; 2 B2 launches a step (identity and dedup backward),
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
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        twice = step_twice_equal(step, params, opt, edges_dev[
            torch.from_numpy(rng.integers(0, edges.shape[0],
                                          tcfg.batch_size)).to(dev)], dev)
        if not twice:
            raise AssertionError(f"{label}/{name}: one step twice from one "
                                 f"state gave other bits")
        results[name] = dict(
            step_ms=step_ms, train_edges_per_s=tcfg.batch_size / step_ms * 1e3,
            launches=counts,
            launches_per_step={k: v / steps for k, v in counts.items()},
            peak_memory_mb=peak_mb, budgets=list(step.budgets),
            first_loss=first_loss, last_loss=last_loss,
            step_twice_equal=twice)
        emit(label, config=name, steps=steps,
             batch_size=tcfg.batch_size, **results[name])
        if name == "block/slim":
            main_counts = counts
        if name in ("block/slim", "block4/slim"):
            prof_steps = 10
            prof_dir = tmp / f"{label}_{mode}_profile"
            torch.cuda.synchronize()
            with profile_trace(prof_dir):
                t0 = time.perf_counter()
                for _ in range(prof_steps):
                    one()
                torch.cuda.synchronize()
                prof_ms = (time.perf_counter() - t0) / prof_steps * 1e3
            bd = trace_breakdown(prof_dir / "trace.json")
            if bd is None:
                emit(f"{label}_profile", config=name, steps=prof_steps,
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
        with trainer_states() as states:
            result = train_cli.main([*base, *extra, "--output_dir", str(out)])
        seconds = time.perf_counter() - t0
        launches[name] = read_counts()
        hist = result["history"]
        problems = check_checkpoints(out, states)
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
    """Launches of one node-sharded step (or, ``step=False``, one encode)
    on the partition ``psg``: :func:`node_step_launches` of its buckets
    with real edges."""
    halo = int((psg.rowptr_halo[..., -1] > 0).sum())
    buckets = int((psg.rowptr_local[..., -1] > 0).sum()) + halo
    return node_step_launches(buckets, psg.uniform_caps, psg.n_devices,
                              step, halo=halo > 0)


def node_step_launches(buckets, uniform_caps, n_devices, step=True,
                       halo=True):
    """Launches of one node-sharded step (or, ``step=False``, one encode)
    with ``buckets`` (shard, group, relation) buckets with real edges: B1
    once per layer and bucket, twice in a step (forward, backward over the
    transpose CSR), three times through the relation scan of a
    ``uniform_caps`` partition (its backward recomputes the partial
    first); B4 once per layer, twice in a step; B2 in a step's backward of
    every ``_take``: each shard's serve list per layer, its two endpoint
    fetches and its relation lookup, 5 n. Where no halo bucket has an edge
    (one shard) the received rows reach no output, so the step's backward
    runs neither exchange nor the serve lists' ``_take``: 2 B4 and
    5 n - 2 B2."""
    if not step:
        return {"B1": 2 * buckets, "B2": 0, "B3": 0, "B4": 2}
    per_bucket = 3 if uniform_caps else 2
    return {"B1": 2 * buckets * per_bucket,
            "B2": 5 * n_devices - (0 if halo else 2), "B3": 0,
            "B4": 4 if halo else 2}


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
    leave the same bits in every parameter, gradient (where the step leaves
    one) and the stats (a tensor, or a tuple of them). The parameters and
    optimizer state are put back after."""
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
        if isinstance(stats, tuple):
            stats = torch.stack(stats)
        runs.append([stats.clone()]
                    + [t.detach().clone() for _, p in leaves
                       for t in (p, p.grad) if t is not None])
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


def l2_bytes(dev):
    """The card's L2 size in bytes (52,428,800 on the H100)."""
    import torch

    return torch.cuda.get_device_properties(dev).L2_cache_size


def b4_sends(psg, d, dtype, gen, dev):
    """The node step's exchange at width ``d``: shard i sends the rows of
    its serve list ``psg.serve[i]`` of a random [n_loc + 1, d] table."""
    import torch

    serve = psg.serve.to(dev).long()
    tables = [torch.randn(psg.n_loc + 1, d, device=dev, generator=gen)
              .to(dtype) for _ in range(psg.n_devices)]
    return [tables[i][serve[i]] for i in range(psg.n_devices)]


def b4_equal(name, sends):
    """B4 on one exchange must equal its plain version, and two launches
    each other, bit for bit, each launch of the sends' dtype's variant."""
    import torch

    from primekg_rgcn_tpu_torch.ops.cuda import halo

    bf16 = sends[0].dtype == torch.bfloat16
    reset_counts()
    got = halo.halo_exchange(sends)
    again = halo.halo_exchange(sends)
    want = halo.halo_exchange_plain(sends)
    torch.cuda.synchronize()
    if (halo.halo_exchange.launches, halo.halo_exchange.launches_bf16) != \
            (2, 2 * bf16):
        raise AssertionError(f"{name}: not 2 launches of its dtype's variant")
    for o, (g, a, w) in enumerate(zip(got, again, want)):
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: recv {o} differs from the plain "
                                 f"version")
        if not torch.equal(g, a):
            raise AssertionError(f"{name}: recv {o} differs between two "
                                 f"launches")


def b4_shape_row(name, sends, **extra):
    """B4 at one shape: ``b4_equal``, then kernel, plain and ``copy_`` of
    the same bytes timed beside ``b4_bound``, warm and with the L2 flushed
    before each call (``kernel_cold_ms``, ``library_cold_ms``).
    ``vs_library`` is kernel / ``copy_`` warm (``vs_library_cold`` cold);
    ``l2_warm`` says the sends fit the card's L2, and then the warm times
    are L2 times and ``bound_share`` is taken from the cold time, else
    from the warm one."""
    import torch

    from primekg_rgcn_tpu_torch.ops.cuda import halo

    b4_equal(name, sends)
    flat = sum(t.numel() for t in sends)
    gen = torch.Generator(sends[0].device).manual_seed(7)
    src = torch.randn(flat, device=sends[0].device, generator=gen).to(
        sends[0].dtype)
    dst = torch.empty_like(src)
    fns = {"kernel": lambda: halo.launch(sends),
           "library": lambda: dst.copy_(src)}
    t = time_calls({**fns, "plain": lambda: halo.halo_exchange_plain(sends)})
    c = time_calls(fns, before=l2_flush(sends[0].device))
    t.update(kernel_cold_ms=c["kernel_ms"], library_cold_ms=c["library_ms"],
             kernel_cold_call_ms=c["kernel_call_ms"],
             library_cold_call_ms=c["library_call_ms"])
    b = bound_fields(b4_bound(sends))
    l2_warm = flat * src.element_size() <= l2_bytes(sends[0].device)
    return dict(shape=name, dtype=str(sends[0].dtype).split(".")[-1],
                **extra, **t, max_abs_err=0,
                vs_library=t["kernel_ms"] / t["library_ms"],
                vs_library_cold=t["kernel_cold_ms"] / t["library_cold_ms"],
                l2_warm=l2_warm, bound_share=b["bound_us"] / 1e3 / (
                    t["kernel_cold_ms"] if l2_warm else t["kernel_ms"]),
                **b)


def b4_local_pairs(name, sends, k):
    """B4's form across processes on one exchange: each of the n / k
    processes' k x k pairs of its own shards, one launch over contiguous
    k-block views of the sends into views of full recv tensors (as
    ``halo._across`` calls it), against the plain version of the same
    pairs, bit for bit, and two launches equal, each of the sends' dtype's
    variant. Returns the vector width each launch took."""
    import torch

    from primekg_rgcn_tpu_torch.ops.cuda import halo

    bf16 = sends[0].dtype == torch.bfloat16
    vecs = []
    for lo in range(0, len(sends), k):
        views = [s[lo:lo + k] for s in sends[lo:lo + k]]
        reset_counts()
        runs = []
        for _ in range(2):
            full = [torch.empty_like(sends[0]) for _ in range(k)]
            halo.launch(views, [r[lo:lo + k] for r in full])
            runs.append([r[lo:lo + k] for r in full])
        want = halo.halo_exchange_plain(views)
        torch.cuda.synchronize()
        if (halo.halo_exchange.launches,
                halo.halo_exchange.launches_bf16) != (2, 2 * bf16):
            raise AssertionError(f"{name}: not 2 launches of its dtype's "
                                 f"variant")
        for o, (g, a, w) in enumerate(zip(*runs, want)):
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: process from {lo}, recv {o} "
                                     f"differs from the plain version")
            if not torch.equal(g, a):
                raise AssertionError(f"{name}: process from {lo}, recv {o} "
                                     f"differs between two launches")
        _, p, d = views[0].shape
        vecs.append(halo.vec_width(p, d, views[0].element_size(), [
            t.data_ptr() for t in views + runs[0]]))
    return vecs


def phase_kernel_b4(psg, dev, dtype=None, label=None, cases=True):
    """Kernel B4 against its plain version on the card, exactly equal, two
    launches equal: at the node-sharded step's two shapes of ``psg`` (the
    real serve lists over random [n_loc + 1, D] tables, D = 64 and 128;
    ``b4_shape_row``), there also in its form across two processes
    (``b4_local_pairs``: each process's 2 x 2 pairs, line
    ``{label}_local_pairs``) and, with ``cases``, on edge cases: 1, 2, 3 and 8
    shards, one row, odd widths (whole 16-byte units a pair or not), a
    pair that is not a multiple of the 16 KB tile, an exchange past the L2
    whose pair is not a multiple of it either, sends offset by one
    element and by 4 bytes (the element-wise kernel). With
    ``dtype`` bf16 (phase ``kernel_bf16``, lines ``kernel_bf16_b4_*``)
    every payload is bf16 and launches the bf16 variant. ``label`` names
    the lines (config 3's shapes: ``full_kg_kernel_b4``)."""
    import torch

    from primekg_rgcn_tpu_torch.ops.cuda import halo

    dtype = dtype or torch.float32
    label = label or ("kernel_bf16_b4" if dtype == torch.bfloat16
                      else "kernel_b4")
    gen = torch.Generator(dev).manual_seed(6)
    n, p = psg.n_devices, psg.halo_width
    where = "full_kg" if label.startswith("full_kg") else "main_path"
    rows = []
    for d in (64, 128):
        sends = b4_sends(psg, d, dtype, gen, dev)
        row = b4_shape_row(f"{where}/n{n}/P{p}/D{d}", sends, n=n, p=p, d=d)
        rows.append(row)
        emit(f"{label}_shape", **row)
        if not cases:
            continue
        k = n // 2
        emit(f"{label}_local_pairs", shape=row["shape"], processes=2,
             pairs_a_process=k * k, view_shape=[k, p, d],
             vec=b4_local_pairs(f"{label}_local_pairs/D{d}", sends, k),
             max_abs_err=0, twice_equal=True)
    if not cases:
        return rows

    def sends_of(n_, p_, d_, offset=0):
        out = []
        for _ in range(n_):
            buf = torch.randn(n_ * p_ * d_ + offset, device=dev,
                              generator=gen).to(dtype)
            out.append(buf[offset:].view(n_, p_, d_))
        return out

    elt = torch.empty((), dtype=dtype).element_size()
    cases = {"n1": sends_of(1, 7736, 64), "n2": sends_of(2, 7736, 64),
             "n3": sends_of(3, 1001, 24), "n8": sends_of(8, 3872, 128),
             "p1": sends_of(4, 1, 64), "d8": sends_of(4, 7736, 8),
             "odd_d": sends_of(4, 999, 37),
             "odd_d_whole_units": sends_of(4, 16, 37),
             "pair_not_tile_multiple": sends_of(4, 2500, 64),
             "past_l2_odd_pair": sends_of(4, 20001, 128),
             "unaligned_views": sends_of(4, 7736, 64, offset=1),
             "offset_4_bytes": sends_of(4, 7736, 64, offset=4 // elt),
             "unaligned_odd": sends_of(3, 5, 3, offset=1)}
    for name, sends in cases.items():
        b4_equal(f"{label}/{name}", sends)
        _, p_, d_ = sends[0].shape
        vec = halo.vec_width(p_, d_, elt, [t.data_ptr() for t in sends])
        emit(f"{label}_case", case=name, n=len(sends),
             shape=list(sends[0].shape), vec=vec,
             path="vector" if vec > 1 else "element", max_abs_err=0,
             twice_equal=True)
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
    if not result["step_twice_equal"]:
        raise AssertionError(f"{label}: one step twice from one state gave "
                             f"other bits")
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
                      us_by_kind=bd["us_by_kind"],
                      top_kernels_us=bd["top_kernels_us"])
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


DP_STEPS = ("dp", "zero1", "zero3", "zero3_adafactor", "zero3_2x2")


def dp_launches(name, n_shards=N_SHARDS):
    """Launches of one data-parallel sampled step in block mode over a slim
    CSR (no identity block): B3 twice a shard (one window fetch a layer);
    B2 once a shard for each layer's dedup backward, plus, once a shard,
    dp's and zero1's table-gather backward, or zero3's fetch backward, n_tp
    sorted sums an owner in each tp group (n_tp^2 a group: 16 flat, 8 on
    the (2, 2) mesh). ``"sparse_adafactor"`` is the one-device step: 2 B2
    (identity and dedup backward) and 2 B3."""
    if name == "sparse_adafactor":
        return {"B1": 0, "B2": 2, "B3": 2, "B4": 0}
    n_tp = 2 if name == "zero3_2x2" else n_shards
    fetch = n_shards * n_tp if name.startswith("zero3") else n_shards
    return {"B1": 0, "B2": 2 * n_shards + fetch, "B3": 2 * n_shards,
            "B4": 0}


def dp_step(name, csr, cfg, dev):
    """One data-parallel sampled step of ``DP_STEPS`` on 4 shards of the
    card (``zero3_2x2``: a (2, 2) mesh), or ``"sparse_adafactor"``, the
    one-device ``--sparse_emb --table_opt adafactor`` step: batch 1024,
    fanouts 15/10, block mode, adam lr 1e-3, clip 1.0 (the factored
    rule: clip 0). Returns (step, train config)."""
    from primekg_rgcn_tpu_torch.config import TrainConfig
    from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
    from primekg_rgcn_tpu_torch.train import sampled

    factored = name.endswith("adafactor")
    tcfg = TrainConfig(batch_size=1024, grad_clip=0.0 if factored else 1.0)
    kw = dict(fanouts=(15, 10), mode="block")
    if name == "sparse_adafactor":
        return sampled.build_sampled_train_step(
            csr, cfg, tcfg, sparse_emb=True, table_opt="adafactor",
            device=dev, **kw), tcfg
    mesh = (make_mesh_2d(2, 2, dev) if name == "zero3_2x2"
            else make_mesh(N_SHARDS, dev))
    if name == "dp":
        step = sampled.build_sampled_train_step_dp(csr, cfg, tcfg, mesh, **kw)
    elif name == "zero1":
        step = sampled.build_sampled_train_step_zero1(csr, cfg, tcfg, mesh,
                                                      **kw)
    else:
        step = sampled.build_sampled_train_step_zero3(
            csr, cfg, tcfg, mesh, table_opt="adafactor" if factored
            else "sgd", **kw)
    return step, tcfg


def dp_state(step, params0):
    """Fresh parameters (the table sharded for zero3) and optimizer."""
    params = fresh_params(params0)
    if hasattr(step, "shard_params"):
        params = step.shard_params(params)
    return params, step.init_optimizer(params)


class ReplayDraws:
    """A sampler ``draw`` that takes its uniforms from a generator on the
    first pass and gives the same ones again after ``rewind()``: the given
    draws of a step that runs more than once."""

    def __init__(self, gen, dev):
        self.gen, self.dev, self.seq, self.i = gen, dev, [], 0

    def __call__(self, shape):
        import torch

        if self.i == len(self.seq):
            self.seq.append(torch.rand(shape, generator=self.gen,
                                       device=self.dev))
        self.i += 1
        return self.seq[self.i - 1]

    def rewind(self):
        self.i = 0


def dp_given(step, cfg, pos, dev, seed=0):
    """Each shard's candidates, sampler draws and dropout mask, drawn once
    from a generator seeded ``seed`` in the step's order: the given inputs
    of every run that ``dp_run`` compares."""
    import torch

    from primekg_rgcn_tpu_torch.train.neg_sampling import candidate_batch

    gen = torch.Generator(dev).manual_seed(seed)
    given = {"cands": [], "draw": [], "enc_mask": []}
    for p in pos.view(step.mesh.n_shards, -1, 3):
        cands = candidate_batch(p[:, 0], p[:, 1], p[:, 2], cfg.num_nodes, 1,
                                generator=gen)
        draw = ReplayDraws(gen, dev)
        batch = step.sample(torch.cat(cands[:2]).to(torch.int32), draw)
        given["enc_mask"].append(torch.rand(
            (batch.blocks[0].m_out, cfg.hidden_dim), generator=gen,
            device=dev) < 1.0 - cfg.dropout)
        given["cands"].append(cands)
        given["draw"].append(draw)
    return given


def dp_run(step, params0, pos, given, dev, plain=False, calls=None):
    """One step from ``params0`` on the given inputs, through the kernels
    (their inputs recorded in ``calls`` when given) or, ``plain``, through
    their plain versions. Returns (loss, {leaf: gradient}, {leaf: full
    parameter after the step}, launches)."""
    import torch

    params, opt = dp_state(step, params0)
    for draw in given["draw"]:
        draw.rewind()
    reset_counts()
    mode = "plain" if plain else ("record", calls) if calls is not None \
        else None
    with (sampler_kernels(mode) if mode else contextlib.nullcontext()):
        loss, _ = step(params, opt, pos, torch.Generator(dev), **given)
    torch.cuda.synchronize()
    counts = read_counts()
    grads = {k: p.grad.clone() for k, p in named_leaves(params)}
    full = (step.full_params(params) if hasattr(step, "full_params")
            else params)
    return (loss.item(), grads,
            {k: p.detach().clone() for k, p in named_leaves(full)}, counts)


def dp_kernel_vs_plain(label, name, step, params0, cfg, pos, dev,
                       calls=None):
    """One step of ``name`` through the kernels and through their plain
    versions on the same given inputs: the launches asserted
    (``dp_launches``, none plain), the losses within 1e-5 and every
    gradient at the grad criterion. Returns (largest error, parameters
    after the kernel step, the kernel run's line)."""
    import numpy as np

    given = dp_given(step, cfg, pos, dev)
    kern = dp_run(step, params0, pos, given, dev, calls=calls)
    ref = dp_run(step, params0, pos, given, dev, plain=True)
    want = dp_launches(name)
    if kern[3] != want or any(ref[3].values()):
        raise AssertionError(f"{label}/{name}: launches kernel {kern[3]}, "
                             f"plain {ref[3]}; expected {want} and none")
    if not np.isfinite(kern[0]):
        raise AssertionError(f"{label}/{name}: non-finite loss")
    np.testing.assert_allclose(kern[0], ref[0], rtol=1e-5)
    err = max(close_scaled(kern[1][k], ref[1][k], f"{label}/{name}/{k}")
              for k in ref[1])
    return err, kern[2], dict(loss_kernel=kern[0], loss_plain=ref[0],
                              launches=kern[3], max_abs_err=err)


def phase_sampled_dp_grad(graph, cfg, edges, dev):
    """One step each of dp, zero1 and zero3 at 4 shards (block over the
    slim pairs CSR, batch 1024: 1,024 seeds a shard) on given per-shard
    candidates, draws and dropout masks, through B2 and B3 and through
    their plain versions (``dp_kernel_vs_plain``); then the parameters
    after the step, zero1 against dp and zero3 against zero1, at the grad
    criterion. Returns the largest error and the B2 calls of the zero3
    step (recorded)."""
    params0, _, pos, csrs = sampled_setup(graph, cfg, edges, dev)
    after, out, max_err, calls = {}, {}, 0.0, {}
    for name in ("dp", "zero1", "zero3"):
        step, _ = dp_step(name, csrs["slim"], cfg, dev)
        err, after[name], out[name] = dp_kernel_vs_plain(
            "sampled_dp_grad", name, step, params0, cfg, pos, dev,
            calls=calls if name == "zero3" else None)
        max_err = max(max_err, err)
    for a, b in (("zero1", "dp"), ("zero3", "zero1")):
        errs = [close_scaled(after[a][k], after[b][k],
                             f"sampled_dp_grad/{a}_vs_{b}/{k}")
                for k in after[b]]
        out[f"{a}_vs_{b}_max_abs_err"] = max(errs)
    emit("sampled_dp_grad", shards=N_SHARDS, **out)
    return max_err, calls["b2"]


def phase_kernel_b2_fetch(calls, n_loc):
    """B2 on one (owner, requester) chunk of zero3's fetch backward,
    recorded from a step (owner 0, requester 1: the requester's frontier
    rows, those of other owners zero, into the owner's n_loc-row slice):
    against its plain version, two launches ``torch.equal``, kernel, plain
    and ``index_add_`` times beside the bound (``b2_stream_row``); and the
    device time of all n_tp^2 chunk sums of one step. Returns the row."""
    fetch = [c for c in calls if c[2] == n_loc]
    if len(fetch) != N_SHARDS * N_SHARDS:
        raise AssertionError(f"kernel_b2: {len(fetch)} fetch-backward "
                             f"calls, expected {N_SHARDS * N_SHARDS}")
    msg, srt, n = fetch[1]
    row = b2_stream_row("kernel_b2", "zero3_fetch_backward_chunk", msg, srt,
                        n)
    from primekg_rgcn_tpu_torch.ops.cuda import dense_segment_sum as pds

    t = time_calls({"fetch_backward_all": lambda: [
        pds.launch(*c) for c in fetch]})
    row.update(chunks_per_step=len(fetch), **t)
    emit("kernel_b2_fetch_backward_all", chunks=len(fetch), **t)
    return row


def dp_timed(label, name, step, params, opt, tcfg, edges_dev, dev, tmp,
             steps, edges_n, want=None, extra=None):
    """``steps`` timed steps after 3 warm-up (a fresh host batch each, the
    pinned copy), launches asserted (``want`` per step, by default
    ``dp_launches(name)``), peak memory, a 10-step profile, and
    ``step_twice_equal``, which must hold. ``edges_dev`` is the [E, 3]
    positives on the card, or on the host (a numpy array: each batch is
    gathered there and copied over). ``extra`` joins the line. Returns the
    figures."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.utils.telemetry import (profile_trace,
                                                        trace_breakdown)

    gen = torch.Generator(dev).manual_seed(0)
    rng = np.random.default_rng(0)

    def batch():
        idx = rng.integers(0, edges_n, tcfg.batch_size)
        if isinstance(edges_dev, np.ndarray):
            return torch.from_numpy(edges_dev[idx].astype(
                np.int64)).pin_memory().to(dev, non_blocking=True)
        return edges_dev[torch.from_numpy(idx).pin_memory().to(
            dev, non_blocking=True)]

    def one():
        return step(params, opt, batch(), gen)

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
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    want = {k: v * steps
            for k, v in (want or dp_launches(name)).items()}
    if counts != want:
        raise AssertionError(f"{label}/{name}: launches {counts}, expected "
                             f"{want}")
    losses = [float(first[0]), float(last[0])]
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{label}/{name}: non-finite loss {losses}")
    twice = step_twice_equal(step, params, opt, batch(), dev)
    if not twice:
        raise AssertionError(f"{label}/{name}: two runs of one step from one "
                             f"state differ")
    result = dict(config=name, steps=steps, batch_size=tcfg.batch_size,
                  step_ms=step_ms,
                  train_edges_per_s=tcfg.batch_size / step_ms * 1e3,
                  launches=counts,
                  launches_per_step={k: v / steps for k, v in counts.items()},
                  peak_memory_mb=peak_mb, first_loss=losses[0],
                  last_loss=losses[1], step_twice_equal=twice,
                  **(extra or {}))
    prof_steps = 10
    torch.cuda.synchronize()
    with profile_trace(tmp / f"{label}_{name}_profile"):
        t0 = time.perf_counter()
        for _ in range(prof_steps):
            one()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) / prof_steps * 1e3
    bd = trace_breakdown(tmp / f"{label}_{name}_profile" / "trace.json")
    if bd is None:
        result["idle_share"] = "not measured"
    else:
        busy_ms = bd["busy_us"] / prof_steps / 1e3
        result.update(step_ms_under_profiler=prof_ms,
                      device_busy_ms_per_step=busy_ms,
                      idle_share=bd["idle_share"],
                      idle_share_two_windows=1.0 - busy_ms / step_ms,
                      us_by_kind=bd["us_by_kind"],
                      top_kernels_us=bd["top_kernels_us"])
    emit(label, **result)
    return result


def phase_sampled_dp_train(graph, cfg, edges, dev, tmp, steps=20):
    """dp, zero1, zero3, zero3 with the factored table rule (clip 0) and
    zero3 on a (2, 2) mesh, each at 4 shards, and the one-device
    ``--sparse_emb --table_opt adafactor`` step: ``dp_timed`` each. Returns
    {config: figures}."""
    params0, edges_dev, _, csrs = sampled_setup(graph, cfg, edges, dev)
    results = {}
    for name in (*DP_STEPS, "sparse_adafactor"):
        step, tcfg = dp_step(name, csrs["slim"], cfg, dev)
        params, opt = dp_state(step, params0)
        results[name] = dp_timed("sampled_dp_train", name, step, params, opt,
                                 tcfg, edges_dev, dev, tmp, steps,
                                 edges.shape[0])
        del step, params, opt
    return results


def phase_full_kg_zero3(graph, cfg, edges, dev, tmp):
    """Config 4's graph (129,375 nodes, 30 relations), zero3 at 4 shards,
    block over the slim CSR: one step through the kernels against their
    plain versions (``dp_kernel_vs_plain``), then 10 timed steps
    (``dp_timed``). Returns (largest error, figures)."""
    params0, edges_dev, pos, csrs = sampled_setup(graph, cfg, edges, dev)
    step, tcfg = dp_step("zero3", csrs["slim"], cfg, dev)
    err, _, grad_line = dp_kernel_vs_plain("full_kg_zero3_grad", "zero3",
                                           step, params0, cfg, pos, dev)
    emit("full_kg_zero3_grad", **grad_line)
    params, opt = dp_state(step, params0)
    return err, dp_timed("full_kg_zero3", "zero3", step, params, opt, tcfg,
                         edges_dev, dev, tmp, 10, edges.shape[0])


def phase_sampled_dp_cli(tmp):
    """``train.cli.main --sample_fanouts 15 10 --sample_mode block --shard
    edge --n_devices 4`` at synthetic scale 0.1 for 2 epochs with
    ``--zero1``, and with ``--zero3 --table_opt adafactor --grad_clip 0
    --val_sampled``, then that one resumed for a third epoch;
    ``evaluate.cli.main`` on each final model (AUC-ROC and MRR finite).
    Returns {run: launches}, the evaluations' included."""
    import numpy as np

    from primekg_rgcn_tpu_torch.train import checkpoint
    from primekg_rgcn_tpu_torch.train import cli as train_cli

    base = ["--synthetic", "--synthetic_scale", "0.1", "--seed", "0",
            "--device", "cuda", "--sample_fanouts", "15", "10",
            "--sample_mode", "block", "--shard", "edge", "--n_devices",
            str(N_SHARDS)]
    zero3 = ["--zero3", "--table_opt", "adafactor", "--grad_clip", "0",
             "--val_sampled"]
    z3_out = tmp / "sampled_dp_cli_zero3"
    runs = {"zero1": ["--zero1", "--epochs", "2"],
            "zero3": [*zero3, "--epochs", "2"],
            "zero3_resumed": [*zero3, "--epochs", "3", "--resume",
                              str(z3_out / "models" / "final_model.pt")]}
    launches = {}
    for name, extra in runs.items():
        out = tmp / f"sampled_dp_cli_{name}"
        reset_counts()
        t0 = time.perf_counter()
        result = train_cli.main([*base, *extra, "--output_dir", str(out)])
        seconds = time.perf_counter() - t0
        launches[name] = read_counts()
        hist = result["history"]
        problems = []
        if not np.all(np.isfinite(hist["train_losses"] + hist["val_losses"])):
            problems.append(f"losses {hist}")
        if len(hist["train_losses"]) != (3 if name.endswith("resumed")
                                         else 2):
            problems.append(f"history {hist}")
        payload = checkpoint.load(out / "models" / "final_model.pt")
        cfg_n = payload["model_config"]["num_nodes"]
        if payload["params"]["encoder"]["node_emb"].shape[0] != cfg_n:
            problems.append("the checkpoint's table is not the full one")
        if launches[name]["B2"] == 0:
            problems.append(f"launches {launches[name]}")
        if problems:
            raise AssertionError(f"sampled_dp_cli/{name}: "
                                 + "; ".join(problems))
        emit("sampled_dp_cli", run=name, seconds=seconds,
             launches=launches[name], history=hist,
             epoch_time_s=result["epoch_times_s"],
             optimizer_state=sorted(payload["optimizer_state_dict"]))
        if name != "zero3":
            launches[f"eval_after_{name}"] = eval_cli_after(
                out, f"sampled_dp_cli_{name}")
    return launches


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
    and final checkpoints; the epoch runs as CUDA graphs under the
    profiler, which counts B1 2R an update (2R more per fallback) and 2R
    for the validation encode, B2 one an update that took the restricted
    layer; the wrappers count the Python runs only: 2R B1 and 1 B2 each
    for the restricted branch's warm-up and capture, 4R B1 each for the
    full one's (when a batch overflows), 2R B1 for the validation's
    warm-up encode; every loss finite. Returns the profile's counts."""
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
    result = {}
    kernels, _, _ = profiled(lambda: result.update(trainer.train()),
                             tmp / "full_kg_trainer_profile")
    seconds = time.perf_counter() - t0
    counts = read_counts()
    fallbacks = pfl.final_layer_restricted.fallbacks - fallbacks
    steps = 45
    # Every update's kernels run once, at its warm-up or at a replay: 2R B1
    # and 1 B2 an update through the restricted layer, 4R B1 a fallback,
    # 2R B1 for the validation encode, as the eager epoch launched them.
    want = {"B1": 2 * r * (steps + fallbacks + 1), "B2": steps - fallbacks,
            "B3": 0, "B4": 0}
    if kernels != want:
        raise AssertionError(f"full_kg_trainer: kernels in the profile "
                             f"{kernels}, expected {want} ({fallbacks} "
                             f"fallbacks); {profiled.last_span}")
    # The epoch runs as CUDA graphs: a wrapper counts its launches when its
    # Python runs, at a body's eager warm-up and at its capture, not at a
    # replay. Each branch of the restricted layer runs its Python twice at
    # most (2R B1 and 1 B2 the restricted one, 4R B1 the full one), the
    # validation epoch once (its warm-up: one encode, 2R).
    fast_py, full_py = min(steps - fallbacks, 2), min(fallbacks, 2)
    want_py = {"B1": 2 * r * fast_py + 4 * r * full_py + 2 * r,
               "B2": fast_py, "B3": 0, "B4": 0}
    if counts != want_py or trainer.graphs.replays < steps - 4:
        raise AssertionError(f"full_kg_trainer: launches {counts}, expected "
                             f"{want_py} ({fallbacks} fallbacks), "
                             f"{trainer.graphs.replays} replays")
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
         launches=kernels, launches_in_python=counts,
         replays=trainer.graphs.replays,
         captures=trainer.graphs.captures,
         train_loss=hist["train_losses"][0],
         val_loss=hist["val_losses"][0], epoch_s=result["epoch_times_s"][0],
         setup_s=setup_s, seconds=seconds,
         train_edges_per_s=len(train_edges) / result["epoch_times_s"][0],
         e_cap_sum=sum(trainer.final_plan.e_cap), checkpoints=list(files))
    return kernels


# -- the combined reductions, the layer-1 cache and BASELINE config 5 ---------

COMBINED_AGGS = ("einsum", "rowwise", "chunked")


@contextlib.contextmanager
def combined_agg(impl):
    """``PRIMEKG_COMBINED_AGG`` set to ``impl`` (the sampler and the
    aggregation read it), restored after."""
    import os

    saved = os.environ.get("PRIMEKG_COMBINED_AGG")
    os.environ["PRIMEKG_COMBINED_AGG"] = impl
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("PRIMEKG_COMBINED_AGG")
        else:
            os.environ["PRIMEKG_COMBINED_AGG"] = saved


def phase_combined_agg(graph, cfg, edges, dev, tmp):
    """Config 4 (the full-PrimeKG graph, uniform at fanouts 15/10, adam lr
    1e-3, clip 1.0) under each per-(node, relation) reduction: one step's
    loss and gradients (``sampled_forward_backward``, the same draws) of
    the rowwise and the chunked reduction against the einsum's, within
    1e-5 and at the grad criterion; then 10 timed steps each
    (``dp_timed``: 2 B2 a step, the identity and the dedup backward;
    step_ms, busy, peak memory). Returns ({impl: figures}, largest
    error)."""
    import numpy as np

    from primekg_rgcn_tpu_torch.config import TrainConfig
    from primekg_rgcn_tpu_torch.train.sampled import build_sampled_train_step

    from primekg_rgcn_tpu_torch.data.sampling import build_combined_csr

    params0, edges_dev, pos, _ = sampled_setup(graph, cfg, edges, dev)
    ccsr = build_combined_csr(graph)
    tcfg = TrainConfig(batch_size=1024)
    runs, results, max_err = {}, {}, 0.0
    for impl in COMBINED_AGGS:
        with combined_agg(impl):
            step = build_sampled_train_step(ccsr, cfg, tcfg,
                                            fanouts=(15, 10),
                                            mode="uniform", device=dev)
            reset_counts()
            loss, grads, batch = sampled_forward_backward(step, params0, cfg,
                                                          pos, dev)
            counts = read_counts()
            if not batch.blocks[0].ident or counts["B2"] != 2:
                raise AssertionError(f"combined_agg/{impl}: identity inner "
                                     f"block {batch.blocks[0].ident}, "
                                     f"launches {counts}")
            if batch.blocks[1].tags_sorted != (impl != "einsum"):
                raise AssertionError(f"combined_agg/{impl}: tags_sorted "
                                     f"{batch.blocks[1].tags_sorted}")
            runs[impl] = (loss, grads)
            line = {"loss": loss, "budgets": list(step.budgets)}
            if impl != "einsum":
                ref_loss, ref = runs["einsum"]
                np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
                errs = {k: close_scaled(grads[k], ref[k],
                                        f"combined_agg/{impl}/{k}")
                        for k in ref}
                max_err = max(max_err, *errs.values())
                line.update(loss_einsum=ref_loss,
                            max_abs_err_vs_einsum=max(errs.values()))
            del grads, batch
            params = fresh_params(params0)
            opt = step.init_optimizer(params)
            results[impl] = dp_timed(
                "combined_agg", impl, step, params, opt, tcfg, edges_dev, dev,
                tmp, 10, edges.shape[0],
                want={"B1": 0, "B2": 2, "B3": 0, "B4": 0}, extra=line)
            del step, params, opt
    return results, max_err


def cached_forward_backward(step, params, cfg, pos, dev, cache, seed=0):
    """One cached step's loss and gradients (no update) on a copy of
    ``cache``: the frontier rows as a leaf (``x0``, as the sparse step
    gathers them), every draw from one generator seeded ``seed``. Returns
    (loss, {leaf or "x0": grad}, updated cache copy)."""
    import torch

    from primekg_rgcn_tpu_torch.data.sampling import uniform_draw
    from primekg_rgcn_tpu_torch.train.neg_sampling import candidate_batch
    from primekg_rgcn_tpu_torch.train.sampled import sampled_loss

    n = cfg.num_nodes
    gen = torch.Generator(dev).manual_seed(seed)
    cands = candidate_batch(pos[:, 0], pos[:, 1], pos[:, 2], n, 1,
                            generator=gen)
    batch = step.sample(torch.cat([cands[0], cands[1]]).to(torch.int32),
                        uniform_draw(gen, dev))
    leaves = list(named_leaves(params))
    for _, p in leaves:
        p.grad = None
    with torch.no_grad():
        x0 = params["encoder"]["node_emb"][
            batch.frontier.clamp(max=n - 1).long()].masked_fill(
            (batch.frontier == n)[:, None], 0.0)
    x0.requires_grad_(True)
    cache = cache.clone()
    loss, _ = sampled_loss(params, batch, cands, cfg, train=True,
                           generator=gen, x0=x0, cache=cache)
    loss.backward()
    torch.cuda.synchronize()
    grads = {k: p.grad.clone() for k, p in leaves if p.grad is not None}
    grads["x0"] = x0.grad.clone()
    return loss.item(), grads, cache


def phase_sampled_cache(graph, cfg, edges, dev, tmp):
    """The layer-1 cache on the ``bench.py`` graph: ``SampledTrainer(
    cache_layer1=True)``'s warm start (one conv1 pass through B1, a launch
    per relation) against the same pass through B1's plain version; one
    cached step (uniform, fanouts 15/10, one hop) from that cache, its loss,
    gradients and pushed cache through B2 against the plain versions (2 B2:
    conv1's and conv2's dedup backward); then ``train.cli --sample_fanouts
    15 10 --sparse_emb --cache_layer1`` at scale 0.1 for 2 epochs and
    ``evaluate.cli`` on its model. Returns ({"warm_start", "cached_step",
    "cli", "eval_after_cli": launches}, largest error)."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.config import TrainConfig
    from primekg_rgcn_tpu_torch.ops.rgcn_segment import (aggregate_plain,
                                                         rgcn_layer_segment)
    from primekg_rgcn_tpu_torch.train import cli as train_cli
    from primekg_rgcn_tpu_torch.train.sampled import SampledTrainer

    tcfg = TrainConfig(batch_size=1024, optimizer="sgd", grad_clip=0.0,
                       epochs=1)
    reset_counts()
    trainer = SampledTrainer(cfg, tcfg, graph, graph, edges, edges[:2048],
                             tmp / "sampled_cache_trainer", fanouts=(15, 10),
                             sparse_emb=True, cache_layer1=True, device=dev)
    warm = read_counts()
    enc = trainer.params["encoder"]
    with torch.no_grad():
        want = rgcn_layer_segment(enc["conv1"], enc["node_emb"], graph,
                                  agg_fn=aggregate_plain)
    buckets = sum(e > s for s, e in map(graph.bucket_slice,
                                        range(graph.num_relations)))
    if warm != {"B1": buckets, "B2": 0, "B3": 0, "B4": 0}:
        raise AssertionError(f"sampled_cache: warm-start launches {warm}, "
                             f"expected {buckets} B1")
    warm_err = close_scaled(trainer.optimizer.cache, want,
                            "sampled_cache/warm_start")
    step = trainer.step_fn
    params0, _, pos, _ = sampled_setup(graph, cfg, edges, dev)
    runs = {}
    for impl in ("kernel", "plain"):
        reset_counts()
        with (sampler_kernels("plain") if impl == "plain"
              else contextlib.nullcontext()):
            runs[impl] = (*cached_forward_backward(
                step, params0, cfg, pos, dev, trainer.optimizer.cache),
                read_counts())
    if runs["kernel"][3] != {"B1": 0, "B2": 2, "B3": 0, "B4": 0} or \
            any(runs["plain"][3].values()):
        raise AssertionError(f"sampled_cache: launches kernel "
                             f"{runs['kernel'][3]}, plain {runs['plain'][3]}")
    np.testing.assert_allclose(runs["kernel"][0], runs["plain"][0], rtol=1e-5)
    errs = {k: close_scaled(runs["kernel"][1][k], v, f"sampled_cache/{k}")
            for k, v in runs["plain"][1].items()}
    errs["cache"] = close_scaled(runs["kernel"][2], runs["plain"][2],
                                 "sampled_cache/cache")
    max_err = max(warm_err, *errs.values())
    emit("sampled_cache", warm_start_launches=warm,
         warm_start_max_abs_err=warm_err, budgets=list(step.budgets),
         step_launches=runs["kernel"][3], loss_kernel=runs["kernel"][0],
         loss_plain=runs["plain"][0], max_abs_err=errs,
         cache_mb=trainer.optimizer.cache.numel()
         * trainer.optimizer.cache.element_size() / 2 ** 20)
    launches = {"warm_start": warm, "cached_step": runs["kernel"][3]}
    del trainer, step, runs

    out = tmp / "sampled_cache_cli"
    reset_counts()
    t0 = time.perf_counter()
    result = train_cli.main([
        "--synthetic", "--synthetic_scale", "0.1", "--epochs", "2", "--seed",
        "0", "--device", "cuda", "--sample_fanouts", "15", "10",
        "--sparse_emb", "--optimizer", "sgd", "--grad_clip", "0", "--lr",
        "0.5", "--cache_layer1", "--output_dir", str(out)])
    seconds = time.perf_counter() - t0
    launches["cli"] = read_counts()
    hist = result["history"]
    if not np.all(np.isfinite(hist["train_losses"] + hist["val_losses"])) \
            or launches["cli"]["B1"] == 0 or launches["cli"]["B2"] == 0:
        raise AssertionError(f"sampled_cache/cli: history {hist}, launches "
                             f"{launches['cli']}")
    emit("sampled_cache_cli", seconds=seconds, launches=launches["cli"],
         history=hist, epoch_time_s=result["epoch_times_s"])
    launches["eval_after_cli"] = eval_cli_after(out, "sampled_cache_cli")
    return launches, max_err


RMAT10M = (10_000_000, 100_000_000, 50)


def host_peak_rss_mb():
    """The process's peak resident set on the host, in MB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def phase_rmat10m_graph(dev, size=RMAT10M):
    """BASELINE config 5's graph, as the JAX suite builds it
    (``bench/suite.py:175-195``): ``native.rmat_native(10M, 100M, 50,
    seed=0)`` (numpy ``rmat`` without the library), not bidirected, then
    ``build_rel_graph`` (the C++ builder) and ``build_combined_csr`` (slim
    packed: the fat degree table would be 1 GB), each timed, the host's
    peak RSS after each, and the budgets at fanouts 15/10. Only the
    combined CSR moves to the card; the graph is dropped. ``size`` is
    (nodes, edges, relations). Returns (CSR on the card, positives [E, 3]
    int32 on the host)."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch import native
    from primekg_rgcn_tpu_torch.data import synthetic
    from primekg_rgcn_tpu_torch.data.graph import build_rel_graph
    from primekg_rgcn_tpu_torch.data.sampling import build_combined_csr
    from primekg_rgcn_tpu_torch.train.sampled import resolve_sampler

    n, e, r = size
    line, t0 = {}, time.perf_counter()
    g = native.rmat_native(n, e, r, seed=0)
    line["generator"] = "rmat_native" if g is not None else "numpy rmat"
    if g is None:
        g = synthetic.rmat(n, e, r, seed=0)
    line.update(rmat_s=time.perf_counter() - t0,
                rss_mb_after_rmat=host_peak_rss_mb())
    src, dst, rel = g["src"], g["dst"], g["rel"]
    edges = np.stack([src, dst, rel], 1).astype(np.int32)
    t0 = time.perf_counter()
    graph = build_rel_graph(src, dst, rel, n, int(rel.max()) + 1)
    line.update(build_rel_graph_s=time.perf_counter() - t0,
                rss_mb_after_build_rel_graph=host_peak_rss_mb(),
                relations=graph.num_relations, edges=graph.num_edges,
                padded_edges=graph.padded_num_edges,
                norm_mode=graph.norm_mode)
    del g, src, dst, rel
    t0 = time.perf_counter()
    ccsr = build_combined_csr(graph)
    line.update(build_combined_csr_s=time.perf_counter() - t0,
                rss_mb_after_build_combined_csr=host_peak_rss_mb())
    del graph
    if not ccsr.packed.shape[0]:
        raise AssertionError("rmat10m_graph: the CSR is not slim packed")
    line["budgets"] = list(resolve_sampler(ccsr, (15, 10))[1])
    names = ("row_start", "col", "rel", "edge_deg", "deg_total",
             "deg_rel_flat", "packed")
    t0 = time.perf_counter()
    ccsr = ccsr.to(dev)
    torch.cuda.synchronize()
    deg = ccsr.deg_total.max().item()
    emit("rmat10m_graph", nodes=n, **line, layout="slim packed",
         packed_records=ccsr.packed.shape[0],
         avg_present_relations=ccsr.avg_present_relations,
         max_in_degree=deg, to_card_s=time.perf_counter() - t0,
         bytes_to_card=sum(getattr(ccsr, k).numel()
                           * getattr(ccsr, k).element_size() for k in names),
         host_peak_rss_mb=host_peak_rss_mb())
    return ccsr, edges


def rmat10m_setup(ccsr, cfg, edges, dev, seed=0):
    """Config 5's parameters (``rgcn.init_params`` from ``seed``) and one
    batch of 1,024 positives on the card."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.models import rgcn

    params = rgcn.init_params(torch.Generator().manual_seed(seed), cfg,
                              device=dev)
    for _, p in named_leaves(params):
        p.requires_grad_(True)
    pos = torch.from_numpy(edges[np.random.default_rng(seed).integers(
        0, edges.shape[0], 1024)].astype(np.int64)).to(dev)
    return params, pos


def rmat10m_step(ccsr, cfg, dev, mode="uniform", cache=False):
    """Config 5's sampled step as the JAX suite builds it: batch 1024,
    fanouts 15/10, ``sparse_emb``, plain SGD for every leaf (lr 1e-3) and
    no clip; ``cache``: the cached step (cold start)."""
    from primekg_rgcn_tpu_torch.config import TrainConfig
    from primekg_rgcn_tpu_torch.train.sampled import build_sampled_train_step

    tcfg = TrainConfig(batch_size=1024, optimizer="sgd", grad_clip=0.0)
    return build_sampled_train_step(ccsr, cfg, tcfg, fanouts=(15, 10),
                                    mode=mode, sparse_emb=True,
                                    cache_layer1=cache, device=dev), tcfg


def phase_rmat10m_grad(ccsr, cfg, edges, dev):
    """One uniform config-5 step's loss and gradients through B2 and
    through its plain version on the same draws (``sampled_forward_
    backward``: the dense table gradient, as the sparse step takes it from
    the identity block), under PERF §2's bf16 criterion: every gradient
    within 1e-2 of its largest magnitude, the losses within 1e-3; 2 B2
    launches, both bf16 ones; the innermost block identity, the outer one
    not. Then B2 on the step's two streams, recorded from it
    (``b2_stream_row``: against its plain version, twice ``torch.equal``,
    timed beside ``index_add_`` and the bound). Returns (largest error,
    the B2 rows)."""
    import numpy as np

    step, _ = rmat10m_step(ccsr, cfg, dev)
    params, pos = rmat10m_setup(ccsr, cfg, edges, dev)
    runs = {}
    for impl in ("kernel", "plain"):
        reset_counts()
        with (sampler_kernels("plain") if impl == "plain"
              else contextlib.nullcontext()):
            loss, grads, batch = sampled_forward_backward(step, params, cfg,
                                                          pos, dev)
        runs[impl] = (loss, grads, read_counts(), read_bf16_counts())
    if not batch.blocks[0].ident or batch.blocks[1].ident:
        raise AssertionError("rmat10m_grad: expected an identity inner block "
                             "and a dedup outer block")
    want = {"B1": 0, "B2": 2, "B3": 0, "B4": 0}
    if runs["kernel"][2] != want or any(runs["plain"][2].values()):
        raise AssertionError(f"rmat10m_grad: launches kernel "
                             f"{runs['kernel'][2]}, plain {runs['plain'][2]}")
    only_bf16("rmat10m_grad", *runs["kernel"][2:])
    if not np.isfinite(runs["kernel"][0]):
        raise AssertionError("rmat10m_grad: non-finite loss")
    np.testing.assert_allclose(runs["kernel"][0], runs["plain"][0], rtol=1e-3)
    per_leaf, max_err = {}, 0.0
    for name, want_g in runs["plain"][1].items():
        rel = close_rel(runs["kernel"][1][name], want_g, 1e-2,
                        f"rmat10m_grad/{name}")
        top = float(want_g.abs().max())
        per_leaf[name] = {"max_rel_err": rel, "max_abs": top}
        max_err = max(max_err, rel * top)
    emit("rmat10m_grad", budgets=list(step.budgets),
         loss_kernel=runs["kernel"][0], loss_plain=runs["plain"][0],
         launches=runs["kernel"][2], leaves=per_leaf,
         ident_rows=batch.blocks[0].sort_uid.numel(),
         outer_frontier=batch.blocks[1].m_in,
         ident_fraction=batch.blocks[0].sort_uid.numel() / (cfg.num_nodes + 1))
    del runs, grads, batch
    streams = sampled_b2_streams("rmat10m_b2", step, params, cfg, pos, dev)
    rows = [b2_stream_row("kernel_b2", name, *streams[key])
            for name, key in (("config5_ident_backward", "ident"),
                              ("config5_dedup_backward", "dedup"))]
    return max_err, rows


def phase_rmat10m_b3(ccsr, cfg, edges, dev):
    """B3 at config 5's shapes (``rmat10m_b3_streams``: one block and one
    block4 batch's windows over the 100M-record table), each
    ``b3_shape_row``: exactly equal to the plain version, two launches
    equal, timed beside the row gather and the bound; at the two inner
    layers also with a cold L2. Returns the rows."""
    return [b3_shape_row(name, packed, starts, width,
                         cold=name.endswith("inner"),
                         records=packed.view(-1, 2).shape[0])
            for name, packed, starts, width in rmat10m_b3_streams(
                ccsr, cfg, edges, dev)]


def phase_rmat10m_sampled(ccsr, cfg, edges, dev, tmp, steps=15):
    """Config 5's step in uniform, block and block4 mode: 3 warm-up and
    ``steps`` timed steps each, a fresh batch of 1,024 positives from the
    host each step (``dp_timed``: launches asserted, 2 B2 a step, and 2 B3
    in the block modes; peak memory; a 10-step profile;
    ``step_twice_equal``, which must hold). Then the cached step
    (``rmat10m_cache``, uniform, cold cache: 2 B2 a step, conv1's and
    conv2's dedup backward), with the cache's MB. Returns {config:
    figures}."""
    results = {}
    for mode in ("uniform", "block", "block4"):
        step, tcfg = rmat10m_step(ccsr, cfg, dev, mode)
        params, _ = rmat10m_setup(ccsr, cfg, edges, dev)
        opt = step.init_optimizer(params)
        results[mode] = dp_timed(
            "rmat10m_sampled", mode, step, params, opt, tcfg, edges, dev, tmp,
            steps, edges.shape[0],
            want={"B1": 0, "B2": 2, "B3": 0 if mode == "uniform" else 2,
                  "B4": 0}, extra={"budgets": list(step.budgets)})
        del step, params, opt
    step, tcfg = rmat10m_step(ccsr, cfg, dev, cache=True)
    params, _ = rmat10m_setup(ccsr, cfg, edges, dev)
    opt = step.init_optimizer(params)
    cache_mb = opt.cache.numel() * opt.cache.element_size() / 2 ** 20
    results["cache"] = dp_timed(
        "rmat10m_cache", "uniform", step, params, opt, tcfg, edges, dev, tmp,
        steps, edges.shape[0], want={"B1": 0, "B2": 2, "B3": 0, "B4": 0},
        extra={"budgets": list(step.budgets), "cache_mb": cache_mb,
               "cache_dtype": str(opt.cache.dtype).replace("torch.", "")})
    # The cold cache's rows that the run's seeds have filled.
    results["cache"]["cache_rows_written"] = int((opt.cache != 0).any(1).sum())
    emit("rmat10m_cache_rows", rows_written=results["cache"][
        "cache_rows_written"], nodes=cfg.num_nodes)
    return results


# -- device-resident epochs: the trainers' CUDA graphs ------------------------

KERNEL_NAMES = {"B1": "gather_segment_sum_kernel",
                "B2": "dense_segment_sum_kernel",
                "B3": "window_rows_fetch_kernel",
                "B4": "halo_exchange_kernel"}


# Marker kernels around a profiled run: ``torch.cuda._sleep``'s
# ``spin_kernel``, which the port never launches, MARKS before and MARKS
# after, each followed by a synchronise.
MARKER_KERNEL = "spin_kernel"
MARKS = 8


def profiled(fn, prof_dir):
    """``fn()`` under ``torch.profiler``: (kernel launches by id counted in
    its trace, the trace's breakdown (``trace_breakdown``), host ms). The
    graphed phases count launches here: a wrapper's counter counts once
    per capture, not per replay. ``profiled.last_span["markers"]`` is the
    number of marker kernels the trace holds (2 * MARKS when it lost no
    record at its start or its end), ``"head_markers"`` those before the
    run's first kernel (MARKS when it lost none at its start)."""
    import torch

    from primekg_rgcn_tpu_torch.utils.telemetry import (profile_trace,
                                                        trace_breakdown)

    def marks():
        for _ in range(MARKS):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()

    torch.cuda.synchronize()
    with profile_trace(prof_dir):
        marks()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        marks()
    path = prof_dir / "trace.json"
    kernels = sorted((e["ts"], e["name"])
                     for e in json.loads(path.read_text())["traceEvents"]
                     if e.get("ph") == "X" and e.get("cat") == "kernel")
    counts = {k: sum(kernel in name for _, name in kernels)
              for k, kernel in KERNEL_NAMES.items()}
    # Where each kernel's launches sit in the trace (count, first and last
    # as ms after its first kernel, and its last kernel's), for a caller
    # whose counts disagree to print.
    first, last = (kernels[0][0], kernels[-1][0]) if kernels else (0, 0)
    marks_at = [i for i, (_, name) in enumerate(kernels)
                if MARKER_KERNEL in name]
    work_at = [i for i, (_, name) in enumerate(kernels)
               if MARKER_KERNEL not in name]
    profiled.last_span = {
        "kernels": len(kernels), "window_ms": (last - first) / 1e3,
        "markers": len(marks_at),
        "head_markers": sum(i < work_at[0] for i in marks_at)
        if work_at else len(marks_at)}
    for k, kernel in KERNEL_NAMES.items():
        ts = [t for t, name in kernels if kernel in name]
        if ts:
            profiled.last_span[k] = (len(ts), (ts[0] - first) / 1e3,
                                     (ts[-1] - first) / 1e3)
    return counts, trace_breakdown(path), ms


def flat_tensors(obj, prefix=""):
    """(name, tensor) of every tensor in nested dicts, lists and tuples."""
    import torch

    if isinstance(obj, torch.Tensor):
        yield prefix, obj
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from flat_tensors(v, f"{prefix}/{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from flat_tensors(v, f"{prefix}/{i}")


def run_state(params, opt, gen, **extra):
    """Copies of every parameter, optimizer-state tensor and of the
    generator's state, by name (``extra``: more tensors)."""
    state = {f"params/{k}": v.detach().clone()
             for k, v in named_leaves(params)}
    state.update((f"opt{k}", v.detach().clone())
                 for k, v in flat_tensors(opt.state_dict()))
    state["generator"] = gen.get_state()
    state.update((k, v.detach().clone()) for k, v in extra.items())
    return state


def differing(want, got):
    """The names whose tensors are not ``torch.equal``."""
    import torch

    return [k for k in want if not torch.equal(want[k], got[k])]


# The traces ``graphed_timing`` took again, with what each lost.
PROFILE_RETAKES = []


def graphed_timing(label, run, steps, tmp, want=None, profile=True):
    """One timed epoch of ``run`` (a callable, its graphs captured) on the
    host clock with its peak memory, then, with ``profile``, one under the
    profiler: its kernel launches counted in the trace (held against
    ``want``, or against ``want(fallbacks)`` with the restricted layer's
    fallbacks in that epoch), device busy ms a step and the idle share.
    Returns the figures."""
    import torch

    from primekg_rgcn_tpu_torch.ops import rgcn_final_layer as pfl

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    fig = dict(step_ms=step_ms,
               peak_memory_mb=torch.cuda.max_memory_allocated() / 2 ** 20)
    if not profile:
        return fig
    # A trace can lose the records of the kernels launched first after it
    # starts (one config-3 epoch's trace held 1,437 of its 1,440 B1 and
    # none of the kernels launched before the epoch, its first kernel a
    # B1). A trace whose counts disagree is taken again, twice at most,
    # only when it lacks marker kernels (it lost records) and counts no
    # more than expected; a whole trace must agree exactly.
    for attempt in range(3):
        fallbacks = pfl.final_layer_restricted.fallbacks
        counts, bd, prof_ms = profiled(run,
                                       tmp / f"{label}_profile{attempt}")
        fallbacks = pfl.final_layer_restricted.fallbacks - fallbacks
        expected = want(fallbacks) if callable(want) else want
        if expected is None or counts == expected:
            break
        lost = profiled.last_span["markers"] < 2 * MARKS
        if not lost or any(counts[k] > v for k, v in expected.items()):
            raise AssertionError(f"{label}: kernels in the profile {counts}"
                                 f", expected {expected}; "
                                 f"{profiled.last_span}")
        print(f"## {label}: kernels in the profile {counts}, expected "
              f"{expected}; the trace lost records ({profiled.last_span}); "
              "traced again", flush=True)
        PROFILE_RETAKES.append({"phase": label, "counts": counts,
                                "expected": expected,
                                "span": profiled.last_span})
    else:
        raise AssertionError(f"{label}: kernels in the profile {counts}, "
                             f"expected {expected} in 3 traces, each of "
                             f"which lost records; {profiled.last_span}")
    if callable(want):
        fig["profiled_fallbacks"] = fallbacks
    fig["profile_attempts"] = attempt + 1
    fig["profile_markers"] = profiled.last_span["markers"]
    fig["profile_head_markers"] = profiled.last_span["head_markers"]
    per_step = {k: v / steps for k, v in counts.items()}
    fig["launches_per_step_from_profile"] = per_step
    if bd is None:
        fig.update(device_events=0, idle_share="not measured")
    else:
        busy_ms = bd["busy_us"] / steps / 1e3
        fig.update(device_busy_ms_per_step=busy_ms,
                   idle_share=bd["idle_share"],
                   idle_share_two_windows=1.0 - busy_ms / step_ms,
                   step_ms_under_profiler=prof_ms / steps,
                   top_kernels_us=bd["top_kernels_us"])
    return fig


def graph_figures(graphs):
    return dict(captures=graphs.captures, replays=graphs.replays,
                warmups=graphs.warmups, capture_s=graphs.capture_s)


def phase_train_graphed(graph, cfg, edges, dev, tmp, updates=34):
    """The full-graph epoch (``train/loop.build_train_epoch``) on the
    ``bench.py`` graph at full width, ``updates`` updates of 1,024 (adam,
    clip 1.0, dropout 0.5), as CUDA graphs (``train/graphs.StepGraphs``) at
    K = 1 (the default), 4 and 32 (34 = 8 x 4 + 2 and 32 + 2, a
    remainder each) against the same epochs run eagerly from one state: two
    epochs each (the first warms up and captures), then every parameter,
    adam state tensor, the epochs' (loss, acc) and the generator's state
    ``torch.equal``. Then per K one timed epoch and one profiled (12 B1 an
    update, counted in the trace), with peak memory and capture seconds;
    the eager epoch timed the same way. Only the default K and the eager
    epoch are profiled. Returns the figures."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.config import TrainConfig
    from primekg_rgcn_tpu_torch.models import rgcn
    from primekg_rgcn_tpu_torch.train import graphs as pgraphs
    from primekg_rgcn_tpu_torch.train import loop

    b = 1024
    pick = np.random.default_rng(3).permutation(edges.shape[0])
    train_edges = edges[pick[:updates * b]]

    def build(k, graphed):
        tcfg = TrainConfig(batch_size=b, steps_per_scan=k)
        params = rgcn.init_params(torch.Generator().manual_seed(0), cfg,
                                  device=dev)
        for _, p in named_leaves(params):
            p.requires_grad_(True)
        opt = loop.make_optimizer(tcfg, params)
        host, gen = (torch.Generator().manual_seed(1),
                     torch.Generator(dev).manual_seed(2))
        graphs = pgraphs.StepGraphs(dev, gen) if graphed else None
        fn = loop.build_train_epoch(graph, train_edges, cfg, tcfg, params,
                                    opt, graphs=graphs)
        if fn.final_plan is not None:
            raise AssertionError("train_graphed: the bench.py graph resolved "
                                 "to the restricted final layer")
        return params, opt, gen, graphs, lambda: torch.stack(fn(host, gen))

    def two_epochs(run):
        params, opt, gen, _, epoch = run
        stats = torch.stack([epoch() for _ in range(2)])
        return run_state(params, opt, gen, stats=stats)

    eager = build(0, False)
    want = two_epochs(eager)
    results = {"eager": graphed_timing("train_graphed_eager", eager[4],
                                       updates, tmp,
                                       {"B1": 12 * updates, "B2": 0, "B3": 0,
                                        "B4": 0})}
    del eager
    for k in (1, 4, 32):
        run = build(k, True)
        t0 = time.perf_counter()
        got = two_epochs(run)
        first_s = time.perf_counter() - t0
        bad = differing(want, got)
        if bad:
            raise AssertionError(f"train_graphed K={k}: the graphed epochs "
                                 f"differ from the eager ones in {bad}")
        results[f"k{k}"] = dict(
            graphed_timing(f"train_graphed_k{k}", run[4], updates, tmp,
                           {"B1": 12 * updates, "B2": 0, "B3": 0, "B4": 0},
                           profile=k == pgraphs.DEFAULT_STEPS_PER_GRAPH),
            first_two_epochs_s=first_s, **graph_figures(run[3]))
        del run
        gc.collect()
        torch.cuda.empty_cache()
    default = pgraphs.DEFAULT_STEPS_PER_GRAPH
    emit("train_graphed", updates_per_epoch=updates, batch_size=b,
         default_k=default, equal_to_eager=True,
         step_ms={k: v["step_ms"] for k, v in results.items()},
         device_busy_ms_per_step={k: v.get("device_busy_ms_per_step")
                                  for k, v in results.items()}, **results)
    results["default"] = results[f"k{default}"]
    return results


def phase_eval_graphed(graph, cfg, edges, dev, tmp, batches=16):
    """The validation epoch (``train/loop.build_eval_epoch``: one encode,
    then ``batches`` batches of 1,024 with their negatives, the last one
    partial) as one CUDA graph against the same epoch run eagerly: three
    epochs each from one generator state (warm-up, capture, replay), their
    (loss, acc) and the generator's state ``torch.equal``; then 5 timed
    epochs each and a profiled one (6 B1 an epoch). Returns the
    figures."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.config import TrainConfig
    from primekg_rgcn_tpu_torch.models import rgcn
    from primekg_rgcn_tpu_torch.train import graphs as pgraphs
    from primekg_rgcn_tpu_torch.train import loop

    pick = np.random.default_rng(4).permutation(edges.shape[0])
    val_edges = edges[pick[:batches * 1024 - 100]]
    params = rgcn.init_params(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    tcfg = TrainConfig(batch_size=1024)
    runs = {}
    for name in ("eager", "graphed"):
        gen = torch.Generator(dev).manual_seed(5)
        graphs = pgraphs.StepGraphs(dev, gen) if name == "graphed" else None
        fn = loop.build_eval_epoch(graph, val_edges, cfg, tcfg, graphs=graphs)
        epoch = (lambda fn=fn, gen=gen: torch.stack(fn(params, gen)))
        stats = torch.stack([epoch() for _ in range(3)])
        runs[name] = (epoch, graphs, {"stats": stats,
                                      "generator": gen.get_state()})
    bad = differing(runs["eager"][2], runs["graphed"][2])
    if bad:
        raise AssertionError(f"eval_graphed: graphed differs from eager in "
                             f"{bad}")
    figures = {}
    for name, (epoch, graphs, _) in runs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            epoch()
        torch.cuda.synchronize()
        epoch_ms = (time.perf_counter() - t0) / 5 * 1e3
        counts, bd, _ = profiled(epoch, tmp / f"eval_graphed_{name}_profile")
        want = {"B1": 6, "B2": 0, "B3": 0, "B4": 0}
        if counts != want:
            raise AssertionError(f"eval_graphed/{name}: kernels in the "
                                 f"profile {counts}, expected {want}; "
                                 f"{profiled.last_span}")
        figures[name] = dict(epoch_ms=epoch_ms, launches_from_profile=counts)
        if bd is not None:
            figures[name].update(device_busy_ms=bd["busy_us"] / 1e3,
                                 idle_share=bd["idle_share"])
        if graphs is not None:
            figures[name].update(graph_figures(graphs))
    emit("eval_graphed", val_edges=len(val_edges), batches=batches,
         equal_to_eager=True, **figures)
    return figures


def recording_graphs(dev, gen):
    """A ``StepGraphs`` that also notes the key of every run (``keys``)."""
    from primekg_rgcn_tpu_torch.train.graphs import StepGraphs

    class Recording(StepGraphs):
        def __init__(self, *args):
            super().__init__(*args)
            self.keys = []

        def run(self, key, body):
            self.keys.append(key)
            return super().run(key, body)

    return Recording(dev, gen)


def phase_full_kg_train_graphed(graph, edges, dev, tmp, updates=24):
    """Config 3's epoch (``restrict_final="auto"``, which resolves to a
    plan), ``updates`` updates of 1,024, graphed against eager. The
    restricted layer's gradient sums with ``index_add_``, which is not
    bit-deterministic on the card, so the two are held at the grad
    criterion (``close_scaled``) with SGD (lr 1e-2, clip 1.0, dropout 0.5)
    over two epochs: the epochs' (loss, acc), every parameter and the last
    update's gradient; the generator's state equal, the fallbacks alike,
    one host read an update (one micro-batch). The same at four
    micro-batches an update (``full_kg_train_graphed_accum4``: each
    micro-batch runs its own graph), and with a plan cut to one group a
    relation (``full_kg_graphed_overflow``: every update takes the full
    layer through its graph). Then the default adam step, eager
    and graphed: one timed epoch and one profiled, 60 B1 and 1 B2 an
    update that took the restricted layer, 120 B1 a fallback. Returns the
    figures."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
    from primekg_rgcn_tpu_torch.models import rgcn
    from primekg_rgcn_tpu_torch.ops import rgcn_final_layer as pfl
    from primekg_rgcn_tpu_torch.train import loop

    n, r = graph.num_nodes, graph.num_relations
    cfg = ModelConfig(num_nodes=n, num_relations=r)
    pick = np.random.default_rng(5).permutation(edges.shape[0])
    train_edges = edges[pick[:updates * 1024]]
    resolve = loop.resolve_final_plan

    def cut(plan):
        g = plan.group
        return pfl.FinalLayerPlan(
            plan.rowptr, (g,) * r, g, torch.full_like(plan.cap, g),
            torch.arange(r, device=plan.cap.device) * g, plan.bucket_start)

    def build(tcfg, graphed, overflow=False):
        params = rgcn.init_params(torch.Generator().manual_seed(0), cfg,
                                  device=dev)
        for _, p in named_leaves(params):
            p.requires_grad_(True)
        opt = loop.make_optimizer(tcfg, params)
        host, gen = (torch.Generator().manual_seed(1),
                     torch.Generator(dev).manual_seed(2))
        graphs = recording_graphs(dev, gen) if graphed else None
        if overflow:
            loop.resolve_final_plan = lambda *a, **kw: cut(resolve(*a, **kw))
        try:
            fn = loop.build_train_epoch(graph, train_edges, cfg, tcfg, params,
                                        opt, graphs=graphs)
        finally:
            loop.resolve_final_plan = resolve
        if fn.final_plan is None:
            raise AssertionError("full_kg_train_graphed: no plan")
        return params, opt, gen, graphs, lambda: torch.stack(fn(host, gen))

    def compare(label, overflow, accum=1):
        tcfg = TrainConfig(batch_size=1024, optimizer="sgd", lr=1e-2,
                           gradient_accumulation_steps=accum)
        n_updates = 2 * (updates // accum)
        runs = {}
        for name in ("eager", "graphed"):
            run = build(tcfg, name == "graphed", overflow)
            before = pfl.final_layer_restricted.fallbacks
            stats = torch.stack([run[4]() for _ in range(2)])
            torch.cuda.synchronize()
            runs[name] = (run, stats,
                          pfl.final_layer_restricted.fallbacks - before)
        (e, e_stats, e_fb), (g, g_stats, g_fb) = (runs["eager"],
                                                  runs["graphed"])
        errs = {"stats": close_scaled(g_stats, e_stats, f"{label}/stats")}
        for (k, a), (_, b) in zip(named_leaves(g[0]), named_leaves(e[0])):
            errs[k] = close_scaled(a.detach(), b.detach(), f"{label}/{k}")
            errs[f"{k}/grad"] = close_scaled(a.grad, b.grad,
                                             f"{label}/{k}/grad")
        reads = g[3].keys.count(("ranges",))
        micro = [k[2] for k in g[3].keys if k[0] == "micro"]
        problems = []
        if not torch.equal(g[2].get_state(), e[2].get_state()):
            problems.append("generator states differ")
        if g_fb != e_fb or (overflow and g_fb != 2 * updates):
            problems.append(f"fallbacks {g_fb} graphed, {e_fb} eager")
        if reads != n_updates:
            problems.append(f"{reads} host reads in {n_updates} updates")
        if micro != list(range(accum)) * n_updates:
            problems.append(f"micro-batch graphs run for {micro}")
        if problems:
            raise AssertionError(f"{label}: " + "; ".join(problems))
        fig = dict(max_abs_err=max(errs.values()), fallbacks=g_fb,
                   host_reads=reads, updates=n_updates, accum=accum,
                   keys=sorted({str(k) for k in g[3].keys}),
                   **graph_figures(g[3]))
        emit(label, criterion="grad (close_scaled)", optimizer="sgd",
             **fig)
        return fig

    results = {"compare": compare("full_kg_train_graphed_grad", False),
               "accum4": compare("full_kg_train_graphed_accum4", False, 4),
               "overflow": compare("full_kg_graphed_overflow", True)}
    tcfg = TrainConfig(batch_size=1024)
    for name in ("eager", "graphed"):
        run = build(tcfg, name == "graphed")
        run[4]()
        results[name] = graphed_timing(
            f"full_kg_train_graphed_{name}", run[4], updates, tmp,
            want=lambda f: {"B1": 2 * r * (updates - f) + 4 * r * f,
                            "B2": updates - f, "B3": 0, "B4": 0})
        if run[3] is not None:
            results[name].update(graph_figures(run[3]))
        del run
        gc.collect()
        torch.cuda.empty_cache()
    emit("full_kg_train_graphed", updates_per_epoch=updates,
         step_ms={k: results[k]["step_ms"] for k in ("eager", "graphed")},
         **{k: results[k] for k in ("eager", "graphed")})
    return results


def phase_sampled_train_graphed(graph, cfg, edges, dev, tmp):
    """The one-device sampled epoch (``train/sampled.SampledEpoch``) on the
    ``bench.py`` graph, block over the slim pairs CSR, fanouts 15/10,
    batch 1,024 (adam, clip 1.0), 34 steps an epoch (33 whole batches and
    one wrapped), graphed at K = 1 (the default: every step one replay), 4
    and 32 (one chunk of 32, then two steps one at a time): two epochs
    graphed and eagerly from one state, the epochs' (loss, acc), every
    parameter, adam state tensor and the generator's state ``torch.equal``
    at each K. Then one timed epoch each, and one profiled at the default
    K and eagerly: 2 B2 and 2 B3 a step, counted in the trace. Returns the
    figures."""
    import itertools

    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.config import TrainConfig
    from primekg_rgcn_tpu_torch.train import graphs as pgraphs
    from primekg_rgcn_tpu_torch.train.sampled import (SampledEpoch,
                                                      build_sampled_train_step)

    params0, edges_dev, _, csrs = sampled_setup(graph, cfg, edges, dev)
    n = 33 * 1024 + 100
    steps = -(-n // 1024)
    pick = np.random.default_rng(6).permutation(edges.shape[0])[:n]
    train_edges = edges_dev[torch.from_numpy(pick).to(dev)]

    def order(epoch):
        perm = np.random.default_rng(10 + epoch).permutation(n)
        return np.concatenate([perm, perm[:steps * 1024 - n]])

    def build(k, graphed):
        tcfg = TrainConfig(batch_size=1024, steps_per_scan=k)
        params = fresh_params(params0)
        step = build_sampled_train_step(csrs["slim"], cfg, tcfg,
                                        fanouts=(15, 10), mode="block",
                                        device=dev)
        opt = step.init_optimizer(params)
        gen = torch.Generator(dev).manual_seed(0)
        graphs = pgraphs.StepGraphs(dev, gen) if graphed else None
        epoch = SampledEpoch(step, params, opt, train_edges, gen, tcfg,
                             graphs=graphs)
        count = itertools.count()
        return params, opt, gen, graphs, lambda: epoch(order(next(count)))

    def two_epochs(run):
        params, opt, gen, _, epoch = run
        stats = torch.stack([epoch() for _ in range(2)])
        return run_state(params, opt, gen, stats=stats)

    want = {"B1": 0, "B2": 2 * steps, "B3": 2 * steps, "B4": 0}
    eager = build(0, False)
    reference = two_epochs(eager)
    results = {"eager": graphed_timing("sampled_train_graphed_eager",
                                       eager[4], steps, tmp, want)}
    del eager
    for k in (1, 4, 32):
        run = build(k, True)
        bad = differing(reference, two_epochs(run))
        if bad:
            raise AssertionError(f"sampled_train_graphed K={k}: graphed "
                                 f"differs from eager in {bad}")
        results[f"k{k}"] = dict(
            graphed_timing(
                f"sampled_train_graphed_k{k}", run[4], steps, tmp, want,
                profile=k == pgraphs.DEFAULT_STEPS_PER_GRAPH),
            **graph_figures(run[3]))
        del run
        gc.collect()
        torch.cuda.empty_cache()
    emit("sampled_train_graphed", config="block/slim", steps_per_epoch=steps,
         default_k=pgraphs.DEFAULT_STEPS_PER_GRAPH,
         equal_to_eager=True,
         step_ms={k: v["step_ms"] for k, v in results.items()},
         device_busy_ms_per_step={k: v.get("device_busy_ms_per_step")
                                  for k, v in results.items()},
         **results)
    results["default"] = results[
        f"k{pgraphs.DEFAULT_STEPS_PER_GRAPH}"]
    return results


def phase_rmat10m_cache_graphed(ccsr, cfg, edges, dev, tmp):
    """Config 5's cached step (``rmat10m_step(cache=True)``: uniform, cold
    cache, bf16, sparse SGD) through ``SampledEpoch``, 34 steps an epoch of
    positives drawn from the 100M edges: two epochs graphed at the default
    K and eagerly from one state, the epochs' (loss, acc), every parameter,
    the histories and the generator's state ``torch.equal``; then one timed
    and one profiled epoch each (2 B2 a step). Returns the figures."""
    import itertools

    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.train import graphs as pgraphs
    from primekg_rgcn_tpu_torch.train.sampled import SampledEpoch

    step, tcfg = rmat10m_step(ccsr, cfg, dev, cache=True)
    n = 33 * 1024 + 100
    steps = -(-n // 1024)
    rows = np.random.default_rng(7).integers(0, edges.shape[0], n)
    train_edges = torch.from_numpy(edges[rows].astype(np.int64)).to(dev)

    def order(epoch):
        perm = np.random.default_rng(20 + epoch).permutation(n)
        return np.concatenate([perm, perm[:steps * 1024 - n]])

    want = {"B1": 0, "B2": 2 * steps, "B3": 0, "B4": 0}
    reference, results = None, {}
    for name in ("eager", "graphed"):
        params, _ = rmat10m_setup(ccsr, cfg, edges, dev)
        opt = step.init_optimizer(params)
        gen = torch.Generator(dev).manual_seed(0)
        graphs = pgraphs.StepGraphs(dev, gen) if name == "graphed" else None
        epoch = SampledEpoch(step, params, opt, train_edges, gen, tcfg,
                             graphs=graphs)
        count = itertools.count()
        run = lambda: epoch(order(next(count)))
        stats = torch.stack([run() for _ in range(2)])
        got = run_state(params, opt, gen, stats=stats)
        if reference is None:
            reference = got
        else:
            bad = differing(reference, got)
            if bad:
                raise AssertionError(f"rmat10m_cache_graphed: graphed "
                                     f"differs from eager in {bad}")
        del got
        results[name] = graphed_timing(f"rmat10m_cache_graphed_{name}", run,
                                       steps, tmp, want)
        if graphs is not None:
            results[name].update(graph_figures(graphs))
        del params, opt, epoch, run, graphs
        gc.collect()
        torch.cuda.empty_cache()
    del reference
    emit("rmat10m_cache_graphed", steps_per_epoch=steps,
         default_k=pgraphs.DEFAULT_STEPS_PER_GRAPH,
         equal_to_eager=True,
         step_ms={k: v["step_ms"] for k, v in results.items()}, **results)
    return results


def old_adam_checkpoint(src, dst):
    """A copy of checkpoint ``src`` as a run before capturable adam wrote
    it: every step count a CPU tensor and ``capturable`` off."""
    import torch

    payload = torch.load(src, map_location="cpu", weights_only=False)
    opt = payload["optimizer_state_dict"]
    for group in opt["param_groups"]:
        group["capturable"] = False
    for state in opt["state"].values():
        state["step"] = torch.tensor(float(state["step"]))
    torch.save(payload, dst)


def phase_train_cli_graphed(tmp):
    """``train.cli.main --steps_per_scan 2 --save_every 1`` at scale 0.1
    for 2 epochs, through ``check_checkpoints``, its ``train_config``
    recording 2; then the run resumed from its epoch-1 checkpoint, and from
    a copy of it with adam's step counts on the host and ``capturable``
    off (``old_adam_checkpoint``), each for epoch 2 in a directory of its
    own: both final models equal the uninterrupted run's bit for bit, and
    so do the histories."""
    import torch

    from primekg_rgcn_tpu_torch.train import checkpoint
    from primekg_rgcn_tpu_torch.train import cli as train_cli

    base = ["--synthetic", "--synthetic_scale", "0.1", "--epochs", "2",
            "--seed", "0", "--device", "cuda", "--steps_per_scan", "2",
            "--save_every", "1"]
    out = tmp / "train_cli_graphed"
    reset_counts()
    t0 = time.perf_counter()
    with trainer_states() as states:
        result = train_cli.main([*base, "--output_dir", str(out)])
    seconds = time.perf_counter() - t0
    launches = read_counts()
    problems = check_checkpoints(out, states)
    final = checkpoint.load(out / "models" / "final_model.pt")
    if final["train_config"]["steps_per_scan"] != 2:
        problems.append(f"train_config {final['train_config']}")
    epoch1 = out / "checkpoints" / "checkpoint_epoch_1.pt"
    old = tmp / "checkpoint_epoch_1_old_adam.pt"
    old_adam_checkpoint(epoch1, old)
    resumed = {}
    for name, path in (("resumed", epoch1), ("resumed_old_adam", old)):
        run = train_cli.main([*base, "--resume", str(path), "--output_dir",
                              str(tmp / f"train_cli_{name}")])
        got = checkpoint.load(tmp / f"train_cli_{name}" / "models" /
                              "final_model.pt")
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            named_leaves(got["params"]), named_leaves(final["params"])))
        resumed[name] = same and run["history"] == result["history"]
        if not resumed[name]:
            problems.append(f"{name}: history {run['history']} against "
                            f"{result['history']}, parameters equal {same}")
    if problems:
        raise AssertionError("train_cli_graphed: " + "; ".join(problems))
    emit("train_cli_graphed", seconds=seconds, launches_in_python=launches,
         history=result["history"], epoch_time_s=result["epoch_times_s"],
         resumed_equal=resumed, async_writes=states["async"])
    return launches


# -- the bench modules (primekg_rgcn_tpu_torch/bench/) ------------------------

# Config 5's node-sharded step with every shard on the card
# (bench/pod_scale.run_pod_scale): (nodes, edges, relations, shards), fixed
# from the memory reckoning that pod_scale prints before it builds the step
# (PERF.md). zero3 keeps every table-shaped object sliced and runs config 5
# at full scale over 8 shards, sgd (dense adam slices) and adafactor.
POD_NODE = (5_000_000, 50_000_000, 50, 4)
POD_ZERO3 = (*RMAT10M, 8)
# The suite's rows run here: every row but config 5's, and one of those
# (the 8/5 budgets in block4 mode); scripts/port_bench_phases.py runs them
# all (config 5's set-up alone is about a minute of host work a process).
SMOKE_SUITE_ROWS = ("primekg-default", "primekg-bases", "primekg-bf16",
                    "sampled-15-10", "sampled-full-15-10",
                    "sampled-full-bf16-15-10", "sampled-full-8-5",
                    "sampled-10m-block4-8-5", "sampled-full-cache-15-10",
                    "primekg-full", "rmat-large", "eval-ranking",
                    "sharded-1dev-pallas")

# The pod-scale children, each report one JSON line: the node step, and
# zero3 under both table rules (the full graph built once for both). Each
# run's host peak is its child's, since a sandboxed kernel may not let a
# process reset its own. A child reads its peak from ru_maxrss, which
# Linux carries from a parent's high-water mark across fork and exec: a
# shell that forks each one (``POD_SPAWN``) keeps this process's mark out
# of theirs.
POD_SPAWN = ("sh", "-c", '"$@"; exit $?', "sh")
POD_CHILDREN = ("""
import json
from primekg_rgcn_tpu_torch.bench import pod_scale
print(json.dumps({{"pod_scale": pod_scale.run_pod_scale(*{node})}}),
      flush=True)
""", """
import json
from primekg_rgcn_tpu_torch.bench import pod_scale
for rule in ("sgd", "adafactor"):
    print(json.dumps({{"pod_scale_zero3": pod_scale.run_pod_scale_zero3(
        *{zero3}, table_opt=rule)}}), flush=True)
""")


def run_child(label, argv, repo, timeout):
    """``argv`` in a child process from ``repo``; its standard output's
    lines, or an AssertionError with the end of its errors when it fails
    (its output is printed either way)."""
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=repo, capture_output=True, text=True,
                          timeout=timeout)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-20000:], flush=True)
        raise AssertionError(f"{label}: exit {proc.returncode} after "
                             f"{seconds:.1f} s: {proc.stderr[-4000:]}")
    return proc.stdout.splitlines(), seconds


def phase_bench_suite(repo, tmp, rows=None):
    """``python -m primekg_rgcn_tpu_torch.bench.suite`` as a child over
    ``rows`` (every row of its ``CONFIGS`` when None): it must exit 0 with
    no row holding ``error``. One line a row: its time, edges/s, how it was
    timed (``graphed``) and its floor. Returns {row: result}."""
    from primekg_rgcn_tpu_torch.bench import suite

    rows = list(suite.CONFIGS) if rows is None else list(rows)
    out = tmp / "bench_report_torch.json"
    _, seconds = run_child(
        "bench_suite", [sys.executable, "-m",
                        "primekg_rgcn_tpu_torch.bench.suite", "--out",
                        str(out), "--configs", *rows], repo, timeout=900)
    report = json.loads(out.read_text())
    results = report["results"]
    missing = [r for r in rows if r not in results]
    failed = {r: results[r]["error"] for r in rows
              if r in results and "error" in results[r]}
    if missing or failed:
        raise AssertionError(f"bench_suite: missing {missing}, failed "
                             f"{failed}")
    for name in rows:
        res = results[name]
        emit("bench_suite", row=name, **{k: v for k, v in res.items()
                                         if k not in ("points", "floor_of")})
    emit("bench_suite_run", seconds=seconds, rows=len(rows),
         device=report["device"],
         floor_of=next((results[r]["floor_of"] for r in rows
                        if "floor_of" in results[r]), None))
    return results


def phase_bench_traces(tmp, suite_rows, steps=10):
    """A 10-step trace of the suite's primekg-bases and rmat-large rows
    (``bench/suite._full_batch_config``: the graphed full-graph update):
    device busy and idle share beside the suite's ``step_ms``, and the
    kernels in the trace against the buckets' count: 2 B1 a non-empty
    relation bucket a layer (forward, transpose backward), or with the
    batch-restricted final layer 2 a bucket for conv1 and 1 B2, and 2 more
    B1 a bucket for each update whose batch overflowed the plan."""
    from primekg_rgcn_tpu_torch.bench import suite

    out = {}
    for row, kw in (("primekg-bases", dict(num_bases=2)),
                    ("rmat-large", dict(graph_override=(
                        *suite.rmat_graph(500_000, 5_000_000, 10),
                        500_000, 10)))):
        epoch, _, graph, plan, _ = suite._full_batch_config(
            n_steps=steps, **kw)
        buckets = sum(1 for size in graph.bucket_sizes() if size)

        def want(fallbacks, buckets=buckets, plan=plan):
            if plan is None:
                return {"B1": 4 * buckets * steps, "B2": 0, "B3": 0, "B4": 0}
            return {"B1": 2 * buckets * (steps + fallbacks),
                    "B2": steps - fallbacks, "B3": 0, "B4": 0}

        epoch()  # warm-up and capture
        fig = graphed_timing(f"bench_trace_{row}", epoch, steps, tmp,
                             want=want)
        out[row] = fig
        emit("bench_trace", row=row,
             suite_step_ms=suite_rows.get(row, {}).get("step_ms"),
             buckets=buckets, restricted=plan is not None, **fig)
        del epoch, graph, plan
        gc.collect()
    return out


def probe_launches(label, res, fallbacks):
    """The launches the wrappers count in a probe (``run_probe``), each
    graphed body's Python running twice (its warm-up and its capture; a
    replay counts none), from its graph's buckets with real edges b and
    relations r. config3_probe: the auto step's restricted branch (2b B1
    and 1 B2 a run) and, after its first ``fallbacks`` overflows, its full
    branch (4b B1 a run, twice at most), or without a plan the full step;
    the full step (4b B1 a run), each layer forward and backward (2b B1 a
    run) and the encode (2b). The restricted probe: the parity gate's
    forwards once, static (r B1) and full (b), then the full layer (2b B1
    a run), the static one (2r: every relation's CSR has rows, edges or
    none) and the dynamic one (1 B2 a run, or the full layer's 2b B1 when
    the batch overflows its plan)."""
    b = res["buckets_with_edges"]
    if label == "config3_probe":
        if res["restricted_e_cap"] is None:
            auto = {"B1": 2 * 4 * b, "B2": 0}
        else:
            auto = {"B1": 2 * 2 * b + min(fallbacks, 2) * 4 * b, "B2": 2}
        return {"B1": auto["B1"] + 2 * 4 * b + 3 * 2 * 2 * b,
                "B2": auto["B2"], "B3": 0, "B4": 0}
    r = res["relations"]
    fits = res["dynamic_fits"]
    return {"B1": (r + b) + 2 * 2 * b + 2 * 2 * r + (0 if fits else 4 * b),
            "B2": 2 if fits else 0, "B3": 0, "B4": 0}


def phase_bench_probes():
    """The config-3 probe and the restricted-layer probe at scale 1.0 in
    this process (``bench/config3_probe.run_probe``,
    ``bench/restricted_probe.run_probe``, whose parity gate raises), each
    component a replayed CUDA graph; the wrappers' launches held against
    ``probe_launches``. Returns the launches by probe."""
    from primekg_rgcn_tpu_torch.bench import config3_probe, restricted_probe
    from primekg_rgcn_tpu_torch.ops import rgcn_final_layer as pfl

    launches = {}
    for label, probe in (("config3_probe", config3_probe),
                         ("restricted_probe", restricted_probe)):
        reset_counts()
        fallbacks = pfl.final_layer_restricted.fallbacks
        t0 = time.perf_counter()
        res = probe.run_probe(scale=1.0)
        counts = read_counts()
        fallbacks = pfl.final_layer_restricted.fallbacks - fallbacks
        want = probe_launches(label, res, fallbacks)
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, expected "
                                 f"{want} ({fallbacks} fallbacks)")
        emit(label, seconds=time.perf_counter() - t0,
             launches_in_python=counts, fallbacks_in_run=fallbacks,
             **{k: v for k, v in res.items() if k != "floor_of"})
        launches[label] = counts
        gc.collect()
    return launches


def zero3_launches(n):
    """One zero3 sampled step's launches over n shards: B2 alone, in each
    shard's backward of its two layers' dedup gathers, and in the row
    fetch's backward, each of the n owners summing each of the n
    requesters' chunk into its slice."""
    return {"B1": 0, "B2": 2 * n + n * n, "B3": 0, "B4": 0}


def scaling_launches(layout, n, graph):
    """One step's launches of a ``measure_sim_mesh`` row on ``graph``: the
    edge layout's (``edge_launches``) and the node layout's
    (``node_launches``) from their partitions at ``n`` shards; a
    data-parallel sampled step's B2 in each shard's backward of its two
    layers' dedup gathers and its table gather (3 n), zero3's
    (``zero3_launches``)."""
    from primekg_rgcn_tpu_torch.parallel.edge_shard import shard_rel_graph
    from primekg_rgcn_tpu_torch.parallel.node_shard import partition_nodes

    if layout == "edge":
        return edge_launches(shard_rel_graph(graph, n))
    if layout == "node":
        return node_launches(partition_nodes(graph, n))
    if layout == "sampled-zero3":
        return zero3_launches(n)
    return {"B1": 0, "B2": 3 * n, "B3": 0, "B4": 0}


def phase_bench_scaling(scale=0.25):
    """``bench/scaling.measure_sim_mesh`` at ``scale``: every layout at 1,
    2, 4 and 8 shards on the card (eager, as the sharded trainers run),
    and the byte model. Each row's launches (its warm step and its timed
    ones) held against ``scaling_launches``. One line, the step times by
    layout and shards."""
    from primekg_rgcn_tpu_torch.bench import scaling

    t0 = time.perf_counter()
    res = scaling.measure_sim_mesh(scale=scale)
    seconds = time.perf_counter() - t0
    graph = scaling.sim_graph(scale)[0]
    for layout, rows in res["layouts"].items():
        for n, row in rows.items():
            want = {k: v * row["steps"] for k, v in
                    scaling_launches(layout, int(n), graph).items()}
            if row["launches"] != want:
                raise AssertionError(f"scaling/{layout}/{n}: launches "
                                     f"{row['launches']}, expected {want}")
    emit("scaling", seconds=seconds, disclaimer=res["disclaimer"],
         launches={lay: {n: r["launches"] for n, r in rows.items()}
                   for lay, rows in res["layouts"].items()},
         step_ms={lay: {n: r["step_ms"] for n, r in rows.items()}
                  for lay, rows in res["layouts"].items()},
         setup_s={lay: {n: r["setup_s"] for n, r in rows.items()}
                  for lay, rows in res["layouts"].items()},
         halo_width={n: m["node_shard"]["halo_width"]
                     for n, m in res["comms_model"].items()
                     if "node_shard" in m},
         per_device_step_bytes={
             n: {k: v["per_device_step_bytes"] for k, v in m.items()
                 if isinstance(v, dict)}
             for n, m in res["comms_model"].items()})
    return res


def phase_pod_scale(repo):
    """Config 5 at pod scale in two children (``POD_CHILDREN``): the
    node-sharded adam step at ``POD_NODE``, then zero3 at ``POD_ZERO3``
    under the sgd (dense adam slices) and adafactor table rules, each with
    a finite loss and the launches of its two steps as
    ``node_step_launches`` and ``zero3_launches`` give them. Returns the
    three reports."""
    import numpy as np

    lines, seconds = [], 0.0
    for child in POD_CHILDREN:
        out, secs = run_child(
            "pod_scale", [*POD_SPAWN, sys.executable, "-c", child.format(
                node=POD_NODE, zero3=POD_ZERO3)], repo, timeout=900)
        lines += out
        seconds += secs
    reports = [json.loads(ln) for ln in lines if ln.startswith("{")]
    node = [r["pod_scale"] for r in reports if "pod_scale" in r]
    zero3 = [r["pod_scale_zero3"] for r in reports
             if "pod_scale_zero3" in r]
    if len(node) != 1 or len(zero3) != 2:
        raise AssertionError(f"pod_scale: reports {reports}")
    node = node[0]
    if (node["nodes"], node["edges"], node["relations"], node["devices"]) \
            != POD_NODE:
        raise AssertionError(f"pod_scale: ran {node['nodes']} nodes, "
                             f"expected {POD_NODE}")
    # Each report's launches are those of its two steps.
    wants = [node_step_launches(node["buckets_with_edges"],
                                node["uniform_caps"], node["devices"],
                                halo=node["halo_buckets_with_edges"] > 0)]
    wants += [zero3_launches(rep["devices"]) for rep in zero3]
    for rep, want in zip((node, *zero3), wants):
        want = {k: 2 * v for k, v in want.items()}
        if not np.isfinite(rep["loss"]):
            raise AssertionError(f"pod_scale: loss {rep['loss']}")
        if rep["launches"] != want:
            raise AssertionError(f"pod_scale/{rep.get('mode', 'node')}: "
                                 f"launches {rep['launches']}, expected "
                                 f"{want}")
    emit("pod_scale", seconds=seconds,
         **{k: v for k, v in node.items() if k != "comms_model"},
         comms_per_device_step_bytes={
             k: v["per_device_step_bytes"]
             for k, v in node["comms_model"].items() if isinstance(v, dict)})
    for rep in zero3:
        emit("pod_scale_zero3", **rep)
    return node, zero3


# -- the edge layout and the data-parallel sampled steps across processes --

DIST_STEPS = 3
DIST_TIMEOUT = 300


def free_port():
    """A port no process listens on now (a socket bound to port 0)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def bench_graph():
    """The ``bench.py`` graph on the host: (graph, model config, edges)."""
    import numpy as np

    from primekg_rgcn_tpu_torch.config import ModelConfig
    from primekg_rgcn_tpu_torch.data import artifacts, synthetic

    raw = synthetic.primekg_like(seed=0, scale=1.0)
    su, du, ru = synthetic.bidirect(raw["src"], raw["dst"], raw["rel"])
    graph = artifacts.split_to_rel_graph({
        "edge_index": np.stack([su, du]), "edge_type": ru,
        "num_nodes": raw["num_nodes"], "num_relations": 3})
    return (graph, ModelConfig(num_nodes=graph.num_nodes, num_relations=3),
            np.stack([su, du, ru], 1))


def dist_state(cfg, edges, seed=5):
    """The saved state the distributed phase starts each run from: the
    parameters of seed 0, the generator's seed, and DIST_STEPS batches of
    1,024 positives (the edge step's with a mask column of ones)."""
    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.models import rgcn

    rng = np.random.default_rng(seed)
    pos = [torch.from_numpy(edges[rng.integers(0, len(edges), 1024)]
                            .astype(np.int64)) for _ in range(DIST_STEPS)]
    return {"params": rgcn.init_params(torch.Generator().manual_seed(0),
                                       cfg),
            "seed": seed, "positives": pos,
            "edge_batches": [torch.cat([p, torch.ones_like(p[:, :1])], 1)
                             for p in pos]}


DIST_TOPK_QUERIES = 64


def node_process_launches(psg, local):
    """A node step's launches in the process that holds the shards
    ``local`` of the partition ``psg`` (:func:`node_step_launches` of its
    buckets with real edges): B1 for each of them, B2 five times a shard,
    B4 four times (its pairs, each layer, both ways)."""
    own = slice(local.start, local.stop)
    buckets = int((psg.rowptr_local[own, :, -1] > 0).sum()
                  + (psg.rowptr_halo[own, :, -1] > 0).sum())
    return node_step_launches(buckets, psg.uniform_caps, len(local))


def dist_node_topk(mesh, psg, cfg, params):
    """The node layout's sharded top-10 of DIST_TOPK_QUERIES heads under
    relation 0: this process's shards encoded, the top-K over every
    process's candidates. Returns its scores and ids on the host and the
    launches of the encode and the top-K."""
    import torch

    from primekg_rgcn_tpu_torch.evaluate.sharded_ranking import (
        build_sharded_topk)
    from primekg_rgcn_tpu_torch.parallel.node_shard import (
        build_node_sharded_forward)

    heads = torch.arange(DIST_TOPK_QUERIES, device=mesh.device) * (
        cfg.num_nodes // DIST_TOPK_QUERIES)
    with torch.no_grad():
        reset_counts()
        emb_dm = build_node_sharded_forward(mesh, psg, cfg,
                                            gather=False)(params)
        scores, ids = build_sharded_topk(
            mesh, emb_dm, params["decoder"]["rel_emb"], cfg.num_nodes,
            10)(heads, torch.zeros_like(heads))
        torch.cuda.synchronize()
    return {"scores": scores.cpu(), "ids": ids.cpu(),
            "shards": emb_dm.shape[0], "launches": read_counts()}


def dist_runs(graph, cfg, state, dev):
    """DIST_STEPS steps of the edge step, the node step, the zero3 block
    step over the slim pairs CSR and that zero3 step on a (1, N_SHARDS)
    mesh (across processes its tp row is split over them), each from
    ``state``, over N_SHARDS shards on a mesh that spans the live process
    group (or this one process): batch 1024, fanouts 15/10, adam lr 1e-3,
    clip 1.0. Returns {layout: losses, whole parameters after the last
    step (host), each step's launches and host-clock ms, the table's local
    rows, the launches expected a step}; "node" also holds the sharded
    top-K on the state's parameters (``dist_node_topk``)."""
    import torch

    from primekg_rgcn_tpu_torch.config import TrainConfig
    from primekg_rgcn_tpu_torch.data.sampling import build_combined_csr
    from primekg_rgcn_tpu_torch.parallel import edge_shard, node_shard
    from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
    from primekg_rgcn_tpu_torch.train import loop, sampled

    mesh = make_mesh(N_SHARDS, dev)
    tcfg = TrainConfig(batch_size=1024)
    csr = build_combined_csr(graph, slim=True, window_pairs=True)
    psg = node_shard.partition_nodes(graph, N_SHARDS)
    steps = {
        "edge": edge_shard.build_sharded_train_step(
            mesh, edge_shard.shard_rel_graph(graph, N_SHARDS), cfg, tcfg),
        "node": node_shard.build_node_sharded_train_step(mesh, psg, cfg,
                                                         tcfg),
        **{name: sampled.build_sampled_train_step_zero3(
            csr, cfg, tcfg, m, fanouts=(15, 10), mode="block")
           for name, m in (("zero3", mesh), ("zero3_1x4", make_mesh_2d(
               1, N_SHARDS, dev)))}}
    expected = {"node": node_process_launches(psg, mesh.local)}
    out = {}
    for layout, step in steps.items():
        zero3 = layout.startswith("zero3")
        params = fresh_params(_to(state["params"], dev))
        if layout == "node":
            topk = dist_node_topk(mesh, psg, cfg, params)
        if zero3:
            params = step.shard_params(params)
            opt = step.init_optimizer(params)
        else:
            opt = loop.make_optimizer(tcfg, params)
        gen = torch.Generator(dev).manual_seed(state["seed"])
        losses, launches, ms = [], [], []
        for i in range(DIST_STEPS):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            if zero3:
                loss = step(params, opt, state["positives"][i].to(dev),
                            gen)[0].item()
            else:
                stats = step(params, opt, state["edge_batches"][i].to(dev),
                             gen)
                loss = (stats[0] / stats[2]).item()
            ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(read_counts())
            losses.append(loss)
        full = step.full_params(params) if zero3 else params
        out[layout] = {
            "losses": losses, "launches": launches, "step_ms": ms,
            "params": {k: p.detach().cpu() for k, p in named_leaves(full)},
            "table_rows": int(params["encoder"]["node_emb"].shape[0]),
            "expected": expected.get(layout)}
        if layout == "node":
            out[layout]["topk"] = topk
    return out


def _to(tree, dev):
    """A nested dict of tensors, moved to ``dev``."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def collective_kinds(dev):
    """Which collectives the live group's backend runs on tensors on
    ``dev``: {kind: "ok", or the first line of its error}. The port builds
    every cross-process collective from all_reduce alone; this reads what
    the others would do."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size()
    x = torch.ones(4 * world, device=dev)
    kinds = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * world * world, device=dev), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), x),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
    }
    out = {}
    for name, run in kinds.items():
        try:
            run()
            torch.cuda.synchronize()
            out[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as exc:
            out[name] = str(exc).strip().splitlines()[0][:300]
    return out


def dist_child(argv):
    """One process of the distributed phase's pair on the card: ``rank
    world port state out``. It meets its peer through
    ``maybe_initialize_distributed`` (the backend rule), runs ``dist_runs``
    from the saved state, then reads which collective kinds its backend has
    on CUDA tensors, and saves all of it to ``out.<rank>``."""
    import torch
    import torch.distributed as dist

    from primekg_rgcn_tpu_torch.train.multichip import (
        maybe_initialize_distributed)

    rank, world, port = (int(a) for a in argv[:3])
    state_path, out_path = argv[3:5]
    if not maybe_initialize_distributed(f"localhost:{port}", world, rank,
                                        device="cuda"):
        raise RuntimeError("the distributed phase's processes did not meet")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    graph, cfg, _ = bench_graph()
    state = torch.load(state_path, weights_only=False)
    runs = dist_runs(graph.to(dev), cfg, state, dev)
    torch.save({"backend": dist.get_backend(), "runs": runs,
                "device": torch.cuda.current_device(),
                "kinds": collective_kinds(dev)}, f"{out_path}.{rank}")
    return 0


def nccl_shared_child(argv):
    """One of two processes that put an NCCL communicator on the one card
    (``rank port``): prints whether NCCL accepted it, or its error."""
    import datetime

    import torch
    import torch.distributed as dist

    rank, port = (int(a) for a in argv[:2])
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    x = torch.ones(4, device="cuda")
    try:
        dist.all_reduce(x)
        torch.cuda.synchronize()
        print(json.dumps({"accepted": True}), flush=True)
    except RuntimeError as exc:      # DistBackendError among them
        print(json.dumps({"accepted": False, "error": " ".join(
            str(exc).split())[:600]}), flush=True)
    return 0


# A step's launches in each of two processes: half the one-process counts
# (its two shards' B1 chunks both ways; zero3's fetch backward, 2 owners x
# 4 requesters, its shards' 2 dedup sums and 2 window fetches each, on
# either mesh); the node step's are each process's own
# (``node_process_launches``: 10 B2 and 4 B4, B1 for its buckets).
DIST_LAUNCHES = {"edge": {"B1": 24, "B2": 0, "B3": 0, "B4": 0},
                 "zero3": {"B1": 0, "B2": 8 + 4, "B3": 4, "B4": 0},
                 "zero3_1x4": {"B1": 0, "B2": 8 + 4, "B3": 4, "B4": 0}}
DIST_LAYOUTS = ("edge", "node", "zero3", "zero3_1x4")


def dist_compare(ref, ranks, want, ref_want):
    """Each process's ``dist_runs`` against the one-process ``ref``:
    launches a step (``want``, and ``ref_want`` for the reference; the
    node step's from its partition, 10 B2 and 4 B4 a process, and the
    processes' B1 adding up to the reference's), the zero3 tables' local
    slices (half), losses within rel 1e-5 and whole parameters within
    rtol 2e-6, atol 2e-7. Returns the figures by layout."""
    import torch

    figures = {}
    for layout in DIST_LAYOUTS:
        solo = ref[layout]
        solo_want = solo["expected"] or ref_want[layout]
        if solo["launches"] != [solo_want] * DIST_STEPS:
            raise AssertionError(f"distributed_steps/{layout}: one-process "
                                 f"launches {solo['launches']}, expected "
                                 f"{solo_want} a step")
        errs, per_process = [], []
        for r, run in enumerate(g[layout] for g in ranks):
            run_want = run["expected"] or want[layout]
            per_process.append(run_want)
            if run["launches"] != [run_want] * DIST_STEPS:
                raise AssertionError(
                    f"distributed_steps/{layout}: process {r} launched "
                    f"{run['launches']}, expected {run_want} a step")
            if layout.startswith("zero3") and \
                    run["table_rows"] != N_SHARDS // 2:
                raise AssertionError(f"distributed_steps/{layout}: process "
                                     f"{r} holds {run['table_rows']} slices")
            for a, b in zip(run["losses"], solo["losses"]):
                if abs(a - b) > 1e-5 * abs(b):
                    raise AssertionError(
                        f"distributed_steps/{layout}: process {r} losses "
                        f"{run['losses']}, one process {solo['losses']}")
            for k, want_p in solo["params"].items():
                torch.testing.assert_close(
                    run["params"][k], want_p, rtol=2e-6, atol=2e-7,
                    msg=lambda m, k=k: f"distributed_steps/{layout}/{k}: "
                                       f"{m}")
                errs.append(float((run["params"][k] - want_p).abs().max()))
        if layout == "node" and (
                [c["B2"] for c in per_process] != [10, 10]
                or [c["B4"] for c in per_process] != [4, 4]
                or sum(c["B1"] for c in per_process) != solo_want["B1"]):
            raise AssertionError(f"distributed_steps/node: per-process "
                                 f"launches {per_process} against one "
                                 f"process's {solo_want}")
        figures[layout] = {
            "losses": solo["losses"], "max_abs_err": max(errs),
            "launches_per_process": (per_process if layout == "node"
                                     else want[layout]),
            "launches_one_process": solo_want,
            "step_ms_per_process": [g[layout]["step_ms"] for g in ranks],
            "step_ms_one_process": solo["step_ms"]}
    return figures


def phase_distributed(repo, tmp, graph, cfg, edges, dev):
    """``--distributed`` on the card (train/multichip, the process-spanning
    mesh). distributed_cli: the edge and the node CLI (``--shard edge|node
    --n_devices 4``, scale 0.1, 2 epochs) each as one process over NCCL
    (``--distributed --num_processes 1``) and without ``--distributed``:
    history and final parameters torch.equal. distributed_steps: two
    processes on the one card (gloo, the backend rule) run the edge step,
    the node step, the zero3 block step over the slim CSR and that step on
    a (1, 4) mesh whose tp row they split, 4 shards, DIST_STEPS steps each
    from one saved state (``dist_state``), against this process's run from
    it: losses within rel 1e-5, parameters within rtol 2e-6, atol 2e-7
    (the drill's); each process's launches a step asserted (edge 24 B1;
    node 4 B4, 10 B2 and the B1 of its buckets, the pair's adding up to
    the one-process 60; zero3 8 fetch-backward + 4 dedup B2 and 4 B3), its
    zero3 table two of the four slices; the node layout's sharded top-10
    over the pair equal to one process's (``dist_topk_compare``). Two more
    processes put an NCCL communicator on the one card, which NCCL must
    refuse. The children run at once, this process's reference beside
    them. Returns the per-process launches."""
    import torch

    state_path = tmp / "dist_state.pt"
    torch.save(dist_state(cfg, edges), state_path)
    out_path = tmp / "dist_out"
    cli = [sys.executable, "-m", "primekg_rgcn_tpu_torch.train.cli",
           "--synthetic", "--synthetic_scale", "0.1", "--epochs", "2",
           "--shard", "edge", "--n_devices", str(N_SHARDS)]
    cli_node = [*cli[:-4], "--shard", "node", "--n_devices", str(N_SHARDS)]
    cli_port, pair_port, nccl_port, node_port = (free_port()
                                                  for _ in range(4))
    argvs = {
        "cli_plain": cli + ["--output_dir", str(tmp / "dist_cli_plain")],
        "cli_nccl": cli + ["--output_dir", str(tmp / "dist_cli_nccl"),
                           "--distributed", "--coordinator_address",
                           f"localhost:{cli_port}", "--num_processes", "1",
                           "--process_id", "0"],
        "cli_node_plain": cli_node + ["--output_dir",
                                      str(tmp / "dist_cli_node_plain")],
        "cli_node_nccl": cli_node + [
            "--output_dir", str(tmp / "dist_cli_node_nccl"), "--distributed",
            "--coordinator_address", f"localhost:{node_port}",
            "--num_processes", "1", "--process_id", "0"],
        **{f"steps_{r}": [sys.executable, "chip_smoke.py", "dist_child",
                          str(r), "2", str(pair_port), str(state_path),
                          str(out_path)] for r in range(2)},
        **{f"nccl_shared_{r}": [sys.executable, "chip_smoke.py",
                                "nccl_shared_child", str(r), str(nccl_port)]
           for r in range(2)}}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(a, cwd=repo, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, a in argvs.items()}
    try:
        ref = dist_runs(graph, cfg, torch.load(state_path,
                                               weights_only=False), dev)
        done = {k: (*p.communicate(timeout=DIST_TIMEOUT), p.returncode)
                for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    for k, (out, err, rc) in done.items():
        if rc != 0:
            print(out[-8000:], flush=True)
            raise AssertionError(f"distributed/{k}: exit {rc}: "
                                 f"{err[-4000:]}")

    # (a) one process over NCCL through the CLI, bit for bit, for each
    # layout.
    histories = {}
    for layout, key in (("edge", "cli"), ("node", "cli_node")):
        plain, nccl = (torch.load(tmp / f"dist_{key}_{d}" / "models" /
                                  "final_model.pt", weights_only=False)
                       for d in ("plain", "nccl"))
        if plain["history"] != nccl["history"] or any(
                not torch.equal(plain["model_state_dict"][k],
                                nccl["model_state_dict"][k])
                for k in plain["model_state_dict"]):
            raise AssertionError(f"distributed_cli/{layout}: the one-process "
                                 f"NCCL run differs from the run without "
                                 f"--distributed")
        backend_line = next((ln for ln in done[f"{key}_nccl"][0].splitlines()
                             if "torch.distributed: backend" in ln), "")
        if "backend nccl, process 0 of 1" not in backend_line:
            raise AssertionError(f"distributed_cli/{layout}: backend line "
                                 f"{backend_line!r}")
        histories[layout] = nccl["history"]
    emit("distributed_cli", backend=backend_line.split(" - ")[-1],
         history=histories["edge"], node_history=histories["node"],
         equal=True, seconds=seconds)

    # (b) two processes on the one card against this process.
    ranks = [torch.load(f"{out_path}.{r}", weights_only=False)
             for r in range(2)]
    figures = dist_compare(ref, [g["runs"] for g in ranks], DIST_LAUNCHES,
                           {"edge": {"B1": 48, "B2": 0, "B3": 0, "B4": 0},
                            "zero3": dp_launches("zero3"),
                            "zero3_1x4": dp_launches("zero3")})
    topk = dist_topk_compare(ref["node"]["topk"],
                             [g["runs"]["node"]["topk"] for g in ranks])
    nccl_shared = [json.loads(done[f"nccl_shared_{r}"][0].splitlines()[-1])
                   for r in range(2)]
    if any(n["accepted"] for n in nccl_shared):
        raise AssertionError(f"distributed_steps: NCCL accepted two ranks "
                             f"on one card: {nccl_shared}")
    emit("distributed_steps", backend=ranks[0]["backend"],
         devices=[g["device"] for g in ranks], steps=DIST_STEPS,
         collective_kinds_on_cuda=ranks[0]["kinds"],
         nccl_shared_card=nccl_shared[0]["error"], seconds=seconds,
         step_ms_note="mechanics, not speed: two processes share one card "
                      "through gloo's host-staged transport, beside the "
                      "other children of this phase",
         node_topk=topk, **figures)
    return {k: v["launches_per_process"] for k, v in figures.items()}


def dist_topk_compare(solo, ranks):
    """The node layout's sharded top-K over the pair against one process's
    (``dist_node_topk``): ids equal, scores within rtol 1e-5, each process
    encoding its two shards (2 B4: one exchange a layer) and the B1
    launches of the pair adding up to the one process's. Returns its
    figures."""
    import torch

    for r, got in enumerate(ranks):
        if not torch.equal(got["ids"], solo["ids"]):
            raise AssertionError(f"distributed_steps/node_topk: process {r} "
                                 f"ids differ from one process's")
        torch.testing.assert_close(got["scores"], solo["scores"], rtol=1e-5,
                                   atol=0)
        if got["shards"] != N_SHARDS // 2 or got["launches"]["B4"] != 2:
            raise AssertionError(f"distributed_steps/node_topk: process {r} "
                                 f"encoded {got['shards']} shards with "
                                 f"{got['launches']}")
    if sum(g["launches"]["B1"] for g in ranks) != solo["launches"]["B1"]:
        raise AssertionError("distributed_steps/node_topk: the pair's B1 "
                             "launches do not add up to one process's")
    return {"queries": DIST_TOPK_QUERIES, "k": solo["ids"].shape[1],
            "ids_equal": True,
            "max_abs_err": max(float((g["scores"] - solo["scores"]).abs()
                                     .max()) for g in ranks),
            "launches_per_process": [g["launches"] for g in ranks],
            "launches_one_process": solo["launches"]}


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
    # BASELINE config 2: the basis decomposition (num_bases=2), 12 B1.
    bases_err, _ = phase_grad(graph, dataclasses.replace(cfg, num_bases=2),
                              edges, dev, plain_layer, label="grad_bases")
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
        train_graphed = phase_train_graphed(graph, cfg, edges, dev, Path(tmp))
        eval_graphed = phase_eval_graphed(graph, cfg, edges, dev, Path(tmp))
        cli_launches = phase_train_cli(Path(tmp))
        phase_train_cli_graphed(Path(tmp))
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
        sampled_graphed = phase_sampled_train_graphed(graph, cfg, edges, dev,
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

        # -- the data-parallel sampled steps, 4 shards ----------------------
        dp_err, dp_b2_calls = phase_sampled_dp_grad(graph, cfg, edges, dev)
        b2_fetch_row = phase_kernel_b2_fetch(dp_b2_calls, -(-n // N_SHARDS))
        del dp_b2_calls
        sampled_dp = phase_sampled_dp_train(graph, cfg, edges, dev, Path(tmp))
        dp_cli_counts = phase_sampled_dp_cli(Path(tmp))

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
        kg_graphed = phase_full_kg_train_graphed(g3, edges3, dev, Path(tmp))
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
        kg_b4_rows = phase_kernel_b4(psg3, dev, label="full_kg_kernel_b4",
                                     cases=False)
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
        kg_zero3_err, kg_zero3 = phase_full_kg_zero3(g3, cfg3, edges3, dev,
                                                     Path(tmp))

        # -- the per-(node, relation) reductions on config 4 ----------------
        agg_runs, agg_err = phase_combined_agg(g3, cfg3, edges3, dev,
                                               Path(tmp))
        # Config 5 needs the room: config 3's graphs and partition go.
        del g3, g3_cpu, psg3, edges3
        gc.collect()
        torch.cuda.empty_cache()

        # -- the layer-1 cache on the bench.py graph ------------------------
        cache_counts, cache_err = phase_sampled_cache(graph, cfg, edges, dev,
                                                      Path(tmp))

        # -- BASELINE config 5: R-MAT, 10M nodes, 100M edges, 50 relations --
        ccsr5, edges5 = phase_rmat10m_graph(dev)
        cfg5 = ModelConfig(num_nodes=RMAT10M[0],
                           num_relations=ccsr5.num_relations,
                           compute_dtype="bfloat16")
        r5_err, r5_b2_rows = phase_rmat10m_grad(ccsr5, cfg5, edges5, dev)
        r5_b3_rows = phase_rmat10m_b3(ccsr5, cfg5, edges5, dev)
        rmat10m = phase_rmat10m_sampled(ccsr5, cfg5, edges5, dev, Path(tmp))
        rmat10m_graphed = phase_rmat10m_cache_graphed(ccsr5, cfg5, edges5,
                                                      dev, Path(tmp))
        del ccsr5, edges5
        gc.collect()
        torch.cuda.empty_cache()

        # -- the bench modules: the suite (a child), two of its rows traced,
        # the config-3 and restricted-layer probes, the scaling harness,
        # config 5 at pod scale (a child) -----------------------------------
        suite_rows = phase_bench_suite(repo, Path(tmp), SMOKE_SUITE_ROWS)
        bench_traces = phase_bench_traces(Path(tmp), suite_rows)
        probe_counts = phase_bench_probes()
        scaling_counts = {
            lay: {k: sum(r["launches"][k] for r in rows.values())
                  for k in ("B1", "B2", "B4")}
            for lay, rows in phase_bench_scaling()["layouts"].items()}
        pod_node, pod_zero3 = phase_pod_scale(repo)
        pod_counts = {"node": pod_node["launches"],
                      **{r["mode"]: r["launches"] for r in pod_zero3}}

        # -- the edge and sampled layouts across processes (--distributed),
        # last: its children share the card with this process --------------
        dist_counts = phase_distributed(repo, Path(tmp), graph, cfg, edges,
                                        dev)
    emit("profile_retakes", retakes=PROFILE_RETAKES)

    # -- 23. summary --------------------------------------------------------
    def bench_paths(k):
        """The bench modules' launches of kernel k (the probes' in their
        Python runs, scaling's over its rows, pod_scale's over two
        steps)."""
        return {"bench_probes": {p: c[k] for p, c in probe_counts.items()},
                "scaling": {lay: c[k] for lay, c in scaling_counts.items()},
                "pod_scale": {m: c[k] for m, c in pod_counts.items()}}

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
                             "distributed_edge_per_process_step":
                                 dist_counts["edge"]["B1"],
                             "distributed_node_per_process_step":
                                 [c["B1"] for c in dist_counts["node"]],
                             "full_kg_node_train": {
                                 k: v[0]["B1"] for k, v in kg_node.items()},
                             "full_kg_node_serve": kg_nserve["B1"],
                             "full_kg_edge_train": kg_edge_counts["B1"],
                             "sampled_cache": {k: v["B1"] for k, v in
                                               cache_counts.items()},
                             **bench_paths("B1")},
        "launches_per_step_in_graphs": {
            "train_graphed": train_graphed["default"][
                "launches_per_step_from_profile"]["B1"],
            "eval_graphed_epoch": eval_graphed["graphed"][
                "launches_from_profile"]["B1"],
            "full_kg_train_graphed": kg_graphed["graphed"][
                "launches_per_step_from_profile"]["B1"],
            **{f"bench_trace_{k}": v["launches_per_step_from_profile"]["B1"]
               for k, v in bench_traces.items()}},
        "launches_per_step": {"forward": 6, "backward": 6,
                              "grad_bases": 12},
        "launches_per_step_sharded": {
            "node_train": node_counts["B1"] / 30,
            "edge_train": edge_counts["B1"] / 30,
            **{k: v[1]["launches_per_step"]["B1"]
               for k, v in kg_node.items()},
            "full_kg_edge_train": kg_edge_counts["B1"] / 10},
        "launches_per_step_full_kg": {
            k: v["launches_per_step"] for k, v in kg_train.items()},
        "max_abs_err": max(max_err, bwd_err, grad_err, bases_err,
                           ngrad_err, kg_grad_err, edge_err, kg_ngrad_err,
                           kg_egrad_err, cache_err),
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
                                   for k, v in kg_node.items()},
            "sampled_dp_train": {k: v["launches"]["B2"]
                                 for k, v in sampled_dp.items()},
            "sampled_dp_cli": {k: v["B2"] for k, v in dp_cli_counts.items()},
            "distributed_zero3_per_process_step": dist_counts["zero3"]["B2"],
            "distributed_node_per_process_step": [
                c["B2"] for c in dist_counts["node"]],
            "full_kg_zero3": kg_zero3["launches"]["B2"],
            "combined_agg": {k: v["launches"]["B2"]
                             for k, v in agg_runs.items()},
            "sampled_cache": {k: v["B2"] for k, v in cache_counts.items()},
            **bench_paths("B2"),
            "rmat10m_sampled": {k: v["launches"]["B2"]
                                for k, v in rmat10m.items()}},
        "launches_per_step_in_graphs": {
            "sampled_train_graphed": sampled_graphed["default"][
                "launches_per_step_from_profile"]["B2"],
            "full_kg_train_graphed": kg_graphed["graphed"][
                "launches_per_step_from_profile"]["B2"],
            "rmat10m_cache_graphed": rmat10m_graphed["graphed"][
                "launches_per_step_from_profile"]["B2"],
            **{f"bench_trace_{k}": v["launches_per_step_from_profile"]["B2"]
               for k, v in bench_traces.items()}},
        "launches_per_step": {"sampled_block": 2, "restricted_step": 1,
                              "node_step": 5 * N_SHARDS,
                              "sampled_dp": {
                                  k: v["launches_per_step"]["B2"]
                                  for k, v in sampled_dp.items()},
                              "rmat10m": {
                                  k: v["launches_per_step"]["B2"]
                                  for k, v in rmat10m.items()}},
        "max_abs_err": max(b2_err, sgrad_err, kg_sgrad_err,
                           kg_b2["max_abs_err"], dp_err, kg_zero3_err,
                           b2_fetch_row["max_abs_err"], agg_err, cache_err,
                           *(r["max_abs_err"] for r in kg_b2_streams),
                           *(r["max_abs_err"] for r in r5_b2_rows)),
        "rmat10m_grad_max_abs_err": r5_err,
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
            for r in (*b2_rows, *b2_16_rows, kg_b2, *kg_b2_streams,
                      b2_fetch_row, *r5_b2_rows)},
        "zero3_fetch_backward_all_ms": b2_fetch_row["fetch_backward_all_ms"],
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
               "config 4's identity and dedup, config 5's (10M nodes) "
               "identity and dedup); a node-sharded step makes "
               "20 (the sorted backward of each shard's serve lists, "
               "endpoint fetches and relation lookup); a 4-shard "
               "data-parallel sampled step 12 (dp, zero1: each shard's two "
               "dedup and its table-gather backward) or 24 (zero3: 8 dedup "
               "and the fetch backward's 16 chunk sums; 16 on the (2, 2) "
               "mesh), whose one chunk is the zero3_fetch_backward_chunk "
               "stream and all 16 zero3_fetch_backward_all_ms; library_ms "
               "is index_add_; "
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
            "full_kg_sampled": kg_sampled_counts["B3"],
            "sampled_dp_train": {k: v["launches"]["B3"]
                                 for k, v in sampled_dp.items()},
            "distributed_zero3_per_process_step": dist_counts["zero3"]["B3"],
            "full_kg_zero3": kg_zero3["launches"]["B3"],
            "rmat10m_sampled": {k: v["launches"]["B3"]
                                for k, v in rmat10m.items()}},
        "launches_per_step_in_graphs": {
            "sampled_train_graphed": sampled_graphed["default"][
                "launches_per_step_from_profile"]["B3"]},
        "launches_per_step": {"sampled_block": 2,
                              "sampled_dp": 2 * N_SHARDS,
                              "rmat10m_block": 2},
        "max_abs_err": 0,
        "ms": total(b3_rows[:2], "kernel_ms"),
        "call_ms": total(b3_rows[:2], "kernel_call_ms"),
        "plain_ms": total(b3_rows[:2], "plain_ms"),
        "bound_ms": total(b3_rows[:2], "bound_us") / 1e3,
        "bound_by": bound_by(b3_rows[:2]),
        "library_ms": total(b3_rows[:2], "library_ms"),
        "block4_ms": total(b3_rows[2:4], "kernel_ms"),
        "block4_bound_ms": total(b3_rows[2:4], "bound_us") / 1e3,
        "shapes": {r["shape"]: {k: r[k] for k in (
            "windows", "width", "kernel_ms", "kernel_call_ms", "plain_ms",
            "library_ms", "library_call_ms", "bound_us", "bound_by",
            "vs_library", "bound_share", "kernel_cold_ms",
            "library_cold_ms") if k in r} for r in (*b3_rows, *r5_b3_rows)},
        "per": "one block-mode step over the slim CSR: ms, plain_ms, "
               "bound_ms and library_ms sum its two launches (outer and "
               "inner layer); library_ms is packed[starts[:, None] + "
               "arange(F)]; shapes gives every timed shape (the bench.py "
               "graph's block and block4 layers, width 64, config 5's "
               "block and block4 layers), vs_library = kernel_ms / "
               "library_ms, bound_share = bound / kernel_ms, *_cold_ms "
               "with 128 MB written between calls; launches is the "
               "sampled_train block/slim count. " + TIMES}, {
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
                             "full_kg_node_serve": kg_nserve["B4"],
                             "distributed_node_per_process_step": [
                                 c["B4"] for c in dist_counts["node"]],
                             **bench_paths("B4")},
        "launches_per_step": {"forward": 2, "backward": 2},
        "max_abs_err": 0,
        "ms": total(b4_rows, "kernel_ms"),
        "call_ms": total(b4_rows, "kernel_call_ms"),
        "plain_ms": total(b4_rows, "plain_ms"),
        "bound_ms": total(b4_rows, "bound_us") / 1e3,
        "bound_by": bound_by(b4_rows),
        "library_ms": total(b4_rows, "library_ms"),
        "shapes": {f"{r['shape']}/{r['dtype']}": {k: r[k] for k in (
            "n", "p", "d", "kernel_ms", "kernel_cold_ms", "kernel_call_ms",
            "plain_ms", "library_ms", "library_cold_ms", "library_call_ms",
            "bound_us", "bound_by", "vs_library", "vs_library_cold",
            "bound_share", "l2_warm")}
            for r in (*b4_rows, *b4_16_rows, *kg_b4_rows)},
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
               "node_train count; shapes gives every timed shape (the "
               "bench.py graph's at float32 and bf16, config 3's at "
               "float32), *_cold_ms with 128 MB written between calls, "
               "vs_library = kernel_ms / library_ms, bound_share = bound / "
               "the HBM time (kernel_cold_ms where l2_warm: the sends fit "
               "the card's L2, else kernel_ms). " % (b4_rows[0]["n"], b4_rows[0]["p"])
               + TIMES}]}),
        flush=True)
    print(card, flush=True)
    # The run uses one card (cuda:0) whatever the machine holds.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    # Two child modes of the distributed phase; with no argument, the run.
    CHILDREN = {"dist_child": dist_child,
                "nccl_shared_child": nccl_shared_child}
    if len(sys.argv) > 1 and sys.argv[1] in CHILDREN:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        sys.exit(CHILDREN[sys.argv[1]](sys.argv[2:]))
    sys.exit(main())
