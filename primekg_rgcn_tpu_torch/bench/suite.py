"""Benchmark suite over the BASELINE.json configurations, on one card.

The counterpart of ``primekg_rgcn_tpu/bench/suite.py``: the same rows,
report keys and row names, each timing the step as the port's trainer runs
it by default, with the card's own floors (``bench/roofline.py``):

1. primekg-default   — full-graph training step, PrimeKG statistics
2. primekg-bases     — the same with basis decomposition (num_bases=2)
3. primekg-bf16      — bfloat16 compute
4. sampled-15-10     — neighbor-sampled mini-batch step (fanouts 15/10)
5. rmat-large        — full-graph step on an R-MAT graph (500k nodes, 5M
                       edges, 10 relations)
6. eval-ranking      — all-tails ranking throughput (score_all_tails + rank)
7. sampled-10m-*     — config 5 (10M nodes, 100M edges, 50 relations)
                       sampled steps: pick modes, budgets, identity
                       threshold, the layer-1 history cache (*-cache-*)
8. ident-crossover   — dedup against identity regime sweep on config 5
9. primekg-full, sampled-full-* — BASELINE configs 3 and 4
10. sharded-1dev-pallas — the edge layout on a mesh of one shard

Each row says in ``graphed`` how it times its step, fixed per row: the
full-graph update and the one-device sampled step as CUDA-graph replays
(``train/graphs.StepGraphs``, through ``build_train_epoch`` and
``SampledEpoch``: one warm epoch of the row's steps, which warms up and
captures, then one timed epoch of replays alone, ``timed_epoch``), the
ranking and the sharded
step eagerly, as the port runs them. Times are host clock ended by
``torch.cuda.synchronize()``.

The JAX rows that pick an implementation the port does not have are
refused (``REFUSED``): each op has one route on the card.

Usage: ``python -m primekg_rgcn_tpu_torch.bench.suite [--out
bench_report_torch.json] [--configs primekg-default sampled-15-10 ...]
[--device cpu]``. A row that fails is recorded as ``{"error": ...}`` and
the run goes on to the next; the command then exits 1.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from primekg_rgcn_tpu_torch.bench.roofline import (
    F32_FLOPS, HBM_BYTES_PER_S, floor_fields, step_aggregation_floor_ms)
from primekg_rgcn_tpu_torch.bench.scaling import sync

BASELINE_EDGES_PER_S = 1_677_772 / (4.5 * 3600 / 100)  # RTX-1070 anchor

# BASELINE config 5: R-MAT nodes, edges, relations.
RMAT10M = (10_000_000, 100_000_000, 50)

_ONE_ROUTE = "the port has one route on the card"
REFUSED = {
    "primekg-xla": f"impl='xla' ({_ONE_ROUTE}: kernel B1)",
    "sampled-10m-block-pallas-15-10": f"window_impl ({_ONE_ROUTE}: kernel "
                                      "B3)",
    "sampled-10m-block-xla-15-10": f"window_impl ({_ONE_ROUTE}: kernel B3)",
    "sharded-1dev-xla": f"agg='xla' ({_ONE_ROUTE}: kernel B1)",
}


def _timed_steps(step_fn, n_steps: int, warmup: int = 3) -> float:
    """Seconds a step of ``step_fn(i)``: ``warmup`` steps, then ``n_steps``
    on the host clock, ended by a synchronise."""
    for i in range(warmup):
        step_fn(i)
    sync()
    t0 = time.perf_counter()
    for i in range(n_steps):
        step_fn(i)
    sync()
    return (time.perf_counter() - t0) / n_steps


# Epochs ``timed_epoch`` times at most before it gives up on finding one
# of replays alone.
TIMED_EPOCH_TRIES = 10


def timed_epoch(epoch: Callable[[], object], n_steps: int,
                graphs) -> Tuple[float, int]:
    """(seconds a step, the restricted final layer's fallbacks) of an
    epoch of ``n_steps`` graphed steps: one epoch warms up and captures its
    graphs (``graphs``, the epoch's ``StepGraphs``), then one of replays
    alone is timed. A timed epoch in which a graph was warmed up or
    captured is timed again: a batch that first overflows the restricted
    layer's plan warms up, then captures, the other branch's graph, a
    one-time cost that is not a step's."""
    from primekg_rgcn_tpu_torch.ops.rgcn_final_layer import \
        final_layer_restricted

    epoch()
    for _ in range(TIMED_EPOCH_TRIES):
        sync()
        before = (graphs.warmups, graphs.captures)
        fallbacks = final_layer_restricted.fallbacks
        t0 = time.perf_counter()
        epoch()
        sync()
        dt = (time.perf_counter() - t0) / n_steps
        if (graphs.warmups, graphs.captures) == before:
            return dt, final_layer_restricted.fallbacks - fallbacks
    raise RuntimeError(f"every one of {TIMED_EPOCH_TRIES} timed epochs "
                       "warmed up or captured a graph")


def replayed_ms(body: Callable[[], object], steps: int, device) -> float:
    """Milliseconds a run of ``body``, captured as one CUDA graph
    (``StepGraphs``: an eager warm-up, then the capture) and replayed
    ``steps`` times on the host clock, ended by a synchronise: the
    counterpart of the JAX probes' ``lax.scan`` over ``steps`` (on the
    CPU the body runs eagerly each time)."""
    from primekg_rgcn_tpu_torch.train.graphs import StepGraphs

    graphs = StepGraphs(device)
    for _ in range(2):
        graphs.run("body", body)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        graphs.run("body", body)
    sync()
    return (time.perf_counter() - t0) / steps * 1e3


def _rate_fields(b: int, dt: float) -> Dict:
    return {"step_ms": dt * 1e3, "edges_per_s": b / dt,
            "vs_baseline": b / dt / BASELINE_EDGES_PER_S}


def _fresh_params(model_cfg, dev):
    """The model's parameters from seed 0 on ``dev``, requiring grad."""
    import torch

    from primekg_rgcn_tpu_torch.models.rgcn import init_params, param_leaves

    params = init_params(torch.Generator().manual_seed(0), model_cfg,
                         device=dev)
    for p in param_leaves(params):
        p.requires_grad_(True)
    return params


@functools.lru_cache(maxsize=2)
def _primekg(dataset: str, scale: float):
    """(src, dst, rel, num_nodes, num_relations) of ``primekg_like`` or, as
    "primekg-full", ``primekg_full_like`` (seed 0, bidirected), kept for
    the next rows of the same graph."""
    from primekg_rgcn_tpu_torch.data.synthetic import (
        bidirect, primekg_full_like, primekg_like)

    make = primekg_full_like if dataset == "primekg-full" else primekg_like
    raw = make(seed=0, scale=scale)
    src, dst, rel = bidirect(raw["src"], raw["dst"], raw["rel"])
    return src, dst, rel, int(raw["num_nodes"]), int(raw["num_relations"])


def rmat_graph(num_nodes: int, num_edges: int, num_relations: int):
    """(src, dst, rel) int64 of ``native.rmat_native`` (numpy ``rmat``
    without the library), seed 0, not bidirected."""
    from primekg_rgcn_tpu_torch import native
    from primekg_rgcn_tpu_torch.data.synthetic import rmat

    g = native.rmat_native(num_nodes, num_edges, num_relations, seed=0)
    if g is None:
        g = rmat(num_nodes, num_edges, num_relations, seed=0)
    return g["src"], g["dst"], g["rel"]


@functools.lru_cache(maxsize=1)
def rmat_rel_graph(num_nodes: int, num_edges: int, num_relations: int):
    """(RelGraph, positives int32 [E, 3], seconds by stage) of
    :func:`rmat_graph` and ``build_rel_graph``, on the host. About a
    minute at config 5's size; kept for the next caller of the same
    size (the memo changes no result)."""
    from primekg_rgcn_tpu_torch.data.graph import build_rel_graph

    t0 = time.perf_counter()
    src, dst, rel = rmat_graph(num_nodes, num_edges, num_relations)
    times = {"rmat_gen_s": time.perf_counter() - t0}
    edges = np.stack([src, dst, rel], 1).astype(np.int32)
    t0 = time.perf_counter()
    graph = build_rel_graph(src, dst, rel, num_nodes, num_relations)
    times["graph_build_s"] = time.perf_counter() - t0
    return graph, edges, times


@functools.lru_cache(maxsize=1)
def config5(num_nodes: int, num_edges: int, num_relations: int):
    """(combined CSR, positives int32 [E, 3], seconds by stage) of the
    R-MAT graph, as the sampled config-5 rows build it:
    :func:`rmat_rel_graph`, then ``build_combined_csr``; kept for the rows
    after."""
    from primekg_rgcn_tpu_torch.data.sampling import build_combined_csr

    graph, edges, times = rmat_rel_graph(num_nodes, num_edges,
                                         num_relations)
    t0 = time.perf_counter()
    ccsr = build_combined_csr(graph)
    return ccsr, edges, {**times, "csr_build_s": time.perf_counter() - t0}


def full_batch_epoch(graph, edges: np.ndarray, model_cfg, train_cfg,
                     n_steps: int, device):
    """``(epoch, final_plan)``: ``epoch()`` runs one epoch of ``n_steps``
    full-graph updates of batch ``train_cfg.batch_size`` as
    ``train/loop.Trainer`` runs them, each a CUDA-graph replay
    (``StepGraphs``; eager bodies on the CPU), over random batches of
    ``edges`` ([E, 3], drawn by ``rng.integers`` from seed 0, as the JAX
    suite draws them), on ``graph`` (on the CPU) moved to ``device``.
    The batch-restricted final layer is resolved per
    ``train_cfg.restrict_final``, sized on all of ``edges``. Parameters
    from seed 0."""
    import torch

    from primekg_rgcn_tpu_torch.train.graphs import StepGraphs
    from primekg_rgcn_tpu_torch.train.loop import (build_train_epoch,
                                                   make_optimizer)

    b = train_cfg.batch_size
    params = _fresh_params(model_cfg, device)
    opt = make_optimizer(train_cfg, params)
    sample = edges[np.random.default_rng(0).integers(0, len(edges),
                                                     n_steps * b)]
    device_gen = torch.Generator(device).manual_seed(0)
    host_gen = torch.Generator().manual_seed(0)
    graphs = StepGraphs(device, device_gen)
    epoch_fn = build_train_epoch(graph.to(device), sample, model_cfg,
                                 train_cfg, params, opt, graphs=graphs,
                                 plan_edges=edges)

    def epoch():
        return epoch_fn(host_gen, device_gen)

    epoch.graphs = graphs
    return epoch, epoch_fn.final_plan


def _full_batch_config(num_bases=None, compute_dtype="float32", impl="auto",
                       graph_override=None, *, scale: float = 1.0,
                       n_steps: int = 30, device="cuda"):
    """The full-graph training step as the trainer runs it
    (:func:`full_batch_epoch`, ``restrict_final`` "auto"), on the
    ``bench.py`` graph at ``scale`` or on ``graph_override`` (src, dst,
    rel, num_nodes, num_relations): (epoch, batch_size, graph, final_plan,
    model_cfg)."""
    from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
    from primekg_rgcn_tpu_torch.data.graph import build_rel_graph
    from primekg_rgcn_tpu_torch.device import resolve_device

    if impl == "xla":
        raise ValueError(REFUSED["primekg-xla"])
    dev = resolve_device(device)
    if graph_override is None:
        src, dst, rel, n, r = _primekg("primekg", scale)
    else:
        src, dst, rel, n, r = graph_override
    graph = build_rel_graph(src, dst, rel, n, r)
    model_cfg = ModelConfig(num_nodes=n, num_relations=r,
                            num_bases=num_bases, compute_dtype=compute_dtype)
    train_cfg = TrainConfig(batch_size=1024)
    edges = np.stack([src, dst, rel], 1).astype(np.int64)
    epoch, plan = full_batch_epoch(graph, edges, model_cfg, train_cfg,
                                   n_steps, dev)
    return epoch, train_cfg.batch_size, graph, plan, model_cfg


def _gather_floor_fields(graph, dt_s: float, final_plan=None, *,
                         model_cfg, batch_size: int = 1024,
                         num_neg_samples: int = 1) -> Dict:
    """The step's aggregation floor on the card (``bench/roofline.py``):
    kernel B1's bound over both layers, forward and transpose backward,
    conv1 over every padded edge and conv2 over every padded edge or, with
    the batch-restricted final layer, over the plan's ``sum(e_cap)``
    slots. ``floor_fraction`` = floor / measured step; a drop flags a
    regression against the step's own bound."""
    floor = step_aggregation_floor_ms(
        graph, model_cfg, final_plan,
        batch_nodes=2 * batch_size * (1 + num_neg_samples))
    return floor_fields(floor, dt_s)


def _full_batch_row(epoch, b, graph, plan, cfg, n_steps) -> Dict:
    """A full-graph row's fields: the timed epoch (``timed_epoch``), the
    restricted layer's fallbacks in it (of ``n_steps`` updates) and the
    aggregation floor."""
    dt, fallbacks = timed_epoch(epoch, n_steps, epoch.graphs)
    return {**_rate_fields(b, dt), "graphed": True,
            "restricted_final_layer": plan is not None,
            "fallbacks": fallbacks,
            **_gather_floor_fields(graph, dt, plan, model_cfg=cfg)}


def bench_full_batch(**kw) -> Dict:
    n_steps = kw.pop("n_steps", 30)
    return _full_batch_row(*_full_batch_config(n_steps=n_steps, **kw),
                           n_steps)


def bench_sampled(fanouts=(15, 10), dataset="primekg",
                  compute_dtype=None, mode="uniform",
                  window_impl=None, ident_fraction=None,
                  cache=False, *, scale: float = 1.0, n_steps: int = 30,
                  size: Tuple[int, int, int] = RMAT10M,
                  device="cuda") -> Dict:
    """Mini-batch neighbor-sampled training step on one device, graphed
    as ``SampledTrainer`` runs it (``SampledEpoch``).

    dataset "primekg" is the ``bench.py`` graph, "primekg-full" BASELINE
    config 4's, "rmat-10m" config 5's (``size``): bf16 compute, the
    sparse-embedding step and plain SGD for every leaf, no clip, as the
    JAX suite runs it on one chip (dense adam state would be 3x the
    parameters). ``cache`` trains the layer-1 history cache the same way
    (the combined layout). ``ident_fraction`` sets
    ``PRIMEKG_IDENT_FRACTION`` for this row only.
    """
    import torch

    from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
    from primekg_rgcn_tpu_torch.data.graph import build_rel_graph
    from primekg_rgcn_tpu_torch.device import resolve_device
    from primekg_rgcn_tpu_torch.train.graphs import StepGraphs
    from primekg_rgcn_tpu_torch.train.sampled import (SampledEpoch,
                                                      build_sampled_train_step)

    if window_impl is not None:
        raise ValueError(REFUSED["sampled-10m-block-xla-15-10"])
    dev = resolve_device(device)
    big = dataset == "rmat-10m"
    if big:
        csr, edges, _ = config5(*size)
        n, n_rel = size[0], csr.num_relations
    elif dataset in ("primekg", "primekg-full"):
        src, dst, rel, n, _ = _primekg(dataset, scale)
        n_rel = int(rel.max()) + 1
        csr = build_rel_graph(src, dst, rel, n, n_rel)
        edges = np.stack([src, dst, rel], 1)
    else:
        raise ValueError(f"unknown dataset {dataset!r}")
    cfg = ModelConfig(num_nodes=n, num_relations=n_rel,
                      compute_dtype=compute_dtype
                      or ("bfloat16" if big else "float32"))
    sparse = big or cache
    # The sparse-embedding step (and the cache, which extends it) updates
    # the table by plain SGD; the JAX suite trains every leaf with it.
    tcfg = (TrainConfig(batch_size=1024, optimizer="sgd", grad_clip=0.0)
            if sparse else TrainConfig(batch_size=1024))
    b = tcfg.batch_size
    prev_ident = os.environ.get("PRIMEKG_IDENT_FRACTION")
    if ident_fraction is not None:
        # The identity threshold (data/sampling.py) for this row; restored
        # in the finally below, so that no later row sees it.
        os.environ["PRIMEKG_IDENT_FRACTION"] = str(ident_fraction)
    try:
        step = build_sampled_train_step(
            csr, cfg, tcfg, fanouts=fanouts, mode=mode,
            layout="combined" if cache else "auto", sparse_emb=sparse,
            cache_layer1=cache, device=dev)
        params = _fresh_params(cfg, dev)
        opt = step.init_optimizer(params)
        gen = torch.Generator(dev).manual_seed(0)
        pos = torch.from_numpy(edges[np.random.default_rng(0).integers(
            0, len(edges), n_steps * b)].astype(np.int64)).to(dev)
        graphs = StepGraphs(dev, gen)
        epoch = SampledEpoch(step, params, opt, pos, gen, tcfg,
                             graphs=graphs)
        order = np.arange(n_steps * b)
        dt, _ = timed_epoch(lambda: epoch(order), n_steps, graphs)
    finally:
        if ident_fraction is not None:
            if prev_ident is None:
                os.environ.pop("PRIMEKG_IDENT_FRACTION", None)
            else:
                os.environ["PRIMEKG_IDENT_FRACTION"] = prev_ident
    return {**_rate_fields(b, dt), "graphed": True,
            "budgets": list(step.budgets)}


def bench_ident_sweep(fanouts=(8, 5), batches=(1024, 512, 256, 128, 64),
                      n_steps=15, *, size: Tuple[int, int, int] = RMAT10M,
                      device="cuda") -> Dict:
    """Dedup against identity regime sweep on config 5's graph.

    The identity threshold (``PRIMEKG_IDENT_FRACTION``) decides, from the
    innermost layer's static raw pick-slot count as a fraction of the node
    space, whether the sampled step keeps the deduplicated frontier or
    gathers straight from the table. Raw slots scale with the batch at
    fixed budgets, so this sweep varies the batch, times both regimes at
    each point (the graphed sparse SGD step, as the config-5 rows) and
    interpolates the crossover fraction.
    """
    import torch

    from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
    from primekg_rgcn_tpu_torch.data.sampling import (sample_batch_combined,
                                                      uniform_draw)
    from primekg_rgcn_tpu_torch.device import resolve_device
    from primekg_rgcn_tpu_torch.train.graphs import StepGraphs
    from primekg_rgcn_tpu_torch.train.sampled import (
        SampledEpoch, build_sampled_train_step, resolve_sampler)

    dev = resolve_device(device)
    csr, edges, _ = config5(*size)
    n = size[0]
    csr, budgets, _ = resolve_sampler(csr, fanouts)

    prev_ident = os.environ.get("PRIMEKG_IDENT_FRACTION")
    points = []
    try:
        for b in batches:
            cfg = ModelConfig(num_nodes=n, num_relations=csr.num_relations,
                              compute_dtype="bfloat16")
            tcfg = TrainConfig(batch_size=b, optimizer="sgd", grad_clip=0.0)
            # The innermost layer's static raw slot count at this batch
            # size (the ids do not change the shapes: one host sample).
            seeds = torch.zeros(2 * b * (1 + tcfg.num_neg_samples),
                                dtype=torch.int32)
            probe = sample_batch_combined(
                uniform_draw(torch.Generator().manual_seed(0), "cpu"), csr,
                seeds, budgets, allow_ident=False)
            raw = int(np.prod(probe.blocks[0].src_local.shape))
            pt = {"batch": b, "raw_slots": raw, "raw_fraction": raw / n}
            for regime, frac_env in (("ident", "1e-9"), ("dedup", "9e9")):
                os.environ["PRIMEKG_IDENT_FRACTION"] = frac_env
                step = build_sampled_train_step(csr, cfg, tcfg,
                                                fanouts=fanouts,
                                                sparse_emb=True, device=dev)
                params = _fresh_params(cfg, dev)
                opt = step.init_optimizer(params)
                gen = torch.Generator(dev).manual_seed(0)
                pos = torch.from_numpy(edges[np.random.default_rng(0)
                                             .integers(0, len(edges),
                                                       n_steps * b)]
                                       .astype(np.int64)).to(dev)
                graphs = StepGraphs(dev, gen)
                epoch = SampledEpoch(step, params, opt, pos, gen, tcfg,
                                     graphs=graphs)
                order = np.arange(n_steps * b)
                dt, _ = timed_epoch(lambda: epoch(order), n_steps, graphs)
                pt[f"{regime}_ms"] = dt * 1e3
                del epoch, step, params, opt, pos
            points.append(pt)
            print(json.dumps(pt), flush=True)
    finally:
        if prev_ident is None:
            os.environ.pop("PRIMEKG_IDENT_FRACTION", None)
        else:
            os.environ["PRIMEKG_IDENT_FRACTION"] = prev_ident

    # Crossover: walk the points by ascending fraction and interpolate
    # where identity-minus-dedup changes sign. If identity wins everywhere
    # measured, the smallest measured fraction bounds the crossover.
    pts = sorted(points, key=lambda p: p["raw_fraction"])
    crossover = None
    for lo, hi in zip(pts, pts[1:]):
        d_lo = lo["ident_ms"] - lo["dedup_ms"]
        d_hi = hi["ident_ms"] - hi["dedup_ms"]
        if d_lo >= 0 and d_hi < 0:
            t = d_lo / (d_lo - d_hi) if d_lo != d_hi else 0.0
            crossover = lo["raw_fraction"] + t * (
                hi["raw_fraction"] - lo["raw_fraction"])
            break
    ident_everywhere = all(p["ident_ms"] <= p["dedup_ms"] for p in pts)
    head = next(p for p in points if p["batch"] == batches[0])
    best = min(head["ident_ms"], head["dedup_ms"])
    return {"step_ms": best,
            "edges_per_s": batches[0] / (best / 1e3),
            "crossover_fraction": crossover,
            "ident_wins_everywhere": ident_everywhere,
            "graphed": True,
            "points": points}


def bench_primekg_full(scale=1.0, *, n_steps: int = 10,
                       device="cuda") -> Dict:
    """BASELINE.json config 3: full PrimeKG (about 129K nodes, 30
    relations, 4.6M directed edges), per-relation buckets at realistic
    skew."""
    src, dst, rel, n, r = _primekg("primekg-full", scale)
    return {"nodes": n, "relations": r, "edges": int(len(src)),
            **_full_batch_row(*_full_batch_config(
                graph_override=(src, dst, rel, n, r), n_steps=n_steps,
                device=device), n_steps)}


def bench_rmat(num_nodes=500_000, num_edges=5_000_000, num_relations=10, *,
               n_steps: int = 10, device="cuda") -> Dict:
    """The full-graph step on an R-MAT graph of ``num_nodes`` nodes,
    ``num_edges`` edges and ``num_relations`` relations."""
    src, dst, rel = rmat_graph(num_nodes, num_edges, num_relations)
    row = _full_batch_row(*_full_batch_config(
        graph_override=(src, dst, rel, num_nodes, num_relations),
        n_steps=n_steps, device=device), n_steps)
    # Candidate edges/s at batch 1024 like every other full-graph row; the
    # rate over the graph's edges is kept too.
    return {"nodes": num_nodes, "edges": num_edges, **row,
            "graph_edges_per_s_fwd_bwd": num_edges / (row["step_ms"] / 1e3)}


def bench_eval_ranking(*, n: int = 30926, d: int = 128, b: int = 1024,
                       n_steps: int = 30, device="cuda") -> Dict:
    """All-tails ranking of ``b`` queries over ``n`` entities, eager."""
    import torch

    from primekg_rgcn_tpu_torch.device import resolve_device
    from primekg_rgcn_tpu_torch.evaluate.metrics import ranks_of_true_tails
    from primekg_rgcn_tpu_torch.ops.distmult import distmult_score_all_tails

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    emb = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    rel = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
    heads = torch.from_numpy(rng.integers(0, n, b)).to(dev)
    tails = torch.from_numpy(rng.integers(0, n, b)).to(dev)

    def step(i):
        with torch.no_grad():
            scores = distmult_score_all_tails(emb[heads], rel, emb)
            return ranks_of_true_tails(scores, tails)

    dt = _timed_steps(step, n_steps)
    # The ranking batch's floor (edges/s means nothing here): the larger
    # of its HBM bytes (the [B, N] scores written and read back by the rank
    # reduction, the table read once) at the card's HBM rate and the score
    # GEMM's 2 * B * N * D float32 operations at its float32 rate.
    hbm_ms = (2 * b * n + n * d + b * d) * 4 / HBM_BYTES_PER_S * 1e3
    op_ms = 2 * b * n * d / F32_FLOPS * 1e3
    floor_ms = max(hbm_ms, op_ms)
    return {"batch_ms": dt * 1e3, "step_ms": dt * 1e3,
            "triples_per_s": b / dt, "entities": n, "graphed": False,
            "floor_ms": floor_ms, "floor_fraction": floor_ms / (dt * 1e3),
            "hbm_floor_ms": hbm_ms, "op_floor_ms": op_ms,
            "floor_of": "NVIDIA H100 SXM at 3.35e12 B/s HBM3 and 67e12 "
                        "float32 FLOP/s, the larger of: the [B, N] scores "
                        "written and read once, the table and the relation "
                        "rows read once; the score GEMM's 2 * B * N * D "
                        "operations"}


def bench_sharded_step(agg: str = "pallas", scale: float = 1.0, *,
                       n_steps: int = 20, device="cuda") -> Dict:
    """The edge-sharded training step on a mesh of one shard, eager as
    ``ShardedTrainer`` runs it: the sharded program at its one-card cost.
    ``agg`` "pallas" names the JAX row; the port has one route."""
    import torch

    from primekg_rgcn_tpu_torch.bench.scaling import one_shard_mesh
    from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
    from primekg_rgcn_tpu_torch.data.graph import build_rel_graph
    from primekg_rgcn_tpu_torch.parallel.edge_shard import (
        build_sharded_train_step, shard_rel_graph)
    from primekg_rgcn_tpu_torch.train.loop import make_optimizer

    if agg != "pallas":
        raise ValueError(REFUSED["sharded-1dev-xla"])
    mesh = one_shard_mesh(device)
    src, dst, rel, n, _ = _primekg("primekg", scale)
    graph = build_rel_graph(src, dst, rel, n, 3)
    cfg = ModelConfig(num_nodes=n, num_relations=3)
    tcfg = TrainConfig(batch_size=1024)
    params = _fresh_params(cfg, mesh.device)
    opt = make_optimizer(tcfg, params)
    sstep = build_sharded_train_step(mesh, shard_rel_graph(graph, 1), cfg,
                                     tcfg)
    gen = torch.Generator(mesh.device).manual_seed(0)
    rng = np.random.default_rng(0)
    b = tcfg.batch_size

    def step(i):
        batch = np.zeros((b, 4), np.int64)
        batch[:, 0] = rng.integers(0, cfg.num_nodes, b)
        batch[:, 1] = rng.integers(0, cfg.num_nodes, b)
        batch[:, 2] = rng.integers(0, 3, b)
        batch[:, 3] = 1
        return sstep(params, opt, torch.from_numpy(batch).to(mesh.device),
                     gen)

    dt = _timed_steps(step, n_steps)
    return {**_rate_fields(b, dt), "agg": agg, "mesh": 1, "graphed": False}


CONFIGS: Dict[str, Callable[..., Dict]] = {
    "primekg-default": bench_full_batch,
    "primekg-bases": functools.partial(bench_full_batch, num_bases=2),
    "primekg-bf16": functools.partial(bench_full_batch,
                                      compute_dtype="bfloat16"),
    "sampled-15-10": functools.partial(bench_sampled, (15, 10)),
    "sampled-full-15-10": functools.partial(bench_sampled, (15, 10),
                                            "primekg-full"),
    "sampled-full-bf16-15-10": functools.partial(
        bench_sampled, (15, 10), "primekg-full", compute_dtype="bfloat16"),
    # Config 4 at the low budget (8/5).
    "sampled-full-8-5": functools.partial(bench_sampled, (8, 5),
                                          "primekg-full"),
    "sampled-10m-15-10": functools.partial(bench_sampled, (15, 10),
                                           "rmat-10m"),
    "sampled-10m-block-15-10": functools.partial(
        bench_sampled, (15, 10), "rmat-10m", mode="block"),
    "sampled-10m-8-5": functools.partial(bench_sampled, (8, 5), "rmat-10m"),
    # The identity threshold at 0.4 and 0.3 for the 8/5 budgets, whose
    # innermost raw stream sits near those fractions of N.
    "sampled-10m-8-5-ident04": functools.partial(
        bench_sampled, (8, 5), "rmat-10m", ident_fraction=0.4),
    "sampled-10m-8-5-ident03": functools.partial(
        bench_sampled, (8, 5), "rmat-10m", ident_fraction=0.3),
    "sampled-10m-block-8-5": functools.partial(
        bench_sampled, (8, 5), "rmat-10m", mode="block"),
    "sampled-10m-block4-8-5": functools.partial(
        bench_sampled, (8, 5), "rmat-10m", mode="block4"),
    # blockN: N independent sub-windows a node, the same budget and bytes
    # as block, about N times the relations covered a step.
    "sampled-10m-block4-15-10": functools.partial(
        bench_sampled, (15, 10), "rmat-10m", mode="block4"),
    "ident-crossover": bench_ident_sweep,
    # Layer-1 histories: one sampled hop serves both convolutions.
    "sampled-10m-cache-15-10": functools.partial(
        bench_sampled, (15, 10), "rmat-10m", cache=True),
    "sampled-10m-cache-8-5": functools.partial(
        bench_sampled, (8, 5), "rmat-10m", cache=True),
    "sampled-full-cache-15-10": functools.partial(
        bench_sampled, (15, 10), "primekg-full", cache=True),
    "primekg-full": bench_primekg_full,
    "rmat-large": bench_rmat,
    "eval-ranking": bench_eval_ranking,
    "sharded-1dev-pallas": functools.partial(bench_sharded_step, "pallas"),
}


def card_line() -> str:
    """The card's ``nvidia-smi --query-gpu=name,power.limit`` line, or
    "cpu" when no card is in use."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{torch.cuda.get_device_name(0)} (nvidia-smi: {e})"
    if smi.returncode != 0 or not smi.stdout.strip():
        return f"{torch.cuda.get_device_name(0)} (nvidia-smi failed)"
    return smi.stdout.strip().splitlines()[0]


def _release() -> None:
    """Free what the last row left on the card."""
    import torch

    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def main(argv: Optional[List[str]] = None):
    """Run the rows and write the report (merged into an existing one at
    ``--out``). Returns the report when every row ran; after writing it,
    exits 1 when a row failed (the JAX suite records the error and exits
    0)."""
    p = argparse.ArgumentParser(description="Benchmark suite")
    p.add_argument("--out", default="bench_report_torch.json")
    p.add_argument("--configs", nargs="+", default=list(CONFIGS))
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    for name in args.configs:
        if name in REFUSED:
            p.error(f"{name} is not a row of the port: {REFUSED[name]}")
        if name not in CONFIGS:
            p.error(f"unknown row {name!r}")

    report = {"device": card_line() if args.device == "cuda" else "cpu",
              "baseline_edges_per_s": BASELINE_EDGES_PER_S,
              "results": {}}
    # Partial runs (--configs a b) merge into an existing report.
    try:
        with open(args.out) as f:
            prev = json.load(f)
        report["results"].update(prev.get("results", {}))
    except (OSError, ValueError):
        pass
    failed = []
    for name in args.configs:
        print(f"== {name} ==", flush=True)
        t0 = time.perf_counter()
        try:
            report["results"][name] = CONFIGS[name](device=args.device)
        except Exception as e:  # record the row, go on with the next
            traceback.print_exc()
            report["results"][name] = {"error": f"{type(e).__name__}: {e}"}
            failed.append(name)
        report["results"][name]["row_s"] = time.perf_counter() - t0
        print(json.dumps(report["results"][name]), flush=True)
        _release()
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(f"wrote {args.out}")
    if failed:
        print(f"rows failed: {failed}", file=sys.stderr)
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
