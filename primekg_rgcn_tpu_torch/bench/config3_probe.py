"""Roofline decomposition of the config-3 (full PrimeKG) training step on
one card.

The counterpart of ``primekg_rgcn_tpu/bench/config3_probe.py``: the
``primekg-full`` suite row split into each layer's aggregation forward and
backward, the dense residual, and the card's floor of each part, so that
an optimisation of any part is judged against numbers.

Each component is captured as one CUDA graph and replayed ``steps`` times
(``suite.replayed_ms``), or, for the two whole steps, runs as an epoch of
``steps`` graphed updates as the trainer runs it (``suite.full_batch_epoch``,
timed in an epoch of replays alone, ``suite.timed_epoch``): the
counterpart of the JAX probe's ``lax.scan`` over ``steps``, which takes
the host out of the figure.

Components:
- ``step_auto_ms``     — the trainer's step (``restrict_final`` "auto")
- ``step_full_ms``     — the same with the batch-restricted final layer off
- ``conv1_fwd_bwd_ms`` — layer 1 alone, forward and input gradient
                         ([N, 64] -> [N, 128])
- ``conv2_fwd_bwd_ms`` — the full layer 2 alone ([N, 128] -> [N, 128])
- ``encode_fwd_ms``    — the two-layer forward encode only
- derived: conv2's effective share under "auto", the dense residual
  (embedding gathers, DistMult, BCE, adam, candidates), and kernel B1's
  floor of each layer's aggregation (``bench/roofline.py``).

Run (on the card): ``python -m primekg_rgcn_tpu_torch.bench.config3_probe
[--scale 1.0] [--steps 20] [--out bench_report_torch.json] [--device
cpu]``; merges the ``config3-decomp`` row into the report.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np

from primekg_rgcn_tpu_torch.bench.roofline import (FLOOR_OF,
                                                   aggregation_floors_ms)


def derive(res: Dict) -> Dict:
    """The derived fields of the measured components, in place: the saving
    of the restricted final layer end to end, conv2's effective share
    under "auto" (the full layer's cost less that saving) and the dense
    residual (the step less both layers' shares)."""
    res["restrict_saving_ms"] = res["step_full_ms"] - res["step_auto_ms"]
    res["conv2_auto_share_ms"] = (res["conv2_fwd_bwd_ms"]
                                  - res["restrict_saving_ms"])
    res["dense_residual_ms"] = (res["step_auto_ms"] - res["conv1_fwd_bwd_ms"]
                                - res["conv2_auto_share_ms"])
    return res


def run_probe(scale: float = 1.0, batch_size: int = 1024, steps: int = 20,
              device="cuda") -> Dict:
    import torch

    from primekg_rgcn_tpu_torch.bench.suite import (full_batch_epoch,
                                                    replayed_ms, timed_epoch)
    from primekg_rgcn_tpu_torch.bench.scaling import device_name
    from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
    from primekg_rgcn_tpu_torch.data.graph import build_rel_graph
    from primekg_rgcn_tpu_torch.data.synthetic import (bidirect,
                                                       primekg_full_like)
    from primekg_rgcn_tpu_torch.device import resolve_device
    from primekg_rgcn_tpu_torch.models.rgcn import encoder_apply, init_params
    from primekg_rgcn_tpu_torch.ops.rgcn_final_layer import \
        resolve_final_plan
    from primekg_rgcn_tpu_torch.ops.rgcn_segment import rgcn_layer_segment

    dev = resolve_device(device)
    raw = primekg_full_like(seed=0, scale=scale)
    src, dst, rel = bidirect(raw["src"], raw["dst"], raw["rel"])
    n, n_rel = int(raw["num_nodes"]), int(raw["num_relations"])
    graph = build_rel_graph(src, dst, rel, n, n_rel)
    cfg = ModelConfig(num_nodes=n, num_relations=n_rel)
    tcfg = TrainConfig(batch_size=batch_size)
    edges = np.stack([src, dst, rel], 1).astype(np.int64)

    plan = resolve_final_plan(graph, edges, batch_size,
                              tcfg.num_neg_samples, seed=tcfg.seed,
                              mode="auto")
    e_cap = int(sum(plan.e_cap)) if plan is not None else None

    # -- whole-step variants (graphed epochs of `steps` updates) -----------
    fallbacks = {}

    def step_timer(restrict_final):
        epoch, _ = full_batch_epoch(
            graph, edges, cfg,
            dataclasses.replace(tcfg, restrict_final=restrict_final),
            steps, dev)
        dt, fallbacks[restrict_final] = timed_epoch(epoch, steps,
                                                    epoch.graphs)
        return dt * 1e3

    g_dev = graph.to(dev)
    params = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    gen = torch.Generator(dev).manual_seed(1)

    # -- each layer alone, forward and the input's gradient ----------------
    def layer_timer(layer_params, din):
        x0 = torch.randn(n, din, generator=gen, device=dev)
        ct = torch.randn(n, cfg.hidden_dim, generator=gen, device=dev)

        def body():
            x = x0.detach().requires_grad_(True)
            out = rgcn_layer_segment(layer_params, x, g_dev)
            return torch.autograd.grad(out, x, grad_outputs=ct)[0]

        return replayed_ms(body, steps, dev)

    def encode_timer():
        def body():
            with torch.no_grad():
                return encoder_apply(params, g_dev, cfg, train=False)

        return replayed_ms(body, steps, dev)

    res = {
        "nodes": n, "relations": n_rel,
        "buckets_with_edges": sum(1 for size in graph.bucket_sizes()
                                  if size),
        "edges": int(graph.num_edges),
        "edges_padded": int(graph.padded_num_edges),
        "restricted_e_cap": e_cap,
        "platform": dev.type,
        "device": device_name(dev),
        "graphed": True,
        "step_auto_ms": step_timer("auto"),
        "step_full_ms": step_timer("off"),
        "conv1_fwd_bwd_ms": layer_timer(params["encoder"]["conv1"],
                                        cfg.embedding_dim),
        "conv2_fwd_bwd_ms": layer_timer(params["encoder"]["conv2"],
                                        cfg.hidden_dim),
        "encode_fwd_ms": encode_timer(),
    }
    # The auto step's updates that overflowed the plan and took the full
    # layer in its timed epoch.
    res["step_auto_fallbacks"] = fallbacks["auto"]
    derive(res)
    # Kernel B1's floors (forward + transpose backward of each layer).
    conv1_floor, conv2_floor = aggregation_floors_ms(
        graph, cfg, plan, batch_nodes=2 * batch_size * (
            1 + tcfg.num_neg_samples))
    res["conv1_gather_floor_ms"] = conv1_floor
    res["conv2_gather_floor_ms"] = conv2_floor
    res["floor_ms"] = conv1_floor + conv2_floor
    res["floor_fraction"] = res["floor_ms"] / res["step_auto_ms"]
    res["floor_of"] = FLOOR_OF
    return res


def main(argv: Optional[List[str]] = None):
    from primekg_rgcn_tpu_torch.bench.scaling import merge_report

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--out", default="bench_report_torch.json")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    res = run_probe(scale=args.scale, steps=args.steps, device=args.device)
    print(json.dumps(res, indent=2))
    merge_report(args.out, "config3-decomp", res)
    print(f"merged into {args.out}")
    return res


if __name__ == "__main__":
    main()
