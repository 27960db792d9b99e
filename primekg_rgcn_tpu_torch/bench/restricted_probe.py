"""Probe of the batch-restricted final layer on one card: a static
restricted layer, built on the host for one batch, against the dynamic
restricted layer and the full layer.

The counterpart of ``primekg_rgcn_tpu/bench/restricted_probe.py``, the
tool for the open question whether ``ops/rgcn_final_layer.AUTO_EDGE_RATIO``
is the card's break-even:

- **full**: conv2 through ``rgcn_layer_segment`` over every edge (kernel
  B1 both ways), its rows at the batch's nodes;
- **dynamic**: ``final_layer_restricted`` with ``plan_final_layer``'s
  plan: the batch's ranges enumerated on the device into the plan's
  static slots, one grouped gather and kernel B2's sorted segment-sum;
- **static**: each relation's in-edges of the batch's nodes, extracted on
  the host (:func:`_extract_restricted`), through kernel B1
  (``GatherSegmentSum``) over their CSR of m + 1 rows forward and their
  transpose CSR of n + 1 rows backward: what a per-batch plan stored for
  the epoch would run (the JAX probe ran its Pallas schedules here).

Each is timed forward and backward (the input's gradient), captured as one
CUDA graph and replayed ``steps`` times, as in the config-3 probe. The
static rows must equal the full layer's (rtol and atol 2e-4) before
anything is timed; a mismatch raises.

Run: ``python -m primekg_rgcn_tpu_torch.bench.restricted_probe [--scale
1.0] [--batch_size 1024] [--steps 30] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import numpy as np

# Padding multiple of the extracted edge lists: the JAX package's SEG_K,
# so that the arrays equal the JAX probe's.
SEG_K = 512


def _extract_restricted(graph, nodes_u: np.ndarray):
    """Per relation: the edges whose destination is in ``nodes_u`` (sorted
    unique ids), in both sort orders.

    Returns a list of dicts with the destination-sorted (src, dst_local,
    scale) and source-sorted (t_src, t_dst_local, t_scale) arrays, each
    padded to a multiple of ``SEG_K`` (sentinels: source row N, local row
    m, scale 0), and ``real_edges``.
    """
    n = graph.num_nodes
    m = len(nodes_u)
    src_h = graph.src.cpu().numpy()
    dst_h = graph.dst.cpu().numpy()

    out = []
    for r in range(graph.num_relations):
        s, e = graph.bucket_slice(r)
        rp = np.searchsorted(dst_h[s:e], np.arange(n + 1)).astype(np.int64)
        # Each restricted node's in-edges are one contiguous range, in
        # destination order (nodes_u is sorted).
        starts, stops = rp[nodes_u], rp[nodes_u + 1]
        counts = stops - starts
        eid = np.repeat(starts, counts) + (
            np.arange(counts.sum()) -
            np.repeat(np.cumsum(counts) - counts, counts))
        src = src_h[s:e][eid].astype(np.int32)
        dstl = np.repeat(np.arange(m, dtype=np.int32), counts)
        if graph.norm_mode == "edge":
            scale = graph.edge_scale.cpu().numpy()[s:e][eid].astype(
                np.float32)
        else:
            scale = graph.inv_in_deg[r].cpu().numpy()[nodes_u][dstl].astype(
                np.float32)

        ecnt = len(src)
        pad = (-ecnt) % SEG_K
        src_p = np.concatenate([src, np.full(pad, n, np.int32)])
        dstl_p = np.concatenate([dstl, np.full(pad, m, np.int32)])
        scale_p = np.concatenate([scale, np.zeros(pad, np.float32)])

        order = np.argsort(src_p[:ecnt], kind="stable")
        t_src = np.concatenate([src_p[:ecnt][order],
                                np.full(pad, n, np.int32)])
        t_dstl = np.concatenate([dstl_p[:ecnt][order],
                                 np.full(pad, m, np.int32)])
        t_scale = np.concatenate([scale_p[:ecnt][order],
                                  np.zeros(pad, np.float32)])
        out.append(dict(src=src_p, dst_local=dstl_p, scale=scale_p,
                        t_src=t_src, t_dst_local=t_dstl, t_scale=t_scale,
                        real_edges=ecnt))
    return out


def static_ops(restricted, n: int, m: int, device):
    """Each relation's kernel B1 operands for the static restricted layer:
    ``AggOp`` over the destination-sorted edges with their CSR of m + 1
    rows (the sentinels in row m) and the transpose CSR of n + 1 rows
    (the sentinels in row n), on ``device``."""
    import torch

    from primekg_rgcn_tpu_torch.ops.rgcn_segment import AggOp

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def rowptr(keys, rows):
        return t(np.searchsorted(keys, np.arange(rows + 1)).astype(np.int32))

    return [AggOp(src=t(d["src"]), rowptr=rowptr(d["dst_local"], m + 1),
                  scale=t(d["scale"]), t_ids=t(d["t_dst_local"]),
                  t_rowptr=rowptr(d["t_src"], n + 1), t_scale=t(d["t_scale"]))
            for d in restricted]


def static_rows(layer_params, x, ops, nodes_u):
    """The final layer's rows at ``nodes_u`` (int64, sorted unique) of
    ``x`` [N, Din] through the static restricted layer: each relation's
    kernel B1 over :func:`static_ops`, equal to ``rgcn_layer_segment``'s
    rows there up to summation order, differentiable in ``x``."""
    import torch

    from primekg_rgcn_tpu_torch.ops.rgcn_segment import (
        aggregate, materialize_relation_weights)

    m = nodes_u.shape[0]
    w_rel = materialize_relation_weights(layer_params)
    xp = torch.cat([x, x.new_zeros(1, x.shape[1])])
    out = xp[nodes_u] @ layer_params["w_root"] + layer_params["bias"][None, :]
    for r, op in enumerate(ops):
        out = out + aggregate(xp, op)[:m] @ w_rel[r]
    return out


def run_probe(scale: float = 1.0, batch_size: int = 1024, steps: int = 30,
              seed: int = 0, device="cuda") -> Dict:
    import torch

    from primekg_rgcn_tpu_torch.bench.scaling import device_name
    from primekg_rgcn_tpu_torch.bench.suite import replayed_ms
    from primekg_rgcn_tpu_torch.config import ModelConfig
    from primekg_rgcn_tpu_torch.data.graph import build_rel_graph
    from primekg_rgcn_tpu_torch.data.synthetic import bidirect, primekg_like
    from primekg_rgcn_tpu_torch.device import resolve_device
    from primekg_rgcn_tpu_torch.models.rgcn import init_params
    from primekg_rgcn_tpu_torch.ops.rgcn_final_layer import (
        final_layer_ranges, final_layer_restricted, plan_final_layer)
    from primekg_rgcn_tpu_torch.ops.rgcn_segment import rgcn_layer_segment

    dev = resolve_device(device)
    raw = primekg_like(seed=seed, scale=scale)
    src, dst, rel = bidirect(raw["src"], raw["dst"], raw["rel"])
    graph = build_rel_graph(src, dst, rel, raw["num_nodes"],
                            raw["num_relations"])
    n = graph.num_nodes
    cfg = ModelConfig(num_nodes=n, num_relations=graph.num_relations)
    params = init_params(torch.Generator().manual_seed(seed), cfg,
                         device=dev)
    conv2 = params["encoder"]["conv2"]

    # A representative batch (positives as drawn, negatives uniform), as
    # the negative sampler draws it.
    rng = np.random.default_rng(seed)
    edges = np.stack([src, dst, rel], 1)
    bi = rng.integers(0, len(edges), batch_size)
    h, t = edges[bi, 0], edges[bi, 1]
    coin = rng.random(batch_size) < 0.5
    ent = rng.integers(0, n, batch_size)
    nh = np.where(coin, ent, h)
    nt = np.where(~coin, ent, t)
    nodes = np.concatenate([h, t, nh, nt]).astype(np.int32)
    nodes_u = np.unique(nodes)
    m = len(nodes_u)

    restricted = _extract_restricted(graph, nodes_u)
    e_restr = sum(d["real_edges"] for d in restricted)
    e_static = sum(len(d["src"]) for d in restricted)
    ops = static_ops(restricted, n, m, dev)

    g_dev = graph.to(dev)
    gen = torch.Generator(dev).manual_seed(1)
    h1 = torch.randn(n, cfg.hidden_dim, generator=gen, device=dev)
    nodes_j = torch.from_numpy(nodes).to(dev)
    nodes_u_j = torch.from_numpy(nodes_u).long().to(dev)

    def static_fn(x):
        return static_rows(conv2, x, ops, nodes_u_j)

    def full_fn(x):
        return rgcn_layer_segment(conv2, x, g_dev)[nodes_u_j]

    plan = plan_final_layer(g_dev, edges, batch_size, 1, seed=seed)
    # The batch is fixed, so are its ranges: the flag is read once, here,
    # and the timed layer takes the branch it picked.
    ranges = final_layer_ranges(plan, nodes_j)
    ranges = ranges._replace(fits=bool(ranges.ok))

    def dynamic_fn(x):
        xp = torch.cat([x, x.new_zeros(1, x.shape[1])])
        return final_layer_restricted(conv2, xp, g_dev, plan, nodes_j,
                                      ranges=ranges)

    # Parity gate before timing: the static restricted rows must equal the
    # full layer's rows (the same sums over a restricted enumeration).
    with torch.no_grad():
        np.testing.assert_allclose(static_fn(h1).cpu().numpy(),
                                   full_fn(h1).cpu().numpy(),
                                   rtol=2e-4, atol=2e-4)

    ct = torch.randn(m, cfg.hidden_dim, generator=gen, device=dev)
    ct_b = torch.randn(len(nodes), cfg.hidden_dim, generator=gen,
                       device=dev)

    def timed(fn, cot):
        def body():
            x = h1.detach().requires_grad_(True)
            return torch.autograd.grad(fn(x), x, grad_outputs=cot)[0]

        return replayed_ms(body, steps, dev)

    res = {
        "relations": graph.num_relations,
        "buckets_with_edges": sum(1 for size in graph.bucket_sizes()
                                  if size),
        "graph_edges": int(graph.num_edges),
        "batch_nodes_unique": int(m),
        "restricted_edges": int(e_restr),
        "restricted_edges_padded": int(e_static),
        "edge_ratio": graph.num_edges / max(e_restr, 1),
        "plan_edge_ratio": graph.num_edges / sum(plan.e_cap),
        "dynamic_fits": ranges.fits,
        "full_fwd_bwd_ms": timed(full_fn, ct),
        "static_fwd_bwd_ms": timed(static_fn, ct),
        "dynamic_fwd_bwd_ms": timed(dynamic_fn, ct_b),
        "platform": dev.type,
        "device": device_name(dev),
        "graphed": True,
    }
    res["static_saving_ms"] = res["full_fwd_bwd_ms"] - res["static_fwd_bwd_ms"]
    res["plan_gb_per_epoch"] = plan_gb_per_epoch(restricted, n, m,
                                                 len(edges), batch_size)
    return res


def plan_gb_per_epoch(restricted, n: int, m: int, num_edges: int,
                      batch_size: int) -> float:
    """GiB of device memory if every batch of an epoch kept its static
    restricted layer: what the port's kernel B1 reads, each relation's
    four edge arrays (ids and scales, both orders) and its two CSRs
    (m + 2 and n + 2 int32 offsets)."""
    n_batches = -(-num_edges // batch_size)
    per_batch = sum(sum(d[k].nbytes for k in ("src", "scale", "t_dst_local",
                                              "t_scale"))
                    + (m + 2 + n + 2) * 4 for d in restricted)
    return n_batches * per_batch / 2 ** 30


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    res = run_probe(args.scale, args.batch_size, args.steps,
                    device=args.device)
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
