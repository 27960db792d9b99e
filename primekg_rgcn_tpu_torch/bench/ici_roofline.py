"""Link-roofline scaling projection: which layout reaches 80 % edges/s
scaling efficiency at which card count, on H100 links.

The counterpart of ``primekg_rgcn_tpu/bench/ici_roofline.py`` (the name is
kept so that a reader finds it; the links here are the H100's, not a
TPU's interconnect). The repo's machine with a card has one, so scaling
efficiency cannot be measured; what can be given, and checked the day
several cards are at hand, is a roofline projection that combines:

(a) the **measured one-card step time** of each layout, from the rows of
    the port's own report (``bench_report_torch.json``, written by
    ``python -m primekg_rgcn_tpu_torch.bench.suite`` on the card): the
    compute side. A layout whose row is absent (or config 5's zero3
    without the pod-scale row's frontier ladder) is reported as "not
    measured", with no number;
(b) the **analytic per-device bytes a step** from the real partition
    (``bench/scaling.comms_bytes_model``: halo widths from running
    ``partition_nodes`` on the graph, psum payloads from the stacked
    aggregates' shapes; the JAX dict key for key);
(c) the **published per-GPU link rate**, one way (``LINK_ONEWAY``).

The byte model prices the JAX design's native collectives. The port's
zero1 and zero3 build their all-gathers and psum_scatters from one ring
all-reduce of a zero-padded [n, ...] buffer stacked by shard
(``parallel/mesh.py``), which sends 2 (n - 1) / n of the whole buffer
where the native collective sends (n - 1) / n of it, or n times one
slice. So the zero layouts appear twice: ``sampled-zero1`` and
``sampled-zero3`` at the JAX bytes, and ``sampled-zero1-port`` and
``sampled-zero3-port`` at the bytes the port's own collectives send at
one process a card (``port_bytes``). The other layouts' collectives are
all-reduces and all-to-alls in both packages.

The rate rule. The JAX module doubles its one-way rate, because a ring on
a torus axis drives both directions of a link pair. An H100 sits on
NVSwitches (within a host) or on one InfiniBand port (between hosts): it
sends and receives at once, each at the one-way rate, and the byte model
counts what each device sends (a ring all-reduce sends 2 (n - 1) / n of
its payload). So the time of a step's collectives is its bytes over the
one-way rate, with no factor of 2.

Projection model (per layout, per card count n), the JAX module's:
    t_comp(n) = t_1 / n
    t_link(n) = per_device_step_bytes(n) / rate
    t(n)      = max(t_comp, t_link)   (overlapped bound)
    t_serial  = t_comp + t_link       (no-overlap bound)
    efficiency(n) = t_1 / (n * t(n))
A layout MEETS the 80 % target when even the serial bound clears it,
MISSES it when even the overlapped bound cannot, and is BORDERLINE
otherwise.

Run: ``python -m primekg_rgcn_tpu_torch.bench.ici_roofline [--out
bench_report_torch.json] [--rates nvlink ib_ndr]``.
The projection merges its ``ici-roofline`` row into ``--out`` and prints
one markdown table and one verdict line a rate. Graphs are built on the
host with the port's own graph construction (data/graph.build_rel_graph).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence, Union

# Published one-way rate a GPU, bytes/s.
LINK_ONEWAY = {
    # NVLink 4 on the H100 SXM5: 18 links, 900 GB/s in total, 450 GB/s
    # each way (NVIDIA H100 Tensor Core GPU datasheet).
    "nvlink": 450e9,
    # One NDR InfiniBand port a GPU, 400 Gb/s = 50 GB/s each way (NVIDIA
    # ConnectX-7 NDR), for cards on different hosts.
    "ib_ndr": 50e9,
}

TARGET = 0.80
# The table's width in every projected config (ModelConfig's default).
EMB = 64
DEVICE_COUNTS = (2, 4, 8)
NOT_MEASURED = "not measured"


def link_rate(rate: Union[str, float]) -> float:
    """Bytes/s of ``rate``: a number, or a key of ``LINK_ONEWAY``."""
    return float(LINK_ONEWAY[rate] if isinstance(rate, str) else rate)


def project_layout(t1_ms: float, bytes_per_n: Dict[int, int],
                   rate: Union[str, float] = "nvlink") -> Dict[str, Dict]:
    """Roofline projection for one layout from its measured one-card step
    time and analytic per-device bytes at each card count; ``rate`` in
    bytes/s, or a key of ``LINK_ONEWAY``."""
    bw = link_rate(rate)
    out = {}
    for n, nbytes in sorted(bytes_per_n.items()):
        t_comp = t1_ms / n
        t_ici = nbytes / bw * 1e3
        t_over = max(t_comp, t_ici)
        t_serial = t_comp + t_ici
        eff_over = t1_ms / (n * t_over)
        eff_serial = t1_ms / (n * t_serial)
        verdict = ("meets" if eff_serial >= TARGET
                   else "misses" if eff_over < TARGET else "borderline")
        out[str(n)] = {
            "ici_mb": round(nbytes / 2**20, 2),
            "t_comp_ms": round(t_comp, 3),
            "t_ici_ms": round(t_ici, 3),
            "eff_overlapped": round(eff_over, 3),
            "eff_serial": round(eff_serial, 3),
            "verdict_80pct": verdict,
        }
    return out


def _layout_bytes(models: Dict[int, Dict], key: str) -> Dict[int, int]:
    return {n: m[key]["per_device_step_bytes"]
            for n, m in models.items() if key in m}


def port_bytes(models: Dict[int, Dict], emb: int) -> Dict[str, Dict[int, int]]:
    """The zero1 and zero3 bytes a device and step that the port's own
    collectives send at one process a card: zero1's table gather, and
    zero3's frontier ids, rows and row cotangents, each one all-reduce of
    the [n, ...] buffer (``Slices.gather``, ``_gather_blocks``,
    ``ShardedRowFetch``) in place of the JAX byte model's all-gather or
    psum_scatter; ``emb`` the table's width."""
    zero1, zero3 = {}, {}
    for n, m in models.items():
        if "sampled_zero1" in m:
            z1 = m["sampled_zero1"]
            zero1[n] = z1["per_device_step_bytes"] + z1["emb_allgather_bytes"]
        if "sampled_zero3" in m:
            z3 = m["sampled_zero3"]
            frontier = n * z3["frontier_cap"] * (4 + 2 * emb * 4)
            zero3[n] = (z3["per_device_step_bytes"] - frontier
                        + int(2 * (n - 1) / n * frontier))
    return {"sampled-zero1-port": zero1, "sampled-zero3-port": zero3}


def _rel_graph(raw):
    from primekg_rgcn_tpu_torch.data.graph import build_rel_graph
    from primekg_rgcn_tpu_torch.data.synthetic import bidirect

    s, d, r = bidirect(raw["src"], raw["dst"], raw["rel"])
    return build_rel_graph(s, d, r, raw["num_nodes"], raw["num_relations"])


def _models(graph) -> Dict[int, Dict]:
    from primekg_rgcn_tpu_torch.bench.scaling import comms_bytes_model
    from primekg_rgcn_tpu_torch.config import ModelConfig

    cfg = ModelConfig(num_nodes=graph.num_nodes,
                      num_relations=graph.num_relations)
    return {n: comms_bytes_model(graph, cfg, n) for n in DEVICE_COUNTS}


def build_projection(report_path: str = "bench_report_torch.json",
                     rates: Sequence[str] = ("nvlink", "ib_ndr"),
                     full_scale: float = 1.0, scale: float = 1.0) -> Dict:
    """The projection across configs x layouts x rates. ``scale`` sizes
    config 1's graph (``primekg_like``, 1.0 the ``bench.py`` graph),
    ``full_scale`` config 3's (``primekg_full_like``); the t1 of each
    layout is its row's ``step_ms`` in the report at ``report_path``."""
    from primekg_rgcn_tpu_torch.data.synthetic import (primekg_full_like,
                                                       primekg_like)

    try:
        with open(report_path) as f:
            report = json.load(f)
    except (OSError, ValueError):
        report = {}
    measured = report.get("results", {})

    def t1(row: str) -> Optional[float]:
        ms = measured.get(row, {}).get("step_ms")
        return None if ms is None else float(ms)

    configs = {}

    # --- Config 1 (the north-star PrimeKG subgraph: 30,926 nodes / 3 rel)
    g = _rel_graph(primekg_like(seed=0, scale=scale))
    models = _models(g)
    configs["primekg-northstar"] = {
        "graph": {"nodes": int(g.num_nodes), "relations": int(g.num_relations)},
        "t1_source": {"edge": "sharded-1dev-pallas", "node":
                      "sharded-1dev-pallas (same per-device kernels; halo "
                      "replaces the psum)", "sampled": "sampled-15-10"},
        "layouts": {
            "edge": (t1("sharded-1dev-pallas"),
                     _layout_bytes(models, "edge_shard")),
            "node": (t1("sharded-1dev-pallas"),
                     _layout_bytes(models, "node_shard")),
            "sampled-dp": (t1("sampled-15-10"),
                           _layout_bytes(models, "sampled_dp")),
            "sampled-zero1": (t1("sampled-15-10"),
                              _layout_bytes(models, "sampled_zero1")),
            "sampled-zero3": (t1("sampled-15-10"),
                              _layout_bytes(models, "sampled_zero3")),
            **{k: (t1("sampled-15-10"), v) for k, v in port_bytes(
                models, EMB).items()},
        },
    }
    del g, models

    # --- Config 3 (full PrimeKG: 129,375 nodes / 30 rel / 4.6M edges) ---
    g = _rel_graph(primekg_full_like(seed=0, scale=full_scale))
    models = _models(g)
    configs["primekg-full"] = {
        "graph": {"nodes": int(g.num_nodes), "relations": int(g.num_relations),
                  "full_scale": full_scale},
        "t1_source": {"edge/node": "primekg-full (unsharded full-graph "
                      "step, restricted final layer)", "sampled":
                      "sampled-full-15-10"},
        "layouts": {
            "edge": (t1("primekg-full"), _layout_bytes(models, "edge_shard")),
            "node": (t1("primekg-full"), _layout_bytes(models, "node_shard")),
            "sampled-dp": (t1("sampled-full-15-10"),
                           _layout_bytes(models, "sampled_dp")),
            "sampled-zero1": (t1("sampled-full-15-10"),
                              _layout_bytes(models, "sampled_zero1")),
            "sampled-zero3": (t1("sampled-full-15-10"),
                              _layout_bytes(models, "sampled_zero3")),
            **{k: (t1("sampled-full-15-10"), v) for k, v in port_bytes(
                models, EMB).items()},
        },
    }
    del g, models

    # --- Config 5 (R-MAT 10M nodes / 100M edges / 50 rel) ---
    # Only the sampled layouts: a full-batch step does not fit one card
    # at this scale (bench/pod_scale.py). The zero3 frontier ladder comes
    # from the pod-scale zero3 row when present.
    n10, r10, emb = 10_000_000, 50, EMB
    p_emb = n10 * emb * 4
    p_rest = (r10 * emb * 128 + emb * 128 + 128
              + r10 * 128 * 128 + 128 * 128 + 128 + r10 * 128) * 4
    z3 = measured.get("config5-zero3-full", {}).get("zero3_comms_model")
    lay10 = {k: {} for k in ("sampled-dp", "sampled-zero1", "sampled-zero3",
                             "sampled-zero1-port", "sampled-zero3-port")}
    for n in DEVICE_COUNTS:
        ring = 2 * (n - 1) / n
        dp = int(ring * (p_emb + p_rest))
        ag = (n - 1) * (-(-n10 // n)) * emb * 4
        lay10["sampled-dp"][n] = dp
        lay10["sampled-zero1"][n] = int(dp + ag)
        lay10["sampled-zero1-port"][n] = int(dp + 2 * ag)
        if z3:
            # The ids, rows and cotangent terms are all n * cap-sized; the
            # port's all-reduces send 2 (n - 1) / n of them.
            frontier = z3["frontier_cap"] * n * (4 + 2 * emb * 4)
            lay10["sampled-zero3"][n] = int(frontier + ring * p_rest)
            lay10["sampled-zero3-port"][n] = int(ring * frontier
                                                 + ring * p_rest)
    configs["rmat-10m"] = {
        "graph": {"nodes": n10, "relations": r10},
        "t1_source": {"sampled": "sampled-10m-15-10 (the one-card sampled "
                      "step)", "sampled-zero3": "config5-zero3-full "
                      "(its frontier ladder)"},
        "note": "full-batch layouts excluded: the 100M-edge message stream "
                "does not fit one card (bench/pod_scale.py)",
        "layouts": {k: (t1("sampled-10m-15-10"), v)
                    for k, v in lay10.items()},
    }

    projection = {"target_efficiency": TARGET,
                  "link_oneway_bytes_per_s": {r: link_rate(r)
                                              for r in rates},
                  "rate_rule": "a GPU sends and receives at once, each at "
                               "the one-way rate; bytes are what each "
                               "device sends",
                  "bytes_rule": "the JAX design's native collectives; the "
                                "-port layouts: the port's zero1 and zero3 "
                                "all-reduces of [n, ...] buffers",
                  "model": "t(n)=max(t1/n, bytes/bw) overlapped | "
                           "t1/n + bytes/bw serial; eff=t1/(n*t(n))",
                  "measured_on": report.get("device"),
                  "report": str(report_path),
                  "configs": {}}
    for cname, c in configs.items():
        entry = {"graph": c["graph"], "t1_source": c["t1_source"]}
        if "note" in c:
            entry["note"] = c["note"]
        for rate in rates:
            entry[rate] = {
                lname: ({"t1_ms": t1_ms, **project_layout(t1_ms, bb, rate)}
                        if t1_ms is not None and bb else NOT_MEASURED)
                for lname, (t1_ms, bb) in c["layouts"].items()}
        projection["configs"][cname] = entry
    return projection


def verdict_summary(projection: Dict, rate: str = "nvlink") -> Dict[str, str]:
    """Per config: the best measured layout at n = 8 and whether it meets
    the target, the one-line claim that several cards can test."""
    out = {}
    for cname, c in projection["configs"].items():
        best, best_eff, verdict = None, -1.0, "misses"
        for lname, rows in c.get(rate, {}).items():
            if rows == NOT_MEASURED:
                continue
            r8 = rows.get("8")
            if r8 and r8["eff_serial"] > best_eff:
                best, best_eff = lname, r8["eff_serial"]
                verdict = r8["verdict_80pct"]
        out[cname] = (f"{best}: eff(n=8) {best_eff:.2f} serial / "
                      f"{c[rate][best]['8']['eff_overlapped']:.2f} "
                      f"overlapped -> {verdict} 80% target" if best
                      else "no layout" if not c.get(rate)
                      else NOT_MEASURED)
    return out


def to_markdown(projection: Dict, rate: str = "nvlink") -> str:
    lines = [f"| config | layout | n | ICI MB/step/dev | t_comp ms | "
             f"t_ici ms | eff (overlap) | eff (serial) | 80% target |",
             "|---|---|---|---|---|---|---|---|---|"]
    for cname, c in projection["configs"].items():
        for lname, rows in c.get(rate, {}).items():
            if rows == NOT_MEASURED:
                lines.append(f"| {cname} | {lname} | - | {NOT_MEASURED} | "
                             f"| | | | |")
                continue
            for n in map(str, DEVICE_COUNTS):
                r = rows.get(n)
                if not r:
                    continue
                lines.append(
                    f"| {cname} | {lname} | {n} | {r['ici_mb']} | "
                    f"{r['t_comp_ms']} | {r['t_ici_ms']} | "
                    f"{r['eff_overlapped']} | {r['eff_serial']} | "
                    f"{r['verdict_80pct']} |")
    return "\n".join(lines)


def main(argv=None):
    from primekg_rgcn_tpu_torch.bench.scaling import merge_report

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="bench_report_torch.json")
    p.add_argument("--rates", nargs="+", default=list(LINK_ONEWAY),
                   choices=list(LINK_ONEWAY))
    args = p.parse_args(argv)

    proj = build_projection(args.out, rates=tuple(args.rates))
    for rate in args.rates:
        proj.setdefault("summary", {})[rate] = verdict_summary(proj, rate)
        print(f"\n=== {rate} ({link_rate(rate):.3g} B/s one way) ===")
        print(to_markdown(proj, rate))
        print(json.dumps(proj["summary"][rate], indent=1))
    merge_report(args.out, "ici-roofline", proj)
    print(f"merged into {args.out}")
    return proj


if __name__ == "__main__":
    main()
