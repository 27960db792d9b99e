"""The port's bench modules (``primekg_rgcn_tpu_torch/bench/``) on the CPU,
against the JAX package's ``primekg_rgcn_tpu/bench/`` at small sizes.

- ``scaling.comms_bytes_model``: the JAX dict, key for key and int for
  int, at 1, 2, 4 and 8 shards on a PrimeKG-shaped graph and on a
  50-relation R-MAT graph.
- ``restricted_probe``: ``_extract_restricted``'s arrays equal to the JAX
  ones; the static restricted layer's rows and input gradient against the
  JAX full layer (``rgcn_layer_segment``) on shared parameters, rtol 2e-4
  and atol 2e-5 of the largest magnitude (``tests/test_torch_parity.py``).
- ``config3_probe``: ``restricted_e_cap`` equal to the JAX
  ``resolve_final_plan``'s; the derived fields from given component times
  by the JAX formulas.
- ``roofline.b1_bound`` equal to ``chip_smoke.bound`` on the same call.
- every suite function at a tiny size, returning the JAX row's keys; the
  refused rows; ``main`` exiting 1 on a failing row, its report written,
  and writing ``bench_report_torch.json`` by default, never the JAX
  package's ``bench_report.json``.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.bench import restricted_probe as jrp
from primekg_rgcn_tpu.bench import scaling as jscaling
from primekg_rgcn_tpu.config import ModelConfig as JModelConfig
from primekg_rgcn_tpu.data.graph import build_rel_graph as j_build
from primekg_rgcn_tpu.models import rgcn as jmodel
from primekg_rgcn_tpu.ops.rgcn_final_layer import \
    resolve_final_plan as j_resolve_plan
from primekg_rgcn_tpu.ops.rgcn_segment import \
    rgcn_layer_segment as j_layer
from primekg_rgcn_tpu_torch.bench import config3_probe, restricted_probe
from primekg_rgcn_tpu_torch.bench import roofline, scaling, suite
from primekg_rgcn_tpu_torch.config import ModelConfig
from primekg_rgcn_tpu_torch.data import synthetic as psyn
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph as p_build
from primekg_rgcn_tpu_torch.train.torch_interop import params_from_jax

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Small torch ops under several test workers: keep torch's pool
    small, as the other port test files that run many small ops do."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _primekg(scale=0.05):
    raw = psyn.primekg_like(seed=0, scale=scale)
    src, dst, rel = psyn.bidirect(raw["src"], raw["dst"], raw["rel"])
    return src, dst, rel, raw["num_nodes"], 3


def _rmat():
    g = psyn.rmat(4000, 40000, 50, seed=0)
    return g["src"], g["dst"], g["rel"], 4000, 50


GRAPHS = {"primekg_like": _primekg, "rmat50": _rmat}


@pytest.fixture(scope="module")
def graphs():
    out = {}
    for name, make in GRAPHS.items():
        src, dst, rel, n, r = make()
        out[name] = (p_build(src, dst, rel, n, r), j_build(src, dst, rel,
                                                           n, r),
                     np.stack([src, dst, rel], 1))
    return out


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_comms_bytes_model_equals_jax(graphs, name, n):
    pg, jg, _ = graphs[name]
    kw = dict(num_nodes=pg.num_nodes, num_relations=pg.num_relations)
    ours = scaling.comms_bytes_model(pg, ModelConfig(**kw), n,
                                     batch_size=1024)
    theirs = jscaling.comms_bytes_model(jg, JModelConfig(**kw), n,
                                        batch_size=1024)
    assert json.dumps(ours, sort_keys=True) == json.dumps(theirs,
                                                          sort_keys=True)
    if n > 1:
        assert ours["node_shard"]["halo_width"] > 0
        assert ours["sampled_zero3"]["frontier_cap"] > 0


def test_comms_bytes_model_takes_the_callers_partition(graphs):
    from primekg_rgcn_tpu_torch.parallel.node_shard import partition_nodes

    pg, _, _ = graphs["primekg_like"]
    cfg = ModelConfig(num_nodes=pg.num_nodes, num_relations=3)
    sg = partition_nodes(pg, 4)
    assert scaling.comms_bytes_model(pg, cfg, 4, sg=sg) == \
        scaling.comms_bytes_model(pg, cfg, 4)
    with pytest.raises(ValueError, match="partition over 4"):
        scaling.comms_bytes_model(pg, cfg, 2, sg=sg)


def _batch_nodes(edges, n, batch_size=256, seed=0):
    rng = np.random.default_rng(seed)
    bi = rng.integers(0, len(edges), batch_size)
    h, t = edges[bi, 0], edges[bi, 1]
    coin = rng.random(batch_size) < 0.5
    ent = rng.integers(0, n, batch_size)
    return np.unique(np.concatenate([h, t, np.where(coin, ent, h),
                                     np.where(~coin, ent, t)]))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_extract_restricted_equals_jax(graphs, name):
    pg, jg, edges = graphs[name]
    nodes_u = _batch_nodes(edges, pg.num_nodes)
    ours = restricted_probe._extract_restricted(pg, nodes_u)
    theirs = jrp._extract_restricted(jg, nodes_u)
    assert len(ours) == len(theirs) == pg.num_relations
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        assert a["real_edges"] == b["real_edges"]
        for k in ("src", "dst_local", "scale", "t_src", "t_dst_local",
                  "t_scale"):
            assert a[k].dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
    assert sum(d["real_edges"] for d in ours) > 0


@pytest.mark.parametrize("name", list(GRAPHS))
def test_static_restricted_layer_matches_the_jax_full_layer(graphs, name):
    """Rows and the input's gradient of the static layer (kernel B1's plain
    version over the restricted CSRs) against the JAX full layer's rows
    at the batch nodes, on the same parameters and input."""
    pg, jg, edges = graphs[name]
    n = pg.num_nodes
    nodes_u = _batch_nodes(edges, n)
    jcfg = JModelConfig(num_nodes=n, num_relations=pg.num_relations)
    jp = jmodel.init_params(jax.random.PRNGKey(3), jcfg)
    conv2_j = jp["encoder"]["conv2"]
    conv2 = params_from_jax(jp)["encoder"]["conv2"]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, 128)).astype(np.float32)
    ct = rng.normal(size=(len(nodes_u), 128)).astype(np.float32)

    want, vjp = jax.vjp(lambda v: j_layer(conv2_j, v, jg)[nodes_u],
                        jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(ct))

    ops = restricted_probe.static_ops(
        restricted_probe._extract_restricted(pg, nodes_u), n,
        len(nodes_u), "cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    got = restricted_probe.static_rows(conv2, xt, ops,
                                       torch.from_numpy(nodes_u).long())
    (got_g,) = torch.autograd.grad(got, xt, torch.from_numpy(ct))
    for ours, theirs in ((got, want), (got_g, want_g)):
        theirs = np.asarray(theirs)
        top = max(float(np.abs(theirs).max()), 1e-30)
        np.testing.assert_allclose(ours.detach().numpy(), theirs, rtol=2e-4,
                                   atol=2e-5 * top)


def test_config3_probe_e_cap_equals_the_jax_plan():
    """At scale 0.1 and batch 16 the "auto" plan is on (edges over 6x its
    capacity), so its capacity is a real number to compare."""
    res = config3_probe.run_probe(scale=0.1, batch_size=16, steps=1,
                                  device="cpu")
    raw = psyn.primekg_full_like(seed=0, scale=0.1)
    src, dst, rel = psyn.bidirect(raw["src"], raw["dst"], raw["rel"])
    jg = j_build(src, dst, rel, raw["num_nodes"], raw["num_relations"])
    plan = j_resolve_plan(jg, np.stack([src, dst, rel], 1).astype(np.int32),
                          16, 1, seed=42, mode="auto")
    assert plan is not None
    assert res["restricted_e_cap"] == int(sum(plan.e_cap))
    assert (res["nodes"], res["relations"], res["edges"]) == (
        raw["num_nodes"], raw["num_relations"], len(src))
    assert res["floor_ms"] == pytest.approx(
        res["conv1_gather_floor_ms"] + res["conv2_gather_floor_ms"])
    assert res["device"] == "cpu" and res["graphed"] is True


def test_config3_probe_derived_fields_follow_the_jax_formulas():
    times = {"step_auto_ms": 19.5, "step_full_ms": 39.25,
             "conv1_fwd_bwd_ms": 6.0, "conv2_fwd_bwd_ms": 24.0}
    res = config3_probe.derive(dict(times))
    saving = times["step_full_ms"] - times["step_auto_ms"]
    share = times["conv2_fwd_bwd_ms"] - saving
    assert res["restrict_saving_ms"] == saving == 19.75
    assert res["conv2_auto_share_ms"] == share == 4.25
    assert res["dense_residual_ms"] == (times["step_auto_ms"]
                                        - times["conv1_fwd_bwd_ms"] - share)


def test_b1_bound_equals_chip_smoke_bound():
    import chip_smoke

    rng = np.random.default_rng(0)
    n, e, d, s = 300, 2000, 64, 301
    x = torch.zeros(n + 1, d)
    src = torch.zeros(e, dtype=torch.int32)
    rowptr = torch.zeros(s + 1, dtype=torch.int32)
    scale = torch.from_numpy(rng.random(e).astype(np.float32))
    for sc, el in ((None, 4), (scale, 4), (None, 2)):
        xx = x.to(torch.bfloat16) if el == 2 else x
        want = chip_smoke.bound(xx, src, rowptr, sc, s)
        got = roofline.b1_bound(n + 1, d, e, s, table_bytes=el,
                                scaled=sc is not None)
        assert got["bytes"] == want["bytes"]
        assert got["byte_ms"] == pytest.approx(want["byte_ms"])
        assert got["op_ms"] == pytest.approx(want["op_ms"])
        assert got["bound_ms"] == max(got["byte_ms"], got["op_ms"])


def test_step_floor_counts_each_bucket_both_ways(graphs):
    pg, _, _ = graphs["rmat50"]
    cfg = ModelConfig(num_nodes=pg.num_nodes, num_relations=50)
    want = sum(2 * roofline.b1_bound(pg.num_nodes + 1, d, size,
                                     pg.num_nodes + 1,
                                     scaled=pg.norm_mode == "edge")
               ["bound_ms"] for d in (64, 128)
               for size in pg.bucket_sizes() if size)
    assert roofline.step_aggregation_floor_ms(pg, cfg) == pytest.approx(want)
    bf16 = ModelConfig(num_nodes=pg.num_nodes, num_relations=50,
                       compute_dtype="bfloat16")
    assert roofline.step_aggregation_floor_ms(pg, bf16) < want


# The JAX rows' keys (primekg_rgcn_tpu/bench/suite.py).
FULL_KEYS = {"step_ms", "edges_per_s", "vs_baseline", "floor_ms",
             "floor_fraction"}
SUITE_CASES = {
    "primekg-bases": (lambda: suite.bench_full_batch(
        num_bases=2, scale=0.02, n_steps=1, device="cpu"), FULL_KEYS),
    "primekg-bf16": (lambda: suite.bench_full_batch(
        compute_dtype="bfloat16", scale=0.02, n_steps=1, device="cpu"),
        FULL_KEYS),
    "rmat-large": (lambda: suite.bench_rmat(3000, 20000, 10, n_steps=1,
                                            device="cpu"),
                   FULL_KEYS | {"nodes", "edges",
                                "graph_edges_per_s_fwd_bwd"}),
    "primekg-full": (lambda: suite.bench_primekg_full(
        scale=0.02, n_steps=1, device="cpu"),
        FULL_KEYS | {"nodes", "relations", "edges"}),
    "eval-ranking": (lambda: suite.bench_eval_ranking(
        n=400, b=32, n_steps=1, device="cpu"),
        {"batch_ms", "step_ms", "triples_per_s", "entities", "floor_ms",
         "floor_fraction"}),
    "sharded-1dev-pallas": (lambda: suite.bench_sharded_step(
        "pallas", scale=0.02, n_steps=1, device="cpu"),
        {"step_ms", "edges_per_s", "vs_baseline", "agg", "mesh"}),
    "sampled-15-10": (lambda: suite.bench_sampled(
        (15, 10), scale=0.02, n_steps=1, device="cpu"),
        {"step_ms", "edges_per_s", "vs_baseline"}),
    "sampled-full-cache-15-10": (lambda: suite.bench_sampled(
        (15, 10), "primekg-full", cache=True, scale=0.02, n_steps=1,
        device="cpu"), {"step_ms", "edges_per_s", "vs_baseline"}),
    "sampled-10m-block4-8-5": (lambda: suite.bench_sampled(
        (8, 5), "rmat-10m", mode="block4", ident_fraction=0.3,
        size=(3000, 30000, 50), n_steps=1, device="cpu"),
        {"step_ms", "edges_per_s", "vs_baseline"}),
    "ident-crossover": (lambda: suite.bench_ident_sweep(
        batches=(32, 16), n_steps=1, size=(3000, 30000, 50),
        device="cpu"),
        {"step_ms", "edges_per_s", "crossover_fraction",
         "ident_wins_everywhere", "points"}),
}
GRAPHED = {"eval-ranking": False, "sharded-1dev-pallas": False}


@pytest.mark.parametrize("row", list(SUITE_CASES))
def test_suite_rows_return_the_jax_keys(row, monkeypatch):
    monkeypatch.delenv("PRIMEKG_IDENT_FRACTION", raising=False)
    run, keys = SUITE_CASES[row]
    res = run()
    assert keys <= set(res), keys - set(res)
    assert res["graphed"] is GRAPHED.get(row, True)
    assert np.isfinite(res["step_ms"]) and res["step_ms"] > 0
    if "floor_ms" in res:
        assert res["floor_ms"] > 0 and "H100" in res["floor_of"]
        assert res["floor_fraction"] == pytest.approx(
            res["floor_ms"] / res["step_ms"])
    # The row's identity threshold does not leak into the next row.
    import os
    assert "PRIMEKG_IDENT_FRACTION" not in os.environ


@pytest.mark.parametrize("n,b,bound_by", [(400, 32, "bytes"),
                                           (30926, 1024, "operations")])
def test_eval_ranking_floor_is_the_larger_of_bytes_and_operations(
        n, b, bound_by):
    """The row's own size (the second case) is bound by the score GEMM."""
    d = 128
    res = suite.bench_eval_ranking(n=n, b=b, d=d, n_steps=1, device="cpu")
    hbm = (2 * b * n + n * d + b * d) * 4 / roofline.HBM_BYTES_PER_S * 1e3
    ops = 2 * b * n * d / roofline.F32_FLOPS * 1e3
    assert res["hbm_floor_ms"] == pytest.approx(hbm)
    assert res["op_floor_ms"] == pytest.approx(ops)
    assert res["floor_ms"] == max(hbm, ops)
    assert res["floor_ms"] == (hbm if bound_by == "bytes" else ops)
    assert "67e12" in res["floor_of"] and "3.35e12" in res["floor_of"]


class _Graphs:
    """The counters ``timed_epoch`` reads of a ``StepGraphs``."""
    warmups = captures = 0


@pytest.mark.parametrize("new_graph_in", [[], [1], [1, 2], [1, 2, 3]])
def test_timed_epoch_times_an_epoch_of_replays_alone(new_graph_in,
                                                     monkeypatch):
    """An epoch that warms up or captures a graph (here, epochs
    ``new_graph_in``, counted from 0 for the warm one) is timed again;
    the fallbacks returned are the timed epoch's."""
    from primekg_rgcn_tpu_torch.ops import rgcn_final_layer as pfl

    monkeypatch.setattr(pfl.final_layer_restricted, "fallbacks", 0)
    graphs, epochs = _Graphs(), []

    def epoch():
        i = len(epochs)
        epochs.append(i)
        if i in new_graph_in:
            graphs.warmups += 1
        pfl.final_layer_restricted.fallbacks += i

    dt, fallbacks = suite.timed_epoch(epoch, 4, graphs)
    assert dt >= 0
    assert len(epochs) == len(new_graph_in) + 2
    assert fallbacks == len(epochs) - 1
    with pytest.raises(RuntimeError, match="every one of 10"):
        suite.timed_epoch(lambda: setattr(graphs, "captures",
                                          graphs.captures + 1), 4, graphs)


def test_scaling_rows_count_their_steps_and_launches():
    res = scaling.measure_sim_mesh(scale=0.01, device_counts=(1, 2),
                                   batch_size=64, n_steps=2, device="cpu")
    for rows in res["layouts"].values():
        for row in rows.values():
            assert row["steps"] == 3
            assert row["launches"] == {"B1": 0, "B2": 0, "B3": 0, "B4": 0}
    graph, edges, cfg = scaling.sim_graph(0.01)
    assert res["graph"]["edges"] == graph.num_edges == len(edges)
    assert cfg.num_relations == graph.num_relations == 3


def test_the_suite_has_every_jax_row_but_the_refused():
    from primekg_rgcn_tpu.bench import suite as jsuite

    assert set(suite.CONFIGS) | set(suite.REFUSED) == set(jsuite.CONFIGS)
    assert not set(suite.CONFIGS) & set(suite.REFUSED)
    assert list(suite.CONFIGS) == [k for k in jsuite.CONFIGS
                                   if k not in suite.REFUSED]


@pytest.mark.parametrize("row", sorted(suite.REFUSED))
def test_refused_rows_fail_with_their_reason(row, tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        suite.main(["--configs", row, "--out", str(tmp_path / "r.json"),
                    "--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert row in err and "one route" in err
    assert not (tmp_path / "r.json").exists()


def test_the_refused_implementations_raise():
    with pytest.raises(ValueError, match="one route"):
        suite.bench_full_batch(impl="xla", device="cpu")
    with pytest.raises(ValueError, match="one route"):
        suite.bench_sampled(window_impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="one route"):
        suite.bench_sharded_step("xla", device="cpu")


def test_main_records_a_failing_row_and_exits_1(tmp_path, monkeypatch):
    def bad(**kw):
        raise RuntimeError("row broke")

    monkeypatch.setattr(suite, "CONFIGS", {
        "ok": lambda device: {"step_ms": 1.0, "device_arg": device},
        "bad": bad})
    out = tmp_path / "r.json"
    with pytest.raises(SystemExit) as exc:
        suite.main(["--out", str(out), "--device", "cpu"])
    assert exc.value.code == 1
    report = json.loads(out.read_text())
    assert report["device"] == "cpu"
    assert report["results"]["ok"]["device_arg"] == "cpu"
    assert report["results"]["bad"]["error"] == "RuntimeError: row broke"


def test_main_writes_the_ports_report_by_default(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(suite, "CONFIGS", {
        "ok": lambda device: {"step_ms": 2.0},
        "two": lambda device: {"step_ms": 3.0}})
    report = suite.main(["--device", "cpu", "--configs", "ok"])
    assert (tmp_path / "bench_report_torch.json").exists()
    assert not (tmp_path / "bench_report.json").exists()
    assert report["results"]["ok"]["step_ms"] == 2.0
    # A partial run merges into the report it finds.
    suite.main(["--device", "cpu", "--configs", "two"])
    merged = json.loads((tmp_path / "bench_report_torch.json").read_text())
    assert set(merged["results"]) == {"ok", "two"}
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "bench_report_torch.json" in ignored


def test_probe_and_scaling_mains_write_their_rows(tmp_path):
    out = tmp_path / "r.json"
    res = config3_probe.main(["--scale", "0.02", "--steps", "1", "--device",
                              "cpu", "--out", str(out)])
    assert res["floor_fraction"] > 0
    scal = scaling.main(["--scale", "0.01", "--batch_size", "64",
                         "--steps", "1", "--device", "cpu", "--out",
                         str(out)])
    assert set(scal["layouts"]) == {"edge", "node", "sampled-dp",
                                    "sampled-zero1", "sampled-zero3"}
    assert set(scal["layouts"]["edge"]) == {"1", "2", "4", "8"}
    assert set(scal["layouts"]["sampled-dp"]) == {"2", "4", "8"}
    assert scal["disclaimer"] == scaling.DISCLAIMER
    assert "one card" in scal["disclaimer"]
    report = json.loads(out.read_text())["results"]
    assert set(report) == {"config3-decomp", "scaling-sim-mesh"}
    rp = restricted_probe.main(["--scale", "0.05", "--batch_size", "128",
                                "--steps", "1", "--device", "cpu"])
    assert rp["restricted_edges"] > 0 and rp["plan_gb_per_epoch"] > 0


def test_bench_entry_points_run_on_the_card_by_default(monkeypatch):
    """Every entry point asks for CUDA unless told otherwise: here, where
    there is no card, that raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        suite.bench_eval_ranking(n=10, b=4, n_steps=1)
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        restricted_probe.run_probe(scale=0.02, steps=1)


def test_chip_smoke_runs_every_suite_row_but_config_5s_and_one_of_those():
    import chip_smoke

    rows = list(chip_smoke.SMOKE_SUITE_ROWS)
    config5 = [r for r in suite.CONFIGS
               if r.startswith("sampled-10m") or r == "ident-crossover"]
    assert set(rows) <= set(suite.CONFIGS)
    assert [r for r in rows if r in config5] == ["sampled-10m-block4-8-5"]
    assert set(rows) | set(config5) == set(suite.CONFIGS)
