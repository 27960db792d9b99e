"""``primekg_rgcn_tpu_torch.bench.ici_roofline`` against the JAX module:
``project_layout``, ``verdict_summary`` and ``to_markdown`` field for field
and string for string at the JAX module's own rate (taken from it here,
so that no TPU figure is written in the port); the layouts' bytes against
the JAX byte model on a small ``primekg_like`` graph; a report without a
layout's row reads "not measured"; the port's own zero1 and zero3 bytes
beside the JAX ones; the module holds no TPU rate or step time."""

import functools
import json
from pathlib import Path

import numpy as np
import pytest

from primekg_rgcn_tpu.bench import ici_roofline as jroof
from primekg_rgcn_tpu_torch.bench import ici_roofline as proof

REPO = Path(__file__).resolve().parent.parent
# Bytes a device at 2, 4 and 8 cards, and t1 values that give every
# verdict somewhere.
BYTES = {2: 3_000_000, 4: 60_000_000, 8: 900_000_000}
T1 = [0.5, 7.0, 40.0, 516.0]


def jax_rate():
    hw = next(iter(jroof.ICI_RING))
    return hw, jroof.ICI_RING[hw]


@pytest.mark.parametrize("t1", T1)
def test_project_layout_matches_the_jax_function(t1):
    hw, rate = jax_rate()
    assert proof.project_layout(t1, BYTES, rate) == jroof.project_layout(
        t1, BYTES, hw)


def test_verdict_and_markdown_match_the_jax_functions():
    hw, rate = jax_rate()
    configs = {}
    for c, scale in (("a", 1), ("b", 40)):
        layouts = {f"layout-{t1}": {"t1_ms": t1, **jroof.project_layout(
            t1, {n: b * scale for n, b in BYTES.items()}, hw)} for t1 in T1}
        configs[c] = {"graph": {}, hw: layouts}
    proj = {"configs": configs}
    assert proof.verdict_summary(proj, hw) == jroof.verdict_summary(proj,
                                                                    hw)
    assert proof.to_markdown(proj, hw) == jroof.to_markdown(proj, hw)
    # The port's own projection rows, at that rate, read the same.
    ours = {"configs": {c: {"graph": {}, hw: {
        name: {"t1_ms": row["t1_ms"], **proof.project_layout(
            row["t1_ms"], {n: b * s for n, b in BYTES.items()}, rate)}
        for name, row in v[hw].items()}} for (c, v), s in zip(
            configs.items(), (1, 40))}}
    assert proof.to_markdown(ours, hw) == jroof.to_markdown(proj, hw)


def test_layout_bytes_match_the_jax_byte_model():
    from primekg_rgcn_tpu.bench.scaling import comms_bytes_model as j_model
    from primekg_rgcn_tpu.config import ModelConfig as JModelConfig
    from primekg_rgcn_tpu.data.graph import build_rel_graph as j_build
    from primekg_rgcn_tpu_torch.data.synthetic import primekg_like

    raw = primekg_like(seed=0, scale=0.05)
    graph = proof._rel_graph(raw)
    ours = proof._models(graph)
    from primekg_rgcn_tpu_torch.data.synthetic import bidirect

    s, d, r = bidirect(raw["src"], raw["dst"], raw["rel"])
    jg = j_build(s, d, r, raw["num_nodes"], raw["num_relations"])
    jcfg = JModelConfig(num_nodes=jg.num_nodes,
                        num_relations=jg.num_relations)
    theirs = {n: j_model(jg, jcfg, n) for n in jroof.DEVICE_COUNTS}
    for key in ("edge_shard", "node_shard", "sampled_dp", "sampled_zero1",
                "sampled_zero3"):
        assert proof._layout_bytes(ours, key) == jroof._layout_bytes(
            theirs, key), key


def test_the_port_bytes_beside_the_jax_bytes():
    """The port's zero1 gather and zero3 fetch are all-reduces of [n, ...]
    buffers: zero1 sends its table gather twice over, zero3 2 (n - 1) / n
    of the JAX frontier term (the same at 2 cards)."""
    from primekg_rgcn_tpu_torch.data.synthetic import primekg_like

    models = proof._models(proof._rel_graph(primekg_like(seed=0,
                                                         scale=0.05)))
    port = proof.port_bytes(models, proof.EMB)
    for n, m in models.items():
        z1, z3 = m["sampled_zero1"], m["sampled_zero3"]
        assert port["sampled-zero1-port"][n] == (
            z1["per_device_step_bytes"] + z1["emb_allgather_bytes"])
        frontier = n * z3["frontier_cap"] * (4 + 2 * proof.EMB * 4)
        assert port["sampled-zero3-port"][n] - z3["per_device_step_bytes"] \
            == int(2 * (n - 1) / n * frontier) - frontier
    assert port["sampled-zero3-port"][2] == models[2]["sampled_zero3"][
        "per_device_step_bytes"]


def test_a_report_without_a_row_reads_not_measured(tmp_path, capsys,
                                                   monkeypatch):
    out = tmp_path / "report.json"
    out.write_text(json.dumps({"device": "cpu", "results": {
        "sampled-15-10": {"step_ms": 6.0},
        "primekg-full": {"step_ms": 20.0}}}))
    # main at full scale partitions config 3's 4.6M edges: the test runs
    # it on graphs a fiftieth and a hundredth of that size.
    monkeypatch.setattr(proof, "build_projection", functools.partial(
        proof.build_projection, scale=0.02, full_scale=0.01))
    proj = proof.main(["--out", str(out)])
    printed = capsys.readouterr().out
    assert set(proj["link_oneway_bytes_per_s"]) == {"nvlink", "ib_ndr"}
    for rate in ("nvlink", "ib_ndr"):
        north = proj["configs"]["primekg-northstar"][rate]
        # No sharded-1dev-pallas row: the edge and node layouts.
        assert north["edge"] == north["node"] == "not measured"
        assert north["sampled-zero3"]["t1_ms"] == 6.0
        assert north["sampled-zero3-port"]["t1_ms"] == 6.0
        full = proj["configs"]["primekg-full"][rate]
        assert full["node"]["t1_ms"] == 20.0
        assert full["sampled-dp"] == "not measured"
        # No config-5 row: every layout, zero3's without its ladder too.
        assert proj["configs"]["rmat-10m"][rate] == {
            k: "not measured" for k in (
                "sampled-dp", "sampled-zero1", "sampled-zero3",
                "sampled-zero1-port", "sampled-zero3-port")}
        assert proj["summary"][rate]["rmat-10m"] == "not measured"
        assert proj["summary"][rate]["primekg-northstar"].startswith(
            "sampled-")
    assert "| primekg-northstar | edge | - | not measured |" in printed
    merged = json.loads(out.read_text())
    assert merged["results"]["ici-roofline"]["configs"].keys() == proj[
        "configs"].keys()
    assert merged["results"]["sampled-15-10"] == {"step_ms": 6.0}
    assert proj["measured_on"] == "cpu"


def test_the_port_module_holds_no_tpu_rate_or_step_time():
    src = (REPO / "primekg_rgcn_tpu_torch" / "bench" /
           "ici_roofline.py").read_text()
    jsrc = (REPO / "primekg_rgcn_tpu" / "bench" / "ici_roofline.py"
            ).read_text()
    for word in ("v5e", "v5p", "ICI_RING", "ICI_ONEWAY"):
        assert word not in src
    # Every number of the JAX module's fallbacks and rates.
    for figure in ("4.5e10", "9.0e10", "37.05", "50.83", "131.3", "516.28",
                   "4263.29"):
        assert figure in jsrc and figure not in src
    assert proof.link_rate("nvlink") == 450e9
    assert proof.link_rate(1.5e9) == 1.5e9
    assert np.isclose(proof.link_rate("ib_ndr"), 400e9 / 8)
