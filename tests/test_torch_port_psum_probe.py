"""``primekg_rgcn_tpu_torch.bench.psum_probe`` on the CPU: every setting
(one process on a 2-shard mesh, one process through the bring-up, two
gloo processes) and every probe against its closed form, a 3-shard mesh
for the chained form at n > 2, and the printed lines' keys."""

import json

import pytest
import torch

from primekg_rgcn_tpu_torch.bench import psum_probe
from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh

NAMES = ["elementwise", "psum", "psum_chain_11", "all_reduce_12_leaves"]


@pytest.fixture(scope="module")
def rows():
    return {r["setting"]: r for r in psum_probe.run_probe(
        device="cpu", processes=(1, 2), reps=2)}


@pytest.mark.parametrize("setting,world,backend", [
    ("local", 1, None), ("group_1", 1, "gloo"), ("group_2", 2, "gloo")])
def test_every_probe_equals_its_closed_form(rows, setting, world, backend):
    row = rows[setting]
    assert (row["processes"], row["backend"], row["shards"]) == (
        world, backend, 2)
    payloads = [f"dist_all_reduce_{k}" for k in psum_probe.STEP_PAYLOADS]
    names = NAMES + (["dist_all_reduce", *payloads] if backend else [])
    assert list(row["probes"]) == names
    want = psum_probe.closed_forms(2, world)
    for name in names:
        got = row["probes"][name]
        assert got["value"] == got["closed_form"] == want[name], name
        assert got["host_ms"] > 0 and got["device_ms"] is None
    # Each step payload's size beside its time.
    if backend:
        mb = {k: row["probes"][f"dist_all_reduce_{k}"]["mb"]
              for k in psum_probe.STEP_PAYLOADS}
        assert mb["edge_partial_128"] == 2 * mb["edge_partial_64"]
        assert mb["zero3_fetch"] == pytest.approx(4 * 30976 * 64 * 4 / 2**20)
        assert mb["gradient"] == pytest.approx(2078208 * 4 / 2 ** 20)
    # x's 7.6 MB, 2 reps.
    assert row["x_mb"] == pytest.approx(31000 * 64 * 4 / 2 ** 20)
    assert row["reps"] == 2


def test_the_closed_forms_at_three_shards():
    """On a 3-shard mesh in one process the chain is 3^11 / 2^10 x, the
    leaves untouched (no process to sum over)."""
    mesh = make_mesh(3, "cpu")
    x = torch.ones(psum_probe.SHAPE)
    want = psum_probe.closed_forms(3, 1)
    assert want["psum_chain_11"] == 3.0 ** 11 / 2 ** 10
    assert want["all_reduce_12_leaves"] == 800 * 78
    for name, fn in psum_probe.probes(mesh).items():
        out = fn(x)
        assert float(out.reshape(-1)[0]) == want[name], name
        if name != "all_reduce_12_leaves":
            assert out.shape == x.shape
            assert torch.equal(out, torch.full_like(x, want[name]))


def test_the_step_payloads_are_the_bench_graphs():
    """The payloads' widths and counts are those of the bench.py graph
    and ModelConfig's default widths: N nodes, the parameter count."""
    from primekg_rgcn_tpu_torch.config import ModelConfig
    from primekg_rgcn_tpu_torch.data.synthetic import primekg_like
    from primekg_rgcn_tpu_torch.models.rgcn import init_params, param_leaves

    n = primekg_like(seed=0, scale=1.0)["num_nodes"]
    cfg = ModelConfig(num_nodes=n, num_relations=3)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    got = psum_probe.STEP_PAYLOADS
    assert got["edge_partial_64"] == (n, cfg.embedding_dim)
    assert got["edge_partial_128"] == (n, cfg.hidden_dim)
    assert got["gradient"] == (sum(p.numel() for p in param_leaves(params)),)
    # zero3's buffer: every shard's frontier rows, at the table's width,
    # the frontier's cap saturated.
    from primekg_rgcn_tpu_torch.data.sampling import _unique_cap

    assert got["zero3_fetch"] == (4, _unique_cap(10 ** 9, n),
                                  cfg.embedding_dim)


def test_main_prints_one_line_a_setting(capsys):
    rows = psum_probe.main(["--device", "cpu", "--processes", "1",
                            "--reps", "1"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    # No card on the CPU: no card line.
    assert [ln["psum_probe"]["setting"] for ln in lines] == ["local",
                                                             "group_1"]
    for ln, row in zip(lines, rows):
        got = ln["psum_probe"]
        assert got == json.loads(json.dumps(row))
        assert {"setting", "processes", "backend", "shards", "device",
                "x_mb", "reps", "probes"} <= got.keys()
        for probe in got["probes"].values():
            assert {"host_ms", "device_ms", "value",
                    "closed_form"} <= probe.keys()
