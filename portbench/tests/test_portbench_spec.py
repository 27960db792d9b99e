"""Every configuration, traffic mix, cell and metric of BENCHMARK.json loads
by name; a malformed file is refused."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load(cell):
    w = spec.workload(BENCH, cell)
    cfg = spec.config(w["config"])
    assert cfg["model"]["hidden_dim"] == 128
    tr = spec.traffic(w["traffic"])
    assert callable(spec.driver(tr["driver"]).run)
    assert set(spec.limits(cell)) == {"loss_gap", "grad_gap", "change_gap"}
    for m in spec.metrics_of(BENCH["per_layer"], cell):
        assert callable(spec.reader(m["name"]).read)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry_matches_its_file(entry):
    path = ROOT / entry["file"]
    assert path.parent == spec.PKG / "configs"
    data = spec.config(path.stem)
    assert data["reduced"] == entry["reduced"]
    assert data["source"] == entry["source"]


def test_each_metric_lists_known_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


def _broken(tmp_path, monkeypatch, rel: str, text: str):
    pkg = tmp_path / "portbench"
    for sub in ("configs", "traffic", "limits", "drivers", "metrics"):
        (pkg / sub).mkdir(parents=True)
    (pkg / rel).write_text(text)
    monkeypatch.setattr(spec, "PKG", pkg)


@pytest.mark.parametrize("rel,text,load", [
    ("configs/x.json", "{not json", lambda: spec.config("x")),
    ("configs/x.json", json.dumps({"source": "s"}), lambda: spec.config("x")),
    ("configs/x.json", json.dumps({
        "source": "s", "graph": {"maker": "m", "scale": "big"},
        "split": {}, "model": {}, "optimizer": {}, "reduced": [],
        "assumed": []}), lambda: spec.config("x")),
    ("traffic/x.json", json.dumps({"batch_size": 8}),
     lambda: spec.traffic("x")),
    ("traffic/x.json", json.dumps({"driver": "nowhere"}),
     lambda: spec.traffic("x")),
    ("limits/x.json", json.dumps({"limits": {"loss_gap": "small"}}),
     lambda: spec.limits("x")),
    ("metrics/x.py", "def other(): pass\n", lambda: spec.reader("x")),
    ("drivers/x.py", "value = 1\n", lambda: spec.driver("x")),
])
def test_malformed_file_is_refused(tmp_path, monkeypatch, rel, text, load):
    _broken(tmp_path, monkeypatch, rel, text)
    with pytest.raises(spec.SpecError):
        load()


@pytest.mark.parametrize("name", ["", "a b", "a/b", "x" * 65, ".hidden"])
def test_bad_names_are_refused(name):
    with pytest.raises(spec.SpecError):
        spec.config(name)


def test_unknown_workload_exits_2_without_a_result(tmp_path, copy_with_tiny,
                                                   run_portbench):
    where = copy_with_tiny(tmp_path)
    proc = run_portbench(where, "--workload", "nowhere.train", "--seed", "1",
                         "--seconds", "1", "--device", "cpu")
    assert proc.returncode == 2 and proc.stdout == ""


def test_without_a_card_exits_2_without_a_result(tmp_path, copy_with_tiny,
                                                 run_portbench):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    where = copy_with_tiny(tmp_path)
    proc = run_portbench(where, "--workload", "tiny.train", "--seed", "1",
                         "--seconds", "1")
    assert proc.returncode == 2 and proc.stdout == ""
