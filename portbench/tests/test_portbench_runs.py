"""Each traffic driver runs a tiny cell end to end on the CPU and prints one
contract line; the plain reference agrees with the port's path there; a
new configuration, cell and per-layer metric added as files alone run."""

from __future__ import annotations

import json

import pytest

CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
                 "checks"}


@pytest.mark.parametrize("cell", ["tiny.train", "tiny-full.train"])
@pytest.mark.parametrize("traced", [0, 1])
def test_tiny_cell_prints_one_contract_line(tiny, run_portbench, last_line,
                                            cell, traced):
    proc = run_portbench(tiny, "--workload", cell, "--seed",
                         str(2 ** 31 + 17), "--seconds", "1", "--trace",
                         str(traced), "--device", "cpu")
    line = last_line(proc)
    assert CONTRACT_KEYS <= set(line) and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    if traced:
        # Without a device trace only the program's counters read; the
        # fallbacks only where the restricted final layer runs.
        counters = {"graph_captures.train"} | (
            {"fallback_share.train"} if cell == "tiny-full.train" else set())
        assert set(line["metrics"]) == counters
    else:
        assert set(line["metrics"]) == {"train_edges_per_s", "setup_s"}
        assert line["metrics"]["train_edges_per_s"]["value"] > 0
    # The numbers compared close standard error, each beside its limit.
    tail = proc.stderr.strip().splitlines()[-3:]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    assert all("limit" in t for t in tail)


def test_reference_agrees_with_the_port(tiny, run_portbench):
    """The sound program's gaps sit far under the limits at a tiny size."""
    proc = run_portbench(tiny, "--workload",
                         "tiny-full.train", "--seeds", "3", "--device", "cpu",
                         module="portbench.control")
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["program"]["loss_gap"] < 1e-5
    assert line["program"]["grad_gap"] < 1e-4
    assert line["program"]["change_gap"] < 1e-5
    assert set(line["worst"]["program"]) == {"loss_gap", "grad_gap",
                                             "change_gap", "left_out"}


@pytest.mark.parametrize("change", ["drop", "add"])
def test_the_limits_file_names_the_numbers_compared(tmp_path, copy_with_tiny,
                                                    run_portbench, change):
    """A reading without a limit, or a limit without a reading, is refused:
    the run exits 3 and prints no result."""
    where = copy_with_tiny(tmp_path)
    path = where / "portbench" / "limits" / "tiny.train.json"
    data = json.loads(path.read_text())
    if change == "drop":
        del data["limits"]["loss_gap"]
    else:
        data["limits"]["other_gap"] = 1.0
    path.write_text(json.dumps(data))
    proc = run_portbench(where, "--workload", "tiny.train", "--seed", "6",
                         "--seconds", "0.1", "--device", "cpu")
    assert proc.returncode == 3 and proc.stdout == ""
    assert ("loss_gap" if change == "drop" else "other_gap") in proc.stderr


def test_same_seed_same_inputs():
    """Every input a run makes that the configuration does not fix comes
    from ``--seed``: the weights, the epoch's sample, the batch order and
    the device generator's draws, each from a sub-seed of its own."""
    from portbench.run import SUB_SEEDS, sub_seeds

    big = 2 ** 31 + 12345
    assert sub_seeds(big) == sub_seeds(big) != sub_seeds(big + 1)
    assert set(sub_seeds(big)) == set(SUB_SEEDS)
    assert all(0 <= v < 2 ** 32 for v in sub_seeds(big).values())
    assert len(set(sub_seeds(big).values())) == len(SUB_SEEDS)


def test_a_new_config_cell_and_metric_as_files(tmp_path, copy_with_tiny,
                                               run_portbench, last_line):
    """Added as new files and new entries only: nothing that is there is
    edited."""
    where = copy_with_tiny(tmp_path)
    pkg = where / "portbench"
    before = {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()}
    cfg = json.loads((pkg / "configs" / "tiny.json").read_text())
    cfg["graph"]["scale"] = 0.06
    (pkg / "configs" / "newcfg.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "b512.json").write_text(json.dumps(
        {"driver": "full_graph", "batch_size": 512}))
    (pkg / "limits" / "newcfg.b512.json").write_text(
        (pkg / "limits" / "tiny.train.json").read_text())
    (pkg / "metrics" / "epochs_seen.train.py").write_text(
        "def read(layer, trace):\n"
        "    return float(layer['updates_traced'])\n")
    bench = json.loads((where / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "newcfg.b512", "config": "newcfg",
                               "traffic": "b512", "chips": 1, "why": "new"})
    bench["per_layer"].append({
        "name": "epochs_seen.train", "unit": "count", "better": "higher",
        "source": "program_counter", "layer": "step graphs",
        "moves": "train_edges_per_s", "workloads": ["newcfg.b512"]})
    (where / "BENCHMARK.json").write_text(json.dumps(bench))
    line = last_line(run_portbench(where, "--workload", "newcfg.b512",
                                   "--seed", "5", "--seconds", "0.1",
                                   "--trace", "1", "--device", "cpu"))
    assert line["correct"] is True
    assert line["metrics"]["epochs_seen.train"]["value"] > 0
    assert all(p.read_bytes() == data for p, data in before.items())
