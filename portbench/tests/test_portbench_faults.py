"""The check that decides ``correct`` fails what it must.

The control, the plain reference computed with TF32 matmuls (emulated on
the CPU), and each fault that a one-chip training cell can have, planted
in the program underneath a whole run at a tiny size: a step that leaves
the parameters unchanged, half of the batch left out with the mean taken
over the rest, and an answer altered where it is produced. The run's look
for a card is skipped (``--device cpu``); everything else runs as on the
card. On the card, the control at each cell's own size."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from portbench import check, run, spec

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _unchanged(monkeypatch):
    from primekg_rgcn_tpu_torch.train import loop

    real = loop.apply_update

    def apply_update(optimizer, train_cfg, accum=1):
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.zero_()
        real(optimizer, train_cfg, accum)

    monkeypatch.setattr(loop, "apply_update", apply_update)


def _half(monkeypatch):
    from primekg_rgcn_tpu_torch.train import loop

    real = loop.bce_stats

    def bce_stats(scores, labels, weights):
        n = weights.shape[0]
        keep = (torch.arange(n, device=weights.device) % (n // 2)) < n // 4
        return real(scores, labels, weights * keep)

    monkeypatch.setattr(loop, "bce_stats", bce_stats)


def _answer(monkeypatch):
    from primekg_rgcn_tpu_torch.models import rgcn

    real = rgcn.distmult_score

    def distmult_score(h, t, r):
        out = real(h, t, r)
        return out + (torch.arange(out.shape[0], device=out.device) == 0)

    monkeypatch.setattr(rgcn, "distmult_score", distmult_score)


@pytest.mark.parametrize("cell", ["tiny.train", "tiny-full.train"])
@pytest.mark.parametrize("plant", [_unchanged, _half, _answer],
                         ids=["unchanged", "half", "answer"])
def test_a_planted_fault_reads_not_correct(tmp_path, monkeypatch, capsys,
                                           copy_with_tiny, cell, plant):
    where = copy_with_tiny(tmp_path)
    monkeypatch.setattr(spec, "PKG", where / "portbench")
    plant(monkeypatch)
    assert run.main(["--workload", cell, "--seed", "4242", "--seconds",
                     "0.1", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", ["tiny.train", "tiny-full.train"])
def test_the_control_reads_not_correct(tmp_path, copy_with_tiny,
                                       run_portbench, cell):
    where = copy_with_tiny(tmp_path)
    limits = spec.limits("primekg.train")
    proc = run_portbench(where, "--workload", cell, "--seeds", "8", "9",
                         "--device", "cpu", module="portbench.control")
    assert proc.returncode == 0, proc.stderr[-3000:]
    for text in proc.stdout.strip().splitlines():
        line = json.loads(text)
        assert check.judge(line["program"], limits), line
        assert not check.judge(line["control"], limits), line
        assert not check.judge(line["half"], limits), line
        assert not check.judge(line["answer"], limits), line


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_at_the_cells_size(card, run_portbench, cell):
    proc = run_portbench(ROOT, "--workload", cell, "--seeds", "101", "102",
                         "103", module="portbench.control", timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    limits = spec.limits(cell)
    for text in proc.stdout.strip().splitlines():
        line = json.loads(text)
        assert check.judge(line["program"], limits), line
        assert not check.judge(line["control"], limits), line
