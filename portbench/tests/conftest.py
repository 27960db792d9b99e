"""Shared fixtures of the benchmark's tests: the ``card`` marker, a
fixture that skips without a CUDA device, and a copy of the benchmark with
tiny cells that run on the CPU in seconds."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
# The benchmark and the port are imported from the checkout's root.
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skipped without one)")


@pytest.fixture(autouse=True)
def _one_thread():
    """One host thread a test: several test workers share the machine, and
    threads that outnumber its cores slow every run to a crawl."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    """Skip the test unless a CUDA device is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; this machine has none")


# Tiny cells: each cell's configuration at a small scale, batch 256, so
# that a run takes seconds on the CPU; "tiny-full.train" forces the
# restricted final layer on, which "auto" leaves off at this scale.
TINY = {
    "tiny.train": ("primekg", 0.08, None, "auto"),
    "tiny-full.train": ("primekg-full", 0.05, 4096, "on"),
}


def make_copy(dest: Path, limits_from: str = "primekg.train") -> Path:
    """``BENCHMARK.json`` and ``portbench/`` copied under ``dest``, with the
    tiny cells added as files and entries; limits from ``limits_from``."""
    shutil.copytree(PKG, dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    limits = json.loads((PKG / "limits" / f"{limits_from}.json").read_text())
    for cell, (base, scale, epoch, restrict) in TINY.items():
        name = cell.split(".")[0]
        cfg = json.loads((PKG / "configs" / f"{base}.json").read_text())
        cfg["graph"]["scale"] = scale
        cfg["epoch_edges"] = epoch
        (dest / "portbench" / "configs" / f"{name}.json").write_text(
            json.dumps(cfg))
        (dest / "portbench" / "traffic" / f"{name}-b256.json").write_text(
            json.dumps({"driver": "full_graph", "batch_size": 256,
                        "restrict_final": restrict}))
        (dest / "portbench" / "limits" / f"{cell}.json").write_text(
            json.dumps(limits))
        bench["workloads"].append({"name": cell, "config": name,
                                   "traffic": f"{name}-b256", "chips": 1,
                                   "why": "a tiny cell for the CPU tests"})
    for m in bench["per_layer"]:
        m["workloads"] = m.get("workloads", []) + list(TINY)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture
def tiny(tmp_path) -> Path:
    return make_copy(tmp_path)


def _run_portbench(where: Path, *args: str, module: str = "portbench",
                   timeout: float = 240) -> subprocess.CompletedProcess:
    """``python -m <module> <args>`` from ``where``, with the port on the
    path."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=where,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def _last_line(proc: subprocess.CompletedProcess) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture
def run_portbench():
    """``run_portbench(where, *args, module="portbench")``: a run as a
    child process, returning the ``CompletedProcess``."""
    return _run_portbench


@pytest.fixture
def last_line():
    """``last_line(proc)``: the JSON of a run's last line of output, after
    checking that it exited 0."""
    return _last_line


@pytest.fixture
def copy_with_tiny():
    """``copy_with_tiny(dest, limits_from=...)``: see :func:`make_copy`."""
    return make_copy
