"""The port stands alone: no module of it, and no line of chip_smoke.py,
imports jax or the JAX package; and no module of it imports pandas,
sklearn, networkx or matplotlib when it is imported, so that the port runs
where none of them is installed (matplotlib and networkx are imported
inside the plotting functions only). The whole analysis suite runs on the
CPU in a process where none of them, nor plotly, can be imported: the
stand-in for the card's machine."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "primekg_rgcn_tpu_torch"
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|primekg_rgcn_tpu)(?![\w])",
    re.MULTILINE)

_PROBE = r"""
import importlib, json, pkgutil, sys
import primekg_rgcn_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "primekg_rgcn_tpu"))
absent = sorted({m.split(".")[0] for m in sys.modules} & {
    "pandas", "sklearn", "matplotlib", "networkx"})
print(json.dumps({"modules": len(names), "names": names, "bad": bad,
                  "absent": absent}))
"""
# An import statement at a module's top level (column 0).
TOP_LEVEL_HOST_ONLY = re.compile(
    r"^(?:import|from)\s+(?:pandas|sklearn|matplotlib|networkx)(?![\w])",
    re.MULTILINE)


def test_importing_every_module_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert seen["modules"] >= 15
    assert seen["bad"] == []


def test_the_import_walk_covers_the_final_layer_and_the_native_builder():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("ops.rgcn_final_layer", "native", "data.synthetic",
                 "data.graph"):
        assert f"primekg_rgcn_tpu_torch.{name}" in seen["names"]
    assert seen["bad"] == []
    # The C++ builder is the port's own copy, built into the port's
    # _build directory, not the JAX package's.
    binding = (PORT / "native" / "__init__.py").read_text()
    assert (PORT / "native" / "graphbuild.cpp").exists()
    assert "primekg_rgcn_tpu/" not in binding


def test_the_import_walk_covers_the_sharded_layouts():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("parallel.edge_shard", "parallel.node_shard",
                 "parallel.mesh", "train.multichip"):
        assert f"primekg_rgcn_tpu_torch.{name}" in seen["names"]
    assert seen["bad"] == []


def test_the_import_walk_covers_the_step_graphs():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("train.graphs", "train.loop", "train.sampled"):
        assert f"primekg_rgcn_tpu_torch.{name}" in seen["names"]
    assert seen["bad"] == []


def test_no_source_line_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert (REPO / "chip_smoke.py").exists()
    offenders = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
                 for p in files for m in FORBIDDEN.finditer(p.read_text())]
    assert offenders == []


def test_no_module_imports_pandas_sklearn_or_matplotlib_when_imported():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["absent"] == []
    offenders = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
                 for p in sorted(PORT.rglob("*.py"))
                 for m in TOP_LEVEL_HOST_ONLY.finditer(p.read_text())]
    assert offenders == []


_BLOCKED_ANALYSIS = r"""
import json, sys
from pathlib import Path
BLOCKED = ("sklearn", "networkx", "pandas", "matplotlib", "plotly")
for name in BLOCKED:
    sys.modules[name] = None          # import raises ImportError
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from port_analysis_data import build_trained
from primekg_rgcn_tpu_torch.analyze import run_full_analysis

out = Path(sys.argv[3])
model, data = build_trained(out)
run_full_analysis.main([
    "--model_path", str(model), "--data_dir", str(data),
    "--output_dir", str(out / "analysis"), "--device", "cpu",
    "--diseases", "disease name 1", "disease name 4",
    "--explain", "drugname2", "disease name 2"])
print(json.dumps({
    "summary": [ln.split("\t")[:2] for ln in
                (out / "analysis" / "analysis_summary.txt").read_text()
                .splitlines()],
    "pngs": sorted(str(p) for p in (out / "analysis").rglob("*.png")),
    "loaded": sorted(m for m in BLOCKED if sys.modules.get(m) is not None)}))
"""


def test_full_analysis_runs_without_sklearn_networkx_pandas_matplotlib(
        tmp_path):
    # One OpenMP thread: the suite's other workers share the cores.
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_ANALYSIS, str(REPO),
         str(REPO / "tests"), str(tmp_path)], cwd=tmp_path,
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["summary"] == [[name, "OK"] for name in (
        "evaluate", "error_analysis", "case_studies", "embeddings",
        "explanations", "validation", "comparison", "failures")]
    assert out["pngs"] == [] and out["loaded"] == []
    assert "matplotlib is not installed" in (
        tmp_path / "analysis" / "error_analysis.log").read_text()
