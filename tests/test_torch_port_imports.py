"""The port stands alone: no module of it, and no line of chip_smoke.py,
imports jax or the JAX package; and no module of it imports pandas,
sklearn or matplotlib when it is imported, so that the port runs where
none of them is installed (matplotlib is imported inside the plotting
functions only)."""

import json
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
    "pandas", "sklearn", "matplotlib"})
print(json.dumps({"modules": len(names), "bad": bad, "absent": absent}))
"""
# An import statement at a module's top level (column 0).
TOP_LEVEL_HOST_ONLY = re.compile(
    r"^(?:import|from)\s+(?:pandas|sklearn|matplotlib)(?![\w])",
    re.MULTILINE)


def test_importing_every_module_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert seen["modules"] >= 15
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
