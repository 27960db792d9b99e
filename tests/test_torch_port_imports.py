"""The port stands alone: no module of it, and no line of chip_smoke.py,
imports jax, flax, optax, msgpack or the JAX package (a JAX checkpoint
loads, ``torch_interop export`` runs, and the bench modules psum_probe
and ici_roofline import, where none of them can be imported); and no
module of it imports pandas,
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
    r"^\s*(?:import|from)\s+"
    r"(?:jax|jaxlib|flax|optax|msgpack|primekg_rgcn_tpu)(?![\w])",
    re.MULTILINE)

_PROBE = r"""
import importlib, json, pkgutil, sys
import primekg_rgcn_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "msgpack", "primekg_rgcn_tpu"))
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


def test_the_import_walk_covers_the_bench_modules():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("bench.roofline", "bench.suite", "bench.scaling",
                 "bench.pod_scale", "bench.config3_probe",
                 "bench.restricted_probe"):
        assert f"primekg_rgcn_tpu_torch.{name}" in seen["names"]
    assert seen["bad"] == []


_BLOCKED_PROBES = r"""
import json, sys
for name in ("jax", "jaxlib", "flax", "optax", "msgpack",
             "primekg_rgcn_tpu"):
    sys.modules[name] = None          # import raises ImportError
sys.path.insert(0, sys.argv[1])
from primekg_rgcn_tpu_torch.bench import ici_roofline, psum_probe
print(json.dumps({"rate": ici_roofline.link_rate("nvlink"),
                  "forms": psum_probe.closed_forms(2, 2)["psum"],
                  "loaded": sorted(m for m in sys.modules
                                   if m.split(".")[0] in ("jax", "optax")
                                   and sys.modules[m] is not None)}))
"""


def test_psum_probe_and_ici_roofline_import_no_jax():
    """The bench modules ``psum_probe`` and ``ici_roofline``: in the
    import walk, and imported where jax, optax, flax, msgpack and the JAX
    package cannot be."""
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("bench.psum_probe", "bench.ici_roofline"):
        assert f"primekg_rgcn_tpu_torch.{name}" in seen["names"]
    assert seen["bad"] == []
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_PROBES,
                           str(REPO)], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "rate": 450e9, "forms": 2.0, "loaded": []}


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


_BLOCKED_DRILL = r"""
import json, sys
for name in ("jax", "jaxlib", "flax", "optax", "primekg_rgcn_tpu"):
    sys.modules[name] = None          # import raises ImportError
sys.path[:0] = [sys.argv[1]]
script, sys.argv = sys.argv[2], sys.argv[2:]
import runpy
runpy.run_path(script, run_name="__main__")
print(json.dumps(sorted(m for m in sys.modules if m.startswith(
    "primekg_rgcn_tpu_torch.train.multichip"))))
"""


def test_the_process_group_modules_and_the_drill_import_no_jax(tmp_path):
    """The modules of the process-spanning mesh are in the walk; the
    drill script and the test's worker import no JAX (scanned), and the
    drill's solo run completes where no JAX can be imported."""
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("parallel.mesh", "train.multichip", "train.checkpoint",
                 "utils.telemetry"):
        assert f"primekg_rgcn_tpu_torch.{name}" in seen["names"]
    assert seen["bad"] == []
    scripts = [REPO / "scripts" / "port_multihost_drill.py",
               REPO / "tests" / "port_dist_worker.py"]
    offenders = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
                 for p in scripts for m in FORBIDDEN.finditer(p.read_text())]
    assert offenders == []
    drill = subprocess.run(
        [sys.executable, "-c", _BLOCKED_DRILL, str(REPO),
         str(scripts[0]), "solo", "1", str(tmp_path), "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert drill.returncode == 0, drill.stderr[-3000:]
    assert "ckpt=ok" in drill.stdout
    assert json.loads(drill.stdout.strip().splitlines()[-1]) == [
        "primekg_rgcn_tpu_torch.train.multichip"]


_BLOCKED_JAX_CHECKPOINT = r"""
import json, sys
for name in ("jax", "jaxlib", "flax", "optax", "msgpack",
             "primekg_rgcn_tpu"):
    sys.modules[name] = None          # import raises ImportError
sys.path[:0] = [sys.argv[1]]
from primekg_rgcn_tpu_torch.train import checkpoint, torch_interop
payload = checkpoint.load(sys.argv[2] + ".json")
torch_interop.main(["export", sys.argv[2], sys.argv[3]])
print(json.dumps({"epoch": payload["epoch"], "step": payload["step"],
                  "count": int(payload["opt_state"]["1"]["count"]),
                  "loaded": sorted(m for m in ("jax", "flax", "optax",
                                               "msgpack")
                                   if sys.modules.get(m) is not None)}))
"""


def test_a_jax_checkpoint_loads_and_exports_without_jax_or_msgpack(
        tmp_path):
    """The JAX package writes a checkpoint here; a process where jax,
    flax, optax and msgpack cannot be imported loads it and converts it
    with the port's ``torch_interop export``, as the card's machine
    must."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from primekg_rgcn_tpu.config import ModelConfig, TrainConfig
    from primekg_rgcn_tpu.models.rgcn import init_params
    from primekg_rgcn_tpu.train import checkpoint as jckpt
    from primekg_rgcn_tpu.train.loop import TrainState, make_optimizer

    cfg = ModelConfig(num_nodes=40, num_relations=2, embedding_dim=8,
                      hidden_dim=8)
    params = init_params(jax.random.PRNGKey(0), cfg)
    state = TrainState(params, make_optimizer(TrainConfig()).init(params),
                       jnp.asarray(3, jnp.int32))
    jckpt.save(tmp_path / "ckpt", {
        "state": state, "epoch": 2, "model_config": cfg.to_dict(),
        "train_config": TrainConfig().to_dict()})
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_JAX_CHECKPOINT, str(REPO),
         str(tmp_path / "ckpt"), str(tmp_path / "out.pt")], cwd=tmp_path,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "epoch": 2, "step": 3, "count": 0, "loaded": []}
    out = torch.load(tmp_path / "out.pt", weights_only=False)
    assert out["epoch"] == 2
    assert torch.equal(out["model_state_dict"][
        "encoder.node_embeddings.weight"],
        torch.from_numpy(np.array(params["encoder"]["node_emb"])))
