"""Finding a cell's files by name, and refusing malformed ones.

A cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root of the
checkout: a configuration and a traffic mix by name. The harness finds:

- ``portbench/configs/<config>.json``: the model, its optimizer, the graph
  maker and scale, the split, the epoch, ``reduced`` and ``assumed``;
- ``portbench/traffic/<traffic>.json``: the traffic's parameters and the
  name of its driver, ``portbench/drivers/<driver>.py``;
- ``portbench/limits/<cell>.json``: the limit of each number compared;
- ``portbench/metrics/<metric>.py``: one reader a per-layer metric.

Adding a configuration, a cell or a metric adds files and entries and edits
no file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
PKG = Path(__file__).resolve().parent


class SpecError(ValueError):
    """A file of the benchmark is missing or malformed."""


def _name(value: Any, what: str) -> str:
    if not isinstance(value, str) or not NAME.match(value):
        raise SpecError(f"{what}: {value!r} is not a name")
    return value


def _json(path: Path) -> Dict:
    if not path.is_file():
        raise SpecError(f"missing {path}")
    try:
        data = json.loads(path.read_text())
    except json.JSONDecodeError as e:
        raise SpecError(f"{path}: {e}") from e
    if not isinstance(data, dict):
        raise SpecError(f"{path}: not a JSON object")
    return data


def _need(data: Dict, keys: Dict[str, type], where: str) -> None:
    for key, kind in keys.items():
        if key not in data:
            raise SpecError(f"{where}: missing key {key!r}")
        value = data[key]
        ok = isinstance(value, (int, float) if kind is float else kind)
        if not ok or (isinstance(value, bool) and kind is not bool):
            raise SpecError(f"{where}: {key!r} is not {kind.__name__}")


def benchmark(root: Path) -> Dict:
    """``BENCHMARK.json`` of the checkout at ``root``."""
    data = _json(root / "BENCHMARK.json")
    for key in ("workloads", "end_to_end", "per_layer"):
        if not isinstance(data.get(key), list):
            raise SpecError(f"BENCHMARK.json: {key!r} is not a list")
    return data


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w.get("name") == name:
            _need(w, {"config": str, "traffic": str, "chips": int}, name)
            _name(w["config"], "config")
            _name(w["traffic"], "traffic")
            return w
    raise SpecError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(entries: List[Dict], cell: str) -> List[Dict]:
    """The metrics of ``entries`` that ``cell`` reports: those without a
    ``workloads`` list, and those whose list names it."""
    return [m for m in entries
            if cell in m.get("workloads", [cell])]


CONFIG_KEYS = {"source": str, "graph": dict, "split": dict, "model": dict,
               "optimizer": dict, "plan_seed": int, "reduced": list,
               "assumed": list}
MODEL_KEYS = {"embedding_dim": int, "hidden_dim": int, "dropout": float,
              "decoder_dropout": float, "compute_dtype": str}
OPTIMIZER_KEYS = {"name": str, "lr": float, "grad_clip": float,
                  "num_neg_samples": int}


def config(name: str) -> Dict:
    """``configs/<name>.json``, checked."""
    where = f"configs/{_name(name, 'config')}.json"
    data = _json(PKG / where)
    _need(data, CONFIG_KEYS, where)
    _need(data["graph"], {"maker": str, "scale": float, "seed": int},
          where + " graph")
    _need(data["split"], {"target_relation": str, "train": float,
                          "val": float, "test": float, "seed": int},
          where + " split")
    _need(data["model"], MODEL_KEYS, where + " model")
    _need(data["optimizer"], OPTIMIZER_KEYS, where + " optimizer")
    epoch = data.get("epoch_edges")
    if epoch is not None and (not isinstance(epoch, int) or epoch <= 0):
        raise SpecError(f"{where}: epoch_edges is not a positive int")
    for key in data["reduced"]:
        _name(key, where + " reduced")
    return data


def traffic(name: str) -> Dict:
    """``traffic/<name>.json``, checked; its driver must exist."""
    where = f"traffic/{_name(name, 'traffic')}.json"
    data = _json(PKG / where)
    _need(data, {"driver": str}, where)
    if not (PKG / "drivers" / f"{_name(data['driver'], 'driver')}.py"
            ).is_file():
        raise SpecError(f"{where}: no driver {data['driver']!r}")
    return data


def limits(cell: str) -> Dict[str, float]:
    """``limits/<cell>.json``: a number's limit by its name."""
    where = f"limits/{_name(cell, 'workload')}.json"
    data = _json(PKG / where)
    out = data.get("limits")
    if not isinstance(out, dict) or not out or not all(
            isinstance(v, (int, float)) and not isinstance(v, bool)
            for v in out.values()):
        raise SpecError(f"{where}: 'limits' is not an object of numbers")
    return {k: float(v) for k, v in out.items()}


def _module(path: Path, label: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str) -> ModuleType:
    mod = _module(PKG / "drivers" / f"{_name(name, 'driver')}.py",
                  f"portbench_driver_{name}")
    if not callable(getattr(mod, "run", None)):
        raise SpecError(f"drivers/{name}.py has no run()")
    return mod


def reader(metric: str) -> ModuleType:
    path = PKG / "metrics" / f"{_name(metric, 'metric')}.py"
    if not path.is_file():
        raise SpecError(f"no reader metrics/{metric}.py")
    mod = _module(path, "portbench_metric_" + metric.replace(".", "_"))
    if not callable(getattr(mod, "read", None)):
        raise SpecError(f"metrics/{metric}.py has no read()")
    return mod
