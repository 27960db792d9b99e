"""Nothing under portbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the port. Top-level names are compared whole,
so ``primekg_rgcn_tpu_torch`` is not ``primekg_rgcn_tpu``."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "primekg_rgcn_tpu"}


def imported(source: str):
    """Top-level names of every module that ``source`` imports."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_anywhere(path):
    assert not set(imported(path.read_text())) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = set(imported(path.read_text()))
    assert "primekg_rgcn_tpu_torch" not in names
    assert "portbench" not in names


def test_whole_name_comparison():
    src = "import primekg_rgcn_tpu_torch.models\nfrom jaxtyping import x\n"
    assert not set(imported(src)) & FORBIDDEN
    assert set(imported("from primekg_rgcn_tpu.ops import y\n")) & FORBIDDEN


def test_run_refuses_a_loaded_jax_module(monkeypatch):
    import sys
    import types

    from portbench import run

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "primekg_rgcn_tpu.ops",
                        types.ModuleType("primekg_rgcn_tpu.ops"))
    assert run.forbidden_modules() == ["primekg_rgcn_tpu"]
