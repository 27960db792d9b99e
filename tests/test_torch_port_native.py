"""The port's C++ graph builder (``primekg_rgcn_tpu_torch/native``) against
its numpy path and against the JAX package's ``build_rel_graph`` in both of
its ``use_native`` modes: every array bit for bit, the CSR row pointers
included, on ``primekg_like`` and ``primekg_full_like`` graphs in both norms
and on edges with out-of-range ids; the ``use_native`` modes; and a clean
error from ``"always"`` when no compiler is found. The tests need ``g++``
and skip without it.
"""

import shutil

import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.data import graph as jgraph
from primekg_rgcn_tpu_torch import native
from primekg_rgcn_tpu_torch.data import graph as pgraph
from primekg_rgcn_tpu_torch.data import synthetic as psyn

ARRAYS = ("src", "dst", "t_src", "t_dst", "inv_in_deg", "edge_scale",
          "t_edge_scale")


@pytest.fixture
def gxx():
    if shutil.which(native.COMPILER) is None:
        pytest.skip(f"no C++ compiler {native.COMPILER!r} on this machine")
    assert native.native_available()


def _graph_edges(kind):
    if kind == "primekg_like":
        raw = psyn.primekg_like(seed=1, scale=0.05)
    else:
        raw = psyn.primekg_full_like(seed=1, scale=0.05)
    src, dst, rel = psyn.bidirect(raw["src"], raw["dst"], raw["rel"])
    return src, dst, rel, raw["num_nodes"], raw["num_relations"]


def _assert_equal(a, b):
    for name in (*ARRAYS, "rowptr", "t_rowptr"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(x, y), name
    assert a.rel_offsets == b.rel_offsets
    assert (a.num_nodes, a.num_relations, a.num_edges, a.norm_mode) == (
        b.num_nodes, b.num_relations, b.num_edges, b.norm_mode)


def _assert_equal_jax(jg, pg):
    for name in ARRAYS:
        x, y = np.asarray(getattr(jg, name)), getattr(pg, name).numpy()
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert jg.rel_offsets == pg.rel_offsets
    assert (jg.num_nodes, jg.num_relations, jg.num_edges) == (
        pg.num_nodes, pg.num_relations, pg.num_edges)


@pytest.mark.parametrize("kind", ["primekg_like", "primekg_full_like"])
@pytest.mark.parametrize("norm", ["dense", "edge"])
def test_native_equals_numpy_and_jax(kind, norm, gxx):
    src, dst, rel, n, r = _graph_edges(kind)
    built = {mode: pgraph.build_rel_graph(src, dst, rel, n, r, norm=norm,
                                          use_native=mode)
             for mode in ("always", "never")}
    _assert_equal(built["always"], built["never"])
    assert built["always"].norm_mode == norm
    for mode in ("always", "never"):
        jg = jgraph.build_rel_graph(src, dst, rel, n, r, norm=norm,
                                    use_native=mode)
        _assert_equal_jax(jg, built["always"])


@pytest.mark.parametrize("pad", [16, 512])
def test_native_drops_invalid_edges_as_numpy_does(pad, gxx):
    rng = np.random.default_rng(pad)
    n, r, e = 80, 5, 3000
    src = rng.integers(-3, n + 3, e)
    dst = rng.integers(-1, n + 1, e)
    rel = rng.integers(-1, r + 1, e)
    a = pgraph.build_rel_graph(src, dst, rel, n, r, bucket_pad_multiple=pad,
                               use_native="always")
    b = pgraph.build_rel_graph(src, dst, rel, n, r, bucket_pad_multiple=pad,
                               use_native="never")
    _assert_equal(a, b)
    valid = ((src >= 0) & (src < n) & (dst >= 0) & (dst < n) & (rel >= 0)
             & (rel < r))
    assert a.num_edges == int(valid.sum())
    counts, total = native.count_buckets(native.get_lib(), src, dst, rel, n,
                                         r)
    np.testing.assert_array_equal(counts,
                                  np.bincount(rel[valid], minlength=r))
    assert total == a.num_edges


def test_native_refuses_a_capacity_below_its_bucket(gxx):
    src, dst, rel = np.arange(10), np.arange(10), np.zeros(10, np.int64)
    with pytest.raises(ValueError, match="capacity"):
        native.build_rel_graph_native(native.get_lib(), src, dst, rel, 10, 1,
                                      [8], norm_mode="dense")


def test_auto_takes_native_from_the_edge_threshold(gxx, monkeypatch):
    calls = []
    real = native.build_rel_graph_native

    def spy(*args, **kwargs):
        calls.append(len(args[1]))
        return real(*args, **kwargs)

    monkeypatch.setattr(native, "build_rel_graph_native", spy)
    src, dst, rel, n, r = _graph_edges("primekg_like")
    below = pgraph.build_rel_graph(src, dst, rel, n, r)
    assert calls == [] and len(src) < pgraph.NATIVE_MIN_EDGES
    monkeypatch.setattr(pgraph, "NATIVE_MIN_EDGES", len(src))
    at = pgraph.build_rel_graph(src, dst, rel, n, r)
    assert calls == [len(src)]
    _assert_equal(below, at)


@pytest.fixture
def no_compiler(tmp_path, monkeypatch):
    """The binding as on a machine without ``g++`` and nothing built."""
    monkeypatch.setattr(native, "COMPILER", "no-such-c++-compiler")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)


def test_always_raises_without_a_compiler(no_compiler):
    src, dst, rel, n, r = _graph_edges("primekg_like")
    with pytest.raises(RuntimeError, match="native graph builder "
                                           "unavailable"):
        pgraph.build_rel_graph(src, dst, rel, n, r, use_native="always")
    assert not native.native_available()


def test_auto_falls_back_to_numpy_without_a_compiler(no_compiler,
                                                     monkeypatch):
    src, dst, rel, n, r = _graph_edges("primekg_like")
    monkeypatch.setattr(pgraph, "NATIVE_MIN_EDGES", 1)
    a = pgraph.build_rel_graph(src, dst, rel, n, r)
    b = pgraph.build_rel_graph(src, dst, rel, n, r, use_native="never")
    _assert_equal(a, b)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="use_native"):
        pgraph.build_rel_graph(np.zeros(1), np.zeros(1), np.zeros(1), 2, 1,
                               use_native="sometimes")


def test_library_is_built_under_the_package_build_dir(gxx):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "primekg_rgcn_tpu_torch"
    assert path.exists()
