"""BASELINE config 5's graph in the port, on the CPU, against the JAX package:
the numpy R-MAT generator bit for bit, the C++ one (``native.rmat_native``)
bit for bit against the JAX package's library at edge counts that split
across threads, its rebuild when the source changes, and config 5 in
miniature: an R-MAT graph of 50 relations over a slim CSR, one bf16
sparse-embedding SGD step with the innermost block identity, against the
JAX step on the JAX draws. The native tests need ``g++`` and skip without
it.

Tolerance of the step: float32, rtol 2e-4 and atol 2e-5 of each tensor's
largest magnitude (test_torch_parity.py); bf16, 2e-2 (the tolerance of
test_torch_port_bf16_paths.py), held as the bf16 test's docstring says.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from primekg_rgcn_tpu import native as jnative
from primekg_rgcn_tpu.config import ModelConfig as JModelConfig
from primekg_rgcn_tpu.config import TrainConfig as JTrainConfig
from primekg_rgcn_tpu.data import sampling as js
from primekg_rgcn_tpu.data import synthetic as jsyn
from primekg_rgcn_tpu.data.graph import build_rel_graph as j_build
from primekg_rgcn_tpu.models import rgcn as jmodel
from primekg_rgcn_tpu.train import sampled as jsampled
from primekg_rgcn_tpu_torch import native
from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.data import sampling as ps
from primekg_rgcn_tpu_torch.data import synthetic as psyn
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph as p_build
from primekg_rgcn_tpu_torch.train import sampled as psampled
from test_torch_port_sampled_train import (JaxDraws, _flat, _jax_batch,
                                           _port_params, _torch,
                                           assert_close)


@pytest.fixture
def gxx():
    if shutil.which(native.COMPILER) is None:
        pytest.skip(f"no C++ compiler {native.COMPILER!r} on this machine")
    assert native.native_available()


def _assert_same(ours, theirs):
    for k in ("src", "dst", "rel"):
        assert ours[k].dtype == theirs[k].dtype == np.int64, k
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert (ours["num_nodes"], ours["num_relations"]) == (
        theirs["num_nodes"], theirs["num_relations"])


@pytest.mark.parametrize("n,e,r,seed", [
    (1000, 5000, 50, 0),      # N not a power of two: the ids fold
    (1024, 3000, 7, 3),       # N a power of two
    (1, 100, 2, 1),           # one node: one bit
])
def test_rmat_equals_jax(n, e, r, seed):
    ours = psyn.rmat(n, e, r, seed=seed)
    _assert_same(ours, jsyn.rmat(n, e, r, seed=seed))
    assert ours["src"].min() >= 0 and ours["src"].max() < n
    assert ours["rel"].min() >= 0 and ours["rel"].max() < r


def test_rmat_quadrant_probabilities_reach_the_ids():
    """Other quadrant weights move the draw exactly as the JAX ones do."""
    kw = dict(a=0.45, b=0.15, c=0.25)
    _assert_same(psyn.rmat(3000, 4000, 5, seed=2, **kw),
                 jsyn.rmat(3000, 4000, 5, seed=2, **kw))


@pytest.mark.parametrize("e", [2 * 65536, 300_000])
def test_rmat_native_equals_the_jax_library(gxx, e):
    """At 2 * 65536 edges and more, parallel_for splits the edges across
    threads, each chunk with its own seeded generator: the port's library
    and the JAX package's split alike on one machine."""
    theirs = jnative.rmat_native(10_000, e, 50, seed=7)
    if theirs is None:
        pytest.skip("the JAX package's native library did not build")
    _assert_same(native.rmat_native(10_000, e, 50, seed=7), theirs)


def test_rmat_native_repeats_per_seed(gxx):
    a = native.rmat_native(5000, 140_000, 50, seed=1)
    b = native.rmat_native(5000, 140_000, 50, seed=1)
    c = native.rmat_native(5000, 140_000, 50, seed=2)
    _assert_same(a, b)
    assert not np.array_equal(a["src"], c["src"])
    assert a["src"].max() < 5000 and a["dst"].max() < 5000
    assert set(np.unique(a["rel"])) == set(range(50))


def test_rmat_native_is_none_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert native.rmat_native(10, 10, 2) is None


def test_changed_source_builds_a_new_library(gxx, tmp_path, monkeypatch):
    """The library is keyed by a hash of its source: a changed source (as
    adding gb_rmat changed it) builds anew at first use, with gb_rmat."""
    src = tmp_path / "graphbuild.cpp"
    src.write_text(native.SOURCE.read_text() + "\n// another revision\n")
    old_path = native.library_path()
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    path = native.library_path()
    assert path.name != old_path.name and not path.exists()
    assert native.get_lib() is not None and path.exists()
    _assert_same(native.rmat_native(500, 1000, 3, seed=4),
                 jnative.rmat_native(500, 1000, 3, seed=4))


# -- config 5 in miniature -----------------------------------------------------

N5, E5, R5 = 2000, 12000, 50
LR5 = 0.5


@pytest.fixture(scope="module")
def config5_small():
    """An R-MAT graph of config 5's shape (50 relations, average in-degree
    6) in both packages, not bidirected, as the JAX suite builds it, and one
    batch of 32 positives."""
    g = psyn.rmat(N5, E5, R5, seed=0)
    src, dst, rel = g["src"], g["dst"], g["rel"]
    r = int(rel.max()) + 1
    jg = j_build(src, dst, rel, N5, r, bucket_pad_multiple=64,
                 use_native="never")
    pg = p_build(src, dst, rel, N5, r, bucket_pad_multiple=64)
    jp = jax.tree_util.tree_map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(0), _jcfg(r, "float32")))
    edges = np.stack([src, dst, rel], 1).astype(np.int32)
    pos = jnp.asarray(edges[np.random.default_rng(1).integers(0, E5, 32)])
    return jg, pg, jp, pos, {}


def _jcfg(r, dtype):
    return JModelConfig(num_nodes=N5, num_relations=r, embedding_dim=8,
                        hidden_dim=16, dropout=0.5, compute_dtype=dtype)


def _config5_steps(data, mode, dtype):
    """One sparse SGD step (lr 0.5, no clip) at fanouts 15/10 over the slim
    packed CSR (granule pairs for block mode) in each package, the port on
    the JAX step's candidates, draws and dropout mask. Returns ({leaf: JAX
    parameter after the step}, {leaf: the port's}, JAX loss, port loss);
    kept per (mode, dtype) for the module."""
    jg, pg, jp, pos, memo = data
    if (mode, dtype) in memo:
        return memo[mode, dtype]
    jcfg = _jcfg(jg.num_relations, dtype)
    csr_kw = {"slim": True, "window_pairs": mode == "block"}
    jcsr = js.build_combined_csr(jg, **csr_kw)
    pcsr = ps.build_combined_csr(pg, **csr_kw)
    assert jcsr.packed.shape[0] and pcsr.packed.shape[0]   # slim, packed
    jstep = jsampled.build_sampled_train_step(
        jcsr, jcfg, JTrainConfig(batch_size=32, lr=LR5), optax.sgd(LR5),
        fanouts=(15, 10), mode=mode, sparse_emb=True)
    state = jstep.init_state(jax.tree_util.tree_map(jnp.asarray, jp))
    key = jax.random.PRNGKey(5)
    state, (loss_j, _) = jstep(state, pos, key)
    _, cands, jb, k_sample, _, mask = _jax_batch(jg, jcfg, pos, key, (15, 10),
                                                 mode, csr_kw)
    # Config 5's regime: the innermost block is identity.
    assert jb.blocks[0].ident and not jb.blocks[1].ident

    cfg = ModelConfig.from_dict(jcfg.to_dict())
    step = psampled.build_sampled_train_step(
        pcsr, cfg, TrainConfig(batch_size=32, optimizer="sgd", lr=LR5,
                               grad_clip=0.0),
        fanouts=(15, 10), mode=mode, sparse_emb=True, device="cpu")
    assert step.budgets == (48, 48)       # capped, as at full size
    pp = _port_params(jp)
    opt = step.init_optimizer(pp)
    pcands = tuple(_torch(c, long=i < 3) for i, c in enumerate(cands))
    pb = step.sample(torch.cat(pcands[:2]).to(torch.int32),
                     JaxDraws(k_sample))
    assert pb.blocks[0].ident and not pb.blocks[1].ident
    loss, _ = step(pp, opt, _torch(pos, long=True), torch.Generator(),
                   cands=pcands, draw=JaxDraws(k_sample),
                   enc_mask=_torch(mask))
    memo[mode, dtype] = (
        _flat(jax.tree_util.tree_map(np.asarray, state.params)),
        {k: p.detach().numpy() for k, p in _flat(pp).items()},
        float(loss_j), loss.item())
    return memo[mode, dtype]


@pytest.mark.parametrize("mode", ["uniform", "block"])
def test_config5_miniature_f32_sgd_step_matches_jax(config5_small, mode):
    theirs, ours, loss_j, loss = _config5_steps(config5_small, mode,
                                                "float32")
    assert_close(loss, loss_j)
    for name, p in ours.items():
        assert_close(p, theirs[name])
    # Identity block, SGD: the table moved densely, the same rows in both.
    p0 = config5_small[2]["encoder"]["node_emb"]
    np.testing.assert_array_equal((ours["encoder/node_emb"] != p0).any(1),
                                  (theirs["encoder/node_emb"] != p0).any(1))


@pytest.mark.parametrize("mode", ["uniform", "block"])
def test_config5_miniature_bf16_sgd_step_matches_jax(config5_small, mode):
    """The bf16 step's loss within 2e-2 of the JAX bf16 step's. Its update
    of every leaf is held against the float32 JAX step's: within 2e-2 of
    that update's largest magnitude, or no farther from it than the JAX
    bf16 step's update. (The JAX step sums the outer block's bf16 dedup
    cotangents in bf16, where the port sums them in float32,
    ``data/sampling._sorted_accumulate``: here that moves its conv1 and
    table updates by up to 4 % of their largest value, the port's by up to
    3 %.)"""
    theirs, ours, loss_j, loss = _config5_steps(config5_small, mode,
                                                "bfloat16")
    ref = _config5_steps(config5_small, mode, "float32")[0]
    np.testing.assert_allclose(loss, loss_j, rtol=2e-2)
    p0 = _flat(config5_small[2])
    for name, p in ours.items():
        want = ref[name] - p0[name]
        top = float(np.abs(want).max())
        ours_err = float(np.abs(p - p0[name] - want).max())
        jax_err = float(np.abs(theirs[name] - p0[name] - want).max())
        assert ours_err <= max(2e-2 * top, jax_err), (name, ours_err,
                                                      jax_err, top)
