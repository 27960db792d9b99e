"""The data-parallel sampled steps on the CPU, against the JAX package.

- The port's dp, zero1 and zero3 steps (flat, and zero3 on a (2, 2) mesh,
  also with ``table_opt="adafactor"``) against the JAX
  ``build_sampled_train_step_{dp,zero1,zero3}`` at 2 and 4 shards, for two
  steps: each shard's JAX candidates, sampler draws (``JaxDraws`` on its
  ``fold_in(key, shard)`` sampling key) and dropout mask are handed to the
  port; loss, accuracy, every parameter and the optimizer state are held
  after each step.
- The port's counterparts of the JAX tests of these steps, under the same
  names, each over the port's own generator: zero1 equals dp, zero3 equals
  zero1 (also in block mode), the (2, 4) mesh equals 8 flat shards, and
  the table optimizer's refusals.
- ``ShardedRowFetch`` against a plain masked gather and its autograd
  gradient; its backward's sorted sums pass B2's sortedness check.
- One zero3 step at bf16 against the JAX step at bf16.

Tolerance as in test_torch_port_sampled_train.py: rtol 2e-4, atol 2e-5
times each tensor's largest magnitude (bf16: 2e-2 and 2e-2, as in
test_torch_port_bf16_paths.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from primekg_rgcn_tpu.config import TrainConfig as JTrainConfig
from primekg_rgcn_tpu.data import sampling as js
from primekg_rgcn_tpu.parallel.mesh import make_mesh as j_mesh
from primekg_rgcn_tpu.parallel.mesh import make_mesh_2d as j_mesh_2d
from primekg_rgcn_tpu.train import loop as jloop
from primekg_rgcn_tpu.train import neg_sampling as jneg
from primekg_rgcn_tpu.train import sampled as jsampled
from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.data import sampling as ps
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph as p_build
from primekg_rgcn_tpu_torch.models import rgcn as pmodel
from primekg_rgcn_tpu_torch.ops.cuda import dense_segment_sum as pds
from primekg_rgcn_tpu_torch.parallel import mesh as pmesh
from primekg_rgcn_tpu_torch.train import sampled as psampled
from test_torch_port_sampled_train import (E, JaxDraws, _flat, _port_params,
                                           _setup, _torch, assert_close)

B = 24
OPT = dict(optimizer="adam", lr=0.01, grad_clip=1.0)


def _adam_state(tree):
    """The ``ScaleByAdamState`` inside an optax state."""
    return next(s for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def jax_shard_draws(jcfg, csr, budgets, combined, pos, key, n, mode):
    """Each shard's candidates, sampler draws and dropout mask as the JAX
    multi-device steps draw them: ``fold_in(key, shard)``, then negatives,
    sampling and dropout keys; the batch split shard-major."""
    cands, draws, masks = [], [], []
    for i in range(n):
        k_neg, k_sample, k_drop = jax.random.split(
            jax.random.fold_in(key, i), 3)
        p = pos[i * B // n:(i + 1) * B // n]
        c = jneg.candidate_batch(k_neg, p[:, 0], p[:, 1], p[:, 2],
                                 jcfg.num_nodes, 1)
        seeds = jnp.concatenate([c[0], c[1]]).astype(jnp.int32)
        batch = (js.sample_batch_combined(k_sample, csr, seeds, budgets,
                                          mode=mode) if combined
                 else js.sample_batch(k_sample, csr, seeds, budgets,
                                      mode=mode))
        _, k = jax.random.split(k_drop)
        mask = jax.random.bernoulli(k, 1.0 - jcfg.dropout,
                                    (batch.blocks[0].m_out, jcfg.hidden_dim))
        cands.append(tuple(_torch(x, long=j < 3) for j, x in enumerate(c)))
        draws.append(JaxDraws(k_sample))
        masks.append(_torch(mask))
    return dict(cands=cands, draw=draws, enc_mask=masks)


def build_pair(layout, shape, mode, opt_kw, fanouts=(4, 3), table_opt="sgd",
               dropout=0.5, bf16=False):
    """(jax init state, jax step, jax to_full, port step, port params, port
    optimizer, graph data) for one layout on an n or (n_dp, n_tp) mesh."""
    edges, jg, pg, jcfg, jp = _setup(seed=5, dropout=dropout)
    if bf16:
        jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    jt = JTrainConfig(batch_size=B, **opt_kw)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    tcfg = TrainConfig(batch_size=B, **opt_kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    kw = dict(fanouts=fanouts, mode=mode)
    if isinstance(shape, tuple):
        mesh, p_mesh = j_mesh_2d(*shape), pmesh.make_mesh_2d(*shape, "cpu")
        kw["dp_axis"] = "dp"
    else:
        mesh, p_mesh = j_mesh(shape), pmesh.make_mesh(shape, "cpu")
    to_full = None
    if layout == "dp":
        opt = jloop.make_optimizer(jt)
        jstep = jsampled.build_sampled_train_step_dp(jg, jcfg, jt, opt, mesh,
                                                     **kw)
        state = jloop.TrainState(jparams, opt.init(jparams),
                                 jnp.zeros((), jnp.int32))
        step = psampled.build_sampled_train_step_dp(pg, cfg, tcfg, p_mesh,
                                                    **kw)
    elif layout == "zero1":
        init, jstep = jsampled.build_sampled_train_step_zero1(
            jg, jcfg, jt, mesh, **kw)
        state = init(jparams)
        step = psampled.build_sampled_train_step_zero1(pg, cfg, tcfg, p_mesh,
                                                       **kw)
    else:
        init, jstep, to_full, _ = jsampled.build_sampled_train_step_zero3(
            jg, jcfg, jt, mesh, table_opt=table_opt, **kw)
        state = init(jparams)
        kw.pop("dp_axis", None)
        step = psampled.build_sampled_train_step_zero3(
            pg, cfg, tcfg, p_mesh, table_opt=table_opt, **kw)
    pp = _port_params(jp)
    if layout == "zero3":
        pp = step.shard_params(pp)
    return (state, jstep, to_full, step, pp, step.init_optimizer(pp),
            (edges, jg, jcfg))


def _compare_params(layout, step, pp, state, to_full):
    ours = _flat(pp)
    theirs = _flat(jax.tree_util.tree_map(np.asarray, state.params))
    assert ours.keys() == theirs.keys()
    for k, want in theirs.items():
        got = ours[k].detach()
        if layout == "zero3" and k == "encoder/node_emb":
            assert tuple(got.shape) == want.shape
            got, want = step.to_full(got), np.asarray(to_full(want))
        assert_close(got.numpy(), want)


def _compare_opt_state(layout, pp, opt, state, table_opt):
    if layout == "dp":
        adam = _adam_state(state.opt_state)
        for name, p in _flat(pp).items():
            assert_close(opt.state[p]["exp_avg"].numpy(), _flat(adam.mu)[name])
            assert_close(opt.state[p]["exp_avg_sq"].numpy(),
                         _flat(adam.nu)[name])
        return
    rest_state, emb_state = state.opt_state
    adam = _adam_state(rest_state)
    emb, rest = psampled._split_emb(pp)
    for name, p in _flat(rest).items():
        assert_close(opt.rest.state[p]["exp_avg"].numpy(),
                     _flat(adam.mu)[name])
        assert_close(opt.rest.state[p]["exp_avg_sq"].numpy(),
                     _flat(adam.nu)[name])
    if table_opt == "adafactor":
        for k in ("v_row", "v_col"):
            assert_close(opt.table[k].numpy(), np.asarray(emb_state[k]))
        np.testing.assert_array_equal(opt.table["count"].numpy(),
                                      np.asarray(emb_state["count"]))
        return
    # The per-slice moments, stacked [n, n_loc, D] as JAX stores them.
    table_state = opt.table.state[opt.table.param_groups[0]["params"][0]]
    emb_adam = _adam_state(emb_state)
    assert table_state["exp_avg"].shape == emb_adam.mu.shape
    assert_close(table_state["exp_avg"].numpy(), np.asarray(emb_adam.mu))
    assert_close(table_state["exp_avg_sq"].numpy(), np.asarray(emb_adam.nu))


# (layout, mesh, mode, table_opt): each layout at 2 and 4 shards over the
# per-relation layout (uniform) and block over the combined one; zero3 on
# the (2, 2) mesh, and with the factored table rule.
CASES = [
    ("dp", 2, "uniform", "sgd"),
    ("dp", 4, "block", "sgd"),
    ("zero1", 2, "uniform", "sgd"),
    ("zero1", 4, "block", "sgd"),
    ("zero3", 2, "uniform", "sgd"),
    ("zero3", 4, "block", "sgd"),
    ("zero3", (2, 2), "block", "sgd"),
    ("zero3", 4, "block", "adafactor"),
    ("zero3", (2, 2), "uniform", "adafactor"),
]


@pytest.mark.parametrize("layout,shape,mode,table_opt", CASES)
def test_step_matches_the_jax_step(layout, shape, mode, table_opt):
    opt_kw = dict(OPT, grad_clip=0.0) if table_opt == "adafactor" else OPT
    state, jstep, to_full, step, pp, opt, (edges, jg, jcfg) = build_pair(
        layout, shape, mode, opt_kw, table_opt=table_opt)
    n = shape[0] * shape[1] if isinstance(shape, tuple) else shape
    csr, budgets, combined = jsampled.resolve_sampler(jg, (4, 3), "auto",
                                                      mode)
    assert combined == (mode == "block")
    rng = np.random.default_rng(2)
    key = jax.random.PRNGKey(7)
    for _ in range(2):
        pos = jnp.asarray(edges[rng.integers(0, E, B)])
        key, k = jax.random.split(key)
        state, (loss_j, acc_j) = jstep(state, pos, k)
        loss, acc = step(pp, opt, _torch(pos, long=True), torch.Generator(),
                         **jax_shard_draws(jcfg, csr, budgets, combined, pos,
                                           k, n, mode))
        assert_close(loss.item(), float(loss_j))
        assert acc.item() == pytest.approx(float(acc_j))
        _compare_params(layout, step, pp, state, to_full)
        _compare_opt_state(layout, pp, opt, state, table_opt)


def test_zero3_step_matches_the_jax_step_at_bf16():
    """SGD, so that each parameter's change is its gradient times lr: the
    changes are held at bf16's tolerance."""
    opt_kw = dict(optimizer="sgd", lr=0.5, grad_clip=0.0)
    state, jstep, to_full, step, pp, opt, (edges, jg, jcfg) = build_pair(
        "zero3", 4, "block", opt_kw, bf16=True)
    before = {k: v.detach().clone() for k, v in _flat(pp).items()}
    csr, budgets, combined = jsampled.resolve_sampler(jg, (4, 3), "auto",
                                                      "block")
    pos = jnp.asarray(edges[np.random.default_rng(3).integers(0, E, B)])
    key = jax.random.PRNGKey(11)
    state, (loss_j, _) = jstep(state, pos, key)
    loss, _ = step(pp, opt, _torch(pos, long=True), torch.Generator(),
                   **jax_shard_draws(jcfg, csr, budgets, combined, pos, key,
                                     4, "block"))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-3)
    theirs = _flat(jax.tree_util.tree_map(np.asarray, state.params))
    for k, p in _flat(pp).items():
        # The table's change slice by slice, [n_tp, n_loc, D].
        got, want = p.detach() - before[k], theirs[k] - before[k].numpy()
        scale = float(np.abs(want).max())
        assert scale > 0, k
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-2,
                                   atol=2e-2 * scale, err_msg=k)


def _graph(n, r, e, seed):
    rng = np.random.default_rng(seed)
    src, dst, rel = (rng.integers(0, n, e), rng.integers(0, n, e),
                     rng.integers(0, r, e))
    graph = p_build(src, dst, rel, n, r, bucket_pad_multiple=64)
    return graph, np.stack([src, dst, rel], 1).astype(np.int64)


def _copy(params):
    if isinstance(params, dict):
        return {k: _copy(v) for k, v in params.items()}
    return params.detach().clone().requires_grad_(True)


def _port_run(step, graph_edges, params, steps, *, batch=64, seed=9):
    """``steps`` steps of ``step`` from a copy of ``params`` over the same
    batches and generator seed: (losses, parameters with a full table)."""
    pp = _copy(params)
    if hasattr(step, "shard_params"):
        pp = step.shard_params(pp)
    opt = step.init_optimizer(pp)
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(steps):
        idx = rng.integers(0, graph_edges.shape[0], batch)
        losses.append(step(pp, opt, torch.from_numpy(graph_edges[idx]),
                           gen)[0].item())
    if hasattr(step, "full_params"):
        pp = step.full_params(pp)
    return losses, _flat(pp)


def _same_run(a, b, rtol=3e-5, atol=3e-6):
    np.testing.assert_allclose(a[0], b[0], rtol=1e-6)
    for k in a[1]:
        np.testing.assert_allclose(a[1][k].detach().numpy(),
                                   b[1][k].detach().numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


def _cfg(n, r, dropout=0.3):
    return ModelConfig(num_nodes=n, num_relations=r, embedding_dim=8,
                       hidden_dim=8, dropout=dropout)


def _init(cfg):
    return pmodel.init_params(torch.Generator().manual_seed(0), cfg)


@pytest.mark.parametrize("opt_kw", [
    dict(optimizer="adam", grad_clip=1.0),
    dict(optimizer="adamw", weight_decay=1e-4, grad_clip=0.5),
])
def test_sampled_zero1_matches_dp_exactly(opt_kw):
    graph, edges = _graph(60, 3, 800, 0)
    cfg, tcfg = _cfg(60, 3), TrainConfig(batch_size=64, lr=1e-2, **opt_kw)
    mesh = pmesh.make_mesh(4, "cpu")
    params = _init(cfg)
    runs = [_port_run(build(graph, cfg, tcfg, mesh, fanouts=(5, 3)), edges,
                      params, 4)
            for build in (psampled.build_sampled_train_step_dp,
                          psampled.build_sampled_train_step_zero1)]
    _same_run(*runs, rtol=2e-5, atol=2e-6)


def _zero3_vs_zero1(mode, n, r, e, steps):
    graph, edges = _graph(n, r, e, 1)
    cfg, tcfg = _cfg(n, r), TrainConfig(batch_size=64, lr=1e-2)
    mesh = pmesh.make_mesh(4, "cpu")
    params = _init(cfg)
    built = [build(graph, cfg, tcfg, mesh, fanouts=(5, 4), mode=mode)
             for build in (psampled.build_sampled_train_step_zero1,
                           psampled.build_sampled_train_step_zero3)]
    assert built[1].sample.use_combined == (mode == "block")
    _same_run(*[_port_run(s, edges, params, steps) for s in built])


def test_zero3_matches_zero1():
    _zero3_vs_zero1("uniform", 90, 12, 800, 4)


def test_zero3_block_mode_matches_zero1():
    """On a relation-sparse graph, which takes the combined CSR."""
    _zero3_vs_zero1("block", 80, 16, 700, 3)


@pytest.mark.parametrize("table_opt", ["sgd", "adafactor"])
def test_zero3_hierarchical_matches_flat(table_opt):
    graph, edges = _graph(90, 12, 800, 1)
    cfg = _cfg(90, 12)
    tcfg = TrainConfig(batch_size=64, lr=1e-2,
                       grad_clip=0.0 if table_opt == "adafactor" else 1.0)
    params = _init(cfg)
    steps = [psampled.build_sampled_train_step_zero3(
        graph, cfg, tcfg, mesh, fanouts=(5, 4), table_opt=table_opt)
        for mesh in (pmesh.make_mesh(8, "cpu"),
                     pmesh.make_mesh_2d(2, 4, "cpu"))]
    if table_opt == "adafactor":
        # Factored: [n_tp, D] + [n_tp, n_loc] statistics, no table-sized
        # moment.
        opt = steps[1].init_optimizer(steps[1].shard_params(params))
        assert opt.table["v_row"].shape == (4, 8)
        assert opt.table["v_col"].shape == (4, 23)
    runs = [_port_run(s, edges, params, 4) for s in steps]
    assert not torch.equal(runs[0][1]["encoder/node_emb"],
                           params["encoder"]["node_emb"])
    _same_run(*runs)

    # The sharded validation runs on the 2-D mesh.
    step = steps[1]
    pp = step.shard_params(params)
    pos_mask = np.zeros((64, 4), np.int64)
    pos_mask[:50, :3] = edges[:50]
    pos_mask[:50, 3] = 1
    trio = step.eval_batch(pp, torch.from_numpy(pos_mask),
                           torch.Generator().manual_seed(1))
    assert trio[2].item() == 100.0  # 50 real positives + 50 negatives
    assert torch.isfinite(trio).all()


def test_zero3_table_opt_validation():
    graph, _ = _graph(60, 3, 300, 0)
    mesh = pmesh.make_mesh(8, "cpu")
    with pytest.raises(ValueError, match="grad_clip"):
        psampled.build_sampled_train_step_zero3(
            graph, _cfg(60, 3), TrainConfig(batch_size=64, grad_clip=1.0),
            mesh, fanouts=(4, 3), table_opt="adafactor")
    with pytest.raises(ValueError, match="table_opt"):
        psampled.build_sampled_train_step_zero3(
            graph, _cfg(60, 3), TrainConfig(batch_size=64, grad_clip=0.0),
            mesh, fanouts=(4, 3), table_opt="rmsprop")
    step = psampled.build_sampled_train_step_dp(
        graph, _cfg(60, 3), TrainConfig(), mesh, fanouts=(4, 3))
    with pytest.raises(ValueError, match="divide"):
        step(_init(_cfg(60, 3)), None, torch.zeros(60, 3, dtype=torch.long),
             torch.Generator())


def test_sharded_row_fetch_matches_a_masked_gather(monkeypatch):
    """Forward against ``table[ids]`` with the sentinel rows zero, and the
    gradient against autograd through that gather; the backward's n * n
    sorted sums pass B2's own order check (the wrapper that raises on
    unsorted ids on a CPU tensor)."""
    n, n_nodes, d, cap = 4, 70, 6, 24
    n_loc = -(-n_nodes // n)
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(n_nodes, d)).astype(np.float32))
    frontiers = []
    for _ in range(n):
        k = int(rng.integers(5, cap))
        f = np.full(cap, n_nodes, np.int32)
        f[:k] = np.sort(rng.choice(n_nodes, k, replace=False))
        frontiers.append(torch.from_numpy(f))
    all_ids = pmesh.all_gather(frontiers, tiled=True)
    off = torch.arange(n)[:, None] * n_loc
    owned = (all_ids >= off) & (all_ids < (off + n_loc).clamp(max=n_nodes))
    loc_ids = (all_ids - off).clamp(0, n_loc - 1).to(torch.int32)
    emb_dm = torch.nn.functional.pad(table, (0, 0, 0, n * n_loc - n_nodes))
    emb_dm = emb_dm.view(n, n_loc, d).clone().requires_grad_(True)

    calls = []

    def checked(gp, ids, num_segments):
        calls.append(ids.shape[0])
        return pds.dense_sorted_segment_sum(gp, ids, num_segments)

    monkeypatch.setattr(ps, "_sorted_accumulate", checked)
    rows = psampled.ShardedRowFetch.apply(emb_dm, owned, loc_ids)
    g = torch.from_numpy(rng.normal(size=(n, cap, d)).astype(np.float32))
    (rows * g).sum().backward()
    assert calls == [cap] * (n * n)

    ref_table = table.clone().requires_grad_(True)
    ids = torch.stack(frontiers).long()
    want = torch.where((ids < n_nodes)[..., None],
                       ref_table[ids.clamp(max=n_nodes - 1)], 0.0)
    (want * g).sum().backward()
    torch.testing.assert_close(rows.detach(), want.detach())
    grad = emb_dm.grad.reshape(n * n_loc, d)
    torch.testing.assert_close(grad[:n_nodes], ref_table.grad)
    assert not grad[n_nodes:].any()


def test_mesh_collectives_and_2d_mesh():
    mesh = pmesh.make_mesh_2d(2, 3, "cpu")
    assert (mesh.n_shards, mesh.n_dp, mesh.n_tp) == (6, 2, 3)
    assert [list(g) for g in pmesh.shard_groups(mesh)] == [[0, 1, 2],
                                                          [3, 4, 5]]
    assert pmesh.make_mesh(4, "cpu").n_tp == 4
    with pytest.raises(ValueError, match="at least 2"):
        pmesh.make_mesh_2d(1, 1, "cpu")
    xs = [torch.arange(6.0).view(3, 2) * (i + 1) for i in range(3)]
    assert torch.equal(pmesh.all_gather(xs), torch.stack(xs))
    assert torch.equal(pmesh.all_gather(xs, tiled=True), torch.cat(xs))
    assert torch.equal(pmesh.psum(xs), xs[0] + xs[1] + xs[2])
    got = pmesh.psum_scatter(xs)
    assert got.shape == (3, 1, 2)
    for i in range(3):
        assert torch.equal(got[i], sum(x[i:i + 1] for x in xs))
