"""The factored (adafactor) table rule, on the CPU, against the JAX package
and optax.

- ``factored_slice_update`` on one device (``axis_name=None``) and over n
  row slices with their statistics summed, and ``factored_rows_update``
  from a sparse row gradient, each against the JAX function and against
  ``optax.adafactor(lr, min_dim_size_to_factor=2,
  multiply_by_parameter_scale=False)`` on the dense table (the port's
  counterparts of ``test_factored_slice_update_matches_dense_optax`` and
  ``test_factored_rows_update_matches_dense_optax``).
- The one-device ``--sparse_emb --table_opt adafactor`` step against the
  JAX step for two steps, in both regimes (identity block, frontier rows),
  with the JAX candidates, draws and dropout masks handed over
  (``test_sparse_emb_adafactor_table``), and its refusals.
- A ``SampledTrainer`` run with the factored state saved and resumed
  (``test_sampled_trainer_adafactor_resume``).

Tolerance: against optax, rtol 2e-5 (as the JAX tests), atol 1e-10 on an
update and 1e-6 times the table's largest magnitude on the updated table;
against the JAX step, rtol 2e-4, atol 2e-5 times the largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from primekg_rgcn_tpu.config import TrainConfig as JTrainConfig
from primekg_rgcn_tpu.train import loop as jloop
from primekg_rgcn_tpu.train import sampled as jsampled
from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph as p_build
from primekg_rgcn_tpu_torch.train import checkpoint as pckpt
from primekg_rgcn_tpu_torch.train import sampled as psampled
from test_torch_port_sampled_train import (E, JaxDraws, _flat, _jax_batch,
                                           _port_params, _setup, _torch,
                                           assert_close)

LR = 5e-2
# The updated tables: a few float32 roundings of the table's largest value
# (the port sums the statistics in another order than optax).
TABLE_ATOL = 1e-6


def _dense_optax(table):
    tx = optax.adafactor(learning_rate=LR, min_dim_size_to_factor=2,
                         multiply_by_parameter_scale=False)
    return tx, tx.init(jnp.asarray(table))


def _factored_stats(state):
    fs = state[0]  # FactoredState of scale_by_factored_rms
    return (np.asarray(jax.tree_util.tree_leaves(fs.v_row)[0]),
            np.asarray(jax.tree_util.tree_leaves(fs.v_col)[0]))


@pytest.mark.parametrize("n_slices", [None, 4, 8])
def test_factored_slice_update_matches_dense_optax(n_slices):
    """One device (the JAX function at ``axis_name=None`` too), and n row
    slices with the last padded (90 rows: 23 a slice at 4, 12 at 8)."""
    n, d = 90, 8
    rng = np.random.default_rng(3)
    table = rng.normal(0, 0.1, (n, d)).astype(np.float32)
    tx, dense_state = _dense_optax(table)
    dense = jnp.asarray(table)
    ours = torch.from_numpy(table.copy())
    n_loc = n if n_slices is None else -(-n // n_slices)
    rows = n_loc * (n_slices or 1)
    state = psampled.factored_slice_init(n_loc, d, n_slices=n_slices)
    valid = (torch.arange(rows) < n).float()
    if n_slices:
        valid = valid.view(n_slices, n_loc)
    j_state = jsampled.factored_slice_init(n, d)
    for step in range(3):
        g = rng.normal(0, 1e-3, (n, d)).astype(np.float32)
        g[step::3] = 0.0  # untouched rows, as a sparse batch leaves them
        upd_d, dense_state = tx.update(jnp.asarray(g), dense_state, dense)
        dense = optax.apply_updates(dense, upd_d)
        g_pad = torch.from_numpy(np.concatenate(
            [g, np.zeros((rows - n, d), np.float32)]))
        upd, state = psampled.factored_slice_update(
            g_pad if n_slices is None else g_pad.view(n_slices, n_loc, d),
            state, axis_name=None if n_slices is None else "tp",
            row_valid=valid, n_valid=n, lr=LR)
        upd = upd.reshape(rows, d)[:n]
        ours += upd
        np.testing.assert_allclose(upd.numpy(), np.asarray(upd_d),
                                   rtol=2e-5, atol=1e-10)
        if n_slices is None:
            upd_j, j_state = jsampled.factored_slice_update(
                jnp.asarray(g), j_state, axis_name=None,
                row_valid=jnp.ones(n, jnp.float32), n_valid=n, lr=LR)
            np.testing.assert_allclose(upd.numpy(), np.asarray(upd_j),
                                       rtol=2e-5, atol=1e-10)
    np.testing.assert_allclose(ours.numpy(), np.asarray(dense), rtol=2e-5,
                               atol=TABLE_ATOL * np.abs(table).max())
    v_row, v_col = _factored_stats(dense_state)
    # Every slice holds the one column statistic.
    got_row = state["v_row"] if n_slices is None else state["v_row"][-1]
    np.testing.assert_allclose(got_row.numpy(), v_row, rtol=2e-5)
    np.testing.assert_allclose(state["v_col"].reshape(-1)[:n].numpy(), v_col,
                               rtol=2e-5, atol=1e-32)
    assert state["count"].reshape(-1).tolist() == [3] * (n_slices or 1)
    if n_slices:
        for v_row in state["v_row"]:
            np.testing.assert_array_equal(v_row.numpy(), got_row.numpy())


def test_factored_rows_update_matches_dense_optax():
    """At partial frontier coverage, with garbage gradients at the fill
    slots (id N) that must drop; against the JAX function as well."""
    n, d, cap = 90, 8, 24
    rng = np.random.default_rng(7)
    table = rng.normal(0, 0.1, (n, d)).astype(np.float32)
    tx, dense_state = _dense_optax(table)
    dense = jnp.asarray(table)
    ours = torch.from_numpy(table.copy())
    theirs = jnp.asarray(table)
    state = psampled.factored_slice_init(n, d)
    j_state = jsampled.factored_slice_init(n, d)
    for step in range(4):
        k = 16 + step
        rows = np.sort(rng.choice(n, size=k, replace=False)).astype(np.int32)
        frontier = np.full(cap, n, np.int32)
        frontier[:k] = rows
        g_rows = rng.normal(0, 1e-2, (cap, d)).astype(np.float32)
        g_rows[k:] = 5.0
        g_dense = np.zeros((n, d), np.float32)
        g_dense[rows] = g_rows[:k]
        upd_d, dense_state = tx.update(jnp.asarray(g_dense), dense_state,
                                       dense)
        dense = optax.apply_updates(dense, upd_d)
        state = psampled.factored_rows_update(
            torch.from_numpy(g_rows), torch.from_numpy(frontier), ours, state,
            lr=LR)
        theirs, j_state = jsampled.factored_rows_update(
            jnp.asarray(g_rows), jnp.asarray(frontier), theirs, j_state,
            lr=LR)
        for want in (dense, theirs):
            np.testing.assert_allclose(ours.numpy(), np.asarray(want),
                                       rtol=2e-5,
                                       atol=TABLE_ATOL * np.abs(table).max())
    v_row, v_col = _factored_stats(dense_state)
    np.testing.assert_allclose(state["v_row"].numpy(), v_row, rtol=2e-5,
                               atol=1e-32)
    np.testing.assert_allclose(state["v_col"].numpy(), v_col, rtol=2e-5,
                               atol=1e-32)
    for k in ("v_row", "v_col"):
        np.testing.assert_allclose(state[k].numpy(), np.asarray(j_state[k]),
                                   rtol=2e-5, atol=1e-32)


@pytest.mark.parametrize("mode,ident", [("block", True), ("uniform", False)])
def test_sparse_emb_adafactor_table(mode, ident, monkeypatch):
    """Two steps of the one-device sparse step with the factored table rule
    against the JAX step: every parameter and the table's statistics."""
    if not ident:
        monkeypatch.setenv("PRIMEKG_IDENT_FRACTION", "1000")
    edges, jg, pg, jcfg, jp = _setup(seed=5, dropout=0.5)
    kw = dict(optimizer="adam", lr=0.05, grad_clip=0.0)
    jt = JTrainConfig(batch_size=24, **kw)
    jstep = jsampled.build_sampled_train_step(
        jg, jcfg, jt, jloop.make_optimizer(jt), fanouts=(4, 3), mode=mode,
        sparse_emb=True, table_opt="adafactor")
    state = jstep.init_state(jax.tree_util.tree_map(jnp.asarray, jp))
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    step = psampled.build_sampled_train_step(
        pg, cfg, TrainConfig(batch_size=24, **kw), fanouts=(4, 3), mode=mode,
        sparse_emb=True, table_opt="adafactor", device="cpu")
    pp = _port_params(jp)
    opt = step.init_optimizer(pp)
    assert opt.table["v_col"].shape == (cfg.num_nodes,)
    rng = np.random.default_rng(2)
    key = jax.random.PRNGKey(7)
    for _ in range(2):
        pos = jnp.asarray(edges[rng.integers(0, E, 24)])
        key, k = jax.random.split(key)
        state, (loss_j, _) = jstep(state, pos, k)
        _, cands, jb, k_sample, _, mask = _jax_batch(jg, jcfg, pos, k,
                                                     (4, 3), mode)
        assert bool(getattr(jb.blocks[0], "ident", False)) == ident
        loss, _ = step(pp, opt, _torch(pos, long=True), torch.Generator(),
                       cands=tuple(_torch(c, long=i < 3)
                                   for i, c in enumerate(cands)),
                       draw=JaxDraws(k_sample), enc_mask=_torch(mask))
        assert_close(loss.item(), float(loss_j))
        theirs = _flat(jax.tree_util.tree_map(np.asarray, state.params))
        for name, p in _flat(pp).items():
            assert_close(p.detach().numpy(), theirs[name])
        for name in ("v_row", "v_col"):
            assert_close(opt.table[name].numpy(),
                         np.asarray(state.opt_state[1][name]))
        assert int(opt.table["count"]) == int(state.opt_state[1]["count"])


def test_table_opt_refusals():
    edges, _, pg, jcfg, _ = _setup()
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    with pytest.raises(ValueError, match="requires sparse_emb"):
        psampled.build_sampled_train_step(pg, cfg, TrainConfig(),
                                          table_opt="adafactor",
                                          device="cpu")
    with pytest.raises(ValueError, match="unknown table_opt"):
        psampled.build_sampled_train_step(pg, cfg, TrainConfig(),
                                          sparse_emb=True,
                                          table_opt="rmsprop", device="cpu")


def _sparse_graph(n=80, r=12, e=700):
    rng = np.random.default_rng(0)
    src, dst, rel = (rng.integers(0, n, e), rng.integers(0, n, e),
                     rng.integers(0, r, e))
    return (p_build(src, dst, rel, n, r, bucket_pad_multiple=64),
            np.stack([src, dst, rel], 1).astype(np.int32),
            ModelConfig(num_nodes=n, num_relations=r, embedding_dim=8,
                        hidden_dim=8, dropout=0.0))


def test_sampled_trainer_adafactor_resume(tmp_path):
    """The (rest adam state, factored table state) pair round-trips through
    the checkpoint: resumed, the run continues from the saved statistics."""
    graph, edges, cfg = _sparse_graph()
    tcfg = TrainConfig(batch_size=64, lr=0.05, epochs=2, optimizer="adam",
                       grad_clip=0.0)
    t = psampled.SampledTrainer(cfg, tcfg, graph, graph, edges, edges[:100],
                                tmp_path / "out", fanouts=(5, 4),
                                sparse_emb=True, table_opt="adafactor",
                                device="cpu")
    hist = t.train()["history"]
    assert len(hist["val_losses"]) == 2
    saved = pckpt.load(tmp_path / "out" / "models" / "final_model.pt")
    table_state = saved["optimizer_state_dict"]["table"]
    assert table_state["v_col"].shape == (cfg.num_nodes,)
    assert int(table_state["count"]) == 2 * -(-len(edges) // 64)

    t2 = psampled.SampledTrainer(
        cfg, TrainConfig(**{**tcfg.to_dict(), "epochs": 3}), graph, graph,
        edges, edges[:100], tmp_path / "out2", fanouts=(5, 4),
        sparse_emb=True, table_opt="adafactor", device="cpu")
    t2.resume(tmp_path / "out" / "models" / "final_model.pt")
    for k in ("v_row", "v_col", "count"):
        assert torch.equal(t2.optimizer.table[k], table_state[k])
    assert torch.equal(t2.params["encoder"]["node_emb"],
                       saved["params"]["encoder"]["node_emb"])
    hist2 = t2.train()["history"]
    assert hist2["train_losses"][:2] == hist["train_losses"]
    assert len(hist2["train_losses"]) == 3
    assert int(t2.optimizer.table["count"]) == 3 * -(-len(edges) // 64)
