"""zero3 on a 2-D mesh whose processes hold parts of two tp rows: gloo
process groups on the CPU, at a small size, against the same runs on one
process and against the JAX package.

- (1) ``make_mesh_2d`` takes every process count that divides the shard
  count; ``table_slices`` gives each process the tp indices of its
  shards, and the slices counted across the processes cover the table
  once. A count that does not divide raises.
- (2) The (3, 2) mesh over 2 processes (each a whole row and half of the
  next) and the (2, 3) mesh over 3 (process 1 holds the end of row 0 and
  the start of row 1), 3 zero3 steps under both table rules (adam with
  clip 1.0 in block mode, the factored rule in uniform mode) against the
  one-process run: losses within rel 1e-5, parameters and optimizer state
  within rtol 2e-6, atol 2e-7, the generator's state equal. Each process's
  calls that launch B2 and B3 on the card, a step: n_tp fetch-backward
  sums and 2 dedup sums a shard, 2 window fetches a shard in block mode.
- (3) The step rebuilt after step 2 from the whole table and the gathered
  optimizer state (as ``--resume`` builds it) continues bit for bit; the
  optimizer state through the JAX checkpoint's tree and back is the same.
- (4) The zero3 step on each mesh against the JAX step on a 6-device CPU
  mesh, on the same parameters and draws, at the tolerance of
  tests/test_torch_port_sampled_dp.py.
- (5) ``train.cli --shard edge --sample_fanouts 15 10 --zero3 --dp_pods 2
  --n_devices 6 --val_sampled --distributed --num_processes 3`` (the
  sharded sampled validation too): one epoch writes its checkpoint;
  ``--resume`` for a second over the 3 processes agrees with the same
  resume in one process.

Workers are tests/port_dist_worker.py's ``mesh2d`` case, both groups at
once, each in a ``file://`` store of its own.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_dist_worker as worker
from primekg_rgcn_tpu.train import sampled as jsampled
from primekg_rgcn_tpu_torch.parallel import mesh as pmesh
from test_torch_port_distributed import WORKER, free_port, spawn
from test_torch_port_sampled_dp import (B, OPT, _adam_state, build_pair,
                                        jax_shard_draws)
from test_torch_port_sampled_train import E, _flat, _torch, assert_close

WORLDS = sorted(worker.MESH2D)
# The JAX comparison's table rule on each mesh.
JAX_RULE = {2: ("uniform", "adafactor"), 3: ("block", "sgd")}


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()


def jax_given(world):
    """Two JAX zero3 steps on this world's (n_dp, n_tp) mesh of 6 CPU
    devices, and what the port's workers need to replay them: (the JAX
    states after each step, the given dict)."""
    shape = worker.MESH2D[world]
    mode, rule = JAX_RULE[world]
    opt_kw = dict(OPT, grad_clip=0.0) if rule == "adafactor" else OPT
    state, jstep, to_full, step, pp, _, (edges, jg, jcfg) = build_pair(
        "zero3", shape, mode, opt_kw, table_opt=rule)
    csr, budgets, combined = jsampled.resolve_sampler(jg, (4, 3), "auto",
                                                      mode)
    rng = np.random.default_rng(2)
    key = jax.random.PRNGKey(7)
    steps, states = [], []
    for _ in range(2):
        pos = jnp.asarray(edges[rng.integers(0, E, B)])
        key, k = jax.random.split(key)
        state, (loss_j, acc_j) = jstep(state, pos, k)
        table = state.opt_state[1]
        # On the host now: the next step donates the state's buffers.
        table = ({k: np.asarray(table[k]) for k in ("v_row", "v_col")}
                 if rule == "adafactor" else
                 {"exp_avg": np.asarray(_adam_state(table).mu),
                  "exp_avg_sq": np.asarray(_adam_state(table).nu)})
        states.append((
            _flat(jax.tree_util.tree_map(np.asarray, state.params)),
            np.asarray(to_full(state.params["encoder"]["node_emb"])),
            table, float(loss_j), float(acc_j)))
        given = jax_shard_draws(jcfg, csr, budgets, combined, pos, k, 6,
                                mode)
        uniforms = [[jd(s) for s in step.sample.draw_shapes(
            2 * c[0].shape[0])[0]] for jd, c in zip(given["draw"],
                                                   given["cands"])]
        steps.append({"pos": _torch(pos, long=True), "cands": given["cands"],
                      "uniforms": uniforms, "masks": given["enc_mask"]})
    return states, {
        "edges": edges.astype(np.int64), "num_nodes": jcfg.num_nodes,
        "num_relations": jcfg.num_relations, "model_config": jcfg.to_dict(),
        "train_config": dict(batch_size=B, **opt_kw),
        "params": _detached(step.full_params(pp)), "steps": steps,
        "shape": shape, "mode": mode, "table_opt": rule}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: ([each process's mesh2d output], the JAX states)}."""
    base = tmp_path_factory.mktemp("mesh2d")
    states = {}
    for w in WORLDS:
        states[w], given = jax_given(w)
        (base / str(w)).mkdir()
        torch.save(given, base / str(w) / "given.pt")
    # Both groups at once.
    results = spawn([[sys.executable, str(WORKER), "mesh2d", str(r), str(w),
                      str(base / str(w))] for w in WORLDS for r in range(w)],
                    base / "logs")
    for rc, _, err in results:
        assert rc == 0, err[-3000:]
    return {w: ([torch.load(base / str(w) / f"mesh2d_{r}.pt",
                            weights_only=False) for r in range(w)],
                states[w]) for w in WORLDS}


# -- (1) the mesh -------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_mesh2d_processes_hold_parts_of_two_rows(runs, world):
    ranks, _ = runs[world]
    n_dp, n_tp = worker.MESH2D[world]
    k = n_dp * n_tp // world
    counted = []
    for r, got in enumerate(ranks):
        m = got["mesh"]
        assert m["local"] == list(range(r * k, (r + 1) * k))
        assert m["rows_split"]
        assert m["held"] == tuple(sorted({s % n_tp for s in m["local"]}))
        counted += [t for t, c in zip(m["held"], m["counted"]) if c]
    # Each slice is counted by one process.
    assert sorted(counted) == list(range(n_tp))
    # Some process holds parts of two rows.
    assert any(len({s // n_tp for s in g["mesh"]["local"]}) == 2
               and g["mesh"]["local"][0] % n_tp for g in ranks)


# (shape, world, held, counted, shared) by rank: whole rows, a part of one
# row, parts of two or more.
SLICES = [
    ((2, 3), 3, [((0, 1), (True, True)), ((0, 2), (False, True)),
                 ((1, 2), (False, False))], True),
    ((3, 2), 2, [((0, 1), (True, True)), ((0, 1), (False, False))], True),
    ((2, 2), 2, [((0, 1), (True, True)), ((0, 1), (False, False))], True),
    ((1, 4), 2, [((0, 1), (True, True)), ((2, 3), (True, True))], False),
    ((2, 2), 4, [((0,), (True,)), ((1,), (True,)), ((0,), (False,)),
                 ((1,), (False,))], True),
    ((4, 3), 6, [((0, 1), (True, True)), ((0, 2), (False, True)),
                 ((1, 2), (False, False)), ((0, 1), (False, False)),
                 ((0, 2), (False, False)), ((1, 2), (False, False))], True),
]


@pytest.mark.parametrize("shape,world,by_rank,shared", SLICES,
                         ids=lambda v: str(v) if isinstance(v, tuple) else
                         None)
def test_table_slices_count_each_slice_once(shape, world, by_rank, shared):
    n = shape[0] * shape[1]
    for rank, (held, counted) in enumerate(by_rank):
        mesh = pmesh.Mesh(n, torch.device("cpu"), shape[0], world, rank)
        sl = pmesh.table_slices(mesh, by_tp=True)
        assert (sl.held, sl.counted, sl.shared) == (held, counted, shared)
        assert mesh.rows_split == (n // world % shape[1] > 0)
        # zero1's slices are the shards themselves.
        z1 = pmesh.table_slices(mesh)
        assert z1.held == tuple(mesh.local) and all(z1.counted)


def test_a_process_count_that_does_not_divide_raises(monkeypatch):
    monkeypatch.setattr(pmesh, "process_group_size", lambda: (4, 1))
    with pytest.raises(ValueError, match="6 shards do not split over 4 "
                                         "processes"):
        pmesh.make_mesh_2d(2, 3, "cpu")
    monkeypatch.setattr(pmesh, "process_group_size", lambda: (3, 1))
    assert pmesh.make_mesh_2d(2, 3, "cpu").local == range(2, 4)


# -- (2, 3) the steps against one process, resumed ---------------------------

RUNS = [(w, name, mode, rule) for w in WORLDS
        for name, mode, rule in worker.MESH2D_RUNS]


@pytest.fixture(scope="module")
def solo():
    """The one-process runs, by (shape, rule name)."""
    return {}


def _solo(solo, world, name, mode, rule):
    key = (world, name)
    if key not in solo:
        solo[key] = worker.run_steps("zero3", worker.MESH2D[world], mode,
                                     rule, batch=worker.MESH2D_BATCH,
                                     slim=mode == "block")
    return solo[key]


@pytest.mark.parametrize("world,name,mode,rule", RUNS,
                         ids=[f"{w}proc-{n}" for w, n, *_ in RUNS])
def test_zero3_on_the_mesh_matches_one_process(runs, solo, world, name,
                                               mode, rule):
    ref = _solo(solo, world, name, mode, rule)
    for got in (g[name] for g in runs[world][0]):
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        for part in ("params", "opt"):
            assert got[part].keys() == ref[part].keys()
            for k, want in ref[part].items():
                np.testing.assert_allclose(
                    got[part][k].double().numpy(), want.double().numpy(),
                    rtol=2e-6, atol=2e-7, err_msg=f"{part}{k}")
        assert torch.equal(got["gen"], ref["gen"])


@pytest.mark.parametrize("world,name,mode,rule", RUNS,
                         ids=[f"{w}proc-{n}" for w, n, *_ in RUNS])
def test_zero3_on_the_mesh_launches_per_process(runs, solo, world, name,
                                                mode, rule):
    """The calls that launch B2 and B3 on the card, over 3 steps: n_tp
    fetch-backward sums and 2 dedup sums a shard, 2 window fetches a
    shard in block mode, half (a third) of one process's."""
    n_dp, n_tp = worker.MESH2D[world]
    n = n_dp * n_tp

    def want(k):
        return {"B2": 3 * (k * n_tp + 2 * k),
                "B3": 3 * 2 * k if mode == "block" else 0}

    assert _solo(solo, world, name, mode, rule)["launches"] == want(n)
    for g in runs[world][0]:
        assert g[name]["launches"] == want(n // world)
        assert int(g[name]["table_rows"]) == len(g["mesh"]["held"])
    if (world, mode) == (3, "block"):
        # 10 B2 and 4 B3 a process and step.
        assert want(2) == {"B2": 30, "B3": 12}


@pytest.mark.parametrize("world,name", [(w, n) for w, n, *_ in RUNS])
def test_zero3_on_the_mesh_resumes_bit_for_bit(runs, world, name):
    for g in runs[world][0]:
        got, want = g[f"{name}_resumed"], g[name]
        assert torch.equal(got["losses"], want["losses"])
        for part in ("params", "opt"):
            assert got[part].keys() == want[part].keys()
            for k, v in want[part].items():
                assert torch.equal(got[part][k], v), f"{part}{k}"
        # The optimizer state through the JAX checkpoint's tree and back.
        for k, v in want["opt"].items():
            assert torch.equal(want["opt_via_jax"][k], v), k


# -- (4) against the JAX step -------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_zero3_on_the_mesh_matches_the_jax_step(runs, world):
    ranks, states = runs[world]
    rule = JAX_RULE[world][1]
    for got in (g["given"] for g in ranks):
        for i, (theirs, table, opt, loss_j, acc_j) in enumerate(states):
            assert_close(got[i]["loss"], loss_j)
            assert got[i]["acc"] == pytest.approx(acc_j)
            ours = {k[1:]: v for k, v in got[i]["params"].items()}
            assert ours.keys() == theirs.keys()
            for k, want in theirs.items():
                assert_close(ours[k].numpy(),
                             table if k == "encoder/node_emb" else want)
            # The table's state, gathered from every process.
            prefix = "/table/" if rule == "adafactor" else \
                "/table/state/0/"
            for k, want in opt.items():
                assert_close(got[i]["opt"][prefix + k].numpy(), want)


# -- (5) the CLI over three processes, resumed ---------------------------------

CLI = [sys.executable, "-m", "primekg_rgcn_tpu_torch.train.cli",
       "--synthetic", "--synthetic_scale", "0.02", "--batch_size", "60",
       "--embedding_dim", "8", "--hidden_dim", "8", "--shard", "edge",
       "--sample_fanouts", "15", "10", "--zero3", "--dp_pods", "2",
       "--n_devices", "6", "--val_sampled", "--device", "cpu"]


def _group(out, epochs, extra=()):
    port = free_port()
    return [CLI + ["--epochs", str(epochs), "--output_dir", str(out),
                   "--distributed", "--coordinator_address",
                   f"localhost:{port}", "--num_processes", "3",
                   "--process_id", str(i), *extra] for i in range(3)]


def test_cli_zero3_over_three_processes_resumes(tmp_path):
    """One epoch over 3 processes writes the checkpoint (the whole table,
    the whole slices' state); resumed for a second epoch over 3 processes
    and in one process on the same 6-shard mesh, the two agree (the
    histories within rtol 1e-5, atol 1e-7, as the 2-process CLI test, and
    the table within rtol 2e-6, atol 2e-7). The sampled trainer seeds each
    run's epoch order with seed + its first epoch, as the JAX trainer does,
    so a resumed run's second epoch takes another order than a run of two
    epochs at once; the step itself resumes bit for bit
    (test_zero3_on_the_mesh_resumes_bit_for_bit)."""
    from primekg_rgcn_tpu_torch.train import checkpoint

    first, solo, mh = (tmp_path / d for d in ("first", "solo", "mh"))
    runs = spawn(_group(first, 1), tmp_path / "runs")
    resume = ["--resume", str(first / "models" / "final_model.pt")]
    runs += spawn(_group(mh, 2, resume) + [
        CLI + ["--epochs", "2", "--output_dir", str(solo), *resume]],
        tmp_path / "resume")
    for rc, _, err in runs:
        assert rc == 0, err[-3000:]
    saved = checkpoint.load(first / "models" / "final_model.pt")
    n_nodes = saved["model_config"]["num_nodes"]
    assert saved["params"]["encoder"]["node_emb"].shape == (n_nodes, 8)
    table = saved["optimizer_state_dict"]["table"]["state"][0]
    assert table["exp_avg"].shape == (3, -(-n_nodes // 3), 8)
    a, b = (checkpoint.load(d / "models" / "final_model.pt")
            for d in (mh, solo))
    assert a["epoch"] == b["epoch"] == 2
    for k in ("train_losses", "val_losses", "train_accs", "val_accs"):
        assert a["history"][k][0] == saved["history"][k][0]
        np.testing.assert_allclose(a["history"][k], b["history"][k],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(a["params"]["encoder"]["node_emb"].numpy(),
                               b["params"]["encoder"]["node_emb"].numpy(),
                               rtol=2e-6, atol=2e-7)
    # Process 1 and 2 write nothing.
    assert not (tmp_path / "mh1").exists()
