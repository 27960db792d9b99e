"""The port across processes (``--distributed``): gloo process groups on the
CPU, at a small size, held against the same runs on one process, and the
zero3 step against the JAX package, as tests/test_multihost.py drills the
JAX package.

- (1) The mesh collectives and their autograd forms at 2 processes
  (``tests/port_dist_worker.py``) against the one-process mesh, output
  and gradient, exactly (integer inputs); ``all_reduce_``,
  ``check_same_across``, the 2-D meshes' groups and zero3 table slices
  (whole rows a process, a row split over processes, and a process with
  parts of two rows) and the mesh that raises.
- (2) The 2-process zero3 block step against the JAX one-process 4-device
  ``build_sampled_train_step_zero3`` for two steps on the same parameters
  and draws (the JAX candidates, sampler uniforms and masks handed over),
  at rtol 2e-4, atol 2e-5 times each tensor's largest magnitude; each
  process's table holds its own two slices.
- (3) ``scripts/port_multihost_drill.py`` on 2 processes against its solo
  run: loss rel 1e-5, table rtol 2e-6, atol 2e-7; its checkpoint holds the
  whole table.
- (4) ``train.cli --distributed`` on 2 processes against one process on
  the same 4-shard mesh (``--shard edge``, and zero3 with
  ``--val_sampled``): histories within rtol 1e-5, atol 1e-7; process 1
  writes no file.
- (5) dp, zero1, zero3 (also on a (2, 2) mesh with adafactor) and the edge
  step with accumulation, on the port's own generator, 2 processes
  against one: losses, parameters and optimizer state within rtol 2e-5,
  atol 2e-6, and the generator's state equal (every process draws every
  shard's numbers).
- (6) ``--num_processes 2`` with no peer raises within its rendezvous
  timeout; (7) any layout without a mesh raises under 2 processes (the
  node layout across processes is tests/test_torch_port_node_distributed.
  py's).

Every child has its own timeout and every sibling is killed in
``finally``; workers meet in ``file://`` stores, the CLI and the drill at
a port from a socket bound to port 0.
"""

import os
import socket
import subprocess
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
from test_torch_port_sampled_dp import (B, OPT, _adam_state, build_pair,
                                        jax_shard_draws)
from test_torch_port_sampled_train import (E, _flat, _torch, assert_close)

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(worker.__file__)
DRILL = REPO / "scripts" / "port_multihost_drill.py"
TIMEOUT = 120
ENV = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(argvs, cwd, timeout=TIMEOUT, env=None):
    """Run every argv at once, each with stdout and stderr in a file under
    ``cwd``; wait for each within ``timeout``, kill any still alive in
    ``finally``. Returns [(returncode, stdout, stderr)]."""
    cwd = Path(cwd)
    cwd.mkdir(parents=True, exist_ok=True)
    procs, logs = [], []
    try:
        for i, argv in enumerate(argvs):
            out = open(cwd / f"out{i}.txt", "w")
            err = open(cwd / f"err{i}.txt", "w")
            logs += [out, err]
            procs.append(subprocess.Popen(argv, cwd=cwd, env=env or ENV,
                                          stdout=out, stderr=err))
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    return [(p.returncode, (cwd / f"out{i}.txt").read_text(),
             (cwd / f"err{i}.txt").read_text()) for i, p in enumerate(procs)]


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()


def run_workers(case, d, world=2):
    results = spawn([[sys.executable, str(WORKER), case, str(r), str(world),
                      str(d)] for r in range(world)], d)
    for rc, _, err in results:
        assert rc == 0, err[-3000:]
    return [torch.load(Path(d) / f"{case}_{r}.pt", weights_only=False)
            for r in range(world)]


# -- (1) the collectives ------------------------------------------------------


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    ranks = run_workers("collectives", tmp_path_factory.mktemp("coll"))
    return ranks, worker.run_collectives(pmesh.make_mesh(4, "cpu"))


@pytest.mark.parametrize("name", ["psum", "all_gather", "all_gather_tiled",
                                  "psum_scatter"])
def test_collective_and_its_gradient_match_the_one_process_mesh(
        collectives, name):
    ranks, solo = collectives
    for r, got in enumerate(ranks):
        local = got["local"].tolist()
        assert local == [2 * r, 2 * r + 1]
        want = solo[name][local] if name == "psum_scatter" else solo[name]
        assert torch.equal(got[name], want)
        assert torch.equal(got[f"{name}_grad"], solo[f"{name}_grad"][local])


def test_all_reduce_check_and_process_meshes(collectives):
    ranks, _ = collectives
    want = torch.cat([torch.full((6,), 3.0), torch.arange(4.0) * 3])
    for r, got in enumerate(ranks):
        assert torch.equal(got["all_reduce_"], want)
        assert bool(got["differing_raises"])
        # (rows split, zero3's slices held, counted, shared). Whole rows a
        # process on (2, 2): each holds the whole table, process 0 counts
        # it, and the replicas are summed across the processes. (1, 4)
        # splits its row: this process holds tp indices 2r, 2r + 1, no
        # other holds them. (3, 2): a whole row and half of the next. 3
        # shards over 2 processes raise.
        mine = (True, True) if r == 0 else (False, False)
        assert got["groups_2x2"] == [[2 * r, 2 * r + 1]]
        assert got["axes_2x2"] == [False, (0, 1), mine, True]
        assert got["groups_1x4"] == [[2 * r, 2 * r + 1]]
        assert got["axes_1x4"] == [True, (2 * r, 2 * r + 1), (True, True),
                                   False]
        assert got["groups_3x2"] == ([[0, 1], [2]] if r == 0
                                     else [[3], [4, 5]])
        assert got["axes_3x2"] == [True, (0, 1), mine, True]
        assert bool(got["odd_shards"])


# -- (2) zero3 across processes against the JAX step --------------------------


def test_two_process_zero3_matches_the_jax_step(tmp_path):
    state, jstep, to_full, step, pp, _, (edges, jg, jcfg) = build_pair(
        "zero3", 4, "block", OPT)
    csr, budgets, combined = jsampled.resolve_sampler(jg, (4, 3), "auto",
                                                      "block")
    rng = np.random.default_rng(2)
    key = jax.random.PRNGKey(7)
    steps, states = [], []
    for _ in range(2):
        pos = jnp.asarray(edges[rng.integers(0, E, B)])
        key, k = jax.random.split(key)
        state, (loss_j, acc_j) = jstep(state, pos, k)
        # On the host now: the next step donates the state's buffers.
        emb_adam = _adam_state(state.opt_state[1])
        states.append((
            _flat(jax.tree_util.tree_map(np.asarray, state.params)),
            np.asarray(to_full(state.params["encoder"]["node_emb"])),
            np.asarray(emb_adam.mu), np.asarray(emb_adam.nu),
            float(loss_j), float(acc_j)))
        given = jax_shard_draws(jcfg, csr, budgets, combined, pos, k, 4,
                                "block")
        # The JAX sampler's uniforms, drawn now in the port's draw order.
        uniforms = [[jd(shape) for shape in
                     step.sample.draw_shapes(2 * c[0].shape[0])[0]]
                    for jd, c in zip(given["draw"], given["cands"])]
        steps.append({"pos": _torch(pos, long=True), "cands": given["cands"],
                      "uniforms": uniforms, "masks": given["enc_mask"]})
    params = step.full_params(pp)
    torch.save({"edges": edges.astype(np.int64), "num_nodes": jcfg.num_nodes,
                "num_relations": jcfg.num_relations,
                "model_config": jcfg.to_dict(),
                "train_config": dict(batch_size=B, **OPT),
                "params": _detached(params),
                "steps": steps}, tmp_path / "given.pt")
    ranks = run_workers("given", tmp_path)
    for got in ranks:
        assert int(got["table_rows"]) == 2     # its own 2 of 4 slices
        for i, (theirs, table, mu, nu, loss_j, acc_j) in enumerate(states):
            assert_close(got[i]["loss"], loss_j)
            assert got[i]["acc"] == pytest.approx(acc_j)
            ours = {k[1:]: v for k, v in got[i]["params"].items()}
            assert ours.keys() == theirs.keys()
            for k, want in theirs.items():
                assert_close(ours[k].numpy(),
                             table if k == "encoder/node_emb" else want)
            # The table's adam moments, gathered from both processes.
            assert_close(got[i]["opt"]["/table/state/0/exp_avg"].numpy(), mu)
            assert_close(got[i]["opt"]["/table/state/0/exp_avg_sq"].numpy(),
                         nu)


# -- (3) the drill ------------------------------------------------------------


def test_drill_two_processes_match_its_solo_run(tmp_path):
    env = {**ENV, "DRILL_COORD": f"localhost:{free_port()}"}
    # The solo run and the two processes at once.
    runs = spawn([[sys.executable, str(DRILL), role, world, str(tmp_path),
                   "--device", "cpu"]
                  for role, world in (("solo", "1"), ("0", "2"), ("1", "2"))],
                 tmp_path / "runs", env=env)
    for rc, out, err in runs:
        assert rc == 0, err[-3000:]
        assert "ckpt=ok" in out
    ref = np.load(tmp_path / "drill_p0_solo.npz")
    mh0 = np.load(tmp_path / "drill_p0_mh.npz")
    mh1 = np.load(tmp_path / "drill_p1_mh.npz")
    assert float(ref["loss"]) == pytest.approx(float(mh0["loss"]), rel=1e-5)
    assert float(mh1["loss"]) == float(mh0["loss"])
    assert sorted(mh0.files) == ["0", "1", "loss"]
    for k, got in (("0", mh0), ("1", mh0), ("2", mh1), ("3", mh1)):
        np.testing.assert_allclose(ref[k], got[k], rtol=2e-6, atol=2e-7)
    # Process 0's checkpoint holds the whole table, every slice's rows.
    from primekg_rgcn_tpu_torch.train import checkpoint

    table = checkpoint.load(tmp_path / "ck_mh.pt")["params"]["encoder"][
        "node_emb"].numpy()
    n_loc = ref["0"].shape[0]
    for k, got in (("0", mh0), ("1", mh0), ("2", mh1), ("3", mh1)):
        rows = table[int(k) * n_loc:(int(k) + 1) * n_loc]
        np.testing.assert_array_equal(rows, got[k][:len(rows)])
    assert table.shape == (80, 8)


# -- (4) the CLI --------------------------------------------------------------

CLI = [sys.executable, "-m", "primekg_rgcn_tpu_torch.train.cli",
       "--synthetic", "--synthetic_scale", "0.02", "--epochs", "2",
       "--batch_size", "64", "--embedding_dim", "8", "--hidden_dim", "8",
       "--n_devices", "4", "--device", "cpu"]


@pytest.mark.parametrize("layout", [
    ["--shard", "edge"],
    ["--shard", "edge", "--sample_fanouts", "4", "3", "--zero3",
     "--val_sampled"],
], ids=["edge", "zero3_val_sampled"])
def test_distributed_cli_matches_one_process(tmp_path, layout):
    port = free_port()
    # The one-process run and the two processes at once.
    runs = spawn([CLI + layout + ["--output_dir", str(tmp_path / "solo")]] + [
        CLI + layout + [
            "--distributed", "--coordinator_address", f"localhost:{port}",
            "--num_processes", "2", "--process_id", str(i),
            "--output_dir", str(tmp_path / f"mh{i}")] for i in range(2)],
        tmp_path / "runs")
    for rc, _, err in runs:
        assert rc == 0, err[-3000:]
    a = torch.load(tmp_path / "mh0" / "models" / "final_model.pt",
                   weights_only=False)
    b = torch.load(tmp_path / "solo" / "models" / "final_model.pt",
                   weights_only=False)
    for k in ("train_losses", "val_losses", "train_accs", "val_accs"):
        np.testing.assert_allclose(a["history"][k], b["history"][k],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert "backend gloo, process 0 of 2 on cpu" in runs[1][1]
    # Process 1 writes nothing: no final_model.pt, metrics.jsonl,
    # training.log or synthetic splits.
    assert not (tmp_path / "mh1").exists()
    assert (tmp_path / "mh0" / "metrics.jsonl").exists()
    assert (tmp_path / "mh0" / "training.log").exists()


# -- (5) the steps on the port's own generator --------------------------------


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    return run_workers("steps", tmp_path_factory.mktemp("steps"))


@pytest.mark.parametrize("run", worker.STEP_RUNS, ids=lambda r: r[0])
def test_step_on_two_processes_matches_one(step_runs, run):
    name, *spec = run
    solo = worker.run_steps(*spec)
    for got in (r[name] for r in step_runs):
        np.testing.assert_allclose(got["losses"], solo["losses"], rtol=1e-6)
        for part in ("params", "opt"):
            assert got[part].keys() == solo[part].keys()
            for k, want in solo[part].items():
                np.testing.assert_allclose(
                    got[part][k].double().numpy(),
                    want.double().numpy(), rtol=2e-5, atol=2e-6,
                    err_msg=f"{part}{k}")
        assert torch.equal(got["gen"], solo["gen"])
    if name.startswith("zero3") and spec[1] == 4:
        # Each process's table holds only its own slices.
        assert [int(r[name]["table_rows"]) for r in step_runs] == [2, 2]


# -- (6, 7) what raises -------------------------------------------------------

_NO_PEER = r"""
import sys
from primekg_rgcn_tpu_torch.train import cli, multichip
multichip.DIST_TIMEOUT_S = 1
cli.main(sys.argv[1:])
"""


def test_two_processes_without_a_peer_raise(tmp_path):
    res = spawn([[sys.executable, "-c", _NO_PEER] + CLI[3:] + [
        "--shard", "edge", "--distributed", "--coordinator_address",
        f"localhost:{free_port()}", "--num_processes", "2", "--process_id",
        "0", "--output_dir", str(tmp_path / "out")]], tmp_path, timeout=60)
    rc, _, err = res[0]
    assert rc != 0
    assert "did not yield a multi-process runtime" in err


@pytest.mark.parametrize("extra,match", [
    ([], "each process would otherwise train alone"),
    (["--sample_fanouts", "4", "3"], "each process would otherwise train"),
    (["--shard", "node", "--sample_fanouts", "4", "3"], None),
    (["--shard", "edge"], None),
    (["--shard", "node"], None),
], ids=["one_device", "one_device_sampled", "sampled_node", "edge", "node"])
def test_which_layouts_train_across_processes(extra, match):
    """The rule the CLI applies once the group is up: a layout without a
    mesh would train alone in each process; either --shard trains, with
    or without --sample_fanouts."""
    from primekg_rgcn_tpu_torch.train import cli

    args = cli.parse_args(["--device", "cpu"] + extra)
    cli._check_across_processes(args, 1)
    if match is None:
        cli._check_across_processes(args, 2)
    else:
        with pytest.raises(ValueError, match=match):
            cli._check_across_processes(args, 2)
