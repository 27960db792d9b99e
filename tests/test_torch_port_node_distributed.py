"""The node layout across processes (``--distributed --shard node``) and
zero3 on meshes whose tp rows span processes: gloo process groups on the
CPU, at a small size, held against the same runs on one process and
against the JAX package, as tests/test_torch_port_distributed.py holds
the edge layout.

- (1) The halo exchange of each process's shards (B4 on the pairs inside
  a process, its plain version here; an all-to-all between processes) at
  4 shards over 2 processes and 8 over 2 and 4, float32 and bf16, against
  the one-process plain exchange: recvs and the sends' gradients exactly.
- (2) The node encode on 2 processes at both ``uniform_caps``: each
  process's shards and the gathered table against one process within
  rtol 1e-6, and against the JAX encode on 4 host devices within rtol
  1e-4, atol 1e-5 (the JAX package's own sharded-vs-dense bounds).
- (3) One SGD update on 2 processes on the JAX step's candidates: loss
  within rel 1e-5, parameters within rtol 1e-4, atol 1e-6 (the bounds of
  test_torch_port_node_shard.py's one-process test); and three adam steps
  with dropout on the port's generator against one process: losses,
  parameters and optimizer state within rtol 2e-5, atol 2e-6, and the
  generators' states equal (every process draws every shard's numbers);
  one update on a graph whose second process has no halo edge, against
  one process (it still joins every exchange).
- (4) The sharded top-K, ranker and scorer on 2 processes against one
  process (indices and ranks equal) and the top-K against the JAX
  ``build_sharded_topk``.
- (5) ``train.cli --distributed --shard node`` on 2 processes against one
  process on the same 4-shard mesh: histories within rtol 1e-5, atol
  1e-7; process 1 writes no file.
- (6) zero3 on a (1, 4) mesh over 2 processes and on a (2, 2) mesh over 4
  (block/sgd and uniform/adafactor) against one process, within rtol
  2e-5, atol 2e-6.

The graph of (2, 3) is tests/test_node_shard.py's (96 nodes, 3
relations, widths 8); workers are tests/port_dist_worker.py's cases
"node" (2 processes) and "node4" (4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import port_dist_worker as worker
from primekg_rgcn_tpu.config import TrainConfig as JTrainConfig
from primekg_rgcn_tpu.evaluate.sharded_ranking import \
    build_sharded_topk as j_topk
from primekg_rgcn_tpu.parallel import node_shard as jns
from primekg_rgcn_tpu.parallel.mesh import make_mesh as j_mesh
from primekg_rgcn_tpu.train import neg_sampling as jneg
from primekg_rgcn_tpu.train.loop import TrainState
from test_torch_port_distributed import (CLI, free_port, run_workers,
                                         spawn)
from test_torch_port_node_shard import _flat, _port_params, _setup

N_DEV, B, LR = 4, 64, 1e-2


def _given():
    """What the workers and the one-process run share: the graph, the JAX
    parameters, the JAX step's candidates and loss after one SGD update,
    its encodes, and a table for the top-K (with the JAX top-K)."""
    rng = np.random.default_rng(0)
    n, r, e = 96, 3, 900
    src, dst, rel = (rng.integers(0, m, e) for m in (n, n, r))
    jg, _, jcfg, jparams = _setup()
    encodes = {u: np.asarray(jns.build_node_sharded_forward(
        j_mesh(N_DEV), jns.partition_nodes(jg, N_DEV, uniform_caps=u), jcfg,
        gather=False)(jparams)) for u in (False, True)}

    opt = optax.sgd(LR)
    j_step = jns.build_node_sharded_train_step(
        j_mesh(N_DEV), jns.partition_nodes(jg, N_DEV), jcfg,
        JTrainConfig(batch_size=B, lr=LR), opt)
    brng = np.random.default_rng(0)
    batch = np.stack([brng.integers(0, n, B), brng.integers(0, n, B),
                      brng.integers(0, r, B), np.ones(B, np.int64)],
                     axis=1).astype(np.int32)
    key = jax.random.PRNGKey(7)
    p0 = jax.tree_util.tree_map(jnp.copy, jparams)
    state, (loss_j, acc_j) = j_step(
        TrainState(p0, opt.init(p0), jnp.zeros((), jnp.int32)),
        jnp.asarray(batch), key)
    # Each shard's candidates: the negative key folded with the shard.
    k_neg, _ = jax.random.split(key)
    b_loc = B // N_DEV
    cands = []
    for d in range(N_DEV):
        sl = jnp.asarray(batch[d * b_loc:(d + 1) * b_loc])
        c = jneg.candidate_batch(jax.random.fold_in(k_neg, d), sl[:, 0],
                                 sl[:, 1], sl[:, 2], n, 1, mask=sl[:, 3])
        h, t, rr, y, w = (torch.from_numpy(np.array(x)) for x in c)
        cands.append((h.long(), t.long(), rr.long(), y, w))

    n_loc, d, k = 40, 16, 10
    num_nodes = N_DEV * n_loc - 7        # the last shard holds padding rows
    trng = np.random.default_rng(4)
    emb = trng.normal(size=(N_DEV, n_loc, d)).astype(np.float32)
    rel_emb = trng.normal(size=(3, d)).astype(np.float32)
    heads, rels, tails = (trng.integers(0, m, 12)
                          for m in (num_nodes, 3, num_nodes))
    topk_j = [np.asarray(a) for a in j_topk(
        j_mesh(N_DEV), jnp.asarray(emb), rel_emb, num_nodes, k)(heads, rels)]
    given = {
        "edges": np.stack([src, dst, rel], 1).astype(np.int64),
        "num_nodes": n, "num_relations": r,
        "model_config": jcfg.to_dict(), "params": _port_params(jparams),
        "cands": cands,
        "topk": {"emb": torch.from_numpy(emb),
                 "rel": torch.from_numpy(rel_emb), "num_nodes": num_nodes,
                 "k": k, "heads": torch.from_numpy(heads),
                 "rels": torch.from_numpy(rels),
                 "tails": torch.from_numpy(tails)}}
    jax_side = {"encodes": encodes, "loss": float(loss_j),
                "acc": float(acc_j), "params": _flat(state.params),
                "topk": topk_j}
    return given, jax_side


@pytest.fixture(scope="module")
def node_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("node")
    given, jax_side = _given()
    torch.save(given, d / "given.pt")
    ranks = run_workers("node", d)
    return ranks, worker.run_node(given), jax_side


@pytest.fixture(scope="module")
def node4_runs(tmp_path_factory):
    return run_workers("node4", tmp_path_factory.mktemp("node4"), world=4)


def _both(node_runs, node4_runs, world):
    return node_runs[0] if world == 2 else node4_runs


def assert_all_close(got, want, rtol, atol):
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].double().numpy(),
                                   w.double().numpy(), rtol=rtol, atol=atol,
                                   err_msg=k)


# -- (1) the exchange ---------------------------------------------------------


@pytest.mark.parametrize("dtype", list(worker.DTYPES))
@pytest.mark.parametrize("n,world", worker.EXCHANGES,
                         ids=lambda v: str(v))
def test_exchange_across_processes_equals_the_plain_one(
        node_runs, node4_runs, n, world, dtype):
    solo = worker.run_exchange(n, worker.DTYPES[dtype])
    k = n // world
    for r, got in enumerate(_both(node_runs, node4_runs, world)):
        got = got[f"exchange_{n}_{dtype}"]
        own = slice(r * k, (r + 1) * k)
        assert got["recv"].dtype == worker.DTYPES[dtype]
        assert torch.equal(got["recv"], solo["recv"][own])
        assert torch.equal(got["grad"], solo["grad"][own])


# -- (2) the encode -----------------------------------------------------------


@pytest.mark.parametrize("uniform", [False, True])
def test_node_encode_on_two_processes(node_runs, uniform):
    ranks, solo, jax_side = node_runs
    key = f"encode_{uniform}"
    whole = torch.cat([g[key] for g in ranks])
    assert [g[key].shape[0] for g in ranks] == [2, 2]
    np.testing.assert_allclose(whole.numpy(), solo[key].numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(whole.numpy(), jax_side["encodes"][uniform],
                               rtol=1e-4, atol=1e-5)
    for g in ranks:
        # gather=True: the whole table on every process.
        assert torch.equal(g[f"gathered_{uniform}"],
                           whole.reshape(-1, whole.shape[-1])[:96])


# -- (3) the update and the steps ---------------------------------------------


def test_one_sgd_update_on_two_processes_matches_the_jax_step(node_runs):
    ranks, solo, jax_side = node_runs
    for g in ranks:
        stats = g["update"]["stats"]
        assert stats[2].item() == 2 * B
        assert stats[0].item() / stats[2].item() == pytest.approx(
            jax_side["loss"], rel=1e-5)
        assert stats[1].item() / stats[2].item() == pytest.approx(
            jax_side["acc"])
        ours = {k[1:]: v for k, v in g["update"]["params"].items()}
        assert ours.keys() == jax_side["params"].keys()
        for k, want in jax_side["params"].items():
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        assert_all_close(g["update"]["params"], solo["update"]["params"],
                         rtol=2e-5, atol=2e-6)


def test_node_steps_on_two_processes_match_one(node_runs):
    ranks, solo, _ = node_runs
    for g in ranks:
        got, want = g["steps"], solo["steps"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        for part in ("params", "opt"):
            assert_all_close(got[part], want[part], rtol=2e-5, atol=2e-6)
        assert torch.equal(got["gen"], want["gen"])


def test_a_process_without_halo_edges_joins_every_exchange(node_runs):
    """The second process's shards have no halo edge: its layers add a
    zero term of the exchange's recvs, so that it joins the exchange's
    backward, and the update matches one process's."""
    ranks, solo, _ = node_runs
    assert solo["no_halo_shards"] == [2, 3]
    for g in ranks:
        assert torch.equal(g["update"]["stats"][2], solo["update"]["stats"][2])
        assert_all_close(g["no_halo"]["params"], solo["no_halo"]["params"],
                         rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(g["no_halo"]["stats"].numpy(),
                                   solo["no_halo"]["stats"].numpy(),
                                   rtol=1e-6)


# -- (4) the sharded ranking --------------------------------------------------


def test_sharded_topk_and_ranks_on_two_processes(node_runs):
    ranks, solo, jax_side = node_runs
    s_j, i_j = jax_side["topk"]
    untied = np.ones_like(s_j, bool)
    untied[:, 1:] &= np.diff(s_j, axis=1) != 0
    untied[:, :-1] &= np.diff(s_j, axis=1) != 0
    for g in ranks:
        got, want = g["topk"], solo["topk"]
        assert torch.equal(got["ids"], want["ids"])
        np.testing.assert_allclose(got["scores"].numpy(),
                                   want["scores"].numpy(), rtol=1e-6)
        np.testing.assert_allclose(got["scores"].numpy(), s_j, rtol=1e-5)
        np.testing.assert_array_equal(got["ids"].numpy()[untied],
                                      i_j[untied])
        for k in ("rank", "ranker"):
            assert torch.equal(got[k], want[k]), k
        assert torch.equal(got["rank"], got["ranker"])
        np.testing.assert_allclose(got["score"].numpy(),
                                   want["score"].numpy(), rtol=1e-6)


# -- (5) the CLI --------------------------------------------------------------


def test_distributed_node_cli_matches_one_process(tmp_path):
    port = free_port()
    layout = ["--shard", "node"]
    runs = spawn([CLI + layout + ["--output_dir", str(tmp_path / "solo")]] + [
        CLI + layout + [
            "--distributed", "--coordinator_address", f"localhost:{port}",
            "--num_processes", "2", "--process_id", str(i),
            "--output_dir", str(tmp_path / f"mh{i}")] for i in range(2)],
        tmp_path / "runs")
    for rc, _, err in runs:
        assert rc == 0, err[-3000:]
    a, b = (torch.load(tmp_path / d / "models" / "final_model.pt",
                       weights_only=False) for d in ("mh0", "solo"))
    for k in ("train_losses", "val_losses", "train_accs", "val_accs"):
        np.testing.assert_allclose(a["history"][k], b["history"][k],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert "node layout over 4 shards" in runs[1][1]
    assert "backend gloo, process 0 of 2 on cpu" in runs[1][1]
    assert not (tmp_path / "mh1").exists()
    assert (tmp_path / "mh0" / "metrics.jsonl").exists()


# -- (6) zero3 on split rows --------------------------------------------------


@pytest.mark.parametrize("world,run", [
    (w, run) for w, runs in worker.SPLIT_RUNS.items() for run in runs],
    ids=lambda v: v[0] if isinstance(v, tuple) else str(v))
def test_zero3_on_split_rows_matches_one_process(node_runs, node4_runs,
                                                 world, run):
    name, *spec = run
    solo = worker.run_steps(*spec)
    k = 4 // world
    for got in (g[name] for g in _both(node_runs, node4_runs, world)):
        np.testing.assert_allclose(got["losses"], solo["losses"], rtol=1e-6)
        for part in ("params", "opt"):
            assert_all_close(got[part], solo[part], rtol=2e-5, atol=2e-6)
        assert torch.equal(got["gen"], solo["gen"])
        # Each process holds the slices of its own shards only.
        assert int(got["table_rows"]) == k
