"""JAX checkpoints in the port (``train/checkpoint.py``): files written by
the JAX package's own ``checkpoint.save`` for every trainer layout, read by
the port's ``load`` and resumed; the port's ``save_jax`` read by the JAX
package; serving, evaluation and analysis of a JAX checkpoint; the port's
``torch_interop`` CLI against the JAX one; the refusals.

- Each layout's JAX state is taken one update past its initial state (so
  that every moment and count is nonzero), saved as the JAX trainer saves
  it, then loaded by the port in one of the three path forms (the stem,
  ``.msgpack``, ``.json``): parameters, adam ``mu``/``nu``/``count``, the
  factored table statistics and the history cache exactly, by path.
- Resume parity: from that state one more JAX step and one port step on the
  same batch, negatives and sampler draws, with dropout off, give
  parameters and optimizer state within rtol 2e-4, atol 2e-5 times each
  tensor's largest magnitude (tests/test_torch_parity.py's tolerances;
  bf16 layers 2e-2, as tests/test_torch_port_bf16_*.py).
- ``save_jax`` of a trainer resumed from a JAX file writes that file's
  ``.msgpack`` byte for byte (adam layouts, whose count is the step), and
  the JAX ``checkpoint.load`` reads what it writes after a port step.

Layouts: the full-graph ``Trainer`` (adam, adam with weight decay, adamw,
sgd; each with and without a clip), the edge and node ``ShardedTrainer``
(2 shards), the one-device ``SampledTrainer`` (dense adam, ``sparse_emb``
with the sgd and the adafactor table rules, ``cache_layer1`` at float32
and, over adafactor, at bf16), zero1 and zero3 at 2 shards (the JAX side
on the conftest's host devices), and zero3 across 2 gloo processes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import port_dist_worker as worker
from primekg_rgcn_tpu.config import ModelConfig as JModelConfig
from primekg_rgcn_tpu.config import TrainConfig as JTrainConfig
from primekg_rgcn_tpu.data import artifacts as jart
from primekg_rgcn_tpu.data import synthetic as jsyn
from primekg_rgcn_tpu.models.rgcn import init_params as j_init
from primekg_rgcn_tpu.ops.rgcn_segment import rgcn_layer_segment as j_layer
from primekg_rgcn_tpu.parallel.mesh import make_mesh as j_mesh
from primekg_rgcn_tpu.train import checkpoint as jckpt
from primekg_rgcn_tpu.train import loop as jloop
from primekg_rgcn_tpu.train import multichip as jmulti
from primekg_rgcn_tpu.train import neg_sampling as jneg
from primekg_rgcn_tpu.train import sampled as jsampled
from primekg_rgcn_tpu.train import torch_interop as j_interop
from primekg_rgcn_tpu_torch.analyze.core import AnalysisContext
from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.evaluate import cli as p_eval_cli
from primekg_rgcn_tpu_torch.evaluate import predict_cli as p_predict
from primekg_rgcn_tpu_torch.train import checkpoint as pckpt
from primekg_rgcn_tpu_torch.train import cli as p_train_cli
from primekg_rgcn_tpu_torch.train import loop as ploop
from primekg_rgcn_tpu_torch.train import sampled as psampled
from primekg_rgcn_tpu_torch.train import torch_interop as p_interop
from primekg_rgcn_tpu_torch.train.multichip import ShardedTrainer
from test_torch_port_cache_layer1 import _jax_cached_batch
from test_torch_port_distributed import run_workers
from test_torch_port_sampled_dp import _compare_opt_state, jax_shard_draws
from test_torch_port_sampled_train import (JaxDraws, _flat, _jax_batch,
                                           _setup, _torch)
from test_torch_port_train_loop import _dataset

FORMS = ("stem", ".msgpack", ".json")
B = 24


def assert_close(ours, expected, bf16=False):
    ours = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) \
        else np.asarray(ours)
    expected = np.asarray(expected, dtype=np.float64)
    scale = max(float(np.abs(expected).max()), 1e-30)
    tol = (2e-2, 2e-2) if bf16 else (2e-4, 2e-5)
    np.testing.assert_allclose(ours, expected, rtol=tol[0],
                               atol=tol[1] * scale)


def _host(tree):
    """A JAX tree's leaves on the host (before a donating step)."""
    return jax.tree_util.tree_map(np.array, tree)


def _exact(ours, theirs, where=""):
    theirs = np.asarray(theirs)
    if theirs.dtype.name == "bfloat16":
        assert ours.dtype == torch.bfloat16, where
        ours, theirs = ours.float(), theirs.astype(np.float32)
    np.testing.assert_array_equal(ours.detach().cpu().numpy(), theirs,
                                  err_msg=where)


def _form(stem, i):
    form = FORMS[i % len(FORMS)]
    return stem if form == "stem" else stem.with_suffix(form)


def _adam(tree):
    return pckpt._adam_of(jax.tree_util.tree_map(
        np.asarray, serialization.to_state_dict(tree)))


def _check_adam_moments(opt, params, adam):
    """The torch optimizer's per-leaf state equals ``adam`` (the JAX
    ``ScaleByAdamState`` as a state dict) exactly, leaf by leaf, by
    path."""
    paths = pckpt._param_paths(params)
    for p in pckpt._live(opt):
        path = paths[id(p)]
        st = opt.state[p]
        where = "/".join(path)
        _exact(st["exp_avg"], pckpt._at(adam["mu"], path), where)
        _exact(st["exp_avg_sq"], pckpt._at(adam["nu"], path), where)
        assert float(st["step"]) == float(np.asarray(adam["count"])), where


def _close_adam_moments(opt, params, adam, bf16=False):
    paths = pckpt._param_paths(params)
    for p in pckpt._live(opt):
        path = paths[id(p)]
        st = opt.state[p]
        assert_close(st["exp_avg"], pckpt._at(adam["mu"], path), bf16)
        assert_close(st["exp_avg_sq"], pckpt._at(adam["nu"], path), bf16)
        assert float(st["step"]) == float(np.asarray(adam["count"]))


def _check_params(params, theirs, close=False, bf16=False):
    ours = _flat(params)
    theirs = _flat(_host(theirs))
    assert ours.keys() == theirs.keys()
    for k, want in theirs.items():
        if close:
            assert_close(ours[k], want, bf16)
        else:
            _exact(ours[k], want, k)


def _meta(stem):
    return json.loads(stem.with_suffix(".json").read_text())


# -- the full-graph Trainer --------------------------------------------------

N_FULL = 60
FULL_CASES = [(opt, wd, clip) for opt, wd in [("adam", 0.0), ("adam", 0.01),
                                              ("adamw", 0.01), ("sgd", 0.01)]
              for clip in (1.0, 0.0)]


@pytest.fixture(scope="module")
def full_data():
    edges, jg, pg = _dataset(3, "dense", n=N_FULL)
    jcfg = JModelConfig(num_nodes=N_FULL, num_relations=3, embedding_dim=8,
                        hidden_dim=16, dropout=0.0, decoder_dropout=0.0)
    e = edges.shape[0]
    edges_pad = jnp.asarray(np.concatenate([edges, np.zeros((1, 3),
                                                            np.int32)]))
    loss_cfg = JTrainConfig(batch_size=64)
    grad = jax.jit(jax.grad(lambda p, bi, key: jloop._batch_loss(
        p, jg, edges_pad, bi, key, jcfg, loss_cfg, train=True,
        layer_fn=j_layer)[0]))
    rng = np.random.default_rng(5)
    batches = [jnp.asarray(rng.integers(0, e, 64).astype(np.int32))
               for _ in range(2)]
    keys = [jax.random.PRNGKey(11), jax.random.PRNGKey(12)]

    def cands(bi, key):
        """The negatives ``_batch_loss`` draws from ``key``, for the
        port."""
        k_neg, _ = jax.random.split(key)
        batch = np.asarray(edges_pad)[np.asarray(bi)]
        c = jneg.candidate_batch(
            k_neg, jnp.asarray(batch[:, 0]), jnp.asarray(batch[:, 1]),
            jnp.asarray(batch[:, 2]), N_FULL, 1,
            mask=jnp.asarray(np.asarray(bi) < e))
        return tuple(_torch(a, long=i < 3) for i, a in enumerate(c))

    return dict(edges=edges, jg=jg, pg=pg, jcfg=jcfg, grad=grad,
                batches=batches, keys=keys, cands=cands)


def _jax_update(optimizer, state, grads):
    updates, opt_state = optimizer.update(grads, state.opt_state,
                                          state.params)
    return jloop.TrainState(optax.apply_updates(state.params, updates),
                            opt_state, state.step + 1)


@pytest.fixture(scope="module", params=FULL_CASES,
                ids=[f"{o}-wd{w}-clip{c}" for o, w, c in FULL_CASES])
def full_case(request, full_data, tmp_path_factory):
    """A JAX Trainer one update in, saved by its own ``save_checkpoint``;
    and the state one more update on."""
    opt, wd, clip = request.param
    d = full_data
    jt = JTrainConfig(batch_size=64, lr=0.01, optimizer=opt,
                      weight_decay=wd, grad_clip=clip, epochs=3, seed=4)
    out = tmp_path_factory.mktemp("full")
    trainer = jloop.Trainer(d["jcfg"], jt, d["jg"], d["jg"], d["edges"],
                            d["edges"][:50], out / "jax")
    state1 = _jax_update(trainer.optimizer, trainer.state, d["grad"](
        trainer.state.params, d["batches"][0], d["keys"][0]))
    trainer.state, trainer.epoch = state1, 1
    trainer.best_val_loss, trainer.best_val_acc = 0.625, 0.75
    for k, v in (("train_losses", 0.7), ("val_losses", 0.625),
                 ("train_accs", 0.5), ("val_accs", 0.75)):
        trainer.history[k].append(v)
    trainer.save_checkpoint(is_final=True)
    state2 = _jax_update(trainer.optimizer, state1, d["grad"](
        state1.params, d["batches"][1], d["keys"][1]))
    return dict(jt=jt, stem=out / "jax" / "models" / "final_model",
                state1=state1, state2=state2, out=out,
                index=FULL_CASES.index(request.param))


def _port_trainer(full_data, case, out):
    tcfg = TrainConfig.from_dict(case["jt"].to_dict())
    cfg = ModelConfig.from_dict(full_data["jcfg"].to_dict())
    return ploop.Trainer(cfg, tcfg, full_data["pg"], full_data["pg"],
                         full_data["edges"], full_data["edges"][:50], out,
                         device="cpu")


def test_full_graph_checkpoint_loads_exactly(full_data, full_case):
    stem = full_case["stem"]
    got = pckpt.load(_form(stem, full_case["index"]))
    _check_params(got["params"], full_case["state1"].params)
    assert got["model_config"] == full_data["jcfg"].to_dict()
    assert got["step"] == 1 and got["epoch"] == 1
    assert (got["best_val_loss"], got["best_val_acc"]) == (0.625, 0.75)
    assert got["history"]["val_accs"] == [0.75]
    assert got["train_config"] == full_case["jt"].to_dict()
    assert got["rng_key"] == _meta(stem)["rng_key"]
    theirs = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(
        full_case["state1"].opt_state))
    ours = got["opt_state"]
    assert list(_flat(ours)) == list(_flat(theirs))
    for k, v in _flat(theirs).items():
        _exact(_flat(ours)[k], v, k)


def test_full_graph_resume_matches_the_jax_step(full_data, full_case):
    d, case = full_data, full_case
    t = _port_trainer(d, case, case["out"] / "port")
    t.resume(_form(case["stem"], case["index"] + 1))
    assert t.epoch == 1 and t.best_val_loss == 0.625
    assert t.history["train_losses"] == [0.7]
    _check_params(t.params, case["state1"].params)
    adam = _adam(case["state1"].opt_state)
    if case["jt"].optimizer == "sgd":
        assert adam is None and not t.optimizer.state
    else:
        _check_adam_moments(t.optimizer, t.params, adam)
    ploop.update_step(t.params, t.optimizer, d["pg"],
                      [d["cands"](d["batches"][1], d["keys"][1])],
                      t.model_cfg, t.train_cfg)
    _check_params(t.params, case["state2"].params, close=True)
    if adam is not None:
        _close_adam_moments(t.optimizer, t.params,
                            _adam(case["state2"].opt_state))


def test_save_jax_writes_the_jax_file_and_the_jax_package_reads_it(
        full_data, full_case, tmp_path):
    d, case = full_data, full_case
    t = _port_trainer(d, case, tmp_path / "port")
    t.resume(case["stem"])
    payload = t.jax_checkpoint_payload()
    if case["jt"].optimizer == "sgd":
        # No optimizer state counts the updates: the step is the caller's.
        payload["state"]["step"] = torch.tensor(1, dtype=torch.int32)
    pckpt.save_jax(tmp_path / "again", payload)
    assert (tmp_path / "again.msgpack").read_bytes() == \
        case["stem"].with_suffix(".msgpack").read_bytes()
    meta, theirs = _meta(tmp_path / "again"), _meta(case["stem"])
    theirs.pop("rng_key")
    # The JAX TrainConfig has a field of its own (impl): the same config.
    assert JTrainConfig.from_dict(meta.pop("train_config")) == \
        JTrainConfig.from_dict(theirs.pop("train_config"))
    assert meta == theirs

    # After a port step, the JAX package reads the port's file into the
    # trainer's own template.
    ploop.update_step(t.params, t.optimizer, d["pg"],
                      [d["cands"](d["batches"][1], d["keys"][1])],
                      t.model_cfg, t.train_cfg)
    t.epoch = 2
    pckpt.save_jax(tmp_path / "stepped", t.jax_checkpoint_payload())
    back = jckpt.load(tmp_path / "stepped.json",
                      example_state=case["state2"])
    assert back["epoch"] == 2 and "rng_key" not in back
    _check_params(t.params, back["state"].params)
    if case["jt"].optimizer != "sgd":
        _check_adam_moments(t.optimizer, t.params,
                            _adam(back["state"].opt_state))
        assert int(back["state"].step) == 2


# -- the sharded trainers -----------------------------------------------------


@pytest.fixture(scope="module", params=["edge", "node"])
def sharded_case(request, full_data, tmp_path_factory):
    d, shard = full_data, request.param
    jt = JTrainConfig(batch_size=64, lr=0.01, grad_clip=1.0, epochs=2)
    out = tmp_path_factory.mktemp(f"sharded_{shard}")
    trainer = jmulti.ShardedTrainer(d["jcfg"], jt, d["jg"], d["jg"],
                                    d["edges"], d["edges"][:50], out / "jax",
                                    shard=shard, n_devices=2)
    rng = np.random.default_rng(8)
    batches = []
    for _ in range(2):
        b = np.ones((64, 4), np.int32)
        b[:, :3] = d["edges"][rng.integers(0, len(d["edges"]), 64)]
        b[50:, 3] = 0
        batches.append(b)
    keys = [jax.random.PRNGKey(21), jax.random.PRNGKey(22)]
    state1, _ = trainer._sharded_step(trainer.state, jnp.asarray(batches[0]),
                                      keys[0])
    trainer.state, trainer.epoch = state1, 1
    trainer.save_checkpoint(is_final=True)
    state1 = _host(state1)
    state2, _ = trainer._sharded_step(state1, jnp.asarray(batches[1]),
                                      keys[1])
    return dict(shard=shard, jt=jt, stem=out / "jax" / "models" /
                "final_model", state1=state1, state2=_host(state2),
                batch=batches[1], key=keys[1], out=out)


def _shard_cands(batch, key, shard):
    """The JAX sharded step's per-shard negatives: the negative key folded
    with the shard index (and, in the edge layout, first with the micro-
    batch index 0)."""
    k_neg, _ = jax.random.split(key)
    if shard == "edge":
        k_neg = jax.random.fold_in(k_neg, 0)
    out = []
    for s in range(2):
        sl = jnp.asarray(batch[s * 32:(s + 1) * 32])
        c = jneg.candidate_batch(jax.random.fold_in(k_neg, s), sl[:, 0],
                                 sl[:, 1], sl[:, 2], N_FULL, 1,
                                 mask=sl[:, 3])
        out.append(tuple(_torch(a, long=i < 3) for i, a in enumerate(c)))
    return [out] if shard == "edge" else out


def test_sharded_trainer_resumes_and_matches_the_jax_step(full_data,
                                                          sharded_case):
    d, case = full_data, sharded_case
    t = ShardedTrainer(ModelConfig.from_dict(d["jcfg"].to_dict()),
                       TrainConfig.from_dict(case["jt"].to_dict()), d["pg"],
                       d["pg"], d["edges"], d["edges"][:50],
                       case["out"] / "port", shard=case["shard"],
                       n_devices=2, device="cpu")
    t.resume(case["stem"].with_suffix(".msgpack"))
    _check_params(t.params, case["state1"].params)
    _check_adam_moments(t.optimizer, t.params,
                        _adam(case["state1"].opt_state))
    t.step_fn.update(t.params, t.optimizer, _shard_cands(
        case["batch"], case["key"], case["shard"]))
    _check_params(t.params, case["state2"].params, close=True)
    _close_adam_moments(t.optimizer, t.params,
                        _adam(case["state2"].opt_state))


# -- the one-device sampled trainer -------------------------------------------

SAMPLED = {
    "dense_adam": dict(mode="block", opt=dict(optimizer="adam", lr=0.01,
                                              grad_clip=1.0)),
    "sparse_sgd": dict(mode="block", sparse_emb=True,
                       opt=dict(optimizer="sgd", lr=0.5, grad_clip=0.0)),
    "sparse_adafactor": dict(mode="uniform", sparse_emb=True,
                             table_opt="adafactor",
                             opt=dict(optimizer="adam", lr=0.05,
                                      grad_clip=0.0)),
    "cache_f32": dict(mode="uniform", sparse_emb=True, cache_layer1=True,
                      opt=dict(optimizer="sgd", lr=0.5, grad_clip=0.0)),
    "cache_bf16_adafactor": dict(mode="uniform", sparse_emb=True,
                                 cache_layer1=True, table_opt="adafactor",
                                 bf16=True,
                                 opt=dict(optimizer="adam", lr=0.05,
                                          grad_clip=0.0)),
}
FANOUTS = (4, 3)


def _sampled_payload(state, epoch, jcfg, jt):
    """What the JAX SampledTrainer saves after ``epoch``."""
    return {"epoch": epoch, "state": state, "best_val_loss": 0.5,
            "best_val_acc": 0.0,
            "history": {"train_losses": [0.6], "val_losses": [0.5]},
            "rng_key": [0, 7], "model_config": jcfg.to_dict(),
            "train_config": jt.to_dict()}


@pytest.fixture(scope="module", params=list(SAMPLED))
def sampled_case(request, tmp_path_factory):
    spec = SAMPLED[request.param]
    edges, jg, pg, jcfg, jp = _setup(seed=5, dropout=0.0)
    if spec.get("bf16"):
        jcfg = JModelConfig.from_dict({**jcfg.to_dict(),
                                       "compute_dtype": "bfloat16"})
    jt = JTrainConfig(batch_size=B, epochs=2, **spec["opt"])
    kw = dict(fanouts=FANOUTS, mode=spec["mode"],
              sparse_emb=spec.get("sparse_emb", False),
              table_opt=spec.get("table_opt", "sgd"),
              cache_layer1=spec.get("cache_layer1", False))
    jstep = jsampled.build_sampled_train_step(
        jg, jcfg, jt, jloop.make_optimizer(jt), **kw)
    state = jstep.init_state(jax.tree_util.tree_map(jnp.asarray, jp))
    rng = np.random.default_rng(2)
    pos = [jnp.asarray(edges[rng.integers(0, len(edges), B)])
           for _ in range(2)]
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    state, _ = jstep(state, pos[0], keys[0])
    state1 = _host(state)
    out = tmp_path_factory.mktemp(f"sampled_{request.param}")
    stem = out / "jax" / "models" / "final_model"
    jckpt.save(stem, _sampled_payload(state1, 1, jcfg, jt))
    state2, _ = jstep(state, pos[1], keys[1])
    if kw["cache_layer1"]:
        cands, k_sample, mask = _jax_cached_batch(jg, jcfg, pos[1], keys[1],
                                                  FANOUTS, spec["mode"])
    else:
        _, cands, _, k_sample, _, mask = _jax_batch(
            jg, jcfg, pos[1], keys[1], FANOUTS, spec["mode"])
    given = dict(cands=tuple(_torch(c, long=i < 3)
                             for i, c in enumerate(cands)),
                 draw=JaxDraws(k_sample), enc_mask=_torch(mask))
    return dict(name=request.param, spec=spec, kw=kw, jcfg=jcfg, jt=jt,
                edges=edges, pg=pg, stem=stem, state1=state1,
                state2=_host(state2), pos=_torch(pos[1], long=True),
                given=given, out=out)


def _sampled_trainer(case, out, **over):
    kw = {**case["kw"], **over}
    return psampled.SampledTrainer(
        ModelConfig.from_dict(case["jcfg"].to_dict()),
        TrainConfig.from_dict(case["jt"].to_dict()), case["pg"], case["pg"],
        case["edges"], case["edges"][:60], out, device="cpu", **kw)


def _sampled_opt_state(case, t, state, close):
    """The port trainer's optimizer state against the JAX ``state``'s."""
    bf16 = case["spec"].get("bf16", False)
    check = (lambda ours, theirs, where: assert_close(ours, theirs, bf16)) \
        if close else _exact
    moments = (lambda *a: _close_adam_moments(*a, bf16=bf16)) if close \
        else _check_adam_moments
    opt_state = jax.tree_util.tree_map(
        np.asarray, serialization.to_state_dict(state.opt_state))
    opt = t.optimizer
    if case["kw"]["cache_layer1"]:
        check(opt.cache, opt_state["1"], "cache")
        opt, opt_state = opt.base, opt_state["0"]
    if case["kw"]["table_opt"] == "adafactor":
        for k in ("v_row", "v_col"):
            check(opt.table[k], opt_state["1"][k], k)
        assert int(opt.table["count"]) == int(opt_state["1"]["count"])
        rest = pckpt._adam_of(opt_state["0"])
        assert rest["mu"]["encoder"]["node_emb"] is None
        moments(opt.rest, t.params, rest)
    elif case["jt"].optimizer == "adam":
        moments(opt, t.params, pckpt._adam_of(opt_state))
    else:
        assert pckpt._adam_of(opt_state) is None and not opt.state


def test_sampled_trainer_resumes_and_matches_the_jax_step(sampled_case):
    case = sampled_case
    t = _sampled_trainer(case, case["out"] / "port")
    t.resume(_form(case["stem"], len(case["name"])))
    assert t.epoch == 1
    assert t.history == {"train_losses": [0.6], "val_losses": [0.5],
                         "train_accs": [], "val_accs": []}
    _check_params(t.params, case["state1"].params)
    _sampled_opt_state(case, t, case["state1"], close=False)
    t.step_fn(t.params, t.optimizer, case["pos"], torch.Generator(),
              **case["given"])
    bf16 = case["spec"].get("bf16", False)
    _check_params(t.params, case["state2"].params, close=True, bf16=bf16)
    _sampled_opt_state(case, t, case["state2"], close=True)


def test_sampled_save_jax_is_read_by_the_jax_package(sampled_case,
                                                     tmp_path):
    """The resumed trainer's ``save_jax`` writes the JAX file again byte
    for byte (the sgd layouts' step given), and the JAX
    ``checkpoint.load`` restores it into the JAX step's template."""
    case = sampled_case
    t = _sampled_trainer(case, tmp_path / "port")
    t.resume(case["stem"])
    payload = t.jax_checkpoint_payload()
    payload["state"]["step"] = torch.tensor(1, dtype=torch.int32)
    pckpt.save_jax(tmp_path / "again", payload)
    assert (tmp_path / "again.msgpack").read_bytes() == \
        case["stem"].with_suffix(".msgpack").read_bytes()
    back = jckpt.load(tmp_path / "again", example_state=case["state1"])
    assert back["history"]["val_losses"] == [0.5]
    _check_params(t.params, back["state"].params)


# -- zero1 and zero3 ----------------------------------------------------------

ZERO = {"zero1": "sgd", "zero3": "sgd", "zero3_adafactor": "adafactor"}


def _jax_zero(layout, table_opt, jg, jcfg, jt, n, mode="uniform"):
    """(init, step, to_full) of the JAX zero1/zero3 step on n devices."""
    kw = dict(fanouts=FANOUTS, mode=mode)
    if layout == "zero1":
        init, jstep = jsampled.build_sampled_train_step_zero1(
            jg, jcfg, jt, j_mesh(n), **kw)
        return init, jstep, None
    init, jstep, to_full, _ = jsampled.build_sampled_train_step_zero3(
        jg, jcfg, jt, j_mesh(n), table_opt=table_opt, **kw)
    return init, jstep, to_full


def write_zero_checkpoint(layout, table_opt, n, stem, seed=5):
    """A JAX zero1/zero3 state one step in, saved as the JAX SampledTrainer
    saves it (the full table, device-major moments); returns the pieces
    the comparisons need."""
    edges, jg, pg, jcfg, jp = _setup(seed=seed, dropout=0.0)
    opt = (dict(optimizer="adam", lr=0.05, grad_clip=0.0)
           if table_opt == "adafactor"
           else dict(optimizer="adam", lr=0.01, grad_clip=1.0))
    jt = JTrainConfig(batch_size=B, epochs=2, **opt)
    init, jstep, to_full = _jax_zero(layout, table_opt, jg, jcfg, jt, n)
    state = init(jax.tree_util.tree_map(jnp.asarray, jp))
    rng = np.random.default_rng(3)
    pos = [jnp.asarray(edges[rng.integers(0, len(edges), B)])
           for _ in range(2)]
    keys = [jax.random.PRNGKey(31), jax.random.PRNGKey(32)]
    state, _ = jstep(state, pos[0], keys[0])
    full = (state.params if to_full is None else jsampled._merge_emb(
        jsampled._split_emb(state.params)[1],
        to_full(state.params["encoder"]["node_emb"])))
    state1 = _host(state)
    jckpt.save(stem, _sampled_payload(
        jloop.TrainState(full, state.opt_state, state.step), 1, jcfg, jt))
    return dict(edges=edges, jg=jg, pg=pg, jcfg=jcfg, jt=jt, jstep=jstep,
                state=state, state1=state1, to_full=to_full, pos=pos,
                keys=keys, full1=_host(full))


@pytest.fixture(scope="module", params=list(ZERO))
def zero_case(request, tmp_path_factory):
    layout = request.param.split("_")[0]
    out = tmp_path_factory.mktemp(request.param)
    case = write_zero_checkpoint(layout, ZERO[request.param], 2,
                                 out / "jax" / "final_model")
    csr, budgets, combined = jsampled.resolve_sampler(case["jg"], FANOUTS,
                                                      "auto", "uniform")
    given = jax_shard_draws(case["jcfg"], csr, budgets, combined,
                            case["pos"][1], case["keys"][1], 2, "uniform")
    state2, _ = case["jstep"](case["state"], case["pos"][1],
                              case["keys"][1])
    return dict(case, layout=layout, table_opt=ZERO[request.param],
                out=out, stem=out / "jax" / "final_model", given=given,
                state2=_host(state2))


def _zero_trainer(case, out, n=2):
    return psampled.SampledTrainer(
        ModelConfig.from_dict(case["jcfg"].to_dict()),
        TrainConfig.from_dict(case["jt"].to_dict()), case["pg"], case["pg"],
        case["edges"], case["edges"][:60], out, fanouts=FANOUTS,
        mode="uniform", n_devices=n, zero1=case["layout"] == "zero1",
        zero3=case["layout"] == "zero3", table_opt=case["table_opt"],
        device="cpu")


def _zero_params(t, case, state, close):
    ours = _flat(t.step_fn.full_params(t.params)
                 if case["layout"] == "zero3" else t.params)
    theirs = _flat(state.params)
    for k, want in theirs.items():
        if case["layout"] == "zero3" and k == "encoder/node_emb":
            want = np.asarray(case["to_full"](jnp.asarray(want)))
        (assert_close if close else _exact)(ours[k], want)


def test_zero_layouts_resume_and_match_the_jax_step(zero_case):
    case = zero_case
    t = _zero_trainer(case, case["out"] / "port")
    t.resume(case["stem"].with_suffix(".json"))
    _zero_params(t, case, case["state1"], close=False)
    # Exact after the load: the device-major moments and counts, the rest.
    emb = serialization.to_state_dict(case["state1"].opt_state)["1"]
    if case["table_opt"] == "adafactor":
        for k in ("v_row", "v_col", "count"):
            _exact(t.optimizer.table[k], emb[k], k)
    else:
        st = t.optimizer.table.state[t.optimizer.table.param_groups[0][
            "params"][0]]
        adam = pckpt._adam_of(jax.tree_util.tree_map(np.asarray, emb))
        _exact(st["exp_avg"], adam["mu"])
        _exact(st["exp_avg_sq"], adam["nu"])
        assert float(st["step"]) == 1.0
    t.step_fn(t.params, t.optimizer, _torch(case["pos"][1], long=True),
              torch.Generator(), **case["given"])
    _zero_params(t, case, case["state2"], close=True)
    _compare_opt_state(case["layout"], t.params, t.optimizer,
                       case["state2"], case["table_opt"])


def test_zero_save_jax_writes_the_jax_file(zero_case, tmp_path):
    case = zero_case
    t = _zero_trainer(case, tmp_path / "port")
    t.resume(case["stem"])
    pckpt.save_jax(tmp_path / "again", t.jax_checkpoint_payload())
    assert (tmp_path / "again.msgpack").read_bytes() == \
        case["stem"].with_suffix(".msgpack").read_bytes()


def test_checkpoint_of_another_shard_count_raises(zero_case, tmp_path):
    """The table's row slices are bound to the shard count: zero1's and
    zero3's state of 2 slices cannot load into 4."""
    t = _zero_trainer(zero_case, tmp_path / "port", n=4)
    with pytest.raises(ValueError, match="n_devices"):
        t.resume(zero_case["stem"])


# -- serving, evaluation, analysis and the train CLI --------------------------


def _save_split(d, name, e, n):
    jart.save_split_npz(d / f"{name}.npz", {
        "edge_index": e[:, :2].T, "edge_type": e[:, 2], "num_nodes": n,
        "num_relations": 3})


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Synthetic splits; a JAX checkpoint of a random model (the JAX
    package's ``save``), and the reference ``.pt`` that the JAX
    ``torch_interop export`` makes of it."""
    d = tmp_path_factory.mktemp("served")
    raw = jsyn.primekg_like(seed=4, scale=0.03)
    n = raw["num_nodes"]
    rng = np.random.default_rng(4)
    held = rng.choice(np.flatnonzero(raw["rel"] == 0), 40, replace=False)
    keep = np.ones(len(raw["src"]), bool)
    keep[held] = False

    def bid(rows):
        return np.stack(jsyn.bidirect(raw["src"][rows], raw["dst"][rows],
                                      raw["rel"][rows]), 1)

    _save_split(d, "train_data", bid(keep), n)
    _save_split(d, "test_data", bid(held), n)
    _save_split(d, "full_graph", bid(np.arange(len(raw["src"]))), n)
    jart.save_mappings(d / "mappings.json", jsyn.synthetic_mappings(raw))
    jcfg = JModelConfig(num_nodes=n, num_relations=3, embedding_dim=16,
                        hidden_dim=16)
    jt = JTrainConfig()
    params = j_init(jax.random.PRNGKey(1), jcfg)
    state = jloop.TrainState(params, jloop.make_optimizer(jt).init(params),
                             jnp.zeros((), jnp.int32))
    jckpt.save(d / "jax_model", {
        "state": state, "epoch": 7, "best_val_loss": 0.625,
        "best_val_acc": 0.75, "history": {"train_losses": [0.7]},
        "rng_key": [0, 1], "model_config": jcfg.to_dict(),
        "train_config": jt.to_dict()})
    j_interop.main(["export", str(d / "jax_model"), str(d / "model.pt")])
    heads = [0, raw["type_ranges"]["drug"][0] + 3]
    return d, [str(h) for h in heads]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shard", ["none", "node"])
def test_predict_cli_serves_a_jax_checkpoint(served, form, shard):
    d, heads = served
    extra = ["--shard", "node", "--n_devices", "2"] if shard == "node" \
        else []

    def serve(model):
        return p_predict.main([
            "--model_path", str(model), "--data_dir", str(d), "--heads",
            *heads, "--relation", "1", "--topk", "10", "--device", "cpu",
            *extra])

    ours = serve(_form(d / "jax_model", FORMS.index(form)))
    assert ours == serve(d / "model.pt")


@pytest.fixture(scope="module")
def evaluated_pt(served):
    d, _ = served
    return _evaluate(d, d / "model.pt", "pt")


def _evaluate(d, model, out):
    return p_eval_cli.main([
        "--model_path", str(model), "--data_dir", str(d), "--output_dir",
        str(d / out), "--batch_size", "32", "--k_values", "1", "10",
        "--filtered", "--device", "cpu"])


@pytest.mark.parametrize("form", FORMS)
def test_evaluate_cli_evaluates_a_jax_checkpoint(served, evaluated_pt, form):
    d, _ = served
    got = _evaluate(d, _form(d / "jax_model", FORMS.index(form)),
                    f"jax_{form}")
    assert got == evaluated_pt


def test_analysis_loads_a_jax_checkpoint(served):
    d, _ = served
    ours = AnalysisContext(d / "jax_model", d, device="cpu")
    ref = AnalysisContext(d / "model.pt", d, device="cpu")
    np.testing.assert_array_equal(ours.embeddings, ref.embeddings)
    assert ours.checkpoint_meta["epoch"] == 7
    assert ours.checkpoint_meta["model_config"] == \
        ref.checkpoint_meta["model_config"]


def test_train_cli_resumes_a_jax_checkpoint(tmp_path, caplog):
    """One port epoch, its .pt made a JAX checkpoint by the JAX ``import``
    (a fresh adam state), resumed by the train CLI for a second epoch:
    the compute dtype comes from the ``.json`` alone, the epoch carries
    over, and the log says that the JAX key stream does not."""
    base = ["--synthetic", "--synthetic_scale", "0.02", "--embedding_dim",
            "8", "--hidden_dim", "8", "--batch_size", "64", "--device",
            "cpu"]
    p_train_cli.main([*base, "--epochs", "1", "--output_dir",
                      str(tmp_path / "a")])
    j_interop.main(["import", str(tmp_path / "a" / "models" /
                                  "final_model.pt"), str(tmp_path / "jax")])
    # The .msgpack is not read to pick the compute dtype.
    assert pckpt.stored_model_config(tmp_path / "jax.json")[
        "compute_dtype"] == "float32"
    with caplog.at_level("INFO"):
        result = p_train_cli.main([
            *base, "--epochs", "2", "--output_dir", str(tmp_path / "b"),
            "--resume", str(tmp_path / "jax"), "--data_dir",
            str(tmp_path / "a" / "synthetic_data")])
    assert len(result["history"]["train_losses"]) == 1
    assert "does not carry over" in caplog.text
    again = pckpt.load(tmp_path / "b" / "models" / "final_model.pt")
    assert again["epoch"] == 2


# -- the torch_interop CLI ----------------------------------------------------


def test_interop_import_writes_the_jax_import_files(served, tmp_path):
    d, _ = served
    j_interop.main(["import", str(d / "model.pt"), str(tmp_path / "j")])
    p_interop.main(["import", str(d / "model.pt"), str(tmp_path / "p")])
    assert (tmp_path / "p.msgpack").read_bytes() == \
        (tmp_path / "j.msgpack").read_bytes()
    ours, theirs = _meta(tmp_path / "p"), _meta(tmp_path / "j")
    # The JAX TrainConfig has a field of its own (impl): the same config.
    assert JTrainConfig.from_dict(ours.pop("train_config")) == \
        JTrainConfig.from_dict(theirs.pop("train_config"))
    assert ours == theirs


def test_interop_export_writes_the_jax_export_file(served, tmp_path):
    d, _ = served
    p_interop.main(["export", str(d / "jax_model.msgpack"),
                    str(tmp_path / "p.pt")])
    ours = torch.load(tmp_path / "p.pt", weights_only=False)
    theirs = torch.load(d / "model.pt", weights_only=False)
    assert ours["epoch"] == theirs["epoch"] == 7
    assert vars(ours["args"]) == vars(theirs["args"])
    assert ours["model_state_dict"].keys() == \
        theirs["model_state_dict"].keys()
    for k, v in theirs["model_state_dict"].items():
        assert torch.equal(ours["model_state_dict"][k], v), k


# -- refusals -----------------------------------------------------------------


@pytest.mark.parametrize("missing", [".json", ".msgpack"])
def test_a_jax_checkpoint_missing_a_file_raises(served, tmp_path, missing):
    d, _ = served
    for suffix in (".json", ".msgpack"):
        if suffix != missing:
            (tmp_path / f"ckpt{suffix}").write_bytes(
                (d / f"jax_model{suffix}").read_bytes())
    with pytest.raises(FileNotFoundError, match=f"ckpt\\{missing}"):
        pckpt.load(tmp_path / "ckpt")


def test_a_pt_still_loads_without_a_jax_state(served):
    d, _ = served
    got = pckpt.load(d / "model.pt")
    assert "opt_state" not in got and got["epoch"] == 7
    ref = pckpt.load(d / "jax_model")
    for k, v in _flat(ref["params"]).items():
        assert torch.equal(_flat(got["params"])[k], v), k


def test_an_optimizer_that_does_not_match_raises(full_data, full_case,
                                                 tmp_path):
    """An adam checkpoint cannot resume an sgd trainer, nor the other way
    round."""
    jt = full_case["jt"]
    other = JTrainConfig.from_dict({
        **jt.to_dict(), "optimizer": "sgd" if jt.optimizer != "sgd"
        else "adam"})
    t = _port_trainer(full_data, {"jt": other}, tmp_path / "port")
    with pytest.raises(ValueError, match="adam moments"):
        t.resume(full_case["stem"])


# -- zero3 across processes ---------------------------------------------------


def test_zero3_across_two_processes_resumes_like_one(tmp_path):
    """A JAX zero3 checkpoint of 4 slices resumed by a 4-shard zero3
    trainer spread over 2 gloo processes (each keeping its 2 slices) and
    by one process: after two steps on the port's generator, losses,
    parameters and the gathered optimizer state agree within rtol 2e-5,
    atol 2e-6 (the distributed tests' bound), and the first process's
    resumed slices equal the JAX state's."""
    case = write_zero_checkpoint("zero3", "sgd", 4, tmp_path / "jax" /
                                 "final_model")
    torch.save({"edges": case["edges"].astype(np.int64),
                "model_config": case["jcfg"].to_dict(),
                "train_config": case["jt"].to_dict(),
                "stem": str(tmp_path / "jax" / "final_model")},
               tmp_path / "given.pt")
    ranks = run_workers("jax_resume", tmp_path)
    solo = worker.case_jax_resume(0, 1, tmp_path)
    emb = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(
        case["state1"].opt_state))["1"]
    mu = pckpt._adam_of(emb)["mu"]
    for rank, got in enumerate(ranks):
        assert int(got["table_rows"]) == 2
        _exact(got["resumed_mu"], mu[2 * rank:2 * rank + 2])
        np.testing.assert_allclose(got["losses"], solo["losses"],
                                   rtol=2e-5)
        for part in ("params", "opt"):
            assert got[part].keys() == solo[part].keys()
            for k, v in solo[part].items():
                np.testing.assert_allclose(
                    got[part][k].double().numpy(), v.double().numpy(),
                    rtol=2e-5, atol=2e-6, err_msg=k)
