"""Sampled training on the CPU against the JAX package: the sampled
encoder's forward and every parameter's gradient of the sampled loss
against ``jax.value_and_grad`` of the JAX step's loss body, whole dense
adam and sparse-embedding SGD steps against the JAX step, the sampled
validation, and the trainer and CLI end to end (checkpoints, resume).

The JAX negatives, sampler draws and dropout masks are handed to the port,
since the two packages' generators cannot agree. The identity block's
backward runs kernel B2's plain version here and the interpreted Pallas
kernel in JAX. Tolerance as in test_torch_parity.py: rtol 2e-4, atol 2e-5
times each tensor's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primekg_rgcn_tpu.config import ModelConfig as JModelConfig
from primekg_rgcn_tpu.config import TrainConfig as JTrainConfig
from primekg_rgcn_tpu.data import sampling as js
from primekg_rgcn_tpu.data.graph import build_rel_graph as j_build
from primekg_rgcn_tpu.models import rgcn as jmodel
from primekg_rgcn_tpu.ops.distmult import distmult_score as j_distmult
from primekg_rgcn_tpu.train import loop as jloop
from primekg_rgcn_tpu.train import neg_sampling as jneg
from primekg_rgcn_tpu.train import sampled as jsampled
from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.data import artifacts as part
from primekg_rgcn_tpu_torch.data import sampling as ps
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph as p_build
from primekg_rgcn_tpu_torch.models import rgcn as pmodel
from primekg_rgcn_tpu_torch.train import checkpoint as pckpt
from primekg_rgcn_tpu_torch.train import cli as pcli
from primekg_rgcn_tpu_torch.train import sampled as psampled
from primekg_rgcn_tpu_torch.train.torch_interop import params_from_jax

N, R, E = 120, 3, 900


class JaxDraws:
    """The port's ``draw`` replaying the JAX sampler's key chain."""

    def __init__(self, key):
        self.key = key

    def __call__(self, shape):
        self.key, k = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.uniform(k, shape)))


def assert_close(ours, expected):
    ours, expected = np.asarray(ours), np.asarray(expected)
    scale = max(float(np.abs(expected).max()), 1e-30)
    np.testing.assert_allclose(ours, expected, rtol=2e-4, atol=2e-5 * scale)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _setup(seed=0, dropout=0.5, bases=None):
    """Directed edges with skew, so no symmetry hides a wrong transpose."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N // 2, E)
    dst = rng.integers(0, N, E)
    rel = rng.integers(0, R, E)
    edges = np.stack([src, dst, rel], 1).astype(np.int32)
    jg = j_build(src, dst, rel, N, R, bucket_pad_multiple=64,
                 use_native="never")
    pg = p_build(src, dst, rel, N, R, bucket_pad_multiple=64)
    jcfg = JModelConfig(num_nodes=N, num_relations=R, embedding_dim=8,
                        hidden_dim=12, dropout=dropout, num_bases=bases)
    jp = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(seed), jcfg))
    return edges, jg, pg, jcfg, jp


def _port_params(jp):
    pp = params_from_jax(jp)
    for p in pmodel.param_leaves(pp):
        p.requires_grad_(True)
    return pp


def _jax_batch(jg, jcfg, pos, key, fanouts, mode, csr_kw=None):
    """What the JAX step draws from ``key``: candidates, the sampled batch,
    the dropout key and the keep mask the encoder draws from it."""
    csr = js.build_combined_csr(jg, **csr_kw) if csr_kw else jg
    csr, budgets, combined = jsampled.resolve_sampler(csr, fanouts, "auto",
                                                      mode)
    k_neg, k_sample, k_drop = jax.random.split(key, 3)
    cands = jneg.candidate_batch(k_neg, pos[:, 0], pos[:, 1], pos[:, 2],
                                 jcfg.num_nodes, 1)
    seeds = jnp.concatenate([cands[0], cands[1]]).astype(jnp.int32)
    if combined:
        batch = js.sample_batch_combined(k_sample, csr, seeds, budgets,
                                         mode=mode, allow_ident=True)
    else:
        batch = js.sample_batch(k_sample, csr, seeds, budgets, mode=mode)
    _, k = jax.random.split(k_drop)
    mask = jax.random.bernoulli(k, 1.0 - jcfg.dropout,
                                (batch.blocks[0].m_out, jcfg.hidden_dim))
    return csr, cands, batch, k_sample, k_drop, mask


def _j_loss(params, batch, cands, jcfg, k_drop):
    heads, tails, rels, labels, weights = cands
    emb = jmodel.encoder_apply_sampled(params, batch, jcfg, train=True,
                                       dropout_rng=k_drop)
    m = heads.shape[0]
    rel_emb = jnp.take(params["decoder"]["rel_emb"], rels, axis=0)
    scores = j_distmult(emb[:m], emb[m:], rel_emb)
    loss_sum, correct, count = jneg.bce_stats(scores, labels, weights)
    return loss_sum / count, correct / count


def _torch(a, long=False):
    t = torch.from_numpy(np.array(a))
    return t.long() if long else t


# (fanouts, mode, CSR layout, identity regime): the per-relation layout,
# the combined layout's modes in both regimes, block over the slim pairs
# form, and basis decomposition.
CASES = [
    ((4, 3), "uniform", None, True, None),
    ((4, 3), "truncate", None, True, None),
    ((4, 3), "block", None, True, None),
    ((4, 3), "block", {"slim": True, "window_pairs": True}, True, 2),
    ((4, 4), "block2", None, False, None),
    ((3, 3), "uniform", {"slim": False}, False, None),
]


@pytest.mark.parametrize("fanouts,mode,csr_kw,ident,bases", CASES)
def test_sampled_loss_and_gradients_match_jax(fanouts, mode, csr_kw, ident,
                                             bases, monkeypatch):
    if not ident:
        monkeypatch.setenv("PRIMEKG_IDENT_FRACTION", "1000")
    edges, jg, pg, jcfg, jp = _setup(seed=len(mode) + fanouts[0],
                                     bases=bases)
    pos = jnp.asarray(edges[np.random.default_rng(1).integers(0, E, 24)])
    key = jax.random.PRNGKey(3)
    jcsr, cands, jb, k_sample, k_drop, mask = _jax_batch(
        jg, jcfg, pos, key, fanouts, mode, csr_kw)
    if mode.startswith("block") or csr_kw:
        assert isinstance(jcsr, js.CombinedCsr)
        assert bool(jb.blocks[0].ident) == ident
    else:
        assert isinstance(jcsr, js.CsrCache)

    (loss_j, acc_j), grads_j = jax.value_and_grad(
        lambda p: _j_loss(p, jb, cands, jcfg, k_drop), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, jp))
    emb_j = jmodel.encoder_apply_sampled(jp, jb, jcfg)

    pcsr = ps.build_combined_csr(pg, **csr_kw) if csr_kw else pg
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    step = psampled.build_sampled_train_step(
        pcsr, cfg, TrainConfig(), fanouts=fanouts, mode=mode, device="cpu")
    pb = step.sample(torch.cat([_torch(cands[0]), _torch(cands[1])]),
                     JaxDraws(k_sample))
    pp = _port_params(jp)
    with torch.no_grad():
        emb = pmodel.encoder_apply_sampled(pp, pb, cfg)
    assert_close(emb.numpy(), emb_j)
    pcands = tuple(_torch(c, long=i < 3) for i, c in enumerate(cands))
    loss, acc = psampled.sampled_loss(pp, pb, pcands, cfg, train=True,
                                      enc_mask=_torch(mask))
    loss.backward()
    assert_close(loss.item(), float(loss_j))
    assert acc.item() == pytest.approx(float(acc_j))
    ours, theirs = _flat(pp), _flat(grads_j)
    assert ours.keys() == theirs.keys()
    for k in theirs:
        assert_close(ours[k].grad.numpy(), theirs[k])


@pytest.mark.parametrize("sparse,mode,ident", [
    (False, "block", True),
    (False, "uniform", False),
    (True, "block", True),
    (True, "block4", False),
    (True, "uniform", False),
])
def test_train_step_matches_jax_step(sparse, mode, ident, monkeypatch):
    if not ident:
        monkeypatch.setenv("PRIMEKG_IDENT_FRACTION", "1000")
    edges, jg, pg, jcfg, jp = _setup(seed=5, dropout=0.5)
    fanouts = (8, 4) if mode == "block4" else (4, 3)
    kw = (dict(optimizer="sgd", lr=0.5, grad_clip=0.0) if sparse
          else dict(optimizer="adam", lr=0.01, grad_clip=1.0))
    jtcfg = JTrainConfig(batch_size=24, **kw)
    pos = jnp.asarray(edges[np.random.default_rng(2).integers(0, E, 24)])
    key = jax.random.PRNGKey(7)
    jstep = jsampled.build_sampled_train_step(
        jg, jcfg, jtcfg, jloop.make_optimizer(jtcfg), fanouts=fanouts,
        mode=mode, sparse_emb=sparse)
    state = jstep.init_state(jax.tree_util.tree_map(jnp.asarray, jp))
    state, (loss_j, _) = jstep(state, pos, key)
    _, cands, jb, k_sample, _, mask = _jax_batch(jg, jcfg, pos, key,
                                                 fanouts, mode)
    assert bool(getattr(jb.blocks[0], "ident", False)) == ident

    cfg = ModelConfig.from_dict(jcfg.to_dict())
    step = psampled.build_sampled_train_step(
        pg, cfg, TrainConfig(batch_size=24, **kw), fanouts=fanouts,
        mode=mode, sparse_emb=sparse, device="cpu")
    pp = _port_params(jp)
    opt = step.init_optimizer(pp)
    pcands = tuple(_torch(c, long=i < 3) for i, c in enumerate(cands))
    loss, _ = step(pp, opt, _torch(pos, long=True), torch.Generator(),
                   cands=pcands, draw=JaxDraws(k_sample),
                   enc_mask=_torch(mask))
    assert_close(loss.item(), float(loss_j))
    ours = _flat(pp)
    theirs = _flat(jax.tree_util.tree_map(np.asarray, state.params))
    for k in theirs:
        assert_close(ours[k].detach().numpy(), theirs[k])
    if sparse:
        # Only the rows the batch reached moved.
        moved = (ours["encoder/node_emb"].detach().numpy()
                 != jp["encoder"]["node_emb"]).any(1)
        assert 0 < moved.sum() <= N


def test_step_draws_from_its_generator_and_repeats():
    edges, jg, pg, jcfg, jp = _setup(seed=2)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    step = psampled.build_sampled_train_step(
        pg, cfg, TrainConfig(batch_size=32), fanouts=(4, 3), mode="block",
        device="cpu")
    assert step.use_combined
    assert step.budgets == jsampled.resolve_sampler(jg, (4, 3), "auto",
                                                    "block")[1]
    pos = torch.from_numpy(edges[:32].astype(np.int64))
    losses = []
    for _ in range(2):
        pp = _port_params(jp)
        opt = step.init_optimizer(pp)
        gen = torch.Generator().manual_seed(4)
        losses.append([step(pp, opt, pos, gen)[0].item() for _ in range(3)])
    assert losses[0] == losses[1]
    assert np.all(np.isfinite(losses[0]))


def test_sampled_eval_matches_a_sampled_encode():
    edges, _, pg, jcfg, jp = _setup(seed=4, dropout=0.5)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    tcfg = TrainConfig(batch_size=40)
    val = edges[:70]
    eval_fn = psampled.build_sampled_eval_epoch(
        pg, val, cfg, tcfg, fanouts=(4, 3), mode="block", device="cpu")
    pp = _port_params(jp)
    loss, acc = eval_fn(pp, torch.Generator().manual_seed(0))
    # The same draws by hand: two batches, the second padded (weight 0).
    gen = torch.Generator().manual_seed(0)
    step = psampled.build_sampled_train_step(pg, cfg, tcfg, fanouts=(4, 3),
                                             mode="block", device="cpu")
    from primekg_rgcn_tpu_torch.train.loop import (edges_with_sentinel,
                                                   sample_candidates)

    pad = edges_with_sentinel(val, "cpu")
    idx = torch.cat([torch.arange(70), torch.full((10,), 70)]).view(2, 40)
    tot = torch.zeros(3)
    with torch.no_grad():
        for bi in idx:
            cands = sample_candidates(pad, bi, N, 1, generator=gen)
            sb = step.sample(torch.cat(cands[:2]).int(),
                             ps.uniform_draw(gen, "cpu"))
            loss_b, acc_b = psampled.sampled_loss(pp, sb, cands, cfg,
                                                  train=False)
            count = cands[4].sum()
            tot += torch.stack([loss_b * count, acc_b * count, count])
    assert tot[2].item() == 140
    assert loss.item() == pytest.approx((tot[0] / tot[2]).item(), rel=1e-6)
    assert acc.item() == pytest.approx((tot[1] / tot[2]).item(), rel=1e-6)


def test_trainer_refuses_sparse_emb_with_adam(tmp_path):
    edges, _, pg, jcfg, _ = _setup()
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    with pytest.raises(ValueError, match="sparse_emb requires"):
        psampled.SampledTrainer(cfg, TrainConfig(), pg, pg, edges, edges[:8],
                                tmp_path, sparse_emb=True, device="cpu")


BASE = ["--epochs", "2", "--embedding_dim", "8", "--hidden_dim", "8",
        "--batch_size", "64", "--lr", "0.01", "--seed", "3",
        "--sample_fanouts", "4", "3", "--device", "cpu"]
ARGS = ["--synthetic", "--synthetic_scale", "0.02", *BASE]


@pytest.fixture(scope="module")
def block_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("sampled_block")
    return out, pcli.main([*ARGS, "--sample_mode", "block",
                           "--output_dir", str(out)])


def test_cli_block_trains_and_writes_loadable_checkpoints(block_run):
    out, result = block_run
    hist = result["history"]
    assert len(hist["train_losses"]) == len(hist["val_losses"]) == 2
    assert np.all(np.isfinite(hist["train_losses"] + hist["val_losses"]))
    assert len((out / "metrics.jsonl").read_text().splitlines()) == 2
    for name in ("best_model.pt", "final_model.pt"):
        payload = pckpt.load(out / "models" / name)
        cfg = ModelConfig.from_dict(payload["model_config"])
        assert payload["params"]["encoder"]["node_emb"].shape == (
            cfg.num_nodes, 8)
        assert {"optimizer_state_dict", "rng_state",
                "device_rng_state"} <= payload.keys()
    assert pckpt.load(out / "models" / "final_model.pt")["epoch"] == 2


def test_cli_resume_continues_the_history(block_run, tmp_path):
    out, result = block_run
    # Stop after epoch 1, then resume from its final model to epoch 2.
    first = tmp_path / "first"
    pcli.main([*ARGS, "--sample_mode", "block", "--output_dir", str(first),
               "--epochs", "1"])
    resumed = pcli.main([*ARGS, "--sample_mode", "block", "--output_dir",
                         str(tmp_path / "second"), "--resume",
                         str(first / "models" / "final_model.pt")])
    hist, want = resumed["history"], result["history"]
    assert len(hist["train_losses"]) == 2
    assert hist["train_losses"][0] == want["train_losses"][0]
    assert np.isfinite(hist["train_losses"][1])
    assert pckpt.load(tmp_path / "second" / "models" /
                      "final_model.pt")["epoch"] == 2


def test_cli_uniform_on_a_relation_dense_graph_takes_per_relation_layout(
        tmp_path):
    # The small synthetic graphs are relation-sparse (the combined layout);
    # this one has most (node, relation) pairs present.
    edges, _, pg, _, _ = _setup(seed=6)
    data = tmp_path / "data"
    data.mkdir()
    for name, e in (("train_data", edges[:800]), ("val_data", edges[800:]),
                    ("full_graph", edges)):
        part.save_split_npz(data / f"{name}.npz", {
            "edge_index": e[:, :2].T, "edge_type": e[:, 2],
            "num_nodes": N, "num_relations": R})
    train_graph = part.split_to_rel_graph(
        part.load_split(data / "train_data.npz"))
    csr, _, combined = psampled.resolve_sampler(train_graph, (4, 3))
    assert not combined and isinstance(csr, ps.CsrCache)
    result = pcli.main([*BASE, "--sample_mode", "uniform", "--data_dir",
                        str(data), "--output_dir", str(tmp_path / "out")])
    hist = result["history"]
    assert np.all(np.isfinite(hist["train_losses"] + hist["val_losses"]))
    assert (tmp_path / "out" / "models" / "final_model.pt").exists()


def test_cli_sparse_emb_and_sampled_validation(tmp_path):
    result = pcli.main([*ARGS, "--sample_mode", "block4", "--sparse_emb",
                        "--optimizer", "sgd", "--grad_clip", "0",
                        "--val_sampled", "--lr", "0.5",
                        "--output_dir", str(tmp_path)])
    hist = result["history"]
    assert np.all(np.isfinite(hist["train_losses"] + hist["val_losses"]))
    assert (tmp_path / "models" / "final_model.pt").exists()


def test_cli_validates_sampled_flags(tmp_path):
    with pytest.raises(SystemExit):
        pcli.parse_args(["--sample_fanouts", "4", "--sample_mode", "block0"])
    with pytest.raises(SystemExit):
        pcli.parse_args(["--sparse_emb"])
    args = pcli.parse_args(["--sample_fanouts", "15", "10",
                            "--sample_mode", "block12"])
    assert args.sample_fanouts == [15, 10] and args.sample_mode == "block12"


# -- the data-parallel layouts through the trainer and the CLI ----------------

_SGD0 = dict(optimizer="sgd", grad_clip=0.0)
REFUSALS = [
    # (trainer keywords, train config keywords, message)
    (dict(zero3=True), {}, "multi-device"),
    (dict(zero1=True, n_devices=1), {}, "multi-device"),
    (dict(dp_pods=2), {}, "multi-device"),
    (dict(dp_pods=2, n_devices=4), {}, "requires --zero3"),
    (dict(sparse_emb=True, n_devices=4), _SGD0, "single-chip"),
    (dict(zero1=True, table_opt="adafactor", n_devices=4),
     dict(grad_clip=0.0), "table_opt"),
    (dict(table_opt="adafactor", n_devices=4), dict(grad_clip=0.0),
     "table_opt"),
    (dict(zero1=True, zero3=True, n_devices=4), {}, "exclusive"),
    (dict(zero3=True, dp_pods=3, n_devices=4), {}, "must divide"),
    (dict(zero3=True, table_opt="adafactor", n_devices=4), {}, "grad_clip"),
    (dict(table_opt="adafactor"), {}, "needs --sparse_emb"),
    (dict(sparse_emb=True), dict(grad_clip=0.0), "sparse_emb requires"),
    (dict(sparse_emb=True, table_opt="adafactor"), {}, "grad_clip"),
]


@pytest.mark.parametrize("kw,tkw,match", REFUSALS)
def test_trainer_refuses_what_the_jax_trainer_refuses(kw, tkw, match,
                                                      tmp_path):
    edges, _, pg, jcfg, _ = _setup()
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    with pytest.raises(ValueError, match=match):
        psampled.SampledTrainer(cfg, TrainConfig(batch_size=32, **tkw), pg,
                                pg, edges, edges[:8], tmp_path,
                                fanouts=(3, 3), device="cpu", **kw)


SHARDED = [*ARGS, "--sample_mode", "block", "--shard", "node",
           "--n_devices", "4"]


@pytest.fixture(scope="module")
def zero3_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("sampled_zero3")
    extra = ["--zero3", "--dp_pods", "2", "--table_opt", "adafactor",
             "--grad_clip", "0", "--val_sampled", "--output_dir", str(out)]
    return out, extra, pcli.main([*SHARDED, *extra, "--epochs", "1"])


def test_cli_zero3_checkpoint_holds_the_full_table(zero3_run, tmp_path):
    """A zero3 run on a (2, 2) mesh with the factored table rule: the .pt
    holds the whole [N, D] table and the per-slice statistics, and
    evaluate.cli reads it as it stands."""
    from primekg_rgcn_tpu_torch.evaluate import cli as p_eval

    out, _, result = zero3_run
    assert np.all(np.isfinite(result["history"]["train_losses"]
                              + result["history"]["val_losses"]))
    payload = pckpt.load(out / "models" / "final_model.pt")
    cfg = ModelConfig.from_dict(payload["model_config"])
    assert payload["params"]["encoder"]["node_emb"].shape == (cfg.num_nodes,
                                                              8)
    table = payload["optimizer_state_dict"]["table"]
    n_loc = -(-cfg.num_nodes // 2)
    assert table["v_row"].shape == (2, 8)
    assert table["v_col"].shape == (2, n_loc)
    metrics = p_eval.main(["--model_path", str(out / "models" /
                                               "final_model.pt"),
                           "--data_dir", str(out / "synthetic_data"),
                           "--output_dir", str(tmp_path), "--device", "cpu"])
    assert np.isfinite(metrics["classification"]["auc_roc"])
    assert np.isfinite(metrics["ranking"]["mrr"])


def test_cli_zero3_resume_continues_the_history_and_the_slices(zero3_run,
                                                               tmp_path):
    out, extra, first = zero3_run
    saved = pckpt.load(out / "models" / "final_model.pt")
    extra = [*extra[:-1], str(tmp_path)]
    resumed = pcli.main([*SHARDED, *extra, "--epochs", "2", "--resume",
                         str(out / "models" / "final_model.pt")])
    hist = resumed["history"]
    assert hist["train_losses"][0] == first["history"]["train_losses"][0]
    assert len(hist["train_losses"]) == 2 and np.isfinite(hist["val_losses"]
                                                          [1])
    steps = int(saved["optimizer_state_dict"]["table"]["count"][0])
    table = pckpt.load(tmp_path / "models" / "final_model.pt")[
        "optimizer_state_dict"]["table"]
    assert table["count"].tolist() == [2 * steps] * 2


@pytest.mark.parametrize("layout", ["zero1", "dp"])
def test_cli_shard_edge_with_sample_fanouts_trains_data_parallel(layout,
                                                                 tmp_path):
    flags = ["--zero1"] if layout == "zero1" else []
    result = pcli.main([*ARGS, "--sample_mode", "block", "--shard", "edge",
                        "--n_devices", "2", *flags, "--epochs", "1",
                        "--output_dir", str(tmp_path)])
    assert np.all(np.isfinite(result["history"]["train_losses"]
                              + result["history"]["val_losses"]))
    payload = pckpt.load(tmp_path / "models" / "final_model.pt")
    opt_state = payload["optimizer_state_dict"]
    if layout == "zero1":
        cfg = ModelConfig.from_dict(payload["model_config"])
        slices = opt_state["table"]["state"][0]["exp_avg"]
        assert slices.shape == (2, -(-cfg.num_nodes // 2), 8)
    else:
        assert "param_groups" in opt_state


def test_cli_sharded_sampled_flags():
    args = pcli.parse_args(["--sample_fanouts", "4", "3", "--shard", "edge",
                            "--n_devices", "4", "--zero3", "--dp_pods", "2",
                            "--table_opt", "adafactor"])
    assert (args.zero3, args.dp_pods, args.table_opt) == (True, 2,
                                                          "adafactor")
    for bad in (["--zero1"], ["--zero3", "--shard", "edge"],
                ["--table_opt", "adafactor"], ["--dp_pods", "2"],
                ["--sample_fanouts", "4", "--zero1", "--zero3"]):
        with pytest.raises(SystemExit):
            pcli.parse_args(bad)
