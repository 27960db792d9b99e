"""bf16 compute through the sampled and node-sharded paths and the CLIs, on
the CPU, against the JAX package at bf16.

- Sampled: one block-mode step in the identity regime (its backward sends
  bf16 cotangents to kernel B2's plain version here, to the interpreted
  Pallas kernel in JAX) and in the dedup regime, block over the slim pairs
  CSR, and the per-relation layout: the sampled encode, the loss and every
  gradient. The JAX draws, candidates and dropout masks are handed over.
- Node-sharded, 2 shards: the encode and one SGD update against the JAX
  step over a partition with Pallas schedules, whose layer sums each bf16
  bucket in float32 as the TPU did (without them it sums in bf16 on the
  CPU); the encode also against the port's dense bf16 encode.
- The train CLI with --compute_dtype bfloat16, full-graph, sampled and
  node-sharded, and serving, evaluation and analysis of its checkpoint at
  bf16; checkpoints without a ``model_config`` load at float32.

Tolerance: 2e-2 of each tensor's largest magnitude (atol) and rtol 2e-2,
as in test_torch_port_bf16_model.py. The sampled combined layout stays bf16
through its einsum and matmuls, so more values round: the largest deviation
measured here is 1.8e-2 (the sampled embedding table's gradient). The
sharded encodes agree with JAX's and the dense one far closer (float32 sums
of the same bf16 values, rtol 1e-5, atol 1e-5 of the largest magnitude).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from primekg_rgcn_tpu.config import ModelConfig as JModelConfig
from primekg_rgcn_tpu.config import TrainConfig as JTrainConfig
from primekg_rgcn_tpu.data import sampling as js
from primekg_rgcn_tpu.data.graph import build_rel_graph as j_build
from primekg_rgcn_tpu.models import rgcn as jmodel
from primekg_rgcn_tpu.ops.distmult import distmult_score as j_distmult
from primekg_rgcn_tpu.parallel import node_shard as jns
from primekg_rgcn_tpu.parallel.mesh import make_mesh as j_mesh
from primekg_rgcn_tpu.train import checkpoint as jckpt
from primekg_rgcn_tpu.train import neg_sampling as jneg
from primekg_rgcn_tpu.train import sampled as jsampled
from primekg_rgcn_tpu.train.loop import TrainState
from primekg_rgcn_tpu.train.torch_interop import export_torch_checkpoint
from primekg_rgcn_tpu_torch.analyze.core import AnalysisContext
from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.data import artifacts as part
from primekg_rgcn_tpu_torch.data import sampling as ps
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph as p_build
from primekg_rgcn_tpu_torch.evaluate import cli as p_eval
from primekg_rgcn_tpu_torch.evaluate import predict_cli as p_predict
from primekg_rgcn_tpu_torch.models import rgcn as pmodel
from primekg_rgcn_tpu_torch.parallel import node_shard as pns
from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh as p_mesh
from primekg_rgcn_tpu_torch.train import checkpoint as pckpt
from primekg_rgcn_tpu_torch.train import cli as pcli
from primekg_rgcn_tpu_torch.train import sampled as psampled
from primekg_rgcn_tpu_torch.train import torch_interop as pinterop
from primekg_rgcn_tpu_torch.train.loop import make_optimizer

BF16 = torch.bfloat16
N, R, E = 120, 3, 900


def assert_close(ours, expected, name=""):
    ours = np.asarray(ours, np.float32)
    expected = np.asarray(expected, np.float32)
    scale = max(float(np.abs(expected).max()), 1e-30)
    np.testing.assert_allclose(ours, expected, rtol=2e-2, atol=2e-2 * scale,
                               err_msg=name)


def assert_sum_close(ours, expected):
    ours = np.asarray(ours, np.float32)
    expected = np.asarray(expected, np.float32)
    scale = max(float(np.abs(expected).max()), 1e-30)
    np.testing.assert_allclose(ours, expected, rtol=1e-5, atol=1e-5 * scale)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _torch(a, long=False):
    t = torch.from_numpy(np.array(a))
    return t.long() if long else t


def _port_params(jp, grad=True):
    pp = pinterop.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    for p in pmodel.param_leaves(pp):
        p.requires_grad_(grad)
    return pp


class JaxDraws:
    """The port's ``draw`` replaying the JAX sampler's key chain."""

    def __init__(self, key):
        self.key = key

    def __call__(self, shape):
        self.key, k = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.uniform(k, shape)))


# -- sampled -------------------------------------------------------------------

# (fanouts, mode, CSR layout, identity regime)
SAMPLED_CASES = [
    ((4, 3), "block", None, True),
    ((4, 3), "block", {"slim": True, "window_pairs": True}, True),
    ((4, 4), "block2", None, False),
    ((4, 3), "uniform", None, True),
]


@pytest.mark.parametrize("fanouts,mode,csr_kw,ident", SAMPLED_CASES)
def test_sampled_step_matches_jax_at_bf16(fanouts, mode, csr_kw, ident,
                                          monkeypatch):
    if not ident:
        monkeypatch.setenv("PRIMEKG_IDENT_FRACTION", "1000")
    rng = np.random.default_rng(len(mode) + fanouts[1])
    src, dst, rel = (rng.integers(0, N // 2, E), rng.integers(0, N, E),
                     rng.integers(0, R, E))
    edges = np.stack([src, dst, rel], 1).astype(np.int32)
    jg = j_build(src, dst, rel, N, R, bucket_pad_multiple=64,
                 use_native="never")
    pg = p_build(src, dst, rel, N, R, bucket_pad_multiple=64)
    jcfg = JModelConfig(num_nodes=N, num_relations=R, embedding_dim=16,
                        hidden_dim=32, dropout=0.5,
                        compute_dtype="bfloat16")
    jp = jmodel.init_params(jax.random.PRNGKey(1), jcfg)

    pos = jnp.asarray(edges[rng.integers(0, E, 24)])
    key = jax.random.PRNGKey(3)
    csr = js.build_combined_csr(jg, **csr_kw) if csr_kw else jg
    csr, budgets, combined = jsampled.resolve_sampler(csr, fanouts, "auto",
                                                      mode)
    k_neg, k_sample, k_drop = jax.random.split(key, 3)
    cands = jneg.candidate_batch(k_neg, pos[:, 0], pos[:, 1], pos[:, 2], N,
                                 1)
    seeds = jnp.concatenate([cands[0], cands[1]]).astype(jnp.int32)
    if combined:
        jb = js.sample_batch_combined(k_sample, csr, seeds, budgets,
                                      mode=mode, allow_ident=True)
    else:
        jb = js.sample_batch(k_sample, csr, seeds, budgets, mode=mode)
    assert combined == (mode != "uniform")
    assert bool(getattr(jb.blocks[0], "ident", False)) == (ident and combined)
    _, k = jax.random.split(k_drop)
    mask = jax.random.bernoulli(k, 0.5, (jb.blocks[0].m_out, 32))

    def j_loss(params):
        heads, tails, rels, labels, weights = cands
        emb = jmodel.encoder_apply_sampled(params, jb, jcfg, train=True,
                                           dropout_rng=k_drop)
        m = heads.shape[0]
        scores = j_distmult(emb[:m], emb[m:],
                            jnp.take(params["decoder"]["rel_emb"], rels,
                                     axis=0))
        loss_sum, _, count = jneg.bce_stats(scores, labels, weights)
        return loss_sum / count

    loss_j, grads_j = jax.value_and_grad(j_loss)(jp)
    emb_j = jmodel.encoder_apply_sampled(jp, jb, jcfg)

    seen = []
    real_b2 = ps.dense_sorted_segment_sum

    def spy_b2(msg, srt, n):
        seen.append(msg.dtype)
        return real_b2(msg, srt, n)

    monkeypatch.setattr(ps, "dense_sorted_segment_sum", spy_b2)
    pcsr = ps.build_combined_csr(pg, **csr_kw) if csr_kw else pg
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    step = psampled.build_sampled_train_step(
        pcsr, cfg, TrainConfig(), fanouts=fanouts, mode=mode, device="cpu")
    pb = step.sample(torch.cat([_torch(cands[0]), _torch(cands[1])]),
                     JaxDraws(k_sample))
    pp = _port_params(jp)
    with torch.no_grad():
        emb = pmodel.encoder_apply_sampled(pp, pb, cfg)
    assert emb.dtype == torch.float32
    assert_close(emb.numpy(), emb_j)
    pcands = tuple(_torch(c, long=i < 3) for i, c in enumerate(cands))
    loss, _ = psampled.sampled_loss(pp, pb, pcands, cfg, train=True,
                                    enc_mask=_torch(mask))
    loss.backward()
    assert loss.item() == pytest.approx(float(loss_j), rel=1e-3)
    # The identity block's backward hands B2 bf16 cotangent rows.
    assert seen == ([BF16] if ident and combined else [])
    ours, theirs = _flat(pp), _flat(grads_j)
    for k in theirs:
        assert ours[k].grad.dtype == torch.float32
        assert_close(ours[k].grad.numpy(), theirs[k], k)


def test_ident_pick_gather_converts_after_the_gather():
    table = torch.randn(6, 4, requires_grad=True)
    ids = torch.tensor([5, 0, 6, 5], dtype=torch.int32)
    perm = torch.argsort(ids, stable=True).to(torch.int32)
    rows = ps.IdentPickGather.apply(table, ids, perm, ids[perm.long()], BF16)
    assert rows.dtype == BF16
    assert torch.equal(rows[2], torch.zeros(4, dtype=BF16))
    assert torch.equal(rows[0], table[5].detach().to(BF16))
    (rows.float() * 2).sum().backward()
    assert table.grad.dtype == torch.float32
    assert torch.equal(table.grad[5], torch.full((4,), 4.0))
    assert torch.equal(table.grad[1], torch.zeros(4))


def test_dedup_backward_sums_bf16_cotangents_in_float32():
    # 300 cotangents of 1: a bf16 running sum stalls at 256 (257 rounds to
    # even), a float32 one reaches 300, a bf16 value.
    x = torch.zeros(2, 1, dtype=BF16, requires_grad=True)
    inv = torch.zeros(300, dtype=torch.int32)
    rows = ps.DedupGather.apply(x, inv, torch.arange(300, dtype=torch.int32),
                                torch.zeros(300, dtype=torch.int32))
    rows.backward(torch.ones(300, 1, dtype=BF16))
    assert x.grad.dtype == BF16
    assert float(x.grad[0]) == 300.0


# -- node-sharded ----------------------------------------------------------------


def _node_setup(seed):
    rng = np.random.default_rng(seed)
    n = 96
    src, dst, rel = (rng.integers(0, m, 900) for m in (n, n, R))
    jg = j_build(src, dst, rel, n, R, bucket_pad_multiple=64,
                 use_native="never")
    pg = p_build(src, dst, rel, n, R, bucket_pad_multiple=64)
    jcfg = JModelConfig(num_nodes=n, num_relations=R, embedding_dim=16,
                        hidden_dim=16, dropout=0.0, compute_dtype="bfloat16")
    return jg, pg, jcfg, jmodel.init_params(jax.random.PRNGKey(seed), jcfg)


def test_node_sharded_encode_matches_jax_and_the_dense_encode_at_bf16():
    jg, pg, jcfg, jp = _node_setup(0)
    expected = np.asarray(jns.build_node_sharded_forward(
        j_mesh(2), jns.partition_nodes(jg, 2, pallas=True), jcfg,
        gather=False)(jp))
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    params = _port_params(jp, grad=False)
    psg = pns.partition_nodes(pg, 2)
    seen = {"sends": [], "tables": []}

    def spy_exchange(sends):
        seen["sends"] += [s.dtype for s in sends]
        return pns.exchange(sends)

    def spy_agg(table, op):
        seen["tables"].append(table.dtype)
        return pns.aggregate(table, op)

    ops = pns.build_shard_ops(psg)
    with torch.no_grad():
        xs = pns.sharded_encoder(params, psg, ops, cfg, agg_fn=spy_agg,
                                 exchange_fn=spy_exchange)
        dense = pmodel.encoder_apply(params, pg, cfg)
    assert all(x.dtype == torch.float32 for x in xs)
    # The serve rows ship in bf16; every B1 table is bf16.
    assert seen["sends"] == [BF16] * 4
    assert seen["tables"] and set(seen["tables"]) == {BF16}
    sharded = torch.stack(xs)
    assert_sum_close(sharded.numpy(), expected)
    assert_sum_close(torch.cat(xs)[:96].numpy(), dense.numpy())


def test_node_sharded_sgd_update_matches_jax_at_bf16():
    jg, pg, jcfg, jp = _node_setup(3)
    b, lr = 64, 1e-2
    opt = optax.sgd(lr)
    j_step = jns.build_node_sharded_train_step(
        j_mesh(2), jns.partition_nodes(jg, 2, pallas=True), jcfg,
        JTrainConfig(batch_size=b, lr=lr), opt)
    rng = np.random.default_rng(0)
    batch = np.stack([rng.integers(0, 96, b), rng.integers(0, 96, b),
                      rng.integers(0, R, b), np.ones(b, np.int64)],
                     axis=1).astype(np.int32)
    key = jax.random.PRNGKey(7)
    p0 = jax.tree_util.tree_map(jnp.copy, jp)
    state, (loss_j, _) = j_step(
        TrainState(p0, opt.init(p0), jnp.zeros((), jnp.int32)),
        jnp.asarray(batch), key)

    k_neg, _ = jax.random.split(key)
    cands = []
    for d in range(2):
        sl = jnp.asarray(batch[d * 32:(d + 1) * 32])
        c = jneg.candidate_batch(jax.random.fold_in(k_neg, d), sl[:, 0],
                                 sl[:, 1], sl[:, 2], 96, 1, mask=sl[:, 3])
        h, t, r, y, w = (torch.from_numpy(np.array(x)) for x in c)
        cands.append((h.long(), t.long(), r.long(), y, w))
    params = _port_params(jp)
    before = {k: v.detach().clone() for k, v in _flat(params).items()}
    tcfg = TrainConfig(batch_size=b, lr=lr, optimizer="sgd", grad_clip=0.0)
    step = pns.build_node_sharded_train_step(
        p_mesh(2, "cpu"), pns.partition_nodes(pg, 2),
        ModelConfig.from_dict(jcfg.to_dict()), tcfg)
    stats = step.update(params, make_optimizer(tcfg, params), cands)
    assert stats[0].item() / stats[2].item() == pytest.approx(
        float(loss_j), rel=1e-3)
    ours, theirs = _flat(params), _flat(state.params)
    j0 = _flat(jax.tree_util.tree_map(np.asarray, jp))
    for k in theirs:
        assert ours[k].dtype == torch.float32
        # The update itself, lr times the gradient, within the tolerance.
        assert_close((ours[k].detach() - before[k]).numpy(),
                     np.asarray(theirs[k]) - j0[k], k)


# -- CLIs and checkpoints ---------------------------------------------------------

ARGS = ["--synthetic", "--synthetic_scale", "0.02", "--epochs", "1",
        "--embedding_dim", "8", "--hidden_dim", "8", "--batch_size", "64",
        "--lr", "0.01", "--seed", "3", "--device", "cpu"]


@pytest.fixture(scope="module")
def bf16_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_bf16_train")
    result = pcli.main([*ARGS, "--compute_dtype", "bfloat16",
                        "--output_dir", str(out)])
    return out, result


def test_cli_trains_at_bf16_and_the_checkpoint_records_it(bf16_run):
    out, result = bf16_run
    assert np.isfinite(result["history"]["train_losses"]).all()
    for name in ("best_model.pt", "final_model.pt"):
        payload = pckpt.load(out / "models" / name)
        assert payload["model_config"]["compute_dtype"] == "bfloat16"
        assert all(p.dtype == torch.float32
                   for p in pmodel.param_leaves(payload["params"]))
    # The JAX package reads the same file at float32: its loader ignores
    # model_config.
    jpayload = jckpt.load(out / "models" / "final_model.pt")
    assert jpayload["model_config"]["compute_dtype"] == "float32"


def test_serving_evaluation_and_analysis_follow_the_checkpoint(
        bf16_run, tmp_path, caplog):
    out, _ = bf16_run
    model = out / "models" / "final_model.pt"
    data = out / "synthetic_data"
    argv = ["--model_path", str(model), "--data_dir", str(data), "--heads",
            "0", "5", "--relation", "0", "--topk", "5", "--device", "cpu"]
    with caplog.at_level(logging.INFO):
        served = p_predict.main(argv)
    assert "compute_dtype bfloat16" in caplog.text
    payload = pckpt.load(model)
    cfg = ModelConfig.from_dict(payload["model_config"])
    graph = part.split_to_rel_graph(
        part.load_dataset(data, require_train=False)["full"])
    with torch.no_grad():
        emb = pmodel.get_embeddings(payload["params"], graph, cfg)
        emb32 = pmodel.get_embeddings(
            payload["params"], graph,
            ModelConfig.from_dict({**cfg.to_dict(),
                                   "compute_dtype": "float32"}))
    assert not torch.equal(emb, emb32)
    rel = payload["params"]["decoder"]["rel_emb"][0]
    for res in served:
        h = res["head_id"]
        want = torch.topk((emb[h] * rel) @ emb.T, 5)
        assert [p["tail_id"] for p in res["predictions"]] == \
            want.indices.tolist()
        np.testing.assert_allclose([p["score"] for p in res["predictions"]],
                                   want.values.numpy(), rtol=1e-5)

    with caplog.at_level(logging.INFO):
        metrics = p_eval.main(["--model_path", str(model), "--data_dir",
                               str(data), "--output_dir",
                               str(tmp_path / "eval"), "--device", "cpu"])
    assert np.isfinite(metrics["classification"]["auc_roc"])
    assert np.isfinite(metrics["ranking"]["mrr"])
    log = (tmp_path / "eval" / "evaluation.log").read_text()
    assert "compute_dtype bfloat16" in log.splitlines()[0]

    ctx = AnalysisContext(model, data, device="cpu")
    assert ctx.model_cfg.compute_dtype == "bfloat16"


def test_resume_takes_the_checkpoint_dtype_and_refuses_another(bf16_run,
                                                               tmp_path):
    out, _ = bf16_run
    ckpt = str(out / "models" / "final_model.pt")
    resumed = pcli.main([*ARGS[:4], "2", *ARGS[5:], "--resume", ckpt,
                         "--output_dir", str(tmp_path / "resumed")])
    assert len(resumed["history"]["train_losses"]) == 2
    payload = pckpt.load(tmp_path / "resumed" / "models" / "final_model.pt")
    assert payload["model_config"]["compute_dtype"] == "bfloat16"
    with pytest.raises(ValueError, match="compute_dtype 'bfloat16'"):
        pcli.main([*ARGS, "--compute_dtype", "float32", "--resume", ckpt,
                   "--output_dir", str(tmp_path / "refused")])


@pytest.mark.parametrize("extra", [
    ["--sample_fanouts", "4", "3", "--sample_mode", "block"],
    ["--shard", "node", "--n_devices", "2"]])
def test_sampled_and_node_sharded_cli_train_at_bf16(tmp_path, extra):
    result = pcli.main([*ARGS, "--compute_dtype", "bfloat16", *extra,
                        "--output_dir", str(tmp_path)])
    assert np.isfinite(result["history"]["train_losses"]).all()
    payload = pckpt.load(tmp_path / "models" / "final_model.pt")
    assert payload["model_config"]["compute_dtype"] == "bfloat16"


def test_checkpoints_without_model_config_load_at_float32(tmp_path):
    jcfg = JModelConfig(num_nodes=20, num_relations=3, embedding_dim=8,
                        hidden_dim=8, compute_dtype="bfloat16")
    export_torch_checkpoint(jmodel.init_params(jax.random.PRNGKey(0), jcfg),
                            jcfg, tmp_path / "ref.pt")
    blob = torch.load(tmp_path / "ref.pt", weights_only=False)
    assert "model_config" not in blob
    assert pckpt.load(tmp_path / "ref.pt")["model_config"][
        "compute_dtype"] == "float32"
    # save_reference_pt records the dtype; a round trip keeps it.
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    params = pinterop.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(0), jcfg)))
    pinterop.save_reference_pt(params, cfg, tmp_path / "port.pt")
    _, cfg2, _ = pinterop.load_reference_pt(tmp_path / "port.pt")
    assert cfg2 == cfg and cfg2.compute_dtype == "bfloat16"
