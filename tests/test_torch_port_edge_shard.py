"""The edge-sharded layout against the JAX package's, on the CPU: the
shards bit for bit, the layer and the encode at float32 and bf16, one adam
update with and without gradient accumulation, the sharded trainer and the
train CLI with ``--shard edge``.

The JAX side runs on meshes of the conftest's 8 host devices (its XLA
segment-sum: ``pallas=False``); the port's shards all lie on the CPU, where
kernel B1 runs its plain version. Graph: 96 nodes, 3 relations, 900 edges.
Tolerances: float32 rtol 2e-4, atol 2e-5 (the update's parameters atol
1e-6, as the node layout's update test); bf16 rtol and atol 2e-2 of the
largest magnitude, as tests/test_torch_port_bf16_*.py (the JAX XLA path
sums bf16 messages in bf16 on the CPU, B1 in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from primekg_rgcn_tpu.config import ModelConfig as JModelConfig
from primekg_rgcn_tpu.config import TrainConfig as JTrainConfig
from primekg_rgcn_tpu.data.graph import build_rel_graph as j_build
from primekg_rgcn_tpu.models.rgcn import init_params as j_init
from primekg_rgcn_tpu.parallel import edge_shard as jes
from primekg_rgcn_tpu.parallel.mesh import make_mesh as j_mesh
from primekg_rgcn_tpu.train import checkpoint as jckpt
from primekg_rgcn_tpu.train import neg_sampling as jneg
from primekg_rgcn_tpu.train.loop import make_optimizer as j_make_optimizer
from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph as p_build
from primekg_rgcn_tpu_torch.models.rgcn import encoder_apply, param_leaves
from primekg_rgcn_tpu_torch.parallel import edge_shard as pes
from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh as p_mesh
from primekg_rgcn_tpu_torch.train import cli as p_cli
from primekg_rgcn_tpu_torch.train.loop import make_optimizer
from primekg_rgcn_tpu_torch.train.multichip import ShardedTrainer
from primekg_rgcn_tpu_torch.train.torch_interop import params_from_jax

N, R, E = 96, 3, 900
ARRAYS = ("src", "dst", "t_src", "t_dst", "scale", "t_scale")


def _graphs(seed=0, norm="dense"):
    rng = np.random.default_rng(seed)
    src, dst, rel = (rng.integers(0, m, E) for m in (N, N, R))
    jg = j_build(src, dst, rel, N, R, bucket_pad_multiple=64,
                 use_native="never", norm=norm)
    pg = p_build(src, dst, rel, N, R, bucket_pad_multiple=64, norm=norm)
    return jg, pg


def _port_params(jparams, grad=False):
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    for p in param_leaves(params):
        p.requires_grad_(grad)
    return params


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _close(ours, theirs, bf16, err_msg="", atol=2e-5):
    ours = np.asarray(ours, np.float32)
    theirs = np.asarray(theirs, np.float32)
    if bf16:
        scale = max(float(np.abs(theirs).max()), 1e-30)
        np.testing.assert_allclose(ours, theirs, rtol=2e-2,
                                   atol=2e-2 * scale, err_msg=err_msg)
    else:
        np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=atol,
                                   err_msg=err_msg)


@pytest.mark.parametrize("norm", ["dense", "edge"])
@pytest.mark.parametrize("n_dev,pallas", [(2, False), (2, True), (4, False),
                                          (4, True)])
def test_shards_equal_jax_bit_for_bit_and_csrs_cover(n_dev, pallas, norm):
    jg, pg = _graphs(norm=norm)
    jsg = jes.shard_rel_graph(jg, n_dev, pallas=pallas)
    psg = pes.shard_rel_graph(pg, n_dev, align=512 * n_dev if pallas
                              else None)
    assert psg.local_offsets == jsg.local_offsets
    assert (psg.num_nodes, psg.num_relations) == (N, R)
    for name in ARRAYS:
        ours, theirs = getattr(psg, name), getattr(jsg, name)
        if theirs is None:
            assert ours is None and norm == "dense", name
            continue
        assert ours.numpy().dtype == np.asarray(theirs).dtype, name
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs),
                                      err_msg=name)
    np.testing.assert_array_equal(psg.inv_in_deg.numpy(),
                                  np.asarray(jsg.inv_in_deg))
    # Each (shard, relation) CSR expands to the chunk's real keys, a prefix
    # followed by the sentinel only; together they hold every real edge.
    real = 0
    for keys, rowptr in ((psg.dst, psg.rowptr), (psg.t_src, psg.t_rowptr)):
        for d in range(n_dev):
            for r in range(R):
                s, e = psg.local_offsets[r], psg.local_offsets[r + 1]
                c = int(rowptr[d, r, -1])
                counts = torch.diff(rowptr[d, r])
                assert torch.equal(torch.repeat_interleave(
                    torch.arange(N + 1, dtype=torch.int32), counts),
                    keys[d, s:s + c])
                assert bool((keys[d, s + c:e] == N).all())
                real += c
    assert real == 2 * pg.num_edges


def _j_layer(jparams, x, jsg, n_dev, cdt):
    edges = tuple(a for a in (jsg.src, jsg.dst, jsg.t_src, jsg.t_dst,
                              jsg.scale, jsg.t_scale) if a is not None)
    f = shard_map(
        lambda e: jes.rgcn_layer_edge_sharded(
            jparams, x, tuple(a[0] for a in e), jsg, "data",
            compute_dtype=cdt),
        mesh=j_mesh(n_dev), in_specs=(P("data"),), out_specs=P(),
        check_vma=False)
    return np.asarray(jax.jit(f)(edges))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("din,dout,norm", [(8, 16, "dense"), (16, 8, "dense"),
                                           (8, 16, "edge")])
def test_layer_matches_jax(din, dout, norm, dtype):
    """Both aggregation orders (aggregate first when Din <= Dout), dense
    and edge norm, over 4 shards."""
    jg, pg = _graphs(seed=1, norm=norm)
    jcfg = JModelConfig(num_nodes=N, num_relations=R, embedding_dim=din,
                        hidden_dim=dout)
    conv = j_init(jax.random.PRNGKey(2), jcfg)["encoder"]["conv1"]
    x = np.random.default_rng(3).normal(size=(N, din)).astype(np.float32)
    bf16 = dtype == "bfloat16"
    expected = _j_layer(conv, jnp.asarray(x), jes.shard_rel_graph(jg, 4), 4,
                        jnp.bfloat16 if bf16 else jnp.float32)
    sg = pes.shard_rel_graph(pg, 4)
    with torch.no_grad():
        got = pes.rgcn_layer_edge_sharded(
            {k: torch.from_numpy(np.array(v)) for k, v in conv.items()},
            torch.from_numpy(x), sg, pes.build_edge_ops(sg),
            compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    assert got.dtype == torch.float32 and got.shape == (N, dout)
    _close(got.numpy(), expected, bf16)


@pytest.mark.parametrize("n_dev,dtype", [(2, "float32"), (4, "float32"),
                                         (4, "bfloat16")])
def test_encode_matches_jax_and_the_dense_encoder(n_dev, dtype):
    jg, pg = _graphs(seed=2)
    jcfg = JModelConfig(num_nodes=N, num_relations=R, embedding_dim=8,
                        hidden_dim=16, dropout=0.0, compute_dtype=dtype)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    expected = np.asarray(jes.build_sharded_forward(
        j_mesh(n_dev), jes.shard_rel_graph(jg, n_dev), jcfg)(jparams))
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    params = _port_params(jparams)
    with torch.no_grad():
        got = pes.build_sharded_forward(
            p_mesh(n_dev, "cpu"), pes.shard_rel_graph(pg, n_dev), cfg)(params)
        dense = encoder_apply(params, pg, cfg)
    assert got.shape == (N, 16)
    bf16 = dtype == "bfloat16"
    _close(got.numpy(), expected, bf16)
    _close(got.numpy(), dense.numpy(), bf16)


def _jax_candidates(batch, key, n_dev, accum, num_nodes):
    """The JAX step's per-micro, per-shard candidates, as ``_jit_step``
    draws them: ``split(key)``, then the negative key folded with the
    micro-batch index and with the shard index."""
    k_neg, _ = jax.random.split(key)
    b_loc = batch.shape[1] // n_dev
    micro = []
    for i in range(accum):
        k_i = jax.random.fold_in(k_neg, i)
        shards = []
        for d in range(n_dev):
            sl = jnp.asarray(batch[i, d * b_loc:(d + 1) * b_loc])
            c = jneg.candidate_batch(jax.random.fold_in(k_i, d), sl[:, 0],
                                     sl[:, 1], sl[:, 2], num_nodes, 1,
                                     mask=sl[:, 3])
            h, t, r, y, w = (torch.from_numpy(np.array(a)) for a in c)
            shards.append((h.long(), t.long(), r.long(), y, w))
        micro.append(shards)
    return micro


@pytest.mark.parametrize("accum", [1, 2])
def test_one_adam_update_matches_the_jax_step(accum):
    jg, pg = _graphs(seed=3)
    n_dev, b, lr = 4, 64, 1e-2
    jcfg = JModelConfig(num_nodes=N, num_relations=R, embedding_dim=8,
                        hidden_dim=8, dropout=0.0, decoder_dropout=0.0)
    jtcfg = JTrainConfig(batch_size=b, lr=lr, grad_clip=0.05,
                         gradient_accumulation_steps=accum)
    jparams = j_init(jax.random.PRNGKey(3), jcfg)
    opt = j_make_optimizer(jtcfg)
    j_step = jes.build_sharded_train_step(
        j_mesh(n_dev), jes.shard_rel_graph(jg, n_dev), jcfg, jtcfg, opt,
        accum_steps=accum)
    rng = np.random.default_rng(0)
    batch = np.stack([rng.integers(0, N, (accum, b)),
                      rng.integers(0, N, (accum, b)),
                      rng.integers(0, R, (accum, b)),
                      (rng.random((accum, b)) < 0.9).astype(np.int64)],
                     axis=2).astype(np.int32)
    key = jax.random.PRNGKey(7)
    p0 = jax.tree_util.tree_map(jnp.copy, jparams)
    params_j, _, (loss_j, acc_j) = j_step(
        p0, opt.init(p0), jnp.asarray(batch[0] if accum == 1 else batch),
        key)

    params = _port_params(jparams, grad=True)
    tcfg = TrainConfig.from_dict(jtcfg.to_dict())
    step = pes.build_sharded_train_step(
        p_mesh(n_dev, "cpu"), pes.shard_rel_graph(pg, n_dev),
        ModelConfig.from_dict(jcfg.to_dict()), tcfg, accum_steps=accum)
    stats = step.update(params, make_optimizer(tcfg, params),
                        _jax_candidates(batch, key, n_dev, accum, N))
    assert stats[2].item() == 2 * batch[..., 3].sum()
    assert stats[0].item() / stats[2].item() == pytest.approx(
        float(loss_j), rel=1e-5)
    assert stats[1].item() / stats[2].item() == pytest.approx(float(acc_j))
    ours, theirs = _flat(params), _flat(params_j)
    assert ours.keys() == theirs.keys()
    for k in theirs:
        _close(ours[k].detach().numpy(), np.asarray(theirs[k]), False, k,
               atol=1e-6)


def test_step_draws_per_micro_and_shard_and_refuses_bad_batches():
    _, pg = _graphs()
    cfg = ModelConfig(num_nodes=N, num_relations=R, embedding_dim=8,
                      hidden_dim=8)
    step = pes.build_sharded_train_step(
        p_mesh(4, "cpu"), pes.shard_rel_graph(pg, 4), cfg, TrainConfig(),
        accum_steps=2)
    batch = torch.zeros(2, 8, 4, dtype=torch.long)
    cands = step.draw(batch, torch.Generator().manual_seed(0))
    assert len(cands) == 2 and all(len(c) == 4 for c in cands)
    assert cands[0][0][0].shape == (4,)       # 2 positives, 2 negatives
    with pytest.raises(ValueError, match="micro-batches"):
        step.draw(batch[0], None)
    with pytest.raises(ValueError, match="divide"):
        step.draw(torch.zeros(2, 6, 4, dtype=torch.long), None)
    with pytest.raises(ValueError, match="shards"):
        pes.build_sharded_forward(p_mesh(2, "cpu"),
                                  pes.shard_rel_graph(pg, 4), cfg)


def test_sharded_trainer_runs_an_edge_epoch_with_accumulation(tmp_path):
    _, pg = _graphs(seed=4)
    edges = np.random.default_rng(4).integers(0, R, (200, 3))
    edges[:, :2] = np.random.default_rng(5).integers(0, N, (200, 2))
    cfg = ModelConfig(num_nodes=N, num_relations=R, embedding_dim=8,
                      hidden_dim=8)
    tcfg = TrainConfig(epochs=1, batch_size=32, gradient_accumulation_steps=2)
    trainer = ShardedTrainer(cfg, tcfg, pg, pg, edges, edges[:64], tmp_path,
                             shard="edge", n_devices=4, device="cpu")
    calls = []
    step_fn = trainer.step_fn
    trainer.step_fn = lambda p, o, batch, g: calls.append(
        tuple(batch.shape)) or step_fn(p, o, batch, g)
    loss, acc = trainer.train_epoch_fn(trainer.host_gen, trainer.device_gen)
    # 200 edges, batch 32: 7 batches, grouped two by two into 4 updates.
    assert calls == [(2, 32, 4)] * 4
    assert np.isfinite(float(loss)) and 0.0 <= float(acc) <= 1.0


ARGS = ["--synthetic", "--synthetic_scale", "0.02", "--epochs", "2",
        "--embedding_dim", "8", "--hidden_dim", "8", "--batch_size", "128",
        "--lr", "0.01", "--seed", "3", "--device", "cpu"]


def test_edge_cli_trains_and_the_jax_package_reads_its_checkpoint(tmp_path):
    result = p_cli.main([*ARGS, "--shard", "edge", "--n_devices", "4",
                         "--gradient_accumulation_steps", "2",
                         "--output_dir", str(tmp_path)])
    hist = result["history"]
    assert len(hist["train_losses"]) == 2
    assert all(np.isfinite(hist["train_losses"] + hist["val_losses"]))
    assert hist["train_losses"][1] < hist["train_losses"][0]
    payload = jckpt.load(tmp_path / "models" / "final_model.pt")
    assert payload["epoch"] == 2
    assert payload["model_config"]["hidden_dim"] == 8
