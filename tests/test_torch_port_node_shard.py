"""The node-sharded slice against the JAX package's, on the CPU: the
partition bit for bit, the sharded encode, one sharded SGD update, the
sharded top-K, and the train and serve CLIs with ``--shard node``.

The JAX side runs on meshes of the conftest's 8 host devices, its Pallas
halo kernel in interpret mode; the port's shards all lie on the CPU, where
kernels B1 and B4 run their plain versions. The graph is the one of
tests/test_node_shard.py (96 nodes, 3 relations, 900 edges, widths 8).
Tolerances: the encode at rtol 1e-4, atol 1e-5 (the JAX package's own
sharded-vs-dense test); the update's loss at rel 1e-5 and parameters at
rtol 1e-4, atol 1e-6 (its train-step test); top-K scores at rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from primekg_rgcn_tpu.config import ModelConfig as JModelConfig
from primekg_rgcn_tpu.config import TrainConfig as JTrainConfig
from primekg_rgcn_tpu.data.graph import build_rel_graph as j_build
from primekg_rgcn_tpu.evaluate import predict_cli as j_predict
from primekg_rgcn_tpu.evaluate.sharded_ranking import \
    build_sharded_topk as j_topk
from primekg_rgcn_tpu.models.rgcn import init_params as j_init
from primekg_rgcn_tpu.parallel import node_shard as jns
from primekg_rgcn_tpu.parallel.mesh import make_mesh as j_mesh
from primekg_rgcn_tpu.train import checkpoint as jckpt
from primekg_rgcn_tpu.train import neg_sampling as jneg
from primekg_rgcn_tpu.train.loop import TrainState
from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph as p_build
from primekg_rgcn_tpu_torch.evaluate import predict_cli as p_predict
from primekg_rgcn_tpu_torch.evaluate.sharded_ranking import \
    build_sharded_topk as p_topk
from primekg_rgcn_tpu_torch.models.rgcn import encoder_apply, param_leaves
from primekg_rgcn_tpu_torch.parallel import node_shard as pns
from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh as p_mesh
from primekg_rgcn_tpu_torch.train import cli as p_cli
from primekg_rgcn_tpu_torch.train.loop import make_optimizer
from primekg_rgcn_tpu_torch.train.multichip import ShardedTrainer
from primekg_rgcn_tpu_torch.train.torch_interop import params_from_jax

ARRAYS = ("src_local", "dst_local", "src_halo", "dst_halo", "t_src_local",
          "t_dst_local", "t_src_halo", "t_dst_halo", "inv_deg", "serve")
SCALARS = ("offsets_local", "offsets_halo", "n_loc", "halo_width",
           "num_nodes", "num_relations", "n_devices", "uniform_caps")


def _setup(seed=0, n=96, r=3, e=900):
    rng = np.random.default_rng(seed)
    src, dst, rel = (rng.integers(0, m, e) for m in (n, n, r))
    jg = j_build(src, dst, rel, n, r, bucket_pad_multiple=64,
                 use_native="never")
    pg = p_build(src, dst, rel, n, r, bucket_pad_multiple=64)
    jcfg = JModelConfig(num_nodes=n, num_relations=r, embedding_dim=8,
                        hidden_dim=8, dropout=0.0)
    jparams = j_init(jax.random.PRNGKey(seed), jcfg)
    return jg, pg, jcfg, jparams


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


@pytest.mark.parametrize("n_dev,uniform", [(2, None), (4, None), (4, True)])
def test_partition_equals_jax_bit_for_bit_and_csrs_cover(n_dev, uniform):
    jg, pg, _, _ = _setup()
    jsg = jns.partition_nodes(jg, n_dev, uniform_caps=uniform)
    psg = pns.partition_nodes(pg, n_dev, uniform_caps=uniform)
    for name in ARRAYS:
        ours = getattr(psg, name).numpy()
        theirs = np.asarray(getattr(jsg, name))
        assert ours.dtype == theirs.dtype, name
        np.testing.assert_array_equal(ours, theirs, err_msg=name)
    for name in SCALARS:
        assert getattr(psg, name) == getattr(jsg, name), name
    assert psg.uniform_caps == bool(uniform)
    # Each bucket's CSR (and its transpose's) expands to the group's real
    # keys; every key after them is the sentinel (the table's last row).
    n_loc, rows_h = psg.n_loc, n_dev * psg.halo_width
    real = 0
    for keys, rowptr, offs, rows in (
            (psg.dst_local, psg.rowptr_local, psg.offsets_local, n_loc + 1),
            (psg.t_src_local, psg.t_rowptr_local, psg.offsets_local,
             n_loc + 1),
            (psg.dst_halo, psg.rowptr_halo, psg.offsets_halo, n_loc + 1),
            (psg.t_src_halo, psg.t_rowptr_halo, psg.offsets_halo,
             rows_h + 1)):
        assert rowptr.shape == (n_dev, pg.num_relations, rows + 1)
        for d in range(n_dev):
            for r in range(pg.num_relations):
                bucket = keys[d, offs[r]:offs[r + 1]]
                counts = torch.diff(rowptr[d, r])
                c = int(rowptr[d, r, -1])
                assert int(rowptr[d, r, 0]) == 0 and bool((counts >= 0).all())
                assert torch.equal(torch.repeat_interleave(
                    torch.arange(rows, dtype=torch.int32), counts), bucket[:c])
                assert bool((bucket[c:] == rows - 1).all())
                real += c
    assert real == 2 * pg.num_edges   # forward and transpose, both groups


@pytest.mark.parametrize("n_dev,j_impl", [
    (2, "xla"), (2, "pallas"), (4, "xla"), (4, "pallas"), (5, "xla")])
def test_encode_matches_jax_and_the_dense_encoder(n_dev, j_impl):
    jg, pg, jcfg, jparams = _setup()
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    expected = np.asarray(jns.build_node_sharded_forward(
        j_mesh(n_dev), jns.partition_nodes(jg, n_dev), jcfg,
        halo_impl=j_impl, gather=False)(jparams))
    params = _port_params(jparams)
    mesh = p_mesh(n_dev, "cpu")
    psg = pns.partition_nodes(pg, n_dev)
    with torch.no_grad():
        sharded = pns.build_node_sharded_forward(
            mesh, psg, cfg, gather=False)(params)
        gathered = pns.build_node_sharded_forward(mesh, psg, cfg)(params)
        dense = encoder_apply(params, pg, cfg)
    assert sharded.shape == (n_dev, psg.n_loc, cfg.hidden_dim)
    np.testing.assert_allclose(sharded.numpy(), expected, rtol=1e-4,
                               atol=1e-5)
    assert torch.equal(gathered, sharded.reshape(-1, cfg.hidden_dim)[:96])
    np.testing.assert_allclose(gathered.numpy(), dense.numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_one_sgd_update_matches_the_jax_step(n_dev):
    jg, pg, jcfg, jparams = _setup(seed=3)
    b, lr = 64, 1e-2
    opt = optax.sgd(lr)
    j_step = jns.build_node_sharded_train_step(
        j_mesh(n_dev), jns.partition_nodes(jg, n_dev), jcfg,
        JTrainConfig(batch_size=b, lr=lr), opt)
    rng = np.random.default_rng(0)
    batch = np.stack([rng.integers(0, 96, b), rng.integers(0, 96, b),
                      rng.integers(0, 3, b), np.ones(b, np.int64)],
                     axis=1).astype(np.int32)
    key = jax.random.PRNGKey(7)
    p0 = jax.tree_util.tree_map(jnp.copy, jparams)
    state, (loss_j, acc_j) = j_step(
        TrainState(p0, opt.init(p0), jnp.zeros((), jnp.int32)),
        jnp.asarray(batch), key)

    # The JAX step's per-shard candidates: its negative key folded with the
    # shard index, over the shard's slice of the batch.
    k_neg, _ = jax.random.split(key)
    b_loc = b // n_dev
    cands = []
    for d in range(n_dev):
        sl = jnp.asarray(batch[d * b_loc:(d + 1) * b_loc])
        c = jneg.candidate_batch(jax.random.fold_in(k_neg, d), sl[:, 0],
                                 sl[:, 1], sl[:, 2], 96, 1, mask=sl[:, 3])
        h, t, r, y, w = (torch.from_numpy(np.array(x)) for x in c)
        cands.append((h.long(), t.long(), r.long(), y, w))

    params = _port_params(jparams, grad=True)
    tcfg = TrainConfig(batch_size=b, lr=lr, optimizer="sgd", grad_clip=0.0)
    step = pns.build_node_sharded_train_step(
        p_mesh(n_dev, "cpu"), pns.partition_nodes(pg, n_dev),
        ModelConfig.from_dict(jcfg.to_dict()), tcfg)
    stats = step.update(params, make_optimizer(tcfg, params), cands)
    assert stats[2].item() == 2 * b
    assert stats[0].item() / stats[2].item() == pytest.approx(
        float(loss_j), rel=1e-5)
    assert stats[1].item() / stats[2].item() == pytest.approx(float(acc_j))
    ours, theirs = _flat(params), _flat(state.params)
    assert ours.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_allclose(ours[k].detach().numpy(),
                                   np.asarray(theirs[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_sharded_topk_matches_jax():
    n_dev, n_loc, d, k = 4, 40, 16, 10
    num_nodes = n_dev * n_loc - 7        # the last shard holds padding rows
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(n_dev, n_loc, d)).astype(np.float32)
    rel = rng.normal(size=(3, d)).astype(np.float32)
    heads = rng.integers(0, num_nodes, 12)
    rels = rng.integers(0, 3, 12)
    s_j, i_j = (np.asarray(a) for a in j_topk(
        j_mesh(n_dev), jnp.asarray(emb), rel, num_nodes, k)(heads, rels))
    s_p, i_p = p_topk(p_mesh(n_dev, "cpu"), torch.from_numpy(emb),
                      torch.from_numpy(rel), num_nodes, k)(heads, rels)
    np.testing.assert_allclose(s_p.numpy(), s_j, rtol=1e-5)
    untied = np.ones_like(s_j, bool)
    untied[:, 1:] &= np.diff(s_j, axis=1) != 0
    untied[:, :-1] &= np.diff(s_j, axis=1) != 0
    np.testing.assert_array_equal(i_p.numpy()[untied], i_j[untied])
    assert int(i_p.max()) < num_nodes
    with pytest.raises(ValueError, match="exceeds"):
        p_topk(p_mesh(n_dev, "cpu"), torch.from_numpy(emb),
               torch.from_numpy(rel), num_nodes, n_loc + 1)


def test_refusals(tmp_path):
    _, pg, jcfg, jparams = _setup()
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    # A uniform-caps partition, refused before the scan was ported, now
    # encodes through it, as the unrolled loop does.
    params = _port_params(jparams)
    with torch.no_grad():
        scanned, unrolled = (pns.build_node_sharded_forward(
            p_mesh(2, "cpu"), pns.partition_nodes(pg, 2, uniform_caps=u),
            cfg)(params) for u in (True, False))
    np.testing.assert_allclose(scanned.numpy(), unrolled.numpy(), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="shards"):
        pns.build_node_sharded_forward(p_mesh(2, "cpu"),
                                       pns.partition_nodes(pg, 4), cfg)
    step = pns.build_node_sharded_train_step(
        p_mesh(4, "cpu"), pns.partition_nodes(pg, 4), cfg, TrainConfig())
    with pytest.raises(ValueError, match="divide"):
        step.draw(torch.zeros(6, 4, dtype=torch.long), None)
    edges = np.zeros((10, 3), np.int64)
    # The edge layout, refused before it was ported, now builds its step.
    trainer = ShardedTrainer(cfg, TrainConfig(), pg, pg, edges, edges,
                             tmp_path, shard="edge", n_devices=2,
                             device="cpu")
    assert callable(trainer.step_fn.update) and trainer.accum == 1
    with pytest.raises(ValueError, match="layout"):
        ShardedTrainer(cfg, TrainConfig(), pg, pg, edges, edges, tmp_path,
                       shard="replicated", n_devices=2, device="cpu")
    # --shard with --sample_fanouts is the data-parallel sampled step;
    # --zero1 and --zero3 together are refused.
    args = p_cli.parse_args(["--shard", "node", "--sample_fanouts", "4", "3"])
    assert args.shard == "node" and args.sample_fanouts == [4, 3]
    with pytest.raises(SystemExit):
        p_cli.parse_args(["--shard", "node", "--sample_fanouts", "4", "3",
                          "--zero1", "--zero3"])


ARGS = ["--synthetic", "--synthetic_scale", "0.02", "--epochs", "2",
        "--embedding_dim", "8", "--hidden_dim", "8", "--batch_size", "128",
        "--lr", "0.01", "--seed", "3", "--device", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_node_train")
    result = p_cli.main([*ARGS, "--shard", "node", "--n_devices", "4",
                         "--output_dir", str(out)])
    return out, result


def test_sharded_cli_trains_and_the_jax_package_reads_its_checkpoint(
        trained):
    out, result = trained
    hist = result["history"]
    assert len(hist["train_losses"]) == 2
    assert all(np.isfinite(hist["train_losses"] + hist["val_losses"]))
    assert hist["train_losses"][1] < hist["train_losses"][0]
    assert len((out / "metrics.jsonl").read_text().splitlines()) == 2
    payload = jckpt.load(out / "models" / "final_model.pt")
    assert payload["epoch"] == 2
    assert payload["model_config"]["hidden_dim"] == 8


@pytest.mark.parametrize("n_dev", [4, 8])
def test_sharded_serving_matches_dense_and_the_jax_sharded_cli(trained,
                                                              n_dev):
    """The port's --shard node serve against its dense serve and, on the
    8-device mesh, the JAX CLI's --shard node (which takes every device)."""
    out, _ = trained
    argv = ["--model_path", str(out / "models" / "final_model.pt"),
            "--data_dir", str(out / "synthetic_data"), "--heads", "0", "7",
            "30", "--relation", "0", "--topk", "10"]
    sharded = p_predict.main([*argv, "--device", "cpu", "--shard", "node",
                              "--n_devices", str(n_dev)])
    refs = [p_predict.main([*argv, "--device", "cpu"])]
    if n_dev == 8:
        refs.append(j_predict.main([*argv, "--shard", "node"]))
    for ref in refs:
        for a, b in zip(sharded, ref):
            assert a["head_id"] == b["head_id"]
            assert [p["tail_id"] for p in a["predictions"]] == [
                p["tail_id"] for p in b["predictions"]]
            np.testing.assert_allclose(
                [p["score"] for p in a["predictions"]],
                [p["score"] for p in b["predictions"]], rtol=1e-4)
