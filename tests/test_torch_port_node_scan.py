"""The node layer's relation scan against the JAX package's, on the CPU:
``ScanAccumulate`` against ``_scan_accumulate`` and its custom VJP, the
node-sharded encode and one update at 16 and 30 relations (where
``partition_nodes`` picks uniform caps by default, so the layer scans), the
scan at bf16, and what the scan saves for its backward.

The JAX side runs on meshes of the conftest's 8 host devices (XLA
segment-sum); the port's shards all lie on the CPU, where kernel B1 runs its
plain version. Tolerances: float32 rtol 2e-4, atol 2e-5 (the update's
parameters atol 1e-6 and loss rel 1e-5, as the node layout's update test);
bf16 rtol and atol 2e-2 of the largest magnitude, as
tests/test_torch_port_bf16_*.py.
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
from primekg_rgcn_tpu.models.rgcn import init_params as j_init
from primekg_rgcn_tpu.parallel import node_shard as jns
from primekg_rgcn_tpu.parallel.mesh import make_mesh as j_mesh
from primekg_rgcn_tpu.train import neg_sampling as jneg
from primekg_rgcn_tpu.train.loop import TrainState
from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph as p_build
from primekg_rgcn_tpu_torch.models.rgcn import encoder_apply, param_leaves
from primekg_rgcn_tpu_torch.ops.rgcn_segment import aggregate
from primekg_rgcn_tpu_torch.parallel import node_shard as pns
from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh as p_mesh
from primekg_rgcn_tpu_torch.train.loop import make_optimizer
from primekg_rgcn_tpu_torch.train.torch_interop import params_from_jax

N = 96


def _graphs(r, seed=0, e=1500):
    rng = np.random.default_rng(seed)
    src, dst, rel = (rng.integers(0, m, e) for m in (N, N, r))
    jg = j_build(src, dst, rel, N, r, bucket_pad_multiple=64,
                 use_native="never")
    pg = p_build(src, dst, rel, N, r, bucket_pad_multiple=64)
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


@pytest.mark.parametrize("group", ["local", "halo"])
@pytest.mark.parametrize("din,dout", [(8, 12), (12, 8)])
def test_scan_and_its_gradients_match_jax(din, dout, group):
    """Output and the gradients of table, inv and W for every shard's
    group, aggregate first (Din <= Dout) and transform first."""
    r, n_dev = 16, 2
    jg, pg = _graphs(r)
    jsg, psg = jns.partition_nodes(jg, n_dev), pns.partition_nodes(pg, n_dev)
    assert jsg.uniform_caps and psg.uniform_caps
    ops = pns.build_shard_ops(psg)
    n_loc = psg.n_loc
    offs = getattr(psg, f"offsets_{group}")
    cap = offs[1] - offs[0]
    assert set(np.diff(offs)) == {cap}
    rows = n_loc + 1 if group == "local" else n_dev * psg.halo_width + 1
    rng = np.random.default_rng(1)
    af = din <= dout
    for d in range(n_dev):
        def arr(name):
            return np.asarray(getattr(jsg, f"{name}_{group}"))[d].reshape(
                r, cap)

        table = rng.normal(size=(rows, din)).astype(np.float32)
        table[-1] = 0.0
        inv = rng.random((r, n_loc)).astype(np.float32)
        w = rng.normal(size=(r, din, dout)).astype(np.float32)
        g = rng.normal(size=(n_loc, dout)).astype(np.float32)
        out_j, vjp = jax.vjp(
            lambda t, i, w_: jns._scan_accumulate(
                n_loc, af, t, arr("src"), arr("dst"), arr("t_src"),
                arr("t_dst"), i, w_, None, None),
            jnp.asarray(table), jnp.asarray(inv), jnp.asarray(w))
        grads_j = vjp(jnp.asarray(g))
        ins = [torch.from_numpy(a).requires_grad_(True)
               for a in (table, inv, w)]
        out = pns.ScanAccumulate.apply(*ins, getattr(ops[d], group), n_loc,
                                       af, aggregate)
        out.backward(torch.from_numpy(g))
        for name, ours, theirs in (("out", out.detach(), out_j),
                                   *zip(("table", "inv", "w"),
                                        (t.grad for t in ins), grads_j)):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"shard {d} {name}")


@pytest.mark.parametrize("r", [16, 30])
def test_encode_and_one_update_match_the_jax_node_step(r):
    """Default ``uniform_caps`` (on from 16 relations): the encode against
    the JAX one and the dense encode, then one SGD update on the JAX
    step's candidates."""
    n_dev, b, lr = 4, 64, 1e-2
    jg, pg = _graphs(r, seed=r)
    jcfg = JModelConfig(num_nodes=N, num_relations=r, embedding_dim=8,
                        hidden_dim=8, dropout=0.0)
    jparams = j_init(jax.random.PRNGKey(r), jcfg)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    jsg, psg = jns.partition_nodes(jg, n_dev), pns.partition_nodes(pg, n_dev)
    assert psg.uniform_caps
    expected = np.asarray(jns.build_node_sharded_forward(
        j_mesh(n_dev), jsg, jcfg, gather=False)(jparams))
    with torch.no_grad():
        params = _port_params(jparams)
        sharded = pns.build_node_sharded_forward(
            p_mesh(n_dev, "cpu"), psg, cfg, gather=False)(params)
        dense = encoder_apply(params, pg, cfg)
    np.testing.assert_allclose(sharded.numpy(), expected, rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(sharded.reshape(-1, 8)[:N].numpy(),
                               dense.numpy(), rtol=2e-4, atol=2e-5)

    opt = optax.sgd(lr)
    j_step = jns.build_node_sharded_train_step(
        j_mesh(n_dev), jsg, jcfg, JTrainConfig(batch_size=b, lr=lr), opt)
    rng = np.random.default_rng(0)
    batch = np.stack([rng.integers(0, N, b), rng.integers(0, N, b),
                      rng.integers(0, r, b), np.ones(b, np.int64)],
                     axis=1).astype(np.int32)
    key = jax.random.PRNGKey(7)
    p0 = jax.tree_util.tree_map(jnp.copy, jparams)
    state, (loss_j, _) = j_step(
        TrainState(p0, opt.init(p0), jnp.zeros((), jnp.int32)),
        jnp.asarray(batch), key)
    k_neg, _ = jax.random.split(key)
    b_loc = b // n_dev
    cands = []
    for d in range(n_dev):
        sl = jnp.asarray(batch[d * b_loc:(d + 1) * b_loc])
        c = jneg.candidate_batch(jax.random.fold_in(k_neg, d), sl[:, 0],
                                 sl[:, 1], sl[:, 2], N, 1, mask=sl[:, 3])
        h, t, rr, y, w = (torch.from_numpy(np.array(x)) for x in c)
        cands.append((h.long(), t.long(), rr.long(), y, w))
    params = _port_params(jparams, grad=True)
    tcfg = TrainConfig(batch_size=b, lr=lr, optimizer="sgd", grad_clip=0.0)
    step = pns.build_node_sharded_train_step(p_mesh(n_dev, "cpu"), psg, cfg,
                                             tcfg)
    stats = step.update(params, make_optimizer(tcfg, params), cands)
    assert stats[0].item() / stats[2].item() == pytest.approx(
        float(loss_j), rel=1e-5)
    ours, theirs = _flat(params), _flat(state.params)
    for k in theirs:
        np.testing.assert_allclose(ours[k].detach().numpy(),
                                   np.asarray(theirs[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_scan_at_bf16_matches_jax_and_gathers_bf16_tables():
    r, n_dev = 16, 2
    jg, pg = _graphs(r, seed=5)
    jcfg = JModelConfig(num_nodes=N, num_relations=r, embedding_dim=16,
                        hidden_dim=16, dropout=0.0, compute_dtype="bfloat16")
    jparams = j_init(jax.random.PRNGKey(5), jcfg)
    expected = np.asarray(jns.build_node_sharded_forward(
        j_mesh(n_dev), jns.partition_nodes(jg, n_dev), jcfg,
        gather=False)(jparams))
    psg = pns.partition_nodes(pg, n_dev)
    tables = []

    def spy(table, op):
        tables.append(table.dtype)
        return aggregate(table, op)

    params = _port_params(jparams, grad=True)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    xs = pns.sharded_encoder(params, psg, pns.build_shard_ops(psg), cfg,
                             agg_fn=spy)
    got = torch.stack(xs).detach()
    scale = float(np.abs(expected).max())
    np.testing.assert_allclose(got.numpy(), expected, rtol=2e-2,
                               atol=2e-2 * scale)
    assert tables and set(tables) == {torch.bfloat16}
    # The backward's recompute and transpose gather bf16 tables too, and
    # every encoder parameter gets a finite float32 gradient.
    n_fwd = len(tables)
    sum(x.sum() for x in xs).backward()
    assert len(tables) > n_fwd and set(tables) == {torch.bfloat16}
    for p in param_leaves(params["encoder"]):
        assert p.grad.dtype == torch.float32
        assert bool(torch.isfinite(p.grad).all())


def _saved_bytes(r):
    """Bytes ``ScanAccumulate`` saves for its backward on one shard's local
    group, apart from inv and w_all (R x n_loc and R x Din x Dout)."""
    _, pg = _graphs(r, seed=6, e=200 * r)
    psg = pns.partition_nodes(pg, 2)
    ops = pns.build_shard_ops(psg)[0].local
    table = torch.randn(psg.n_loc + 1, 32, requires_grad=True)
    inv = torch.rand(r, psg.n_loc)
    w = torch.randn(r, 32, 32, requires_grad=True)
    seen = []

    def pack(t):
        if t.data_ptr() not in (inv.data_ptr(), w.data_ptr()):
            seen.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = pns.ScanAccumulate.apply(table, inv, w, ops, psg.n_loc, True,
                                       aggregate)
    out.sum().backward()
    assert table.grad.shape == table.shape and w.grad.shape == w.shape
    return sum(seen)


def test_the_scan_saves_nothing_that_grows_with_r():
    at16, at32 = _saved_bytes(16), _saved_bytes(32)
    assert at16 == at32 == (N // 2 + 1) * 32 * 4       # the table alone
