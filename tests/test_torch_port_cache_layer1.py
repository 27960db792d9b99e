"""The layer-1 history cache (``--cache_layer1``), on the CPU, against the
JAX package: ``encoder_apply_cached`` (embeddings, the updated cache and
every gradient, with the true histories and with a stale cache, float32 and
bf16), the cached sparse step for two steps on the JAX step's candidates,
draws and dropout masks (loss, table, other parameters, cache), the
``layout=`` routing of ``resolve_sampler``, every refusal, the
``SampledTrainer`` warm start (JAX's conv1 output) and its resume with the
cache round-tripped, and ``train/cli --cache_layer1``.

Tolerance: float32, rtol 2e-4 and atol 2e-5 of each tensor's largest
magnitude (test_torch_parity.py); bf16, 2e-2 of it and rtol 2e-2
(test_torch_port_bf16_paths.py).
"""

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
from primekg_rgcn_tpu.ops.rgcn_segment import rgcn_layer_segment as j_layer
from primekg_rgcn_tpu.train import neg_sampling as jneg
from primekg_rgcn_tpu.train import sampled as jsampled
from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.data import sampling as ps
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph as p_build
from primekg_rgcn_tpu_torch.models import rgcn as pmodel
from primekg_rgcn_tpu_torch.train import checkpoint as pckpt
from primekg_rgcn_tpu_torch.train import cli as pcli
from primekg_rgcn_tpu_torch.train import sampled as psampled
from test_torch_port_sampled_train import (JaxDraws, _flat, _port_params,
                                           _torch)

N, R, E = 80, 12, 700


def _close(ours, expected, bf16=False):
    ours = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) \
        else np.asarray(ours, np.float32)
    expected = np.asarray(expected, np.float32)
    scale = max(float(np.abs(expected).max()), 1e-30)
    tol = (2e-2, 2e-2) if bf16 else (2e-4, 2e-5)
    np.testing.assert_allclose(ours, expected, rtol=tol[0],
                               atol=tol[1] * scale)


def _graphs(seed=0, n=N, r=R, e=E):
    """A relation-sparse graph (12 relations, few edges each) in both
    packages, and its directed edges."""
    rng = np.random.default_rng(seed)
    src, dst, rel = (rng.integers(0, n, e), rng.integers(0, n, e),
                     rng.integers(0, r, e))
    jg = j_build(src, dst, rel, n, r, bucket_pad_multiple=64,
                 use_native="never")
    pg = p_build(src, dst, rel, n, r, bucket_pad_multiple=64)
    return jg, pg, np.stack([src, dst, rel], 1).astype(np.int32)


def _jcfg(dtype="float32", dropout=0.5, n=N, r=R):
    return JModelConfig(num_nodes=n, num_relations=r, embedding_dim=8,
                        hidden_dim=8, dropout=dropout, compute_dtype=dtype)


def _jparams(jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(seed), jcfg))


# -- encoder_apply_cached --------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("history", ["true", "stale"])
def test_encoder_apply_cached_matches_jax(history, dtype):
    """One truncate hop at a budget that covers every in-edge (exact
    neighbourhoods), duplicated seeds, dropout from a given mask: the
    embeddings, the pushed cache and the gradients of every parameter,
    with the cache holding the true conv1 rows of every node ("true") or
    random rows ("stale")."""
    bf16 = dtype == "bfloat16"
    jg, pg, _ = _graphs()
    jcfg = _jcfg(dtype)
    jp = _jparams(jcfg)
    jc = js.build_combined_csr(jg)
    budget = int(np.asarray(jc.deg_total).max())
    seeds = np.array([0, 5, 5, 17, 3, 0, 42, 61, 79], np.int32)
    batch = js.sample_batch_combined(jax.random.PRNGKey(0), jc,
                                     jnp.asarray(seeds), [budget],
                                     mode="truncate")
    cdt = jnp.bfloat16 if bf16 else jnp.float32
    if history == "true":
        cache = np.asarray(j_layer(jp["encoder"]["conv1"],
                                   jp["encoder"]["node_emb"], jg,
                                   compute_dtype=cdt).astype(cdt))
    else:
        cache = np.asarray(jnp.asarray(np.random.default_rng(1).normal(
            0, 0.5, (N, 8)).astype(np.float32), cdt))
    k_drop = jax.random.PRNGKey(3)
    mask = jax.random.bernoulli(k_drop, 0.5, (batch.frontier.shape[0], 8))
    g = np.random.default_rng(2).normal(size=(len(seeds), 8)).astype(
        np.float32)

    def f(p):
        emb, new = jmodel.encoder_apply_cached(
            p, batch, jnp.asarray(cache), jcfg, train=True,
            dropout_rng=k_drop)
        return emb, new
    (emb_j, new_j), vjp = jax.vjp(f, jax.tree_util.tree_map(jnp.asarray, jp))
    (grads_j,) = vjp((jnp.asarray(g), jnp.zeros_like(new_j)))

    cfg = ModelConfig.from_dict(jcfg.to_dict())
    pp = _port_params(jp)
    pb = ps.SampledBatch(
        frontier=torch.from_numpy(np.array(batch.frontier)),
        blocks=(ps.CombinedBlock(**{
            k: torch.from_numpy(np.array(v)) if isinstance(v, jax.Array)
            else v for k, v in batch.blocks[0]._asdict().items()}),),
        seed_gather=torch.from_numpy(np.array(batch.seed_gather)))
    p_cache = torch.from_numpy(np.array(cache, np.float32)).to(
        torch.bfloat16 if bf16 else torch.float32)
    emb, new = pmodel.encoder_apply_cached(pp, pb, p_cache, cfg, train=True,
                                           mask=_torch(mask))
    assert new is p_cache and new.dtype == p_cache.dtype
    assert emb.dtype == torch.float32 and emb.shape == (len(seeds), 8)
    emb.backward(torch.from_numpy(g))
    _close(emb, emb_j, bf16)
    _close(new, new_j, bf16)
    ours, theirs = _flat(pp), _flat(grads_j)
    for k in theirs:
        if ours[k].grad is None:   # the decoder: not in the encode
            assert not np.asarray(theirs[k]).any(), k
        else:
            _close(ours[k].grad, theirs[k], bf16)
    assert ours["encoder/node_emb"].grad.abs().max() > 0
    seed_rows = np.unique(seeds)
    others = np.setdiff1d(np.arange(N), seed_rows)
    # Only the seeds' rows were pushed.
    np.testing.assert_array_equal(new.float().numpy()[others],
                                  np.asarray(cache, np.float32)[others])
    if history == "true" and not bf16:
        # Exact neighbourhoods and true histories: the cached encode is the
        # full-graph encode at the seeds (no dropout), and the push
        # rewrites the true rows.
        with torch.no_grad():
            p_cache = torch.from_numpy(cache.copy())
            emb0, _ = pmodel.encoder_apply_cached(pp, pb, p_cache, cfg)
            full = pmodel.encoder_apply(pp, pg, cfg)
        _close(emb0, full[torch.from_numpy(seeds).long()])
        _close(p_cache, cache)


def test_cached_encoder_refuses_two_hops_and_an_identity_block():
    _, pg, _ = _graphs()
    cfg = ModelConfig.from_dict(_jcfg().to_dict())
    pp = pmodel.init_params(torch.Generator().manual_seed(0), cfg)
    pc = ps.build_combined_csr(pg)
    cache = torch.zeros(N, 8)
    two = ps.sample_batch_combined(JaxDraws(jax.random.PRNGKey(0)), pc,
                                   torch.arange(8), (4, 4))
    with pytest.raises(ValueError, match="exactly 1 sampled hop"):
        pmodel.encoder_apply_cached(pp, two, cache, cfg)
    ident = ps.sample_batch_combined(JaxDraws(jax.random.PRNGKey(0)), pc,
                                     torch.arange(8), (4,),
                                     allow_ident=True)
    assert ident.blocks[0].ident
    with pytest.raises(ValueError, match="dedup-frontier CombinedBlock"):
        pmodel.encoder_apply_cached(pp, ident, cache, cfg)


# -- the cached step -------------------------------------------------------------


def _jax_cached_batch(jg, jcfg, pos, key, fanouts, mode):
    """What the JAX cached step draws from ``key``: the candidates, one hop
    (``allow_ident=False``), the sampler's key and the keep mask over the
    hop's [frontier, hidden] table."""
    csr, budgets, _ = jsampled.resolve_sampler(jg, fanouts, "combined", mode)
    k_neg, k_sample, k_drop = jax.random.split(key, 3)
    cands = jneg.candidate_batch(k_neg, pos[:, 0], pos[:, 1], pos[:, 2],
                                 jcfg.num_nodes, 1)
    seeds = jnp.concatenate([cands[0], cands[1]]).astype(jnp.int32)
    batch = js.sample_batch_combined(k_sample, csr, seeds, budgets[:1],
                                     mode=mode, allow_ident=False)
    mask = jax.random.bernoulli(k_drop, 1.0 - jcfg.dropout,
                                (batch.frontier.shape[0], jcfg.hidden_dim))
    return cands, k_sample, mask


@pytest.mark.parametrize("dtype,mode", [("float32", "uniform"),
                                        ("bfloat16", "uniform"),
                                        ("float32", "block")])
def test_cached_step_matches_jax(dtype, mode):
    """Two sparse SGD steps from a cold cache: after each, the loss, the
    table, every other parameter and the cache against the JAX step's."""
    bf16 = dtype == "bfloat16"
    jg, pg, edges = _graphs(seed=4)
    jcfg = _jcfg(dtype)
    jp = _jparams(jcfg, seed=1)
    lr = 0.5
    jstep = jsampled.build_sampled_train_step(
        jg, jcfg, JTrainConfig(batch_size=16, lr=lr), optax.sgd(lr),
        fanouts=(5, 4), mode=mode, sparse_emb=True, cache_layer1=True)
    state = jstep.init_state(jax.tree_util.tree_map(jnp.asarray, jp))
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    step = psampled.build_sampled_train_step(
        pg, cfg, TrainConfig(batch_size=16, optimizer="sgd", lr=lr,
                             grad_clip=0.0),
        fanouts=(5, 4), mode=mode, sparse_emb=True, cache_layer1=True,
        device="cpu")
    assert step.use_combined
    pp = _port_params(jp)
    opt = step.init_optimizer(pp)
    assert isinstance(opt, psampled.CachedOptimizer)
    assert opt.cache.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert not opt.cache.any()
    rng = np.random.default_rng(2)
    key = jax.random.PRNGKey(7)
    for _ in range(2):
        pos = jnp.asarray(edges[rng.integers(0, E, 16)])
        key, k = jax.random.split(key)
        state, (loss_j, _) = jstep(state, pos, k)
        cands, k_sample, mask = _jax_cached_batch(jg, jcfg, pos, k, (5, 4),
                                                  mode)
        loss, _ = step(pp, opt, _torch(pos, long=True), torch.Generator(),
                       cands=tuple(_torch(c, long=i < 3)
                                   for i, c in enumerate(cands)),
                       draw=JaxDraws(k_sample), enc_mask=_torch(mask))
        _close(loss.item(), float(loss_j), bf16)
        theirs = _flat(jax.tree_util.tree_map(np.asarray, state.params))
        for name, p in _flat(pp).items():
            _close(p, theirs[name], bf16)
        _close(opt.cache, state.opt_state[1], bf16)
    assert opt.cache.abs().max() > 0


def test_cached_step_trains_and_threads_the_cache():
    """Many cached steps on one graph: the loss falls, the histories fill
    and the table moves (the JAX package's test_cached_step_trains_and_
    threads_cache, on the port alone)."""
    _, pg, edges = _graphs()
    cfg = ModelConfig.from_dict(_jcfg(dropout=0.0).to_dict())
    step = psampled.build_sampled_train_step(
        pg, cfg, TrainConfig(batch_size=32, optimizer="adam", lr=0.05,
                             grad_clip=0.0),
        fanouts=(5, 4), sparse_emb=True, table_opt="adafactor",
        cache_layer1=True, device="cpu")
    pp = pmodel.init_params(torch.Generator().manual_seed(0), cfg)
    for p in pmodel.param_leaves(pp):
        p.requires_grad_(True)
    emb0 = pp["encoder"]["node_emb"].detach().clone()
    opt = step.init_optimizer(pp)
    assert isinstance(opt.base, psampled.SplitOptimizer)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    edges_t = torch.from_numpy(edges.astype(np.int64))
    losses = [step(pp, opt, edges_t[rng.integers(0, E, 32)], gen)[0].item()
              for _ in range(120)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.01
    assert opt.cache.abs().max() > 0
    assert (pp["encoder"]["node_emb"] - emb0).abs().max() > 1e-4


# -- layout routing and refusals ---------------------------------------------


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("layout", ["auto", "combined", "per-relation"])
def test_resolve_sampler_layout_matches_jax(kind, layout):
    """A relation-dense graph (3 relations: "auto" takes the per-relation
    layout) and a relation-sparse one (12: "auto" takes combined), each
    forced either way: the same layout and budgets as the JAX package."""
    jg, pg, _ = (_graphs(seed=5, n=60, r=3, e=500) if kind == "dense"
                 else _graphs())
    csr, budgets, combined = psampled.resolve_sampler(pg, (5, 4), layout)
    jcsr, jbudgets, jcombined = jsampled.resolve_sampler(jg, (5, 4), layout)
    assert combined == jcombined
    assert budgets == tuple(jbudgets)
    assert isinstance(csr, ps.CombinedCsr if combined else ps.CsrCache)
    if layout == "auto":
        assert combined == (kind == "sparse")


def test_cached_step_takes_combined_on_a_relation_dense_graph():
    """"auto" would take the per-relation layout on 3 relations; the cache
    needs the combined one (as the JAX step's override)."""
    _, pg, edges = _graphs(seed=5, n=60, r=3, e=500)
    cfg = ModelConfig.from_dict(_jcfg(n=60, r=3).to_dict())
    step = psampled.build_sampled_train_step(
        pg, cfg, TrainConfig(batch_size=16, optimizer="sgd", grad_clip=0.0),
        fanouts=(5, 4), sparse_emb=True, cache_layer1=True, device="cpu")
    assert step.use_combined
    pp = pmodel.init_params(torch.Generator().manual_seed(0), cfg)
    for p in pmodel.param_leaves(pp):
        p.requires_grad_(True)
    opt = step.init_optimizer(pp)
    gen = torch.Generator().manual_seed(1)
    for _ in range(3):
        loss, _ = step(pp, opt, torch.from_numpy(edges[:16].astype(np.int64)),
                       gen)
        assert np.isfinite(loss.item())


def _refuse_build(**kw):
    _, pg, _ = _graphs()
    cfg = ModelConfig.from_dict(_jcfg().to_dict())
    step = psampled.build_sampled_train_step(
        kw.pop("csr", pg), cfg, TrainConfig(optimizer="sgd", grad_clip=0.0),
        fanouts=(5, 4), device="cpu", **kw)
    step.init_optimizer(pmodel.init_params(torch.Generator(), cfg))


def _refuse_trainer(tmp_path, **kw):
    _, pg, edges = _graphs()
    cfg = ModelConfig.from_dict(_jcfg().to_dict())
    psampled.SampledTrainer(cfg, TrainConfig(batch_size=32, optimizer="sgd",
                                             grad_clip=0.0), pg, pg, edges,
                            edges[:8], tmp_path, fanouts=(5, 4),
                            device="cpu", **kw)


REFUSALS = [
    (lambda tmp: _refuse_build(cache_layer1=True), "requires sparse_emb"),
    (lambda tmp: _refuse_build(sparse_emb=True, cache_layer1=True,
                               layout="per-relation"),
     "combined pick layout"),
    (lambda tmp: _refuse_build(sparse_emb=True, cache_layer1=True,
                               cache_init=np.zeros((N, 5), np.float32)),
     "cache_init shape"),
    (lambda tmp: _refuse_build(sparse_emb=True, layout="grouped"),
     "unknown layout"),
    (lambda tmp: _refuse_trainer(tmp, sparse_emb=True, cache_layer1=True,
                                 n_devices=2), "single-chip"),
    (lambda tmp: _refuse_trainer(tmp, cache_layer1=True),
     "requires --sparse_emb"),
]


@pytest.mark.parametrize("case,match", REFUSALS)
def test_cache_layer1_refusals(case, match, tmp_path):
    with pytest.raises(ValueError, match=match):
        case(tmp_path)


def test_per_relation_layout_refuses_a_combined_csr():
    _, pg, _ = _graphs()
    with pytest.raises(ValueError, match="per-relation"):
        psampled.resolve_sampler(ps.build_combined_csr(pg), (5, 4),
                                 "per-relation")


# -- SampledTrainer and the CLI -----------------------------------------------


def _jax_params_of(params):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.detach().numpy()),
                                  params)


def test_trainer_warm_start_matches_jax_conv1(tmp_path, monkeypatch):
    """The histories start as one full-graph conv1 pass of the initial
    parameters (JAX's rgcn_layer_segment on the same parameters); above
    CACHE_WARM_MAX_EDGES padded edges they start at zero."""
    jg, pg, edges = _graphs()
    cfg = ModelConfig.from_dict(_jcfg().to_dict())
    tcfg = TrainConfig(batch_size=64, lr=0.05, epochs=1, optimizer="sgd",
                       grad_clip=0.0)
    t = psampled.SampledTrainer(cfg, tcfg, pg, pg, edges, edges[:100],
                                tmp_path / "warm", fanouts=(5, 4),
                                sparse_emb=True, cache_layer1=True,
                                device="cpu")
    jp = _jax_params_of(t.params)
    want = j_layer(jp["encoder"]["conv1"], jp["encoder"]["node_emb"], jg)
    _close(t.optimizer.cache, want)
    monkeypatch.setattr(psampled, "CACHE_WARM_MAX_EDGES",
                        pg.padded_num_edges - 1)
    cold = psampled.SampledTrainer(cfg, tcfg, pg, pg, edges, edges[:100],
                                   tmp_path / "cold", fanouts=(5, 4),
                                   sparse_emb=True, cache_layer1=True,
                                   device="cpu")
    assert not cold.optimizer.cache.any()


def test_trainer_resume_round_trips_the_cache(tmp_path):
    """The (rest adam state, factored table state, cache) round-trips
    through the checkpoint: resumed, the trainer holds the trained run's
    histories, not a fresh warm start, and continues the history."""
    _, pg, edges = _graphs()
    cfg = ModelConfig.from_dict(_jcfg().to_dict())
    tcfg = TrainConfig(batch_size=64, lr=0.05, epochs=2, optimizer="adam",
                       grad_clip=0.0)
    kw = dict(fanouts=(5, 4), sparse_emb=True, table_opt="adafactor",
              cache_layer1=True, device="cpu")
    t = psampled.SampledTrainer(cfg, tcfg, pg, pg, edges, edges[:100],
                                tmp_path / "out", **kw)
    warm = t.optimizer.cache.clone()
    hist = t.train()["history"]
    assert len(hist["val_losses"]) == 2
    assert not torch.equal(t.optimizer.cache, warm)
    saved = pckpt.load(tmp_path / "out" / "models" / "final_model.pt")
    cache = saved["optimizer_state_dict"]["cache"]
    assert cache.shape == (N, 8)
    assert torch.equal(cache, t.optimizer.cache)

    t2 = psampled.SampledTrainer(
        cfg, TrainConfig(**{**tcfg.to_dict(), "epochs": 3}), pg, pg, edges,
        edges[:100], tmp_path / "out2", **kw)
    t2.resume(tmp_path / "out" / "models" / "final_model.pt")
    assert torch.equal(t2.optimizer.cache, cache)
    assert torch.equal(t2.optimizer.base.table["v_col"],
                       saved["optimizer_state_dict"]["base"]["table"]
                       ["v_col"])
    hist2 = t2.train()["history"]
    assert hist2["train_losses"][:2] == hist["train_losses"]
    assert len(hist2["train_losses"]) == 3


CLI = ["--synthetic", "--synthetic_scale", "0.02", "--epochs", "1",
       "--embedding_dim", "8", "--hidden_dim", "8", "--batch_size", "64",
       "--seed", "3", "--sample_fanouts", "4", "3", "--device", "cpu"]


def test_cli_cache_layer1_trains_one_epoch(tmp_path):
    result = pcli.main([*CLI, "--sparse_emb", "--optimizer", "sgd",
                        "--grad_clip", "0", "--lr", "0.5", "--cache_layer1",
                        "--output_dir", str(tmp_path)])
    hist = result["history"]
    assert np.all(np.isfinite(hist["train_losses"] + hist["val_losses"]))
    payload = pckpt.load(tmp_path / "models" / "final_model.pt")
    cfg = ModelConfig.from_dict(payload["model_config"])
    cache = payload["optimizer_state_dict"]["cache"]
    assert cache.shape == (cfg.num_nodes, 8) and cache.abs().max() > 0


def test_cli_refuses_cache_layer1_without_sample_fanouts():
    with pytest.raises(SystemExit):
        pcli.parse_args(["--cache_layer1"])
    args = pcli.parse_args(["--sample_fanouts", "4", "3", "--sparse_emb",
                            "--cache_layer1"])
    assert args.cache_layer1
