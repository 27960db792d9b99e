"""The port's training step against the JAX package's: the loss and every
parameter's gradient against ``jax.value_and_grad(_batch_loss)``, optimizer
steps against optax, negative sampling and BCE statistics, and gradient
accumulation.

Inputs come from ``np.random.default_rng``; JAX's candidates are handed to
the port, since the two packages' generators cannot agree. Tolerance as in
test_torch_parity.py: rtol 2e-4, atol 2e-5 times each tensor's largest
magnitude.
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
from primekg_rgcn_tpu.ops.rgcn_segment import rgcn_layer_segment as j_layer
from primekg_rgcn_tpu.train import loop as jloop
from primekg_rgcn_tpu.train import neg_sampling as jneg
from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph as p_build
from primekg_rgcn_tpu_torch.models.rgcn import init_params, param_leaves
from primekg_rgcn_tpu_torch.train import loop
from primekg_rgcn_tpu_torch.train import neg_sampling as pneg
from primekg_rgcn_tpu_torch.train.torch_interop import params_from_jax


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


def _dataset(seed, norm, n=60, r=3, e=500):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n // 2, e)
    dst = rng.integers(0, n, e)
    rel = rng.integers(0, r, e)
    edges = np.stack([src, dst, rel], 1).astype(np.int32)
    jg = j_build(src, dst, rel, n, r, bucket_pad_multiple=64, norm=norm,
                 use_native="never")
    pg = p_build(src, dst, rel, n, r, bucket_pad_multiple=64, norm=norm)
    return edges, jg, pg


@pytest.mark.parametrize("norm,masked,neg,bases,drop", [
    ("dense", False, 1, None, False),
    ("dense", True, 2, 2, False),
    ("edge", False, 1, 2, False),
    ("edge", True, 1, None, False),
    ("dense", True, 1, None, True),
])
def test_loss_and_gradients_match_jax_batch_loss(norm, masked, neg, bases,
                                                 drop):
    edges, jg, pg = _dataset(7 + neg, norm)
    n, r = 60, 3
    jcfg = JModelConfig(num_nodes=n, num_relations=r, embedding_dim=8,
                        hidden_dim=16, dropout=0.5 if drop else 0.0,
                        decoder_dropout=0.25 if drop else 0.0,
                        num_bases=bases)
    tcfg = JTrainConfig(batch_size=64, num_neg_samples=neg)
    jp = j_init(jax.random.PRNGKey(neg), jcfg)
    e = edges.shape[0]
    edges_pad = jnp.asarray(np.concatenate([edges, np.zeros((1, 3), np.int32)]))
    rng = np.random.default_rng(neg)
    batch_idx = rng.integers(0, e, 64).astype(np.int32)
    if masked:   # the last partial batch: padding slots index row E
        batch_idx[40:] = e
    key = jax.random.PRNGKey(11)

    (loss_j, (correct_j, count_j)), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jloop._batch_loss(
            p, jg, edges_pad, jnp.asarray(batch_idx), key, jcfg, tcfg,
            train=True, layer_fn=j_layer), has_aux=True))(jp)

    # The negatives _batch_loss drew: the same key split, the same call.
    k_neg, k_drop = jax.random.split(key)
    batch = np.asarray(edges_pad)[batch_idx]
    cands = jneg.candidate_batch(
        k_neg, jnp.asarray(batch[:, 0]), jnp.asarray(batch[:, 1]),
        jnp.asarray(batch[:, 2]), n, neg, mask=jnp.asarray(batch_idx < e))
    heads, tails, rels, labels, weights = (
        torch.from_numpy(np.array(c)) for c in cands)
    heads, tails, rels = heads.long(), tails.long(), rels.long()

    pp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    for p in param_leaves(pp):
        p.requires_grad_(True)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    masks = {}
    if drop:   # the keep masks model_apply drew from its dropout key
        k_enc, k_dec = jax.random.split(k_drop)
        masks = {
            "enc_mask": torch.from_numpy(np.array(jax.random.bernoulli(
                k_enc, 0.5, (n, jcfg.hidden_dim)))),
            "dec_mask": torch.from_numpy(np.array(jax.random.bernoulli(
                k_dec, 0.75, (heads.shape[0], jcfg.hidden_dim))))}
    loss, (correct, count) = loop.loss_from_candidates(
        pp, pg, heads, tails, rels, labels, weights, cfg, train=True,
        **masks)
    loss.backward()
    assert_close(loss.item(), float(loss_j))
    assert correct.item() == float(correct_j)
    assert count.item() == float(count_j) == (40 if masked else 64) * (1 + neg)
    ours, theirs = _flat(pp), _flat(grads_j)
    assert ours.keys() == theirs.keys()
    for k in theirs:
        assert_close(ours[k].grad.numpy(), theirs[k])


@pytest.mark.parametrize("opt,wd", [("adam", 0.0), ("adam", 0.01),
                                    ("adamw", 0.01), ("sgd", 0.01)])
@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_optimizer_steps_match_optax(opt, wd, clip):
    rng = np.random.default_rng(3)
    shapes = {"a": (6, 4), "b": {"c": (5,), "d": (3, 2)}}
    init = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s) * 2).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple)) for _ in range(5)]
    kw = dict(optimizer=opt, lr=0.05, weight_decay=wd, grad_clip=clip)

    jopt = jloop.make_optimizer(JTrainConfig(**kw))
    jparams = jax.tree_util.tree_map(jnp.asarray, init)
    state = jopt.init(jparams)
    jstep = jax.jit(lambda g, st, p: jopt.update(g, st, p))

    cfg = TrainConfig(**kw)
    params = params_from_jax(init)
    for p in param_leaves(params):
        p.requires_grad_(True)
    popt = loop.make_optimizer(cfg, params)
    for g in grads:
        updates, state = jstep(jax.tree_util.tree_map(jnp.asarray, g),
                               state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        gt = params_from_jax(g)
        for p, pg in zip(param_leaves(params), param_leaves(gt)):
            p.grad = pg
        loop.apply_update(popt, cfg)
        ours, theirs = _flat(params), _flat(jparams)
        for k in theirs:
            assert_close(ours[k].detach().numpy(), theirs[k])


def test_clip_has_no_epsilon():
    g = [torch.tensor([3.0, 4.0]), torch.tensor([0.0])]
    norm = loop.clip_by_global_norm_(g, 1.0)
    assert norm.item() == 5.0
    assert torch.equal(g[0], torch.tensor([3.0, 4.0]) * (1.0 / 5.0))
    g = [torch.tensor([0.6, 0.8])]
    loop.clip_by_global_norm_(g, 1.0)
    assert torch.equal(g[0], torch.tensor([0.6, 0.8]))


@pytest.mark.parametrize("neg", [1, 3])
def test_candidate_batch_layout(neg):
    rng = np.random.default_rng(neg)
    b, n = 4000, 1_000_000
    pos = [torch.from_numpy(rng.integers(0, 1000, b)) for _ in range(3)]
    mask = torch.from_numpy(rng.random(b) < 0.8)
    gen = torch.Generator().manual_seed(0)
    heads, tails, rels, labels, weights = pneg.candidate_batch(
        *pos, n, neg, mask=mask, generator=gen)
    assert heads.shape == tails.shape == rels.shape == (b * (1 + neg),)
    assert torch.equal(heads[:b], pos[0]) and torch.equal(tails[:b], pos[1])
    assert torch.equal(labels, torch.cat([torch.ones(b), torch.zeros(b * neg)]))
    rep = lambda t: t.repeat_interleave(neg)
    assert torch.equal(rels[b:], rep(pos[2]))
    assert torch.equal(weights, torch.cat([mask.float(), rep(mask.float())]))
    kept_head = heads[b:] == rep(pos[0])
    kept_tail = tails[b:] == rep(pos[1])
    assert bool((kept_head | kept_tail).all())   # one side is replaced
    corrupt_head = ~kept_head
    assert abs(corrupt_head.float().mean().item() - 0.5) < 0.02
    assert int(heads.min()) >= 0 and int(heads.max()) < n
    assert int(tails.min()) >= 0 and int(tails.max()) < n
    no_mask = pneg.candidate_batch(*pos, n, neg, generator=gen)[4]
    assert torch.equal(no_mask, torch.ones(b * (1 + neg)))


def test_bce_stats_match_jax():
    rng = np.random.default_rng(0)
    scores = (rng.standard_normal(300) * 20).astype(np.float32)
    scores[:4] = [80.0, -80.0, 0.0, 1e-3]
    labels = (rng.random(300) < 0.5).astype(np.float32)
    weights = (rng.random(300) < 0.9).astype(np.float32)
    ours = pneg.bce_stats(*(torch.from_numpy(a)
                            for a in (scores, labels, weights)))
    theirs = jneg.bce_stats(*(jnp.asarray(a)
                              for a in (scores, labels, weights)))
    for a, b in zip(ours, theirs):
        assert_close(a.item(), float(b))


def _toy(seed=0, dropout=0.0):
    rng = np.random.default_rng(seed)
    n, r, e = 60, 3, 600
    src, dst, rel = (rng.integers(0, m, e) for m in (n, n, r))
    graph = p_build(src, dst, rel, n, r, bucket_pad_multiple=64)
    edges = np.stack([src, dst, rel], 1)
    cfg = ModelConfig(num_nodes=n, num_relations=r, embedding_dim=8,
                      hidden_dim=16, dropout=dropout)
    return graph, edges, cfg


def _trainable(cfg, seed=0):
    params = init_params(torch.Generator().manual_seed(seed), cfg)
    for p in param_leaves(params):
        p.requires_grad_(True)
    return params


@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_accumulation_of_two_batches_is_the_double_batch(clip):
    graph, edges, cfg = _toy()
    rng = np.random.default_rng(1)
    b = 48

    def cands(k):
        heads, tails = (torch.from_numpy(rng.integers(0, 60, k))
                        for _ in range(2))
        rels = torch.from_numpy(rng.integers(0, 3, k))
        labels = torch.from_numpy((rng.random(k) < 0.5).astype(np.float32))
        return heads, tails, rels, labels, torch.ones(k)

    c1, c2 = cands(b), cands(b)
    c12 = tuple(torch.cat([x, y]) for x, y in zip(c1, c2))
    tcfg = TrainConfig(optimizer="sgd", lr=0.1, grad_clip=clip,
                       gradient_accumulation_steps=2)
    runs = []
    for micro in ([c1, c2], [c12]):
        params = _trainable(cfg)
        opt = loop.make_optimizer(tcfg, params)
        stats = loop.update_step(params, opt, graph, micro, cfg, tcfg)
        runs.append((params, stats))
    (pa, sa), (pb, sb) = runs
    assert_close(sa[0].item() / sa[2].item(), sb[0].item() / sb[2].item())
    assert sa[2].item() == sb[2].item() == 2 * b
    for a, bb in zip(param_leaves(pa), param_leaves(pb)):
        assert_close(a.grad.numpy(), bb.grad.numpy())
        assert_close(a.detach().numpy(), bb.detach().numpy())


@pytest.mark.parametrize("accum,updates", [(1, 6), (2, 3)])
def test_epoch_update_count_and_masked_final_batch(accum, updates):
    graph, edges, cfg = _toy(dropout=0.1)
    tcfg = TrainConfig(batch_size=100, gradient_accumulation_steps=accum,
                       lr=1e-2)
    params = _trainable(cfg)
    opt = loop.make_optimizer(tcfg, params)
    epoch = loop.build_train_epoch(graph, edges[:550], cfg, tcfg, params, opt)
    loss, acc = epoch(torch.Generator().manual_seed(0),
                      torch.Generator().manual_seed(1))
    state = opt.state[next(iter(param_leaves(params)))]
    assert int(state["step"]) == updates
    assert np.isfinite(loss.item()) and 0.0 <= acc.item() <= 1.0


def test_loss_decreases_and_eval_is_deterministic():
    graph, edges, cfg = _toy(dropout=0.1)
    tcfg = TrainConfig(batch_size=128, lr=1e-2)
    params = _trainable(cfg)
    opt = loop.make_optimizer(tcfg, params)
    epoch = loop.build_train_epoch(graph, edges, cfg, tcfg, params, opt)
    host, dev = torch.Generator().manual_seed(0), torch.Generator().manual_seed(1)
    losses = [epoch(host, dev)[0].item() for _ in range(5)]
    assert losses[-1] < losses[0]
    evaluate = loop.build_eval_epoch(graph, edges[:100], cfg, tcfg)
    a = evaluate(params, torch.Generator().manual_seed(9))
    b = evaluate(params, torch.Generator().manual_seed(9))
    assert a[0].item() == b[0].item() and a[1].item() == b[1].item()


def _same(a, b, where=""):
    """Two loaded checkpoints hold equal tensors and values."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert type(a) is type(b) and list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, f"{where}: {a!r} vs {b!r}"


def test_save_async_writes_the_state_of_the_call(tmp_path, monkeypatch):
    """The writer thread is held until the caller has changed the tensors
    in place and appended to a list: the file still holds the values of
    the moment of the call. A second save to the same path waits for the
    first; a writer error surfaces in wait_for_saves."""
    import threading

    from primekg_rgcn_tpu_torch.train import checkpoint as ckpt

    gate = threading.Event()
    real_save = ckpt.save

    def held_save(path, payload):
        assert gate.wait(timeout=60)
        real_save(path, payload)

    monkeypatch.setattr(ckpt, "save", held_save)
    w = torch.arange(6, dtype=torch.float32)
    history = [1.0]
    saver = ckpt.AsyncSaver()
    saver.save_async(tmp_path / "a.pt", {"w": w, "history": history,
                                         "nested": {"w": w[:2]}})
    w.add_(100.0)
    history.append(2.0)
    gate.set()
    saver.save_async(tmp_path / "a.pt", {"w": w, "history": history})
    saver.save_async(tmp_path / "b.pt", {"w": w * 0})
    saver.wait_for_saves()
    assert torch.equal(torch.load(tmp_path / "a.pt")["w"], w)
    assert torch.load(tmp_path / "a.pt")["history"] == [1.0, 2.0]
    assert torch.equal(torch.load(tmp_path / "b.pt")["w"], w * 0)

    gate.clear()
    saver.save_async(tmp_path / "c.pt", {"w": w, "history": history,
                                         "nested": {"w": w[:2]}})
    w.add_(1.0)
    history.append(3.0)
    gate.set()
    saver.wait_for_saves()
    got = torch.load(tmp_path / "c.pt")
    assert torch.equal(got["w"], w - 1.0)
    assert torch.equal(got["nested"]["w"], w[:2] - 1.0)
    assert got["history"] == [1.0, 2.0]

    monkeypatch.setattr(ckpt, "save", lambda path, payload: 1 / 0)
    saver.save_async(tmp_path / "d.pt", {"w": w})
    with pytest.raises(ZeroDivisionError):
        saver.wait_for_saves()


def test_trainer_checkpoints_equal_synchronous_saves(tmp_path, monkeypatch):
    """Every best and periodic checkpoint goes through the async writer;
    after training, each file loads equal to a synchronous save of the
    payload of its last call, and the final model too."""
    from primekg_rgcn_tpu_torch.train import checkpoint as ckpt

    shadow = tmp_path / "sync"
    real_async = ckpt.AsyncSaver.save_async
    calls = []

    def recording(self, path, payload):
        calls.append(path.name)
        ckpt.save(shadow / path.parent.name / path.name, payload)
        return real_async(self, path, payload)

    monkeypatch.setattr(ckpt.AsyncSaver, "save_async", recording)
    graph, edges, cfg = _toy(dropout=0.1)
    tcfg = TrainConfig(batch_size=128, lr=1e-2, epochs=2, save_every=1)
    trainer = loop.Trainer(cfg, tcfg, graph, graph, edges[:500], edges[500:],
                           tmp_path / "run", device="cpu")
    trainer.train()
    assert "best_model.pt" in calls
    assert [c for c in calls if c.startswith("checkpoint_epoch")] == [
        f"checkpoint_epoch_{e}.pt" for e in (1, 2)]
    written = sorted((tmp_path / "run").glob("*/*.pt"))
    assert {p.name for p in written} >= {"best_model.pt", "final_model.pt",
                                         "checkpoint_epoch_2.pt"}
    for p in written:
        if p.name == "final_model.pt":
            continue
        _same(torch.load(p, weights_only=False),
              torch.load(shadow / p.parent.name / p.name,
                         weights_only=False), p.name)
    final = ckpt.load(tmp_path / "run" / "models" / "final_model.pt")
    want = _flat(trainer.params)
    got = _flat(final["params"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k].detach()), k
