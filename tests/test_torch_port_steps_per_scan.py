"""steps_per_scan in the port: the epochs that run as CUDA graphs on the
card (train/graphs.py), run here as their eager bodies.

On the CPU ``StepGraphs.run`` calls each body. These tests run the
bodies as the card would replay them instead (``RecordingGraphs``: a
key's captured body runs again, its outputs rewritten in place), hold the
segmented epochs against the per-update loop bit for bit (one thread: CPU
reductions on several threads differ in the last bits between runs) and
record the segment layout the card would capture: full segments of K and
one remainder, as the JAX package's scan segments, whose own fused and
segmented epochs are held together beside them. The restricted final
layer's two parts, the ranges that give the overflow flag and the branch
the flag picks, are held against the JAX package's ``_batch_loss``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_analysis_data import one_thread
from primekg_rgcn_tpu.config import ModelConfig as JModelConfig
from primekg_rgcn_tpu.config import TrainConfig as JTrainConfig
from primekg_rgcn_tpu.data.graph import build_rel_graph as j_build
from primekg_rgcn_tpu.models.rgcn import init_params as j_init
from primekg_rgcn_tpu.ops import rgcn_final_layer as jfl
from primekg_rgcn_tpu.ops.rgcn_segment import rgcn_layer_segment as j_layer
from primekg_rgcn_tpu.train import cli as jcli
from primekg_rgcn_tpu.train import loop as jloop
from primekg_rgcn_tpu.train import neg_sampling as jneg
from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph as p_build
from primekg_rgcn_tpu_torch.models.rgcn import init_params, param_leaves
from primekg_rgcn_tpu_torch.ops import rgcn_final_layer as pfl
from primekg_rgcn_tpu_torch.train import checkpoint as pckpt
from primekg_rgcn_tpu_torch.train import cli as pcli
from primekg_rgcn_tpu_torch.train import graphs as pgraphs
from primekg_rgcn_tpu_torch.train import loop
from primekg_rgcn_tpu_torch.train import sampled as psampled
from primekg_rgcn_tpu_torch.train.torch_interop import params_from_jax

N, R = 120, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


class RecordingGraphs(pgraphs.StepGraphs):
    """StepGraphs that notes every key it runs and, on the CPU, runs it as
    the card does: a key's first run is its warm-up, its second is kept as
    the captured body with what it returned, and every later run calls the
    kept body again (not the one passed) and writes what it returns into
    the kept outputs, as a replay rewrites a graph's tensors in place. A
    body that reaches a replay through what the host passes it, not
    through tensors that live across runs, then gives other results than
    the per-update loop."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.keys = []
        self._kept = {}
        self._seen = set()

    def run(self, key, body):
        self.keys.append(key)
        if key in self._kept:
            kept_body, out = self._kept[key]
            _write_into(out, kept_body())
            return out
        out = body()
        if key in self._seen:
            self._kept[key] = (body, out)
        self._seen.add(key)
        return out

    def reset(self):
        super().reset()
        self._kept.clear()


def _write_into(dst, src):
    """Copy every tensor of ``src`` into the same place in ``dst``."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, (tuple, list)):
        assert type(dst) is type(src) and len(dst) == len(src)
        for d, x in zip(dst, src):
            _write_into(d, x)
    else:
        assert dst == src


def _graph(seed=0, n=N, e=1500, norm="dense"):
    """A skewed graph (hub destinations) in both packages."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = np.minimum((n * rng.random(e) ** 2.0).astype(np.int64), n - 1)
    rel = rng.integers(0, R, e)
    edges = np.stack([src, dst, rel], 1).astype(np.int32)
    jg = j_build(src, dst, rel, n, R, bucket_pad_multiple=64, norm=norm,
                 use_native="never")
    pg = p_build(src, dst, rel, n, R, bucket_pad_multiple=64, norm=norm,
                 use_native="never")
    return edges, jg, pg


def _state(cfg, tcfg):
    params = init_params(torch.Generator().manual_seed(1), cfg)
    for p in param_leaves(params):
        p.requires_grad_(True)
    return (params, loop.make_optimizer(tcfg, params),
            torch.Generator().manual_seed(2), torch.Generator().manual_seed(3))


def _run_epochs(pg, edges, cfg, tcfg, graphs_cls, epochs=2):
    params, opt, host_gen, dev_gen = _state(cfg, tcfg)
    graphs = None if graphs_cls is None else graphs_cls("cpu", dev_gen)
    epoch_fn = loop.build_train_epoch(pg, edges, cfg, tcfg, params, opt,
                                      graphs=graphs)
    losses = [torch.stack(epoch_fn(host_gen, dev_gen)).tolist()
              for _ in range(epochs)]
    return losses, params, opt, dev_gen, graphs


def _assert_same_run(a, b):
    (la, pa, oa, ga, _), (lb, pb, ob, gb, _) = a, b
    assert la == lb
    for x, y in zip(param_leaves(pa), param_leaves(pb)):
        assert torch.equal(x, y)
    for sa, sb in zip(oa.state.values(), ob.state.values()):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert torch.equal(ga.get_state(), gb.get_state())


# -- the config, the checkpoint and the CLI -------------------------------------


def test_steps_per_scan_round_trips_config_and_checkpoint(tmp_path):
    tc = TrainConfig(steps_per_scan=3, batch_size=64, epochs=1, seed=3)
    assert TrainConfig().steps_per_scan == 0
    assert TrainConfig.from_dict(tc.to_dict()) == tc
    # The dict moves to the JAX config and back unchanged.
    assert JTrainConfig.from_dict(tc.to_dict()).steps_per_scan == 3
    edges, _, pg = _graph(1)
    cfg = ModelConfig(num_nodes=N, num_relations=R, embedding_dim=8,
                      hidden_dim=8)
    trainer = loop.Trainer(cfg, tc, pg, pg, edges[:300], edges[:64],
                           tmp_path, device="cpu")
    trainer.train()
    saved = pckpt.load(tmp_path / "models" / "final_model.pt")
    assert saved["train_config"]["steps_per_scan"] == 3
    assert TrainConfig.from_dict(saved["train_config"]) == tc


@pytest.mark.parametrize("argv,want", [([], 0), (["--steps_per_scan", "4"], 4),
                                       (["--steps_per_scan", "-1"], -1)])
def test_cli_parses_steps_per_scan_as_jax(argv, want):
    assert pcli.parse_args(argv).steps_per_scan == want
    assert jcli.parse_args(argv).steps_per_scan == want


@pytest.mark.parametrize("value", ["two", "1.5", ""])
def test_cli_refuses_what_jax_refuses(value):
    for cli in (jcli, pcli):
        with pytest.raises(SystemExit):
            cli.parse_args(["--steps_per_scan", value])


def test_cli_trains_with_steps_per_scan(tmp_path):
    pcli.main(["--synthetic", "--synthetic_scale", "0.02", "--epochs", "1",
               "--batch_size", "256", "--embedding_dim", "8",
               "--hidden_dim", "8", "--steps_per_scan", "2",
               "--output_dir", str(tmp_path), "--device", "cpu"])
    saved = pckpt.load(tmp_path / "models" / "final_model.pt")
    assert saved["train_config"]["steps_per_scan"] == 2


# -- the full-graph epoch ---------------------------------------------------------


def _segments(n, k):
    k = min(k, n)
    return [("updates", k)] * (n // k) + ([("updates", n % k)] if n % k
                                           else [])


@pytest.mark.parametrize("k,accum", [(0, 1), (1, 1), (2, 1), (3, 1),
                                     (3, 2)])
def test_segmented_epoch_equals_the_per_update_loop(k, accum):
    """K in {0, 1, 2, 3}: the epoch's segments, run as their eager bodies,
    give the per-update loop's losses, parameters, adam state and generator
    position, bit for bit, over two epochs; the layer records n // K full
    segments and one remainder (0: the default)."""
    edges, _, pg = _graph(2)
    cfg = ModelConfig(num_nodes=N, num_relations=R, embedding_dim=8,
                      hidden_dim=8, dropout=0.3, decoder_dropout=0.1)
    tcfg = TrainConfig(batch_size=64, lr=1e-2, steps_per_scan=k,
                       gradient_accumulation_steps=accum, seed=3,
                       restrict_final="off")
    edges = edges[:700]
    n_updates = -(-(-(-700 // 64)) // accum)
    ref = _run_epochs(pg, edges, cfg, tcfg, None)
    got = _run_epochs(pg, edges, cfg, tcfg, RecordingGraphs)
    _assert_same_run(ref, got)
    assert got[4].keys == 2 * _segments(
        n_updates, k or pgraphs.DEFAULT_STEPS_PER_GRAPH)


def test_jax_segmented_epochs_agree_with_the_fused_epoch():
    """The JAX package's counterpart at the same K (tests/test_train.py's
    check at K = 2): its segmented epochs at K = 1 and 3 (a remainder of
    2) follow its fused one (K = 0)."""
    edges, jg, _ = _graph(2)
    edges = edges[:700]
    mcfg = JModelConfig(num_nodes=N, num_relations=R, embedding_dim=8,
                        hidden_dim=8, dropout=0.3)
    runs = []
    for k in (0, 1, 3):
        tcfg = JTrainConfig(batch_size=64, lr=1e-2, steps_per_scan=k,
                            seed=3)
        opt = jloop.make_optimizer(tcfg)
        params = j_init(jax.random.PRNGKey(0), mcfg)
        state = jloop.TrainState(params, opt.init(params),
                                 jnp.zeros((), jnp.int32))
        fn = jloop.build_train_epoch(jg, edges, mcfg, tcfg, opt, j_layer)
        state, (loss, _) = fn(state, jax.random.PRNGKey(9))
        runs.append((float(loss), state))
    for loss, state in runs[1:]:
        assert loss == pytest.approx(runs[0][0], rel=1e-5)
        assert int(state.step) == int(runs[0][1].step) == 11
        for a, b in zip(jax.tree_util.tree_leaves(runs[0][1].params),
                        jax.tree_util.tree_leaves(state.params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-5, atol=1e-6)


def _cut_plan(plan, cap):
    """``plan`` with every relation's capacity cut to ``cap`` slots."""
    return pfl.FinalLayerPlan(
        plan.rowptr, (cap,) * R, plan.group,
        torch.full_like(plan.cap, cap), torch.arange(R) * cap,
        plan.bucket_start)


@pytest.mark.parametrize("cap,accum", [(None, 1), (None, 2), (544, 1),
                                       (544, 2), (8, 1), (None, 4),
                                       (544, 4)])
def test_restricted_epoch_equals_the_per_update_loop(cap, accum,
                                                     monkeypatch):
    """The split update (the candidates and ranges, the host read, then
    each micro-batch through the branch its flag picks, into the epoch's
    own gradients) against the per-update loop, whose restricted layer
    reads its flag itself: equal bit for bit, with the plan (None), a cut
    plan that overflows on some micro-batches (544) and one that overflows
    on all (8); the fallbacks counted alike. Each micro-batch of an update
    runs its own graph, so with four of them a replay never reads another
    micro-batch's candidates."""
    n = 600
    edges, _, pg = _graph(21, n=n, e=3000)
    cfg = ModelConfig(num_nodes=n, num_relations=R, embedding_dim=8,
                      hidden_dim=8, dropout=0.3)
    tcfg = TrainConfig(batch_size=32, lr=1e-2, seed=3, restrict_final="on",
                       gradient_accumulation_steps=accum)
    if cap is not None:
        resolve = loop.resolve_final_plan
        monkeypatch.setattr(loop, "resolve_final_plan",
                            lambda *a, **kw: _cut_plan(resolve(*a, **kw),
                                                       cap))
    edges = edges[:320]
    counts = []
    runs = []
    for graphs_cls in (None, RecordingGraphs):
        before = pfl.final_layer_restricted.fallbacks
        runs.append(_run_epochs(pg, edges, cfg, tcfg, graphs_cls))
        counts.append(pfl.final_layer_restricted.fallbacks - before)
    _assert_same_run(*runs)
    assert counts[0] == counts[1]
    keys = runs[1][4].keys
    micro = [key for key in keys if key[0] == "micro"]
    n_updates = -(-10 // accum)
    assert keys.count(("ranges",)) == 2 * n_updates
    assert [key[2] for key in micro] == list(range(accum)) * 2 * n_updates
    assert sum(not key[1] for key in micro) == counts[1]
    if cap == 544:
        assert 0 < counts[1] < len(micro)
    elif cap == 8:
        assert counts[1] == len(micro)


@pytest.mark.parametrize("norm,branch", [("dense", "restricted"),
                                         ("edge", "restricted"),
                                         ("dense", "full"),
                                         ("edge", "full")])
def test_split_branches_match_jax_batch_loss(norm, branch):
    """Each branch of the split layer, handed the ranges and the flag as
    read, gives the JAX ``_batch_loss`` with ``final_plan`` (which branches
    on the device) its loss and every gradient; ``full`` on a plan cut to
    one group a relation, so that JAX takes its full layer too."""
    n = 600
    edges, jg, pg = _graph(11 + len(norm), n=n, e=3000, norm=norm)
    jplan = jfl.plan_final_layer(jg, edges.astype(np.int64), 32, 1, sims=8,
                                 seed=3)
    pplan = pfl.plan_final_layer(pg, edges.astype(np.int64), 32, 1, sims=8,
                                 seed=3)
    if branch == "full":
        jplan = jfl.FinalLayerPlan(jplan.rowptr, (8,) * R, 8)
        pplan = _cut_plan(pplan, 8)
    jcfg = JModelConfig(num_nodes=n, num_relations=R, embedding_dim=8,
                        hidden_dim=16, dropout=0.0)
    tcfg = JTrainConfig(batch_size=32, num_neg_samples=1)
    jp = j_init(jax.random.PRNGKey(4), jcfg)
    e = edges.shape[0]
    edges_pad = jnp.asarray(np.concatenate([edges,
                                            np.zeros((1, 3), np.int32)]))
    batch_idx = np.random.default_rng(5).integers(0, e, 32).astype(np.int32)
    batch_idx[28:] = e
    key = jax.random.PRNGKey(13)
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jloop._batch_loss(
            p, jg, edges_pad, jnp.asarray(batch_idx), key, jcfg, tcfg,
            train=True, layer_fn=j_layer, final_plan=jplan),
        has_aux=True))(jp)
    k_neg, _ = jax.random.split(key)
    batch = np.asarray(edges_pad)[batch_idx]
    cands = jneg.candidate_batch(
        k_neg, jnp.asarray(batch[:, 0]), jnp.asarray(batch[:, 1]),
        jnp.asarray(batch[:, 2]), n, 1, mask=jnp.asarray(batch_idx < e))
    heads, tails, rels, labels, weights = (
        torch.from_numpy(np.array(c)) for c in cands)
    pp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    for p in param_leaves(pp):
        p.requires_grad_(True)
    ranges = pfl.final_layer_ranges(pplan, torch.cat([heads, tails]).long())
    assert bool(ranges.ok) == (branch == "restricted")
    before = pfl.final_layer_restricted.fallbacks
    loss, _ = loop.loss_from_candidates(
        pp, pg, heads.long(), tails.long(), rels.long(), labels, weights,
        ModelConfig.from_dict(jcfg.to_dict()), train=True, final_plan=pplan,
        final_ranges=ranges._replace(fits=bool(ranges.ok)))
    loss.backward()
    # The caller counts at its read; the branch reads nothing.
    assert pfl.final_layer_restricted.fallbacks == before
    scale = lambda a: max(float(np.abs(a).max()), 1e-30)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=2e-4)
    flat_j = _flat(grads_j)
    for k, v in _flat(pp).items():
        want = np.asarray(flat_j[k], np.float32)
        np.testing.assert_allclose(v.grad.numpy(), want, rtol=2e-4,
                                   atol=2e-5 * scale(want), err_msg=k)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


# -- the sampled trainer --------------------------------------------------------


@pytest.mark.parametrize("mode", ["dense", "sparse_emb", "adafactor",
                                  "cache_layer1"])
def test_sampled_trainer_chunking_matches_per_step(mode, tmp_path,
                                                   monkeypatch):
    """steps_per_scan 1 (every step alone), 2 (chunks of two whole
    batches, then the rest one at a time, the wrapped last batch among
    them) and the default give the same history, parameters and optimizer
    state, as the JAX trainer's test_trainer_chunking_matches_per_step;
    dense adam, --sparse_emb SGD, --table_opt adafactor and
    --cache_layer1."""
    monkeypatch.setattr(psampled, "StepGraphs", RecordingGraphs)
    edges, _, pg = _graph(7, e=700)
    cfg = ModelConfig(num_nodes=N, num_relations=R, embedding_dim=8,
                      hidden_dim=8, dropout=0.3)
    kw = dict(fanouts=(4, 3), device="cpu")
    opt = dict(optimizer="adam", grad_clip=1.0)
    if mode != "dense":
        kw["sparse_emb"] = True
        opt = dict(optimizer="sgd", grad_clip=0.0)
        kw["cache_layer1"] = mode == "cache_layer1"
    if mode == "adafactor":
        # The factored table rule, its statistics written in place.
        kw["table_opt"] = "adafactor"
        opt["optimizer"] = "adam"
    runs = []
    for k in (1, 2, 0):
        tcfg = TrainConfig(batch_size=64, lr=1e-2, epochs=2, seed=3,
                           steps_per_scan=k, **opt)
        t = psampled.SampledTrainer(cfg, tcfg, pg, pg, edges[:300],
                                    edges[:64], tmp_path / str(k), **kw)
        runs.append((t.train()["history"], t))
    steps, n_full = -(-300 // 64), 300 // 64
    for k, (hist, t) in zip((1, 2, 0), runs):
        assert hist == runs[0][0]
        for a, b in zip(param_leaves(t.params), param_leaves(runs[0][1].params)):
            assert torch.equal(a, b)
        chunk = min(k or pgraphs.DEFAULT_STEPS_PER_GRAPH, n_full)
        chunked = n_full // chunk * chunk if chunk > 1 else 0
        train_keys = [key for key in t.graphs.keys if key[0] == "steps"]
        assert train_keys == 2 * ([("steps", chunk)] * (chunked // chunk
                                                        if chunked else 0)
                                  + [("steps", 1)] * (steps - chunked))
    if mode == "cache_layer1":
        assert torch.equal(runs[1][1].optimizer.cache,
                           runs[0][1].optimizer.cache)
    if mode == "adafactor":
        for k, v in runs[0][1].optimizer.table.items():
            assert torch.equal(runs[1][1].optimizer.table[k], v), k
