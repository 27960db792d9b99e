"""Full-graph training traffic: epochs of the port's
``train/loop.build_train_epoch`` under ``train/graphs.StepGraphs``, as
``Trainer.train`` runs them, in a closed loop.

Set-up, timed from the process's start: the graph from the configuration's
maker and the split (the yardstick's frozen copies), the port's
``build_rel_graph`` over the train split, the epoch's edges (the whole
split, or a seeded sample of ``epoch_edges`` of it), the weights on the
device from the seed, the optimizer, the epoch function (which resolves
the restricted final layer's plan on the whole split) and one warm epoch,
which loads and builds every kernel, captures the graphs, and is the run
whose first updates the reference follows. The window runs whole epochs
until ``--seconds`` have passed; each epoch is read once at its end.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict

import numpy as np

from portbench.reference.rgcn import LEAVES
from portbench.yardstick import roofline, split, synthetic, trace

CHECKED_STEPS = 3
# A traced run traces about TRACE_SECONDS of updates of its first epoch
# (counted at the warm epoch's pace after its checked updates), from update
# TRACE_FROM on: a bounded stretch, past the epoch's start.
TRACE_SECONDS = 1.5
TRACE_FROM = 8


def _closure(fn, name: str):
    """The object that ``fn`` holds under the free variable ``name``."""
    for var, cell in zip(fn.__code__.co_freevars, fn.__closure__ or ()):
        if var == name:
            return cell.cell_contents
    raise LookupError(f"{fn.__qualname__} holds no {name!r}")


def make_params(num_nodes: int, num_relations: int, d_emb: int, d_hid: int,
                seed: int, device) -> Dict:
    """Xavier-uniform weights and zero biases by leaf name, drawn on
    ``device`` from a generator seeded ``seed`` in one call."""
    import torch

    shapes = {
        "encoder.node_emb": ((num_nodes, d_emb), num_nodes, d_emb),
        "encoder.conv1.w_rel": ((num_relations, d_emb, d_hid), d_emb, d_hid),
        "encoder.conv1.w_root": ((d_emb, d_hid), d_emb, d_hid),
        "encoder.conv2.w_rel": ((num_relations, d_hid, d_hid), d_hid, d_hid),
        "encoder.conv2.w_root": ((d_hid, d_hid), d_hid, d_hid),
        "decoder.rel_emb": ((num_relations, d_hid), num_relations, d_hid),
    }
    sizes = [math.prod(s) for s, _, _ in shapes.values()]
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, (shape, fan_in, fan_out)), chunk in zip(
            shapes.items(), torch.split(flat, sizes)):
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        out[name] = (chunk * (2 * limit) - limit).reshape(shape).clone()
    for name in ("encoder.conv1.bias", "encoder.conv2.bias"):
        out[name] = torch.zeros(d_hid, device=device)
    return {n: out[n] for n in LEAVES}


def nest(flat: Dict) -> Dict:
    """The port's parameter dict from leaves named ``a.b.c``."""
    tree: Dict = {}
    for name, value in flat.items():
        *path, last = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = value
    return tree


class FirstSteps:
    """Called after each run of the epoch's graphs: on each of the first
    updates records its loss (from the epoch's running sums), after the
    first the gradient the optimizer got (from Adam's first moment), after
    the last the parameters."""

    def __init__(self, optimizer, leaves: Dict, stats, steps: int):
        self.opt, self.leaves, self.stats = optimizer, leaves, stats
        self.steps, self.seen = steps, 0
        self.first = next(iter(leaves.values()))
        self.prev = None
        self.loss, self.grad1, self.params = [], {}, {}
        self.runs, self.done_at = 0, None

    def __call__(self, key) -> None:
        import torch

        self.runs += 1
        state = self.opt.state.get(self.first)
        if self.seen >= self.steps or not state:
            return
        step = int(state["step"])
        if step == self.seen:
            return
        if step != self.seen + 1:
            raise RuntimeError(f"update {step} came after {self.seen}: the "
                               "first updates were not seen one by one")
        s = self.stats.detach().double().cpu()
        d = s if self.prev is None else s - self.prev
        self.prev = s
        self.loss.append(float(d[0] / d[2]))
        if step == 1:
            beta1 = self.opt.param_groups[0]["betas"][0]
            self.grad1 = {n: float(torch.linalg.vector_norm(
                self.opt.state[p]["exp_avg"])) / (1 - beta1)
                for n, p in self.leaves.items()}
        if step == self.steps:
            self.params = {n: p.detach().cpu().clone()
                           for n, p in self.leaves.items()}
            self.done_at = time.perf_counter()
        self.seen = step


class TracedStretch:
    """Called after each run of the epoch's graphs: traces ``count``
    updates from update ``start`` on (``runs_per_update`` runs each), and
    counts the restricted layer's fallbacks among them."""

    def __init__(self, runs_per_update: int, start: int, count: int,
                 cuda: bool):
        if start < 1 or count < 1:
            raise ValueError(f"no stretch of updates to trace from update "
                             f"{start} ({count} updates)")
        self.rpu, self.start, self.count = runs_per_update, start, count
        self.tracer = trace.Tracer() if cuda else None
        self.runs = 0
        self.fallbacks = None
        self.summary = None

    @staticmethod
    def _fallbacks() -> int:
        from primekg_rgcn_tpu_torch.ops.rgcn_final_layer import \
            final_layer_restricted

        return final_layer_restricted.fallbacks

    def __call__(self, key) -> None:
        self.runs += 1
        if self.runs == self.start * self.rpu:
            self.fallbacks = self._fallbacks()
            if self.tracer:
                self.tracer.start()
        elif self.runs == (self.start + self.count) * self.rpu:
            self.fallbacks = self._fallbacks() - self.fallbacks
            if self.tracer:
                self.summary = self.tracer.stop()

    def result(self) -> Dict:
        return {"updates_traced": self.count,
                "fallbacks_traced": self.fallbacks, "summary": self.summary}


def _graphs_class():
    from primekg_rgcn_tpu_torch.train.graphs import StepGraphs

    class ObservedGraphs(StepGraphs):
        """The port's ``StepGraphs``, calling ``observer(key)`` after each
        run while one is set."""
        observer = None

        def run(self, key, body):
            out = super().run(key, body)
            if self.observer is not None:
                self.observer(key)
            return out

    return ObservedGraphs


def _sample_candidates(epoch_edges: np.ndarray, num_nodes: int, b: int,
                       k: int, rng: np.random.Generator, n: int):
    """``n`` batches' candidate node ids (heads and tails of the positives
    and their corruptions), drawn as the trainer draws them."""
    for _ in range(n):
        pos = epoch_edges[rng.choice(epoch_edges.shape[0], b, replace=False)]
        h, t = np.repeat(pos[:, 0], k), np.repeat(pos[:, 1], k)
        coin = rng.random(b * k) < 0.5
        ent = rng.integers(0, num_nodes, b * k)
        yield np.concatenate([pos[:, 0], np.where(coin, ent, h),
                              pos[:, 1], np.where(coin, t, ent)])


class Cell:
    """A full-graph cell's program object, set up and driven through its
    warm epoch (set-up ends there), then measured and checked."""

    def __init__(self, r):
        import torch

        from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
        from primekg_rgcn_tpu_torch.data.graph import build_rel_graph
        from primekg_rgcn_tpu_torch.train.loop import (build_train_epoch,
                                                       make_optimizer)

        self.r = r
        cfg, tr, seeds = r.config, r.traffic, r.seeds
        dev = self.dev = torch.device(r.device)
        marks = {}

        def mark(stage: str) -> None:
            marks[stage] = time.perf_counter() - r.started

        g = synthetic.MAKERS[cfg["graph"]["maker"]](cfg["graph"]["seed"],
                                                    cfg["graph"]["scale"])
        n, n_rel = self.n, self.n_rel = (int(g["num_nodes"]),
                                         int(g["num_relations"]))
        sp = cfg["split"]
        train = self.train = split.split_rows(
            g["src"], g["dst"], g["rel"],
            g["relation_names"].index(sp["target_relation"]),
            sp["seed"], sp["train"], sp["val"], sp["test"])["train"]
        m = cfg.get("epoch_edges")
        self.epoch_edges = train if not m else train[
            np.random.default_rng(seeds["sample"]).choice(
                train.shape[0], m, replace=False)]
        mark("graph_and_split")
        self.graph = build_rel_graph(train[:, 0], train[:, 1], train[:, 2],
                                     n, n_rel).to(dev)
        mark("build_rel_graph")

        mc, oc = self.mc, self.oc = cfg["model"], cfg["optimizer"]
        self.b, self.k = int(tr["batch_size"]), int(oc["num_neg_samples"])
        model_cfg = ModelConfig(
            num_nodes=n, num_relations=n_rel,
            embedding_dim=mc["embedding_dim"], hidden_dim=mc["hidden_dim"],
            dropout=mc["dropout"], decoder_dropout=mc["decoder_dropout"],
            compute_dtype=mc["compute_dtype"])
        self.train_cfg = TrainConfig(
            batch_size=self.b, lr=oc["lr"], optimizer=oc["name"],
            num_neg_samples=self.k, grad_clip=oc["grad_clip"],
            seed=cfg["plan_seed"],
            restrict_final=tr.get("restrict_final", "auto"))
        flat = make_params(n, n_rel, mc["embedding_dim"], mc["hidden_dim"],
                           seeds["weights"], dev)
        self.params0 = {name: t.cpu().clone() for name, t in flat.items()}
        for t in flat.values():
            t.requires_grad_(True)
        self.flat = flat
        self.opt = make_optimizer(self.train_cfg, nest(flat))
        self.dev_gen = torch.Generator(dev).manual_seed(seeds["device"])
        self.host_gen = torch.Generator().manual_seed(seeds["perm"])
        self.graphs = _graphs_class()(dev, self.dev_gen)
        self.epoch_fn = build_train_epoch(
            self.graph, self.epoch_edges, model_cfg, self.train_cfg,
            nest(flat), self.opt, graphs=self.graphs, plan_edges=train)
        self.plan = self.epoch_fn.final_plan
        mark("plan_and_params")

        self.per_epoch = -(-self.epoch_edges.shape[0] // self.b)
        if self.epoch_edges.shape[0] < CHECKED_STEPS * self.b:
            raise ValueError(f"an epoch of {self.epoch_edges.shape[0]} "
                             f"edges has fewer than {CHECKED_STEPS} "
                             "whole batches")
        first = FirstSteps(self.opt, flat, _closure(self.epoch_fn, "stats"),
                           CHECKED_STEPS)
        self.graphs.observer = first
        self.epoch()
        self.graphs.observer = None
        # An optimizer that never stepped gives no numbers: the readings
        # are then infinite.
        self.got = None if first.seen < CHECKED_STEPS else {
            "loss": first.loss, "grad1": first.grad1,
            "change": {name: float(torch.linalg.vector_norm(
                first.params[name] - self.params0[name]))
                for name in LEAVES}}
        mark("warm_epoch")
        self.setup_s = time.perf_counter() - r.started
        # The warm epoch's pace after the checked updates: the first ones
        # load, build and capture.
        self.warm_update_s = ((time.perf_counter() - first.done_at)
                              / max(self.per_epoch - CHECKED_STEPS, 1)
                              if self.got else 0.0)
        # The graphs' runs an update, for tracing a stretch of updates.
        self.runs_per_update, rest = divmod(first.runs, self.per_epoch)
        if rest or not self.runs_per_update:
            raise RuntimeError(f"{first.runs} graph runs in an epoch of "
                               f"{self.per_epoch} updates")
        r.log("setup " + " ".join(f"{k}={v:.3f}" for k, v in marks.items()))

    def epoch(self) -> float:
        """One epoch, read once at its end: its mean loss."""
        return float(self.epoch_fn(self.host_gen, self.dev_gen)[0])

    def window(self, seconds: float, traced_first: bool) -> Dict:
        """Whole epochs until ``seconds`` have passed, the first traced
        when ``traced_first``; what the window did, for the metrics."""
        import torch

        from primekg_rgcn_tpu_torch.ops.rgcn_final_layer import \
            final_layer_restricted as restricted

        graphs = self.graphs
        captures0 = graphs.warmups + graphs.captures
        fallbacks0 = restricted.fallbacks
        out: Dict = {}
        epochs = failed = 0
        cuda = self.dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        while True:
            if traced_first and epochs == 0:
                count = (math.ceil(TRACE_SECONDS / self.warm_update_s)
                         if self.warm_update_s else self.per_epoch)
                stretch = TracedStretch(self.runs_per_update, TRACE_FROM,
                                        min(count,
                                            self.per_epoch - TRACE_FROM),
                                        cuda)
                graphs.observer = stretch
                loss = self.epoch()
                graphs.observer = None
                out.update(stretch.result())
            else:
                loss = self.epoch()
            epochs += 1
            failed += 0 if math.isfinite(loss) else self.per_epoch
            if time.perf_counter() - t0 >= seconds:
                break
        out["window_s"] = time.perf_counter() - t0
        out["epochs"], out["failed"] = epochs, failed
        out["graph_captures_window"] = (graphs.warmups + graphs.captures
                                        - captures0)
        out["fallbacks_window"] = restricted.fallbacks - fallbacks0
        out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(self.dev)
                                    if cuda else 0)
        return out

    def release(self) -> None:
        """Free the program's state, before the reference runs."""
        import torch

        del self.epoch_fn, self.graphs, self.opt, self.flat, self.graph
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, **kw) -> Dict:
        """The plain reference's first updates on this cell's inputs
        (``kw``: ``precision``, ``fault``)."""
        from portbench.reference.rgcn import train_steps

        return train_steps(
            self.train, self.n, self.n_rel, self.epoch_edges, self.params0,
            model=self.mc, train={"lr": self.oc["lr"],
                                  "grad_clip": self.oc["grad_clip"],
                                  "num_neg_samples": self.k},
            batch_size=self.b, perm_seed=self.r.seeds["perm"],
            device_seed=self.r.seeds["device"], device=self.dev,
            steps=CHECKED_STEPS, **kw)


def run(r) -> Dict:
    from portbench import check

    cell = Cell(r)
    w = cell.window(r.seconds, r.trace)
    updates = w["epochs"] * cell.per_epoch
    r.log(f"window {w['window_s']:.3f} s, {w['epochs']} epochs, {updates} "
          f"updates, {w['fallbacks_window']} fallbacks, "
          f"{w['graph_captures_window']} warm-ups and captures")
    plan, mc = cell.plan, cell.mc
    layer = {k: w[k] for k in ("updates_traced", "fallbacks_traced",
                               "graph_captures_window", "fallbacks_window")
             if k in w}
    layer["updates_window"] = updates
    layer.update(
        restricted=plan is not None, num_nodes=cell.n,
        num_relations=cell.n_rel,
        bucket_sizes=list(cell.graph.bucket_sizes()),
        scaled=cell.graph.norm_mode == "edge", d_emb=mc["embedding_dim"],
        d_hid=mc["hidden_dim"], batch_nodes=2 * cell.b * (1 + cell.k),
        e_cap_total=int(sum(plan.e_cap)) if plan is not None else 0,
        group=plan.group if plan is not None else 1)
    cell.release()
    if r.trace:
        train = cell.train
        layer["bucket_src_rows"], layer["bucket_dst_rows"] = \
            roofline.bucket_rows(train[:, 0], train[:, 1], train[:, 2],
                                 cell.n, cell.n_rel)
        layer["update_flops"] = roofline.update_flops(
            roofline.InEdges(train[:, 0], train[:, 1], train[:, 2], cell.n),
            _sample_candidates(cell.epoch_edges, cell.n, cell.b, cell.k,
                               np.random.default_rng(r.seeds["flops"]), 4),
            mc["embedding_dim"], mc["hidden_dim"])
    t_ref = time.perf_counter()
    ref = cell.reference()
    worst: Dict[str, str] = {}
    readings = check.readings(cell.got, ref, worst)
    r.log(f"reference {time.perf_counter() - t_ref:.3f} s; losses: program "
          f"{cell.got and cell.got['loss']}, reference {ref['loss']}; "
          f"worst: {worst}")
    return {"end_to_end": {
                "train_edges_per_s": (w["epochs"] * cell.epoch_edges.shape[0]
                                      / w["window_s"]),
                "setup_s": cell.setup_s},
            "attempted": updates, "failed": w["failed"],
            "readings": readings,
            "memory_peak_bytes": int(w["memory_peak_bytes"]), "layer": layer,
            "trace": w.get("summary")}
