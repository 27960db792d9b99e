"""The recorder of ``utils/telemetry``: the training epoch's spans, the
graph runs' device events and the account of the waits between runs.

On the CPU ``StepGraphs.run`` calls each body and records no device
events, so the epoch tests read the spans; the device events are held
here with stand-in events, and the account with hand-made intervals.
"""

import json

import numpy as np
import pytest
import torch

from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph
from primekg_rgcn_tpu_torch.models.rgcn import init_params, param_leaves
from primekg_rgcn_tpu_torch.ops import rgcn_final_layer as pfl
from primekg_rgcn_tpu_torch.train import graphs as pgraphs
from primekg_rgcn_tpu_torch.train import loop
from primekg_rgcn_tpu_torch.utils import telemetry

N, R, B = 600, 4, 32


@pytest.fixture(autouse=True)
def _fresh_recorder():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    telemetry.clear()
    yield
    telemetry.clear()
    torch.set_num_threads(threads)


def _cut_plan(plan, cap):
    """``plan`` with every relation's capacity cut to ``cap`` slots, so
    that some batches overflow it."""
    return pfl.FinalLayerPlan(
        plan.rowptr, (cap,) * R, plan.group, torch.full_like(plan.cap, cap),
        torch.arange(R) * cap, plan.bucket_start)


def _epoch(monkeypatch, restrict="on", steps_per_scan=0, cap=544):
    """A tiny epoch function (10 updates of 32 edges) with fresh weights,
    optimizer and generators, under CPU ``StepGraphs``."""
    rng = np.random.default_rng(21)
    src, rel = rng.integers(0, N, 3000), rng.integers(0, R, 3000)
    dst = np.minimum((N * rng.random(3000) ** 2.0).astype(np.int64), N - 1)
    edges = np.stack([src, dst, rel], 1).astype(np.int32)[:320]
    graph = build_rel_graph(src, dst, rel, N, R, bucket_pad_multiple=64,
                            use_native="never")
    cfg = ModelConfig(num_nodes=N, num_relations=R, embedding_dim=8,
                      hidden_dim=8, dropout=0.3)
    tcfg = TrainConfig(batch_size=B, lr=1e-2, seed=3, restrict_final=restrict,
                       steps_per_scan=steps_per_scan)
    if cap is not None:
        resolve = loop.resolve_final_plan
        monkeypatch.setattr(loop, "resolve_final_plan",
                            lambda *a, **kw: _cut_plan(resolve(*a, **kw),
                                                       cap))
    params = init_params(torch.Generator().manual_seed(1), cfg)
    for p in param_leaves(params):
        p.requires_grad_(True)
    opt = loop.make_optimizer(tcfg, params)
    dev_gen = torch.Generator().manual_seed(3)
    graphs = pgraphs.StepGraphs("cpu", dev_gen)
    epoch_fn = loop.build_train_epoch(graph, edges, cfg, tcfg, params, opt,
                                      graphs=graphs)
    return (lambda: epoch_fn(torch.Generator().manual_seed(2), dev_gen)), \
        params


def _names(summary):
    return [s["name"] for s in summary["spans"]]


def test_recording_is_off_by_default(monkeypatch):
    """Outside a scope and a profiler an epoch records nothing and opens
    no ``record_function``."""
    run, _ = _epoch(monkeypatch)

    def no_range(name):
        raise AssertionError(f"record_function({name!r}) while off")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert not telemetry.recording_on()
    run()
    got = telemetry.recorded()
    assert got["spans"] == [] and got["runs"] == []
    assert got["updates"] == 0 and got["dropped"] == 0


def test_restricted_epoch_spans_inside_a_scope(monkeypatch):
    """Inside ``recording()`` each update is one ``train.update`` holding
    one ``restricted.host_read``, fallbacks among them; the epoch's
    permutation and upload are one span each."""
    run, _ = _epoch(monkeypatch)
    before = pfl.final_layer_restricted.fallbacks
    with telemetry.recording():
        assert telemetry.recording_on()
        run()
    added = pfl.final_layer_restricted.fallbacks - before
    got = telemetry.recorded()
    spans = got["spans"]
    names = _names(got)
    assert names.count("train.update") == 10
    assert names.count("restricted.host_read") == 10
    assert names.count("epoch.permute") == names.count("epoch.upload") == 1
    assert got["updates"] == 10
    reads = [s for s in spans if s["name"] == "restricted.host_read"]
    assert all(spans[s["parent"]]["name"] == "train.update" for s in reads)
    assert 0 < added < 10
    # CPU runs are eager bodies: no device events.
    assert got["runs"] == [] and got["update_ms"] == []
    assert not telemetry.recording_on()


def test_full_layer_segments_are_updates(monkeypatch):
    """The full-layer epoch's segments of K updates are ``train.update``
    spans of ``updates`` K (10 updates: 4, 4, then 2)."""
    run, _ = _epoch(monkeypatch, restrict="off", steps_per_scan=4, cap=None)
    with telemetry.recording():
        run()
    got = telemetry.recorded()
    assert _names(got).count("train.update") == 3
    assert got["updates"] == 10


def test_spans_in_a_profiler_trace(monkeypatch, tmp_path):
    """Under a CPU ``torch.profiler`` the spans are recorded and show in
    the exported trace as ``user_annotation`` events, which
    ``device_us_by_range`` reads."""
    run, _ = _epoch(monkeypatch)
    with telemetry.profile_trace(tmp_path):
        assert telemetry.recording_on()
        run()
    assert _names(telemetry.recorded()).count("train.update") == 10
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    marks = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    for name in ("train.update", "restricted.host_read", "epoch.permute",
                 "epoch.upload"):
        assert name in marks
    assert marks.count("train.update") == 10
    by_range = telemetry.device_us_by_range(tmp_path / "trace.json",
                                            "restricted.")
    assert by_range == {"restricted.host_read": 0.0}


def test_a_span_open_when_recording_stops_is_kept():
    """Recorded if and only if recording was on when it opened."""
    with telemetry.span("epoch.permute"):
        pass
    scope = telemetry.recording()
    scope.__enter__()
    with telemetry.span("train.update", updates=1):
        scope.__exit__(None, None, None)
        with telemetry.span("restricted.host_read", wait=True):
            pass
    got = telemetry.recorded()
    assert _names(got) == ["train.update"]
    assert got["updates"] == 1


def test_parameters_equal_with_recording_on_and_off(monkeypatch):
    results = []
    for on in (False, True):
        run, params = _epoch(monkeypatch)
        if on:
            with telemetry.recording():
                loss, acc = run()
        else:
            loss, acc = run()
        results.append(([p.detach().clone() for p in param_leaves(params)],
                        loss, acc))
        monkeypatch.undo()
    (pa, la, aa), (pb, lb, ab) = results
    assert torch.equal(la, lb) and torch.equal(aa, ab)
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)


# -- the account of runs and waits -------------------------------------------

MS = 1_000_000  # host nanoseconds a millisecond


def test_account_labels_waits_and_updates():
    """Two restricted updates: the gap after the ranges run is the host
    read; the gap after a warm-up is the host's launch pace, though the
    warm-up's own span closes inside it; a capture's gap is the capture;
    a warm-up's interval is all wait, named after its span; updates sum
    their runs' intervals."""
    U, W = 1, True  # one update; a wait
    spans = [
        ("epoch.permute", 0 * MS, 2 * MS, None, W, 0),                  # 0
        ("epoch.upload", 2 * MS, 3 * MS, None, W, 0),                   # 1
        ("train.update", 3 * MS, 20 * MS, None, False, U),              # 2
        ("graphs.replay", 3 * MS, 4 * MS, 2, False, 0),                 # 3
        ("restricted.host_read", 4 * MS, 9 * MS, 2, W, 0),              # 4
        ("graphs.warmup", 9 * MS, 20 * MS, 2, False, 0),                # 5
        ("train.update", 21 * MS, 40 * MS, None, False, U),             # 6
        ("graphs.replay", 21 * MS, 22 * MS, 6, False, 0),               # 7
        ("restricted.host_read", 22 * MS, 25 * MS, 6, W, 0),            # 8
        ("graphs.capture", 25 * MS, 35 * MS, 6, W, 0),                  # 9
        ("graphs.replay", 35 * MS, 36 * MS, 6, False, 0),               # 10
    ]
    runs = [  # key, kind, span, start, end (device ms), host ns
        (("ranges",), "replay", 3, 100.0, 104.0, 3 * MS, 4 * MS),
        ("m", "warmup", 5, 106.0, 116.0, 9 * MS, 19 * MS),
        (("ranges",), "replay", 7, 117.0, 121.0, 21 * MS, 22 * MS),
        ("m", "capture", 10, 131.0, 140.0, 35 * MS, 36 * MS),
    ]
    got = telemetry.account(runs, spans, dropped=0)
    assert got["stretch_ms"] == 40.0
    assert [r["update"] for r in got["runs"]] == [0, 0, 1, 1]
    assert [r["start_ms"] for r in got["runs"]] == [0.0, 6.0, 17.0, 31.0]
    assert [(w["label"], w["ms"], w["run"]) for w in got["waits"]] == [
        ("restricted.host_read", 2.0, 1), ("launch", 1.0, 2),
        ("graphs.capture", 10.0, 3), ("graphs.warmup", 10.0, 1)]
    assert got["waits"][2]["key"] == "m"
    assert got["wait_ms"] == {"restricted.host_read": 2.0, "launch": 1.0,
                              "graphs.capture": 10.0, "graphs.warmup": 10.0}
    assert got["updates"] == 2
    assert got["update_ms"] == [14.0, 13.0]


def test_account_epoch_boundary_and_segments():
    """A gap holding the epoch's permutation and upload is named after
    the longer; a segment of K updates shares its time among them; a gap
    with no wait span is ``launch``; back-to-back runs leave none; a span
    that is no wait names no gap, however long."""
    spans = [
        ("train.update", 0, 2 * MS, None, False, 4),
        ("epoch.permute", 3 * MS, 7 * MS, None, True, 0),
        ("epoch.upload", 7 * MS, 8 * MS, None, True, 0),
        ("train.update", 9 * MS, 11 * MS, None, False, 2),
        ("train.update", 11 * MS, 16 * MS, None, False, 2),
    ]
    runs = [("u", "replay", 0, 0.0, 8.0, 0, 1 * MS),
            ("u", "replay", 3, 13.0, 17.0, 9 * MS, 10 * MS),
            ("u", "replay", 4, 18.0, 21.0, 15 * MS, 16 * MS)]
    got = telemetry.account(runs, spans)
    assert [(w["label"], w["ms"]) for w in got["waits"]] == [
        ("epoch.permute", 5.0), ("launch", 1.0)]
    assert got["updates"] == 8
    assert got["update_ms"] == [2.0] * 4 + [2.0] * 2 + [1.5] * 2
    assert got["stretch_ms"] == 21.0


def test_account_of_nothing():
    got = telemetry.account([], [])
    assert got["runs"] == [] and got["waits"] == []
    assert got["stretch_ms"] == 0.0 and got["updates"] == 0


class _Event:
    """A stand-in CUDA event: its time is the order it was recorded in,
    a millisecond apart."""
    clock = 0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        _Event.clock += 1
        self.t = float(_Event.clock)

    def elapsed_time(self, other):
        return other.t - self.t


def test_graph_runs_resolve_and_drop_past_the_cap(monkeypatch):
    """``graph_run`` is a span with a pair of events; ``recorded``
    resolves them against the first run's start; spans and runs past
    ``RECORD_CAP`` are counted as dropped; ``clear()`` frees them all."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: 0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    _Event.clock = 0
    with telemetry.recording():
        for i in range(3):
            with telemetry.span("train.update", updates=1):
                with telemetry.graph_run("graphs.replay", ("u",), "replay",
                                         "cuda"):
                    pass
    got = telemetry.recorded()
    assert [(r["start_ms"], r["end_ms"]) for r in got["runs"]] == [
        (0.0, 1.0), (2.0, 3.0), (4.0, 5.0)]
    assert [r["update"] for r in got["runs"]] == [0, 1, 2]
    assert _names(got) == ["train.update", "graphs.replay"] * 3
    assert got["update_ms"] == [1.0, 1.0, 1.0]
    assert [w["label"] for w in got["waits"]] == ["launch", "launch"]
    assert got["dropped"] == 0

    telemetry.clear()
    got = telemetry.recorded()
    assert got["runs"] == [] and got["spans"] == [] and got["dropped"] == 0
    assert telemetry._rec.runs == []
    monkeypatch.setattr(telemetry, "RECORD_CAP", 2)
    with telemetry.recording():
        with telemetry.graph_run("graphs.warmup", ("w",), "warmup", "cuda"):
            pass
        for i in range(3):
            with telemetry.graph_run("graphs.replay", ("w",), "replay",
                                     "cuda"):
                pass
    got = telemetry.recorded()
    assert _names(got) == ["graphs.warmup", "graphs.replay"]
    assert len(got["runs"]) == 2
    assert got["dropped"] == 4  # two spans and two runs past the cap
    assert [(w["label"], w["ms"]) for w in got["waits"]] == [
        ("launch", 1.0), ("graphs.warmup", 1.0)]


def test_off_sites_return_one_shared_no_op():
    """Off, a span site and a graph run make nothing: both give the same
    no-op, and no event or stream is asked for."""
    assert not telemetry.recording_on()
    assert telemetry.span("epoch.permute", wait=True) is telemetry._OFF
    assert telemetry.graph_run("graphs.replay", ("u",), "replay",
                               "cuda") is telemetry._OFF
    with telemetry.graph_run("graphs.warmup", ("w",), "warmup", "cuda"):
        pass
    assert telemetry.recorded()["runs"] == []
