"""Observability: a JSONL metrics stream, device memory counters, a
profiler trace scope and the training epoch's own spans and device events.

- MetricsLogger: one JSON object per line beside the human-readable log,
  so training curves are machine-readable.
- device_memory_stats: the CUDA caching allocator's counters.
- profile_trace: a ``torch.profiler`` scope (CPU and, on a card, CUDA
  activity) that writes a Chrome trace, ``trace.json``, into its directory.
- trace_breakdown: device time by kind and the idle share read from such a
  trace.
- device_us_by_range: the device time of the work launched inside each
  ``record_function`` range of such a trace (a kernel's time per call).
- The recorder: ``span`` marks the program's host work by name and
  ``graph_run`` marks a graph run and brackets its device work with a
  pair of CUDA events; ``recorded`` resolves what was recorded into an
  account of the runs and of every gap between them on the device, each
  gap named after the program's work that held the host (``account``).

The recorder records only while a ``torch.profiler`` is recording or
inside a ``recording()`` scope: off, a span site or a graph run costs one
check (``recording_on``) and nothing else. A span or run is kept if
recording was on when it opened, even if it closes after a profiler has
stopped. Each span also opens a ``torch.profiler.record_function`` of its
name, so that a profiler's trace shows it as a ``user_annotation`` on the
kernels' clock. A span site says what its span is to the account: a
``wait`` (the device waits on that host work between two runs) or a
number of ``updates``; the recorder knows no span by name. At most
``RECORD_CAP`` spans and as many runs (two CUDA events each) are held
until ``clear()``, which frees them; what comes past that is counted as
``dropped``. So any profile, read or not, pays for the events of its
first ``RECORD_CAP`` graph runs.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import time
from pathlib import Path
from typing import Any, Dict, Hashable, List, Optional, Sequence

import torch

from primekg_rgcn_tpu_torch.parallel.mesh import process_group_size


class MetricsLogger:
    """Append-only JSONL metrics stream. Across processes only process 0
    opens the file (every process constructs a logger and logs; appends
    from several would interleave torn lines)."""

    def __init__(self, path):
        self.path = Path(path)
        self._f = None
        if process_group_size()[1] == 0:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._f = open(self.path, "a")

    def log(self, event: str, **fields: Any) -> None:
        if self._f is None:
            return
        rec = {"event": event, "time": time.time(), **fields}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


def device_memory_stats(device) -> Dict[str, int]:
    """Bytes in use, their high-water mark and the card's memory for a CUDA
    device; {} for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    return {
        "bytes_in_use": int(torch.cuda.memory_allocated(device)),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device)),
        "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
    }


@contextlib.contextmanager
def profile_trace(log_dir):
    """``torch.profiler`` scope; on exit the trace goes to
    ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing).
    ``log_dir=None`` turns it off."""
    if log_dir is None:
        yield None
        return
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def _kind(event: Dict[str, Any]) -> str:
    name = event["name"].lower()
    if event["cat"] != "kernel":
        return "memcpy_memset"
    for kernel in ("gather_segment_sum", "dense_segment_sum",
                   "window_rows_fetch", "halo_exchange"):
        if kernel in name:
            return kernel
    if "sort" in name:
        return "sort"
    if any(k in name for k in ("gemm", "cutlass", "xmma", "cublas")):
        return "matmul"
    if "multi_tensor_apply" in name or "adam" in name:
        return "optimizer"
    return "other"


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_us_by_range(path, prefix: str) -> Dict[str, float]:
    """Device time, in microseconds, of the work launched inside each
    ``torch.profiler.record_function`` range whose name starts with
    ``prefix``, read from a ``profile_trace`` Chrome trace.

    Every kernel, memcpy and memset is charged to the range that holds the
    host call that launched it (matched by the trace's ``correlation`` id),
    so a call that launches several kernels is charged for all of them and
    the idle gaps between them are not. A device event whose launch the
    trace did not record is charged to the last range that started before
    it, which is right where the caller synchronises after each range (as
    a timing loop does). A range that launched nothing reads 0.
    """
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith(prefix))
    out = {name: 0.0 for _, _, name in ranges}
    starts = [start for start, _, _ in ranges]
    owner: Dict[int, Optional[str]] = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if corr is None or e.get("cat") in _DEVICE_CATS:
            continue
        i = bisect.bisect_right(starts, e["ts"]) - 1
        inside = i >= 0 and e["ts"] <= ranges[i][1]
        owner[corr] = ranges[i][2] if inside else None
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        corr = e.get("args", {}).get("correlation")
        if corr in owner:
            name = owner[corr]
        else:
            i = bisect.bisect_right(starts, e["ts"]) - 1
            name = ranges[i][2] if i >= 0 else None
        if name is not None:
            out[name] += e["dur"]
    return out


def trace_breakdown(path) -> Optional[Dict[str, Any]]:
    """Device time by kind and the idle share of a ``profile_trace`` Chrome
    trace: busy is the union of kernel, memcpy and memset intervals, the
    window runs from the first device event's start to the last one's end.
    Times in microseconds; None when the trace holds no device events."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in _DEVICE_CATS]
    if not dev:
        return None
    by_kind: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    for e in dev:
        by_kind[_kind(e)] = by_kind.get(_kind(e), 0.0) + e["dur"]
        by_name[e["name"][:90]] = by_name.get(e["name"][:90], 0.0) + e["dur"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_us": window, "busy_us": busy,
            "idle_share": 1.0 - busy / window, "device_events": len(dev),
            "us_by_kind": by_kind, "top_kernels_us": dict(top)}


# -- the recorder -----------------------------------------------------------

# Spans held, and runs held, until clear(). A benchmark's traced stretch
# holds about 1,100 spans and 530 runs; a longer profile (a chip_smoke.py
# phase, a training run under --profile_dir) records its first RECORD_CAP
# and then only counts what it drops.
RECORD_CAP = 8192


class _Recorder:
    """What is recorded until ``clear()``."""

    def __init__(self):
        self.scopes = 0
        self.clear()

    def clear(self) -> None:
        # [name, host start ns, host end ns (None while open), parent,
        #  wait, updates]
        self.spans: List[list] = []
        # [key, kind, span, start event, end event, host start ns,
        #  host end ns]
        self.runs: List[list] = []
        self.open: List[Optional[int]] = []
        self.dropped = 0
        self.summary: Optional[Dict[str, Any]] = None


_rec = _Recorder()


def recording_on() -> bool:
    """Whether spans and runs are recorded now: a ``torch.profiler`` is
    recording, or a ``recording()`` scope is open."""
    return _rec.scopes > 0 or torch._C._autograd._profiler_enabled()


@contextlib.contextmanager
def recording():
    """Record spans and runs inside this scope, with no profiler."""
    _rec.scopes += 1
    try:
        yield
    finally:
        _rec.scopes -= 1


def clear() -> None:
    """Forget what was recorded, and free its CUDA events."""
    _rec.clear()


class _Off:
    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    """A recorded span: its record and its ``record_function``."""

    __slots__ = ("_name", "_wait", "_updates", "_fn", "_record")

    def __init__(self, name: str, wait: bool, updates: int):
        self._name, self._wait, self._updates = name, wait, updates

    def __enter__(self) -> None:
        self._fn = torch.profiler.record_function(self._name)
        self._fn.__enter__()
        self._record = index = None
        if len(_rec.spans) < RECORD_CAP:
            index = len(_rec.spans)
            self._record = [self._name, time.perf_counter_ns(), None,
                            _rec.open[-1] if _rec.open else None,
                            self._wait, self._updates]
            _rec.spans.append(self._record)
            _rec.summary = None
        else:
            _rec.dropped += 1
        _rec.open.append(index)

    def __exit__(self, *exc) -> bool:
        if self._record is not None:
            self._record[2] = time.perf_counter_ns()
            _rec.summary = None
        if _rec.open:  # empty when clear() ran inside the span
            _rec.open.pop()
        self._fn.__exit__(*exc)
        return False


def span(name: str, *, wait: bool = False, updates: int = 0):
    """A context manager marking host work ``name``. ``wait``: the device
    waits on this work, so a device gap between two graph runs is named
    after it. ``updates``: the span is that many optimizer updates, and
    the graph runs inside it are theirs. Not recording, it does nothing."""
    if not recording_on():
        return _OFF
    return _Span(name, wait, updates)


class _Run(_Span):
    """A recorded span around one graph run, and a pair of CUDA events on
    the current stream around the run's device work."""

    __slots__ = ("_key", "_kind", "_stream", "_run")

    def __init__(self, name: str, key: Hashable, kind: str, device):
        super().__init__(name, False, 0)
        self._key, self._kind = key, kind
        self._stream = torch.cuda.current_stream(device)

    def __enter__(self) -> None:
        super().__enter__()
        self._run = None
        if len(_rec.runs) >= RECORD_CAP:
            _rec.dropped += 1
            return
        start = torch.cuda.Event(enable_timing=True)
        start.record(self._stream)
        self._run = [self._key, self._kind, _rec.open[-1], start,
                     torch.cuda.Event(enable_timing=True),
                     time.perf_counter_ns(), None]
        _rec.runs.append(self._run)
        _rec.summary = None

    def __exit__(self, *exc) -> bool:
        if self._run is not None:
            self._run[4].record(self._stream)
            self._run[6] = time.perf_counter_ns()
            _rec.summary = None
        return super().__exit__(*exc)


def graph_run(name: str, key: Hashable, kind: str, device):
    """A context manager around one run of ``key``'s graph on ``device``:
    a span ``name`` and a pair of CUDA events on the current stream.
    ``kind``: ``warmup`` (an eager body, paced by the host: its whole
    interval is a wait named ``name``), ``capture`` (the replay that
    follows a capture) or ``replay``. Not recording, it does nothing."""
    if not recording_on():
        return _OFF
    return _Run(name, key, kind, device)


def recorded() -> Dict[str, Any]:
    """The :func:`account` of everything recorded since ``clear()``: one
    synchronise, then each run's events resolved against the first run's
    start (a span still open ends now). Cached until a span or run opens
    or closes."""
    if _rec.summary is None:
        now = time.perf_counter_ns()
        runs = []
        if _rec.runs:
            torch.cuda.synchronize()
            first = _rec.runs[0][3]
            runs = [(key, kind, parent, first.elapsed_time(start),
                     first.elapsed_time(end), t0, now if t1 is None else t1)
                    for key, kind, parent, start, end, t0, t1 in _rec.runs]
        spans = [(name, t0, now if t1 is None else t1, parent, wait, k)
                 for name, t0, t1, parent, wait, k in _rec.spans]
        _rec.summary = account(runs, spans, _rec.dropped)
    return _rec.summary


def account(runs: Sequence[tuple], spans: Sequence[tuple],
            dropped: int = 0) -> Dict[str, Any]:
    """The device's account of graph runs and the host's of the waits
    between them.

    ``runs``: ``(key, kind, span, start_ms, end_ms, host_start_ns,
    host_end_ns)`` in launch order on one stream, device times relative to
    any fixed origin, ``span`` the index in ``spans`` of the run's own span
    (or None). ``spans``: ``(name, host_start_ns, host_end_ns, parent,
    wait, updates)``, as :func:`span` takes them.

    Each gap between two consecutive runs on the device is a wait, named
    after the ``wait`` span that took most host time between the first
    run's end and the second's start on the host, or ``launch`` where
    none ran there; a warm-up run's whole interval is a wait named after
    its own span (an eager body runs at the host's pace). Each run belongs
    to the nearest span above it with ``updates``; an update's device time
    is its runs' intervals summed, a span of K updates shares its time
    among them.

    Returns ``runs`` (key, kind, update, start and end ms from the first
    run's start), ``waits`` (ms, label, and the key and index of the run
    that follows the gap or is the warm-up), ``stretch_ms`` (first start
    to last end), ``wait_ms`` by label, ``updates`` (the spans' updates
    summed), ``update_ms`` (a device time an update that ran), ``spans``
    (name and parent) and ``dropped``."""
    t0 = min((r[3] for r in runs), default=0.0)
    # Each update span's first update, counted from 0.
    first: Dict[int, int] = {}
    updates = 0
    for i, s in enumerate(spans):
        if s[5]:
            first[i] = updates
            updates += s[5]
    update_of: Dict[Optional[int], Optional[int]] = {None: None}

    def update(parent: Optional[int]) -> Optional[int]:
        if parent not in update_of:
            up = spans[parent][3]
            update_of[parent] = parent if parent in first else update(up)
        return update_of[parent]

    owner = [update(r[2]) for r in runs]
    out_runs = [{"key": key, "kind": kind,
                 "update": None if u is None else first[u],
                 "start_ms": s - t0, "end_ms": e - t0}
                for (key, kind, _, s, e, _, _), u in zip(runs, owner)]

    # Host time of each wait span within each host interval between
    # consecutive runs; the intervals are disjoint and in order.
    held = [(r[6], n[5]) for r, n in zip(runs, runs[1:])]
    starts = [h0 for h0, _ in held]
    by_gap: List[Dict[str, float]] = [{} for _ in held]
    for name, s0, s1, _, wait, _ in spans:
        if not wait:
            continue
        i = max(bisect.bisect_right(starts, s0) - 1, 0)
        while i < len(held) and held[i][0] < s1:
            overlap = min(s1, held[i][1]) - max(s0, held[i][0])
            if overlap > 0:
                by_gap[i][name] = by_gap[i].get(name, 0.0) + overlap
            i += 1

    waits: List[Dict[str, Any]] = []
    for i, (r, n) in enumerate(zip(runs, runs[1:])):
        gap = n[3] - r[4]
        if gap > 0:
            label = max(by_gap[i], key=by_gap[i].get, default="launch")
            waits.append({"ms": gap, "label": label, "key": n[0],
                          "run": i + 1})
    for i, r in enumerate(runs):
        if r[1] == "warmup":
            label = r[1] if r[2] is None else spans[r[2]][0]
            waits.append({"ms": r[4] - r[3], "label": label, "key": r[0],
                          "run": i})
    wait_ms: Dict[str, float] = {}
    for w in waits:
        wait_ms[w["label"]] = wait_ms.get(w["label"], 0.0) + w["ms"]

    device_ms: Dict[int, float] = {}
    for r, u in zip(out_runs, owner):
        if u is not None:
            device_ms[u] = (device_ms.get(u, 0.0)
                            + r["end_ms"] - r["start_ms"])
    update_ms: List[float] = []
    for i, ms in device_ms.items():
        k = spans[i][5]
        update_ms += [ms / k] * k
    return {
        "runs": out_runs, "waits": waits,
        "stretch_ms": max((r["end_ms"] for r in out_runs), default=0.0),
        "wait_ms": wait_ms, "updates": updates, "update_ms": update_ms,
        "spans": [{"name": s[0], "parent": s[3]} for s in spans],
        "dropped": dropped}
