"""Reading a ``torch.profiler`` trace of a traced stretch of the window.

The busy-union and idle arithmetic is the port's
``utils/telemetry.trace_breakdown``. A trace on the card's machine can drop
its first records (up to a few dozen), so the stretch is bounded by marker
kernels that the harness launches itself (``torch.cuda._sleep``'s
``spin_kernel``, which the port never launches): ``HEAD_MARKS`` before it
and ``TAIL_MARKS`` after it, each followed by a synchronise. Only device
work between the last head marker and the first tail marker counts.
"""

from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

MARKER_KERNEL = "spin_kernel"
HEAD_MARKS = 128
TAIL_MARKS = 32
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
# Kernel families by a substring of their names: the port's hand-written
# kernels, each call's main kernel with its zeroing and fix-up launches.
KERNEL_FAMILIES = {"B1": "gather_segment_sum", "B2": "dense_segment_sum"}


@dataclass
class TraceSummary:
    """What a traced stretch holds, in seconds."""
    window_s: float
    busy_s: float
    family_s: Dict[str, float]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    head_marks: int
    tail_marks: int

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _marks(n: int) -> None:
    import torch

    for _ in range(n):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()


class Tracer:
    """A ``torch.profiler`` trace of the work between :meth:`start` and
    :meth:`stop`, bounded by marker kernels; :meth:`stop` returns its
    :class:`TraceSummary` (None when the trace lost every head or every
    tail marker). The trace file lives in a temporary directory under
    ``TMPDIR`` and is deleted once read."""

    def __init__(self):
        self._prof = None

    def start(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        _marks(HEAD_MARKS)

    def stop(self) -> Optional["TraceSummary"]:
        import torch

        torch.cuda.synchronize()
        _marks(TAIL_MARKS)
        self._prof.__exit__(None, None, None)
        tmp = tempfile.mkdtemp(prefix="portbench_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self._prof = None
        return summarize(events)


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def _host_at(host: List[Tuple[float, float, str]], starts: List[float],
             t: float) -> str:
    """The shortest host event that covers time ``t`` (the innermost call
    the host was in), or "host idle"."""
    best, best_len = "host idle", float("inf")
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(host[max(0, i - 400):i]):
        if e >= t and e - s < best_len:
            best, best_len = name, e - s
    return best


def summarize(events: List[Dict]) -> Optional[TraceSummary]:
    """The :class:`TraceSummary` of a Chrome trace's events (times in
    microseconds there), or None without head and tail markers."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    work = [e for e in dev if MARKER_KERNEL not in e["name"]]
    marks = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev
                   if MARKER_KERNEL in e["name"])
    if len(marks) < 2:
        return None
    # The traced block lies in the widest gap between two markers: the
    # head markers end before it, the tail markers start after it.
    cut = max(range(1, len(marks)),
              key=lambda i: marks[i][0] - marks[i - 1][1])
    w0, w1 = marks[cut - 1][1], marks[cut][0]
    inside = [e for e in work if e["ts"] >= w0 and e["ts"] + e["dur"] <= w1]
    if not inside:
        return None
    busy_spans = _union([(e["ts"], e["ts"] + e["dur"]) for e in inside])
    busy = sum(e - s for s, e in busy_spans)

    by_name: Dict[str, float] = {}
    family = {k: 0.0 for k in KERNEL_FAMILIES}
    for e in inside:
        name = e["name"]
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + e["dur"]
        for k, sub in KERNEL_FAMILIES.items():
            if sub in name:
                family[k] += e["dur"]

    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"][:120])
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") in HOST_CATS and w0 <= e["ts"] <= w1)
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for span in busy_spans for x in span] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            label = _host_at(host, starts, (s + e) / 2)
            gaps[label] = gaps.get(label, 0.0) + (e - s)

    def top(d: Dict[str, float]) -> List[Tuple[str, float]]:
        return [(k, v / 1e6) for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return TraceSummary(
        window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6,
        family_s={k: v / 1e6 for k, v in family.items()},
        device_ops=top(by_name), idle_gaps=top(gaps),
        head_marks=cut, tail_marks=len(marks) - cut)
