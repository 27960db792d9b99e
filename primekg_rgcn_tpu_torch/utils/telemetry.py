"""Observability: a JSONL metrics stream, device memory counters and a
profiler trace scope.

- MetricsLogger: one JSON object per line beside the human-readable log,
  so training curves are machine-readable.
- device_memory_stats: the CUDA caching allocator's counters.
- profile_trace: a ``torch.profiler`` scope (CPU and, on a card, CUDA
  activity) that writes a Chrome trace, ``trace.json``, into its directory.
- trace_breakdown: device time by kind and the idle share read from such a
  trace.
- device_us_by_range: the device time of the work launched inside each
  ``record_function`` range of such a trace (a kernel's time per call).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

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
