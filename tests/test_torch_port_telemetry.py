"""The port's telemetry: the profiler scope and the reading of its trace."""

import json

import torch

from primekg_rgcn_tpu_torch.utils.telemetry import (MetricsLogger,
                                                    device_memory_stats,
                                                    device_us_by_range,
                                                    profile_trace,
                                                    trace_breakdown)


def _write_trace(path, events):
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_trace_breakdown_kinds_and_idle(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "gather_segment_sum_kernel",
         "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_f32",
         "ts": 5.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 30.0, "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "multi_tensor_apply_kernel",
         "ts": 40.0, "dur": 2.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm",
         "ts": 0.0, "dur": 100.0},
    ]
    got = trace_breakdown(_write_trace(tmp_path / "t.json", events))
    # Busy is the union of device intervals: [0, 15], [30, 35], [40, 42].
    assert got["busy_us"] == 22.0
    assert got["window_us"] == 42.0
    assert abs(got["idle_share"] - 20.0 / 42.0) < 1e-12
    assert got["device_events"] == 4
    assert got["us_by_kind"] == {"gather_segment_sum": 10.0, "matmul": 10.0,
                                 "memcpy_memset": 5.0, "optimizer": 2.0}


def test_trace_breakdown_names_the_sampled_step_kernels(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "ts": 0.0, "dur": 4.0,
         "name": "void (anonymous namespace)::dense_segment_sum_kernel<2>"
                 "(float const*, int const*, float*, int, int, int)"},
        {"ph": "X", "cat": "kernel", "ts": 4.0, "dur": 1.0,
         "name": "void (anonymous namespace)::window_rows_fetch_kernel"
                 "(int2 const*, int const*, int2*, int, int, int)"},
        {"ph": "X", "cat": "kernel", "ts": 5.0, "dur": 2.0,
         "name": "void cub::DeviceRadixSortOnesweepKernel<Policy>()"},
        {"ph": "X", "cat": "kernel", "ts": 7.0, "dur": 3.0,
         "name": "void at::native::index_elementwise_kernel<128, 4>()"},
    ]
    got = trace_breakdown(_write_trace(tmp_path / "t.json", events))
    assert got["us_by_kind"] == {"dense_segment_sum": 4.0,
                                 "window_rows_fetch": 1.0, "sort": 2.0,
                                 "other": 3.0}
    assert got["busy_us"] == got["window_us"] == 10.0


def test_trace_breakdown_names_the_halo_exchange(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "ts": 0.0, "dur": 6.0,
         "name": "void (anonymous namespace)::halo_exchange_kernel<float4>"
                 "((anonymous namespace)::ShardPointers, int, long)"},
        {"ph": "X", "cat": "kernel", "ts": 8.0, "dur": 2.0,
         "name": "void (anonymous namespace)::gather_segment_sum_kernel<4>"
                 "(float const*, int const*, int const*, float const*, "
                 "float*, int, int, int, int)"},
    ]
    got = trace_breakdown(_write_trace(tmp_path / "t.json", events))
    assert got["us_by_kind"] == {"halo_exchange": 6.0,
                                 "gather_segment_sum": 2.0}
    assert got["busy_us"] == 8.0 and got["window_us"] == 10.0


def test_trace_breakdown_counts_the_fixup_launch_as_b1(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "ts": 0.0, "dur": 7.0,
         "name": "void (anonymous namespace)::gather_segment_sum_kernel<4, "
                 "16, false>(float const*, int const*, int const*, "
                 "float const*, float*, float*, int*, int, int, int, int, "
                 "int, int)"},
        {"ph": "X", "cat": "kernel", "ts": 9.0, "dur": 2.0,
         "name": "void (anonymous namespace)::gather_segment_sum_fixup_kernel"
                 "<4>(float*, float const*, int const*, int, int)"},
        {"ph": "X", "cat": "kernel", "ts": 11.0, "dur": 1.0,
         "name": "void at::native::vectorized_elementwise_kernel<4>()"},
    ]
    got = trace_breakdown(_write_trace(tmp_path / "t.json", events))
    assert got["us_by_kind"] == {"gather_segment_sum": 9.0, "other": 1.0}
    assert got["busy_us"] == 10.0 and got["window_us"] == 12.0


def _timed_calls_trace():
    """Two timed calls: one that launches two kernels and a memset through
    the runtime, one that launches a kernel through the driver API; plus a
    launch outside any timed range and an unrelated annotation."""
    def x(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e
    return [
        x("user_annotation", "timed:kernel#0", 0.0, 20.0),
        x("cuda_runtime", "cudaLaunchKernel", 2.0, 3.0, 1),
        x("cuda_runtime", "cudaMemsetAsync", 6.0, 2.0, 2),
        x("cuda_runtime", "cudaLaunchKernel", 10.0, 3.0, 3),
        x("kernel", "gather_segment_sum_kernel", 30.0, 40.0, 1),
        x("gpu_memset", "Memset (Device)", 71.0, 1.5, 2),
        x("kernel", "gather_segment_sum_fixup_kernel", 80.0, 4.0, 3),
        x("gpu_user_annotation", "timed:kernel#0", 30.0, 54.0),
        x("user_annotation", "timed:library#0", 100.0, 10.0),
        x("cuda_driver", "cuLaunchKernel", 101.0, 2.0, 4),
        x("kernel", "csrmm_kernel", 120.0, 11.0, 4),
        x("cuda_runtime", "cudaLaunchKernel", 200.0, 2.0, 5),
        x("kernel", "outside_kernel", 210.0, 50.0, 5),
        x("user_annotation", "other_range", 195.0, 10.0),
        x("user_annotation", "timed:idle#0", 300.0, 5.0),
        # A kernel whose launch the trace lost.
        x("user_annotation", "timed:lost#0", 400.0, 5.0),
        x("kernel", "gather_segment_sum_kernel", 410.0, 7.0, 6),
    ]


def test_device_us_by_range_charges_each_call_its_launches(tmp_path):
    path = _write_trace(tmp_path / "t.json", _timed_calls_trace())
    got = device_us_by_range(path, "timed:")
    # Two kernels and a memset, not the 54 us from the first launch to the
    # last end; the driver-API launch counts; the untimed launch does not;
    # a kernel without a recorded launch goes to the range before it.
    assert got == {"timed:kernel#0": 45.5, "timed:library#0": 11.0,
                   "timed:idle#0": 0.0, "timed:lost#0": 7.0}


def test_device_us_by_range_reads_a_cpu_trace(tmp_path):
    with profile_trace(tmp_path / "prof"):
        for i in range(2):
            with torch.profiler.record_function(f"timed:mm#{i}"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    got = device_us_by_range(tmp_path / "prof" / "trace.json", "timed:")
    # The ranges are found; a CPU run launches no device work.
    assert got == {"timed:mm#0": 0.0, "timed:mm#1": 0.0}


def test_trace_breakdown_without_device_events(tmp_path):
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::add",
               "ts": 0.0, "dur": 3.0}]
    assert trace_breakdown(_write_trace(tmp_path / "t.json", events)) is None


def test_profile_trace_writes_cpu_trace(tmp_path):
    with profile_trace(tmp_path / "prof") as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert prof is not None
    assert (tmp_path / "prof" / "trace.json").exists()
    # A CPU-only trace holds no device events.
    assert trace_breakdown(tmp_path / "prof" / "trace.json") is None


def test_profile_trace_off_without_dir():
    with profile_trace(None) as prof:
        torch.ones(2) + 1
    assert prof is None


def test_metrics_logger_and_cpu_memory_stats(tmp_path):
    log = MetricsLogger(tmp_path / "m.jsonl")
    log.log("epoch", epoch=1, loss=0.5)
    log.close()
    rec = json.loads((tmp_path / "m.jsonl").read_text())
    assert rec["event"] == "epoch" and rec["loss"] == 0.5
    assert device_memory_stats("cpu") == {}
