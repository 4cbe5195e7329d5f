"""The trace reduction and the per-layer readers on a hand-made trace."""
import json

import pytest

from benchmark import run
from benchmark.trace import Trace


def x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    x("bench.window", "user_annotation", 0, 1000),
    x("bench.call", "user_annotation", 0, 400),
    x("bench.call", "user_annotation", 500, 400),
    x("itd_sift", "user_annotation", 10, 290),
    x("itd_sift", "user_annotation", 510, 290),
    x("aten::empty", "cpu_op", 20, 10),
    x("aten::zeros", "cpu_op", 40, 40),
    x("aten::fill_", "cpu_op", 50, 20),
    x("cudaLaunchKernel", "cuda_runtime", 45, 2, corr=1),
    x("aten::mul", "cpu_op", 100, 20),
    x("cudaLaunchKernel", "cuda_runtime", 105, 2, corr=2),
    x("aten::add", "cpu_op", 520, 20),
    x("cudaLaunchKernel", "cuda_runtime", 525, 2, corr=3),
    x("cudaLaunchKernel", "cuda_runtime", 600, 2, corr=4),  # record lost
    x("backward", "user_annotation", 700, 200),
    x("cudaLaunchKernel", "cuda_runtime", 750, 2, tid=2, corr=6),
    x("cudaLaunchKernel", "cuda_runtime", 760, 2, tid=2, corr=7),
    x("void at::native::fill_kernel", "kernel", 100, 50, corr=1),
    x("void sift_level_kernel<true>", "kernel", 140, 100, corr=2),
    x("void elementwise_kernel", "kernel", 600, 100, corr=3),
    x("aten_glue_kernel", "kernel", 760, 20, corr=6),
    x("void scan_lookback<Fill2>", "kernel", 785, 5, corr=7),
    x("Memcpy DtoH", "gpu_memcpy", 800, 10, corr=8),
    x("bench.call", "user_annotation", 1200, 10),  # after the window
]


@pytest.fixture
def trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return Trace.from_chrome(path)


def test_bench_trace_reduction(trace):
    assert trace.calls == 2 and trace.missing == 1
    assert trace.busy_intervals() == [(100, 240), (600, 700), (760, 780),
                                      (785, 790), (800, 810)]
    assert trace.busy_us() == 275 + 50   # one lost record at the median
    assert trace.top_level_ops("itd_sift") == 4
    assert [e.corr for e in trace.kernels_launched_in("backward")] == [6, 7]
    b = trace.breakdown()
    assert b["device_ops"][0][1] == pytest.approx(1e-4)
    # idle from 240 to 600 us while the host sat in itd_sift between ops
    assert b["idle_gaps"][0] == ["itd_sift > python", pytest.approx(3.6e-4)]


CTX = {"config": {"rows": 2, "n": 10, "max_iteration": 1},
       "peaks": {"hbm_bytes_per_s": 1e7}, "sample_bytes": 4}


@pytest.mark.parametrize("name,want", [
    ("itd_sift.aten_calls", 2.0),
    ("device.kernels_per_call", 3.0),
    ("device.idle_share", 1 - 325 / 1000),
    ("backward.eager_ms", 0.02),
    ("sift_roofline", 100 * 80 / (325 / 2)),
])
def test_bench_readers(trace, name, want):
    assert run.load_metric(name).read(trace, CTX) == pytest.approx(want)


def test_bench_readers_find_nothing(trace):
    empty = {**CTX, "peaks": {}}
    assert run.load_metric("sift_roofline").read(trace, empty) is None
    assert run.load_metric("backward.eager_ms").read(
        Trace([e for e in trace.host if e.name == "bench.window"]), CTX) \
        is None


def test_bench_sift_bytes():
    sift_bytes = run.load_metric("sift_roofline").sift_bytes
    # 10 extractions of 64 x 1M f32: one read and two writes each, and the
    # correction
    assert sift_bytes(64, 1_000_000, 8) == 4 * 64_000_000 * 31
    assert sift_bytes(2, 10, 1) == 4 * 20 * 10


def test_bench_port_kernel_names():
    names = run.load_metric("backward.eager_ms").port_kernels()
    assert {"sift_level_kernel", "tile_scan_kernel", "scan_lookback",
            "level_summaries_kernel"} <= names
