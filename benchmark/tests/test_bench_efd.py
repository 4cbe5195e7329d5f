"""The ``efd_1m.bands`` cell: its pieces are found by name, the readers of
EFD's spans read a hand-made trace (and nothing where the program records
no span), ``efd_roofline`` counts its bytes and operations as derived, the
reference loads nothing of the program, and at a small size on the CPU the
program passes the check while every fault and the control fail it; on
the card, at the cell's size, on three seeds."""
import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import check, control, run, workload

CELL = "efd_1m.bands"
READERS = ("efd.segments_ms", "efd.bands_ms")
SEED = 2 ** 31 + 977


def cell(spec, name=CELL):
    (c,) = [w for w in spec["workloads"] if w["name"] == name]
    return c


def test_bench_efd_spec(spec):
    names = [w["name"] for w in spec["workloads"]]
    # appended last: the cells before it keep their places
    assert names == ["bank_1m.sift", "eeg_16k.sift", "eeg_16k.grad",
                     "meitd_32k.ensemble", "bank_1m.grad", CELL]
    c = cell(spec)
    assert (c["config"], c["traffic"], c["chips"]) == ("efd_1m", "bands", 1)
    (cfg,) = [c for c in spec["configs"] if c["name"] == "efd_1m"]
    assert cfg["reduced"] == []
    metrics = {m["name"]: m for m in spec["per_layer"]}
    for name in READERS + ("efd_roofline",):
        assert metrics[name]["workloads"] == [CELL]
        assert metrics[name]["moves"] == "call_p95_ms"
        assert metrics[name]["source"] == "device_trace"
    reported = {m["name"] for m in spec["end_to_end"] if run.in_cell(m, CELL)}
    assert reported == {"setup_s", "call_p95_ms"}


def test_bench_efd_pieces_found_by_name():
    config = workload.load("configs", "efd_1m")
    traffic = workload.load("traffic", "bands")
    assert (config["rows"], config["n"], config["dtype"],
            config["n_bands"]) == (8, 1 << 20, "float32", 12)
    assert [(t["kind"], t.get("freq"), t["amp"])
            for t in config["signal"]["terms"]] == [
        ("sine", 40.0, 1.0), ("sine", 250.0, 0.7), ("sine", 1200.0, 0.4),
        ("noise", None, 0.1)]
    assert (traffic["pool"], traffic["checked"]) == (4, 4)
    mod = workload.call_module(traffic)
    assert mod.FAULTS == ("unchanged", "half_batch", "altered")
    assert set(traffic["limits"]) == {"count_diff", "bound_diff",
                                      "band_gap"}
    assert traffic["limits"]["count_diff"] == traffic["limits"][
        "bound_diff"] == 0


def test_bench_efd_reference_takes_nothing_of_the_program():
    out = subprocess.run(
        [sys.executable, "-c", "import benchmark.reference.efd, sys, torch\n"
         "print(torch.backends.cuda.matmul.allow_tf32,"
         " torch.backends.cudnn.allow_tf32)\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=300,
        check=True)
    flags, top = out.stdout.splitlines()
    assert flags == "False False"  # no TF32 in the float32 reference
    assert not set(top.split()) & {"pyitd_tpu_torch", "pyitd_tpu", "jax"}


def x(name, ts, dur, tid=1, cat="user_annotation", corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def efd_call(ts, corr):
    """One EFD of 1000 us: the input's rfft (kernel 20 us) outside both
    inner spans, the segmentation (two kernels, 30 + 10 us) and the
    filterbank (three kernels, 100 + 50 + 200 us)."""
    out = [x("pyitd.efd", ts, 1000), x("pyitd.efd_segments", ts + 100, 300),
           x("pyitd.efd_bands", ts + 450, 500)]
    launches = [(ts + 10, 20), (ts + 110, 30), (ts + 200, 10),
                (ts + 460, 100), (ts + 600, 50), (ts + 700, 200)]
    for i, (t, dur) in enumerate(launches):
        out += [x("cudaLaunchKernel", t, 2, cat="cuda_runtime", corr=corr + i),
                x(f"fft_kernel_{i}", t + 5, dur, cat="kernel", corr=corr + i)]
    return out


WINDOW = [x("bench.window", 0, 4000), x("bench.call", 0, 1900),
          x("efd", 5, 1800), x("bench.call", 2000, 1900),
          x("efd", 2005, 1800)]
PROGRAM = efd_call(10, 100) + efd_call(2010, 200)
OUTSIDE = efd_call(-1500, 300) + efd_call(4100, 400)
WANT = {"efd.segments_ms": 0.04, "efd.bands_ms": 0.35}


def trace_of(tmp_path, events):
    from benchmark.trace import Trace

    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace.from_chrome(path)


@pytest.mark.parametrize("outside", [False, True],
                         ids=["window_only", "with_spans_outside"])
@pytest.mark.parametrize("name", READERS)
def test_bench_efd_readers(tmp_path, name, outside):
    tr = trace_of(tmp_path, WINDOW + PROGRAM + (OUTSIDE if outside else []))
    assert run.load_metric(name).read(tr, {}) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS + ("efd_roofline",))
def test_bench_efd_readers_find_nothing(tmp_path, name):
    """A program without the spans (the parent of the change that added
    them) gives no reading, and nothing raises."""
    tr = trace_of(tmp_path, WINDOW + [
        e for e in PROGRAM if not e["name"].startswith("pyitd.")])
    ctx = {"config": {"rows": 8, "n": 1 << 20, "n_bands": 12},
           "peaks": {"hbm_bytes_per_s": 3.35e12, "f32_flops": 6.7e13},
           "sample_bytes": 4}
    assert run.load_metric(name).read(tr, ctx) is None


def test_bench_efd_roofline_work():
    m = run.load_metric("efd_roofline")
    # the input and 14 band rows of 8 x 2^20 f32
    assert m.efd_bytes(8, 1 << 20, 12) == 4 * 8 * (1 << 20) * 15 \
        == 503_316_480
    # per signal: one rfft of 2^20, then 15 real transforms of 2^21 (the
    # mirror's rfft and 14 inverse), 2.5 N log2 N each
    per_row = 2.5 * (1 << 20) * 20 + 15 * 2.5 * (1 << 21) * 21
    assert m.efd_flops(8, 1 << 20, 12) == 8 * per_row == 13_631_488_000
    # at the data sheet's peaks the transforms bound the call
    assert 503_316_480 / 3.35e12 * 1e3 == pytest.approx(0.15024, rel=1e-4)
    assert 13_631_488_000 / 6.7e13 * 1e3 == pytest.approx(0.20346, rel=1e-4)


def test_bench_efd_roofline_reads(tmp_path):
    tr = trace_of(tmp_path, WINDOW + PROGRAM)
    ctx = {"config": {"rows": 2, "n": 8, "n_bands": 1},
           "peaks": {"hbm_bytes_per_s": 1e6, "f32_flops": 1e9},
           "sample_bytes": 4}
    m = run.load_metric("efd_roofline")
    # bytes 4 * 16 * 4 = 256 at 1e6 B/s: 256 us, over the flops' 1.4 us;
    # busy 410 us a call
    assert m.efd_bytes(2, 8, 1) == 256
    assert m.read(tr, ctx) == pytest.approx(100 * 256 / 410)
    assert m.read(tr, {**ctx, "peaks": {"hbm_bytes_per_s": 1e6}}) is None


@pytest.fixture
def small(monkeypatch, small_load):
    monkeypatch.setattr(workload, "load", small_load)
    return small_load


@pytest.mark.parametrize("kind", (None, "unchanged", "half_batch",
                                  "altered"))
def test_bench_efd_fault_is_caught(spec, kind, small):
    c = cell(spec)
    plant = None
    if kind is not None:
        config = small("configs", c["config"])
        mod = workload.call_module(small("traffic", c["traffic"]))

        def plant(call):
            return mod.plant(call, kind, config)
    result = run.run_cell(spec, c, SEED, 0.2, False, torch.device("cpu"),
                          time.perf_counter(), plant=plant)
    assert result["correct"] is (kind is None), result["compared"]
    assert (result["failed"] == 0) is (kind is None)
    assert set(result["metrics"]) == {"setup_s", "call_p95_ms"}
    json.dumps(result)


def test_bench_efd_control_fails_small(spec, small_load):
    r = control.readings(cell(spec), 5, torch.device("cpu"), load=small_load)
    limits = small_load("traffic", "bands")["limits"]
    got = {k: check.judge(v, limits)[0] for k, v in r.items()}
    assert got == {k: k == "sound" for k in got}, r


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 2 ** 31 + 5, 9_000_000_001])
def test_bench_efd_control_on_card(spec, seed, card):
    c = cell(spec)
    traffic = workload.load("traffic", c["traffic"])
    r = control.readings(c, seed, card)
    got = {k: check.judge(v, traffic["limits"])[0] for k, v in r.items()}
    assert got == {k: k == "sound" for k in got}, r
