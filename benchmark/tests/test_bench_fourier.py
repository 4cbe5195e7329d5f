"""The ``fourier_1m.cascade`` cell: appended last, its pieces found by
name, the readers of the cascade's spans read a hand-made trace (and the
span readers nothing where the program records no span), the ATen count
reads the benchmark's own span, ``fourier_roofline`` counts its bytes and
operations as derived, and at a small size on the CPU the program passes
the check while every fault and the control fail it; on the card, at the
cell's size, on three seeds."""
import json
import time

import pytest
import torch

from benchmark import check, control, run, workload

CELL = "fourier_1m.cascade"
ACCEPTED = ["bank_1m.sift", "eeg_16k.sift", "eeg_16k.grad",
            "meitd_32k.ensemble", "bank_1m.grad", "efd_1m.bands"]
READERS = ("fourier.sine_sift_ms", "fourier.modes_ms")
METRICS = READERS + ("fourier.aten_calls", "fourier_roofline")
SEED = 2 ** 31 + 977


def cell(spec, name=CELL):
    (c,) = [w for w in spec["workloads"] if w["name"] == name]
    return c


def test_bench_fourier_spec(spec):
    names = [w["name"] for w in spec["workloads"]]
    # appended last: the accepted cells keep their places
    assert names[:len(ACCEPTED)] == ACCEPTED
    assert names[-1] == CELL
    c = cell(spec)
    assert (c["config"], c["traffic"], c["chips"]) == (
        "fourier_1m", "cascade", 1)
    (cfg,) = [c for c in spec["configs"] if c["name"] == "fourier_1m"]
    assert cfg["reduced"] == []
    assert spec["configs"][-1] is cfg
    metrics = {m["name"]: m for m in spec["per_layer"]}
    assert [m["name"] for m in spec["per_layer"][-len(METRICS):]] == \
        list(METRICS)
    for name in METRICS:
        assert metrics[name]["workloads"] == [CELL]
        assert metrics[name]["moves"] == "call_p95_ms"
        assert metrics[name]["source"] == "device_trace"
    reported = {m["name"] for m in spec["end_to_end"] if run.in_cell(m, CELL)}
    assert reported == {"setup_s", "call_p95_ms"}
    # no accepted metric lists the new cell
    for m in spec["per_layer"] + spec["end_to_end"]:
        if m["name"] not in METRICS:
            assert CELL not in m.get("workloads", [])


def test_bench_fourier_pieces_found_by_name():
    config = workload.load("configs", "fourier_1m")
    traffic = workload.load("traffic", "cascade")
    assert (config["rows"], config["n"], config["dtype"],
            config["sample_rate"], config["mode"]) == (
        1, 1 << 20, "float32", 2048, "any")
    # (n - 1) / 1024: sample k at k / 2048 s
    assert config["signal"]["t_end_pi"] == (config["n"] - 1) / 1024
    assert [(t["kind"], t.get("freq"), t["amp"])
            for t in config["signal"]["terms"]] == [
        ("sine", 50.0, 1.0), ("sine", 220.0, 0.6), ("noise", None, 0.2)]
    assert (traffic["pool"], traffic["checked"],
            traffic["trace_seconds"]) == (4, 4, 3.0)
    mod = workload.call_module(traffic)
    assert mod.FAULTS == ("unchanged", "half_comb", "altered")
    assert set(traffic["limits"]) == {"recon", "rot_gap", "keep_diff",
                                      "mode_gap", "update_gap"}
    assert traffic["limits"]["keep_diff"] == 0


def test_bench_fourier_input_is_the_bench_signal():
    """The configuration's bank generator puts sample k at k / 2048 s:
    without its noise term the input is ``bench.py``'s tones."""
    import math

    from benchmark.signals import make_bank

    config = workload.load("configs", "fourier_1m")
    n = 4096
    signal = {**config["signal"], "t_end_pi": (n - 1) / 1024,
              "terms": config["signal"]["terms"][:2]}
    gen = torch.Generator().manual_seed(1)
    got = make_bank(signal, 1, n, gen, torch.device("cpu"), torch.float64)[0]
    t = torch.arange(n, dtype=torch.float64) / 2048
    want = torch.sin(2 * math.pi * 50 * t) + 0.6 * torch.sin(
        2 * math.pi * 220 * t)
    assert float((got - want).abs().max()) < 1e-11


def x(name, ts, dur, tid=1, cat="user_annotation", corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def cascade_call(ts, corr):
    """One cascade iteration of 1000 us inside the benchmark's ``cascade``
    span: the sift (two template baselines, kernels 30 + 10 and 40 us),
    the modes (kernels 100 + 50 us), and five top-level ATen operators, one
    of them with an operator nested inside it; the host read (a copy of 5
    us) last."""
    out = [x("cascade", ts, 1000),
           x("pyitd.cascade_iteration", ts + 5, 900),
           x("pyitd.sine_sift", ts + 10, 400),
           x("pyitd.template_baseline", ts + 20, 150),
           x("pyitd.template_baseline", ts + 200, 150),
           x("pyitd.fourier_modes", ts + 500, 350)]
    ops = [(ts + 25, 20), (ts + 210, 30), (ts + 510, 50), (ts + 600, 40),
           (ts + 950, 30)]
    for t, dur in ops:
        out.append(x("aten::op", t, dur, cat="cpu_op"))
    out.append(x("aten::inner", ts + 515, 10, cat="cpu_op"))
    launches = [(ts + 30, 30), (ts + 100, 10), (ts + 220, 40),
                (ts + 520, 100), (ts + 630, 50)]
    for i, (t, dur) in enumerate(launches):
        out += [x("cudaLaunchKernel", t, 2, cat="cuda_runtime",
                  corr=corr + i),
                x(f"kernel_{i}", t + 5, dur, cat="kernel", corr=corr + i)]
    out.append(x("Memcpy DtoH", ts + 955, 5, cat="gpu_memcpy"))
    return out


WINDOW = [x("bench.window", 0, 4000), x("bench.call", 0, 1900),
          x("bench.call", 2000, 1900)]
PROGRAM = cascade_call(10, 100) + cascade_call(2010, 200)
OUTSIDE = cascade_call(-1500, 300) + cascade_call(4100, 400)
WANT = {"fourier.sine_sift_ms": 0.08, "fourier.modes_ms": 0.15,
        "fourier.aten_calls": 5}


def trace_of(tmp_path, events):
    from benchmark.trace import Trace

    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace.from_chrome(path)


@pytest.mark.parametrize("outside", [False, True],
                         ids=["window_only", "with_spans_outside"])
@pytest.mark.parametrize("name", READERS + ("fourier.aten_calls",))
def test_bench_fourier_readers(tmp_path, name, outside):
    tr = trace_of(tmp_path, WINDOW + PROGRAM + (OUTSIDE if outside else []))
    assert run.load_metric(name).read(tr, {}) == pytest.approx(WANT[name])


CTX = {"config": {"rows": 1, "n": 1 << 20, "sample_rate": 2048},
       "peaks": {"hbm_bytes_per_s": 3.35e12, "f32_flops": 6.7e13},
       "sample_bytes": 4}


@pytest.mark.parametrize("name", READERS)
def test_bench_fourier_span_readers_find_nothing(tmp_path, name):
    """A program without the port's spans (the parent of the change that
    added them) gives no span reading, and nothing raises."""
    tr = trace_of(tmp_path, WINDOW + [
        e for e in PROGRAM if not e["name"].startswith("pyitd.")])
    assert run.load_metric(name).read(tr, CTX) is None


def test_bench_fourier_parent_still_reads_calls_and_roofline(tmp_path):
    """The ATen count and the roofline read the benchmark's own span, so
    they read on a program without the port's spans too."""
    tr = trace_of(tmp_path, WINDOW + [
        e for e in PROGRAM if not e["name"].startswith("pyitd.")])
    assert run.load_metric("fourier.aten_calls").read(tr, CTX) == 5
    assert run.load_metric("fourier_roofline").read(tr, CTX) > 0


@pytest.mark.parametrize("name", METRICS)
def test_bench_fourier_readers_need_the_call(tmp_path, name):
    tr = trace_of(tmp_path, WINDOW + [
        e for e in PROGRAM if e["name"] != "cascade"
        and not e["name"].startswith("pyitd.")])
    assert run.load_metric(name).read(tr, CTX) is None


def test_bench_fourier_roofline_work():
    m = run.load_metric("fourier_roofline")
    assert m.comb_size(2048) == 10
    assert (m.comb_size(256), m.comb_size(1024)) == (1, 5)
    # the input, ten rotations, the residual, the update and ten half
    # spectra of 2^20 f32
    assert m.cascade_bytes(1, 1 << 20, 10) == 4 * (1 << 20) * 23 \
        == 96_468_992
    # ten rffts and one irfft of 2^20, 2.5 N log2 N each
    assert m.cascade_flops(1, 1 << 20, 10) == 11 * 2.5 * (1 << 20) * 20 \
        == 576_716_800
    # at the data sheet's peaks the bytes bound the call
    assert 96_468_992 / 3.35e12 * 1e3 == pytest.approx(0.028797, rel=1e-4)
    assert 576_716_800 / 6.7e13 * 1e3 == pytest.approx(0.0086077, rel=1e-4)


def test_bench_fourier_roofline_reads(tmp_path):
    tr = trace_of(tmp_path, WINDOW + PROGRAM)
    ctx = {"config": {"rows": 1, "n": 8, "sample_rate": 2048},
           "peaks": {"hbm_bytes_per_s": 1e6, "f32_flops": 1e9},
           "sample_bytes": 4}
    m = run.load_metric("fourier_roofline")
    # bytes 4 * 8 * 23 = 736 at 1e6 B/s: 736 us, over the flops' 0.66 us;
    # busy 235 us a call (five kernels and the copy)
    assert m.cascade_bytes(1, 8, 10) == 736
    assert m.read(tr, ctx) == pytest.approx(100 * 736 / 235)
    assert m.read(tr, {**ctx, "peaks": {"hbm_bytes_per_s": 1e6}}) is None


@pytest.fixture
def small(monkeypatch, small_load):
    monkeypatch.setattr(workload, "load", small_load)
    return small_load


@pytest.mark.parametrize("kind", (None, "unchanged", "half_comb",
                                  "altered"))
def test_bench_fourier_fault_is_caught(spec, kind, small):
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


def test_bench_fourier_half_comb_restores_the_comb(spec, small):
    """The fault swaps the comb only for its own call."""
    from pyitd_tpu_torch.decomp import itd_fourier as tif

    c = cell(spec)
    config = small("configs", c["config"])
    traffic = small("traffic", c["traffic"])
    mod = workload.call_module(traffic)
    call = mod.make_call(config, traffic, workload.spans(False))
    (bank,) = mod.inputs(config, {**traffic, "pool": 1}, 3,
                         torch.device("cpu"))
    before = tif._sine_template_static
    assert mod.plant(call, "half_comb", config)(bank)[
        "rotations"].shape[0] == 5
    assert tif._sine_template_static is before
    assert call(bank)["rotations"].shape[0] == 10


def test_bench_fourier_control_fails_small(spec, small_load):
    r = control.readings(cell(spec), 5, torch.device("cpu"), load=small_load)
    limits = small_load("traffic", "cascade")["limits"]
    got = {k: check.judge(v, limits)[0] for k, v in r.items()}
    assert got == {k: k == "sound" for k in got}, r


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 2 ** 31 + 5, 9_000_000_001])
def test_bench_fourier_control_on_card(spec, seed, card):
    c = cell(spec)
    traffic = workload.load("traffic", c["traffic"])
    r = control.readings(c, seed, card)
    got = {k: check.judge(v, traffic["limits"])[0] for k, v in r.items()}
    assert got == {k: k == "sound" for k in got}, r
