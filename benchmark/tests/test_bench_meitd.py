"""The ``meitd_32k.ensemble`` and ``bank_1m.grad`` cells: their pieces are
found by name, the readers of the walk's and the cubic level's spans read
a hand-made trace (and nothing where the program records no span),
``grad_roofline`` counts its bytes as derived, and at a small size on the
CPU the program passes the check while every fault and the control fail
it."""
import json
import time

import pytest
import torch

from benchmark import check, control, run, workload
from benchmark.reference import meitd as ref

CELLS = ("meitd_32k.ensemble", "bank_1m.grad")
READERS = ("meitd.levels_per_call", "meitd.reads_per_call",
           "meitd.walk_self_ms", "cubic.level_host_ms", "cubic.interface_ms",
           "cubic.eager_ms")
SEED = 2 ** 31 + 977
SMALL_N = 1024


def cell(spec, name):
    (c,) = [w for w in spec["workloads"] if w["name"] == name]
    return c


def test_bench_meitd_spec(spec):
    assert [w["name"] for w in spec["workloads"][-2:]] == list(CELLS)
    assert all(cell(spec, c)["chips"] == 1 for c in CELLS)
    (cfg,) = [c for c in spec["configs"] if c["name"] == "meitd_32k"]
    assert cfg["reduced"] == []
    metrics = {m["name"]: m for m in spec["per_layer"]}
    for name in READERS:
        assert metrics[name]["workloads"] == ["meitd_32k.ensemble"]
        assert metrics[name]["moves"] == "call_p95_ms"
    assert metrics["grad_roofline"]["workloads"] == ["bank_1m.grad",
                                                    "eeg_16k.grad"]


def test_bench_meitd_pieces_found_by_name():
    config = workload.load("configs", "meitd_32k")
    traffic = workload.load("traffic", "ensemble")
    assert (config["rows"], config["n"], config["realizations"]) == \
        (1, 32768, 32)
    assert getattr(torch, config["level_dtype"]) == \
        ref.LOWER[workload.dtype(config)]
    mod = workload.call_module(traffic)
    assert mod.FAULTS == ("unchanged", "half_batch", "altered")
    assert set(traffic["limits"]) == {"recon", "count_diff",
                                      "stack_row_median", "stack_row_p90",
                                      "mean_gap"}
    for name in READERS + ("grad_roofline",):
        assert callable(run.load_metric(name).read)


def x(name, ts, dur, tid=1, cat="user_annotation", corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def level(ts, corr):
    """A cubic level of 100 us: four wrappers, the interface solve of 40
    us, one port kernel and one eager kernel launched inside it."""
    return [x("pyitd.cubic_level", ts, 100),
            x("pyitd.cubic_ksite", ts + 2, 5),
            x("pyitd.cubic_neighbors", ts + 8, 5),
            x("pyitd.spike_factors", ts + 14, 5),
            x("pyitd.interface_solve", ts + 20, 40),
            x("pyitd.spike_backsub_eval", ts + 62, 5),
            x("cudaLaunchKernel", ts + 3, 1, cat="cuda_runtime", corr=corr),
            x("cudaLaunchKernel", ts + 30, 1, cat="cuda_runtime",
              corr=corr + 1),
            x("cubic_ksite_kernel", ts + 10, 7, cat="kernel", corr=corr),
            x("elementwise_kernel<mul>", ts + 35, 3, cat="kernel",
              corr=corr + 1)]


def walk(ts, corr):
    """One call's walk of 1000 us: two trips; three levels (300 us), four
    reads of 10 us, two entropies of 20 us (one inside a dig), so 620 us
    of its own; the epilogue's entropy lies outside the walk."""
    return [x("pyitd.ensemble", ts, 1200), x("pyitd.walk", ts + 10, 1000),
            x("pyitd.walk_trip", ts + 20, 400),
            x("pyitd.wpe", ts + 30, 20), x("pyitd.read", ts + 55, 10),
            *level(ts + 70, corr), x("pyitd.read", ts + 180, 10),
            x("pyitd.walk_trip", ts + 500, 450),
            *level(ts + 510, corr + 2),
            x("pyitd.dig", ts + 620, 300), x("pyitd.read", ts + 630, 10),
            *level(ts + 650, corr + 4), x("pyitd.wpe", ts + 760, 20),
            x("pyitd.read", ts + 790, 10),
            x("pyitd.ensemble_select", ts + 1020, 150),
            x("pyitd.wpe", ts + 1030, 50)]


WINDOW = [x("bench.window", 0, 4000), x("bench.call", 0, 1900),
          x("meitd_ensemble", 5, 1800), x("bench.call", 2000, 1900),
          x("meitd_ensemble", 2005, 1800)]
PROGRAM = walk(10, 100) + walk(2010, 200)
OUTSIDE = walk(-1500, 300) + walk(4100, 400)
WANT = {"meitd.levels_per_call": 3.0, "meitd.reads_per_call": 4.0,
        "meitd.walk_self_ms": 0.62, "cubic.level_host_ms": 0.3,
        "cubic.interface_ms": 0.12, "cubic.eager_ms": 0.009}


def trace_of(tmp_path, events):
    from benchmark.trace import Trace

    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace.from_chrome(path)


@pytest.mark.parametrize("outside", [False, True],
                         ids=["window_only", "with_spans_outside"])
@pytest.mark.parametrize("name", READERS)
def test_bench_meitd_readers(tmp_path, name, outside):
    tr = trace_of(tmp_path, WINDOW + PROGRAM + (OUTSIDE if outside else []))
    assert run.load_metric(name).read(tr, {}) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_bench_meitd_readers_find_nothing(tmp_path, name):
    """A program without the spans (the parent of the change that added
    them) gives no reading, and nothing raises."""
    tr = trace_of(tmp_path, WINDOW + [
        e for e in OUTSIDE if not e["name"].startswith("pyitd.")])
    assert run.load_metric(name).read(tr, {}) is None


def test_bench_grad_bytes():
    grad_bytes = run.load_metric("grad_roofline").grad_bytes
    # 10 output rows of 64 x 1M f32: the forward's 31 streams and four per
    # level adjoint
    assert grad_bytes(64, 1_000_000, 8) == 4 * 64_000_000 * (31 + 40)
    # 2 x 10 f32, one trip (3 rows): 10 + 12 streams of 20 samples
    assert grad_bytes(2, 10, 1) == 4 * 20 * 22 == 1760


def test_bench_grad_roofline_reads(tmp_path):
    events = [x("bench.window", 0, 1000), x("bench.call", 0, 400),
              x("bench.call", 500, 400),
              x("kern", 100, 160, cat="kernel", corr=1)]
    tr = trace_of(tmp_path, events)
    ctx = {"config": {"rows": 2, "n": 10, "max_iteration": 1},
           "peaks": {"hbm_bytes_per_s": 1e7}, "sample_bytes": 4}
    # 1760 bytes at 1e7 B/s: 176 us over 80 us busy a call
    got = run.load_metric("grad_roofline").read(tr, ctx)
    assert got == pytest.approx(100 * 176 / 80)
    assert run.load_metric("grad_roofline").read(
        tr, {**ctx, "peaks": {}}) is None


@pytest.fixture
def small_meitd(monkeypatch):
    """The ensemble cell cut to ``SMALL_N`` samples and one recording, with
    the cubic level on the card's route (the kernels' plain versions)."""
    from pyitd_tpu_torch.decomp import meitd as port_meitd

    monkeypatch.setattr(port_meitd, "_CUBIC_BACKEND", "fills")
    orig = workload.load

    def load(kind, name):
        d = orig(kind, name)
        if kind == "configs":
            return {**d, "n": SMALL_N}
        return {**d, "pool": 1, "checked": 1} if name == "ensemble" else d
    monkeypatch.setattr(workload, "load", load)
    return load


@pytest.mark.parametrize("kind", (None, "unchanged", "half_batch",
                                  "altered"))
def test_bench_meitd_fault_is_caught(spec, kind, small_meitd):
    c = cell(spec, "meitd_32k.ensemble")
    plant = None
    if kind is not None:
        config = small_meitd("configs", c["config"])
        mod = workload.call_module(small_meitd("traffic", c["traffic"]))

        def plant(call):
            return mod.plant(call, kind, config)
    result = run.run_cell(spec, c, SEED, 0.2, False, torch.device("cpu"),
                          time.perf_counter(), plant=plant)
    assert result["correct"] is (kind is None), result["compared"]
    assert set(result["metrics"]) == {"setup_s", "call_p95_ms"}


def test_bench_meitd_control_fails(spec, small_meitd):
    r = control.readings(cell(spec, "meitd_32k.ensemble"), 5,
                         torch.device("cpu"), load=small_meitd)
    limits = small_meitd("traffic", "ensemble")["limits"]
    got = {k: check.judge(v, limits)[0] for k, v in r.items()}
    assert got == {k: k == "sound" for k in got}, r


@pytest.mark.parametrize("kind", ("unchanged", "half_batch", "altered"))
def test_bench_bank_grad_fault_is_caught(spec, kind, monkeypatch,
                                         small_load, plain_kernels):
    """The faults of ``bank_1m.grad`` at a small size.  Its sound run is
    held at the cell's own size on the card: in rows of 3,000 samples one
    ill-conditioned segment of the f32 gradient (``calls/grad.py``) sets a
    row's whole gradient norm, and this bank's reads 0.25 at its 90th
    percentile."""
    c = cell(spec, "bank_1m.grad")
    monkeypatch.setattr(workload, "load", small_load)
    config = small_load("configs", c["config"])
    mod = workload.call_module(small_load("traffic", c["traffic"]))
    result = run.run_cell(spec, c, SEED, 0.2, False, torch.device("cpu"),
                          time.perf_counter(),
                          plant=lambda call: mod.plant(call, kind, config))
    assert result["correct"] is False, result["compared"]
    assert set(result["metrics"]) == {"setup_s", "call_p95_ms"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_bench_new_cells_control_on_card(spec, name, card):
    c = cell(spec, name)
    traffic = workload.load("traffic", c["traffic"])
    r = control.readings(c, 2 ** 31 + 11, card)
    got = {k: check.judge(v, traffic["limits"])[0] for k, v in r.items()}
    assert got == {k: k == "sound" for k in got}, r
