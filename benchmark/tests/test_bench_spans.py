"""The readers of the program's own spans (``benchmark/spans.py``) on a
hand-made trace: two calls on the harness's thread, a backward on a second
thread, and spans outside the window that must not count."""
import json

import pytest

from benchmark import run
from benchmark.trace import Trace


def x(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


WINDOW = [x("bench.window", 0, 2000)]
BENCH = [
    x("bench.call", 0, 900), x("itd_sift", 10, 590), x("backward", 600, 290),
    x("bench.call", 1000, 500), x("itd_sift", 1005, 400),
    x("aten::empty", 25, 3, cat="cpu_op"),
    x("aten::empty", 35, 5, cat="cpu_op"),
]
PROGRAM = [
    # call 1: the sift (560 us), the first extraction, then two trips;
    # wrappers 220 us, so 340 us of the loop's own
    x("pyitd.sift", 20, 560),
    x("pyitd.level_summaries", 30, 20), x("pyitd.tile_scan", 50, 10),
    x("pyitd.sift_level", 60, 40),
    x("pyitd.trip", 110, 190),
    x("pyitd.tile_scan", 120, 20), x("pyitd.sift_level", 150, 50),
    x("pyitd.trip", 300, 200),
    x("pyitd.tile_scan", 310, 20), x("pyitd.sift_level", 340, 60),
    # a wrapper on another thread while the sift runs: no part of the
    # sift's self time, but a wrapper call all the same
    x("pyitd.segsum", 200, 60, tid=2),
    # call 1's backward on the engine's thread: 270 us, the replay 80,
    # two adjoints 50 each, so 90 us of its own
    x("pyitd.sift_bwd", 610, 270, tid=2),
    x("pyitd.replay", 620, 80, tid=2),
    x("pyitd.level_summaries", 630, 10, tid=2),
    x("pyitd.tile_scan", 640, 10, tid=2),
    x("pyitd.sift_level", 650, 20, tid=2),
    x("pyitd.level_bwd", 710, 50, tid=2),
    x("pyitd.fill2", 715, 10, tid=2), x("pyitd.segsum", 730, 10, tid=2),
    x("pyitd.level_bwd", 770, 50, tid=2),
    x("pyitd.fill2", 775, 10, tid=2), x("pyitd.segsum", 790, 10, tid=2),
    # call 2: the sift 390 us, one wrapper of 100 inside a trip
    x("pyitd.sift", 1010, 390), x("pyitd.trip", 1050, 250),
    x("pyitd.sift_level", 1100, 100),
]
OUTSIDE = [  # a traced call before the window and one after it
    x("pyitd.sift", -500, 300), x("pyitd.tile_scan", -490, 50),
    x("pyitd.sift_bwd", -150, 100, tid=2), x("pyitd.replay", -140, 40, tid=2),
    x("pyitd.level_bwd", -90, 30, tid=2),
    x("pyitd.sift", 2100, 100), x("pyitd.fill2", 2110, 40),
]

# per call (2 calls), ms
WANT = {
    "trip_loop.host_self_ms": (340 + 290) / 2e3,
    "wrappers.host_ms": (220 + 100 + 60 + 40 + 40) / 2e3,
    "wrappers.launches_per_call": (7 + 1 + 1 + 3 + 4) / 2,
    "backward.replay_ms": 80 / 2e3,
    "backward.adjoint_ms": 100 / 2e3,
    "backward.self_ms": 90 / 2e3,
}
CTX = {"config": {}, "traffic": {}, "peaks": {}, "sample_bytes": 4}


def trace_of(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace.from_chrome(path)


def read(name, trace):
    return run.load_metric(name).read(trace, CTX)


@pytest.mark.parametrize("outside", [False, True],
                         ids=["window_only", "with_spans_outside"])
@pytest.mark.parametrize("name", list(WANT))
def test_bench_span_readers(tmp_path, name, outside):
    events = WINDOW + BENCH + PROGRAM + (OUTSIDE if outside else [])
    assert read(name, trace_of(tmp_path, events)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", list(WANT))
def test_bench_span_readers_find_nothing(tmp_path, name):
    """A program that records no span of its own (the parent of the change
    that added them) gives no reading, and nothing raises."""
    assert read(name, trace_of(tmp_path, WINDOW + BENCH + OUTSIDE)) is None


def test_bench_backward_splits_whole(tmp_path):
    """The replay, the adjoints and the rest add up to the backward."""
    tr = trace_of(tmp_path, WINDOW + BENCH + PROGRAM + OUTSIDE)
    parts = sum(read(f"backward.{p}_ms", tr)
                for p in ("replay", "adjoint", "self"))
    assert parts == pytest.approx(270 / 2e3)


def test_bench_span_readers_leave_the_old_ones(tmp_path):
    """The program's spans change none of the readers of the benchmark's
    own spans."""
    bare = trace_of(tmp_path, WINDOW + BENCH)
    full = trace_of(tmp_path, WINDOW + BENCH + PROGRAM + OUTSIDE)
    assert read("itd_sift.aten_calls", bare) == \
        read("itd_sift.aten_calls", full) == 1.0
