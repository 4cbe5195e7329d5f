"""The reader of the level adjoint's kernel spans
(``backward.fused_launches_per_call``) on a hand-made trace: two calls on
the harness's thread, their backwards on a second thread, spans outside
the window that must not count, and a program without the spans."""
import json

import pytest

from benchmark import run
from benchmark.trace import Trace

NAME = "backward.fused_launches_per_call"
FUSED = ("pyitd.bwd_knots", "pyitd.bwd_pre", "pyitd.bwd_post")


def x(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def adjoint(ts, tid=2):
    """One level adjoint: its span, the three fused kernels' spans and the
    four scans' between them."""
    return [x("pyitd.level_bwd", ts, 70, tid),
            x("pyitd.bwd_knots", ts + 1, 5, tid),
            x("pyitd.fill2", ts + 7, 10, tid),
            x("pyitd.fill2", ts + 18, 10, tid),
            x("pyitd.bwd_pre", ts + 29, 8, tid),
            x("pyitd.segsum", ts + 38, 10, tid),
            x("pyitd.segsum", ts + 49, 10, tid),
            x("pyitd.bwd_post", ts + 60, 8, tid)]


WINDOW = [x("bench.window", 0, 4000)]
BENCH = [x("bench.call", 0, 1900), x("itd_sift", 10, 300),
         x("backward", 320, 1500),
         x("bench.call", 2000, 1900), x("itd_sift", 2010, 300),
         x("backward", 2320, 1500)]
# call 1: ten level adjoints; call 2: five (an early exit)
PROGRAM = [e for i in range(10) for e in adjoint(330 + 100 * i)] + \
    [e for i in range(5) for e in adjoint(2330 + 100 * i)]
OUTSIDE = adjoint(-500) + adjoint(4100)


def read(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return run.load_metric(NAME).read(Trace.from_chrome(path), {})


@pytest.mark.parametrize("outside", [False, True],
                         ids=["window_only", "with_spans_outside"])
def test_bench_fused_launches_reader(tmp_path, outside):
    events = WINDOW + BENCH + PROGRAM + (OUTSIDE if outside else [])
    assert read(tmp_path, events) == pytest.approx(3 * (10 + 5) / 2)


def test_bench_fused_launches_reads_thirty_for_ten_levels(tmp_path):
    events = WINDOW + BENCH[:3] + PROGRAM[:80]
    assert read(tmp_path, events) == pytest.approx(30.0)


def test_bench_fused_launches_find_nothing(tmp_path):
    """A program without the fused kernels (the parent of the change that
    added them: its adjoints hold scans alone) gives no reading, and
    nothing raises."""
    unfused = [e for e in PROGRAM if e["name"] not in FUSED]
    assert read(tmp_path, WINDOW + BENCH + unfused + OUTSIDE) is None


def test_bench_fused_launches_leave_the_wrappers_alone(tmp_path):
    """``wrappers.launches_per_call`` counts the seven old wrappers only:
    four scans per adjoint here."""
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": WINDOW + BENCH + PROGRAM}))
    tr = Trace.from_chrome(path)
    got = run.load_metric("wrappers.launches_per_call").read(tr, {})
    assert got == pytest.approx(4 * (10 + 5) / 2)


def test_bench_fused_launches_in_the_spec(spec):
    (m,) = [m for m in spec["per_layer"] if m["name"] == NAME]
    assert (m["layer"], m["moves"], m["workloads"]) == (
        "backward", "call_p95_ms", ["eeg_16k.grad"])
