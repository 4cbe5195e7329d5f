"""The port's profiler spans (``pyitd_tpu_torch/utils/spans.py``) on the CPU.

The kernel route's sift on a CPU tensor runs the wrappers' plain versions
inside the same spans as on the card, so a CPU profile holds the card's
span tree: ``pyitd.sift`` around the loop, ``pyitd.trip`` around each trip,
one ``pyitd.<wrapper>`` per wrapper call, and in the gradient
``pyitd.sift_bwd`` around the backward, ``pyitd.replay`` around its replay
of the levels' inputs and ``pyitd.level_bwd`` around each level's adjoint
in the reverse trip loop, which holds
the spans of its fused kernels (``pyitd.bwd_knots``, ``pyitd.bwd_pre``,
``pyitd.bwd_post``) beside those of its scans.  With no
profiler running nothing records and no ``record_function`` is entered.
"""
import collections
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pyitd_tpu_torch import itd_sift
from pyitd_tpu_torch.ops import cuda_fill as cf
from pyitd_tpu_torch.ops.linear_baseline import knot_mask
from pyitd_tpu_torch.utils import spans

MAX_IT = 8  # 10 trips, 11 extractions
WRAPPERS = ("level_summaries", "tile_scan", "sift_level", "fill2",
            "linear_fill2", "fillv", "segsum")
# the level adjoint's own kernels, counted apart from the seven above (the
# benchmark's wrappers.* metrics read those seven)
FUSED = ("bwd_knots", "bwd_pre", "bwd_post")
RESERVED = re.compile(r"^(itd_sift|loss|backward|bench\..*)$")


def _bank():
    rng = np.random.default_rng(17)
    t = np.linspace(0, 2 * np.pi, 5000)
    x = np.sin(9 * t)[None] + 0.4 * rng.normal(size=(3, t.size))
    return torch.from_numpy(x.astype(np.float32))


def _sift(x):
    return list(itd_sift(x, MAX_IT, backend="kernel", store_baselines=False))


def _grad(x):
    """The sift's outputs and the input gradient of the benchmark's loss."""
    xg = x.clone().requires_grad_()
    r = itd_sift(xg, MAX_IT, backend="kernel", store_baselines=False)
    loss = (r.rotations ** 2).sum() + 0.7 * r.correction.sum()
    (g,) = torch.autograd.grad(loss, xg)
    return [t.detach() for t in r] + [g]


class Span(collections.namedtuple("Span", "name start end thread")):
    def inside(self, other: "Span") -> bool:
        return (self.thread == other.thread and other.start <= self.start
                and self.end <= other.end)


def _recorded(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(_bank())
    got = [Span(e.name, e.time_range.start, e.time_range.end, e.thread)
           for e in prof.events() if e.is_user_annotation]
    return out, sorted(got, key=lambda s: (s.start, -s.end))


@pytest.fixture(scope="module")
def sift_spans():
    return _recorded(_sift)[1]


@pytest.fixture(scope="module")
def grad_spans():
    return _recorded(_grad)[1]


def _named(spans_, name):
    return [s for s in spans_ if s.name == name]


def _wrapper_spans(spans_, names=WRAPPERS):
    return [s for s in spans_ if s.name[len("pyitd."):] in names]


@pytest.mark.parametrize("name,count", [
    ("pyitd.sift", 1), ("pyitd.trip", MAX_IT + 2),
    ("pyitd.level_summaries", 1), ("pyitd.tile_scan", MAX_IT + 3),
    ("pyitd.sift_level", MAX_IT + 3), ("wrappers", 2 * MAX_IT + 7)])
def test_sift_span_counts(sift_spans, name, count):
    got = _wrapper_spans(sift_spans) if name == "wrappers" \
        else _named(sift_spans, name)
    assert len(got) == count


@pytest.mark.parametrize("name", ["pyitd.trip", "pyitd.level_summaries",
                                  "pyitd.tile_scan", "pyitd.sift_level"])
def test_sift_spans_nest_in_the_sift(sift_spans, name):
    (sift,) = _named(sift_spans, "pyitd.sift")
    assert all(s.inside(sift) for s in _named(sift_spans, name))


@pytest.mark.parametrize("name,outside", [
    ("pyitd.level_summaries", 1), ("pyitd.tile_scan", 1),
    ("pyitd.sift_level", 1)])
def test_sift_trips_hold_all_but_the_first_extraction(sift_spans, name,
                                                      outside):
    """The first extraction (summaries, scan, level) runs before the first
    trip; every later wrapper call lies inside one trip."""
    trips = _named(sift_spans, "pyitd.trip")
    first_trip = trips[0].start
    loose = [s for s in _named(sift_spans, name)
             if not any(s.inside(t) for t in trips)]
    assert len(loose) == outside
    assert all(s.end <= first_trip for s in loose)


# per backward: the replay's 9 extractions of the baselines that are level
# inputs (the first with the pre-pass, each later one a scan and a level),
# then 10 level adjoints of 2 fill2, 2 segsum and one of each fused kernel
GRAD_COUNTS = {"pyitd.sift_bwd": 1, "pyitd.replay": 1,
               "pyitd.level_bwd": MAX_IT + 2,
               "pyitd.level_summaries": 2,
               "pyitd.tile_scan": (MAX_IT + 3) + (MAX_IT + 1),
               "pyitd.sift_level": (MAX_IT + 3) + (MAX_IT + 1),
               "pyitd.fill2": 2 * (MAX_IT + 2),
               "pyitd.segsum": 2 * (MAX_IT + 2),
               "pyitd.linear_fill2": 0, "pyitd.fillv": 0,
               "pyitd.bwd_knots": MAX_IT + 2, "pyitd.bwd_pre": MAX_IT + 2,
               "pyitd.bwd_post": MAX_IT + 2,
               "wrappers": 82, "fused": 3 * (MAX_IT + 2)}


def _counted(spans_, name):
    if name == "wrappers":
        return _wrapper_spans(spans_)
    if name == "fused":
        return _wrapper_spans(spans_, FUSED)
    return _named(spans_, name)


@pytest.mark.parametrize("name", list(GRAD_COUNTS))
def test_grad_span_counts(grad_spans, name):
    assert len(_counted(grad_spans, name)) == GRAD_COUNTS[name]


@pytest.mark.parametrize("name,within,count", [
    ("pyitd.replay", "pyitd.sift_bwd", 1),
    ("pyitd.level_bwd", "pyitd.sift_bwd", MAX_IT + 2),
    ("wrappers", "pyitd.replay", 1 + 2 * (MAX_IT + 1)),
    ("wrappers", "pyitd.level_bwd", 4 * (MAX_IT + 2)),
    ("fused", "pyitd.level_bwd", 3 * (MAX_IT + 2)),
    ("wrappers", "pyitd.sift", 2 * MAX_IT + 7)])
def test_grad_spans_nest(grad_spans, name, within, count):
    """The replay and the adjoints lie inside the backward (the adjoints
    after the replay, which they differentiate); the wrapper calls split
    into the forward's, the replay's and the adjoints'; the fused kernels
    run inside the adjoints alone."""
    outer = _named(grad_spans, within)
    inner = _counted(grad_spans, name)
    assert sum(any(s.inside(o) for o in outer) for s in inner) == count
    if name == "pyitd.level_bwd":
        (replay,) = _named(grad_spans, "pyitd.replay")
        assert all(s.start >= replay.end for s in inner)


def _wrapper_call(name, x):
    mask = knot_mask(x)
    fwd, bwd = cf.fill2(x, mask), cf.fill2(x, mask, True, True)
    return {
        "level_summaries": lambda: cf.level_summaries_cuda(x),
        "tile_scan": lambda: cf.tile_scan_cuda(cf.level_summaries(x)),
        "sift_level": lambda: cf.sift_level_cuda(x, cf.level_states(x)),
        "fill2": lambda: cf.fill2_cuda(x, mask),
        "linear_fill2": lambda: cf.linear_fill2_cuda(x, reverse=True),
        "fillv": lambda: cf.fillv_cuda(x, mask),
        "segsum": lambda: cf.segsum_cuda((x, x), mask, strict=True),
        "bwd_knots": lambda: cf.bwd_knots_cuda(x),
        "bwd_pre": lambda: cf.bwd_pre_cuda(x, x, x, x, fwd, bwd),
        "bwd_post": lambda: cf.bwd_post_cuda(mask, x, (x, x), (x, x),
                                             fwd[2], bwd[0]),
    }[name]


@pytest.mark.parametrize("name", WRAPPERS + FUSED)
def test_each_wrapper_call_is_one_span(name):
    call = _wrapper_call(name, _bank())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    got = [e.name for e in prof.events() if e.is_user_annotation]
    assert got == [f"pyitd.{name}"]


def test_span_is_the_shared_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert spans.span("pyitd.sift") is spans.span("pyitd.trip")
    with profile(activities=[ProfilerActivity.CPU]):
        on = spans.span("pyitd.sift")
    assert isinstance(on, torch.profiler.record_function)


@pytest.mark.parametrize("fn", [_sift, _grad], ids=["sift", "grad"])
def test_no_span_is_entered_without_a_profiler(monkeypatch, fn):
    def refuse(name, args=None):
        raise AssertionError(f"span {name!r} entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    fn(_bank())


@pytest.mark.parametrize("fn", [_sift, _grad], ids=["sift", "grad"])
def test_outputs_bitwise_the_same_with_spans_recording(fn):
    want = fn(_bank())
    got = _recorded(fn)[0]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_recorded_span_names(sift_spans, grad_spans):
    names = {s.name for s in sift_spans + grad_spans}
    assert names == {"pyitd.sift", "pyitd.trip", "pyitd.sift_bwd",
                     "pyitd.replay", "pyitd.level_bwd"} | {
        f"pyitd.{w}" for w in WRAPPERS + FUSED
        if w not in ("linear_fill2", "fillv")}


PKG = Path(__file__).resolve().parents[1] / "pyitd_tpu_torch"


def test_every_span_of_the_port_is_pyitd_prefixed():
    """Every literal name given to ``span`` or ``spanned`` in the package:
    prefixed ``pyitd.``, and none of the benchmark's own spans (its readers
    count those by name)."""
    found = []
    for path in sorted(PKG.rglob("*.py")):
        found += re.findall(r"\bspan(?:ned)?\(\s*\"([^\"]*)\"",
                            path.read_text())
    assert len(found) >= 12, found
    for name in found:
        assert name.startswith("pyitd.") and not RESERVED.match(name), name
