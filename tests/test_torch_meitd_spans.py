"""The profiler spans and counters of the MEITD ensemble, its walk and the
cubic level (``decomp/ensemble.py``, ``decomp/meitd_jit.py``,
``decomp/meitd.py``, ``ops/cuda_cubic.py``).

On the CPU, with the cubic level on the card's route (``"fills"``: the
kernels' plain versions run inside the wrappers' spans), one traced
ensemble holds ``pyitd.ensemble`` around the call, ``pyitd.walk`` and
``pyitd.ensemble_select`` (the epilogue) inside it, one
``pyitd.walk_trip`` per trip, ``pyitd.dig`` inside trips, one
``pyitd.cubic_level`` per level with the four wrapper spans and
``pyitd.interface_solve`` inside it, one ``pyitd.read`` per host read,
one ``pyitd.walk_stats`` (the gate statistics' wrapper) per read and one in
the epilogue, and no ``pyitd.wpe``; the counts are those of
``meitd.COUNTS``.  With no profiler running no span is entered.  On the
card (marked ``cuda``) each wrapper span's count, and
``pyitd.interface_solve``'s, is its ``cuda_cubic.LAUNCHES`` increment and
each holds its kernel's launch.
"""
import collections
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pyitd_tpu_torch import meitd_ensemble
from pyitd_tpu_torch.decomp import meitd as port_meitd
from pyitd_tpu_torch.ops import cuda_cubic

torch.set_num_threads(1)

WRAPPERS = ("cubic_ksite", "cubic_neighbors", "spike_factors",
            "spike_backsub_eval")
# each launching span's counter in cuda_cubic.LAUNCHES, and its kernel
LAUNCHED = dict({w: w for w in WRAPPERS}, interface_solve="spike_interface")
KERNEL = {s: f"{k}_kernel" for s, k in LAUNCHED.items()}
NEW = ("ensemble", "ensemble_select", "walk", "walk_trip", "dig",
       "cubic_level", "interface_solve", "read", "walk_stats") + WRAPPERS


def _signal(n, device="cpu"):
    rng = np.random.default_rng(19)
    t = np.linspace(0, 6 * np.pi, n)
    x = np.sin(20 * t * (1 + 0.1 * t)) + np.sin(13 * t) \
        + 0.25 * rng.normal(size=n)
    return torch.from_numpy(x).to(device)


def _ensemble(x):
    gen = torch.Generator(device=x.device).manual_seed(7)
    return meitd_ensemble(x, gen, 4, 0.1, 0.6)


class Span(collections.namedtuple("Span", "name start end thread")):
    def inside(self, other: "Span") -> bool:
        return (self.thread == other.thread and other.start <= self.start
                and self.end <= other.end)


@pytest.fixture(scope="module")
def recorded():
    """One traced ensemble on the fills route: its spans, the counters and
    the rows of every level."""
    rows = []
    orig_backend = port_meitd._CUBIC_BACKEND
    orig_extract = port_meitd.cubic_baseline_extract

    def counted(x, capacity, **kw):
        rows.append(x.shape[0])
        return orig_extract(x, capacity, **kw)

    port_meitd._CUBIC_BACKEND = "fills"
    port_meitd.cubic_baseline_extract = counted
    try:
        port_meitd.reset_counts()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = _ensemble(_signal(1024))
        counts = dict(port_meitd.COUNTS)
    finally:
        port_meitd._CUBIC_BACKEND = orig_backend
        port_meitd.cubic_baseline_extract = orig_extract
    got = [Span(e.name, e.time_range.start, e.time_range.end, e.thread)
           for e in prof.events() if e.is_user_annotation]
    return sorted(got, key=lambda s: (s.start, -s.end)), counts, rows, out


def _named(spans_, name):
    return [s for s in spans_ if s.name == f"pyitd.{name}"]


def test_meitd_counters(recorded):
    _, counts, rows, out = recorded
    assert counts["levels"] == len(rows) > counts["trips"] > 0
    assert counts["level_rows"] == sum(rows)
    assert counts["reads"] > counts["trips"]
    assert (out.num_components > 1).all()


@pytest.mark.parametrize("name,count", [
    ("ensemble", lambda c: 1), ("ensemble_select", lambda c: 1),
    ("walk", lambda c: 1), ("walk_trip", lambda c: c["trips"]),
    ("cubic_level", lambda c: c["levels"]),
    ("interface_solve", lambda c: c["levels"]),
    ("read", lambda c: c["reads"]),
    ("walk_stats", lambda c: c["reads"] + 1)] + [
    (w, lambda c: c["levels"]) for w in WRAPPERS])
def test_meitd_span_counts(recorded, name, count):
    spans_, counts, _, _ = recorded
    assert len(_named(spans_, name)) == count(counts)


@pytest.mark.parametrize("name,within", [
    ("walk", "ensemble"), ("ensemble_select", "ensemble"),
    ("walk_trip", "walk"), ("dig", "walk_trip"), ("cubic_level", "walk"),
    ("read", "walk"), ("walk_stats", "ensemble"),
    ("interface_solve", "cubic_level")] + [
    (w, "cubic_level") for w in WRAPPERS])
def test_meitd_spans_nest(recorded, name, within):
    spans_ = recorded[0]
    outer = _named(spans_, within)
    inner = _named(spans_, name)
    assert inner and all(any(s.inside(o) for o in outer) for s in inner)


def test_meitd_select_follows_the_walk(recorded):
    spans_ = recorded[0]
    (walk,), (select,) = _named(spans_, "walk"), _named(spans_, "ensemble_select")
    assert select.start >= walk.end


def test_meitd_wpe_spans(recorded):
    """The gate statistics of each of the walk's reads (the dig's included,
    which read extrema counts alone) come from one ``pyitd.walk_stats``
    just before the read, and one sorts the stacks; no entropy is left to
    ``pyitd.wpe``."""
    spans_ = recorded[0]
    (walk,), (select,) = _named(spans_, "walk"), _named(spans_, "ensemble_select")
    stats, reads = _named(spans_, "walk_stats"), _named(spans_, "read")
    assert not _named(spans_, "wpe")
    assert sum(s.inside(select) for s in stats) == 1
    in_walk = [s for s in stats if s.inside(walk)]
    assert len(in_walk) == len(reads) == len(stats) - 1
    for s, r in zip(in_walk, reads):
        assert s.end <= r.start and s.thread == r.thread
    assert all(later.start >= r.end for r, later in zip(reads, in_walk[1:]))


def test_meitd_span_names(recorded):
    assert {s.name for s in recorded[0]} >= {f"pyitd.{n}" for n in NEW}


def test_meitd_no_span_without_a_profiler(monkeypatch):
    def refuse(name, args=None):
        raise AssertionError(f"span {name!r} entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(port_meitd, "_CUBIC_BACKEND", "fills")
    out = _ensemble(_signal(512))
    assert (out.num_components > 1).all()


@pytest.mark.cuda
def test_meitd_cuda_wrapper_spans_hold_their_launches(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    x = _signal(32768, torch.device("cuda", 0))
    _ensemble(x)  # build the library
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _ensemble(x)
        torch.cuda.synchronize()
        before = dict(cuda_cubic.LAUNCHES)
        port_meitd.reset_counts()
        with record_function("test.window"):
            _ensemble(x)
            torch.cuda.synchronize()
        levels = port_meitd.COUNTS["levels"]
    delta = {k: v - before[k] for k, v in cuda_cubic.LAUNCHES.items()}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    raw = json.loads(path.read_text())
    evs = [e for e in (raw["traceEvents"] if isinstance(raw, dict) else raw)
           if e.get("ph") == "X" and "dur" in e]
    (win,) = [e for e in evs if e["name"] == "test.window"
              and e.get("cat") == "user_annotation"]

    def inside(e, span):
        return span["ts"] <= e["ts"] and e["ts"] + e["dur"] <= \
            span["ts"] + span["dur"]

    def corr(e):
        return (e.get("args") or {}).get("correlation")

    spans_ = [e for e in evs if e.get("cat") == "user_annotation"
              and e["name"][6:] in LAUNCHED and inside(e, win)]
    launches = [e for e in evs if e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver")
                and "LaunchKernel" in e["name"] and inside(e, win)]
    kernels = {corr(e): e for e in evs if e.get("cat") == "kernel"}
    assert {k: sum(s["name"] == f"pyitd.{w}" for s in spans_)
            for w, k in LAUNCHED.items()} == delta == {
                k: levels for k in LAUNCHED.values()}
    for s in spans_:
        own = [kernels[corr(la)] for la in launches
               if la["tid"] == s["tid"] and inside(la, s)
               and corr(la) in kernels
               and KERNEL[s["name"][6:]] in kernels[corr(la)]["name"]]
        assert len(own) == 1, (s["name"], s["ts"], len(own))
