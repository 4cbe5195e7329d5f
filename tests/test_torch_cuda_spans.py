"""The port's profiler spans on an NVIDIA GPU, in one traced sift call and
one traced gradient call of a 256 x 16,384 f32 bank (the benchmark's
``eeg_16k`` shape).  Marked ``cuda``: skips where
``torch.cuda.is_available()`` is false.  Run on the card with
``python -m pytest --noconftest tests/test_torch_cuda_spans.py -q``.

* each wrapper's span count equals its ``cuda_fill.LAUNCHES`` increment;
* each wrapper span holds the host launch of its own kernel, whose device
  record starts after the span starts: the spans and the device trace
  share one clock, to within the profiler's alignment of the device's
  clock to the host's (``ALIGN_US``);
* the level adjoints' spans are on the autograd engine's thread, inside the
  backward's span there, not on the caller's thread.
"""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pyitd_tpu_torch import itd_sift
from pyitd_tpu_torch.ops import cuda_fill

pytestmark = pytest.mark.cuda

SHAPE, MAX_IT = (256, 16384), 8
# the kernel each wrapper launches (csrc/sift_level.cu, csrc/fill_segsum.cu,
# csrc/level_bwd.cu)
KERNEL = {"level_summaries": "level_summaries_kernel",
          "tile_scan": "tile_scan_kernel",
          "sift_level": "sift_level_kernel", "fill2": "scan_lookback",
          "linear_fill2": "scan_lookback", "fillv": "scan_lookback",
          "segsum": "scan_lookback", "bwd_knots": "bwd_knots_kernel",
          "bwd_pre": "bwd_pre_kernel", "bwd_post": "bwd_post_kernel"}
# the gradient's replay: the 9 baselines that are level inputs, with the
# forward's launches; per level adjoint: one bwd_knots, two fill2, one
# bwd_pre, two segsum, one bwd_post
LAUNCHES = {"sift": {"level_summaries": 1, "tile_scan": 11,
                     "sift_level": 11},
            "grad": {"level_summaries": 2, "tile_scan": 20,
                     "sift_level": 20, "fill2": 20, "segsum": 20,
                     "bwd_knots": 10, "bwd_pre": 10, "bwd_post": 10}}
WINDOW = "test.window"
# the profiler aligns the device's clock to the host's once per session: in
# some sessions nearly every device record then leads its own launch, by up
# to 0.26 ms on an H100; in the others none does (launch to start 3 to 8 us)
ALIGN_US = 500.0


def _bank(device):
    gen = torch.Generator(device=device)
    gen.manual_seed(20261018)
    t = torch.linspace(0, 60.0, SHAPE[1], device=device)
    return (torch.sin(t)[None] + 0.4 * torch.randn(
        SHAPE, generator=gen, device=device)).contiguous()


def _sift(x):
    itd_sift(x, MAX_IT, store_baselines=False)


def _grad(x):
    xg = x.clone().requires_grad_()
    r = itd_sift(xg, MAX_IT, store_baselines=False)
    loss = (r.rotations ** 2).sum() + 0.7 * r.correction.sum()
    torch.autograd.grad(loss, xg)


def _traced(fn, x, tmp_path):
    """One call of ``fn`` inside a traced window, after a traced warm call
    (the profiler may lose its first records); the launch counts of the
    window's call, and its events by kind."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(x)
        torch.cuda.synchronize()
        before = dict(cuda_fill.LAUNCHES)
        with record_function(WINDOW):
            fn(x)
            torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in cuda_fill.LAUNCHES.items()}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    raw = json.loads(path.read_text())
    evs = [e for e in (raw["traceEvents"] if isinstance(raw, dict) else raw)
           if e.get("ph") == "X" and "dur" in e]
    (win,) = [e for e in evs if e["name"] == WINDOW
              and e.get("cat") == "user_annotation"]

    def inside(e, span):
        return span["ts"] <= e["ts"] and e["ts"] + e["dur"] <= \
            span["ts"] + span["dur"]

    def corr(e):
        return (e.get("args") or {}).get("correlation")

    ev = {"window": win,
          "spans": [e for e in evs if e.get("cat") == "user_annotation"
                    and e["name"].startswith("pyitd.") and inside(e, win)],
          "launches": [e for e in evs
                       if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and "LaunchKernel" in e["name"] and inside(e, win)],
          "kernels": {corr(e): e for e in evs if e.get("cat") == "kernel"}}
    ev["inside"], ev["corr"] = inside, corr
    return delta, ev


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    x = _bank(torch.device("cuda", 0))
    _grad(x)  # build the library and warm both paths
    torch.cuda.synchronize()
    return {name: _traced(fn, x, tmp_path_factory.mktemp(name))
            for name, fn in (("sift", _sift), ("grad", _grad))}


@pytest.mark.parametrize("call", ["sift", "grad"])
def test_cuda_span_counts_equal_launches(traced, call):
    delta, ev = traced[call]
    spans = {w: sum(s["name"] == f"pyitd.{w}" for s in ev["spans"])
             for w in KERNEL}
    assert spans == delta
    assert {w: n for w, n in delta.items() if n} == LAUNCHES[call]


@pytest.mark.parametrize("call", ["sift", "grad"])
def test_cuda_launches_lie_inside_their_spans(traced, call):
    """Each wrapper span holds one launch of its kernel on its thread, and
    the kernel's device record starts after the span starts (to within
    ``ALIGN_US``)."""
    _, ev = traced[call]
    wrappers = [s for s in ev["spans"] if s["name"][6:] in KERNEL]
    assert wrappers
    for s in wrappers:
        own = []
        for la in ev["launches"]:
            k = ev["kernels"].get(ev["corr"](la))
            if la["tid"] == s["tid"] and ev["inside"](la, s) and k \
                    and KERNEL[s["name"][6:]] in k["name"]:
                own.append(k)
        assert len(own) == 1, (s["name"], s["ts"], len(own))
        assert own[0]["ts"] >= s["ts"] - ALIGN_US, \
            (s["name"], own[0]["ts"] - s["ts"])


def test_cuda_adjoints_on_the_engine_thread(traced):
    _, ev = traced["grad"]
    caller = ev["window"]["tid"]
    (bwd,) = [s for s in ev["spans"] if s["name"] == "pyitd.sift_bwd"]
    adjoints = [s for s in ev["spans"] if s["name"] == "pyitd.level_bwd"]
    assert len(adjoints) == MAX_IT + 2
    assert bwd["tid"] != caller
    assert all(s["tid"] == bwd["tid"] and ev["inside"](s, bwd)
               for s in adjoints)
    (sift,) = [s for s in ev["spans"] if s["name"] == "pyitd.sift"]
    assert sift["tid"] == caller
