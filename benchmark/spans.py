"""Span arithmetic for the readers of the program's own spans.

The port records ``pyitd.*`` spans inside itself while a profiler runs
(``pyitd_tpu_torch/utils/spans.py``): ``pyitd.sift`` around the kernel
sift's loop, ``pyitd.trip`` around each trip, one span per call of each
kernel wrapper of ``ops/cuda_fill.py`` (:data:`WRAPPERS`), and in a
gradient ``pyitd.sift_bwd`` around the backward, ``pyitd.replay`` around
its replayed forward and ``pyitd.level_bwd`` around each level's adjoint,
on the autograd engine's thread.  The readers take them from a reduced
trace (``trace.py``), where only spans inside the window count, and give
every value per ``bench.call``.  A trace without the spans (a program that
records none) gives no reading.
"""
from __future__ import annotations

import bisect

WRAPPERS = tuple(f"pyitd.{w}" for w in (
    "level_summaries", "tile_scan", "sift_level", "fill2", "linear_fill2",
    "fillv", "segsum"))


def named(trace, names) -> list:
    """The window's spans whose name is ``names`` (a name or several), on
    every thread, in order of start."""
    names = (names,) if isinstance(names, str) else names
    return sorted((e for n in names for e in trace.spans(n)),
                  key=lambda e: e.ts)


def per_call_ms(trace, us: float):
    return us / 1e3 / trace.calls if trace.calls else None


def total_ms(trace, names):
    """The spans' summed duration per call, in ms; ``None`` without one."""
    spans = named(trace, names)
    return per_call_ms(trace, sum(e.dur for e in spans)) if spans else None


def count_per_call(trace, names):
    spans = named(trace, names)
    return len(spans) / trace.calls if spans and trace.calls else None


def self_ms(trace, parent: str, children):
    """Per call, the spans ``parent``'s self time in ms: each one's duration
    less the part of it that the spans ``children`` starting inside it on
    its thread cover (their union, so nested children count once).
    ``None`` without a span ``parent``."""
    parents = named(trace, parent)
    if not parents:
        return None
    by_tid: dict = {}
    for e in named(trace, children):
        by_tid.setdefault(e.tid, []).append(e)
    starts = {t: [e.ts for e in es] for t, es in by_tid.items()}
    total = 0.0
    for p in parents:
        kids = by_tid.get(p.tid, [])
        i = bisect.bisect_left(starts.get(p.tid, []), p.ts)
        covered, reach = 0.0, p.ts
        for k in kids[i:]:
            if k.ts >= p.end:
                break
            a, b = max(k.ts, reach), min(k.end, p.end)
            if b > a:
                covered += b - a
                reach = b
        total += p.dur - covered
    return per_call_ms(trace, total)
