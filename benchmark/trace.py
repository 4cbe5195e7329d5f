"""Reduction of a traced window to what the per-layer readers need.

A traced run records a ``torch.profiler`` trace (CPU and CUDA activities)
over a few warm calls and then the window, exports it as a Chrome trace
and hands it here.  The harness marks the window with the span
``bench.window``, each call with ``bench.call`` and each call into a layer
with the layer's span (``itd_sift``, ``loss``, ``backward``); only events
inside the window count.

The profiler can lose device records, most often the first launches after
it starts (the warm calls absorb those).  Every kernel launch on the host
carries a correlation id, as does the kernel's device record, so a launch
in the window without a device record is a missing record.  ``busy_us``
makes each one up at the median duration of the recorded kernels, and
``missing`` says how many there were.
"""
from __future__ import annotations

import bisect
import json
import statistics
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
WINDOW, CALL = "bench.window", "bench.call"


class Event(NamedTuple):
    name: str
    cat: str
    ts: float   # us
    dur: float  # us
    tid: object
    corr: object

    @property
    def end(self) -> float:
        return self.ts + self.dur


def _is_launch(name: str) -> bool:
    return "LaunchKernel" in name or "LaunchCooperativeKernel" in name


class Trace:
    """The events of one traced window."""

    def __init__(self, events: list[Event]):
        windows = [e for e in events
                   if e.cat == "user_annotation" and e.name == WINDOW]
        if len(windows) != 1:
            raise ValueError(f"the trace holds {len(windows)} windows")
        w = windows[0]
        self.start, self.end, self.main_tid = w.ts, w.end, w.tid

        def inside(e):
            return self.start <= e.ts and e.end <= self.end

        self.device = sorted((e for e in events
                              if e.cat in DEVICE_CATS and inside(e)),
                             key=lambda e: e.ts)
        self.kernels = [e for e in self.device if e.cat == "kernel"]
        self.launches = [e for e in events if e.cat in HOST_RUNTIME_CATS
                         and _is_launch(e.name) and inside(e)]
        self.host = sorted((e for e in events
                            if e.cat in ("cpu_op", "user_annotation")
                            and inside(e)),
                           key=lambda e: (e.ts, -e.dur))
        self.calls = sum(1 for e in self.host
                         if e.cat == "user_annotation" and e.name == CALL)
        recorded = {e.corr for e in self.kernels}
        self.missing = sum(1 for e in self.launches
                           if e.corr not in recorded)

    @classmethod
    def from_chrome(cls, path) -> "Trace":
        with open(path) as f:
            raw = json.load(f)
        evs = raw["traceEvents"] if isinstance(raw, dict) else raw
        out = []
        for e in evs:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            args = e.get("args") or {}
            out.append(Event(str(e.get("name", "")), str(e.get("cat", "")),
                             float(e["ts"]), float(e["dur"]), e.get("tid"),
                             args.get("correlation")))
        return cls(out)

    @property
    def window_us(self) -> float:
        return self.end - self.start

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the recorded device intervals, merged."""
        merged = []
        for e in self.device:
            if merged and e.ts <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e.end)
            else:
                merged.append([e.ts, e.end])
        return [(a, b) for a, b in merged]

    def busy_us(self) -> float:
        """Device busy time in the window, missing records made up."""
        busy = sum(b - a for a, b in self.busy_intervals())
        if self.missing and self.kernels:
            busy += self.missing * statistics.median(
                e.dur for e in self.kernels)
        return busy

    def spans(self, name: str) -> list[Event]:
        return [e for e in self.host
                if e.cat == "user_annotation" and e.name == name]

    def kernels_launched_in(self, name: str) -> list[Event]:
        """Device kernels whose launch on the host lies inside a span
        ``name`` (any thread: the autograd engine launches the backward's
        kernels from a thread of its own)."""
        spans = sorted((s.ts, s.end) for s in self.spans(name))
        starts = [a for a, _ in spans]

        def covered(t):
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t <= spans[i][1]

        corr = {e.corr for e in self.launches if covered(e.ts)}
        return [e for e in self.kernels if e.corr in corr]

    def top_level_ops(self, name: str) -> int:
        """ATen operators called directly inside the spans ``name`` on the
        harness's thread: ops nested in another op are not counted."""
        spans = self.spans(name)
        starts = [s.ts for s in spans]
        top_end: dict[int, float] = {}
        total = 0
        for e in self.host:
            if e.cat != "cpu_op" or not e.name.startswith("aten::"):
                continue
            i = bisect.bisect_right(starts, e.ts) - 1
            if i < 0 or e.tid != spans[i].tid or e.end > spans[i].end:
                continue
            if e.ts >= top_end.get(i, float("-inf")):
                total += 1
                top_end[i] = e.end
        return total

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the device's
        idle time by what the harness's thread was doing, in seconds."""
        ops: dict[str, float] = {}
        for e in self.device:
            key = kernel_label(e.name)
            ops[key] = ops.get(key, 0.0) + e.dur / 1e6
        gaps, last = [], self.start
        for a, b in self.busy_intervals():
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        if self.end > last:
            gaps.append((last, self.end))
        idle: dict[str, float] = {}
        for (a, b), label in zip(gaps, self._labels([a for a, _ in gaps])):
            idle[label] = idle.get(label, 0.0) + (b - a) / 1e6

        def ranked(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                    ][:top]

        return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}

    def _labels(self, times: list[float]) -> list[str]:
        """What the harness's thread was inside at each (ascending) time:
        the innermost span and the innermost operator."""
        host = [e for e in self.host if e.tid == self.main_tid]
        stack, out, i = [], [], 0
        for t in times:
            while i < len(host) and host[i].ts <= t:
                while stack and stack[-1].end <= host[i].ts:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1].end <= t:
                stack.pop()
            span = next((e.name for e in reversed(stack)
                         if e.cat == "user_annotation"), "outside calls")
            op = next((e.name for e in reversed(stack)
                       if e.cat == "cpu_op"), None)
            out.append(f"{span} > {op}" if op else f"{span} > python")
        return out


def kernel_label(name: str) -> str:
    """A kernel's name cut to what tells kernels apart (PyTorch's
    elementwise kernels differ only deep in their template arguments)."""
    for s in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(s, "")
    return name[:110]
