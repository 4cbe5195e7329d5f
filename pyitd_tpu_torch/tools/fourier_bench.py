"""Time one ITD-Fourier cascade iteration on one GPU: the workload of the
ITD-Fourier bench (``bench.py:246-275``: n = 2^20, sr = 2048, f32).

    python -m pyitd_tpu_torch.tools.fourier_bench [--n 1048576] [--sr 2048]
        [--chain 20] [--tag NAME]

From the root of a checkout; it imports nothing but ``pyitd_tpu_torch``'s
``decomp/itd_fourier.cascade_iteration`` and ``tools/level_bench``'s
timers, so a copy of this file runs against another tree of the package
too (parent and change alternated in one call, each in its own process).

Prints one JSON line: the first call's host time (the comb's templates and
their device copies), ``chain`` chained iterations by CUDA events (each
iteration timed alone: median, min, max in ms), the device time per
iteration from the profiler, the ATen calls per iteration, and the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np


def signal(n: int, sr: int) -> np.ndarray:
    """The ITD-Fourier bench's signal (``bench.py:256-260``), float64."""
    rng = np.random.default_rng(4)
    t = np.arange(n) / sr
    return (np.sin(2 * np.pi * 50 * t) + 0.6 * np.sin(2 * np.pi * 220 * t)
            + 0.2 * rng.normal(size=n))


def main() -> int:
    import torch

    from pyitd_tpu_torch.decomp.itd_fourier import cascade_iteration
    from pyitd_tpu_torch.tools.level_bench import _smi, aten_ops, device_time

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--sr", type=int, default=2048)
    ap.add_argument("--chain", type=int, default=20)
    ap.add_argument("--tag", default="")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("fourier_bench: no CUDA device")
        return 1
    x = torch.from_numpy(signal(a.n, a.sr)).float().cuda()
    t0 = time.perf_counter()
    cascade_iteration(x, a.sr)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0

    times, cur = [], x
    for _ in range(a.chain):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cur = cascade_iteration(cur, a.sr)[0]
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    busy, missing = device_time([lambda: cascade_iteration(x, a.sr)])
    ops = aten_ops(lambda: cascade_iteration(x, a.sr))
    print(json.dumps({
        "tag": a.tag, "n": a.n, "sr": a.sr, "first_call_s": first,
        "ms_median": statistics.median(times), "ms_min": min(times),
        "ms_max": max(times), "device_busy_ms": busy,
        "missing_records": missing, "aten_calls": ops,
        "card": _smi("name,power.limit")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
