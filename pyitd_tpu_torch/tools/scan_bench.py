"""Time the scan kernels (``fill2_cuda``, ``fillv_cuda``, ``segsum_cuda``)
alone on one GPU, at one block shape or several.

    python -m pyitd_tpu_torch.tools.scan_bench [--shapes 512 256:NAME ...]
        [--rows 8] [--n 1000000] [--reps 50]

For each shape ``threads[:define...]`` a child process builds ``csrc/*.cu``
with ``-DPYITD_SCAN_THREADS=<threads> -Xptxas -v`` and a ``-D`` for every
further name (a macro an experiment has put into the source), through the
``PYITD_NVCC_FLAGS`` environment variable of ``ops/_build.py``, prints what
ptxas says of every ``scan_lookback`` instance (registers, spills), holds
each kernel against its plain version, and prints its time per call: CUDA
events around ``reps`` back-to-back launches, and the device time of a
``torch.profiler`` trace.  Two inputs: the first baseline of the bench
signal with its own knots (dense: a knot every few samples), and the same
values with a mark every 65,536 samples in row 0 and none in the other rows
(sparse: the look-back walks to the row's start).  Each line carries the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

import numpy as np


def _child(shape: str, rows: int, n: int, reps: int) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..ops import _build
    from ..ops import cuda_fill as cf
    from ..ops.fill import shift_left
    from ..ops.linear_baseline import knot_mask

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    threads = int(shape.split(":")[0])
    cf.SCAN_THREADS, cf.SCAN_RUN = threads, cf.TILE // threads
    _, log = _build.build()
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and "scan_lookback" in name and (
                "registers" in line or "spill" in line):
            print(f"ptxas {name[:70]}: {line.strip()}")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, n)
    x = torch.from_numpy((np.sin(20 * t * (1 + 0.2 * t))[None] + np.sin(13 * t)
                          + 0.3 * rng.normal(size=(rows, n))
                          + 0.1 * t ** 2).astype(np.float32)).to(dev)
    base = cf.sift_level(x, cf.level_states(x)).baseline
    dense = knot_mask(base)
    sparse = torch.zeros_like(dense)
    sparse[0, ::65536] = True
    y = torch.randn(rows, n, device=dev)

    def timed(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        dms = sum(getattr(e, "self_device_time_total", 0.0)
                  for e in prof.key_averages()) / 5e3
        return start.elapsed_time(end) / reps, dms

    for what, mask in (("dense", dense), ("sparse", sparse)):
        flags = shift_left(mask, False)
        cases = {
            "fill2": (lambda: cf.fill2_cuda(base, mask),
                      lambda: cf.fill2(base, mask), 21),
            "fill2 reverse strict": (
                lambda: cf.fill2_cuda(base, mask, True, True),
                lambda: cf.fill2(base, mask, True, True), 21),
            "fillv": (lambda: (cf.fillv_cuda(base, mask),),
                      lambda: (cf.fillv(base, mask),), 9),
            "segsum 2ch reverse": (
                lambda: cf.segsum_cuda((base, y), flags, True),
                lambda: cf.segsum((base, y), flags, True), 17),
            "segsum 1ch reverse": (
                lambda: (cf.segsum_cuda(y, flags, True),),
                lambda: (cf.segsum(y, flags, True),), 9),
            "segsum 1ch strict": (
                lambda: (cf.segsum_cuda(y, mask, False, True),),
                lambda: (cf.segsum(y, mask, False, True),), 9),
        }
        for label, (kernel, plain, nbytes) in cases.items():
            got, want = kernel(), plain()
            if label.startswith("fill"):
                ok = all(torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
                         for a, b in zip(got, want))
            else:
                v = (base, y) if "2ch" in label else (y,)
                rev, strict = "reverse" in label, "strict" in label
                fl = mask if strict else flags
                ok = all(bool(((a.double() - b.double()).abs()
                               <= cf.segsum_error_bound(c, fl, rev, strict)
                               ).all())
                         for a, b, c in zip(got, want, v))
            ev, dms = timed(kernel)
            bound = rows * n * nbytes / 3.35e12 * 1e3
            print(f"shape {shape} {what} {label}: "
                  f"{'ok' if ok else 'WRONG'}; {ev:.4f} ms per call (CUDA "
                  f"events, {reps} launches), device {dms:.4f} ms "
                  f"(profiler); bound {bound:.4f} ms, x{dms / bound:.2f} "
                  f"at {rows}x{n}  [{card}]", flush=True)
            if not ok:
                return 1
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=["512"])
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        return _child(a.child, a.rows, a.n, a.reps)
    rc = 0
    for shape in a.shapes:
        threads, *defines = shape.split(":")
        env = dict(os.environ)
        env["PYITD_NVCC_FLAGS"] = " ".join(
            [f"-DPYITD_SCAN_THREADS={threads}", "-Xptxas", "-v"]
            + [f"-D{d}" for d in defines])
        rc |= subprocess.run(
            [sys.executable, "-m", "pyitd_tpu_torch.tools.scan_bench",
             "--child", shape, "--rows", str(a.rows), "--n", str(a.n),
             "--reps", str(a.reps)], env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
