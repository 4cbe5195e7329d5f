"""Time the cubic tier's K5 (``cubic_ksite_cuda``), K7
(``spike_factors_cuda``) and the interface solve (``spike_interface_cuda``)
alone on one GPU, at one kernel shape or several.

    python -m pyitd_tpu_torch.tools.cubic_bench [--shapes 2048,8,3 8192,8 ...]
        [--rows 8] [--n 1000000] [--reps 50] [--no-edge-cases]

A shape is ``SB,R[,spike_blocks[,ksite_blocks]]``: K7's cells per SPIKE
block and per thread's run, and the resident blocks per SM that K7 and K5
are compiled for (``__launch_bounds__``'s second argument, which caps their
registers).  For each shape a child process builds ``csrc/*.cu`` with those
and ``-Xptxas -v`` through the ``PYITD_NVCC_FLAGS`` environment variable of
``ops/_build.py``, prints what ptxas says of the two kernels, sets
``cuda_cubic.SPIKE_BLK`` / ``SPIKE_RUN`` to the shape so that the plain
versions follow it, holds K7 bitwise against its plain version on
:func:`spike_cases` and K5 and K7 on the cubic level's own inputs (the
edge shapes of ``level_bench`` and :func:`edge_cases`, then the bench
signal at ``rows x n``), and times each kernel alone there beside its
bound: ``hot`` (profiler device time over 5 calls on one set of inputs),
``rotating`` (4 copies taken in turn: no call finds its input in the L2)
and ``events`` (CUDA events around ``reps`` calls).  It also prints the
interface solve and end moments that the block size leaves, one launch of
``spike_interface_cuda`` held bitwise against its plain version, at
``rows x n`` and at :data:`INTERFACE_SHAPES` (the kernel's CUDA-event and
device time beside the plain version's time and ATen calls), and the whole
cubic level's event time and device busy time.  Each line carries the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import subprocess
import sys

import numpy as np

from .level_bench import (_smi, aten_ops, device_time, events, ptxas_lines,
                          same)

KERNELS = ("spike_factors_kernel", "cubic_ksite_kernel",
           "spike_interface_kernel")
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
# the interface solve's shapes besides the bench's: the MEITD ensemble's
# levels (16 SPIKE blocks a row) and 8 x 2^20 (512)
INTERFACE_SHAPES = ((32, 32768), (8, 1 << 20))


def bench_signal(rows: int, n: int) -> np.ndarray:
    """The bench's (rows, n) f32 signal: a chirp, a tone, noise and a
    trend."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, n)
    return (np.sin(20 * t * (1 + 0.2 * t))[None] + np.sin(13 * t)
            + 0.3 * rng.normal(size=(rows, n)) + 0.1 * t ** 2
            ).astype(np.float32)


def spike_issue_ops(rows: int, npad: int, sb: int, r: int) -> int:
    """K7's f32 operations at (rows, npad) as issued under -fmad=false,
    counted from csrc/spike.cu: per cell at most 24 (the forward sweep 9
    with the division as one, the run's first w 5, the back-substitution
    10); per run and round of the reduced solve 100, and 22 for its last
    2x2 solve."""
    nrun = sb // r
    rounds = (nrun - 1).bit_length()
    return rows * npad * 24 + rows * (npad // r) * (100 * rounds + 22)


def spike_cases(sb: int, r: int, dtype=np.float32):
    """(name, (mask, a, b, c, d)) chained systems that put knots on the
    first and last cells of runs of ``r`` and of SPIKE blocks of ``sb``
    cells, leave a block without a knot, and end rows between runs."""
    rng = np.random.default_rng(sb + r)

    def system(rows, n, density):
        mask = rng.random((rows, n)) < density
        hl, hr = rng.uniform(1.0, 50.0, (2, rows, n))
        d = rng.normal(size=(rows, n)) * 10.0
        return mask, hl, 2.0 * (hl + hr), hr, d

    def done(mask, a, b, c, d):
        mask[:, 0] = mask[:, -1] = False
        for row in range(mask.shape[0]):  # the not-a-knot ends
            idx = np.flatnonzero(mask[row])
            if idx.size:
                a[row, idx[0]] = 0.0
                c[row, idx[-1]] = 0.0
        return mask, *(v.astype(dtype) for v in (a, b, c, d))

    yield "random (2, 3 SB + 5)", done(*system(2, 3 * sb + 5, 0.6))
    yield "sparse (2, 2 SB)", done(*system(2, 2 * sb, 0.02))
    s = system(2, 3 * sb, 0.5)
    s[0][:, sb:2 * sb] = False
    yield "a block with no knot (2, 3 SB)", done(*s)
    s = system(2, 2 * sb + 3, 0.0)
    s[0][0, sb + 1] = s[0][1, 1] = True
    yield "one interior knot (2, 2 SB + 3)", done(*s)
    s = system(2, 2 * sb + r + 1, 0.0)
    s[0][:, ::r] = s[0][:, r - 1::r] = True
    yield "knots on every run's first and last cell (2, 2 SB + R + 1)", \
        done(*s)
    s = system(2, 3 * sb - 1, 0.3)
    s[0][:, sb - 1::sb] = s[0][:, sb::sb] = True
    s[0][1, sb - 2:sb + 2] = False
    yield "knots on block edges, a gap across one (2, 3 SB - 1)", done(*s)
    yield "no knot (1, SB + 1)", done(*system(1, sb + 1, 0.0))
    yield "shorter than a run (1, 5)", done(*system(1, 5, 1.0))


def edge_cases(sb: int, r: int):
    """(name, f32 signal) cubic levels with knots and NaN on run and SPIKE
    block edges, and a block without a knot."""
    rng = np.random.default_rng(5)

    def noisy(rows, n):
        t = np.linspace(0, 8 * np.pi, n)
        return (np.sin(t)[None] + 0.3 * rng.normal(size=(rows, n))
                ).astype(np.float32)

    x = noisy(2, 2 * sb + 77)
    for i, p in enumerate((r - 1, r, sb - r, sb - 1, sb, sb + r - 1,
                           2 * sb - 1, 2 * sb)):
        x[0, p] = 6.0 if i % 2 else -6.0
    x[1, [sb - 1, sb + r, 2 * sb]] = np.nan
    yield "knots and NaN on run and block edges (2, 2 SB + 77)", x
    x = noisy(2, 3 * sb)
    x[0, sb - 3:2 * sb + 3] = 10.0 + np.arange(sb + 6) * 1e-3
    yield "a SPIKE block with no knot (2, 3 SB)", x


def interface_rows(n: int, device="cpu"):
    """(rows, n) f32 signals for the interface solve and the end moments:
    a ramp (no interior knot), a tent (one), a zigzag (two), an
    alternating row (every interior sample a knot), a noisy chirp, and
    two slow periods that the guard passes through at ``min_extrema=10``.
    Made on ``device``, so the card makes its rows of 2^24 itself."""
    import torch

    it = torch.arange(n, device=device, dtype=torch.float64)
    p1, p2 = n // 3, (2 * n) // 3
    gen = torch.Generator(device=device).manual_seed(n)
    t = it / n
    return torch.stack([
        it,
        torch.where(it <= p1, it, 2 * p1 - it),
        torch.where(it <= p1, it, torch.where(it <= p2, 2 * p1 - it,
                                              it + 2 * (p1 - p2))),
        torch.where(it % 2 == 0, 1.0, -1.0),
        torch.sin(2 * torch.pi * 40 * t * (1 + t)) + 0.3 * torch.randn(
            n, generator=gen, device=device, dtype=torch.float64),
        torch.sin(4 * torch.pi * t + 0.3),
    ]).to(torch.float32).contiguous()


@contextlib.contextmanager
def recorded_interface(calls: list):
    """``spike_interface_cuda`` with each call's arguments appended to
    ``calls``."""
    from ..ops import cuda_cubic as cc

    real = cc.spike_interface_cuda

    def fn(*args):
        calls.append(args)
        return real(*args)

    cc.spike_interface_cuda = fn
    try:
        yield
    finally:
        cc.spike_interface_cuda = real


@contextlib.contextmanager
def checked_route(calls: dict):
    """K5 and K7 inside the cubic level, each held bitwise against its
    plain version on the same inputs (raises on a difference); the inputs
    of the last call of each in ``calls``."""
    from ..ops import cuda_cubic as cc

    real = {k: getattr(cc, k) for k in ("cubic_ksite_cuda",
                                        "spike_factors_cuda")}

    def wrap(k):
        def fn(*args):
            out = real[k](*args)
            if not same(out, cc.PLAIN[k](*args)):
                raise AssertionError(f"{k}: kernel differs from its plain "
                                     f"version")
            calls[k] = args
            return out
        return fn

    try:
        for k in real:
            setattr(cc, k, wrap(k))
        yield
    finally:
        for k, fn in real.items():
            setattr(cc, k, fn)


def level(x):
    from ..ops.cubic_baseline import cubic_baseline_extract

    return cubic_baseline_extract(x, x.shape[-1] + 2, min_extrema=0,
                                  eval_backend="fills")


def interface_timing(x, card: str, reps: int = 20,
                     tag: str = "") -> dict:
    """The interface solve and the end moments alone, on the arguments the
    cubic level of ``x`` (rows, n) f32 on the card hands them: the launch
    held bitwise against its plain version, then the kernel's CUDA-event
    time (median of ``reps`` single calls) and profiler device time beside
    the plain version's event time and ATen calls.  Prints one line,
    ``tag`` first, and returns the numbers."""
    from ..ops import cuda_cubic as cc

    calls = []
    with recorded_interface(calls):
        level(x)
    (factors, mask), = calls
    rows, n = mask.shape
    nblk = factors.shape[-1] // cc.SPIKE_BLK

    def kernel():
        return cc.spike_interface_cuda(factors, mask)

    def plain():
        return cc.PLAIN["spike_interface_cuda"](factors, mask)

    if not same(kernel(), plain()):
        raise AssertionError(f"spike_interface at {rows}x{n}: kernel differs "
                             f"from its plain version")
    k_ms = statistics.median(events(kernel, 1) for _ in range(reps))
    p_ms = statistics.median(events(plain, 1) for _ in range(reps))
    busy, lost = device_time([kernel])
    ops = aten_ops(plain)
    print(f"{tag}interface solve and end moments at {rows}x{n} ({nblk} SPIKE "
          f"blocks a row): kernel {k_ms:.4f} ms (CUDA events, median of "
          f"{reps} calls), device {busy:.4f} ms ({lost} of 5 records "
          f"missing), 1 launch; plain {p_ms:.4f} ms, {ops} ATen calls; "
          f"bitwise equal  [{card}]", flush=True)
    return {"rows": rows, "n": n, "nblk": nblk, "kernel_ms": k_ms,
            "device_ms": busy, "plain_ms": p_ms, "plain_aten_calls": ops}


def _child(shape: str, rows: int, n: int, reps: int, edge: bool) -> int:
    import torch

    from ..ops import _build
    from ..ops import cuda_cubic as cc
    from ..ops import cuda_fill as cf
    from .level_bench import edge_cases as level_edges

    card = _smi("name,power.limit")
    _, log = _build.build()
    for line in ptxas_lines(log, KERNELS):
        print(line)
    # the plain versions follow the blocks this build was made for, then
    # the checked load holds the library to them
    lib = _build.load_library()
    cc.SPIKE_BLK, cc.SPIKE_RUN = lib.pyitd_spike_block(), lib.pyitd_spike_run()
    cf._lib()
    sb, r = cc.SPIKE_BLK, cc.SPIKE_RUN
    dev = torch.device("cuda", 0)
    if edge:
        cases = list(spike_cases(sb, r))
        for what, sys_ in cases:
            m, *rest = (torch.from_numpy(v).to(dev) for v in sys_)
            if not same(cc.spike_factors_cuda(m, *rest),
                        cc.spike_factors(m, *rest)):
                raise AssertionError(f"K7 {what}: differs from its plain "
                                     f"version")
        sigs = list(level_edges()) + list(edge_cases(sb, r))
        for what, xn in sigs:
            with checked_route({}):
                level(torch.from_numpy(xn).to(dev))
        torch.cuda.synchronize()
        print(f"shape {shape}: K7 bitwise its plain version on "
              f"{len(cases)} systems, K5 and K7 in the cubic level on "
              f"{len(sigs)} edge signals", flush=True)

    x = torch.from_numpy(bench_signal(rows, n)).to(dev)
    calls = {}
    with checked_route(calls):
        level(x)
    torch.cuda.synchronize()
    nt = -(-n // cf.TILE)
    npad = cc.spike_pad(n)

    def report(label, make, nbytes, flops):
        hot, lost_h = device_time([make(0)])
        rot, lost_r = device_time([make(i) for i in range(4)])
        ev = events(make(0), reps)
        t_b, t_f = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
        bound, by = (t_b, "bytes") if t_b >= t_f else (t_f, "operations")
        print(f"shape {shape} {label}: hot {hot:.4f} ms, rotating {rot:.4f} "
              f"ms (profiler device time per recorded launch; {lost_h} of 5 "
              f"and {lost_r} of 20 records missing), events {ev:.4f} ms over "
              f"{reps} calls; bound {bound:.4f} ms by {by} ({nbytes / 1e6:.1f}"
              f" MB, {flops / 1e6:.1f} MFLOP), x{hot / bound:.2f} hot, "
              f"x{rot / bound:.2f} rotating, at {rows}x{n}  [{card}; SM "
              f"clock {_smi('clocks.sm')}]", flush=True)

    kx, kst, kbf, kbl = calls["cubic_ksite_cuda"]
    xs = [kx] + [kx.clone() for _ in range(3)]
    report("K5 cubic_ksite", lambda i: lambda: cc.cubic_ksite_cuda(
        xs[i], kst, kbf, kbl), 8 * rows * n + 32 * rows * nt + 8 * rows,
        11 * rows * n)
    sargs = calls["spike_factors_cuda"]
    copies = [sargs] + [tuple(a.clone() for a in sargs) for _ in range(3)]
    report(f"K7 spike_factors (SB {sb}, R {r})",
           lambda i: lambda: cc.spike_factors_cuda(*copies[i]),
           17 * rows * n + 24 * rows * npad,
           2 * spike_issue_ops(rows, npad, sb, r))

    # what the block size leaves to the interface solve
    interface_timing(x, card, tag=f"shape {shape}: ")
    for shape_i in INTERFACE_SHAPES:
        interface_timing(torch.from_numpy(bench_signal(*shape_i)).to(dev),
                         card, tag=f"shape {shape}: ")
    # and the whole cubic level at this shape
    times = sorted(events(lambda: level(x), 1) for _ in range(10))
    busy, lost = device_time([lambda: level(x)])
    print(f"shape {shape} cubic level: {statistics.median(times):.4f} ms "
          f"(CUDA events, median of 10, min {times[0]:.4f}, max "
          f"{times[-1]:.4f}), device busy {busy:.4f} ms ({lost} records "
          f"missing)  [{card}]", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=["2048,8,3"])
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--no-edge-cases", action="store_true")
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        return _child(a.child, a.rows, a.n, a.reps, not a.no_edge_cases)
    rc = 0
    for shape in a.shapes:
        vals = shape.split(",")
        flags = ["-Xptxas", "-v"] + [
            f"-DPYITD_{name}={v}" for name, v in zip(
                ("SPIKE_SB", "SPIKE_RUN", "SPIKE_BLOCKS", "KSITE_BLOCKS"),
                vals) if v]
        env = dict(os.environ)
        env["PYITD_NVCC_FLAGS"] = " ".join(flags)
        cmd = [sys.executable, "-m", "pyitd_tpu_torch.tools.cubic_bench",
               "--child", shape, "--rows", str(a.rows), "--n", str(a.n),
               "--reps", str(a.reps)]
        if a.no_edge_cases:
            cmd.append("--no-edge-cases")
        rc |= subprocess.run(cmd, env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
