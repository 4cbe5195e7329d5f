"""Time the sift's level kernels (``level_summaries_cuda``,
``tile_scan_cuda``, ``sift_level_cuda``) alone on one GPU, at one block
shape or several.

    python -m pyitd_tpu_torch.tools.level_bench [--shapes 3,2 2,2,4:NAME ...]
        [--rows 8] [--n 1000000] [--levels 10] [--reps 50] [--no-edge-cases]

A shape is ``level_blocks[,book_blocks[,summary_blocks]][:define...]``: the
resident blocks per SM that ``sift_level`` without and with the sift's
bookkeeping and ``level_summaries`` are compiled for
(``__launch_bounds__``'s second argument, which caps their registers), and a
``-D`` for every further name (a macro an experiment has put into the
source).  For each shape a child process builds ``csrc/*.cu`` with those and
``-Xptxas -v`` through the ``PYITD_NVCC_FLAGS`` environment variable of
``ops/_build.py``, prints what ptxas says of every instance of the three
kernels (registers, spills, shared memory), holds every instantiation
against its plain version (on small edge shapes, then at ``rows x n``) and
prints its device time per call beside its bound.  Two inputs: the first
baseline of the bench signal (level 1: two samples in three are knots) and
the input of the sift's last level (knots are sparse).

Three ways to time a call, because a kernel that reads 32 MB finds more or
less of it in the card's 50 MB L2 depending on what ran before it:
``hot``: the profiler's device time over 5 calls on one set of buffers;
``rotating``: the same over 4 copies of the input taken in turn (128 MB: no
call finds its input in the cache); ``events``: CUDA events around ``reps``
back-to-back calls on one set of buffers.  Each line carries the card's name
and power limit; the SM clock is sampled before and after.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

import numpy as np

KERNELS = ("level_summaries_kernel", "tile_scan_kernel", "sift_level_kernel")
HBM_BPS = 3.35e12


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def edge_cases():
    """(name, f32 array): the shapes that try the tile edges of the
    interior summary and its completion."""
    from ..ops.cuda_fill import TILE

    rng = np.random.default_rng(11)

    def noisy(rows, n):
        t = np.linspace(0, 2 * np.pi, n)
        return (np.sin(9 * t)[None] + 0.3 * rng.normal(size=(rows, n))
                ).astype(np.float32)

    yield "n < TILE (2, 130)", noisy(2, 130)
    yield "n = TILE + 1 (2, 4097)", noisy(2, TILE + 1)
    yield "n = 2 TILE (3, 8192)", noisy(3, 2 * TILE)
    yield "n = 2 TILE + 2 (2, 8194)", noisy(2, 2 * TILE + 2)
    yield "rows off a 16-byte boundary (3, 9001)", noisy(3, 9001)
    yield "two samples (2, 2)", noisy(2, 2)
    yield "constant (2, 8192)", np.ones((2, 2 * TILE), np.float32)
    t = np.linspace(0, 1, 3 * TILE)
    yield "monotone (2, 12288)", np.stack([t, t ** 2]).astype(np.float32)
    x = noisy(2, 3 * TILE)
    x[0, TILE - 2:TILE + 2] = 4.0
    x[1, 2 * TILE - 1:2 * TILE + 1] = -4.0
    x[1, TILE - 3:TILE] = 3.0
    yield "plateaus across tile edges (2, 12288)", x
    x = noisy(3, 3 * TILE)
    x[0, TILE], x[1, TILE - 1], x[2, TILE + 1] = np.nan, np.nan, np.nan
    x[0, 2 * TILE - 2], x[1, 2 * TILE - 1:2 * TILE + 1] = np.nan, np.nan
    yield "NaN at and beside tile edges (3, 12288)", x
    x = noisy(2, 3 * TILE)
    for b in (TILE, 2 * TILE):
        x[0, b], x[0, b - 1], x[1, b - 1], x[1, b] = 5.0, -5.0, 5.0, -5.0
    yield "knots on tile edges (2, 12288)", x


def same(a, b) -> bool:
    """Two tensors, or two (nested) tuples of tensors and Nones, bit for
    bit (NaN equals NaN)."""
    import torch

    if a is None or b is None:
        return a is b
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same(p, q) for p, q in zip(a, b))
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))
         if a.is_floating_point() else a == b).all())


def check_level(x, what: str) -> None:
    """Every mode of the three kernels on ``x`` against its plain version,
    and the emitted summaries, completed, against ``level_summaries``."""
    import torch
    from ..ops import cuda_fill as cf

    def fail(msg):
        raise AssertionError(f"{what}: {msg}")

    summ = cf.level_summaries_cuda(x)
    if not same(tuple(summ), tuple(cf.level_summaries(x))):
        fail("level_summaries differs from its plain version")
    states = cf.tile_scan_cuda(summ)
    if not same(tuple(states), tuple(cf.tile_scan(summ))):
        fail("tile_scan differs from its plain version")
    for mode in ("reference", "natural"):
        got = cf.sift_level_cuda(x, states, endpoint_mode=mode, emit=True)
        want = cf.sift_level(x, states, endpoint_mode=mode, emit=True)
        if not same(tuple(got), tuple(want)):
            fail(f"sift_level emit {mode} differs from its plain version")
        if not same(tuple(cf.sift_level_cuda(x, states, endpoint_mode=mode)[:3]),
                    tuple(want[:3])):
            fail(f"sift_level {mode} differs from its plain version")
        base = got.baseline
        whole = cf.level_summaries_cuda(base)
        if not same(tuple(cf.complete_summaries(got.interior, base)),
                    tuple(whole)):
            fail(f"{mode}: completed interior summaries differ from "
                 f"level_summaries")
        carry_k, carry_p, carry_w = (cf.SiftCarry.zeros(x.shape[0], x.device)
                                     for _ in range(3))
        sk = cf.tile_scan_cuda(got.interior, carry_k, 1, 4, edges_from=base)
        sp = cf.tile_scan(want.interior, carry_p, 1, 4, edges_from=base)
        sw = cf.tile_scan_cuda(whole, carry_w, 1, 4)
        if not (same(tuple(sk), tuple(sp)) and same(tuple(sk), tuple(sw))
                and same(tuple(carry_k), tuple(carry_p))):
            fail(f"{mode}: tile_scan with edge completion differs")
        # the bookkeeping, emitting and not
        rows_k, rows_p = torch.empty_like(x), torch.empty_like(x)
        args = dict(rotp=got.rotation, pbase=x, perr=got.sub_err, comp=x * 0,
                    endpoint_mode=mode)
        for emit in (True, False):
            bk = cf.sift_level_cuda(base, sk, out_row=rows_k, emit=emit,
                                    **args)
            bp = cf.sift_level(base, sk, out_row=rows_p, emit=emit, **args)
            if not (same(tuple(bk), tuple(bp)) and same(rows_k, rows_p)):
                fail(f"sift_level with bookkeeping, emit={emit}, {mode} "
                     f"differs from its plain version")
    torch.cuda.synchronize()


def host_parts(x) -> None:
    """Host microseconds per call of what a wrapper does around its launch
    (host clock over 2000 calls, the device kept idle)."""
    import time

    import torch
    from ..ops import cuda_fill as cf

    rows, n = x.shape
    nt = -(-n // cf.TILE)
    summ = cf.level_summaries_cuda(x)

    def us(fn, reps=2000):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / reps * 1e6

    def ctx():
        with torch.cuda.device(x.device):
            pass

    lib = cf._lib()
    pos = torch.empty((2, rows, nt, 2), dtype=torch.int32, device=x.device)
    val = torch.empty((2, rows, nt, 2), dtype=torch.float32, device=x.device)
    small = torch.empty((2, rows), dtype=torch.int32, device=x.device)
    scan_args = (rows, nt, *(t.data_ptr() for t in summ), None, 0, 0, None,
                 None, None, pos[0].data_ptr(), val[0].data_ptr(),
                 pos[1].data_ptr(), val[1].data_ptr(), small[0].data_ptr(),
                 small[1].data_ptr(),
                 None, None, None, 0, 0, None, None, None, None,
                 cf._stream(x.device))
    parts = {
        "a ctypes call that launches nothing": lib.pyitd_tile_size,
        "the bare tile_scan launch, arguments ready":
            lambda: lib.pyitd_tile_scan(*scan_args),
        "a PyTorch op (x[0, :8] + 1)": lambda: x[0, :8] + 1,
        "torch.empty of a (2, rows, tiles, 2) tensor": lambda: torch.empty(
            (2, rows, nt, 2), dtype=torch.int32, device=x.device),
        "a view t[0]": lambda: summ.fpos[0],
        "torch.cuda.device context": ctx,
        "current stream": lambda: cf._stream(x.device),
        "library handle": cf._lib,
        "checks of tile_scan": lambda: cf._same(
            summ.fval, summ.fpos, summ.rpos, summ.cnt, dtype=torch.int32),
        "tile_scan_cuda, whole": lambda: cf.tile_scan_cuda(summ),
        "level_summaries_cuda, whole": lambda: cf.level_summaries_cuda(
            x[:, :cf.TILE].contiguous()),
    }
    print("host us per call: " + "; ".join(
        f"{k} {us(fn):.1f}" for k, fn in parts.items()), flush=True)

    states = cf.tile_scan_cuda(summ, cf.SiftCarry.zeros(rows, x.device), 1, 8)
    lvl = cf.sift_level_cuda(x, states, emit=True)
    kw = dict(rotp=lvl.rotation, pbase=x, perr=lvl.sub_err, comp=x * 0,
              out_row=torch.empty_like(x), emit=True)

    def trip():
        st = cf.tile_scan_cuda(lvl.interior, None, 1, 8,
                               edges_from=lvl.baseline)
        cf.sift_level_cuda(lvl.baseline, st, **kw)

    print(f"host us per trip (tile_scan with edge completion + emitting "
          f"sift_level with bookkeeping): {us(trip, 500):.1f}", flush=True)


def device_time(fns) -> tuple[float, int]:
    """Profiler device time per call, the calls of ``fns`` in turn, and the
    kernel records missing from the window (the tracer can miss the
    launches made while it starts): each kernel's mean recorded duration
    times its launches per call, rounded up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    calls, seen, timed = 5 * len(fns), {}, {}
    for e in prof.events():  # a record cut off by the tracer has no time
        seen[e.name] = seen.get(e.name, 0) + 1
        if getattr(e, "self_device_time_total", 0.0):
            timed.setdefault(e.name, []).append(e.self_device_time_total)
    ms = missing = 0
    for name, durations in timed.items():
        per_call = -(-seen[name] // calls)
        ms += sum(durations) / len(durations) * per_call / 1e3
        missing += per_call * calls - len(durations)
    return ms, missing


def events(fn, reps: int) -> float:
    """ms per call by CUDA events around ``reps`` back-to-back calls."""
    import torch

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
    return start.elapsed_time(end) / reps


def aten_ops(fn) -> int:
    """The number of ATen operator calls ``fn`` makes (views included):
    the host's share of a chain of small PyTorch ops."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        calls = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.calls += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.calls


def ptxas_lines(log: str, kernels) -> list[str]:
    """What ptxas -v says (registers, spills, shared memory) of every
    instance of the kernels whose names contain one of ``kernels``."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and any(k in name for k in kernels) and (
                "registers" in line or "spill" in line):
            short = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?\d+(?=[a-z])", "", name)
            out.append(f"ptxas {short[:60]}: {line.strip()}")
    return out


def _child(shape: str, rows: int, n: int, levels: int, reps: int,
           edge: bool) -> int:
    import torch

    from ..ops import _build
    from ..ops import cuda_fill as cf

    card = _smi("name,power.limit")
    _, log = _build.build()
    for line in ptxas_lines(log, KERNELS):
        print(line)
    dev = torch.device("cuda", 0)
    if edge:
        for what, xn in edge_cases():
            check_level(torch.from_numpy(xn).to(dev), what)
        print(f"shape {shape}: every mode bitwise its plain version on "
              f"{len(list(edge_cases()))} edge shapes", flush=True)
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, n)
    x = torch.from_numpy((np.sin(20 * t * (1 + 0.2 * t))[None] + np.sin(13 * t)
                          + 0.3 * rng.normal(size=(rows, n))
                          + 0.1 * t ** 2).astype(np.float32)).to(dev)
    nt = -(-n // cf.TILE)

    def report(label, make, nbytes):
        """``make(i)``: the call on copy ``i`` of its inputs (0..3)."""
        hot, lost_h = device_time([make(0)])
        rot, lost_r = device_time([make(i) for i in range(4)])
        ev = events(make(0), reps)
        bound = nbytes / HBM_BPS * 1e3
        print(f"shape {shape} {label}: hot {hot:.4f} ms, rotating {rot:.4f} "
              f"ms (profiler device time per recorded launch; {lost_h} of 5 "
              f"and {lost_r} of 20 records missing), events {ev:.4f} ms over "
              f"{reps} "
              f"calls; bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB), "
              f"x{hot / bound:.2f} hot, x{rot / bound:.2f} rotating, at "
              f"{rows}x{n}  [{card}; SM clock {_smi('clocks.sm')}]",
              flush=True)

    host_parts(x)
    deep = x
    for _ in range(levels - 1):
        deep = cf.sift_level_cuda(deep, cf.level_states_cuda(deep)).baseline
    first = cf.sift_level_cuda(x, cf.level_states_cuda(x)).baseline
    for what, sig in (("level 1", first), ("last level", deep)):
        check_level(sig, f"{what} {rows}x{n}")
        knots = int(cf.level_summaries_cuda(sig).cnt.sum()) // rows
        print(f"shape {shape} {what}: about {knots} knots per row of {n}; "
              f"every mode bitwise its plain version", flush=True)
        sigs = [sig] + [sig.clone() for _ in range(3)]
        summ = cf.level_summaries_cuda(sig)
        states = cf.tile_scan_cuda(summ)
        lvl = cf.sift_level_cuda(sig, states, emit=True)
        bases = [lvl.baseline] + [lvl.baseline.clone() for _ in range(3)]
        report(f"{what} level_summaries",
               lambda i: lambda: cf.level_summaries_cuda(sigs[i]),
               rows * n * 4 + rows * nt * 36)
        report(f"{what} tile_scan",
               lambda i: lambda: cf.tile_scan_cuda(summ),
               rows * nt * (36 + 32) + rows * 8)
        report(f"{what} tile_scan with edge completion",
               lambda i: lambda: cf.tile_scan_cuda(lvl.interior,
                                                   edges_from=bases[i]),
               rows * nt * (36 + 32 + 24) + rows * 8)
        for emit in (False, True):
            tag = " emit" if emit else ""
            extra = rows * nt * 36 if emit else 0
            report(f"{what} sift_level<false>{tag}",
                   lambda i: lambda: cf.sift_level_cuda(sigs[i], states,
                                                        emit=emit),
                   16 * rows * n + rows * nt * 32 + extra)
            carry = cf.SiftCarry.zeros(rows, dev)
            st = cf.tile_scan_cuda(summ, carry, 1, levels)
            row = torch.empty_like(sig)
            args = dict(rotp=lvl.rotation, pbase=sig, perr=lvl.sub_err,
                        comp=sig * 0, out_row=row)
            report(f"{what} sift_level<true>{tag}",
                   lambda i: lambda: cf.sift_level_cuda(sigs[i], st, emit=emit,
                                                        **args),
                   4 * n * 9 * rows + rows * nt * 32 + rows * 4 + extra)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=["3,2"])
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--levels", type=int, default=10)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--no-edge-cases", action="store_true")
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        return _child(a.child, a.rows, a.n, a.levels, a.reps,
                      not a.no_edge_cases)
    rc = 0
    for shape in a.shapes:
        blocks, *defines = shape.split(":")
        flags = ["-Xptxas", "-v"] + [
            f"-DPYITD_{name}_BLOCKS={v}" for name, v in zip(
                ("LEVEL", "BOOK", "SUMMARY"), blocks.split(",")) if v]
        env = dict(os.environ)
        env["PYITD_NVCC_FLAGS"] = " ".join(flags + [f"-D{d}" for d in defines])
        cmd = [sys.executable, "-m", "pyitd_tpu_torch.tools.level_bench",
               "--child", shape, "--rows", str(a.rows), "--n", str(a.n),
               "--levels", str(a.levels), "--reps", str(a.reps)]
        if a.no_edge_cases:
            cmd.append("--no-edge-cases")
        rc |= subprocess.run(cmd, env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
