#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``pyitd_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and nvcc:

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):

1. environment and build: the card's name and power limit, the build of
   ``pyitd_tpu_torch/csrc/*.cu`` with nvcc for sm_90a, timed;
2. kernel vs plain on the card: ``itd_sift`` and ``linear_baseline_extract``
   through the kernels against ``backend="torch"`` on the same CUDA tensors,
   bitwise (NaN equal to NaN), at small edge-case shapes, both endpoint
   modes, stop A and stop B;
3. the main path at full size: the bench signal, 8 x 1,000,000 f32,
   ``itd_sift(x, 8, store_baselines=False)`` (10 levels), with every kernel
   launch counted, and the compensated reconstruction
   ``max|sum(rotations) + correction - x|`` in f64 held to 1e-10;
4. timing of the kernel path and the plain path at 8 x 1M and at the
   256 x 16k EEG shape (CUDA events after warm-up, median of 10, and the
   device busy time from a ``torch.profiler`` trace), the main-path output
   of both held bitwise equal, and each kernel against its plain version at
   the main path's shapes (device time per call from the profiler).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SRC = "pyitd_tpu_torch/csrc/sift_level.cu"
REPLACES = {
    "level_summaries": "pyitd_tpu/ops/pallas_fill.py:1398",
    "tile_scan": "pyitd_tpu/ops/pallas_fill.py:1398",
    "sift_level": "pyitd_tpu/ops/pallas_fill.py:1717",
}
MAIN_SHAPE, MAIN_MAX_IT = (8, 1_000_000), 8
EEG_SHAPE, EEG_MAX_IT = (256, 16384), 8


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bitwise_equal(a, b) -> bool:
    """Same shape, dtype and bits; NaN equals NaN."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        same = a.view(torch.int32) == b.view(torch.int32)
        return bool((same | (torch.isnan(a) & torch.isnan(b))).all())
    return bool((a == b).all())


def max_abs_err(a, b) -> float:
    """Largest |a - b| over entries where not both are NaN; inf where only
    one is NaN."""
    import torch

    a, b = a.double(), b.double()
    both = torch.isnan(a) & torch.isnan(b)
    d = (a - b).abs()
    d = torch.where(both, torch.zeros_like(d), d)
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    return float(d.max()) if d.numel() else 0.0


def cuda_times(fn, reps: int = 10, warmup: int = 2) -> list[float]:
    """Sorted times of ``reps`` calls of ``fn`` in ms (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)


def device_ms(fn, reps: int = 5) -> tuple[float, dict]:
    """Device time per call of ``fn`` in ms: the kernels it launches, summed
    from a ``torch.profiler`` trace over ``reps`` calls after one warm-up;
    also the time per call by kernel name.  Returns ``(nan, {})`` where the
    trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us:
            by_name[e.key] = us / 1e3 / reps
    total = sum(by_name.values())
    return (total if total > 0 else float("nan")), by_name


def bench_signal(rows: int, n: int):
    """The headline bench signal (bench.py:349-358)."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, n, dtype=np.float64)
    return (np.sin(20 * t[None, :] * (1 + 0.2 * t[None, :]))
            + np.sin(13 * t[None, :])
            + 0.3 * rng.normal(size=(rows, n))
            + t[None, :] ** 2 * 0.1).astype(np.float32)


def eeg_signal(rows: int, n: int):
    """The EEG-like bank of bench.py:129-137."""
    rng = np.random.default_rng(1)
    t = np.linspace(0, 8 * np.pi, n)
    return (np.sin(55 * t[None] + rng.uniform(0, 6, (rows, 1)))
            + 0.6 * np.sin(130 * t[None] + rng.uniform(0, 6, (rows, 1)))
            + 0.8 * rng.normal(size=(rows, n))
            + 0.3 * np.cumsum(rng.normal(size=(rows, n)), axis=1) / n**0.5
            ).astype(np.float32)


def phase2_cases():
    rng = np.random.default_rng(2)
    t = np.linspace(0, 2 * np.pi, 9000)
    x = np.stack([
        np.sin(20 * t) + 0.1 * rng.normal(size=t.size),
        np.sin(7 * t) * (1 + 0.1 * t) + 0.05 * rng.normal(size=t.size),
    ]).astype(np.float32)
    x[1, 4000:4002] = np.nan
    yield "nan-pair (2, 9000)", x
    for rows, n in [(3, 8192), (2, 8192 + 128), (2, 130), (2, 2)]:
        tt = np.linspace(0, 2 * np.pi, n)
        yield f"({rows}, {n})", (np.sin(7 * tt)[None] + 0.4 * rng.normal(
            size=(rows, n))).astype(np.float32)
    yield "constant (2, 8192)", np.ones((2, 8192), np.float32)
    yield "monotone (2, 9000)", np.stack([t, t ** 2]).astype(np.float32)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from pyitd_tpu_torch import itd_sift, linear_baseline_extract
    from pyitd_tpu_torch.ops import _build
    from pyitd_tpu_torch.ops import cuda_fill as cf

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, device {kind}", flush=True)

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    so, log = _build.build()
    cf._lib()
    print(f"[1] built {so.name} in {time.perf_counter() - t0:.2f} s "
          f"(flags: {' '.join(_build.NVCC_FLAGS)})", flush=True)
    if log.strip():
        print(log.strip())

    # ---- phase 2: kernel vs plain, bitwise ----
    for name, xn in phase2_cases():
        x = torch.from_numpy(xn).to(dev)
        for mode in ("reference", "natural"):
            for mi in (2, 5):
                a = itd_sift(x, mi, endpoint_mode=mode)
                b = itd_sift(x, mi, endpoint_mode=mode, backend="torch")
                for f in a._fields:
                    if not bitwise_equal(getattr(a, f), getattr(b, f)):
                        raise AssertionError(
                            f"itd_sift {name} {mode} max_iteration={mi}: "
                            f"{f} differs, max abs err "
                            f"{max_abs_err(getattr(a, f), getattr(b, f))}")
            la = linear_baseline_extract(x, endpoint_mode=mode)
            lb = linear_baseline_extract(x, endpoint_mode=mode,
                                         backend="torch")
            for f in la._fields:
                if not bitwise_equal(getattr(la, f), getattr(lb, f)):
                    raise AssertionError(
                        f"linear_baseline_extract {name} {mode}: {f} differs")
        ee = itd_sift(x, 5, early_exit=True)
        ref = itd_sift(x, 5, backend="torch")
        if not all(bitwise_equal(getattr(ee, f), getattr(ref, f))
                   for f in ee._fields):
            raise AssertionError(f"early_exit differs on {name}")
        print(f"[2] {name}: kernel == torch bitwise; stop reasons "
              f"{b.stop_reason.tolist()}, components "
              f"{b.num_components.tolist()}", flush=True)
    for bad, exc in ((torch.zeros(2, 64, dtype=torch.float64, device=dev),
                      ValueError),
                     (torch.zeros(2, 64, device=dev, requires_grad=True),
                      NotImplementedError)):
        try:
            itd_sift(bad, 2)
        except exc:
            pass
        else:
            raise AssertionError(f"itd_sift took {bad.dtype} "
                                 f"requires_grad={bad.requires_grad}")
    print("[2] f64 and requires_grad inputs on CUDA raise", flush=True)

    # ---- phase 3: the main path at full size ----
    xn = bench_signal(*MAIN_SHAPE)
    x = torch.from_numpy(xn).to(dev)
    torch.cuda.synchronize()
    cf.reset_launches()
    res = itd_sift(x, MAIN_MAX_IT, store_baselines=False)
    torch.cuda.synchronize()
    launches = dict(cf.LAUNCHES)
    levels = MAIN_MAX_IT + 2
    want = {k: levels + 1 for k in launches}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    if tuple(res.rotations.shape) != (levels,) + MAIN_SHAPE:
        raise AssertionError(f"rotations shape {tuple(res.rotations.shape)}")
    if not bool(torch.isfinite(res.rotations).all()):
        raise AssertionError("non-finite rotations")
    recon = (res.rotations.double().sum(0) + res.correction.double()
             - x.double()).abs().max().item()
    raw = (res.rotations.double().sum(0) - x.double()).abs().max().item()
    if not recon <= 1e-10:
        raise AssertionError(f"compensated reconstruction error {recon}")
    print(f"[3] 8x1M sift: launches {launches}; num_components "
          f"{res.num_components.tolist()}; stop_reason "
          f"{res.stop_reason.tolist()}; compensated reconstruction error "
          f"{recon!r} (uncompensated {raw!r})", flush=True)

    # ---- phase 4: timing ----
    k_ms = cuda_times(lambda: itd_sift(x, MAIN_MAX_IT,
                                       store_baselines=False))
    p_ms = cuda_times(lambda: itd_sift(x, MAIN_MAX_IT, store_baselines=False,
                                       backend="torch"), warmup=1)
    plain = itd_sift(x, MAIN_MAX_IT, store_baselines=False, backend="torch")
    for f in res._fields:
        if not bitwise_equal(getattr(res, f), getattr(plain, f)):
            raise AssertionError(f"8x1M: kernel and torch paths differ in {f}")
    print("[4] 8x1M kernel == torch path bitwise", flush=True)

    def report(shape, xs, times, backend):
        dms, by_name = device_ms(lambda: itd_sift(
            xs, MAIN_MAX_IT, store_baselines=False, backend=backend))
        n = shape[0] * shape[1]
        ms = statistics.median(times)
        print(f"[4] {shape[0]}x{shape[1]} max_iteration=8 {backend} path: "
              f"{ms:.4f} ms/sift (CUDA events, median of {len(times)}, "
              f"min {times[0]:.4f}, max {times[-1]:.4f}), "
              f"{n / ms / 1e3:.2f} Msamp/s; device busy {dms:.4f} ms/sift, "
              f"idle share {1 - dms / ms:.3f}  [{card}]", flush=True)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        print("[4]   top device kernels (ms/sift): " + "; ".join(
            f"{k[:60]} {v:.4f}" for k, v in top), flush=True)

    report(MAIN_SHAPE, x, k_ms, "kernel")
    report(MAIN_SHAPE, x, p_ms, "torch")

    xe = torch.from_numpy(eeg_signal(*EEG_SHAPE)).to(dev)
    ek_ms = cuda_times(lambda: itd_sift(xe, EEG_MAX_IT,
                                        store_baselines=False))
    ep_ms = cuda_times(lambda: itd_sift(xe, EEG_MAX_IT, store_baselines=False,
                                        backend="torch"), warmup=1)
    report(EEG_SHAPE, xe, ek_ms, "kernel")
    report(EEG_SHAPE, xe, ep_ms, "torch")

    # each kernel against its plain version at the main path's shapes
    # (trip 1 of the 8x1M sift: the first baseline as input)
    st0 = cf.level_states(x)
    lvl0 = cf.sift_level(x, st0)
    base = lvl0.baseline
    entries = []

    def entry(name, errs, kernel_fn, plain_fn):
        err = max(errs)
        if err != 0.0:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version, max abs err {err}")
        # device time from the profiler; CUDA events where it has none
        ms, plain_ms = device_ms(kernel_fn)[0], device_ms(plain_fn)[0]
        method = "profiler device time"
        if ms != ms or plain_ms != plain_ms:
            ms = statistics.median(cuda_times(kernel_fn))
            plain_ms = statistics.median(cuda_times(plain_fn))
            method = "CUDA events"
        print(f"[4] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"per call at 8x1M ({method}; max abs err {err})  [{card}]",
              flush=True)
        entries.append({"name": name, "route": "cuda", "source": SRC,
                        "replaces": REPLACES[name],
                        "launches": launches[name], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms})

    sk, sp = cf.level_summaries_cuda(base), cf.level_summaries(base)
    entry("level_summaries", [max_abs_err(a, b) for a, b in zip(sk, sp)],
          lambda: cf.level_summaries_cuda(base),
          lambda: cf.level_summaries(base))

    def carry():
        c = cf.SiftCarry.zeros(MAIN_SHAPE[0], dev)
        c.done[1] = 1
        return c

    ck, cp = carry(), carry()
    tk = cf.tile_scan_cuda(sk, ck, trip=1, max_iteration=MAIN_MAX_IT)
    tp = cf.tile_scan(sp, cp, trip=1, max_iteration=MAIN_MAX_IT)
    entry("tile_scan",
          [max_abs_err(a, b) for a, b in zip(tk + ck, tp + cp)],
          lambda: cf.tile_scan_cuda(sk, ck, 1, MAIN_MAX_IT),
          lambda: cf.tile_scan(sp, cp, 1, MAIN_MAX_IT))

    row_k, row_p = torch.empty_like(x), torch.empty_like(x)
    zero = x * 0
    args = dict(rotp=lvl0.rotation, pbase=x, perr=lvl0.sub_err, comp=zero)
    lk = cf.sift_level_cuda(base, tk, out_row=row_k, **args)
    lp = cf.sift_level(base, tk, out_row=row_p, **args)
    entry("sift_level",
          [max_abs_err(a, b) for a, b in zip(lk + (row_k,), lp + (row_p,))],
          lambda: cf.sift_level_cuda(base, tk, out_row=row_k, **args),
          lambda: cf.sift_level(base, tk, out_row=row_p, **args))

    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
