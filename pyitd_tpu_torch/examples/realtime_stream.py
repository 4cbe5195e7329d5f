"""Real-time streaming ITD, the reference's deployed use case, as a
script: port of ``examples/realtime_stream.py``.

1. ``streaming_step`` fed hop by hop like an audio callback (two warm-up
   hops, then one decomposed hop per push), with per-hop latency
   percentiles against the callback budget HOP/SR (on the card each hop
   is synchronized before its clock stops);
2. the offline channel-bank replay (``streaming_itd``) of the same
   signal on a bank of channels, every ready hop equal to the step's;
3. the native C++ tier on the host (``pyitd_tpu_torch.runtime``):
   ``StreamingITD`` hop by hop with its latency percentiles, channel 0's
   extrema reused on a second channel, and a ``NativePool`` batch with
   the pool's tasks-per-second harness.

    python -m pyitd_tpu_torch.examples.realtime_stream [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import runtime, streaming_init, streaming_itd, streaming_step

SR = 48_000          # simulated sample rate (audio block processing)
HOP = 256            # samples per callback (5.3 ms at 48 kHz)
N_HOPS = 64


def live_signal(n, seed=0, channels=1):
    """Speech-ish test signal: chirp + hum + noise, f64, (channels, n)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    base = (np.sin(2 * np.pi * 220 * t * (1 + 40 * t))
            + 0.4 * np.sin(2 * np.pi * 60 * t))
    return base + 0.1 * rng.normal(size=(channels, n))


def stream(x, device, n_hops=N_HOPS):
    """Hop-by-hop streaming of ``x`` (channels, n): per-hop latencies (ms),
    the emitted hops' (rotation + baseline) error against their input,
    and the (rotation, baseline) of every ready hop."""
    dev = torch.device(device)
    state = streaming_init(HOP, (x.shape[0],), device=dev)
    xt = torch.from_numpy(x).to(dev)
    lat, err, out = [], 0.0, []
    for k in range(n_hops):
        hop = xt[:, k * HOP:(k + 1) * HOP]
        t0 = time.perf_counter()
        state, rot, base, ready = streaming_step(state, hop, HOP)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        lat.append((time.perf_counter() - t0) * 1e3)
        if bool(ready.all()):
            want = xt[:, (k - 1) * HOP:k * HOP]
            err = max(err, float((rot + base - want).abs().max()))
            out.append((rot, base))
    return np.sort(lat), err, out


def native_stream(x, n_hops=N_HOPS):
    """Hop-by-hop native streaming of the 1-D ``x``: sorted per-hop
    latencies (ms), hops emitted, and the emitted hops' reconstruction
    error."""
    s = runtime.StreamingITD(HOP)
    lat, err, emitted = [], 0.0, 0
    try:
        for k in range(n_hops):
            hop = x[k * HOP:(k + 1) * HOP]
            t0 = time.perf_counter()
            out = s.push(hop)
            lat.append((time.perf_counter() - t0) * 1e3)
            if out is not None:
                rot, base = out
                err = max(err, float(np.abs(rot + base - x[(k - 1) * HOP:
                                                           k * HOP]).max()))
                emitted += 1
    finally:
        s.close()
    return np.sort(lat), emitted, err


def extrema_reuse(x):
    """Channel 0's knots reused on a second channel with co-located
    extrema: ``(knots, channel 1's reconstruction error)``."""
    ch0 = x[:4096]
    ch1 = 0.8 * ch0 + 0.05
    _, _, state = runtime.baseline_extract(ch0)
    rot1, base1, _ = runtime.baseline_extract(ch1, extrema_state=state)
    return int(state[1][0]), float(np.abs(rot1 + base1 - ch1).max())


def pool_batch(x, rows=8, n=2048):
    """A (rows, n) batch across the thread pool: ``(ms, reconstruction
    error, tasks per second of the harness)``."""
    pool = runtime.NativePool()
    try:
        signals = np.stack([x[i * n:(i + 1) * n] for i in range(rows)])
        t0 = time.perf_counter()
        rots, bases = pool.extract_batch(signals)
        ms = (time.perf_counter() - t0) * 1e3
        worst = float(np.abs(rots + bases - signals).max())
        return ms, worst, pool.bench(ntasks=20_000, task_us=5)
    finally:
        pool.close()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hops", type=int, default=N_HOPS)
    ap.add_argument("--channels", type=int, default=8)
    args = ap.parse_args(argv)
    x = live_signal(args.hops * HOP, channels=args.channels)
    lat, err, hops = stream(x[:1], args.device, args.hops)
    budget = HOP / SR * 1e3
    print(f"stream (1 channel): {len(hops)}/{args.hops} hops emitted, "
          f"recon err {err:.3e}, latency p50 {lat[len(lat) // 2]:.3f} / "
          f"p99 {lat[int(len(lat) * 0.99)]:.3f} ms (host clock; callback "
          f"budget {budget:.1f} ms)")
    rots, bases, ready = streaming_itd(x, HOP, device=args.device)
    one = torch.stack([r for r, _ in hops])[:, 0]
    same = bool(torch.equal(rots[ready[:, 0]][:, 0], one))
    bank_err = float((rots + bases)[2:].sub(torch.from_numpy(
        x[:, HOP:(args.hops - 1) * HOP].reshape(args.channels, -1, HOP)
        .transpose(1, 0, 2)).to(rots.device)).abs().max())
    print(f"channel bank ({args.channels} x {x.shape[1]}): "
          f"{int(ready[:, 0].sum())} ready hops per channel, recon err "
          f"{bank_err:.3e}; channel 0 bitwise the step's hops: {same}")
    if not runtime.native_available():
        raise RuntimeError(f"native tier unavailable: {runtime._build_error}")
    nlat, emitted, nerr = native_stream(x[0], args.hops)
    print(f"native stream: {emitted}/{args.hops} hops emitted, recon err "
          f"{nerr:.3e}, latency p50 {nlat[len(nlat) // 2]:.3f} / p99 "
          f"{nlat[int(len(nlat) * 0.99)]:.3f} ms (host clock; callback "
          f"budget {budget:.1f} ms)")
    # a run shorter than the demos' windows repeats the signal to fill them
    knots, reuse_err = extrema_reuse(np.resize(x[0], 4096))
    print(f"extrema reuse: {knots} knots shared across channels, ch1 recon "
          f"err {reuse_err:.3e}")
    pool_ms, pool_err, rate = pool_batch(np.resize(x[0], 8 * 2048))
    print(f"native pool: 8x2048 batch in {pool_ms:.2f} ms (recon err "
          f"{pool_err:.3e}); bench {rate:,.0f} tasks/sec")
    if not (err < 1e-10 and bank_err < 1e-10 and same and nerr < 1e-10
            and reuse_err < 1e-10 and pool_err < 1e-10):
        raise AssertionError("streaming reconstruction failed")
    return {"latency_ms": lat, "err": err, "bank_err": bank_err,
            "native_latency_ms": nlat, "native_err": nerr,
            "reuse_err": reuse_err, "pool_err": pool_err}


if __name__ == "__main__":
    main()
