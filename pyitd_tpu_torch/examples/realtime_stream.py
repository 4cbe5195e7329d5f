"""Real-time streaming ITD, the reference's deployed use case, as a
script: port of ``examples/realtime_stream.py``.

1. ``streaming_step`` fed hop by hop like an audio callback (two warm-up
   hops, then one decomposed hop per push), with per-hop latency
   percentiles against the callback budget HOP/SR (on the card each hop
   is synchronized before its clock stops);
2. the offline channel-bank replay (``streaming_itd``) of the same
   signal on a bank of channels, every ready hop equal to the step's.

The JAX example also drives the native C++ tier (``pyitd_tpu.runtime``:
``StreamingITD``, extrema reuse, ``NativePool``).  That tier is not
ported, and this example leaves it out.

    python -m pyitd_tpu_torch.examples.realtime_stream [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import streaming_init, streaming_itd, streaming_step

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
    print("native C++ tier (pyitd_tpu.runtime) not ported: left out")
    if not (err < 1e-10 and bank_err < 1e-10 and same):
        raise AssertionError("streaming reconstruction failed")
    return {"latency_ms": lat, "err": err, "bank_err": bank_err}


if __name__ == "__main__":
    main()
