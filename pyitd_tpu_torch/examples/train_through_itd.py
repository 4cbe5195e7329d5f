"""Train THROUGH the decomposition: gradients across ``itd_sift`` — port of
``examples/train_through_itd.py``.

The sift is differentiable end to end: on the card its backward walks the
sift's trips in reverse on the kernels, the structural adjoint per level,
so a model can learn parameters upstream of the decomposition.  This demo learns a
9-tap FIR pre-filter that makes the sift's first proper rotation match a
known band; the gradient flows through every level into the taps.

Run on the card (or with ``--device cpu``):

    python -m pyitd_tpu_torch.examples.train_through_itd
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..decomp.itd import itd_sift
from ..utils.interop import from_numpy

__all__ = ["make_problem", "identity_taps", "prefilter", "loss_fn", "train"]


def make_problem(n: int = 512, batch: int = 4, seed: int = 0):
    """The example's signal and target as numpy f64: ``batch`` rows of two
    tones plus noise; the target is the high tone, which rotation 0 should
    isolate."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 4 * np.pi, n)
    hi = np.stack([np.sin((40 + 3 * k) * t) for k in range(batch)])
    lo = np.stack([np.sin((3 + k) * t) for k in range(batch)])
    noise = 0.35 * rng.normal(size=(batch, n))
    return hi + lo + noise, hi


def identity_taps(k: int = 9) -> np.ndarray:
    taps = np.zeros(k)
    taps[k // 2] = 1.0
    return taps


def prefilter(taps: torch.Tensor, sig: torch.Tensor) -> torch.Tensor:
    """FIR filter with edge padding, as ``windows @ taps`` (a matrix
    product, never a convolution: cuDNN would run f32 in TF32)."""
    k, n = taps.shape[0], sig.shape[-1]
    pad = k // 2
    s = torch.cat([sig[:, :1].expand(-1, pad), sig,
                   sig[:, -1:].expand(-1, pad)], dim=-1)
    windows = torch.stack([s[:, i:i + n] for i in range(k)], dim=-1)
    return windows @ taps


def loss_fn(taps, x, target, max_iteration: int = 6, **sift_kw):
    """Mean squared error between rotation 0 of the pre-filtered signal and
    the target."""
    res = itd_sift(prefilter(taps, x), max_iteration, store_baselines=False,
                   **sift_kw)
    return torch.mean(torch.square(res.rotations[0] - target))


def train(x, target, taps, steps: int, lr: float = 3e-2,
          max_iteration: int = 6, log=None):
    """``steps`` Adam steps on the taps; returns the taps and the losses
    (each read before its step)."""
    taps = taps.detach().clone().requires_grad_()
    opt = torch.optim.Adam([taps], lr=lr)
    losses = []
    for i in range(steps):
        opt.zero_grad()
        loss = loss_fn(taps, x, target, max_iteration)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if log is not None:
            log(i, losses[-1])
    return taps.detach(), losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    xn, hi = make_problem()
    dtype = torch.float32 if dev.type == "cuda" else torch.float64
    x, target = (from_numpy(a, dev).to(dtype) for a in (xn, hi))
    taps0 = from_numpy(identity_taps(), dev).to(dtype)
    loss0 = float(loss_fn(taps0, x, target))

    def log(i, loss):
        if i % 10 == 0:
            print(f"step {i:3d}  loss {loss:.5f}")

    taps, _ = train(x, target, taps0, args.steps, log=log)
    loss1 = float(loss_fn(taps, x, target))
    print(f"loss: {loss0:.5f} -> {loss1:.5f} "
          f"({'improved' if loss1 < loss0 * 0.8 else 'NO IMPROVEMENT'})")
    print("learned taps:", np.round(taps.cpu().numpy(), 3))
    if not loss1 < loss0 * 0.8:
        raise SystemExit("training through the sift failed")


if __name__ == "__main__":
    main()
