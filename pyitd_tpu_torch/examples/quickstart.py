"""Quickstart, the reference repository's demos as a script: port of
``examples/quickstart.py``.

Runs a decomposition, then checks the exact-reconstruction invariant
``|sum(components) - input|`` (compensated summation): the ITD class and a
batched sift, the WPE-sorted MEITD (``xitd``), EFD of three cosines, and
FABADA's denoising (PSNR up).  On the card the ITD sift runs its CUDA
kernels in f32; the rest runs in f64.

    python -m pyitd_tpu_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import ITD, efd, fabada, itd_sift, neumaier_sum, xitd


def demo_itd(device) -> float:
    """Canonical ITD on the reference demo chirp; a batched sift of a bank
    of 16 copies.  Returns the reconstruction error over max|s|."""
    t = np.linspace(0, 2 * np.pi, 400)
    s = np.sin(20 * t * (1 + 0.2 * t)) + t**2 + np.sin(13 * t)
    rotations = ITD(device=device)(s)
    err = float((neumaier_sum(rotations.double(), 0).cpu() - torch.from_numpy(
        s)).abs().max()) / np.abs(s).max()
    print(f"ITD: {rotations.shape[0]} components, recon err {err:.3e} of "
          f"max|s| (f32)")
    bank = torch.from_numpy(np.tile(s, (16, 1))).float().to(device)
    res = itd_sift(bank, 8, store_baselines=False)
    print(f"itd_sift bank: rotations {tuple(res.rotations.shape)}, "
          f"components per row {int(res.num_components[0])}")
    return err


def demo_xitd(device) -> float:
    """Entropy-sorted ensemble decomposition."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, 512)
    s = np.sin(6 * t) + 0.3 * rng.normal(size=t.size)
    comps = xitd(s, device=device).cpu().numpy()
    err = float(np.abs(comps.sum(0) - s).max())
    print(f"XITD: {comps.shape[0]} WPE-sorted components, recon err "
          f"{err:.3e}")
    return err


def demo_efd(device) -> float:
    """Empirical Fourier Decomposition of three cosines."""
    t = np.arange(1024) / 1024
    s = (np.cos(2 * np.pi * 5 * t) + 0.5 * np.cos(2 * np.pi * 40 * t)
         + 0.25 * np.cos(2 * np.pi * 120 * t))
    res = efd(s, 3, device=device)
    bands = res.bands.cpu().numpy()
    err = float(np.abs(bands.sum(0) - s).max())
    print(f"EFD: {int(res.count)} bands, recon err {err:.3e}")
    return err


def demo_fabada(device) -> tuple[float, float]:
    """Bayesian denoising: (PSNR of the noisy signal, of the denoised)."""
    rng = np.random.default_rng(1)
    t = np.linspace(0, 1, 512)
    clean = np.sin(2 * np.pi * 3 * t) * (1 - t)
    sigma = 0.2
    noisy = clean + sigma * rng.normal(size=t.size)
    den = fabada(noisy, sigma**2, device=device).cpu().numpy()

    def psnr(a):
        return 10 * np.log10(np.ptp(clean) ** 2 / np.mean((a - clean) ** 2))

    print(f"FABADA: PSNR {psnr(noisy):.1f} dB -> {psnr(den):.1f} dB")
    return psnr(noisy), psnr(den)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = {"itd": demo_itd(args.device), "xitd": demo_xitd(args.device),
           "efd": demo_efd(args.device), "fabada": demo_fabada(args.device)}
    if not (out["itd"] < 1e-5 and out["xitd"] < 1e-10 and out["efd"] < 1e-10
            and out["fabada"][1] > out["fabada"][0]):
        raise AssertionError(f"a reconstruction check failed: {out}")
    return out


if __name__ == "__main__":
    main()
