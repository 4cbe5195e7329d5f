"""Time-causal analogue of the Gabor transform (Lindeberg et al. 2024) —
port of ``pyitd_tpu/decomp/lindeberg.py``.

A geometric ladder of temporal scales ``tau_k = c^(2(k-K)) tau_max``, a
cascade of K first-order recursive filters ``y[n] = y[n-1] + (x[n] -
y[n-1])/(1+mu_k)``, then a DFT-centred STFT (halves-swapped frames,
fftshifted window) of the smoothed signal, combined with scale-normalized
first and second temporal derivatives: ``S = |Z| + sqrt(tau)|Z_t| +
tau|Z_tt|``.

Each recursive filter is the affine recurrence ``y[n] = a y[n-1] + b x[n]``
run as log-depth doubling of the affine maps (``tridiag.
_affine_scan_banded``), where JAX runs a ``lax.associative_scan``: the
same maps combined in another order, so the two agree to roundoff.

Where this differs from JAX: the time derivatives are taken along the
frame axis (-1).  JAX takes them along axis 1 (``pyitd_tpu/decomp/
lindeberg.py:90-91``), which is the frame axis only for a 1-D input; for a
(channels, n) bank axis 1 is the frequency axis.  The port equals JAX's
1-D result row by row.  Entry points given numpy run on ``device`` (the
card by default); a tensor stays on its own device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.tridiag import _affine_scan_banded
from ..utils.interop import as_input

__all__ = ["recursive_filter", "dft_centered_stft", "time_causal_stft"]


def recursive_filter(x, mu: float, *, device="cuda"):
    """First-order IIR ``y[n] = y[n-1] + (x[n]-y[n-1])/(1+mu)``, ``y[0] =
    x[0]``: the affine maps ``y -> a·y + c`` composed by doubling."""
    x = as_input(x, None, device)
    a = torch.full_like(x, mu / (1.0 + mu))
    a[..., 0] = 0.0
    c = (1.0 / (1.0 + mu)) * x
    c[..., 0] = x[..., 0]
    return _affine_scan_banded(c, a, None)


def dft_centered_stft(x, n_fft: int, hop_len: int, window, *, device="cuda"):
    """The reference's DFT-centred STFT (lindeberg.py:43-80): reflect pad,
    halves-swapped frames, fftshifted window, rfft per frame; ``(...,
    n_fft // 2 + 1, frames)``."""
    x = as_input(x, None, device)
    window = as_input(window, None, x.device)
    before, after = n_fft // 2, n_fft // 2 - 1
    # reflect pad excluding the edge sample
    head = x[..., 1:before + 1].flip(-1)
    tail = x[..., -after - 1:-1].flip(-1) if after > 0 else x[..., :0]
    xp = torch.cat([head, x, tail], dim=-1)
    s21 = math.ceil(n_fft / 2) - (n_fft % 2)
    # a frame from start s is [xp[s+s21 : s+n_fft], xp[s : s+s21]]
    frames = xp.unfold(-1, n_fft, hop_len).roll(-s21, dims=-1)
    shift = window.shape[0] // 2 if window.shape[0] % 2 == 0 \
        else (window.shape[0] + 1) // 2
    win = torch.cat([window[shift:], window[:shift]])
    return torch.fft.rfft(frames * win, dim=-1).transpose(-1, -2)


def time_causal_stft(x, n_fft: int = 512, hop_len: int = 128,
                     tau_max: float = 0.1, c: float = 2.0, k: int = 4, *,
                     device="cuda"):
    """lindeberg.py:8-33, time derivatives along the frame axis."""
    x = as_input(x, None, device)
    tau = np.asarray([c ** (2 * (kk - k)) * tau_max
                      for kk in range(1, k + 1)])
    mu = np.sqrt(c ** 2 - 1.0) * np.sqrt(tau)
    mu = np.insert(mu, 0, c ** (1 - k) * np.sqrt(tau_max))

    y = x
    for kk in range(k):
        y = recursive_filter(y, float(mu[kk]))

    hop_adj = max(1, int(hop_len * np.sqrt(tau_max)))
    n_fft_adj = max(n_fft, int(n_fft * np.sqrt(tau_max)))
    zx = dft_centered_stft(y, n_fft_adj, hop_adj,
                           torch.ones(n_fft_adj, dtype=x.dtype,
                                      device=x.device))

    def d_dt(z):
        return torch.gradient(z, dim=-1)[0]

    zx_t = float(np.sqrt(tau_max)) * d_dt(zx)
    zx_tt = tau_max * d_dt(d_dt(zx))
    return zx.abs() + zx_t.abs() + zx_tt.abs()
