"""STIRFT, the short-time inverse-FFT transform pair — port of
``pyitd_tpu/decomp/stirft.py``.

A real-valued time-frequency transform for streaming filtering
(the reference's ``stirft.py``): odd-reflect pad by 2·hop, frame (n_fft
512, hop 128), window, irfft per frame (forward); the inverse is an rfft per
frame and a hop-sized overlap-add through a persistent (n_fft -
hop)-sample buffer, so it streams.  The forward uses the Griffin-Lim MSE
synthesis window computed from hann, the inverse 2·hann (``stirft.py:
113-119``).

JAX's overlap-add is a ``lax.scan`` over frames.  Here it is vectorized:
each output hop adds, in the scan's order, the initial buffer's block, the
frames' overlapping blocks from the oldest to the newest, then the current
frame's first block; the buffer passed on is what the next hops would add
to.  Entry points given numpy run on ``device`` (the card by default); a
tensor stays on its own device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.interop import as_input

__all__ = ["compute_synthesis_window", "stirft", "istirft"]


def compute_synthesis_window(analysis_window: np.ndarray,
                             hop: int) -> np.ndarray:
    """Griffin-Lim optimal (MSE) synthesis window for an analysis window and
    frame shift (stirft.py:1-37).  Host numpy: windows are static
    configuration."""
    w = np.asarray(analysis_window, np.float64)
    L = w.shape[0]
    norm = np.zeros_like(w)
    n = 0
    while n - hop > -L:
        n -= hop
    while n < L:
        if n == 0:
            norm += w ** 2
        elif n < 0:
            norm[: n + L] += w[-n - L:] ** 2
        else:
            norm[n:] += w[:-n] ** 2
        n += hop
    return w / norm


def stirft(x, window, *, n_fft: int = 512, hop_len: int = 128,
           device="cuda"):
    """Forward STIRFT: ``(..., n_fft, frames)`` real frames of the inverse
    FFT, taken along the frame axis (a batch axis never mixes)."""
    x = as_input(x, None, device)
    window = as_input(window, None, x.device)
    pad = 2 * hop_len
    # reflect pad excluding the edge sample (stirft.py:49-52)
    xp = torch.cat([x[..., 1:pad + 1].flip(-1), x,
                    x[..., -pad:-1].flip(-1)], dim=-1)
    frames = xp.unfold(-1, n_fft, hop_len) * window
    spec = torch.complex(frames, torch.zeros_like(frames))
    return torch.fft.irfft(spec, dim=-1)[..., :n_fft].transpose(
        -1, -2).contiguous()


def istirft(sx, persistent_buffer, window, *, n_fft: int = 512,
            hop_len: int = 128, device="cuda"):
    """Inverse STIRFT by overlap-add; one channel, ``sx`` of ``(n_fft,
    frames)``.  Returns ``(x, buffer)``; pass ``buffer`` to the next call
    to stream block by block (the reference's 384-sample persistent
    buffer)."""
    sx = as_input(sx, None, device)
    if sx.ndim != 2:
        raise ValueError(
            "istirft streams one channel: sx must be (n_fft, n_segs); "
            "call it per channel for banks")
    buf = as_input(persistent_buffer, None, sx.device)
    window = as_input(window, None, sx.device)
    hop, keep = hop_len, n_fft - hop_len
    segs = sx.shape[1]
    xbuf = torch.fft.rfft(sx, n=n_fft * 2 - 2, dim=0).real   # (n_fft, segs)
    proc = xbuf.T * window                                   # (segs, n_fft)
    r = -(-n_fft // hop)                                     # blocks a frame
    dtype = torch.promote_types(proc.dtype, buf.dtype)
    blocks = torch.nn.functional.pad(proc, (0, r * hop - n_fft)).reshape(
        segs, r, hop).to(dtype)
    # acc[i]: what the buffer holds for output hop i, i < segs + r - 1
    acc = torch.zeros(segs + r - 1, hop, dtype=dtype, device=sx.device)
    acc[:r - 1] = torch.nn.functional.pad(
        buf, (0, (r - 1) * hop - keep)).reshape(r - 1, hop)
    for q in range(r - 1, 0, -1):
        acc = acc + torch.nn.functional.pad(blocks[:, q], (0, 0, q, r - 1 - q))
    out = blocks[:, 0] + acc[:segs]
    return out.reshape(-1), acc[segs:].reshape(-1)[:keep]
