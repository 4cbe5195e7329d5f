"""Hypersphere phase heads and the spectral mixer: port of
``pyitd_tpu/ml/phase.py``.

``add_hypersphere_phase_heads`` splits channels into S heads; each head
s >= 1 adds the cosine similarity between its L2-normalized vector at time
t and at time t-s (lag = head index, clamped at 0), scaled by 1/E.  The
optional scalar path measures lag-1 self-coherence across heads.  Real and
complex inputs (complex-safe inner products).

``Mixer``: FFT across channels in complex64 whatever the input dtype ->
phase heads in the spectral domain -> inverse FFT -> causal depthwise
convolution over time, cast back to the input dtype.
"""
from __future__ import annotations

import torch
from torch import nn

from . import _init

__all__ = ["add_hypersphere_phase_heads", "PhaseHeads", "Mixer"]


def _cnorm(z, eps):
    return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(
        eps)


def add_hypersphere_phase_heads(x, num_segs: int, eps: float = 1e-8,
                                return_scalar: bool = False):
    b, t, c = x.shape
    if t == 0 or num_segs <= 0:
        return (x, None) if return_scalar else x
    if c % num_segs:
        raise ValueError(f"{c} channels do not split into {num_segs} heads")
    e = c // num_segs
    xh = x.reshape(b, t, num_segs, e).transpose(1, 2)  # (B,S,T,E)
    steps = torch.arange(t, device=x.device)

    if num_segs > 1:
        v = _cnorm(xh[:, 1:], eps)  # (B,S-1,T,E)
        lags = torch.arange(1, num_segs, device=x.device)
        src = (steps[None, :] - lags[:, None]).clamp_min(0)  # (S-1,T)
        anchor = v[:, torch.arange(num_segs - 1, device=x.device)[:, None],
                   src]
        cos_a = (v * anchor.conj()).sum(-1)  # (B,S-1,T)
        xproc = xh[:, 1:] + (cos_a / float(e))[..., None]
        xh = torch.cat([xh[:, :1], xproc], dim=1)

    y = xh.transpose(1, 2).reshape(b, t, c)
    if not return_scalar:
        return y

    v_all = _cnorm(xh, eps)
    t_prev = (steps - 1).clamp_min(0)
    cos1 = (v_all * v_all[:, :, t_prev].conj()).sum(-1)
    if cos1.is_complex():
        cos1 = cos1.real
    cos1 = cos1.clamp(-1.0 + eps, 1.0 - eps)
    s_norm = cos1 / torch.linalg.vector_norm(
        cos1, dim=1, keepdim=True).clamp_min(eps)
    scalar = (s_norm * s_norm[:, :, t_prev]).sum(1).clamp(-1.0 + eps,
                                                          1.0 - eps)
    return y, scalar


class PhaseHeads(nn.Module):
    """``add_hypersphere_phase_heads`` with the scalar path; no
    parameters.  Returns ``(y, scalar)``."""

    def __init__(self, num_segs: int, eps: float = 1e-8):
        super().__init__()
        self.num_segs = num_segs
        self.eps = eps

    def forward(self, x):
        return add_hypersphere_phase_heads(x, self.num_segs, self.eps,
                                           return_scalar=True)


class Mixer(nn.Module):
    """FFT-over-channels phase heads + causal depthwise conv over time, on
    ``channels`` features; ``dw`` is ``(dw_kernel, channels)``,
    ``lecun_normal``."""

    def __init__(self, channels: int, num_segs: int, dw_kernel: int = 3,
                 eps: float = 1e-16, *, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        self.num_segs = num_segs
        self.dw_kernel = dw_kernel
        self.eps = eps
        self.dw = _init.parameter(_init.lecun_normal(
            (dw_kernel, channels), dw_kernel, gen), device, dtype)

    def forward(self, x):
        t = x.shape[1]
        y = torch.fft.fft(x.to(torch.float32), dim=2)
        s = add_hypersphere_phase_heads(y, self.num_segs, self.eps)
        z = torch.fft.ifft(s, dim=2).real  # (B,T,C)
        k = self.dw_kernel
        zp = nn.functional.pad(z, (0, 0, k - 1, 0))  # causal pad
        out = sum(zp[:, i:i + t, :] * self.dw[i] for i in range(k))
        return out.to(x.dtype)
