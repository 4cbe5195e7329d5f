"""Kalman-sweep multi-head gains: port of ``pyitd_tpu/ml/kalman.py``.

A gain-producing attention substitute: a fused projection of (Q, K,
first-head-broadcast V) yields per-head diagonal observation models H,
observations y, adaptive noise R (a sink gate inflates R to ignore
inputs), and a transition modulation; ``n_passes`` Kalman sweeps
(shift-and-predict across time, diagonal updates) refine the state, and
the final Kalman gain is the output.  Both of the reference's layout
quirks are kept (see the comments in ``forward``).
"""
from __future__ import annotations

import torch
from torch import nn

from . import _init

__all__ = ["KalmanSweepMHGains"]


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0); torch's F.softplus returns x
    # itself above its threshold of 20, 2e-9 away
    return torch.logaddexp(x, torch.zeros_like(x))


class KalmanSweepMHGains(nn.Module):
    """Gains for inputs of ``d_model`` features in ``n_head`` heads."""

    def __init__(self, d_model: int, n_head: int, n_passes: int = 12,
                 init_log_q: float = -2.0, eps: float = 1e-6, *,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        h, dh = n_head, d_model // n_head
        self.n_head = n_head
        self.n_passes = n_passes
        self.eps = eps
        self.fused_proj = _init.dense(3 * dh, 5 * dh, gen, device, dtype)
        self.scales = _init.parameter(torch.ones(3, h, dtype=torch.float64),
                                      device, dtype)
        self.A_base = _init.parameter(torch.eye(dh, dtype=torch.float64),
                                      device, dtype)
        self.logQ = _init.parameter(torch.full((h, dh), float(init_log_q),
                                               dtype=torch.float64),
                                    device, dtype)

    def forward(self, q, k, v):
        b, n, d = q.shape
        h = self.n_head
        dh = d // h

        v_shared = v.reshape(b, n, h, dh)[:, :, :1, :].expand(
            b, n, h, dh).reshape(b, n, d)
        # reference layout quirk: the fused projection's per-"head" input
        # is a CONTIGUOUS 3dh slice of the full [Q | K | V_broadcast]
        # embedding, not the per-head [Q_h, K_h, V_h]
        qkv = torch.cat([q, k, v_shared], dim=-1).reshape(b, n, h, 3 * dh)
        out = self.fused_proj(qkv)  # (B,N,H,5dh)
        h_raw, y, r_raw, a_mod, sink_raw = out.split(dh, dim=-1)

        scales = self.scales
        h_diag = torch.sigmoid(h_raw) * scales[0][None, None, :, None]
        sink = torch.sigmoid(sink_raw) * scales[2][None, None, :, None]
        r_base = _softplus(r_raw) * scales[1][None, None, :, None] + self.eps
        r_diag = r_base / (sink + 0.01)

        a_sig = torch.sigmoid(a_mod)  # (B,N,H,dh): row modulation of A_base
        q_diag = self.logQ.exp().clamp_min(self.eps)[None, None]

        p = torch.ones((b, n, h, dh), dtype=q.dtype, device=q.device)
        hp = h_diag * p
        s = hp * h_diag + r_diag
        k_gain = hp / s
        if self.n_passes == 1:
            return k_gain.reshape(b, n, d)

        x = k_gain * y
        p = p - k_gain * hp

        # reference quirk: the modulation rows come from the FLAT prefix
        # (b-major order), not the per-batch [:, :-1] slice: for B > 1 the
        # rows misalign across batch elements
        a_mod_rows = a_sig.reshape(b * n * h, dh)[: b * (n - 1) * h]
        a_mod_rows = a_mod_rows.reshape(b, n - 1, h, dh)

        zeros = torch.zeros((b, 1, h, dh), dtype=x.dtype, device=x.device)
        ones = torch.ones((b, 1, h, dh), dtype=p.dtype, device=p.device)
        for _ in range(1, self.n_passes):
            # predict: shift the state one step through the modulated A
            x_pred = a_mod_rows * torch.einsum("ed,bnhd->bnhe", self.A_base,
                                               x[:, :-1])
            x_prev = torch.cat([zeros, x_pred], dim=1)
            p_prev = torch.cat([ones, p[:, :-1] + q_diag], dim=1)
            hp = h_diag * p_prev
            s = hp * h_diag + r_diag
            k_gain = hp / s
            innov = y - h_diag * x_prev
            x = x_prev + k_gain * innov
            p = p_prev - k_gain * hp

        return k_gain.reshape(b, n, d)
