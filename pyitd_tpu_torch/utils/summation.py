"""Compensated summation — the reconstruction oracle.

Port of ``pyitd_tpu/utils/summation.py``: a Kahan-Neumaier sum along one
axis, which keeps the error of summing K components per sample at one ulp.
"""
from __future__ import annotations

import torch

__all__ = ["neumaier_sum", "neumaier_sum_parts", "reconstruction_error"]


def neumaier_sum_parts(components: torch.Tensor, dim: int = 0):
    """Compensated sum along ``dim``; returns ``(s, c)`` with the true sum
    ≈ ``s + c`` and every per-step rounding residual captured in ``c``."""
    comps = torch.movedim(components, dim, 0)
    s = torch.zeros_like(comps[0])
    c = torch.zeros_like(comps[0])
    for v in comps:
        t = s + v
        big = s.abs() >= v.abs()
        c = c + torch.where(big, (s - t) + v, (v - t) + s)
        s = t
    return s, c


def neumaier_sum(components: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Compensated sum along ``dim`` (Neumaier variant of Kahan)."""
    s, c = neumaier_sum_parts(components, dim=dim)
    return s + c


def reconstruction_error(components: torch.Tensor, signal: torch.Tensor,
                         dim: int = 0) -> torch.Tensor:
    """Max-abs error of ``sum(components) - signal`` with compensated sums."""
    total = neumaier_sum(components, dim=dim)
    return (total - signal).abs().max()
