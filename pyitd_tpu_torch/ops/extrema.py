"""Vectorized extrema detection — port of ``pyitd_tpu/ops/extrema.py``.

For interior ``i``::

    is_min[i] = (x[i] - x[i-1] <= 0) & (x[i+1] - x[i] > 0)
    is_max[i] = (x[i] - x[i-1] >= 0) & (x[i+1] - x[i] < 0)

(the plateau-rightmost rule).  Differences that involve a NaN count as
+inf, any sample within distance 1 of a NaN is disqualified, endpoints are
never extrema, and signals shorter than 3 samples have none.  All functions
work on the last axis and broadcast over leading batch axes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["ExtremaMasks", "extrema_masks", "extrema_mask", "count_extrema",
           "compact_indices"]


class ExtremaMasks(NamedTuple):
    minima: torch.Tensor  # bool, same shape as x
    maxima: torch.Tensor  # bool, same shape as x


def _diffs(x: torch.Tensor):
    """Backward/forward first differences with NaN->+inf substitution."""
    dx = x[..., 1:] - x[..., :-1]
    dx = torch.where(torch.isnan(dx), torch.full_like(dx, float("inf")), dx)
    zero = torch.zeros_like(x[..., :1])
    dxb = torch.cat([zero, dx], dim=-1)  # x[i] - x[i-1]; 0 at i=0
    dxf = torch.cat([dx, zero], dim=-1)  # x[i+1] - x[i]; 0 at i=N-1
    return dxb, dxf


def extrema_masks(x: torch.Tensor) -> ExtremaMasks:
    """Boolean masks of local minima and maxima (plateau-rightmost rule)."""
    n = x.shape[-1]
    if n < 3:
        none = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        return ExtremaMasks(minima=none, maxima=none.clone())
    dxb, dxf = _diffs(x)
    is_min = (dxb <= 0) & (dxf > 0)
    is_max = (dxb >= 0) & (dxf < 0)

    it = torch.arange(n, device=x.device)
    interior = (it > 0) & (it < n - 1)

    isnan = torch.isnan(x)
    pad = torch.zeros_like(isnan[..., :1])
    near_nan = (
        isnan
        | torch.cat([pad, isnan[..., :-1]], dim=-1)
        | torch.cat([isnan[..., 1:], pad], dim=-1)
    )
    keep = interior & ~near_nan
    return ExtremaMasks(minima=is_min & keep, maxima=is_max & keep)


def extrema_mask(x: torch.Tensor) -> torch.Tensor:
    """Merged extrema mask (minima | maxima) — what the sift consumes."""
    m = extrema_masks(x)
    return m.minima | m.maxima


def count_extrema(x: torch.Tensor) -> torch.Tensor:
    """Number of interior extrema as int32, one per batch element."""
    m = extrema_masks(x)
    return (m.minima.sum(-1) + m.maxima.sum(-1)).to(torch.int32)


def compact_indices(mask: torch.Tensor,
                    capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack the sorted indices of marked samples into a fixed-capacity
    buffer: ``(indices[..., capacity], count)``, both int32.  Slots past
    ``count`` hold ``n - 1`` (clamping gathers to the last sample keeps
    padded arithmetic finite); marks past ``capacity`` are dropped, while
    ``count`` counts them all."""
    n = mask.shape[-1]
    it = torch.arange(n, dtype=torch.int32, device=mask.device)
    rank = torch.cumsum(mask.to(torch.int64), dim=-1) - 1
    count = mask.sum(-1).to(torch.int32)
    # unmarked samples and marks past capacity go to one spare slot
    dest = torch.where(mask & (rank < capacity), rank, capacity)
    out = torch.full(mask.shape[:-1] + (capacity + 1,), n - 1,
                     dtype=torch.int32, device=mask.device)
    out.scatter_(-1, dest, it.expand(mask.shape))
    return out[..., :capacity], count
