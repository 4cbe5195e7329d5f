"""Masked index fills — port of ``pyitd_tpu/ops/fill.py:44-103``.

``prev_index`` / ``next_index`` give, per sample, the position of the most
recent / soonest marked sample (a knot) with ``torch.cummax`` over
``where(mask, iota, -1)`` and its flipped twin; ``take_last_axis`` gathers
along the last axis.  Indices are int64, PyTorch's index type.
"""
from __future__ import annotations

import torch

__all__ = ["prev_index", "next_index", "take_last_axis"]


def _iota_like(mask: torch.Tensor) -> torch.Tensor:
    return torch.arange(mask.shape[-1], device=mask.device).expand(mask.shape)


def prev_index(mask: torch.Tensor, *, inclusive: bool = True) -> torch.Tensor:
    """Per-sample index of the nearest marked sample at-or-before it.

    Returns -1 where no marked sample exists yet.  With ``inclusive=False``
    the marked sample itself maps to the previous marked one.
    """
    marked = torch.where(mask, _iota_like(mask), -1)
    idx = torch.cummax(marked, dim=-1).values
    if not inclusive:
        idx = torch.cat([torch.full_like(idx[..., :1], -1), idx[..., :-1]],
                        dim=-1)
    return idx


def next_index(mask: torch.Tensor, *, inclusive: bool = True) -> torch.Tensor:
    """Per-sample index of the nearest marked sample at-or-after it.

    Returns ``n`` (one past the end) where no marked sample follows.  With
    ``inclusive=False`` the marked sample itself maps to the next marked one.
    """
    n = mask.shape[-1]
    marked = torch.where(mask, _iota_like(mask), n)
    idx = torch.cummin(marked.flip(-1), dim=-1).values.flip(-1)
    if not inclusive:
        idx = torch.cat([idx[..., 1:], torch.full_like(idx[..., :1], n)],
                        dim=-1)
    return idx


def take_last_axis(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather along the last axis:
    ``out[..., i] = values[..., idx[..., i]]``.

    ``idx`` is clipped into range, so callers may pass the -1 / n sentinels
    of :func:`prev_index` / :func:`next_index` and mask afterwards.
    """
    n = values.shape[-1]
    return torch.gather(values, -1, idx.clamp(0, n - 1))
