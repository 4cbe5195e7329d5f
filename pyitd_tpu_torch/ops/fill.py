"""Masked index and value fills — port of ``pyitd_tpu/ops/fill.py``.

``prev_index`` / ``next_index`` give, per sample, the position of the most
recent / soonest marked sample (a knot) with ``torch.cummax`` over
``where(mask, iota, -1)`` and its flipped twin; ``take_last_axis`` gathers
along the last axis, and ``forward_fill`` / ``backward_fill`` are the two
composed.  Indices are int64, PyTorch's index type.

The value fills (``forward_fill_scan`` and ``backward_fill_scan`` at depth
one, ``forward_fill2_scan`` and ``backward_fill2_scan`` at depth two) keep
the JAX names and results but not its method: JAX runs associative scans
(a TPU workaround for slow gathers); here they are an index fill and a
gather.  A fill only selects, so the two agree bit for bit.
"""
from __future__ import annotations

import torch

__all__ = ["prev_index", "next_index", "forward_fill", "backward_fill",
           "take_last_axis", "shift_left",
           "shift_right", "forward_fill_scan", "backward_fill_scan",
           "forward_fill2_scan", "backward_fill2_scan"]


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
        idx = shift_right(idx, -1)
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
        idx = shift_left(idx, n)
    return idx


def take_last_axis(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather along the last axis:
    ``out[..., i] = values[..., idx[..., i]]``.

    ``idx`` is clipped into range, so callers may pass the -1 / n sentinels
    of :func:`prev_index` / :func:`next_index` and mask afterwards.
    """
    n = values.shape[-1]
    return torch.gather(values, -1, idx.clamp(0, n - 1))


def forward_fill(values: torch.Tensor, mask: torch.Tensor, *,
                 inclusive: bool = True) -> torch.Tensor:
    """The value at the last marked sample at or before each sample
    (``inclusive=False``: strictly before).  Samples before the first mark
    read ``values[..., 0]``; callers that care mask with ``prev_index(mask)
    < 0``."""
    return take_last_axis(values, prev_index(mask, inclusive=inclusive))


def backward_fill(values: torch.Tensor, mask: torch.Tensor, *,
                  inclusive: bool = True) -> torch.Tensor:
    """The value at the next marked sample at or after each sample
    (``inclusive=False``: strictly after).  Samples after the last mark
    read ``values[..., -1]``."""
    return take_last_axis(values, next_index(mask, inclusive=inclusive))


def shift_left(a: torch.Tensor, fill) -> torch.Tensor:
    """``out[..., t] = a[..., t + 1]``; ``fill`` at the last sample."""
    return torch.cat([a[..., 1:], torch.full_like(a[..., :1], fill)], dim=-1)


def shift_right(a: torch.Tensor, fill) -> torch.Tensor:
    """``out[..., t] = a[..., t - 1]``; ``fill`` at the first sample."""
    return torch.cat([torch.full_like(a[..., :1], fill), a[..., :-1]], dim=-1)


def _fill(values, defaults, idx, has):
    return tuple(torch.where(has, take_last_axis(v, idx), d)
                 for v, d in zip(values, defaults))


def forward_fill_scan(values: tuple, mask: torch.Tensor,
                      defaults: tuple) -> tuple:
    """Per sample, each channel of ``values`` at the last marked sample at
    or before it; its default before the first mark."""
    i1 = prev_index(mask)
    return _fill(values, defaults, i1, i1 >= 0)


def backward_fill_scan(values: tuple, mask: torch.Tensor,
                       defaults: tuple) -> tuple:
    """Reverse-direction counterpart of :func:`forward_fill_scan`: the next
    marked sample at or after each sample."""
    i1 = next_index(mask)
    return _fill(values, defaults, i1, i1 < mask.shape[-1])


def _fill2(values, defaults, i1, i2, has1, has2):
    cnt = has1.to(torch.int32) + has2.to(torch.int32)
    return (_fill(values, defaults, i1, has1),
            _fill(values, defaults, i2, has2), cnt)


def forward_fill2_scan(values: tuple, mask: torch.Tensor, defaults: tuple):
    """Per sample: channels of the last marked sample at-or-before it (v1)
    and of the marked sample before that (v2), plus the count of the two
    that exist (0, 1 or 2)."""
    i1 = prev_index(mask)
    has1 = i1 >= 0
    i2 = torch.where(has1, take_last_axis(
        prev_index(mask, inclusive=False), i1), -1)
    return _fill2(values, defaults, i1, i2, has1, i2 >= 0)


def backward_fill2_scan(values: tuple, mask: torch.Tensor, defaults: tuple):
    """Per sample: the next marked sample at-or-after (v1) and the one after
    it (v2), plus the count of the two that exist."""
    n = mask.shape[-1]
    i1 = next_index(mask)
    has1 = i1 < n
    i2 = torch.where(has1, take_last_axis(
        next_index(mask, inclusive=False), i1), n)
    return _fill2(values, defaults, i1, i2, has1, i2 < n)
