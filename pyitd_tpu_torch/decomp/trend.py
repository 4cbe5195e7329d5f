"""Filter-based trend decomposition — port of ``pyitd_tpu/decomp/trend.py``
(Untitled35.ipynb cells 1-3).

* ``custom_filter_engine``: halves the signal, then applies 8 orders of
  e-folding corrections whose sign flips wherever the running residual's
  gradient changes sign;
* ``extract_trend``: double-filter, find zero crossings of the second
  derivative, natural cubic spline through those inflection knots;
* ``decompose_signal``: subtract-trend iteration (tol 1e-6, max 10), one
  host read of the step's norm per iteration, as in JAX.

The knot count is data-dependent: fixed-capacity knot buffers
(``compact_indices``) and the batched natural-spline solver
(``tridiag.spline_moments``: PCR on the card, Thomas on the CPU below 1,024
slots).  ``torch.gradient`` is ``jnp.gradient`` (central differences
inside, one-sided at the ends) and ``torch.sign(0)`` is 0, as
``jnp.sign``'s.  Entry points given numpy run on ``device`` (the card by
default); a tensor stays on its own device.
"""
from __future__ import annotations

import torch

from ..ops.cubic_baseline import eval_moment_spline, segment_index
from ..ops.extrema import compact_indices
from ..ops.fill import take_last_axis
from ..ops.tridiag import spline_moments
from ..utils.interop import as_input

__all__ = ["custom_filter_engine", "extract_trend", "decompose_signal"]

_A = 1.0 - 0.36787944


def _gradient(x):
    return torch.gradient(x, dim=-1)[0]


def _sign_flips(x):
    """Where the gradient's sign differs from the sample before (never at
    the first sample)."""
    s = torch.sign(_gradient(x))
    return torch.cat([torch.zeros_like(s[..., :1], dtype=torch.bool),
                      s[..., :-1] != s[..., 1:]], dim=-1)


def custom_filter_engine(x, *, device="cuda"):
    """Untitled35 cell 1 (its offset parameter is unused there and omitted
    here)."""
    x = as_input(x, None, device)
    out = 0.5 * x
    residual = 0.5 * x
    flip = _sign_flips(x)
    for order in range(1, 9):
        if order > 1:
            flip = _sign_flips(residual)
        delta = _A * residual
        out = out + torch.where(flip, delta, -delta)
        residual = residual * 0.36787944
    return out


def extract_trend(signal, capacity: int | None = None, *, device="cuda"):
    """Natural cubic spline through the inflections of the double-filtered
    signal, evaluated on the full grid.  Returns ``(trend, knot_mask)``."""
    signal = as_input(signal, None, device)
    n = signal.shape[-1]
    if capacity is None:
        capacity = n + 2  # the inflection count is data-dependent, up to n
    f2 = custom_filter_engine(custom_filter_engine(signal))
    sign = torch.sign(_gradient(_gradient(f2)))
    crossing = torch.cat([sign[..., :-1] != sign[..., 1:],
                          torch.zeros_like(sign[..., :1], dtype=torch.bool)],
                         dim=-1)
    it = torch.arange(n, device=signal.device)
    knotmask = crossing | (it == 0) | (it == n - 1)
    pos, count = compact_indices(knotmask, capacity)
    cnt = count[..., None]
    vals = take_last_axis(signal, pos.long())
    k = torch.arange(capacity, device=signal.device)
    vals = torch.where(k < cnt, vals, torch.zeros_like(vals))

    moments = spline_moments(pos.to(signal.dtype), vals, count, bc="natural")
    h = (torch.cat([pos[..., 1:], pos[..., -1:]], dim=-1) - pos).to(
        signal.dtype)
    h = torch.where(k < cnt - 1, h, torch.ones_like(h))
    seg = segment_index(signal, pos, count, cap_to_last_interval=True)
    lin, cub = eval_moment_spline(signal, pos, vals, moments, h, seg)
    return lin + cub, knotmask


def decompose_signal(signal, max_iter: int = 10, tol: float = 1e-6, *,
                     device="cuda"):
    """Untitled35 cell 3: ``(components list, residual)``."""
    residual = as_input(signal, None, device)
    components = []
    for _ in range(max_iter):
        trend, _ = extract_trend(residual)
        components.append(trend)
        new_residual = residual - trend
        if float(torch.linalg.norm(new_residual - residual)) < tol:
            break
        residual = new_residual
    return components, residual
