"""Ensemble-selection statistics — port of ``pyitd_tpu/utils/stats.py``.

The noise-assisted workflows run many realizations and pick the median
outcome: ``fingerprint`` reduces an array to a perceptual scalar (haar
detail -> DCT -> sum / Γ-ppf constant), ``sorted_median_index`` returns the
index of the realization nearest the mean of the sorted fingerprints plus a
"completeness" score (correlation of the sorted distribution against a
logit ramp; believe the median when completeness > 0.95).

Everything here is float64, as in the JAX package.  torch has no DCT:
:func:`dct2` builds JAX's ``jax.scipy.fft.dct(x, type=2, norm=None)`` from
an FFT of the same length.  :func:`median` is ``jnp.median``'s (the mean
of the two middle values of an even count); ``torch.median`` returns the
lower one.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .interop import as_input

__all__ = ["fingerprint", "sorted_median_index", "median", "dct2"]

_SQ2 = math.sqrt(2.0)
# the Γ-ppf constant of the reference's fingerprint
_PPF = 0.6616518484657332


def median(a: torch.Tensor, dim: int | None = None) -> torch.Tensor:
    """``jnp.median``: over all elements (``dim=None``) or along ``dim``;
    the mean of the two middle values of an even count, NaN where the
    input holds one."""
    if dim is None:
        a, dim = a.reshape(-1), 0
    s = torch.sort(a, dim=dim).values
    n = s.shape[dim]
    lo, hi = s.narrow(dim, (n - 1) // 2, 1), s.narrow(dim, n // 2, 1)
    m = (0.5 * (lo + hi)).squeeze(dim)
    return torch.where(torch.isnan(a).any(dim), torch.nan, m)


def dct2(x: torch.Tensor) -> torch.Tensor:
    """DCT-II of the last axis, unnormalized (scipy's and JAX's
    ``norm=None``): ``y_k = 2 sum_n x_n cos(pi k (2n + 1) / 2N)``, from one
    complex FFT of the even samples followed by the odd ones reversed."""
    n = x.shape[-1]
    v = torch.cat([x[..., 0::2], x[..., 1::2].flip(-1)], dim=-1)
    k = torch.arange(n, dtype=x.dtype, device=x.device)
    tw = torch.polar(torch.ones_like(k), -math.pi * k / (2 * n))
    return 2.0 * (torch.fft.fft(v, dim=-1) * tw).real


def _haar_split(x: torch.Tensor):
    """Single-level haar DWT along the last axis (pywt convention: symmetric
    odd-length handling via edge duplication)."""
    if x.shape[-1] % 2 == 1:
        x = torch.cat([x, x[..., -1:]], dim=-1)
    a = (x[..., 0::2] + x[..., 1::2]) / _SQ2
    d = (x[..., 0::2] - x[..., 1::2]) / _SQ2
    return a, d


def fingerprint_rows(x: torch.Tensor) -> torch.Tensor:
    """The 1-D :func:`fingerprint` of every row of ``x`` (..., n)."""
    a, d = _haar_split(x.to(torch.float64))
    return dct2(torch.cat([a, d], dim=-1)).sum(-1) / _PPF


def fingerprint(data, *, device="cuda") -> torch.Tensor:
    """helperfunctions.py:11-16: haar dwtn -> flatten all subbands -> DCT ->
    sum / 0.6616518484657332, of 1-D or 2-D ``data``.  A tensor stays on
    its device; anything else goes to ``device``."""
    x = as_input(data, torch.float64, device)
    if x.dim() == 1:
        return fingerprint_rows(x)
    if x.dim() != 2:
        raise ValueError("fingerprint supports 1-D and 2-D data")
    # pywt.dwtn key order is aa, ad, da, dd with the FIRST letter on axis 0:
    # splitting axis 1 first makes the second split's detail pywt's 'da'
    a, d = _haar_split(x)                  # along axis 1
    aa, da_ = _haar_split(a.T)             # along axis 0
    ad_, dd = _haar_split(d.T)
    coeff = torch.cat([c.T.reshape(-1) for c in (aa, ad_, da_, dd)])
    return dct2(coeff).sum() / _PPF


def sorted_median_index(data, *, device="cuda"):
    """helperfunctions.py:18-37: index of the sorted-mean element + the
    logit-fit completeness measure, as 0-d tensors."""
    data = as_input(data, torch.float64, device).reshape(-1)
    size = data.numel()
    sort = torch.argsort(data, stable=True)
    a = data[sort]
    mean = a.mean()
    idx = torch.searchsorted(a, mean.reshape(1), right=False)[0]

    lo, hi = a.min(), a.max()
    scaled = -6.0 + (a - lo) * 12.0 / torch.where(hi == lo, 1.0, hi - lo)
    y = torch.special.logit(torch.from_numpy(
        np.linspace(0.0, 1.0, size)).to(a.device))
    # the reference replaces only the +-inf ENDPOINTS with +-6; finite
    # interior values beyond |6| (size >= ~406) are kept
    y = torch.where(torch.isinf(y), torch.sign(y) * 6.0, y)
    sc = scaled - scaled.mean()
    yc = y - y.mean()
    completeness = (sc * yc).sum() / torch.sqrt((sc ** 2).sum()
                                                * (yc ** 2).sum())
    return sort[idx.clamp(0, size - 1)], completeness
