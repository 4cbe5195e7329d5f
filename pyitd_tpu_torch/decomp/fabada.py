"""FABADA / PFABADA, iterative Bayesian denoising — port of
``pyitd_tpu/decomp/fabada.py``.

* :func:`fabada` — the canonical 1-D/2-D algorithm (PFABADA.ipynb cell 1):
  running-mean priors (3-tap line / 5-point cross with edge divisors),
  Gaussian evidence, a chi²-pdf convergence test.
* :func:`pfabada` — the numba variant (the reference's ``pfabada.py:
  91-225``) with σ as a parameter and that file's quirks: the 3-tap prior
  with special end formulas, the evidence denominator's unbalanced
  parenthesis (``sqrt(2π)·prior_variance + data_variance``), χ²/N and
  first/second derivative stopping with tolerance 1e-15, cap 1000.
* :func:`auto_sigma` — the db2-wavelet noise estimator the notebook tier
  inlines (median |detail| / Γ-ppf constant, the skimage recipe).

The denoised output is the evidence-weighted average over the iteration
path, the iteration-zero term included.  JAX's ``lax.while_loop`` becomes a
device state machine (``utils/device_loop.run_until``): the state and the
stop flag stay on the device, and the host reads the flag once per
``_BLOCK`` iterations.  Everything is float64, as the JAX package with x64.
Entry points given numpy run on ``device`` (the card by default); a tensor
stays on its own device.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device_loop import run_until
from ..utils.interop import as_input
from ..utils.stats import median

__all__ = ["fabada", "pfabada", "auto_sigma", "psnr"]

# iterations between host reads of the stop flag
_BLOCK = 32
_F64 = torch.float64


def _edge_divisor(d, inner: float):
    """The running mean's divisors: ``inner`` inside, one less on each edge
    a sample has."""
    div = torch.full_like(d, inner)
    for ax in range(d.ndim):
        idx = [slice(None)] * d.ndim
        for end in (0, -1):
            idx[ax] = end
            div[tuple(idx)] -= 1.0
    return div


def _running_mean(d, div):
    """The canonical FABADA prior smoother (PFABADA.ipynb ``running_mean``):
    each sample plus its neighbours along every axis, in the reference's
    order, over ``div``."""
    if d.ndim not in (1, 2):
        raise ValueError("fabada supports 1-D and 2-D data")
    s = d
    for ax in range(d.ndim):
        lead = (0, 0) * (d.ndim - 1 - ax)
        s = s + F.pad(d.narrow(ax, 1, d.shape[ax] - 1), lead + (0, 1))
        s = s + F.pad(d.narrow(ax, 0, d.shape[ax] - 1), lead + (1, 0))
    return s / div


def _evidence(mu1, mu2, var1, var2):
    return torch.exp(-((mu1 - mu2) ** 2) / (2.0 * (var1 + var2))) / torch.sqrt(
        2.0 * math.pi * (var1 + var2))


def _chi2_pdf(x, df: float):
    """``jax.scipy.stats.chi2.pdf`` in its order of operations."""
    half = df / 2.0
    kernel = torch.special.xlogy(half - 1.0, x) - x / 2.0
    nrml = -(math.lgamma(half) + math.log(2.0) * df / 2.0)
    return torch.exp(nrml + kernel)


def fabada(data, data_variance, max_iter: int = 3000, *, device="cuda"):
    """Canonical FABADA (1-D or 2-D).  ``data_variance`` is a scalar or an
    array of ``data``'s shape."""
    data = as_input(data, _F64, device)
    x = torch.where(torch.isnan(data), 0.0, data)
    dv = as_input(data_variance, _F64, x.device).expand(x.shape)
    # no 1e-15 substitution at NaN positions: the canonical cell zeroes
    # data's NaNs in place before `data_variance[np.isnan(data)] = 1e-15`,
    # so that line sees an all-False mask — NaN samples keep the caller's
    # variance (the numba tier works on a copy: see pfabada)
    size = float(x.numel())
    div = _edge_divisor(x, 2.0 * x.ndim + 1.0)
    inv_dv, x_dv = 1.0 / dv, x / dv
    ev0 = _evidence(0.0, torch.sqrt(dv), 0.0, dv)

    def step(c):
        it = c["iteration"] + 1
        prior_mean = _running_mean(c["post_mean"], div)
        prior_var = c["post_var"]
        post_var = 1.0 / (1.0 / prior_var + inv_dv)
        post_mean = (prior_mean / prior_var + x_dv) * post_var

        ev = _evidence(prior_mean, x, prior_var, dv)
        ev_mean = ev.mean()
        ev_deriv = ev_mean - c["ev_prev"]

        chi2_data = ((x - post_mean) ** 2 / dv).sum()
        chi2_pdf = _chi2_pdf(chi2_data, size)
        chi2_pdf_deriv = chi2_pdf - c["chi2_pdf"]
        chi2_pdf_snd = chi2_pdf_deriv - c["chi2_pdf_deriv"]

        mw = ev * chi2_data
        bw = c["bayes_w"] + mw
        bm = c["bayes_m"] + mw * post_mean
        chi2_min = torch.where(it == 1, chi2_data, c["chi2_min"])

        converged = (((chi2_data > size) & (chi2_pdf_snd >= 0)
                      & (ev_deriv < 0)) | (it >= max_iter + 1))
        # the iteration-zero term folds in at convergence
        mw0 = ev0 * chi2_min
        bw = torch.where(converged, bw + mw0, bw)
        bm = torch.where(converged, bm + mw0 * x, bm)
        return {"post_mean": post_mean, "post_var": post_var,
                "ev_prev": ev_mean, "chi2_pdf": chi2_pdf,
                "chi2_pdf_deriv": chi2_pdf_deriv, "chi2_min": chi2_min,
                "bayes_w": bw, "bayes_m": bm, "iteration": it,
                "done": converged}

    def scalar(v, dtype=_F64):
        return torch.tensor(v, dtype=dtype, device=x.device)

    init = {"post_mean": x, "post_var": dv, "ev_prev": ev0.mean(),
            "chi2_pdf": scalar(0.0), "chi2_pdf_deriv": scalar(0.0),
            "chi2_min": scalar(size), "bayes_w": torch.zeros_like(x),
            "bayes_m": torch.zeros_like(x),
            "iteration": scalar(0, torch.int32), "done": scalar(False,
                                                                torch.bool)}
    c = run_until(step, init, block=_BLOCK)
    return c["bayes_m"] / c["bayes_w"]


def _pfabada_prior(pm):
    """pfabada.py:143-147 along the last axis: the interior 3-tap mean; the
    ends use half-sums."""
    left = torch.cat([pm[..., :1], pm[..., :-1]], dim=-1)
    right = torch.cat([pm[..., 1:], pm[..., -1:]], dim=-1)
    out = (left + pm + right) / 3.0
    first = (pm[..., 0] + (pm[..., 1] + pm[..., 2]) / 2.0) / 3.0
    last = (pm[..., -1] + (pm[..., -2] + pm[..., -3]) / 2.0) / 3.0
    return torch.cat([first[..., None], out[..., 1:-1], last[..., None]],
                     dim=-1)


def pfabada(data, sigma, max_iterations: int = 1000, *, device="cuda"):
    """The pfabada.py numba tier, quirks included (see the module
    docstring).  2-D inputs use the reference's sketched generalization
    (``pfabada.py:228-255``): the prior is the average of the row- and
    column-direction 1-D smoothers."""
    data = as_input(data, _F64, device)
    nan = torch.isnan(data)
    x = torch.where(nan, 0.0, data)
    n = float(x.numel())
    tol = 1e-15

    sigma = as_input(sigma, _F64, x.device)
    dv = (sigma ** 2).expand(x.shape)
    dv = torch.where(nan | (dv == 0), 1e-15, dv)

    if x.ndim == 1:
        prior_fn = _pfabada_prior
    elif x.ndim == 2:
        def prior_fn(pm):
            return 0.5 * (_pfabada_prior(pm) + _pfabada_prior(pm.T).T)
    else:
        raise ValueError("pfabada supports 1-D and 2-D data")

    # the initial evidence, formula for formula (pfabada.py:131-136):
    # exp(-dv / (2 dv)) / (sqrt(2 pi) dv)
    ev0 = torch.exp(-torch.square(torch.sqrt(dv) * -1.0) / (2.0 * dv)) / (
        math.sqrt(2.0 * math.pi) * dv)
    x_dv = x / dv

    def step(c):
        prior_mean = prior_fn(c["post_mean"])
        prior_var = c["post_var"]
        post_var = torch.where(prior_var > 0,
                               (dv * prior_var) / (dv + prior_var), 0.0)
        post_mean = torch.where((prior_var > 0) & (post_var > 0),
                                (prior_mean / prior_var + x_dv) * post_var,
                                prior_mean)
        # the reference's unbalanced-paren denominator, kept verbatim
        ev = torch.exp(-torch.square(prior_mean - x)
                       / (2.0 * (prior_var + dv))) / (
            math.sqrt(2.0 * math.pi) * prior_var + dv)
        ev_mean = ev.mean()
        ev_deriv = ev_mean - c["ev_prev"]

        chi2 = ((x - post_mean) ** 2 / dv).sum() / n
        chi2_deriv = chi2 - c["chi2_prev"]
        chi2_snd = chi2_deriv - c["chi2_deriv_prev"]
        chi2_min = torch.where(c["iterations"] == 1, chi2, c["chi2_min"])

        mw = ev * chi2
        done = (((chi2 > 1.0) & (ev_deriv < 0) & (chi2_snd < tol))
                | (c["iterations"] >= max_iterations + 1))
        return {"post_mean": post_mean, "post_var": post_var,
                "ev_prev": ev_mean, "chi2_prev": chi2,
                "chi2_deriv_prev": chi2_deriv, "chi2_min": chi2_min,
                "bayes_w": c["bayes_w"] + mw,
                "bayes_m": c["bayes_m"] + mw * post_mean,
                "iterations": c["iterations"] + (~done).to(torch.int32),
                "done": done}

    def scalar(v, dtype=_F64):
        return torch.tensor(v, dtype=dtype, device=x.device)

    init = {"post_mean": x, "post_var": dv, "ev_prev": ev0.mean(),
            "chi2_prev": scalar(0.0), "chi2_deriv_prev": scalar(0.0),
            "chi2_min": scalar(0.0), "bayes_w": torch.zeros_like(x),
            "bayes_m": torch.zeros_like(x),
            "iterations": scalar(1, torch.int32),
            "done": scalar(False, torch.bool)}
    c = run_until(step, init, block=_BLOCK)

    mw0 = ev0 * c["chi2_min"]
    bw = c["bayes_w"] + mw0
    bm = c["bayes_m"] + mw0 * x
    return torch.where(bw > 0, bm / bw, x)


# db2 high-pass decomposition filter (Daubechies-2 QMF)
_DB2_LO = np.array([
    (1 + np.sqrt(3)) / (4 * np.sqrt(2)),
    (3 + np.sqrt(3)) / (4 * np.sqrt(2)),
    (3 - np.sqrt(3)) / (4 * np.sqrt(2)),
    (1 - np.sqrt(3)) / (4 * np.sqrt(2)),
])
_DB2_HI = np.array([_DB2_LO[3], -_DB2_LO[2], _DB2_LO[1], -_DB2_LO[0]])


def _dwt_detail_1d(x):
    """Single-level db2 detail coefficients with symmetric padding along the
    last axis (pywt ``dwt`` convention)."""
    flt = _DB2_HI[::-1]  # correlation form
    pad = 3
    xp = torch.cat([x[..., :pad].flip(-1), x, x[..., -pad:].flip(-1)],
                   dim=-1)
    m = xp.shape[-1] - 3  # valid correlation length
    y = sum(float(flt[k]) * xp[..., k:k + m] for k in range(4))
    return y[..., 1::2]


def auto_sigma(x, *, device="cuda"):
    """Robust noise σ via db2 wavelet detail MAD (the skimage recipe the
    notebook tier inlines: ``median(|detail|) / 0.6616518484657332``).  For
    2-D input the detail band is the separable high-pass along both axes
    (pywt ``dwtn`` 'dd')."""
    x = as_input(x, _F64, device)
    d = _dwt_detail_1d(x)
    if x.ndim == 2:
        d = _dwt_detail_1d(d.movedim(0, -1)).movedim(-1, 0)
    return median(d.abs()) / 0.6616518484657332


def psnr(recover, signal, L: float = 255.0, *, device="cuda"):
    """PSNR as the reference's harness defines it (PFABADA.ipynb cell 1)."""
    recover = as_input(recover, None, device)
    signal = as_input(signal, None, recover.device)
    mse = ((recover - signal) ** 2).sum() / recover.numel()
    return 10.0 * torch.log10(L ** 2 / mse)
