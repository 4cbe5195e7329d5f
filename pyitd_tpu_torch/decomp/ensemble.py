"""Noise-assisted ensemble MEITD — port of ``pyitd_tpu/decomp/ensemble.py``.

The reference's MEITD cites its ensemble-ITD lineage
(the reference's ``MEITD.py:38-47``: Hu 2015 ensemble ITD, Wang & Ling
2019 EITD-MP) and ships the two ensemble mechanisms separately:

* **paired-noise realizations** — the 2-D ensemble decomposes
  ``img + v`` and ``img - v`` for ``v ~ N(0, MAD(img))`` and averages
  (siftED2D.ipynb cell 1);
* **median selection** — ``helperfunctions.py:18-37``: fingerprint every
  realization's outcome, pick the realization nearest the mean of the
  sorted fingerprints, believe it when the sorted distribution's
  logit-fit "completeness" exceeds 0.95.

This module composes both around the batched MEITD walk
(:func:`.meitd_jit.meitd_jit_bank`): R paired realizations ride ONE walk
(the modpool-style batch axis — the reference's ``modpool.c`` — is exactly
the ensemble axis here), each realization's components are WPE-sorted (the
XITD convention, ``MEITD.py:545-548``), and the result carries both
ensemble reductions: the across-realization mean of the sorted stacks and
the fingerprint-median realization.

With paired noise and an even ``n_realizations`` the realization mean
equals the input exactly, so the mean stack reconstructs the INPUT (not a
noisy copy) to float roundoff.  The noise comes from ``torch.randn`` with
the caller's ``generator`` where JAX takes a PRNG key; no generator
reproduces JAX's stream, so the tests hand JAX's bank to
:func:`_ensemble_from_bank`.  While a profiler records, a call runs inside
the span ``pyitd.ensemble`` and its epilogue (the WPE sort, the
fingerprints and the median selection) inside ``pyitd.ensemble_select``
(``utils/spans.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.interop import as_input
from ..utils.spans import span, spanned
from ..utils.stats import fingerprint_rows, median, sorted_median_index
from ..ops.wpe import walk_stats_cuda
from .meitd_jit import meitd_jit_bank

__all__ = ["meitd_ensemble", "EnsembleResult"]

# The walk accepts at most one component per trip and stops once
# highc + lowc exceeds 20 (the reference cap, MEITD.py:424-433), so at
# most 21 high + 21 low rows can ever be valid — the 44-row buffers are
# the reference's allocation, not its reachable count.  Sorting only the
# reachable rows halves the ensemble epilogue's WPE work.
_MAX_VALID = 22


class EnsembleResult(NamedTuple):
    """``stacks``: (R, 2*_MAX_VALID+1, n) WPE-sorted component stacks, one
    per realization (invalid rows hold zeros and sort last);
    ``mean_stack``: their across-realization mean; ``selected``: the
    stack of the fingerprint-median realization; ``selected_index`` /
    ``completeness``: the ``getsortedindex`` machinery's pick and its
    believability score (> 0.95 per the reference); ``num_components``:
    per-realization valid-row counts (high + low + residual)."""

    stacks: torch.Tensor
    mean_stack: torch.Tensor
    selected: torch.Tensor
    selected_index: torch.Tensor
    completeness: torch.Tensor
    num_components: torch.Tensor


def _sorted_stacks(high, low, residual, highc, lowc):
    """Every realization's XITD-style stack: valid high rows, valid low
    rows, residual, WPE-sorted ascending (the entropy row of one
    ``walk_stats`` launch over every row); invalid rows sort last (+inf
    sentinel) and hold zeros."""
    rows = torch.cat([high[:, :_MAX_VALID], low[:, :_MAX_VALID],
                      residual[:, None]], dim=1)
    k = torch.arange(rows.shape[1], device=rows.device)
    valid = ((k < highc[:, None])
             | ((k >= _MAX_VALID) & (k < _MAX_VALID + lowc[:, None]))
             | (k == 2 * _MAX_VALID))
    ent = torch.where(valid, walk_stats_cuda(rows)[1], torch.inf)
    order = torch.argsort(ent, dim=1, stable=True)
    rows = torch.take_along_dim(rows, order[..., None], dim=1)
    return torch.where(torch.take_along_dim(valid, order, dim=1)[..., None],
                       rows, 0.0)


def _ensemble_from_bank(bank, wpemax: float = 0.6,
                        capacity: int | None = None) -> EnsembleResult:
    """The ensemble of the realizations ``bank`` (R, n) of one signal."""
    res = meitd_jit_bank(bank, wpemax, capacity=capacity)
    with span("pyitd.ensemble_select"):
        stacks = _sorted_stacks(res.high, res.low, res.residual,
                                res.high_count, res.low_count)
        # median selection over each realization's DENOISED reconstruction
        # (the accepted components; the residual trend — which sorts
        # somewhere inside the WPE-ordered stack — is excluded by
        # subtracting it from the realization): the object the noise
        # perturbs and the fingerprint machinery ranks
        idx, completeness = sorted_median_index(
            fingerprint_rows(bank - res.residual))
    return EnsembleResult(
        stacks=stacks,
        mean_stack=stacks.mean(0),
        selected=stacks[idx],
        selected_index=idx,
        completeness=completeness,
        num_components=res.high_count + res.low_count + 1,
    )


@spanned("pyitd.ensemble")
def meitd_ensemble(data, generator: torch.Generator | None = None,
                   n_realizations: int = 32,
                   noise_scale: float | torch.Tensor | None = None,
                   wpemax: float = 0.6, *, capacity: int | None = None,
                   device="cuda") -> EnsembleResult:
    """Noise-assisted ensemble MEITD of a single signal.

    ``n_realizations`` must be even: realizations come in ``(x + v,
    x - v)`` pairs (siftED2D's paired-noise construction), ``v`` drawn by
    ``torch.randn`` from ``generator`` (on the signal's device).
    ``noise_scale`` defaults to the reference's MAD of the signal
    (``scipy.stats.median_abs_deviation`` semantics, siftED2D cell 1).  A
    tensor stays on its device; anything else goes to ``device``.
    """
    if n_realizations % 2:
        raise ValueError("n_realizations must be even (paired +-noise)")
    x = as_input(data, torch.float64, device)
    if noise_scale is None:
        noise_scale = median((x - median(x)).abs())
    v = noise_scale * torch.randn((n_realizations // 2, x.shape[-1]),
                                  generator=generator, device=x.device,
                                  dtype=x.dtype)
    bank = torch.cat([x[None] + v, x[None] - v], dim=0)
    return _ensemble_from_bank(bank, wpemax, capacity)
