"""Plain PyTorch reference of the canonical ITD sift, vectorised over rows.

Written from the upstream semantics (``itd_oracle.py`` holds them as a
sequential loop); it imports nothing of the program under test.  One level
of a row ``x`` of ``n`` samples:

* knots: 0, every interior extremum (plateau-rightmost rule: ``x[i] -
  x[i-1] <= 0 < x[i+1] - x[i]`` or ``x[i] - x[i-1] >= 0 > x[i+1] - x[i]``),
  and ``n - 1``;
* knot values: ``0.5 * (x[0] + x[1])`` and ``0.5 * (x[n-2] + x[n-1])`` at
  the ends; inside, with neighbour knots ``l < k < r``,
  ``0.5 * (x[l] + w * (x[r] - x[l])) + 0.5 * x[k]``, ``w = (k - l) / (r - l)``;
* baseline between knots ``a < b``: ``B[a] + s * (x[t] - x[a])``, ``s =
  (B[b] - B[a]) / (x[b] - x[a])`` (0 where the denominator is 0); the last
  sample's baseline is 0;
* rotation ``x - baseline``.

The sift (``max_iteration + 2`` output rows per signal): while the baseline
has two extrema or more and the level budget lasts, emit the rotation and
descend into the baseline; stop A (fewer than 2) emits the previous
baseline, stop B (trip ``max_iteration + 1``) emits rotation + baseline.
Rows past a signal's stop are zero.  ``correction`` sums the exact rounding
residual of every emitted subtraction (and of stop B's addition), so the
rows plus the correction rebuild the input.

Every operation runs in the dtype of the input, so the same code computed
in bfloat16 is the control of the benchmark's comparison.  Differentiable
through autograd.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

STOP_FLAT = 1
STOP_BUDGET = 2


class Sift(NamedTuple):
    rotations: torch.Tensor       # (levels, rows, n)
    num_components: torch.Tensor  # (rows,) int32
    stop_reason: torch.Tensor     # (rows,) int32
    correction: torch.Tensor      # (rows, n)


def two_sum_err(a, b, s):
    """Exact residual ``a + b - s`` of ``s = fl(a + b)`` (Knuth)."""
    bb = s - a
    return (a - (s - bb)) + (b - bb)


def extrema(x):
    """Interior extrema of each row (bool, same shape as ``x``)."""
    db = x[:, 1:-1] - x[:, :-2]
    df = x[:, 2:] - x[:, 1:-1]
    inner = ((db <= 0) & (df > 0)) | ((db >= 0) & (df < 0))
    edge = torch.zeros_like(inner[:, :1])
    return torch.cat([edge, inner, edge], dim=1)


def extract(x):
    """One level: ``(rotation, baseline)`` of each row of ``x``."""
    rows, n = x.shape
    idx = torch.arange(n, device=x.device).expand(rows, n)
    knot = extrema(x)
    knot[:, 0] = True
    knot[:, -1] = True
    # the knot at or before each sample, and the knot after it
    at_or_before = torch.where(knot, idx, -1).cummax(dim=1).values
    at_or_after = torch.where(knot, idx, n).flip(1).cummin(dim=1).values.flip(1)
    before = torch.cat([at_or_before[:, :1], at_or_before[:, :-1]], dim=1)
    after = torch.cat([at_or_after[:, 1:], at_or_after[:, -1:]], dim=1)
    before = before.clamp(min=0)
    after = after.clamp(max=n - 1)

    xl, xr = x.gather(1, before), x.gather(1, after)
    span = (after - before).to(x.dtype)
    w = (idx - before).to(x.dtype) / torch.where(span == 0, 1, span)
    kval = 0.5 * (xl + w * (xr - xl)) + 0.5 * x
    kval = torch.cat([0.5 * (x[:, :1] + x[:, 1:2]), kval[:, 1:-1],
                      0.5 * (x[:, -2:-1] + x[:, -1:])], dim=1)

    bl, br = kval.gather(1, at_or_before), kval.gather(1, after)
    xa, xb = x.gather(1, at_or_before), xr
    den = xb - xa
    flat = den == 0
    slope = torch.where(flat, 0, (br - bl) / torch.where(flat, 1, den))
    baseline = bl + slope * (x - xa)
    baseline = torch.cat([baseline[:, :-1], torch.zeros_like(baseline[:, :1])],
                         dim=1)
    return x - baseline, baseline


def sift(x: torch.Tensor, max_iteration: int) -> Sift:
    """The sift of each row of ``x`` (rows, n), in ``x``'s dtype."""
    levels = max_iteration + 2
    rows = x.shape[0]
    rot, base = extract(x)
    err = two_sum_err(x, -base, rot)
    zero = torch.zeros_like(x)
    prev_base, comp = zero, zero
    done = torch.zeros(rows, dtype=torch.bool, device=x.device)
    ncomp = torch.zeros(rows, dtype=torch.int32, device=x.device)
    reason = torch.zeros_like(ncomp)
    out = []
    for i in range(levels):
        nex = extrema(base).sum(dim=1)
        stop_a = ~done & (nex < 2)
        stop_b = ~done & ~stop_a & (i >= max_iteration + 1)
        cont = ~done & ~stop_a & ~stop_b
        res = rot + base
        row = torch.where(stop_a[:, None], prev_base,
                          torch.where(stop_b[:, None], res,
                                      torch.where(cont[:, None], rot, zero)))
        out.append(row)
        comp = comp + torch.where((cont | stop_b)[:, None], err, zero) \
            + torch.where(stop_b[:, None], two_sum_err(rot, base, res), zero)
        stopping = stop_a | stop_b
        ncomp = torch.where(stopping, i + 1, ncomp)
        reason = torch.where(stop_a, STOP_FLAT,
                             torch.where(stop_b, STOP_BUDGET, reason))
        done = done | stopping
        if i + 1 < levels:
            prev_base = base
            rot, base = extract(base)
            err = two_sum_err(prev_base, -base, rot)
    return Sift(torch.stack(out), ncomp.to(torch.int32),
                reason.to(torch.int32), comp)


def sift_loss(s: Sift, weights: dict) -> torch.Tensor:
    """The gradient traffic's loss: ``rot_sq`` times the squared rows
    summed, plus ``correction`` times the summed correction."""
    return weights["rot_sq"] * (s.rotations ** 2).sum() \
        + weights["correction"] * s.correction.sum()
