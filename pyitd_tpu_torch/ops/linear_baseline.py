"""Canonical ITD baseline extraction, linear-in-value tier — port of
``pyitd_tpu/ops/linear_baseline.py:63-281``.

* knot set = {0} ∪ interior extrema ∪ {N-1};
* end knots: ``B_first = mean(x[:2])``, ``B_last = mean(x[-2:])``;
* interior knots use the Frei-Osorio formula with α = 0.5::

      B_k = α·(x[τ_{k-1}] + (τ_k − τ_{k-1})/(τ_{k+1} − τ_{k-1})
                 · (x[τ_{k+1}] − x[τ_{k-1}]))  +  α·x[τ_k]

* between knots the baseline is linear in the signal's value::

      B[t] = B_k + (B_{k+1} − B_k)/(x[τ_{k+1}] − x[τ_k]) · (x[t] − x[τ_k])

* ``endpoint_mode="reference"`` keeps the reference's quirk ``B[N-1] == 0``;
  ``"natural"`` evaluates the last segment's formula at N-1;
* equal adjacent knot values give a flat segment (slope 0), not a division
  by zero.

Backends:

* ``"torch"`` — the plain form: cummax knot indices and per-sample gathers,
  with the operations in the order of the JAX ``gather`` backend.  Any
  device, any float dtype, differentiable through autograd.
* ``"kernel"`` — the level kernel of ``ops/cuda_fill.py`` with the sift
  bookkeeping compiled out (the port of ``linear_level_pallas``).  f32 only.
  On a CPU tensor the wrappers run their plain versions.
* ``"auto"`` — ``"kernel"`` on a CUDA tensor, ``"torch"`` elsewhere.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .extrema import count_extrema, extrema_mask
from .fill import next_index, prev_index, take_last_axis

__all__ = ["linear_baseline_extract", "LinearBaselineResult", "two_sum_err",
           "knot_mask"]

ENDPOINT_MODES = ("reference", "natural")


class LinearBaselineResult(NamedTuple):
    rotation: torch.Tensor
    baseline: torch.Tensor
    num_extrema: torch.Tensor  # interior extrema count (int32), per batch elem
    sub_err: torch.Tensor      # exact residual of rotation = fl(x - baseline)


def two_sum_err(a: torch.Tensor, b: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """Exact rounding residual of ``s = fl(a + b)`` (Knuth two-sum,
    branchless).  Only adds and subtracts, so no contraction can touch it."""
    bb = s - a
    return (a - (s - bb)) + (b - bb)


def knot_mask(x: torch.Tensor) -> torch.Tensor:
    """Extrema mask plus both endpoints."""
    n = x.shape[-1]
    it = torch.arange(n, device=x.device)
    return extrema_mask(x) | (it == 0) | (it == n - 1)


def knot_value(kpos, kval, lpos, lval, rpos, rval):
    """Frei-Osorio value of the knot at ``kpos`` from its neighbor knots.

    Positions are integer tensors: the differences are taken first (exact
    at any n) and cast once."""
    span = (rpos - lpos).to(kval.dtype)
    w = (kpos - lpos).to(kval.dtype) / torch.where(
        span == 0, torch.ones_like(span), span)
    return 0.5 * (lval + w * (rval - lval)) + 0.5 * kval


def interp(x, it, n, b_l, x_l, b_r, x_r, endpoint_mode):
    """Linear-in-value interpolation between the knots around each sample."""
    den = x_r - x_l
    flat = den == 0
    slope = torch.where(
        flat, torch.zeros_like(den),
        (b_r - b_l) / torch.where(flat, torch.ones_like(den), den))
    baseline = b_l + slope * (x - x_l)
    if endpoint_mode == "reference":
        baseline = torch.where(it == n - 1, torch.zeros_like(baseline),
                               baseline)
    return baseline


def _knot_values(x, it, n, prev_x, next_x, prev_pos, next_pos):
    knot_val = knot_value(it, x, prev_pos, prev_x, next_pos, next_x)
    b_first = 0.5 * (x[..., 0] + x[..., 1])
    b_last = 0.5 * (x[..., n - 2] + x[..., n - 1])
    knot_val = torch.where(it == 0, b_first[..., None], knot_val)
    return torch.where(it == n - 1, b_last[..., None], knot_val)


def _baseline_gather(x, knots, it, n, endpoint_mode):
    prev_excl = prev_index(knots, inclusive=False)
    next_excl = next_index(knots, inclusive=False)
    knot_val = _knot_values(
        x, it, n,
        take_last_axis(x, prev_excl), take_last_axis(x, next_excl),
        prev_excl, next_excl,
    )
    seg_l = prev_index(knots, inclusive=True)
    seg_r = next_excl
    return interp(
        x, it, n,
        take_last_axis(knot_val, seg_l), take_last_axis(x, seg_l),
        take_last_axis(knot_val, seg_r), take_last_axis(x, seg_r),
        endpoint_mode,
    )


def check_kernel_input(x: torch.Tensor) -> None:
    """Refuse what the kernel route does not take: it is f32-only and has
    no backward yet."""
    if x.dtype != torch.float32:
        raise ValueError(
            f"the kernel route is f32-only (got {x.dtype}); cast the input "
            "or pass backend='torch' to keep the input dtype")
    if x.requires_grad:
        raise NotImplementedError(
            "the kernel route has no backward yet: the structural backward "
            "(kernels K3/K4, ROADMAP queue 1 item 4) lands later; pass "
            "backend='torch' for a differentiable sift")


def linear_baseline_extract(x: torch.Tensor, *,
                            endpoint_mode: str = "reference",
                            backend: str = "auto") -> LinearBaselineResult:
    """One level of canonical ITD: returns (rotation, baseline, num_extrema,
    sub_err) — sub_err is the exact rounding residual of the rotation,
    consumed by the sift's compensated reconstruction."""
    if endpoint_mode not in ENDPOINT_MODES:
        raise ValueError(f"unknown endpoint_mode: {endpoint_mode!r}")
    n = x.shape[-1]
    if n < 2:
        raise ValueError(f"a signal needs at least 2 samples (got n={n})")
    if backend == "auto":
        backend = "kernel" if x.is_cuda else "torch"
    if backend == "kernel":
        check_kernel_input(x)
        from . import cuda_fill

        lead = x.shape[:-1]
        x2 = x.reshape(-1, n).contiguous()
        states = cuda_fill.level_states_cuda(x2)
        lvl = cuda_fill.sift_level_cuda(x2, states,
                                        endpoint_mode=endpoint_mode)
        return LinearBaselineResult(
            rotation=lvl.rotation.reshape(x.shape),
            baseline=lvl.baseline.reshape(x.shape),
            num_extrema=states.nex.reshape(lead),
            sub_err=lvl.sub_err.reshape(x.shape),
        )
    if backend != "torch":
        raise ValueError(f"unknown backend: {backend!r}")

    it = torch.arange(n, device=x.device).expand(x.shape)
    baseline = _baseline_gather(x, knot_mask(x), it, n, endpoint_mode)
    rotation = x - baseline
    return LinearBaselineResult(
        rotation=rotation, baseline=baseline, num_extrema=count_extrema(x),
        sub_err=two_sum_err(x, -baseline, rotation),
    )
