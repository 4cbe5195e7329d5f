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
from .fill import (backward_fill2_scan, backward_fill_scan,
                   forward_fill2_scan, next_index, prev_index, shift_left,
                   take_last_axis)
from ..utils.spans import spanned

__all__ = ["linear_baseline_extract", "LinearBaselineResult", "two_sum_err",
           "knot_mask", "knot_mask_at", "structural_level_bwd",
           "linear_baseline_extract_structural"]

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


def knot_mask_at(x: torch.Tensor, halo_l: torch.Tensor, halo_r: torch.Tensor,
                 gpos: torch.Tensor, n_global: int) -> torch.Tensor:
    """:func:`knot_mask` of rows that are pieces of a signal of ``n_global``
    samples (``pyitd_tpu/parallel/sharded.py:180-197``): ``gpos`` holds each
    sample's position in the signal, ``halo_l`` / ``halo_r`` (one per row)
    the samples just before and after the piece.  A sample at or past
    ``n_global`` is padding and never a knot."""
    inf = torch.full_like(x, float("inf"))
    x_m1 = torch.cat([halo_l[..., None], x[..., :-1]], dim=-1)
    x_p1 = torch.cat([x[..., 1:], halo_r[..., None]], dim=-1)
    dxb, dxf = x - x_m1, x_p1 - x
    dxb = torch.where(torch.isnan(dxb), inf, dxb)
    dxf = torch.where(torch.isnan(dxf), inf, dxf)
    interior = (gpos > 0) & (gpos < n_global - 1)
    near_nan = torch.isnan(x) | torch.isnan(x_m1) | torch.isnan(x_p1)
    extrema = (((dxb <= 0) & (dxf > 0)) | ((dxb >= 0) & (dxf < 0))) \
        & interior & ~near_nan
    return extrema | (gpos == 0) | (gpos == n_global - 1)


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
    """Refuse what the kernel route does not take: it is f32-only."""
    if x.dtype != torch.float32:
        raise ValueError(
            f"the kernel route is f32-only (got {x.dtype}); cast the input "
            "or pass backend='torch' to keep the input dtype")


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
        if x.requires_grad and torch.is_grad_enabled():
            # as JAX's pallas level, the kernel level has no AD of its own
            raise NotImplementedError(
                "the kernel level has no backward of its own; use "
                "linear_baseline_extract_structural for a differentiable "
                "level on the kernels, or backend='torch'")
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


# ---------------------------------------------------------------------------
# structural adjoint: a hand-written backward for one level — port of
# pyitd_tpu/ops/linear_baseline.py:296-583.  The level is linear in x
# except the segment-slope quotient, so its exact adjoint is per-sample
# cotangent products, segment sums into the knot sites and the Frei-Osorio
# knot-value coefficients pushed to the knot neighbors: O(n), with no
# differentiation of the fills.  The knot structure (masks, positions) is
# constant in x almost everywhere and treated as such, as autograd of the
# gather form treats it.
# ---------------------------------------------------------------------------


def _structural_fills(x, knots):
    """The torch route's scans: the forward and strictly-after
    knot-structure fills, and the direct segment sums as cumulative-sum
    differences read back through the plain fills of ``ops/fill.py``
    (JAX's ``"scan"`` route)."""
    n = x.shape[-1]
    it = torch.arange(n, device=x.device).expand(x.shape)

    def struct_fwd():
        (a, b), (c, d), _ = forward_fill2_scan((it, x), knots, (0, 0.0))
        return a, b, c, d

    def struct_bwd():
        (a, b), (c, d), _ = backward_fill2_scan(
            (shift_left(it, 0), shift_left(x, 0.0)), shift_left(knots, False),
            (0, 0.0))
        return a, b, c, d

    def seg_reads(a_bl, a_xl, a_br, a_xr):
        # exclusive running sums of the four channels, read back at the
        # neighbor knots; one batched cumsum
        c = torch.cumsum(torch.stack([a_bl, a_xl, a_br, a_xr]), dim=-1)
        excl = torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1)
        zs_bl, zs_xl, zs_br, zs_xr = excl
        tot_bl, tot_xl = c[0, ..., -1:], c[1, ..., -1:]
        # running sum at the NEXT knot (strictly after), patched at the
        # last sample (a knot) with the total
        nxt_bl, nxt_xl = backward_fill_scan(
            (shift_left(zs_bl, 0.0), shift_left(zs_xl, 0.0)),
            shift_left(knots, False), (0.0, 0.0))
        is_last = it == n - 1
        nxt_bl = torch.where(is_last, tot_bl, nxt_bl)
        nxt_xl = torch.where(is_last, tot_xl, nxt_xl)
        # running sum at the PREVIOUS knot (strictly before)
        _v1, (prv_br, prv_xr), _ = forward_fill2_scan((zs_br, zs_xr), knots,
                                                      (0.0, 0.0))
        return ((nxt_bl - zs_bl, nxt_xl - zs_xl),
                (zs_br - prv_br, zs_xr - prv_xr))

    return struct_fwd, struct_bwd, seg_reads


def structural_level_bwd(x: torch.Tensor, g_rot: torch.Tensor,
                         g_base: torch.Tensor, g_err: torch.Tensor,
                         endpoint_mode: str, fills: str = "auto"
                         ) -> torch.Tensor:
    """Adjoint of ``(rotation, baseline, sub_err) = level(x)`` given the
    output cotangents; returns the x cotangent (port of JAX's
    ``_structural_level_bwd``, in its order of operations).

    ``fills`` selects the route: ``"kernel"`` (the adjoint's kernels
    around the fill2 and segsum kernels, f32; on a CPU tensor their plain
    versions), ``"torch"`` (cumulative-sum differences read back through
    plain fills, any device and dtype), ``"auto"`` (``"kernel"`` on a CUDA
    f32 tensor, ``"torch"`` elsewhere).  The two routes agree to segment-sum rounding, not bitwise:
    the kernels sum each segment directly, the torch route differences
    running sums of the whole row."""
    if endpoint_mode not in ENDPOINT_MODES:
        raise ValueError(f"unknown endpoint_mode: {endpoint_mode!r}")
    if fills == "auto":
        fills = "kernel" if (x.is_cuda and x.dtype == torch.float32) \
            else "torch"
    if fills == "torch":
        return _structural_level_bwd_impl(x, g_rot, g_base, g_err,
                                          endpoint_mode)
    if fills != "kernel":
        raise ValueError(f"unknown fills: {fills!r}")
    check_kernel_input(x)
    n = x.shape[-1]

    def flat(a):  # the kernels take (rows, n)
        return a.reshape(-1, n).contiguous()

    gx = _structural_level_bwd_kernels(flat(x), flat(g_rot), flat(g_base),
                                       flat(g_err), endpoint_mode)
    return gx.reshape(x.shape)


def _structural_level_bwd_kernels(x, g_rot, g_base, g_err, endpoint_mode,
                                  trip=None):
    """The kernel route (JAX's ``"pallas"`` route): seven launches of the
    kernels of ``ops/cuda_fill.py`` (on a CPU tensor their plain versions).
    The fills give each sample its segment's knots, ``bwd_pre`` the
    cotangent channels, the segment sums land them on the knot sites
    (``seg_a`` over ``[t, nextknot)``: the reverse sums reset where the NEXT
    sample is a knot; ``seg_e`` over ``[prevknot, t)``: strict sums over the
    knots), and ``bwd_post`` the gradient.  With ``trip`` (a
    ``cuda_fill.TripCotangents``) the cotangents are the kernel sift's and
    ``bwd_pre`` forms the level's own (``decomp/itd.py::_KernelSift``)."""
    from . import cuda_fill as cf

    knots, f_next = cf.bwd_knots_cuda(x)
    fwd = cf.fill2_cuda(x, knots)
    bwd = cf.fill2_cuda(x, knots, reverse=True, strict=True)
    a_bl, a_xl, a_br, a_xr, gx = cf.bwd_pre_cuda(x, g_rot, g_base, g_err,
                                                 fwd, bwd, endpoint_mode,
                                                 trip=trip)
    seg_a = cf.segsum_cuda((a_bl, a_xl), f_next, reverse=True)
    seg_e = cf.segsum_cuda((a_br, a_xr), knots, strict=True)
    return cf.bwd_post_cuda(knots, gx, seg_a, seg_e, fwd[2], bwd[0])


def _structural_level_bwd_impl(x, g_rot, g_base, g_err, endpoint_mode):
    """The torch route: the plain versions of the adjoint kernels
    (``cuda_fill.bwd_pre``, ``cuda_fill.bwd_post``) around the plain fills
    and the cumulative-sum segment sums; any device, dtype and batch
    shape."""
    from . import cuda_fill as cf

    knots = knot_mask(x)
    struct_fwd, struct_bwd, seg_reads = _structural_fills(x, knots)
    fwd, bwd = struct_fwd(), struct_bwd()
    a_bl, a_xl, a_br, a_xr, gx = cf.bwd_pre(x, g_rot, g_base, g_err, fwd,
                                            bwd, endpoint_mode)
    seg_a, seg_e = seg_reads(a_bl, a_xl, a_br, a_xr)
    return cf.bwd_post(knots, gx, seg_a, seg_e, fwd[2], bwd[0])


class _StructuralLevel(torch.autograd.Function):
    """One level whose backward is :func:`structural_level_bwd` (the
    forward may run the kernels, which are never differentiated)."""

    @staticmethod
    def forward(ctx, x, endpoint_mode, backend):
        r = linear_baseline_extract(x.detach(), endpoint_mode=endpoint_mode,
                                    backend=backend)
        ctx.save_for_backward(x)
        ctx.endpoint_mode, ctx.backend = endpoint_mode, backend
        ctx.mark_non_differentiable(r.num_extrema)
        ctx.set_materialize_grads(False)
        return tuple(r)

    @staticmethod
    @spanned("pyitd.level_bwd")
    def backward(ctx, g_rot, g_base, _g_nex, g_err):
        (x,) = ctx.saved_tensors

        def z(g):
            return torch.zeros_like(x) if g is None else g

        gx = structural_level_bwd(x, z(g_rot), z(g_base), z(g_err),
                                  ctx.endpoint_mode, fills=ctx.backend)
        return gx, None, None


def linear_baseline_extract_structural(
        x: torch.Tensor, *, endpoint_mode: str = "reference",
        backend: str = "auto") -> LinearBaselineResult:
    """:func:`linear_baseline_extract` with the structural backward: the
    forward runs ``backend`` (the kernels included) without autograd, the
    backward is :func:`structural_level_bwd` on the same route (the
    kernel level's adjoint runs the adjoint, fill2 and segsum kernels, the
    torch level's the plain fills).  ``num_extrema`` is not differentiable."""
    if backend == "auto":
        backend = "kernel" if x.is_cuda else "torch"
    return LinearBaselineResult(*_StructuralLevel.apply(
        x, endpoint_mode, backend))
