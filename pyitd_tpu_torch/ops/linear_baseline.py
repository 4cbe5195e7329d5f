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


def _structural_fills(x, knots, use_kernels):
    """The adjoint's five primitives: the forward and strictly-after
    knot-structure fills, the direct segment sums, and the reads of a
    knot-sited value at the next / previous knot.  ``use_kernels``: the
    fill2 and segsum kernels of ``ops/cuda_fill.py`` (JAX's ``"pallas"``
    route); otherwise cumulative-sum differences read back through the
    plain fills of ``ops/fill.py`` (JAX's ``"scan"`` route)."""
    n = x.shape[-1]
    it = torch.arange(n, device=x.device).expand(x.shape)

    if use_kernels:
        from .cuda_fill import fill2_cuda, segsum_cuda

        def struct_fwd():
            return fill2_cuda(x, knots)

        def struct_bwd():
            return fill2_cuda(x, knots, reverse=True, strict=True)

        # a segment boundary sits BETWEEN a knot and its neighbor, so the
        # reverse sums reset where the NEXT sample is a knot; a sum that
        # excludes its own sample is the strict sum over the knots
        # themselves (JAX shifts values and flags by one instead)
        f_next = shift_left(knots, False)

        def seg_reads(a_bl, a_xl, a_br, a_xr):
            # segA_*[t] = sum over [t, nextknot(t)), segE_*[t] = sum over
            # [prevknot(t), t)
            seg_a = segsum_cuda((a_bl, a_xl), f_next, reverse=True)
            seg_e = segsum_cuda((a_br, a_xr), knots, strict=True)
            return seg_a + seg_e

        def knot_next(v):
            # v is nonzero only at knots, so the sum over (t, nextknot(t)]
            # is that one value
            return segsum_cuda(v, knots, reverse=True, strict=True)

        def knot_prev(v):
            return segsum_cuda(v, knots, strict=True)

        return struct_fwd, struct_bwd, seg_reads, knot_next, knot_prev

    def struct_fwd():
        (a, b), (c, d), _ = forward_fill2_scan((it, x), knots, (0, 0.0))
        return a, b, c, d

    def struct_bwd():
        (a, b), (c, d), _ = backward_fill2_scan(
            (shift_left(it, 0), shift_left(x, 0.0)), shift_left(knots, False),
            (0, 0.0))
        return a, b, c, d

    def fills_after(vals):
        return backward_fill_scan(tuple(shift_left(v, 0.0) for v in vals),
                                  shift_left(knots, False), (0.0,) * len(vals))

    def fills_before(vals):
        _v1, v2, _ = forward_fill2_scan(vals, knots, (0.0,) * len(vals))
        return v2

    def seg_reads(a_bl, a_xl, a_br, a_xr):
        # exclusive running sums of the four channels, read back at the
        # neighbor knots; one batched cumsum
        c = torch.cumsum(torch.stack([a_bl, a_xl, a_br, a_xr]), dim=-1)
        excl = torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1)
        zs_bl, zs_xl, zs_br, zs_xr = excl
        tot_bl, tot_xl = c[0, ..., -1:], c[1, ..., -1:]
        # running sum at the NEXT knot (strictly after), patched at the
        # last sample (a knot) with the total
        nxt_bl, nxt_xl = fills_after((zs_bl, zs_xl))
        is_last = it == n - 1
        nxt_bl = torch.where(is_last, tot_bl, nxt_bl)
        nxt_xl = torch.where(is_last, tot_xl, nxt_xl)
        # running sum at the PREVIOUS knot (strictly before)
        prv_br, prv_xr = fills_before((zs_br, zs_xr))
        return (nxt_bl - zs_bl, nxt_xl - zs_xl, zs_br - prv_br,
                zs_xr - prv_xr)

    def knot_next(v):
        return fills_after((v,))[0]

    def knot_prev(v):
        return fills_before((v,))[0]

    return struct_fwd, struct_bwd, seg_reads, knot_next, knot_prev


def structural_level_bwd(x: torch.Tensor, g_rot: torch.Tensor,
                         g_base: torch.Tensor, g_err: torch.Tensor,
                         endpoint_mode: str, fills: str = "auto"
                         ) -> torch.Tensor:
    """Adjoint of ``(rotation, baseline, sub_err) = level(x)`` given the
    output cotangents; returns the x cotangent (port of JAX's
    ``_structural_level_bwd``, in its order of operations).

    ``fills`` selects the scan primitives: ``"kernel"`` (the fill2 and
    segsum kernels, f32; on a CPU tensor their plain versions), ``"torch"``
    (cumulative-sum differences read back through plain fills, any device
    and dtype), ``"auto"`` (``"kernel"`` on a CUDA f32 tensor, ``"torch"``
    elsewhere).  The two routes agree to segment-sum rounding, not bitwise:
    the kernels sum each segment directly, the torch route differences
    running sums of the whole row."""
    if endpoint_mode not in ENDPOINT_MODES:
        raise ValueError(f"unknown endpoint_mode: {endpoint_mode!r}")
    if fills == "auto":
        fills = "kernel" if (x.is_cuda and x.dtype == torch.float32) \
            else "torch"
    if fills == "torch":
        return _structural_level_bwd_impl(x, g_rot, g_base, g_err,
                                          endpoint_mode, False)
    if fills != "kernel":
        raise ValueError(f"unknown fills: {fills!r}")
    check_kernel_input(x)
    n = x.shape[-1]

    def flat(a):  # the kernels take (rows, n); everything below is batched
        return a.reshape(-1, n).contiguous()

    gx = _structural_level_bwd_impl(flat(x), flat(g_rot), flat(g_base),
                                    flat(g_err), endpoint_mode, True)
    return gx.reshape(x.shape)


def _structural_level_bwd_impl(x, g_rot, g_base, g_err, endpoint_mode,
                               use_kernels):
    n = x.shape[-1]
    it = torch.arange(n, device=x.device).expand(x.shape)
    knots = knot_mask(x)
    struct_fwd, struct_bwd, seg_reads, knot_next, knot_prev = \
        _structural_fills(x, knots, use_kernels)

    # per-sample knot structure, the forward's fill channels
    p1p, p1x, p2p, p2x = struct_fwd()
    n1p, n1x, n2p, n2x = struct_bwd()

    b_first = (0.5 * (x[..., 0] + x[..., 1]))[..., None]
    b_last = (0.5 * (x[..., n - 2] + x[..., n - 1]))[..., None]
    bl = torch.where(p1p == 0, b_first,
                     knot_value(p1p, p1x, p2p, p2x, n1p, n1x))
    bl = torch.where(p1p == n - 1, b_last, bl)
    br = torch.where(n1p == n - 1, b_last,
                     knot_value(n1p, n1x, p1p, p1x, n2p, n2x))

    xl, xr = p1x, n1x
    d = xr - xl
    dz = d == 0
    safe = torch.where(dz, torch.ones_like(d), d)
    zero = torch.zeros_like(d)
    s = torch.where(dz, zero, (br - bl) / safe)

    # err's coefficients are exactly (+x, -rot, -baseline)
    geff_rot = g_rot - g_err
    geff_base = g_base - g_err
    g_b = geff_base - geff_rot
    if endpoint_mode == "reference":
        g_b = torch.where(it == n - 1, torch.zeros_like(g_b), g_b)

    q = torch.where(dz, zero, (x - xl) / safe)
    coef = torch.where(dz, zero, (br - bl) / (safe * safe))
    a_bl = g_b * torch.where(dz, torch.ones_like(q), 1.0 - q)
    a_br = g_b * q
    a_xl = g_b * coef * (x - xr)
    a_xr = -g_b * coef * (x - xl)

    gx = geff_rot + g_err + g_b * s  # direct dB/dx[t] = slope

    # Non-finite terms (only inside a NaN quarantine zone, where the
    # gradient is undefined anyway) are dropped: a running sum would carry
    # one NaN into every position after it, where autograd keeps it to the
    # samples involved.  The direct per-sample terms keep their NaNs.
    a_bl, a_xl, a_br, a_xr = (torch.where(torch.isfinite(z), z, 0.0)
                              for z in (a_bl, a_xl, a_br, a_xr))

    # segment sums landing on knot sites: over [t, nextknot) for the *_l
    # channels, over [prevknot, t) for the *_r
    seg_a_bl, seg_a_xl, seg_e_br, seg_e_xr = seg_reads(a_bl, a_xl, a_br,
                                                       a_xr)
    gkv = torch.where(knots, seg_a_bl + seg_e_br, 0.0)
    gx = gx + torch.where(knots, seg_a_xl + seg_e_xr, 0.0)

    # knot-value adjoint.  Interior knots: kv = 0.5*(x[pe] + w*(x[nx] -
    # x[pe])) + 0.5*x[t]; at a knot site pe = p2p, nx = n1p.
    span = (n1p - p2p).to(x.dtype)
    w = (it - p2p).to(x.dtype) / torch.where(span == 0,
                                             torch.ones_like(span), span)
    interior = knots & (it != 0) & (it != n - 1)
    gkv_int = torch.where(interior, gkv, torch.zeros_like(gkv))
    gx = gx + 0.5 * gkv_int

    # pushes: x[pe(k)] += c_p(k); x[nx(k)] += c_n(k).  Every knot is the
    # exclusive-previous of exactly its next knot (and vice versa), so the
    # receive is one strictly-after / strictly-before read
    c_p = gkv_int * (0.5 * (1.0 - w))
    c_n = gkv_int * (0.5 * w)
    gx = gx + torch.where(knots, knot_next(c_p) + knot_prev(c_n), 0.0)

    # end knots: kv[0] = 0.5*(x[0]+x[1]); kv[n-1] = 0.5*(x[n-2]+x[n-1])
    g0 = 0.5 * gkv[..., 0]
    gl = 0.5 * gkv[..., n - 1]
    for i, g in ((0, g0), (1, g0), (n - 2, gl), (n - 1, gl)):
        gx[..., i] += g
    return gx


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
    kernel level's adjoint runs the fill2 and segsum kernels, the torch
    level's the plain fills).  ``num_extrema`` is not differentiable."""
    if backend == "auto":
        backend = "kernel" if x.is_cuda else "torch"
    return LinearBaselineResult(*_StructuralLevel.apply(
        x, endpoint_mode, backend))
