"""Tridiagonal solvers and cubic-spline moment systems on padded knot
buffers — port of ``pyitd_tpu/ops/tridiag.py``.

All work on the last axis and broadcast over leading batch axes, on
fixed-capacity knot buffers with a per-row ``count``; lanes at or beyond
``count`` are inert.

* :func:`reference_spline_moments` — the reference native tier's moment
  recurrence (not an exact Thomas elimination), for the template tier;
* :func:`thomas_solve` — exact Thomas elimination, a Python loop over the
  knot axis: the shape for small capacities on the CPU;
* :func:`pcr_solve` — parallel cyclic reduction: ``log2(cap)`` rounds of
  whole-vector ops, the shape for large capacities and for the GPU;
* :func:`spline_moments` — second derivatives (moments) of the
  interpolating cubic with ``natural`` or ``not-a-knot`` ends (scipy's
  ``splrep(k=3, s=0)``); picks Thomas or PCR by capacity and device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["reference_spline_moments", "thomas_solve", "pcr_solve",
           "spline_moments"]

# above this capacity the sequential Thomas loop loses to log-depth PCR on
# the CPU; on a GPU a loop of cap dependent steps is cap launches, so PCR
# is preferred at any capacity (JAX prefers it on the TPU for the same
# reason)
_PCR_MIN_CAP = 1024

# truncation depth of reference_spline_moments' "banded" method: a 2^6 =
# 64-knot exact window (see _affine_scan_banded)
_BANDED_ROUNDS = 6


def _prefer_pcr(cap: int, ref: torch.Tensor) -> bool:
    return cap >= _PCR_MIN_CAP or ref.is_cuda


def _safe_div(a, b):
    return a / torch.where(b == 0, torch.ones_like(b), b)


def _count(count, ref: torch.Tensor) -> torch.Tensor:
    """``count`` as an int tensor that broadcasts against ``ref``'s last
    axis: (..., 1)."""
    cnt = torch.as_tensor(count, device=ref.device)
    return cnt[..., None] if cnt.dim() == ref.dim() - 1 else cnt


def _shift_r(x, s, fill):
    """``out[..., i] = x[..., i - s]``, ``fill`` for ``i < s`` (one
    launch)."""
    return F.pad(x[..., :-s], (s, 0), value=fill)


def _shift_l(x, s, fill):
    """``out[..., i] = x[..., i + s]``, ``fill`` for the last ``s``."""
    return F.pad(x[..., s:], (0, s), value=fill)


def _affine_scan_banded(A, B, rounds: int | None, reverse: bool = False):
    """``c_i = A_i + B_i * c_{i-1}`` (zero initial carry) along the last
    axis by Hillis-Steele doubling of the affine maps, reversed with
    ``reverse``: ``rounds`` doubling steps make every contribution within a
    ``2^rounds``-element window exact; ``None`` runs ``ceil(log2(size))``,
    the whole scan.  Older terms are weighted by products of ``2^rounds``
    consecutive ``B`` factors, which for the spline recurrences (|B| about
    0.5 at uniform spacings) fall below f64 roundoff at 6 rounds."""
    size = A.shape[-1]
    shift = _shift_l if reverse else _shift_r
    c, Bp = A, B
    s = 0
    while (1 << s) < size and (rounds is None or s < rounds):
        sh = 1 << s
        c = c + Bp * shift(c, sh, 0.0)
        Bp = Bp * shift(Bp, sh, 0.0)
        s += 1
    return c


def reference_spline_moments(knots, h, count, method: str = "auto"):
    """Moment vector ``b`` as the reference native tier computes it.

    ``knots[..., c]``: knot values (slot ``count`` takes part: the
    reference reads one slot past the valid range); ``h[..., c]``: the
    spacings ``pos[k+1] - pos[k]``; ``count``: the valid knots, an int or
    a tensor of the batch shape.  The
    forward pass runs over ``1 <= i <= count-1``, the backward pass over
    ``count-2 >= i >= 0``; then ``b[0]`` and ``b[count-1]`` are set to 0.

    ``method``: ``"scan"`` — the sequential recurrence in the reference's
    order of operations, a Python loop over the knot axis (for small
    capacities on the CPU); ``"affine"`` — both passes are affine
    recurrences whose denominators never touch the carry, so they run as
    log-depth doubling of the affine maps (reassociation roundoff only);
    ``"banded"`` — the same doubling cut to ``_BANDED_ROUNDS`` rounds (the
    recurrence's propagator decays exponentially); ``"auto"`` —
    ``"affine"`` on a CUDA tensor and ``"scan"`` elsewhere (JAX keys the
    same choice on the TPU backend).
    """
    if method == "auto":
        method = "affine" if knots.is_cuda else "scan"
    if method not in ("scan", "affine", "banded"):
        raise ValueError(f"unknown method: {method!r}")
    idx = torch.arange(knots.shape[-1], device=knots.device)
    # a Python count stays one: a device scalar built from it would be a
    # host-to-device copy on every call
    cnt = count if isinstance(count, int) else _count(count, knots)

    zero = torch.zeros_like(knots[..., :1])
    h_im1 = torch.cat([torch.zeros_like(h[..., :1]), h[..., :-1]], dim=-1)
    k_ip1 = torch.cat([knots[..., 1:], zero], dim=-1)
    k_im1 = torch.cat([zero, knots[..., :-1]], dim=-1)

    u = _safe_div(h_im1, h_im1 + h)
    v = 1.0 - u
    rhs = 6.0 * _safe_div(
        _safe_div(k_ip1 - knots, h) - _safe_div(knots - k_im1, h_im1),
        h_im1 + h)
    active = (idx >= 1) & (idx < cnt)
    u = torch.where(active, u, torch.zeros_like(u))
    v = torch.where(active, v, torch.zeros_like(v))
    b0 = torch.where(active, rhs, torch.zeros_like(rhs))
    # the forward pass: b[i] = (b[i] - u[i] b[i-1]) / (2 - u[i] v[i-1]),
    # with v un-normalized, as the reference has it
    v_im1 = torch.cat([torch.zeros_like(v[..., :1]), v[..., :-1]], dim=-1)
    act_bwd = idx <= cnt - 2

    if method != "scan":
        rounds = _BANDED_ROUNDS if method == "banded" else None
        # forward carry: active c' = b0/d + (-u/d) c; inactive c' = c
        d = 2.0 - u * v_im1
        A = torch.where(active, _safe_div(b0, d), torch.zeros_like(b0))
        B = torch.where(active, _safe_div(-u, d), torch.ones_like(u))
        b_f = torch.where(active, _affine_scan_banded(A, B, rounds), b0)
        # backward carry (reverse order): active c' = b_f - v c;
        # inactive c' = b_f
        B2 = torch.where(act_bwd, -v, torch.zeros_like(v))
        b = _affine_scan_banded(b_f, B2, rounds, reverse=True)
    else:
        shape = torch.broadcast_shapes(knots.shape, active.shape)
        active = active.expand(shape)
        act_bwd = act_bwd.expand(shape)
        carry = torch.zeros_like(b0[..., 0])
        b_f = []
        for i in range(knots.shape[-1]):
            new = _safe_div(b0[..., i] - u[..., i] * carry,
                            2.0 - u[..., i] * v_im1[..., i])
            out = torch.where(active[..., i], new, b0[..., i])
            carry = torch.where(active[..., i], out, carry)
            b_f.append(out)
        # walk down from the top; inactive steps pass b[i] on as the
        # carry, so the first active step (i = count-2) sees b[count-1]
        carry = torch.zeros_like(carry)
        b = [None] * len(b_f)
        for i in range(len(b_f) - 1, -1, -1):
            carry = torch.where(act_bwd[..., i], b_f[i] - v[..., i] * carry,
                                b_f[i])
            b[i] = carry
        b = torch.stack(b, dim=-1)
    # natural ends
    return torch.where((idx == 0) | (idx == cnt - 1), torch.zeros_like(b), b)


def thomas_solve(lower, diag, upper, rhs, count=None) -> torch.Tensor:
    """Exact Thomas elimination for batched tridiagonal systems.

    Solves ``lower[i]*x[i-1] + diag[i]*x[i] + upper[i]*x[i+1] = rhs[i]`` for
    ``i < count`` (the full capacity if ``count`` is None).  Lanes >= count
    are inert and return 0."""
    cap = diag.shape[-1]
    idx = torch.arange(cap, device=diag.device)
    cnt = (torch.full(diag.shape[:-1] + (1,), cap, device=diag.device)
           if count is None else _count(count, diag))
    active = (idx < cnt).expand(diag.shape)
    last = (idx == cnt - 1).expand(diag.shape)

    zero = torch.zeros_like(diag[..., 0])
    cp, dp = zero, zero
    cps, dps = [], []
    for i in range(cap):
        a, b, c, d = lower[..., i], diag[..., i], upper[..., i], rhs[..., i]
        denom = b - a * cp
        denom = torch.where(denom == 0, torch.ones_like(denom), denom)
        cp_new = c / denom
        dp_new = (d - a * dp) / denom
        cp = torch.where(active[..., i], cp_new, zero)
        dp = torch.where(active[..., i], dp_new, zero)
        cps.append(cp)
        dps.append(dp)

    carry = zero
    xs = [zero] * cap
    for i in range(cap - 1, -1, -1):
        x_i = dps[i] - cps[i] * carry
        x_i = torch.where(last[..., i], dps[i], x_i)
        x_i = torch.where(active[..., i], x_i, zero)
        carry = torch.where(active[..., i], x_i, carry)
        xs[i] = x_i
    return torch.stack(xs, dim=-1)


def pcr_solve(lower, diag, upper, rhs) -> torch.Tensor:
    """Parallel cyclic reduction for batched tridiagonal systems.

    Inactive lanes must already be identity rows (``lower=upper=rhs=0,
    diag=1``), as :func:`spline_moments` masks them.  Needs diagonal
    dominance for stability; spline moment systems are strictly dominant.
    Each round eliminates the couplings at distance ``2^k``; after
    ``ceil(log2(cap))`` rounds the system is diagonal."""
    cap = diag.shape[-1]
    a, b, c, d = lower, diag, upper, rhs
    steps = max(1, int(cap - 1).bit_length())
    for k in range(steps):
        s = 1 << k
        if s >= cap:
            break
        b_m = _shift_r(b, s, 1.0)
        c_m = _shift_r(c, s, 0.0)
        d_m = _shift_r(d, s, 0.0)
        a_m = _shift_r(a, s, 0.0)
        b_p = _shift_l(b, s, 1.0)
        a_p = _shift_l(a, s, 0.0)
        d_p = _shift_l(d, s, 0.0)
        c_p = _shift_l(c, s, 0.0)
        alpha = -_safe_div(a, b_m)
        beta = -_safe_div(c, b_p)
        b = b + alpha * c_m + beta * a_p
        d = d + alpha * d_m + beta * d_p
        a = alpha * a_m
        c = beta * c_p
    return _safe_div(d, b)


def _take(a, idx):
    """``a[..., idx]`` for a (..., 1) index tensor (clipped into range)."""
    idx = idx.clamp(0, a.shape[-1] - 1).expand(a.shape[:-1] + (1,))
    return torch.gather(a, -1, idx.long())


def spline_moments(pos, val, count, *, bc: str = "natural") -> torch.Tensor:
    """Second derivatives M of the cubic interpolant through
    ``(pos[k], val[k])`` for ``k < count``, with the requested boundary
    condition.  Integer ``pos`` is differenced first and cast once (exact at
    any n).

    not-a-knot folds the third-derivative-continuity end rows into the
    interior system by eliminating M[0] and M[count-1]:
    ``M0 = M1 + (h0/h1)(M1 - M2)``, and mirrored at the far end."""
    if bc not in ("natural", "not-a-knot"):
        raise ValueError(bc)
    one = torch.ones_like(val[..., :1])
    if pos.dtype.is_floating_point:
        pos = pos.to(val.dtype)
        h = torch.cat([pos[..., 1:] - pos[..., :-1], one], dim=-1)
    else:
        h = torch.cat([(pos[..., 1:] - pos[..., :-1]).to(val.dtype), one],
                      dim=-1)
    idx = torch.arange(val.shape[-1], device=val.device)
    cnt = _count(count, val)

    h = torch.where(idx < cnt - 1, h, torch.ones_like(h))  # padded spacings
    h_im1 = torch.cat([one, h[..., :-1]], dim=-1)
    zero = torch.zeros_like(val[..., :1])
    v_ip1 = torch.cat([val[..., 1:], zero], dim=-1)
    v_im1 = torch.cat([zero, val[..., :-1]], dim=-1)
    rhs = 6.0 * (_safe_div(v_ip1 - val, h) - _safe_div(val - v_im1, h_im1))

    lower = h_im1
    diag = 2.0 * (h_im1 + h)
    upper = h
    interior = (idx >= 1) & (idx < cnt - 1)
    solve = pcr_solve if _prefer_pcr(diag.shape[-1], diag) else thomas_solve

    def zeros(a):
        return torch.zeros_like(a)

    if bc == "natural":
        # M[0] = M[count-1] = 0: the plain interior system, without the
        # couplings that reach M[0] and M[count-1]
        lower_s = torch.where(interior, lower, zeros(lower))
        diag_s = torch.where(interior, diag, torch.ones_like(diag))
        upper_s = torch.where(interior, upper, zeros(upper))
        rhs_s = torch.where(interior, rhs, zeros(rhs))
        lower_s = torch.where(idx == 1, zeros(lower_s), lower_s)
        upper_s = torch.where(idx == cnt - 2, zeros(upper_s), upper_s)
        m = solve(lower_s, diag_s, upper_s, rhs_s)
        return torch.where(interior, m, zeros(m))

    h0 = _take(h, torch.zeros_like(cnt))
    h1 = _take(h, torch.ones_like(cnt))
    hl = _take(h, (cnt - 2).clamp(min=0))    # last interval
    hl2 = _take(h, (cnt - 3).clamp(min=0))   # second-to-last

    # row 1: substitute M0; row count-2: substitute M_{count-1}
    diag_s = torch.where(idx == 1, diag + lower * _safe_div(h0 + h1, h1),
                         diag)
    upper_s = torch.where(idx == 1, upper - lower * _safe_div(h0, h1), upper)
    lower_s = torch.where(idx == 1, zeros(lower), lower)
    diag_s = torch.where(idx == cnt - 2,
                         diag_s + upper_s * _safe_div(hl + hl2, hl2), diag_s)
    lower_s = torch.where(idx == cnt - 2,
                          lower_s - upper_s * _safe_div(hl, hl2), lower_s)
    upper_s = torch.where(idx == cnt - 2, zeros(upper_s), upper_s)

    lower_s = torch.where(interior, lower_s, zeros(lower_s))
    diag_s = torch.where(interior, diag_s, torch.ones_like(diag_s))
    upper_s = torch.where(interior, upper_s, zeros(upper_s))
    rhs_s = torch.where(interior, rhs, zeros(rhs))
    m = solve(lower_s, diag_s, upper_s, rhs_s)
    m = torch.where(interior, m, zeros(m))

    m1 = _take(m, torch.ones_like(cnt))
    m2 = _take(m, 2 * torch.ones_like(cnt))
    m0 = m1 + _safe_div(h0, h1) * (m1 - m2)
    ml1 = _take(m, (cnt - 2).clamp(min=0))
    ml2 = _take(m, (cnt - 3).clamp(min=0))
    ml = ml1 + _safe_div(hl, hl2) * (ml1 - ml2)
    m = torch.where(idx == 0, m0, m)
    return torch.where(idx == cnt - 1, ml, m)
