"""Grid-resident spline-moment solve: chained block-2x2 parallel cyclic
reduction — port of ``pyitd_tpu/ops/chained_pcr.py``.

The cubic tier's tridiagonal moment system lives on the knot axis, but at
noise-driven extrema densities about 2n/3 samples are knots, so this solves
it on the signal grid instead, where every per-knot quantity already lives
after the fills.  Each grid cell ``g`` has two unknowns ``(u_g, w_g)``:

* unmarked cell: ``u_g = u_{g-1}`` and ``w_g = w_{g+1}`` (pass-through
  chain rows);
* marked cell (an interior knot with row ``a M_prev + b M_g + c M_next =
  d``): ``a u_{g-1} + b u_g + c w_{g+1} = d`` and ``w_g = u_g``.

The chains carry the nearest knot's moment across the gaps, so the
block-tridiagonal grid system is exactly the knot-space system, and its
solution is already expanded: ``u_g`` is the moment of the last interior
knot at or before ``g``, ``w_g`` of the next at or after it.  Sparsity
survives PCR and leaves 6 matrix channels: ``A = [[al,0],[0,0]]``, ``B =
[[b11,b12],[b21,1]]``, ``C = [[0,cg],[0,cw]]``.

:func:`shard_spike_factors` solves one contiguous block with its two
boundary couplings moved to extra right-hand sides (the SPIKE local
factorization, by PCR over the block's cells), and
:func:`reduced_interface_solve` couples the blocks.  The K7 kernel
(``csrc/spike.cu``, plain version ``ops/cuda_cubic.py::spike_factors``)
computes the same factors by the partition method, coupling its runs with
:func:`interface_pcr`; the tests hold it against
:func:`shard_spike_factors`.
"""
from __future__ import annotations

import torch

from .tridiag import _shift_l, _shift_r

__all__ = ["chained_block_pcr", "shard_spike_factors",
           "reduced_interface_solve", "interface_pcr", "notaknot_rows"]


def _safe_inv(x):
    return torch.reciprocal(torch.where(x == 0, torch.ones_like(x), x))


def _sdiv(num, den):
    return num / torch.where(den == 0, torch.ones_like(den), den)


def notaknot_rows(hl, hr, v_prev, v_mid, v_next, firstrow, lastrow):
    """Not-a-knot tridiagonal row of each interior knot, built elementwise
    on the grid.

    ``hl``/``hr``: distances to the previous/next knot (endpoints
    included); ``v_*``: the Frei-Osorio knot values there;
    ``firstrow``/``lastrow``: masks of the knots next to the endpoints.
    The boundary substitutions go in ``tridiag.spline_moments``' order (row
    1 first; the last row uses the updated upper coefficient, which matters
    when one interior knot gets both).  Returns ``(a, b, c, d)`` with the
    boundary couplings zeroed."""
    a = hl
    b = 2.0 * (hl + hr)
    c = hr
    d = 6.0 * (_sdiv(v_next - v_mid, hr) - _sdiv(v_mid - v_prev, hl))
    b1 = torch.where(firstrow, b + a * _sdiv(hl + hr, hr), b)
    c1 = torch.where(firstrow, c - a * _sdiv(hl, hr), c)
    a1 = torch.where(firstrow, torch.zeros_like(a), a)
    b2 = torch.where(lastrow, b1 + c1 * _sdiv(hr + hl, hl), b1)
    a2 = torch.where(lastrow, a1 - c1 * _sdiv(hr, hl), a1)
    c2 = torch.where(lastrow, torch.zeros_like(c1), c1)
    return a2, b2, c2, d


def _encode(mask, a, b, c, d):
    """Chain-encoded 2x2 block channels: marked cells carry the knot row,
    unmarked cells the pass-through chains (al=-1, B=I, cw=-1)."""
    one = torch.ones_like(b)
    zero = torch.zeros_like(b)
    al = torch.where(mask, a, -one)
    b11 = torch.where(mask, b, one)
    b21 = torch.where(mask, -one, zero)
    cg = torch.where(mask, c, zero)
    cw = torch.where(mask, zero, -one)
    d1 = torch.where(mask, d, zero)
    return al, b11, b21, cg, cw, d1


def _pcr_core(al, b11, b21, cg, cw, rhs_pairs):
    """Block PCR on chain-encoded channels; ``rhs_pairs`` is a list of
    ``(rhs_u, rhs_w)`` sharing the one matrix reduction.  Returns the
    per-cell ``(u, w)`` for every pair."""
    n = al.shape[-1]
    b12 = torch.zeros_like(b11)
    rhs = list(rhs_pairs)

    s = 1
    while s < n:
        # neighbors at distance s; out of range: identity row, zero rhs
        b11m, b12m, b21m = (_shift_r(b11, s, 1.0), _shift_r(b12, s, 0.0),
                            _shift_r(b21, s, 0.0))
        alm = _shift_r(al, s, 0.0)
        cgm, cwm = _shift_r(cg, s, 0.0), _shift_r(cw, s, 0.0)
        b11p, b12p, b21p = (_shift_l(b11, s, 1.0), _shift_l(b12, s, 0.0),
                            _shift_l(b21, s, 0.0))
        alp = _shift_l(al, s, 0.0)
        cgp, cwp = _shift_l(cg, s, 0.0), _shift_l(cw, s, 0.0)

        # E = -A inv(B_m): its second row is zero because A's is
        idetm = _safe_inv(b11m - b12m * b21m)
        e11 = -al * idetm
        e12 = al * b12m * idetm
        # F = -C inv(B_p): a full 2x2
        idetp = _safe_inv(b11p - b12p * b21p)
        f11 = cg * b21p * idetp
        f12 = -cg * b11p * idetp
        f21 = cw * b21p * idetp
        f22 = -cw * b11p * idetp

        b11 = b11 + f11 * alp
        b12 = b12 + e11 * cgm + e12 * cwm
        b21 = b21 + f21 * alp
        new_rhs = []
        for p1, p2 in rhs:
            p1m, p2m = _shift_r(p1, s, 0.0), _shift_r(p2, s, 0.0)
            p1p, p2p = _shift_l(p1, s, 0.0), _shift_l(p2, s, 0.0)
            new_rhs.append((
                p1 + e11 * p1m + e12 * p2m + f11 * p1p + f12 * p2p,
                p2 + f21 * p1p + f22 * p2p,
            ))
        rhs = new_rhs
        al = e11 * alm
        cg = f11 * cgp + f12 * cwp
        cw = f21 * cgp + f22 * cwp
        s <<= 1

    idet = _safe_inv(b11 - b12 * b21)
    return [((p1 - b12 * p2) * idet, (b11 * p2 - b21 * p1) * idet)
            for p1, p2 in rhs]


def chained_block_pcr(mask, a, b, c, d):
    """Solve the knot-space tridiagonal system on the grid.

    ``mask`` (..., n) bool marks the interior-knot cells; ``a, b, c, d``
    are the knot rows there (``a`` couples to the previous marked cell,
    ``c`` to the next; the first and last rows must pass ``a = 0`` / ``c =
    0``), ignored elsewhere.  Returns ``(u, w)``: ``u[g]`` the solution at
    the last marked cell <= g (0 before the first), ``w[g]`` at the next
    marked cell >= g (0 after the last)."""
    al, b11, b21, cg, cw, d1 = _encode(mask, a, b, c, d)
    return _pcr_core(al, b11, b21, cg, cw,
                     [(d1, torch.zeros_like(d1))])[0]


def shard_spike_factors(mask, a, b, c, d):
    """SPIKE factorization of one contiguous block of a larger chained
    system: the block's two boundary couplings (its first cell's link to
    the previous cell, its last cell's to the next) move to extra
    right-hand sides, and the block is solved for all three.

    Returns ``(xp, vl, vr)``, each a ``(u, w)`` pair, composing as
    ``X = xp + vl * e_prev + vr * f_next``, where ``e_prev`` is the true
    ``u`` at the previous block's last cell and ``f_next`` the true ``w`` at
    the next block's first cell (:func:`reduced_interface_solve`)."""
    al, b11, b21, cg, cw, d1 = _encode(mask, a, b, c, d)
    zero = torch.zeros_like(d1)
    first = torch.zeros_like(d1)
    first[..., 0] = 1.0
    last = torch.zeros_like(d1)
    last[..., -1] = 1.0
    l1 = first * (-al)
    r1 = last * (-cg)
    r2 = last * (-cw)
    al = al * (1.0 - first)
    cg = cg * (1.0 - last)
    cw = cw * (1.0 - last)
    return _pcr_core(al, b11, b21, cg, cw, [(d1, zero), (l1, zero), (r1, r2)])


def reduced_interface_solve(a11, a21, c12, c22, d1, d2):
    """Solve the SPIKE interface system over blocks: per block p, unknowns
    ``X_p = (e_p, f_p)`` (the true ``u`` at its last cell, ``w`` at its
    first) with ``A_p X_{p-1} + X_p + C_p X_{p+1} = D_p``, A having only
    column 1 and C only column 2.  From :func:`shard_spike_factors`::

        a11 = -vl_u[..., -1]   a21 = -vl_w[..., 0]
        c12 = -vr_u[..., -1]   c22 = -vr_w[..., 0]
        d1  =  xp_u[..., -1]   d2  =  xp_w[..., 0]

    All inputs (..., P); returns ``(e, f)`` of the same shape.  Block PCR
    of ``ceil(log2(P))`` rounds of small torch ops."""
    return interface_pcr(a11, a21, c12, c22, [(d1, d2)])[0]


def interface_pcr(a11, a21, c12, c22, rhs_pairs):
    """Block PCR of the system of :func:`reduced_interface_solve` for
    several right-hand sides ``(d1, d2)`` sharing one matrix; returns the
    ``(e, f)`` of each.  The order of every operation is the reduced solve
    of the K7 kernel (``csrc/spike.cu``)."""
    nblk = a11.shape[-1]
    one = torch.ones_like(a11)
    zero = torch.zeros_like(a11)
    b11, b12, b21, b22 = one, zero, zero, one
    rhs = list(rhs_pairs)

    s = 1
    while s < nblk:
        b11m, b12m = _shift_r(b11, s, 1.0), _shift_r(b12, s, 0.0)
        b21m, b22m = _shift_r(b21, s, 0.0), _shift_r(b22, s, 1.0)
        a11m, a21m = _shift_r(a11, s, 0.0), _shift_r(a21, s, 0.0)
        c12m, c22m = _shift_r(c12, s, 0.0), _shift_r(c22, s, 0.0)
        b11p, b12p = _shift_l(b11, s, 1.0), _shift_l(b12, s, 0.0)
        b21p, b22p = _shift_l(b21, s, 0.0), _shift_l(b22, s, 1.0)
        a11p, a21p = _shift_l(a11, s, 0.0), _shift_l(a21, s, 0.0)
        c12p, c22p = _shift_l(c12, s, 0.0), _shift_l(c22, s, 0.0)

        idetm = _safe_inv(b11m * b22m - b12m * b21m)
        e11 = -(a11 * b22m) * idetm
        e12 = (a11 * b12m) * idetm
        e21 = -(a21 * b22m) * idetm
        e22 = (a21 * b12m) * idetm
        idetp = _safe_inv(b11p * b22p - b12p * b21p)
        f11 = (c12 * b21p) * idetp
        f12 = -(c12 * b11p) * idetp
        f21 = (c22 * b21p) * idetp
        f22 = -(c22 * b11p) * idetp

        b11 = b11 + f11 * a11p + f12 * a21p
        b12 = b12 + e11 * c12m + e12 * c22m
        b21 = b21 + f21 * a11p + f22 * a21p
        b22 = b22 + e21 * c12m + e22 * c22m
        new_rhs = []
        for d1, d2 in rhs:
            d1m, d2m = _shift_r(d1, s, 0.0), _shift_r(d2, s, 0.0)
            d1p, d2p = _shift_l(d1, s, 0.0), _shift_l(d2, s, 0.0)
            new_rhs.append((
                d1 + e11 * d1m + e12 * d2m + f11 * d1p + f12 * d2p,
                d2 + e21 * d1m + e22 * d2m + f21 * d1p + f22 * d2p))
        rhs = new_rhs
        a11, a21 = e11 * a11m + e12 * a21m, e21 * a11m + e22 * a21m
        c12, c22 = f11 * c12p + f12 * c22p, f21 * c12p + f22 * c22p
        s <<= 1

    idet = _safe_inv(b11 * b22 - b12 * b21)
    return [((b22 * d1 - b12 * d2) * idet, (b11 * d2 - b21 * d1) * idet)
            for d1, d2 in rhs]
