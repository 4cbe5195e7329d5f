"""Cubic-spline baselines — port of ``pyitd_tpu/ops/cubic_baseline.py``:
the MEITD tier (``cubic_baseline_extract`` and what it runs: :78-673,
1123-1331) and the template tier (``template_fast_baseline``, :131-148,
682-1120; end of this module).

Knots are the extrema plus both endpoints, with odd-reflection end values
``(3x[0]-x[1])/2`` and ``(3x[-1]-x[-2])/2`` and Frei-Osorio values
elsewhere, interpolated by a not-a-knot cubic spline (scipy's
``splrep(k=3, s=0)``).  With fewer than ``min_extrema`` interior extrema
the baseline is the signal itself.

Routes (``eval_backend``):

* ``"gather"`` — compact knot buffers of ``capacity`` slots, the moment
  system on the knot axis (``tridiag.spline_moments``) and per-sample
  gathers.  Plain PyTorch, any device and float dtype, differentiable by
  autograd.
* ``"fills"`` — the padded-resident route of JAX's ``_eval_fills_fused``,
  on five kernels (``ops/cuda_cubic.py``): the knot values (K5), the
  neighbor fills (K6), the elementwise not-a-knot rows, the SPIKE local
  factorization of the grid-resident moment system (K7), the interface
  solve over SPIKE blocks with the end moments (one kernel), and the fused
  back-substitution and evaluation (K8).  On a CPU tensor the wrappers run
  their plain versions.  f32 inside for any input dtype, no compact
  buffers (``capacity`` is ignored), positions below 2^24; its gradient is
  autograd of the gather route (:class:`_CubicFills`).
* ``"auto"`` — ``"fills"`` on a CUDA tensor, ``"gather"`` elsewhere.

JAX's other routes (``"scan"``, ``"fills_fused"``, ``"fills_unfused"``,
``"fills_compact"``, ``"fills_packed"``) are refused: no caller selects
them, and the one timed on the H100, ``"fills_packed"``, was slower than
``"fills"`` on the short rows it was written for.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .chained_pcr import _sdiv, notaknot_rows
from .extrema import compact_indices, extrema_mask
from .fill import forward_fill_scan, shift_left, shift_right, take_last_axis
from .linear_baseline import knot_value
from .tridiag import _count, reference_spline_moments, spline_moments
from ..utils.spans import spanned

__all__ = ["CubicBaselineResult", "segment_index", "eval_moment_spline",
           "cubic_baseline_extract", "template_fast_baseline"]

# the h^2/6 factor of the fills route: PyTorch's CUDA division by a host
# scalar multiplies by its reciprocal, so the route (and K8) multiply by
# the f32 sixth on every device
_SIXTH = 1.0 / 6.0


class CubicBaselineResult(NamedTuple):
    rotation: torch.Tensor
    baseline: torch.Tensor
    num_extrema: torch.Tensor  # interior extrema count (int32) per row


def segment_index(x_like: torch.Tensor, positions: torch.Tensor, count, *,
                  cap_to_last_interval: bool) -> torch.Tensor:
    """Per-sample segment id j: the number of knot positions in [1,
    count-1] at or before the sample; with ``cap_to_last_interval``
    clamped to ``count-2`` (interval semantics).  int32."""
    n = x_like.shape[-1]
    k = torch.arange(positions.shape[-1], device=positions.device)
    cnt = _count(count, positions)
    valid = (k >= 1) & (k < cnt)
    pos = torch.where(valid, positions.long(), n)
    marks = torch.zeros(x_like.shape[:-1] + (n + 1,), dtype=torch.int32,
                        device=x_like.device)
    marks.scatter_add_(-1, pos.expand(x_like.shape[:-1] + pos.shape[-1:]),
                       torch.ones_like(pos, dtype=torch.int32).expand(
                           x_like.shape[:-1] + pos.shape[-1:]))
    j = torch.cumsum(marks[..., :n], dim=-1)
    cap_v = (cnt - 2 if cap_to_last_interval else cnt - 1).clamp(min=0)
    return torch.minimum(j, cap_v).to(torch.int32)


def eval_moment_spline(x_like, positions, values, moments, h, seg):
    """The moment-form cubic on every sample, as ``(lin, cub)``:
    ``S(t) = (1-s) K_j + s K_{j+1} + h^2/6 [((1-s)^3-(1-s)) M_j + (s^3-s)
    M_{j+1}]`` with ``s = (t - pos_j)/h_j``.  Integer ``positions`` subtract
    before casting (exact at any n)."""
    dtype = values.dtype
    it = torch.arange(x_like.shape[-1], device=x_like.device)
    seg = seg.long()
    pos_j = take_last_axis(positions, seg)
    h_j = take_last_axis(h, seg)
    k_j = take_last_axis(values, seg)
    k_j1 = take_last_axis(values, seg + 1)
    m_j = take_last_axis(moments, seg)
    m_j1 = take_last_axis(moments, seg + 1)

    h_safe = torch.where(h_j == 0, torch.ones_like(h_j), h_j)
    if positions.dtype.is_floating_point:
        s = (it.to(dtype) - pos_j.to(dtype)) / h_safe
    else:
        s = (it - pos_j).to(dtype) / h_safe
    lin = (1.0 - s) * k_j + s * k_j1
    omt = 1.0 - s
    cub = h_j * h_j / 6.0 * ((omt * omt * omt - omt) * m_j
                             + (s * s * s - s) * m_j1)
    return lin, cub


def _odd_reflect_ends(x: torch.Tensor):
    n = x.shape[-1]
    return (0.5 * (3.0 * x[..., 0] - x[..., 1]),
            0.5 * (3.0 * x[..., n - 1] - x[..., n - 2]))


def _extract_gather(x, capacity: int,
                    min_extrema: int) -> CubicBaselineResult:
    """The gather route (JAX's ``_cubic_extract_impl`` with
    ``eval_backend="gather"``)."""
    n = x.shape[-1]
    dtype = x.dtype
    mask = extrema_mask(x)
    it = torch.arange(n, device=x.device)
    pos, kcount = compact_indices(mask | (it == 0) | (it == n - 1), capacity)
    nex = mask.sum(-1).to(torch.int32)
    b_first, b_last = _odd_reflect_ends(x)

    k = torch.arange(capacity, device=x.device)
    cnt = kcount[..., None]
    xe = take_last_axis(x, pos.long())
    e_prev, e_next = shift_right(pos, 0), shift_left(pos, 0)
    x_prev, x_next = shift_right(xe, 0.0), shift_left(xe, 0.0)
    span = (e_next - e_prev).to(dtype)
    w = (pos - e_prev).to(dtype) / torch.where(span == 0,
                                               torch.ones_like(span), span)
    knots = 0.5 * (x_prev + w * (x_next - x_prev)) + 0.5 * xe
    knots = torch.where(k == 0, b_first[..., None], knots)
    knots = torch.where(k == cnt - 1, b_last[..., None], knots)
    knots = torch.where(k >= cnt, torch.zeros_like(knots), knots)

    moments = spline_moments(pos, knots, kcount, bc="not-a-knot")
    h = (e_next - pos).to(dtype)
    h = torch.where(k < cnt - 1, h, torch.ones_like(h))
    seg = segment_index(x, pos, kcount, cap_to_last_interval=True)
    lin, cub = eval_moment_spline(x, pos, knots, moments, h, seg)
    baseline = torch.where((nex < min_extrema)[..., None], x, lin + cub)
    return CubicBaselineResult(rotation=x - baseline, baseline=baseline,
                               num_extrema=nex)


# ---------------------------------------------------------------------------
# the fills route
# ---------------------------------------------------------------------------


def _fo_knot_values(xv, it, p2p, p2x, n1p, n1x, b_first, b_last):
    """Frei-Osorio knot values at knot sites with the odd-reflection end
    values, from the fill channels: at a knot, ``p2p`` is the previous knot
    and ``n1p`` the next (K5's formula, at every sample)."""
    k = knot_value(it, xv, p2p, p2x, n1p, n1x)
    k = torch.where(it == 0, b_first[..., None], k)
    return torch.where(it == xv.shape[-1] - 1, b_last[..., None], k)


def _end_knot_positions(mask: torch.Tensor, big: int, pos=None):
    """``(last1, last2, first1, first2)``: the last two and the first two
    marked positions per row (masked top-2 reductions); empty slots are -1
    (last) and ``big`` (first).  ``pos`` gives the samples' positions where
    they are not their indices (a time shard's global positions)."""
    it = torch.arange(mask.shape[-1], device=mask.device) if pos is None \
        else pos
    lp = torch.where(mask, it, -1)
    l1 = lp.amax(-1)
    l2 = torch.where(lp < l1[..., None], lp, -1).amax(-1)
    fp = torch.where(mask, it, big)
    f1 = fp.amin(-1)
    f2 = torch.where(fp > f1[..., None], fp, big).amin(-1)
    return l1, l2, f1, f2


def _segment_eval(xv, it, nb, m_j, m_j1, m_last, b_last, passthrough):
    """Closed-form moment-spline evaluation from per-sample channels, with
    the final-sample patches (its j-side is the second-to-last knot, its
    (j+1)-side the last) and the pass-through guard; K8's formula.  Returns
    ``(baseline, rotation)``."""
    is_last = it == xv.shape[-1] - 1
    m_j1 = torch.where(is_last, m_last, m_j1)
    pos_j = torch.where(is_last, nb.p2p, nb.p1p)
    k_j = torch.where(is_last, nb.kjm1, nb.kj)
    k_j1 = torch.where(is_last, b_last[:, None], nb.kj1)
    right = torch.where(is_last, it, nb.n1p)

    h = (right - pos_j).to(xv.dtype)
    h_safe = torch.where(h == 0, torch.ones_like(h), h)
    t = (it - pos_j).to(xv.dtype) / h_safe
    omt = 1.0 - t
    baseline = (omt * k_j + t * k_j1 + (h * h) * _SIXTH
                * ((omt * omt * omt - omt) * m_j + (t * t * t - t) * m_j1))
    baseline = torch.where(passthrough[:, None], xv, baseline)
    return baseline, xv - baseline


def _u_at(factors, e_prev, f_next, idx):
    """The back-substituted ``u`` at one position per row."""
    from .cuda_cubic import SPIKE_BLK

    i = idx.clamp(0, factors.shape[-1] - 1)[:, None]
    blk = i // SPIKE_BLK

    def g(a):
        return torch.gather(a, 1, i)[:, 0]

    return (g(factors[0]) + g(factors[2]) * torch.gather(e_prev, 1, blk)[:, 0]
            + g(factors[4]) * torch.gather(f_next, 1, blk)[:, 0])


def _end_moments(u_at, mask_int, n: int):
    """The not-a-knot end moments ``M0 = M1 + (h0/h1)(M1 - M2)`` and its
    mirror, from the first / last two interior knots, ``u_at(idx)`` the
    solution at one position per row.  Degenerate contract pinned to the
    compact solver: a missing second interior knot reads moment 0 and its
    spacing reaches the far end knot."""
    il1, il2, i1, i2 = _end_knot_positions(mask_int, n)
    has_i2, has_il2 = i2 < n, il2 >= 0
    i1 = torch.where(i1 >= n, 0, i1)
    il1 = torch.where(il1 < 0, n - 1, il1)

    m1 = u_at(i1)
    m2 = torch.where(has_i2, u_at(i2), 0.0)
    ml1 = u_at(il1)
    ml2 = torch.where(has_il2, u_at(il2), 0.0)
    f32 = torch.float32
    h0 = i1.to(f32)
    h1 = torch.where(has_i2, i2 - i1, n - 1 - i1).to(f32)
    hl = (n - 1 - il1).to(f32)
    hl2 = torch.where(has_il2, il1 - il2, il1).to(f32)
    return (m1 + _sdiv(h0, h1) * (m1 - m2),
            ml1 + _sdiv(hl, hl2) * (ml1 - ml2))


def _eval_fills_fused(x: torch.Tensor, min_extrema: int):
    """The padded-resident cubic level on the kernels of
    ``ops/cuda_cubic.py`` (JAX's ``_eval_fills_fused``).  Returns
    ``(baseline, rotation, nex)``, f32."""
    from . import cuda_cubic as cc
    from .cuda_fill import level_states_cuda

    n = x.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, n).to(torch.float32).contiguous()

    # round 1: the sift pre-pass seeds both directions and counts extrema;
    # the Frei-Osorio knot values in one kernel
    states = level_states_cuda(x2)
    b_first, b_last = _odd_reflect_ends(x2)
    k_site = cc.cubic_ksite_cuda(x2, states, b_first, b_last)
    # round 2: neighbor knot positions and values
    nb = cc.cubic_neighbors_cuda(x2, k_site, states)

    # not-a-knot rows at interior knots (a sample is a knot iff it is its
    # own latest knot)
    it = torch.arange(n, dtype=torch.int32, device=x2.device)
    mask_int = (nb.p1p == it) & (it > 0) & (it < n - 1)
    a, b, c, d = notaknot_rows(
        (it - nb.p2p).to(torch.float32), (nb.n1p - it).to(torch.float32),
        nb.kjm1, k_site, nb.kj1, firstrow=nb.p2p == 0,
        lastrow=nb.n1p == n - 1)
    factors = cc.spike_factors_cuda(mask_int, a, b, c, d)

    # the interface solve over SPIKE blocks and the end moments in one
    # launch, then the fused back-substitution and evaluation
    e_prev, f_next, w_first_next, m0, m_last = cc.spike_interface_cuda(
        factors, mask_int)
    baseline, rotation = cc.spike_backsub_eval_cuda(
        factors, e_prev, f_next, w_first_next, m0, m_last, b_last,
        states.nex < min_extrema, nb, x2)
    return (baseline.reshape(lead + (n,)), rotation.reshape(lead + (n,)),
            states.nex.reshape(lead))


def _extract_fills(x, min_extrema: int) -> CubicBaselineResult:
    """The f32 fills route, forward only, its result in the input's dtype.
    A guarded row returns x itself, with rotation exactly 0, as the gather
    route does (the kernels' guard passed the f32 copy of x through)."""
    baseline, rotation, nex = _eval_fills_fused(x, min_extrema)
    if x.dtype != torch.float32:
        baseline = torch.where((nex < min_extrema)[..., None], x,
                               baseline.to(x.dtype))
        rotation = x - baseline
    return CubicBaselineResult(rotation=rotation, baseline=baseline,
                               num_extrema=nex)


class _CubicFills(torch.autograd.Function):
    """The fills route's forward, without autograd; its backward is autograd
    of the gather route at ``max(capacity, n + 2)`` in the input's dtype on
    the input's device (JAX's ``_cubic_extract_structural``): the level is
    linear in x for a fixed knot structure, and the structure is constant
    almost everywhere."""

    @staticmethod
    def forward(ctx, x, capacity, min_extrema):
        r = _extract_fills(x.detach(), min_extrema)
        ctx.save_for_backward(x)
        ctx.capacity, ctx.min_extrema = capacity, min_extrema
        ctx.mark_non_differentiable(r.num_extrema)
        ctx.set_materialize_grads(False)
        return tuple(r)

    @staticmethod
    def backward(ctx, g_rot, g_base, _g_nex):
        (x,) = ctx.saved_tensors
        pairs = [(o, g) for o, g in zip(("rotation", "baseline"),
                                        (g_rot, g_base)) if g is not None]
        if not pairs:
            return None, None, None
        cap = max(ctx.capacity, x.shape[-1] + 2)
        with torch.enable_grad():
            xi = x.detach().requires_grad_()
            r = _extract_gather(xi, cap, ctx.min_extrema)
            (gx,) = torch.autograd.grad([getattr(r, o) for o, _ in pairs], xi,
                                        [g for _, g in pairs])
        return gx, None, None


def _resolve_cubic_backend(eval_backend: str, x: torch.Tensor) -> str:
    if eval_backend == "auto":
        return "fills" if x.is_cuda else "gather"
    if eval_backend not in ("gather", "fills"):
        raise ValueError(f"unknown eval_backend: {eval_backend!r}; the "
                         f"port's routes are 'fills' and 'gather' (and "
                         f"'auto', which picks one)")
    return eval_backend


def _check_cubic_ceiling(x: torch.Tensor, eval_backend: str) -> None:
    """The fills route evaluates positions in f32 for any input dtype: past
    2^24 samples f32 positions alias and the spline silently corrupts, so
    refuse.  The gather route keeps integer positions and is exact at any
    n."""
    if x.shape[-1] <= (1 << 24) or eval_backend == "gather":
        return
    raise ValueError(
        f"n={x.shape[-1]} exceeds the f32 knot-position ceiling "
        f"(2^24={1 << 24}) of the {eval_backend!r} backend; use "
        "eval_backend='gather' (exact integer positions at any n).")


def cubic_baseline_extract(x: torch.Tensor, capacity: int, *,
                           min_extrema: int = 10,
                           eval_backend: str = "auto") -> CubicBaselineResult:
    """MEITD-tier cubic baseline: extrema knots and a not-a-knot spline,
    on the last axis of ``x``.  Returns (rotation, baseline, num_extrema).

    With fewer than ``min_extrema`` interior extrema the baseline is the
    signal itself (rotation 0); ``min_extrema=0`` disables the guard.
    ``capacity`` bounds the compact knot buffers of the gather route (knots
    beyond it are dropped); the fills route has none and ignores it, so
    pass at least n + 2 where the routes must agree.  ``eval_backend``:
    ``"gather"``, ``"fills"`` or ``"auto"`` (module docstring).
    Differentiable on both routes; the knot structure is treated as
    constant in x."""
    eval_backend = _resolve_cubic_backend(eval_backend, x)
    _check_cubic_ceiling(x, eval_backend)
    n = x.shape[-1]
    if n < 2:
        raise ValueError(f"a signal needs at least 2 samples (got n={n})")
    if eval_backend == "gather":
        return _extract_gather(x, capacity, min_extrema)
    if capacity < n:
        # the fills route ignores capacity while gather truncates knots
        # beyond it; worst case every sample is a knot
        warnings.warn(
            f"cubic_baseline_extract: capacity={capacity} < worst-case knot "
            f"count ({n}); the fills backend ignores capacity, so results "
            "may differ from the truncating gather backend", stacklevel=2)
    if x.requires_grad and torch.is_grad_enabled():
        return CubicBaselineResult(*_CubicFills.apply(x, capacity,
                                                      min_extrema))
    return _extract_fills(x, min_extrema)


# ---------------------------------------------------------------------------
# the template tier: the reference native tier's "fast" baseline on
# caller-supplied knot positions
# ---------------------------------------------------------------------------


def _scatter_channels(x_like, positions, valid, channels):
    """Per-knot ``channels`` scattered onto the signal grid at ``positions``
    (unique where valid); invalid or out-of-range slots go to one sink slot
    past the end, which is cut off."""
    n = x_like.shape[-1]
    shape = x_like.shape[:-1] + positions.shape[-1:]
    keep = valid & (positions >= 0) & (positions < n)
    pos = torch.where(keep, positions, n).long().expand(shape)
    return tuple(
        torch.zeros(x_like.shape[:-1] + (n + 1,), dtype=ch.dtype,
                    device=x_like.device).scatter(-1, pos, ch.expand(shape))
        [..., :n] for ch in channels)


def _check_f32_grid(x: torch.Tensor) -> None:
    """The closed form reads ``s = (it - pos_j) / h`` on a float sample
    grid, which aliases past 2^24 samples in f32; f64 is exact to 2^53."""
    if x.dtype == torch.float32 and x.shape[-1] > (1 << 24):
        raise ValueError(
            f"n={x.shape[-1]} exceeds the f32 sample-grid ceiling "
            f"(2^24={1 << 24}) of template_fast_baseline; use a float64 "
            "input.")


_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


class _StaticTemplate:
    """The host constants of one static knot grid on ``n`` samples — the
    position buffer trimmed to ``count + 2`` slots, the spacings and the
    segment map — and their device copies per (device, dtype), made on the
    first call that needs them.  Whoever owns the grid keeps the object
    (``decomp/itd_fourier._sine_template_static`` caches one per comb
    frequency), so a call neither rebuilds nor re-uploads them."""

    def __init__(self, positions, count: int, n: int):
        self.count, self.n = count, n
        cap2 = count + 2
        k = np.arange(cap2)
        pos = np.zeros(cap2, np.int64)
        pos[:count] = np.asarray(positions[:count], np.int64)
        self.pos = pos
        self.e_prev = np.concatenate([[0], pos[:-1]])
        self.e_next = np.concatenate([pos[1:], [0]])
        # h[count-1] = -e, as in the reference
        self.h64 = np.where(k < count, (self.e_next - pos).astype(np.float64),
                            0.0)
        self.seg = np.searchsorted(pos[1:count], np.arange(n),
                                   side="right").astype(np.int32)
        self._dev = {}

    def consts(self, device, dtype) -> dict:
        key = (torch.device(device), dtype)
        if key not in self._dev:
            self._dev[key] = self._build(*key)
        return self._dev[key]

    def _build(self, device, dtype) -> dict:
        npdt = _NP_DTYPE[dtype]
        pos, count, n = self.pos, self.count, self.n

        def f(a):
            return torch.from_numpy(np.ascontiguousarray(
                np.asarray(a).astype(npdt))).to(device)

        def i64(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(device)

        span = (self.e_next - self.e_prev).astype(npdt)
        w = (pos - self.e_prev).astype(npdt) / np.where(
            span == 0, np.ones_like(span), span)
        k = np.arange(count + 2)
        return {"w": f(w), "h": f(self.h64),
                "xe_idx": i64(np.clip(pos, 0, n - 1)), "seg": i64(self.seg),
                "pos_f": f(pos), "lastlin": f(k == count - 2),
                "it": f(np.arange(n))}


@spanned("pyitd.template_baseline")
def _template_fast_baseline_static(x: torch.Tensor,
                                   tpl: _StaticTemplate) -> torch.Tensor:
    """Static-positions path of :func:`template_fast_baseline`; while a
    profiler records, each call runs inside the span
    ``pyitd.template_baseline`` (``utils/spans.py``).

    Knot positions that depend only on configuration make everything
    positional a host constant (:class:`_StaticTemplate`), and the buffers
    are trimmed to ``count + 2`` slots: the knot values are one gather and
    the evaluation one row gather of a 7-channel matrix by the segment map.
    JAX's periodic route (one-hot compaction and evaluation GEMMs,
    ``pyitd_tpu/ops/cubic_baseline.py:682-853``) is built for the TPU's
    matrix unit and is not ported: on the H100 it was no faster than this
    route (PERF.md, Findings)."""
    if x.dtype not in _NP_DTYPE:
        raise TypeError(f"template_fast_baseline takes float32 or float64, "
                        f"not {x.dtype}")
    if x.shape[-1] != tpl.n:
        raise ValueError(f"the template is laid out for n={tpl.n}, the "
                         f"signal has {x.shape[-1]} samples")
    count, lead = tpl.count, x.shape[:-1]
    cap2 = count + 2
    c = tpl.consts(x.device, x.dtype)

    xe = x.index_select(-1, c["xe_idx"])
    x_prev = F.pad(xe[..., :-1], (1, 0))
    x_next = F.pad(xe[..., 1:], (0, 1))
    knots = 0.5 * (x_prev + c["w"] * (x_next - x_prev)) + 0.5 * xe
    # K[0] = x[e0]; K[count-1] is never written; K[count] reads x[0]
    knots = knots.clone()
    knots[..., 0] = xe[..., 0]
    knots[..., count - 1] = 0.0
    knots[..., count] = x[..., 0]
    knots[..., count + 1:] = 0.0
    # "banded": the truncated affine doubling (a 64-knot exact window)
    moments = reference_spline_moments(knots, c["h"], count, method="banded")

    # one row gather of the per-knot channels by the segment map; the
    # coefficients derive from them
    def shl(a):
        return F.pad(a[..., 1:], (0, 1))

    full = lead + (cap2,)
    chan = torch.stack(
        [c["pos_f"].expand(full), c["h"].expand(full),
         c["lastlin"].expand(full), knots, shl(knots), moments,
         shl(moments)], dim=-1)
    g = chan.index_select(-2, c["seg"])  # (..., n, 7)
    pos_j, h_j, is_lastlin = g[..., 0], g[..., 1], g[..., 2]
    k_j, k_j1, m_j, m_j1 = g[..., 3], g[..., 4], g[..., 5], g[..., 6]

    h_safe = torch.where(h_j == 0, torch.ones_like(h_j), h_j)
    s = (c["it"] - pos_j) / h_safe
    omt = 1.0 - s
    # the reference's last segment is linear only
    hh = torch.where(is_lastlin > 0, torch.zeros_like(h_j), h_j * h_j / 6.0)
    return (omt * k_j + s * k_j1
            + hh * ((omt * omt * omt - omt) * m_j + (s * s * s - s) * m_j1))


def template_fast_baseline(x, positions, count, *, period_hint=None,
                           device="cuda") -> torch.Tensor:
    """The reference native tier's ("fast") cubic baseline on caller-supplied
    knot positions, on the last axis of ``x``.

    ``positions[..., cap]`` is zero-padded past ``count`` (as the
    reference's zero-initialised extrema buffers: the one-past-the-end knot
    value reads ``x[0]``); the last knot value is never written (0) and
    the last segment is linear only.  An out-of-range position reads the
    clamped sample (the reference reads out of bounds there).

    Given a numpy ``positions`` and an integer ``count`` (the sine-template
    tier: positions are configuration), the static path runs
    (:func:`_template_fast_baseline_static`) on constants made for this
    call; a caller that reuses one grid keeps a :class:`_StaticTemplate`
    instead, as ``decomp/itd_fourier`` does.  ``period_hint=(q0, span)`` is
    accepted for JAX's signature and changes nothing: in JAX it offers the
    knot grid's periodicity to the TPU matrix-unit route, which is not
    ported, and JAX ignores it where the periodicity does not hold, so the
    result is the call's without it.  Otherwise the dynamic path
    scatters the per-knot channels onto the grid and forward-fills them,
    with ``reference_spline_moments``' ``"auto"`` method.

    ``x``: a tensor stays on its device; numpy goes to ``device``.  An f32
    signal longer than 2^24 raises (its float sample grid aliases there);
    f64 is exact to 2^53.  Differentiable in ``x``."""
    from ..utils.interop import as_input

    x = as_input(x, None, device)
    _check_f32_grid(x)
    if isinstance(positions, np.ndarray) and isinstance(
            count, (int, np.integer)):
        return _template_fast_baseline_static(
            x, _StaticTemplate(positions, int(count), x.shape[-1]))
    dtype = x.dtype
    lead = x.shape[:-1]
    positions = torch.as_tensor(positions, device=x.device)
    k = torch.arange(positions.shape[-1], device=x.device)
    count = torch.as_tensor(count, device=x.device).expand(lead)
    cnt = count[..., None]

    pos = torch.where(k < cnt, positions, torch.zeros_like(positions)).long()
    pos_f = pos.to(dtype)
    xe = take_last_axis(x, pos)  # clamped read
    x0 = x[..., :1]

    e_prev, e_next = shift_right(pos, 0), shift_left(pos, 0)
    x_prev, x_next = shift_right(xe, 0.0), shift_left(xe, 0.0)
    span = (e_next - e_prev).to(dtype)
    w = (pos - e_prev).to(dtype) / torch.where(span == 0,
                                               torch.ones_like(span), span)
    knots = 0.5 * (x_prev + w * (x_next - x_prev)) + 0.5 * xe
    zero = torch.zeros_like(knots)
    knots = torch.where(k == 0, xe, knots)
    knots = torch.where(k == cnt - 1, zero, knots)     # never written
    knots = torch.where(k == cnt, x0, knots)           # x[0]
    knots = torch.where(k > cnt, zero, knots)
    h = (e_next - pos).to(dtype)  # h[count-1] = -e[count-1]
    h = torch.where(k < cnt, h, torch.zeros_like(h))
    moments = reference_spline_moments(knots, h, count)

    # every per-sample quantity of the closed form — pos[seg], K[seg],
    # K[seg+1], M[seg], M[seg+1], h[seg] — is constant between knots:
    # scatter the channels at knots 0..count-1 and forward-fill them once;
    # samples before the first knot take knot 0's
    chans = (pos_f, knots, shift_left(knots, 0.0), moments,
             shift_left(moments, 0.0), h)
    scat = _scatter_channels(x, pos, k < cnt,
                             chans + (torch.ones_like(knots),))
    filled = forward_fill_scan(scat, scat[-1] != 0, (0.0,) * 7)
    seen = filled[-1] > 0
    pos_j, k_j, k_j1, m_j, m_j1, h_j = (
        torch.where(seen, f, ch[..., :1]) for f, ch in zip(filled[:-1], chans))

    it = torch.arange(x.shape[-1], device=x.device).to(dtype)
    h_safe = torch.where(h_j == 0, torch.ones_like(h_j), h_j)
    s = (it - pos_j) / h_safe
    omt = 1.0 - s
    lin = omt * k_j + s * k_j1
    cub = h_j * h_j / 6.0 * ((omt ** 3 - omt) * m_j + (s ** 3 - s) * m_j1)
    # the last segment (seg == count-2) is linear only: its left knot's
    # position identifies it (positions are unique integers)
    pos_cnt2 = torch.gather(pos_f, -1, (cnt - 2).clamp(min=0))
    return torch.where(pos_j == pos_cnt2, lin, lin + cub)
