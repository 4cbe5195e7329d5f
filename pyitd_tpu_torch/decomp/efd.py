"""Empirical Fourier Decomposition family — port of
``pyitd_tpu/decomp/efd.py``.

EFD: rfft -> the top-N spectral maxima with a plateau-rightmost dedup ->
band bounds at the argmin between consecutive maxima -> a symmetric x2
mirror extension -> a zero-one ideal filterbank, including the reference's
"negative-frequency" tail slices (on an rfft array these are high bins; a
quirk kept because the bands depend on it) -> irfft, centre crop.

Modified EFD: the same segmentation in the time<->spectrum flipped domain
(a spectrum row is treated as a signal), with greedy extraction of the
strongest band.

Fixed shapes, as in JAX: ``n_bands`` is static; with fewer spectral peaks
the trailing bands are zero and ``count`` gives the number of valid rows.
Ties in the descending peak sort follow reversed-stable order.  A band
bound of exactly 0 gets no mirror slice (the reference's ``[-0:]`` would
cover the whole spectrum).

Where this differs from JAX: the mapped bounds ``bound2 = ceil(bounds *
half2 / half1)`` are computed in int64, exact for any n below 2^31.  JAX
computes them in int32 (``pyitd_tpu/decomp/efd.py:161``), which overflows
once ``bounds * half2`` passes 2^31: at n = 2^20 (half2 = 524288) every
bound above 4096.  The numpy oracle ``tests/reference/efd_ref.py``
computes in int64, and the port is held against it there.

The FFTs are ``torch.fft``.  Entry points given numpy run on ``device``
(the card by default); a tensor stays on its own device.  Integer outputs
are int64 (bounds) and int32 (counts).

While a profiler records, ``efd`` runs inside the span ``pyitd.efd``, its
segmentation inside ``pyitd.efd_segments`` and its filterbank (the mirror's
rfft, the band masks, the batched irfft) inside ``pyitd.efd_bands``
(``utils/spans.py``); :data:`COUNTS` counts EFD's calls, the rows they
decompose and the ``torch.fft`` calls they issue, from shapes alone.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.extrema import extrema_masks
from ..utils.interop import as_input
from ..utils.spans import spanned

__all__ = ["spectral_segments", "efd", "EFDResult", "efd_real",
           "iterative_efd", "efd_slice_max", "iterative_max"]

# EFD's calls, the rows (signals) they decompose and the torch.fft calls
# they issue (three a call: the input's rfft, the mirror's, the bands'
# batched irfft); host counts from shapes, no device value is read
COUNTS = {"calls": 0, "rows": 0, "transforms": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _masked_argmin(x, lo, hi):
    """argmin of ``x`` over ``[lo, hi)`` per row, relative to 0 (0 where
    the range is empty)."""
    it = torch.arange(x.shape[-1], device=x.device)
    sel = (it >= lo[..., None]) & (it < hi[..., None])
    return torch.argmin(torch.where(sel, x, float("inf")), dim=-1)


def _pair_argmins(f, d, count):
    """argmin of ``f`` over ``[d_k, d_{k+1})`` for every kept maximum
    ``k`` (the last one's range runs to the end), as absolute positions;
    ``(..., len(d), n)`` work, as in JAX."""
    n = f.shape[-1]
    k = torch.arange(d.shape[-1], device=d.device)
    d_next = torch.cat([d[..., 1:], torch.full_like(d[..., :1], n)], dim=-1)
    hi = torch.where(k == count[..., None] - 1, torch.full_like(d, n), d_next)
    it = torch.arange(n, device=f.device)
    sel = (it >= d[..., None]) & (it < hi[..., None])
    return torch.argmin(torch.where(sel, f[..., None, :], float("inf")),
                        dim=-1)


def _bounds(first_bound, mids, count, n_slots: int, n: int):
    """``[0, first_bound, mids[0..count-1], n, n, ...]`` over ``n_slots``
    slots: the mids go to slots 2..count+1 (a scatter with one sink slot),
    slot count+2 holds n, and so do the inert slots past it."""
    k = torch.arange(mids.shape[-1], device=mids.device)
    cnt = count[..., None]
    slot = torch.where(k < cnt, k + 2, n_slots)
    buf = torch.full(mids.shape[:-1] + (n_slots + 1,), n, dtype=torch.int64,
                     device=mids.device)
    bounds = buf.scatter(-1, slot, mids.to(torch.int64))[..., :n_slots]
    bounds[..., 0] = 0
    bounds[..., 1] = first_bound
    pos = torch.arange(n_slots, device=mids.device)
    return torch.where(pos == cnt + 2, n, bounds)


class SegmentResult(NamedTuple):
    bounds: torch.Tensor     # (..., n_bands + 3) int64; past count+3 it is n
    cerf: torch.Tensor       # (..., n_bands) centre frequencies; zero-padded
    count: torch.Tensor      # kept maxima (int32)
    raw_peaks: torch.Tensor  # maxima before the dedup (int32)


@spanned("pyitd.efd_segments")
def spectral_segments(f: torch.Tensor, n_bands: int) -> SegmentResult:
    """The reference's ``segm_tec`` (EFD.py:5-69) on the half spectrum
    ``f``."""
    n = f.shape[-1]
    dx = f[..., 1:] - f[..., :-1]
    zero = torch.zeros_like(f[..., :1])
    dxf = torch.cat([dx, zero], dim=-1)   # hstack((dx, 0))
    dxb = torch.cat([zero, dx], dim=-1)   # hstack((0, dx))
    peak = (dxf <= 0) & (dxb > 0)
    it = torch.arange(n, device=f.device)
    locmax = torch.where(peak & (it > 0) & (it < n - 1), f,
                         torch.zeros_like(f))

    # descending order with reversed-stable ties (numpy argsort()[::-1])
    order = torch.argsort(locmax, dim=-1, stable=True).flip(-1)
    # plateau-rightmost dedup (EFD.py:37-41): drop rank r when the next
    # rank holds the immediate left or right neighbour bin, ranks 1..n-2
    nxt = torch.cat([order[..., 1:], order[..., -1:]], dim=-1)
    kill = ((order - 1 == nxt) | (order + 1 == nxt)) & (it >= 1) & (
        it <= n - 2)
    alive = (torch.gather(locmax, -1, order) > 0) & ~kill

    # the top n_bands surviving maxima, sorted by bin
    keep = alive & (torch.cumsum(alive.to(torch.int32), dim=-1) <= n_bands)
    cand = torch.where(keep, order, n)
    d = torch.sort(cand, dim=-1).values[..., :n_bands]  # n pads last
    count = alive.sum(-1).clamp(max=n_bands).to(torch.int32)

    # bounds (EFD.py:56-66): 0, the argmin before the first maximum, the
    # argmins between consecutive maxima (-1 offset), the argmin after the
    # last (-1), n
    b1 = _masked_argmin(f, torch.zeros_like(d[..., 0]), d[..., 0])
    mids = _pair_argmins(f, d, count) - 1
    bounds = _bounds(b1, mids, count, n_bands + 3, n)

    k = torch.arange(d.shape[-1], device=d.device)
    cerf = torch.where(k < count[..., None], d, 0).to(f.dtype) * math.pi / n
    return SegmentResult(bounds=bounds, cerf=cerf, count=count,
                         raw_peaks=peak.sum(-1).to(torch.int32))


class EFDResult(NamedTuple):
    bands: torch.Tensor   # (..., n_bands + 2, n); rows past count are 0
    cerf: torch.Tensor
    bounds: torch.Tensor  # normalised bounds in [0, pi], as the ref returns
    count: torch.Tensor   # valid band rows = kept maxima + 2 (int32)


@spanned("pyitd.efd")
def efd(x, n_bands: int, *, device="cuda") -> EFDResult:
    """Empirical Fourier Decomposition (EFD.py:72-110) on the last axis.
    Differentiable in ``x`` (the bounds are constant in it)."""
    x = as_input(x, None, device)
    COUNTS["calls"] += 1
    COUNTS["rows"] += math.prod(x.shape[:-1])
    COUNTS["transforms"] += 1
    ff = torch.fft.rfft(x)
    # Python's round on the float: 524289 / 2 -> 262144 (half to even)
    half1 = round(ff.shape[-1] / 2)
    return _efd_bands(x, spectral_segments(ff[..., :half1].abs(), n_bands))


@spanned("pyitd.efd_bands")
def _efd_bands(x: torch.Tensor, seg: SegmentResult) -> EFDResult:
    """EFD's bands from its segmentation of ``x``'s half spectrum."""
    COUNTS["transforms"] += 2
    n = x.shape[-1]
    dtype = x.dtype
    n_bands = seg.cerf.shape[-1]
    half1 = round((n // 2 + 1) / 2)
    bounds_norm = seg.bounds.to(dtype) * math.pi / half1

    l = round(n / 2)
    z = torch.cat([x[..., :l].flip(-1), x, x[..., n - l:].flip(-1)], dim=-1)
    ffz = torch.fft.rfft(z)
    m = ffz.shape[-1]
    # exact integer ceil of bounds * half2 / half1, in int64 (module
    # docstring: JAX's int32 overflows here)
    half2 = round(m / 2)
    bound2 = (seg.bounds * half2 + (half1 - 1)) // half1

    nb = n_bands + 2
    bins = torch.arange(m, device=x.device)
    lo = bound2[..., :nb, None]
    hi = bound2[..., 1:nb + 1, None]
    main = (bins >= lo) & (bins < hi)
    # the "negative frequency" mirror on the rfft tail: bins in
    # [m-hi, m-lo) when lo > 0, else [m-hi, m)
    mirror = (bins >= m - hi) & (bins < torch.where(lo == 0, m, m - lo))
    kidx = torch.arange(nb, device=x.device)
    valid = (kidx < seg.count[..., None] + 2)[..., None] & (lo < hi)
    ft = torch.where((main | mirror) & valid, ffz[..., None, :], 0)
    bands = torch.fft.irfft(ft, z.shape[-1])[..., l:l + n]
    # fewer than 2 raw spectral maxima (EFD.py:29+81): the reference
    # returns the input; here band row 0 carries x, the rest is zero
    passthrough = seg.raw_peaks < 2
    row0 = torch.where((kidx == 0)[:, None], x[..., None, :], 0)
    bands = torch.where(passthrough[..., None, None], row0, bands)
    count = torch.where(passthrough, 1, seg.count + 2).to(torch.int32)
    return EFDResult(bands=bands, cerf=seg.cerf, bounds=bounds_norm,
                     count=count)


# ---------------------------------------------------------------------------
# modified EFD: flipped-domain greedy band extraction (modified_efd.py)
# ---------------------------------------------------------------------------


def _flipped_segments(robust: torch.Tensor, n_req: int):
    """modified_efd.py:59-105 ``segm_tec``: maxima by the rising-edge
    detector on the half 'signal', bounds WITHOUT the -1 offset; also the
    strength order of the kept maxima."""
    half = robust[..., : robust.shape[-1] // 2]
    n = half.shape[-1]
    peak = extrema_masks(half).maxima  # detect_peaks(-x) == maxima of x
    ninf = float("-inf")
    order = torch.argsort(torch.where(peak, half, ninf), dim=-1,
                          stable=True).flip(-1)
    npeaks = peak.sum(-1)
    # modified_efd.py:65: fewer than 4 maxima -> no bands at all
    count = torch.where(npeaks < 4, 0, npeaks.clamp(max=n_req))
    cnt = count[..., None]

    top = order[..., :n_req]
    k = torch.arange(top.shape[-1], device=top.device)
    d = torch.sort(torch.where(k < cnt, top, n), dim=-1).values
    b1 = _masked_argmin(half, torch.zeros_like(d[..., 0]), d[..., 0])
    bounds = _bounds(b1, _pair_argmins(half, d, count), count, n_req + 3, n)
    # count 0 (the < 4-maxima guard too): the reference's all-zero bounds
    # make every band slice empty
    bounds = torch.where(cnt == 0, 0, bounds)

    # strength order of the kept maxima: argsort(half[d])[::-1]
    strength = torch.where(k < cnt, torch.gather(half, -1, d.clamp(0, n - 1)),
                           ninf)
    sort = torch.argsort(strength, dim=-1, stable=True).flip(-1)
    return bounds, count.to(torch.int32), sort


def _band_slice(robust, lo, hi):
    """``z[lo:hi] = robust[lo:hi]; z[-hi:-lo] = robust[-hi:-lo];
    rfft(z).real`` (modified_efd.py:119-124) for bounds ``lo``/``hi`` of
    shape ``robust.shape[:-1] + (k,)``: ``(..., k, n//2+1)``.  Unlike EFD
    there is no ``lo == 0`` special case: ``z[-hi:-0]`` is an empty
    slice, so a band from bound 0 has no mirror."""
    n = robust.shape[-1]
    bins = torch.arange(n, device=robust.device)
    lo, hi = lo[..., None], hi[..., None]
    main = (bins >= lo) & (bins < hi)
    mirror = (bins >= n - hi) & (bins < n - lo) & (hi > lo) & (lo > 0)
    z = torch.where(main | mirror, robust[..., None, :], 0)
    return torch.fft.rfft(z).real


def efd_real(row, n_req: int, *, device="cuda"):
    """modified_efd.py:111-128: a spectrum row treated as a signal;
    returns ``(bands[n_req + 2, ..., m], count, sort)`` — every band
    spectrum (rows past count+2 are zero) and the strength order."""
    row = as_input(row, None, device)
    robust = torch.fft.irfft(row, 2 * (row.shape[-1] - 1))
    bounds, count, sort = _flipped_segments(robust, n_req)
    nb = n_req + 2
    bands = _band_slice(robust, bounds[..., :nb], bounds[..., 1:nb + 1])
    return bands.movedim(-2, 0), count, sort


def iterative_efd(row, elem: int, comb_size: int, *, device="cuda"):
    """modified_efd.py:130-138: extract the strongest band ``elem`` times;
    ``(elem + 1, m)``, the remainder last."""
    working = as_input(row, None, device)
    out = []
    for _ in range(elem):
        bands, _, sort = efd_real(working, comb_size)
        topband = bands[sort[0] + 1]
        out.append(topband)
        working = working - topband
    out.append(working)
    return torch.stack(out)


def efd_slice_max(row, n_req: int, *, device="cuda"):
    """modified_efd.py:144-160: only the strongest band; the row itself
    where no band exists."""
    row = as_input(row, None, device)
    robust = torch.fft.irfft(row, 2 * (row.shape[-1] - 1))
    bounds, count, sort = _flipped_segments(robust, n_req)
    top = sort[..., :1]
    lo = torch.gather(bounds, -1, top + 1)
    hi = torch.gather(bounds, -1, top + 2)
    out = _band_slice(robust, lo, hi)[..., 0, :]
    return torch.where(count[..., None] == 0, row, out)


def iterative_max(row, elem: int, comb_size: int, *, device="cuda"):
    """modified_efd.py:162-170: ``elem`` strongest-band extractions and the
    remainder, ``(elem + 1, m)``; the rows sum to ``row``."""
    working = as_input(row, None, device)
    out = []
    for _ in range(elem):
        first = efd_slice_max(working, comb_size)
        out.append(first)
        working = working - first
    out.append(working)
    return torch.stack(out)
