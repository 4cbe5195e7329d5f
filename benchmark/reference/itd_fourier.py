"""Plain PyTorch reference of one ITD-Fourier cascade iteration.

Written from the upstream semantics (falseywinchnet/PyITD
``itd_fourier_decomposition.py``); it imports nothing of the program under
test.  Its one borrowed piece is the plain cyclic-reduction solve of the
MEITD reference (``reference/meitd.py::tridiagonal``).

* **The comb** (``:33-46``): ``arange(2, sr / 2 - 1, 96)`` in descending
  order, visited from its second entry on (upstream's loop starts at index
  1): at ``sr`` 2,048 the ten frequencies 866, 770, ..., 98, 2 Hz.
* **The knots of a frequency** (``:11-30``): on ``t = arange(0, n / sr,
  1 / sr)`` the samples ``s = sin(2 pi f t)``; index 0, every ``i`` in
  ``[1, len(t) - 2]`` with ``s[i] > 0 > s[i+1]`` or ``s[i] < 0 < s[i+1]``,
  and the tail knot ``2 e[-1] - e[-2]`` extrapolated past them (``0`` in
  place of ``e[-2]`` with one knot).  Made on the host in float64, once a
  ``(sr, n)``.
* **The fast baseline** (``:48-122``) on ``count`` knots ``e`` of a
  zero-filled buffer, quirks kept: the knot values are ``K[0] = x[e[0]]``,
  for ``0 < k < count - 1`` ``0.5 (x[e[k-1]] + w (x[e[k+1]] - x[e[k-1]]))
  + 0.5 x[e[k]]`` with ``w = (e[k] - e[k-1]) / (e[k+1] - e[k-1])``;
  ``K[count - 1]`` is never written (0) and slot ``count`` reads
  ``x[e[count]] = x[0]``.  The spacings are ``h[k] = e[k+1] - e[k]``, so
  ``h[count - 1] = -e[count - 1]``.  For ``0 < i < count``: ``u = h[i-1] /
  (h[i-1] + h[i])``, ``v = 1 - u`` and ``r = 6 ((K[i+1] - K[i]) / h[i] -
  (K[i] - K[i-1]) / h[i-1]) / (h[i-1] + h[i])``.  Upstream then runs a
  forward sweep ``b[i] = (r[i] - u[i] b[i-1]) / (2 - u[i] v[i-1])`` and a
  backward sweep ``b[i] -= v[i] b[i+1]`` with ``v`` left unnormalised: the
  two are the exact LU solve of the tridiagonal system ``u[i] b[i-1] + 2
  b[i] + (2 - u[i] v[i-1]) v[i] b[i+1] = r[i]`` (no upper term in row
  ``count - 1``, ``b[0] = 0``), which is solved here exactly by cyclic
  reduction over all knots; then ``b[0] = b[count - 1] = 0``.  Sample
  ``i`` lies in segment ``j``, the last knot ``e[j] <= i`` among ``e[0..
  count-1]``; with ``s = (i - e[j]) / h[j]`` the baseline is ``(1 - s)
  K[j] + s K[j+1] + h[j]^2 / 6 (((1 - s)^3 - (1 - s)) b[j] + (s^3 - s)
  b[j+1])`` (``b[count] = 0``), but linear alone in segment ``count - 2``.
* **The sift**: per frequency ``rotation = problem - baseline`` and the
  next problem is the baseline; the residual is the last baseline.
* **The band** (``fourier_mode_decomposition_any``, ``:171-209``) of a
  rotation of ``n`` samples, ``X = fft(rotation)``, ``a = |X|``, ``half =
  n // 2``: ``p = 1 + argmax(a[1:half])``; zeros if ``p`` is 1 or ``half -
  1``; ``f = argmax(a[:p])``, ``l = p + 1 + argmax(a[p+1:half])``; zeros if
  ``f == p - 1`` or ``l == p + 1``; ``mina = f + argmin(a[f:p+1])``,
  ``minb = p + argmin(a[p:l+1])``; the mode is ``real(ifft(Y))`` where
  ``Y`` holds ``X[mina:minb]`` and the mirror ``X[-minb:-mina]`` (empty when
  ``mina == 0``) and zeros elsewhere.  Ties go to the first index.
* **The iteration** (``:212-255``): a mode is kept when it is not close to
  zero (some ``|mode| > 1e-8``, numpy's ``isclose`` at its ``atol``); the
  update is the input less the kept modes.

Departures from upstream:

* a knot read past the signal's end (the tail knot) reads its last sample,
  where upstream reads out of bounds;
* the noise of the cell's input comes from a ``torch.Generator``
  (``benchmark/signals.py``), not from numpy's ``default_rng(4)``;
* :func:`band_modes` (the check's band extraction on the program's own
  rotations) searches the peaks on ``|rfft|`` of the rotations in their
  own dtype, all rows in one transform: it reads the same bins below
  ``n // 2`` as upstream's ``|fft|``, and gives the program's own spectrum
  bits, so that two near-equal noise bins cannot send the two argmins
  apart; the modes themselves come from the float64 ``fft`` of those
  rotations.

``dtype`` is the precision of :func:`cascade_iteration`: float64 by
default; bfloat16 (the check's control: ``torch.fft`` has no bfloat16
transform) computes in float32 with the input, the knot values, the
moments, every baseline, the spectra and the modes rounded through
bfloat16.
"""
from __future__ import annotations

import math
from functools import lru_cache

import torch

from .meitd import tridiagonal

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KEEP_ATOL = 1e-8  # numpy's isclose(mode, 0)


def _rounder(dtype):
    """``(work dtype, round)``: ``round`` passes a tensor through
    ``dtype`` where the work runs above it (bfloat16 on float32)."""
    if dtype == torch.bfloat16:
        def rnd(t):
            if t.is_complex():
                return torch.complex(rnd(t.real), rnd(t.imag))
            return t.to(torch.bfloat16).to(torch.float32)
        return torch.float32, rnd
    return dtype, lambda t: t


def comb(sample_rate: int) -> list[int]:
    """The sift's frequencies in the order it visits them."""
    freqs = list(range(2, math.ceil(sample_rate / 2 - 1), 96))[::-1]
    return freqs[1:]


@lru_cache(maxsize=4)
def knots(sample_rate: int, n: int) -> tuple:
    """Per comb frequency the knot positions (int64, on the host)."""
    t = torch.arange(0, n / sample_rate, 1 / sample_rate,
                     dtype=torch.float64)
    out = []
    for f in comb(sample_rate):
        s = torch.sin(2 * math.pi * f * t)
        si, sj = s[1:-1], s[2:]
        cross = ((si > 0) & (sj < 0)) | ((si < 0) & (sj > 0))
        e = torch.cat([torch.zeros(1, dtype=torch.int64),
                       torch.nonzero(cross).flatten() + 1])
        second_last = int(e[-2]) if e.numel() >= 2 else 0
        out.append(torch.cat([e, e.new_tensor([2 * int(e[-1])
                                               - second_last])]))
    return tuple(out)


def fast_baseline(x: torch.Tensor, e: torch.Tensor, rnd) -> torch.Tensor:
    """Upstream's fast cubic baseline of ``x`` (``(..., n)``, computed in
    its dtype) on the knots ``e`` (int64, on ``x``'s device)."""
    n, count = x.shape[-1], e.numel()
    dt = x.dtype
    xe = x[..., e.clamp(0, n - 1)]
    ef = e.to(dt)
    knot = torch.zeros(x.shape[:-1] + (count + 1,), dtype=dt,
                       device=x.device)
    w = (ef[1:-1] - ef[:-2]) / (ef[2:] - ef[:-2])
    knot[..., 1:count - 1] = 0.5 * (
        xe[..., :-2] + w * (xe[..., 2:] - xe[..., :-2])) + 0.5 * xe[..., 1:-1]
    knot[..., 0] = xe[..., 0]
    knot[..., count] = x[..., 0]
    knot = rnd(knot)
    # the zero-filled buffer's e[count] = 0
    e_ext = torch.cat([ef, ef.new_zeros(1)])
    h = e_ext[1:] - e_ext[:-1]                                  # (count,)
    hm, hi = h[:-1], h[1:]                                      # i = 1..c-1
    u = hm / (hm + hi)
    v = 1.0 - u
    k = knot
    r = 6.0 * ((k[..., 2:] - k[..., 1:-1]) / hi
               - (k[..., 1:-1] - k[..., :-2]) / hm) / (hm + hi)
    v_prev = torch.cat([v.new_zeros(1), v[:-1]])                # v[i-1]
    zero = r.new_zeros(r.shape[:-1] + (1,))
    sub = torch.cat([v.new_zeros(1), u])
    diag = torch.full((count,), 2.0, dtype=dt, device=x.device)
    sup = torch.cat([v.new_zeros(1), (2.0 - u * v_prev) * v])
    moments = tridiagonal(sub.expand(r.shape[:-1] + (count,)),
                          diag.expand(r.shape[:-1] + (count,)),
                          sup.expand(r.shape[:-1] + (count,)),
                          torch.cat([zero, r], -1))
    moments[..., 0] = 0.0
    moments[..., count - 1] = 0.0
    moments = rnd(torch.cat([moments, zero], -1))               # b[count]

    seg = torch.searchsorted(e[1:count].contiguous(),
                             torch.arange(n, device=x.device), right=True)
    s = (torch.arange(n, device=x.device, dtype=dt) - e_ext[seg]) / h[seg]
    omt = 1.0 - s
    lin = omt * k[..., seg] + s * k[..., seg + 1]
    cubic = h[seg] ** 2 / 6.0 * ((omt ** 3 - omt) * moments[..., seg]
                                 + (s ** 3 - s) * moments[..., seg + 1])
    return torch.where(seg == count - 2, lin, lin + cubic)


def sine_sift(x: torch.Tensor, sample_rate: int, rnd=lambda t: t):
    """``(rotations (F, ..., n), residual)`` of ``x`` in its dtype."""
    problem, rotations = x, []
    for e in knots(sample_rate, x.shape[-1]):
        baseline = rnd(fast_baseline(problem, e.to(x.device), rnd))
        rotations.append(rnd(problem - baseline))
        problem = baseline
    return torch.stack(rotations), problem


def _bounds(a: torch.Tensor, n: int):
    """``(mina, minb)`` of upstream's peak search on one row's ``|X|``, or
    ``None`` where it returns zeros."""
    half = n // 2
    p = 1 + int(torch.argmax(a[1:half]))
    if p in (1, half - 1):
        return None
    f = int(torch.argmax(a[:p]))
    last = p + 1 + int(torch.argmax(a[p + 1:half]))
    if f == p - 1 or last == p + 1:
        return None
    return (f + int(torch.argmin(a[f:p + 1])),
            p + int(torch.argmin(a[p:last + 1])))


def _band(spectrum: torch.Tensor, bounds) -> torch.Tensor:
    """``real(ifft)`` of the band ``bounds`` of one row's full spectrum."""
    y = torch.zeros_like(spectrum)
    if bounds is not None:
        lo, hi = bounds
        m = spectrum.shape[-1]
        y[lo:hi] = spectrum[lo:hi]
        if lo > 0:
            y[m - hi:m - lo] = spectrum[m - hi:m - lo]
    return torch.fft.ifft(y).real


def _kept(modes: torch.Tensor) -> torch.Tensor:
    return (modes.abs() > KEEP_ATOL).any(-1)


def band_modes(rotations: torch.Tensor):
    """``(modes (F, n) float64, keep (F,))``: upstream's band of each row
    of ``rotations``, the peaks searched on ``|rfft|`` in the rows' own
    dtype (module docstring), the modes from their float64 ``fft``; modes
    not kept are zero."""
    n = rotations.shape[-1]
    modes = torch.zeros(rotations.shape, dtype=torch.float64,
                        device=rotations.device)
    if not modes.numel():  # no rows: torch.fft refuses an empty batch
        return modes, modes.new_zeros(modes.shape[:1], dtype=torch.bool)
    mag = torch.fft.rfft(rotations).abs()
    full = torch.fft.fft(rotations.double())
    for i in range(rotations.shape[0]):
        modes[i] = _band(full[i], _bounds(mag[i], n))
    keep = _kept(modes)
    return modes * keep[:, None], keep


def cascade_iteration(x: torch.Tensor, sample_rate: int,
                      dtype=torch.float64) -> dict:
    """One iteration of the cascade on the 1-D signal ``x`` in ``dtype``:
    ``update``, ``is_mode`` (F,), ``mode_spectra`` (the rfft of each kept
    mode, zero for the others), ``rotations`` (F, n), ``residual``."""
    work, rnd = _rounder(dtype)
    x = rnd(x.detach().to(work))
    n = x.shape[-1]
    rotations, residual = sine_sift(x, sample_rate, rnd)
    full = rnd(torch.fft.fft(rotations))
    modes = torch.stack([rnd(_band(full[i], _bounds(full[i].abs(), n)))
                         for i in range(rotations.shape[0])])
    keep = _kept(modes)
    modes = modes * keep[:, None]
    return {"update": x - modes.sum(0), "is_mode": keep,
            "mode_spectra": torch.fft.rfft(modes), "rotations": rotations,
            "residual": residual}
