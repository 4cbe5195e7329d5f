"""Plain PyTorch reference of Empirical Fourier Decomposition.

Written from the upstream semantics (falseywinchnet/PyITD ``EFD.py``:
``segm_tec`` :5-69 and ``EFD`` :72-110); it imports nothing of the program
under test, and takes one signal at a time (each row's transforms are
single-row ``torch.fft`` calls, not the program's batched ones).

* **Spectrum**: ``|rfft(x)|`` over its first ``round(m / 2)`` bins, for
  ``m = n // 2 + 1`` (Python's rounding: half to even).
* **Local maxima** (``segm_tec``): bins where the spectrum rises from the
  left (``f[i] - f[i-1] > 0``) and does not rise to the right
  (``f[i+1] - f[i] <= 0``, 0 past the end); fewer than two such bins, the
  ends included, and EFD returns its input unchanged.  The ends are no
  candidates.
* **The top ``n_bands``**: the candidates sorted by descending value, then
  the dedup walk over that order: a maximum whose next rank holds its
  immediate left or right neighbour bin is dropped (a plateau keeps its
  rightmost bin), the first rank never; the first ``n_bands`` survivors,
  in bin order.
* **Bounds**: ``0``; the argmin of the spectrum before the first maximum;
  for each maximum, the argmin from it to the next one (to the end after
  the last), less one; the spectrum's length.
* **Bands**: the input mirrored symmetrically by ``round(n / 2)`` on each
  side (``2 n`` samples), its rfft, and for each pair of consecutive
  bounds mapped onto that spectrum, ``ft[lo:hi] = ffz[lo:hi]`` and the
  "negative-frequency" slice ``ft[-hi:-lo]`` (``ft[-hi:]`` where ``lo ==
  0``), which on an rfft array are high bins; then ``irfft`` and the
  centre ``n`` samples.  A row per bound pair: ``n_bands + 2`` rows.

Departures from ``EFD.py``, each shared with the program:

* the mapped bounds are the exact integer ceiling ``ceil(b * half2 /
  half1)`` in int64, where ``EFD.py`` maps the float bounds ``b * pi /
  half1`` back with ``ceil(bn * half2 / pi)`` (roundoff can move an
  integer-exact bound by one bin);
* ties in the descending sort go in reversed-stable order (the higher bin
  first), as numpy's ``argsort()[::-1]`` of a stable sort gives them;
  ``EFD.py``'s default quicksort leaves their order unspecified;
* a band whose upper bound is 0 gets no mirror slice (``EFD.py``'s
  ``ft[-0:]`` would take the whole spectrum);
* the outputs have fixed shapes: rows past a signal's band count are zero,
  and a signal returned unchanged comes back as band row 0 with count 1.

``dtype`` is the precision: float64 and float32 compute in it; bfloat16
(the check's control for a float32 configuration: ``torch.fft`` has no
bfloat16 transform) computes in float32 with the input, both spectra's
real and imaginary parts (and so every band spectrum, a copy of the
mirror's) and the bands rounded through bfloat16.
"""
from __future__ import annotations

import math

import torch

# a float32 reference in TF32 would be a lower precision than it states
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


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


def segm_tec(f: torch.Tensor, n_bands: int):
    """``(kept maxima in bin order, bounds)`` of the half spectrum ``f``,
    or ``None`` where it has fewer than two local maxima."""
    n = f.shape[0]
    dx = f[1:] - f[:-1]
    zero = torch.zeros(1, dtype=f.dtype, device=f.device)
    peak = (torch.cat([dx, zero]) <= 0) & (torch.cat([zero, dx]) > 0)
    if int(peak.sum()) < 2:
        return None
    peak[0] = peak[-1] = False
    bins = torch.nonzero(peak).flatten()
    # descending by value; ties higher bin first: a stable sort of the
    # candidates taken from the highest bin down
    rank = torch.sort(f[bins].flip(0), descending=True, stable=True).indices
    order = bins.flip(0)[rank].tolist()
    # after the last maximum the order goes on through the zero entries,
    # highest bin first: the spectrum's last bin
    kept = []
    for r, b in enumerate(order):
        nxt = order[r + 1] if r + 1 < len(order) else n - 1
        if r >= 1 and abs(b - nxt) == 1:
            continue
        kept.append(b)
        if len(kept) == n_bands:
            break
    kept.sort()
    bounds = [0, int(torch.argmin(f[:kept[0]]))]
    for a, b in zip(kept, kept[1:] + [n]):
        bounds.append(a + int(torch.argmin(f[a:b])) - 1)
    bounds.append(n)
    return kept, bounds


def _signal(x: torch.Tensor, n_bands: int, rnd):
    """One signal's ``(bands, count, bounds)``."""
    n = x.shape[0]
    rows = n_bands + 2
    bands = torch.zeros(rows, n, dtype=x.dtype, device=x.device)
    ff = rnd(torch.fft.rfft(x))
    half1 = round(ff.shape[0] / 2)
    seg = segm_tec(ff[:half1].abs(), n_bands)
    if seg is None:  # EFD.py:81, the input unchanged
        bands[0] = x
        return bands, 1, [0] * (n_bands + 3)
    kept, bounds = seg
    l = round(n / 2)
    z = torch.cat([x[:l].flip(0), x, x[n - l:].flip(0)])
    ffz = rnd(torch.fft.rfft(z))
    m = ffz.shape[0]
    half2 = round(m / 2)
    mapped = [(b * half2 + half1 - 1) // half1 for b in bounds]
    for k, (lo, hi) in enumerate(zip(mapped, mapped[1:])):
        ft = torch.zeros_like(ffz)
        ft[lo:hi] = ffz[lo:hi]
        if lo == 0:
            if hi > 0:
                ft[m - hi:] = ffz[m - hi:]
        elif hi > lo:
            ft[m - hi:m - lo] = ffz[m - hi:m - lo]
        bands[k] = rnd(torch.fft.irfft(ft, z.shape[0])[l:l + n])
    bounds = bounds + [half1] * (n_bands + 3 - len(bounds))
    return bands, len(kept) + 2, bounds


def efd(x: torch.Tensor, n_bands: int, dtype=None) -> dict:
    """EFD of each row of ``x`` (``(..., n)``) in ``dtype`` (by default
    ``x``'s): ``bands`` ``(..., n_bands + 2, n)`` in the work dtype,
    ``count`` (band rows, int32), ``bounds`` (``(..., n_bands + 3)``, the
    spectrum's bounds over ``pi``, as ``EFD.py`` returns them, past the
    last the spectrum's length; zero for a signal returned unchanged)."""
    work, rnd = _rounder(dtype or x.dtype)
    lead, n = x.shape[:-1], x.shape[-1]
    half1 = round((n // 2 + 1) / 2)
    bands, counts, bounds = [], [], []
    for row in x.detach().reshape(-1, n):
        b, c, bd = _signal(rnd(row.to(work)), n_bands, rnd)
        bands.append(b)
        counts.append(c)
        bounds.append(bd)
    dev = x.device
    return {"bands": torch.stack(bands).reshape(*lead, n_bands + 2, n),
            "count": torch.tensor(counts, dtype=torch.int32,
                                  device=dev).reshape(lead),
            "bounds": (torch.tensor(bounds, dtype=torch.float64, device=dev)
                       * math.pi / half1).to(work).reshape(
                           *lead, n_bands + 3)}
