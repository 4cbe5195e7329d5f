"""Plain PyTorch reference of the noise-assisted MEITD ensemble.

Written from the upstream semantics (falseywinchnet/PyITD: ``MEITD.py``
and ``helperfunctions.py``, siftED2D cell 1); it imports nothing of the
program under test.

* **Extrema** of a row: interior samples with ``x[i] - x[i-1] <= 0 <
  x[i+1] - x[i]`` (minima) or ``x[i] - x[i-1] >= 0 > x[i+1] - x[i]``
  (maxima), the plateau-rightmost rule; the ends never.
* **The cubic-tier level** (``MEITD.py:288-338``): knots are the extrema
  and both ends; the end values ``(3 x[0] - x[1]) / 2`` and ``(3 x[-1] -
  x[-2]) / 2`` (odd reflection); inside, with neighbour knots ``l < k <
  r``, ``0.5 (x[l] + w (x[r] - x[l])) + 0.5 x[k]``, ``w = (k - l) / (r -
  l)`` (Frei-Osorio); through them a not-a-knot cubic spline (scipy's
  ``splrep(k=3, s=0)``), whose moments solve a tridiagonal system by
  parallel cyclic reduction over all rows at once.  The baseline is the
  spline on every sample, the rotation the signal less it.
* **WPE** (``MEITD.py:51-128``): order 3, delay 1, each window's pattern
  its stable argsort, hashed ``sum(idx[k] 3^k)``, weighed by the window's
  variance; Shannon entropy in bits over ``log2(3!)``.
* **The HILO walk** (``MEITD.py:395-534``): a rotation is proper when the
  WPE of the signal it came from lies in ``[0.2, wpemax)``; the walk
  alternates extractions from ``x`` (high) and from its baseline (low),
  subtracts every accepted rotation from ``x`` and digs into ever deeper
  baselines when stuck (``soft_reset``); it stops when the count of
  extrema drops to 5 or after more than 20 accepted components.  Fewer
  than 4 extrema in the input give two zero components.
* **Assembly**: XITD's stack (``MEITD.py:536-549``) of each realization,
  its high rows, low rows and residual sorted by ascending WPE; the mean
  of the stacks; each realization's fingerprint (``helperfunctions.py:
  11-16``: one Haar step, the DCT-II, summed, over the Gamma-ppf constant)
  of its accepted components, and ``getsortedindex`` (``:18-37``) over
  those: the index nearest the mean of the sorted fingerprints and the
  completeness (the sorted values' correlation with a logit ramp).
* **The realizations** (siftED2D cell 1): ``R / 2`` noise draws ``v``,
  ``noise_scale`` times standard normal, give ``x + v`` then ``x - v``.

``dtype`` is the walk's precision; the cubic level runs in the one below
it (:data:`LOWER`): float64 walks on float32 levels, float32 on bfloat16.

Departures from upstream:

* the soft-reset dig makes at most :data:`DIG_CAP` (64) extractions a
  trip, where upstream's loop is unbounded;
* ``retrieve_proper_rotation`` gates once on its input, so upstream's
  re-sift loop returns either its first extraction (the gate holds) or the
  input after extractions nothing reads (it fails): both outcomes are
  computed without the unread extractions;
* fewer than 4 knots give the not-a-knot spline's limit (3 knots: the
  parabola through them; 2: the line), where ``splrep`` refuses them;
* a window of zero variance everywhere gives WPE 0, and the extrema test
  takes finite input;
* the noise comes from ``torch.randn`` with a ``torch.Generator`` seeded
  by ``noise_seed``, in place of numpy's generator;
* a walk stops after :data:`MAX_TRIPS` trips, which the walk in float64
  never reaches (a few dozen trips); it keeps the walk in lower precision,
  whose levels may never flatten, finite.
"""
from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the level's precision below each walk's
LOWER = {torch.float64: torch.float32, torch.float32: torch.bfloat16}
DIG_CAP = 64
MAX_TRIPS = 1000
MAX_ACCEPTED = 20
PPF = 0.6616518484657332  # helperfunctions.py's Gamma-ppf constant


def extrema(x: torch.Tensor) -> torch.Tensor:
    """Interior extrema of each row of ``x`` (..., n), bool."""
    db = x[..., 1:-1] - x[..., :-2]
    df = x[..., 2:] - x[..., 1:-1]
    inner = ((db <= 0) & (df > 0)) | ((db >= 0) & (df < 0))
    edge = torch.zeros_like(inner[..., :1])
    return torch.cat([edge, inner, edge], dim=-1)


def count_extrema(x: torch.Tensor) -> torch.Tensor:
    return extrema(x).sum(-1)


def wpe(x: torch.Tensor) -> torch.Tensor:
    """Normalised weighted permutation entropy of order 3 of each row."""
    win = x.unfold(-1, 3, 1)                                # (..., w, 3)
    idx = torch.argsort(win, dim=-1, stable=True)
    code = idx[..., 0] + 3 * idx[..., 1] + 9 * idx[..., 2]
    var = win.var(dim=-1, unbiased=False)
    weight = torch.stack([torch.where(code == h, var, 0).sum(-1)
                          for h in range(27)], dim=-1)
    total = weight.sum(-1, keepdim=True)
    p = weight / torch.where(total > 0, total, 1)
    terms = torch.where(p > 0, p * torch.log2(torch.where(p > 0, p, 1)), 0)
    return -terms.sum(-1) / math.log2(6)


def tridiagonal(a, b, c, r):
    """Solve ``a[i] y[i-1] + b[i] y[i] + c[i] y[i+1] = r[i]`` along the last
    axis for every leading index at once, by parallel cyclic reduction
    (``a[0]`` and ``c[-1]`` are ignored)."""
    m = b.shape[-1]

    def shifted(t, s, fill):
        pad = torch.full(t.shape[:-1] + (s,), fill, dtype=t.dtype,
                         device=t.device)
        if s >= m:
            return pad[..., :m]
        return (torch.cat([pad, t[..., :-s]], -1),
                torch.cat([t[..., s:], pad], -1))

    a = torch.cat([torch.zeros_like(a[..., :1]), a[..., 1:]], -1)
    c = torch.cat([c[..., :-1], torch.zeros_like(c[..., :1])], -1)
    s = 1
    while s < m:
        (am, ap), (bm, bp), (cm, cp), (rm, rp) = (
            shifted(a, s, 0), shifted(b, s, 1), shifted(c, s, 0),
            shifted(r, s, 0))
        alpha, gamma = -a / bm, -c / bp
        a, b, c, r = (alpha * am, b + alpha * cm + gamma * ap, gamma * cp,
                      r + alpha * rm + gamma * rp)
        s *= 2
    return r / b


def cubic_level(x: torch.Tensor, min_extrema: int = 0) -> torch.Tensor:
    """The cubic-tier baseline of each row of ``x`` (rows, n), computed in
    ``x``'s dtype; a row with fewer than ``min_extrema`` extrema is its own
    baseline."""
    rows, n = x.shape
    dt, dev = x.dtype, x.device
    it = torch.arange(n, device=dev)
    ext = extrema(x)
    knot = ext | (it == 0) | (it == n - 1)
    count = knot.sum(-1)                                     # (rows,)
    kmax = int(count.max())
    pos = torch.where(knot, it, n).sort(-1).values[:, :kmax].contiguous()
    k = torch.arange(kmax, device=dev)
    cnt = count[:, None]
    last = cnt - 1

    def at(v, j):
        return torch.gather(v, -1, j.clamp(0, kmax - 1).expand(rows, -1)
                            if j.dim() == 1 else j.clamp(0, kmax - 1))

    xe = torch.gather(x, -1, pos.clamp(max=n - 1))
    left, right = at(pos, k - 1), at(pos, k + 1)
    w = (pos - left).to(dt) / (right - left).clamp(min=1).to(dt)
    xl, xr = at(xe, k - 1), at(xe, k + 1)
    val = 0.5 * (xl + w * (xr - xl)) + 0.5 * xe
    first = 0.5 * (3 * x[:, :1] - x[:, 1:2])
    end = 0.5 * (3 * x[:, -1:] - x[:, -2:-1])
    val = torch.where(k == 0, first, torch.where(k == last, end, val))
    val = torch.where(k > last, 0, val)

    # spacings h[j] = pos[j+1] - pos[j] for j < count - 1, else 1
    h = torch.where(k < last, (right - pos).to(dt), 1).to(dt)
    slope = (at(val, k + 1) - val) / h

    # moments: unknowns M[1..count-2] at rows j - 1 of the system
    moments = torch.zeros_like(val)
    m = kmax - 2
    if m >= 1:
        j = k[1:-1]                               # knot of each row
        hl, hr = h[:, :-2], h[:, 1:-1]
        a, b, c = hl.clone(), 2 * (hl + hr), hr.clone()
        r = 6 * (slope[:, 1:-1] - slope[:, :-2])
        h0, h1 = h[:, :1], h[:, 1:2]
        hn = at(h, last - 1)                      # h[count-2]
        hp = at(h, last - 2)                      # h[count-3]
        four = cnt >= 4
        lo, hi = j == 1, j == last - 1
        # not-a-knot at knot 1: M0 = M1 + (h0 / h1) (M1 - M2)
        b = torch.where(lo & four, b + h0 + h0 * h0 / h1, b)
        c = torch.where(lo & four, c - h0 * h0 / h1, c)
        a = torch.where(lo, 0, a)
        # and at knot count-2: M[-1] = M[-2] + (hn / hp) (M[-2] - M[-3])
        b = torch.where(hi & four, b + hn + hn * hn / hp, b)
        a = torch.where(hi & four, a - hn * hn / hp, a)
        c = torch.where(hi, 0, c)
        # three knots: one parabola, M0 = M1 = M2
        b = torch.where(lo & hi, 3 * (h0 + h1), b)
        # rows past the knots: y = 0
        pad = j > last - 1
        a, b, c, r = (torch.where(pad, 0, a), torch.where(pad, 1, b),
                      torch.where(pad, 0, c), torch.where(pad, 0, r))
        inner = tridiagonal(a, b, c, r)
        m1, m2 = inner[:, :1], inner[:, 1:2] if m >= 2 else inner[:, :1]
        mn = at(inner, last - 2)                  # M[count-2]
        mp = at(inner, last - 3)                  # M[count-3]
        m0 = torch.where(four, m1 + h0 / h1 * (m1 - m2), m1)
        ml = torch.where(four, mn + hn / hp * (mn - mp), mn)
        moments = torch.cat([m0, inner, torch.zeros_like(m0)], -1)
        moments = torch.where(k == last, ml, moments)
        moments = torch.where((k > last) | (cnt < 3), 0, moments)

    # the segment of each sample: its last knot at or before it, the last
    # sample in the final segment
    seg = torch.searchsorted(pos, it.expand(rows, n).contiguous(),
                             right=True) - 1
    seg = torch.minimum(seg.clamp(min=0), (cnt - 2).clamp(min=0))
    p0, hs = at(pos, seg), at(h, seg)
    k0, k1 = at(val, seg), at(val, seg + 1)
    m0, m1 = at(moments, seg), at(moments, seg + 1)
    s = (it - p0).to(dt) / hs
    t = 1 - s
    base = t * k0 + s * k1 + hs * hs / 6 * ((t * t * t - t) * m0
                                            + (s * s * s - s) * m1)
    return torch.where((ext.sum(-1) < min_extrema)[:, None], x, base)


class _Walk:
    """The HILO walk of one signal in its dtype, the levels in ``level``."""

    def __init__(self, wpemax: float, level: torch.dtype):
        self.wpemax, self.level = wpemax, level

    def extract(self, s):
        """``(rotation, baseline)`` of one cubic level of ``s``."""
        base = cubic_level(s[None].to(self.level))[0].to(s.dtype)
        return s - base, base

    def proper(self, s) -> bool:
        return 0.2 <= float(wpe(s)) < self.wpemax

    def __call__(self, x):
        """``(high rows, low rows, residual)`` of ``x`` (n,)."""
        count = lambda s: int(count_extrema(s))  # noqa: E731
        zero = torch.zeros_like(x)
        nex = count(x)
        if nex < 4:
            return [zero], [zero], x
        if nex < 5:
            rotation, baseline, proper = x, zero, False
        else:
            rotation, baseline = self.extract(x)
            proper = self.proper(x)
        high, low = [], []
        xchanged, hilo, soft_reset, trips = False, True, 1, 0
        while nex > 5 and len(high) + len(low) <= MAX_ACCEPTED \
                and trips < MAX_TRIPS:
            trips += 1
            if not proper and count(rotation) > 5 and self.proper(rotation):
                # retrieve_proper_rotation: its first extraction
                rotation, proper = self.extract(rotation)[0], True
            if proper:
                (high if hilo else low).append(rotation)
                x = x - rotation
                soft_reset, xchanged = 0, True
            if hilo:
                if xchanged:
                    nex = count(x)
                    if nex < 5:
                        continue
                    baseline = self.extract(x)[1]
                # first_rotation_is_proper of the baseline
                if count(baseline) < 5:
                    rotation, proper = baseline, False
                else:
                    rotation = self.extract(baseline)[0]
                    proper = self.proper(baseline)
                xchanged, hilo = False, False
            elif xchanged:
                nex = count(x)
                if nex < 5:
                    continue
                rotation, baseline = self.extract(x)
                proper = self.proper(x)
                xchanged, hilo = False, True
            else:
                # stuck: dig into ever deeper baselines
                if soft_reset == 0:
                    rotation, baseline = self.extract(x)
                    soft_reset = 1
                nex = count(baseline)
                if nex < 5:
                    continue
                for _ in range(min(soft_reset, DIG_CAP)):
                    rotation, baseline = self.extract(baseline)
                    nex = count(baseline)
                    if nex < 5:
                        break
                soft_reset += 1
        return high, low, x


def fingerprint(x: torch.Tensor) -> torch.Tensor:
    """helperfunctions.py's fingerprint of each row: one Haar step (an odd
    length repeats its last sample), the approximation then the detail,
    the sum of their DCT-II, over :data:`PPF`.  The DCT-II sums in closed
    form: ``sum_k cos(pi k (2i + 1) / 2N) = sin(N t / 2) cos((N - 1) t / 2)
    / sin(t / 2)`` at ``t = pi (2i + 1) / 2N``."""
    x = x.double()
    if x.shape[-1] % 2:
        x = torch.cat([x, x[..., -1:]], -1)
    r2 = math.sqrt(2.0)
    coef = torch.cat([(x[..., 0::2] + x[..., 1::2]) / r2,
                      (x[..., 0::2] - x[..., 1::2]) / r2], -1)
    big_n = coef.shape[-1]
    t = math.pi * (2 * torch.arange(big_n, dtype=torch.float64,
                                    device=x.device) + 1) / (2 * big_n)
    ksum = torch.sin(big_n * t / 2) * torch.cos((big_n - 1) * t / 2) \
        / torch.sin(t / 2)
    return 2 * (coef * ksum).sum(-1) / PPF


def sorted_index(data: torch.Tensor):
    """helperfunctions.py's ``getsortedindex``: the index of the element
    where the mean falls in the sorted values, and the completeness."""
    data = data.double()
    order = torch.argsort(data, stable=True)
    a = data[order]
    size = a.numel()
    i = int(torch.searchsorted(a, a.mean().reshape(1)))
    lo, hi = a.min(), a.max()
    scaled = -6 + (a - lo) * 12 / (hi - lo if hi > lo else 1)
    ramp = torch.linspace(0, 1, size, dtype=torch.float64, device=a.device)
    y = torch.logit(ramp)
    y = torch.where(torch.isinf(y), 6 * torch.sign(y), y)
    sc, yc = scaled - scaled.mean(), y - y.mean()
    completeness = (sc * yc).sum() / torch.sqrt((sc * sc).sum()
                                               * (yc * yc).sum())
    return int(order[min(i, size - 1)]), completeness


def realizations(x: torch.Tensor, n_realizations: int, noise_scale: float,
                 noise_seed: int) -> torch.Tensor:
    """The ``(R, n)`` float64 bank: ``x + v`` for ``R / 2`` draws ``v``,
    then ``x - v``."""
    gen = torch.Generator(device=x.device)
    gen.manual_seed(noise_seed)
    x = x.double()
    v = noise_scale * torch.randn((n_realizations // 2, x.shape[-1]),
                                  generator=gen, dtype=torch.float64,
                                  device=x.device)
    return torch.cat([x + v, x - v])


def ensemble(x: torch.Tensor, *, n_realizations: int, noise_scale: float,
             wpemax: float, noise_seed: int, dtype=None, level=None) -> dict:
    """The ensemble of the 1-D signal ``x``: each realization walked in
    ``dtype`` (by default ``x``'s) on levels in ``level`` (by default one
    precision below).  Returns
    float64 tensors: ``realizations`` (R, n), ``stacks`` (R, rows, n; rows
    past a realization's count are zero), ``mean_stack``,
    ``num_components`` (R,), and ``selected_index`` and ``completeness``."""
    dtype = dtype or x.dtype
    walk = _Walk(wpemax, level or LOWER[dtype])
    bank = realizations(x, n_realizations, noise_scale, noise_seed)
    stacks, denoised = [], []
    for real in bank:
        xr = real.to(dtype)
        high, low, resid = walk(xr)
        comps = torch.stack(high + low + [resid])
        comps = comps[torch.argsort(wpe(comps), stable=True)]
        stacks.append(comps.double())
        denoised.append(real - resid.double())
    rows = max(s.shape[0] for s in stacks)
    out = bank.new_zeros((len(stacks), rows, bank.shape[-1]))
    for i, s in enumerate(stacks):
        out[i, :s.shape[0]] = s
    index, completeness = sorted_index(fingerprint(torch.stack(denoised)))
    return {"realizations": bank, "stacks": out, "mean_stack": out.mean(0),
            "num_components": torch.tensor([s.shape[0] for s in stacks]),
            "selected_index": index, "completeness": completeness}
