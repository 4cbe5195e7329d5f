"""MEITD as one batched walk — port of ``pyitd_tpu/decomp/meitd_jit.py``.

JAX compiles the whole HILO walk (the retrieve-proper-rotation step and
the soft-reset dig loop included) into one ``lax.while_loop`` with
fixed-capacity output buffers (44 + 44 rows, the reference caps), and its
bank is a ``vmap`` of that: every branch runs on every row and is then
selected, and a finished row's carry freezes.

Here one walk serves both entry points: ``meitd_jit(x)`` is the walk at
B = 1 and ``meitd_jit_bank`` the same walk at B.  The signals, rotations,
baselines and output buffers are (B, ...) tensors on the input's device;
the per-row scalars of the state machine (counts, flags, ``nex``) live on
the host, and the counts and entropies they are decided on come back in
one small transfer per stage, from one launch of the gate statistics
(``decomp/meitd.py::_stats``, the host walk's path too).  Each stage makes
one batched cubic call on exactly the rows that need an extraction there
(indexed out, scattered back), never on every row of every branch as
``vmap`` does.  The cubic level and the gate statistics work row by row,
so every row gets the result it gets alone.

Semantics follow the reference's ``MEITD.py:344-534`` like the host walk
(``decomp/meitd.py``); the tests hold the two against each other and
against JAX's.  While a profiler records, the walk runs inside the span
``pyitd.walk``, each trip inside ``pyitd.walk_trip`` and the rest of a
trip's dig inside ``pyitd.dig`` (``utils/spans.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.interop import as_input
from ..utils.spans import span, spanned
from .meitd import COUNTS, _extract, _stats

__all__ = ["meitd_jit", "meitd_jit_bank", "MeitdResult"]

_MAX_ROWS = 44
_SOFT_CAP = 64     # bound on the reference's unbounded soft_reset digging


class MeitdResult(NamedTuple):
    high: torch.Tensor        # (44, n); rows beyond high_count are zero
    low: torch.Tensor         # (44, n)
    residual: torch.Tensor    # (n,)
    high_count: torch.Tensor  # int32
    low_count: torch.Tensor


@spanned("pyitd.walk")
def _walk(x0: torch.Tensor, wpemax: float, cap: int) -> MeitdResult:
    """The HILO walk of every row of ``x0`` (B, n) float64."""
    bsz, n = x0.shape
    dev = x0.device

    def ix(rows):
        return torch.from_numpy(rows).to(dev)

    def gate(w):
        return (w >= 0.2) & (w < wpemax)

    def rows_of(parts):
        """``[(rows, source)]`` stacked into one (k, n) tensor."""
        return torch.cat([s[ix(r)] for r, s in parts])

    def counts_wpe(parts):
        """count and WPE of every part's rows, on the host, one read."""
        if not sum(r.size for r, _ in parts):
            return np.zeros(0, np.int64), np.zeros(0)
        c, w = _stats(rows_of(parts))
        return np.asarray(c, np.int64), np.asarray(w)

    def extract_into(parts):
        """One cubic call over ``[(rows, source, keep_baseline)]``: the
        rotations scattered back, and the baselines where not kept."""
        parts = [p for p in parts if p[0].size]
        if not parts:
            return
        rot, base = _extract(rows_of([(r, s) for r, s, _ in parts]), cap)
        rows = np.concatenate([r for r, _, _ in parts])
        rotation[ix(rows)] = rot
        new = np.concatenate([np.full(r.size, not keep) for r, _, keep
                              in parts])
        baseline[ix(rows[new])] = base[ix(np.flatnonzero(new))]

    x = x0.clone()
    # first_proper(x0): (x, 0, improper) below 5 extrema
    all_rows = np.arange(bsz)
    nex0, w0 = counts_wpe([(all_rows, x0)])
    rotation, baseline = x0.clone(), torch.zeros_like(x0)
    extract_into([(all_rows[nex0 >= 5], x0, False)])
    proper = (nex0 >= 5) & gate(w0)
    nex = nex0.copy()
    high = x0.new_zeros((bsz, _MAX_ROWS, n))
    low = x0.new_zeros((bsz, _MAX_ROWS, n))
    highc = np.zeros(bsz, np.int64)
    lowc = np.zeros(bsz, np.int64)
    xchanged = np.zeros(bsz, bool)
    hilo = np.ones(bsz, bool)
    soft_reset = np.ones(bsz, np.int64)

    def trip(act):
        """One trip of the rows ``act``."""
        # retrieve where the rotation is improper: the gate on the input,
        # the extraction only where it holds (MEITD.py:344-368)
        rr = act[~proper[act]]
        if rr.size:
            c, w = counts_wpe([(rr, rotation)])
            take = (c > 5) & gate(w)
            extract_into([(rr[take], rotation, True)])
            proper[rr] = take

        # accept: store by HILO, subtract from x
        acc = act[proper[act]]
        for rows, buf, cnt in ((acc[hilo[acc]], high, highc),
                               (acc[~hilo[acc]], low, lowc)):
            if rows.size:
                buf[ix(rows), ix(cnt[rows])] = rotation[ix(rows)]
                cnt[rows] += 1
        if acc.size:
            soft_reset[acc] = 0
            x[ix(acc)] -= rotation[ix(acc)]
            xchanged[acc] = True

        # exactly one continuation branch per row (MEITD.py:456-515)
        a = act[xchanged[act] & hilo[act]]     # rebase from baseline of x
        b = act[~xchanged[act] & hilo[act]]    # dig into the held baseline
        c = act[xchanged[act] & ~hilo[act]]    # back to high frequency
        d = act[~xchanged[act] & ~hilo[act]]   # stuck: soft-reset digging

        # stage 1: a and c count x, b gates its baseline; one cubic call
        # for a's and c's x, b's baseline and d's soft reset
        cnt, w = counts_wpe([(a, x), (c, x), (b, baseline)])
        ca, cc, cb = np.split(cnt, [a.size, a.size + c.size])
        wc, wb = np.split(w, [a.size, a.size + c.size])[1:]
        nex[a], nex[c] = ca, cc
        a_go, c_go, b_go = a[ca >= 5], c[cc >= 5], b[cb >= 5]
        d0 = d[soft_reset[d] == 0]
        # below 5 extrema b's rotation is its baseline itself
        rotation[ix(b[cb < 5])] = baseline[ix(b[cb < 5])]
        extract_into([(a_go, x, False), (b_go, baseline, True),
                      (c_go, x, False), (d0, x, False)])
        proper[b] = (cb >= 5) & gate(wb)
        hilo[b] = False
        proper[c_go] = gate(wc[cc >= 5])
        xchanged[c_go], hilo[c_go] = False, True
        soft_reset[d0] = 1

        # stage 2: first_proper of a's new baseline; d's dig, whose first
        # step always runs (soft_reset >= 1) where the baseline has >= 5
        cnt, w = counts_wpe([(a_go, baseline), (d, baseline)])
        cab, nxb = np.split(cnt, [a_go.size])
        nex[d[nxb < 5]] = nxb[nxb < 5]
        dig = d[nxb >= 5]
        lim = np.minimum(soft_reset[dig], _SOFT_CAP)
        a_no = a_go[cab < 5]
        rotation[ix(a_no)] = baseline[ix(a_no)]
        extract_into([(a_go[cab >= 5], baseline, True),
                      (dig, baseline, False)])
        proper[a_go] = (cab >= 5) & gate(w[:a_go.size])
        xchanged[a_go], hilo[a_go] = False, False
        soft_reset[dig] += 1

        # the rest of the dig: the running extrema count IS the walk's nex
        if not dig.size:
            return
        with span("pyitd.dig"):
            i = 1
            while dig.size:
                (cnt,) = _stats(baseline[ix(dig)], entropy=False)
                cnt = np.asarray(cnt, np.int64)
                nex[dig] = cnt
                more = (i < lim) & (cnt >= 5)
                dig, lim = dig[more], lim[more]
                extract_into([(dig, baseline, False)])
                i += 1

    while True:
        act = np.flatnonzero((nex >= 6) & (highc + lowc <= 20))
        if not act.size:
            break
        COUNTS["trips"] += 1
        with span("pyitd.walk_trip"):
            trip(act)

    # reference quirk (MEITD.py:413-414): < 4 extrema yields TWO zero
    # components; the buffers are zero-filled, so raising the counts is
    # enough.  4 <= nex <= 5 stays empty.
    degenerate = nex0 < 4
    highc = np.where(degenerate, 1, highc)
    lowc = np.where(degenerate, 1, lowc)
    return MeitdResult(high=high, low=low, residual=x,
                       high_count=torch.from_numpy(highc).to(
                           device=dev, dtype=torch.int32),
                       low_count=torch.from_numpy(lowc).to(
                           device=dev, dtype=torch.int32))


def meitd_jit(data, wpemax: float = 0.6, *, capacity: int | None = None,
              device="cuda") -> MeitdResult:
    """MEITD of a 1-D signal as the batched walk at B = 1.  A tensor stays
    on its device; anything else goes to ``device``."""
    x0 = as_input(data, torch.float64, device)
    if x0.dim() != 1:
        raise ValueError("meitd_jit expects a 1-D signal; use meitd_jit_bank")
    r = _walk(x0[None], wpemax, capacity or (x0.shape[-1] + 2))
    return MeitdResult(*(t[0] for t in r))


def meitd_jit_bank(bank, wpemax: float = 0.6, *, capacity: int | None = None,
                   device="cuda") -> MeitdResult:
    """Batched MEITD over a (batch, n) signal bank — the modpool-style
    many-independent-decompositions use case (the reference's ``modpool.c``):
    every signal walks its own HILO state machine, in one walk whose stages
    make one cubic call each over the rows that need it."""
    x0 = as_input(bank, torch.float64, device)
    if x0.dim() != 2:
        raise ValueError("meitd_jit_bank expects a (batch, n) bank")
    return _walk(x0, wpemax, capacity or (x0.shape[-1] + 2))
