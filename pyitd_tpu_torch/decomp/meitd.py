"""MEITD / XITD — maximal-extraction ensemble ITD with entropy gating; port
of ``pyitd_tpu/decomp/meitd.py``.

Behavioral contract (the reference's ``MEITD.py:344-549``):

* a rotation is "proper" iff the weighted permutation entropy of the signal
  it was extracted from satisfies ``0.2 <= WPE < WPEMAX``
  (``MEITD.py:364,389``) — the criterion is evaluated on the *input* of
  the retrieval, so it is constant across the retrieval loop;
* ``retrieve_proper_rotation`` re-sifts a rejected rotation through the
  cubic tier until the criterion holds (first extraction, in practice) or
  the running baseline drops to <= 5 extrema (returns the input, flagged
  improper);
* the MEITD main loop alternates high-frequency extractions (from x) and
  low-frequency extractions (from the baseline of x) via the
  HILO / xchanged / soft_reset state machine, subtracting every accepted
  rotation from x; hard caps: 20 accepted components, 44 + 44 output rows;
* ``XITD`` wraps MEITD and sorts all components by ascending WPE.
  Reference quirk preserved: XITD passes its auto-computed WPEMAX
  *positionally into MEITD's (unused) max_iteration slot*
  (``MEITD.py:542``), so the gate that actually applies is the 0.6 default.
  Pass ``use_auto_wpemax=True`` for the evidently intended behavior.

The walk runs on the host: each state's device work (cubic extractions,
WPE, extrema counts) is grouped per trip, and the scalars the host decides
on (counts, WPE) come back in one transfer of the (2, rows) buffer that one
launch of ``ops/wpe.py::walk_stats_cuda`` fills (:func:`_stats`, shared
with the batched walk).  The signal is float64; on the card the cubic
level computes in f32 and returns f64, so the subtraction chain and the
gate stay f64.

While a profiler records, each cubic level runs inside the span
``pyitd.cubic_level``, each host read inside ``pyitd.read``, the
statistics it reads inside ``pyitd.walk_stats`` and XITD's sort entropy
inside ``pyitd.wpe`` (``utils/spans.py``); :data:`COUNTS` counts the walks'
trips, reads, cubic levels and the rows those levels extract.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.cubic_baseline import cubic_baseline_extract
from ..ops.wpe import walk_stats_cuda, weighted_permutation_entropy
from ..utils.interop import as_input
from ..utils.spans import span

__all__ = ["meitd", "xitd", "retrieve_proper_rotation",
           "first_rotation_is_proper"]

# the cubic level's ``eval_backend`` for the MEITD walks and the 2-D tier;
# a test sets "fills" to rehearse the card's route on a CPU tensor
_CUBIC_BACKEND = "auto"

# the walks' trips, host reads (each read is one device-to-host copy), cubic
# levels (calls of cubic_baseline_extract) and the rows those extract
COUNTS = {"trips": 0, "reads": 0, "levels": 0, "level_rows": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _cubic(x: torch.Tensor, capacity: int, min_extrema: int):
    COUNTS["levels"] += 1
    COUNTS["level_rows"] += x[..., 0].numel()
    with span("pyitd.cubic_level"):
        return cubic_baseline_extract(x, capacity, min_extrema=min_extrema,
                                      eval_backend=_CUBIC_BACKEND)


def _extract(x, capacity):
    res = _cubic(x, capacity, 0)
    return res.rotation, res.baseline


def _wpe(x):
    with span("pyitd.wpe"):
        return weighted_permutation_entropy(x, 3, normalize=True)


def _read(values: torch.Tensor) -> list:
    """A small tensor of scalars to the host in one transfer."""
    COUNTS["reads"] += 1
    with span("pyitd.read"):
        return values.tolist()


def _stats(x: torch.Tensor, entropy: bool = True) -> list:
    """The extrema counts and (``entropy``) normalised order-3 WPEs of the
    rows of ``x``, from one launch, on the host in one read: ``[counts,
    entropies]`` or ``[counts]``, each a float per row (a number for 1-D
    ``x``)."""
    return _read(walk_stats_cuda(x, entropy=entropy))


def _cap(n: int) -> int:
    return n + 2  # worst case: an extremum at nearly every sample


def _fused_gate(x, capacity):
    """count(x), WPE(x) and the first extraction of x, one host read."""
    rot, base = _extract(x, capacity)
    nex, w = _stats(x)
    return int(nex), w, rot, base


def retrieve_proper_rotation(x, wpemax: float, *, device="cuda"):
    """Re-sift ``x`` until its first proper rotation emerges.

    Returns ``(rotation, flag)`` with flag 1 on success, else ``(x, 0)``
    (``MEITD.py:344-368`` semantics).

    Observational short-circuit: the reference evaluates the entropy gate
    once on the *input* (``MEITD.py:345-346``), so its re-sift loop either
    returns the FIRST extraction's rotation (gate holds — the loop exits on
    iteration one) or burns extractions until the running baseline flattens
    and returns the input unchanged (gate fails — nothing from the burn is
    observable).  Both outcomes are computed here without the loop."""
    x = as_input(x, torch.float64, device)
    nex, w = _stats(x)
    if nex <= 5:  # reference: nex<5 bails before the loop; nex==5 skips it
        return x, 0
    if not 0.2 <= w < wpemax:
        return x, 0
    rotation, _ = _extract(x, _cap(x.shape[-1]))
    return rotation, 1


def first_rotation_is_proper(x, wpemax: float, *, device="cuda"):
    """One cubic extraction + the entropy gate.

    Returns ``(rotation, baseline, flag)``; with < 5 extrema returns
    ``(x, zeros, 0)`` (``MEITD.py:371-392``)."""
    x = as_input(x, torch.float64, device)
    nex, w = _stats(x)
    if nex < 5:
        return x, torch.zeros_like(x), 0
    rotation, baseline = _extract(x, _cap(x.shape[-1]))
    return rotation, baseline, 1 if 0.2 <= w < wpemax else 0


def meitd(data, max_iteration: int = 40, wpemax: float = 0.6, *,
          device="cuda"):
    """Maximal-extraction ensemble ITD of a 1-D signal.

    Returns ``(high_rotations, low_rotations, residual)``; the component
    caps (20 accepted, 44+44 rows) and the HILO/xchanged/soft_reset walk
    follow ``MEITD.py:395-534``.  ``max_iteration`` is accepted for API
    parity; like the reference, the 20-component cap is what binds.  A
    tensor stays on its device; anything else goes to ``device``.
    """
    del max_iteration
    x = as_input(data, torch.float64, device)
    n = x.shape[-1]
    high: list = []
    low: list = []
    cap = _cap(n)

    def gate(w):
        return 1 if 0.2 <= w < wpemax else 0

    # pre-loop: first_rotation_is_proper(x) + count(x), one host read
    nex, wpe0, rot0, base0 = _fused_gate(x, cap)
    if nex < 5:
        rotation, baseline, proper = x, torch.zeros_like(x), 0
    else:
        rotation, baseline, proper = rot0, base0, gate(wpe0)
    xchanged, hilo, soft_reset = 0, 1, 1
    if nex < 4:
        # reference quirk (MEITD.py:401,413-414): < 4 extrema returns TWO
        # zero components (its 1-D ``zero_sum`` rows, normalized to the
        # (1, n) row shape the non-degenerate path uses), NOT empty
        # stacks — XITD consumers see 3 rows.  4 <= nex <= 5 still falls
        # through to the while (which it skips) and returns empty stacks.
        return x.new_zeros((1, n)), x.new_zeros((1, n)), x

    while nex > 5:
        if len(high) + len(low) > 20:
            break
        COUNTS["trips"] += 1
        if proper == 0:
            # retrieve_proper_rotation: the gate on the input first, the
            # extraction only where it holds (the re-sift burn is
            # unobservable, see retrieve_proper_rotation)
            rnex, rwpe = _stats(rotation)
            if rnex > 5 and gate(rwpe):
                rotation, _ = _extract(rotation, cap)
                proper = 1
        if proper == 1:
            (high if hilo == 1 else low).append(rotation)
            soft_reset = 0
            x = x - rotation
            xchanged = 1

        if xchanged == 1 and hilo == 1:
            # the baseline of x and the gate pieces of that baseline
            _, base_c = _extract(x, cap)
            rotb, _ = _extract(base_c, cap)
            (nex_x, nexb), (_, wpeb) = _stats(torch.stack([x, base_c]))
            nex = int(nex_x)
            if nex < 5:
                continue
            baseline = base_c
            if nexb < 5:
                rotation, proper = baseline, 0
            else:
                rotation, proper = rotb, gate(wpeb)
            xchanged, hilo = 0, 0
            continue
        elif hilo == 1:
            nexb, wpeb, rotb, _ = _fused_gate(baseline, cap)
            if nexb < 5:
                rotation, proper = baseline, 0
            else:
                rotation, proper = rotb, gate(wpeb)
            hilo = 0
            continue

        if xchanged == 1 and hilo == 0:
            nex, wpe_x, rot_x, base_x = _fused_gate(x, cap)
            if nex < 5:
                continue
            rotation, baseline, proper = rot_x, base_x, gate(wpe_x)
            xchanged, hilo = 0, 1
            continue

        if xchanged == 0 and hilo == 0:
            # dig: decompose successively deeper baselines
            if soft_reset == 0:
                rotation, baseline = _extract(x, cap)
                soft_reset = 1
            (nex,) = _stats(baseline, entropy=False)
            if nex < 5:
                continue
            for _ in range(soft_reset):
                rotation, baseline = _extract(baseline, cap)
                (nex,) = _stats(baseline, entropy=False)
                if nex < 5:
                    break
            soft_reset += 1
            continue

    hi = torch.stack(high) if high else x.new_zeros((0, n))
    lo = torch.stack(low) if low else x.new_zeros((0, n))
    return hi, lo, x


def xitd(data, *, use_auto_wpemax: bool = False, device="cuda"):
    """Auto-parameter MEITD returning all components sorted by ascending WPE
    (``MEITD.py:536-549``)."""
    x = as_input(data, torch.float64, device)
    if use_auto_wpemax:
        m, sd = _read(torch.stack([x.mean(), x.std(correction=0)]))
        snr = 0.0 if sd == 0 else m / sd
        wpemax = float(np.log(abs(20 * np.log10(abs(snr))))) if snr != 0 \
            else 0.6
        hi, lo, resid = meitd(x, wpemax=wpemax)
    else:
        # reference behavior: the auto WPEMAX lands in the unused slot
        hi, lo, resid = meitd(x)
    rows = torch.cat([hi, lo, resid[None, :]], dim=0)
    order = torch.argsort(_wpe(rows), stable=True)
    return rows[order]
