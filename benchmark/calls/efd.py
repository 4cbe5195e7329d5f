"""The ``efd`` call: Empirical Fourier Decomposition of a bank, as users
call it: ``pyitd_tpu_torch.efd(x, n_bands)`` on its default route (on the
card ``torch.fft``'s cuFFT transforms and the port's eager segmentation
and filterbank; the first call on the card checks that the bands came
back there).

The configuration gives the bank (``workload.banks``) and ``n_bands``.
The check runs the plain reference (``reference/efd.py``) on the same bank
in the configuration's float32, one signal at a time.  Compared numbers:

* ``count_diff``: signals whose band count differs from the reference's,
  an exact comparison (limit 0): the count is the number of maxima kept;
* ``bound_diff``: signals (of those the reference decomposes) whose
  integer spectral bounds differ from the reference's anywhere, an exact
  comparison (limit 0): the peak sort and the argmins decide them, and on
  equal spectra they cannot part.  On the card cuFFT gives a row the same
  bits alone as in the batch, so sound calls read 0; the control reads 8
  of 8 on every seed.  The bounds come back over ``pi``, as ``EFD.py``
  returns them, and are rounded back to bins here (exact: float32 holds a
  bound below ``pi`` to about 0.02 of a bin at 2^18 bins);
* ``band_gap``: the largest ``|bands - reference's bands|`` over
  ``max |x|``, in float64, over every band row (rows past a count are zero
  on both sides).  Limit 1e-4: sound calls read 0.0 on the card (the
  same bits), a sound path with other transform bits would read float32
  rounding (3.5e-7 to 4.7e-7 on the CPU), the ``altered`` fault reads
  1e-3 and the control 0.178 to 0.483.

Readings (``PERF.md``, section 2): 15 seeds of four banks at the cell's
size on an NVIDIA H100, the sound call, the control (the reference with
its input, spectra and bands rounded through bfloat16) and the faults,
and every run of the cell.  Faults:
``unchanged`` (the call hands its input back untouched: each signal as its
own single band), ``half_batch`` (only the first half of the bank's rows
is decomposed, the rest of the outputs are zero), ``altered`` (one sample
of one band row is moved by 1e-3 max |x| where it is produced).  A bank is
one program on one card, so no exchange between chips can be left out.
"""
from __future__ import annotations

import math

import torch

from benchmark import workload
from benchmark.reference import efd as ref
from pyitd_tpu_torch import efd

FAULTS = ("unchanged", "half_batch", "altered")


def inputs(config, traffic, seed, device):
    return workload.banks(config, traffic, seed, device)


def on_card(call):
    """``call``, whose first call on the card raises unless the bands came
    back on the card: EFD launches none of the port's kernels to count, so
    the outputs' device is what shows that the transforms ran there."""
    seen = []

    def checked(x):
        out = call(x)
        if seen or not x.is_cuda:
            return out
        if not all(v.is_cuda for v in out.values()):
            raise RuntimeError("efd of a bank on the card returned outputs "
                               "off the card: the timed path is not the "
                               "card's")
        seen.append(True)
        return out
    return checked


def make_call(config, traffic, span):
    def call(x):
        with span("efd"):
            r = efd(x, config["n_bands"])
        return {"bands": r.bands, "bounds": r.bounds, "count": r.count}
    return on_card(call)


def reference(x, config, traffic, dtype=None) -> dict:
    return ref.efd(x, config["n_bands"], dtype or x.dtype)


def _bins(bounds, n) -> torch.Tensor:
    """Bounds over ``pi`` back to spectrum bins."""
    half1 = round((n // 2 + 1) / 2)
    return torch.round(bounds.double() * half1 / math.pi).long().cpu()


def numbers(x, out, want) -> dict:
    n = x.shape[-1]
    x64 = x.detach().double()
    scale = float(x64.abs().max())
    got_count = out["count"].long().cpu().flatten()
    want_count = want["count"].long().cpu().flatten()
    split = want_count > 1  # the signals the reference decomposes
    bins_got = _bins(out["bounds"], n).flatten(0, -2)
    bins_want = _bins(want["bounds"], n).flatten(0, -2)
    bound_diff = ((bins_got != bins_want).any(-1) & split).sum()
    got = out["bands"].flatten(0, -3)
    exp = want["bands"].flatten(0, -3)
    gap = max(float((g.double() - e.double()).abs().max())
              for g, e in zip(got, exp))
    return {
        "count_diff": float((got_count != want_count).sum()),
        "bound_diff": float(bound_diff),
        "band_gap": gap / scale,
    }


def plant(call, kind, config):
    """``call`` with the fault ``kind``."""
    rows = config["n_bands"] + 2
    if kind == "unchanged":
        def broken(x):
            x0 = x.detach()
            bands = torch.zeros(x0.shape[:-1] + (rows, x0.shape[-1]),
                                dtype=x0.dtype, device=x0.device)
            bands[..., 0, :] = x0
            return {"bands": bands,
                    "bounds": torch.zeros(x0.shape[:-1] + (rows + 1,),
                                          dtype=x0.dtype, device=x0.device),
                    "count": torch.ones(x0.shape[:-1], dtype=torch.int32,
                                        device=x0.device)}
        return broken

    if kind == "half_batch":
        def broken(x):
            half = x.shape[0] // 2
            out = {}
            for k, v in call(x[:half]).items():
                pad = torch.zeros((x.shape[0] - half,) + v.shape[1:],
                                  dtype=v.dtype, device=v.device)
                out[k] = torch.cat([v, pad])
            return out
        return broken

    if kind == "altered":
        def broken(x):
            out = call(x)
            b = out["bands"]
            b[0, 1, b.shape[-1] // 2] += 1e-3 * float(x.detach().abs().max())
            return out
        return broken

    raise ValueError(f"unknown fault {kind!r}")
