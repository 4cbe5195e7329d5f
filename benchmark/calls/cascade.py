"""The ``cascade`` call: one iteration of the ITD-Fourier cascade of one
recording, as ``itd_fourier_decomposition``'s loop makes it:
``pyitd_tpu_torch.decomp.itd_fourier.cascade_iteration(x, sample_rate,
mode=...)`` on its default route (on the card the template tier's eager
ops and ``torch.fft``'s cuFFT transforms), then the host read of
``is_mode`` that the loop makes once an iteration.  The first call on the
card checks that the outputs came back there.

The configuration gives the recording (``workload.banks``, one row, handed
to the call as a 1-D signal), the ``sample_rate`` and the ``mode``.  The
check runs the plain reference (``reference/itd_fourier.py``) on the same
recording in float64, and its band extraction on the program's own
rotations.  Compared numbers, each over ``max |x|``:

* ``recon``: max ``|sum of the rotations + residual - x|``, in float64, of
  the program's outputs: the rotations telescope.  Limit 1e-5: sound
  calls read float32 rounding of the ten subtractions, 2.6e-8 to 3.4e-8;
  the control reads bfloat16's, 3.6e-3 to 5.0e-3.
* ``rot_gap``: max ``|rotations and residual - the reference's|``, the
  reference in float64 from ``x``: the template tier's knots, moments and
  evaluation through ten comb entries.  A rotation missing (``unchanged``,
  ``half_comb``) compares as zeros.  Limit 1e-4: sound calls read 1.4e-7
  to 1.7e-7, the control 6.9e-3 to 7.6e-3, ``half_comb`` 0.58 to 0.64
  and ``unchanged`` 1.0.
* ``keep_diff``: rotations whose keep flag differs from the reference's on
  the program's rotations, an exact comparison (limit 0).  The reference
  searches the peaks on the program's own ``|rfft|`` bits
  (``band_modes``), so a near-tie between two noise bins, which float32
  and float64 spectra can resolve apart, resolves alike; on the card cuFFT
  gives those bits whatever the batch.  Sound calls and the control read
  0.
* ``mode_gap``: max ``|kept mode - the reference's band of the same
  rotation|``, the program's weighted half spectra made modes by a float64
  ``irfft``, the reference's from the rotation's float64 ``fft``: the
  program's float32 transform and weights.  Limit 1e-4: sound calls read
  4.4e-8 to 1.0e-7, the control 7.1e-4 to 2.1e-2.
* ``update_gap``: max ``|update - (x - the reference's kept modes)|``, the
  modes again on the program's rotations: the summed ``irfft`` and the
  subtraction in float32.  Limit 1e-4: sound calls read 3.6e-7 to 4.8e-7,
  ``altered`` 1.0e-3, the control 4.2e-3 to 2.2e-2.

Each limit lies at least 200x above every sound reading and below the
control's reading on every seed (7x for ``mode_gap``; the control fails
``recon``, ``rot_gap`` and ``update_gap`` by 40x or more besides).  The
readings (``PERF.md``, section 2) are 24 seeds of four recordings at the
cell's size on an NVIDIA H100, the sound call, the control (the reference
with its input, knot values, moments, baselines, spectra and modes
rounded through bfloat16) and the faults, and every run of the cell.
Faults: ``unchanged`` (the input handed back as the update and the
residual, with no rotations and no modes), ``half_comb`` (the comb's last
five entries skipped), ``altered`` (one sample of the update moved by
1e-3 max |x| where it is produced).  The recording is one program on one
card, so no exchange between chips can be left out.
"""
from __future__ import annotations

import torch

from benchmark import workload
from benchmark.reference import itd_fourier as ref
from pyitd_tpu_torch.decomp import itd_fourier as tif

FAULTS = ("unchanged", "half_comb", "altered")


def inputs(config, traffic, seed, device):
    return [b[0] for b in workload.banks(config, traffic, seed, device)]


def on_card(call):
    """``call``, whose first call on the card raises unless the outputs
    came back on the card: the cascade launches none of the port's kernels
    to count, so the outputs' device is what shows that it ran there."""
    seen = []

    def checked(x):
        out = call(x)
        if seen or not x.is_cuda:
            return out
        if not all(out[k].is_cuda for k in ("update", "mode_spectra",
                                            "rotations", "residual")):
            raise RuntimeError("cascade_iteration of a recording on the "
                               "card returned outputs off the card: the "
                               "timed path is not the card's")
        seen.append(True)
        return out
    return checked


def make_call(config, traffic, span):
    sr, mode = config["sample_rate"], config["mode"]

    def call(x):
        with span("cascade"):
            update, is_mode, spectra, rotations, residual = \
                tif.cascade_iteration(x, sr, mode=mode)
            keep = is_mode.cpu()  # the loop's one host read an iteration
        return {"update": update, "is_mode": keep, "mode_spectra": spectra,
                "rotations": rotations, "residual": residual}
    return on_card(call)


def reference(x, config, traffic, dtype=None) -> dict:
    return ref.cascade_iteration(x, config["sample_rate"],
                                 dtype or torch.float64)


def _rows(t, rows):
    """``t`` (F, ...) with zero rows appended up to ``rows``."""
    pad = t.new_zeros((rows - t.shape[0],) + t.shape[1:])
    return torch.cat([t, pad])


def numbers(x, out, want) -> dict:
    x64 = x.detach().double()
    n = x64.shape[-1]
    scale = float(x64.abs().max())
    rows = want["rotations"].shape[0]
    rot = _rows(out["rotations"].detach().double(), rows)
    res = out["residual"].detach().double()
    recon = float((rot.sum(0) + res - x64).abs().max())
    rot_gap = max(float((rot - want["rotations"].double()).abs().max()),
                  float((res - want["residual"].double()).abs().max()))
    modes, keep = ref.band_modes(out["rotations"].detach())
    mode_gap = 0.0
    if modes.numel():
        got_modes = torch.fft.irfft(out["mode_spectra"].detach().to(
            torch.complex128), n)
        mode_gap = float((got_modes - modes).abs().max())
    got_keep = _rows(out["is_mode"].to(x.device), rows)
    keep_diff = (got_keep != _rows(keep, rows)).sum()
    update_gap = (out["update"].detach().double()
                  - (x64 - modes.sum(0))).abs().max()
    return {"recon": recon / scale, "rot_gap": rot_gap / scale,
            "keep_diff": float(keep_diff), "mode_gap": mode_gap / scale,
            "update_gap": float(update_gap) / scale}


def plant(call, kind, config):
    """``call`` with the fault ``kind``."""
    if kind == "unchanged":
        def broken(x):
            x0 = x.detach()
            n = x0.shape[-1]
            return {"update": x0.clone(),
                    "is_mode": torch.zeros(0, dtype=torch.bool),
                    "mode_spectra": torch.zeros(
                        (0, n // 2 + 1), dtype=torch.complex64,
                        device=x0.device),
                    "rotations": x0.new_zeros((0, n)),
                    "residual": x0.clone()}
        return broken

    if kind == "half_comb":
        def broken(x):
            full = tif._sine_template_static
            tif._sine_template_static = lambda sr, n: full(sr, n)[:5]
            try:
                return call(x)
            finally:
                tif._sine_template_static = full
        return broken

    if kind == "altered":
        def broken(x):
            out = call(x)
            u = out["update"]
            u[u.shape[-1] // 2] += 1e-3 * float(x.detach().abs().max())
            return out
        return broken

    raise ValueError(f"unknown fault {kind!r}")
