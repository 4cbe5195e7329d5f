"""Sine-template ITD and the ITD-Fourier cascade — port of
``pyitd_tpu/decomp/itd_fourier.py``.

* ``itd_sine_sift``: a descending frequency comb ``arange(2, sr/2 - 1,
  96)[::-1]`` without its first entry (the reference's loop starts at 1);
  for each frequency the knot positions are the zero crossings of a
  sampled sine (index 0 forced, one extrapolated tail knot) and the
  baseline is the template tier's fast cubic
  (``ops/cubic_baseline.template_fast_baseline``); ``rotation = problem -
  baseline`` and the next problem is the baseline.
* ``fourier_mode_any``: the FFT band between the argmins flanking the
  global spectrum peak (DC and the halfway bin excluded), mirrored bins
  included; zeros where the peaks degenerate.  ``fourier_mode_valid`` is
  the stricter three-peak variant.
* ``itd_fourier_decomposition``: sift, extract a mode per rotation,
  subtract, re-sum, until no rotation yields a mode.

The knot positions depend only on (sr, n): host numpy, cached with the
template tier's segment maps and their device copies.  The FFTs are
``torch.fft`` (JAX's four-step MXU FFT is a TPU workaround and is not
ported).  The reference's complex64 spectrum buffer is widened to the
input's dtype, as in JAX.  Entry points given numpy run on ``device``
(the card by default); a tensor stays on its own device.

While a profiler records, ``cascade_iteration`` runs inside the span
``pyitd.cascade_iteration``, its sift inside ``pyitd.sine_sift`` (each
template baseline inside ``pyitd.template_baseline``,
``ops/cubic_baseline.py``) and the rest of the iteration (the rotations'
rfft, the band weights, the keep flags, the summed irfft and the update)
inside ``pyitd.fourier_modes`` (``utils/spans.py``); :data:`COUNTS`
counts cascade iterations, template baselines and the transforms the
iterations issue, from shapes alone.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..ops.cubic_baseline import (_check_f32_grid, _StaticTemplate,
                                  _template_fast_baseline_static)
from ..utils.interop import as_input
from ..utils.spans import span, spanned

__all__ = [
    "sine_template_positions",
    "itd_sine_sift",
    "fourier_mode_any",
    "fourier_mode_valid",
    "cascade_iteration",
    "itd_fourier_decomposition",
    "itd_fourier_decomposition_lean",
]

# transforms: an rfft a rotation row and an irfft a signal row
COUNTS = {"iterations": 0, "templates": 0, "transforms": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def sine_template_positions(sample_rate: int, n: int, *, device="cuda"):
    """The knot-position buffers of the reference's frequency comb:
    ``(positions[F, cap] int32, counts[F] int32, freqs[F])`` — zero-padded
    tensors on ``device``, and the frequencies as numpy."""
    buf, counts, freqs = _sine_template_np(sample_rate, n)
    return as_input(buf, None, device), as_input(counts, None, device), freqs


@lru_cache(maxsize=None)
def _sine_template_np(sample_rate: int, n: int):
    """Host numpy twin of :func:`sine_template_positions` (a copy of
    JAX's)."""
    duration = n / sample_rate
    freqs = np.arange(2, sample_rate // 2 - 1, 96)[::-1]
    freqs = freqs[1:]  # the reference's loop starts at index 1
    t = np.arange(0, duration, 1 / sample_rate)
    pos_list, counts = [], []
    for f in freqs:
        s = np.sin(2 * np.pi * f * t)
        # the reference's per-i test `(s[i] > 0 > s[i+1]) or (s[i] < 0 <
        # s[i+1])` over i in [1, size-2], vectorized
        si, sj = s[1:-1], s[2:]
        cross = ((si > 0) & (sj < 0)) | ((si < 0) & (sj > 0))
        p = [0] + (np.nonzero(cross)[0] + 1).tolist()
        # the reference extrapolates the final knot on a zero-filled int
        # buffer; with NO crossings idx-2 wraps to the buffer's trailing
        # zero, so it appends a degenerate 0 knot
        second_last = p[-2] if len(p) >= 2 else 0
        p.append(2 * p[-1] - second_last)
        pos_list.append(np.asarray(p, np.int64))
        counts.append(len(p))
    cap = max(counts) + 2
    buf = np.zeros((len(freqs), cap), np.int32)
    for i, p in enumerate(pos_list):
        buf[i, : p.size] = p
    return buf, np.asarray(counts, np.int32), freqs


@lru_cache(maxsize=8)
def _sine_template_static(sample_rate: int, n: int):
    """Per comb frequency the template tier's :class:`_StaticTemplate` of
    the zero-crossing grid (its segment map and, once used, its device
    constants), built once per ``(sample_rate, n)``; the last 8 shapes are
    kept.  JAX's entries also carry a ``period_hint`` for its TPU
    matrix-unit route, which the port does not take."""
    pos_np, cnt_np, _ = _sine_template_np(sample_rate, n)
    return tuple(_StaticTemplate(p, int(c), n) for p, c in zip(pos_np, cnt_np))


@spanned("pyitd.sine_sift")
def itd_sine_sift(x, sample_rate: int, *, device="cuda"):
    """``(rotations[F, ..., n], residual)``: for input ``(..., n)`` the
    frequency axis leads.  Differentiable in ``x``."""
    x = as_input(x, None, device)
    _check_f32_grid(x)
    problem = x
    rotations = []
    templates = _sine_template_static(sample_rate, x.shape[-1])
    COUNTS["templates"] += len(templates)
    for tpl in templates:
        baseline = _template_fast_baseline_static(problem, tpl)
        rotations.append(problem - baseline)
        problem = baseline
    return torch.stack(rotations, dim=0), problem


def _band_weights(x_rfft, mina, minb, ok):
    """Half-spectrum weights that reproduce the reference's
    ``real(ifft(masked full spectrum))`` with ``xn[mina:minb]`` and the
    mirror ``xn[-minb:-mina]`` (empty when ``mina == 0``): folded onto the
    positive bins, ``0.5*(1[k in [mina,minb)) + 1[mina>0]*1[k in
    (mina,minb]])``, with DC at full weight, so one ``irfft`` of
    ``x_rfft * w`` replaces the complex ``ifft``."""
    bins = torch.arange(x_rfft.shape[-1], device=x_rfft.device)
    a, b = mina[..., None], minb[..., None]
    in_main = (bins >= a) & (bins < b)
    in_mirror = (bins > a) & (bins <= b) & (a > 0)
    rdt = x_rfft.real.dtype
    w = 0.5 * (in_main.to(rdt) + in_mirror.to(rdt))
    # DC has no mirror partner: real(V[0]) keeps full weight
    w = torch.where((bins == 0) & in_main, torch.ones_like(w), w)
    return torch.where(ok[..., None], w, torch.zeros_like(w))


def _argmax_where(cond, a, fill):
    return torch.argmax(torch.where(cond, a, fill), dim=-1)


def _argmin_where(cond, a):
    return torch.argmin(torch.where(cond, a, float("inf")), dim=-1)


def _mode_weights_any(x_rfft, n: int):
    """Peak search and band weights of ``fourier_mode_any`` on a half
    spectrum, batched over leading axes."""
    a = x_rfft.abs()
    half = n // 2
    bins = torch.arange(a.shape[-1], device=a.device)
    ninf = float("-inf")

    peak_max = _argmax_where((bins >= 1) & (bins < half), a, ninf)
    ok = (peak_max != 1) & (peak_max != half - 1)
    pm = peak_max[..., None]
    first_peak = _argmax_where(bins < pm, a, ninf)
    last_peak = _argmax_where((bins > pm) & (bins < half), a, ninf)
    ok &= (first_peak != peak_max - 1) & (last_peak != peak_max + 1)
    # mina = argmin over [first_peak, peak_max]; minb over
    # [peak_max, last_peak]
    mina = _argmin_where((bins >= first_peak[..., None]) & (bins <= pm), a)
    minb = _argmin_where((bins >= pm) & (bins <= last_peak[..., None]), a)
    return _band_weights(x_rfft, mina, minb, ok)


def _mode_weights_valid(x_rfft, n: int):
    """The strict variant: at least 3 strict local spectrum peaks; the
    closest valid peaks around the maximum."""
    a = x_rfft.abs()
    half = n // 2
    bins = torch.arange(a.shape[-1], device=a.device)
    inf = torch.full_like(a[..., :1], float("inf"))
    a_m1 = torch.cat([inf, a[..., :-1]], dim=-1)
    a_p1 = torch.cat([a[..., 1:], inf], dim=-1)
    is_peak = (a > a_m1) & (a > a_p1) & (bins >= 1) & (bins < half - 1)
    npeaks = is_peak.sum(-1)

    peak_max = _argmax_where(is_peak, a, float("-inf"))
    pm = peak_max[..., None]
    first_peak = torch.where(is_peak & (bins < pm - 1), bins, -1).amax(-1)
    last_peak = torch.where(is_peak & (bins > pm + 1), bins, n).amin(-1)
    ok = (npeaks >= 3) & (first_peak >= 0) & (last_peak < n)

    fp = first_peak.clamp(min=0)[..., None]
    lp = last_peak.clamp(max=n - 1)[..., None]
    mina = _argmin_where((bins >= fp) & (bins <= pm), a)
    minb = _argmin_where((bins >= pm) & (bins <= lp), a)
    return _band_weights(x_rfft, mina, minb, ok)


def _weights_fn(mode: str):
    if mode not in ("any", "valid"):
        raise ValueError(f"unknown mode: {mode!r}")
    return _mode_weights_any if mode == "any" else _mode_weights_valid


def fourier_mode_any(rotation, *, device="cuda"):
    """``fourier_mode_decomposition_any`` on the rfft half spectrum (the
    input is real; the reference's full-FFT peak search reads only bins
    below n//2)."""
    rotation = as_input(rotation, None, device)
    n = rotation.shape[-1]
    x = torch.fft.rfft(rotation)
    return torch.fft.irfft(x * _mode_weights_any(x, n), n)


def fourier_mode_valid(rotation, *, device="cuda"):
    """The strict variant of :func:`fourier_mode_any`."""
    rotation = as_input(rotation, None, device)
    n = rotation.shape[-1]
    x = torch.fft.rfft(rotation)
    return torch.fft.irfft(x * _mode_weights_valid(x, n), n)


@spanned("pyitd.cascade_iteration")
def cascade_iteration(current, sample_rate: int, *, mode: str = "any",
                      device="cuda"):
    """One cascade iteration with the per-rotation inverse FFTs summed into
    ONE: the rotations telescope (``sum(rotations) + residual ==
    current``), so subtracting every kept mode and re-summing is ``current
    - irfft(sum_i V_i * w_i)``.

    Returns ``(new_current, is_mode[F], mode_spectra[F, ..., n//2+1],
    rotations[F, ..., n], residual)``.  The keep decision is spectral,
    ``any(V*w != 0)``, where the reference tests the time-domain mode
    against zero with ``isclose``; they differ only for a band whose time
    signal is uniformly below 1e-8 yet not exactly zero."""
    current = as_input(current, None, device)
    weights_fn = _weights_fn(mode)
    n = current.shape[-1]
    rotations, residual = itd_sine_sift(current, sample_rate)
    COUNTS["iterations"] += 1
    COUNTS["transforms"] += (math.prod(rotations.shape[:-1])
                             + math.prod(current.shape[:-1]))
    with span("pyitd.fourier_modes"):
        spectra = torch.fft.rfft(rotations)
        mode_spectra = spectra * weights_fn(spectra, n)
        is_mode = (mode_spectra != 0).any(-1)
        new_current = current - torch.fft.irfft(mode_spectra.sum(0), n)
    return new_current, is_mode, mode_spectra, rotations, residual


def _numpy(t: torch.Tensor):
    return t.detach().cpu().numpy()


def itd_fourier_decomposition(signal, sample_rate: int, *, max_outer: int = 50,
                              mode: str = "any", device="cuda") -> list:
    """The cascade: ``[modes of rotation 0..., rotation 0, modes of
    rotation 1..., rotation 1, ..., residual]`` as numpy arrays.

    The loop runs on the host and reads ``is_mode`` once per iteration;
    kept modes stay weighted half spectra until the end, where one batched
    ``irfft`` makes them.  ``max_outer`` bounds a cascade that does not
    stop (the reference loops without bound): past it a ``RuntimeError``
    is raised."""
    x = as_input(signal, None, device)
    n = x.shape[-1]
    mode_specs, source_indices = [], []
    current = x
    for _ in range(max_outer):
        current_next, is_mode, spectra, rotations, residual = \
            cascade_iteration(current, sample_rate, mode=mode)
        keep = _numpy(is_mode)
        if not keep.any():
            modes = (_numpy(torch.fft.irfft(torch.stack(mode_specs), n))
                     if mode_specs else None)
            rot_np = _numpy(rotations)
            out = []
            for i in range(rot_np.shape[0]):
                out.extend(modes[m] for m, s in enumerate(source_indices)
                           if s == i)
                out.append(rot_np[i])
            out.append(_numpy(residual))
            return out
        for i in np.nonzero(keep)[0]:
            mode_specs.append(spectra[i])
            source_indices.append(int(i))
        current = current_next
    raise RuntimeError(f"cascade did not converge in {max_outer} iterations")


def itd_fourier_decomposition_lean(signal, sample_rate: int, *,
                                   max_outer: int = 50, mode: str = "any",
                                   device="cuda") -> list:
    """The lean cascade: one accumulated mode per rotation, ``[modes_0,
    rotation_0, modes_1, rotation_1, ..., residual]`` as numpy arrays (the
    reference calls an undefined ``itd_fourier_wrapper`` here: the sine
    wrapper, renamed).  The accumulators stay spectra until the end."""
    x = as_input(signal, None, device)
    n = x.shape[-1]
    acc_spec = None
    current = x
    for _ in range(max_outer):
        current_next, is_mode, spectra, rotations, residual = \
            cascade_iteration(current, sample_rate, mode=mode)
        if not bool(_numpy(is_mode).any()):
            acc = (_numpy(torch.fft.irfft(acc_spec, n)) if acc_spec is not None
                   else np.zeros(rotations.shape, _numpy(residual).dtype))
            rot_np = _numpy(rotations)
            out = []
            for i in range(rot_np.shape[0]):
                out += [acc[i], rot_np[i]]
            out.append(_numpy(residual))
            return out
        acc_spec = spectra if acc_spec is None else acc_spec + spectra
        current = current_next
    raise RuntimeError(f"cascade did not converge in {max_outer} iterations")
