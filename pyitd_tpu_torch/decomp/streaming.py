"""Streaming/block ITD — port of ``pyitd_tpu/decomp/streaming.py``.

The protocol (the reference native tier's header, ``itd.cpp:31-39``): keep
a 3-hop window, re-assess extrema over the whole window each hop, restrict
the knot set to [last extremum in the first third, first extremum in the
last third], and emit the decomposition of the inner third only.  Latency:
3 hops.

:func:`streaming_step` is the one-hop real-time transition with a carried
:class:`StreamState`.  :func:`streaming_itd` replays a whole signal offline.
JAX replays with a ``lax.scan`` over hops; here nothing but the raw samples
carries from hop to hop (the window of hop ``t`` is ``x[(t-2)·hop :
(t+1)·hop]``, zeros before the start, ready from ``t = 2``), so every
window is formed at once with ``unfold`` and the windows run through the
step's own baseline in batches of ``_CHUNK_BYTES`` of window samples: the
ATen calls grow with the number of batches, not of hops, and each hop is
bitwise the step's on the same device.  The spline is evaluated on the
inner third only (it is per sample, so the bits are those of a whole-window
evaluation).

The complex-IQ tier (the SDR use case, ``itd.cpp:58-154``): a sample is a
knot iff it is an extremum in both the I and Q channels
(:func:`iq_extrema_mask`), knot values come from the averaged channel
``(I+Q)/2``, and one common real baseline is subtracted from both
(:func:`iq_baseline_extract`, :func:`streaming_step_iq`,
:func:`streaming_itd_iq`).

Outputs are hop-major, as JAX's: ``(hops, *batch, hop)`` rotations and
baselines, ``(hops, *batch)`` ready flags.  JAX's ``streaming_init(like=)``
is a ``shard_map`` workaround and is not ported; the port's takes a
``device``.  Entry points given numpy run on ``device`` (the card by
default); a tensor stays on its own device, and a step's samples go to
its state's device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.cubic_baseline import eval_moment_spline, segment_index
from ..ops.extrema import compact_indices, extrema_mask
from ..ops.fill import take_last_axis
from ..ops.tridiag import spline_moments
from ..utils.interop import as_input, checked_device

__all__ = [
    "StreamState", "streaming_init", "streaming_step", "streaming_itd",
    "iq_extrema_mask", "iq_baseline_extract",
    "streaming_step_iq", "streaming_itd_iq",
]

# window samples per batch of the offline replay (bytes of one window
# tensor): at 3·hop = 768 f64 samples, 21,845 windows a batch, so that the
# spline's few dozen live (windows, 3·hop) tensors stay within a few GB
_CHUNK_BYTES = 1 << 27


class StreamState(NamedTuple):
    window: torch.Tensor   # (..., 3*hop)
    filled: torch.Tensor   # int32 hop count (saturates at 3)


def streaming_init(hop: int, batch_shape=(), dtype=torch.float64, *,
                   device="cuda") -> StreamState:
    """Fresh 3-hop state on ``device``."""
    device = checked_device(device)
    return StreamState(
        window=torch.zeros(tuple(batch_shape) + (3 * hop,), dtype=dtype,
                           device=device),
        filled=torch.zeros(tuple(batch_shape), dtype=torch.int32,
                           device=device))


def _frei_osorio_spline(sig, pos, count, lo: int = 0, hi: int | None = None):
    """Frei-Osorio knot values over ``sig`` (ends pinned to the signal at
    the boundary knots, itd.cpp semantics) and the natural moment spline,
    evaluated on samples ``[lo, hi)`` — the shared core of the scalar tier
    and the IQ tier.  Returns ``(baseline[..., lo:hi], knots, cnt)``,
    ``cnt`` the count broadcast to ``(..., 1)``."""
    n = sig.shape[-1]
    hi = n if hi is None else hi
    dtype = sig.dtype
    k = torch.arange(pos.shape[-1], device=pos.device)
    cnt = torch.as_tensor(count, device=pos.device).expand(
        sig.shape[:-1])[..., None]
    xe = take_last_axis(sig, pos.long())

    zp, zx = torch.zeros_like(pos[..., :1]), torch.zeros_like(xe[..., :1])
    e_prev = torch.cat([zp, pos[..., :-1]], dim=-1)
    e_next = torch.cat([pos[..., 1:], zp], dim=-1)
    x_prev = torch.cat([zx, xe[..., :-1]], dim=-1)
    x_next = torch.cat([xe[..., 1:], zx], dim=-1)
    span = (e_next - e_prev).to(dtype)
    w = (pos - e_prev).to(dtype) / torch.where(span == 0,
                                               torch.ones_like(span), span)
    knots = 0.5 * (x_prev + w * (x_next - x_prev)) + 0.5 * xe
    knots = torch.where((k == 0) | (k == cnt - 1), xe, knots)  # ends pinned
    knots = torch.where(k >= cnt, torch.zeros_like(knots), knots)

    moments = spline_moments(pos.to(dtype), knots, cnt[..., 0], bc="natural")
    h = (e_next - pos).to(dtype)
    h = torch.where(k < cnt - 1, h, torch.ones_like(h))
    seg = segment_index(sig, pos, cnt[..., 0], cap_to_last_interval=True)
    # per sample: the samples [lo, hi) with positions shifted by lo give
    # the same integer differences, so the same bits
    lin, cub = eval_moment_spline(sig[..., lo:hi], pos - lo, knots, moments,
                                  h, seg[..., lo:hi])
    return lin + cub, knots, cnt


def _inner_baseline(window, hop: int, mask=None):
    """Baseline of the inner third from the windowed knot set.

    ``window`` supplies the knot values; ``mask`` the knot positions
    (defaults to the scalar extrema mask of ``window``; the IQ tier passes
    the joint mask over the averaged channel instead)."""
    n = 3 * hop
    if mask is None:
        mask = extrema_mask(window)
    it = torch.arange(n, device=window.device)

    # active knot range: last extremum with index < hop .. first extremum
    # with index >= 2*hop (falling back to the window's ends)
    lo = torch.where(mask & (it < hop), it, 0).amax(-1)[..., None]
    hi = torch.where(mask & (it >= 2 * hop), it, n - 1).amin(-1)[..., None]
    active = (mask & (it >= lo) & (it <= hi)) | (it == lo) | (it == hi)

    pos, count = compact_indices(active, n)
    baseline = _frei_osorio_spline(window, pos, count, hop, 2 * hop)[0]
    # degenerate window (fewer than 2 usable knots): baseline 0
    usable = (count >= 2)[..., None]
    return torch.where(usable, baseline, torch.zeros_like(baseline))


def _iq_base(window, hop: int):
    avg = 0.5 * (window.real + window.imag)
    return _inner_baseline(avg, hop,
                           mask=iq_extrema_mask(window.real, window.imag))


def _emit(window, hop: int, base, ready):
    """The hop's outputs: the inner third less the baseline, which is zero
    until the window is ready."""
    base = torch.where(ready[..., None], base, torch.zeros_like(base))
    inner = window[..., hop:2 * hop]
    if window.is_complex():
        return inner - torch.complex(base, base), base
    return inner - base, base


def _step(state: StreamState, hop_samples, hop: int, base_fn):
    w = state.window
    hop_samples = as_input(hop_samples, w.dtype, w.device)
    window = torch.cat([w[..., hop:], hop_samples], dim=-1)
    filled = torch.clamp(state.filled + 1, max=3)
    ready = filled >= 3
    rot, base = _emit(window, hop, base_fn(window, hop), ready)
    return StreamState(window=window, filled=filled), rot, base, ready


def streaming_step(state: StreamState, hop_samples, hop: int):
    """One hop in, one (rotation, baseline) hop out, and the ready flag:
    ``(state, rotation, baseline, ready)``."""
    return _step(state, hop_samples, hop, _inner_baseline)


def _replay(x, hop: int, base_fn):
    """Every hop of the 3-hop protocol over ``x`` in batches of windows;
    hop-major ``(rotations, baselines, ready)``."""
    lead = x.shape[:-1]
    nhops = x.shape[-1] // hop
    n = 3 * hop
    xp = torch.cat([torch.zeros(lead + (2 * hop,), dtype=x.dtype,
                                device=x.device), x[..., :nhops * hop]],
                   dim=-1)
    windows = xp.unfold(-1, n, hop).movedim(-2, 0)   # (hops, *lead, n)
    real = x.real.dtype if x.is_complex() else x.dtype
    bases = torch.empty((nhops,) + lead + (hop,), dtype=real, device=x.device)
    per_hop = max(1, math.prod(lead)) * n * x.element_size()
    step = max(1, _CHUNK_BYTES // per_hop)
    for h0 in range(0, nhops, step):
        w = windows[h0:h0 + step]
        bases[h0:h0 + step] = base_fn(w.reshape(-1, n), hop).reshape(
            w.shape[:-1] + (hop,))
    ready = (torch.arange(nhops, device=x.device) >= 2).reshape(
        (nhops,) + (1,) * len(lead)).expand((nhops,) + lead)
    rots, bases = _emit(windows, hop, bases, ready)
    return rots, bases, ready


def streaming_itd(x, hop: int, *, device="cuda"):
    """Offline replay: ``(rotations, baselines, ready)`` per hop, aligned
    like the real-time path (3-hop latency; hop ``t`` emits
    ``x[(t-1)·hop : t·hop]``)."""
    return _replay(as_input(x, None, device), hop, _inner_baseline)


# ---------------------------------------------------------------------------
# complex-IQ tier (joint extrema, one common baseline for both channels)
# ---------------------------------------------------------------------------


def iq_extrema_mask(re, im):
    """Joint IQ knot mask: a sample is a knot iff it is an extremum in both
    channels at once, with the IQ tier's tie rules (``itd.cpp:74-82``:
    strict on the rising edge, inclusive on the falling — the mask form of
    ``(prev < cur && cur >= next) || (prev > cur && cur <= next)``)."""

    def chan(x):
        db = x - torch.cat([x[..., :1], x[..., :-1]], dim=-1)
        df = torch.cat([x[..., 1:], x[..., -1:]], dim=-1) - x
        return ((db > 0) & (df <= 0)) | ((db < 0) & (df >= 0))

    n = re.shape[-1]
    it = torch.arange(n, device=re.device)
    return chan(re) & chan(im) & (it > 0) & (it < n - 1)


def iq_baseline_extract(re, im, *, capacity: int | None = None,
                        extrema=None, device="cuda"):
    """One common real baseline for an IQ pair — the SDR tier
    (``itd.cpp:58-154``; native twin ``pyitd_baseline_extract_iq``).

    Joint extrema, knot values Frei-Osorio over the averaged channel
    ``(re+im)/2`` with the end knots pinned to it, a natural cubic spline
    clamped to the end knots outside the knot span, and an all-zero
    baseline with fewer than 2 joint extrema.  ``extrema`` (positions,
    count) from an earlier call reuses its knot placement — the native
    tier's ``compute_extrema=false`` protocol (``itd.cpp:41-44``).
    Returns ``(baseline, (positions, count))``."""
    re = as_input(re, None, device)
    im = as_input(im, re.dtype, re.device)
    n = re.shape[-1]
    avg = 0.5 * (re + im)

    if extrema is None:
        pos, count = compact_indices(iq_extrema_mask(re, im), capacity or n)
    else:
        pos, count = (as_input(e, torch.int32, re.device) for e in extrema)

    baseline, knots, cnt = _frei_osorio_spline(avg, pos, count)

    # outside the knot span: clamp to the end knots (itd_native.cpp's rule)
    it = torch.arange(n, device=re.device)
    last = (cnt - 1).clamp(min=0).long()
    first = torch.zeros_like(last)
    e_first = take_last_axis(pos.long(), first)
    e_last = take_last_axis(pos.long(), last)
    baseline = torch.where(it < e_first, take_last_axis(knots, first),
                           baseline)
    baseline = torch.where(it > e_last, take_last_axis(knots, last),
                           baseline)
    baseline = torch.where(cnt >= 2, baseline, torch.zeros_like(baseline))
    return baseline, (pos, count)


def streaming_step_iq(state: StreamState, hop_samples, hop: int):
    """IQ one-hop transition: complex samples in; the complex rotation and
    the common real baseline of the inner third out.  ``state.window`` is
    complex; the knot mask is the joint IQ mask, the knot values come from
    the averaged channel."""
    return _step(state, hop_samples, hop, _iq_base)


def streaming_itd_iq(x, hop: int, *, device="cuda"):
    """Offline replay of the IQ protocol over a complex signal: (complex
    rotations, common baselines, ready flags) per hop."""
    return _replay(as_input(x, None, device), hop, _iq_base)
