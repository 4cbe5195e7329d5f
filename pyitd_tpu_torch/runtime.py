"""The native real-time tier: ctypes bindings of ``native/itd_native.cpp``
— port of ``pyitd_tpu/runtime.py``.

The library is the C++ equivalent of the reference implementation's
real-time layer (its ``itd.cpp`` streaming baseline extraction with extrema
reuse and ``modpool.c`` thread-pool batch runner).  It runs on the host by
design: a hop of audio is decomposed in microseconds with no Python and no
device in the loop, which a launch on the card cannot match.  Its card
counterpart is ``decomp.streaming.streaming_step``.

The library is built at first use with the host C++ compiler
(``ops/_build.py::build_host``); if none is available the import still
succeeds and :func:`native_available` reports False.  Inputs are numpy
arrays or CPU tensors, copied to contiguous float64; outputs are numpy
arrays.  A CUDA tensor is refused, never copied to the host quietly.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

__all__ = [
    "native_available",
    "baseline_extract",
    "baseline_extract_iq",
    "StreamingITD",
    "NativePool",
]

_lib = None
_build_error: str | None = None


def _load():
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    try:
        from .ops._build import load_host_library

        lib = load_host_library()
    except Exception as e:  # no toolchain, or a build that failed
        _build_error = str(e)
        return None

    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.pyitd_baseline_extract.argtypes = [dp, dp, ctypes.c_int, ip, ip,
                                           ctypes.c_int]
    lib.pyitd_baseline_extract_iq.argtypes = [dp, dp, dp, ctypes.c_int, ip,
                                              ip, ctypes.c_int]
    lib.pyitd_stream_new.restype = ctypes.c_void_p
    lib.pyitd_stream_new.argtypes = [ctypes.c_int]
    lib.pyitd_stream_free.argtypes = [ctypes.c_void_p]
    lib.pyitd_stream_push.restype = ctypes.c_int
    lib.pyitd_stream_push.argtypes = [ctypes.c_void_p, dp, dp, dp]
    lib.pyitd_pool_new.restype = ctypes.c_void_p
    lib.pyitd_pool_new.argtypes = [ctypes.c_int]
    lib.pyitd_pool_free.argtypes = [ctypes.c_void_p]
    lib.pyitd_pool_extract_batch.argtypes = [
        ctypes.c_void_p, dp, dp, dp, ctypes.c_int, ctypes.c_int]
    lib.pyitd_pool_bench.restype = ctypes.c_double
    lib.pyitd_pool_bench.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def _need():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    return lib


def _host(a) -> np.ndarray:
    """``a`` as a contiguous float64 numpy array; a CUDA tensor raises."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(
                f"the native tier runs on the host and takes numpy arrays or "
                f"CPU tensors, got a tensor on {a.device}; on the card use "
                "pyitd_tpu_torch.decomp.streaming.streaming_step (or "
                "streaming_itd for a recorded bank)")
        a = a.detach().numpy()
    return np.ascontiguousarray(a, np.float64)


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ipp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _extrema_buffers(extrema_state, n: int):
    """``(extrema, count, compute)``: fresh buffers, or the caller's state
    (checked against n) for the reuse protocol."""
    if extrema_state is None:
        return np.zeros(n + 2, np.int32), np.zeros(1, np.int32), 1
    extrema, count = extrema_state
    if extrema.size != n + 2:
        raise ValueError(
            f"extrema_state was built for n={extrema.size - 2}, got n={n}")
    return extrema, count, 0


def baseline_extract(data, extrema_state=None):
    """One-shot native baseline extraction.

    Returns ``(rotation, baseline, state)``.  Re-pass ``state`` with new
    data of the same length to reuse the cached extrema positions across
    channels or adjustment passes (the reference's ``compute_extrema=false``
    protocol)."""
    lib = _need()
    x = _host(data)
    n = x.size
    baseline = np.zeros(n)
    extrema, count, compute = _extrema_buffers(extrema_state, n)
    lib.pyitd_baseline_extract(_dp(x), _dp(baseline), n, _ipp(extrema),
                               _ipp(count), compute)
    return x - baseline, baseline, (extrema, count)


def baseline_extract_iq(re, im, extrema_state=None):
    """IQ (complex) variant: joint extrema, averaged-channel baseline.
    Returns ``(baseline, state)``."""
    lib = _need()
    re, im = _host(re), _host(im)
    if re.size != im.size:
        raise ValueError(f"re/im length mismatch: {re.size} vs {im.size}")
    n = re.size
    baseline = np.zeros(n)
    extrema, count, compute = _extrema_buffers(extrema_state, n)
    lib.pyitd_baseline_extract_iq(_dp(re), _dp(im), _dp(baseline), n,
                                  _ipp(extrema), _ipp(count), compute)
    return baseline, (extrema, count)


class StreamingITD:
    """Hop-in, hop-out native streaming decomposer (3-hop latency)."""

    def __init__(self, hop: int):
        lib = _need()
        self._lib = lib
        self._h = lib.pyitd_stream_new(hop)
        self.hop = hop

    def push(self, hop_samples):
        """Returns ``(rotation, baseline)`` for the inner hop, or ``None``
        while the 3-hop pipeline primes."""
        x = _host(hop_samples)
        if x.size != self.hop:
            raise ValueError(f"a push takes one hop of {self.hop} samples, "
                             f"got {x.size}")
        rot = np.zeros(self.hop)
        base = np.zeros(self.hop)
        ready = self._lib.pyitd_stream_push(self._h, _dp(x), _dp(rot),
                                            _dp(base))
        return (rot, base) if ready else None

    def close(self):
        if self._h:
            self._lib.pyitd_stream_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativePool:
    """Thread-pool batch runner (the reference's ``modpool.c``)."""

    def __init__(self, nthreads: int = os.cpu_count() or 1):
        lib = _need()
        self._lib = lib
        self._h = lib.pyitd_pool_new(nthreads)

    def extract_batch(self, signals):
        """Parallel baseline extraction over a (batch, n) bank; returns
        ``(rotations, baselines)``."""
        x = _host(signals)
        b, n = x.shape
        rot = np.zeros_like(x)
        base = np.zeros_like(x)
        self._lib.pyitd_pool_extract_batch(self._h, _dp(x), _dp(rot),
                                           _dp(base), b, n)
        return rot, base

    def bench(self, ntasks: int = 100_000, task_us: int = 10) -> float:
        """Tasks per second for ``ntasks`` dummy tasks of ``task_us``
        microseconds each (the reference's harness)."""
        return float(self._lib.pyitd_pool_bench(self._h, ntasks, task_us))

    def close(self):
        if self._h:
            self._lib.pyitd_pool_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
