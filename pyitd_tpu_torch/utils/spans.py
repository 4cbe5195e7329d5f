"""Profiler spans of the port.

``span(name)`` is a ``torch.profiler.record_function`` span when a
``torch.profiler`` session records on the calling thread (the autograd
engine's threads inherit it during a backward), and a shared no-op context
otherwise.  The check costs well under a microsecond; an unguarded
``record_function`` runs a dispatcher op on every entry whether or not
anything records, which the sift's host-bound trip loop would feel.  The
spans land in the profiler's trace on the same clock as its CUDA kernel
records, so a device gap can be put down to the span the host was in.

Every span of the port is named ``pyitd.<what>``.
"""
from __future__ import annotations

import functools
from contextlib import nullcontext

import torch

__all__ = ["span", "spanned"]

_OFF = nullcontext()
_recording = torch.autograd._profiler_enabled


def span(name: str):
    """A profiler span ``name`` while a profiler records on this thread,
    else a no-op context."""
    if _recording():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``
    (without a profiler the call costs one check and one frame more)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap
