"""Kernel wrapper calls per call, from their spans on every thread: on the
card each is one launch of the port's kernels, counted where it is made
(``device.kernels_per_call`` less this is the eager kernels).  Layer: the
kernel wrappers."""
from benchmark import spans


def read(trace, ctx):
    return spans.count_per_call(trace, spans.WRAPPERS)
