"""Calls per call of the level adjoint's own kernels, from their spans
``pyitd.bwd_knots``, ``pyitd.bwd_pre`` and ``pyitd.bwd_post`` on every
thread (``ops/cuda_fill.py``; on the card each is one launch, three per
level adjoint).  Counted apart from ``wrappers.*``, which keep the seven
wrappers of ``spans.WRAPPERS``.  A program without these kernels records
none of the spans and gives no reading.  Layer: the backward."""
from benchmark import spans

FUSED = ("pyitd.bwd_knots", "pyitd.bwd_pre", "pyitd.bwd_post")


def read(trace, ctx):
    return spans.count_per_call(trace, FUSED)
