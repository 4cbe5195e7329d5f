"""Device ms per call in kernels launched inside the ``pyitd.cubic_level``
spans that are none of the port's own: the cubic level's eager PyTorch
(the not-a-knot rows, the interface solve, the end moments, the casts).
The port's kernels are known, as ``backward.eager_ms`` knows them, by the
names of the ``__global__`` functions in ``pyitd_tpu_torch/csrc``.  A
program without the span gives no reading.  Layer: the cubic level."""
from benchmark import run, spans

NAME = "pyitd.cubic_level"


def read(trace, ctx):
    if not trace.spans(NAME):
        return None
    ours = run.load_metric("backward.eager_ms").port_kernels()
    us = sum(e.dur for e in trace.kernels_launched_in(NAME)
             if not any(k in e.name for k in ours))
    return spans.per_call_ms(trace, us)
