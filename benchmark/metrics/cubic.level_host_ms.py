"""Host ms per call inside the cubic levels: the summed duration of the
``pyitd.cubic_level`` spans (``decomp/meitd.py::_cubic`` around
``cubic_baseline_extract``: the sift pre-pass, the four kernel wrappers of
``ops/cuda_cubic.py``, the not-a-knot rows and end moments in eager
PyTorch, and the interface solve).  Layer: the cubic level."""
from benchmark import spans


def read(trace, ctx):
    return spans.total_ms(trace, "pyitd.cubic_level")
