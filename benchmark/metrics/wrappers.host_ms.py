"""Host ms per call inside the kernel wrappers of ``ops/cuda_fill.py``: the
summed duration of their spans (``pyitd.level_summaries`` ...
``pyitd.segsum``) on every thread, each a wrapper's checks, allocations,
ctypes launch and error check.  Layer: the kernel wrappers."""
from benchmark import spans


def read(trace, ctx):
    return spans.total_ms(trace, spans.WRAPPERS)
