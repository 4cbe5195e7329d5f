"""Host ms per call in the kernel sift's own loop: the ``pyitd.sift`` spans'
self time, their duration less the kernel wrapper spans inside them.  That
is the loop's Python and eager glue (``x2 * 0``, ``zeros_like``,
``SiftCarry.zeros``, the trips' bookkeeping, the early-exit read).  Layer:
the trip loop, ``decomp/itd.py::_itd_sift_kernel``."""
from benchmark import spans


def read(trace, ctx):
    return spans.self_ms(trace, "pyitd.sift", spans.WRAPPERS)
