"""Host ms per call in the MEITD walk's own work: the ``pyitd.walk`` spans
(``decomp/meitd_jit.py::_walk``) less the cubic levels, host reads and
entropies inside them (``pyitd.cubic_level``, ``pyitd.read``,
``pyitd.wpe``).  That is the state machine's index sets, the gathers and
scatters of rows into the (R, 44, n) buffers, the extrema counts and the
subtractions.  Layer: the walk."""
from benchmark import spans


def read(trace, ctx):
    return spans.self_ms(trace, "pyitd.walk",
                         ("pyitd.cubic_level", "pyitd.read", "pyitd.wpe"))
