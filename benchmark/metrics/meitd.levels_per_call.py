"""Cubic levels per call: the ``pyitd.cubic_level`` spans (``decomp/
meitd.py::_cubic``, one ``cubic_baseline_extract`` over the rows that need
an extraction at one stage of a trip) per ``bench.call``.  A program
without the span gives no reading.  Layer: the walk."""
from benchmark import spans


def read(trace, ctx):
    return spans.count_per_call(trace, "pyitd.cubic_level")
