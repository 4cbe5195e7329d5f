"""Host reads per call: the ``pyitd.read`` spans (``decomp/meitd.py::
_read``, one device-to-host copy of the counts and entropies a stage of
the walk decides on, and so one wait for the device) per ``bench.call``.
A program without the span gives no reading.  Layer: the walk."""
from benchmark import spans


def read(trace, ctx):
    return spans.count_per_call(trace, "pyitd.read")
