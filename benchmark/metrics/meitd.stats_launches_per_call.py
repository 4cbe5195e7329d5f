"""Gate-statistics launches per call: the ``pyitd.walk_stats`` spans
(``ops/wpe.py::walk_stats_cuda``, one launch of ``walk_stats_kernel`` for a
stage's extrema counts and entropies, and one for the WPE sort of the
stacks) per ``bench.call``: the walk's reads plus one.  A program without
the span gives no reading.  Layer: the walk."""
from benchmark import spans


def read(trace, ctx):
    return spans.count_per_call(trace, "pyitd.walk_stats")
