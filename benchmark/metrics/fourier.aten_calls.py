"""ATen operators that one cascade iteration dispatches on the harness's
thread, counted as operators called directly inside the benchmark's
``cascade`` span (an operator inside another counts once, with its
caller; the host read of the keep flags is one of them).  It reads the
same on a program with or without the port's own spans.  Layer: cascade
loop, ``decomp/itd_fourier.py::cascade_iteration`` and what it calls."""

NAME = "cascade"


def read(trace, ctx):
    spans = trace.spans(NAME)
    if not spans:
        return None
    return trace.top_level_ops(NAME) / len(spans)
