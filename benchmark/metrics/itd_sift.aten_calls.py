"""ATen operators that one ``itd_sift`` call dispatches on the harness's
thread, counted as operators called directly inside the ``itd_sift`` span
(an operator inside another counts once, with its caller).  Layer: the trip
loop, ``decomp/itd.py::itd_sift`` and ``_itd_sift_kernel``."""


def read(trace, ctx):
    spans = trace.spans("itd_sift")
    if not spans:
        return None
    return trace.top_level_ops("itd_sift") / len(spans)
