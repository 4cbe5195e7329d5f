"""Device ms per call in kernels launched inside the ``pyitd.sine_sift``
spans (``decomp/itd_fourier.py::itd_sine_sift``: one template baseline a
comb entry, ``ops/cubic_baseline.py::_template_fast_baseline_static``, each
its knot-value gather, the banded moment doubling and the 7-channel row
gather and evaluation, and the subtraction that makes its rotation).  A
program without the span gives no reading.  Layer: sine-template sift."""
from benchmark import spans

NAME = "pyitd.sine_sift"


def read(trace, ctx):
    if not trace.spans(NAME):
        return None
    return spans.per_call_ms(
        trace, sum(e.dur for e in trace.kernels_launched_in(NAME)))
