"""Device ms per call in kernels launched inside the ``pyitd.efd_bands``
spans (``decomp/efd.py::_efd_bands``: the symmetric x2 mirror and its rfft,
the band masks over ``(rows, n_bands + 2, n + 1)`` spectra, the batched
irfft and the crop).  A program without the span gives no reading.
Layer: EFD filterbank."""
from benchmark import spans

NAME = "pyitd.efd_bands"


def read(trace, ctx):
    if not trace.spans(NAME):
        return None
    return spans.per_call_ms(
        trace, sum(e.dur for e in trace.kernels_launched_in(NAME)))
