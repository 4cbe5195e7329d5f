"""Device ms per call in kernels launched inside the ``pyitd.efd_segments``
spans (``decomp/efd.py::spectral_segments``: the local maxima of the half
spectrum, the descending sort of 262,144 bins a row, the plateau dedup,
the top ``n_bands`` and the argmins between them).  A program without the
span gives no reading.  Layer: EFD segmentation."""
from benchmark import spans

NAME = "pyitd.efd_segments"


def read(trace, ctx):
    if not trace.spans(NAME):
        return None
    return spans.per_call_ms(
        trace, sum(e.dur for e in trace.kernels_launched_in(NAME)))
