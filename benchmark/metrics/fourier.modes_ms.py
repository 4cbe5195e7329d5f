"""Device ms per call in kernels launched inside the ``pyitd.fourier_modes``
spans (``decomp/itd_fourier.py::cascade_iteration`` after its sift: the
rotations' batched rfft, the peak search and band weights of
``_mode_weights_any`` or ``_mode_weights_valid``, the keep flags, the
summed irfft and the update).  A program without the span gives no
reading.  Layer: Fourier modes."""
from benchmark import spans

NAME = "pyitd.fourier_modes"


def read(trace, ctx):
    if not trace.spans(NAME):
        return None
    return spans.per_call_ms(
        trace, sum(e.dur for e in trace.kernels_launched_in(NAME)))
