"""Host ms per call in the backward's replayed forward: the summed
duration of the ``pyitd.replay`` spans (``decomp/itd.py::
_KernelSift.backward``'s ``_itd_sift_torch`` with structural levels on the
kernels).  Layer: the backward."""
from benchmark import spans


def read(trace, ctx):
    return spans.total_ms(trace, "pyitd.replay")
