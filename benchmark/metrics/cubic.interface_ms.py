"""Host ms per call in the cubic level's interface solve over SPIKE
blocks: the summed duration of the ``pyitd.interface_solve`` spans
(``ops/cuda_cubic.py::spike_interface``, ``chained_pcr.
reduced_interface_solve`` in eager PyTorch).  Layer: the cubic level."""
from benchmark import spans


def read(trace, ctx):
    return spans.total_ms(trace, "pyitd.interface_solve")
