"""Host ms per call in the levels' structural adjoints: the summed duration
of the ``pyitd.level_bwd`` spans (``ops/linear_baseline.py::
_StructuralLevel.backward``, on the autograd engine's thread).  Layer: the
backward."""
from benchmark import spans


def read(trace, ctx):
    return spans.total_ms(trace, "pyitd.level_bwd")
