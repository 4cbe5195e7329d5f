"""Host ms per call in the kernel sift's backward outside its replay and
its level adjoints: the ``pyitd.sift_bwd`` spans' self time, less their
``pyitd.replay`` and ``pyitd.level_bwd`` children.  That is the autograd
engine's nodes through the replay's eager glue.  Layer: the backward."""
from benchmark import spans


def read(trace, ctx):
    return spans.self_ms(trace, "pyitd.sift_bwd",
                         ("pyitd.replay", "pyitd.level_bwd"))
