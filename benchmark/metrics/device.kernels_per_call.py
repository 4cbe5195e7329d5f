"""Device kernels per call: the kernel records of the window plus the
launches whose record the profiler lost, over the calls.  Layer: the kernel
wrappers (``ops/cuda_fill.py``) and the eager glue around them."""


def read(trace, ctx):
    if not trace.calls or not trace.kernels:
        return None
    return (len(trace.kernels) + trace.missing) / trace.calls
