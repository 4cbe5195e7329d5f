"""The device's idle share of the traced window: 1 minus the union of its
kernel, copy and fill intervals (missing records made up) over the
window's length.  Layer: the device."""


def read(trace, ctx):
    if not trace.device or trace.window_us <= 0:
        return None
    return 1.0 - trace.busy_us() / trace.window_us
