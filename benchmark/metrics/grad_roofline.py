"""The gradient call's share of its roofline, in %: the least time the
chip needs for a call's work over the device's busy time per call.

The work is counted from the shapes, as the algorithm's bytes and not as
any kernel's own traffic, so the share reads the same whatever implements
the sift and its backward.  With ``L = max_iteration + 2`` output rows, a
``rows x n`` bank of ``s``-byte samples:

* the forward is the sift's ``3 L + 1`` streams (``sift_roofline``): each
  of the ``L`` extractions reads its input and writes its rotation and its
  baseline, and the correction is written once;
* each of the ``L`` level adjoints reads the level's input and the two
  cotangents that reach it (of its rotation and of its baseline) and
  writes the cotangent of its input: four streams;
* the backward replays nothing: a replayed forward is an implementation's
  choice, not the algorithm's work.

So ``bytes = s * rows * n * (7 L + 1)``, and the least time is ``bytes``
over the card's memory bandwidth (``peaks.json``; the sift and its adjoint
do a few operations per byte, so bandwidth bounds them).  A card that the
table does not hold gives no reading.  Layer: the kernels and all other
device work inside the call."""


def grad_bytes(rows: int, n: int, max_iteration: int,
               sample_bytes: int = 4) -> int:
    levels = max_iteration + 2
    return sample_bytes * rows * n * (7 * levels + 1)


def read(trace, ctx):
    peak = ctx["peaks"].get("hbm_bytes_per_s")
    busy = trace.busy_us()
    if not peak or not trace.calls or busy <= 0:
        return None
    cfg = ctx["config"]
    least_us = grad_bytes(cfg["rows"], cfg["n"], cfg["max_iteration"],
                          ctx["sample_bytes"]) / peak * 1e6
    return 100.0 * least_us / (busy / trace.calls)
