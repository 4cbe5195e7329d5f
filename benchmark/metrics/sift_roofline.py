"""The sift's share of its roofline, in %: the least time the chip needs
for a call's work over the device's busy time per call.

The work is counted from the shapes, as the algorithm's bytes and not as
any kernel's own traffic, so the share reads the same whatever implements
the sift.  With ``L = max_iteration + 2`` output rows, a sift of a
``rows x n`` bank of ``s``-byte samples makes ``L`` extractions (the input,
then each baseline in turn); each reads its input once and writes its
rotation and its baseline once, and the correction is written once::

    bytes = s * rows * n * (3 * L + 1)

The least time is ``bytes`` over the card's memory bandwidth (``peaks.json``;
the sift does a few operations per byte, so bandwidth bounds it).  A card
that the table does not hold gives no reading.  Layer: the kernels
(``csrc/sift_level.cu``) and all other device work inside the call."""


def sift_bytes(rows: int, n: int, max_iteration: int,
               sample_bytes: int = 4) -> int:
    levels = max_iteration + 2
    return sample_bytes * rows * n * (3 * levels + 1)


def read(trace, ctx):
    peak = ctx["peaks"].get("hbm_bytes_per_s")
    busy = trace.busy_us()
    if not peak or not trace.calls or busy <= 0:
        return None
    cfg = ctx["config"]
    least_us = sift_bytes(cfg["rows"], cfg["n"], cfg["max_iteration"],
                          ctx["sample_bytes"]) / peak * 1e6
    return 100.0 * least_us / (busy / trace.calls)
