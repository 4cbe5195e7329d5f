"""The cascade call's share of its roofline, in %: the least time the chip
needs for one iteration's work over the device's busy time per call.

The work is counted from the shapes, as the algorithm's and not as any
implementation's, so the share reads the same whatever implements the
iteration.  For ``rows`` signals of ``n`` samples of ``s`` bytes and a comb
of ``F`` frequencies (ten at ``sample_rate`` 2,048):

* bytes: the input read once, and the ``F`` rotations, the residual, the
  update and the ``F`` weighted half spectra of the modes (``n / 2 + 1``
  complex values, counted as ``n`` samples) written once, ``s * rows * n *
  (2 F + 3)``; the knot values, moments and spectra are an
  implementation's temporaries;
* operations: ``2.5 N log2 N`` for a real transform of ``N`` points (half
  the ``5 N log2 N`` of a complex one), for the ``F`` rotations' rffts and
  the one irfft of the summed modes (``N = n``), a signal; the template
  baselines, the peak search and the weights are not counted.

The least time is the larger of bytes over the card's memory bandwidth
and operations over its float32 rate (``peaks.json``): at one signal of
2^20 samples and F = 10, 96.5 MB take 0.0288 ms and 0.58 GFLOP 0.0086 ms,
so the bytes bound it.  The call launches no kernel of the port, so this
is the whole call's share.  A run without the benchmark's ``cascade``
span or on a card the table does not hold gives no reading.  Layer: the
kernels and all other device work inside the call."""
import math

NAME = "cascade"


def comb_size(sample_rate: int) -> int:
    """``F``: the comb ``arange(2, sr / 2 - 1, 96)`` less its first entry
    in descending order."""
    return len(range(2, math.ceil(sample_rate / 2 - 1), 96)) - 1


def cascade_bytes(rows: int, n: int, comb: int, sample_bytes: int = 4) -> int:
    return sample_bytes * rows * n * (2 * comb + 3)


def cascade_flops(rows: int, n: int, comb: int) -> float:
    return rows * (comb + 1) * 2.5 * n * math.log2(n)


def read(trace, ctx):
    peaks = ctx["peaks"]
    bw, rate = peaks.get("hbm_bytes_per_s"), peaks.get("f32_flops")
    busy = trace.busy_us()
    if not trace.spans(NAME) or not bw or not rate or not trace.calls \
            or busy <= 0:
        return None
    cfg = ctx["config"]
    comb = comb_size(cfg["sample_rate"])
    least_s = max(
        cascade_bytes(cfg["rows"], cfg["n"], comb, ctx["sample_bytes"]) / bw,
        cascade_flops(cfg["rows"], cfg["n"], comb) / rate)
    return 100.0 * least_s * 1e6 / (busy / trace.calls)
