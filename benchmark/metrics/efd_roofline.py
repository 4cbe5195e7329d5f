"""The EFD call's share of its roofline, in %: the least time the chip
needs for a call's work over the device's busy time per call.

The work is counted from the shapes, as the algorithm's and not as any
implementation's, so the share reads the same whatever implements EFD.
For a ``rows x n`` bank of ``s``-byte samples and ``B = n_bands`` bands
(``B + 2`` band rows a signal):

* bytes: the input read once and the ``B + 2`` band rows written once,
  ``s * rows * n * (B + 3)``; the spectra, the mirror and the masks are an
  implementation's temporaries;
* operations: ``2.5 N log2 N`` for a real transform of ``N`` points (half
  the ``5 N log2 N`` of a complex one), for the input's rfft (``N = n``),
  the mirror's rfft (``N = 2 n``) and the ``B + 2`` bands' inverse
  transforms (``N = 2 n``), a signal; the sort, the argmins and the masks
  are not counted.

The least time is the larger of bytes over the card's memory bandwidth
and operations over its float32 rate (``peaks.json``): at 8 x 2^20 and
12 bands, 503 MB take 0.150 ms and 13.63 GFLOP 0.2034 ms, so the
transforms bound it.  A program without the span ``pyitd.efd`` (whose
calls cannot be told to be EFD's) or a card the table does not hold gives
no reading.  Layer: the kernels and all other device work inside the
call."""
import math

NAME = "pyitd.efd"


def efd_bytes(rows: int, n: int, n_bands: int, sample_bytes: int = 4) -> int:
    return sample_bytes * rows * n * (n_bands + 3)


def efd_flops(rows: int, n: int, n_bands: int) -> float:
    def real_fft(points):
        return 2.5 * points * math.log2(points)
    return rows * (real_fft(n) + (n_bands + 3) * real_fft(2 * n))


def read(trace, ctx):
    peaks = ctx["peaks"]
    bw, rate = peaks.get("hbm_bytes_per_s"), peaks.get("f32_flops")
    busy = trace.busy_us()
    if not trace.spans(NAME) or not bw or not rate or not trace.calls \
            or busy <= 0:
        return None
    cfg = ctx["config"]
    least_s = max(
        efd_bytes(cfg["rows"], cfg["n"], cfg["n_bands"],
                  ctx["sample_bytes"]) / bw,
        efd_flops(cfg["rows"], cfg["n"], cfg["n_bands"]) / rate)
    return 100.0 * least_s * 1e6 / (busy / trace.calls)
