"""Sequential plain-numpy oracle of the canonical ITD sift (a frozen copy
of ``tests/reference/itd_ref.py``), in float64.  The benchmark's tests hold
the vectorised reference (``reference/itd.py``) against it.

Sequential and index-based on purpose, so it is easy to audit against the
upstream ``ITD.py`` by eye.  It reproduces the upstream quirks exactly:

* plateau-rightmost extrema, endpoints excluded;
* end knots = mean of first/last two samples;
* linear-in-value interpolation between knots, last sample left at 0;
* stop A (<2 extrema): residual := previously stored baseline;
* stop B (level budget exhausted): residual := rotation + baseline.
"""
from __future__ import annotations

import numpy as np


def find_extrema(x: np.ndarray) -> np.ndarray:
    """Sorted indices of all interior extrema (plateau-rightmost rule)."""
    n = x.size
    if n < 3:
        return np.empty(0, dtype=np.int64)
    out = []
    for i in range(1, n - 1):
        db = x[i] - x[i - 1]
        df = x[i + 1] - x[i]
        if (db <= 0 and df > 0) or (db >= 0 and df < 0):
            out.append(i)
    return np.asarray(out, dtype=np.int64)


def baseline_extract(x: np.ndarray):
    """One canonical ITD level: returns (rotation, baseline, num_extrema)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.size
    ext = find_extrema(x)
    tau = np.concatenate([[0], ext, [n - 1]]).astype(np.int64)
    k = tau.size

    knot = np.zeros(k)
    knot[0] = 0.5 * (x[0] + x[1])
    knot[-1] = 0.5 * (x[-2] + x[-1])
    for j in range(1, k - 1):
        w = (tau[j] - tau[j - 1]) / (tau[j + 1] - tau[j - 1])
        knot[j] = 0.5 * (x[tau[j - 1]] + w * (x[tau[j + 1]] - x[tau[j - 1]])) + 0.5 * x[tau[j]]

    baseline = np.zeros_like(x)
    for j in range(k - 1):
        lo, hi = tau[j], tau[j + 1]
        den = x[hi] - x[lo]
        seg = x[lo:hi] - x[lo]
        slope = 0.0 if den == 0 else (knot[j + 1] - knot[j]) / den
        baseline[lo:hi] = knot[j] + slope * seg
    # reference quirk: final sample never written -> stays 0
    return x - baseline, baseline, ext.size


def itd_sift(data: np.ndarray, max_iteration: int = 11):
    """Canonical sift loop; returns (rotations array, stop_reason)."""
    x = np.asarray(data, dtype=np.float64)
    rows = []
    prev_base = np.zeros_like(x)  # mirrors baselines[-1] == zeros at start
    rotation, baseline, _ = baseline_extract(x)
    counter = 0
    while True:
        # min-count + max-count in the reference == merged count (disjoint)
        nex = find_extrema(baseline).size
        if nex < 2:
            rows.append(prev_base.copy())
            return np.stack(rows), "A"
        if counter > max_iteration:
            rows.append(rotation + baseline)
            return np.stack(rows), "B"
        rows.append(rotation.copy())
        prev_base = baseline.copy()
        rotation, baseline, _ = baseline_extract(baseline)
        counter += 1
