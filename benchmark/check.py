"""The verdict that decides ``correct``.

After the window, each call in the seeded sample of completed calls is
judged against the plain reference: the cell's call module
(``calls/<call>.py``) runs the reference on the same input and gives the
compared numbers of the call.  Each number, the worst over the sample, is
held to its limit from the traffic's file; a number that is not finite
fails.
"""
from __future__ import annotations

import math


def worst(readings: list[dict]) -> dict:
    """Per number, the worst reading (NaN beats everything)."""
    out = {}
    for r in readings:
        for k, v in r.items():
            old = out.get(k)
            if old is None or math.isnan(v) or (not math.isnan(old)
                                                and v > old):
                out[k] = v
    return out


def judge(got: dict, limits: dict) -> tuple[bool, list[list]]:
    """``(correct, [[name, value, limit], ...])``: every number finite and
    within its limit."""
    rows = [[k, got[k], limits[k]] for k in sorted(got)]
    ok = bool(rows) and all(math.isfinite(v) and v <= lim
                            for _, v, lim in rows)
    return ok, rows
