"""The one generator of signal banks: a sum of terms that a configuration's
``signal`` entry lists, made on the device from the seed.

The two configurations' terms copy the upstream benchmark's generators:
the headline bank (chirp, tone, white noise, quadratic trend;
``bench.py:349-358``) and the EEG-like bank (two tones at a random phase
per row, white noise, a random walk; ``bench.py:129-137``), with a
``torch.Generator`` on the card in place of their fixed numpy seeds.

Term kinds (``amp`` scales each):

* ``sine``: ``sin(freq * t * (1 + sweep * t) + phase)``, ``phase`` drawn per
  row from ``U(0, phase_max)`` (``sweep`` and ``phase_max`` default to 0);
* ``noise``: standard normal per sample;
* ``power``: ``t ** exponent``;
* ``walk``: the running sum of standard normal samples over ``sqrt(n)``.

``t`` runs from 0 to ``t_end_pi * pi`` in ``n`` samples.  Terms are
summed in float64, in the order listed, and the bank is cast to the
configuration's ``dtype`` once.
"""
from __future__ import annotations

import math

import torch


def make_bank(signal: dict, rows: int, n: int, gen: torch.Generator,
              device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """One ``(rows, n)`` bank; draws advance ``gen``."""
    f64 = torch.float64
    t = torch.linspace(0, signal["t_end_pi"] * math.pi, n, dtype=f64,
                       device=device)
    out = torch.zeros(rows, n, dtype=f64, device=device)
    for term in signal["terms"]:
        kind, amp = term["kind"], term["amp"]
        if kind == "sine":
            arg = term["freq"] * t * (1 + term.get("sweep", 0.0) * t)
            phase = torch.rand(rows, 1, generator=gen, dtype=f64,
                               device=device) * term.get("phase_max", 0.0)
            out += amp * torch.sin(arg[None, :] + phase)
        elif kind == "noise":
            out += amp * torch.randn(rows, n, generator=gen, dtype=f64,
                                     device=device)
        elif kind == "power":
            out += amp * t[None, :] ** term["exponent"]
        elif kind == "walk":
            steps = torch.randn(rows, n, generator=gen, dtype=f64,
                                device=device)
            out += amp * steps.cumsum_(dim=1) / math.sqrt(n)
        else:
            raise ValueError(f"unknown signal term {kind!r}")
    return out.to(dtype)
