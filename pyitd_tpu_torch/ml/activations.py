"""Activations: port of ``pyitd_tpu/ml/activations.py``."""
from __future__ import annotations

import torch

__all__ = ["rainstar"]


def rainstar(x: torch.Tensor) -> torch.Tensor:
    """Blended sigmoid-gated activation: ``neg = (x·σ(x))² + x/(1+|x|)``,
    ``pos = x − x/(1+|x|)``, ``out = neg·σ(−x) + pos·σ(x)``."""
    sig = torch.sigmoid(x)
    soft = x / (1.0 + x.abs())
    neg = (x * sig) ** 2 + soft
    pos = x - soft
    return neg * torch.sigmoid(-x) + pos * sig
