"""Moving data between numpy and the port.

The sift has no parameters, so what crosses between the JAX package and
this one is the input signal and the ``SiftResult`` layout
``(levels, *batch, n)``, level axis first.
"""
from __future__ import annotations

import numpy as np
import torch

from ..decomp.itd import SiftResult

__all__ = ["from_numpy", "sift_result_to_numpy"]


def from_numpy(x, device=None) -> torch.Tensor:
    """A tensor on ``device`` with the dtype and values of ``x``."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def sift_result_to_numpy(res: SiftResult) -> SiftResult:
    """The five ``SiftResult`` fields as numpy arrays, in the JAX layout."""
    return SiftResult(*(t.detach().cpu().numpy() for t in res))
