"""Moving data between numpy and the port.

The decompositions have no parameters, so what crosses between the JAX
package and this one is the input signal, the result layouts
(``SiftResult``'s ``(levels, *batch, n)``, level axis first;
``MeitdResult`` and ``EnsembleResult`` field by field) and the streaming
tier's carried ``StreamState`` (:func:`stream_state_from_numpy`).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_numpy", "checked_device", "as_input", "result_to_numpy",
           "stream_state_from_numpy"]


def from_numpy(x, device=None) -> torch.Tensor:
    """A tensor on ``device`` with the dtype and values of ``x``."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def checked_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA device and "
            "torch.cuda.is_available() is false; pass device='cpu' to run "
            "on the CPU")
    return device


def as_input(data, dtype: torch.dtype | None, device) -> torch.Tensor:
    """An entry point's input as a ``dtype`` tensor (``None``: its own
    dtype): a tensor stays on its own device; anything else (numpy, lists)
    goes to ``device``, and a CUDA ``device`` without a card raises."""
    if isinstance(data, torch.Tensor):
        return data if dtype is None else data.to(dtype)
    return torch.as_tensor(np.asarray(data), dtype=dtype,
                           device=checked_device(device))


def result_to_numpy(res):
    """One of the port's result tuples (``SiftResult``, ``MeitdResult``,
    ``EnsembleResult``, ``EFDResult``) with every field as a numpy array,
    in the JAX layout."""
    return type(res)(*(t.detach().cpu().numpy() for t in res))


def stream_state_from_numpy(state, device="cuda"):
    """JAX's ``StreamState`` (``window``, ``filled``), as numpy arrays or
    anything ``np.asarray`` takes, as the port's ``StreamState`` on
    ``device``: a stream started in JAX continues in the port."""
    from ..decomp.streaming import StreamState

    window, filled = state
    return StreamState(window=as_input(window, None, device),
                       filled=as_input(filled, torch.int32, device))
