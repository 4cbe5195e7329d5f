"""Moving data between numpy and the port.

The decompositions have no parameters, so what crosses between the JAX
package and this one is the input signal, the result layouts
(``SiftResult``'s ``(levels, *batch, n)``, level axis first;
``MeitdResult`` and ``EnsembleResult`` field by field) and the streaming
tier's carried ``StreamState`` (:func:`stream_state_from_numpy`).  The
models of ``ml/`` carry their weights across with
:func:`load_flax_params`.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_numpy", "checked_device", "as_input", "result_to_numpy",
           "stream_state_from_numpy", "load_flax_params"]


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


def _dense_kernel(kernel: np.ndarray, lin) -> np.ndarray:
    """A flax ``Dense`` kernel ``(in, out)``, or a ``DenseGeneral`` kernel
    whose leading axes multiply to ``in`` and trailing axes to ``out``
    (``(d, heads, d/heads)`` or ``(heads, d/heads, d)``), as the
    ``Linear``'s ``(out, in)`` weight."""
    for cut in range(1, kernel.ndim):
        if (int(np.prod(kernel.shape[:cut])) == lin.in_features
                and int(np.prod(kernel.shape[cut:])) == lin.out_features):
            return kernel.reshape(lin.in_features, lin.out_features).T
    raise ValueError(f"kernel {kernel.shape} does not fit Linear("
                     f"{lin.in_features}, {lin.out_features})")


def _leaf_target(module, name: str, value: np.ndarray):
    """The torch parameter that flax's leaf ``name`` of ``module`` fills,
    and the value in its layout."""
    from torch import nn

    if isinstance(module, nn.Linear):
        if name == "kernel":
            return module.weight, _dense_kernel(value, module)
        if name == "bias" and module.bias is not None:
            return module.bias, value.reshape(-1)
    elif isinstance(module, nn.LayerNorm) and name in ("scale", "bias"):
        target = module.weight if name == "scale" else module.bias
        if target is not None:
            return target, value
    elif isinstance(module, nn.Embedding) and name == "embedding":
        return module.weight, value
    elif isinstance(module._parameters.get(name), nn.Parameter):
        return module._parameters[name], value
    return None, value


def load_flax_params(module, params) -> None:
    """Copy a flax parameter tree into the torch ``module``, in place.

    ``params`` is the tree as nested dicts of numpy arrays (or anything
    ``np.asarray`` takes), with or without the outer ``{"params": ...}``.
    A sub-dict fills the child module of the same name; a ``Dense`` kernel
    fills a ``Linear``'s weight transposed (a ``DenseGeneral`` kernel is
    first flattened to ``(in, out)``), ``bias`` its bias; a ``LayerNorm``'s
    ``scale`` fills ``weight``; an ``Embed``'s ``embedding`` fills
    ``weight``; any other leaf fills the parameter of its own name (the
    MoE banks ``W1``/``W2``/``b2``, ``LinearBilinear``'s ``U``/``V``, the
    tapes' ``U1``..``U3``, a ``Mixer``'s ``dw``).  The port's submodules
    carry flax's names (``expert_i/Dense_k``, ``enc1``/``dec1``,
    ``LayerNorm_k``, ``LowRankShift_0``, ``convolve1/out``), so one walk
    fills every model of ``ml/``.  Raises ``ValueError`` on a shape that
    differs, a leaf with no counterpart, or a parameter of ``module`` that
    no leaf filled."""
    import torch

    if isinstance(params, dict) and set(params) == {"params"}:
        params = params["params"]
    filled: set[int] = set()

    def walk(mod, tree, prefix):
        for key, val in tree.items():
            where = f"{prefix}{key}"
            if isinstance(val, dict):
                child = mod._modules.get(key)
                if child is None:
                    raise ValueError(f"flax subtree {where!r} has no child "
                                     f"module of that name")
                walk(child, val, where + ".")
                continue
            value = np.asarray(val)
            target, value = _leaf_target(mod, key, value)
            if target is None:
                raise ValueError(f"flax leaf {where!r} has no torch "
                                 f"parameter")
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"flax leaf {where!r}: shape "
                                 f"{tuple(value.shape)} against the torch "
                                 f"parameter's {tuple(target.shape)}")
            if id(target) in filled:
                raise ValueError(f"flax leaf {where!r} fills a parameter "
                                 f"twice")
            with torch.no_grad():
                target.copy_(torch.from_numpy(np.array(value)))
            filled.add(id(target))

    walk(module, params, "")
    missing = [n for n, p in module.named_parameters()
               if id(p) not in filled]
    if missing:
        raise ValueError(f"torch parameters no flax leaf filled: {missing}")
