"""Flax's parameter initializers, drawn from an explicit ``torch.Generator``.

``torch.nn.Linear`` and friends initialize with Kaiming-uniform weights
and uniform biases; flax draws other distributions, and a model started
from other weights trains differently.  Every draw here happens on the
CPU in float64 from the caller's CPU generator and is then cast and
copied to the parameter's device, so one seed gives the same weights on
every device and (up to rounding) in every dtype.

Flax's conventions, with a Dense kernel stored ``(in, out)``:

* ``lecun_normal``: truncated normal at two standard deviations, scaled so
  that the variance is ``1 / fan_in``;
* ``he_uniform``: uniform with variance ``2 / fan_in``;
* ``xavier_uniform``: uniform with variance ``2 / (fan_in + fan_out)``;
* ``default_embed_init``: normal with standard deviation ``1/sqrt(width)``;
* ``orthogonal``: rows (or columns) of a QR factor, signs fixed by R's
  diagonal;
* biases zero, LayerNorm scales one.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..utils.interop import checked_device

__all__ = ["generator_or_default", "truncated_normal", "lecun_normal",
           "he_uniform", "xavier_uniform", "normal", "orthogonal",
           "parameter", "dense", "layer_norm", "embed", "put"]

# flax's variance_scaling: stddev of the unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def generator_or_default(generator) -> torch.Generator:
    """The caller's CPU generator, or a new one seeded 0 (flax's modules
    take an explicit key; so does every module of the port, with this as
    its default)."""
    if generator is None:
        return torch.Generator().manual_seed(0)
    if generator.device.type != "cpu":
        raise ValueError("parameter draws take a CPU torch.Generator")
    return generator


def truncated_normal(shape, std: float, generator) -> torch.Tensor:
    """Normal of standard deviation ``std / 0.8796...`` truncated to two of
    its deviations (flax's ``truncated_normal`` scaling): the inverse CDF
    of a uniform draw between the two tails."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    u = lo + (1.0 - 2.0 * lo) * u
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return z.clamp(-2.0, 2.0) * (std / _TRUNC_STD)


def lecun_normal(shape, fan_in: int, generator) -> torch.Tensor:
    return truncated_normal(shape, math.sqrt(1.0 / fan_in), generator)


def _uniform(shape, limit: float, generator) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    return (2.0 * u - 1.0) * limit


def he_uniform(shape, fan_in: int, generator) -> torch.Tensor:
    return _uniform(shape, math.sqrt(3.0 * 2.0 / fan_in), generator)


def xavier_uniform(shape, fan_in: int, fan_out: int,
                   generator) -> torch.Tensor:
    return _uniform(shape, math.sqrt(3.0 * 2.0 / (fan_in + fan_out)),
                    generator)


def normal(shape, std: float, generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float64) * std


def orthogonal(shape, generator) -> torch.Tensor:
    """Flax's ``orthogonal()`` (``column_axis=-1``): the last axis holds
    the columns; with fewer rows than columns the rows are orthonormal,
    else the columns."""
    cols = shape[-1]
    rows = math.prod(shape) // cols
    tall = (cols, rows) if rows < cols else (rows, cols)
    a = torch.randn(tall, generator=generator, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    return q.reshape(shape)


def parameter(values: torch.Tensor, device, dtype) -> nn.Parameter:
    """``values`` (drawn on the CPU) as a parameter on ``device``."""
    return nn.Parameter(values.to(device=checked_device(device),
                                  dtype=dtype, copy=True))


def put(param: torch.Tensor, values: torch.Tensor) -> None:
    """Copy CPU draws into an existing parameter."""
    with torch.no_grad():
        param.copy_(values.reshape(param.shape))


def dense(in_features: int, out_features: int, generator, device, dtype,
          bias: bool = True, init: str = "lecun") -> nn.Linear:
    """``flax.linen.Dense``: weight ``(out, in)`` (flax's kernel
    transposed) drawn by ``init`` (``"lecun"`` or ``"he"``), bias zero."""
    lin = nn.utils.skip_init(nn.Linear, in_features, out_features,
                             bias=bias, device=checked_device(device),
                             dtype=dtype)
    draw = lecun_normal if init == "lecun" else he_uniform
    put(lin.weight, draw((out_features, in_features), in_features,
                         generator))
    if bias:
        with torch.no_grad():
            lin.bias.zero_()
    return lin


def layer_norm(width: int, device, dtype, bias: bool = True) -> nn.LayerNorm:
    """``flax.linen.LayerNorm``: epsilon 1e-6 (torch's default is 1e-5),
    scale one, bias zero."""
    return nn.LayerNorm(width, eps=1e-6, bias=bias,
                        device=checked_device(device), dtype=dtype)


def embed(num: int, width: int, generator, device, dtype) -> nn.Embedding:
    """``flax.linen.Embed``: ``default_embed_init``, a normal of standard
    deviation ``1/sqrt(width)``."""
    emb = nn.utils.skip_init(nn.Embedding, num, width,
                             device=checked_device(device), dtype=dtype)
    put(emb.weight, normal((num, width), 1.0 / math.sqrt(width), generator))
    return emb
