"""NewGPT exploration pieces: port of ``pyitd_tpu/ml/newgpt.py``.

* :class:`WedgeTransform`: the symplectic twist ``x + x(A - Aᵀ)`` along a
  learned antisymmetric generator, per head;
* :func:`convex_softmax`: the explicit max-shifted LSE softmax;
* :class:`AlpertQueryGenerator`: queries from a Legendre/Alpert
  multiwavelet basis over per-head channel intervals, with a learned
  spectral scale;
* :class:`ExplorerEngineerStage`: a pre-LN causal-attention block applied
  as a residual mapping update.  Its attention is flax's
  ``MultiHeadDotProductAttention`` written out in torch ops with flax's
  layout: separate q/k/v projections of ``d -> (heads, d/heads)`` with
  biases, the query scaled by ``1/sqrt(d/heads)``, masked logits set to
  the dtype's lowest value, and an output projection of ``(heads,
  d/heads) -> d``.  ``torch.nn.MultiheadAttention`` packs its input
  projection and would not carry the weights across as they are.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.interop import checked_device
from . import _init

__all__ = ["WedgeTransform", "convex_softmax", "AlpertQueryGenerator",
           "ExplorerEngineerStage"]


class WedgeTransform(nn.Module):
    """x: ``(B, H, T, D)`` -> ``x + x @ (A - Aᵀ)`` per head; A starts at
    zero."""

    def __init__(self, heads: int, head_dim: int, *, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        self.A = _init.parameter(torch.zeros(heads, head_dim, head_dim,
                                             dtype=torch.float64),
                                 device, dtype)

    def forward(self, x):
        s = self.A - self.A.transpose(-1, -2)
        return x + torch.einsum("bhtd,hde->bhte", x, s)


def convex_softmax(scores: torch.Tensor, dim: int = -1) -> torch.Tensor:
    m = scores.amax(dim, keepdim=True)
    lse = m + torch.log(torch.exp(scores - m).sum(dim, keepdim=True))
    return torch.exp(scores - lse)


def _legendre_basis(interval_size: int, num_modes: int) -> np.ndarray:
    """Normalized Legendre polynomials sampled on [-1, 1]."""
    x = np.linspace(-1, 1, interval_size)
    modes = []
    for k in range(num_modes):
        coeffs = np.zeros(k + 1)
        coeffs[k] = 1.0
        poly = np.polynomial.legendre.legval(x, coeffs)
        modes.append(poly * math.sqrt((2 * k + 1) / 2))
    return np.stack(modes, axis=1)  # (interval_size, num_modes)


class AlpertQueryGenerator(nn.Module):
    """``(B, T, channels)`` -> per-head Alpert-basis queries
    ``(B, H, T, head_dim)``."""

    def __init__(self, channels: int, num_heads: int, head_dim: int, *,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"{channels} channels do not split into "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        split = channels // num_heads
        basis = np.broadcast_to(_legendre_basis(split, head_dim)[None],
                                (num_heads, split, head_dim))
        self.register_buffer("basis", torch.as_tensor(
            np.ascontiguousarray(basis), device=checked_device(device),
            dtype=dtype), persistent=False)
        self.spectral_scale = _init.parameter(
            torch.ones(1, num_heads, 1, head_dim, dtype=torch.float64),
            device, dtype)

    def forward(self, x):
        b, t, c = x.shape
        xr = x.reshape(b, t, self.num_heads, c // self.num_heads)
        q = torch.einsum("bths,hsd->bthd", xr, self.basis.to(x.dtype))
        return q.permute(0, 2, 1, 3) * self.spectral_scale


class _SelfAttention(nn.Module):
    """flax's ``nn.SelfAttention`` (``MultiHeadDotProductAttention``) on
    ``dim`` features: ``query``/``key``/``value``/``out`` in flax's
    ``DenseGeneral`` layout, flattened into ``Linear``s."""

    def __init__(self, dim: int, num_heads: int, gen, device, dtype):
        super().__init__()
        self.num_heads = num_heads
        for name in ("query", "key", "value", "out"):
            self.add_module(name, _init.dense(dim, dim, gen, device, dtype))

    def forward(self, x, mask):
        b, t, d = x.shape
        h = self.num_heads
        hd = d // h
        q = self.query(x).view(b, t, h, hd)
        k = self.key(x).view(b, t, h, hd)
        v = self.value(x).view(b, t, h, hd)
        q = q / math.sqrt(hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.out(out.reshape(b, t, d))


class ExplorerEngineerStage(nn.Module):
    """A pre-LN causal-attention "engineer" block on ``dim`` features,
    applied as a residual mapping update (returns ``x + mapping``)."""

    def __init__(self, dim: int, num_heads: int = 4, *, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        self.LayerNorm_0 = _init.layer_norm(dim, device, dtype)
        self.engineer_attn = _SelfAttention(dim, num_heads, gen, device,
                                            dtype)
        self.LayerNorm_1 = _init.layer_norm(dim, device, dtype)
        self.Dense_0 = _init.dense(dim, 4 * dim, gen, device, dtype)
        self.Dense_1 = _init.dense(4 * dim, dim, gen, device, dtype)

    def forward(self, x, mask=None):
        t = x.shape[1]
        causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        if mask is not None:
            causal = causal & mask
        h2 = x + self.engineer_attn(self.LayerNorm_0(x), causal[None, None])
        mlp = self.Dense_0(self.LayerNorm_1(h2))
        h2 = h2 + self.Dense_1(F.gelu(mlp, approximate="tanh"))
        return x + h2
