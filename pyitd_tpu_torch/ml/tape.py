"""Tape transformer and matrix-exponential layers: port of
``pyitd_tpu/ml/tape.py``.

* :func:`reference_activation`: the rectified-KAN activation
  (``log1p``-compress, then ``x/sqrt(1+24x²)``);
* :class:`RectifiedKAN`: expand -> activation -> project;
* :class:`CachedMultiheadAttention`: multi-head attention with an explicit
  KV cache threaded through calls (incremental decoding);
* :class:`TapeHeadBlock`: sinusoidal position + RoPE + cached attention +
  RectifiedKAN with pre-norm residuals;
* :class:`MLayer`: inputs to a generator combination, matrix-exponentiated
  (``torch.linalg.matrix_exp``, or scaling and squaring);
* :class:`LieMLayer`: so(2) block rotations in a learned orthogonal frame.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..utils.interop import checked_device
from . import _init

__all__ = [
    "reference_activation",
    "RectifiedKAN",
    "CachedMultiheadAttention",
    "TapeHeadBlock",
    "MLayer",
    "LieMLayer",
    "sinusoidal_embedding",
    "apply_rope",
]


def reference_activation(x, gamma: float = 24.0):
    log_x = torch.sign(x) * torch.log1p(x.abs())
    return log_x / torch.sqrt(1.0 + gamma * log_x**2)


class RectifiedKAN(nn.Module):
    def __init__(self, dim: int, expansion_factor: int = 8, *, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        self.Dense_0 = _init.dense(dim, expansion_factor * dim, gen, device,
                                   dtype)
        self.Dense_1 = _init.dense(expansion_factor * dim, dim, gen, device,
                                   dtype, bias=False)

    def forward(self, x):
        return self.Dense_1(reference_activation(self.Dense_0(x)))


def sinusoidal_embedding(seq_len: int, embed_dim: int) -> np.ndarray:
    pos = np.arange(seq_len)[:, None]
    div = np.exp(np.arange(0, embed_dim, 2) * -(math.log(10000.0) / embed_dim))
    out = np.zeros((seq_len, embed_dim))
    out[:, 0::2] = np.sin(pos * div)
    # odd embed_dim: the cos lane has one fewer column than div
    out[:, 1::2] = np.cos(pos * div)[:, : embed_dim // 2]
    return out


def apply_rope(x, offset: int = 0):
    """RoPE on interleaved pairs of ``(B, S, D)``, positions from
    ``offset``."""
    b, s, d = x.shape
    half = d // 2
    freqs = torch.as_tensor(1.0 / (10000.0 ** (np.arange(half) / half)),
                            dtype=x.dtype, device=x.device)
    pos = torch.arange(offset, offset + s, dtype=x.dtype, device=x.device)
    theta = pos[:, None] * freqs[None, :]
    cos, sin = torch.cos(theta)[None], torch.sin(theta)[None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(b, s, d)


class CachedMultiheadAttention(nn.Module):
    """``forward(query, key, value, past_kv=None)`` returns ``(out, (k,
    v))``; ``k`` and ``v`` are the projected keys and values of every
    position so far, ``(B, S_total, dim)``."""

    def __init__(self, dim: int, num_heads: int, *, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        self.num_heads = num_heads
        for name in ("wq", "wk", "wv", "wo"):
            self.add_module(name, _init.dense(dim, dim, gen, device, dtype))

    def forward(self, query, key, value, past_kv=None):
        d = query.shape[-1]
        hd = d // self.num_heads
        k = self.wk(key)
        v = self.wv(value)
        if past_kv is not None:
            k = torch.cat([past_kv[0], k], dim=1)
            v = torch.cat([past_kv[1], v], dim=1)
        q = self.wq(query)

        def heads(a):
            return a.reshape(a.shape[0], a.shape[1], self.num_heads,
                             hd).transpose(1, 2)

        att = torch.einsum("bhqd,bhkd->bhqk", heads(q), heads(k)) / math.sqrt(
            hd)
        out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(att, dim=-1),
                           heads(v))
        return self.wo(out.transpose(1, 2).reshape(q.shape)), (k, v)


class TapeHeadBlock(nn.Module):
    """On ``dim`` features, positions up to ``seq_len``;
    ``forward(x, past_kv=None, offset=0)`` returns ``(x, new_kv)``."""

    def __init__(self, dim: int, seq_len: int, num_heads: int = 1,
                 use_rope: bool = True, *, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        self.use_rope = use_rope
        self.register_buffer("pos", torch.as_tensor(
            sinusoidal_embedding(seq_len, dim), device=checked_device(device),
            dtype=dtype), persistent=False)
        self.ln_attn = _init.layer_norm(dim, device, dtype)
        self.attn = CachedMultiheadAttention(dim, num_heads, device=device,
                                             dtype=dtype, generator=gen)
        self.ln_mlp = _init.layer_norm(dim, device, dtype)
        self.mlp = RectifiedKAN(dim, device=device, dtype=dtype,
                                generator=gen)

    def forward(self, x, past_kv=None, offset: int = 0):
        s = x.shape[1]
        h = x + self.pos[None, offset:offset + s].to(x.dtype)
        if self.use_rope:
            h = apply_rope(h, offset)
        # one tensor for q, k and v, as the reference's
        # cached_attn(attn_input, attn_input, attn_input)
        hn = self.ln_attn(h)
        attn_out, new_kv = self.attn(hn, hn, hn, past_kv)
        x = x + attn_out
        x = x + self.mlp(self.ln_mlp(x))
        return x, new_kv


class MLayer(nn.Module):
    """expm of a learned combination of ``dim_in`` generators of size
    ``dim_m`` (normal, scaled by 0.1)."""

    def __init__(self, dim_in: int, dim_m: int, with_bias: bool = False,
                 use_approx: bool = False, num_squarings: int = 6, *,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        self.dim_m = dim_m
        self.use_approx = use_approx
        self.num_squarings = num_squarings
        self.generators = _init.parameter(
            _init.normal((dim_in, dim_m, dim_m), 0.1, gen), device, dtype)
        self.bias = (_init.parameter(_init.normal((1, dim_m, dim_m), 0.1, gen),
                                     device, dtype) if with_bias else None)

    def forward(self, x):
        m = torch.einsum("...a,amn->...mn", x, self.generators)
        if self.bias is not None:
            m = m + self.bias
        if self.use_approx:
            mat = m / (2**self.num_squarings) + torch.eye(
                self.dim_m, dtype=x.dtype, device=x.device)
            for _ in range(self.num_squarings):
                mat = mat @ mat
            return mat
        return torch.linalg.matrix_exp(m)


class LieMLayer(nn.Module):
    """so(2)-block rotations in a learned orthogonal frame, from ``dim_in``
    features."""

    def __init__(self, dim_in: int, dim_m: int, latent: int = 8, *,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        if dim_m % 2:
            raise ValueError(f"dim_m must be even, got {dim_m}")
        gen = _init.generator_or_default(generator)
        nb = dim_m // 2
        self.dim_m = dim_m
        self.frame = _init.parameter(_init.orthogonal((dim_m, dim_m), gen),
                                     device, dtype)
        self.u = _init.dense(dim_in, latent, gen, device, dtype)
        self.gen_theta = _init.dense(latent, nb, gen, device, dtype)
        self.u2 = _init.dense(dim_in, latent, gen, device, dtype)
        self.gen_theta2 = _init.dense(latent, nb, gen, device, dtype)

    def forward(self, x):
        xn = x * torch.rsqrt((x**2).mean(-1, keepdim=True) + 1e-6)
        c = torch.cos(self.gen_theta(self.u(xn)))
        s = torch.sin(self.gen_theta2(self.u2(xn)))
        # block-diagonal rotation in the frame basis
        r = x.new_zeros(x.shape[:-1] + (self.dim_m, self.dim_m))
        even = torch.arange(0, self.dim_m, 2, device=x.device)
        r[..., even, even] = c
        r[..., even + 1, even + 1] = c
        r[..., even, even + 1] = s
        r[..., even + 1, even] = -s
        return self.frame @ r @ self.frame.T
