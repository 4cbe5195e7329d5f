"""Parseval / Haar-wavelet attention GPT: port of
``pyitd_tpu/ml/parseval.py``.

* :func:`variance_scaled_softmax`: per-row standardization over the valid
  (finite) entries before the softmax; fully masked rows give zeros;
* :class:`ParsevalRotaryEmbedding`: rotary pairs over split halves;
* :func:`build_haar_wavelet_basis`: blockwise Haar detail vectors over
  ``levels`` dyadic scales;
* :class:`SingleHeadWaveletAttention`: W_K derived every step as the
  QR-based dual frame of W_Q (``W_Q W_Kᴴ = I``), near-field exact attention
  inside a ±``near_window`` band, far field in the compressed Haar domain,
  causal mask, variance-scaled softmax;
* :class:`UnitaryAncillaAttention`: learned always-visible ancilla tokens
  in K and V, so no row is ever fully masked;
* :class:`AnchorModule`: soft assignment to learned anchors, residual plus
  a 0.1 outward-normal push;
* :class:`ParsevalGPT`: embedding -> anchored blocks -> head with
  ``30·tanh(logits/30)`` softcapping; returns ``(logits, loss)``, and the
  last position's logits only when there are no targets.

The Haar basis and the rotary tables are constants built once per module
and kept on its device; the QR runs every step, in at least float32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.interop import checked_device
from . import _init
from .zoo import token_nll

__all__ = [
    "variance_scaled_softmax",
    "build_haar_wavelet_basis",
    "ParsevalRotaryEmbedding",
    "SingleHeadWaveletAttention",
    "UnitaryAncillaAttention",
    "AnchorModule",
    "GPTConfig",
    "ParsevalGPT",
    "softcap",
]


def variance_scaled_softmax(scores: torch.Tensor, dim: int = -1,
                            eps: float = 1e-6) -> torch.Tensor:
    """Softmax of the scores standardized over each row's finite entries;
    masked (``-inf``) entries are replaced by 0 before any arithmetic, so
    no NaN enters the forward, and fully masked rows give zeros."""
    finite = torch.isfinite(scores)
    m = finite.to(scores.dtype)
    count = m.sum(dim, keepdim=True)
    n = count.clamp_min(1.0)
    safe = torch.where(finite, scores, 0.0)
    mean = (safe * m).sum(dim, keepdim=True) / n
    var = ((safe - mean) ** 2 * m).sum(dim, keepdim=True) / n
    std = var.clamp_min(eps).sqrt()
    scaled = torch.where(finite, (safe - mean) / std, -torch.inf)
    out = torch.softmax(scaled, dim=dim)
    return torch.where(count == 0, 0.0, out)


def softcap(logits: torch.Tensor, cap: float = 30.0) -> torch.Tensor:
    return cap * torch.tanh(logits / cap)


def build_haar_wavelet_basis(t: int, levels: int) -> np.ndarray:
    cols = []
    for j in range(levels):
        block_count = 2**j
        block_size = t // block_count
        if block_size == 0:
            continue
        half = block_size // 2
        for k in range(block_count):
            vec = np.zeros(t)
            start = k * block_size
            if half > 0:
                vec[start: start + half] = 1.0 / math.sqrt(half)
                vec[start + half: start + block_size] = -1.0 / math.sqrt(half)
            cols.append(vec)
    if not cols:
        return np.eye(t)
    return np.stack(cols, axis=1)


class ParsevalRotaryEmbedding(nn.Module):
    """Rotary tables of ``dim`` features for ``max_seq_len`` positions;
    call with ``(B, T, D)`` and a position vector."""

    def __init__(self, dim: int, max_seq_len: int = 2048,
                 theta_base: float = 10000.0, *, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        half = dim // 2
        inv_freq = 1.0 / (theta_base ** (np.arange(half) / half))
        angles = np.arange(max_seq_len)[:, None] * inv_freq[None, :]
        dev = checked_device(device)
        self.register_buffer("cos", torch.as_tensor(
            np.cos(angles), device=dev, dtype=dtype), persistent=False)
        self.register_buffer("sin", torch.as_tensor(
            np.sin(angles), device=dev, dtype=dtype), persistent=False)

    def forward(self, x, seq_pos):
        half = x.shape[-1] // 2
        c = self.cos[seq_pos][None].to(x.dtype)
        s = self.sin[seq_pos][None].to(x.dtype)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def _l2n(x, eps=1e-8):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def _dual_wk(wq: torch.Tensor) -> torch.Tensor:
    """QR-based dual frame: W_K with ``W_Q @ W_Kᴴ = I``, factored in at
    least float32 and cast back.  Mathematically ``R⁻¹Qᴴ = (W_Qᴴ)⁻¹``, so
    the sign conventions of the QR libraries cancel."""
    dt = wq.dtype
    w = wq.to(torch.promote_types(dt, torch.float32))
    qm, rm = torch.linalg.qr(w.mH)
    return (torch.linalg.inv(rm) @ qm.mH).to(dt)


@dataclass
class GPTConfig:
    block_size: int = 256
    vocab_size: int = 256
    n_layer: int = 2
    n_embd: int = 64
    dropout: float = 0.0
    bias: bool = True
    wavelet_levels: int = 3
    near_window: int = 64
    ancilla_dim: int = 16
    n_anchor: int = 32


class SingleHeadWaveletAttention(nn.Module):
    def __init__(self, config: GPTConfig, *, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        c = self.config = config
        d = c.n_embd
        self.w_q = _init.parameter(_init.xavier_uniform((d, d), d, d, gen),
                                   device, dtype)
        self.w_v = _init.dense(d, d, gen, device, dtype, bias=False)
        self.w_o = _init.dense(d, d, gen, device, dtype, bias=False)
        self.register_buffer("haar", torch.as_tensor(
            build_haar_wavelet_basis(c.block_size, c.wavelet_levels),
            device=checked_device(device), dtype=dtype), persistent=False)
        self.rope = ParsevalRotaryEmbedding(d, c.block_size, device=device,
                                            dtype=dtype)

    def _qkv(self, x):
        w_k = _dual_wk(self.w_q)
        return x @ self.w_q.T, x @ w_k.T, self.w_v(x)

    def forward(self, x):
        c = self.config
        b, t, d = x.shape
        q, k, v = self._qkv(x)
        idx = torch.arange(t, device=x.device)
        q = _l2n(self.rope(q, idx))
        k = _l2n(self.rope(k, idx))

        near = (idx[None, :] - idx[:, None]).abs() <= c.near_window
        att_near = (q @ k.transpose(-2, -1)) / math.sqrt(d)
        att_near = torch.where(near[None], att_near, -torch.inf)

        w_h = self.haar[:t].to(x.dtype)
        q_far = torch.einsum("btc,tw->bwc", q, w_h)
        k_far = torch.einsum("btc,tw->bwc", k, w_h)
        att_far = torch.einsum("bwc,bvc->bwv", q_far, k_far) / math.sqrt(d)
        att_far = torch.einsum("tw,bwv,sv->bts", w_h, att_far, w_h)

        att = torch.where(near[None], att_near, att_far)
        causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        att = torch.where(causal[None], att, -torch.inf)
        att = variance_scaled_softmax(att)
        return self.w_o(att @ v)


class UnitaryAncillaAttention(SingleHeadWaveletAttention):
    def __init__(self, config: GPTConfig, *, device="cuda",
                 dtype=torch.float32, generator=None):
        gen = _init.generator_or_default(generator)
        super().__init__(config, device=device, dtype=dtype, generator=gen)
        self.ancilla = _init.parameter(_init.orthogonal(
            (1, config.ancilla_dim, config.n_embd), gen), device, dtype)

    def forward(self, x):
        c = self.config
        b, t, d = x.shape
        q, k, v = self._qkv(x)
        idx = torch.arange(t, device=x.device)
        anc = self.ancilla.expand(b, c.ancilla_dim, d).to(x.dtype)
        q = _l2n(self.rope(q, idx))
        k_sem = self.rope(k, idx)
        k_ext = _l2n(torch.cat([anc, k_sem], dim=1))
        v_ext = torch.cat([anc, v], dim=1)

        scores = (q @ k_ext.transpose(-2, -1)) / math.sqrt(d)
        full = torch.ones((t, c.ancilla_dim + t), dtype=torch.bool,
                          device=x.device).tril(c.ancilla_dim)
        scores = torch.where(full[None], scores, -torch.inf)
        att = variance_scaled_softmax(scores)
        return self.w_o(att @ v_ext)


class AnchorModule(nn.Module):
    """Soft assignment of ``dim``-feature rows to ``n_anchor`` anchors
    (normal over ``sqrt(dim)``)."""

    def __init__(self, dim: int, n_anchor: int = 4, *, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        self.anchors = _init.parameter(
            _init.normal((n_anchor, dim), 1.0 / dim**0.5, gen), device, dtype)

    def forward(self, x):
        w = torch.softmax(x @ self.anchors.T, dim=-1)
        resid = x - w @ self.anchors
        normal = resid / (torch.linalg.vector_norm(resid, dim=-1,
                                                   keepdim=True) + 1e-12)
        return x + resid + 0.1 * normal


class _MLP(nn.Module):
    def __init__(self, config: GPTConfig, gen, device, dtype):
        super().__init__()
        c = self.config = config
        self.Dense_0 = _init.dense(c.n_embd, 4 * c.n_embd, gen, device, dtype,
                                   bias=c.bias)
        self.Dense_1 = _init.dense(4 * c.n_embd, c.n_embd, gen, device, dtype,
                                   bias=c.bias)

    def forward(self, x, deterministic=True):
        h = self.Dense_0(x)
        h = h * torch.sigmoid((math.pi / math.sqrt(3.0)) * h)
        h = self.Dense_1(h)
        if self.config.dropout > 0:
            h = F.dropout(h, self.config.dropout, training=not deterministic)
        return h


class _Block(nn.Module):
    def __init__(self, config: GPTConfig, gen, device, dtype):
        super().__init__()
        c = config
        kw = dict(device=device, dtype=dtype, generator=gen)
        self.LayerNorm_0 = _init.layer_norm(c.n_embd, device, dtype, c.bias)
        self.anchor_pre = AnchorModule(c.n_embd, c.n_anchor, **kw)
        self.attn = UnitaryAncillaAttention(c, **kw)
        self.anchor_post = AnchorModule(c.n_embd, c.n_anchor, **kw)
        self.mlp = _MLP(c, gen, device, dtype)
        self.LayerNorm_1 = _init.layer_norm(c.n_embd, device, dtype, c.bias)

    def forward(self, x, deterministic=True):
        h = self.anchor_pre(self.LayerNorm_0(x))
        x = x + self.attn(h)
        x = self.anchor_post(x)
        return x + self.mlp(self.LayerNorm_1(x), deterministic)


class ParsevalGPT(nn.Module):
    """The T.py research transformer; ``forward(idx, targets=None,
    deterministic=True)`` returns ``(logits, loss)``."""

    def __init__(self, config: GPTConfig, *, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        c = self.config = config
        self.wte = _init.embed(c.vocab_size, c.n_embd, gen, device, dtype)
        for i in range(c.n_layer):
            self.add_module(f"block_{i}", _Block(c, gen, device, dtype))
        self.ln_f = _init.layer_norm(c.n_embd, device, dtype, c.bias)
        self.lm_head = _init.dense(c.n_embd, c.vocab_size, gen, device, dtype,
                                   bias=False)

    def forward(self, idx, targets=None, deterministic=True):
        x = self.wte(idx)
        for i in range(self.config.n_layer):
            x = getattr(self, f"block_{i}")(x, deterministic)
        x = self.ln_f(x)
        if targets is not None:
            logits = softcap(self.lm_head(x))
            return logits, token_nll(logits, targets)
        return softcap(self.lm_head(x[:, -1:, :])), None
