"""Notebook model-zoo staples: port of ``pyitd_tpu/ml/zoo.py``.

* :class:`RecurrentMLP`: k residual tanh-GELU cells, ``he_uniform``
  kernels;
* :func:`fixed_embedding`: deterministic zero-mean unit-norm token rows
  (not learned);
* :class:`UnigramModel`: the context-free logits baseline, target ``-1``
  ignored;
* :class:`BatchSampler`: aligned / jittered contiguous blocks of a token
  stream, drawn from the same ``np.random.default_rng`` stream as the JAX
  package's, so both packages draw the same batches from one seed.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.interop import checked_device
from . import _init

__all__ = ["RecurrentMLP", "fixed_embedding", "UnigramModel", "BatchSampler"]


class _Cell(nn.Module):
    def __init__(self, dim: int, hidden: int, generator, device, dtype):
        super().__init__()
        self.Dense_0 = _init.dense(dim, hidden, generator, device, dtype,
                                   bias=False, init="he")
        self.Dense_1 = _init.dense(hidden, dim, generator, device, dtype,
                                   init="he")

    def forward(self, x):
        return self.Dense_1(F.gelu(self.Dense_0(x), approximate="tanh"))


class RecurrentMLP(nn.Module):
    """k residual cells on ``dim`` features: ``z <- z + cell_i(z)``."""

    def __init__(self, dim: int, k: int = 2, hidden_mult: int = 2, *,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        self.k = k
        for i in range(k):
            self.add_module(f"cell_{i}", _Cell(dim, dim * hidden_mult, gen,
                                               device, dtype))

    def forward(self, x):
        z = x
        for i in range(self.k):
            z = z + getattr(self, f"cell_{i}")(z)
        return z


def fixed_embedding(num_embeddings: int, embedding_dim: int, seed: int = 0,
                    device="cuda") -> torch.Tensor:
    """Deterministic zero-mean unit-norm embedding rows, f32 on
    ``device``."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(num_embeddings, embedding_dim))
    w = w - w.mean(axis=1, keepdims=True)
    w = w / (np.linalg.norm(w, axis=1, keepdims=True) + 1e-8)
    return torch.as_tensor(w.astype(np.float32),
                           device=checked_device(device))


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the targets that are not ``-1``
    (0 when none is), as ``-sum(one_hot · log_softmax)``: no scatter in
    the backward, so deterministic on the card."""
    valid = targets != -1
    onehot = F.one_hot(targets.clamp(min=0), logits.shape[-1]).to(
        logits.dtype)
    nll = -(onehot * torch.log_softmax(logits, dim=-1)).sum(-1)
    return (torch.where(valid, nll, 0.0).sum()
            / valid.sum().clamp(min=1).to(logits.dtype))


class UnigramModel(nn.Module):
    """Context-free learnable logits baseline; returns ``(logits, loss)``."""

    def __init__(self, vocab_size: int, *, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.logits = _init.parameter(
            torch.zeros(vocab_size, dtype=torch.float64), device, dtype)

    def forward(self, idx, targets=None):
        logits = self.logits.expand(*idx.shape, self.vocab_size)
        if targets is None:
            return logits, None
        return logits, token_nll(logits, targets)


class BatchSampler:
    """Aligned/jittered contiguous block sampler over a 1-D token stream:
    each row picks an aligned block start, adding a small jitter with
    probability ``1 - p_aligned``; targets are the inputs shifted by
    ``1 + pad_len``.  ``sample()`` returns int64 tensors on ``device``."""

    def __init__(self, data, block_size: int, batch_size: int, *,
                 jitter: int = 63, p_aligned: float = 0.5, pad_len: int = 0,
                 seed: int = 0, device="cuda"):
        self.device = checked_device(device)
        self.data = np.asarray(data)
        self.block_size = block_size
        self.batch_size = batch_size
        self.pad_len = int(pad_len)
        self.sample_len = block_size + self.pad_len
        self.total = len(self.data) - self.sample_len - 1
        self.n_blocks = self.total // self.sample_len
        self.jitter = int(jitter)
        self.p_aligned = float(p_aligned)
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.total // self.batch_size

    def sample(self):
        x = np.empty((self.batch_size, self.sample_len), np.int64)
        y = np.empty((self.batch_size, self.block_size), np.int64)
        for i in range(self.batch_size):
            start = self.rng.integers(0, self.n_blocks) * self.sample_len
            if self.rng.random() > self.p_aligned:
                start = min(start + self.rng.integers(0, self.jitter + 1),
                            self.total)
            x[i] = self.data[start:start + self.sample_len]
            y[i] = self.data[start + 1 + self.pad_len:
                             start + 1 + self.pad_len + self.block_size]
        return (torch.from_numpy(x).to(self.device),
                torch.from_numpy(y).to(self.device))
