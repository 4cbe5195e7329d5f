"""Weighted permutation entropy — port of ``pyitd_tpu/ops/wpe.py``.

Behavioral contract (the reference's ``MEITD.py:51-128`` /
``helperfunctions.py:40-116``): order-m time-delay embedding, argsort
pattern hashing ``sum(sorted_idx * m**arange(m))``, window-variance weights,
Shannon entropy of the weight-normalized pattern distribution, optional
``/log2(m!)`` normalization.

Each window's pattern comes from pairwise comparisons (the rank of an
element is the count of elements that sort before it, ties broken by
position exactly like a stable argsort).  The weights are summed by one
masked reduction per pattern, over the m! hashes a permutation can give:
JAX reduces over all m**m hash bins, and the others hold exact zeros.
A masked reduction sums in the same order on every run, which
``scatter_add_``, ``index_add_`` and ``bincount(weights=...)`` (float
atomics on CUDA) do not: the entropy gates a discrete decision.  Memory
peaks at a few ``(..., windows)`` tensors.
"""
from __future__ import annotations

import itertools
import math

import torch

__all__ = ["weighted_permutation_entropy"]


def _pattern_hashes(order: int) -> list[int]:
    """The hash of every permutation's rank pattern, ascending."""
    return sorted(sum(i * order ** r for i, r in enumerate(p))
                  for p in itertools.permutations(range(order)))


def weighted_permutation_entropy(x: torch.Tensor, order: int = 3,
                                 delay: int = 1, *,
                                 normalize: bool = False) -> torch.Tensor:
    """WPE of the last axis; leading axes broadcast.  Returns one value per
    batch element."""
    n = x.shape[-1]
    w = n - (order - 1) * delay  # number of windows
    if w < 1:
        raise ValueError("signal too short for the requested order/delay")
    cols = [x[..., i * delay:i * delay + w] for i in range(order)]

    # rank with stable tie-break: rank_i = #{j: v_j < v_i} + #{j<i: v_j ==
    # v_i}; the argsort is its inverse permutation, so the reference's hash
    # is sum(pos * order**rank)
    hashval = torch.zeros(cols[0].shape, dtype=torch.int64, device=x.device)
    for i, vi in enumerate(cols):
        rank = sum(((vj < vi) | ((vj == vi) & (j < i))).to(torch.int64)
                   for j, vj in enumerate(cols))
        hashval += i * torch.pow(order, rank)

    # window variance weights (reference: np.var of each window, ddof=0)
    mean = sum(cols) / order
    var = sum((c - mean) ** 2 for c in cols) / order

    counts = torch.stack([torch.where(hashval == h, var, 0.0).sum(-1)
                          for h in _pattern_hashes(order)], dim=-1)
    total = counts.sum(-1, keepdim=True)
    p = counts / torch.where(total == 0, torch.ones_like(total), total)
    ent = -torch.where(p > 0, p * torch.log2(torch.where(p > 0, p, 1.0)),
                       0.0).sum(-1)
    if normalize:
        ent = ent / math.log2(math.factorial(order))
    return ent
