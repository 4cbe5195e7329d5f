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

The MEITD walks gate on two statistics of a row: its interior extrema count
and its normalised order-3 WPE.  :func:`walk_stats_cuda` gives both from
one launch of ``csrc/walk_stats.cu::walk_stats_kernel`` (through
``cuda_fill._launch``, counted in :data:`LAUNCHES`, inside the profiler
span ``pyitd.walk_stats``) for a CUDA tensor, and from its plain version
:func:`walk_stats` (``count_extrema`` and the WPE above, stacked) for a CPU
tensor.  The kernel's counts equal the plain version's; its entropies sum
the bins in another order, so they agree to rounding.
"""
from __future__ import annotations

import itertools
import math

import torch

from ..utils.spans import spanned
from .cuda_fill import _launch
from .extrema import count_extrema

__all__ = ["weighted_permutation_entropy", "LAUNCHES", "reset_launches",
           "walk_stats", "walk_stats_cuda"]

# launches of walk_stats_kernel, counted where they are made
LAUNCHES = {"walk_stats": 0}


def reset_launches() -> None:
    LAUNCHES["walk_stats"] = 0


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


def walk_stats(x: torch.Tensor, *, entropy: bool = True) -> torch.Tensor:
    """Plain version of the ``walk_stats`` kernel: the interior extrema
    count of every row of ``x`` (last axis) and, with ``entropy``, its
    normalised order-3 WPE, stacked as f64: shape ``(2,) + x.shape[:-1]``,
    or ``(1,) + x.shape[:-1]`` without the entropy."""
    c = count_extrema(x).to(torch.float64)
    if not entropy:
        return c[None]
    return torch.stack([c, weighted_permutation_entropy(x, 3,
                                                        normalize=True)])


@spanned("pyitd.walk_stats")
def walk_stats_cuda(x: torch.Tensor, order: int = 3, delay: int = 1, *,
                    entropy: bool = True) -> torch.Tensor:
    """What :func:`walk_stats` gives, from one launch of the kernel for a
    CUDA tensor (the plain version for a CPU tensor).  Takes f64 rows at
    order 3, delay 1, and at least 3 samples a row with the entropy."""
    if x.dtype != torch.float64:
        raise ValueError(f"walk_stats takes float64, got {x.dtype}")
    if (order, delay) != (3, 1):
        raise ValueError(f"walk_stats takes order 3 and delay 1, got order "
                         f"{order} and delay {delay}")
    if x.dim() < 1:
        raise ValueError("walk_stats needs rows of samples, got a scalar")
    n = x.shape[-1]
    if entropy and n < 3:
        raise ValueError(f"the entropy needs at least 3 samples a row, got "
                         f"{n}")
    if not x.is_cuda:
        return walk_stats(x, entropy=entropy)
    if n > 2**31 - 3:  # int32 positions in the kernel
        raise ValueError(f"walk_stats takes n < 2^31 - 2, got {n}")
    lead = x.shape[:-1]
    rows = math.prod(lead)
    if rows > 2**31 - 1:  # one CTA a row
        raise ValueError(f"walk_stats takes fewer than 2^31 rows, got {rows}")
    out = torch.empty((1 + entropy, rows), dtype=torch.float64,
                      device=x.device)
    if rows:
        xr = x.reshape(rows, n).contiguous()
        _launch("walk_stats", x.device, xr.data_ptr(), rows, n, int(entropy),
                math.log2(math.factorial(order)), out.data_ptr(),
                counts=LAUNCHES)
    return out.reshape((1 + entropy,) + lead)
