"""Accumulator Fourier Transform exploration (AFT.ipynb) — port of
``pyitd_tpu/decomp/aft.py``.

The notebook evaluates a DFT by grouping the contributions that share a
twiddle factor: ``X[k] = sum_r W^r S_k[r]`` with ``S_k[r] = sum_{j : j·k
= r (mod n)} x[j]``, so each bin needs ``unique_twiddle_count(n)``
multiplies after pure accumulation (257 for n = 512).

* :func:`accumulator_dft` — the flat grouped form (cell 18).  JAX builds an
  ``(n, n, n)`` one-hot and contracts it on the TPU's matrix unit; here the
  grouped sums are a scatter-add over the ``(j·k) mod n`` residues, then
  one float64 product with the twiddles (complex128 out, as JAX's with x64).
* The hierarchical machinery of cells 3-21, host numpy as in JAX:
  :func:`coefficient_census`, :func:`accumulation_paths`,
  :func:`sub_accumulators`; and :func:`hierarchical_dft`, exact: each
  distinct (symbol, position-set) pair is one shared accumulator ``a =
  sum(x[P])``, reused by every bin row that multiplies that set by that
  coefficient.  JAX runs its two stages, gather and emit, as two f32
  GEMMs.  Here both are gathers and f32 sums over padded index tables (the
  accumulators bucketed by size, each bin row's accumulators in one
  table): no matmul, so no TF32 whatever the caller's matmul precision, and
  the same bits on every call.

Capability parity for an exploratory artifact, not an FFT replacement.
Numpy input runs on ``device`` (the card by default); a tensor stays on
its own device.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils.interop import as_input

__all__ = [
    "dft_matrix", "unique_twiddle_count", "accumulator_dft",
    "coefficient_census", "accumulation_paths", "sub_accumulators",
    "hierarchical_dft",
]

# elements of one intermediate tensor (frames x table entries) per batch of
# frames: 2^26 f32 is 256 MB
_BATCH_ELEMS = 1 << 26


def dft_matrix(n: int) -> np.ndarray:
    j = np.arange(n)
    return np.exp(-2j * np.pi * np.outer(j, j) / n)


def unique_twiddle_count(n: int) -> int:
    """Number of distinct cosine coefficients among the n-point DFT
    twiddles (257 for n=512, the notebook's count): cos(2πr/n) is shared by
    r and n-r, which is what makes coefficient-grouped accumulation pay."""
    return np.unique(np.round(np.cos(2 * np.pi * np.arange(n) / n), 12)).size


def _batches(frames: int, per_frame: int):
    step = max(1, _BATCH_ELEMS // max(1, per_frame))
    return [slice(b, b + step) for b in range(0, frames, step)]


def accumulator_dft(x, *, device="cuda"):
    """DFT of the last axis via accumulate-then-multiply grouping."""
    x = as_input(x, None, device)
    n = x.shape[-1]
    lead = x.shape[:-1]
    flat = x.reshape(-1, n)
    j = np.arange(n)
    # slot k·n + (j·k mod n) of S receives x[j]
    slots = torch.from_numpy((j[:, None] * n + np.outer(j, j) % n).reshape(
        -1)).to(x.device)
    r = np.arange(n)
    cos = torch.from_numpy(np.cos(-2 * np.pi * r / n)).to(x.device)
    sin = torch.from_numpy(np.sin(-2 * np.pi * r / n)).to(x.device)
    out = torch.empty(flat.shape, dtype=torch.complex128, device=x.device)
    for b in _batches(flat.shape[0], n * n):
        xb = flat[b]
        acc = torch.zeros((xb.shape[0], n * n), dtype=x.dtype,
                          device=x.device)
        acc.index_add_(1, slots, xb.repeat(1, n))
        acc = acc.reshape(-1, n, n).to(torch.float64)   # (frames, k, r)
        out[b] = torch.complex(acc @ cos, acc @ sin)
    return out.reshape(lead + (n,))


@lru_cache(maxsize=8)
def coefficient_census(n: int, decimals: int = 10):
    """Cells 3-4: stack [cos; -sin] twiddle rows, round, and index every
    entry by its unique coefficient value.

    Returns ``(values, sym)``: ``values[s]`` the s-th unique coefficient,
    ``sym[r, j]`` the symbol index of entry (r, j) of the stacked ``(2n,
    n)`` matrix (rows 0..n-1 real/cos, rows n..2n-1 imag/-sin)."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    real = np.cos(2 * np.pi * k * j / n)
    imag = -np.sin(2 * np.pi * k * j / n)
    full = np.round(np.vstack([real, imag]), decimals=decimals)
    values, inverse = np.unique(full, return_inverse=True)
    return values, inverse.reshape(2 * n, n).astype(np.int32)


def accumulation_paths(n: int):
    """Cell 8: per fundamental bin i, its harmonic chain ``{j > i : j % i ==
    0}`` and the coefficient symbols shared with each harmonic (the union of
    the bin's real and imaginary rows).

    Returns ``{i: {"symbols": set, "harmonics": [...], "shared_symbols":
    {h: set}}}``."""
    _, sym = coefficient_census(n)
    bin_syms = [set(sym[i]) | set(sym[i + n]) for i in range(n)]
    paths = {}
    for i in range(n):
        harmonics = list(range(2 * i, n, i)) if i > 0 else []
        paths[i] = {
            "symbols": bin_syms[i],
            "harmonics": harmonics,
            "shared_symbols": {h: bin_syms[i] & bin_syms[h]
                               for h in harmonics},
        }
    return paths


def sub_accumulators(n: int):
    """Cells 9-10 made exact: the shared accumulators of the hierarchy,
    grouped by ``(symbol, position-set)``.  Returns

    * ``acc_members``: list of (symbol index, sorted position tuple), one
      per accumulator;
    * ``row_acc``: ``{row r: [acc ids]}`` — each of the 2n bin rows is the
      exact sum ``sum_a values[sym_a] * acc_a`` over its accumulators."""
    _, sym = coefficient_census(n)
    acc_ids: dict = {}
    acc_members = []
    row_acc = {}
    for r in range(2 * n):
        by_symbol: dict = {}
        for pos, s in enumerate(sym[r]):
            by_symbol.setdefault(int(s), []).append(pos)
        ids = []
        for s, positions in by_symbol.items():
            key = (s, tuple(positions))
            if key not in acc_ids:
                acc_ids[key] = len(acc_members)
                acc_members.append(key)
            ids.append(acc_ids[key])
        row_acc[r] = ids
    return acc_members, row_acc


@lru_cache(maxsize=4)
def _hierarchical_tables(n: int):
    """The two stages as padded index tables (host numpy).

    Gather: the accumulators in buckets of sizes up to 1, 2, 4, ...; bucket
    b is a ``(accumulators, 2^b)`` table of positions, padded with ``n`` (a
    zero sample).  Their concatenation numbers the accumulators anew.
    Emit: a ``(2n, longest row)`` table of those numbers, padded with the
    count (a zero accumulator), and the matching f32 coefficients."""
    values, _ = coefficient_census(n)
    acc_members, row_acc = sub_accumulators(n)
    sizes = np.array([len(p) for _, p in acc_members])
    width = np.ceil(np.log2(sizes)).astype(int)
    gather, new_id = [], np.empty(len(acc_members), np.int64)
    start = 0
    for b in np.unique(width):
        ids = np.nonzero(width == b)[0]
        table = np.full((ids.size, 1 << b), n, np.int64)
        for i, a in enumerate(ids):
            table[i, :sizes[a]] = acc_members[a][1]
        new_id[ids] = start + np.arange(ids.size)
        start += ids.size
        gather.append(table)
    longest = max(len(v) for v in row_acc.values())
    emit = np.full((2 * n, longest), start, np.int64)
    coef = np.zeros((2 * n, longest), np.float32)
    for r, ids in row_acc.items():
        emit[r, :len(ids)] = new_id[ids]
        coef[r, :len(ids)] = [values[acc_members[a][0]] for a in ids]
    return gather, emit, coef


def hierarchical_dft(x, *, device="cuda"):
    """Cells 12/21's hierarchical evaluator, exact, on f32: positions ->
    shared accumulators -> coefficient-weighted bin sums.  Matches
    :func:`accumulator_dft` and the FFT to f32 roundoff."""
    x = as_input(x, None, device).to(torch.float32)
    n = x.shape[-1]
    lead = x.shape[:-1]
    gather, emit, coef = _hierarchical_tables(n)
    gather = [torch.from_numpy(t).to(x.device) for t in gather]
    emit = torch.from_numpy(emit).to(x.device)
    coef = torch.from_numpy(coef).to(x.device)
    flat = x.reshape(-1, n)
    parts = torch.empty((flat.shape[0], 2 * n), dtype=torch.float32,
                        device=x.device)
    for b in _batches(flat.shape[0], emit.numel()):
        xb = torch.cat([flat[b], torch.zeros_like(flat[b, :1])], dim=-1)
        acc = torch.cat([xb[:, t].sum(-1) for t in gather]
                        + [torch.zeros_like(xb[:, :1])], dim=-1)
        parts[b] = (acc[:, emit] * coef).sum(-1)
    return torch.complex(parts[:, :n], parts[:, n:]).reshape(lead + (n,))
