"""UltraMemv5, shared-memory-bank layers: port of
``pyitd_tpu/ml/ultramem.py``.

A product-key memory variant: per layer, row/col queries preselect top-k
key rows/columns from shared banks (flattened matmuls with the learned
rank mixers folded in), a Tucker-style grid score picks ``top_m`` (row,
col) cells, and a factored codebook (row/col embeddings through bilinear
heads, top-k sparsified) gives value and pre-value codes that accumulate
into a shared basis; a per-layer near-identity projector finishes.  The
blocks are parallel residuals, ``x + ffn(norm(x)) + mem(norm(x))``, and
every block reads the one :class:`_Shared` bank.

Top-k takes the k largest by a stable descending sort, so that ties come
lowest index first as ``jax.lax.top_k`` gives them (``torch.topk``
promises no order among ties); ``jax.lax.stop_gradient`` is ``detach``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from . import _init

__all__ = ["UltraMemCfg", "UltraMemClassifier"]


@dataclass(frozen=True)
class UltraMemCfg:
    hidden_size: int = 64
    n_keys: int = 64
    key_dim: int = 16
    tucker_rank: int = 2
    rb: int = 32            # value code dim
    rp: int = 32            # pre-value code dim
    qr: int = 32            # row embedding dim
    qc: int = 32            # col embedding dim
    ks_s: int = 4           # top-k sparsity for S rows
    ks_t: int = 4           # top-k sparsity for T rows
    projector_rank: int = 8
    topk_rows: int = 8
    topk_cols: int = 8
    top_m: int = 8
    softmax_tau: float = 1.0
    n_blocks: int = 2
    ffn_multiple: float = 2.0
    num_classes: int = 64


def top_k(x: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest along the last axis,
    ties lowest index first (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _rmsnorm(x, w, eps=1e-6):
    return x * torch.rsqrt((x**2).mean(-1, keepdim=True) + eps) * w


def _topk_row_sparsify(mat, k):
    if k <= 0 or k >= mat.shape[-1]:
        return mat
    vals, _ = top_k(mat.abs(), k)
    thresh = vals[..., -1:].detach()
    return torch.where(mat.abs() >= thresh, mat, torch.zeros_like(mat))


class _Shared(nn.Module):
    """The banks every block reads: parameters only."""

    def __init__(self, cfg: UltraMemCfg, gen, device, dtype):
        super().__init__()
        c = cfg
        h, n, dk, r = c.hidden_size, c.n_keys, c.key_dim, c.tucker_rank

        def p(values):
            return _init.parameter(values, device, dtype)

        self.K_row = p(_init.normal((r, n, dk), 1 / math.sqrt(dk), gen))
        self.K_col = p(_init.normal((r, n, dk), 1 / math.sqrt(dk), gen))
        self.core = p(_init.normal((r, r), 1 / math.sqrt(max(1, r)), gen))
        self.row_mix = p(_init.normal((r,), 1.0, gen))
        self.col_mix = p(_init.normal((r,), 1.0, gen))
        self.row_emb = p(_init.normal((n, c.qr), 0.01, gen))
        self.col_emb = p(_init.normal((n, c.qc), 0.01, gen))
        self.row_to_S = p(_init.normal((c.qr, c.rb), 0.02, gen))
        self.col_to_S = p(_init.normal((c.qc, c.rb), 0.02, gen))
        self.row_to_T = p(_init.normal((c.qr, c.rp), 0.02, gen))
        self.col_to_T = p(_init.normal((c.qc, c.rp), 0.02, gen))
        b = _init.normal((c.rb, h), 1 / math.sqrt(h), gen)
        d = min(c.rb, h)
        b[:d, :d] += torch.eye(d, dtype=b.dtype)
        self.B = p(b)
        self.x_to_U = p(_init.lecun_normal((h, c.rp), h, gen))


class _MemLayer(nn.Module):
    def __init__(self, cfg: UltraMemCfg, gen, device, dtype):
        super().__init__()
        c = self.cfg = cfg
        h, dk, r = c.hidden_size, c.key_dim, c.tucker_rank
        self.q = _init.dense(h, 2 * r * dk, gen, device, dtype, bias=False)
        self.Vproj = _init.dense(h, c.projector_rank, gen, device, dtype,
                                 bias=False)
        self.Uproj = _init.dense(c.projector_rank, h, gen, device, dtype,
                                 bias=False)
        self.gamma = _init.parameter(torch.zeros((), dtype=torch.float64),
                                     device, dtype)

    def forward(self, x, s: _Shared):
        c = self.cfg
        n, dk, r = c.n_keys, c.key_dim, c.tucker_rank
        bsz = x.shape[0]

        q_all = self.q(x).reshape(bsz, 2, r, dk)
        qrow, qcol = q_all[:, 0], q_all[:, 1]

        # preselect on the detached flattened banks with folded mixers
        krf = s.K_row.movedim(1, 0).reshape(n, r * dk).T.detach()
        kcf = s.K_col.movedim(1, 0).reshape(n, r * dk).T.detach()
        sr = s.row_mix.repeat_interleave(dk)[:, None]
        sc = s.col_mix.repeat_interleave(dk)[:, None]
        _, row_idx = top_k(qrow.reshape(bsz, -1) @ (krf * sr), c.topk_rows)
        _, col_idx = top_k(qcol.reshape(bsz, -1) @ (kcf * sc), c.topk_cols)

        # selected keys: (B, r, P, dk)
        k_row_sel = s.K_row[:, row_idx].movedim(1, 0)
        k_col_sel = s.K_col[:, col_idx].movedim(1, 0)

        qrow_mixed = torch.einsum("ij,brk->bjk", s.core.T, qrow)
        # 'brpk,bjk->bjp': the bank's rank axis is summed independently of
        # the mixed-q rank axis j (a full r x j mixing)
        a_sel = torch.einsum("brpk,bjk->bjp", k_row_sel, qrow_mixed)
        b_sel = torch.einsum("brqk,brk->brq", k_col_sel, qcol)
        grid = torch.einsum("brp,brn->bpn", a_sel, b_sel)  # (B, Pr, Pc)

        top_scores, top_idx = top_k(grid.reshape(bsz, -1), c.top_m)
        picked_rows = torch.gather(row_idx, 1, top_idx // c.topk_cols)
        picked_cols = torch.gather(col_idx, 1, top_idx % c.topk_cols)

        if c.softmax_tau != 0:
            weights = torch.softmax(top_scores / c.softmax_tau, dim=1)
        else:
            weights = top_scores

        row_vecs = s.row_emb[picked_rows]  # (B, M, Qr)
        col_vecs = s.col_emb[picked_cols]
        s_rows = row_vecs @ s.row_to_S + col_vecs @ s.col_to_S  # (B, M, Rb)
        t_rows = row_vecs @ s.row_to_T + col_vecs @ s.col_to_T  # (B, M, Rp)
        s_rows = _topk_row_sparsify(s_rows, c.ks_s)
        t_rows = _topk_row_sparsify(t_rows, c.ks_t)

        u = x @ s.x_to_U  # (B, Rp)
        pv = torch.einsum("bmr,br->bm", t_rows, u)
        s_acc = ((weights * pv)[..., None] * s_rows).sum(1)
        s_acc = s_acc / (torch.linalg.vector_norm(s_acc, dim=-1,
                                                  keepdim=True) + 1e-12)
        g = s_acc @ s.B  # (B, H)
        return g + torch.tanh(self.gamma) * self.Uproj(self.Vproj(g))


class _FFN(nn.Module):
    def __init__(self, cfg: UltraMemCfg, gen, device, dtype):
        super().__init__()
        h = cfg.hidden_size
        inner = int(h * cfg.ffn_multiple)
        self.Dense_0 = _init.dense(h, inner, gen, device, dtype, bias=False)
        self.Dense_1 = _init.dense(h, inner, gen, device, dtype, bias=False)
        self.Dense_2 = _init.dense(inner, h, gen, device, dtype, bias=False)

    def forward(self, x):
        return self.Dense_2(torch.nn.functional.silu(self.Dense_0(x))
                            * self.Dense_1(x))


class UltraMemClassifier(nn.Module):
    """Stack of parallel-residual UltraMem blocks + head, on ``input_dim``
    features (``cfg.hidden_size`` when None)."""

    def __init__(self, cfg: UltraMemCfg, input_dim: int | None = None, *,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        c = self.cfg = cfg
        h = c.hidden_size
        self.input_proj = (_init.dense(input_dim, h, gen, device, dtype,
                                       bias=False)
                           if input_dim is not None and input_dim != h
                           else None)
        self.shared = _Shared(c, gen, device, dtype)
        for i in range(c.n_blocks):
            ones = torch.ones(h, dtype=torch.float64)
            setattr(self, f"norm_ffn_{i}", _init.parameter(ones, device,
                                                           dtype))
            setattr(self, f"norm_mem_{i}", _init.parameter(ones, device,
                                                           dtype))
            self.add_module(f"ffn_{i}", _FFN(c, gen, device, dtype))
            self.add_module(f"mem_{i}", _MemLayer(c, gen, device, dtype))
        self.final_norm = _init.parameter(torch.ones(h, dtype=torch.float64),
                                          device, dtype)
        self.head = _init.dense(h, c.num_classes, gen, device, dtype)

    def forward(self, x):
        if self.input_proj is not None:
            x = self.input_proj(x)
        for i in range(self.cfg.n_blocks):
            ffn_out = getattr(self, f"ffn_{i}")(
                _rmsnorm(x, getattr(self, f"norm_ffn_{i}")))
            mem_out = getattr(self, f"mem_{i}")(
                _rmsnorm(x, getattr(self, f"norm_mem_{i}")), self.shared)
            x = x + ffn_out + mem_out
        return self.head(_rmsnorm(x, self.final_norm))
