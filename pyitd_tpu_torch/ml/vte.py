"""Vector transport / manifold "BlockFast" toolkit: port of
``pyitd_tpu/ml/vte.py``.

* :func:`pairwise_rot_spiral` / :func:`spiral_mix`: pairwise 2-D rotations
  with a radial Euler step toward a shell;
* :func:`phase_tap`: guarded-Householder phase-preserving difference
  (reflect H with ``H a = u`` applied to ``x_t - x_{t-d}``, identity and
  fixed-axis fallbacks near ``u = ±a`` and tiny norms);
* :func:`phase_transport`: Rodrigues-style parallel transport of the
  lagged difference from direction v to u, with antipodal and degenerate
  guards;
* :func:`subspace_iteration`: block-Krylov subspace extraction with the
  Student-t spectral filter, with :func:`orthonorm_columns`,
  :func:`sign_align`, :func:`energy_normalize`, :func:`soft_shrink` and
  :class:`LowRankShift`;
* :func:`frft_time`: chirp-convolution fractional Fourier transform along
  time;
* :func:`ar1_filter`: causal AR(1) smoothing as a doubling scan over time;
* :class:`ManifoldStage`, :class:`AutoencoderBlock`,
  :class:`BlockFastGPT`: the attention-free GPT; :func:`dynmix`.

The guards are branchless ``where`` selects with JAX's safe denominators,
as written there: an unselected branch is still differentiated, and its
cotangent is zero.  QR factors are sign-fixed by R's diagonal, so the
subspaces do not depend on the library's Householder convention.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import _init
from .zoo import fixed_embedding, token_nll

__all__ = [
    "pairwise_rot_spiral",
    "spiral_mix",
    "phase_tap",
    "phase_transport",
    "orthonorm_columns",
    "subspace_iteration",
    "sign_align",
    "energy_normalize",
    "soft_shrink",
    "LowRankShift",
    "frft_time",
    "subspace_iteration_linop",
    "ManifoldStage",
    "AutoencoderBlock",
    "BlockFastGPT",
    "dynmix",
    "ar1_filter",
]


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # flax's and jax.nn's gelu


def _norm(x, keepdim=True):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def pairwise_rot_spiral(x, radius=6.0, omega=1.0, k=1.0, step=0.1,
                        cube_shell=False):
    d = x.shape[-1]
    r = _norm(x).clamp_min(1e-8)
    radial = (radius - r) * (x / r)
    if d >= 2:
        c, s = math.cos(omega * step), math.sin(omega * step)
        n2 = d // 2
        head = x[..., :2 * n2].reshape(x.shape[:-1] + (n2, 2))
        xi, xj = head[..., 0], head[..., 1]
        rot = torch.stack([c * xi - s * xj, s * xi + c * xj], dim=-1).reshape(
            x.shape[:-1] + (2 * n2,))
        y = torch.cat([rot, x[..., 2 * n2:]], dim=-1) if d % 2 else rot
    else:
        y = x
    y = x + step * ((y - x) + k * radial)
    if cube_shell:
        y = radius * torch.tanh(y / radius)
    return y


def spiral_mix(comps, center=0.0, loop_iters=2, **spiral_kwargs):
    y = comps
    for _ in range(loop_iters):
        y = pairwise_rot_spiral(y - center, **spiral_kwargs) + center
    return y


def _safe_unit(v, eps=1e-12):
    return v / _norm(v).clamp_min(eps)


def _early(first, d: int, t: int, like):
    """Rows t < d: ``first / (d - t)``; later rows zero."""
    tt = torch.arange(t, device=like.device)
    div = (d - tt).clamp_min(1).to(like.dtype)
    early = first[:, None, :] / div[None, :, None]
    return torch.where((tt < d)[None, :, None], early, 0.0), tt


def phase_tap(x, d: int, tau: float = 1e-6):
    """(B, T, C) -> (B, T, C); early rows are a/(d-t), later rows the
    Householder-transported lagged difference."""
    b, t, c = x.shape
    a = torch.zeros(c, dtype=x.dtype, device=x.device)
    a[0] = 1.0
    early, tt = _early(a.expand(b, c), d, t, x)
    if t <= d:
        return early

    x_t, x_tm = x[:, d:, :], x[:, :-d, :]
    u = _safe_unit(x_t)
    v = x_t - x_tm

    dot = (a * u).sum(-1, keepdim=True)
    near_pos = dot > 1.0 - tau
    near_neg = dot < -1.0 + tau
    near_zero = _norm(u) < tau

    w = _safe_unit(a - u)
    y_gen = v - 2.0 * w * (w * v).sum(-1, keepdim=True)
    if c == 1:
        y_main = v
    else:
        bb = torch.zeros(c, dtype=x.dtype, device=x.device)
        bb[1] = 1.0
        y_neg = v - 2.0 * bb * (bb * v).sum(-1, keepdim=True)
        y_main = torch.where(near_pos | near_zero, v,
                             torch.where(near_neg, y_neg, y_gen))
    pad = torch.zeros((b, d, c), dtype=x.dtype, device=x.device)
    return early + torch.cat([pad, y_main], dim=1) * (tt >= d)[None, :, None]


def phase_transport(x, d: int, tau: float = 1e-6):
    """Rodrigues transport of lagged differences."""
    b, t, c = x.shape
    ref_t = min(d, t - 1)
    early, tt = _early(_safe_unit(x[:, ref_t, :]), d, t, x)
    if t <= d:
        return early

    xt, xtm = x[:, d:, :], x[:, :-d, :]
    u = _safe_unit(xt)
    v = _safe_unit(xtm)
    w = xt - xtm

    cth = (u * v).sum(-1, keepdim=True)
    near_pos = cth > 1.0 - tau
    near_neg = cth < -1.0 + tau
    small_u = _norm(xt) < tau
    small_v = _norm(xtm) < tau
    trivial = near_pos | small_u | small_v

    alpha = 1.0 / (1.0 + cth).clamp_min(tau)
    av = (v * w).sum(-1, keepdim=True)
    bu = (u * w).sum(-1, keepdim=True)
    kw = u * av - v * bu
    k2w = u * (av * cth - bu) + v * (bu * cth - av)
    y_gen = w - kw + alpha * k2w

    # antipodal: reflect across v and an orthonormal perp of v
    idx = v.abs().argmin(-1)
    e = F.one_hot(idx, c).to(x.dtype)
    p = _safe_unit(e - (e * v).sum(-1, keepdim=True) * v)
    y_neg = (w - 2.0 * (v * w).sum(-1, keepdim=True) * v
             - 2.0 * (p * w).sum(-1, keepdim=True) * p)

    y_main = torch.where(trivial, w, torch.where(near_neg, y_neg, y_gen))
    pad = torch.zeros((b, d, c), dtype=x.dtype, device=x.device)
    return early + torch.cat([pad, y_main], dim=1) * (tt >= d)[None, :, None]


def orthonorm_columns(v, eps: float = 1e-6):
    q, r = torch.linalg.qr(v)
    diag = torch.diagonal(r, dim1=-2, dim2=-1)
    return q * torch.sign(diag + eps)[..., None, :]


def _eye(d: int, r: int, like):
    return torch.eye(d, r, dtype=like.dtype, device=like.device)


def subspace_iteration(cmat, r: int, k: int, v0=None, eps: float = 1e-6):
    """Block-Krylov subspace with a Student-t spectral filter.  cmat:
    (B, D, D) -> (B, D, r)."""
    bsz, d, _ = cmat.shape
    if v0 is None:
        v0 = _eye(d, r, cmat).expand(bsz, d, r)
    z = orthonorm_columns(v0, eps)
    blocks = []
    for _ in range(max(1, k)):
        blocks.append(z)
        z = orthonorm_columns(cmat @ z, eps)
    q = orthonorm_columns(torch.cat(blocks, dim=2), eps)

    h = q.transpose(1, 2) @ (cmat @ q)
    evals, u = torch.linalg.eigh(h)
    kappa = torch.quantile(evals.clamp_min(eps), 0.80, dim=-1,
                           keepdim=True) + eps
    nu = 4.0
    gt = 1.0 - torch.pow(1.0 + evals / kappa, -0.5 * nu)
    scores = evals.clamp_min(eps).sqrt() * gt
    idx = torch.argsort(-scores, dim=-1, stable=True)[..., :r]
    u_top = torch.gather(u, 2, idx[:, None, :].expand(-1, u.shape[1], -1))
    return orthonorm_columns(q @ u_top, eps)


def sign_align(v, a, eps: float = 1e-12):
    dots = (v * a[..., None]).sum(1)
    return v * torch.sign(dots + eps)[:, None, :]


def energy_normalize(traces, eps: float = 1e-8):
    scales = torch.sqrt((traces**2).sum(1, keepdim=True) + eps)
    return traces / scales, scales


def soft_shrink(x, lam: float):
    if lam <= 0.0:
        return x
    return torch.sign(x) * _gelu(x.abs() - lam)


class LowRankShift(nn.Module):
    """S(X) = Dense_1(gelu(Dense_0(X))), a rank-``shift_rank`` residual
    shift on ``dim`` features."""

    def __init__(self, dim: int, shift_rank: int, *, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        self.Dense_0 = _init.dense(dim, shift_rank, gen, device, dtype,
                                   bias=False)
        self.Dense_1 = _init.dense(shift_rank, dim, gen, device, dtype)

    def forward(self, x):
        return self.Dense_1(_gelu(self.Dense_0(x)))


@functools.lru_cache(maxsize=512)
def _chirps(t_len: int, alpha: float, t_min: float, t_max: float,
            eps: float, dtype: torch.dtype, device: torch.device):
    """``frft_time``'s constants, built in complex128 numpy as JAX builds
    them, cast once to ``dtype`` on ``device``: the pre/post chirp (T,),
    the FFT of the padded chirp kernel (L,), and the scalar prefactor;
    ``None`` where the transform is the identity or the reversal."""
    a = ((float(alpha) + math.pi) % (2.0 * math.pi)) - math.pi
    if abs(a) < 1e-6 or abs(abs(a) - math.pi) < 1e-6:
        return None
    s = math.copysign(1.0 / max(eps, abs(math.sin(a))), math.sin(a))
    # sign-preserving guard on cot(a), JAX's deliberate deviation from the
    # reference (pyitd_tpu/ml/vte.py:249-256)
    c = math.cos(a) / math.copysign(max(eps, abs(math.sin(a))), math.sin(a))
    t = np.linspace(t_min, t_max, t_len)
    dt = (t_max - t_min) / (t_len - 1) if t_len > 1 else 1.0
    pre_post = np.exp(1j * np.pi * (c + s) * t**2)
    m = np.arange(-(t_len - 1), t_len)
    h = np.exp(-1j * np.pi * s * (m * dt) ** 2)
    ln = 1 << (2 * t_len - 2).bit_length()
    h_pad = np.zeros(ln, complex)
    h_pad[m % ln] = h
    hf = np.fft.fft(h_pad)
    pref = complex(np.sqrt(1.0 - 1j * c)) * dt

    def put(arr):
        return torch.as_tensor(arr, device=device).to(dtype)

    return put(pre_post), put(hf), pref


def frft_time(z, alpha: float, *, t_min: float = -1.0, t_max: float = 1.0,
              eps: float = 1e-7):
    """Fractional Fourier transform along axis 1 (chirp convolution);
    real input becomes complex (float64 -> complex128, else complex64)."""
    if not z.is_complex():
        z = z.to(torch.complex128 if z.dtype == torch.float64
                 else torch.complex64)
    t_len = z.shape[1]
    a = ((float(alpha) + math.pi) % (2.0 * math.pi)) - math.pi
    if abs(a) < 1e-6:
        return z
    if abs(abs(a) - math.pi) < 1e-6:
        return complex(np.exp(1j * math.copysign(math.pi / 2, a))) * \
            torch.flip(z, dims=(1,))
    pre_post, hf, pref = _chirps(t_len, float(alpha), float(t_min),
                                 float(t_max), float(eps), z.dtype, z.device)
    tail = (1,) * (z.dim() - 2)
    pre_post = pre_post.reshape((1, t_len) + tail)
    ln = hf.shape[0]
    g = z * pre_post
    g_pad = F.pad(g.movedim(1, -1), (0, ln - t_len)).movedim(-1, 1)
    gf = torch.fft.fft(g_pad, dim=1)
    conv = torch.fft.ifft(gf * hf.reshape((1, ln) + tail), dim=1)
    return pref * pre_post * conv[:, t_len - 1:2 * t_len - 1]


def subspace_iteration_linop(matvec, v0, k: int, eps: float = 1e-6):
    """Power iteration over a linear operator with QR
    orthonormalization."""
    v = orthonorm_columns(v0, eps)
    for _ in range(max(1, k)):
        v = orthonorm_columns(matvec(v), eps)
    return v


def ar1_filter(traces, rho: float):
    """Causal AR(1) smoothing along time, ``y_t = rho y_{t-1} + x_t``, as
    a doubling scan of the affine maps ``y -> a_t y + x_t`` (``a_0 = 0``):
    log2(T) rounds of tensor ops."""
    t = traces.shape[1]
    a = torch.full_like(traces, rho)
    a[:, 0] = 0.0
    c = traces
    off = 1
    while off < t:
        c = torch.cat([c[:, :off], a[:, off:] * c[:, :-off] + c[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return c


class ManifoldStage(nn.Module):
    """Stages 1/2 of the no-attention manifold mixer on ``dim`` features.

    ``use_frft=True`` gives Stage1 (FrFT-energy-weighted Omega
    covariance); False gives Stage2 (plain covariance)."""

    def __init__(self, dim: int, rank: int = 16, k_iters: int = 2,
                 shift_rank: int = 0, shrink_lambda: float = 0.0,
                 causal: bool = False, ar_rho: float = 0.0, eps: float = 1e-5,
                 use_layernorm: bool = True, use_frft: bool = False,
                 n_alphas: int | None = None, *, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        self.rank, self.k_iters, self.eps = rank, k_iters, eps
        self.shrink_lambda = shrink_lambda
        self.causal, self.ar_rho = causal, ar_rho
        self.use_frft = use_frft
        # the reference's fixed alpha grid, n_alphas defaulting to rank
        self.alphas = [float(a) for a in
                       np.linspace(0.15, 2.99, n_alphas or rank)]
        if shift_rank > 0:
            self.LowRankShift_0 = LowRankShift(dim, shift_rank,
                                               device=device, dtype=dtype,
                                               generator=gen)
        else:
            self.LowRankShift_0 = None
        self.out = _init.dense(dim, dim, gen, device, dtype, bias=False)
        self.LayerNorm_0 = (_init.layer_norm(dim, device, dtype)
                            if use_layernorm else None)

    def forward(self, x):
        b, t, d = x.shape
        anchor = torch.zeros((b, d), dtype=x.dtype, device=x.device)
        anchor[:, 0] = 1.0
        xc = x - anchor[:, None, :]
        s = self.LowRankShift_0(x) if self.LowRankShift_0 is not None \
            else None
        xprime = xc + s if s is not None else xc
        xprime_t = xprime.transpose(1, 2)
        v0 = _eye(d, self.rank, x).expand(b, d, self.rank)

        if self.use_frft:
            weights = []
            for alpha in self.alphas:
                e_a = frft_time(xprime, alpha).abs().pow(2).mean(2)
                w_a = (e_a + 1e-6) ** 0.5
                weights.append((alpha, w_a / (w_a.mean(1, keepdim=True)
                                              + 1e-6)))

            def komega(y):
                out = None
                for alpha, w in weights:
                    term = frft_time(w[..., None] * frft_time(y, alpha),
                                     -alpha)
                    out = term if out is None else out + term
                return (out / len(weights)).real.to(x.dtype)
        else:
            def komega(y):
                return y

        def matvec(v):
            return xprime_t @ komega(xprime @ v) / t + self.eps * v

        v = subspace_iteration_linop(matvec, v0, self.k_iters, self.eps)
        v = sign_align(v, anchor)

        traces = xprime @ v
        traces_n, scales = energy_normalize(traces, self.eps)
        traces_n = soft_shrink(traces_n, self.shrink_lambda)
        traces_n = spiral_mix(traces_n, loop_iters=2)
        if self.causal and self.ar_rho > 0.0:
            traces_n = ar1_filter(traces_n, self.ar_rho)
        x_hat = (traces_n * scales) @ v.transpose(1, 2) + anchor[:, None, :]
        if s is not None:
            x_hat = x_hat - s
        y = x + self.out(x_hat)
        return self.LayerNorm_0(y) if self.LayerNorm_0 is not None else y


class _Cell(nn.Module):
    def __init__(self, dim: int, gen, device, dtype):
        super().__init__()
        self.Dense_0 = _init.dense(dim, 2 * dim, gen, device, dtype,
                                   bias=False, init="he")
        self.Dense_1 = _init.dense(2 * dim, dim, gen, device, dtype,
                                   init="he")

    def forward(self, x):
        return self.Dense_1(_gelu(self.Dense_0(x)))


class AutoencoderBlock(nn.Module):
    """PhaseTransport front-end + encode -> stage1 -> stage2 -> decode, on
    ``dim`` features."""

    def __init__(self, dim: int, rank: int = 16, *, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        kw = dict(device=device, dtype=dtype, generator=gen)
        self.LayerNorm_0 = _init.layer_norm(dim, device, dtype)
        self.enc1 = _Cell(dim, gen, device, dtype)
        self.convolve1 = ManifoldStage(dim, rank, k_iters=3, shift_rank=8,
                                       shrink_lambda=0.01, use_frft=True,
                                       **kw)
        self.convolve2 = ManifoldStage(dim, rank, k_iters=2, shift_rank=8,
                                       shrink_lambda=0.01, use_frft=False,
                                       **kw)
        self.dec1 = _Cell(dim, gen, device, dtype)

    def forward(self, x):
        z = self.LayerNorm_0(x)
        z = z + phase_transport(z, 1)
        z1 = self.dec1(self.convolve2(self.convolve1(self.enc1(z))))
        return x + z1


class BlockFastGPT(nn.Module):
    """The attention-free GPT wrapper: fixed zero-mean unit-norm embeddings
    (``seed``), an AutoencoderBlock stack, a linear head; ``forward(idx,
    targets=None)`` returns ``(logits, loss)``, the last position's logits
    only when there are no targets."""

    def __init__(self, vocab_size: int = 66, n_embd: int = 128,
                 n_layer: int = 2, rank: int = 16, seed: int = 123, *,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        self.n_layer = n_layer
        self.register_buffer("wte", fixed_embedding(
            vocab_size, n_embd, seed, device=device).to(dtype),
            persistent=False)
        for i in range(n_layer):
            self.add_module(f"block_{i}", AutoencoderBlock(
                n_embd, rank, device=device, dtype=dtype, generator=gen))
        self.lm_head = _init.dense(n_embd, vocab_size, gen, device, dtype,
                                   bias=False)

    def forward(self, idx, targets=None):
        x = self.wte[idx]
        for i in range(self.n_layer):
            x = getattr(self, f"block_{i}")(x)
        logits = self.lm_head(x)
        if targets is None:
            return logits[:, -1:], None
        return logits, token_nll(logits, targets)


def dynmix(comps, step: float = 0.1, loop_iters: int = 2):
    """Cooperative symplectic mixer for >= 3 tensors: each component takes
    a Heun step toward the mean of the others, gated by a sigmoid of their
    normalized inner product.  ``comps``: a list of same-shaped tensors or
    a stacked tensor with the component axis first."""
    listed = isinstance(comps, (list, tuple))
    stacked = torch.stack(list(comps), 0) if listed else comps
    n = stacked.shape[0]
    if n < 3:
        raise ValueError("Need at least 3 components")
    for _ in range(loop_iters):
        others = (stacked.sum(0, keepdim=True) - stacked) / (n - 1)
        w = torch.sigmoid((stacked * others).sum(-1, keepdim=True)
                          / (2.0 * stacked.shape[-1] ** 0.5))
        k1 = w * (others - stacked)
        k2 = w * (others - (stacked + step * k1))
        stacked = stacked + 0.5 * step * (k1 + k2)
    return [stacked[i] for i in range(n)] if listed else stacked
