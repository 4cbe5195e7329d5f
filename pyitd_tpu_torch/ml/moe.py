"""Recurrent-MLP and hash-MoE family: port of ``pyitd_tpu/ml/moe.py``.

* :class:`LinearBilinear` / :class:`BiMLP`: bilinear-gated MLPs, with the
  reference's ``act(fc1(x+1))-1`` shifts;
* :class:`ModCRTMoE`: hard hash routing, a random linear hash folded mod
  per-channel periods into residues over pairwise coprime moduli,
  Chinese-Remainder candidates from every channel pair, the candidate with
  the most residue agreement picks the expert (mod E); expert banks
  ``W1 (E, 2D, D)``, ``W2 (E, D, 2D)``, ``b2 (E, D)`` in JAX's layout;
* :func:`router_topk`: top-k with softmax gate weights and the reference's
  own backward, a ``torch.autograd.Function``;
* :class:`FastLearnedCellX3`: three top-k routed weight tapes applied as
  gather-einsum mixtures.

The hash weights and the address projection come from
``np.random.default_rng(seed)`` as in JAX, so one seed gives one hash on
every device; the routing runs in integer arithmetic on the device.  Top-k
is the stable descending sort of ``ultramem.top_k`` (``jax.lax.top_k``'s
tie order).  With ``dispatch="capacity"`` and the banks placed
``Shard(0)`` by ``parallel.train.shard_params`` (``MOE_EP_RULES``), each
rank computes its own experts' GEMMs and one all-reduce over the expert
group sums the combined outputs.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from ..parallel.comm import copy_to_group, reduce_from_group
from ..utils.interop import checked_device
from . import _init
from .ultramem import top_k

__all__ = [
    "LinearBilinear",
    "BiMLP",
    "ModCRTMoE",
    "capacity_dispatch",
    "router_topk",
    "FastLearnedCellX3",
    "first_primes",
]


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # flax's nn.gelu


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n % 2 == 0:
        return n == 2
    f = 3
    while f * f <= n:
        if n % f == 0:
            return False
        f += 2
    return True


def first_primes(k: int, start: int = 3) -> List[int]:
    out, p = [], max(3, start | 1)
    while len(out) < k:
        if _is_prime(p):
            out.append(p)
        p += 2
    return out


def _inv_mod(a: int, m: int) -> int:
    t, new_t, r, new_r = 0, 1, m, a % m
    while new_r:
        q = r // new_r
        t, new_t = new_t, t - q * new_t
        r, new_r = new_r, r - q * new_r
    if r != 1:
        raise ValueError("not invertible")
    return t % m


class LinearBilinear(nn.Module):
    """Low-rank bilinear gate folded into the first layer, on ``dim``
    features: ``W2(gelu(W1 x + alpha B((x_q U) * (x_c V))))``."""

    def __init__(self, dim: int, rank: int, q_frac: float = 0.6,
                 alpha: float = 1.0, hidden: int | None = None, *,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        h = hidden or dim
        self.dq = max(1, min(dim - 1, int(round(q_frac * dim))))
        dc = dim - self.dq
        self.alpha = alpha
        self.U = _init.parameter(_init.normal(
            (self.dq, rank), 1.0 / math.sqrt(self.dq), gen), device, dtype)
        self.V = _init.parameter(_init.normal(
            (dc, rank), 1.0 / math.sqrt(dc), gen), device, dtype)
        self.W1 = _init.dense(dim, h, gen, device, dtype, bias=False)
        self.B = _init.dense(rank, h, gen, device, dtype, bias=False)
        self.W2 = _init.dense(h, dim, gen, device, dtype)

    def forward(self, x):
        z = (x[..., :self.dq] @ self.U) * (x[..., self.dq:] @ self.V)
        return self.W2(_gelu(self.W1(x) + self.alpha * self.B(z)))


class BiMLP(nn.Module):
    """``fc2(gelu(fc1(x + 1)) - 1) - 1`` on ``dim`` features (the shifts
    are the reference's)."""

    def __init__(self, dim: int, *, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        kw = dict(device=device, dtype=dtype, generator=gen)
        self.fc1 = LinearBilinear(dim, dim // 2, **kw)
        self.fc2 = _init.dense(dim, dim, gen, device, dtype)

    def forward(self, x):
        h = _gelu(self.fc1(x + 1.0)) - 1.0
        return self.fc2(h) - 1.0


def capacity_dispatch(eid: torch.Tensor, num_experts: int,
                      capacity: int) -> torch.Tensor:
    """GShard-style dispatch tensor for hard single-expert routing: a 0/1
    float ``(tokens, num_experts, capacity)`` tensor D with ``D[n, e, c] =
    1`` iff token n is the c-th token routed to expert e and ``c <
    capacity``; tokens beyond an expert's capacity are dropped (zero
    rows)."""
    one = F.one_hot(eid.long(), num_experts)  # (N, E)
    pos = torch.cumsum(one, dim=0) * one - 1  # slot within expert, -1 if not
    slots = torch.arange(capacity, device=eid.device)
    return (pos[..., None] == slots).to(torch.float32)


class ModCRTMoE(nn.Module):
    """Hard CRT-consensus hash router + expert bank on ``dim`` features.

    ``dispatch="gather"`` (default) serves every token by its routed expert
    through per-token gathered weights; ``dispatch="capacity"`` uses
    :func:`capacity_dispatch` buffers, the same outputs whenever no expert
    overflows ``capacity``, and the form that runs expert-parallel."""

    def __init__(self, dim: int, num_experts: int,
                 moduli: Sequence[int] | None = None, seed: int = 0,
                 dispatch: str = "gather", capacity: int | None = None,
                 capacity_factor: float = 2.0, *, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        if dispatch not in ("gather", "capacity"):
            raise ValueError(f"unknown dispatch {dispatch!r}")
        gen = _init.generator_or_default(generator)
        self.num_experts = num_experts
        self.moduli = self._moduli(moduli, num_experts)
        self.dispatch = dispatch
        self.capacity = capacity
        self.capacity_factor = capacity_factor
        dev = checked_device(device)
        kch = len(self.moduli)
        rng = np.random.default_rng(seed)
        w_hash = rng.normal(size=(dim, kch)) / math.sqrt(dim)
        b_hash = rng.normal(size=(kch,)) * 0.01
        self.register_buffer("w_hash", torch.as_tensor(w_hash, device=dev),
                             persistent=False)
        self.register_buffer("b_hash", torch.as_tensor(b_hash, device=dev),
                             persistent=False)
        self.register_buffer("m", torch.as_tensor(self.moduli, device=dev),
                             persistent=False)
        # CRT constants per channel pair (i, j): m_i, m_j, m_i^-1 mod m_j
        pairs = [(i, j, self.moduli[i], self.moduli[j],
                  _inv_mod(self.moduli[i] % self.moduli[j], self.moduli[j]))
                 for i in range(kch) for j in range(i + 1, kch)]
        self._pairs = pairs
        e, h = num_experts, 2 * dim
        # the expert axis is a batch axis of the init: fan-in is the
        # contraction dim alone (flax's variance_scaling with batch_axis=0)
        self.W1 = _init.parameter(_init.he_uniform((e, h, dim), dim, gen),
                                  device, dtype)
        self.W2 = _init.parameter(_init.he_uniform((e, dim, h), h, gen),
                                  device, dtype)
        self.b2 = _init.parameter(torch.zeros(e, dim, dtype=torch.float64),
                                  device, dtype)

    @staticmethod
    def _moduli(moduli, num_experts) -> List[int]:
        if moduli is not None:
            return list(moduli)
        k = 3
        while True:
            primes = first_primes(k)
            if int(np.prod(primes)) >= max(4 * num_experts, 256):
                return primes
            k += 1

    def route(self, xf: torch.Tensor) -> torch.Tensor:
        """The expert of every row of ``xf`` (N, D), int64, no gradient."""
        with torch.no_grad():
            dt = xf.dtype
            s = xf @ self.w_hash.to(dt) + self.b_hash.to(dt)
            f = torch.remainder(s, 1.0)  # the periods are all one
            mf = self.m.to(dt)
            r = torch.floor(f * mf + 0.5)
            r = torch.remainder(r, mf).long()  # (N, K)
            cands = []
            for i, j, m1, m2, inv in self._pairs:
                t = ((r[:, j] - r[:, i]) % m2) * inv % m2
                cands.append((r[:, i] + t * m1) % (m1 * m2))
            cand = torch.stack(cands, dim=1)  # (N, P)
            match = (cand[:, :, None] % self.m) == r[:, None, :]
            best = torch.gather(cand, 1, match.sum(-1).argmax(1, keepdim=True))
            return best[:, 0] % self.num_experts

    def forward(self, x):
        d = x.shape[-1]
        xf = x.reshape(-1, d)
        eid = self.route(xf)
        if self.dispatch == "gather":
            if isinstance(self.W1, DTensor):
                raise ValueError("expert parallelism takes "
                                 "dispatch='capacity'")
            h = _gelu(torch.einsum("nhd,nd->nh", self.W1[eid], xf))
            y = torch.einsum("noh,nh->no", self.W2[eid], h) + self.b2[eid]
            return y.reshape(x.shape)
        e = self.num_experts
        cap = self.capacity
        if cap is None:
            cap = max(1, int(math.ceil(xf.shape[0] / e
                                       * self.capacity_factor)))
        disp = capacity_dispatch(eid, e, cap).to(x.dtype)  # (N, E, C)
        w1, w2, b2 = self.W1, self.W2, self.b2
        group = None
        if isinstance(w1, DTensor):  # expert-parallel: this rank's experts
            mesh = w1.device_mesh
            group = mesh.get_group()
            lo = mesh.get_local_rank() * w1.to_local().shape[0]
            w1, w2, b2 = w1.to_local(), w2.to_local(), b2.to_local()
            disp = disp[:, lo:lo + w1.shape[0]]
            xf = copy_to_group(xf, group)
        xe = torch.einsum("nec,nd->ecd", disp, xf)
        h = _gelu(torch.einsum("ehd,ecd->ech", w1, xe))
        ye = torch.einsum("edh,ech->ecd", w2, h) + b2[:, None, :]
        y = torch.einsum("nec,ecd->nd", disp, ye)
        if group is not None:
            y = reduce_from_group(y, group)
        return y.reshape(x.shape)


class _RouterTopK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, k, tau):
        topv, topi = top_k(z, k)
        w = torch.softmax(topv / (tau + 1e-8), dim=-1)
        ctx.save_for_backward(topi, w)
        ctx.n_cols, ctx.tau = z.shape[-1], tau
        ctx.mark_non_differentiable(topi)
        return topi, w

    @staticmethod
    def backward(ctx, _grad_topi, grad_w):
        topi, w = ctx.saved_tensors
        s = (grad_w * w).sum(-1, keepdim=True)
        grad_topv = (w * (grad_w - s)) / (ctx.tau + 1e-8)
        # the push into (N, E) zeros as a one-hot product: no scatter, so
        # deterministic on the card (the top-k indices of a row differ)
        onehot = F.one_hot(topi, ctx.n_cols).to(grad_topv.dtype)
        return (onehot * grad_topv[..., None]).sum(-2), None, None


def router_topk(z: torch.Tensor, k: int, tau: float):
    """``(topi, w)``: the ``k`` largest of each row of ``z`` (ties lowest
    index first) and their softmax at temperature ``tau``; the backward is
    the softmax Jacobian pushed into the selected entries."""
    return _RouterTopK.apply(z, k, tau)


def _apply_mixture(x, topi, weights, w):
    """Sum_k w_k * W[topi_k] @ x per token."""
    xk = x[:, None, :] * weights[:, :, None]  # (N, k, in)
    return torch.einsum("nkoi,nki->no", w[topi], xk)


def _apply_bias(topi, weights, b):
    return torch.einsum("nko,nk->no", b[topi], weights)


class FastLearnedCellX3(nn.Module):
    """Tape-addressed mixture cell: a fixed random address projection of
    the ``d_in`` input features (``seed``; give each instance its own),
    three top-k routed tapes ``W1``/``W2``/``b2``."""

    def __init__(self, d_in: int, hidden: int, d_out: int, l_w1: int = 12,
                 l_w2: int = 12, l_b2: int = 12, k1: int = 3, k2: int = 3,
                 k3: int = 3, tau: float = 1.0, d_addr: int = 32,
                 seed: int = 0, *, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        self.k = (k1, k2, k3)
        self.tau = tau
        self.d_out = d_out
        rng = np.random.default_rng(seed)
        p = rng.normal(size=(d_in, d_addr)) / math.sqrt(d_in)
        self.register_buffer("p", torch.as_tensor(
            p, device=checked_device(device)), persistent=False)

        def unit_rows(shape):
            u = torch.randn(shape, generator=gen, dtype=torch.float64)
            u = u - u.mean(1, keepdim=True)
            return u / (torch.linalg.vector_norm(u, dim=1, keepdim=True)
                        + 1e-8)

        def tape(shape):
            w = torch.randn(shape, generator=gen, dtype=torch.float64)
            axes = tuple(range(1, w.dim()))
            return w / ((w**2).sum(axes, keepdim=True).sqrt() + 1e-12)

        def param(values):
            return _init.parameter(values, device, dtype)

        self.U1 = param(unit_rows((l_w1, d_addr)))
        self.U2 = param(unit_rows((l_w2, d_addr)))
        self.U3 = param(unit_rows((l_b2, d_addr)))
        self.W1 = param(tape((l_w1, hidden, d_in)))
        self.W2 = param(tape((l_w2, d_out, hidden)))
        self.b2 = param(tape((l_b2, d_out)))

    def forward(self, x):
        xf = x.reshape(-1, x.shape[-1])
        addr = xf @ self.p.to(x.dtype)
        k1, k2, k3 = self.k
        i1, g1 = router_topk(addr @ self.U1.T, k1, self.tau)
        i2, g2 = router_topk(addr @ self.U2.T, k2, self.tau)
        i3, g3 = router_topk(addr @ self.U3.T, k3, self.tau)
        h = _gelu(_apply_mixture(xf, i1, g1, self.W1))
        y = _apply_mixture(h, i2, g2, self.W2) + _apply_bias(i3, g3, self.b2)
        return y.reshape(x.shape[:-1] + (self.d_out,))
