"""BlockFast language-model family and its O(1) incremental inference:
port of ``pyitd_tpu/ml/blockfast.py``.

* :func:`circular_student_t`: circular Student-t routing weights over E
  expert bins;
* :class:`MOEMLP`: phase-scalar-routed mixture of GELU MLP experts;
* :class:`BlockFastBlock`: Mixer (spectral phase heads + causal depthwise
  conv) -> phase heads (with the routing scalar) -> MOE, parallel
  residual;
* :class:`BlockFastLM`: embedding -> BlockFast stack -> linear head;
* :func:`blockfast_init_state` and :func:`blockfast_step`: one token at a
  time through every block, carrying ring buffers of normalized head
  vectors (the lag-s anchors), the depthwise-conv tail and the lag-1
  scalar state as ``NamedTuple``s of tensors on the model's device,
  updated functionally (each step returns new tensors, no state is
  written in place).

The step path keeps JAX's fixed dtypes: the mixer ring is complex64, the
conv tail and the block ring float32, ``s_prev`` float32, the mixer's
FFT runs on float32; so it is float32 even for a float64 model.  It takes
the blocks themselves (JAX takes their params dict) and applies each
block's own :class:`MOEMLP`.  After the warm-up window the step path
matches the full-sequence forward; the cold start differs by design (zero
rings where the full pass clamps anchors to t = 0).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.interop import checked_device
from . import _init
from .phase import Mixer, add_hypersphere_phase_heads
from .zoo import token_nll

__all__ = [
    "circular_student_t",
    "MOEMLP",
    "BlockFastBlock",
    "BlockFastLM",
    "PhaseState",
    "MixerState",
    "BlockState",
    "blockfast_init_state",
    "blockfast_step",
]


def circular_student_t(center: torch.Tensor, e: int, v: float):
    """center: (...,) -> weights (..., E); Student-t pdf over circular
    bins."""
    idx = torch.arange(e, dtype=center.dtype, device=center.device)
    c = center[..., None]
    c = c - torch.floor(c / e) * e
    delta = (idx - c).abs()
    d = torch.minimum(delta, float(e) - delta)
    w = torch.pow(1.0 + (d * d) / v, -0.5 * (v + 1.0))
    return w / (w.sum(-1, keepdim=True) + 1e-12)


class _MLP(nn.Module):
    def __init__(self, dim: int, gen, device, dtype):
        super().__init__()
        self.Dense_0 = _init.dense(dim, 4 * dim, gen, device, dtype)
        self.Dense_1 = _init.dense(4 * dim, dim, gen, device, dtype)

    def forward(self, x):
        return self.Dense_1(F.gelu(self.Dense_0(x), approximate="tanh"))


class MOEMLP(nn.Module):
    """``num_experts`` MLPs on ``dim`` features blended by the
    circular-Student-t weights of the phase scalar."""

    def __init__(self, dim: int, num_experts: int,
                 v: float = 2.718281828459045, *, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        self.num_experts = num_experts
        self.v = v
        for i in range(num_experts):
            self.add_module(f"expert_{i}", _MLP(dim, gen, device, dtype))

    def forward(self, x, scalar):
        e = self.num_experts
        w = circular_student_t((scalar * e) % e, e, self.v)  # (..., E)
        outs = torch.stack([getattr(self, f"expert_{i}")(x)
                            for i in range(e)], dim=-2)  # (..., E, C)
        return (w[..., None] * outs).sum(-2)


class BlockFastBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, dw_kernel: int = 3, *,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        self.num_heads = num_heads
        self.attn = Mixer(dim, num_heads, dw_kernel, device=device,
                          dtype=dtype, generator=gen)
        self.moe = MOEMLP(dim, num_heads, device=device, dtype=dtype,
                          generator=gen)

    def forward(self, x):
        x_attn = self.attn(x)
        x_phase, scalar = add_hypersphere_phase_heads(
            x_attn, self.num_heads, return_scalar=True)
        return x + x_phase + self.moe(x_phase, scalar)


class BlockFastLM(nn.Module):
    """MachineIntelligence GPT: embeddings -> BlockFast stack -> head;
    ``forward(idx, targets=None)`` returns ``(logits, loss)``."""

    def __init__(self, vocab_size: int, n_embd: int = 64, n_layer: int = 2,
                 n_head: int = 4, *, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        self.vocab_size, self.n_embd = vocab_size, n_embd
        self.n_layer, self.n_head = n_layer, n_head
        self.wte = _init.embed(vocab_size, n_embd, gen, device, dtype)
        for i in range(n_layer):
            self.add_module(f"block_{i}", BlockFastBlock(
                n_embd, n_head, device=device, dtype=dtype, generator=gen))
        self.lm_head = _init.dense(n_embd, vocab_size, gen, device, dtype,
                                   bias=False)

    def blocks(self) -> list:
        return [getattr(self, f"block_{i}") for i in range(self.n_layer)]

    def forward(self, idx, targets=None):
        x = self.wte(idx)
        for block in self.blocks():
            x = block(x)
        logits = self.lm_head(x)
        if targets is None:
            return logits, None
        return logits, token_nll(logits, targets)

    def init_state(self, batch: int) -> list:
        """:func:`blockfast_init_state` for this model, on its device."""
        return blockfast_init_state(
            batch, self.n_embd, self.n_head, self.n_layer,
            self.block_0.attn.dw_kernel, device=self.wte.weight.device)

    def step(self, states, idx_t: torch.Tensor):
        """One token per row, ``idx_t`` (B,): ``(new_states, hidden,
        logits)``."""
        states, h = blockfast_step(self.blocks(), states, self.wte(idx_t),
                                   n_head=self.n_head)
        return states, h, self.lm_head(h)


# ---------------------------------------------------------------------------
# incremental (per-token) inference states
# ---------------------------------------------------------------------------


class PhaseState(NamedTuple):
    rb_v: torch.Tensor        # (B, S-1, D, E) ring of normalized head vecs
    dptr: torch.Tensor        # () int32, the ring's write slot
    v_all_prev: torch.Tensor  # (B, S, E) previous processed normalized heads
    s_prev: torch.Tensor      # (B, S) previous across-head normalized cosines


def _phase_init(b, s, e, dtype, device):
    d = max(s - 1, 1)
    return PhaseState(
        rb_v=torch.zeros((b, d, d, e), dtype=dtype, device=device),
        dptr=torch.zeros((), dtype=torch.int32, device=device),
        v_all_prev=torch.zeros((b, s, e), dtype=dtype, device=device),
        s_prev=torch.zeros((b, s), dtype=torch.float32, device=device),
    )


def _cnorm(z, eps=1e-8):
    return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(
        eps)


def _phase_step(state: PhaseState, x_t, num_segs: int, eps: float,
                need_scalar: bool):
    b, c = x_t.shape
    e = c // num_segs
    d = max(num_segs - 1, 1)
    xh = x_t.reshape(b, num_segs, e)

    if num_segs > 1:
        v = _cnorm(xh[:, 1:], eps)  # (B, S-1, E)
        lags = torch.arange(1, num_segs, device=x_t.device)
        slots = (state.dptr - lags) % d  # (S-1,)
        anchor = state.rb_v[:, torch.arange(num_segs - 1,
                                             device=x_t.device), slots]
        cos = (v * anchor.conj()).sum(-1)
        xproc = xh[:, 1:] + (cos / float(e))[..., None]
        xh_out = torch.cat([xh[:, :1], xproc], dim=1)
        here = torch.arange(d, device=x_t.device) == state.dptr % d
        rb_v = torch.where(here[:, None], v[:, :, None].to(state.rb_v.dtype),
                           state.rb_v)
        dptr = (state.dptr + 1) % d
    else:
        xh_out = xh
        rb_v, dptr = state.rb_v, state.dptr

    y_t = xh_out.reshape(b, c)
    if not need_scalar:
        return PhaseState(rb_v, dptr, state.v_all_prev, state.s_prev), y_t, \
            None

    v_all = _cnorm(xh_out, eps)
    cos1 = (v_all * state.v_all_prev.conj()).sum(-1)
    if cos1.is_complex():
        cos1 = cos1.real
    cos1 = cos1.clamp(-1.0 + eps, 1.0 - eps).to(torch.float32)
    s_norm = cos1 / torch.linalg.vector_norm(
        cos1, dim=1, keepdim=True).clamp_min(eps)
    scalar = (s_norm * state.s_prev).sum(1).clamp(-1.0 + eps, 1.0 - eps)
    return (PhaseState(rb_v, dptr, v_all.to(state.v_all_prev.dtype), s_norm),
            y_t, scalar)


class MixerState(NamedTuple):
    phase: PhaseState
    dw_buf: torch.Tensor  # (B, k-1, C)


class BlockState(NamedTuple):
    mixer: MixerState
    phase: PhaseState


def blockfast_init_state(batch: int, n_embd: int, n_head: int, n_layer: int,
                         dw_kernel: int = 3, device="cuda") -> list:
    """Zero states of every block for ``batch`` rows, on ``device``."""
    dev = checked_device(device)
    e = n_embd // n_head
    return [BlockState(
        mixer=MixerState(
            phase=_phase_init(batch, n_head, e, torch.complex64, dev),
            dw_buf=torch.zeros((batch, dw_kernel - 1, n_embd),
                               dtype=torch.float32, device=dev)),
        phase=_phase_init(batch, n_head, e, torch.float32, dev))
        for _ in range(n_layer)]


def _mixer_step(state: MixerState, x_t, mixer: Mixer, num_segs: int,
                eps: float = 1e-16):
    y_t = torch.fft.fft(x_t.to(torch.float32), dim=1)
    pstate, s_t, _ = _phase_step(state.phase, y_t, num_segs, eps,
                                 need_scalar=False)
    z_t = torch.fft.ifft(s_t, dim=1).real  # (B, C)
    window = torch.cat([state.dw_buf, z_t[:, None, :]], dim=1)  # (B, k, C)
    out = (window * mixer.dw[None]).sum(1)
    return MixerState(pstate, window[:, 1:]), out.to(x_t.dtype)


def blockfast_step(blocks: Sequence[BlockFastBlock], states, x_t, *,
                   n_head: int):
    """One token ``x_t`` (B, C) through every block of ``blocks`` (a
    ``BlockFastLM``'s :meth:`~BlockFastLM.blocks`); the embedding and the
    head are the caller's.  Returns ``(new_states, y_t)``."""
    new_states = []
    h = x_t
    for st, block in zip(states, blocks):
        mstate, x_attn = _mixer_step(st.mixer, h, block.attn, n_head)
        pstate, x_phase, scalar = _phase_step(st.phase, x_attn, n_head, 1e-8,
                                              need_scalar=True)
        h = h + x_phase + block.moe(x_phase, scalar)
        new_states.append(BlockState(mixer=mstate, phase=pstate))
    return new_states, h
