"""Decomposition-as-features model layers: port of
``pyitd_tpu/ml/layers.py``.

``ITDLinear`` renders a bank of multi-scale monotone-cubic smoothings of
the input sequence (grid sizes ``linspace(2, L/2, out_dim)``, weighted
harmonic slopes, Hermite basis evaluation); the MLP and RNN heads consume
that bank.  The per-scale grids, segment ids and Hermite bases depend only
on ``(L, out_dim)``: they are built once per pair (:func:`_scale_constants`)
and kept on the module's device as buffers.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.interop import checked_device
from . import _init

__all__ = ["ITDLinear", "ITDMLP", "VanillaMLP", "ITDRNNForecaster"]


@lru_cache(maxsize=None)
def _scale_constants(input_length: int, output_dim: int):
    """(grid indices, segment ids, Hermite basis, grid size) per scale."""
    positions = np.arange(input_length, dtype=np.float64)
    consts = []
    for grid_size in np.linspace(2, input_length // 2, output_dim):
        g = int(grid_size)
        idx = np.linspace(0, input_length - 1, g).astype(np.int64)
        scale_factor = (g - 1) / (input_length - 1)
        seg = np.clip((positions * scale_factor).astype(np.int64), 0, g - 2)
        x_grid = idx.astype(np.float64)
        start, end = x_grid[seg], x_grid[seg + 1]
        t = (positions - start) / (end - start + 1e-12)
        t2, t3 = t * t, t * t * t
        basis = np.stack(
            [2 * t3 - 3 * t2 + 1, t3 - 2 * t2 + t, -2 * t3 + 3 * t2, t3 - t2]
        )
        consts.append((idx, seg, basis, g))
    return consts


class ITDLinear(nn.Module):
    """Multi-scale monotone-cubic smoothing bank.

    Input ``(batch, L, 1)`` -> output ``(batch, output_dim, L)``."""

    def __init__(self, input_length: int, output_dim: int,
                 use_bias: bool = True, *, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        dev = checked_device(device)
        self.input_length = input_length
        self.output_dim = output_dim
        self.bias = (_init.parameter(torch.zeros(output_dim, 1,
                                                 dtype=torch.float64),
                                     dev, dtype) if use_bias else None)
        self.grid_sizes = []
        for s, (idx, seg, basis, g) in enumerate(
                _scale_constants(input_length, output_dim)):
            self.register_buffer(f"idx_{s}", torch.as_tensor(
                idx, device=dev), persistent=False)
            self.register_buffer(f"seg_{s}", torch.as_tensor(
                seg, device=dev), persistent=False)
            self.register_buffer(f"basis_{s}", torch.as_tensor(
                basis, device=dev, dtype=dtype), persistent=False)
            self.grid_sizes.append(g)

    def forward(self, x):
        batch = x.shape[0]
        sig = x[..., 0]  # (batch, L)
        outs = []
        for s, g in enumerate(self.grid_sizes):
            idx = getattr(self, f"idx_{s}")
            seg = getattr(self, f"seg_{s}")
            b = getattr(self, f"basis_{s}").to(x.dtype)
            ext = sig[:, idx]  # (batch, g)
            dgrid = (idx[1:] - idx[:-1]).to(x.dtype)
            d = (ext[:, 1:] - ext[:, :-1]) / (dgrid + 1e-12)

            # the end slopes in the reference's order: at g = 2 and g = 3
            # the writes overlap and the last one wins
            m = x.new_zeros(batch, g)
            m[:, 0] = d[:, 0]
            m[:, 1] = d[:, 0]
            m[:, -2] = d[:, -1]
            m[:, -1] = d[:, -1]
            if g > 3:
                d_im2, d_im1 = d[:, 0:g - 4], d[:, 1:g - 3]
                d_i, d_ip1 = d[:, 2:g - 2], d[:, 3:g - 1]
                w1 = (d_ip1 - d_i).abs()
                w2 = (d_im1 - d_im2).abs()
                denom = w1 + w2 + 1e-12
                m[:, 2:g - 2] = torch.where(
                    denom >= 1e-6,
                    (w1 * d_im1 + w2 * d_i) / (denom + 1e-12),
                    0.5 * (d_im1 + d_i))

            y0, y1 = ext[:, seg], ext[:, seg + 1]
            m0, m1 = m[:, seg], m[:, seg + 1]
            delta = (idx[1] - idx[0]).to(x.dtype)
            baseline = (b[0] * y0 + b[1] * m0 * delta + b[2] * y1
                        + b[3] * m1 * delta)
            if self.bias is not None:
                baseline = baseline + self.bias[s]
            outs.append(baseline)
        return torch.stack(outs, dim=1)


class VanillaMLP(nn.Module):
    """Whole-signal MLP baseline: ``(batch, L, 1)`` flattened through two
    Dense layers to ``(batch, output_length, 1)``."""

    def __init__(self, input_length: int, hidden_dim: int,
                 output_length: int, *, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        self.output_length = output_length
        self.Dense_0 = _init.dense(input_length, hidden_dim, gen, device,
                                   dtype)
        self.Dense_1 = _init.dense(hidden_dim, output_length, gen, device,
                                   dtype)

    def forward(self, x):
        batch = x.shape[0]
        h = F.gelu(self.Dense_0(x.reshape(batch, -1)), approximate="tanh")
        return self.Dense_1(h).reshape(batch, self.output_length, 1)


class ITDMLP(nn.Module):
    """ITDLinear feature bank -> per-sample MLP head."""

    def __init__(self, input_length: int, hidden_dim: int,
                 output_length: int, *, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        self.input_length = input_length
        self.output_length = output_length
        self.ITDLinear_0 = ITDLinear(input_length, hidden_dim, device=device,
                                     dtype=dtype)
        self.Dense_0 = _init.dense(hidden_dim, hidden_dim, gen, device, dtype)
        self.Dense_1 = _init.dense(hidden_dim, 1, gen, device, dtype)

    def forward(self, x):
        feats = self.ITDLinear_0(x).movedim(1, 2)  # (b, L, h)
        h = F.gelu(self.Dense_0(feats), approximate="tanh")
        out = self.Dense_1(h)  # (b, L, 1)
        if self.output_length != self.input_length:
            out = out[:, :self.output_length]
        return out


class ITDRNNForecaster(nn.Module):
    """ITD feature bank feeding a stack of simple tanh-GELU RNN cells."""

    def __init__(self, seq_len: int, hidden_size: int = 64,
                 num_layers: int = 2, output_size: int = 1, *,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        self.seq_len = seq_len
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.ITDLinear_0 = ITDLinear(seq_len, hidden_size, device=device,
                                     dtype=dtype)
        # flax's names in creation order: the i2h cells, the h2h cells,
        # then the output projection
        for j in range(2 * num_layers):
            self.add_module(f"Dense_{j}", _init.dense(
                hidden_size, hidden_size, gen, device, dtype))
        self.add_module(f"Dense_{2 * num_layers}", _init.dense(
            hidden_size, output_size, gen, device, dtype))

    def forward(self, x):
        seq = self.ITDLinear_0(x).movedim(1, 2)  # (b, L, h)
        layers = self.num_layers
        i2h = [getattr(self, f"Dense_{j}") for j in range(layers)]
        h2h = [getattr(self, f"Dense_{layers + j}") for j in range(layers)]
        out_proj = getattr(self, f"Dense_{2 * layers}")
        hs = [x.new_zeros(seq.shape[0], self.hidden_size)
              for _ in range(layers)]
        outputs = []
        for t in range(self.seq_len):
            inp = seq[:, t]
            for layer in range(layers):
                hs[layer] = F.gelu(i2h[layer](inp) + h2h[layer](hs[layer]),
                                   approximate="tanh")
                inp = hs[layer]
            outputs.append(out_proj(inp))
        return torch.stack(outputs, dim=1)
