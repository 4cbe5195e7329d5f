"""2-D decomposition by serialization (Serial-EFD.ipynb cells 2-3) — port
of ``pyitd_tpu/decomp/serial2d.py``.

``sconcatenate`` flattens an image column-major into one long 1-D signal,
inserting ``num_interval`` cross-faded transition samples between adjacent
columns so any 1-D decomposer (EFD, ITD, ...) can process it;
``sdeconcatenate`` inverts the layout for per-mode images.  numpy's
``order="F"`` flatten and reshape become transposes around C-order ones.
"""
from __future__ import annotations

import torch

from ..utils.interop import as_input

__all__ = ["sconcatenate", "sdeconcatenate"]


def sconcatenate(matrix_x, num_interval: int, *, device="cuda"):
    """(length, signals) -> serialized column vector (Serial-EFD cell 2).
    A tensor stays on its device; anything else goes to ``device``."""
    x = as_input(matrix_x, None, device)
    a = x[:num_interval, 1:]           # heads of the *next* columns
    b = x[-num_interval:, :-1]         # tails of the current columns

    ramp = torch.linspace(0, 1, num_interval + 2, dtype=torch.float64,
                          device=x.device)[1:-1][:, None]
    trans = a.flip(0) * ramp + b.flip(0) * ramp.flip(0)
    trans = torch.cat([trans, trans.new_zeros((num_interval, 1))], dim=1)
    r = torch.cat([x.to(trans.dtype), trans], dim=0)
    r = r.T.reshape(-1)[:-num_interval]   # column-major flatten
    return r.reshape(-1, 1)


def sdeconcatenate(matrix_r, num_interval: int, num_signal: int, *,
                   device="cuda"):
    """serialized (samples, modes) -> (length, modes, signals)
    (Serial-EFD cell 3).  A tensor stays on its device; anything else goes
    to ``device``."""
    r = as_input(matrix_r, None, device)
    num_mode = r.shape[1]
    r = torch.cat([r, r.new_zeros((num_interval, num_mode))], dim=0)
    # reshape((-1, num_signal, num_mode), order="F")
    imf = r.T.reshape(num_mode, num_signal, -1).permute(2, 1, 0)
    imf = imf[:-num_interval, :, :]
    return imf.permute(0, 2, 1)
