"""Batch-parallel conveniences — port of ``pyitd_tpu/parallel/batch.py``.

The natural parallel axis is the signal bank: rows never interact, so each
device sifts (or streams) its own rows with no collective.  Pair with
``parallel.sharded`` when the time axis must also split.
"""
from __future__ import annotations

import torch

from ..decomp.itd import itd_sift

__all__ = ["pjit_itd_sift", "shard_bank", "sharded_streaming_itd"]


def shard_bank(x: torch.Tensor, devices) -> list[torch.Tensor]:
    """Place a (batch, n) bank with the batch axis over ``devices``: one
    chunk of rows per device, in order; a device beyond the rows gets
    none."""
    return [c.to(d) for c, d in zip(torch.chunk(x, len(devices)), devices)]


def pjit_itd_sift(devices, max_iteration: int = 11, **kwargs):
    """A batched sift with the rows split over ``devices`` (what JAX's
    ``pjit_itd_sift`` is over a mesh's 'data' axis).

    Returns ``fn(x) -> (rotations, baselines, num_components,
    stop_reason)``: ``x`` is a (batch, n) tensor or the list
    :func:`shard_bank` made; every device runs ``itd_sift(chunk,
    max_iteration, **kwargs)`` on its rows, and the results are joined on
    the first device.  One device: one chunk."""
    devices = [torch.device(d) for d in devices]

    def fn(x):
        chunks = shard_bank(x, devices) if isinstance(x, torch.Tensor) \
            else list(x)
        outs = [itd_sift(c, max_iteration, **kwargs) for c in chunks]
        to = devices[0]

        def join(field, dim):
            return torch.cat([getattr(o, field).to(to) for o in outs], dim)

        return (join("rotations", 1), join("baselines", 1),
                join("num_components", 0), join("stop_reason", 0))

    return fn


def sharded_streaming_itd(devices, hop: int, *, iq: bool = False):
    """Block-protocol streaming over a channel bank with the channels split
    over ``devices`` (what JAX's ``sharded_streaming_itd`` is over a mesh's
    'data' axis).  Every channel runs the 3-hop protocol on its own, so no
    collective is needed.

    Returns ``fn(x) -> (rotations, baselines, ready)``: ``x`` is a
    (channels, n) tensor or the list :func:`shard_bank` made; every device
    runs ``streaming_itd`` (``streaming_itd_iq`` with ``iq=True``) on its
    channels, and the hop-major results are joined on the first device."""
    from ..decomp.streaming import streaming_itd, streaming_itd_iq

    run = streaming_itd_iq if iq else streaming_itd
    devices = [torch.device(d) for d in devices]

    def fn(x):
        chunks = shard_bank(x, devices) if isinstance(x, torch.Tensor) \
            else list(x)
        outs = [run(c, hop) for c in chunks]
        to = devices[0]
        return tuple(torch.cat([o[i].to(to) for o in outs], 1)
                     for i in range(3))

    return fn
