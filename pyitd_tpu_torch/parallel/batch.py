"""Batch-parallel conveniences — port of ``pyitd_tpu/parallel/batch.py``.

The natural parallel axis is the signal bank: rows never interact, so each
device sifts its own rows with no collective.  Pair with
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


def sharded_streaming_itd(*args, **kwargs):
    """JAX's block-protocol streaming over a channel bank: not ported, it
    waits for ``decomp/streaming.py`` (ROADMAP.md, queue 1, item 10)."""
    raise NotImplementedError(
        "sharded_streaming_itd needs decomp/streaming.py, which is not "
        "ported yet (ROADMAP.md, queue 1, item 10)")
