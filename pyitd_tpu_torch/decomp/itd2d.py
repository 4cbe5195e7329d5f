"""2-D ensemble ITD (texture/structure separation) — port of
``pyitd_tpu/decomp/itd2d.py``.

Behavioral contract (siftED2D.ipynb cell 1):

* the 1-D kernel is the cubic-tier baseline extract with the <10-extrema
  pass-through guard;
* ``crossways``: row-pass and column-pass baselines, then each re-applied
  along the *other* axis, averaged;
* ``statistical_component``: a noise-assisted ensemble — ``iterations``
  paired realizations ``img ± v`` with ``v ~ N(0, MAD(img))``, each run
  through crossways, pairs averaged, then the ensemble averaged;
* ``totalextract2d`` returns ``[highpass, lowpass]`` with
  ``highpass = img - lowpass`` (exact reconstruction by construction).

Rows and columns go through transposes, and every leading axis (the
realizations too) rides one batched cubic call per pass: four calls per
``statistical_component``, whatever ``iterations`` is.  The noise comes
from ``torch.randn`` with the caller's ``generator`` where JAX takes a
PRNG key; ``noise=`` injects it.
"""
from __future__ import annotations

import torch

from ..utils.interop import as_input
from ..utils.stats import median
from .meitd import _cubic

__all__ = ["mad", "crossways_baseline", "statistical_component",
           "totalextract2d"]


def mad(a: torch.Tensor) -> torch.Tensor:
    """Median absolute deviation (siftED2D `mad`), with ``jnp.median``'s
    mean of the two middle values."""
    return median((a - median(a)).abs())


def _row_baseline(img: torch.Tensor, capacity: int) -> torch.Tensor:
    # every leading axis is batch: one cubic call for all rows (and
    # realizations), never a loop over them
    return _cubic(img, capacity, 10).baseline


def crossways_baseline(img: torch.Tensor) -> torch.Tensor:
    """Row-pass + column-pass baselines, cross-applied, averaged.

    Batch-aware: ``img`` is (..., h, w); leading axes (e.g. ensemble
    realizations) ride through as batch."""
    h, w = img.shape[-2:]
    # worst case (zigzag rows) has an extremum at nearly every sample
    cap_w, cap_h = w + 2, h + 2

    def t(a):
        return a.transpose(-1, -2)

    lengthwise = _row_baseline(img, cap_w)                    # rows
    crosswise = t(_row_baseline(t(img), cap_h))               # cols
    crosswise = _row_baseline(crosswise, cap_w)               # rows again
    lengthwise = t(_row_baseline(t(lengthwise), cap_h))       # cols again
    return 0.5 * (lengthwise + crosswise)


def statistical_component(img: torch.Tensor,
                          generator: torch.Generator | None = None,
                          iterations: int = 20, *,
                          noise: torch.Tensor | None = None) -> torch.Tensor:
    """Noise-assisted ensemble lowpass component (must be even iterations).

    ``noise`` (optional, ``(iterations//2, h, w)``) overrides the random
    draw with caller-provided realizations — the deterministic injection
    point that makes exact cross-implementation parity possible (the
    reference draws from numpy's global RNG inside numba, siftED2D cell 1
    ``retrieve_statistical_image_component``)."""
    if iterations % 2 != 0:
        raise ValueError("iterations must be even")
    half = iterations // 2
    if noise is None:
        v = torch.randn((half,) + tuple(img.shape), generator=generator,
                        device=img.device, dtype=img.dtype) * mad(img)
    else:
        v = as_input(noise, img.dtype, img.device)
        if v.shape != (half,) + tuple(img.shape):
            raise ValueError(f"noise must be {(half,) + tuple(img.shape)}")
    stacked = torch.cat([img[None] + v, img[None] - v], dim=0)
    out = crossways_baseline(stacked)  # batched, not looped (see above)
    paired = 0.5 * (out[:half] + out[half:])
    return paired.mean(0)


def totalextract2d(img, generator: torch.Generator | None = None,
                   iterations: int = 20, *, device="cuda") -> torch.Tensor:
    """[highpass, lowpass] separation (siftED2D `totalextract2d`), in
    float64 (the reference's precision).  A tensor stays on its device;
    anything else goes to ``device``."""
    img = as_input(img, torch.float64, device)
    lowpass = statistical_component(img, generator, iterations)
    return torch.stack([img - lowpass, lowpass])
