"""PyTorch / CUDA port of ``pyitd_tpu``.

The canonical ITD sift and the cubic-spline baseline tier, with their
hand-written Hopper kernels (``csrc/*.cu``).  Module names mirror the JAX
package's, and the public names below are those of
``pyitd_tpu/__init__.py``.  This package imports ``torch`` and never
``jax``.
"""
from .decomp.itd import ITD, STOP_BUDGET, STOP_FLAT, SiftResult, itd_sift
from .ops.cubic_baseline import cubic_baseline_extract
from .ops.extrema import count_extrema, extrema_mask, extrema_masks
from .ops.linear_baseline import linear_baseline_extract
from .utils.summation import neumaier_sum, reconstruction_error

__all__ = [
    "itd_sift",
    "ITD",
    "SiftResult",
    "STOP_FLAT",
    "STOP_BUDGET",
    "linear_baseline_extract",
    "cubic_baseline_extract",
    "extrema_mask",
    "extrema_masks",
    "count_extrema",
    "neumaier_sum",
    "reconstruction_error",
]
