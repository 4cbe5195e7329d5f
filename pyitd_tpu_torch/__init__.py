"""PyTorch / CUDA port of ``pyitd_tpu``.

The canonical ITD sift, the cubic-spline baseline tier with their
hand-written Hopper kernels (``csrc/*.cu``), and the cubic tier's callers:
the MEITD family (host walk, batched walk, noise-assisted ensemble, WPE
and the selection statistics), the 2-D ensemble, the FFT family (EFD,
modified EFD, the sine-template ITD and the ITD-Fourier cascade on the
template cubic tier), the streaming tier (scalar and IQ, the one-hop step
and the batched offline replay), SVMD, FABADA, and the transforms (STIRFT,
the time-causal STFT, the trend filter, the accumulator DFT).  Module
names mirror the JAX package's, and the public names below are those of
``pyitd_tpu/__init__.py``.  This package imports ``torch`` and never
``jax``.
"""
from .decomp.efd import (efd, efd_real, efd_slice_max, iterative_efd,
                         iterative_max)
from .decomp.ensemble import EnsembleResult, meitd_ensemble
from .decomp.fabada import auto_sigma, fabada, pfabada, psnr
from .decomp.itd import ITD, STOP_BUDGET, STOP_FLAT, SiftResult, itd_sift
from .decomp.itd2d import crossways_baseline, mad, totalextract2d
from .decomp.itd_fourier import itd_fourier_decomposition, itd_sine_sift
from .decomp.lindeberg import time_causal_stft
from .decomp.meitd import meitd, xitd
from .decomp.meitd_jit import meitd_jit, meitd_jit_bank
from .decomp.serial2d import sconcatenate, sdeconcatenate
from .decomp.stirft import compute_synthesis_window, istirft, stirft
from .decomp.streaming import (iq_baseline_extract, iq_extrema_mask,
                               streaming_init, streaming_itd,
                               streaming_itd_iq, streaming_step,
                               streaming_step_iq)
from .decomp.svmd import svmd
from .decomp.trend import custom_filter_engine, decompose_signal
from .ops.cubic_baseline import (cubic_baseline_extract,
                                 template_fast_baseline)
from .ops.extrema import count_extrema, extrema_mask, extrema_masks
from .ops.linear_baseline import linear_baseline_extract
from .ops.wpe import weighted_permutation_entropy
from .utils.stats import fingerprint, sorted_median_index
from .utils.summation import neumaier_sum, reconstruction_error

__all__ = [
    "itd_sift",
    "ITD",
    "SiftResult",
    "STOP_FLAT",
    "STOP_BUDGET",
    "meitd",
    "xitd",
    "meitd_jit",
    "meitd_jit_bank",
    "meitd_ensemble",
    "EnsembleResult",
    "totalextract2d",
    "crossways_baseline",
    "mad",
    "sconcatenate",
    "sdeconcatenate",
    "efd",
    "efd_real",
    "iterative_efd",
    "efd_slice_max",
    "iterative_max",
    "itd_sine_sift",
    "itd_fourier_decomposition",
    "svmd",
    "fabada",
    "pfabada",
    "auto_sigma",
    "psnr",
    "stirft",
    "istirft",
    "compute_synthesis_window",
    "time_causal_stft",
    "decompose_signal",
    "custom_filter_engine",
    "streaming_itd",
    "streaming_step",
    "streaming_init",
    "iq_baseline_extract",
    "streaming_itd_iq",
    "streaming_step_iq",
    "iq_extrema_mask",
    "linear_baseline_extract",
    "cubic_baseline_extract",
    "template_fast_baseline",
    "extrema_mask",
    "extrema_masks",
    "count_extrema",
    "weighted_permutation_entropy",
    "neumaier_sum",
    "reconstruction_error",
    "fingerprint",
    "sorted_median_index",
]
