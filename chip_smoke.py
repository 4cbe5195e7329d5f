#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``pyitd_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and nvcc:

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):

1. environment and build: the card's name and power limit, the build of
   ``pyitd_tpu_torch/csrc/*.cu`` with nvcc for sm_90a into one library (one
   ``nvcc -c`` per source, in parallel, then one link), timed;
2. kernel vs plain on the card, at small edge-case shapes: ``itd_sift`` and
   ``linear_baseline_extract`` through the kernels against
   ``backend="torch"`` on the same CUDA tensors, bitwise (NaN equal to NaN),
   both endpoint modes, stop A and stop B; the sift's gradient through the
   kernels against the plain structural route and against plain scans
   (``SCAN_LIMITS``), which must also reject three planted scan faults
   (``FAULTS``); the fills (fill2 in both
   directions and both ``strict`` modes, fillv) bitwise against their plain
   versions, with marks on tile seams and a row with no mark; segsum with 1
   and 2 channels in both directions and both ``strict`` modes, exact on
   integer-valued inputs and within ``segsum_error_bound`` on real ones;
   the same on the shapes that try the one-pass scan's protocol
   (``scan_protocol_cases``: rows and arrays off a 16-byte boundary, 1
   tile, 1 tile + 1, 245 tiles with a row that has no mark, 256 x 16,384,
   and 8 x 1M, more blocks than the card holds at once), and the same
   segsum call 20 times bitwise the same; the level adjoint's own kernels
   (``bwd_knots``, ``bwd_pre``, ``bwd_post``) against their plain versions
   to rtol = atol = 0 on ``level_bwd_cases`` (edge shapes, rows of 3 to 5
   samples, plateaus, rows and arrays off a 16-byte boundary, 256 x 16,384
   and 8 x 1M), ``bwd_pre`` also as the reverse trip loop calls it (the
   sift's cotangents, per-row flags, the carry, level 0's zero path, absent
   cotangents, infinite ones); the sift's gradient bitwise the autograd
   replay's (``replay_grad``); the level adjoint on the
   kernels against the plain route (rtol = atol = 2e-4, and no more than
   1.5x the plain route's error against an f64 truth, plus 1e-6); the
   ``ITD`` class on a numpy float64 signal through the sift kernels; the
   cubic tier (``cubic_baseline_extract``, ``eval_backend="fills"``) on
   the same edge cases and its own (a row across tiles and SPIKE blocks,
   knots and NaN on K7's run and block edges, a block without a knot,
   short rows, the degenerate rows, the pass-through guard in f32 and in
   f64, f64 in and out): each kernel (K5-K8) bitwise against its plain version on the
   route's own inputs, and the route against the plain route (every
   wrapper swapped for its plain version) bitwise; K7 alone bitwise on
   ``tools/cubic_bench.py::spike_cases``; the sequence-parallel
   tier on ``sharded_cases`` at 2, 4 and 8 time shards, both endpoint modes,
   stop A and stop B: ``sharded_itd_sift`` on the shard-aware kernels,
   without ``fold_emit`` and with it (``PYITD_FOLD_EMIT=1``: each level
   emits the next trip's tile summaries), launches and collectives
   counted, against each other, against the same call with every wrapper
   swapped for its plain version and against the unsharded kernel sift of
   the whole signal, all bitwise, the same on ``fold_emit_layouts`` (the
   shard's last sample mid-tile, on a tile's first or last sample, in one
   partial tile), and ``sharded_cubic_baseline`` (both methods, f64)
   against the gather route of the whole signal to 1e-10;
3. the main path at full size: the bench signal, 8 x 1,000,000 f32,
   ``itd_sift(x, 8, store_baselines=False)`` (10 levels), with every kernel
   launch counted (one ``level_summaries``, of the input; one ``tile_scan``
   and one ``sift_level`` per extraction, each trip's scan completing the
   interior summaries the level before it emitted), and the compensated
   reconstruction
   ``max|sum(rotations) + correction - x|`` in f64 held to 1e-10;
4. timing of the kernel path and the plain path at 8 x 1M and at the
   256 x 16k EEG shape (CUDA events after warm-up, median of 10, and the
   device busy time from a ``torch.profiler`` trace), the main-path output
   of both held bitwise equal;
5. the main path's gradient at full size: the same signal with
   ``requires_grad``, loss ``sum(rotations^2) + 0.7 * sum(correction)``,
   ``.backward()``; launches counted (per level adjoint two fill2, two
   segsum and one of each adjoint kernel), the gradient finite and held against
   the plain structural route (``backend="torch",
   linear_backend="structural"``) and both against an f64 truth, and
   against plain scans with the planted faults rejected; forward +
   backward and forward alone timed (median of 10), device busy time by
   group (sift, scan and adjoint kernels, PyTorch ops), idle share, top
   device kernels and peak memory;
6. the trainer of ``examples/train_through_itd.py`` at 8 x 1,000,000 with
   ``max_iteration=6``: 5 Adam steps (lr 3e-2) through the kernel sift, each
   loss finite, the step-0 taps gradient held against the plain structural
   route and against plain scans, the planted faults rejected;
7. each kernel against its plain version at the main path's shapes, with
   its device time, the plain version's, and its bound (bytes over the
   card's 3.35 TB/s, or f32 operations over its 67 TFLOP/s): ``sift_level``
   with the bookkeeping, the same emitting interior summaries, ``tile_scan``
   completing them with the tiles' edge samples (bitwise the scan of
   ``level_summaries`` of the same baseline), ``sift_level`` without the
   bookkeeping (K2); the scans and the level adjoint's own kernels, these
   also at 256 x 16,384 with the launches of one counted gradient there;
   the scans and the level kernels also on the input of
   the sift's last level, where knots are sparse and the scans' look-back
   is longest; the cubic kernels K5-K8 and the interface solve likewise
   after phase 8, on the inputs the cubic level gave them;
8. the cubic level at full size: ``cubic_baseline_extract`` of the bench
   signal, 8 x 1,000,000 f32, ``capacity=n+2``, ``min_extrema=0``, with
   every kernel launch counted; each kernel bitwise against its plain
   version and the route against the plain route; the f32 baseline
   against the f64 gather route within ``CUBIC_F64_REL`` of its largest
   magnitude; the kernel and plain routes timed (median of 10), device
   busy time, idle share and top device kernels, the interface solve
   and end moments alone (one launch, bitwise its plain version; beside
   the plain version's time and ATen calls) there, at 32 x 32,768 and at
   8 x 2^20; the gradient of ``sum(rotation^2)`` (autograd of the gather
   route), finite, timed forward + backward, and its peak memory;
9. the sequence-parallel tier at full width: the bench signal at
   8 x 4,194,304 f32, ``max_iteration=8``, over 4 time shards of 1,048,576
   resident on the one card (``LocalGroup(4)``), the main path on the
   ``fold_emit`` route (one ``level_summaries``, 11 scans completing the
   emitted summaries, 11 levels): launches, their modes and collectives
   counted on both routes, every launch of the shard-aware kernels bitwise
   its plain version on each route's own inputs, the two routes bitwise
   each other and the unsharded ``itd_sift`` of the same signal, the
   compensated reconstruction held to 1e-10; both routes timed in turns
   (without, with, with, without; CUDA events, median of 10, device busy,
   idle share, top device kernels) and the unsharded sift, the emitting
   and the plain ``sift_level<SHARD>`` per launch, a trip's summaries on
   each route, the cross-shard fold alone (host ms, ATen calls); the same
   signal as one shard of a one-rank NCCL
   ``DistGroup`` bitwise ``LocalGroup(1)``; the gradient of the sharded
   kernel route at 8 x 262,144 (the plain sharded route's autograd holds
   every intermediate: the full width does not fit) against the unsharded
   plain sift's; one sharded cubic level (``method="spike"``) at 8 x 4M
   against ``cubic_baseline_extract`` of the whole signal; then phase 7's
   rows for the shard-aware kernels at these shapes, the emitting level
   and the scan completing its summaries among them;
10. the cubic tier's callers at full width, every cubic level counted
   (launches of K5-K8 and of the pre-pass, one each per level), every
   launch bitwise its plain version and each whole route bitwise its plain
   route: the ensemble MEITD of the ensemble bench's signal (``ENS_SHAPE``,
   32 realizations of 32,768 f64, ``noise_scale=0.1``, a seeded generator
   on the card) with trips, levels, rows per level and host reads, the
   reconstruction of the input and of every realization to 1e-10, its time
   and ATen calls, ``meitd_jit`` alone and the one-at-a-time speedup;
   ``meitd`` and ``xitd`` of the same signal, ``meitd`` against
   ``meitd_jit`` to 1e-9; ``statistical_component`` of the 2-D profile's
   256 x 256 tile with 20 iterations in f64 (4 levels of 5,120 rows), each
   level within ``CUBIC_F64_REL`` of the f64 gather route on its recorded
   input, ``totalextract2d`` reconstructing the tile to 1e-12 max|tile|,
   each kernel's device time per useful sample beside phase 8's; one cubic
   level at 32 x 32,768 and 1 x 32,768 on both routes;
11. the FFT family at full width, with no kernel of the repo launched
   (cuFFT, cuBLAS, eager PyTorch): ``efd`` of the EFD bench's signal
   (``EFD_SHAPE``, 8 x 2^20, 12 bands) in f32 and f64, timed (median of
   10, device busy, idle share, top device ops, peak memory, Msamp/s), f64
   row 0 against ``tests/reference/efd_ref.py`` (counts exact, cerf to
   1e-10, bands to 1e-8: the comparison JAX's int32 bounds fail), f32
   against f64 row by row (bounds, then bands within ``EFD_F32_REL``);
   ``iterative_max`` of row 0's spectrum (524,289 bins, f64), timed, its
   components summing to the row; one ITD-Fourier cascade iteration of
   the 5b signal (n = 2^20, sr = 2048, f32): the first call apart, the
   knots per comb frequency, ``FOURIER_CHAIN`` iterations chained and
   timed with ATen calls and the moment solves by method (all
   ``"banded"``), the sine sift's reconstruction, the densest entry's
   static path timed, in f32 against f64 (2e-6 of max|x|) and bitwise
   under ``"high"`` matmul precision; the f64 cascade at ``CASCADE_N`` on the card
   against the CPU (keep masks per iteration equal, components to 1e-10),
   and at 2^20 driven by hand for ``CASCADE_MAX_OUTER`` iterations,
   reconstructing x to 1e-8 whether it stops or not;
12. the rest of ``decomp/`` at full size, with no kernel of the repo
   launched: ``streaming_itd`` of a 64 x 2^20 f64 audio bank at hop 256
   (timed, Msamp/s, device busy, idle share, peak memory; the first two
   hops not ready, every ready hop rebuilt to 1e-10; 4 channels against
   the CPU), ``STEP_HOPS`` consecutive ``streaming_step`` calls on the
   64-channel state (per-hop p50 and p99 beside the HOP/SR callback budget,
   ATen calls per hop, every hop bitwise the replay's),
   ``sharded_streaming_itd`` on the card bitwise the replay,
   ``streaming_itd_iq`` of 8 x 2^20 complex128 at hop 1024; ``decompose_
   signal`` and ``time_causal_stft`` of 64 x 48,000 f64 (the rebuild, the
   CPU row by row); ``stirft`` of 64 x 2^20 f32 and ``istirft`` of one
   channel in chained blocks against one call (f32 and f64); ``fabada`` of
   a 1,024² image against JAX's iteration count and PSNR
   (``FABADA_JAX``), its CUDA graph bitwise the per-iteration eager loop,
   and ``pfabada`` of a 2^16 spectrum against the CPU; ``svmd`` of 8,192
   samples against the CPU (mode count exactly, omega to 1e-10, modes to
   1e-9), its graph bitwise the per-iteration eager loop on the first two
   modes; ``accumulator_dft`` and ``hierarchical_dft`` of 4,096 x 512 f32
   frames against ``torch.fft.fft`` (``AFT_REL``), the
   hierarchical one bitwise under ``"high"`` matmul precision;
13. the ML trainers of ``pyitd_tpu_torch/ml/`` at full width, with no
   kernel of the repo launched: ``ParsevalGPT`` at ``GPTConfig()`` (T.py's
   width: block 256, vocab 256, 2 layers, 64 features, f32) on batches of
   32 x 256 tokens that ``BatchSampler`` draws from the motif stream of
   ``examples/train_parallel.py`` (``ML_BATCH``), ``ML_STEPS`` steps of
   ``torch.optim.Adam(3e-3)`` under ``torch.use_deterministic_algorithms``:
   every loss finite and the mean of the last 10 below the first; ms per
   step (CUDA events, after ``ML_WARMUP`` steps), tokens per second,
   device busy, idle share, ATen calls per step and peak memory; step 0's
   loss and gradient on the card against the CPU from the same initial
   weights and batch (``ML_CARD_REL``: f64 and f32); a checkpoint at step
   ``ML_CKPT_STEP`` with ``save_state``, restored into a fresh model and
   optimizer, run to the end: parameters and optimizer state bitwise those
   of the run without the restore.  Then ``examples/train_tiny.py``: the
   tiny LM, ``TINY_STEPS`` Wolf steps with a seeded card generator beside
   the unigram, its last loss below the unigram's;
14. the last of ``ml/`` and the training parallelism, with no kernel of
   the repo launched: ``BlockFastLM`` at its full width (``BF_CONFIG``,
   vocabulary 256) trained ``BF_STEPS`` Adam steps on phase 13's batches,
   then serving ``SERVE_BATCH`` requests of ``SERVE_PROMPT`` prompt and
   ``SERVE_NEW`` greedy tokens through ``blockfast_step``: per-token step
   latency (CUDA events: p50, p99, min, max), tokens per second, ATen calls
   per step, device busy, idle share, peak memory; the step path's hidden
   states and logits against the full forward on the same tokens from
   ``3 * (n_head + 1)`` tokens per layer on (``SERVE_ATOL``), and the first
   ``SERVE_CPU_TOKENS`` tokens of each request against the CPU.  Then, on a
   one-rank NCCL ``DeviceMesh`` (data 1, model 1): ParsevalGPT at
   ``GPTConfig()`` through ``make_train_step`` with ``PARSEVAL_TP_RULES``,
   in f32 against phase 13's plain loop (bitwise, or ``LOOSE_REL`` of
   max|p| where an op has no deterministic CUDA version) and with bf16
   compute (master weights and Adam state f32, the loss falling), ms per
   step and tokens per second; ``ModCRTMoE`` (``MOE_EXPERTS`` experts,
   width ``MOE_WIDTH``, capacity dispatch) on ``MOE_TOKENS`` tokens with
   ``MOE_EP_RULES``: capacity against gather where no expert overflows,
   step 0's gradient against the CPU's (on the card's routes),
   ``MOE_STEPS`` Adam steps with a checkpoint at ``MOE_CKPT_STEP`` resumed
   bitwise; ``gpipe_apply`` at pp = 1 against the sequential fold, output
   and gradients; and ``BlockFastGPT`` at its defaults on 32 x 256
   batches: step 0's gradient against the CPU's in f64 (``ML_CARD_REL``;
   in f32 printed beside the f64 gradient, not held: ill-conditioned),
   ``VTE_STEPS`` Adam steps, finite and falling;
15. K2a, the ``DistGroup`` gradient and the native real-time tier:
   ``linear_fill2_cuda`` (K2a alone) bitwise its plain version at 8 x 1M
   in both directions, and its row of the kernels line (no route launches
   it).  Over a one-rank NCCL ``DistGroup`` at
   ``SHARD_GRAD_SHAPE``: the gradient of ``sharded_itd_sift`` (kernel
   route) and of ``sharded_cubic_baseline``, each bitwise
   ``LocalGroup(1)``'s under ``torch.use_deterministic_algorithms`` (the
   backward's ``gather`` adds by atomics otherwise), the first with its
   peak memory, its time and its gap to the unsharded sift's structural
   gradient.  ``runtime.native_available()``
   asserted (the build is part of the phase); ``NATIVE_CHANNELS``
   ``StreamingITD`` streams at hop 256 for ``STEP_HOPS`` hops of phase 12's
   bank (per-hop p50, p99 beside phase 12's card step; every hop rebuilt to
   1e-10 and within 1e-12 of max|x| of the card's f64 replay), and one
   ``NativePool`` batch of the 64 x 2^20 bank, every row bitwise
   ``baseline_extract``, ms and rows per second.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# cuBLAS is deterministic only with a fixed workspace, set before the first
# CUDA call (phase 13 runs its trainer under use_deterministic_algorithms)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

SRC = {k: "pyitd_tpu_torch/csrc/sift_level.cu"
       for k in ("level_summaries", "tile_scan", "tile_scan_edges",
                 "sift_level", "sift_level_emit", "sift_level_k2")}
SRC.update({k: "pyitd_tpu_torch/csrc/fill_segsum.cu"
            for k in ("fill2", "fillv", "segsum", "linear_fill2")})
SRC.update({k: "pyitd_tpu_torch/csrc/cubic.cu"
            for k in ("cubic_ksite", "cubic_neighbors", "spike_backsub_eval")})
SRC["spike_factors"] = "pyitd_tpu_torch/csrc/spike.cu"
SRC["spike_interface"] = "pyitd_tpu_torch/csrc/spike.cu"
SRC["walk_stats"] = "pyitd_tpu_torch/csrc/walk_stats.cu"
# the level adjoint's own kernels: they replace no TPU kernel, but fuse the
# XLA glue of JAX's structural adjoint
ADJOINT_KERNELS = ("bwd_knots", "bwd_pre", "bwd_post")
SRC.update({k: "pyitd_tpu_torch/csrc/level_bwd.cu"
            for k in ADJOINT_KERNELS + ("bwd_pre_level",)})
SIFT_KERNELS = ("level_summaries", "tile_scan", "sift_level")
SRC.update({"sharded_" + k: SRC[k] for k in SIFT_KERNELS
             + ("sift_level_emit", "tile_scan_edges")})
REPLACES = {
    "level_summaries": "pyitd_tpu/ops/pallas_fill.py:1398",
    "tile_scan": "pyitd_tpu/ops/pallas_fill.py:1398",
    "tile_scan_edges": "pyitd_tpu/ops/pallas_fill.py:1398",
    "sift_level": "pyitd_tpu/ops/pallas_fill.py:1717",
    "sift_level_emit": "pyitd_tpu/ops/pallas_fill.py:1821",
    "sift_level_k2": "pyitd_tpu/ops/pallas_fill.py:738",
    "fill2": "pyitd_tpu/ops/pallas_fill.py:590",
    "linear_fill2": "pyitd_tpu/ops/pallas_fill.py:738",
    "fillv": "pyitd_tpu/ops/pallas_fill.py:363",
    "segsum": "pyitd_tpu/ops/pallas_fill.py:503",
    "cubic_ksite": "pyitd_tpu/ops/pallas_fill.py:1590",
    "cubic_neighbors": "pyitd_tpu/ops/pallas_fill.py:1691",
    "spike_factors": "pyitd_tpu/ops/pallas_spike.py:176",
    "spike_backsub_eval": "pyitd_tpu/ops/pallas_spike.py:262",
    "spike_interface": "none: the XLA glue of pyitd_tpu/ops/cubic_baseline."
                       "py:530-567 (reduced_interface_solve and the end "
                       "moments)",
    "walk_stats": "none: the eager glue of pyitd_tpu_torch/ops/wpe.py and "
                  "ops/extrema.py (JAX's WPE and extrema count are plain "
                  "jnp)",
}
REPLACES.update({k: "none: the XLA glue of pyitd_tpu/ops/linear_baseline.py:"
                    "315 (_structural_level_bwd)"
                 for k in ADJOINT_KERNELS + ("bwd_pre_level",)})
# K9: the three sift kernels with the shard arguments compiled in; with
# fold_emit the level emits (the kernel's fold_emit=True) and the scan
# completes its summaries (states_from_folds, XLA in JAX)
REPLACES.update({"sharded_" + k: "pyitd_tpu/ops/pallas_fill_sharded.py:199"
                 for k in SIFT_KERNELS + ("sift_level_emit",)})
REPLACES["sharded_tile_scan_edges"] = "pyitd_tpu/parallel/sharded.py:489"
# The cubic level's f32 baseline against the f64 gather route, as a
# fraction of max|baseline|: the bar of the JAX tests
# (tests/test_cubic.py:195, 248-253).
CUBIC_F64_REL = 2e-6
MAIN_SHAPE, MAIN_MAX_IT = (8, 1_000_000), 8
EEG_SHAPE, EEG_MAX_IT = (256, 16384), 8
TRAIN_MAX_IT, TRAIN_STEPS = 6, 5
# the MEITD ensemble (realizations, n) of bench.py:166, and the 2-D
# ensemble's tile side and iterations (bench_profile.py:134-138)
ENS_SHAPE = (32, 32768)
TILE_2D, ITER_2D = 256, 20
# the FFT family's cells (bench.py:207-275): EFD of 8 x 2^20 with 12
# bands; one ITD-Fourier cascade iteration at n = 2^20, sr = 2048, chained
# FOURIER_CHAIN times; the f64 cascade against the CPU at CASCADE_N
EFD_SHAPE, EFD_BANDS = (8, 1 << 20), 12
FOURIER_N, FOURIER_SR, FOURIER_CHAIN = 1 << 20, 2048, 10
CASCADE_N, CASCADE_MAX_OUTER = 1 << 16, 50
# the densest comb entry's knots, where JAX's slow test pins them
# (tests/test_itd_fourier.py:279-312)
DENSEST_KNOTS = {(1 << 20, 2048): 886785}
# the densest entry's f32 static path against its f64 one, as a fraction of
# max|x|: 1.1e-7 on the CPU at FOURIER_N; the bar is the one JAX's tests
# hold the template tier's f32 routes to
TEMPLATE_F32_REL = 2e-6
# f32 EFD bands against the f64 bands on rows whose integer bounds agree,
# as a fraction of max|x|: the H100 read 2.9e-7 to 3.4e-7 on the 8 rows
# (PERF.md, Findings); the bar is about 3x that, near f32 FFT
# roundoff at this length (2^-24 * log2(2^21) = 1.3e-6), far below what a
# bound moved by one bin changes in a band
EFD_F32_REL = 1e-6
# sum(rotations) + residual of the f32 sine sift against x, as a fraction
# of max|x|: 10 f32 subtractions, each rounding by at most half an ulp of
# a rotation of up to about twice max|x| (about 1.2e-6 at worst)
SIFT_F32_REL = 1e-5
# phase 13: ParsevalGPT at GPTConfig() (T.py:439-447) on batches of
# ML_BATCH x block_size tokens, Adam steps, the checkpoint's step, the
# steps before timing; the tiny LM's Wolf steps (examples/train_tiny.py)
ML_BATCH, ML_STEPS, ML_CKPT_STEP, ML_WARMUP = 32, 60, 30, 3
TINY_STEPS = 500
ML_SEED = 0
ML_CONFIG: dict = {}  # GPTConfig overrides (none: T.py's width)
# step 0's gradient on the card against the CPU, as a fraction of max|g|
ML_CARD_REL = {"float64": 1e-9, "float32": 1e-4}


def sift_launches(levels: int) -> dict:
    """The sift kernels' launches in one kernel sift of ``levels`` levels:
    one summary pass (of the input), and one tile scan and one level per
    extraction; every level but the last trip's emits the interior
    summaries that the next trip's scan completes."""
    return {"level_summaries": 1, "tile_scan": levels + 1,
            "sift_level": levels + 1}
# the sequence-parallel tier: 4 time shards of the main path's row length;
# its gradient at the largest size whose plain-route autograd fits the card
SHARD_SHAPE, SHARD_SEQ, SHARD_GRAD_SHAPE = (8, 4_194_304), 4, (8, 262_144)
# the card's data-sheet peaks (H100 SXM): HBM bytes/s, f32 FLOP/s outside
# the tensor cores
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
# Limits on the sift gradient through the kernels, as fractions of max|g|:
# (max |diff|, rms(diff)); for the trainer's 9 taps, max |diff| alone.  The
# forwards are bit for bit the same, so only the adjoint's sums differ, and
# the backward's knot quotients amplify them where two knots nearly meet.
# GRAD_LIMITS / TAPS_REL: against the plain structural route, whose
# differences of row-long running sums round far more than a segment sum.
# At 8x1M its rounding hides a scan fault, so the sharp test is SCAN_LIMITS
# / TAPS_SCAN_REL: against the same adjoint with each scan wrapper swapped
# for its plain version (fill2 is bitwise; segsum sums in f64).  Each limit
# sits above the largest reading of the sound kernels on the H100 (PERF.md,
# Findings); the sharp ones must also reject every planted fault below.
GRAD_LIMITS = {"phase 2": (4e-3, 1e-4), "8x1M": (0.1, 1e-3)}
TAPS_REL = 2e-5
SCAN_LIMITS = {"phase 2": (5e-5, 1e-6), "8x1M": (1e-3, 1e-6)}
TAPS_SCAN_REL = 3e-7


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bitwise_equal(a, b) -> bool:
    """Same shape, dtype and bits; NaN equals NaN."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}
    if a.dtype in bits:
        same = a.view(bits[a.dtype]) == b.view(bits[a.dtype])
        return bool((same | (torch.isnan(a) & torch.isnan(b))).all())
    return bool((a == b).all())


def max_abs_err(a, b) -> float:
    """Largest |a - b| over entries where not both are NaN; inf where only
    one is NaN."""
    import torch

    a, b = a.double(), b.double()
    both = torch.isnan(a) & torch.isnan(b)
    d = (a - b).abs()
    d = torch.where(both, torch.zeros_like(d), d)
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    return float(d.max()) if d.numel() else 0.0


def cuda_times(fn, reps: int = 10, warmup: int = 2) -> list[float]:
    """Sorted times of ``reps`` calls of ``fn`` in ms (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)


# of device_ms's last window: kernel records missing and expected, and the
# device time as a plain sum of the recorded launches over the calls
TRACE_GAPS = {"missing": 0, "expected": 0, "summed_ms": 0.0}


def device_ms(fn, reps: int = 5) -> tuple[float, dict]:
    """Device time per call of ``fn`` in ms: the kernels it launches, summed
    from a ``torch.profiler`` trace over ``reps`` calls after one warm-up;
    also the time per call by kernel name.  Returns ``(nan, {})`` where the
    trace holds no device time.

    The trace can miss the first launches of its window (the records of
    kernels launched while the tracer is still starting), so a kernel's
    time per call is its mean recorded duration times its launches per
    call, the recorded count over ``reps`` rounded up: right as long as
    fewer than ``reps`` records of a kernel are missing.  Records without a
    duration count as launches and not towards the mean.  A plain sum over
    ``reps`` reads low by the missing share; ``TRACE_GAPS`` holds the last
    window's missing and expected records and that plain sum."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # per kernel name: every record, and the durations of those that have one
    # (a record cut off by the tracer counts as a launch and carries no time)
    seen, timed = {}, {}
    for e in prof.events():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        seen[e.name] = seen.get(e.name, 0) + 1
        if us:
            timed.setdefault(e.name, []).append(us)
    by_name, missing, expected = {}, 0, 0
    for name, durations in timed.items():
        per_call = -(-seen[name] // reps)
        by_name[name] = statistics.fmean(durations) * per_call / 1e3
        missing += per_call * reps - len(durations)
        expected += per_call * reps
    TRACE_GAPS.update(missing=missing, expected=expected, summed_ms=sum(
        sum(d) for d in timed.values()) / 1e3 / reps)
    total = sum(by_name.values())
    return (total if total > 0 else float("nan")), by_name


def device_launches(fn, name: str) -> int:
    """How many kernels whose name contains ``name`` one call of ``fn``
    launches, from a ``torch.profiler`` trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if name in e.key)


def kernel_label(name: str) -> str:
    """A profiler kernel name cut to what tells kernels apart: PyTorch's
    elementwise kernels differ only in their functor, deep in the
    template arguments."""
    for s in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(s, "")
    return name[:110]


def bench_signal(rows: int, n: int):
    """The headline bench signal (bench.py:349-358)."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, n, dtype=np.float64)
    return (np.sin(20 * t[None, :] * (1 + 0.2 * t[None, :]))
            + np.sin(13 * t[None, :])
            + 0.3 * rng.normal(size=(rows, n))
            + t[None, :] ** 2 * 0.1).astype(np.float32)


def eeg_signal(rows: int, n: int):
    """The EEG-like bank of bench.py:129-137."""
    rng = np.random.default_rng(1)
    t = np.linspace(0, 8 * np.pi, n)
    return (np.sin(55 * t[None] + rng.uniform(0, 6, (rows, 1)))
            + 0.6 * np.sin(130 * t[None] + rng.uniform(0, 6, (rows, 1)))
            + 0.8 * rng.normal(size=(rows, n))
            + 0.3 * np.cumsum(rng.normal(size=(rows, n)), axis=1) / n**0.5
            ).astype(np.float32)


def phase2_cases():
    rng = np.random.default_rng(2)
    t = np.linspace(0, 2 * np.pi, 9000)
    x = np.stack([
        np.sin(20 * t) + 0.1 * rng.normal(size=t.size),
        np.sin(7 * t) * (1 + 0.1 * t) + 0.05 * rng.normal(size=t.size),
    ]).astype(np.float32)
    x[1, 4000:4002] = np.nan
    yield "nan-pair (2, 9000)", x
    for rows, n in [(3, 8192), (2, 8192 + 128), (2, 130), (2, 2)]:
        tt = np.linspace(0, 2 * np.pi, n)
        yield f"({rows}, {n})", (np.sin(7 * tt)[None] + 0.4 * rng.normal(
            size=(rows, n))).astype(np.float32)
    yield "constant (2, 8192)", np.ones((2, 8192), np.float32)
    yield "monotone (2, 9000)", np.stack([t, t ** 2]).astype(np.float32)


def sharded_cases():
    """The shapes that break a time-sharded sift first, each (name, f32
    array): shard lengths around the kernels' tile of 4096, shards shorter
    than a tile, shards that hold no knot, knots / plateaus / NaNs on the
    edges of 2, 4 and 8 shards, a row that stops while its neighbour runs
    on, lengths that no shard count divides."""
    rng = np.random.default_rng(7)

    def noisy(rows, n, f=9):
        t = np.linspace(0, 2 * np.pi, n)
        return (np.sin(f * t)[None] + 0.3 * rng.normal(size=(rows, n))
                ).astype(np.float32)

    yield "n_loc 4097 at 2 shards (2, 8194)", noisy(2, 8194)
    yield "n_loc 8193 at 2 shards (2, 16386)", noisy(2, 16386)
    yield "shards shorter than a tile (3, 1024)", noisy(3, 1024)
    x = noisy(2, 4096)
    x[:, 512:3584] = np.linspace(-3, 3, 3072, dtype=np.float32)
    yield "shards without a knot (2, 4096)", x
    x = noisy(2, 2048)
    for b in (256, 512, 1024, 1536):
        x[0, b], x[1, b - 1] = 5.0, -5.0
    yield "knots on shard edges (2, 2048)", x
    x = noisy(2, 2048)
    x[0, 1022:1026], x[0, 255:257], x[1, 510:514] = 4.0, 4.0, -4.0
    yield "plateaus across shard edges (2, 2048)", x
    x = noisy(2, 2048)
    x[0, 1023:1025], x[1, 512], x[1, 255] = np.nan, np.nan, np.nan
    yield "NaN at shard edges (2, 2048)", x
    t = np.linspace(0, 2 * np.pi, 2048)
    yield "stop A beside a running row (2, 2048)", np.stack(
        [np.sin(1.5 * t).astype(np.float32), noisy(1, 2048)[0]])
    yield "length no shard count divides (2, 1003)", noisy(2, 1003)
    yield "length no shard count divides (2, 9001)", noisy(2, 9001)


def fold_emit_layouts() -> dict:
    """Shard lengths that put the sample an emitting level leaves out, the
    shard's last (its right neighbour is the next shard's first), mid-tile,
    on a tile's first sample, on a tile's last sample, and in a single
    partial tile."""
    from pyitd_tpu_torch.ops.cuda_fill import TILE

    return {"mid-tile": 2 * TILE + 700, "tile-first": 2 * TILE + 1,
            "tile-last": 2 * TILE, "one partial tile": 512}


def fold_emit_signal(n_loc: int, seq: int):
    """Three rows of ``seq * n_loc`` f32 for the ``fold_emit`` route: a
    spike on a tile's first sample inside shard 0 (shard 1's first sample
    where a shard has one tile) and one on the last shard's first sample;
    NaN across the boundary of shards 0 and 1; a triangle wave on a ramp,
    which stops flat after two components beside rows that run on."""
    from pyitd_tpu_torch.ops.cuda_fill import TILE

    n = seq * n_loc
    rng = np.random.default_rng(n_loc + seq)
    t = np.linspace(0, 2 * np.pi, n)
    x = np.stack([np.sin(15 * t) + 0.1 * rng.normal(size=n),
                  np.sin(5 * t * (1 + 0.2 * t)) + 0.05 * rng.normal(size=n),
                  np.abs(t * 1.5 / np.pi % 2 - 1) + 0.1 * t]
                 ).astype(np.float32)
    x[0, TILE if n_loc > TILE else n_loc] = 8.0
    x[0, (seq - 1) * n_loc] = -8.0
    x[1, n_loc - 1:n_loc + 2] = np.nan
    return x


def sift_loss(r):
    """The gradient phases' loss."""
    return (r.rotations ** 2).sum() + 0.7 * r.correction.sum()


def scan_masks(x):
    """Masks for the scans on ``x``: its knot mask, and random marks with
    marks on tile seams, a row with no mark and, with three rows or more, a
    row marked everywhere."""
    import torch
    from pyitd_tpu_torch.ops.linear_baseline import knot_mask

    rows, n = x.shape
    m = np.random.default_rng(n).random((rows, n)) < 0.01
    m[0, [i for i in (0, 4095, 4096, 4097, 8191, 8192, n - 1) if i < n]] = True
    m[-1] = False
    if rows > 2:
        m[1] = True
    return knot_mask(x), torch.from_numpy(m).to(x.device)


def segsum_within_bound(vals, flags, reverse, what,
                        strict=False) -> tuple[float, float]:
    """segsum on real-valued channels, kernel against plain: the same
    non-finite results, the finite ones within ``segsum_error_bound``.
    Returns (max abs err, max err / bound)."""
    import torch
    from pyitd_tpu_torch.ops import cuda_fill as cf

    chans = (vals,) if isinstance(vals, torch.Tensor) else tuple(vals)
    got = cf.segsum_cuda(chans, flags, reverse, strict)
    want = cf.segsum(chans, flags, reverse, strict)
    err_max, ratio = 0.0, 0.0
    for v, a, b in zip(chans, got, want):
        fin = torch.isfinite(b)
        if not bitwise_equal(a[~fin], b[~fin]):
            raise AssertionError(f"segsum {what}: non-finite sums differ")
        err = (a.double() - b.double()).abs()[fin]
        bound = cf.segsum_error_bound(v, flags, reverse, strict)[fin]
        if not bool((err <= bound).all()):
            raise AssertionError(f"segsum {what}: beyond segsum_error_bound")
        if err.numel():
            err_max = max(err_max, float(err.max()))
            ratio = max(ratio, float((err / bound.clamp(min=1e-300)).max()))
    return err_max, ratio


def equal_values(a, b) -> bool:
    """Whether two f32 tensors are NaN at the same samples and bit for bit
    equal everywhere else (so -0 is not +0)."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb) and torch.equal(
        a[~na].view(torch.int32), b[~nb].view(torch.int32)))


def off_boundary(t, off: int):
    """A contiguous copy of ``t`` whose data starts ``off`` elements past
    an allocation's (16-byte aligned) start."""
    import torch

    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    out = buf[off:].view(t.shape)
    out.copy_(t)
    return out


def scan_protocol_cases():
    """The shapes that try the one-pass scan's protocol, each (name, rows,
    n, element offsets of (values, flags) from an aligned address): rows
    that start off a 16-byte boundary (``n % 4 != 0``), arrays that do
    (values off by one float while the outputs are aligned: the stores
    turn scalar; flags off by 3 bytes), 1 tile, 1 tile + 1, 245 tiles in
    rows of which one has no mark (its look-back walks to the row's
    start), 256 x 16,384, and a grid of more blocks than the card holds
    at once."""
    yield "rows off a 16-byte boundary (3, 4097)", 3, 4097, (0, 0)
    yield "rows off a 16-byte boundary (4, 9001)", 4, 9001, (0, 0)
    yield "arrays off a 16-byte boundary (3, 8200)", 3, 8200, (1, 3)
    yield "arrays and rows off a boundary (3, 12291)", 3, 12291, (2, 5)
    yield "1 tile (3, 4096)", 3, 4096, (0, 0)
    yield "1 tile + 1 (3, 4097) flags off by 1", 3, 4097, (0, 1)
    yield "245 tiles (3, 1000000)", 3, 1_000_000, (0, 0)
    yield "(256, 16384)", 256, 16384, (0, 0)
    yield "1960 blocks (8, 1000000)", 8, 1_000_000, (0, 0)


def check_scans(name, x, offsets=(0, 0)) -> tuple[float, float]:
    """fill2 and fillv bitwise against their plain versions; segsum exact
    on integer-valued channels and within its bound on real ones.
    ``offsets``: the inputs' (values, flags) starts in elements past an
    aligned address."""
    import torch
    from pyitd_tpu_torch.ops import cuda_fill as cf

    rng = np.random.default_rng(x.shape[1] + 1)
    ints = torch.from_numpy(rng.integers(
        -8, 9, size=(2,) + tuple(x.shape)).astype(np.float32)).to(x.device)
    masks, y = scan_masks(x), 0.5 * x + 1.0
    if offsets != (0, 0):
        x, y, *ints = (off_boundary(t, offsets[0]) for t in (x, y, *ints))
        masks = [off_boundary(m, offsets[1]) for m in masks]
    worst = (0.0, 0.0)
    for mask in masks:
        for rev in (False, True):
            for strict in (False, True):
                for a, b in zip(cf.fill2_cuda(x, mask, rev, strict),
                                cf.fill2(x, mask, rev, strict)):
                    if not bitwise_equal(a, b):
                        raise AssertionError(f"fill2 {name} reverse={rev} "
                                             f"strict={strict} differs")
            if not bitwise_equal(cf.fillv_cuda(x, mask, rev),
                                 cf.fillv(x, mask, rev)):
                raise AssertionError(f"fillv {name} reverse={rev} differs")
            for strict in (False, True):
                for nch in (1, 2):
                    got = cf.segsum_cuda(tuple(ints[:nch]), mask, rev, strict)
                    want = cf.segsum(tuple(ints[:nch]), mask, rev, strict)
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        raise AssertionError(
                            f"segsum {name} {nch} channels reverse={rev} "
                            f"strict={strict}: integer sums differ")
                e = segsum_within_bound((x, y), mask, rev, name, strict)
                worst = (max(worst[0], e[0]), max(worst[1], e[1]))
    return worst


def check_scan_protocol(dev) -> None:
    """``check_scans`` on ``scan_protocol_cases``; then one segsum call (2
    channels, reverse, real values) 20 times at 256 x 16,384 and at 8 x 1M:
    every output bitwise the first's."""
    import torch
    from pyitd_tpu_torch.ops import cuda_fill as cf

    for name, rows, n, offsets in scan_protocol_cases():
        rng = np.random.default_rng(rows * n)
        t = np.linspace(0, 2 * np.pi, n)
        x = torch.from_numpy((np.sin(7 * t)[None] + 0.4 * rng.normal(
            size=(rows, n))).astype(np.float32)).to(dev)
        err = check_scans(name, x, offsets)
        torch.cuda.synchronize()
        print(f"[2] scans, {name}, inputs {offsets[0]} floats and "
              f"{offsets[1]} flag bytes past an aligned address: fill2/fillv "
              f"bitwise, segsum exact on integers, real max abs err "
              f"{err[0]!r} ({err[1]:.4f} of its bound)", flush=True)
        if (rows, n) not in (EEG_SHAPE, MAIN_SHAPE):
            continue
        knots, _ = scan_masks(x)
        chans = (x, torch.from_numpy(rng.normal(size=(rows, n)).astype(
            np.float32)).to(dev))
        first = cf.segsum_cuda(chans, knots, True)
        for _ in range(19):
            again = cf.segsum_cuda(chans, knots, True)
            if not all(bitwise_equal(a, b) for a, b in zip(again, first)):
                raise AssertionError(f"segsum {name}: two calls on the same "
                                     f"inputs differ")
        print(f"[2] segsum {name}: 20 calls on the same inputs bitwise the "
              f"same", flush=True)


def level_bwd_cases():
    """The shapes and layouts for the level adjoint's fused kernels, each
    (name, f32 array, element offset of every input from an aligned
    address): phase 2's cases (a NaN quarantine, tile edges, 2 samples, a
    constant and a monotone row), rows of 3 to 5 samples (the end-knot
    additions overlap, the first and last knots gather), plateaus and flat
    runs, rows and arrays off a 16-byte boundary (a chunk holds the end of
    one row and the start of the next; every access scalar), and the
    benchmark's and the main path's shapes."""
    rng = np.random.default_rng(18)
    for name, x in phase2_cases():
        yield name, x, 0
    for rows, n in ((4, 3), (3, 4), (5, 5)):
        yield f"({rows}, {n})", rng.normal(size=(rows, n)).astype(
            np.float32), 0
    flat = np.round(rng.normal(size=(4, 5000)) * 1.5).astype(np.float32)
    flat[1, 1000:3000] = 2.0
    flat[2] = np.repeat(rng.normal(size=50), 100)
    yield "plateaus and flat runs (4, 5000)", flat, 0
    t = np.linspace(0, 2 * np.pi, 4097)
    off = (np.sin(9 * t)[None] + 0.3 * rng.normal(size=(3, 4097))).astype(
        np.float32)
    yield "rows off a 16-byte boundary (3, 4097)", off, 0
    yield "arrays off a 16-byte boundary (3, 4097)", off, 1
    yield "arrays off by 3 floats (2, 130)", off[:2, :130].copy(), 3
    yield "(256, 16384)", eeg_signal(*EEG_SHAPE), 0
    yield "(8, 1000000)", bench_signal(*MAIN_SHAPE), 0


def check_level_bwd(name, x, offset: int = 0) -> bool:
    """``bwd_knots``, ``bwd_pre`` and ``bwd_post`` on the card against
    their plain versions on ``x``'s level adjoint (random cotangents, both
    endpoint modes): rtol = atol = 0, NaN equal to NaN and +0 to -0.
    ``offset``: every input starts that many elements past an aligned
    address.  Returns whether every output was also bitwise its plain
    version's."""
    import torch
    from pyitd_tpu_torch.ops import cuda_fill as cf

    rng = np.random.default_rng(x.shape[1] + 2)
    cts = [torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(
        np.float32)).to(x.device) for _ in range(3)]

    def moved(*ts):
        return tuple(off_boundary(t, offset) for t in ts) if offset else ts

    x, *cts = moved(x, *cts)
    bitwise = True

    def same(what, got, want):
        nonlocal bitwise
        for a, b in zip(got, want):
            torch.testing.assert_close(
                a, b, rtol=0, atol=0, equal_nan=True,
                msg=lambda m: f"{what} {name}: {m}")
            bitwise = bitwise and bitwise_equal(a, b)

    knots, f_next = cf.bwd_knots_cuda(x)
    same("bwd_knots", (knots, f_next), cf.bwd_knots(x))
    knots, f_next = moved(knots, f_next)
    fwd = moved(*cf.fill2_cuda(x, knots))
    bwd = moved(*cf.fill2_cuda(x, knots, True, True))
    for mode in ("reference", "natural"):
        pre = cf.bwd_pre_cuda(x, *cts, fwd, bwd, mode)
        same(f"bwd_pre {mode}", pre, cf.bwd_pre(x, *cts, fwd, bwd, mode))
        seg_a = moved(*cf.segsum_cuda(pre[:2], f_next, reverse=True))
        seg_e = moved(*cf.segsum_cuda(pre[2:4], knots, strict=True))
        (gx,) = moved(pre[4])
        same(f"bwd_post {mode}",
             (cf.bwd_post_cuda(knots, gx, seg_a, seg_e, fwd[2], bwd[0]),),
             (cf.bwd_post(knots, gx, seg_a, seg_e, fwd[2], bwd[0]),))
    return bitwise


def trip_cases(x, rng):
    """``bwd_pre``'s inputs as the kernel sift's reverse trip loop passes
    them, for the level input ``x`` (rows, n): (what, (g_rot, g_base,
    g_err), ``TripCotangents``).  Rows take every stop flag, the next
    trip's too; the cotangents hold infinities, so the zero path and a
    stop-B row's two-sum term turn them into NaN."""
    import torch
    from pyitd_tpu_torch.ops import cuda_fill as cf

    rows, n = x.shape

    def ct():
        g = rng.normal(size=(rows, n)).astype(np.float32)
        g.reshape(-1)[rng.integers(0, rows * n, size=3)] = np.inf
        return torch.from_numpy(g).to(x.device)

    def flags():
        f = rng.choice([0, cf.STOP_A, cf.STOP_B, cf.CONT], size=rows)
        return torch.from_numpy(f.astype(np.int32)).to(x.device)

    f, fn = flags(), flags()
    yield "every stream", (ct(), ct(), ct()), cf.TripCotangents(
        f, fn, ct(), ct(), True, ct())
    yield "level 0, rows only", (ct(), None, None), cf.TripCotangents(
        f, fn, ct(), ct(), True)
    yield "the last trip, correction only", (None, None, ct()), \
        cf.TripCotangents(f)
    yield "a middle trip, baselines only", (None, ct(), None), \
        cf.TripCotangents(f, carry=ct())


def bad_trips(x):
    """``bwd_pre_cuda`` calls on the level input ``x`` (rows, n) f32 that the
    wrapper refuses, by what is wrong: one per argument of the reverse trip
    loop, and a cotangent absent without it."""
    import torch
    from pyitd_tpu_torch.ops import cuda_fill as cf

    rows, n = x.shape
    knots, _ = cf.bwd_knots(x.cpu())
    fwd = tuple(t.to(x.device) for t in cf.fill2(x.cpu(), knots))
    bwd = tuple(t.to(x.device) for t in cf.fill2(x.cpu(), knots, True, True))
    g = torch.zeros_like(x)
    f = torch.zeros(rows, dtype=torch.int32, device=x.device)
    T = cf.TripCotangents

    def call(cts, trip):
        return lambda: cf.bwd_pre_cuda(x, *cts, fwd, bwd, trip=trip)

    return {
        "absent cotangent without trip": call((g, None, g), None),
        "flags missing": call((g, g, g), T(None)),
        "flags int64": call((g, g, g), T(f.long())),
        "flags per sample": call((g, g, g), T(torch.zeros_like(
            x, dtype=torch.int32))),
        "flags on the host": call((g, g, g), T(f.cpu()) if x.is_cuda
                                  else T(f[:-1])),
        "flags_next without g_next": call((g, g, g), T(f, f)),
        "g_next without flags_next": call((g, g, g), T(f, g_next=g)),
        "flags_next float": call((g, g, g), T(f, f.float(), g)),
        "g_next a row short": call((g, g, g), T(f, f, g[:-1])),
        "carry f64": call((g, g, g), T(f, carry=g.double())),
        "carry strided": call((g, g, g), T(f, carry=torch.zeros(
            rows, 2 * n, device=x.device)[:, ::2])),
        "g_zero past level 0": call((g, g, g), T(f, g_zero=g)),
        "g_zero one row": call((g, g, g), T(f, zero=True, g_zero=g[0])),
    }


def check_bwd_pre_trips(name, x, offset: int = 0) -> bool:
    """``bwd_pre`` on the card against its plain version on ``x``'s fills
    with the inputs of ``trip_cases`` (both endpoint modes): rtol = atol =
    0, NaN equal to NaN.  ``offset`` as in ``check_level_bwd``.  Returns
    whether every output was also bitwise its plain version's."""
    import torch
    from pyitd_tpu_torch.ops import cuda_fill as cf

    def moved(*ts):
        return tuple(t if t is None or not offset else off_boundary(t, offset)
                     for t in ts)

    (x,) = moved(x)
    knots, _ = cf.bwd_knots_cuda(x)
    fwd = moved(*cf.fill2_cuda(x, knots))
    bwd = moved(*cf.fill2_cuda(x, knots, True, True))
    bitwise = True
    rng = np.random.default_rng(x.shape[1] + 5)
    for what, cts, trip in trip_cases(x, rng):
        cts = moved(*cts)
        trip = trip._replace(**dict(zip(
            ("g_next", "carry", "g_zero"),
            moved(trip.g_next, trip.carry, trip.g_zero))))
        for mode in ("reference", "natural"):
            got = cf.bwd_pre_cuda(x, *cts, fwd, bwd, mode, trip=trip)
            want = cf.bwd_pre(x, *cts, fwd, bwd, mode, trip=trip)
            for a, b in zip(got, want):
                torch.testing.assert_close(
                    a, b, rtol=0, atol=0, equal_nan=True,
                    msg=lambda m: f"bwd_pre {what} {mode} {name}: {m}")
                bitwise = bitwise and bitwise_equal(a, b)
    return bitwise


def check_level_bwd_cases(dev) -> None:
    """``check_level_bwd`` and ``check_bwd_pre_trips`` on
    ``level_bwd_cases``."""
    import torch

    for name, xn, offset in level_bwd_cases():
        x = torch.from_numpy(xn).to(dev)
        bitwise = check_level_bwd(name, x, offset)
        trips = check_bwd_pre_trips(name, x, offset)
        torch.cuda.synchronize()
        print(f"[2] level adjoint kernels, {name}, inputs {offset} floats "
              f"past an aligned address: bwd_knots, bwd_pre, bwd_post equal "
              f"their plain versions (rtol = atol = 0), "
              f"{'bitwise' if bitwise else 'but for the sign of a zero'}; "
              f"bwd_pre on the reverse trip loop's inputs "
              f"{'bitwise' if trips else 'but for the sign of a zero'}",
              flush=True)


def check_adjoint(name, x, rng, tight: bool) -> tuple[float, float]:
    """The level adjoint on the kernels against the plain route: the
    kernel route's error against an f64 truth at most 1.5x the plain
    route's, plus 1e-6; with ``tight``, also rtol = atol = 2e-4 between
    them (the tolerance JAX holds its two routes to on this signal)."""
    import torch
    from pyitd_tpu_torch.ops.linear_baseline import structural_level_bwd

    cts = [torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(
        np.float32)).to(x.device) for _ in range(3)]
    gk = structural_level_bwd(x, *cts, "reference", fills="kernel")
    gt = structural_level_bwd(x, *cts, "reference", fills="torch")
    g64 = structural_level_bwd(x.double(), *(c.double() for c in cts),
                               "reference", fills="torch")
    if not bitwise_equal(torch.isnan(gk), torch.isnan(gt)):
        raise AssertionError(f"adjoint {name}: NaN positions differ")
    ok = ~torch.isnan(g64)
    if tight:
        torch.testing.assert_close(gk[ok], gt[ok], rtol=2e-4, atol=2e-4)
    err_k = float((gk.double() - g64)[ok].abs().max()) if ok.any() else 0.0
    err_t = float((gt.double() - g64)[ok].abs().max()) if ok.any() else 0.0
    if not err_k <= 1.5 * err_t + 1e-6:
        raise AssertionError(f"adjoint {name}: kernel route error {err_k} "
                             f"against f64, plain route {err_t}")
    return err_k, err_t


def grad_gap(gk, gp) -> tuple[float, float, float]:
    """``(max |gk - gp|, rms(gk - gp))`` over the samples where ``gp`` is
    not NaN, as fractions of ``max|gp|``, and ``max|gp|``; infinite where
    the NaN positions differ."""
    import torch

    g_max = float(gp.abs().nan_to_num(0.0).max())
    if not bitwise_equal(torch.isnan(gk), torch.isnan(gp)):
        return float("inf"), float("inf"), g_max
    ok = ~torch.isnan(gp)
    d = (gk - gp)[ok].double()
    if g_max == 0.0:
        return (0.0, 0.0, 0.0) if not bool(d.any()) else \
            (float("inf"), float("inf"), 0.0)
    return (float(d.abs().max()) / g_max,
            float(d.square().mean().sqrt()) / g_max, g_max)


def within(gap, limits) -> bool:
    return gap[0] <= limits[0] and gap[1] <= limits[1]


# ---- planted faults: scan wrappers with the defects a tiled scan kernel is
# most likely to have.  Each limit on the gradient must reject each fault
# wherever the fault changes the gradient.

def _seam_resets(flags, reverse):
    """A reset on each tile's first sample in scan order: a segsum that
    drops the carry into every tile."""
    import torch
    from pyitd_tpu_torch.ops import cuda_fill as cf

    t = torch.arange(flags.shape[-1], device=flags.device)
    return flags | (t % cf.TILE == (cf.TILE - 1 if reverse else 0))


def _one_reset_dropped(flags):
    """Without the first reset at or after the middle of each row."""
    import torch

    n = flags.shape[-1]
    t = torch.arange(n, device=flags.device)
    first = torch.where(flags & (t >= n // 2), t, n).amin(-1, keepdim=True)
    return flags & (t != first)


def _tile_carry_dropped(out, mask, reverse, strict):
    """fill2's outputs zeroed where no mark comes before the sample (in scan
    order) in its own tile: a fill2 that drops the carry into every
    tile."""
    import torch
    import torch.nn.functional as F
    from pyitd_tpu_torch.ops import cuda_fill as cf
    from pyitd_tpu_torch.ops.fill import shift_left, shift_right

    if strict:
        mask = shift_left(mask, False) if reverse else shift_right(mask, False)
    rows, n = mask.shape
    nt = -(-n // cf.TILE)
    m = F.pad(mask.int(), (0, nt * cf.TILE - n)).view(rows, nt, cf.TILE)
    seen = (m.flip(-1) if reverse else m).cummax(-1).values
    seen = (seen.flip(-1) if reverse else seen).reshape(rows, -1)[:, :n]
    return tuple(torch.where(seen != 0, o, torch.zeros_like(o)) for o in out)


FAULTS = {
    "segsum drops the tile carry": ("segsum_cuda", lambda fn: (
        lambda v, f, reverse=False, strict=False: fn(
            v, _seam_resets(f, reverse), reverse, strict))),
    "segsum drops one reset per row": ("segsum_cuda", lambda fn: (
        lambda v, f, reverse=False, strict=False: fn(
            v, _one_reset_dropped(f), reverse, strict))),
    "fill2 drops the tile carry": ("fill2_cuda", lambda fn: (
        lambda v, m, reverse=False, strict=False: _tile_carry_dropped(
            fn(v, m, reverse, strict), m, reverse, strict))),
}


@contextlib.contextmanager
def swapped(fns: dict, module=None):
    """Run with the functions named in ``fns`` replaced in ``module``
    (default ``cuda_fill``)."""
    from pyitd_tpu_torch.ops import cuda_fill as cf

    module = cf if module is None else module
    real = {k: getattr(module, k) for k in fns}
    for k, fn in fns.items():
        setattr(module, k, fn)
    try:
        yield
    finally:
        for k, fn in real.items():
            setattr(module, k, fn)


def plain_scans():
    """The adjoint's scan wrappers swapped for their plain versions."""
    from pyitd_tpu_torch.ops import cuda_fill as cf

    return swapped({"fill2_cuda": cf.fill2, "segsum_cuda": cf.segsum})


def planted(fault: str):
    """The adjoint's scan wrapper with ``fault`` planted in it."""
    from pyitd_tpu_torch.ops import cuda_fill as cf

    attr, wrap = FAULTS[fault]
    return swapped({attr: wrap(getattr(cf, attr))})


def sift_grad(x, max_iteration, **kw):
    """The gradient of ``sift_loss`` through ``itd_sift`` at ``x``."""
    from pyitd_tpu_torch import itd_sift

    xg = x.clone().requires_grad_()
    sift_loss(itd_sift(xg, max_iteration, **kw)).backward()
    return xg.grad


def replay_grad(x, max_iteration, store_baselines=True):
    """The gradient of ``sift_loss`` through autograd of the loop with
    structural levels on the kernels (``_itd_sift_torch(...,
    linear_backend="structural", level_backend="kernel")``), which the
    kernel sift's reverse trip loop equals bit for bit on finite
    cotangents."""
    from pyitd_tpu_torch.decomp.itd import _itd_sift_torch

    xg = x.clone().requires_grad_()
    sift_loss(_itd_sift_torch(xg, max_iteration, "reference",
                              store_baselines, False,
                              linear_backend="structural",
                              level_backend="kernel")).backward()
    return xg.grad


# ---- the cubic tier ----

def cubic_cases():
    """Phase 2's cases, then the cubic tier's own: a row across tiles and
    SPIKE blocks, knots and NaN on K7's run and block edges and a block
    without a knot (``tools/cubic_bench.py::edge_cases``), short rows, the
    degenerate rows of tests/test_cubic.py:312-320, and the pass-through
    guard (each (name, f32 array, min_extrema))."""
    from pyitd_tpu_torch.ops import cuda_cubic as cc
    from pyitd_tpu_torch.tools.cubic_bench import edge_cases

    for name, xn in phase2_cases():
        yield name, xn, 0
    for name, xn in edge_cases(cc.SPIKE_BLK, cc.SPIKE_RUN):
        yield name, xn, 0
    rng = np.random.default_rng(4)
    n = 3 * 4096 + 17
    t = np.linspace(0, 6 * np.pi, n)
    yield f"tiles and SPIKE blocks (2, {n})", np.stack([
        np.sin(40 * t) + 0.3 * rng.normal(size=n),
        rng.normal(size=n)]).astype(np.float32), 0
    for n in (64, 300):
        yield f"short (2, {n})", rng.normal(size=(2, n)).astype(np.float32), 0
    n = 32
    tt = np.arange(n, dtype=np.float64)
    for name, sig in {
            "tent": np.minimum(tt, n - 1 - tt),
            "asym_tent": np.where(tt < 9, tt, (n - 1 - tt) * 9.0 / (n - 10)),
            "monotone": tt * 1.7,
            "constant": np.ones(n),
            "two_extrema": np.sin(2 * np.pi * tt / 20),
            "two_sample": np.array([1.0, 2.0])}.items():
        yield f"degenerate {name} (1, {sig.size})", \
            sig[None].astype(np.float32), 0
    t = np.linspace(0, 6, 256)
    yield "pass-through guard (2, 256)", np.stack(
        [np.sin(t), np.sin(40 * t)]).astype(np.float32), 10


@contextlib.contextmanager
def plain_cubic():
    """The cubic route with every kernel wrapper it calls (the sift
    pre-pass's too) swapped for its plain version."""
    from pyitd_tpu_torch.ops import cuda_cubic as cc
    from pyitd_tpu_torch.ops import cuda_fill as cf

    with swapped({"level_states_cuda": cf.level_states}), \
            swapped(cc.PLAIN, cc):
        yield


def _tensors(out):
    return tuple(out) if isinstance(out, tuple) else (out,)


@contextlib.contextmanager
def recorded_cubic(calls: dict):
    """The cubic kernel wrappers, each holding its output bitwise against
    its plain version on the same inputs (raises on a difference) and
    recording ``(args, output, max abs err)`` in ``calls[name]``."""
    from pyitd_tpu_torch.ops import cuda_cubic as cc

    real = {k: getattr(cc, k) for k in cc.PLAIN}

    def wrap(k):
        def fn(*args):
            out = real[k](*args)
            pairs = list(zip(_tensors(out), _tensors(cc.PLAIN[k](*args))))
            err = max(max_abs_err(a, b) for a, b in pairs)
            if not all(bitwise_equal(a, b) for a, b in pairs):
                raise AssertionError(f"{k}: kernel differs from its plain "
                                     f"version, max abs err {err}")
            calls[k] = (args, out, err)
            return out
        return fn

    with swapped({k: wrap(k) for k in real}, cc):
        yield


def check_cubic(name, x, min_extrema):
    """``cubic_baseline_extract(x, n + 2, eval_backend="fills")`` on the
    card: one launch of each cubic kernel, each bitwise against its plain
    version, the route bitwise against the plain route.  Returns the
    route's result."""
    from pyitd_tpu_torch import cubic_baseline_extract
    from pyitd_tpu_torch.ops import cuda_cubic as cc

    def run():
        return cubic_baseline_extract(x, x.shape[-1] + 2,
                                      min_extrema=min_extrema,
                                      eval_backend="fills")

    cc.reset_launches()
    with recorded_cubic({}):
        got = run()
    launches = dict(cc.LAUNCHES)
    if launches != {k: 1 for k in launches}:
        raise AssertionError(f"cubic {name}: launches {launches}")
    with plain_cubic():
        want = run()
    for f in got._fields:
        if not bitwise_equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(
                f"cubic {name}: {f} differs from the plain route, max abs "
                f"err {max_abs_err(getattr(got, f), getattr(want, f))}")
    if got.baseline.dtype != x.dtype or got.rotation.dtype != x.dtype:
        raise AssertionError(f"cubic {name}: {got.baseline.dtype} out for "
                             f"{x.dtype} in")
    return got


def phase2_cubic(dev) -> None:
    """Phase 2's cubic cases on the card, and K7 alone on systems with
    knots on its run and block edges."""
    import torch
    from pyitd_tpu_torch.ops import cuda_cubic as cc
    from pyitd_tpu_torch.tools.cubic_bench import spike_cases

    for name, sys_ in spike_cases(cc.SPIKE_BLK, cc.SPIKE_RUN):
        m, *rows = (torch.from_numpy(v).to(dev) for v in sys_)
        got = cc.spike_factors_cuda(m, *rows)
        want = cc.spike_factors(m, *rows)
        if not bitwise_equal(got, want):
            raise AssertionError(f"spike_factors {name}: kernel differs from "
                                 f"its plain version, max abs err "
                                 f"{max_abs_err(got, want)}")
        print(f"[2] spike_factors {name} (SB {cc.SPIKE_BLK}, R "
              f"{cc.SPIKE_RUN}): bitwise its plain version", flush=True)
    for name, xn, me in cubic_cases():
        x = torch.from_numpy(xn).to(dev)
        r = check_cubic(name, x, me)
        guard = ""
        if me:
            held = r.num_extrema < me
            if not (held.any() and bool(
                    (r.baseline[held] == x[held]).all())
                    and bool((r.rotation[held] == 0).all())):
                raise AssertionError(f"cubic {name}: pass-through guard")
            guard = f", pass-through on rows {held.nonzero()[:, 0].tolist()}"
        print(f"[2] cubic {name}: K5-K8 one launch each, each bitwise its "
              f"plain version, the route bitwise the plain route; "
              f"num_extrema {r.num_extrema.tolist()}{guard}", flush=True)
    name, xn = next(phase2_cases())
    check_cubic(f"{name} f64", torch.from_numpy(xn).double().to(dev), 0)
    print(f"[2] cubic {name} in f64: f64 out, bitwise the plain route",
          flush=True)
    # the guard in f64: the row itself, not f64(f32(x)), and rotation 0
    name, xn, me = list(cubic_cases())[-1]
    x = torch.from_numpy(xn).double().to(dev) * (1 + 1e-9)
    r = check_cubic(f"{name} f64", x, me)
    held = r.num_extrema < me
    if not (held.any() and bool((r.baseline[held] == x[held]).all())
            and bool((r.rotation[held] == 0).all())):
        raise AssertionError(f"cubic {name} f64: pass-through guard")
    print(f"[2] cubic {name} in f64: the guarded rows "
          f"{held.nonzero()[:, 0].tolist()} return x itself in f64, "
          f"rotation 0", flush=True)


def phase8_cubic(x, card: str):
    """The cubic level at full size; returns its launches, the calls
    ``recorded_cubic`` saw (each kernel's inputs and output) and the kernel
    route's device time by kernel name."""
    import torch
    from pyitd_tpu_torch import cubic_baseline_extract
    from pyitd_tpu_torch.ops import cuda_cubic as cc
    from pyitd_tpu_torch.ops import cuda_fill as cf
    from pyitd_tpu_torch.tools.cubic_bench import (INTERFACE_SHAPES,
                                                   bench_signal,
                                                   interface_timing)

    rows, n = x.shape
    cap = n + 2

    def level(xx):
        return cubic_baseline_extract(xx, cap, min_extrema=0,
                                      eval_backend="fills")

    torch.cuda.synchronize()
    cc.reset_launches()
    cf.reset_launches()
    res = level(x)
    torch.cuda.synchronize()
    launches, sift = dict(cc.LAUNCHES), dict(cf.LAUNCHES)
    # the sift pre-pass seeds K5 and K6: one level_summaries, one tile_scan
    want_sift = {k: int(k in ("level_summaries", "tile_scan")) for k in sift}
    if launches != {k: 1 for k in launches} or sift != want_sift:
        raise AssertionError(f"cubic 8x1M launches {launches}, sift kernels "
                             f"{sift}")
    for f in ("baseline", "rotation"):
        v = getattr(res, f)
        if tuple(v.shape) != (rows, n) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"cubic 8x1M: {f} not finite or shaped "
                                 f"{tuple(v.shape)}")
    calls = {}
    with recorded_cubic(calls):
        again = level(x)
    with plain_cubic():
        plain = level(x)
    for f in res._fields:
        for other, what in ((again, "a second run"), (plain, "the plain "
                                                      "route")):
            if not bitwise_equal(getattr(res, f), getattr(other, f)):
                raise AssertionError(
                    f"cubic 8x1M: {f} differs from {what}, max abs err "
                    f"{max_abs_err(getattr(res, f), getattr(other, f))}")
    del again, plain
    print(f"[8] cubic 8x1M (capacity n+2, min_extrema=0): launches "
          f"{launches}, sift pre-pass {sift}; each kernel bitwise its plain "
          f"version, the route bitwise the plain route; num_extrema "
          f"{res.num_extrema.tolist()}", flush=True)

    g64 = cubic_baseline_extract(x.double(), cap, min_extrema=0,
                                 eval_backend="gather")
    if not torch.equal(g64.num_extrema, res.num_extrema):
        raise AssertionError("cubic 8x1M: extrema counts differ from the "
                             "f64 gather route")
    scale = float(g64.baseline.abs().max())
    rel = float((res.baseline.double() - g64.baseline).abs().max()) / scale
    del g64
    print(f"[8] cubic 8x1M f32 baseline against the f64 gather route: max "
          f"abs diff {rel!r} of max|baseline| {scale!r} (limit "
          f"{CUBIC_F64_REL})", flush=True)
    if not rel <= CUBIC_F64_REL:
        raise AssertionError("cubic 8x1M: f32 baseline beyond its limit "
                             "against f64")

    k_ms = cuda_times(lambda: level(x))
    with plain_cubic():
        p_ms = cuda_times(lambda: level(x), warmup=1)
        p_dms, p_by = device_ms(lambda: level(x), reps=3)
    k_dms, k_by = device_ms(lambda: level(x))
    for route, times, dms, by_name in (("kernel", k_ms, k_dms, k_by),
                                       ("plain", p_ms, p_dms, p_by)):
        ms = statistics.median(times)
        print(f"[8] cubic 8x1M {route} route: {ms:.4f} ms/level (CUDA "
              f"events, median of {len(times)}, min {times[0]:.4f}, max "
              f"{times[-1]:.4f}), {rows * n / ms / 1e3:.2f} Msamp/s; device "
              f"busy {dms:.4f} ms/level, idle share {1 - dms / ms:.3f}  "
              f"[{card}]", flush=True)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"[8]   top device kernels, {route} route (ms/level): "
              + "; ".join(f"{kernel_label(k)} {v:.4f}" for k, v in top),
              flush=True)
    # the interface solve and the end moments alone: one launch, beside
    # the eager composition it replaced, here and at the MEITD levels'
    # shape and 8 x 2^20
    for xi in (x, *(torch.from_numpy(bench_signal(*shape)).to(x.device)
                    for shape in INTERFACE_SHAPES)):
        interface_timing(xi, card, tag="[8] ")

    xg = x.clone().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    cc.reset_launches()
    (level(xg).rotation ** 2).sum().backward()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    grad_launches = dict(cc.LAUNCHES)
    if grad_launches != launches:
        raise AssertionError(f"cubic 8x1M gradient launches {grad_launches}")
    if not bool(torch.isfinite(xg.grad).all()):
        raise AssertionError("cubic 8x1M: non-finite gradient")
    g_max = float(xg.grad.abs().max())

    def fwd_bwd():
        xg.grad = None
        (level(xg).rotation ** 2).sum().backward()

    fb_ms = cuda_times(fwd_bwd, warmup=1)
    fb_dms, _ = device_ms(fwd_bwd, reps=3)
    fb = statistics.median(fb_ms)
    print(f"[8] cubic 8x1M gradient of sum(rotation^2): finite, max|g| "
          f"{g_max!r}; forward + backward {fb:.4f} ms (CUDA events, median "
          f"of {len(fb_ms)}, min {fb_ms[0]:.4f}, max {fb_ms[-1]:.4f}), "
          f"{fb / statistics.median(k_ms):.2f}x the forward; device busy "
          f"{fb_dms:.4f} ms, idle share {1 - fb_dms / fb:.3f}; peak memory "
          f"{peak_gb:.3f} GB, {peak_gb - held_gb:.3f} GB above the "
          f"{held_gb:.3f} GB held before it  [{card}]", flush=True)
    return launches, calls, k_by


# ---- the sequence-parallel tier ----

@contextlib.contextmanager
def fold_emit_flag(on: bool):
    """``PYITD_FOLD_EMIT`` set (``on``) or unset for the block, then as it
    was: the sharded kernel route's only lever, as in JAX."""
    old = os.environ.pop("PYITD_FOLD_EMIT", None)
    if on:
        os.environ["PYITD_FOLD_EMIT"] = "1"
    try:
        yield
    finally:
        os.environ.pop("PYITD_FOLD_EMIT", None)
        if old is not None:
            os.environ["PYITD_FOLD_EMIT"] = old


def sharded_route_counts(trips: int, fold: bool) -> tuple[dict, dict]:
    """The sift kernels' launches and, of those, the modes in one sharded
    kernel sift of ``trips`` trips, with ``fold_emit`` or without."""
    from pyitd_tpu_torch.ops import cuda_fill as cf

    launches = {k: trips if k in SIFT_KERNELS else 0 for k in cf.LAUNCHES}
    modes = dict.fromkeys(cf.MODE_LAUNCHES, 0)
    modes["sift_level_book"] = trips - 1
    if fold:
        launches["level_summaries"] = 1
        modes.update({k: trips - 1 for k in modes})
    return launches, modes


def plain_sift_kernels():
    """The three sift kernel wrappers swapped for their plain versions."""
    from pyitd_tpu_torch.ops import cuda_fill as cf

    return swapped({k + "_cuda": getattr(cf, k) for k in SIFT_KERNELS})


@contextlib.contextmanager
def recorded_sift(calls: dict, keep: int = 1):
    """The three sift kernel wrappers, each holding its output bitwise
    against its plain version on the same inputs (raises on a difference)
    and recording ``(args, kwargs, max abs err)`` of every call in
    ``calls[name]``; only call number ``keep`` (trip 1: the first with the
    bookkeeping) keeps its tensors, the others record None."""
    import torch
    from pyitd_tpu_torch.ops import cuda_fill as cf

    def wrap(k):
        real, plain = getattr(cf, k + "_cuda"), getattr(cf, k)

        def fn(*args, **kw):
            out = real(*args, **kw)
            pkw = dict(kw)
            if kw.get("out_row") is not None:
                pkw["out_row"] = torch.empty_like(kw["out_row"])
            pairs = list(zip(flat(out), flat(plain(*args, **pkw))))
            if "out_row" in pkw:
                pairs.append((kw["out_row"], pkw["out_row"]))
            err = max(max_abs_err(a, b) for a, b in pairs)
            if not all(bitwise_equal(a, b) for a, b in pairs):
                raise AssertionError(f"{k}: kernel differs from its plain "
                                     f"version, max abs err {err}")
            seen = calls.setdefault(k, [])
            seen.append((args, kw, err) if len(seen) == keep
                        else (None, None, err))
            return out
        return fn

    with swapped({k + "_cuda": wrap(k) for k in SIFT_KERNELS}):
        yield


def flat(out) -> list:
    """The tensors of a (nested) tuple of tensors and Nones."""
    if out is None:
        return []
    if isinstance(out, tuple):
        return [t for part in out for t in flat(part)]
    return [out]


def sift_tuple(r):
    """A ``SiftResult`` as ``sharded_itd_sift`` returns its own."""
    return r.rotations, r.num_components, r.stop_reason, r.correction


def same_sift(got, want, what) -> None:
    for f, a, b in zip(("rotations", "num_components", "stop_reason",
                        "correction"), got, want):
        if not bitwise_equal(a, b):
            raise AssertionError(f"{what}: {f} differs, max abs err "
                                 f"{max_abs_err(a, b)}")


def phase2_sharded(dev) -> None:
    """Phase 2's sequence-parallel cases on the card."""
    import torch
    from pyitd_tpu_torch import cubic_baseline_extract, itd_sift
    from pyitd_tpu_torch.ops import cuda_fill as cf
    from pyitd_tpu_torch.parallel import (LocalGroup, sharded_cubic_baseline,
                                          sharded_itd_sift)

    def both_routes(x, seq, mode, mi, what):
        """The route without ``fold_emit`` and with it, launches and
        collectives counted, the two bitwise each other; returns the
        first."""
        out = None
        for fold in (False, True):
            group = LocalGroup(seq)
            cf.reset_launches()
            with fold_emit_flag(fold):
                got = sharded_itd_sift(x, group, mi, endpoint_mode=mode,
                                       backend="kernel")
            trips = mi + 3
            want_l, want_m = sharded_route_counts(trips, fold)
            want_c = {"halo": 2 * trips, "all_gather": trips,
                      "all_reduce_sum": trips, "all_reduce_min": 0}
            if (dict(cf.LAUNCHES), dict(cf.MODE_LAUNCHES), group.calls) != (
                    want_l, want_m, want_c):
                raise AssertionError(f"{what}, fold_emit={fold}: launches "
                                     f"{dict(cf.LAUNCHES)} by mode "
                                     f"{dict(cf.MODE_LAUNCHES)}, collectives "
                                     f"{group.calls}")
            if out is None:
                out = got
            else:
                same_sift(got, out, what + " with fold_emit against the "
                          "route without it")
        same_sift(out, sift_tuple(itd_sift(
            x, mi, endpoint_mode=mode, store_baselines=False,
            backend="kernel")), what + " against the unsharded sift")
        return out

    for name, xn in sharded_cases():
        x = torch.from_numpy(xn).to(dev)
        reasons = set()
        for seq in (2, 4, 8):
            for mode, mi in (("reference", 6), ("natural", 6),
                             ("reference", 2), ("natural", 2)):
                what = f"sharded sift {name}, {seq} shards, {mode}, " \
                    f"max_iteration={mi}"
                got = both_routes(x, seq, mode, mi, what)
                with plain_sift_kernels(), fold_emit_flag(False):
                    plain = sharded_itd_sift(x, LocalGroup(seq), mi,
                                             endpoint_mode=mode,
                                             backend="kernel")
                same_sift(got, plain, what + " against plain versions")
                reasons.update(got[2].tolist())
        cub = ""
        if not bool(torch.isnan(x).any()):
            x64 = x.double()
            ref = cubic_baseline_extract(x64, x.shape[-1] + 2, min_extrema=0,
                                         eval_backend="gather")
            worst = 0.0
            for seq in (2, 4, 8):
                for method in ("spike", "gather"):
                    _, base, nex = sharded_cubic_baseline(
                        x64, LocalGroup(seq), method=method, min_extrema=0)
                    if not torch.equal(nex, ref.num_extrema):
                        raise AssertionError(f"sharded cubic {name} {method} "
                                             f"{seq} shards: extrema counts")
                    worst = max(worst, max_abs_err(base, ref.baseline))
            if not worst <= 1e-10:
                raise AssertionError(f"sharded cubic {name}: max abs diff "
                                     f"{worst} from the gather route")
            cub = (f"; sharded cubic (spike, gather) f64 within {worst!r} of "
                   f"the gather route")
        print(f"[2] sharded {name}: 2, 4, 8 shards x both endpoint modes x "
              f"max_iteration 2, 6: kernel route == fold_emit route == "
              f"plain versions == unsharded kernel sift bitwise, stop reasons "
              f"seen {sorted(reasons)}{cub}", flush=True)
    # the layouts of the sample an emitting level leaves out
    for layout, n_loc in fold_emit_layouts().items():
        reasons = set()
        for seq in (2, 4, 8):
            x = torch.from_numpy(fold_emit_signal(n_loc, seq)).to(dev)
            for mode, mi in (("reference", 6), ("natural", 2)):
                reasons.update(both_routes(
                    x, seq, mode, mi, f"fold_emit layout {layout}, {seq} "
                    f"shards of {n_loc}, {mode}, max_iteration={mi}"
                )[2].tolist())
        print(f"[2] fold_emit layout {layout} (n_loc {n_loc}): 2, 4, 8 "
              f"shards x both endpoint modes: fold_emit route == kernel "
              f"route == unsharded kernel sift bitwise, stop reasons seen "
              f"{sorted(reasons)}", flush=True)


def phase9_sharded(dev, card: str):
    """The sequence-parallel tier at full width; its main path is the
    ``fold_emit`` route.  Returns the launches of the main-path run, their
    modes, and the recorded calls of the shard-aware kernels in the route
    without ``fold_emit`` and in the route with it."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    from pyitd_tpu_torch import cubic_baseline_extract, itd_sift
    from pyitd_tpu_torch.ops import cuda_fill as cf
    from pyitd_tpu_torch.parallel import (DistGroup, LocalGroup,
                                          sharded_cubic_baseline,
                                          sharded_itd_sift)
    from pyitd_tpu_torch.parallel.sharded import _fold_states_both
    from pyitd_tpu_torch.tools.level_bench import aten_ops

    rows, n = SHARD_SHAPE
    seq, mi = SHARD_SEQ, MAIN_MAX_IT
    levels, trips = mi + 2, mi + 3
    label = f"{rows}x{n} over {seq} shards of {n // seq}"
    x = torch.from_numpy(bench_signal(rows, n)).to(dev)
    group = LocalGroup(seq)

    def sharded():  # the route without fold_emit
        with fold_emit_flag(False):
            return sharded_itd_sift(x, group, mi)

    def sharded_fold():
        with fold_emit_flag(True):
            return sharded_itd_sift(x, group, mi)

    def whole():
        return itd_sift(x, mi, store_baselines=False)

    want_c = {"halo": 2 * trips, "all_gather": trips, "all_reduce_sum": trips,
              "all_reduce_min": 0}

    def counted(fn, fold):
        torch.cuda.synchronize()
        cf.reset_launches()
        group.reset_calls()
        out = fn()
        torch.cuda.synchronize()
        got = (dict(cf.LAUNCHES), dict(cf.MODE_LAUNCHES), dict(group.calls))
        want_l, want_m = sharded_route_counts(trips, fold)
        if got != (want_l, want_m, want_c):
            raise AssertionError(f"sharded {label}, fold_emit={fold}: "
                                 f"launches {got[0]} by mode {got[1]}, "
                                 f"collectives {got[2]}")
        return out, got

    # the main path: the fold_emit route, the counts set to 0 just before
    res, (launches, modes, calls_c) = counted(sharded_fold, True)
    if tuple(res[0].shape) != (levels, rows, n) or not bool(
            torch.isfinite(res[0]).all()):
        raise AssertionError(f"sharded {label}: rotations not finite or "
                             f"shaped {tuple(res[0].shape)}")
    recon = 0.0
    for r in range(rows):  # row by row: the f64 copies are large
        recon = max(recon, float((res[0][:, r].double().sum(0)
                                  + res[3][r].double()
                                  - x[r].double()).abs().max()))
    if not recon <= 1e-10:
        raise AssertionError(f"sharded {label}: compensated reconstruction "
                             f"error {recon}")
    default, (d_launches, d_modes, _) = counted(sharded, False)
    same_sift(res, default, f"sharded {label}: fold_emit against the route "
              f"without it")
    del default
    ref = whole()
    same_sift(res, sift_tuple(ref), f"sharded {label} against the unsharded "
              f"sift")
    del ref
    calls, calls_fold = {}, {}
    for rec, fn in ((calls, sharded), (calls_fold, sharded_fold)):
        with recorded_sift(rec):
            again = fn()
        same_sift(res, again, f"sharded {label} against a second run")
        del again
    print(f"[9] sharded sift {label}, max_iteration={mi}, fold_emit: "
          f"launches {launches} by mode {modes}; without fold_emit "
          f"{d_launches} by mode {d_modes}; collectives {calls_c} in both "
          f"({trips} trips: 2 halo exchanges, 1 gather, 1 sum each); every "
          f"launch of both routes bitwise its plain version; the two routes "
          f"bitwise each other and the unsharded kernel sift; num_components "
          f"{res[1].tolist()}, stop_reason {res[2].tolist()}; compensated "
          f"reconstruction error {recon!r}", flush=True)
    del res

    # the A/B in turns (without, with, with, without), then the unsharded
    routes = {"sharded": sharded, "sharded, fold_emit": sharded_fold}
    ab = {k: [] for k in routes}
    for what in ("sharded", "sharded, fold_emit", "sharded, fold_emit",
                 "sharded"):
        ab[what] += cuda_times(routes[what], reps=5)
    routes["unsharded"] = whole
    ab["unsharded"] = cuda_times(whole)
    for what, fn in routes.items():
        times = sorted(ab[what])
        dms, by_name = device_ms(fn)
        ms = statistics.median(times)
        print(f"[9] {what} sift {rows}x{n}: {ms:.4f} ms/sift (CUDA events, "
              f"median of {len(times)}, min {times[0]:.4f}, max "
              f"{times[-1]:.4f}), {rows * n / ms / 1e3:.2f} Msamp/s; device "
              f"busy {dms:.4f} ms/sift, idle share {1 - dms / ms:.3f}  "
              f"[{card}]", flush=True)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"[9]   top device kernels, {what} (ms/sift): " + "; ".join(
            f"{kernel_label(k)} {v:.4f}" for k, v in top), flush=True)

    # per launch on trip 1's inputs: what fold_emit adds to a level and
    # takes from a trip's summaries
    def one(rec, k):
        args, kw, _ = rec[k][1]
        return device_ms(lambda: getattr(cf, k + "_cuda")(*args, **kw))[0]

    lvl_ms, emit_ms = one(calls, "sift_level"), one(calls_fold, "sift_level")
    sum_ms, scan_ms = (one(calls, "level_summaries"),
                       one(calls, "tile_scan"))
    edges_ms = one(calls_fold, "tile_scan")
    print(f"[9] per launch, {rows * seq} shard rows of {n // seq} (profiler "
          f"device time): sift_level<SHARD> {lvl_ms:.4f} ms, emitting "
          f"{emit_ms:.4f} ms ({emit_ms / lvl_ms - 1:+.3f}); a trip's "
          f"summaries: level_summaries<SHARD> + tile_scan {sum_ms:.4f} + "
          f"{scan_ms:.4f} ms without fold_emit, tile_scan completing the "
          f"emitted ones {edges_ms:.4f} ms with it  [{card}]", flush=True)

    # the comm layer alone: the cross-shard fold of one trip's totals
    args, kw, _ = calls["level_summaries"][1]
    _, tot = cf.tile_scan_cuda(cf.level_summaries_cuda(*args, **kw),
                               totals=True)
    f_ms = cuda_times(lambda: _fold_states_both(tot, group, seq))
    f_dms, _ = device_ms(lambda: _fold_states_both(tot, group, seq))
    f_ops = aten_ops(lambda: _fold_states_both(tot, group, seq))
    t_ops = aten_ops(sharded)
    print(f"[9] cross-shard fold alone ({seq} shards x {rows} rows): "
          f"{statistics.median(f_ms):.4f} ms (CUDA events, median of "
          f"{len(f_ms)}), device busy {f_dms:.4f} ms, {f_ops} ATen operator "
          f"calls; the whole sharded sift makes {t_ops} ATen calls, "
          f"{t_ops / trips:.1f} per trip  [{card}]", flush=True)

    # one rank of a torch.distributed group on the card: the same signal as
    # one shard over NCCL, against LocalGroup(1)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, device_id=dev)
        try:
            dgroup = DistGroup()
            got = sharded_itd_sift(x, dgroup, mi)
            torch.cuda.synchronize()
            d_calls = dict(dgroup.calls)
            d_ms = cuda_times(lambda: sharded_itd_sift(x, dgroup, mi), reps=5)
        finally:
            dist.destroy_process_group()
    same_sift(got, sharded_itd_sift(x, LocalGroup(1), mi),
              "DistGroup of one rank against LocalGroup(1)")
    del got
    print(f"[9] DistGroup (NCCL, one rank, FileStore) {rows}x{n} as one "
          f"shard: bitwise LocalGroup(1); collectives {d_calls}; "
          f"{statistics.median(d_ms):.4f} ms/sift (CUDA events, median of "
          f"{len(d_ms)})  [{card}]", flush=True)

    # the gradient: the kernel route's backward differentiates the plain
    # sharded route, whose autograd holds every level's intermediates
    g_rows, g_n = SHARD_GRAD_SHAPE
    xs = x[:g_rows, :g_n].contiguous()

    def loss4(out):
        return (out[0] ** 2).sum() + 0.7 * out[3].sum()

    xg = xs.clone().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    loss4(sharded_itd_sift(xg, LocalGroup(seq), mi)).backward()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    g = xg.grad.detach().clone()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("sharded gradient: not finite")
    xp = xs.clone().requires_grad_()
    sift_loss(itd_sift(xp, mi, store_baselines=False, backend="torch")
              ).backward()
    gap = grad_gap(g, xp.grad)
    del xp

    def fwd_bwd():
        xg.grad = None
        loss4(sharded_itd_sift(xg, LocalGroup(seq), mi)).backward()

    fb_ms = cuda_times(fwd_bwd, reps=5, warmup=1)
    print(f"[9] sharded gradient at {g_rows}x{g_n} over {seq} shards (the "
          f"plain sharded route's autograd does not fit at {rows}x{n}): "
          f"finite; against the unsharded plain sift's gradient max|diff| "
          f"{gap[0]!r} and rms {gap[1]!r} of max|g| {gap[2]!r} (limits "
          f"{GRAD_LIMITS['8x1M']}); forward + backward "
          f"{statistics.median(fb_ms):.4f} ms (CUDA events, median of "
          f"{len(fb_ms)}, min {fb_ms[0]:.4f}, max {fb_ms[-1]:.4f}); peak "
          f"memory {peak_gb:.3f} GB, {peak_gb - held_gb:.3f} GB above the "
          f"{held_gb:.3f} GB held before it  [{card}]", flush=True)
    if not within(gap, GRAD_LIMITS["8x1M"]):
        raise AssertionError("sharded gradient beyond its limits against "
                             "the unsharded plain sift's")
    del xg, g

    # one sharded cubic level (plain PyTorch on the card, as it is plain
    # XLA in JAX) against the kernel route of the whole signal
    def cubic():
        return sharded_cubic_baseline(x, group, method="spike",
                                      min_extrema=0)

    ref = cubic_baseline_extract(x, n + 2, min_extrema=0,
                                 eval_backend="fills")
    group.reset_calls()
    _, base, nex = cubic()
    cubic_calls = dict(group.calls)
    if not torch.equal(nex, ref.num_extrema):
        raise AssertionError("sharded cubic: extrema counts differ")
    scale = float(ref.baseline.abs().max())
    rel = max_abs_err(base, ref.baseline) / scale
    del base, ref
    c_ms = cuda_times(cubic, reps=5, warmup=1)
    c_dms, _ = device_ms(cubic, reps=2)
    c = statistics.median(c_ms)
    print(f"[9] sharded cubic level (spike) {label}: against "
          f"cubic_baseline_extract of the whole signal max abs diff {rel!r} "
          f"of max|baseline| {scale!r} (limit {CUBIC_F64_REL}); collectives "
          f"{cubic_calls}; {c:.4f} ms/level (CUDA events, median of "
          f"{len(c_ms)}, min {c_ms[0]:.4f}, max {c_ms[-1]:.4f}), device busy "
          f"{c_dms:.4f} ms, idle share {1 - c_dms / c:.3f}  [{card}]",
          flush=True)
    if not rel <= CUBIC_F64_REL:
        raise AssertionError("sharded cubic beyond its limit against the "
                             "unsharded level")
    return launches, modes, calls, calls_fold


# ---- the cubic tier's callers: MEITD and the 2-D ensemble ----

def ensemble_signal(n: int):
    """The ensemble bench's signal (bench.py:166-170), float64."""
    rng = np.random.default_rng(2)
    t = np.linspace(0, 6 * np.pi, n)
    return (np.sin(20 * t * (1 + 0.1 * t)) + np.sin(13 * t)
            + 0.25 * rng.normal(size=n))


def tile_2d(side: int):
    """The 2-D profile's tile (bench_profile.py:50-56, 134): the first
    side² samples of the bench signal's first row, f32, as float64."""
    n = 1_000_000
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, n)[:side * side]
    row = (np.sin(20 * t * (1 + 0.2 * t))
           + 0.3 * rng.normal(size=side * side)).astype(np.float32)
    return row.astype(np.float64).reshape(side, side)


@contextlib.contextmanager
def recorded_levels(calls: list):
    """Every cubic level the MEITD walks and the 2-D tier call, recorded as
    ``(input, kwargs)``."""
    from pyitd_tpu_torch.decomp import meitd as pm

    real = pm.cubic_baseline_extract

    def fn(x, capacity, **kw):
        calls.append((x, kw))
        return real(x, capacity, **kw)

    with swapped({"cubic_baseline_extract": fn}, pm):
        yield


def same_result(got, want, what: str) -> None:
    for f in got._fields:
        if not bitwise_equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(
                f"{what}: {f} differs from the plain route, max abs err "
                f"{max_abs_err(getattr(got, f), getattr(want, f))}")


def counted(fn):
    """``fn()`` with the cubic and sift kernel launches, the walks' trips
    and host reads, the cubic levels and the gate statistics' launches
    (``counts["walk_stats"]``) counted from 0; returns ``(out, launches,
    sift launches, counts, level calls)``."""
    import torch
    from pyitd_tpu_torch.decomp import meitd as pm
    from pyitd_tpu_torch.ops import cuda_cubic as cc
    from pyitd_tpu_torch.ops import cuda_fill as cf
    from pyitd_tpu_torch.ops import wpe as wo

    levels = []
    torch.cuda.synchronize()
    cc.reset_launches()
    cf.reset_launches()
    wo.reset_launches()
    pm.reset_counts()
    with recorded_levels(levels), recorded_cubic({}):
        out = fn()
    torch.cuda.synchronize()
    launches, sift = dict(cc.LAUNCHES), dict(cf.LAUNCHES)
    want = {"level_summaries": len(levels), "tile_scan": len(levels)}
    if (not levels or launches != {k: len(levels) for k in launches}
            or sift != {k: want.get(k, 0) for k in sift}):
        raise AssertionError(f"{len(levels)} cubic levels: launches "
                             f"{launches}, sift kernels {sift}")
    return out, launches, sift, dict(pm.COUNTS, **wo.LAUNCHES), levels


def timed(what: str, fn, card: str, reps: int = 3, tag: str = "10"):
    """Median of ``reps`` CUDA-event times with min and max, device busy
    and idle share, top device kernels; returns the median ms and the
    device time by kernel name.  ``tag``: the phase the lines belong to."""
    times = cuda_times(fn, reps=reps, warmup=1)
    dms, by_name = device_ms(fn, reps=1)
    ms = statistics.median(times)
    print(f"[{tag}] {what}: {ms:.4f} ms (CUDA events, median of {reps}, "
          f"min {times[0]:.4f}, max {times[-1]:.4f}); device busy "
          f"{dms:.4f} ms, idle share {1 - dms / ms:.3f}  [{card}]",
          flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"[{tag}]   top device kernels (ms): " + "; ".join(
        f"{kernel_label(k)} {v:.4f}" for k, v in top), flush=True)
    return ms, by_name


def phase10_meitd(dev, card: str, level_by: dict) -> int:
    """The cubic tier's callers at full width: the 32 x 32,768 ensemble,
    the host walk, the 20 x 256² 2-D ensemble, and the cubic level at the
    MEITD shapes.  ``level_by``: phase 8's device time by kernel name.
    Returns the ensemble's launches of the gate statistics' kernel (one a
    host read and one for the select)."""
    import torch
    from pyitd_tpu_torch import (cubic_baseline_extract, meitd,
                                 meitd_ensemble, meitd_jit, totalextract2d,
                                 xitd)
    from pyitd_tpu_torch.decomp.itd2d import statistical_component
    from pyitd_tpu_torch.tools.level_bench import aten_ops

    t_phase = time.perf_counter()
    reps, n = ENS_SHAPE
    x = torch.from_numpy(ensemble_signal(n)).to(dev)

    def ensemble():
        gen = torch.Generator(device=dev).manual_seed(0)
        return meitd_ensemble(x, gen, reps, noise_scale=0.1)

    # 1. the ensemble: every launch bitwise its plain version, the whole
    # route bitwise the plain route, reconstruction
    res, launches, sift, counts, levels = counted(ensemble)
    rows = sorted(int(np.prod(v.shape[:-1])) for v, _ in levels)
    with plain_cubic():
        same_result(res, ensemble(), "ensemble")
    gen = torch.Generator(device=dev).manual_seed(0)
    v = 0.1 * torch.randn((reps // 2, n), generator=gen, device=dev,
                          dtype=torch.float64)
    bank = torch.cat([x[None] + v, x[None] - v])
    rec = float((res.mean_stack.sum(0) - x).abs().max())
    rec_each = float((res.stacks.sum(1) - bank).abs().max())
    print(f"[10] ensemble {reps} x {n} f64: {counts['trips']} trips, "
          f"{len(levels)} cubic levels (launches {launches}; pre-pass "
          f"{sift}), rows per level min {rows[0]} median "
          f"{statistics.median(rows)} max {rows[-1]}; {counts['reads']} host "
          f"reads, {counts['walk_stats']} walk_stats launches; every cubic "
          f"launch bitwise its plain version, the ensemble "
          f"bitwise the plain route; components "
          f"{res.num_components.tolist()}, selected "
          f"{int(res.selected_index)}, completeness "
          f"{float(res.completeness)!r}; mean stack reconstructs x to "
          f"{rec!r}, each realization its bank row to {rec_each!r}",
          flush=True)
    if not (rec <= 1e-10 and rec_each <= 1e-10):
        raise AssertionError("ensemble reconstruction beyond 1e-10")
    if counts["walk_stats"] != counts["reads"] + 1:
        raise AssertionError(f"{counts['walk_stats']} walk_stats launches "
                             f"for {counts['reads']} reads and the select")
    t_bank, _ = timed(f"ensemble {reps} x {n}", ensemble, card)
    ops = aten_ops(ensemble)
    print(f"[10]   ATen calls: {ops} per ensemble, "
          f"{ops / counts['trips']:.0f} per trip, "
          f"{ops / len(levels):.0f} per cubic level", flush=True)
    one, _, _, c1, l1 = counted(lambda: meitd_jit(x))
    t_one, _ = timed(f"meitd_jit alone, 1 x {n} ({c1['trips']} trips, "
                     f"{len(l1)} cubic levels)", lambda: meitd_jit(x), card)
    print(f"[10] one-at-a-time speedup {reps} * t_one / t_bank = "
          f"{reps * t_one / t_bank:.2f}  [{card}]", flush=True)

    # 2. the host walk on the same signal
    (hi, lo, resid), _, _, ch, lh = counted(lambda: meitd(x))
    with plain_cubic():
        ph, pl, pr = meitd(x)
        px = xitd(x)
    kx = xitd(x)
    for a, b, what in ((hi, ph, "high"), (lo, pl, "low"),
                       (resid, pr, "residual"), (kx, px, "xitd")):
        if not bitwise_equal(a, b):
            raise AssertionError(f"meitd {what} differs from the plain "
                                 f"route, max abs err {max_abs_err(a, b)}")
    hc, lc = int(one.high_count), int(one.low_count)
    if (hc, lc) != (hi.shape[0], lo.shape[0]):
        raise AssertionError(f"meitd counts {hi.shape[0]}, {lo.shape[0]}; "
                             f"meitd_jit {hc}, {lc}")
    gap = max(max_abs_err(hi, one.high[:hc]), max_abs_err(lo, one.low[:lc]),
              max_abs_err(resid, one.residual))
    print(f"[10] meitd 1 x {n}: {hc} + {lc} components, {ch['trips']} trips, "
          f"{len(lh)} cubic levels, {ch['reads']} host reads "
          f"({ch['reads'] / max(ch['trips'], 1):.2f} per trip); meitd and "
          f"xitd bitwise the plain route; against meitd_jit max abs diff "
          f"{gap!r} (limit 1e-9)", flush=True)
    if not gap <= 1e-9:
        raise AssertionError("meitd differs from meitd_jit beyond 1e-9")
    timed(f"meitd 1 x {n}", lambda: meitd(x), card)

    # 3. the 2-D ensemble at full width: 4 batched levels of 20 x 256 rows
    img = torch.from_numpy(tile_2d(TILE_2D)).to(dev)

    def component():
        gen = torch.Generator(device=dev).manual_seed(0)
        return statistical_component(img, gen, ITER_2D)

    low2, launches2, _, _, levels2 = counted(component)
    if [tuple(v.shape) for v, _ in levels2] != [
            (ITER_2D, TILE_2D, TILE_2D)] * 4:
        raise AssertionError(f"2-D levels {[v.shape for v, _ in levels2]}")
    with plain_cubic():
        if not bitwise_equal(low2, component()):
            raise AssertionError("2-D: differs from the plain route")
    worst = 0.0
    for v, kw in levels2:
        got = cubic_baseline_extract(v, TILE_2D + 2, **kw)
        g64 = cubic_baseline_extract(v, TILE_2D + 2, min_extrema=10,
                                     eval_backend="gather")
        worst = max(worst, float((got.baseline - g64.baseline).abs().max())
                    / float(g64.baseline.abs().max()))
    del levels2
    split = totalextract2d(img, torch.Generator(device=dev).manual_seed(0),
                           ITER_2D)
    rec2 = float((split.sum(0) - img).abs().max())
    scale = float(img.abs().max())
    print(f"[10] 2-D statistical_component {ITER_2D} x {TILE_2D}^2 f64: "
          f"launches {launches2}; every launch bitwise its plain version, "
          f"the component bitwise the plain route; each level against the "
          f"f64 gather route within {worst!r} of max|baseline| (limit "
          f"{CUBIC_F64_REL}); totalextract2d reconstructs to {rec2!r} "
          f"(limit 1e-12 * {scale!r})", flush=True)
    if not (worst <= CUBIC_F64_REL and rec2 <= 1e-12 * scale):
        raise AssertionError("2-D beyond its limits")
    _, by2 = timed(f"2-D statistical_component {ITER_2D} x {TILE_2D}^2",
                   component, card)
    useful = 4 * ITER_2D * TILE_2D * TILE_2D
    full = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    for k in ("cubic_ksite", "cubic_neighbors", "spike_factors",
              "spike_backsub", "level_summaries", "tile_scan"):
        d2 = sum(t for name, t in by2.items() if k in name)
        d8 = sum(t for name, t in level_by.items() if k in name)
        print(f"[10]   {k}: {d2 * 1e6 / useful:.4f} ns per useful sample "
              f"in the 2-D levels (rows of {TILE_2D}), {d8 * 1e6 / full:.4f} "
              f"at 8x1M (phase 8)  [{card}]", flush=True)

    # 4. one cubic level at the MEITD shapes, for the short-row route
    for b in (bank, bank[:1]):
        for route in ("fills", "gather"):
            def level(b=b, route=route):
                return cubic_baseline_extract(b, n + 2, min_extrema=0,
                                              eval_backend=route)
            ms, _ = timed(f"cubic level {tuple(b.shape)} f64, {route!r}",
                          level, card, reps=10)
            print(f"[10]   {aten_ops(level)} ATen calls", flush=True)
    print(f"[10] phase 10 took {time.perf_counter() - t_phase:.1f} s (host "
          f"clock)", flush=True)
    return counts["walk_stats"]


# ---- the FFT family: EFD, modified EFD, the ITD-Fourier cascade ----

def efd_signal(rows: int, n: int):
    """The EFD bench's signal (bench.py:219-224), float64."""
    rng = np.random.default_rng(3)
    t = np.linspace(0, 2 * np.pi, n)
    return (np.cos(40 * t[None]) + 0.7 * np.cos(250 * t[None])
            + 0.4 * np.cos(1200 * t[None])
            + 0.1 * rng.normal(size=(rows, n)))


def fourier_signal(n: int, sr: int):
    """The ITD-Fourier bench's signal (bench.py:256-260), float64."""
    rng = np.random.default_rng(4)
    t = np.arange(n) / sr
    return (np.sin(2 * np.pi * 50 * t) + 0.6 * np.sin(2 * np.pi * 220 * t)
            + 0.2 * rng.normal(size=n))


def efd_oracle():
    """``tests/reference/efd_ref.py::efd``, the numpy oracle of EFD."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "reference", "efd_ref.py")
    spec = importlib.util.spec_from_file_location("efd_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.efd


def peak_memory(fn) -> tuple[float, float]:
    """``(peak, peak above what was live before)`` of one call of ``fn``,
    in GB."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return peak / 1e9, (peak - base) / 1e9


@contextlib.contextmanager
def recorded_moments(methods: list):
    """The template tier's moment solves, each recorded by the method it
    resolves to."""
    from pyitd_tpu_torch.ops import cubic_baseline as tcb

    real = tcb.reference_spline_moments

    def fn(knots, h, count, method="auto"):
        methods.append(("affine" if knots.is_cuda else "scan")
                       if method == "auto" else method)
        return real(knots, h, count, method)

    with swapped({"reference_spline_moments": fn}, tcb):
        yield


def drive_cascade(x, sr: int, max_outer: int, keep_modes: bool) -> dict:
    """``itd_fourier_decomposition``'s loop driven by hand for at most
    ``max_outer`` iterations, without its error: the keep masks per
    iteration, the kept mode spectra (with ``keep_modes``) and their sum,
    and the last state (``x == irfft(mode_sum) + current``)."""
    import torch
    from pyitd_tpu_torch.decomp.itd_fourier import cascade_iteration

    keeps, specs, src = [], [], []
    mode_sum = None
    cur, stopped = x, False
    for _ in range(max_outer):
        nxt, is_mode, spectra, rot, res = cascade_iteration(cur, sr)
        keep = is_mode.cpu().numpy()
        keeps.append(keep)
        if not keep.any():
            stopped = True
            break
        kept = spectra[torch.from_numpy(keep).to(spectra.device)]
        mode_sum = kept.sum(0) if mode_sum is None else mode_sum + kept.sum(0)
        if keep_modes:
            specs.append(kept)
            src += np.nonzero(keep)[0].tolist()
        cur = nxt
    return {"keeps": keeps, "specs": torch.cat(specs) if specs else None,
            "src": src, "mode_sum": mode_sum, "current": cur,
            "rotations": rot, "residual": res, "stopped": stopped}


def phase11_efd(dev, card: str) -> None:
    """EFD at 8 x 2^20 with 12 bands in f32 and f64, and modified EFD."""
    import torch
    from pyitd_tpu_torch import efd, iterative_max

    rows, n = EFD_SHAPE
    x64n = efd_signal(rows, n)
    x64 = torch.from_numpy(x64n).to(dev)
    x32 = x64.float()
    res = {}
    for x in (x32, x64):
        what = f"efd {rows} x {n}, {EFD_BANDS} bands, {x.dtype}"
        ms, _ = timed(what, lambda x=x: efd(x, EFD_BANDS), card, reps=10,
                      tag="11")
        peak, extra = peak_memory(lambda x=x: efd(x, EFD_BANDS))
        print(f"[11]   {rows * n / ms / 1e3:.2f} Msamp/s; peak device memory "
              f"{peak:.3f} GB ({extra:.3f} GB above the input)  [{card}]",
              flush=True)
        res[x.dtype] = efd(x, EFD_BANDS)
    r64, r32 = res[torch.float64], res[torch.float32]
    for r in (r32, r64):
        if not (tuple(r.bands.shape) == (rows, EFD_BANDS + 2, n)
                and bool(torch.isfinite(r.bands).all())):
            raise AssertionError(f"efd bands {tuple(r.bands.shape)}, "
                                 "not all finite")

    # f64 row 0 against the numpy oracle: the comparison JAX fails at
    # pyitd_tpu/decomp/efd.py:161 (int32 bounds)
    t0 = time.perf_counter()
    want_bands, want_cerf, want_bn, m = efd_oracle()(x64n[0], EFD_BANDS)
    t_ref = time.perf_counter() - t0
    cnt = int(r64.count[0])
    band_err = max_abs_err(r64.bands[0, :cnt].cpu(),
                           torch.from_numpy(want_bands)) \
        if cnt == want_bands.shape[0] else float("inf")
    cerf_err = max_abs_err(r64.cerf[0, :m].cpu(), torch.from_numpy(want_cerf))
    print(f"[11] f64 row 0 against tests/reference/efd_ref.py ({t_ref:.1f} s "
          f"on the host): count {cnt} (oracle {want_bands.shape[0]}), bands "
          f"max abs err {band_err!r} (limit 1e-8), cerf {cerf_err!r} (limit "
          f"1e-10)", flush=True)
    if not (cnt == want_bands.shape[0] and band_err <= 1e-8
            and cerf_err <= 1e-10):
        raise AssertionError("f64 EFD differs from the oracle")

    # f32 against f64 on the card, row by row; the integer bounds are the
    # normalized ones times half1 / pi
    scale = float(x64.abs().max())
    half1 = round((n // 2 + 1) / 2)

    def int_bounds(r, b):
        return (r.bounds[b].double() * half1 / np.pi).round().long()

    same_rows, worst = 0, 0.0
    for b in range(rows):
        same = (int(r32.count[b]) == int(r64.count[b])
                and torch.equal(int_bounds(r32, b), int_bounds(r64, b)))
        err = max_abs_err(r32.bands[b], r64.bands[b]) / scale
        print(f"[11]   row {b}: f32 count {int(r32.count[b])}, f64 "
              f"{int(r64.count[b])}; bounds {'equal' if same else 'differ'};"
              f" bands max abs diff {err!r} of max|x|", flush=True)
        if same:
            same_rows += 1
            worst = max(worst, err)
    print(f"[11] f32 against f64: {same_rows} of {rows} rows with equal "
          f"bounds, their bands within {worst!r} of max|x| (limit "
          f"{EFD_F32_REL})", flush=True)
    # the bar is held on at least one row (8 of 8 when it was set)
    if not (same_rows >= 1 and worst <= EFD_F32_REL):
        raise AssertionError("f32 EFD: no row with the f64 bounds, or bands "
                             "beyond EFD_F32_REL")
    del res, r32, r64

    # modified EFD on the spectrum of row 0, f64
    row = torch.fft.rfft(x64[0]).real
    ms, _ = timed(f"iterative_max(rfft(x[0]).real, elem=4, comb_size=12), "
                  f"{row.shape[-1]} bins, f64",
                  lambda: iterative_max(row, 4, 12), card, reps=5, tag="11")
    comps = iterative_max(row, 4, 12)
    err = max_abs_err(comps.sum(0), row) / float(row.abs().max())
    print(f"[11] iterative_max: {tuple(comps.shape)}, the components sum to "
          f"the row within {err!r} of max|row| (limit 1e-9)", flush=True)
    if not err <= 1e-9:
        raise AssertionError("iterative_max does not sum to its row")


def phase11_fourier(dev, card: str) -> None:
    """The ITD-Fourier cascade: one iteration at 2^20 in f32, chained;
    the templates; the densest entry's static path; the f64 cascade
    against the CPU and at full length."""
    import torch
    from pyitd_tpu_torch import itd_fourier_decomposition, itd_sine_sift
    from pyitd_tpu_torch.decomp import itd_fourier as tif
    from pyitd_tpu_torch.ops import cubic_baseline as tcb
    from pyitd_tpu_torch.tools.level_bench import aten_ops

    n, sr = FOURIER_N, FOURIER_SR
    x64n = fourier_signal(n, sr)
    x = torch.from_numpy(x64n).to(dev).float()
    scale = float(x.abs().max())

    t0 = time.perf_counter()
    tif.cascade_iteration(x, sr)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    templates = tif._sine_template_static(sr, n)
    print(f"[11] cascade_iteration f32, n = {n}, sr = {sr}: first call "
          f"{first:.2f} s (host clock: the templates, their segment maps, "
          f"their device copies)", flush=True)
    print("[11]   knots per comb frequency: " + ", ".join(
        f"{int(f)} Hz {t.count}" for t, f in
        zip(templates, tif._sine_template_np(sr, n)[2])), flush=True)

    # the chain, with the moment solves recorded by method
    methods = []
    cur, times = x, []
    with recorded_moments(methods):
        for _ in range(FOURIER_CHAIN):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            cur = tif.cascade_iteration(cur, sr)[0]
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    times.sort()
    per_it = statistics.median(times)
    dms, by_name = device_ms(lambda: tif.cascade_iteration(x, sr), reps=3)
    ops = aten_ops(lambda: tif.cascade_iteration(x, sr))
    print(f"[11] {FOURIER_CHAIN} chained iterations: {per_it:.4f} ms per "
          f"iteration (CUDA events, median, min {times[0]:.4f}, max "
          f"{times[-1]:.4f}), {n / per_it / 1e3:.2f} Msamp/s; device busy "
          f"{dms:.4f} ms, idle share {1 - dms / per_it:.3f}; {ops} ATen "
          f"calls per iteration  [{card}]", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print("[11]   top device kernels (ms): " + "; ".join(
        f"{kernel_label(k)} {v:.4f}" for k, v in top), flush=True)
    counts = {m: methods.count(m) for m in sorted(set(methods))}
    print(f"[11]   moment solves by method over the chain: {counts}",
          flush=True)
    if counts != {"banded": FOURIER_CHAIN * len(templates)}:
        raise AssertionError(f"moment solves {counts}")
    if not bool(torch.isfinite(cur).all()):
        raise AssertionError("the chained cascade is not finite")

    rot, res = itd_sine_sift(x, sr)
    rec = max_abs_err(rot.double().sum(0) + res.double(), x.double()) / scale
    print(f"[11] itd_sine_sift f32: {tuple(rot.shape)}, sum(rotations) + "
          f"residual against x within {rec!r} of max|x| (limit "
          f"{SIFT_F32_REL})", flush=True)
    if not rec <= SIFT_F32_REL:
        raise AssertionError("the f32 sine sift does not reconstruct")

    # the densest comb entry's static path: timed, f32 against f64, and
    # under TF32-permitting matmul precision
    tpl = templates[0]
    if tpl.count != DENSEST_KNOTS[(n, sr)]:
        raise AssertionError(f"densest entry: {tpl.count} knots")

    def static(v):
        return tcb._template_fast_baseline_static(v, tpl)

    a = static(x)
    gap = max_abs_err(a.double(), static(x.double())) / scale
    t_a = statistics.median(cuda_times(lambda: static(x)))
    d_a = device_ms(lambda: static(x), reps=3)[0]
    it_ref = tif.cascade_iteration(x, sr)[0]
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        a_high = static(x)
        it_high = tif.cascade_iteration(x, sr)[0]
        kept = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(prev)
    print(f"[11] densest entry ({tpl.count} knots), f32 static path: "
          f"{t_a:.4f} ms (CUDA events, median of 10; device busy "
          f"{d_a:.4f}); against f64 within {gap!r} of max|x| (limit "
          f"{TEMPLATE_F32_REL}); under 'high' matmul precision the baseline "
          f"is {'bitwise' if bitwise_equal(a, a_high) else 'NOT'} unchanged, "
          f"the iteration {'bitwise' if bitwise_equal(it_ref, it_high) else 'NOT'}"
          f" unchanged, and the setting stays {kept!r}  [{card}]", flush=True)
    if not (gap <= TEMPLATE_F32_REL and bitwise_equal(a, a_high)
            and bitwise_equal(it_ref, it_high) and kept == "high"):
        raise AssertionError("densest entry: f32 path or precision")
    del a, a_high, it_ref, it_high, rot, res

    # the f64 cascade at CASCADE_N: the card against the CPU
    xs = fourier_signal(CASCADE_N, sr)
    scale_s = float(np.abs(xs).max())
    t0 = time.perf_counter()
    on = drive_cascade(torch.from_numpy(xs).to(dev), sr, CASCADE_MAX_OUTER,
                       True)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    off = drive_cascade(torch.from_numpy(xs), sr, CASCADE_MAX_OUTER, True)
    t_cpu = time.perf_counter() - t0
    same_keeps = (len(on["keeps"]) == len(off["keeps"]) and all(
        np.array_equal(a, b) for a, b in zip(on["keeps"], off["keeps"])))
    gaps = [max_abs_err(on[k].cpu(), off[k]) / scale_s
            for k in ("current", "rotations", "residual")]
    if on["specs"] is not None and off["specs"] is not None:
        gaps.append(max_abs_err(
            torch.fft.irfft(on["specs"], CASCADE_N).cpu(),
            torch.fft.irfft(off["specs"], CASCADE_N)) / scale_s)
    outcomes = []
    for device in (dev, "cpu"):
        try:
            comps = itd_fourier_decomposition(
                xs, sr, max_outer=CASCADE_MAX_OUTER, device=device)
            outcomes.append(f"{len(comps)} components")
        except RuntimeError as e:  # the cascade's max_outer bound
            outcomes.append(str(e))
    print(f"[11] f64 cascade at n = {CASCADE_N}, sr = {sr}: "
          f"{len(on['keeps'])} iterations on the card ({t_card:.2f} s), "
          f"{len(off['keeps'])} on the CPU ({t_cpu:.2f} s), stopped "
          f"{on['stopped']} / {off['stopped']}; keep masks "
          f"{'equal' if same_keeps else 'DIFFER'} in every iteration; "
          f"{len(on['src'])} / {len(off['src'])} modes; components within "
          f"{max(gaps)!r} of max|x| (limit 1e-10); rotations kept per "
          f"iteration {[int(k.sum()) for k in on['keeps']]}; "
          f"itd_fourier_decomposition: {outcomes[0]!r} on the card, "
          f"{outcomes[1]!r} on the CPU", flush=True)
    if not (same_keeps and len(on["src"]) == len(off["src"])
            and max(gaps) <= 1e-10 and outcomes[0] == outcomes[1]):
        raise AssertionError("the f64 cascade differs between card and CPU")
    del on, off

    # the f64 cascade at full length, driven by hand
    x64 = torch.from_numpy(x64n).to(dev)
    t0 = time.perf_counter()
    full = drive_cascade(x64, sr, CASCADE_MAX_OUTER, False)
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    modes = (torch.fft.irfft(full["mode_sum"], n) if full["mode_sum"]
             is not None else torch.zeros_like(x64))
    rec = max_abs_err(modes + full["current"], x64) / float(x64.abs().max())
    its = len(full["keeps"])
    print(f"[11] f64 cascade at n = {n}, sr = {sr}: "
          + ("stops" if full["stopped"] else "does not stop")
          + f" within {CASCADE_MAX_OUTER} iterations ({its} run, "
          f"{t_full:.2f} s host clock, {t_full / its * 1e3:.1f} ms per "
          f"iteration); rotations kept per iteration "
          f"{[int(k.sum()) for k in full['keeps']]}; modes + current "
          f"reconstruct x within {rec!r} of max|x| (limit 1e-8)  [{card}]",
          flush=True)
    if not rec <= 1e-8:
        raise AssertionError("the f64 cascade does not reconstruct x")


def phase11_fft(dev, card: str) -> None:
    """The FFT family at full width; no kernel of the repo runs in it."""
    from pyitd_tpu_torch.ops import cuda_cubic as cc
    from pyitd_tpu_torch.ops import cuda_fill as cf

    t_phase = time.perf_counter()
    cc.reset_launches()
    cf.reset_launches()
    phase11_efd(dev, card)
    phase11_fourier(dev, card)
    launches = {**cc.LAUNCHES, **cf.LAUNCHES}
    print(f"[11] launches of the repo's kernels in phase 11: {launches}",
          flush=True)
    if any(launches.values()):
        raise AssertionError("the FFT family launched a kernel of the repo")
    print(f"[11] phase 11 took {time.perf_counter() - t_phase:.1f} s (host "
          f"clock)", flush=True)


# ---- the rest of decomp/: streaming, trend, Lindeberg, STIRFT, FABADA,
# SVMD, AFT ----

# the streaming bank: 64 channels of 2^20 samples (21.8 s of 48 kHz audio)
# at the hop of examples/realtime_stream.py:40-41; the IQ bank; the real-time
# step's run of consecutive hops
STREAM_SHAPE, STREAM_SR, STREAM_HOP = (64, 1 << 20), 48_000, 256
IQ_SHAPE, IQ_HOP = (8, 1 << 20), 1024
STEP_HOPS = 1000
# trend and Lindeberg at Untitled35's 48k samples (SURVEY.md:278); STIRFT
TREND_SHAPE = (64, 48_000)
STIRFT_SHAPE, STIRFT_BLOCKS = (64, 1 << 20), 4
# FABADA's image and spectrum; JAX's run of the image on the CPU with x64
# (iterations, PSNR of the input, PSNR of the result, dB), which the card
# must give to 1e-6 dB
FABADA_SIDE, PFABADA_N = 1024, 1 << 16
FABADA_JAX = (347, 24.60190795395912, 44.179894143455876)
# SVMD at PyITD.ipynb's 8k excerpt (SURVEY.md:222).  With 0.1 noise JAX
# extracts 23 modes there; at the card's 0.53 ms per step that is 16 s,
# which the phase's budget does not hold (PERF.md, Findings): the noisy case
# is a CPU test at n = 512 (tests/test_torch_svmd.py)
SVMD_N = 8192
# the AFT's frames: 4,096 frames of 512, held to the FFT within JAX's bar
# (tests/test_aft.py:56) relative to max|X|
AFT_SHAPE, AFT_REL = (4096, 512), 5e-4


def stream_bank(rows: int, n: int):
    """``tests/test_streaming_native.py::chirpy`` at n samples, one seed
    per channel."""
    t = np.linspace(0, 1, n)
    base = np.sin(2 * np.pi * 40 * t * (1 + t))
    return np.stack([base + 0.1 * np.random.default_rng(s).normal(size=n)
                     for s in range(rows)])


def iq_bank(rows: int, n: int):
    """``tests/test_streaming_native.py::iq_pair`` at its density (25
    carrier cycles per 1,024 samples), scaled per channel: joint extrema in
    every window."""
    t = np.arange(n) / 1024
    re = np.cos(2 * np.pi * 25 * t) * (1 + 0.3 * np.sin(2 * np.pi * 2 * t))
    im = 0.7 * re + 0.2 + 0.02 * np.sin(2 * np.pi * 5 * t)
    return np.stack([(re + 1j * im) * (1 + 0.1 * s) for s in range(rows)])


def two_tone(n: int):
    """``tests/test_svmd.py::two_tone``."""
    t = np.arange(n) / n
    return np.cos(2 * np.pi * 11 * t) + 0.6 * np.cos(2 * np.pi * 97 * t)


def inner_hops(x, hop: int):
    """The samples hop t emits, ``x[(t-1)·hop : t·hop]``, hop-major, for
    t >= 2 (zeros before)."""
    nh = x.shape[-1] // hop
    blocks = x[..., :nh * hop].reshape(x.shape[:-1] + (nh, hop))
    return blocks.movedim(-2, 0)[1:nh - 1]


@contextlib.contextmanager
def final_states(module, out: list):
    """Every device loop ``module`` runs, its final state appended to
    ``out``."""
    real = module.run_until

    def spy(step, state, **kw):
        final = real(step, state, **kw)
        out.append(final)
        return final

    with swapped({"run_until": spy}, module):
        yield


def phase12_streaming(dev, card: str) -> None:
    """The streaming tier on the 64 x 2^20 bank and the 8 x 2^20 IQ bank;
    the real-time step; the channel split."""
    import torch
    from pyitd_tpu_torch import (streaming_init, streaming_itd,
                                 streaming_itd_iq, streaming_step)
    from pyitd_tpu_torch.decomp import streaming as ts
    from pyitd_tpu_torch.parallel import sharded_streaming_itd
    from pyitd_tpu_torch.tools.level_bench import aten_ops

    rows, n = STREAM_SHAPE
    hop = STREAM_HOP
    xn = stream_bank(rows, n)
    x = torch.from_numpy(xn).to(dev)
    rot, base, ready = streaming_itd(x, hop)
    nh = n // hop
    if ready[:2].any() or not ready[2:].all() or rot.shape != (nh, rows, hop):
        raise AssertionError(f"streaming: ready flags or shape wrong "
                             f"{tuple(rot.shape)}")
    rebuilt = max_abs_err(rot[2:] + base[2:], inner_hops(x, hop))
    if not rebuilt <= 1e-10:
        raise AssertionError(f"streaming: rot + base vs the inner hop "
                             f"{rebuilt}")
    ms, _ = timed(f"streaming_itd {rows} x {n} f64, hop {hop} ({nh} hops "
                  f"of {3 * hop}-sample windows)",
                  lambda: streaming_itd(x, hop), card, tag="12")
    peak, above = peak_memory(lambda: streaming_itd(x, hop))
    per_batch = max(1, ts._CHUNK_BYTES // (rows * 3 * hop * 8))
    print(f"[12]   {aten_ops(lambda: streaming_itd(x, hop))} ATen calls in "
          f"{-(-nh // per_batch)} batches of {per_batch} hops (no per-hop "
          f"host loop)", flush=True)
    print(f"[12]   {rows * n / ms / 1e3:.1f} Msamp/s, "
          f"{rows * n / STREAM_SR / (ms / 1e3):.0f} channel-seconds of "
          f"{STREAM_SR} Hz audio per second; peak {peak:.3f} GB "
          f"({above:.3f} above the input); rot + base rebuild every ready "
          f"hop within {rebuilt:.3e}  [{card}]", flush=True)
    cpu = streaming_itd(xn[:4], hop, device="cpu")
    b_err = max_abs_err(base[:, :4].cpu(), cpu[1]) / np.abs(xn[:4]).max()
    if not (torch.equal(ready[:, :4].cpu(), cpu[2]) and b_err <= 1e-10):
        raise AssertionError(f"streaming: 4 channels against the CPU, "
                             f"baselines {b_err}")
    print(f"[12]   4 channels against the CPU: ready flags equal, "
          f"baselines within {b_err:.3e} of max|x|", flush=True)
    del cpu

    # the real-time step: consecutive hops on one 64-channel state
    state = streaming_init(hop, (rows,), device=dev)
    hops = x[:, :STEP_HOPS * hop].reshape(rows, STEP_HOPS, hop)
    calls = aten_ops(lambda: streaming_step(state, hops[:, 0], hop))
    times = []
    for k in range(STEP_HOPS):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, r, b, rd = streaming_step(state, hops[:, k], hop)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        if not (torch.equal(r, rot[k]) and torch.equal(b, base[k])
                and torch.equal(rd, ready[k])):
            raise AssertionError(f"streaming_step hop {k} differs from the "
                                 f"replay")
    budget = hop / STREAM_SR * 1e3
    p50, p99 = np.percentile(times, [50, 99])
    STEP_LATENCY.update(p50=float(p50), p99=float(p99))
    print(f"[12] streaming_step x {STEP_HOPS} on {rows} channels: per hop "
          f"p50 {p50:.4f} ms, p99 {p99:.4f} ms, max {max(times):.4f} ms "
          f"(CUDA events, synchronized per hop) against the {budget:.2f} ms "
          f"callback budget (HOP/SR); {calls} ATen calls per hop; every hop "
          f"bitwise the replay's  [{card}]", flush=True)

    split = sharded_streaming_itd([str(dev)], hop)(x)
    if not all(torch.equal(a, b) for a, b in zip(split, (rot, base, ready))):
        raise AssertionError("sharded_streaming_itd differs from the replay")
    print("[12] sharded_streaming_itd(['cuda:0'], 256) bitwise the replay",
          flush=True)
    del x, rot, base, ready, split, hops

    rows, n = IQ_SHAPE
    hop = IQ_HOP
    z = torch.from_numpy(iq_bank(rows, n)).to(dev)
    rot, base, ready = streaming_itd_iq(z, hop)
    rebuilt = max_abs_err(torch.view_as_real(rot[2:] + torch.complex(
        base[2:], base[2:])), torch.view_as_real(inner_hops(z, hop)))
    if ready[:2].any() or not ready[2:].all() or not rebuilt <= 1e-10:
        raise AssertionError(f"streaming IQ: ready flags or rebuild "
                             f"{rebuilt}")
    timed(f"streaming_itd_iq {rows} x {n} complex128, hop {hop}",
          lambda: streaming_itd_iq(z, hop), card, tag="12")
    print(f"[12]   IQ: rot + (1+1j) base rebuild every ready hop within "
          f"{rebuilt:.3e}", flush=True)


def phase12_transforms(dev, card: str) -> None:
    """Trend, the time-causal STFT and STIRFT."""
    import torch
    from pyitd_tpu_torch import (compute_synthesis_window, decompose_signal,
                                 istirft, stirft, time_causal_stft)

    rows, n = TREND_SHAPE
    t = np.linspace(-10, 10, n)
    xn = np.stack([np.sin(t * (1 + 0.01 * s)) + 0.44 * np.cos(7 * t)
                   + 0.01 * np.random.default_rng(s).normal(size=n)
                   for s in range(rows)])
    x = torch.from_numpy(xn).to(dev)
    comps, resid = decompose_signal(x)
    err = max_abs_err(sum(comps) + resid, x)
    if not err <= 1e-10:
        raise AssertionError(f"decompose_signal: rebuild {err}")
    ms, _ = timed(f"decompose_signal {rows} x {n} f64 ({len(comps)} levels)",
                  lambda: decompose_signal(x), card, tag="12")
    print(f"[12]   trend: {len(comps)} levels, components + residual "
          f"rebuild x within {err:.3e}", flush=True)

    s = time_causal_stft(x)
    want = time_causal_stft(xn, device="cpu")
    rel = max(max_abs_err(s[i].cpu(), want[i]) / float(want[i].abs().max())
              for i in range(rows))
    if not rel <= 1e-10:
        raise AssertionError(f"time_causal_stft: card vs CPU {rel}")
    timed(f"time_causal_stft {rows} x {n} f64, defaults "
          f"({tuple(s.shape[1:])} per row)", lambda: time_causal_stft(x),
          card, tag="12")
    print(f"[12]   time_causal_stft against the CPU row by row within "
          f"{rel:.3e} of each row's max|S|", flush=True)
    del x, s, want

    rows, n = STIRFT_SHAPE
    win = compute_synthesis_window(np.hanning(512), 128)
    x = torch.from_numpy(stream_bank(rows, n)).to(dev)
    x32, win32 = x.float(), torch.from_numpy(win).float().to(dev)
    sx = stirft(x32, win32)
    timed(f"stirft {rows} x {n} f32, n_fft 512, hop 128 "
          f"({sx.shape[-1]} frames a row)", lambda: stirft(x32, win32),
          card, tag="12")
    bars = {}
    for name, frames, dt in (("f32", sx[0], torch.float32),
                             ("f64", stirft(x[0], torch.from_numpy(win).to(
                                 dev)), torch.float64)):
        syn = torch.from_numpy(np.hanning(512) * 2).to(dev, dt)
        zero = torch.zeros(384, dtype=dt, device=dev)
        whole, whole_buf = istirft(frames, zero, syn)
        buf, outs = zero, []
        for blk in torch.arange(frames.shape[1], device=dev).tensor_split(
                STIRFT_BLOCKS):
            out, buf = istirft(frames[:, blk], buf, syn)
            outs.append(out)
        scale = float(x[0].abs().max())
        bars[name] = max(max_abs_err(torch.cat(outs), whole),
                         max_abs_err(buf, whole_buf)) / scale
    if not (bars["f32"] <= 1e-6 and bars["f64"] <= 1e-12):
        raise AssertionError(f"istirft: chained blocks vs one call {bars}")
    timed(f"istirft of one channel's {sx.shape[-1]} frames (f32)",
          lambda: istirft(sx[0], torch.zeros(384, device=dev),
                          torch.from_numpy(np.hanning(512) * 2).float().to(
                              dev)), card, tag="12")
    print(f"[12]   istirft in {STIRFT_BLOCKS} chained blocks against one "
          f"call, output and buffer, of max|x|: f32 {bars['f32']:.3e}, f64 "
          f"{bars['f64']:.3e}", flush=True)


def phase12_denoise(dev, card: str) -> None:
    """FABADA of a 1,024² image, PFABADA of a 2^16 spectrum, SVMD at 8k."""
    import torch
    from pyitd_tpu_torch import pfabada, psnr, svmd
    from pyitd_tpu_torch.decomp import fabada as tf
    from pyitd_tpu_torch.decomp import svmd as tv
    from pyitd_tpu_torch.tools.level_bench import aten_ops
    from pyitd_tpu_torch.utils import device_loop as dl

    side = FABADA_SIDE
    yy, xx = np.mgrid[0:side, 0:side]
    clean = 127.5 + 100 * np.sin(xx / 37) * np.cos(yy / 53)
    img = clean + 15 * np.random.default_rng(0).normal(size=clean.shape)
    x = torch.from_numpy(img).to(dev)
    cl = torch.from_numpy(clean).to(dev)
    states = []
    dl.reset_runs()
    with final_states(tf, states):
        rec = tf.fabada(x, 225.0)
    its, run = int(states[-1]["iteration"]), dl.RUNS[-1]
    p_in, p_out = float(psnr(x, cl)), float(psnr(rec, cl))
    if not (its == FABADA_JAX[0] and abs(p_in - FABADA_JAX[1]) <= 1e-6
            and abs(p_out - FABADA_JAX[2]) <= 1e-6
            and run["graph"] == x.is_cuda):
        raise AssertionError(f"fabada: {its} iterations, PSNR {p_in} -> "
                             f"{p_out}, {run}; JAX {FABADA_JAX}")
    ms, _ = timed(f"fabada {side} x {side} f64 (graph of {tf._BLOCK} "
                  f"iterations)", lambda: tf.fabada(x, 225.0), card, tag="12")
    # the eager loop on the card: one host read per iteration, bitwise
    dl.GRAPHS = False
    try:
        tf._BLOCK, block = 1, tf._BLOCK
        ops = aten_ops(lambda: tf.fabada(x, 225.0))
        eager = tf.fabada(x, 225.0)
        eager_ms = statistics.median(cuda_times(lambda: tf.fabada(x, 225.0),
                                                reps=1, warmup=0))
    finally:
        dl.GRAPHS, tf._BLOCK = True, block
    if not bitwise_equal(rec, eager):
        raise AssertionError("fabada: the graph differs from the eager loop")
    print(f"[12]   fabada: {its} iterations, {run['reads']} host reads "
          f"({run['steps']} steps), PSNR {p_in:.6f} -> {p_out:.6f} dB (JAX "
          f"on the CPU: {FABADA_JAX[0]}, {FABADA_JAX[1]:.6f} -> "
          f"{FABADA_JAX[2]:.6f}); {ms / run['steps']:.4f} ms per step; "
          f"bitwise the per-iteration eager loop ({eager_ms:.1f} ms, "
          f"{ops / its:.0f} ATen calls per iteration)  [{card}]",
          flush=True)

    t = np.linspace(0, 1, PFABADA_N)
    spec = (80 * np.exp(-((t - 0.3) ** 2) / 0.002)
            + 50 * np.exp(-((t - 0.6) ** 2) / 0.005)
            + 10 * np.random.default_rng(2).normal(size=t.size))
    got = pfabada(torch.from_numpy(spec).to(dev), 10.0)
    want = pfabada(spec, 10.0, device="cpu")
    err = max_abs_err(got.cpu(), want) / float(want.abs().max())
    if not err <= 1e-12:
        raise AssertionError(f"pfabada: card vs CPU {err}")
    timed(f"pfabada of {PFABADA_N} points", lambda: pfabada(
        torch.from_numpy(spec).to(dev), 10.0), card, tag="12")
    print(f"[12]   pfabada: card vs CPU within {err:.3e} of max|x|, "
          f"{dl.RUNS[-1]['reads']} host reads", flush=True)

    sig = two_tone(SVMD_N)
    modes = []
    dl.reset_runs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with final_states(tv, modes):
        u, _, om = svmd(sig, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runs = list(dl.RUNS)
    inner = [int(m["inner"]) for m in modes]
    # device time over the first two modes (a whole run is ~10^5 kernels)
    dl.reset_runs()
    dms, _ = device_ms(lambda: svmd(sig, max_modes=2, device=dev), reps=1)
    two = sum(r["steps"] for r in dl.RUNS) // 2
    uc, _, omc = svmd(sig, device="cpu")
    om_err = float(np.abs(om - omc).max()) if om.shape == omc.shape \
        else float("inf")
    if not (u.shape == uc.shape and om_err <= 1e-10
            and np.abs(u - uc).max() <= 1e-9
            and all(r["graph"] == (dev.type == "cuda") for r in runs)):
        raise AssertionError(f"svmd: card {u.shape} {om} vs CPU {uc.shape} "
                             f"{omc}, max {np.abs(u - uc).max()}")
    steps = sum(r["steps"] for r in runs)
    per_step = wall * 1e3 / steps
    print(f"[12] svmd of {SVMD_N} f64 (two tones, defaults): {len(om)} modes, "
          f"omega {np.array2string(om, precision=5)}; inner steps per mode "
          f"{inner}, host reads per mode {[r['reads'] for r in runs]}; "
          f"{wall * 1e3:.1f} ms ({wall * 1e3 / len(om):.1f} per mode, "
          f"{per_step:.4f} per step, host clock); device busy of the first "
          f"two modes {dms:.4f} ms in {two} steps; "
          f"the CPU's mode count, omega within {om_err:.3e}, modes within "
          f"{np.abs(u - uc).max():.3e}"
          f"  [{card}]", flush=True)
    # the blocked graph bitwise the per-iteration eager loop, two modes
    dl.GRAPHS = False
    try:
        tv._BLOCK, block = 1, tv._BLOCK
        ue, _, ome = svmd(sig, max_modes=2, device=dev)
    finally:
        dl.GRAPHS, tv._BLOCK = True, block
    ug, _, omg = svmd(sig, max_modes=2, device=dev)
    if not (np.array_equal(ug, ue) and np.array_equal(omg, ome)):
        raise AssertionError("svmd: the graph differs from the eager loop")
    print("[12]   svmd's first two modes: the graph bitwise the "
          "per-iteration eager loop", flush=True)


def phase12_aft(dev, card: str) -> None:
    """The accumulator and hierarchical DFTs of 4,096 x 512 f32 frames."""
    import torch
    from pyitd_tpu_torch.decomp.aft import accumulator_dft, hierarchical_dft

    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=AFT_SHAPE).astype(np.float32)).to(dev)
    want = torch.fft.fft(x.double())
    scale = float(want.abs().max())
    errs = {}
    for name, fn in (("accumulator_dft", accumulator_dft),
                     ("hierarchical_dft", hierarchical_dft)):
        errs[name] = max_abs_err(torch.view_as_real(fn(x).to(want.dtype)),
                                 torch.view_as_real(want)) / scale
        timed(f"{name} of {AFT_SHAPE[0]} x {AFT_SHAPE[1]} f32 frames",
              lambda f=fn: f(x), card, tag="12")
    if not all(e <= AFT_REL for e in errs.values()):
        raise AssertionError(f"AFT against the FFT: {errs}")
    before = torch.get_float32_matmul_precision()
    ref = hierarchical_dft(x)
    torch.set_float32_matmul_precision("high")
    try:
        high = hierarchical_dft(x)
    finally:
        torch.set_float32_matmul_precision(before)
    if not bitwise_equal(torch.view_as_real(high), torch.view_as_real(ref)):
        raise AssertionError("hierarchical_dft changes under 'high' matmul "
                             "precision")
    print(f"[12]   AFT against torch.fft.fft, of max|X|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + "; hierarchical_dft bitwise the same under 'high' matmul "
          "precision", flush=True)


def phase12_decomp(dev, card: str) -> None:
    """The rest of decomp/ at full size; no kernel of the repo runs in it."""
    from pyitd_tpu_torch.ops import cuda_cubic as cc
    from pyitd_tpu_torch.ops import cuda_fill as cf

    t_phase = time.perf_counter()
    cc.reset_launches()
    cf.reset_launches()
    took = {}
    for part in (phase12_streaming, phase12_transforms, phase12_denoise,
                 phase12_aft):
        t0 = time.perf_counter()
        part(dev, card)
        took[part.__name__] = time.perf_counter() - t0
    launches = {k: v for k, v in {**cc.LAUNCHES, **cf.LAUNCHES}.items() if v}
    print(f"[12] launches of the repo's kernels in phase 12: {launches}",
          flush=True)
    if launches:
        raise AssertionError("phase 12 launched a kernel of the repo")
    print(f"[12] phase 12 took {time.perf_counter() - t_phase:.1f} s (host "
          f"clock): " + ", ".join(f"{k} {v:.1f} s" for k, v in took.items())
          + f"  [{card}]", flush=True)


def gpt_step(model, opt, x, y):
    """One training step; returns the loss, not read back."""
    opt.zero_grad(set_to_none=True)
    loss = model(x, y)[1]
    loss.backward()
    opt.step()
    return loss.detach()


def gpt_model(dev, dtype):
    """ParsevalGPT at GPTConfig() (with ``ML_CONFIG``'s overrides), its
    weights drawn on the CPU from ``ML_SEED`` and moved to ``dev``."""
    import torch
    from pyitd_tpu_torch.ml import GPTConfig, ParsevalGPT

    model = ParsevalGPT(GPTConfig(**ML_CONFIG), device="cpu", dtype=dtype,
                        generator=torch.Generator().manual_seed(ML_SEED))
    return model.to(dev)


def gpt_batches(dev, n: int) -> list:
    """``n`` batches of ``ML_BATCH`` x block_size tokens drawn by
    ``BatchSampler`` from examples/train_parallel.py's stream (a 17-token
    motif, 15% substitutions) over the config's vocabulary."""
    from pyitd_tpu_torch.examples.train_tiny import make_stream
    from pyitd_tpu_torch.ml import BatchSampler, GPTConfig

    cfg = GPTConfig(**ML_CONFIG)
    sampler = BatchSampler(make_stream(400_000, vocab=cfg.vocab_size),
                           cfg.block_size, ML_BATCH, seed=1, device=dev)
    return [sampler.sample() for _ in range(n)]


def card_against_cpu(dev, batch, card: str) -> None:
    """Step 0's loss and gradient on the card against the CPU, from the
    same initial weights and batch, in f64 and f32."""
    import torch

    for dtype in (torch.float64, torch.float32):
        grads = []
        for where in (torch.device("cpu"), dev):
            model = gpt_model(where, dtype)
            loss = model(batch[0].to(where), batch[1].to(where))[1]
            loss.backward()
            grads.append((loss.item(), [p.grad.detach().cpu().double()
                                        for p in model.parameters()]))
        (lc, gc), (lg, gg) = grads
        gmax = max(float(g.abs().max()) for g in gc)
        gap = max(float((a - b).abs().max()) for a, b in zip(gg, gc)) / gmax
        name = str(dtype).split(".")[-1]
        print(f"[13] ParsevalGPT step 0 {name}, card against CPU: loss "
              f"{lg!r} against {lc!r}; gradient max|diff| {gap:.3e} of "
              f"max|g| {gmax:.4e} (bar {ML_CARD_REL[name]:g})  [{card}]",
              flush=True)
        if not (gap <= ML_CARD_REL[name]
                and abs(lg - lc) <= ML_CARD_REL[name] * abs(lc)):
            raise AssertionError(f"ParsevalGPT {name}: card against CPU "
                                 f"gradient {gap}, loss {lg} / {lc}")


def optimizer_leaves(opt) -> list:
    """The tensors of an optimizer's state, in a fixed order."""
    import torch

    return [v for st in opt.state_dict()["state"].values()
            for _, v in sorted(st.items()) if isinstance(v, torch.Tensor)]


def phase13_gpt(dev, card: str) -> list:
    """ParsevalGPT at T.py's width: training, its timing, card against
    CPU, and the checkpoint resume.  Returns the parameters after the run
    without interruption."""
    import tempfile
    import warnings

    import torch
    from pyitd_tpu_torch.ml import GPTConfig, restore_state, save_state
    from pyitd_tpu_torch.tools.level_bench import aten_ops

    cfg = GPTConfig(**ML_CONFIG)
    batches = gpt_batches(dev, ML_STEPS)
    card_against_cpu(dev, batches[0], card)
    tokens = ML_BATCH * cfg.block_size

    def fresh():
        model = gpt_model(dev, torch.float32)
        return model, torch.optim.Adam(model.parameters(), 3e-3)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            # the run without interruption, each step timed
            model, opt = fresh()
            n_params = sum(p.numel() for p in model.parameters())
            losses, times = [], []
            for x, y in batches:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                losses.append(gpt_step(model, opt, x, y))
                end.record()
                times.append((start, end))
            torch.cuda.synchronize()
            ms = sorted(a.elapsed_time(b) for a, b in times[ML_WARMUP:])
            losses = torch.stack(losses).tolist()
            # the same steps with a checkpoint and a restore on the way
            part, popt = fresh()
            for x, y in batches[:ML_CKPT_STEP]:
                gpt_step(part, popt, x, y)
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "ckpt")
                save_state(path, {"model": part.state_dict(),
                                  "opt": popt.state_dict(),
                                  "step": ML_CKPT_STEP})
                del part, popt
                resumed, ropt = fresh()
                out = restore_state(path, {"model": resumed.state_dict(),
                                           "opt": ropt.state_dict(),
                                           "step": 0})
            resumed.load_state_dict(out["model"])
            ropt.load_state_dict(out["opt"])
            for x, y in batches[out["step"]:]:
                gpt_step(resumed, ropt, x, y)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    loose = sorted({str(w.message).split(".")[0] for w in caught
                    if "deterministic" in str(w.message)})
    if not all(np.isfinite(losses)):
        raise AssertionError(f"ParsevalGPT losses {losses}")
    if not np.mean(losses[-10:]) < losses[0]:
        raise AssertionError(f"ParsevalGPT loss did not fall: {losses}")
    med = statistics.median(ms)
    print(f"[13] ParsevalGPT {cfg} f32, {n_params} parameters, batch "
          f"{ML_BATCH} x {cfg.block_size}: {ML_STEPS} Adam(3e-3) steps, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of the last 10 "
          f"{np.mean(losses[-10:]):.4f}); {med:.4f} ms per step (CUDA events "
          f"after {ML_WARMUP} warm-up steps, median of {len(ms)}, min "
          f"{ms[0]:.4f}, max {ms[-1]:.4f}), {tokens / med * 1e3:.0f} tokens "
          f"per second  [{card}]", flush=True)
    final = [p.detach().clone() for p in model.parameters()]
    pairs = (list(zip(model.parameters(), resumed.parameters()))
             + list(zip(optimizer_leaves(opt), optimizer_leaves(ropt))))
    if loose:
        pmax = max(float(p.detach().abs().max()) for p, _ in pairs)
        gap = max(float((a.detach().double() - b.detach().double()).abs()
                        .max()) for a, b in pairs) / pmax
        ok, how = gap <= 1e-6, f"within {gap:.3e} of max|p| (bar 1e-6)"
    else:
        ok = all(torch.equal(a, b) for a, b in pairs)
        how = "bitwise"
    print(f"[13] checkpoint at step {ML_CKPT_STEP} (save_state, "
          f"restore_state into a fresh model and Adam), run to step "
          f"{ML_STEPS}: {len(pairs)} parameter and optimizer tensors {how} "
          f"those of the run without the restore; ops without a "
          f"deterministic CUDA version: {loose or 'none'}", flush=True)
    if not ok:
        raise AssertionError("ParsevalGPT: the resumed run differs")

    x, y = batches[0]
    step = lambda: gpt_step(model, opt, x, y)  # noqa: E731
    dms, by_name = device_ms(step)
    calls = aten_ops(step)
    peak, above = peak_memory(step)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"[13] ParsevalGPT step: device busy {dms:.4f} ms, idle share "
          f"{1 - dms / med:.3f}; {calls} ATen calls per step "
          f"({med / calls * 1e3:.1f} us of step time a call); peak memory "
          f"{peak:.3f} GB ({above:.3f} above what was live)  [{card}]",
          flush=True)
    print("[13]   top device kernels (ms per step): " + "; ".join(
        f"{kernel_label(k)} {v:.4f}" for k, v in top), flush=True)
    return final


def phase13_ml(dev, card: str) -> list:
    """The ML trainers at full width; no kernel of the repo runs in it.
    Returns ParsevalGPT's parameters after its uninterrupted run."""
    import torch
    from pyitd_tpu_torch.examples import train_tiny
    from pyitd_tpu_torch.ops import cuda_cubic as cc
    from pyitd_tpu_torch.ops import cuda_fill as cf

    t_phase = time.perf_counter()
    cc.reset_launches()
    cf.reset_launches()
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")  # no TF32
    try:
        final = phase13_gpt(dev, card)
        t0 = time.perf_counter()
        out = train_tiny.train(TINY_STEPS, dev, log=lambda line: print(
            f"[13] tiny LM {line}", flush=True))
    finally:
        torch.set_float32_matmul_precision(before)
    print(f"[13] tiny LM (vocab {train_tiny.VOCAB}, dim {train_tiny.DIM}, "
          f"block {train_tiny.BLOCK}, batch {train_tiny.BATCH}): "
          f"{TINY_STEPS} Wolf steps beside the unigram, "
          f"{out['ms_per_step']:.4f} ms per step (host clock, both models "
          f"and the dashboard, the loss read every step; "
          f"{time.perf_counter() - t0:.1f} s); last loss {out['loss']:.4f} "
          f"against the unigram's {out['unigram_loss']:.4f}  [{card}]",
          flush=True)
    if not out["loss"] < out["unigram_loss"]:
        raise AssertionError("the tiny LM did not beat the unigram")
    launches = {k: v for k, v in {**cc.LAUNCHES, **cf.LAUNCHES}.items() if v}
    print(f"[13] launches of the repo's kernels in phase 13: "
          f"{sum(launches.values())}", flush=True)
    if launches:
        raise AssertionError(f"phase 13 launched kernels of the repo: "
                             f"{launches}")
    print(f"[13] phase 13 took {time.perf_counter() - t_phase:.1f} s (host "
          f"clock)  [{card}]", flush=True)
    return final


# phase 14: BlockFastLM at its full width (blockfast.py:89-96: 64 features,
# 2 layers, 4 heads; vocabulary 256 as GPTConfig()) trained BF_STEPS Adam
# steps on phase 13's batches, then serving SERVE_BATCH requests of a
# SERVE_PROMPT-token prompt and SERVE_NEW greedy tokens; the step path held
# to the full forward after the warm-up, JAX's 3 * (n_head + 1) per layer
# (the cold start runs through the stack), and SERVE_CPU_TOKENS tokens of
# each request against the CPU; then training over a one-rank DeviceMesh:
# ParsevalGPT at GPTConfig() in f32 and bf16, ModCRTMoE (MOE_EXPERTS
# experts, width MOE_WIDTH, capacity dispatch) on MOE_TOKENS tokens with a
# checkpoint at MOE_CKPT_STEP, BlockFastGPT at its defaults (vte.py:418-427)
# for VTE_STEPS steps, and gpipe_apply at pp = 1 over PIPE_MICRO
# microbatches
BF_CONFIG = dict(n_embd=64, n_layer=2, n_head=4)
BF_STEPS = 60
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_CPU_TOKENS = 32, 256, 256, 8
SERVE_ATOL = 1e-4  # tests/test_blockfast.py:67
MOE_EXPERTS, MOE_WIDTH, MOE_TOKENS = 8, 64, (32, 256)
MOE_STEPS, MOE_CKPT_STEP = 60, 30
VTE_BATCH, VTE_STEPS = 32, 10
VTE_CONFIG: dict = {}  # BlockFastGPT overrides (none: its defaults)
PIPE_MICRO = 8
# a gap as a fraction of max|value| that counts as equal where no op
# has a deterministic CUDA version (phase 13's bar)
LOOSE_REL = 1e-6


def events_ms(fn, n: int) -> list:
    """Each of ``n`` calls of ``fn`` timed by CUDA events, sorted (ms)."""
    import torch

    marks = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in marks)


def full_params(module) -> list:
    """``module``'s parameters as plain tensors (a DTensor's whole
    value)."""
    from torch.distributed.tensor import DTensor

    return [(p.full_tensor() if isinstance(p, DTensor) else p).detach()
            for p in module.parameters()]


def same_or_close(got: list, want: list) -> tuple[bool, str]:
    """Bitwise, or the largest gap as a fraction of max|want|."""
    import torch

    if all(bitwise_equal(a, b) for a, b in zip(got, want)):
        return True, "bitwise"
    scale = max(float(b.abs().max()) for b in want)
    gap = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(got, want)) / scale
    return gap <= LOOSE_REL, f"within {gap:.3e} of max|p| (bar {LOOSE_REL})"


def grads_of(model, loss_fn) -> tuple[list, float]:
    """Gradients of ``loss_fn(model)`` (their plain values on the CPU in
    f64) and the loss."""
    import torch

    for p in model.parameters():
        p.grad = None
    loss = loss_fn(model)
    loss.backward()
    grads = [(g.full_tensor() if hasattr(g, "full_tensor") else g)
             .detach().cpu().double()
             for g in (p.grad for p in model.parameters())]
    for p in model.parameters():
        p.grad = None
    return grads, loss.item()


def held_to_cpu(what, card_grads, cpu_grads, rel, card,
                names=None) -> None:
    gmax = max(float(g.abs().max()) for g in cpu_grads)
    gaps = [float((a - b).abs().max()) / gmax
            for a, b in zip(card_grads, cpu_grads)]
    gap = max(gaps)
    worst = "" if names is None else f", largest at {names[gaps.index(gap)]}"
    print(f"[14] {what} step 0, card against CPU: gradient max|diff| "
          f"{gap:.3e} of max|g| {gmax:.4e} (bar {rel:g}){worst}  [{card}]",
          flush=True)
    if not gap <= rel:
        raise AssertionError(f"{what}: card against CPU gradient {gap}")


def phase14_serve(dev, card: str) -> None:
    """BlockFastLM trained, then served token by token."""
    import copy

    import torch
    from pyitd_tpu_torch.ml import BlockFastLM, GPTConfig
    from pyitd_tpu_torch.tools.level_bench import aten_ops

    vocab = GPTConfig(**ML_CONFIG).vocab_size
    model = BlockFastLM(vocab, **BF_CONFIG, device="cpu",
                        generator=torch.Generator().manual_seed(ML_SEED)
                        ).to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    batches = gpt_batches(dev, BF_STEPS + 1)
    opt = torch.optim.Adam(model.parameters(), 3e-3)
    t0 = time.perf_counter()
    losses = [gpt_step(model, opt, x, y) for x, y in batches[:-1]]
    losses = torch.stack(losses).tolist()
    train_s = time.perf_counter() - t0
    if not (all(np.isfinite(losses))
            and np.mean(losses[-10:]) < losses[0]):
        raise AssertionError(f"BlockFastLM loss did not fall: {losses}")
    print(f"[14] BlockFastLM {BF_CONFIG} vocab {vocab}, {n_params} "
          f"parameters: {BF_STEPS} Adam(3e-3) steps on {ML_BATCH} x "
          f"{batches[0][0].shape[1]} batches, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (mean of the last 10 "
          f"{np.mean(losses[-10:]):.4f}); {train_s * 1e3 / BF_STEPS:.2f} ms "
          f"per step (host clock)  [{card}]", flush=True)

    b, p, n = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    prompts = batches[-1][0][:b, :p]
    model.eval()
    with torch.no_grad():
        states = model.init_state(b)
        inputs, hidden, logits, marks = [], [], [], []
        tok = prompts[:, 0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        wall = time.perf_counter()
        for k in range(p + n):
            inp = prompts[:, k] if k < p else tok
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            states, h, lg = model.step(states, inp)
            tok = lg.argmax(-1)
            end.record()
            marks.append((start, end))
            inputs.append(inp)
            hidden.append(h)
            logits.append(lg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall
        peak = (torch.cuda.max_memory_allocated() - live) / 1e9
        ms = sorted(a.elapsed_time(c) for a, c in marks)
        seq = torch.stack(inputs, 1)  # (b, p + n): prompt, then generated
        generated = seq[:, p:]
        hidden, logits = torch.stack(hidden, 1), torch.stack(logits, 1)

        def one_step():
            model.step(states, tok)[2].argmax(-1)

        calls = aten_ops(one_step)
        dms, _ = device_ms(one_step)
        # the full forward on the same sequences
        x = model.wte(seq)
        for blk in model.blocks():
            x = blk(x)
        full_logits = model.lm_head(x)
    warm = 3 * (BF_CONFIG["n_head"] + 1) * BF_CONFIG["n_layer"]
    h_gap = float((hidden - x)[:, warm:].abs().max())
    l_gap = float((logits - full_logits)[:, warm:].abs().max())
    early = float((logits - full_logits)[:, :warm].abs().max())
    med = statistics.median(ms)
    print(f"[14] served {b} requests x ({p} prompt + {n} generated) tokens "
          f"through blockfast_step: per-token step p50 {med:.4f} ms, p99 "
          f"{ms[int(0.99 * (len(ms) - 1))]:.4f}, min {ms[0]:.4f}, max "
          f"{ms[-1]:.4f} (CUDA events, {len(ms)} steps of {b} tokens); "
          f"{b / med * 1e3:.0f} tokens/s at p50, {b * (p + n) / wall:.0f} "
          f"tokens/s over the whole run ({wall:.3f} s host clock, argmax "
          f"included); {calls} ATen calls per step ({med / calls * 1e3:.1f} "
          f"us of step time a call); device busy {dms:.4f} ms per step, "
          f"idle share {1 - dms / med:.3f}; peak memory {peak:.4f} GB above "
          f"what was live  [{card}]", flush=True)
    print(f"[14] step path against the full BlockFastLM forward on the same "
          f"{p + n} tokens, from position {warm} (3 * (n_head + 1) per "
          f"layer): hidden max|diff| {h_gap:.3e}, logits {l_gap:.3e} (bar "
          f"{SERVE_ATOL:g}); before it {early:.3e} (the cold start)  "
          f"[{card}]", flush=True)
    if not (h_gap <= SERVE_ATOL and l_gap <= SERVE_ATOL):
        raise AssertionError(f"BlockFastLM step against full: {h_gap}, "
                             f"{l_gap}")
    # the first tokens of each request against the CPU, teacher-forced
    cpu = copy.deepcopy(model).cpu()
    m = SERVE_CPU_TOKENS
    with torch.no_grad():
        st = cpu.init_state(b)
        seq_cpu = seq[:, :p + m].cpu()
        out = []
        for k in range(p + m - 1):
            st, _, lg = cpu.step(st, seq_cpu[:, k])
            if k >= p - 1:
                out.append(lg.argmax(-1))
    cpu_tokens = torch.stack(out, 1)
    card_tokens = generated[:, :m].cpu()
    differ = card_tokens != cpu_tokens
    # a differing token is allowed only at a near tie of the card's logits
    lg_card = logits[:, p - 1:p - 1 + m].cpu()
    pick = lg_card.gather(-1, card_tokens[..., None])[..., 0]
    alt = lg_card.gather(-1, cpu_tokens[..., None])[..., 0]
    ties = (pick - alt).abs() <= SERVE_ATOL
    print(f"[14] first {m} generated tokens of each of {b} requests, card "
          f"against CPU (same weights, teacher-forced): "
          f"{int(differ.sum())} of {differ.numel()} differ, "
          f"{int((differ & ~ties).sum())} of them outside a near tie of the "
          f"logits ({SERVE_ATOL:g})  [{card}]", flush=True)
    if (differ & ~ties).any():
        raise AssertionError("BlockFastLM: card and CPU tokens differ")


def phase14_gpt(dev, card: str, mesh, gpt_final: list) -> None:
    """ParsevalGPT at GPTConfig() through make_train_step in f32 (against
    phase 13's plain loop) and bf16."""
    import warnings

    import torch
    from pyitd_tpu_torch.ml import GPTConfig
    from pyitd_tpu_torch.parallel.train import (PARSEVAL_TP_RULES,
                                                make_train_step,
                                                param_groups, shard_batch,
                                                shard_params)
    from pyitd_tpu_torch.tools.level_bench import aten_ops
    from torch.func import functional_call

    cfg = GPTConfig(**ML_CONFIG)
    batches = gpt_batches(dev, ML_STEPS)
    tokens = ML_BATCH * cfg.block_size
    for cd in (None, torch.bfloat16):
        model = gpt_model(dev, torch.float32)
        shard_params(model, mesh, PARSEVAL_TP_RULES)
        opt = torch.optim.Adam(param_groups(model), 3e-3)
        step = make_train_step(
            lambda q, b_: functional_call(model, q, b_)[1], opt, mesh,
            model, compute_dtype=cd)
        it = iter(batches)
        torch.use_deterministic_algorithms(cd is None, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                losses = []
                ms = events_ms(lambda: losses.append(
                    step(shard_batch(next(it), mesh))), len(batches))
        finally:
            torch.use_deterministic_algorithms(False)
        losses = torch.stack(losses).float().tolist()
        loose = sorted({str(w.message).split(".")[0] for w in caught
                        if "deterministic" in str(w.message)})
        med = statistics.median(ms[:len(ms) - ML_WARMUP])
        name = "f32" if cd is None else "bf16 compute"
        params = full_params(model)
        if not (all(np.isfinite(losses))
                and np.mean(losses[-10:]) < losses[0]):
            raise AssertionError(f"make_train_step {name}: {losses}")
        if cd is None:
            ok, how = same_or_close(params, gpt_final)
            verdict = (f"parameters {how} phase 13's plain Adam loop "
                       f"after {ML_STEPS} steps; ops without a "
                       f"deterministic CUDA version: {loose or 'none'}")
        else:
            ok = all(p.dtype == torch.float32 for p in params) and all(
                v.dtype == torch.float32 for st in opt.state.values()
                for v in st.values() if v.is_floating_point())
            verdict = "master weights and Adam state f32"
        y = batches[0]
        calls = aten_ops(lambda: step(shard_batch(y, mesh)))
        dms, _ = device_ms(lambda: step(shard_batch(y, mesh)))
        print(f"[14] ParsevalGPT {name} through make_train_step on the "
              f"(data 1, model 1) {torch.distributed.get_backend()} mesh, "
              f"PARSEVAL_TP_RULES: loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; {med:.4f} ms per step "
              f"(CUDA events, median of all but the slowest "
              f"{ML_WARMUP}, min {ms[0]:.4f}, max {ms[-1]:.4f}), "
              f"{tokens / med * 1e3:.0f} tokens/s, {calls} ATen calls per "
              f"step, device busy {dms:.4f} ms, idle share "
              f"{1 - dms / med:.3f}; {verdict}  [{card}]", flush=True)
        if not ok:
            raise AssertionError(f"make_train_step {name}: {verdict}")


def phase14_moe(dev, card: str, mesh) -> None:
    """ModCRTMoE expert-parallel: capacity against gather, step 0 against
    the CPU, training with a checkpoint resumed bitwise."""
    import tempfile
    import warnings

    import torch
    from pyitd_tpu_torch.ml import ModCRTMoE, restore_state, save_state
    from pyitd_tpu_torch.parallel.train import (MOE_EP_RULES,
                                                make_train_step,
                                                param_groups, shard_batch,
                                                shard_params)
    from pyitd_tpu_torch.tools.level_bench import aten_ops
    from torch.distributed.checkpoint.state_dict import (
        get_optimizer_state_dict, set_optimizer_state_dict)
    from torch.func import functional_call

    rng = np.random.default_rng(ML_SEED + 14)
    x = torch.from_numpy(rng.normal(size=MOE_TOKENS + (MOE_WIDTH,)).astype(
        np.float32)).to(dev)

    def build(where, dispatch="capacity"):
        return ModCRTMoE(MOE_WIDTH, MOE_EXPERTS, dispatch=dispatch,
                         device="cpu",
                         generator=torch.Generator().manual_seed(ML_SEED)
                         ).to(where)

    def loss_of(m, xx=x):
        return ((m(xx) - 0.5 * xx) ** 2).mean()

    with torch.no_grad():
        gather, cap = build(dev, "gather"), build(dev)
        eid = cap.route(x.reshape(-1, MOE_WIDTH))
        counts = torch.bincount(eid, minlength=MOE_EXPERTS)
        capacity = int(np.ceil(eid.numel() / MOE_EXPERTS
                               * cap.capacity_factor))
        yg, yc = gather(x), cap(x)
    ok, how = same_or_close([yc], [yg])
    print(f"[14] ModCRTMoE({MOE_EXPERTS} experts, width {MOE_WIDTH}) on "
          f"{MOE_TOKENS[0]} x {MOE_TOKENS[1]} tokens: tokens per expert "
          f"{counts.tolist()} against capacity {capacity}; capacity "
          f"dispatch {how} the gather dispatch  [{card}]", flush=True)
    if int(counts.max()) > capacity or not ok:
        raise AssertionError(f"ModCRTMoE capacity against gather: {how}")

    model = build(dev)
    shard_params(model, mesh, MOE_EP_RULES)
    g_card, l_card = grads_of(model, loss_of)
    cpu = build("cpu")
    cpu_eid = cpu.route(x.reshape(-1, MOE_WIDTH).cpu())
    flips = int((cpu_eid != eid.cpu()).sum())
    cpu.route = lambda xf: eid.cpu()  # the card's routes: hold the experts
    g_cpu, l_cpu = grads_of(cpu, lambda m: loss_of(m, x.cpu()))
    print(f"[14] ModCRTMoE routes, CPU against card: {flips} of "
          f"{eid.numel()} differ (f32 hash); the CPU gradient taken on the "
          f"card's routes; loss {l_card!r} against {l_cpu!r}", flush=True)
    held_to_cpu("ModCRTMoE (expert-parallel)", g_card, g_cpu,
                ML_CARD_REL["float32"], card)

    def trainer():
        m = build(dev)
        shard_params(m, mesh, MOE_EP_RULES)
        o = torch.optim.Adam(param_groups(m), 1e-2)
        st = make_train_step(
            lambda q, b_: ((functional_call(m, q, (b_,)) - 0.5 * b_) ** 2)
            .mean(), o, mesh, m)
        return m, o, lambda: st(shard_batch(x, mesh))

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            m_a, o_a, step_a = trainer()
            losses = []
            ms = events_ms(lambda: losses.append(step_a()), MOE_CKPT_STEP)
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "ckpt")
                save_state(path, {"model": m_a.state_dict(),
                                  "opt": get_optimizer_state_dict(m_a, o_a),
                                  "step": MOE_CKPT_STEP})
                ms += events_ms(lambda: losses.append(step_a()),
                                MOE_STEPS - MOE_CKPT_STEP)
                m_b, o_b, step_b = trainer()
                back = restore_state(path, {
                    "model": m_b.state_dict(),
                    "opt": get_optimizer_state_dict(m_b, o_b), "step": 0})
            m_b.load_state_dict(back["model"])
            set_optimizer_state_dict(m_b, o_b, back["opt"])
            for _ in range(MOE_STEPS - back["step"]):
                last_b = step_b()
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    loose = sorted({str(w.message).split(".")[0] for w in caught
                    if "deterministic" in str(w.message)})
    losses = torch.stack(losses).tolist()
    ok, how = same_or_close(full_params(m_b), full_params(m_a))
    ok = ok and last_b.item() == losses[-1]
    ms = sorted(ms)
    med = statistics.median(ms)
    calls = aten_ops(step_a)
    peak, above = peak_memory(step_a)
    print(f"[14] ModCRTMoE expert-parallel (MOE_EP_RULES, W1 "
          f"{m_a.W1.placements}) through make_train_step: {MOE_STEPS} "
          f"Adam(1e-2) steps, loss {losses[0]:.6f} -> {losses[-1]:.6f}; "
          f"{med:.4f} ms per step (CUDA events, median of {len(ms)}, min "
          f"{ms[0]:.4f}, max {ms[-1]:.4f}), {calls} ATen calls per step, "
          f"peak memory {peak:.3f} GB ({above:.3f} above what was live); "
          f"checkpoint at step {MOE_CKPT_STEP} restored into a fresh "
          f"sharded model and Adam, run to step {MOE_STEPS}: {how} the run "
          f"without the restore, W1 restored as {m_b.W1.placements}; ops "
          f"without a deterministic CUDA version: {loose or 'none'}  "
          f"[{card}]", flush=True)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0] and ok
            and m_b.W1.placements == m_a.W1.placements):
        raise AssertionError(f"ModCRTMoE training or resume: {how}")


def phase14_vte(dev, card: str) -> None:
    """BlockFastGPT at its defaults: step 0 against the CPU, then
    ``VTE_STEPS`` Adam steps.

    Step 0's gradient is held against the CPU's in f64 (``ML_CARD_REL``).
    In f32 the card's and the CPU's gradients are printed beside their
    distances from the f64 one, and not held to a bar: the f32 gradient is
    ill-conditioned (``tools/vte_conditioning.py`` on the CPU: the f32
    gradient is 3.1e-4 of max|g| from the f64 one, and 2.2e-4 to 6.9e-4
    once every weight moves by 1e-7 of itself, while the loss moves by 4e-8
    to 1.2e-7), so two f32 implementations need not agree within the 1e-4
    that phase 13 holds ParsevalGPT to."""
    import copy

    import torch
    from pyitd_tpu_torch.examples.train_tiny import make_stream
    from pyitd_tpu_torch.ml import BatchSampler, BlockFastGPT, GPTConfig
    from pyitd_tpu_torch.tools.level_bench import aten_ops

    model = BlockFastGPT(**VTE_CONFIG, device="cpu",
                         generator=torch.Generator().manual_seed(ML_SEED))
    vocab = model.lm_head.out_features
    block = GPTConfig(**ML_CONFIG).block_size  # 256, as phase 13
    sampler = BatchSampler(make_stream(400_000, vocab=vocab), block,
                           VTE_BATCH, seed=2, device=dev)
    batches = [sampler.sample() for _ in range(VTE_STEPS)]
    x0, y0 = batches[0]
    grads = {}
    for dtype in (torch.float64, torch.float32):
        for where in (dev, torch.device("cpu")):
            m = copy.deepcopy(model).to(where, dtype)
            grads[where.type, dtype] = grads_of(
                m, lambda m_: m_(x0.to(where), y0.to(where))[1])
    names = [n for n, _ in model.named_parameters()]
    (g64, l64), (c64, lc64) = grads[dev.type, torch.float64], \
        grads["cpu", torch.float64]
    print(f"[14] BlockFastGPT step-0 loss, f64: card {l64!r}, CPU "
          f"{lc64!r}", flush=True)
    held_to_cpu("BlockFastGPT f64", g64, c64, ML_CARD_REL["float64"], card,
                names)
    gmax = max(float(g.abs().max()) for g in c64)

    def gap(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b)) / gmax

    g32, c32 = grads[dev.type, torch.float32][0], \
        grads["cpu", torch.float32][0]
    print(f"[14] BlockFastGPT step-0 gradient in f32, as fractions of "
          f"max|g| {gmax:.4e}: card against CPU {gap(g32, c32):.3e}; card "
          f"against the f64 gradient {gap(g32, c64):.3e}, CPU against it "
          f"{gap(c32, c64):.3e} (printed, not held: ill-conditioned in "
          f"f32)  [{card}]", flush=True)
    model = model.to(dev)
    opt = torch.optim.Adam(model.parameters(), 3e-3)
    it = iter(batches)
    losses = []
    ms = events_ms(lambda: losses.append(gpt_step(model, opt, *next(it))),
                   VTE_STEPS)
    losses = torch.stack(losses).tolist()
    calls = aten_ops(lambda: gpt_step(model, opt, x0, y0))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[14] BlockFastGPT(vocab {vocab}, n_embd "
          f"{model.lm_head.in_features}, {model.n_layer} layers, rank "
          f"{model.block_0.convolve1.rank}; {n_params} parameters) on "
          f"{VTE_BATCH} x {block} batches: {VTE_STEPS} Adam(3e-3) steps, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"{statistics.median(ms):.2f} ms per step (CUDA events, median, "
          f"min {ms[0]:.2f}, max {ms[-1]:.2f}), {calls} ATen calls per "
          f"step  [{card}]", flush=True)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"BlockFastGPT losses {losses}")


def phase14_pipeline(dev, card: str) -> None:
    """gpipe_apply at pp = 1 over the one-rank group: output and
    gradients against the sequential fold."""
    import torch
    from pyitd_tpu_torch.ml import BiMLP
    from pyitd_tpu_torch.parallel.pipeline import (gpipe_apply,
                                                   stack_stage_params)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.func import functional_call

    pmesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("pp",))
    stage = BiMLP(MOE_WIDTH, device="cpu",
                  generator=torch.Generator().manual_seed(ML_SEED)).to(dev)
    rng = np.random.default_rng(ML_SEED + 15)
    x = torch.from_numpy(rng.normal(size=(PIPE_MICRO, ML_BATCH, MOE_WIDTH))
                         .astype(np.float32)).to(dev)
    tgt = 0.5 * x
    params = {n: p.detach() for n, p in stage.named_parameters()}
    stacked = {n: a.requires_grad_() for n, a in
               stack_stage_params([params], pmesh).items()}
    f = gpipe_apply(lambda q, h: functional_call(stage, q, (h,)), pmesh,
                    PIPE_MICRO)
    y = f(stacked, x)
    ((y - tgt) ** 2).mean().backward()
    want = torch.stack([stage(x[m]) for m in range(PIPE_MICRO)])
    ((want - tgt) ** 2).mean().backward()
    ok_y, how_y = same_or_close([y.detach()], [want.detach()])
    ok_g, how_g = same_or_close(
        [stacked[n].grad.full_tensor()[0] for n in params],
        [p.grad for p in stage.parameters()])
    print(f"[14] gpipe_apply at pp = 1 over the one-rank "
          f"{torch.distributed.get_backend()} group, "
          f"{PIPE_MICRO} microbatches of {ML_BATCH} x {MOE_WIDTH}, a BiMLP "
          f"stage: output {how_y} the sequential fold, gradients {how_g}  "
          f"[{card}]", flush=True)
    if not (ok_y and ok_g):
        raise AssertionError("gpipe_apply against the fold")


def phase14_ml(dev, card: str, gpt_final: list) -> None:
    """BlockFastLM served; the training parallelism on a one-rank mesh; no
    kernel of the repo runs in it."""
    import torch
    from pyitd_tpu_torch.ops import cuda_cubic as cc
    from pyitd_tpu_torch.ops import cuda_fill as cf
    from pyitd_tpu_torch.parallel.train import make_tp_mesh, one_rank_group

    t_phase = time.perf_counter()
    cc.reset_launches()
    cf.reset_launches()
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")  # no TF32, as phase 13
    took = {}
    try:
        t0 = time.perf_counter()
        phase14_serve(dev, card)
        took["serve"] = time.perf_counter() - t0
        with one_rank_group(dev.type):
            mesh = make_tp_mesh(device_type=dev.type)
            for name, part in (("ParsevalGPT", lambda: phase14_gpt(
                    dev, card, mesh, gpt_final)),
                    ("ModCRTMoE", lambda: phase14_moe(dev, card, mesh)),
                    ("pipeline", lambda: phase14_pipeline(dev, card))):
                t0 = time.perf_counter()
                part()
                took[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase14_vte(dev, card)
        took["BlockFastGPT"] = time.perf_counter() - t0
    finally:
        torch.set_float32_matmul_precision(before)
    launches = {k: v for k, v in {**cc.LAUNCHES, **cf.LAUNCHES}.items() if v}
    print(f"[14] launches of the repo's kernels in phase 14: "
          f"{sum(launches.values())}", flush=True)
    if launches:
        raise AssertionError(f"phase 14 launched kernels of the repo: "
                             f"{launches}")
    print(f"[14] phase 14 took {time.perf_counter() - t_phase:.1f} s (host "
          f"clock): " + ", ".join(f"{k} {v:.1f} s" for k, v in took.items())
          + f"  [{card}]", flush=True)


# ---- phase 15: K2a, the DistGroup gradient, the native real-time tier ----

# the native tier: STEP_HOPS hops of phase 12's bank on NATIVE_CHANNELS
# streams, and one NativePool batch of the bank
NATIVE_CHANNELS = 64
# phase 12's card step (p50, p99 in ms), printed beside the native tier's
STEP_LATENCY: dict = {}


def phase15_linear_fill2(dev):
    """``linear_fill2_cuda`` (K2a alone) bitwise its plain version at
    ``MAIN_SHAPE`` in both directions.  Returns the signal."""
    import torch
    from pyitd_tpu_torch.ops import cuda_fill as cf

    x = torch.from_numpy(bench_signal(*MAIN_SHAPE)).to(dev)
    for reverse in (False, True):
        got = cf.linear_fill2_cuda(x, reverse)
        want = cf.linear_fill2(x, reverse)
        if not all(bitwise_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"linear_fill2 8x1M reverse={reverse}: "
                                 f"kernel differs from its plain version")
    print("[15] linear_fill2 8x1M: kernel bitwise its plain version (the "
          "knot mask of ops/extrema.py, then fill2), both directions",
          flush=True)
    return x


def phase15_dist_grad(dev, card: str) -> None:
    """The gradient over a one-rank NCCL ``DistGroup`` at phase 9's
    gradient shape: ``sharded_itd_sift`` (kernel route) and
    ``sharded_cubic_baseline``, each bitwise ``LocalGroup(1)``'s.  The
    plain route's backward adds through atomics on the card (the backward
    of ``gather``), so two runs of one group differ in the last bits: the
    bitwise comparison runs under ``torch.use_deterministic_algorithms``,
    the timing and the peak memory without it."""
    import tempfile

    import torch
    import torch.distributed as dist
    from pyitd_tpu_torch import itd_sift
    from pyitd_tpu_torch.parallel import (DistGroup, LocalGroup,
                                          sharded_cubic_baseline,
                                          sharded_itd_sift)

    g_rows, g_n = SHARD_GRAD_SHAPE
    mi = MAIN_MAX_IT
    xs = torch.from_numpy(bench_signal(g_rows, g_n)).to(dev)

    def sift_grad_over(group):
        xg = xs.clone().requires_grad_()
        rot, _, _, corr = sharded_itd_sift(xg, group, mi)
        ((rot ** 2).sum() + 0.7 * corr.sum()).backward()
        return xg.grad

    def cubic_grad_over(group):
        xg = xs.clone().requires_grad_()
        rot, base, _ = sharded_cubic_baseline(xg, group, min_extrema=0)
        ((rot ** 2).sum() + torch.sin(base).sum()).backward()
        return xg.grad

    @contextlib.contextmanager
    def deterministic():
        torch.use_deterministic_algorithms(True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, device_id=dev)
        try:
            dgroup = DistGroup()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held_gb = torch.cuda.memory_allocated() / 1e9
            g_free = sift_grad_over(dgroup)
            torch.cuda.synchronize()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            calls = dict(dgroup.calls)
            fb_ms = cuda_times(lambda: sift_grad_over(dgroup), reps=3,
                               warmup=0)
            with deterministic():
                gd = sift_grad_over(dgroup)
                gc = cubic_grad_over(dgroup)
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    with deterministic():
        gl = sift_grad_over(LocalGroup(1))
        gcl = cubic_grad_over(LocalGroup(1))
    if not (bool(torch.isfinite(gd).all()) and bitwise_equal(gd, gl)):
        raise AssertionError("DistGroup sift gradient: not finite or not "
                             "bitwise LocalGroup(1)'s")
    atomics = max_abs_err(g_free, gl) / float(gl.abs().max())
    del gl, g_free
    xp = xs.clone().requires_grad_()
    sift_loss(itd_sift(xp, mi, store_baselines=False, backend="torch")
              ).backward()
    gap = grad_gap(gd, xp.grad)
    del xp, gd
    print(f"[15] DistGroup (NCCL, one rank) gradient of sharded_itd_sift "
          f"(kernel route, f32) at {g_rows}x{g_n}: finite, bitwise "
          f"LocalGroup(1)'s under deterministic algorithms (without them "
          f"{atomics!r} of max|g| apart: the atomics of gather's "
          f"backward); collectives called in the forward {calls} (the "
          f"backward runs their transposes); against the unsharded sift's "
          f"structural gradient max|diff| {gap[0]!r}, rms {gap[1]!r} of "
          f"max|g| {gap[2]!r} (limits {GRAD_LIMITS['8x1M']}); forward + "
          f"backward {statistics.median(fb_ms):.4f} ms (CUDA events, median "
          f"of {len(fb_ms)}); peak memory {peak_gb:.3f} GB, "
          f"{peak_gb - held_gb:.3f} GB above the {held_gb:.3f} GB held "
          f"before it  [{card}]", flush=True)
    if not within(gap, GRAD_LIMITS["8x1M"]):
        raise AssertionError("DistGroup gradient beyond its limits against "
                             "the unsharded plain sift's")
    if not (bool(torch.isfinite(gc).all()) and bitwise_equal(gc, gcl)):
        raise AssertionError("DistGroup cubic gradient: not finite or not "
                             "bitwise LocalGroup(1)'s")
    print(f"[15] DistGroup (NCCL, one rank) gradient of "
          f"sharded_cubic_baseline (spike, f32) at {g_rows}x{g_n}: finite, "
          f"bitwise LocalGroup(1)'s under deterministic algorithms; max|g| "
          f"{float(gc.abs().max())!r}", flush=True)


def phase15_native(dev, card: str) -> None:
    """The native tier on phase 12's bank: ``NATIVE_CHANNELS`` streams for
    ``STEP_HOPS`` hops against the card's replay, and one pool batch."""
    import torch
    from pyitd_tpu_torch import runtime, streaming_itd
    from pyitd_tpu_torch.ops._build import HOST_FLAGS

    t0 = time.perf_counter()
    if not runtime.native_available():
        raise AssertionError(f"native tier: {runtime._build_error}")
    print(f"[15] native tier built and loaded in "
          f"{time.perf_counter() - t0:.2f} s (host compiler, flags "
          f"{' '.join(HOST_FLAGS)})", flush=True)
    rows, hop = NATIVE_CHANNELS, STREAM_HOP
    n = STEP_HOPS * hop
    bank = stream_bank(STREAM_SHAPE[0], STREAM_SHAPE[1])
    xn = np.ascontiguousarray(bank[:rows, :n])
    streams = [runtime.StreamingITD(hop) for _ in range(rows)]
    rot = np.zeros((STEP_HOPS, rows, hop))
    base = np.zeros((STEP_HOPS, rows, hop))
    ready = np.zeros(STEP_HOPS, bool)
    lat = []
    try:
        for k in range(STEP_HOPS):
            hops = xn[:, k * hop:(k + 1) * hop]
            t0 = time.perf_counter()
            outs = [s.push(hops[c]) for c, s in enumerate(streams)]
            lat.append((time.perf_counter() - t0) * 1e3)
            if outs[0] is not None:
                ready[k] = True
                for c, (r, b) in enumerate(outs):
                    rot[k, c], base[k, c] = r, b
    finally:
        for s in streams:
            s.close()
    if ready[:2].any() or not ready[2:].all():
        raise AssertionError("native stream: ready hops wrong")
    want = np.stack([xn[:, (k - 1) * hop:k * hop]
                     for k in range(2, STEP_HOPS)])
    rebuilt = float(np.abs(rot[2:] + base[2:] - want).max())
    if not rebuilt <= 1e-10:
        raise AssertionError(f"native stream: rebuild {rebuilt}")
    r_dev, b_dev, rd = streaming_itd(torch.from_numpy(xn).to(dev), hop)
    scale = float(np.abs(xn).max())
    gap = max(float(np.abs(rot[2:] - r_dev[2:].cpu().numpy()).max()),
              float(np.abs(base[2:] - b_dev[2:].cpu().numpy()).max())) / scale
    if not (bool(rd[2:].all()) and gap <= 1e-12):
        raise AssertionError(f"native stream against the card's replay: "
                             f"{gap} of max|x|")
    p50, p99 = np.percentile(lat, [50, 99])
    budget = hop / STREAM_SR * 1e3
    card_step = (f"phase 12's card step p50 {STEP_LATENCY['p50']:.4f} / p99 "
                 f"{STEP_LATENCY['p99']:.4f} ms" if STEP_LATENCY else
                 "phase 12's card step not run")
    print(f"[15] native StreamingITD x {rows} channels, hop {hop}, "
          f"{STEP_HOPS} hops: {rows}-channel hop p50 {p50:.4f} ms, p99 "
          f"{p99:.4f} ms, max {max(lat):.4f} ms (host clock) against the "
          f"{budget:.2f} ms callback budget; {card_step}; every emitted hop "
          f"rebuilds its input within {rebuilt:.3e} and the card's f64 "
          f"replay within {gap:.3e} of max|x|  [{card}]", flush=True)
    del r_dev, b_dev, rot, base

    pool = runtime.NativePool()
    try:
        pool.extract_batch(bank[:2, :4096])  # the threads started
        t0 = time.perf_counter()
        prot, pbase = pool.extract_batch(bank)
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        pool.close()
    for r in range(bank.shape[0]):
        r1, b1, _ = runtime.baseline_extract(bank[r])
        if not (np.array_equal(pbase[r], b1) and np.array_equal(prot[r],
                                                                r1)):
            raise AssertionError(f"NativePool row {r} differs from "
                                 f"baseline_extract")
    recon = float(np.abs(prot + pbase - bank).max())
    if not recon <= 1e-12:
        raise AssertionError(f"NativePool rebuild {recon}")
    print(f"[15] NativePool({os.cpu_count()} threads).extract_batch "
          f"{bank.shape[0]} x {bank.shape[1]} f64: {ms:.2f} ms, "
          f"{bank.shape[0] / ms * 1e3:.1f} rows/s, "
          f"{bank.size / ms / 1e3:.1f} Msamp/s (host clock, one batch); "
          f"every row bitwise baseline_extract, rot + base rebuild x within "
          f"{recon:.3e}  [{card}]", flush=True)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time in ms for the work, and what bounds it."""
    t_b, t_f = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import pyitd_tpu_torch  # noqa: F401
    except ModuleNotFoundError as err:
        print(f"chip_smoke: {err}; run it from the repository's root",
              file=sys.stderr)
        return 1
    from pyitd_tpu_torch import ITD, itd_sift, linear_baseline_extract
    from pyitd_tpu_torch.decomp.itd import _itd_sift_kernel
    from pyitd_tpu_torch.examples import train_through_itd as trainer
    from pyitd_tpu_torch.ops import _build
    from pyitd_tpu_torch.ops import cuda_cubic as cc
    from pyitd_tpu_torch.ops import cuda_fill as cf
    from pyitd_tpu_torch.ops.fill import shift_left
    from pyitd_tpu_torch.ops.linear_baseline import knot_mask
    from pyitd_tpu_torch.tools.cubic_bench import spike_issue_ops
    from pyitd_tpu_torch.utils.interop import from_numpy

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, device {kind}", flush=True)

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    so, log = _build.build()
    cf._lib()
    print(f"[1] built {so.name} in {time.perf_counter() - t0:.2f} s, one "
          f"nvcc -c per source in parallel, then one link (flags: "
          f"{' '.join(_build.NVCC_FLAGS)})", flush=True)
    if log.strip():
        print(log.strip())

    # ---- phase 2: kernel vs plain on small edge cases ----
    rng = np.random.default_rng(3)
    # (what, (max, rms, max|g|), limits, must pass) of the sharp
    # comparisons: the sound kernels must pass, every planted fault fail
    verdicts = []
    for name, xn in phase2_cases():
        x = torch.from_numpy(xn).to(dev)
        for mode in ("reference", "natural"):
            for mi in (2, 5):
                a = itd_sift(x, mi, endpoint_mode=mode)
                b = itd_sift(x, mi, endpoint_mode=mode, backend="torch")
                for f in a._fields:
                    if not bitwise_equal(getattr(a, f), getattr(b, f)):
                        raise AssertionError(
                            f"itd_sift {name} {mode} max_iteration={mi}: "
                            f"{f} differs, max abs err "
                            f"{max_abs_err(getattr(a, f), getattr(b, f))}")
            la = linear_baseline_extract(x, endpoint_mode=mode)
            lb = linear_baseline_extract(x, endpoint_mode=mode,
                                         backend="torch")
            for f in la._fields:
                if not bitwise_equal(getattr(la, f), getattr(lb, f)):
                    raise AssertionError(
                        f"linear_baseline_extract {name} {mode}: {f} differs")
        ee = itd_sift(x, 5, early_exit=True)
        ref = itd_sift(x, 5, backend="torch")
        if not all(bitwise_equal(getattr(ee, f), getattr(ref, f))
                   for f in ee._fields):
            raise AssertionError(f"early_exit differs on {name}")

        # the sift's gradient through the kernels against the plain
        # structural route and against plain scans; on rows of more than
        # one tile, the planted faults against plain scans
        gk = sift_grad(x, 5)
        if not equal_values(gk, replay_grad(x, 5)):
            raise AssertionError(f"gradient {name}: the reverse trip loop "
                                 f"differs from the autograd replay")
        gap = grad_gap(gk, sift_grad(x, 5, backend="torch",
                                     linear_backend="structural"))
        if not within(gap, GRAD_LIMITS["phase 2"]):
            raise AssertionError(f"gradient {name}: kernel against plain "
                                 f"structural (max, rms, max|g|) {gap}")
        with plain_scans():
            gs = sift_grad(x, 5)
        sgap = grad_gap(gk, gs)
        verdicts.append((f"{name}: sound kernels", sgap,
                         SCAN_LIMITS["phase 2"], True))
        for fault in FAULTS if x.shape[1] > cf.TILE and gap[2] > 0 else ():
            with planted(fault):
                fgap = grad_gap(sift_grad(x, 5), gs)
            if fgap[:2] != (0.0, 0.0):
                verdicts.append((f"{name}: {fault}", fgap,
                                 SCAN_LIMITS["phase 2"], False))

        s_err = check_scans(name, x)
        a_err = check_adjoint(name, x, rng, tight=False)
        print(f"[2] {name}: kernel == torch bitwise; stop reasons "
              f"{b.stop_reason.tolist()}, components "
              f"{b.num_components.tolist()}; gradient against the plain "
              f"structural route max|diff| {gap[0]!r} and rms {gap[1]!r} "
              f"of max|g| {gap[2]!r}, against plain scans {sgap[0]!r} and "
              f"{sgap[1]!r}; "
              f"fill2/fillv bitwise, segsum exact on integers, real max abs "
              f"err {s_err[0]!r} ({s_err[1]:.4f} of its bound); level "
              f"adjoint error against f64 {a_err[0]!r} (plain route "
              f"{a_err[1]!r})", flush=True)

    # the level adjoint on JAX's own test signal (tests/test_pallas_fill.py:
    # 381-404), with its 2e-4 tolerance between the routes
    n = 8192 + 130
    t = np.linspace(0, 4 * np.pi, n)
    sig = np.stack([np.sin(9 * t) + 0.2 * rng.standard_normal(n),
                    rng.standard_normal(n)]).astype(np.float32)
    a_err = check_adjoint("(2, 8322)", torch.from_numpy(sig).to(dev), rng,
                          tight=True)
    print(f"[2] level adjoint (2, 8322): kernel and plain routes within "
          f"2e-4; error against f64 {a_err[0]!r} (plain route "
          f"{a_err[1]!r})", flush=True)
    try:
        itd_sift(torch.zeros(2, 64, dtype=torch.float64, device=dev), 2)
    except ValueError:
        pass
    else:
        raise AssertionError("itd_sift took float64 on the kernel route")
    print("[2] f64 on the kernel route raises", flush=True)
    # the class API on a numpy float64 signal: cast to f32, on the kernels
    t = np.linspace(0, 2 * np.pi, 9000)
    s64 = np.sin(20 * t * (1 + 0.2 * t)) + t ** 2 + np.sin(13 * t)
    cf.reset_launches()
    comps = ITD()(s64)
    torch.cuda.synchronize()
    itd_launches = dict(cf.LAUNCHES)
    want = itd_sift(torch.from_numpy(s64).float().to(dev), 11,
                    backend="torch")
    if not bitwise_equal(comps, want.rotations[:int(want.num_components)]):
        raise AssertionError("ITD()(numpy f64) differs from the plain f32 "
                             "sift")
    if itd_launches != {k: sift_launches(13).get(k, 0)
                        for k in itd_launches}:
        raise AssertionError(f"ITD()(numpy f64) launches {itd_launches}")
    print(f"[2] ITD()(numpy float64, 9000): {comps.shape[0]} components in "
          f"f32 on the kernels, bitwise the plain f32 sift; launches "
          f"{itd_launches}", flush=True)
    check_scan_protocol(dev)
    check_level_bwd_cases(dev)
    phase2_cubic(dev)
    phase2_sharded(dev)

    # ---- phase 3: the main path at full size ----
    xn = bench_signal(*MAIN_SHAPE)
    x = torch.from_numpy(xn).to(dev)
    torch.cuda.synchronize()
    cf.reset_launches()
    res = itd_sift(x, MAIN_MAX_IT, store_baselines=False)
    torch.cuda.synchronize()
    launches = dict(cf.LAUNCHES)
    levels = MAIN_MAX_IT + 2
    modes = dict(cf.MODE_LAUNCHES)
    # no backward, so no scans; every trip's scan completes the summaries
    # the level before it emitted
    want = {k: sift_launches(levels).get(k, 0) for k in launches}
    want_modes = {"sift_level_book": levels, "sift_level_emit": levels,
                  "sift_level_shard_emit": 0, "tile_scan_edges": levels,
                  "tile_scan_shard_edges": 0}
    if launches != want or modes != want_modes:
        raise AssertionError(f"launches {launches} by mode {modes}, expected "
                             f"{want} and {want_modes}")
    if tuple(res.rotations.shape) != (levels,) + MAIN_SHAPE:
        raise AssertionError(f"rotations shape {tuple(res.rotations.shape)}")
    if not bool(torch.isfinite(res.rotations).all()):
        raise AssertionError("non-finite rotations")
    recon = (res.rotations.double().sum(0) + res.correction.double()
             - x.double()).abs().max().item()
    raw = (res.rotations.double().sum(0) - x.double()).abs().max().item()
    if not recon <= 1e-10:
        raise AssertionError(f"compensated reconstruction error {recon}")
    print(f"[3] 8x1M sift: launches {launches}, by mode {modes}; "
          f"num_components "
          f"{res.num_components.tolist()}; stop_reason "
          f"{res.stop_reason.tolist()}; compensated reconstruction error "
          f"{recon!r} (uncompensated {raw!r})", flush=True)

    # ---- phase 4: timing ----
    k_ms = cuda_times(lambda: itd_sift(x, MAIN_MAX_IT,
                                       store_baselines=False))
    p_ms = cuda_times(lambda: itd_sift(x, MAIN_MAX_IT, store_baselines=False,
                                       backend="torch"), warmup=1)
    plain = itd_sift(x, MAIN_MAX_IT, store_baselines=False, backend="torch")
    for f in res._fields:
        if not bitwise_equal(getattr(res, f), getattr(plain, f)):
            raise AssertionError(f"8x1M: kernel and torch paths differ in {f}")
    print("[4] 8x1M kernel == torch path bitwise", flush=True)

    def report(shape, xs, times, backend):
        dms, by_name = device_ms(lambda: itd_sift(
            xs, MAIN_MAX_IT, store_baselines=False, backend=backend))
        n = shape[0] * shape[1]
        ms = statistics.median(times)
        print(f"[4] {shape[0]}x{shape[1]} max_iteration=8 {backend} path: "
              f"{ms:.4f} ms/sift (CUDA events, median of {len(times)}, "
              f"min {times[0]:.4f}, max {times[-1]:.4f}), "
              f"{n / ms / 1e3:.2f} Msamp/s; device busy {dms:.4f} ms/sift, "
              f"idle share {1 - dms / ms:.3f}  [{card}]", flush=True)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        print("[4]   top device kernels (ms/sift): " + "; ".join(
            f"{kernel_label(k)} {v:.4f}" for k, v in top), flush=True)

    report(MAIN_SHAPE, x, k_ms, "kernel")
    report(MAIN_SHAPE, x, p_ms, "torch")

    xe = torch.from_numpy(eeg_signal(*EEG_SHAPE)).to(dev)
    ek_ms = cuda_times(lambda: itd_sift(xe, EEG_MAX_IT,
                                        store_baselines=False))
    ep_ms = cuda_times(lambda: itd_sift(xe, EEG_MAX_IT, store_baselines=False,
                                        backend="torch"), warmup=1)
    report(EEG_SHAPE, xe, ek_ms, "kernel")
    report(EEG_SHAPE, xe, ep_ms, "torch")

    # ---- phase 5: the main path's gradient at full size ----
    levels = MAIN_MAX_IT + 2
    xg = x.clone().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cf.reset_launches()
    rk = itd_sift(xg, MAIN_MAX_IT, store_baselines=False)
    sift_loss(rk).backward()
    torch.cuda.synchronize()
    grad_launches = dict(cf.LAUNCHES)
    segsum_launches = dict(cf.SEGSUM_LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the forward: levels + 1 extractions; the replay: the levels - 1
    # baselines that are level inputs, with the forward's launches (one
    # pre-pass, then a scan and a level each); a level adjoint per trip:
    # two fill2 and two segsum calls, and one of each of its own kernels
    want = {"level_summaries": 2, "tile_scan": 2 * levels,
            "sift_level": 2 * levels, "fill2": 2 * levels,
            "linear_fill2": 0, "fillv": 0, "segsum": 2 * levels,
            "bwd_knots": levels, "bwd_pre": levels, "bwd_post": levels}
    if grad_launches != want or segsum_launches != {1: 0, 2: 2 * levels}:
        raise AssertionError(f"gradient launches {grad_launches}, segsum by "
                             f"channels {segsum_launches}, expected {want}")
    g = xg.grad.detach().clone()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("non-finite gradient")
    if not equal_values(g, replay_grad(x, MAIN_MAX_IT,
                                       store_baselines=False)):
        raise AssertionError("8x1M gradient: the reverse trip loop differs "
                             "from the autograd replay")
    xp = x.clone().requires_grad_()
    rp = itd_sift(xp, MAIN_MAX_IT, store_baselines=False, backend="torch",
                  linear_backend="structural")
    for f in rk._fields:
        if not bitwise_equal(getattr(rk, f).detach(), getattr(rp, f).detach()):
            raise AssertionError(f"8x1M: kernel and plain structural "
                                 f"forwards differ in {f}")
    sift_loss(rp).backward()
    gp = xp.grad.detach()
    del rk, rp
    x64 = x.double().requires_grad_()
    sift_loss(itd_sift(x64, MAIN_MAX_IT, store_baselines=False,
                       backend="torch", linear_backend="structural")
              ).backward()
    g64 = x64.grad.detach()
    del x64
    gap = grad_gap(g, gp)
    peak_g = gap[2]
    rms_k = float((g.double() - g64).square().mean().sqrt())
    rms_p = float((gp.double() - g64).square().mean().sqrt())
    del g64
    print(f"[5] 8x1M gradient: launches {grad_launches}; finite; against the "
          f"plain structural route max|diff| {gap[0]!r} and rms(diff) "
          f"{gap[1]!r} of max|g| {peak_g!r}; rms error against the f64 "
          f"sift gradient: kernel route {rms_k!r}, plain route {rms_p!r}; "
          f"peak memory {peak_gb:.3f} GB  [{card}]", flush=True)
    if not within(gap, GRAD_LIMITS["8x1M"]):
        raise AssertionError("8x1M gradient beyond its limits against the "
                             "plain structural route")
    if not rms_k <= 1.5 * rms_p + 1e-6 * peak_g:
        raise AssertionError(f"8x1M gradient: kernel route rms error {rms_k} "
                             f"against f64, plain route {rms_p}")
    del gp
    with plain_scans():
        gs = sift_grad(x, MAIN_MAX_IT, store_baselines=False)
    sgap = grad_gap(g, gs)
    print(f"[5] 8x1M gradient against plain scans: max|diff| {sgap[0]!r} "
          f"and rms(diff) {sgap[1]!r} of max|g| {sgap[2]!r}", flush=True)
    verdicts.append(("8x1M: sound kernels", sgap, SCAN_LIMITS["8x1M"], True))
    for fault in FAULTS:
        with planted(fault):
            fgap = grad_gap(sift_grad(x, MAIN_MAX_IT, store_baselines=False),
                            gs)
        verdicts.append((f"8x1M: {fault}", fgap, SCAN_LIMITS["8x1M"], False))
    del gs, g

    def fwd_bwd():
        xg.grad = None
        sift_loss(itd_sift(xg, MAIN_MAX_IT, store_baselines=False)).backward()

    fb_ms = cuda_times(fwd_bwd)
    f_ms = cuda_times(lambda: itd_sift(x, MAIN_MAX_IT, store_baselines=False))
    fb_dms, fb_by_name = device_ms(fwd_bwd)
    fb, f = statistics.median(fb_ms), statistics.median(f_ms)
    print(f"[5] 8x1M forward + backward {fb:.4f} ms (CUDA events, median of "
          f"{len(fb_ms)}, min {fb_ms[0]:.4f}, max {fb_ms[-1]:.4f}); forward "
          f"alone {f:.4f} ms (min {f_ms[0]:.4f}, max {f_ms[-1]:.4f}); ratio "
          f"{fb / f:.2f}; device busy {fb_dms:.4f} ms, idle share "
          f"{1 - fb_dms / fb:.3f}  [{card}]", flush=True)
    groups = {"sift kernels": 0.0, "scan kernels": 0.0,
              "adjoint kernels": 0.0, "PyTorch ops": 0.0}
    for k, v in fb_by_name.items():
        if any(s in k for s in ("sift_level_kernel", "level_summaries_kernel",
                                "tile_scan_kernel")):
            groups["sift kernels"] += v
        elif "scan_lookback" in k:
            groups["scan kernels"] += v
        elif any(f"{s}_kernel" in k for s in ADJOINT_KERNELS):
            groups["adjoint kernels"] += v
        else:
            groups["PyTorch ops"] += v
    print("[5]   device time by group (ms per forward + backward): "
          + "; ".join(f"{k} {v:.4f}" for k, v in groups.items()), flush=True)
    # one launch per call: 2 fill2 and 2 segsum calls per level, and one of
    # each adjoint kernel
    scan_kernels = device_launches(fwd_bwd, "scan_lookback")
    adj_kernels = device_launches(fwd_bwd, "bwd_")
    print(f"[5]   scan kernel launches per forward + backward: "
          f"{scan_kernels} for {4 * levels} calls; adjoint kernel launches "
          f"{adj_kernels} for {3 * levels} calls", flush=True)
    if scan_kernels != 4 * levels or adj_kernels != 3 * levels:
        raise AssertionError(f"{scan_kernels} scan kernel launches for "
                             f"{4 * levels} scan calls, {adj_kernels} "
                             f"adjoint kernel launches for {3 * levels}")
    top = sorted(fb_by_name.items(), key=lambda kv: -kv[1])[:8]
    print("[5]   top device kernels (ms per forward + backward): " + "; ".join(
        f"{kernel_label(k)} {v:.4f}" for k, v in top), flush=True)

    # ---- phase 6: the trainer ----
    xn_t, hi_t = trainer.make_problem(n=MAIN_SHAPE[1], batch=MAIN_SHAPE[0])
    xt, tgt = from_numpy(xn_t, dev).float(), from_numpy(hi_t, dev).float()
    del xn_t, hi_t
    taps0 = from_numpy(trainer.identity_taps(), dev).float()
    taps_k = taps0.clone().requires_grad_()
    taps_p = taps0.clone().requires_grad_()
    (gk,) = torch.autograd.grad(
        trainer.loss_fn(taps_k, xt, tgt, TRAIN_MAX_IT), taps_k)
    (gt,) = torch.autograd.grad(trainer.loss_fn(
        taps_p, xt, tgt, TRAIN_MAX_IT, backend="torch",
        linear_backend="structural"), taps_p)
    taps_rel = float((gk - gt).abs().max() / gt.abs().max())
    if not taps_rel <= TAPS_REL:
        raise AssertionError(f"trainer step 0: taps gradient {gk.tolist()} "
                             f"against plain structural {gt.tolist()}")
    def taps_grad():
        tf = taps0.clone().requires_grad_()
        return torch.autograd.grad(
            trainer.loss_fn(tf, xt, tgt, TRAIN_MAX_IT), tf)[0]

    with plain_scans():
        gs = taps_grad()
    t_max = float(gs.abs().max())
    for what, gf in [("sound kernels", gk)] + [
            (fault, None) for fault in FAULTS]:
        if gf is None:
            with planted(what):
                gf = taps_grad()
        verdicts.append((f"taps: {what}", (float(
            (gf - gs).abs().max()) / t_max, 0.0, t_max),
            (TAPS_SCAN_REL, 0.0), what == "sound kernels"))
    cf.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, losses = trainer.train(
        xt, tgt, taps0, TRAIN_STEPS, lr=3e-2, max_iteration=TRAIN_MAX_IT,
        log=lambda i, v: print(f"[6] trainer step {i}: loss {v!r}",
                               flush=True))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    train_launches = dict(cf.LAUNCHES)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"trainer losses {losses}")
    t_levels = TRAIN_MAX_IT + 2
    if (train_launches["fill2"] != 2 * t_levels * TRAIN_STEPS
            or train_launches["segsum"] != 2 * t_levels * TRAIN_STEPS
            or train_launches["bwd_post"] != t_levels * TRAIN_STEPS):
        raise AssertionError(f"trainer launches {train_launches}")
    print(f"[6] trainer 8x1M max_iteration={TRAIN_MAX_IT}: {TRAIN_STEPS} Adam "
          f"steps, losses {losses}; {step_ms:.2f} ms per step (host clock, "
          f"first step included); step-0 taps gradient {gk.tolist()} against "
          f"plain structural {gt.tolist()} (max rel diff {taps_rel:.3g}); "
          f"launches {train_launches}  [{card}]", flush=True)
    del xt, tgt

    # against plain scans: the sound kernels within the limits, every
    # planted fault (where it changed the gradient) beyond them
    for what, fgap, limits, ok in verdicts:
        print(f"[6] against plain scans, {what}: max|diff| {fgap[0]!r}, rms "
              f"{fgap[1]!r} of max|g| {fgap[2]!r}; limits {limits}: "
              f"{'within' if within(fgap, limits) else 'beyond'}", flush=True)
    wrong = [what for what, fgap, limits, ok in verdicts
             if within(fgap, limits) != ok]
    if wrong:
        raise AssertionError(f"against plain scans, wrong side of the "
                             f"limits: {wrong}")

    # ---- phase 7: each kernel against its plain version at the main
    # path's shapes (trip 1 of the 8x1M sift: the first baseline as input)
    st0 = cf.level_states(x)
    lvl0 = cf.sift_level(x, st0)
    base = lvl0.baseline
    rows, n = MAIN_SHAPE
    nt = -(-n // cf.TILE)
    entries = []

    def entry(name, err, kernel_fn, plain_fn, nbytes, flops, count,
              exact=True, shape="8x1M"):
        if exact and err != 0.0:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version, max abs err {err}")
        # device time from the profiler; CUDA events where it has none
        plain_ms, ms = device_ms(plain_fn)[0], device_ms(kernel_fn)[0]
        method = ("profiler device time per recorded launch, {missing} of "
                  "{expected} records missing, {summed_ms:.4f} ms as a plain "
                  "sum over the calls").format(**TRACE_GAPS)
        if ms != ms or plain_ms != plain_ms:
            # 20 calls back to back per timed window: one call's window
            # would time the wrapper's host work, not the device's
            def twenty(fn):
                return lambda: [fn() for _ in range(20)]

            ms = statistics.median(cuda_times(twenty(kernel_fn))) / 20
            plain_ms = statistics.median(cuda_times(twenty(plain_fn))) / 20
            method = "CUDA events over 20 calls back to back"
        b_ms, b_by = bound(nbytes, flops)
        print(f"[7] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per "
              f"call at {shape} ({method}; max abs err {err!r}); bound "
              f"{b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e6:.1f} MFLOP); {count} launches  [{card}]",
              flush=True)
        entries.append({"name": name, "shape": shape, "route": "cuda",
                        "source": SRC[name],
                        "replaces": REPLACES[name], "launches": count,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None})

    sk, sp = cf.level_summaries_cuda(base), cf.level_summaries(base)
    entry("level_summaries", max(max_abs_err(a, b) for a, b in zip(sk, sp)),
          lambda: cf.level_summaries_cuda(base),
          lambda: cf.level_summaries(base),
          rows * n * 4 + rows * nt * 36, 2 * rows * n,
          launches["level_summaries"])

    def carry():
        c = cf.SiftCarry.zeros(rows, dev)
        c.done[1] = 1
        return c

    ck, cp = carry(), carry()
    tk = cf.tile_scan_cuda(sk, ck, trip=1, max_iteration=MAIN_MAX_IT)
    tp = cf.tile_scan(sp, cp, trip=1, max_iteration=MAIN_MAX_IT)
    entry("tile_scan",
          max(max_abs_err(a, b) for a, b in zip(tk + ck, tp + cp)),
          lambda: cf.tile_scan_cuda(sk, ck, 1, MAIN_MAX_IT),
          lambda: cf.tile_scan(sp, cp, 1, MAIN_MAX_IT),
          rows * nt * (36 + 32) + rows * (12 + 12 + 8), 0,
          launches["tile_scan"])

    row_k, row_p = torch.empty_like(x), torch.empty_like(x)
    zero = x * 0
    args = dict(rotp=lvl0.rotation, pbase=x, perr=lvl0.sub_err, comp=zero)
    # reads: base and comp always, rotp and perr on running or stop-B rows,
    # pbase on stop-A rows; five row writes; the seeds and flags
    fl = tk.flags
    n_rp = int(((fl & (cf.CONT | cf.STOP_B)) != 0).sum())
    n_pb = int(((fl & cf.STOP_A) != 0).sum())
    book_bytes = (4 * n * (7 * rows + 2 * n_rp + n_pb) + rows * nt * 32
                  + rows * 4)

    def level_err(emit, **kw):
        """sift_level on the kernel against its plain version."""
        lk = cf.sift_level_cuda(base, tk, emit=emit, **kw)
        lp = cf.sift_level(base, tk, emit=emit, **dict(
            kw, **({"out_row": row_p} if kw else {})))
        pairs = list(zip(flat(lk), flat(lp)))
        if kw:
            pairs.append((row_k, row_p))
        return lk, max(max_abs_err(a, b) for a, b in pairs)

    # the sift's last trip: the bookkeeping, nothing emitted
    _, l_err = level_err(False, out_row=row_k, **args)
    entry("sift_level", l_err,
          lambda: cf.sift_level_cuda(base, tk, out_row=row_k, **args),
          lambda: cf.sift_level(base, tk, out_row=row_p, **args),
          book_bytes, 40 * rows * n, launches["sift_level"])
    # every other trip: it also emits the baseline's interior summaries
    lk, e_err = level_err(True, out_row=row_k, **args)
    entry("sift_level_emit", e_err,
          lambda: cf.sift_level_cuda(base, tk, out_row=row_k, emit=True,
                                     **args),
          lambda: cf.sift_level(base, tk, out_row=row_p, emit=True, **args),
          book_bytes + rows * nt * 36, 42 * rows * n,
          modes["sift_level_emit"])
    # the next trip's scan: the interior summaries completed with each
    # tile's first and last sample (six values a tile) before the scan
    ck, cp = carry(), carry()
    ek = cf.tile_scan_cuda(lk.interior, ck, 2, MAIN_MAX_IT,
                           edges_from=lk.baseline)
    ep = cf.tile_scan(lk.interior, cp, 2, MAIN_MAX_IT,
                      edges_from=lk.baseline)
    whole = cf.tile_scan_cuda(cf.level_summaries_cuda(lk.baseline), carry(),
                              2, MAIN_MAX_IT)
    entry("tile_scan_edges",
          max(max_abs_err(a, b)
              for a, b in list(zip(ek + ck, ep + cp)) + list(zip(ek, whole))),
          lambda: cf.tile_scan_cuda(lk.interior, ck, 2, MAIN_MAX_IT,
                                    edges_from=lk.baseline),
          lambda: cf.tile_scan(lk.interior, cp, 2, MAIN_MAX_IT,
                               edges_from=lk.baseline),
          rows * nt * (36 + 24 + 32) + rows * (12 + 12 + 8), 0,
          modes["tile_scan_edges"])

    # the same kernel with the bookkeeping compiled out (K2: the first
    # extraction of a sift, which emits, and every level of the backward's
    # replay, which does not)
    for emit in (True, False):
        _, k2 = level_err(emit)
        if k2 != 0.0:
            raise AssertionError(f"sift_level without bookkeeping, emit="
                                 f"{emit}, differs: max abs err {k2}")
    k2_emit = device_ms(lambda: cf.sift_level_cuda(base, tk, emit=True))[0]
    entry("sift_level_k2", 0.0, lambda: cf.sift_level_cuda(base, tk),
          lambda: cf.sift_level(base, tk),
          16 * rows * n + rows * nt * 32, 40 * rows * n,
          launches["sift_level"] - modes["sift_level_book"])
    print(f"[7] sift_level without bookkeeping, emitting (the sift's first "
          f"extraction): kernel {k2_emit:.4f} ms per call at 8x1M (profiler "
          f"device time; max abs err 0.0)  [{card}]", flush=True)

    # the backward's scans on the same level input, as the adjoint calls them
    knots = knot_mask(base)
    f_next = shift_left(knots, False)
    fk = cf.fill2_cuda(base, knots) + cf.fill2_cuda(base, knots, True, True)
    fp = cf.fill2(base, knots) + cf.fill2(base, knots, True, True)
    entry("fill2", max(max_abs_err(a, b) for a, b in zip(fk, fp)),
          lambda: cf.fill2_cuda(base, knots), lambda: cf.fill2(base, knots),
          rows * n * (4 + 1 + 16), 0, grad_launches["fill2"])
    vk = (cf.fillv_cuda(base, knots), cf.fillv_cuda(base, knots, True))
    vp = (cf.fillv(base, knots), cf.fillv(base, knots, True))
    entry("fillv", max(max_abs_err(a, b) for a, b in zip(vk, vp)),
          lambda: cf.fillv_cuda(base, knots), lambda: cf.fillv(base, knots),
          rows * n * (4 + 1 + 4), 0, grad_launches["fillv"])
    gen = torch.Generator(device=dev).manual_seed(5)
    chans = tuple(torch.randn(MAIN_SHAPE, generator=gen, device=dev)
                  for _ in range(2))
    s_err, s_ratio = segsum_within_bound(chans, f_next, True, "8x1M")
    print(f"[7] segsum at 8x1M: 2 channels within {s_ratio:.4f} of "
          f"segsum_error_bound", flush=True)
    entry("segsum", s_err, lambda: cf.segsum_cuda(chans, f_next, True),
          lambda: cf.segsum(chans, f_next, True), rows * n * (8 + 1 + 8),
          2 * rows * n, segsum_launches[2], exact=False)

    # the level adjoint's own kernels on the same level input, at 8x1M and
    # at the benchmark's 256 x 16,384 (the first level of its bank), with
    # bwd_pre as the reverse trip loop calls it for trip 1 (the flags of
    # the forward's trips 1 and 2, no stored baselines) and as a lone
    # level's adjoint calls it (bwd_pre_level: the torch route and the
    # sharded sift's backward, which the sift's gradient never launches)
    def adjoint_entries(xa, shape, counts, flags):
        r, m = xa.shape
        cgen = torch.Generator(device=dev).manual_seed(6)
        cts = [torch.randn(xa.shape, generator=cgen, device=dev)
               for _ in range(5)]
        g_j, g_c, g_n, g_carry = cts[0], cts[2], cts[3], cts[4]
        trip = cf.TripCotangents(flags[1], flags[2], g_n, g_carry)
        tcts = (g_j, None, g_c)
        kk = cf.bwd_knots_cuda(xa)
        kn, fn_ = kk
        fw = cf.fill2_cuda(xa, kn)
        bw = cf.fill2_cuda(xa, kn, True, True)
        pre = cf.bwd_pre_cuda(xa, *tcts, fw, bw, trip=trip)
        lone = cf.bwd_pre_cuda(xa, *cts[:3], fw, bw)
        sa = cf.segsum_cuda(pre[:2], fn_, reverse=True)
        se = cf.segsum_cuda(pre[2:4], kn, strict=True)
        post = cf.bwd_post_cuda(kn, pre[4], sa, se, fw[2], bw[0])
        errs = {
            "bwd_knots": max(max_abs_err(a, b)
                             for a, b in zip(kk, cf.bwd_knots(xa))),
            "bwd_pre": max(max_abs_err(a, b) for a, b in zip(
                pre, cf.bwd_pre(xa, *tcts, fw, bw, trip=trip))),
            "bwd_pre_level": max(max_abs_err(a, b) for a, b in zip(
                lone, cf.bwd_pre(xa, *cts[:3], fw, bw))),
            "bwd_post": max_abs_err(post, cf.bwd_post(
                kn, pre[4], sa, se, fw[2], bw[0]))}
        calls = {
            "bwd_knots": (lambda: cf.bwd_knots_cuda(xa),
                          lambda: cf.bwd_knots(xa)),
            "bwd_pre": (lambda: cf.bwd_pre_cuda(xa, *tcts, fw, bw, trip=trip),
                        lambda: cf.bwd_pre(xa, *tcts, fw, bw, trip=trip)),
            "bwd_pre_level": (lambda: cf.bwd_pre_cuda(xa, *cts[:3], fw, bw),
                              lambda: cf.bwd_pre(xa, *cts[:3], fw, bw)),
            "bwd_post": (lambda: cf.bwd_post_cuda(kn, pre[4], sa, se, fw[2],
                                                  bw[0]),
                         lambda: cf.bwd_post(kn, pre[4], sa, se, fw[2],
                                             bw[0]))}
        # bytes a sample: x in, two masks out; x, three cotangent streams
        # (the trip loop's G_j, Gc and carry) and the fills' eight channels
        # in, five channels out, and in the trip loop the two trips' flags
        # a row and G_{j+1} on the rows that trip 2 stopped by STOP_A; a
        # mask, the direct term, four sums and two positions in, the
        # gradient out (the gathers are L2 reads); flops a sample, about
        stop_a = int(((flags[2] & cf.STOP_A) != 0).sum())
        per = {"bwd_knots": (r * m * (4 + 2), 0),
               "bwd_pre": (r * m * (48 + 20) + r * 8 + stop_a * m * 4,
                           r * m * 44),
               "bwd_pre_level": (r * m * (48 + 20), r * m * 40),
               "bwd_post": (r * m * (29 + 4), r * m * 10)}
        for k in ADJOINT_KERNELS + ("bwd_pre_level",):
            entry(k, errs[k], *calls[k], *per[k], counts.get(k, 0),
                  shape=shape)

    main_flags = []
    _itd_sift_kernel(x, MAIN_MAX_IT, "reference", False, False,
                     flags_out=main_flags)
    adjoint_entries(base, "8x1M", grad_launches, main_flags)
    # the launches of one counted 256 x 16,384 gradient, as the benchmark's
    # eeg_16k.grad cell takes it
    xeg = xe.clone().requires_grad_()
    cf.reset_launches()
    sift_loss(itd_sift(xeg, EEG_MAX_IT, store_baselines=False)).backward()
    torch.cuda.synchronize()
    eeg_launches = dict(cf.LAUNCHES)
    del xeg
    if any(eeg_launches[k] != EEG_MAX_IT + 2 for k in ADJOINT_KERNELS):
        raise AssertionError(f"256x16k gradient launches {eeg_launches}, "
                             f"expected {EEG_MAX_IT + 2} of each adjoint "
                             f"kernel")
    xe1 = cf.sift_level_cuda(xe, cf.level_states_cuda(xe)).baseline
    eeg_flags = []
    _itd_sift_kernel(xe, EEG_MAX_IT, "reference", False, False,
                     flags_out=eeg_flags)
    adjoint_entries(xe1, "256x16k", eeg_launches, eeg_flags)

    # the same scans on the input of the backward's last level, where the
    # knots are sparse and a tile looks back furthest
    deep = x
    for _ in range(levels - 1):
        deep = cf.sift_level_cuda(deep, cf.level_states_cuda(deep)).baseline
    dknots = knot_mask(deep)
    d_next = shift_left(dknots, False)
    per_row = dknots.sum(-1).tolist()
    for a, b in zip(cf.fill2_cuda(deep, dknots)
                    + cf.fill2_cuda(deep, dknots, True, True),
                    cf.fill2(deep, dknots)
                    + cf.fill2(deep, dknots, True, True)):
        if not bitwise_equal(a, b):
            raise AssertionError("fill2 on the last level's input differs")
    d_err, d_ratio = segsum_within_bound(chans, d_next, True, "last level")
    deep_ms = {
        "fill2": device_ms(lambda: cf.fill2_cuda(deep, dknots))[0],
        "fillv": device_ms(lambda: cf.fillv_cuda(deep, dknots))[0],
        "segsum": device_ms(lambda: cf.segsum_cuda(chans, d_next, True))[0]}
    print(f"[7] scans on the input of the backward's last level (knots per "
          f"row {per_row}, of {n}; level 1 has {knots.sum(-1).tolist()}): "
          f"fill2 bitwise, segsum within {d_ratio:.4f} of its bound (max "
          f"abs err {d_err!r}); kernel ms per "
          f"call (profiler device time) "
          + ", ".join(f"{k} {v:.4f}" for k, v in deep_ms.items())
          + f"  [{card}]", flush=True)
    # the level kernels on the same input: the walk seldom passes a knot
    dsum = cf.level_summaries_cuda(deep)
    dst = cf.tile_scan_cuda(dsum, carry(), 1, MAIN_MAX_IT)
    dk = cf.sift_level_cuda(deep, dst, out_row=row_k, emit=True, **args)
    dp = cf.sift_level(deep, dst, out_row=row_p, emit=True, **args)
    de = cf.tile_scan_cuda(dk.interior, edges_from=dk.baseline)
    if not (all(bitwise_equal(a, b) for a, b in zip(
                flat(dk) + [row_k] + list(dsum), flat(dp) + [row_p]
                + list(cf.level_summaries(deep))))
            and all(bitwise_equal(a, b) for a, b in zip(de, cf.tile_scan(
                cf.level_summaries(dk.baseline))))):
        raise AssertionError("the level kernels on the last level's input "
                             "differ from their plain versions")
    deep_lvl = {
        "level_summaries": lambda: cf.level_summaries_cuda(deep),
        "tile_scan_edges": lambda: cf.tile_scan_cuda(
            dk.interior, edges_from=dk.baseline),
        "sift_level_k2": lambda: cf.sift_level_cuda(deep, dst),
        "sift_level": lambda: cf.sift_level_cuda(deep, dst, out_row=row_k,
                                                 **args),
        "sift_level_emit": lambda: cf.sift_level_cuda(
            deep, dst, out_row=row_k, emit=True, **args)}
    print(f"[7] level kernels on the same input: bitwise their plain "
          f"versions; kernel ms per call (profiler device time) "
          + ", ".join(f"{k} {device_ms(fn)[0]:.4f}"
                      for k, fn in deep_lvl.items())
          + f"  [{card}]", flush=True)
    del deep, dknots, d_next, dk, dp
    print(f"[7] launches: forward sift {launches} (by mode {modes}); forward "
          f"+ backward "
          f"{grad_launches}, segsum by channels {segsum_launches}; one kernel "
          f"launch per scan call, "
          f"{grad_launches['fill2'] + grad_launches['segsum']} per backward",
          flush=True)

    # ---- phase 8: the cubic level at full size ----
    cubic_launches, calls, level_by = phase8_cubic(x, card)

    # phase 7's rows for the cubic kernels, on the inputs the cubic level
    # gave them.  Bytes: each input read once, each output written once;
    # operations counted from the kernels' sources (K7's as issued under
    # -fmad=false, each a multiply-add slot of the f32 peak)
    nt = -(-n // cf.TILE)
    npad = calls["spike_factors_cuda"][1].shape[-1]
    nblk = npad // cc.SPIKE_BLK
    for name, nbytes, flops in (
            ("cubic_ksite", 8 * rows * n + 32 * rows * nt + 8 * rows,
             11 * rows * n),
            ("cubic_neighbors", 32 * rows * n + 16 * rows * nt,
             2 * rows * n),
            ("spike_factors", 17 * rows * n + 24 * rows * npad,
             2 * spike_issue_ops(rows, npad, cc.SPIKE_BLK, cc.SPIKE_RUN)),
            # the edge cells of six channels in, three block scalars and
            # two end moments out (the mask is read only to the second knot
            # from each end: a few bytes a row here); about 70 operations a
            # block and PCR round
            ("spike_interface", 36 * rows * nblk + 12 * rows * nblk
             + 8 * rows, rows * nblk * (70 * (nblk - 1).bit_length() + 20)),
            ("spike_backsub_eval",
             60 * rows * n + 12 * rows * (npad // cc.SPIKE_BLK) + 16 * rows,
             31 * rows * n)):
        key = name + "_cuda"
        args, _, err = calls[key]
        entry(name, err, lambda k=key, a=args: getattr(cc, k)(*a),
              lambda k=key, a=args: cc.PLAIN[k](*a), nbytes, flops,
              cubic_launches[name])
    del calls, x

    # ---- phase 9: the sequence-parallel tier at full width ----
    shard_launches, shard_modes, calls, calls_fold = phase9_sharded(dev, card)

    # phase 7's rows for the shard-aware kernels on trip 1's inputs (the
    # route without fold_emit; launches: the main path's, with it): each
    # kernel row is one (shard, row) pair of 1,048,576 samples
    (xs, sh), _, s_err = calls["level_summaries"][1]
    rows, n = xs.shape
    nt = -(-n // cf.TILE)
    shape = f"{rows}x{n} shard rows"
    entry("sharded_level_summaries", s_err,
          lambda: cf.level_summaries_cuda(xs, sh),
          lambda: cf.level_summaries(xs, sh),
          rows * n * 4 + rows * nt * 36 + rows * 12, 2 * rows * n,
          shard_launches["level_summaries"], shape=shape)
    (summ,), kw, t_err = calls["tile_scan"][1]
    entry("sharded_tile_scan", t_err,
          lambda: cf.tile_scan_cuda(summ, **kw),
          lambda: cf.tile_scan(summ, **kw),
          rows * nt * (36 + 32) + rows * (8 + 32), 0,
          shard_launches["tile_scan"], shape=shape)
    (xs, states), kw, l_err = calls["sift_level"][1]
    fl = states.flags
    n_rp = int(((fl & (cf.CONT | cf.STOP_B)) != 0).sum())
    n_pb = int(((fl & cf.STOP_A) != 0).sum())
    plain_kw = dict(kw, out_row=torch.empty_like(kw["out_row"]))
    entry("sharded_sift_level", l_err,
          lambda: cf.sift_level_cuda(xs, states, **kw),
          lambda: cf.sift_level(xs, states, **plain_kw),
          4 * n * (7 * rows + 2 * n_rp + n_pb) + rows * nt * 32 + rows * 56,
          40 * rows * n, shard_launches["sift_level"], shape=shape)
    # the fold_emit route's trip 1: the level also emits its baseline's
    # interior summaries, and the next scan completes them with each tile's
    # edge samples and the shard's last, against the halos
    (xs, states), kw, e_err = calls_fold["sift_level"][1]
    plain_kw = dict(kw, out_row=torch.empty_like(kw["out_row"]))
    entry("sharded_sift_level_emit", e_err,
          lambda: cf.sift_level_cuda(xs, states, **kw),
          lambda: cf.sift_level(xs, states, **plain_kw),
          4 * n * (7 * rows + 2 * n_rp + n_pb) + rows * nt * 68 + rows * 56,
          42 * rows * n, shard_modes["sift_level_shard_emit"], shape=shape)
    (summ,), kw, te_err = calls_fold["tile_scan"][1]
    entry("sharded_tile_scan_edges", te_err,
          lambda: cf.tile_scan_cuda(summ, **kw),
          lambda: cf.tile_scan(summ, **kw),
          rows * nt * (36 + 24 + 32) + rows * (8 + 32 + 12 + 12), 0,
          shard_modes["tile_scan_shard_edges"], shape=shape)
    del calls, calls_fold

    # ---- phase 10: the cubic tier's callers at full width ----
    stats_launches = phase10_meitd(dev, card, level_by)

    # phase 7's rows for the walk's gate statistics: the largest stage (the
    # ensemble's 32 rows) and the select's (R, 45, n) stacks.  Bytes: the
    # rows read once, two f64 a row written; about 25 f64 operations a
    # sample, counted twice against the f32 peak (f64 runs at half rate)
    from pyitd_tpu_torch.ops import wpe as wo
    reps, n = ENS_SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    for srows in (reps, reps * 45):
        xs = torch.from_numpy(ensemble_signal(n)).to(dev) + 0.1 * torch.randn(
            (srows, n), generator=gen, device=dev, dtype=torch.float64)
        got, want = wo.walk_stats_cuda(xs), wo.walk_stats(xs)
        err = max_abs_err(got[1], want[1])
        if not (torch.equal(got[0], want[0]) and err <= 1e-12):
            raise AssertionError(f"walk_stats at {srows} x {n}: counts "
                                 f"equal {torch.equal(got[0], want[0])}, "
                                 f"entropies apart {err!r}")
        entry("walk_stats", err, lambda: wo.walk_stats_cuda(xs),
              lambda: wo.walk_stats(xs), 8 * srows * n + 16 * srows,
              2 * 25 * srows * n, stats_launches, exact=False,
              shape=f"{srows}x{n} f64")
    del xs, got, want

    # ---- phase 11: the FFT family at full width ----
    phase11_fft(dev, card)

    # ---- phase 12: the rest of decomp/ at full size ----
    phase12_decomp(dev, card)

    # ---- phase 13: the ML trainers at full width ----
    gpt_final = phase13_ml(dev, card)

    # ---- phase 14: BlockFastLM served; training over a DeviceMesh ----
    phase14_ml(dev, card, gpt_final)

    # ---- phase 15: K2a, the DistGroup gradient, the native real-time
    # tier ----
    x15 = phase15_linear_fill2(dev)
    rows, n = MAIN_SHAPE
    lf_k = cf.linear_fill2_cuda(x15) + cf.linear_fill2_cuda(x15, True)
    lf_p = cf.linear_fill2(x15) + cf.linear_fill2(x15, True)
    # bytes: x read once, four (position, value) channels written; the knot
    # test's two differences per sample; no route launches K2a
    entry("linear_fill2", max(max_abs_err(a, b) for a, b in zip(lf_k, lf_p)),
          lambda: cf.linear_fill2_cuda(x15), lambda: cf.linear_fill2(x15),
          rows * n * (4 + 16), 2 * rows * n, 0)
    del x15, lf_k, lf_p
    phase15_dist_grad(dev, card)
    phase15_native(dev, card)

    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
