"""The benchmark's plain reference of one ITD-Fourier cascade iteration
(``benchmark/reference/itd_fourier.py``) against the JAX package, and the
port (``pyitd_tpu_torch/decomp/itd_fourier.py``) against that reference,
on the CPU, at bench's small shape (n = 4,096, sr = 256: one comb entry)
and at n = 4,096 with sr 1,024 and 2,048 (five and ten chained template
baselines).

* the reference's knot grids are the port's, at the cell's full size too;
* the reference against JAX's sift, band extraction, keep flags and
  update in float64 to 1e-12 of max |x|;
* the port against the reference in float64 and float32: rotations and
  residual, the keep flags and the modes of the reference's band
  extraction on the port's own rotations, the update;
* the bfloat16 control parts from the port by far more than the port
  parts from the float64 reference;
* the reference imports nothing of either package and keeps TF32 off;
* the spans and ``COUNTS`` of the cascade under a CPU profiler, and the
  outputs bitwise alike with and without one.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark.reference import itd_fourier as ref
from pyitd_tpu.decomp import itd_fourier as jif
from pyitd_tpu_torch.decomp import itd_fourier as tif

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(4096, 256), (4096, 1024), (4096, 2048)]
IDS = ["sr256", "sr1024", "sr2048"]


def bench_signal(n, sr, seed=4):
    """Bench config 5b's signal (``bench.py:256-261``) at ``(n, sr)``."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return (np.sin(2 * np.pi * 50 * t) + 0.6 * np.sin(2 * np.pi * 220 * t)
            + 0.2 * rng.normal(size=n))


def scale(x):
    return float(np.abs(np.asarray(x)).max())


def gap(a, b):
    def f64(v):
        return torch.from_numpy(np.array(v, dtype=np.float64))
    return float((f64(a) - f64(b)).abs().max())


@pytest.mark.parametrize("n,sr", SHAPES + [(1 << 20, 2048)],
                         ids=IDS + ["cell"])
def test_reference_knots_are_the_ports(n, sr):
    pos, counts, freqs = tif._sine_template_np(sr, n)
    assert ref.comb(sr) == [int(f) for f in freqs]
    got = ref.knots(sr, n)
    assert len(got) == len(counts)
    for e, p, c in zip(got, pos, counts):
        assert e.numel() == c
        np.testing.assert_array_equal(e.numpy(), p[:c])


def test_reference_comb_at_the_cell():
    assert ref.comb(2048) == [866, 770, 674, 578, 482, 386, 290, 194, 98, 2]
    assert len(ref.comb(256)) == 1 and len(ref.comb(1024)) == 5


@pytest.mark.parametrize("n,sr", SHAPES, ids=IDS)
def test_reference_matches_jax_f64(n, sr):
    x = bench_signal(n, sr)
    want = jax.jit(lambda a: jif.cascade_iteration(a, sr))(jnp.asarray(x))
    new, is_mode, _, rotations, residual = (np.asarray(v) for v in want)
    jmodes = np.asarray(jax.jit(jif.fourier_mode_any)(jnp.asarray(rotations)))
    got = ref.cascade_iteration(torch.from_numpy(x), sr)
    tol = 1e-12 * scale(x)
    assert gap(got["rotations"], rotations) <= tol
    assert gap(got["residual"], residual) <= tol
    np.testing.assert_array_equal(got["is_mode"].numpy(), is_mode)
    modes = torch.fft.irfft(got["mode_spectra"], n)
    assert gap(modes, jmodes * is_mode[:, None]) <= tol
    assert gap(got["update"], new) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-6)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n,sr", SHAPES, ids=IDS)
def test_port_matches_reference(n, sr, dtype, tol):
    x = torch.from_numpy(bench_signal(n, sr, seed=7)).to(dtype)
    want = ref.cascade_iteration(x, sr)
    new, is_mode, spectra, rotations, residual = tif.cascade_iteration(
        x, sr, device="cpu")
    lim = tol * scale(x)
    assert rotations.dtype == dtype
    assert gap(rotations, want["rotations"]) <= lim
    assert gap(residual, want["residual"]) <= lim
    # the modes, keep flags and update against the reference's band
    # extraction on the port's own rotations
    modes, keep = ref.band_modes(rotations)
    assert torch.equal(is_mode, keep)
    assert keep.any()
    assert gap(torch.fft.irfft(spectra.to(torch.complex128), n), modes) \
        <= lim
    assert gap(new, x.double() - modes.sum(0)) <= lim


@pytest.mark.parametrize("n,sr", SHAPES, ids=IDS)
def test_control_parts_from_the_port(n, sr):
    x = torch.from_numpy(bench_signal(n, sr, seed=11)).float()
    want = ref.cascade_iteration(x, sr)
    low = ref.cascade_iteration(x, sr, torch.bfloat16)
    port = tif.cascade_iteration(x, sr, device="cpu")
    s = scale(x)
    port_gap = gap(port[3], want["rotations"]) / s
    low_gap = gap(low["rotations"], want["rotations"]) / s
    assert port_gap < 2e-6
    assert low_gap > 1e-3 > 100 * port_gap


def test_reference_takes_nothing_of_either_package():
    out = subprocess.run(
        [sys.executable, "-c",
         "import benchmark.reference.itd_fourier, sys, torch\n"
         "print(torch.backends.cuda.matmul.allow_tf32,"
         " torch.backends.cudnn.allow_tf32)\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    flags, top = out.stdout.splitlines()
    assert flags == "False False"
    assert not set(top.split()) & {"pyitd_tpu_torch", "pyitd_tpu", "jax",
                                   "jaxlib", "flax"}


def profiled_iteration(x, sr):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = tif.cascade_iteration(x, sr, device="cpu")
    names = [e.name for e in prof.events()]
    return out, {k: names.count(k) for k in (
        "pyitd.cascade_iteration", "pyitd.sine_sift",
        "pyitd.template_baseline", "pyitd.fourier_modes")}


@pytest.mark.parametrize("n,sr", SHAPES, ids=IDS)
def test_cascade_spans_and_counts(n, sr):
    x = torch.from_numpy(bench_signal(n, sr)).float()
    comb = len(ref.comb(sr))
    tif.reset_counts()
    _, spans = profiled_iteration(x, sr)
    assert spans == {"pyitd.cascade_iteration": 1, "pyitd.sine_sift": 1,
                     "pyitd.template_baseline": comb,
                     "pyitd.fourier_modes": 1}
    assert tif.COUNTS == {"iterations": 1, "templates": comb,
                          "transforms": comb + 1}
    tif.reset_counts()
    tif.cascade_iteration(x, sr, device="cpu")
    assert tif.COUNTS == {"iterations": 1, "templates": comb,
                          "transforms": comb + 1}


def test_cascade_counts_at_the_cell():
    """At sr 2,048 an iteration counts 10 templates and 11 transforms; a
    batch of rows counts a transform a row."""
    x = torch.from_numpy(np.stack([bench_signal(4096, 2048, s)
                                   for s in (1, 2, 3)])).float()
    tif.reset_counts()
    tif.cascade_iteration(x[0], 2048, device="cpu")
    assert tif.COUNTS == {"iterations": 1, "templates": 10, "transforms": 11}
    tif.reset_counts()
    tif.cascade_iteration(x, 2048, device="cpu")
    assert tif.COUNTS == {"iterations": 1, "templates": 10, "transforms": 33}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("n,sr", SHAPES, ids=IDS)
def test_outputs_bitwise_with_and_without_profiler(n, sr, dtype):
    x = torch.from_numpy(bench_signal(n, sr, seed=3)).to(dtype)
    plain = tif.cascade_iteration(x, sr, device="cpu")
    traced, _ = profiled_iteration(x, sr)
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)
