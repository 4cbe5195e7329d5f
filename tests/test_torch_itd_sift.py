"""The port's sift against the JAX package and the numpy oracle.

* f64 demo chirp against ``reference.itd_ref.itd_sift`` to 1e-11, counts
  and stop reasons exact;
* batched, flat, ``store_baselines=False``, ``early_exit``, NaN and the
  ``ITD`` class quirks against JAX ``backend="xla"`` (f64, 1e-12); the
  class runs on the card unless given ``device="cpu"``;
* f32 (2, 9000) with a NaN pair against JAX ``backend="pallas_fused"`` in
  interpret mode, level by level on JAX's own baselines (``1e-5 * max|x|``:
  XLA on the CPU fuses ``a*b+c`` into an FMA in f32, PyTorch does not, and
  a last-bit difference can flip a knot tie), with the port's own
  compensated reconstruction exact to 1e-10 in f64;
* the kernel route on the CPU (the wrappers' plain versions) bit for bit
  against the plain loop, with the launch counters left at 0, and its
  gradient against the plain structural route;
* the kernel route's loop without a summary pass per trip (each level
  emits its baseline's interior summaries, the next trip's scan completes
  them) bit for bit against the loop with one (rebuilt here from the same
  wrappers), trip by trip against JAX's fused sift on JAX's own baselines,
  and its wrapper calls per sift: 1 / ``levels + 1`` / ``levels + 1``;
* at n = 1 the port refuses (``ValueError`` from the sift, both baseline
  tiers and the sharded sift) where JAX returns one zero row with zero
  correction, which does not rebuild x (ROADMAP queue 3, a difference on
  purpose);
* ``import pyitd_tpu_torch`` (the ``ml`` family and the examples
  included) loads no JAX, flax or optax.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyitd_tpu import itd_sift as jax_sift
from pyitd_tpu import ITD as JaxITD
from pyitd_tpu_torch import (ITD, STOP_BUDGET, STOP_FLAT, itd_sift,
                             linear_baseline_extract, neumaier_sum,
                             reconstruction_error)
from pyitd_tpu_torch.ops import cuda_fill
from pyitd_tpu_torch.utils.interop import from_numpy, result_to_numpy
from reference.itd_ref import itd_sift as ref_sift

torch.set_num_threads(1)


def demo_chirp(n=400):
    T = np.linspace(0, 2 * np.pi, n)
    return np.sin(20 * T * (1 + 0.2 * T)) + T**2 + np.sin(13 * T)


def nan_pair_signal():
    rng = np.random.default_rng(2)
    t = np.linspace(0, 2 * np.pi, 9000)
    x = np.stack([
        np.sin(20 * t) + 0.1 * rng.normal(size=t.size),
        np.sin(7 * t) * (1 + 0.1 * t) + 0.05 * rng.normal(size=t.size),
    ]).astype(np.float32)
    x[1, 4000:4002] = np.nan
    return x


def bitwise_equal(a: np.ndarray, b: np.ndarray) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == np.float32:
        return bool(np.all((a.view(np.int32) == b.view(np.int32))
                           | (np.isnan(a) & np.isnan(b))))
    return np.array_equal(a, b)


def assert_matches_jax(got, want, atol):
    got = result_to_numpy(got)
    for f in ("rotations", "baselines", "correction"):
        np.testing.assert_allclose(getattr(got, f),
                                   np.asarray(getattr(want, f)),
                                   atol=atol, rtol=0, err_msg=f)
    for f in ("num_components", "stop_reason"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), err_msg=f)
        assert getattr(got, f).dtype == np.int32


def test_parity_with_numpy_oracle():
    for s, max_it in [(demo_chirp(), 11), (demo_chirp(257), 3)]:
        want, reason = ref_sift(s, max_iteration=max_it)
        res = itd_sift(from_numpy(s), max_it)
        n = int(res.num_components)
        assert n == want.shape[0]
        np.testing.assert_allclose(res.rotations[:n].numpy(), want,
                                   atol=1e-11, rtol=0)
        assert int(res.stop_reason) == (STOP_FLAT if reason == "A"
                                        else STOP_BUDGET)


def _jax_cases():
    rng = np.random.default_rng(4)
    t = np.linspace(0, 2 * np.pi, 400)
    batch = np.stack([demo_chirp(), demo_chirp() * 2 + 1,
                      np.sin(np.linspace(0, 40, 400))])
    flat = np.stack([demo_chirp(), np.zeros(400), t])  # zero row, monotone
    nan = batch.copy()
    nan[0, 100:102] = np.nan
    nan[2, 0] = np.nan
    noisy = np.sin(20 * t)[None] + 0.3 * rng.normal(size=(2, 400))
    yield "batched", batch, 5, {}
    yield "flat", flat, 5, {}
    yield "no-baselines", batch, 5, {"store_baselines": False}
    yield "early-exit", flat, 8, {"early_exit": True}
    yield "nan", nan, 4, {}
    yield "natural", noisy, 3, {"endpoint_mode": "natural"}
    yield "budget", noisy[:, :257], 1, {}


CASES = list(_jax_cases())


@pytest.mark.parametrize("name,x,max_it,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_matches_jax_xla_loop(name, x, max_it, kw):
    jkw = {k: v for k, v in kw.items() if k != "early_exit"}
    want = jax_sift(jnp.asarray(x), max_it, backend="xla", **jkw)
    got = itd_sift(from_numpy(x), max_it, **kw)
    assert_matches_jax(got, want, atol=1e-12)


def test_class_api_quirks_match_jax():
    for s in (demo_chirp(), np.linspace(0.0, 1.0, 64)):
        for max_it in (11, 2):
            j, t = JaxITD(), ITD(device="cpu", dtype=torch.float64)
            jr, tr = j.itd(s, max_iteration=max_it), t(s, max_iteration=max_it)
            np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-12,
                                       rtol=0)
            np.testing.assert_allclose(t.get_baselines().numpy(),
                                       np.asarray(j.get_baselines()),
                                       atol=1e-12, rtol=0)
    itd = ITD(as_numpy=True, device="cpu", dtype=None)
    rot = itd.itd(demo_chirp())
    assert isinstance(rot, np.ndarray)
    comps, residual = itd.get_rotations_and_residual()
    np.testing.assert_allclose(comps.sum(0) + residual, demo_chirp(),
                               atol=1e-9)
    with pytest.raises(ValueError):
        ITD(device="cpu").itd(np.zeros((2, 8)))
    with pytest.raises(ValueError):
        ITD("bogus", device="cpu")
    with pytest.raises(ValueError, match="No IPR"):
        ITD(device="cpu").get_rotations()


def test_class_runs_on_the_card_unless_asked_for_the_cpu():
    """``ITD()`` sifts on the card; without one it raises rather than run
    on the CPU.  With ``device="cpu"`` it moves its input there, cast to
    f32 unless given another ``dtype`` (``None`` keeps the input's)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ITD()
    with pytest.raises(RuntimeError, match="CUDA"):
        ITD(device="cuda:0")
    itd = ITD(device="cpu")
    assert itd.device == torch.device("cpu")
    rot = itd.itd(demo_chirp())
    assert rot.device.type == "cpu" and rot.dtype == torch.float32
    want = itd_sift(torch.from_numpy(demo_chirp()).float(), 11)
    assert torch.equal(rot, want.rotations[:int(want.num_components)])
    rot = ITD(device="cpu", dtype=None).itd(torch.from_numpy(demo_chirp()))
    assert rot.dtype == torch.float64


def test_f32_level_by_level_against_pallas_fused():
    x = nan_pair_signal()
    max_it = 3
    want = jax_sift(jnp.asarray(x), max_it, backend="pallas_fused")
    w_rot, w_base = np.asarray(want.rotations), np.asarray(want.baselines)
    atol = 1e-5 * np.nanmax(np.abs(x))
    inputs = [x] + [w_base[i] for i in range(w_base.shape[0] - 1)]
    checked = 0
    for i, inp in enumerate(inputs):
        cont = w_base[i] != 0  # rows still running at trip i
        rows = np.flatnonzero(np.any(cont, axis=-1))
        if rows.size == 0:
            continue
        lvl = linear_baseline_extract(from_numpy(inp[rows]))
        np.testing.assert_allclose(lvl.baseline.numpy(), w_base[i][rows],
                                   atol=atol, rtol=0, err_msg=f"level {i}")
        np.testing.assert_allclose(lvl.rotation.numpy(), w_rot[i][rows],
                                   atol=atol, rtol=0, err_msg=f"level {i}")
        checked += 1
    assert checked >= 3

    res = itd_sift(from_numpy(x), max_it)
    np.testing.assert_array_equal(res.num_components.numpy(),
                                  np.asarray(want.num_components))
    np.testing.assert_array_equal(res.stop_reason.numpy(),
                                  np.asarray(want.stop_reason))
    total = res.rotations.double().sum(0) + res.correction.double()
    err = (total - torch.from_numpy(x).double()).abs()
    assert torch.isnan(err).sum() == np.isnan(x).sum()
    assert float(err.nan_to_num(0.0).max()) <= 1e-10


KERNEL_ROUTE = [((2, 9000), 5, "reference"), ((3, 8192), 2, "natural"),
                ((2, 8320), 5, "natural"), ((2, 130), 5, "reference"),
                ((2, 2), 2, "reference")]


@pytest.mark.parametrize("shape,max_it,mode", KERNEL_ROUTE)
def test_kernel_route_on_cpu_is_bitwise_plain(shape, max_it, mode):
    rng = np.random.default_rng(shape[1])
    t = np.linspace(0, 2 * np.pi, shape[1])
    x = (np.sin(7 * t)[None] + 0.4 * rng.normal(size=shape)).astype(np.float32)
    if shape == (2, 9000):
        x[1, 4000:4002] = np.nan
        x[0, 4095:4097] = np.nan  # across a tile edge
    xt = torch.from_numpy(x)
    cuda_fill.reset_launches()
    for kw in ({}, {"store_baselines": False}, {"early_exit": True}):
        a = itd_sift(xt, max_it, endpoint_mode=mode, backend="torch", **kw)
        b = itd_sift(xt, max_it, endpoint_mode=mode, backend="kernel", **kw)
        a, b = result_to_numpy(a), result_to_numpy(b)
        for f in a._fields:
            assert bitwise_equal(getattr(a, f), getattr(b, f)), (kw, f)
    # CPU calls never launch a kernel
    assert all(v == 0 for v in cuda_fill.LAUNCHES.values())


def _sift_with_a_summary_pass_per_trip(x, max_iteration, endpoint_mode):
    """The kernel route's loop as it was before the levels emitted their
    summaries: ``level_states_cuda`` of every trip's input."""
    levels = max_iteration + 2
    first = cuda_fill.sift_level_cuda(x, cuda_fill.level_states_cuda(x),
                                      endpoint_mode=endpoint_mode)
    rot, base, perr = first.rotation, first.baseline, first.sub_err
    out = torch.empty((levels,) + tuple(x.shape))
    carry = cuda_fill.SiftCarry.zeros(x.shape[0], "cpu")
    prev_base = comp = x * 0
    for i in range(levels):
        states = cuda_fill.level_states_cuda(base, carry, trip=i,
                                             max_iteration=max_iteration)
        new = cuda_fill.sift_level_cuda(
            base, states, endpoint_mode=endpoint_mode, rotp=rot,
            pbase=prev_base, perr=perr, comp=comp, out_row=out[i])
        comp = new.comp
        rot, prev_base, base, perr = new.rotation, base, new.baseline, \
            new.sub_err
    return out, carry.ncomp, carry.reason, comp


NEW_LOOP = KERNEL_ROUTE + [((2, 4097), 4, "reference"),
                           ((2, 8192), 9, "natural"),
                           ((1, 12288), 3, "reference")]


@pytest.mark.parametrize("shape,max_it,mode", NEW_LOOP)
def test_kernel_route_without_summary_passes_equals_the_loop_with(
        shape, max_it, mode, monkeypatch):
    rng = np.random.default_rng(shape[1] + 1)
    t = np.linspace(0, 2 * np.pi, shape[1])
    x = (np.sin(5 * t)[None] + 0.4 * rng.normal(size=shape)).astype(np.float32)
    if shape[1] > 2 * cuda_fill.TILE:
        x[0, cuda_fill.TILE - 1:cuda_fill.TILE + 1] = np.nan
        x[0, 2 * cuda_fill.TILE - 2:2 * cuda_fill.TILE + 2] = 2.0
    xt = torch.from_numpy(x)
    want = _sift_with_a_summary_pass_per_trip(xt, max_it, mode)

    calls = {k: 0 for k in ("level_summaries_cuda", "tile_scan_cuda",
                            "sift_level_cuda")}
    for k in calls:
        def counted(*a, _fn=getattr(cuda_fill, k), _k=k, **kw):
            calls[_k] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(cuda_fill, k, counted)
    got = itd_sift(xt, max_it, endpoint_mode=mode, backend="kernel",
                   store_baselines=False)
    levels = max_it + 2
    assert calls == {"level_summaries_cuda": 1, "tile_scan_cuda": levels + 1,
                     "sift_level_cuda": levels + 1}
    for a, b in zip((got.rotations, got.num_components, got.stop_reason,
                     got.correction), want):
        assert bitwise_equal(a.numpy(), b.numpy())


def test_trips_without_a_summary_pass_against_pallas_fused():
    """Each trip as the new loop runs it (interior summaries of the trip's
    input, the scan that completes them, the emitting level) on JAX's own
    baselines, against JAX's fused sift."""
    x = nan_pair_signal()
    want = jax_sift(jnp.asarray(x), 3, backend="pallas_fused")
    w_rot, w_base = np.asarray(want.rotations), np.asarray(want.baselines)
    atol = 1e-5 * np.nanmax(np.abs(x))
    checked = 0
    for i, inp in enumerate([x] + [w_base[i] for i in range(len(w_base) - 1)]):
        rows = np.flatnonzero(np.any(w_base[i] != 0, axis=-1))
        if rows.size == 0:
            continue
        sig = torch.from_numpy(np.ascontiguousarray(inp[rows]))
        states = cuda_fill.tile_scan_cuda(cuda_fill.interior_summaries(sig),
                                          edges_from=sig)
        lvl = cuda_fill.sift_level_cuda(sig, states, emit=True)
        np.testing.assert_allclose(lvl.baseline.numpy(), w_base[i][rows],
                                   atol=atol, rtol=0, err_msg=f"level {i}")
        np.testing.assert_allclose(lvl.rotation.numpy(), w_rot[i][rows],
                                   atol=atol, rtol=0, err_msg=f"level {i}")
        for a, b in zip(lvl.interior,
                        cuda_fill.interior_summaries(lvl.baseline)):
            assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
        checked += 1
    assert checked >= 3


def test_compensated_correction_f32_exact():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, 4096)
    sigs = (np.sin(20 * t * (1 + 0.2 * t))[None]
            + 0.3 * rng.normal(size=(3, t.size))).astype(np.float32)
    for max_it in (9, 2):
        res = itd_sift(from_numpy(sigs), max_it, backend="kernel")
        rot = res.rotations.double()
        comp = (rot.sum(0) + res.correction.double()
                - torch.from_numpy(sigs).double()).abs().max()
        assert float(comp) <= 1e-10
        assert float(reconstruction_error(res.rotations.double(),
                                          torch.from_numpy(sigs).double()
                                          - res.correction.double())) <= 1e-10
    s = demo_chirp()
    res = itd_sift(from_numpy(s))
    n = int(res.num_components)
    total = neumaier_sum(res.rotations[:n]) + res.correction
    assert float((total - torch.from_numpy(s)).abs().max()) < 1e-13


def test_plain_route_is_differentiable_and_kernel_route_refuses_grad():
    """Both sift routes take a gradient; the kernel LEVEL has no backward of
    its own (as JAX's pallas level has none) and still refuses one."""
    s = torch.from_numpy(demo_chirp(128)).requires_grad_()
    r = itd_sift(s, 3, store_baselines=False)
    (r.rotations[0] ** 2).sum().backward()
    assert torch.isfinite(s.grad).all()
    sf = s.float().detach().requires_grad_()
    rk = itd_sift(sf, 3, backend="kernel")
    rp = itd_sift(sf, 3, backend="torch", linear_backend="structural")
    (gk,) = torch.autograd.grad((rk.rotations[0] ** 2).sum(), sf)
    (gp,) = torch.autograd.grad((rp.rotations[0] ** 2).sum(), sf)
    assert torch.isfinite(gk).all()
    np.testing.assert_allclose(gk.numpy(), gp.numpy(), rtol=0,
                               atol=1e-4 * gp.abs().max().item())
    assert not rk.num_components.requires_grad
    with torch.no_grad():
        assert not itd_sift(sf, 3, backend="kernel").rotations.requires_grad
    with pytest.raises(NotImplementedError, match="structural"):
        linear_baseline_extract(sf, backend="kernel")
    with pytest.raises(ValueError, match="f32"):
        itd_sift(s.detach(), 3, backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        itd_sift(s.detach(), 3, backend="bogus")


def test_single_sample_refused_where_jax_returns_zeros():
    from pyitd_tpu_torch import cubic_baseline_extract
    from pyitd_tpu_torch.parallel import LocalGroup, sharded_itd_sift

    x = np.array([[2.5], [-1.0]])
    r = jax_sift(jnp.asarray(x), 3)
    assert np.asarray(r.rotations).shape == (5, 2, 1)
    assert not np.asarray(r.rotations).any()
    assert not np.asarray(r.correction).any()
    np.testing.assert_array_equal(np.asarray(r.num_components), [1, 1])
    rebuilt = np.asarray(r.rotations).sum(0) + np.asarray(r.correction)
    assert np.abs(rebuilt - x).max() > 0  # JAX's result does not rebuild x
    xt = torch.from_numpy(x)
    for call in (lambda: itd_sift(xt, 3), lambda: itd_sift(xt[0, :1], 3),
                 lambda: linear_baseline_extract(xt),
                 lambda: cubic_baseline_extract(xt, 8),
                 lambda: sharded_itd_sift(xt, LocalGroup(1), 3)):
        with pytest.raises(ValueError, match="at least 2 samples"):
            call()


def test_import_loads_no_jax():
    code = ("import sys, pyitd_tpu_torch, pyitd_tpu_torch.ops.cuda_fill, "
            "pyitd_tpu_torch.utils.interop, pyitd_tpu_torch.parallel, "
            "pyitd_tpu_torch.parallel.comm, pyitd_tpu_torch.parallel.sharded, "
            "pyitd_tpu_torch.parallel.batch, pyitd_tpu_torch.ops.wpe, "
            "pyitd_tpu_torch.utils.stats, pyitd_tpu_torch.decomp.meitd, "
            "pyitd_tpu_torch.decomp.meitd_jit, "
            "pyitd_tpu_torch.decomp.ensemble, pyitd_tpu_torch.decomp.itd2d, "
            "pyitd_tpu_torch.decomp.serial2d, pyitd_tpu_torch.decomp.efd, "
            "pyitd_tpu_torch.decomp.itd_fourier, "
            "pyitd_tpu_torch.tools.fourier_bench, "
            "pyitd_tpu_torch.decomp.streaming, pyitd_tpu_torch.decomp.trend, "
            "pyitd_tpu_torch.decomp.lindeberg, pyitd_tpu_torch.decomp.stirft, "
            "pyitd_tpu_torch.decomp.fabada, pyitd_tpu_torch.decomp.svmd, "
            "pyitd_tpu_torch.decomp.aft, pyitd_tpu_torch.utils.device_loop, "
            "pyitd_tpu_torch.ml, pyitd_tpu_torch.ml.activations, "
            "pyitd_tpu_torch.ml.zoo, pyitd_tpu_torch.ml.layers, "
            "pyitd_tpu_torch.ml.phase, pyitd_tpu_torch.ml.kalman, "
            "pyitd_tpu_torch.ml.visualizer, pyitd_tpu_torch.ml.optimizers, "
            "pyitd_tpu_torch.ml.parseval, pyitd_tpu_torch.ml.newgpt, "
            "pyitd_tpu_torch.ml.tape, pyitd_tpu_torch.ml.ultramem, "
            "pyitd_tpu_torch.ml.checkpoint, pyitd_tpu_torch.ml._init, "
            "pyitd_tpu_torch.ml.moe, pyitd_tpu_torch.ml.blockfast, "
            "pyitd_tpu_torch.ml.vte, pyitd_tpu_torch.parallel.train, "
            "pyitd_tpu_torch.parallel.pipeline, "
            "pyitd_tpu_torch.tools.vte_conditioning, "
            "pyitd_tpu_torch.examples.train_tiny, "
            "pyitd_tpu_torch.examples.train_through_itd, "
            "pyitd_tpu_torch.examples.quickstart, "
            "pyitd_tpu_torch.examples.train_parallel, "
            "pyitd_tpu_torch.examples.multichip, "
            "pyitd_tpu_torch.examples.realtime_stream, "
            "pyitd_tpu_torch.runtime; "
            "assert pyitd_tpu_torch.runtime.native_available(); "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'flax' not in sys.modules, 'flax imported'; "
            "assert 'optax' not in sys.modules, 'optax imported'; "
            "assert 'pyitd_tpu' not in sys.modules, 'pyitd_tpu imported'")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=root)
