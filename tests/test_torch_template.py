"""The port's template cubic tier (``pyitd_tpu_torch/ops/tridiag.py::
reference_spline_moments`` and ``ops/cubic_baseline.py::
template_fast_baseline``) and its sine-template buffers against the JAX
package's, on the same numpy inputs, on the CPU.

* ``reference_spline_moments``: each method in f64 against the same JAX
  method to 1e-12; ``"scan"`` against ``"affine"`` and ``"banded"`` to
  1e-9 on the cases of ``tests/test_itd_fourier.py:199-215``;
* ``template_fast_baseline``, the dynamic path and the static path
  against JAX in f64 to 1e-12, in f32 to 1e-6 of max|x|; the port's static
  path is the gather route only, held against both of JAX's routes (its
  periodic GEMM route, which engages on the comb's two densest entries,
  as ``tests/test_itd_fourier.py:251-276``, and its gather route) and
  against the port's dynamic path;
* the f32 ceiling at 2^24 on a meta tensor (nothing allocated);
* the template buffers bitwise JAX's, the no-crossing ``[0, 0]`` case
  included; the host and device constants built once per comb entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyitd_tpu.decomp import itd_fourier as jif
from pyitd_tpu.ops import cubic_baseline as jcb
from pyitd_tpu.ops.tridiag import reference_spline_moments as jax_moments
from pyitd_tpu_torch import template_fast_baseline
from pyitd_tpu_torch.decomp import itd_fourier as tif
from pyitd_tpu_torch.ops import cubic_baseline as tcb
from pyitd_tpu_torch.ops.tridiag import reference_spline_moments

torch.set_num_threads(1)
CPU = "cpu"

# tests/test_itd_fourier.py:207: (capacity, count) of the moment cases
MOMENT_CASES = [(16, 13), (64, 64), (33, 2), (8, 3), (128, 97)]


def _moment_inputs(cap, cnt, seed):
    rng = np.random.default_rng(seed)
    knots = rng.normal(size=(3, cap))
    h = rng.integers(1, 9, size=(3, cap)).astype(np.float64)
    count = np.asarray([cnt, max(cnt - 1, 2), min(cnt + 1, cap)], np.int32)
    return knots, h, count


def _moments(knots, h, count, method):
    return reference_spline_moments(
        torch.from_numpy(knots), torch.from_numpy(h),
        torch.from_numpy(count), method=method).numpy()


@pytest.mark.parametrize("method", ["scan", "affine", "banded"])
def test_reference_moments_match_jax(method):
    for i, (cap, cnt) in enumerate(MOMENT_CASES):
        knots, h, count = _moment_inputs(cap, cnt, i)
        want = np.asarray(jax.jit(jax_moments, static_argnames="method")(
            jnp.asarray(knots), jnp.asarray(h), jnp.asarray(count),
            method=method))
        np.testing.assert_allclose(_moments(knots, h, count, method), want,
                                   rtol=0, atol=1e-12, err_msg=str(cap))


@pytest.mark.parametrize("method", ["affine", "banded"])
def test_reference_moments_doubling_matches_scan(method):
    rng = np.random.default_rng(0)
    for cap, cnt in MOMENT_CASES:
        knots = rng.normal(size=(3, cap))
        h = rng.integers(1, 9, size=(3, cap)).astype(np.float64)
        count = np.asarray([cnt, max(cnt - 1, 2), min(cnt + 1, cap)],
                           np.int32)
        np.testing.assert_allclose(_moments(knots, h, count, method),
                                   _moments(knots, h, count, "scan"),
                                   rtol=1e-9, atol=1e-9, err_msg=str(cap))


def test_reference_moments_auto_is_scan_on_the_cpu():
    knots, h, count = _moment_inputs(64, 50, 7)
    np.testing.assert_array_equal(_moments(knots, h, count, "auto"),
                                  _moments(knots, h, count, "scan"))
    with pytest.raises(ValueError, match="unknown method"):
        _moments(knots, h, count, "thomas")


@pytest.mark.parametrize("method", ["scan", "affine", "banded"])
def test_reference_moments_take_a_python_count(method):
    """An int count (the static path's) gives the bits of the same count
    as a tensor."""
    knots, h, _ = _moment_inputs(64, 50, 8)
    k, hh = torch.from_numpy(knots), torch.from_numpy(h)
    assert torch.equal(
        reference_spline_moments(k, hh, 50, method=method),
        reference_spline_moments(k, hh, torch.tensor([50, 50, 50]),
                                 method=method))


def _signal(n, sr, rows=2, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = np.sin(2 * np.pi * 50 * t) + 0.2 * rng.normal(size=n)
    return np.stack([x, -0.5 * x + 0.1 * rng.normal(size=n)])[:rows]


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-6)])
def test_template_dynamic_path_matches_jax(dtype, tol):
    sr, n = 400, 2000
    x = _signal(n, sr).astype(dtype)
    pos, counts, _ = jif.sine_template_positions(sr, n)
    pos, counts = np.asarray(pos), np.asarray(counts)
    # one comb entry per row (f64), and one shared by both rows (f32)
    p, c = ((pos[[1, 0]], counts[[1, 0]]) if dtype == np.float64
            else (pos[0], counts[0]))
    want = np.asarray(jax.jit(jcb.template_fast_baseline)(
        jnp.asarray(x), jnp.asarray(p), jnp.asarray(c)))
    got = template_fast_baseline(
        torch.from_numpy(x), torch.from_numpy(p.copy()),
        torch.from_numpy(np.asarray(c).copy()))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * np.abs(x).max())


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-6)])
def test_template_static_path_matches_jax(periodic, dtype, tol):
    """The port's gather route against JAX's periodic GEMM route (with the
    period hint) and against JAX's gather route (without)."""
    sr, n = 400, 8192
    x = _signal(n, sr).astype(dtype)
    engaged = 0
    for pos_np, cnt, hint in jif._sine_template_static(sr, n):
        hint = hint if periodic else None
        want = np.asarray(jax.jit(
            lambda a: jcb._template_fast_baseline_static(
                a, pos_np, cnt, period_hint=hint))(jnp.asarray(x)))
        got = template_fast_baseline(x, pos_np, cnt, device=CPU)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=tol * np.abs(x).max())
        if hint is not None:
            tpl = tcb._StaticTemplate(pos_np, cnt, n)
            engaged += jcb._template_period_plan(
                tpl.pos, cnt, n, hint, tpl.h64, tpl.seg) is not None
    assert engaged == (2 if periodic else 0)


def test_template_static_matches_dynamic():
    """The static path (host segment map, one row gather) against the
    dynamic path (scatter and forward fill) on every comb entry."""
    sr, n = 400, 8192
    x = torch.from_numpy(_signal(n, sr))
    buf, counts, _ = tif._sine_template_np(sr, n)
    for p, c in zip(buf, counts):
        a = template_fast_baseline(x, p, int(c))
        b = template_fast_baseline(x, torch.from_numpy(p.copy()),
                                   torch.tensor(int(c)))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-12 * float(x.abs().max()))


def test_template_period_hint_changes_nothing():
    """``period_hint`` is JAX's knob for its TPU matrix-unit route, which
    is not ported: with the hints JAX's comb gives (both engaged and not),
    the result is bitwise the call's without it."""
    sr, n = 400, 8192
    x = torch.from_numpy(_signal(n, sr))
    for pos_np, cnt, hint in jif._sine_template_static(sr, n):
        a = template_fast_baseline(x, pos_np, cnt, period_hint=hint)
        b = template_fast_baseline(x, pos_np, cnt)
        assert torch.equal(a, b)
        c = template_fast_baseline(x, torch.from_numpy(pos_np.copy()),
                                   torch.tensor(cnt), period_hint=hint)
        assert torch.equal(c, template_fast_baseline(
            x, torch.from_numpy(pos_np.copy()), torch.tensor(cnt)))


def test_template_static_refuses_another_length():
    tpl = tif._sine_template_static(400, 8192)[0]
    with pytest.raises(ValueError, match="laid out for n=8192"):
        tcb._template_fast_baseline_static(torch.zeros(4096,
                                                       dtype=torch.float64),
                                           tpl)


def test_template_constants_are_built_once():
    """The comb's templates are cached with their device constants: a
    second sift builds and uploads nothing, and a caller's own copy of a
    grid gives the same bits."""
    sr, n = 400, 8192
    x = torch.from_numpy(_signal(n, sr))
    tif.itd_sine_sift(x, sr)
    tpls = tif._sine_template_static(sr, n)
    consts = [t.consts(x.device, x.dtype) for t in tpls]
    rot = tif.itd_sine_sift(x, sr)[0]
    assert tif._sine_template_static(sr, n) is tpls
    assert all(t.consts(x.device, x.dtype) is c
               for t, c in zip(tpls, consts))
    assert tpls[0].consts(x.device, torch.float32) is not consts[0]
    buf, counts, _ = tif._sine_template_np(sr, n)
    assert torch.equal(x - template_fast_baseline(x, buf[0].copy(),
                                                  int(counts[0])), rot[0])


def test_template_keeps_the_callers_matmul_precision():
    sr, n = 400, 8192
    buf, counts, _ = tif._sine_template_np(sr, n)
    x = torch.from_numpy(_signal(n, sr).astype(np.float32))
    want = template_fast_baseline(x, buf[0], int(counts[0]))
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        got = template_fast_baseline(x, buf[0], int(counts[0]))
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(got, want)


def test_template_f32_ceiling():
    """The f32 sample grid aliases past 2^24: refuse, on a meta tensor
    (no samples allocated)."""
    n_big = (1 << 24) + 8
    pos = np.zeros(16, np.int64)
    pos[:8] = np.arange(8) * (n_big // 8)
    x = torch.empty(n_big, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="f32 sample-grid ceiling"):
        template_fast_baseline(x, pos, 8)
    with pytest.raises(ValueError, match="f32 sample-grid ceiling"):
        template_fast_baseline(x, torch.from_numpy(pos), torch.tensor(8))


@pytest.mark.parametrize("sr,n", [(1000, 1000), (1000, 200), (400, 8192),
                                  (2048, 4096)])
def test_sine_template_buffers_bitwise_jax(sr, n):
    want_buf, want_cnt, want_f = jif._sine_template_np(sr, n)
    buf, cnt, freqs = tif._sine_template_np(sr, n)
    np.testing.assert_array_equal(buf, want_buf)
    assert buf.dtype == want_buf.dtype and cnt.dtype == want_cnt.dtype
    np.testing.assert_array_equal(cnt, want_cnt)
    np.testing.assert_array_equal(freqs, want_f)
    for tpl, (wp, wc, _) in zip(tif._sine_template_static(sr, n),
                                jif._sine_template_static(sr, n),
                                strict=True):
        assert tpl.count == wc and tpl.pos.size == wc + 2
        np.testing.assert_array_equal(tpl.pos[:wc], wp[:wc])
        np.testing.assert_array_equal(tpl.pos[wc:], 0)
    pos, counts, _ = tif.sine_template_positions(sr, n, device=CPU)
    np.testing.assert_array_equal(pos.numpy(), want_buf)
    np.testing.assert_array_equal(counts.numpy(), want_cnt)
    if n == 200:
        # no interior crossing: the reference's degenerate [0, 0] pair
        assert int(freqs[-1]) == 2 and int(cnt[-1]) == 2
        np.testing.assert_array_equal(buf[-1, :2], [0, 0])


def test_template_f64_gradient_matches_jax():
    """Autograd of the port's static path against ``jax.grad`` of JAX's
    static path (given the period hint), in f64."""
    sr, n = 400, 2000
    x = _signal(n, sr, rows=1)[0]
    pos_np, cnt, hint = jif._sine_template_static(sr, n)[0]
    wts = np.cos(np.arange(n) / 17.0)

    def jloss(a):
        return jnp.sum(jnp.asarray(wts) * jcb.template_fast_baseline(
            a, pos_np, cnt, period_hint=hint) ** 2)

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(x)))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    loss = (torch.from_numpy(wts) * template_fast_baseline(
        xt, pos_np, cnt) ** 2).sum()
    (g,) = torch.autograd.grad(loss, xt)
    np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-10)
