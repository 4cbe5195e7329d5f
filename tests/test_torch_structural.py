"""The structural backward of the port against the JAX package, on the CPU.

* one level, f64: ``structural_level_bwd(fills="torch")`` against JAX
  ``_structural_level_bwd(fills="scan")`` and against autograd of the
  port's own gather level, to 1e-12 (as ``tests/test_itd_sift.py:293-305``);
* one level, f32: ``fills="kernel"`` on a CPU tensor (the plain versions of
  fill2 and segsum) against JAX ``fills="pallas"`` in interpret mode, to
  rtol = atol = 2e-4, and no looser than the torch route against an f64
  truth (``tests/test_pallas_fill.py:394-404``);
* the whole sift, f64: ``linear_backend="structural"`` against
  ``jax.grad`` of ``_itd_sift_xla(..., linear_backend="structural")`` and
  against the port's autograd route, to 1e-11;
* the kernel route with a gradient, f32 on the CPU: forward bit for bit
  the plain loop's, gradient against the plain structural route, and two
  fill2 and four segsum calls per level that reaches the loss;
* the trainer of ``examples/train_through_itd.py``, f64: the taps gradient
  against ``jax.grad`` of the same loss to 1e-10, at the start and after 3
  SGD steps applied to both sides.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyitd_tpu.decomp.itd import _itd_sift_xla
from pyitd_tpu.decomp.itd import itd_sift as jax_sift
from pyitd_tpu.ops.linear_baseline import _structural_level_bwd
from pyitd_tpu_torch import itd_sift, linear_baseline_extract
from pyitd_tpu_torch.examples import train_through_itd as trainer
from pyitd_tpu_torch.ops import cuda_fill
from pyitd_tpu_torch.ops.linear_baseline import (
    linear_baseline_extract_structural, structural_level_bwd)
from pyitd_tpu_torch.utils.interop import from_numpy, result_to_numpy

torch.set_num_threads(1)


def _signals():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, 384)
    yield "chirp", np.stack([
        np.sin(20 * t * (1 + 0.2 * t)) + np.sin(13 * t)
        + 0.1 * rng.normal(size=384),
        np.sin(5 * t) + 0.3 * t])
    yield "plateaus", np.round(rng.normal(size=(2, 384)) * 2)
    nan = rng.normal(size=(2, 384))
    nan[0, 100:102] = np.nan
    yield "nan", nan
    yield "short", rng.normal(size=(3, 2))


SIGNALS = list(_signals())


def _cts(x, seed=1):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=x.shape) for _ in range(3))


@pytest.mark.parametrize("mode", ["reference", "natural"])
@pytest.mark.parametrize("name,x", SIGNALS, ids=[s[0] for s in SIGNALS])
def test_torch_adjoint_matches_jax_scan_and_autograd_f64(name, x, mode):
    cts = _cts(x)
    want = _structural_level_bwd(jnp.asarray(x), *map(jnp.asarray, cts),
                                 mode, fills="scan")
    got = structural_level_bwd(from_numpy(x), *map(from_numpy, cts), mode,
                               fills="torch")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    if name == "nan":
        return  # autograd carries the NaN into the running sums
    xt = from_numpy(x).requires_grad_()
    r = linear_baseline_extract(xt, endpoint_mode=mode)
    (g_ad,) = torch.autograd.grad([r.rotation, r.baseline, r.sub_err], xt,
                                  [from_numpy(c) for c in cts])
    np.testing.assert_allclose(got.numpy(), g_ad.numpy(), rtol=0, atol=1e-12)


def test_kernel_fills_on_cpu_match_jax_pallas_f32():
    rng = np.random.default_rng(11)
    n = 8322
    t = np.linspace(0, 4 * np.pi, n)
    sig = np.stack([np.sin(9 * t) + 0.2 * rng.standard_normal(n),
                    rng.standard_normal(n)])
    x = sig.astype(np.float32)
    cts = tuple(rng.normal(size=x.shape).astype(np.float32)
                for _ in range(3))
    g_pal = np.asarray(_structural_level_bwd(
        jnp.asarray(x), *map(jnp.asarray, cts), "reference",
        fills="pallas"))
    cuda_fill.reset_launches()
    g_ker = structural_level_bwd(from_numpy(x), *map(from_numpy, cts),
                                 "reference", fills="kernel").numpy()
    g_tor = structural_level_bwd(from_numpy(x), *map(from_numpy, cts),
                                 "reference", fills="torch").numpy()
    assert all(v == 0 for v in cuda_fill.LAUNCHES.values())
    np.testing.assert_allclose(g_ker, g_pal, rtol=2e-4, atol=2e-4)
    g_true = structural_level_bwd(
        from_numpy(x).double(), *(from_numpy(c).double() for c in cts),
        "reference", fills="torch").numpy()
    err_ker = np.abs(g_ker - g_true).max()
    err_tor = np.abs(g_tor - g_true).max()
    assert err_ker <= err_tor * 1.5 + 1e-6, (err_ker, err_tor)


def test_structural_level_function():
    """Unused outputs arrive as no cotangent; the count is not
    differentiable; a bad ``fills`` raises."""
    x = SIGNALS[0][1]
    xt = from_numpy(x).requires_grad_()
    r = linear_baseline_extract_structural(xt, backend="torch")
    assert not r.num_extrema.requires_grad
    (g,) = torch.autograd.grad(r.rotation.sum(), xt)
    zero = torch.zeros_like(xt)
    want = structural_level_bwd(xt.detach(), torch.ones_like(zero), zero,
                                zero, "reference", fills="torch")
    assert torch.equal(g, want)
    with pytest.raises(ValueError, match="fills"):
        structural_level_bwd(xt.detach(), zero, zero, zero, "reference",
                             fills="bogus")
    with pytest.raises(ValueError, match="f32"):
        structural_level_bwd(xt.detach(), zero, zero, zero, "reference",
                             fills="kernel")


def _loss(r):
    return ((r.rotations ** 2).sum() + (r.baselines ** 2).sum()
            + (r.correction * 0.7).sum())


def test_sift_grad_f64_matches_jax_structural():
    x = SIGNALS[0][1]

    def jloss(a):
        r = _itd_sift_xla(a, 4, "reference", True,
                          linear_backend="structural")
        return (jnp.sum(jnp.square(r.rotations)) + jnp.sum(r.baselines ** 2)
                + jnp.sum(r.correction * 0.7))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(_loss(itd_sift(
        xt, 4, backend="torch", linear_backend="structural")), xt)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-11)
    (g_ad,) = torch.autograd.grad(_loss(itd_sift(xt, 4, backend="torch")),
                                  xt)
    np.testing.assert_allclose(got.numpy(), g_ad.numpy(), rtol=0,
                               atol=1e-11)
    with pytest.raises(ValueError, match="linear_backend"):
        itd_sift(xt, 4, linear_backend="bogus")


def _count_calls(monkeypatch):
    calls = {"fill2": 0, "segsum": 0}
    for name in calls:
        fn = getattr(cuda_fill, f"{name}_cuda")

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(cuda_fill, f"{name}_cuda", counted)
    return calls


KERNEL_GRAD = [((2, 9000), 5, {}), ((3, 130), 3, {"store_baselines": False}),
               ((2, 8320), 4, {"early_exit": True})]


@pytest.mark.parametrize("shape,max_it,kw", KERNEL_GRAD)
def test_kernel_route_grad_on_cpu_f32(monkeypatch, shape, max_it, kw):
    """Tolerance: the two routes differ only in the segment sums (direct
    sums against differences of row-long running sums), a few ulp of the
    running sums' magnitude; 1e-4 * max|g| at these sizes."""
    rng = np.random.default_rng(shape[1])
    t = np.linspace(0, 2 * np.pi, shape[1])
    x = (np.sin(7 * t)[None] + 0.4 * rng.normal(size=shape)).astype(
        np.float32)
    if shape[1] > 4100:
        x[0, 4095:4097] = np.nan  # across a tile edge
    calls = _count_calls(monkeypatch)
    xk = from_numpy(x).requires_grad_()
    rk = itd_sift(xk, max_it, backend="kernel", **kw)
    xp = from_numpy(x).requires_grad_()
    rp = itd_sift(xp, max_it, backend="torch", linear_backend="structural",
                  **kw)
    a, b = result_to_numpy(rk), result_to_numpy(rp)
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert calls == {"fill2": 0, "segsum": 0}

    _loss(rk).backward()
    levels = max_it + 2
    if kw.get("early_exit"):
        levels = int(rk.num_components.max())
    # every extraction but the last trip's reaches the loss
    assert calls == {"fill2": 2 * levels, "segsum": 4 * levels}
    _loss(rp).backward()
    gk, gp = xk.grad.numpy(), xp.grad.numpy()
    np.testing.assert_array_equal(np.isnan(gk), np.isnan(gp))
    ok = ~np.isnan(gp)
    np.testing.assert_allclose(gk[ok], gp[ok], rtol=0,
                               atol=1e-4 * np.abs(gp[ok]).max())


def test_kernel_route_grad_through_rotations_only():
    """A loss on one output sends no cotangent to the others."""
    x = SIGNALS[0][1].astype(np.float32)
    xk = from_numpy(x).requires_grad_()
    (gk,) = torch.autograd.grad(itd_sift(xk, 3, backend="kernel")
                                .rotations[0].square().sum(), xk)
    (gp,) = torch.autograd.grad(itd_sift(
        xk, 3, backend="torch", linear_backend="structural")
        .rotations[0].square().sum(), xk)
    np.testing.assert_allclose(gk.numpy(), gp.numpy(), rtol=0,
                               atol=1e-4 * gp.abs().max().item())


def _jax_trainer_loss(x, target):
    """``examples/train_through_itd.py:36-47``."""
    def prefilter(taps, sig):
        pad = taps.shape[0] // 2
        s = jnp.pad(sig, ((0, 0), (pad, pad)), mode="edge")
        windows = jnp.stack(
            [s[:, i: i + sig.shape[1]] for i in range(taps.shape[0])],
            axis=-1)
        return windows @ taps

    def loss_fn(taps):
        res = jax_sift(prefilter(taps, x), 6, store_baselines=False)
        return jnp.mean(jnp.square(res.rotations[0] - target))

    return loss_fn


@pytest.mark.parametrize("linear_backend", ["auto", "structural"])
def test_trainer_grad_f64_matches_jax(linear_backend):
    xn, hi = trainer.make_problem()
    jloss = _jax_trainer_loss(jnp.asarray(xn), jnp.asarray(hi))
    jgrad = jax.jit(jax.grad(jloss))
    x, target = from_numpy(xn), from_numpy(hi)
    taps = trainer.identity_taps()
    for step in range(4):
        want = np.asarray(jgrad(jnp.asarray(taps)))
        tt = from_numpy(taps).requires_grad_()
        loss = trainer.loss_fn(tt, x, target, backend="torch",
                               linear_backend=linear_backend)
        (got,) = torch.autograd.grad(loss, tt)
        np.testing.assert_allclose(float(loss.detach()), float(jloss(taps)),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10,
                                   err_msg=f"step {step}")
        taps = taps - 0.05 * want  # the same SGD step on both sides
