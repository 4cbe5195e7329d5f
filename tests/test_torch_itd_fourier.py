"""The port's sine-template ITD and ITD-Fourier cascade
(``pyitd_tpu_torch/decomp/itd_fourier.py``) against the JAX package's, on
the same numpy inputs, on the CPU.

* ``itd_sine_sift`` against JAX in f64 to 1e-12, 1-D and batched (the
  ``(F, batch, n)`` layout), and its gradient against ``jax.grad`` to
  1e-10;
* ``fourier_mode_any`` and ``fourier_mode_valid`` against JAX to 1e-12 on
  the cases of ``tests/test_itd_fourier.py:92-121``, the degenerate zeros
  included;
* ``cascade_iteration`` in both modes: ``is_mode`` equal, the arrays to
  1e-12 of their scale;
* the cascade and the lean cascade: JAX's component count, each component
  to 1e-9 of JAX's, reconstruction to 1e-8;
* a noise-floor input that pins the keep decision (``any(V*w != 0)``
  keeps a band of 1e-12 energy, ROADMAP queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyitd_tpu.decomp import itd_fourier as jif
from pyitd_tpu_torch import itd_fourier_decomposition, itd_sine_sift
from pyitd_tpu_torch.decomp import itd_fourier as tif

torch.set_num_threads(1)
CPU = "cpu"


def _two_tones(n, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return (np.sin(2 * np.pi * 25 * t) + 0.4 * np.sin(2 * np.pi * 80 * t)
            + 0.05 * rng.normal(size=n))


def test_sine_sift_matches_jax():
    sr, n = 1000, 1000
    x = _two_tones(n, sr, 0)
    jr, js = jax.jit(lambda a: jif.itd_sine_sift(a, sr))(jnp.asarray(x))
    tr, ts = itd_sine_sift(x, sr, device=CPU)
    assert tr.shape == jr.shape
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(tr.numpy().sum(0) + ts.numpy(), x, atol=1e-12)


def test_sine_sift_batched_layout():
    """For input (batch, n) the rotations are (F, batch, n), each batch row
    the 1-D result."""
    sr, n = 256, 1000
    x2 = np.random.default_rng(5).standard_normal((3, n))
    jr, js = jax.jit(lambda a: jif.itd_sine_sift(a, sr))(jnp.asarray(x2))
    tr, ts = itd_sine_sift(torch.from_numpy(x2), sr)
    one, one_res = itd_sine_sift(torch.from_numpy(x2[1]), sr)
    assert tr.shape == (one.shape[0], 3, n) and ts.shape == (3, n)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-12)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-12)
    np.testing.assert_allclose(tr[:, 1].numpy(), one.numpy(), atol=1e-12)
    np.testing.assert_allclose(ts[1].numpy(), one_res.numpy(), atol=1e-12)


def test_sine_sift_gradient_matches_jax():
    sr, n = 400, 800
    x = _two_tones(n, sr, 1)
    wts = np.random.default_rng(2).normal(size=n)

    def jloss(a):
        rot, res = jif.itd_sine_sift(a, sr)
        return (jnp.sum(jnp.asarray(wts) * rot[0] ** 2)
                + jnp.sum(rot[-1] * res))

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(x)))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    rot, res = itd_sine_sift(xt, sr)
    loss = (torch.from_numpy(wts) * rot[0] ** 2).sum() + (rot[-1] * res).sum()
    (g,) = torch.autograd.grad(loss, xt)
    np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-10)


def _mode_cases():
    rng = np.random.default_rng(7)
    n = 512
    t = np.arange(n) / n
    yield "three-tones", (np.sin(2 * np.pi * 20 * t)
                          + 0.5 * np.sin(2 * np.pi * 60 * t)
                          + 0.3 * np.sin(2 * np.pi * 120 * t)
                          + 0.05 * rng.normal(size=n))
    yield "noise", rng.normal(size=n)
    yield "bin-1", np.sin(2 * np.pi * 1 * t)     # degenerate: zeros
    yield "single", np.sin(2 * np.pi * 20 * t)   # an isolated peak


MODE_CASES = list(_mode_cases())


@pytest.mark.parametrize("name,x", MODE_CASES, ids=[c[0] for c in MODE_CASES])
def test_fourier_modes_match_jax(name, x):
    for tfn, jfn in ((tif.fourier_mode_any, jif.fourier_mode_any),
                     (tif.fourier_mode_valid, jif.fourier_mode_valid)):
        want = np.asarray(jfn(jnp.asarray(x)))
        got = tfn(x, device=CPU).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    if name == "bin-1":
        assert np.all(tif.fourier_mode_any(x, device=CPU).numpy() == 0.0)
        assert np.all(tif.fourier_mode_valid(x, device=CPU).numpy() == 0.0)


@pytest.mark.parametrize("mode", ["any", "valid"])
def test_cascade_iteration_matches_jax(mode):
    sr, n = 1000, 1000
    x = _two_tones(n, sr, 9)
    want = jif.cascade_iteration(jnp.asarray(x), sr, mode=mode)
    got = tif.cascade_iteration(x, sr, mode=mode, device=CPU)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for i in (0, 2, 3, 4):
        w = np.asarray(want[i])
        np.testing.assert_allclose(got[i].numpy(), w, rtol=0,
                                   atol=1e-12 * max(1.0, np.abs(w).max()))
    with pytest.raises(ValueError, match="unknown mode"):
        tif.cascade_iteration(x, sr, mode="all", device=CPU)


@pytest.mark.parametrize("lean", [False, True], ids=["full", "lean"])
def test_cascade_matches_jax_and_reconstructs(lean):
    n, sr = 600, 600
    x = _two_tones(n, sr, 2 if not lean else 3)
    jfn = (jif.itd_fourier_decomposition_lean if lean
           else jif.itd_fourier_decomposition)
    tfn = (tif.itd_fourier_decomposition_lean if lean
           else itd_fourier_decomposition)
    want = jfn(x, sr, max_outer=30)
    got = tfn(x, sr, max_outer=30, device=CPU)
    assert len(got) == len(want)
    if lean:
        assert len(got) % 2 == 1  # [modes_i, rotation_i]... residual
    for a, b in zip(got, want):
        assert isinstance(a, np.ndarray)
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.sum(np.stack(got), axis=0), x, atol=1e-8)


def test_noise_floor_keep_decision():
    """The keep decision is "any exactly nonzero weighted bin": on noise of
    1e-12, where the reference's ``isclose(mode, 0)`` drops every band at
    the first iteration, a band is kept in each of the first 8 iterations
    and the cascade stops within 12.  The port decides as JAX does,
    iteration by iteration: both raise at ``max_outer=8`` and both stop
    within ``max_outer=12`` with the same components."""
    n, sr = 600, 600
    x = 1e-12 * np.random.default_rng(0).normal(size=n)
    cur_j, cur_t = jnp.asarray(x), torch.from_numpy(x)
    for _ in range(6):
        cur_j, kj = jif.cascade_iteration(cur_j, sr)[:2]
        cur_t, kt = tif.cascade_iteration(cur_t, sr)[:2]
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
        assert bool(kt.any())

    def outcome(fn, max_outer, **kw):
        try:
            return len(fn(x, sr, max_outer=max_outer, **kw))
        except RuntimeError as e:
            return str(e)

    for max_outer in (8, 12):
        got = outcome(itd_fourier_decomposition, max_outer, device=CPU)
        assert got == outcome(jif.itd_fourier_decomposition, max_outer)
        assert isinstance(got, str) == (max_outer == 8), got


@pytest.mark.parametrize("fn,args", [
    (itd_sine_sift, (600,)), (itd_fourier_decomposition, (600,)),
    (tif.itd_fourier_decomposition_lean, (600,)),
    (tif.cascade_iteration, (600,)), (tif.fourier_mode_any, ())],
    ids=["itd_sine_sift", "itd_fourier_decomposition", "lean",
         "cascade_iteration", "fourier_mode_any"])
def test_numpy_input_goes_to_the_card(fn, args, monkeypatch):
    """numpy input goes to ``device="cuda"`` by default, which raises
    without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        fn(_two_tones(600, 600, 0), *args)
