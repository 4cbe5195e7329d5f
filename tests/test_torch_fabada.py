"""The port's FABADA tier (``pyitd_tpu_torch/decomp/fabada.py``) against
the JAX package's and the numpy oracle of ``tests/test_fabada.py``, on the
same numpy inputs, on the CPU: f64 results to 1e-12 of max|x| (1e-8 against
the oracle, JAX's own bar), the iteration count exactly (read from the
final state of both loops), the NaN quirk of each tier; the device state
machine read once per ``_BLOCK`` iterations bitwise the per-iteration loop
(``_BLOCK = 1``), with one host read per block.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyitd_tpu.decomp import fabada as jf
from pyitd_tpu_torch import auto_sigma, fabada, pfabada, psnr
from pyitd_tpu_torch.decomp import fabada as tf
from pyitd_tpu_torch.utils import device_loop
from test_fabada import noisy_arp, ref_fabada

torch.set_num_threads(1)
CPU = "cpu"


def image(side=48, seed=1):
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.linspace(-1, 1, side), np.linspace(-1, 1, side))
    clean = 100 * np.exp(-(xx ** 2 + yy ** 2) / 0.2)
    return clean, clean + 8.0 * rng.normal(size=clean.shape)


def _with_nan(x):
    x = x.copy()
    x[40:43] = np.nan
    return x


CASES = [("1-D", noisy_arp()[1], 100.0), ("NaN", _with_nan(noisy_arp()[1]),
                                           100.0),
         ("2-D", image()[1], 64.0),
         ("variance array", noisy_arp(seed=3)[1],
          np.linspace(60.0, 140.0, 256))]


def jax_run(fn, key, *args):
    """The un-jitted JAX function and the final state of its while loop."""
    final = {}
    real = jax.lax.while_loop

    def spy(cond, body, init):
        out = real(cond, body, init)
        final.update(out)
        return out

    jax.lax.while_loop = spy
    try:
        out = np.asarray(fn.__wrapped__(*(jnp.asarray(a) for a in args)))
    finally:
        jax.lax.while_loop = real
    return out, int(final[key])


def port_run(fn, key, *args, monkeypatch):
    final = {}
    real = tf.run_until

    def spy(step, state, **kw):
        out = real(step, state, **kw)
        final.update(out)
        return out

    with monkeypatch.context() as m:
        m.setattr(tf, "run_until", spy)
        out = fn(*args, device=CPU)
    return out.numpy(), int(final[key])


@pytest.mark.parametrize("name,x,var", CASES, ids=[c[0] for c in CASES])
def test_fabada_matches_jax_and_oracle(name, x, var, monkeypatch):
    want, wit = jax_run(jf.fabada, "iteration", x, var)
    got, it = port_run(fabada, "iteration", x, var, monkeypatch=monkeypatch)
    assert it == wit
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(got, ref_fabada(x, var), atol=1e-8, rtol=1e-8)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("name,x,var", CASES, ids=[c[0] for c in CASES])
def test_pfabada_matches_jax(name, x, var, monkeypatch):
    sigma = np.sqrt(var)
    want, wit = jax_run(jf.pfabada, "iterations", x, sigma)
    got, it = port_run(pfabada, "iterations", x, sigma,
                       monkeypatch=monkeypatch)
    assert it == wit
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_nan_samples_keep_the_callers_variance():
    """The canonical tier zeroes NaNs before its variance substitution, so
    NaN samples keep the caller's variance: the result differs from the one
    with 1e-15 there.  The numba tier substitutes for real."""
    x = _with_nan(noisy_arp()[1])
    got = fabada(x, 100.0, device=CPU)
    dv = np.full(x.shape, 100.0)
    dv[40:43] = 1e-15
    substituted = fabada(x, dv, device=CPU)
    assert torch.isfinite(got).all()
    assert (got - substituted).abs().max() > 1e-3
    p = pfabada(x, 10.0, device=CPU)
    assert torch.isfinite(p).all()


@pytest.mark.parametrize("fn", ["fabada", "pfabada"])
def test_blocked_machine_is_bitwise_the_eager_loop(fn, monkeypatch):
    x = image(32, seed=4)[1]
    run = getattr(tf, fn)
    arg = 64.0 if fn == "fabada" else 8.0
    device_loop.reset_runs()
    blocked = run(x, arg, device=CPU)
    assert device_loop.RUNS[-1]["reads"] * tf._BLOCK == \
        device_loop.RUNS[-1]["steps"]
    monkeypatch.setattr(tf, "_BLOCK", 1)
    eager = run(x, arg, device=CPU)
    assert torch.equal(blocked, eager)
    assert device_loop.RUNS[-1]["reads"] == device_loop.RUNS[-1]["steps"]
    assert device_loop.RUNS[-1]["steps"] > device_loop.RUNS[0]["reads"]


def test_auto_sigma_and_psnr_match_jax():
    rng = np.random.default_rng(3)
    t = np.linspace(0, 1, 4096)
    for x in (rng.normal(size=4095) * 7.0,
              100 * np.sin(2 * np.pi * 3 * t) + 7.0 * rng.normal(size=4096),
              image(40)[1]):
        want = float(jf.auto_sigma(jnp.asarray(x)))
        assert abs(float(auto_sigma(x, device=CPU)) - want) <= 1e-12 * want
    clean, noisy = noisy_arp()
    assert abs(float(psnr(noisy, clean, device=CPU))
               - float(jf.psnr(jnp.asarray(noisy), jnp.asarray(clean)))) \
        < 1e-12


def test_fabada_improves_psnr():
    clean, noisy = noisy_arp()
    rec = fabada(noisy, 100.0, device=CPU)
    assert float(psnr(rec, clean, device=CPU)) > float(
        psnr(noisy, clean, device=CPU)) + 3.0


def test_numpy_goes_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = noisy_arp()[1]
    for fn in (lambda: fabada(x, 100.0), lambda: pfabada(x, 10.0),
               lambda: auto_sigma(x)):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            fn()
