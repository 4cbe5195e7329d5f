"""The port's 2-D tier (``pyitd_tpu_torch/decomp/itd2d.py``,
``decomp/serial2d.py``) against the JAX package's, on the CPU.

* ``mad``, ``crossways_baseline`` and ``statistical_component`` (with
  injected noise) against JAX in f64 to 1e-12;
* the fixed-noise parity with the numpy oracle
  ``tests/reference/sifted2d_ref.py``, as ``tests/test_transforms_2d.py:
  159-183`` holds JAX's (atol 5e-8);
* ``totalextract2d``: shape, exact reconstruction, the generator's
  determinism;
* ``sconcatenate`` / ``sdeconcatenate`` against JAX, and the round trip;
* the card's route rehearsed: with the cubic level on ``"fills"`` (the
  kernels' plain versions on a CPU tensor) a ``statistical_component``
  makes exactly 4 cubic calls, each within 2e-6 of max|baseline| of the
  f64 gather route on its own input, and ``totalextract2d`` reconstructs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyitd_tpu.decomp import itd2d as j2
from pyitd_tpu.decomp import serial2d as js
from pyitd_tpu_torch import (crossways_baseline, mad, sconcatenate,
                             sdeconcatenate, totalextract2d)
from pyitd_tpu_torch.decomp import meitd as port_meitd
from pyitd_tpu_torch.decomp.itd2d import statistical_component
from pyitd_tpu_torch.ops.cubic_baseline import cubic_baseline_extract
from reference.sifted2d_ref import (
    statistical_component as ref_statistical_component)

torch.set_num_threads(1)


def _img(h, w, seed=7):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return (np.sin(0.7 * xx) * np.cos(0.5 * yy)
            + 0.3 * rng.normal(size=(h, w)) + 0.01 * (xx + yy))


@pytest.mark.parametrize("shape", [(48, 48), (40, 56), (2, 32, 24)])
def test_crossways_and_mad_match_jax(shape):
    img = np.stack([_img(*shape[-2:], seed=k) for k in range(
        np.prod(shape[:-2], dtype=int))]).reshape(shape)
    got = crossways_baseline(torch.from_numpy(img)).numpy()
    want = np.asarray(j2.crossways_baseline(jnp.asarray(img)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert float(mad(torch.from_numpy(img))) == float(j2.mad(
        jnp.asarray(img)))


def test_statistical_component_matches_jax_and_oracle():
    rng = np.random.default_rng(7)
    h = w = 48
    img = _img(h, w)
    noise = rng.normal(0, 0.2, size=(2, h, w))
    got = statistical_component(torch.from_numpy(img), None, 4,
                                noise=torch.from_numpy(noise)).numpy()
    want = np.asarray(j2.statistical_component(
        jnp.asarray(img), jax.random.PRNGKey(0), 4, noise=jnp.asarray(noise)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, ref_statistical_component(img, noise),
                               rtol=0, atol=5e-8)
    with pytest.raises(ValueError, match="even"):
        statistical_component(torch.from_numpy(img), None, 3)
    with pytest.raises(ValueError, match="noise must be"):
        statistical_component(torch.from_numpy(img), None, 4,
                              noise=torch.from_numpy(noise[:1]))


def test_totalextract2d():
    img = _img(32, 40)
    out = totalextract2d(img, torch.Generator().manual_seed(3), 4,
                         device="cpu")
    again = totalextract2d(torch.from_numpy(img),
                           torch.Generator().manual_seed(3), 4)
    assert out.shape == (2, 32, 40) and out.dtype == torch.float64
    assert torch.equal(out, again)
    np.testing.assert_allclose(out.sum(0).numpy(), img, rtol=0,
                               atol=1e-12 * np.abs(img).max())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            totalextract2d(img, None, 2)


@pytest.mark.parametrize("length,signals,k", [(30, 5, 4), (17, 3, 1)])
def test_serial2d_matches_jax(length, signals, k):
    m = np.random.default_rng(length).normal(size=(length, signals))
    s = sconcatenate(m, k, device="cpu")
    want = np.asarray(js.sconcatenate(jnp.asarray(m), k))
    assert s.shape == want.shape
    np.testing.assert_allclose(s.numpy(), want, rtol=0, atol=1e-15)
    modes = np.concatenate([want, 2 * want], axis=1)
    got = sdeconcatenate(torch.from_numpy(modes), k, signals)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(js.sdeconcatenate(jnp.asarray(modes), k,
                                                  signals)))
    # the round trip gives every column back, each mode scaled
    np.testing.assert_allclose(got[:, 0].numpy(), m, rtol=0, atol=1e-15)
    np.testing.assert_allclose(got[:, 1].numpy(), 2 * m, rtol=0, atol=1e-15)


def test_2d_on_the_fills_route(monkeypatch):
    """The card's route on a CPU tensor: one batched cubic call per pass,
    each held against the f64 gather route on its own input."""
    calls = []

    def recorded(x, capacity, **kw):
        r = cubic_baseline_extract(x, capacity, **kw)
        calls.append((x, kw, r))
        return r

    monkeypatch.setattr(port_meitd, "_CUBIC_BACKEND", "fills")
    monkeypatch.setattr(port_meitd, "cubic_baseline_extract", recorded)
    img = torch.from_numpy(_img(40, 48))
    out = totalextract2d(img, torch.Generator().manual_seed(5), 6)
    np.testing.assert_allclose(out.sum(0).numpy(), img.numpy(), rtol=0,
                               atol=1e-12 * float(img.abs().max()))
    assert [tuple(x.shape) for x, _, _ in calls] == [
        (6, 40, 48), (6, 48, 40), (6, 40, 48), (6, 48, 40)]
    for x, kw, r in calls:
        assert kw["eval_backend"] == "fills" and kw["min_extrema"] == 10
        assert x.dtype == torch.float64
        g = cubic_baseline_extract(x, x.shape[-1] + 2, min_extrema=10,
                                   eval_backend="gather")
        assert torch.equal(r.num_extrema, g.num_extrema)
        held = r.num_extrema < 10
        assert torch.equal(r.baseline[held], x[held])
        err = float((r.baseline - g.baseline).abs().max())
        assert err <= 2e-6 * float(g.baseline.abs().max()), err
