"""The port's batched MEITD walk (``pyitd_tpu_torch/decomp/meitd_jit.py``)
against the JAX package's ``meitd_jit`` / ``meitd_jit_bank`` and against
the port's host walk, on the CPU; the twin of ``tests/test_meitd_jit.py``.

* ``meitd_jit`` against JAX's: counts exactly, rows to 1e-9; against the
  port's ``meitd`` likewise;
* ``meitd_jit_bank`` on 3 rows against JAX's bank and against the port's
  walk of each row alone;
* reconstruction to 1e-10;
* the card's route rehearsed: with the cubic level on its ``"fills"``
  route (the kernels' plain versions on a CPU tensor) the bank walk
  reconstructs its input, every cubic call is within ``WALK_F32_REL`` of
  max|baseline| of the f64 gather route on the same input, and each stage
  makes one cubic call over the rows that need it.

``WALK_F32_REL`` is 5e-5, not the 2e-6 of the cubic tests: the walk digs
down to baselines with few knots where the not-a-knot spline overshoots
the signal, and there f32 itself loses more.  On the 54 cubic calls of
this file's bank, JAX's own f32 routes read up to 2.9e-5 (``"fills"``)
and 1.8e-5 (``"gather"``) of max|baseline| from the f64 gather route; the
port's route read 8.6e-6.  A wrong knot or moment reads 1e-2 or more.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyitd_tpu.decomp.meitd_jit import meitd_jit as jax_meitd_jit
from pyitd_tpu.decomp.meitd_jit import meitd_jit_bank as jax_bank
from pyitd_tpu_torch import meitd, meitd_jit, meitd_jit_bank
from pyitd_tpu_torch.decomp import meitd as port_meitd
from pyitd_tpu_torch.ops.cubic_baseline import cubic_baseline_extract

torch.set_num_threads(1)

WALK_F32_REL = 5e-5


def _sig(n=400, seed=3):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n)
    return (np.sin(2 * np.pi * 30 * t) + 0.5 * np.sin(2 * np.pi * 7 * t)
            + 0.1 * rng.normal(size=n))


def _bank():
    rng = np.random.default_rng(3)
    t = np.linspace(0, 1, 1024)
    return np.stack([
        np.sin(2 * np.pi * (20 + 5 * k) * t) + 0.1 * rng.normal(size=t.size)
        for k in range(3)])


@pytest.fixture(scope="module")
def bank():
    b = _bank()
    return b, jax_bank(jnp.asarray(b), 0.6)


def _same(res, want, atol=1e-9):
    hc, lc = int(res.high_count), int(res.low_count)
    assert (hc, lc) == (int(want.high_count), int(want.low_count))
    for f in ("high", "low", "residual"):
        np.testing.assert_allclose(getattr(res, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=atol)


def _recon(res):
    return res.residual + res.high.sum(-2) + res.low.sum(-2)


@pytest.mark.parametrize("seed", [3, 5])
def test_meitd_jit_matches_jax_and_host_walk(seed):
    s = _sig(seed=seed)
    res = meitd_jit(s, device="cpu")
    assert res.high.shape == (44, 400) and res.high_count.dtype == torch.int32
    _same(res, jax_meitd_jit(jnp.asarray(s)))
    hi, lo, resid = meitd(s, device="cpu")
    assert (int(res.high_count), int(res.low_count)) == (hi.shape[0],
                                                         lo.shape[0])
    np.testing.assert_allclose(res.high[:hi.shape[0]].numpy(), hi.numpy(),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.low[:lo.shape[0]].numpy(), lo.numpy(),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.residual.numpy(), resid.numpy(), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(_recon(res).numpy(), s, rtol=0, atol=1e-10)


def test_meitd_jit_degenerate_counts():
    s = np.linspace(0.0, 1.0, 256)
    res = meitd_jit(s, device="cpu")
    assert int(res.high_count) == 1 and int(res.low_count) == 1
    np.testing.assert_array_equal(res.residual.numpy(), s)
    assert not res.high.any() and not res.low.any()
    with pytest.raises(ValueError, match="1-D"):
        meitd_jit(np.zeros((2, 8)), device="cpu")


@pytest.mark.parametrize("row", range(3))
def test_bank_matches_jax_and_single_walks(bank, row):
    b, want = bank
    res = meitd_jit_bank(b, device="cpu")
    assert res.high.shape == (3, 44, 1024)
    one = meitd_jit(b[row], device="cpu")
    for f in res._fields:
        assert torch.equal(getattr(res, f)[row], getattr(one, f)), f
    _same(one, type(want)(*(t[row] for t in want)))
    np.testing.assert_allclose(_recon(res)[row].numpy(), b[row], rtol=0,
                               atol=1e-10)


def test_walk_on_the_fills_route(bank, monkeypatch):
    """The card's route on a CPU tensor: every cubic call on the fills
    route's plain versions, recorded and held against the f64 gather route
    on its own input; the walk reconstructs its input."""
    b, _ = bank
    calls = []

    def recorded(x, capacity, **kw):
        r = cubic_baseline_extract(x, capacity, **kw)
        calls.append((x, kw, r))
        return r

    monkeypatch.setattr(port_meitd, "_CUBIC_BACKEND", "fills")
    monkeypatch.setattr(port_meitd, "cubic_baseline_extract", recorded)
    port_meitd.reset_counts()
    res = meitd_jit_bank(b, device="cpu")
    trips = port_meitd.COUNTS["trips"]
    np.testing.assert_allclose(_recon(res).numpy(), b, rtol=0, atol=1e-10)
    assert (res.high_count + res.low_count > 0).all()
    assert trips > 0 and len(calls) > trips
    for x, kw, r in calls:
        assert kw["eval_backend"] == "fills" and kw["min_extrema"] == 0
        assert x.shape[0] <= 3 and x.dtype == torch.float64
        g = cubic_baseline_extract(x, x.shape[-1] + 2, min_extrema=0,
                                   eval_backend="gather")
        assert torch.equal(r.num_extrema, g.num_extrema)
        err = float((r.baseline - g.baseline).abs().max())
        assert err <= WALK_F32_REL * float(g.baseline.abs().max()), err
