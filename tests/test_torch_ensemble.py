"""The port's ensemble MEITD and selection statistics
(``pyitd_tpu_torch/decomp/ensemble.py``, ``utils/stats.py``) against the JAX
package's, on the CPU; the twin of ``tests/test_ensemble.py``.

No ``torch.Generator`` reproduces JAX's noise stream, so the ensemble is
held on JAX's own bank: ``_ensemble_from_bank`` on the realizations JAX's
``meitd_ensemble`` draws from its key (``pyitd_tpu/decomp/ensemble.py:
106-111``), against JAX's result: stacks to 1e-9, ``selected_index``
exactly, ``completeness`` to 1e-12.  Also: ``fingerprint`` (1-D and 2-D),
the DCT and ``sorted_median_index`` against JAX to 1e-12; the median
helper against ``np.median`` (``torch.median`` returns the lower middle
value); the paired-noise mean reconstructing the input to 1e-10; an odd
``n_realizations`` raising; the same generator seed giving the same
ensemble.
"""
import jax
import jax.numpy as jnp
import jax.scipy.fft
import numpy as np
import pytest
import torch

from pyitd_tpu import meitd_ensemble as jax_ensemble
from pyitd_tpu.utils.stats import fingerprint as jax_fingerprint
from pyitd_tpu.utils.stats import sorted_median_index as jax_smi
from pyitd_tpu_torch import fingerprint, meitd_ensemble, sorted_median_index
from pyitd_tpu_torch.decomp.ensemble import _ensemble_from_bank
from pyitd_tpu_torch.utils.interop import result_to_numpy
from pyitd_tpu_torch.utils.stats import dct2, median

torch.set_num_threads(1)


def _signal(n=600, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, n)
    return (np.sin(20 * t * (1 + 0.2 * t)) + np.sin(13 * t)
            + 0.2 * rng.normal(size=n) + 0.1 * t ** 2)


# (seed of the signal, key, realizations, noise scale): bench.py's paired
# construction at tests/test_ensemble.py's sizes
ENSEMBLES = [(0, 7, 4, 0.05), (9, 4, 6, 0.08)]


@pytest.fixture(scope="module", params=ENSEMBLES,
                ids=[f"seed{e[0]}-R{e[2]}" for e in ENSEMBLES])
def ensemble(request):
    seed, key, r, scale = request.param
    x = jnp.asarray(_signal(seed=seed), jnp.float64)
    k = jax.random.PRNGKey(key)
    want = jax_ensemble(x, k, n_realizations=r, noise_scale=scale)
    v = scale * jax.random.normal(k, (r // 2, x.shape[-1]), x.dtype)
    bank = np.array(jnp.concatenate([x[None] + v, x[None] - v], axis=0))
    return np.asarray(x), bank, want


def test_bank_ensemble_matches_jax(ensemble):
    x, bank, want = ensemble
    got = _ensemble_from_bank(torch.from_numpy(bank))
    assert got.stacks.shape == want.stacks.shape
    np.testing.assert_allclose(got.stacks.numpy(), np.asarray(want.stacks),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.mean_stack.numpy(),
                               np.asarray(want.mean_stack), rtol=0, atol=1e-9)
    assert int(got.selected_index) == int(want.selected_index)
    assert torch.equal(got.selected, got.stacks[int(got.selected_index)])
    assert abs(float(got.completeness) - float(want.completeness)) < 1e-12
    np.testing.assert_array_equal(got.num_components.numpy(),
                                  np.asarray(want.num_components))
    # every realization reconstructs itself, the pairs' mean the input
    np.testing.assert_allclose(got.stacks.sum(1).numpy(), bank, rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(got.mean_stack.sum(0).numpy(), x, rtol=0,
                               atol=1e-10)


def test_ensemble_from_a_generator():
    x = torch.from_numpy(_signal(n=512, seed=3))
    runs = [meitd_ensemble(x, torch.Generator().manual_seed(s), 4, 0.1)
            for s in (1, 1, 2)]
    a, b, c = (result_to_numpy(r) for r in runs)
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert not np.array_equal(a.stacks, c.stacks)
    np.testing.assert_allclose(a.mean_stack.sum(0), x.numpy(), rtol=0,
                               atol=1e-10)
    # the default noise scale is the signal's MAD (jnp.median semantics)
    d = meitd_ensemble(x, torch.Generator().manual_seed(1), 2)
    mad = np.median(np.abs(x.numpy() - np.median(x.numpy())))
    v = mad * torch.randn((1, 512), generator=torch.Generator().manual_seed(1),
                          dtype=torch.float64)
    np.testing.assert_allclose(d.stacks[0].sum(0).numpy(),
                               (x + v[0]).numpy(), rtol=0, atol=1e-10)
    with pytest.raises(ValueError, match="even"):
        meitd_ensemble(x, None, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            meitd_ensemble(x.numpy(), None, 2)


@pytest.mark.parametrize("n", [1, 2, 7, 64, 255])
def test_dct_matches_jax(n):
    v = np.random.default_rng(n).normal(size=(3, n))
    want = np.asarray(jax.scipy.fft.dct(jnp.asarray(v), axis=-1))
    np.testing.assert_allclose(dct2(torch.from_numpy(v)).numpy(), want,
                               rtol=0, atol=1e-12 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("shape", [(64,), (63,), (16, 10), (15, 9)])
def test_fingerprint_matches_jax(shape):
    d = np.random.default_rng(6).normal(size=shape)
    got = float(fingerprint(d, device="cpu"))
    want = float(jax_fingerprint(jnp.asarray(d)))
    assert abs(got - want) <= 1e-12 * max(1.0, abs(want))
    with pytest.raises(ValueError, match="1-D and 2-D"):
        fingerprint(np.zeros((2, 2, 2)), device="cpu")


@pytest.mark.parametrize("size", [1, 2, 64, 500])
def test_sorted_median_index_matches_jax(size):
    d = np.random.default_rng(size).normal(size=size)
    idx, comp = sorted_median_index(d, device="cpu")
    jidx, jcomp = jax_smi(jnp.asarray(d))
    assert int(idx) == int(jidx)
    if size > 1:
        assert abs(float(comp) - float(jcomp)) < 1e-12


@pytest.mark.parametrize("n", [1, 2, 5, 32768])
def test_median_is_jnp_median(n):
    a = np.random.default_rng(n).normal(size=n)
    assert float(median(torch.from_numpy(a))) == float(np.median(a))
    m = median(torch.from_numpy(a.reshape(1, -1)), dim=1)
    assert m.shape == (1,) and float(m[0]) == float(np.median(a))
    a[0] = np.nan
    assert np.isnan(float(median(torch.from_numpy(a))))
