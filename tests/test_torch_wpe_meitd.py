"""The port's WPE and host MEITD walk (``pyitd_tpu_torch/ops/wpe.py``,
``decomp/meitd.py``) against the JAX package's, on the same numpy inputs,
on the CPU; the twin of ``tests/test_wpe_meitd.py``.

* WPE against JAX and against that file's numpy oracle ``ref_wpe`` to
  1e-12, batched and with tied samples (the stable tie-break);
* ``first_rotation_is_proper`` and ``retrieve_proper_rotation`` against
  JAX, on a gate-holding, a gate-failing and a few-extrema input;
* ``meitd`` and ``xitd`` on three signals of 400 to 600 samples: the same
  component counts, rows to 1e-9;
* the degenerate walks (< 4 extrema: two zero rows; 4 or 5: empty stacks)
  and XITD's auto-WPEMAX slot quirk;
* a numpy input runs on the card by default and raises without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyitd_tpu.decomp import meitd as jm
from pyitd_tpu.ops.wpe import weighted_permutation_entropy as jax_wpe
from pyitd_tpu_torch import (count_extrema, meitd,
                             weighted_permutation_entropy, xitd)
from pyitd_tpu_torch.decomp.meitd import (first_rotation_is_proper,
                                          retrieve_proper_rotation)
from test_wpe_meitd import ref_wpe

torch.set_num_threads(1)


def _sig(n, seed):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n)
    return (np.sin(2 * np.pi * 30 * t) + 0.5 * np.sin(2 * np.pi * 7 * t)
            + 0.1 * rng.normal(size=n))


def _wpe_cases():
    rng = np.random.default_rng(0)
    ties = np.round(rng.normal(size=300), 1)  # many tied windows
    yield "noise", rng.normal(size=300)
    yield "sine", np.sin(np.linspace(0, 20, 500))
    yield "ties", ties
    yield "plateaus", np.repeat(rng.normal(size=60), 4)


WPE_CASES = list(_wpe_cases())


@pytest.mark.parametrize("name,sig", WPE_CASES, ids=[c[0] for c in WPE_CASES])
@pytest.mark.parametrize("norm", [False, True])
def test_wpe_matches_jax_and_oracle(name, sig, norm):
    got = float(weighted_permutation_entropy(torch.from_numpy(sig), 3,
                                             normalize=norm))
    want = float(jax_wpe(jnp.asarray(sig), 3, normalize=norm))
    assert abs(got - want) < 1e-12, (got, want)
    if name not in ("ties", "plateaus"):
        # numpy's quicksort argsort is unstable on ties; JAX's and the
        # port's ranks are stable
        assert abs(got - ref_wpe(sig, 3, norm)) < 1e-12


def test_wpe_batched_and_delayed():
    rng = np.random.default_rng(2)
    sigs = np.round(rng.normal(size=(2, 3, 256)), 1)
    for order, delay in ((3, 1), (4, 2)):
        got = weighted_permutation_entropy(torch.from_numpy(sigs), order,
                                           delay, normalize=True).numpy()
        want = np.asarray(jax_wpe(jnp.asarray(sigs), order, delay,
                                  normalize=True))
        assert got.shape == (2, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert float(weighted_permutation_entropy(
        torch.linspace(0, 1, 100, dtype=torch.float64) ** 2)) == 0.0
    with pytest.raises(ValueError, match="too short"):
        weighted_permutation_entropy(torch.zeros(2), 3)


def _gate_cases():
    rng = np.random.default_rng(3)
    t = np.linspace(0, 2 * np.pi, 512)
    yield "noisy", np.sin(24 * t) + 0.3 * rng.normal(size=t.size)
    yield "smooth", np.sin(2 * t) + 0.02 * t
    yield "few extrema", np.sin(2.6 * t)


GATE_CASES = list(_gate_cases())


@pytest.mark.parametrize("name,x", GATE_CASES, ids=[c[0] for c in GATE_CASES])
def test_gate_functions_match_jax(name, x):
    rot, flag = retrieve_proper_rotation(x, 0.6, device="cpu")
    jrot, jflag = jm.retrieve_proper_rotation(x, 0.6)
    assert flag == jflag
    np.testing.assert_allclose(rot.numpy(), np.asarray(jrot), rtol=0,
                               atol=1e-12)
    rot, base, flag = first_rotation_is_proper(x, 0.6, device="cpu")
    jrot, jbase, jflag = jm.first_rotation_is_proper(x, 0.6)
    assert flag == jflag
    np.testing.assert_allclose(rot.numpy(), np.asarray(jrot), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(base.numpy(), np.asarray(jbase), rtol=0,
                               atol=1e-12)


SIGNALS = [(600, 3), (400, 5), (500, 7)]


@pytest.mark.parametrize("n,seed", SIGNALS)
def test_meitd_matches_jax(n, seed):
    s = _sig(n, seed)
    hi, lo, resid = meitd(s, device="cpu")
    jhi, jlo, jresid = jm.meitd(s)
    assert hi.shape == jhi.shape and lo.shape == jlo.shape
    assert hi.dtype == torch.float64
    np.testing.assert_allclose(hi.numpy(), np.asarray(jhi), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(lo.numpy(), np.asarray(jlo), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(resid.numpy(), np.asarray(jresid), rtol=0,
                               atol=1e-9)
    total = resid + hi.sum(0) + lo.sum(0)
    np.testing.assert_allclose(total.numpy(), s, rtol=0, atol=1e-10)
    assert hi.shape[0] + lo.shape[0] <= 21


@pytest.mark.parametrize("n,seed", SIGNALS)
def test_xitd_matches_jax(n, seed):
    s = _sig(n, seed)
    rows = xitd(s, device="cpu")
    want = np.asarray(jm.xitd(s))
    assert rows.shape == want.shape
    np.testing.assert_allclose(rows.numpy(), want, rtol=0, atol=1e-9)
    ents = weighted_permutation_entropy(rows, 3, normalize=True).tolist()
    assert ents == sorted(ents)


def test_degenerate_walks():
    """< 4 extrema: two zero rows (MEITD.py:413-414), so XITD sees 3;
    4 or 5 extrema: empty stacks."""
    s = np.linspace(0.0, 1.0, 256)
    hi, lo, resid = meitd(s, device="cpu")
    assert hi.shape == (1, 256) and lo.shape == (1, 256)
    assert not hi.any() and not lo.any()
    np.testing.assert_array_equal(resid.numpy(), s)
    assert xitd(s, device="cpu").shape == (3, 256)
    t = np.linspace(0, 2 * np.pi, 256)
    for k, f in ((4, 1.9), (5, 2.4)):
        s = np.sin(f * t + 0.3)
        assert int(count_extrema(torch.from_numpy(s))) == k
        hi, lo, resid = meitd(s, device="cpu")
        jhi, jlo, _ = jm.meitd(s)
        assert hi.shape == jhi.shape == (0, 256)
        assert lo.shape == jlo.shape == (0, 256)


def test_xitd_auto_wpemax_slot():
    """XITD's auto WPEMAX lands in MEITD's unused slot unless
    ``use_auto_wpemax=True`` (MEITD.py:542)."""
    s = _sig(400, 11) + 3.0
    for auto in (False, True):
        got = xitd(s, use_auto_wpemax=auto, device="cpu").numpy()
        want = np.asarray(jm.xitd(s, use_auto_wpemax=auto))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    # the default applies the 0.6 gate, whatever the signal's SNR
    hi, lo, _ = meitd(s, wpemax=0.6, device="cpu")
    assert xitd(s, device="cpu").shape[0] == hi.shape[0] + lo.shape[0] + 1


def test_numpy_input_goes_to_the_card():
    s = _sig(128, 1)
    if torch.cuda.is_available():
        assert meitd(s)[2].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            meitd(s)
        with pytest.raises(RuntimeError, match="CUDA"):
            xitd(s)
