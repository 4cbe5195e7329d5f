"""The port's AFT (``pyitd_tpu_torch/decomp/aft.py``) against the JAX
package's and the FFT on the same numpy inputs, on the CPU, to JAX's own
bar of 5e-4 (``tests/test_aft.py:56``) taken relative to max|X|; the host
census functions (own numpy copies) equal to JAX's; the cases of
``tests/test_aft.py``; the hierarchical evaluator's padded tables covering
every accumulator and bin row exactly once; its result unchanged under
TF32-permitting ``"high"`` matmul precision.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyitd_tpu.decomp import aft as ja
from pyitd_tpu_torch.decomp import aft as ta

torch.set_num_threads(1)
CPU = "cpu"
BAR = 5e-4


def signal(shape, seed=0):
    rng = np.random.default_rng(seed)
    n = shape[-1]
    return rng.random(shape) + 6 * np.sin(np.linspace(0, 50 * np.pi, n))


def rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_census_functions_equal_jax():
    assert ta.unique_twiddle_count(512) == ja.unique_twiddle_count(512) == 257
    np.testing.assert_array_equal(ta.dft_matrix(16), ja.dft_matrix(16))
    for a, b in zip(ta.coefficient_census(64), ja.coefficient_census(64)):
        np.testing.assert_array_equal(a, b)
    assert ta.sub_accumulators(64) == ja.sub_accumulators(64)
    tp, jp = ta.accumulation_paths(64), ja.accumulation_paths(64)
    assert tp == jp
    assert tp[3]["harmonics"] == list(range(6, 64, 3))


@pytest.mark.parametrize("shape", [(128,), (3, 64), (2, 3, 32)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_accumulator_dft_matches_jax_and_fft(shape, dtype):
    x = signal(shape).astype(dtype)
    got = ta.accumulator_dft(x, device=CPU).numpy()
    want = np.asarray(ja.accumulator_dft(jnp.asarray(x)))
    assert got.dtype == want.dtype == np.complex128
    fft = np.fft.fft(x.astype(np.float64), axis=-1)
    assert rel(got, want) < BAR and rel(got, fft) < BAR
    if dtype == np.float64:
        np.testing.assert_allclose(got, fft, atol=1e-9)


@pytest.mark.parametrize("shape", [(64,), (3, 64), (5, 128)])
def test_hierarchical_dft_matches_jax_flat_and_fft(shape):
    x = signal(shape, seed=1)
    got = ta.hierarchical_dft(x, device=CPU).numpy()
    want = np.asarray(ja.hierarchical_dft(x))
    assert got.dtype == want.dtype == np.complex64
    assert rel(got, want) < BAR
    assert rel(got, np.fft.fft(x, axis=-1)) < BAR
    assert rel(got, ta.accumulator_dft(x, device=CPU).numpy()) < BAR


def test_hierarchical_tables_cover_each_term_once():
    n = 64
    gather, emit, coef = ta._hierarchical_tables(n)
    acc_members, row_acc = ta.sub_accumulators(n)
    values, sym = ta.coefficient_census(n)
    members = [row[row < n] for t in gather for row in t]
    assert len(members) == len(acc_members) == emit.max()
    assert sorted(tuple(sorted(m.tolist())) for m in members) == sorted(
        p for _, p in acc_members)
    # row r's accumulators hold every position once, with its coefficient
    for r in range(2 * n):
        ids = emit[r][emit[r] < len(members)]
        weight = np.zeros(n, np.float32)
        seen = np.zeros(n, int)
        for a, c in zip(ids, coef[r]):
            weight[members[a]] = c
            seen[members[a]] += 1
        np.testing.assert_array_equal(seen, np.ones(n, int))
        np.testing.assert_array_equal(weight,
                                      values[sym[r]].astype(np.float32))


def test_hierarchical_dft_ignores_the_matmul_precision():
    x = signal((4, 128), seed=2).astype(np.float32)
    before = torch.get_float32_matmul_precision()
    want = ta.hierarchical_dft(x, device=CPU)
    torch.set_float32_matmul_precision("high")
    try:
        got = ta.hierarchical_dft(x, device=CPU)
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.equal(got, want)


def test_numpy_goes_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (ta.accumulator_dft, ta.hierarchical_dft):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            fn(signal((64,)))
