"""The port's extrema masks and counts against ``pyitd_tpu.ops.extrema``,
exactly, in f32 and f64: plateaus (plateau-rightmost rule), NaN pairs and
NaN endpoints (±1 quarantine, NaN differences as +inf), and n in {2, 3, 130}
(the n < 3 rule)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyitd_tpu.ops import extrema as jx
from pyitd_tpu_torch.ops import extrema as tx

torch.set_num_threads(1)


def _signals():
    rng = np.random.default_rng(3)
    for n in (2, 3, 130):
        yield f"noise-{n}", rng.normal(size=(2, n))
    # integer-rounded noise: long plateaus, flat valleys and flat peaks
    yield "plateaus", np.round(rng.normal(size=(3, 130)))
    yield "staircase", np.array([[0, 1, 1, 1, 0, 0, 2, 2, -1, -1, -1, 3, 3]],
                                dtype=np.float64)
    s = np.repeat(np.sin(np.linspace(0, 20, 130))[None], 3, axis=0)
    s[0, 40:42] = np.nan   # a NaN pair
    s[1, 0] = np.nan       # NaN endpoints
    s[1, -1] = np.nan
    s[2, 64] = np.nan      # a lone NaN at an extremum's neighbour
    yield "nan", s
    yield "three-nan", np.array([[1.0, np.nan, 0.0], [0.0, 1.0, 0.0]])


CASES = list(_signals())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,x", CASES, ids=[c[0] for c in CASES])
def test_masks_and_counts_match_jax(name, x, dtype):
    x = x.astype(dtype)
    jm = jx.extrema_masks(jnp.asarray(x))
    tm = tx.extrema_masks(torch.from_numpy(x))
    np.testing.assert_array_equal(tm.minima.numpy(), np.asarray(jm.minima))
    np.testing.assert_array_equal(tm.maxima.numpy(), np.asarray(jm.maxima))
    np.testing.assert_array_equal(tx.extrema_mask(torch.from_numpy(x)).numpy(),
                                  np.asarray(jx.extrema_mask(jnp.asarray(x))))
    got = tx.count_extrema(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jx.count_extrema(jnp.asarray(x))))


def test_one_dimensional_and_short_signals():
    x = np.sin(np.linspace(0, 9, 50))
    assert int(tx.count_extrema(torch.from_numpy(x))) == int(
        jx.count_extrema(jnp.asarray(x)))
    for n in (1, 2):
        m = tx.extrema_masks(torch.zeros(2, n))
        assert not m.minima.any() and not m.maxima.any()


@pytest.mark.parametrize("capacity", [4, 40, 132])
def test_compact_indices_match_jax(capacity):
    """Sorted marked indices, slots past the count at n - 1, marks past the
    capacity dropped (the count keeps them), exactly."""
    rng = np.random.default_rng(5)
    mask = rng.random((3, 130)) < 0.2
    mask[1] = False
    mask[2, [0, 129]] = True
    jp, jc = jx.compact_indices(jnp.asarray(mask), capacity)
    tp, tc = tx.compact_indices(torch.from_numpy(mask), capacity)
    assert tp.dtype == torch.int32 and tc.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
