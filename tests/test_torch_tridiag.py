"""The port's tridiagonal solvers (``pyitd_tpu_torch/ops/tridiag.py``)
against the JAX package's (``pyitd_tpu/ops/tridiag.py``) on the same numpy
inputs, in f64 to 1e-12."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyitd_tpu.ops import tridiag as jt
from pyitd_tpu_torch.ops import tridiag as tt

TOL = 1e-12


def _t(a):
    return torch.from_numpy(np.array(a))


def _system(rng, rows, cap, tail=0):
    """A diagonally dominant batch; the last ``tail`` lanes identity rows."""
    lower = rng.uniform(0.1, 1, (rows, cap))
    upper = rng.uniform(0.1, 1, (rows, cap))
    diag = 2.0 * (lower + upper) + 0.5
    rhs = rng.normal(size=(rows, cap))
    lower[:, 0] = 0
    upper[:, -1] = 0
    if tail:
        k = cap - tail
        lower[:, k:] = 0
        upper[:, k - 1:] = 0
        diag[:, k:] = 1
        rhs[:, k:] = 0
    return lower, diag, upper, rhs


@pytest.mark.parametrize("count", [None, 9, "rows"])
def test_thomas_matches_jax(count):
    rng = np.random.default_rng(1)
    sys_ = _system(rng, 3, 16)
    if count == "rows":
        count = np.array([16, 9, 1], np.int32)
    want = jt.thomas_solve(*(jnp.asarray(a) for a in sys_),
                           count=None if count is None else jnp.asarray(
                               count))
    got = tt.thomas_solve(*(_t(a) for a in sys_),
                          count=None if count is None else _t(count))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("cap", [64, 1025])
def test_pcr_matches_jax_and_thomas(cap):
    rng = np.random.default_rng(13)
    sys_ = _system(rng, 3, cap, tail=7)
    want = jt.pcr_solve(*(jnp.asarray(a) for a in sys_))
    got = tt.pcr_solve(*(_t(a) for a in sys_))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got.numpy(),
                               tt.thomas_solve(*(_t(a) for a in sys_)),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("bc", ["natural", "not-a-knot"])
@pytest.mark.parametrize("cap", [20, 1100])   # Thomas, then PCR
@pytest.mark.parametrize("int_pos", [True, False])
def test_spline_moments_match_jax(bc, cap, int_pos):
    """Rows with ``count`` below the capacity (padded slots hold junk
    positions, as ``compact_indices`` leaves them)."""
    rng = np.random.default_rng(3)
    counts = np.array([cap - 6, cap // 2, 7], np.int32)
    pos = np.zeros((3, cap), np.int64)
    val = rng.normal(size=(3, cap))
    for r, c in enumerate(counts):
        pos[r, :c] = np.sort(rng.choice(np.arange(5 * cap), c,
                                        replace=False))
        pos[r, c:] = 5 * cap - 1
    if not int_pos:
        pos = pos.astype(np.float64)
    want = jt.spline_moments(jnp.asarray(pos), jnp.asarray(val),
                             jnp.asarray(counts), bc=bc)
    got = tt.spline_moments(_t(pos), _t(val), _t(counts), bc=bc)
    scale = np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL * max(scale, 1.0))
