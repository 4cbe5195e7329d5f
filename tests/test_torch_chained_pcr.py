"""The port's grid-resident moment solve (``pyitd_tpu_torch/ops/
chained_pcr.py``) and its SPIKE twin (``ops/cuda_cubic.py``) against the
JAX package's, on the same numpy inputs.

f64 to 1e-12: ``notaknot_rows``, ``chained_block_pcr``,
``shard_spike_factors`` and ``reduced_interface_solve``.  The port's
``chained_block_spike`` (the plain ``spike_factors`` on the CPU, 2048-cell
blocks) against JAX's ``chained_block_spike(interpret=True)`` (8192-cell
blocks) in f32 to 5e-5 of max|u|, the bar of
``tests/test_chained_pcr.py:121``: the two factor different blocks, so they
agree to f32 roundoff, not bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyitd_tpu.ops import chained_pcr as jc
from pyitd_tpu.ops.pallas_spike import SPIKE_BLK as JAX_BLK
from pyitd_tpu.ops.pallas_spike import chained_block_spike as jax_spike
from pyitd_tpu_torch.ops import chained_pcr as tc
from pyitd_tpu_torch.ops import cuda_cubic

TOL = 1e-12


def _t(a):
    return torch.from_numpy(np.array(a))


def _random_system(rng, rows, n, density):
    """tests/test_chained_pcr.py's system: random interior knots, the first
    and last rows without their outward coupling."""
    mask = rng.random((rows, n)) < density
    mask[:, 0] = mask[:, -1] = False
    mask[:, 5] = True
    mask[:, n // 2] = True
    hl = rng.uniform(1.0, 50.0, (rows, n))
    hr = rng.uniform(1.0, 50.0, (rows, n))
    a, b, c = hl, 2.0 * (hl + hr), hr
    d = rng.normal(size=(rows, n)) * 10.0
    _cut_ends(mask, a, c)
    return mask, a, b, c, d


def _cut_ends(mask, a, c):
    for r in range(mask.shape[0]):
        idx = np.where(mask[r])[0]
        a[r, idx[0]] = 0.0
        c[r, idx[-1]] = 0.0


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=tol * max(np.abs(w).max(), 1.0))


def test_notaknot_rows_match_jax():
    rng = np.random.default_rng(2)
    shape = (3, 200)
    hl, hr = (rng.integers(1, 9, shape).astype(np.float64)
              for _ in range(2))
    hl[0, :3] = 0.0   # a zero spacing: the safe division
    vals = [rng.normal(size=shape) for _ in range(3)]
    first = rng.random(shape) < 0.1
    last = rng.random(shape) < 0.1
    first[1, 7] = last[1, 7] = True   # one knot gets both substitutions
    want = jc.notaknot_rows(*(jnp.asarray(a) for a in (hl, hr, *vals)),
                            jnp.asarray(first), jnp.asarray(last))
    got = tc.notaknot_rows(*(_t(a) for a in (hl, hr, *vals)), _t(first),
                           _t(last))
    _close(got, want)


@pytest.mark.parametrize("n,density", [(513, 0.6), (640, 0.04)])
def test_chained_block_pcr_matches_jax(n, density):
    rng = np.random.default_rng(3)
    sys_ = _random_system(rng, 2, n, density)
    want = jc.chained_block_pcr(*(jnp.asarray(a) for a in sys_))
    got = tc.chained_block_pcr(*(_t(a) for a in sys_))
    _close(got, want)


def test_chained_block_pcr_empty_row():
    z = torch.zeros(1, 96, dtype=torch.float64)
    u, w = tc.chained_block_pcr(torch.zeros(1, 96, dtype=torch.bool), z,
                                torch.ones_like(z), z, z)
    assert not u.any() and not w.any()


def test_spike_factors_and_interface_match_jax():
    """One row cut into blocks of 256: the factors of every block, then the
    interface solve on their edge values, in f64."""
    rng = np.random.default_rng(7)
    mask, a, b, c, d = _random_system(rng, 1, 8 * 256, 0.4)
    blocks = [x.reshape(8, 256) for x in (mask, a, b, c, d)]
    want = jc.shard_spike_factors(*(jnp.asarray(x) for x in blocks))
    got = tc.shard_spike_factors(*(_t(x) for x in blocks))
    for g, w in zip(got, want):
        _close(g, w)
    (xp1, xp2), (vl1, vl2), (vr1, vr2) = (tuple(np.asarray(v) for v in p)
                                          for p in want)
    args = [x[None] for x in (-vl1[:, -1], -vl2[:, 0], -vr1[:, -1],
                              -vr2[:, 0], xp1[:, -1], xp2[:, 0])]
    _close(tc.reduced_interface_solve(*(_t(x) for x in args)),
           jc.reduced_interface_solve(*(jnp.asarray(x) for x in args)))


def _spike_case(n, zero_block):
    rng = np.random.default_rng(11 + n)
    mask, a, b, c, d = _random_system(rng, 2, n, 0.3)
    if zero_block:   # a whole JAX block (4 port blocks) with no knot
        mask[:, JAX_BLK:2 * JAX_BLK] = False
        _cut_ends(mask, a, c)
    return mask, a, b, c, d


@pytest.mark.parametrize("n,zero_block", [
    (2 * JAX_BLK + 1777, False), (3000, False), (JAX_BLK, False),
    (3 * JAX_BLK, True)])
def test_chained_block_spike_matches_jax(n, zero_block):
    mask, *rows = _spike_case(n, zero_block)
    f32 = [r.astype(np.float32) for r in rows]
    ju, jw = jax_spike(jnp.asarray(mask), *(jnp.asarray(r) for r in f32),
                       interpret=True)
    before = dict(cuda_cubic.LAUNCHES)
    tu, tw = cuda_cubic.chained_block_spike(_t(mask), *(_t(r) for r in f32))
    assert cuda_cubic.LAUNCHES == before  # the plain version on the CPU
    scale = float(np.abs(np.asarray(ju)).max())
    assert float(np.abs(tu.numpy() - np.asarray(ju)).max()) / scale < 5e-5
    assert float(np.abs(tw.numpy() - np.asarray(jw)).max()) / scale < 5e-5
    # and against the one-piece grid PCR of the port, in f64
    u64, w64 = tc.chained_block_pcr(*(_t(x) for x in (mask, *rows)))
    scale = float(u64.abs().max())
    assert float((tu.double() - u64).abs().max()) / scale < 5e-5
    assert float((tw.double() - w64).abs().max()) / scale < 5e-5
