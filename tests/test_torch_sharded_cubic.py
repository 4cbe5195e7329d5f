"""The port's sequence-parallel cubic baseline against the JAX package's
(``pyitd_tpu.parallel.sharded.sharded_cubic_baseline`` on its virtual CPU
mesh) and against the port's own unsharded gather route.

Both methods (``"spike"``: local SPIKE factorization + an interface solve
over the shards; ``"gather"``: replicated knot buffers), f64: baselines and
rotations to 1e-10, extrema counts equal.  The NaN case runs in f32 as
JAX's own test does (``tests/test_sharded.py:191-211``, 1e-5); the
any-shape case (a length and a batch the mesh does not divide) and the
gradient (autograd through the ``LocalGroup``'s index collectives) follow
``tests/test_sharded.py:471-487`` and ``:542-564``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyitd_tpu.parallel.sharded import make_mesh
from pyitd_tpu.parallel.sharded import \
    sharded_cubic_baseline as jax_sharded_cubic
from pyitd_tpu_torch import cubic_baseline_extract
from pyitd_tpu_torch.parallel import LocalGroup, sharded_cubic_baseline
from pyitd_tpu_torch.parallel.sharded import _max_knots_per_shard
from pyitd_tpu_torch.utils.interop import from_numpy

torch.set_num_threads(1)

needs_mesh = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")
METHODS = ["spike", "gather"]


def bank(batch=4, n=1024):
    """The bank of tests/test_sharded.py."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, n)
    return np.stack([
        np.sin((10 + 3 * k) * t * (1 + 0.1 * t)) + 0.2 * t**2
        + 0.1 * rng.normal(size=n) for k in range(batch)])


def gather_route(x, **kw):
    return cubic_baseline_extract(x, x.shape[-1] + 2, eval_backend="gather",
                                  **kw)


@needs_mesh
@pytest.mark.parametrize("method", METHODS)
def test_sharded_cubic_matches_jax_and_the_gather_route(method):
    x = bank(2, 1024)
    want = jax_sharded_cubic(jnp.asarray(x), make_mesh(8, seq=4),
                             method=method)
    rot, base, nex = sharded_cubic_baseline(from_numpy(x), LocalGroup(4),
                                            method=method)
    assert base.dtype == torch.float64
    np.testing.assert_array_equal(nex.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(base.numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(rot.numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-10)
    ref = gather_route(from_numpy(x))
    assert torch.equal(nex, ref.num_extrema)
    torch.testing.assert_close(base, ref.baseline, rtol=0, atol=1e-10)
    torch.testing.assert_close(rot, ref.rotation, rtol=0, atol=1e-10)


@pytest.mark.parametrize("seq", [2, 8])
@pytest.mark.parametrize("method", METHODS)
def test_sharded_cubic_other_shard_counts(method, seq):
    x = from_numpy(bank(2, 1024))
    ref = gather_route(x)
    rot, base, nex = sharded_cubic_baseline(x, LocalGroup(seq),
                                            method=method)
    assert torch.equal(nex, ref.num_extrema)
    torch.testing.assert_close(base, ref.baseline, rtol=0, atol=1e-10)
    torch.testing.assert_close(rot, ref.rotation, rtol=0, atol=1e-10)


@needs_mesh
@pytest.mark.parametrize("method", METHODS)
def test_sharded_cubic_nan_quarantine(method):
    """A NaN pair across a shard edge and a lone NaN: the knot sets, hence
    the counts and the spline, agree with JAX's and the gather route's."""
    x = bank(2, 1024).astype(np.float32)
    x[0, 255:257] = np.nan  # straddles the edge at 256 of 4 shards
    x[1, 600] = np.nan
    want = jax_sharded_cubic(jnp.asarray(x), make_mesh(8, seq=4),
                             method=method)
    rot, base, nex = sharded_cubic_baseline(from_numpy(x), LocalGroup(4),
                                            method=method)
    ref = gather_route(from_numpy(x))
    np.testing.assert_array_equal(nex.numpy(), np.asarray(want[2]))
    assert torch.equal(nex, ref.num_extrema)
    for got, jx, own in ((base, want[1], ref.baseline),
                         (rot, want[0], ref.rotation)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jx), rtol=0,
                                   atol=1e-5, equal_nan=True)
        np.testing.assert_allclose(got.numpy(), own.numpy(), rtol=0,
                                   atol=1e-5, equal_nan=True)


@needs_mesh
@pytest.mark.parametrize("method", METHODS)
def test_sharded_cubic_any_shape(method):
    x = bank(3, 1013)
    want = jax_sharded_cubic(jnp.asarray(x), make_mesh(8, seq=4),
                             method=method)
    rot, base, nex = sharded_cubic_baseline(from_numpy(x), LocalGroup(4),
                                            method=method)
    assert base.shape == (3, 1013) and nex.shape == (3,)
    np.testing.assert_array_equal(nex.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(base.numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-10)
    ref = gather_route(from_numpy(x))
    torch.testing.assert_close(base, ref.baseline, rtol=0, atol=1e-10)
    # a flat signal and extra batch axes
    one = sharded_cubic_baseline(from_numpy(x[0]), LocalGroup(4),
                                 method=method)
    assert one[1].shape == (1013,) and one[2].shape == ()
    torch.testing.assert_close(one[1], ref.baseline[0], rtol=0, atol=1e-10)


@pytest.mark.parametrize("method", METHODS)
def test_sharded_cubic_pass_through_guard_and_degenerate_rows(method):
    """Fewer than ``min_extrema`` extrema: the baseline is the signal; one
    and no interior knot with the guard off (the degenerate rows of
    tests/test_cubic.py:312-320)."""
    t = np.linspace(0, 6, 256)
    x = from_numpy(np.stack([np.sin(t), np.sin(40 * t)]))
    rot, base, nex = sharded_cubic_baseline(x, LocalGroup(4), method=method)
    assert nex.tolist()[0] < 10 <= nex.tolist()[1]
    assert torch.equal(base[0], x[0]) and not bool(rot[0].any())
    tt = np.arange(32, dtype=np.float64)
    rows = np.stack([np.minimum(tt, 31 - tt), tt * 1.7, np.ones(32),
                     np.sin(2 * np.pi * tt / 20)])
    x = from_numpy(rows)
    ref = gather_route(x, min_extrema=0)
    rot, base, nex = sharded_cubic_baseline(x, LocalGroup(4), method=method,
                                            min_extrema=0)
    assert torch.equal(nex, ref.num_extrema)
    torch.testing.assert_close(base, ref.baseline, rtol=0, atol=1e-10)


def test_sharded_cubic_capacity_and_refusals():
    t = np.linspace(0, 1, 4096)
    x = from_numpy(np.stack([np.sin(40 * np.pi * t) + 0.5 * t,
                             np.cos(34 * np.pi * t) - 0.3 * t]))
    measured = _max_knots_per_shard(x, 4)
    assert measured <= 16  # sparse knots: the buffer is O(knots), not O(n)
    assert _max_knots_per_shard(x[:, :4093], 4) <= 16
    ref = gather_route(x)
    for cap in (None, 64):
        _, base, nex = sharded_cubic_baseline(
            x, LocalGroup(4), method="gather", capacity_per_shard=cap)
        assert torch.equal(nex, ref.num_extrema)
        torch.testing.assert_close(base, ref.baseline, rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match="method"):
        sharded_cubic_baseline(x, LocalGroup(4), method="bogus")


@needs_mesh
def test_sharded_cubic_gradient():
    """tests/test_sharded.py:542-564 for the port: autograd through the
    sharded tier against JAX's and against the gather route's."""
    x = bank(2, 256)
    mesh = make_mesh(8, seq=4)

    def loss_jax(a):
        rot, base, _ = jax_sharded_cubic(a, mesh, min_extrema=0)
        return jnp.sum(jnp.square(rot)) + jnp.sum(jnp.sin(base))

    want = np.asarray(jax.grad(loss_jax)(jnp.asarray(x)))
    xs = from_numpy(x).requires_grad_()
    r = gather_route(xs, min_extrema=0)
    ((r.rotation ** 2).sum() + torch.sin(r.baseline).sum()).backward()
    for method in METHODS:
        xt = from_numpy(x).requires_grad_()
        rot, base, nex = sharded_cubic_baseline(xt, LocalGroup(4),
                                                min_extrema=0, method=method)
        ((rot ** 2).sum() + torch.sin(base).sum()).backward()
        assert not nex.requires_grad
        assert bool(torch.isfinite(xt.grad).all())
        for other in (xs.grad.numpy(), want):
            np.testing.assert_allclose(xt.grad.numpy(), other, rtol=0,
                                       atol=1e-9, err_msg=method)
