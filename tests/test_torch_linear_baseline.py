"""One linear-baseline level of the port against the JAX package.

* f64: the port's plain form against JAX ``backend="gather"`` to 1e-12, and
  against the numpy oracle ``reference.itd_ref.baseline_extract`` to 1e-11.
* f32 (2, 9000), both endpoint modes: against JAX ``linear_level_pallas``
  in interpret mode (the TPU kernel pair K2).  Extrema counts exact;
  baseline and rotation to ``1e-5 * max|x|``, because XLA on the CPU
  contracts ``a*b+c`` into an FMA in f32 and PyTorch does not, which moves
  the knot-value formula by up to 131072 ulp where it cancels.
* The kernel route on the CPU (the wrappers' plain, tile-seeded versions)
  bit for bit against the plain form.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyitd_tpu.ops.linear_baseline import linear_baseline_extract as jax_lbe
from pyitd_tpu.ops.pallas_fill import linear_level_pallas
from pyitd_tpu_torch import linear_baseline_extract
from pyitd_tpu_torch.ops import cuda_fill
from reference.itd_ref import baseline_extract

torch.set_num_threads(1)


def _f64_signals():
    rng = np.random.default_rng(7)
    T = np.linspace(0, 2 * np.pi, 400)
    yield np.sin(20 * T * (1 + 0.2 * T)) + T**2 + np.sin(13 * T)
    yield rng.normal(size=513)
    yield np.sin(np.linspace(0, 50, 1000)) * np.linspace(1, 3, 1000)
    yield np.round(rng.normal(size=(3, 300)))  # plateaus, flat segments


def _f32_signal():
    rng = np.random.default_rng(2)
    t = np.linspace(0, 2 * np.pi, 9000)
    x = np.stack([
        np.sin(20 * t) + 0.1 * rng.normal(size=t.size),
        np.sin(7 * t) * (1 + 0.1 * t) + 0.05 * rng.normal(size=t.size),
    ]).astype(np.float32)
    x[1, 4000:4002] = np.nan
    return x


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.numpy(), b.numpy()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == np.float32:
        return bool(np.all((a.view(np.int32) == b.view(np.int32))
                           | (np.isnan(a) & np.isnan(b))))
    return np.array_equal(a, b)


@pytest.mark.parametrize("mode", ["reference", "natural"])
def test_f64_matches_jax_gather(mode):
    for s in _f64_signals():
        got = linear_baseline_extract(torch.from_numpy(s), endpoint_mode=mode)
        want = jax_lbe(jnp.asarray(s), endpoint_mode=mode, backend="gather")
        for f in ("rotation", "baseline", "sub_err"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       atol=1e-12, rtol=0, err_msg=f)
        np.testing.assert_array_equal(got.num_extrema.numpy(),
                                      np.asarray(want.num_extrema))
        assert got.num_extrema.dtype == torch.int32


def test_f64_matches_numpy_oracle():
    for s in _f64_signals():
        for row in np.atleast_2d(s):
            rot, base, nex, _ = linear_baseline_extract(torch.from_numpy(row))
            r_rot, r_base, r_nex = baseline_extract(row)
            np.testing.assert_allclose(base.numpy(), r_base, atol=1e-11,
                                       rtol=0)
            np.testing.assert_allclose(rot.numpy(), r_rot, atol=1e-11, rtol=0)
            assert int(nex) == r_nex


@pytest.mark.parametrize("mode", ["reference", "natural"])
def test_f32_matches_pallas_level(mode):
    x = _f32_signal()
    base_j, rot_j, _, nex_j = linear_level_pallas(
        jnp.asarray(x), endpoint_mode=mode, interpret=True)
    got = linear_baseline_extract(torch.from_numpy(x), endpoint_mode=mode)
    np.testing.assert_array_equal(got.num_extrema.numpy(), np.asarray(nex_j))
    atol = 1e-5 * np.nanmax(np.abs(x))
    np.testing.assert_allclose(got.baseline.numpy(), np.asarray(base_j),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(rot_j),
                               atol=atol, rtol=0)
    # sub_err is the exact residual: rotation + sub_err == x - baseline in f64
    lhs = got.rotation.double() + got.sub_err.double()
    rhs = torch.from_numpy(x).double() - got.baseline.double()
    np.testing.assert_array_equal(lhs.numpy(), rhs.numpy())


@pytest.mark.parametrize("mode", ["reference", "natural"])
@pytest.mark.parametrize("shape", [(2, 9000), (3, 8192), (2, 8320), (2, 130),
                                   (2, 2)])
def test_kernel_route_on_cpu_is_bitwise_plain(shape, mode):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    if shape[1] > 4100:
        x[0, 4094:4098] = np.nan  # a NaN run across a tile edge
        x[1, 4096] = 5.0          # a spike on the tile edge
    xt = torch.from_numpy(x)
    cuda_fill.reset_launches()
    a = linear_baseline_extract(xt, endpoint_mode=mode, backend="torch")
    b = linear_baseline_extract(xt, endpoint_mode=mode, backend="kernel")
    for f in a._fields:
        assert bitwise_equal(getattr(a, f), getattr(b, f)), f
    assert all(v == 0 for v in cuda_fill.LAUNCHES.values())


def test_reference_endpoint_quirk_and_batch_shape():
    s = np.sin(np.linspace(0, 30, 256))
    out = linear_baseline_extract(torch.from_numpy(s))
    assert float(out.baseline[-1]) == 0.0
    nat = linear_baseline_extract(torch.from_numpy(s), endpoint_mode="natural")
    assert float(nat.baseline[-1]) != 0.0
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 3, 64)))
    out = linear_baseline_extract(x)
    assert out.baseline.shape == (2, 3, 64) and out.num_extrema.shape == (2, 3)


def test_plain_route_is_differentiable():
    x = torch.from_numpy(np.sin(np.linspace(0, 20, 200))).requires_grad_()
    out = linear_baseline_extract(x)
    (out.rotation ** 2).sum().backward()
    assert torch.isfinite(x.grad).all()


def test_bad_arguments_raise():
    x = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="endpoint_mode"):
        linear_baseline_extract(x, endpoint_mode="bogus")
    with pytest.raises(ValueError, match="backend"):
        linear_baseline_extract(x, backend="bogus")
    with pytest.raises(ValueError, match="2 samples"):
        linear_baseline_extract(torch.zeros(2, 1))
    with pytest.raises(ValueError, match="f32"):
        linear_baseline_extract(x.double(), backend="kernel")
    with pytest.raises(NotImplementedError, match="backward"):
        linear_baseline_extract(x.requires_grad_(), backend="kernel")
