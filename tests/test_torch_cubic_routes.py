"""The cubic tier's two routes (``pyitd_tpu_torch/ops/cubic_baseline.py``:
``"gather"`` and ``"fills"``) against each of the JAX package's other
routes (``"scan"``, ``"fills_unfused"``, ``"fills_compact"``,
``"fills_packed"``, ``"fills_fused"``), which the port refuses, and
``linear_fill2``'s plain version (``ops/cuda_fill.py``) against JAX's
kernel, on the CPU, on the same numpy inputs: a JAX user of any of those
routes gets what the port's routes give.

JAX's fills routes run their Pallas kernels in interpret mode and, on the
CPU, the chained solver by grid PCR (``use_spike=not interp``); the port's
``"fills"`` route runs its kernels' plain versions on a CPU tensor.
Tolerances:

* ``linear_fill2``: positions exact, values bitwise (a fill only selects);
* ``"gather"`` in f64 against JAX's ``"scan"`` to 1e-12 of max|x|;
* ``"fills"`` (f32) against each route to 1e-5 of max|x|: XLA on the CPU
  contracts ``a*b+c`` into FMAs, torch does not (ROADMAP queue 3), and
  each route holds its extrema count exactly;
* gradients with fixed cotangents in f64 to 1e-10 (JAX's
  ``tests/test_cubic.py:366-380``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyitd_tpu.ops import pallas_fill as pf
from pyitd_tpu.ops.cubic_baseline import cubic_baseline_extract as jax_cubic
from pyitd_tpu_torch import cubic_baseline_extract
from pyitd_tpu_torch.ops import cuda_fill as cf
from pyitd_tpu_torch.ops.linear_baseline import knot_mask

torch.set_num_threads(1)

# JAX's eval routes that the port does not take
ROUTES = ("scan", "fills_unfused", "fills_compact", "fills_packed",
          "fills_fused")


def _noisy(rows, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n)
    return (np.sin(2 * np.pi * 9 * t)[None]
            + 0.3 * rng.normal(size=(rows, n))).astype(dtype)


def _jax(x, cap, route, min_extrema=0):
    r = jax_cubic(jnp.asarray(x), cap, min_extrema=min_extrema,
                  eval_backend=route)
    return np.asarray(r.baseline), np.asarray(r.num_extrema)


def _port(x, cap, route, min_extrema=0):
    return cubic_baseline_extract(torch.from_numpy(x), cap,
                                  min_extrema=min_extrema, eval_backend=route)


@pytest.mark.parametrize("reverse", [False, True])
def test_linear_fill2_matches_jax(reverse):
    """Ragged n, a NaN triple, a NaN endpoint, a plateau and a constant
    row: the plain version (and the wrapper on a CPU tensor) against
    ``linear_fill2_pallas(interpret=True)``."""
    n = 1000
    x = _noisy(4, n, 3)
    x[1, 400:403] = np.nan
    x[2, 0] = np.nan
    x[2, 500:520] = 0.25
    x[3] = 1.0
    want = pf.linear_fill2_pallas(jnp.asarray(x), reverse=reverse,
                                  interpret=True)
    xt = torch.from_numpy(x)
    got = cf.linear_fill2(xt, reverse)
    for w, g in zip(want, got):
        w = np.asarray(w)
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), w.astype(np.int32))
        else:
            np.testing.assert_array_equal(g.numpy().view(np.int32),
                                          w.view(np.int32))
    for a, b in zip(cf.linear_fill2_cuda(xt, reverse), got):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # and it is fill2 under the knot mask
    for a, b in zip(cf.fill2(xt, knot_mask(xt), reverse), got):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("route", ROUTES)
def test_removed_routes_refuse(route):
    x = torch.from_numpy(_noisy(2, 256, 1))
    with pytest.raises(ValueError, match="'fills' and 'gather'"):
        cubic_baseline_extract(x, 258, eval_backend=route)


def test_scan_matches_jax_f64():
    """JAX's scan route against the port's gather route in f64."""
    x = _noisy(3, 1500, 5, np.float64)
    cap = x.shape[-1] + 2
    b_jax, nex_jax = _jax(x, cap, "scan")
    r = _port(x, cap, "gather")
    scale = np.abs(x).max()
    np.testing.assert_array_equal(r.num_extrema.numpy(), nex_jax)
    np.testing.assert_allclose(r.baseline.numpy(), b_jax, rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_array_equal(r.rotation.numpy(), x - r.baseline.numpy())


@pytest.mark.parametrize("route", ROUTES)
def test_route_matches_jax_f32(route):
    """The port's fills route on f32 rows against JAX's ``route``: the
    extrema count exactly, the baseline to 1e-5 of max|x|; the f64 gather
    route within ``CUBIC_F64_REL`` (2e-6) of max|baseline|.  Rows of 1,500
    (ragged against every tile) with one guarded row."""
    n = 1500
    x = _noisy(3, n, 7)
    x[2] = np.sin(np.linspace(0, 6, n)).astype(np.float32)  # 2 extrema
    cap = n + 2
    b_jax, nex_jax = _jax(x, cap, route, min_extrema=3)
    r = _port(x, cap, "fills", min_extrema=3)
    np.testing.assert_array_equal(r.num_extrema.numpy(), nex_jax)
    scale = np.abs(x).max()
    np.testing.assert_allclose(r.baseline.numpy(), b_jax, rtol=0,
                               atol=1e-5 * scale)
    # the guarded row passes through exactly
    np.testing.assert_array_equal(r.baseline[2].numpy(), x[2])
    assert not r.rotation[2].any()
    ref = _port(x.astype(np.float64), cap, "gather", min_extrema=3).baseline
    err = (r.baseline.double() - ref).abs().max() / ref.abs().max()
    assert err < 2e-6, err


@pytest.mark.parametrize("route", ["fills"])
def test_chained_routes_warn_on_small_capacity(route):
    x = torch.from_numpy(_noisy(1, 256, 2))
    with pytest.warns(UserWarning, match="capacity"):
        cubic_baseline_extract(x, 8, eval_backend=route)


def _degenerate():
    n = 32
    t = np.arange(n, dtype=float)
    return {
        "tent": np.minimum(t, n - 1 - t),
        "asym_tent": np.where(t < 9, t, (n - 1 - t) * 9.0 / (n - 10)),
        "monotone": t * 1.7,
        "constant": np.ones(n),
        "two_extrema": np.sin(2 * np.pi * t / 20),
        "two_sample": np.array([1.0, 2.0]),
    }


@pytest.mark.parametrize("route", ROUTES)
def test_degenerate_rows_match_jax(route):
    """JAX's degenerate-row matrix (``tests/test_cubic.py:306-338``): the
    port's fills route against JAX's ``route`` to 3e-6 of the row's
    scale."""
    for name, sig in _degenerate().items():
        x = sig[None]
        cap = x.shape[-1] + 2
        ref, _ = _jax(x, cap, route)
        r = _port(x, cap, "fills")
        scale = max(1.0, float(np.abs(sig).max()))
        np.testing.assert_allclose(r.baseline.numpy(), ref, rtol=0,
                                   atol=3e-6 * scale, err_msg=name)


def _pullback_jax(x, ct_r, ct_b, route):
    import jax

    def f(xx):
        r = jax_cubic(xx, x.shape[-1] + 2, min_extrema=0, eval_backend=route)
        return r.rotation, r.baseline

    _, pull = jax.vjp(f, jnp.asarray(x))
    return np.asarray(pull((jnp.asarray(ct_r), jnp.asarray(ct_b)))[0])


@pytest.mark.parametrize("route", ROUTES)
def test_gradient_matches_jax(route):
    """Fixed cotangents through the port's fills route in f64 against JAX's
    ``route``'s VJP to 1e-10."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 96))
    ct_r, ct_b = rng.standard_normal((2, 2, 96))
    want = _pullback_jax(x, ct_r, ct_b, route)
    xt = torch.from_numpy(x).requires_grad_()
    r = cubic_baseline_extract(xt, 98, min_extrema=0, eval_backend="fills")
    (g,) = torch.autograd.grad([r.rotation, r.baseline], xt,
                               [torch.from_numpy(ct_r), torch.from_numpy(ct_b)])
    np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-10)
