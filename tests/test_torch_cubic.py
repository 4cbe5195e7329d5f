"""The port's cubic tier (``pyitd_tpu_torch/ops/cubic_baseline.py`` and the
plain versions of its kernels in ``ops/cuda_cubic.py``) against the JAX
package's, on the same numpy inputs, on the CPU.

* K5 ``cubic_ksite`` against JAX's ``cubic_ksite_padded(interpret=True)``:
  the knot mask exactly, ``k_site`` to 1e-5 max|x| (XLA contracts the
  Frei-Osorio formula into an FMA; ROADMAP queue 3, "How to compare");
* K6 ``cubic_neighbors`` on JAX's ``k_site`` against
  ``cubic_neighbors_padded(interpret=True)``: positions exact, values
  bitwise (it only selects);
* the gather route against JAX's in f64 to 1e-12;
* the fills route (the kernels' plain versions) against JAX's fills route
  and its f64 gather route: extrema counts exactly, the baseline to 2e-6
  max|baseline| (``tests/test_cubic.py:195``);
* the degenerate rows on both routes against JAX's gather route to 3e-6
  of the row's scale (``tests/test_cubic.py:306-338``);
* the gradient through both routes with fixed cotangents in f64 against
  JAX's gather AD to 1e-10 (``tests/test_cubic.py:366-403``), and the
  pass-through gradient as the identity.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyitd_tpu.ops import pallas_fill as pf
from pyitd_tpu.ops.cubic_baseline import cubic_baseline_extract as jax_cubic
from pyitd_tpu_torch import cubic_baseline_extract
from pyitd_tpu_torch.ops import cuda_cubic as cc
from pyitd_tpu_torch.ops import cuda_fill as cf
from pyitd_tpu_torch.ops.linear_baseline import knot_mask

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ends(x):
    n = x.shape[-1]
    return (0.5 * (3.0 * x[:, 0] - x[:, 1]),
            0.5 * (3.0 * x[:, n - 1] - x[:, n - 2]))


@pytest.fixture(scope="module")
def seam_case():
    """Two rows of 8192+600 with a NaN triple across JAX's block seam
    (tests/test_cubic.py:273-279), and JAX's K5 and K6 on them."""
    rng = np.random.default_rng(13)
    n = pf.BLK + 600
    t = np.linspace(0, 4 * np.pi, n)
    x = np.stack([np.sin(9 * t) + 0.1 * rng.normal(size=n),
                  np.cos(4 * t) + 0.05 * rng.normal(size=n)]
                 ).astype(np.float32)
    x[1, pf.BLK - 1:pf.BLK + 2] = np.nan
    x3, pe, ne, npad, _ = pf._pad_edges(jnp.asarray(x))
    nex, fp0 = pf.level_block_states_fwd(x3, n)
    bf, bl = (jnp.asarray(v) for v in _ends(x))
    ks3 = pf.cubic_ksite_padded(x3, pe, ne, bf, bl, fp0, n, interpret=True)
    kp = pf.ksite_block_states(x3, ks3, n)
    nbr = pf.cubic_neighbors_padded(x3, ks3, pe, ne, kp, n, interpret=True)

    def crop(a3):
        return np.asarray(a3).reshape(2, npad)[:, :n]

    mask = np.asarray(pf._knot_mask_flat(x3.reshape(2, npad), n)[0])[:, :n]
    return x, np.asarray(nex), mask, crop(ks3), [crop(a) for a in nbr]


def test_ksite_matches_jax_kernel(seam_case):
    x, nex, mask, k_jax, _ = seam_case
    xt = _t(x)
    states = cf.level_states(xt)
    np.testing.assert_array_equal(knot_mask(xt).numpy(), mask)
    np.testing.assert_array_equal(states.nex.numpy(), nex)
    bf, bl = (_t(v) for v in _ends(x))
    k = cc.cubic_ksite_cuda(xt, states, bf, bl).numpy()
    nan = np.isnan(k_jax)
    np.testing.assert_array_equal(np.isnan(k), nan)
    assert nan[1].any() and not nan[0].any()
    assert np.abs(k - k_jax)[~nan].max() <= 1e-5 * np.nanmax(np.abs(x))


def test_neighbors_match_jax_kernel(seam_case):
    x, _, _, k_jax, (p1p, p2p, n1p, kj, kjm1, kj1) = seam_case
    xt = _t(x)
    nb = cc.cubic_neighbors_cuda(xt, _t(k_jax), cf.level_states(xt))
    for got, want in zip(nb[:3], (p1p, p2p, n1p)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    for got, want in zip(nb[3:], (kj, kjm1, kj1)):
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))


def test_wrappers_on_cpu_count_no_launch(seam_case):
    x = _t(seam_case[0])
    cc.reset_launches()
    r = cubic_baseline_extract(x, x.shape[-1] + 2, min_extrema=0,
                               eval_backend="fills")
    assert set(cc.LAUNCHES.values()) == {0}
    assert r.baseline.dtype == torch.float32
    with pytest.raises(ValueError, match="float32"):
        cc.cubic_ksite_cuda(x.double(), cf.level_states(x), *_t(
            np.zeros((2, 2), np.float32)))


def _signals():
    rng = np.random.default_rng(5)
    n = 4500
    t = np.linspace(0, 2 * np.pi, n)
    yield "4500", np.stack([np.sin(24 * t) + 0.3 * rng.normal(size=n),
                            np.cos(17 * t) + 0.1 * t
                            + 0.2 * rng.normal(size=n)])
    n = 3 * 2048 + 17   # three SPIKE blocks and a ragged fourth
    t = np.linspace(0, 6 * np.pi, n)
    yield "6161", np.stack([np.sin(40 * t) + 0.3 * rng.normal(size=n),
                            rng.normal(size=n)])


SIGNALS = list(_signals())


@pytest.mark.parametrize("capacity", ["n+2", 40])
def test_gather_matches_jax_f64(capacity):
    """With the pass-through guard (a row with few extrema) and with a
    capacity that truncates the knots."""
    x = SIGNALS[0][1][:, :300].copy()
    x[1] = np.sin(np.linspace(0, 6, 300))
    cap = 302 if capacity == "n+2" else capacity
    a = jax_cubic(jnp.asarray(x), cap, min_extrema=10, eval_backend="gather")
    b = cubic_baseline_extract(_t(x), cap, min_extrema=10,
                               eval_backend="gather")
    np.testing.assert_array_equal(b.num_extrema.numpy(),
                                  np.asarray(a.num_extrema))
    for f in ("baseline", "rotation"):
        np.testing.assert_allclose(getattr(b, f).numpy(),
                                   np.asarray(getattr(a, f)), rtol=0,
                                   atol=1e-12 * max(1, np.abs(x).max()))
    np.testing.assert_array_equal(b.baseline[1].numpy(), x[1])


@pytest.mark.parametrize("name,x", SIGNALS, ids=[s[0] for s in SIGNALS])
def test_fills_route_matches_jax(name, x):
    n = x.shape[-1]
    x32 = x.astype(np.float32)
    oracle = jax_cubic(jnp.asarray(x32, jnp.float64), n + 2, min_extrema=0,
                       eval_backend="gather")
    got = cubic_baseline_extract(_t(x32), n + 2, min_extrema=0,
                                 eval_backend="fills")
    np.testing.assert_array_equal(got.num_extrema.numpy(),
                                  np.asarray(oracle.num_extrema))
    want = np.asarray(oracle.baseline)
    scale = np.abs(want).max()
    assert np.abs(got.baseline.numpy() - want).max() <= 2e-6 * scale
    np.testing.assert_array_equal(got.rotation.numpy(),
                                  (_t(x32) - got.baseline).numpy())
    if name == "4500":   # JAX's own fills route (interpret-mode kernels)
        jf = jax_cubic(jnp.asarray(x32), n + 2, min_extrema=0,
                       eval_backend="fills")
        np.testing.assert_array_equal(got.num_extrema.numpy(),
                                      np.asarray(jf.num_extrema))
        assert np.abs(got.baseline.numpy()
                      - np.asarray(jf.baseline)).max() <= 2e-6 * scale


def test_fills_keeps_f64_and_batch_shape():
    """f64 in: f32 inside, f64 out, rotation = x - baseline in f64; a 1-D
    signal gives a 0-d extrema count."""
    x = SIGNALS[0][1]
    r64 = cubic_baseline_extract(_t(x), x.shape[-1] + 2, min_extrema=0,
                                 eval_backend="fills")
    r32 = cubic_baseline_extract(_t(x.astype(np.float32)), x.shape[-1] + 2,
                                 min_extrema=0, eval_backend="fills")
    assert r64.baseline.dtype == torch.float64
    np.testing.assert_array_equal(r64.baseline.numpy(),
                                  r32.baseline.double().numpy())
    np.testing.assert_array_equal(r64.rotation.numpy(),
                                  x - r64.baseline.numpy())
    r1 = cubic_baseline_extract(_t(x[0]), x.shape[-1] + 2, min_extrema=0,
                                eval_backend="fills")
    assert r1.num_extrema.shape == ()
    np.testing.assert_array_equal(r1.baseline.numpy(), r64.baseline[0])


@pytest.mark.parametrize("backend", ["gather", "fills"])
def test_f64_guard_returns_the_row_itself(backend):
    """A row with fewer than ``min_extrema`` extrema returns x itself in
    f64 and a rotation of exactly 0 on both routes; the fills route
    computes in f32 and must not pass f64(f32(x)) through (JAX's fills
    routes do: ROADMAP queue 3)."""
    t = np.linspace(0, 6, 256)
    x = np.stack([np.sin(t) + 0.1 * t, np.sin(40 * t)]) * (1 + 1e-9)
    assert not np.array_equal(x, x.astype(np.float32))
    r = cubic_baseline_extract(_t(x), 258, min_extrema=10,
                               eval_backend=backend)
    assert r.num_extrema.tolist()[0] < 10 <= r.num_extrema.tolist()[1]
    assert r.baseline.dtype == torch.float64
    np.testing.assert_array_equal(r.baseline[0].numpy(), x[0])
    assert not r.rotation[0].any()
    assert r.rotation[1].abs().max() > 0.5


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


@pytest.mark.parametrize("name", list(_degenerate()))
def test_degenerate_rows_match_jax(name):
    sig = _degenerate()[name]
    ref = np.asarray(jax_cubic(jnp.asarray(sig), sig.size + 2, min_extrema=0,
                               eval_backend="gather").baseline)
    scale = max(1.0, np.abs(sig).max())
    for backend in ("gather", "fills"):
        r = cubic_baseline_extract(_t(sig), sig.size + 2, min_extrema=0,
                                   eval_backend=backend)
        np.testing.assert_allclose(r.baseline.numpy(), ref, rtol=0,
                                   atol=3e-6 * scale, err_msg=backend)


def _jax_pullback(x, ct_r, ct_b, min_extrema):
    def f(xx):
        r = jax_cubic(xx, x.size + 2, min_extrema=min_extrema,
                      eval_backend="gather")
        return r.rotation, r.baseline

    _, pull = jax.vjp(f, jnp.asarray(x))
    return np.asarray(pull((jnp.asarray(ct_r), jnp.asarray(ct_b)))[0])


def _pullback(x, ct_r, ct_b, min_extrema, backend):
    xt = _t(x).requires_grad_()
    r = cubic_baseline_extract(xt, x.size + 2, min_extrema=min_extrema,
                               eval_backend=backend)
    (g,) = torch.autograd.grad((r.rotation, r.baseline), xt,
                               (_t(ct_r), _t(ct_b)))
    return g.numpy()


_GRAD_CASES = {"noise": np.random.default_rng(7).standard_normal(96)}
_GRAD_CASES.update({k: v for k, v in _degenerate().items()
                    if k in ("tent", "monotone", "constant", "two_extrema")})


@pytest.mark.parametrize("name", list(_GRAD_CASES))
def test_grad_matches_jax_gather_ad(name):
    x = _GRAD_CASES[name]
    rng = np.random.default_rng(11)
    ct_r, ct_b = rng.standard_normal(x.size), rng.standard_normal(x.size)
    ref = _jax_pullback(x, ct_r, ct_b, 0)
    for backend in ("gather", "fills"):
        np.testing.assert_allclose(_pullback(x, ct_r, ct_b, 0, backend), ref,
                                   rtol=0, atol=1e-10, err_msg=backend)


def test_grad_passthrough_is_identity():
    x = np.linspace(0.0, 3.0, 64) ** 2
    ct_r = np.random.default_rng(3).standard_normal(64)
    ct_b = np.random.default_rng(4).standard_normal(64)
    for backend in ("gather", "fills"):
        np.testing.assert_allclose(_pullback(x, ct_r, ct_b, 10, backend),
                                   ct_b, rtol=0, atol=1e-12)
    # a cotangent on one output only
    xt = _t(x).requires_grad_()
    r = cubic_baseline_extract(xt, 66, min_extrema=0, eval_backend="fills")
    r.rotation.sum().backward()
    assert torch.isfinite(xt.grad).all()


def test_backends_resolve_and_refuse():
    x = torch.zeros(2, 64)
    # JAX's other eval backends are not ported and raise, naming the two
    # routes that are (tests/test_torch_cubic_routes.py holds those to
    # every JAX route's answer)
    for name in ("scan", "fills_packed", "fills_compact", "fills_unfused",
                 "fills_fused", "nope"):
        with pytest.raises(ValueError, match="unknown.*'fills' and "
                                             "'gather'"):
            cubic_baseline_extract(x, 66, eval_backend=name)
    with pytest.raises(ValueError, match="2\\^24"):
        cubic_baseline_extract(torch.zeros(1, (1 << 24) + 1), 8,
                               eval_backend="fills")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cubic_baseline_extract(x, 8, eval_backend="fills")
    assert any("capacity" in str(m.message) for m in w)
    # auto on a CPU tensor is the gather route: exact at any n, any dtype
    a = cubic_baseline_extract(x.double(), 66)
    b = cubic_baseline_extract(x.double(), 66, eval_backend="gather")
    assert torch.equal(a.baseline, b.baseline)
