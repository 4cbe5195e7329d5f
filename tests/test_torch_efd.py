"""The port's EFD family (``pyitd_tpu_torch/decomp/efd.py``) against the
JAX package's and the numpy oracles, on the same numpy inputs, on the CPU.

* ``efd`` on the cases of ``tests/test_efd.py``: against JAX and
  ``tests/reference/efd_ref.py`` to 1e-9 in f64, against JAX in f32 (the
  same integer bounds, bands to 1e-5 of max|x|); the pass-through below 2
  raw peaks; bands shaped ``(..., n_bands + 2, n)``;
* at n = 2^18 against the oracle alone: JAX's int32 ``bound2``
  (``pyitd_tpu/decomp/efd.py:161``) overflows there;
* the flipped-domain family against JAX and
  ``tests/reference/modified_efd_ref.py``, the fewer-than-4-maxima guard
  included;
* a spectrum with plateaus and equal peaks: integer bounds equal to JAX's;
* the gradient of a scalar loss through the bands against ``jax.grad`` in
  f64 to 1e-10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyitd_tpu.decomp import efd as jefd
from pyitd_tpu_torch import (efd, efd_real, efd_slice_max, iterative_efd,
                             iterative_max)
from pyitd_tpu_torch.decomp import efd as tefd
from pyitd_tpu_torch.utils.interop import result_to_numpy
from reference.efd_ref import efd as ref_efd
from reference.modified_efd_ref import efd_real as ref_real
from reference.modified_efd_ref import efd_slice_max as ref_max
from reference.modified_efd_ref import segm_tec as ref_segm

torch.set_num_threads(1)
CPU = "cpu"


def three_cosines(n=1024):
    t = np.arange(n) / n
    return (np.cos(2 * np.pi * 30 * t) + 0.7 * np.cos(2 * np.pi * 90 * t)
            + 0.4 * np.cos(2 * np.pi * 200 * t))


def _cases():
    """(name, x, n_bands, clean): the cases of tests/test_efd.py.  In the
    one not ``clean``, 4 of the 6 maxima the segmentation keeps are FFT
    roundoff (about 1e-13 against a peak of 256): torch's CPU FFT (MKL)
    rounds otherwise than numpy's and JAX's, so the bounds follow the
    roundoff there, and each stage is held on the oracle's own input to
    it instead (ROADMAP queue 3, "How to compare")."""
    rng = np.random.default_rng(0)
    yield "three-cosines", three_cosines(), 3, True
    yield "fewer-peaks", np.cos(2 * np.pi * 10 * np.arange(512) / 512), 6, \
        False
    yield "noisy", three_cosines() + 0.05 * rng.normal(size=1024), 5, True


CASES = list(_cases())


def _half_spectrum(x):
    ff = np.fft.rfft(x)
    return np.abs(ff[:round(ff.size / 2)])


@pytest.mark.parametrize("name,x,nb,clean", CASES, ids=[c[0] for c in CASES])
def test_efd_f64_matches_jax_and_oracle(name, x, nb, clean):
    want_bands, want_cerf, want_bn, m = ref_efd(x, nb)
    # stage by stage on the oracle's spectrum: the same integer bounds,
    # then the same bands from them
    f = _half_spectrum(x)
    seg = tefd.spectral_segments(torch.from_numpy(f), nb)
    assert int(seg.count) == m
    np.testing.assert_array_equal(
        seg.bounds.numpy()[:m + 3],
        np.round(want_bn * f.size / np.pi).astype(np.int64))
    staged = tefd._efd_bands(torch.from_numpy(x), seg)
    np.testing.assert_allclose(staged.bands.numpy()[:m + 2], want_bands,
                               atol=1e-9)
    np.testing.assert_allclose(staged.cerf.numpy()[:m], want_cerf,
                               atol=1e-12)
    np.testing.assert_allclose(staged.bounds.numpy()[:m + 3], want_bn,
                               atol=1e-12)
    # end to end
    j = jefd.efd(jnp.asarray(x), nb)
    r = efd(x, nb, device=CPU)
    cnt = int(r.count)
    assert cnt == int(j.count) == m + 2 == want_bands.shape[0]
    assert r.bands.shape == (nb + 2, x.size)
    assert np.all(r.bands.numpy()[cnt:] == 0.0)
    if clean:
        np.testing.assert_allclose(r.bands.numpy()[:cnt], want_bands,
                                   atol=1e-9)
        np.testing.assert_allclose(r.bands.numpy(), np.asarray(j.bands),
                                   atol=1e-9)
        np.testing.assert_allclose(r.bounds.numpy(), np.asarray(j.bounds),
                                   atol=1e-12)


@pytest.mark.parametrize("name,x,nb,clean", CASES, ids=[c[0] for c in CASES])
def test_efd_f32_matches_jax(name, x, nb, clean):
    x32 = x.astype(np.float32)
    j = jefd.efd(jnp.asarray(x32), nb)
    r = efd(torch.from_numpy(x32), nb)
    assert r.bands.dtype == torch.float32
    assert int(r.count) == int(j.count)
    # the segmentation on JAX's own f32 spectrum, then the bands from it
    f = jnp.abs(jnp.fft.rfft(x32)[:x.size // 4])
    seg_j = jax.jit(jefd.spectral_segments, static_argnums=1)(f, nb)
    seg_t = tefd.spectral_segments(torch.from_numpy(np.asarray(f)), nb)
    np.testing.assert_array_equal(seg_t.bounds.numpy(),
                                  np.asarray(seg_j.bounds))
    staged = tefd._efd_bands(torch.from_numpy(x32), seg_t)
    np.testing.assert_allclose(staged.bands.numpy(), np.asarray(j.bands),
                               rtol=0, atol=1e-5 * np.abs(x).max())
    if clean:
        np.testing.assert_allclose(r.bands.numpy(), np.asarray(j.bands),
                                   rtol=0, atol=1e-5 * np.abs(x).max())


def test_efd_batched_shape_and_rows():
    """Bands are ``(..., n_bands + 2, n)`` (``tests/test_efd.py:139``
    asserts ``n_bands`` rows; the API returns ``n_bands + 2``), and each
    batch row equals the 1-D result."""
    rng = np.random.default_rng(4)
    x = np.stack([three_cosines() + 0.05 * rng.normal(size=1024)
                  for _ in range(3)]).reshape(3, 1, 1024)
    r = efd(x, 4, device=CPU)
    assert r.bands.shape == (3, 1, 6, 1024)
    assert r.count.shape == r.cerf.shape[:-1] == (3, 1)
    j = jefd.efd(jnp.asarray(x), 4)
    for got, want in zip(result_to_numpy(r), j):
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-9)
    for b in range(3):
        one = efd(x[b, 0], 4, device=CPU)
        np.testing.assert_allclose(r.bands[b, 0].numpy(), one.bands.numpy(),
                                   atol=1e-12)
        assert int(r.count[b, 0]) == int(one.count)


def test_efd_passthrough_below_two_raw_maxima():
    """EFD.py:29+81: a half spectrum with < 2 raw maxima returns the input;
    here band row 0 is x, count 1, the other rows zero."""
    x = np.exp(-5 * np.linspace(0, 1, 512))
    want_bands, _, _, m = ref_efd(x, 3)
    assert m is None
    for xx in (x, x.astype(np.float32)):
        r = efd(torch.from_numpy(xx), 3)
        assert int(r.count) == 1
        np.testing.assert_array_equal(r.bands.numpy()[0], xx)
        assert np.all(r.bands.numpy()[1:] == 0.0)


def test_efd_int64_bounds_at_2_18_match_the_oracle():
    """At n = 2^18 (half2 = 131072) every bound above 16384 overflows JAX's
    int32 ``bound2`` (``pyitd_tpu/decomp/efd.py:161``), the last one (n)
    always, so JAX is not compared here: the port computes it in int64 and
    is held against the numpy oracle."""
    n = 1 << 18
    rng = np.random.default_rng(3)
    t = np.linspace(0, 2 * np.pi, n)
    x = (np.cos(40 * t) + 0.7 * np.cos(250 * t) + 0.4 * np.cos(1200 * t)
         + 0.1 * rng.normal(size=n))
    want_bands, want_cerf, want_bn, m = ref_efd(x, 12)
    r = efd(x, 12, device=CPU)
    cnt = int(r.count)
    assert cnt == want_bands.shape[0] == m + 2 == 14
    # bins past 16384 of the half1 = 65536 half spectrum overflow in int32
    assert np.round(want_bn * 65536 / np.pi).max() * 131072 > 2 ** 31
    np.testing.assert_allclose(r.bands.numpy()[:cnt], want_bands, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(r.cerf.numpy()[:m], want_cerf, atol=1e-10)
    np.testing.assert_allclose(r.bounds.numpy()[:m + 3], want_bn,
                               atol=1e-12)


def test_spectral_segments_plateaus_and_ties_match_jax():
    """Plateaus, equal peaks, and maxima on neighbouring bins: the
    reversed-stable tie order and the plateau-rightmost dedup give the same
    integer bounds as JAX."""
    base = np.array([0., 1, 3, 3, 3, 1, 0, 2, 2, 1, .5, 3, 1, 0, 3, 1, 3, 1,
                     .2, 2, 2.5, 2.5, 1, 0, 1, 3, 0.5, 0.5, 1, 0.3])
    f = np.stack([base, base[::-1], np.tile([0., 2], 15), np.round(
        np.random.default_rng(1).uniform(0, 3, 30))])
    for nb in (3, 12):
        want = jax.jit(jefd.spectral_segments, static_argnums=1)(
            jnp.asarray(f), nb)
        got = tefd.spectral_segments(torch.from_numpy(f), nb)
        for fld in ("bounds", "count", "raw_peaks"):
            np.testing.assert_array_equal(getattr(got, fld).numpy(),
                                          np.asarray(getattr(want, fld)),
                                          err_msg=f"{fld} nb={nb}")
        np.testing.assert_allclose(got.cerf.numpy(), np.asarray(want.cerf),
                                   atol=1e-15)


def test_flipped_segments_ties_match_jax():
    robust = np.concatenate([np.array([0., 2, 1, 2, 1, 2, 2, 0, 3, 0, 3, 1,
                                       2, 1, 0, 2]), np.zeros(16)])
    for nr in (2, 6):
        jb, jc, js = jax.jit(jefd._flipped_segments, static_argnums=1)(
            jnp.asarray(robust), nr)
        tb, tc, ts = tefd._flipped_segments(torch.from_numpy(robust), nr)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        assert int(tc) == int(jc)
        np.testing.assert_array_equal(ts.numpy()[:int(tc)],
                                      np.asarray(js)[:int(jc)])


def test_efd_real_matches_jax_and_modified_oracle():
    """Band 0's EMPTY lo == 0 mirror (the reference's z[-hi:-0]) included."""
    row = np.random.default_rng(5).normal(size=257)
    want_bands, want_count, want_sort = ref_real(row, 4)
    bands, count, sort = efd_real(row, 4, device=CPU)
    jb, jc, js = jefd.efd_real(jnp.asarray(row), 4)
    assert int(count) == want_count == int(jc)
    assert bands.shape == (6, 257)
    for i in range(want_count + 2):
        np.testing.assert_allclose(bands.numpy()[i], want_bands[i],
                                   atol=1e-9)
    np.testing.assert_allclose(bands.numpy(), np.asarray(jb), atol=1e-12)
    np.testing.assert_array_equal(sort.numpy()[:want_count], want_sort)
    np.testing.assert_allclose(efd_slice_max(row, 4, device=CPU).numpy(),
                               ref_max(row, 4), atol=1e-9)


def test_efd_real_fewer_than_four_maxima_yields_no_bands():
    """modified_efd.py:65: < 4 maxima in the flipped half signal -> zero
    bounds, count 0, zero bands; efd_slice_max passes the row through."""
    t = np.linspace(0, 1, 64)
    row = np.fft.rfft(np.sin(2 * np.pi * 3 * t) + 0.2 * t).real
    robust = np.fft.irfft(row)
    assert ref_segm(robust[: robust.size // 2], 4)[1] == 0
    bands, count, _ = efd_real(row, 4, device=CPU)
    assert int(count) == 0 and bool((bands == 0).all())
    np.testing.assert_array_equal(efd_slice_max(row, 4, device=CPU).numpy(),
                                  row)


def test_iterative_extraction_matches_jax_and_reconstructs():
    row = np.random.default_rng(1).normal(size=257)
    for fn, jfn in ((iterative_max, jefd.iterative_max),
                    (iterative_efd, jefd.iterative_efd)):
        out = fn(row, elem=3, comb_size=4, device=CPU)
        assert out.shape == (4, 257)
        np.testing.assert_allclose(out.numpy(), np.asarray(jfn(
            jnp.asarray(row), elem=3, comb_size=4)), atol=1e-12)
        np.testing.assert_allclose(out.numpy().sum(0), row, atol=1e-9)


def test_efd_gradient_matches_jax():
    """A scalar loss through the bands: autograd against ``jax.grad`` in
    f64 (the bounds are constant in x)."""
    x = CASES[2][1]
    wts = np.random.default_rng(6).normal(size=(7, x.size))

    def jloss(a):
        return jnp.sum(jnp.asarray(wts) * jefd.efd(a, 5).bands ** 2)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    (g,) = torch.autograd.grad(
        (torch.from_numpy(wts) * efd(xt, 5).bands ** 2).sum(), xt)
    np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("fn,args", [
    (efd, (4,)), (efd_real, (4,)), (efd_slice_max, (4,)),
    (iterative_efd, (2, 4)), (iterative_max, (2, 4))],
    ids=["efd", "efd_real", "efd_slice_max", "iterative_efd",
         "iterative_max"])
def test_numpy_input_goes_to_the_card(fn, args, monkeypatch):
    """numpy input goes to ``device="cuda"`` by default, which raises
    without a card; a CPU tensor stays on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = three_cosines(256)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        fn(x, *args)
    out = fn(torch.from_numpy(x), *args)
    assert (out[0] if isinstance(out, tuple) else out).device.type == "cpu"
