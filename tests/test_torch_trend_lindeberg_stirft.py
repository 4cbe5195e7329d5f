"""The port's transforms (``pyitd_tpu_torch/decomp/trend.py``,
``lindeberg.py``, ``stirft.py``) against the JAX package's on the same
numpy inputs, on the CPU: f64 to 1e-12 of max|x| (of max|S| for the STFTs),
knot masks exactly.  The cases of ``tests/test_transforms_2d.py:67-146,
185-209``, plus:

* ``torch.gradient`` against ``jnp.gradient`` at the edges and on complex
  frames, ``torch.sign(0) == 0``;
* the recursive filter against the sequential loop (its oracle);
* ``time_causal_stft`` of a bank row by row against JAX's 1-D result; JAX's
  batched result differs (it differentiates along axis 1, the frequency
  axis of a bank: ROADMAP queue 3), pinned in a test of its own;
* ``istirft`` with a nonzero buffer, chained over blocks, and with frames
  that are no multiple of the hop; its 2-D-only guard.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyitd_tpu.decomp import lindeberg as jl
from pyitd_tpu.decomp import stirft as js
from pyitd_tpu.decomp import trend as jt
from pyitd_tpu_torch import (compute_synthesis_window, custom_filter_engine,
                             decompose_signal, istirft, stirft,
                             time_causal_stft)
from pyitd_tpu_torch.decomp import lindeberg as tl
from pyitd_tpu_torch.decomp import trend as tt

torch.set_num_threads(1)
CPU = "cpu"


def tnp(t):
    return t.detach().cpu().numpy()


def close(got, want, scale, tol=1e-12):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def trend_signal(n=2000):
    """``tests/test_transforms_2d.py::test_trend_decomposition_
    reconstructs``'s signal."""
    x = np.linspace(-10, 10, n)
    return np.sin(x) + 0.44 * np.cos(7 * x)


def trend_bank():
    """Smooth rows.  On a noisy row the later trends' knots sit where the
    filtered signal's second derivative is within roundoff of 0, so they
    follow the order of additions: a row with 0.05 noise first differs
    from JAX in 4 knots at the fourth trend, on inputs 4e-16 apart."""
    rng = np.random.default_rng(9)
    s = trend_signal(1500)
    t = np.linspace(0, 1, s.size)
    return np.stack([s, 0.5 * s + 3 * t ** 2,
                     np.sin(2 * np.pi * (3 + rng.random()) * t) * (1 + t)])


def test_gradient_and_sign_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 17))
    z = x + 1j * rng.normal(size=x.shape)
    for a in (x, z):
        np.testing.assert_array_equal(
            tnp(torch.gradient(torch.from_numpy(a), dim=-1)[0]),
            np.asarray(jnp.gradient(jnp.asarray(a), axis=-1)))
    assert torch.sign(torch.tensor(0.0)) == 0 == float(jnp.sign(0.0))


@pytest.mark.parametrize("shape", ["1-D", "bank"])
def test_filter_and_trend_match_jax(shape):
    x = trend_signal() if shape == "1-D" else trend_bank()
    scale = np.abs(x).max()
    close(tnp(custom_filter_engine(x, device=CPU)),
          np.asarray(jt.custom_filter_engine(jnp.asarray(x))), scale)
    want, wmask = jt.extract_trend(jnp.asarray(x))
    got, mask = tt.extract_trend(x, device=CPU)
    np.testing.assert_array_equal(tnp(mask), np.asarray(wmask))
    close(tnp(got), np.asarray(want), scale)


@pytest.mark.parametrize("shape", ["1-D", "bank"])
def test_decompose_signal_matches_jax_and_reconstructs(shape):
    x = trend_signal() if shape == "1-D" else trend_bank()
    wc, wr = jt.decompose_signal(jnp.asarray(x))
    gc, gr = decompose_signal(x, device=CPU)
    assert len(gc) == len(wc)
    scale = np.abs(x).max()
    for g, w in zip(gc, wc):
        close(tnp(g), np.asarray(w), scale)
    close(tnp(gr), np.asarray(wr), scale)
    total = sum(tnp(c) for c in gc) + tnp(gr)
    np.testing.assert_allclose(total, x, atol=1e-8)


def test_recursive_filter_matches_sequential_and_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 300))
    mu = 1.7
    y = np.zeros_like(x)
    y[:, 0] = x[:, 0]
    for i in range(1, x.shape[-1]):
        y[:, i] = y[:, i - 1] + (x[:, i] - y[:, i - 1]) / (1 + mu)
    got = tnp(tl.recursive_filter(x, mu, device=CPU))
    close(got, y, 1.0)
    close(got, np.asarray(jl.recursive_filter(jnp.asarray(x), mu)), 1.0)


@pytest.mark.parametrize("n_fft,hop", [(256, 64), (128, 50)])
def test_dft_centered_stft_matches_jax(n_fft, hop):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 2048))
    win = np.hanning(n_fft)
    want = np.asarray(jl.dft_centered_stft(jnp.asarray(x), n_fft, hop,
                                           jnp.asarray(win)))
    got = tnp(tl.dft_centered_stft(x, n_fft, hop, win, device=CPU))
    assert got.shape == want.shape
    close(got, want, np.abs(want).max())


def test_time_causal_stft_matches_jax_row_by_row():
    x = np.sin(np.linspace(0, 200, 4000))
    rng = np.random.default_rng(6)
    xb = np.stack([x, x + 0.3 * rng.normal(size=x.size)])
    kw = dict(n_fft=256, hop_len=64, tau_max=0.1, c=2.0, k=4)
    got = tnp(time_causal_stft(xb, device=CPU, **kw))
    assert got.shape[1] == 256 // 2 + 1 and np.all(got >= 0)
    for i in range(2):
        want = np.asarray(jl.time_causal_stft(jnp.asarray(xb[i]), **kw))
        close(got[i], want, np.abs(want).max())
    got = tnp(time_causal_stft(x, device=CPU))
    want = np.asarray(jl.time_causal_stft(jnp.asarray(x)))
    close(got, want, np.abs(want).max())


def test_jax_time_causal_stft_differentiates_a_bank_along_frequency():
    """JAX's ``time_causal_stft`` takes the time derivatives along axis 1,
    the frequency axis of a (channels, n) bank: its batched result is not
    its own per-row result, where the port's is."""
    rng = np.random.default_rng(7)
    xb = rng.normal(size=(3, 4096))
    jb = np.asarray(jl.time_causal_stft(jnp.asarray(xb)))
    rows = np.stack([np.asarray(jl.time_causal_stft(jnp.asarray(r)))
                     for r in xb])
    assert np.abs(jb - rows).max() > 0.1 * np.abs(rows).max()
    close(tnp(time_causal_stft(xb, device=CPU)), rows, np.abs(rows).max())


def test_synthesis_window_matches_jax():
    for hop in (64, 128, 100):
        np.testing.assert_array_equal(
            compute_synthesis_window(np.hanning(512), hop),
            js.compute_synthesis_window(np.hanning(512), hop))


def test_stirft_matches_jax_per_row():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 4096))
    win = compute_synthesis_window(np.hanning(512), 128)
    want = np.asarray(js.stirft(jnp.asarray(x), jnp.asarray(win)))
    got = tnp(stirft(x, win, device=CPU))
    assert got.shape == want.shape == (3, 512, 32)
    close(got, want, np.abs(x).max())
    one = tnp(stirft(x[1], win, device=CPU))
    np.testing.assert_array_equal(one, got[1])


def _istirft_case():
    rng = np.random.default_rng(4)
    x = np.sin(np.linspace(0, 120, 6000)) + 0.1 * rng.normal(size=6000)
    msewin = compute_synthesis_window(np.hanning(512), 128)
    return x, np.asarray(js.stirft(jnp.asarray(x), jnp.asarray(msewin)))


@pytest.mark.parametrize("buffer", ["zero", "nonzero"])
def test_istirft_matches_jax(buffer):
    x, s = _istirft_case()
    buf = np.zeros(384) if buffer == "zero" else \
        np.random.default_rng(1).normal(size=384)
    win = np.hanning(512) * 2
    want, want_buf = js.istirft(jnp.asarray(s), jnp.asarray(buf),
                                jnp.asarray(win))
    got, got_buf = istirft(s, buf, win, device=CPU)
    scale = np.abs(np.asarray(want)).max()
    close(tnp(got), np.asarray(want), scale)
    close(tnp(got_buf), np.asarray(want_buf), scale)


def test_istirft_chains_block_by_block():
    """Four chained blocks give the single call's output and buffer."""
    x, s = _istirft_case()
    win = np.hanning(512) * 2
    whole, whole_buf = istirft(s, np.zeros(384), win, device=CPU)
    buf, outs = torch.zeros(384, dtype=torch.float64), []
    for blk in np.array_split(np.arange(s.shape[1]), 4):
        out, buf = istirft(s[:, blk], buf, win, device=CPU)
        outs.append(out)
    scale = float(whole.abs().max())
    close(tnp(torch.cat(outs)), tnp(whole), scale)
    close(tnp(buf), tnp(whole_buf), scale)


def test_istirft_frames_no_multiple_of_the_hop():
    rng = np.random.default_rng(2)
    for n_fft, hop in ((500, 128), (512, 100)):
        sx = rng.normal(size=(n_fft, 13))
        buf = rng.normal(size=n_fft - hop)
        win = rng.normal(size=n_fft)
        want, want_buf = js.istirft(jnp.asarray(sx), jnp.asarray(buf),
                                    jnp.asarray(win), n_fft=n_fft,
                                    hop_len=hop)
        got, got_buf = istirft(sx, buf, win, n_fft=n_fft, hop_len=hop,
                               device=CPU)
        scale = np.abs(np.asarray(want)).max()
        close(tnp(got), np.asarray(want), scale)
        close(tnp(got_buf), np.asarray(want_buf), scale)


def test_stirft_roundtrip_fidelity_and_guard():
    """``tests/test_transforms_2d.py::test_stirft_roundtrip_fidelity`` on
    the port, and the one-channel guard."""
    x, _ = _istirft_case()
    msewin = compute_synthesis_window(np.hanning(512), 128)
    s = stirft(x, msewin, device=CPU)
    y, _ = istirft(s, np.zeros(384), np.hanning(512) * 2)
    got = tnp(y)[384:]
    want = x[128:128 + got.size]
    m = min(got.size, want.size) - 512
    assert np.corrcoef(got[:m], want[:m])[0, 1] > 0.999
    with pytest.raises(ValueError, match="one channel"):
        istirft(s[None], np.zeros(384), np.hanning(512) * 2)


def test_numpy_goes_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: decompose_signal(trend_signal()),
               lambda: time_causal_stft(trend_signal()),
               lambda: stirft(trend_signal(), np.hanning(512))):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            fn()
