"""The port's streaming tier (``pyitd_tpu_torch/decomp/streaming.py``,
``parallel/batch.py::sharded_streaming_itd``) against the JAX package's
and the native tier's, on the same numpy inputs, on the CPU.

* the offline replay (scalar and IQ) against JAX's ``lax.scan`` replay:
  f64 to 1e-12 of max|x|, ready flags exactly; the replay's batches of
  windows bitwise one batch, and its ATen calls the same for 8 and 64 hops;
* the one-hop step bitwise the replay; a JAX ``StreamState`` continued in
  the port against JAX continuing it;
* ``iq_baseline_extract`` against JAX (knot positions and counts exactly)
  and against the native tier (``pyitd_tpu.runtime``, skipped where it
  does not build, as ``tests/test_streaming_native.py`` does), the
  ``extrema=`` reuse, the degenerate quadrature pair;
* the native tier's ``StreamingITD`` against the port's replay;
* ``sharded_streaming_itd`` over two CPU devices bitwise the replay;
* numpy input goes to the card and raises without one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyitd_tpu import runtime
from pyitd_tpu.decomp import streaming as js
from pyitd_tpu_torch import (iq_baseline_extract, iq_extrema_mask,
                             streaming_init, streaming_itd, streaming_itd_iq,
                             streaming_step, streaming_step_iq)
from pyitd_tpu_torch.decomp import streaming as ts
from pyitd_tpu_torch.parallel import sharded_streaming_itd
from pyitd_tpu_torch.tools.level_bench import aten_ops
from pyitd_tpu_torch.utils.interop import stream_state_from_numpy

torch.set_num_threads(1)
CPU = "cpu"

needs_native = pytest.mark.skipif(
    not runtime.native_available(), reason="native toolchain unavailable")

j_replay = jax.jit(js.streaming_itd, static_argnums=1)
j_replay_iq = jax.jit(js.streaming_itd_iq, static_argnums=1)


def chirpy(n, seed=0):
    """``tests/test_streaming_native.py::chirpy``."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n)
    return np.sin(2 * np.pi * 40 * t * (1 + t)) + 0.1 * rng.normal(size=n)


def iq_pair(n, seed=0):
    """``tests/test_streaming_native.py::iq_pair``: coincident extrema in
    both channels."""
    t = np.linspace(0, 1, n)
    re = np.cos(2 * np.pi * 25 * t) * (1 + 0.3 * np.sin(2 * np.pi * 2 * t))
    im = 0.7 * re + 0.2 + 0.02 * np.sin(2 * np.pi * 5 * t)
    return re, im


def bank(rows, n):
    return np.stack([chirpy(n, seed=s) for s in range(rows)])


def iq_bank(rows, n):
    out = []
    for s in range(rows):
        re, im = iq_pair(n, seed=s)
        out.append((re + 1j * im) * (1 + 0.1 * s))
    return np.stack(out)


def tnp(t):
    return t.detach().cpu().numpy()


def close(got, want, scale):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)


REAL_CASES = [("1-D", chirpy(1024), 128), ("bank 3x1024", bank(3, 1024), 128),
              ("hop not dividing n", bank(2, 1000), 96),
              ("short hop", bank(2, 256), 16)]


@pytest.mark.parametrize("name,x,hop", REAL_CASES,
                         ids=[c[0] for c in REAL_CASES])
def test_replay_matches_jax(name, x, hop):
    want = [np.asarray(a) for a in j_replay(jnp.asarray(x), hop)]
    got = [tnp(a) for a in streaming_itd(x, hop, device=CPU)]
    scale = np.abs(x).max()
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape
        close(g, w, scale)
    np.testing.assert_array_equal(got[2], want[2])


def test_replay_reconstructs_inner_hops():
    """``tests/test_streaming_native.py::test_streaming_reconstructs_inner_
    hops`` on the port."""
    x = chirpy(1024)
    hop = 128
    r, b, rd = (tnp(a) for a in streaming_itd(x, hop, device=CPU))
    assert rd[:2].sum() == 0 and rd[2:].all()
    for k in range(2, r.shape[0]):
        np.testing.assert_allclose(r[k] + b[k], x[(k - 1) * hop:k * hop],
                                   atol=1e-10)
    assert np.var(np.diff(b[3])) < np.var(np.diff(x[2 * hop:3 * hop]))


@pytest.mark.parametrize("iq", [False, True], ids=["scalar", "iq"])
def test_step_is_bitwise_the_replay(iq):
    hop = 64
    x = iq_bank(3, 640) if iq else bank(3, 640)
    replay = (streaming_itd_iq if iq else streaming_itd)(x, hop, device=CPU)
    step = streaming_step_iq if iq else streaming_step
    state = streaming_init(hop, (3,), torch.complex128 if iq else
                           torch.float64, device=CPU)
    for k in range(10):
        state, rot, base, ready = step(state, x[:, k * hop:(k + 1) * hop],
                                       hop)
        assert torch.equal(rot, replay[0][k]) and torch.equal(
            base, replay[1][k]) and torch.equal(ready, replay[2][k]), k
    assert int(state.filled.min()) == 3


@pytest.mark.parametrize("iq", [False, True], ids=["scalar", "iq"])
def test_replay_batches_are_bitwise_one_batch(iq, monkeypatch):
    hop = 32
    x = iq_bank(3, 1024) if iq else bank(3, 1024)
    run = streaming_itd_iq if iq else streaming_itd
    whole = run(x, hop, device=CPU)
    # a batch of 5 hops of 3 windows: 7 batches, the last one short
    item = 16 if iq else 8
    monkeypatch.setattr(ts, "_CHUNK_BYTES", 5 * 3 * 3 * hop * item)
    parts = run(x, hop, device=CPU)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


def test_replay_calls_do_not_grow_with_hops():
    """One batch of windows: the same ATen calls for 8 hops and 64."""
    hop = 32
    short = torch.from_numpy(bank(2, 8 * hop))
    long = torch.from_numpy(bank(2, 64 * hop))
    assert aten_ops(lambda: streaming_itd(short, hop)) == aten_ops(
        lambda: streaming_itd(long, hop))


def test_jax_state_continues_in_the_port():
    hop = 64
    x = bank(2, 12 * hop)
    jstate = js.streaming_init(hop, (2,))
    jstep = jax.jit(js.streaming_step, static_argnums=2)
    for k in range(4):
        jstate, *_ = jstep(jstate, jnp.asarray(x[:, k * hop:(k + 1) * hop]),
                           hop)
    state = stream_state_from_numpy(
        (np.asarray(jstate.window), np.asarray(jstate.filled)), device=CPU)
    assert state.filled.dtype == torch.int32
    for k in range(4, 12):
        hop_x = x[:, k * hop:(k + 1) * hop]
        jstate, jrot, jbase, jready = jstep(jstate, jnp.asarray(hop_x), hop)
        state, rot, base, ready = streaming_step(state, hop_x, hop)
        close(tnp(rot), np.asarray(jrot), 1.0)
        close(tnp(base), np.asarray(jbase), 1.0)
        np.testing.assert_array_equal(tnp(ready), np.asarray(jready))
    close(tnp(state.window), np.asarray(jstate.window), 1.0)


IQ_CASES = [("1-D", iq_bank(1, 1024)[0], 128), ("bank 2x1024",
                                                iq_bank(2, 1024), 128)]


@pytest.mark.parametrize("name,x,hop", IQ_CASES, ids=[c[0] for c in IQ_CASES])
def test_iq_replay_matches_jax_and_reconstructs(name, x, hop):
    want = [np.asarray(a) for a in j_replay_iq(jnp.asarray(x), hop)]
    r, b, rd = (tnp(a) for a in streaming_itd_iq(x, hop, device=CPU))
    scale = np.abs(x).max()
    close(r, want[0], scale)
    close(b, want[1], scale)
    np.testing.assert_array_equal(rd, want[2])
    assert rd[:2].sum() == 0 and rd[2:].all()
    for k in range(2, r.shape[0]):
        np.testing.assert_allclose(r[k] + b[k] * (1 + 1j),
                                   x[..., (k - 1) * hop:k * hop], atol=1e-10)


def test_iq_mask_and_baseline_match_jax():
    re, im = iq_pair(1024, seed=3)
    np.testing.assert_array_equal(
        tnp(iq_extrema_mask(torch.from_numpy(re), torch.from_numpy(im))),
        np.asarray(js.iq_extrema_mask(jnp.asarray(re), jnp.asarray(im))))
    want, (wpos, wcnt) = js.iq_baseline_extract(jnp.asarray(re),
                                                jnp.asarray(im))
    got, (pos, cnt) = iq_baseline_extract(re, im, device=CPU)
    m = int(wcnt)
    assert int(cnt) == m > 5
    np.testing.assert_array_equal(tnp(pos)[:m], np.asarray(wpos)[:m])
    close(tnp(got), np.asarray(want), np.abs(re).max())


@needs_native
def test_iq_baseline_matches_native():
    re, im = iq_pair(1024)
    want, (epos, ecnt) = runtime.baseline_extract_iq(re, im)
    got, (pos, count) = iq_baseline_extract(re, im, device=CPU)
    m = int(count)
    assert m == int(ecnt[0])
    np.testing.assert_array_equal(tnp(pos)[:m], epos[:m])
    close(tnp(got), want, np.abs(re).max())


@needs_native
def test_iq_extrema_reuse_matches_native_and_jax():
    """The ``compute_extrema=false`` protocol: knot placement from a first
    pass reused on adjusted data (``itd.cpp:41-44``)."""
    re, im = iq_pair(1024, seed=1)
    _, state = iq_baseline_extract(re, im, device=CPU)
    _, state_n = runtime.baseline_extract_iq(re, im)
    _, state_j = js.iq_baseline_extract(jnp.asarray(re), jnp.asarray(im))
    re2, im2 = re * 1.1 + 0.05, im * 0.9 - 0.02
    want, _ = runtime.baseline_extract_iq(re2, im2, extrema_state=state_n)
    want_j, _ = js.iq_baseline_extract(jnp.asarray(re2), jnp.asarray(im2),
                                       extrema=state_j)
    # the port's own state, and JAX's state as numpy
    for st in (state, tuple(np.asarray(a) for a in state_j)):
        got, _ = iq_baseline_extract(re2, im2, extrema=st, device=CPU)
        close(tnp(got), want, np.abs(re2).max())
        close(tnp(got), np.asarray(want_j), np.abs(re2).max())


def test_iq_degenerate_quadrature_pair():
    """A true quadrature pair has no joint extrema: a zero baseline."""
    t = np.linspace(0, 1, 512)
    re, im = np.cos(2 * np.pi * 20 * t), np.sin(2 * np.pi * 20 * t)
    assert int(iq_extrema_mask(torch.from_numpy(re),
                               torch.from_numpy(im)).sum()) == 0
    base, (_, count) = iq_baseline_extract(re, im, device=CPU)
    assert int(count) == 0
    assert torch.equal(base, torch.zeros(512, dtype=torch.float64))
    want, _ = js.iq_baseline_extract(jnp.asarray(re), jnp.asarray(im))
    np.testing.assert_array_equal(tnp(base), np.asarray(want))


@needs_native
def test_native_streaming_matches_the_port():
    x = chirpy(1024, seed=4)
    hop = 128
    rot, base, _ = (tnp(a) for a in streaming_itd(x, hop, device=CPU))
    s = runtime.StreamingITD(hop)
    emitted = 0
    for k in range(8):
        out = s.push(x[k * hop:(k + 1) * hop])
        if out is not None:
            close(out[0], rot[k], np.abs(x).max())
            close(out[1], base[k], np.abs(x).max())
            emitted += 1
    s.close()
    assert emitted == 6


@pytest.mark.parametrize("iq", [False, True], ids=["scalar", "iq"])
def test_sharded_streaming_is_bitwise_the_replay(iq):
    hop = 64
    x = torch.from_numpy(iq_bank(5, 512) if iq else bank(5, 512))
    want = (streaming_itd_iq if iq else streaming_itd)(x, hop)
    fn = sharded_streaming_itd([CPU, CPU], hop, iq=iq)
    got = fn(x)
    assert got[0].shape == want[0].shape and got[2].shape == want[2].shape
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_numpy_goes_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        streaming_itd(chirpy(256), 32)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        streaming_init(32)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        iq_baseline_extract(*iq_pair(256))
