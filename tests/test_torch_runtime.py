"""The port's native real-time tier (``pyitd_tpu_torch/runtime.py`` over its
own copy of ``native/itd_native.cpp``) against the JAX package's
(``pyitd_tpu.runtime``) on the same numpy inputs: both libraries are built
here from the same code with the same flags, so every result is held
bitwise.  The stream is also held against the port's f64 replay on the CPU
(``decomp/streaming.py``) to 1e-12 of max|x|, the bar of
``tests/test_torch_streaming.py::test_native_streaming_matches_the_port``.
"""
import numpy as np
import pytest
import torch

from pyitd_tpu import runtime as jrt
from pyitd_tpu_torch import runtime as trt
from pyitd_tpu_torch.decomp.streaming import streaming_itd

CPU = torch.device("cpu")


def chirpy(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n)
    return np.sin(2 * np.pi * 40 * t * (1 + t)) + 0.1 * rng.normal(size=n)


@pytest.fixture(scope="module", autouse=True)
def native():
    assert trt.native_available(), trt._build_error
    assert jrt.native_available()


def same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_baseline_and_extrema_reuse_bitwise(as_tensor):
    x = chirpy(2048, seed=2)
    y = chirpy(2048, seed=3)
    wrap = torch.from_numpy if as_tensor else (lambda a: a)
    rot, base, state = trt.baseline_extract(wrap(x))
    jrot, jbase, jstate = jrt.baseline_extract(x)
    same(rot, jrot), same(base, jbase)
    same(state[0], jstate[0]), same(state[1], jstate[1])
    assert int(state[1][0]) > 10
    np.testing.assert_allclose(rot + base, x, rtol=0, atol=1e-12)
    # channel 0's extrema reused on channel 1
    rot2, base2, _ = trt.baseline_extract(wrap(y), extrema_state=state)
    jrot2, jbase2, _ = jrt.baseline_extract(y, extrema_state=jstate)
    same(rot2, jrot2), same(base2, jbase2)
    np.testing.assert_allclose(rot2 + base2, y, rtol=0, atol=1e-12)


def test_iq_and_its_reuse_bitwise():
    rng = np.random.default_rng(4)
    re, im = chirpy(1500, seed=5), chirpy(1500, seed=6)
    base, state = trt.baseline_extract_iq(re, im)
    jbase, jstate = jrt.baseline_extract_iq(re, im)
    same(base, jbase), same(state[0], jstate[0]), same(state[1], jstate[1])
    re2, im2 = re + 0.01 * rng.normal(size=1500), im * 0.5
    b2, _ = trt.baseline_extract_iq(torch.from_numpy(re2), im2,
                                    extrema_state=state)
    jb2, _ = jrt.baseline_extract_iq(re2, im2, extrema_state=jstate)
    same(b2, jb2)


def test_stream_three_hop_protocol():
    """Two priming hops, then the inner hop of every push: bitwise JAX's
    native stream, rebuilding its input to 1e-10, and within 1e-12 max|x|
    of the port's f64 replay."""
    hop = 128
    x = chirpy(12 * hop, seed=4)
    rot_r, base_r, ready = streaming_itd(x, hop, device=CPU)
    s, js = trt.StreamingITD(hop), jrt.StreamingITD(hop)
    emitted = 0
    try:
        for k in range(12):
            h = x[k * hop:(k + 1) * hop]
            out = s.push(torch.from_numpy(h) if k % 2 else h)
            jout = js.push(h)
            assert (out is None) == (jout is None) == (k < 2)
            assert bool(ready[k]) == (out is not None)
            if out is None:
                continue
            same(out[0], jout[0]), same(out[1], jout[1])
            np.testing.assert_allclose(out[0] + out[1],
                                       x[(k - 1) * hop:k * hop], rtol=0,
                                       atol=1e-10)
            scale = np.abs(x).max()
            np.testing.assert_allclose(out[0], rot_r[k].numpy(), rtol=0,
                                       atol=1e-12 * scale)
            np.testing.assert_allclose(out[1], base_r[k].numpy(), rtol=0,
                                       atol=1e-12 * scale)
            emitted += 1
    finally:
        s.close()
        js.close()
    assert emitted == 10


def test_pool_back_to_back_batches_bitwise():
    """Many back-to-back batches of varying shape (JAX's park-barrier
    regression): every row bitwise the one-shot extraction and JAX's
    pool's."""
    pool, jpool = trt.NativePool(4), jrt.NativePool(4)
    rng = np.random.default_rng(0)
    try:
        for trial in range(40):
            b = 1 + trial % 7
            n = 256 + 16 * (trial % 5)
            x = rng.normal(size=(b, n))
            rot, base = pool.extract_batch(x)
            jrot, jbase = jpool.extract_batch(x)
            same(rot, jrot), same(base, jbase)
            for i in range(b):
                r1, b1, _ = trt.baseline_extract(x[i])
                same(base[i], b1), same(rot[i], r1)
        assert pool.bench(ntasks=200, task_us=50) > 1000
    finally:
        pool.close()
        jpool.close()


def test_length_and_device_errors():
    x = chirpy(512)
    _, _, state = trt.baseline_extract(x)
    with pytest.raises(ValueError, match="built for n=512, got n=511"):
        trt.baseline_extract(x[:511], extrema_state=state)
    with pytest.raises(ValueError, match="built for n=512, got n=511"):
        trt.baseline_extract_iq(x[:511], x[:511], extrema_state=state)
    with pytest.raises(ValueError, match="re/im length mismatch"):
        trt.baseline_extract_iq(x, x[:500])
    s = trt.StreamingITD(64)
    with pytest.raises(ValueError, match="one hop of 64"):
        s.push(x[:63])
    s.close()
    # a tensor off the host is refused with the card's counterpart named
    off = torch.empty(512, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="streaming_step"):
        trt.baseline_extract(off)
    with pytest.raises(ValueError, match="streaming_step"):
        trt.NativePool(1).extract_batch(off.reshape(2, 256))
