"""Smoke tests of the port's examples (``pyitd_tpu_torch/examples/``:
quickstart, realtime_stream, train_parallel, multichip) on the CPU at
small sizes: each runs its ``main`` with ``--device cpu`` and its own
checks (reconstruction to 1e-10 in f64, the streaming hops bitwise the
bank replay, the loss falling under bf16 compute with f32 master weights,
the resumed run bitwise the uninterrupted one, both sifts bitwise the
single-device sift, the pipeline equal to the sequential stack).  The
quickstart's numbers are held against the JAX example's functions on the
same signals.
"""
import jax.numpy as jnp
import numpy as np
import torch

from pyitd_tpu.decomp.efd import efd as jefd
from pyitd_tpu.decomp.meitd import xitd as jxitd
from pyitd_tpu_torch.examples import (multichip, quickstart, realtime_stream,
                                      train_parallel)

torch.set_num_threads(1)


def test_quickstart(capsys):
    out = quickstart.main(["--device", "cpu"])
    assert out["itd"] < 1e-5 and out["xitd"] < 1e-10 and out["efd"] < 1e-10
    assert out["fabada"][1] > out["fabada"][0] + 5
    text = capsys.readouterr().out
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, 512)
    s = np.sin(6 * t) + 0.3 * rng.normal(size=t.size)
    assert f"XITD: {np.asarray(jxitd(s)).shape[0]} WPE-sorted" in text
    t = np.arange(1024) / 1024
    s = (np.cos(2 * np.pi * 5 * t) + 0.5 * np.cos(2 * np.pi * 40 * t)
         + 0.25 * np.cos(2 * np.pi * 120 * t))
    assert f"EFD: {int(jefd(jnp.asarray(s), 3).count)} bands" in text


def test_realtime_stream(capsys):
    out = realtime_stream.main(["--device", "cpu", "--hops", "12",
                                "--channels", "3"])
    assert out["err"] < 1e-10 and out["bank_err"] < 1e-10
    assert len(out["latency_ms"]) == 12
    # the native tier: a stream, extrema reuse and a pool batch
    assert len(out["native_latency_ms"]) == 12
    assert max(out["native_err"], out["reuse_err"], out["pool_err"]) < 1e-10
    text = capsys.readouterr().out
    assert "native stream: 10/12 hops emitted" in text
    assert "native pool: 8x2048 batch" in text


def test_train_parallel(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the example writes its dashboard here
    out = train_parallel.main(["--device", "cpu", "--steps", "16"])
    assert out["bitwise"] and out["dtype"] == torch.float32
    assert out["losses"][-1] < out["losses"][0]
    assert out["frame"].dtype == np.uint8 and out["frame"].ndim == 3


def test_multichip():
    out = multichip.main(["--device", "cpu", "--n", "4096"])
    assert out["dp_same"] and out["sp_same"] and out["recon"] < 1e-6
    assert out["pipe_gap"] < 1e-5 and np.isfinite(out["loss"])
