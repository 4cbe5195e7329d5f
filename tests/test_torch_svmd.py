"""The port's SVMD (``pyitd_tpu_torch/decomp/svmd.py``) against the JAX
package's and the numpy oracle ``tests/reference/svmd_ref.py``, on the
same numpy inputs, on the CPU: the mode count exactly, modes to 1e-9 and
center frequencies to 1e-10 (the oracle: JAX's own bars of 1e-6 and 1e-8);
the Savitzky-Golay map without its matrix against the matrix and scipy;
the first pass's real-division ``udiff`` (inf, and the loop goes on); the
device state machine bitwise the per-iteration loop (``_BLOCK = 1``).

The runs are cut by ``max_modes`` where JAX's default would extract up to
30 modes: at n = 512 a mode is about 2,000 eager steps on this CPU.
"""
import numpy as np
import pytest
import torch
from scipy.signal import savgol_filter

from pyitd_tpu.decomp import svmd as jv
from pyitd_tpu_torch import svmd
from pyitd_tpu_torch.decomp import svmd as tv
from pyitd_tpu_torch.utils import device_loop
from reference.svmd_ref import svmd_ref

torch.set_num_threads(1)
CPU = "cpu"


def two_tone(n=512):
    """``tests/test_svmd.py::two_tone``."""
    t = np.arange(n) / n
    lo = np.cos(2 * np.pi * 11 * t)
    hi = 0.6 * np.cos(2 * np.pi * 97 * t)
    return lo, hi, lo + hi


def noisy(n=512):
    return two_tone(n)[2] + 0.1 * np.random.default_rng(1).normal(size=n)


CASES = [("default", two_tone()[2], dict(max_modes=6)),
         ("noisy", noisy(), dict(max_modes=4)),
         ("noisy stopc 1", noisy(), dict(stopc=1, max_modes=8)),
         ("scalar stopc 4", two_tone()[2], dict(coupling="scalar")),
         ("scalar stopc 3", two_tone()[2], dict(coupling="scalar", stopc=3)),
         ("init_omega 1", two_tone()[2], dict(init_omega=1, max_modes=3,
                                              seed=2)),
         ("odd length", np.concatenate([[5.0], two_tone(510)[2]]),
          dict(max_modes=2))]


@pytest.mark.parametrize("name,x,kw", CASES, ids=[c[0] for c in CASES])
def test_svmd_matches_jax(name, x, kw):
    uj, hj, oj = jv.svmd(x, **kw)
    u, h, o = svmd(x, device=CPU, **kw)
    assert u.shape == uj.shape and h.shape == hj.shape
    assert u.shape[1] == x.size - x.size % 2
    np.testing.assert_allclose(u, uj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(h, hj, rtol=0, atol=1e-9 * np.abs(hj).max())
    np.testing.assert_allclose(o, oj, rtol=0, atol=1e-10)
    assert list(o) == sorted(o)


@pytest.mark.parametrize("stopc", [4, 3])
def test_scalar_coupling_matches_the_oracle(stopc):
    sig = two_tone(256)[2]
    u_r, _, om_r = svmd_ref(sig, stopc=stopc)
    u, _, om = svmd(sig, stopc=stopc, coupling="scalar", device=CPU)
    assert u.shape == u_r.shape
    np.testing.assert_allclose(om, om_r, rtol=0, atol=1e-8)
    np.testing.assert_allclose(u, u_r, rtol=0, atol=1e-6)


def test_savgol_without_the_matrix():
    rng = np.random.default_rng(0)
    x = rng.normal(size=200)
    M = tv.savgol_filter_matrix(200, 25, 8)
    np.testing.assert_array_equal(M, jv.savgol_filter_matrix(200, 25, 8))
    np.testing.assert_allclose(tv._savgol_apply(torch.from_numpy(x)).numpy(),
                               M @ x, rtol=0, atol=1e-12)
    np.testing.assert_allclose(M @ x, savgol_filter(x, 25, 8), atol=2e-4)


def _mode_machine(monkeypatch):
    """The step function and initial state of the first mode's loop."""
    seen = {}

    def spy(step, state, **kw):
        seen.setdefault("step", step)
        seen.setdefault("state", state)
        return device_loop.run_until(step, state, **kw)

    monkeypatch.setattr(tv, "run_until", spy)
    svmd(two_tone(256)[2], max_modes=1, device=CPU)
    return seen["step"], seen["state"]


def test_first_pass_udiff_is_inf_and_the_loop_goes_on(monkeypatch):
    """u starts at 0, so the first ratio divides by exactly 0: real
    division gives inf (a complex one would give nan and stop the inner
    loop after one pass)."""
    step, s = _mode_machine(monkeypatch)
    s = step(s)
    assert float(s["udiff"]) == float("inf") and int(s["n"]) == 1
    assert int(s["inner"]) == 1 and not bool(s["done"])
    s = step(s)
    assert np.isfinite(float(s["udiff"])) and int(s["n"]) == 2


def test_blocked_machine_is_bitwise_the_eager_loop(monkeypatch):
    x = two_tone(256)[2]
    device_loop.reset_runs()
    blocked = svmd(x, max_modes=2, device=CPU)
    assert all(r["reads"] * tv._BLOCK == r["steps"]
               for r in device_loop.RUNS)
    monkeypatch.setattr(tv, "_BLOCK", 1)
    eager = svmd(x, max_modes=2, device=CPU)
    for a, b in zip(blocked, eager):
        np.testing.assert_array_equal(a, b)


def test_numpy_goes_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        svmd(two_tone()[2])
