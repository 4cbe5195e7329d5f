"""The benchmark's plain MEITD reference (``benchmark/reference/meitd.py``)
against the port and against the 2-D tier's oracle, on the CPU.

* its cubic level against ``tests/reference/sifted2d_ref.py::
  meitd_tier_baseline`` (scipy's ``splrep``) to f64 rounding, and its
  tridiagonal solve against a dense one;
* its extrema count and WPE against the port's ``count_extrema`` and
  ``weighted_permutation_entropy``;
* the port's ``meitd_jit_bank`` and ``meitd_ensemble`` against it on
  seeded signals of 2,048 samples, R = 4 and R = 8: on the gather route the
  port's levels run in float64, and so do the reference's here (rows to
  1e-9); on the fills route rehearsed on the CPU (the kernels' plain
  versions, ``meitd._CUBIC_BACKEND = "fills"``) both run their levels in
  float32 by two different solvers: each realization's rows agree to
  ``F32_REL`` of their norm (these signals read up to 1.6e-4: the deep
  components, extracted from baselines with few knots, inherit the
  differences of every level before them) and the counts, the selected
  realization and the completeness agree;
* the reference imports nothing of the port, the JAX package or JAX.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.interpolate import splev, splrep

from benchmark.reference import meitd as ref
from pyitd_tpu_torch import (count_extrema, meitd_ensemble, meitd_jit_bank,
                             weighted_permutation_entropy)
from pyitd_tpu_torch.decomp import meitd as port_meitd
from reference.sifted2d_ref import meitd_tier_baseline

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N = 2048
F32_REL = 1e-3
LEVEL = {"gather": torch.float64, "fills": torch.float32}


def _signal(seed, n=N):
    """The configuration's signal (bench.py:158-178) at ``n`` samples."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 6 * np.pi, n)
    return torch.from_numpy(np.sin(20 * t * (1 + 0.1 * t)) + np.sin(13 * t)
                            + 0.25 * rng.normal(size=n))


def _rows(seed, n):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 4 * np.pi, n)
    x = np.stack([np.sin(9 * t) + 0.3 * rng.normal(size=n),
                  np.sin(3 * t) + 0.01 * t,
                  np.round(4 * np.sin(5 * t)) / 4])   # plateaus
    return torch.from_numpy(x)


@pytest.mark.parametrize("n", [40, 300, 2048])
@pytest.mark.parametrize("seed", [0, 1])
def test_reference_level_matches_splrep(n, seed):
    x = _rows(seed, n)
    got = ref.cubic_level(x, min_extrema=10).numpy()
    for r in range(x.shape[0]):
        want = meitd_tier_baseline(x[r].numpy())
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(got[r] - want).max() <= 1e-12 * scale


@pytest.mark.parametrize("extrema", [0, 1, 2, 3])
def test_reference_level_few_knots(extrema):
    """Fewer than 4 knots: the line or the parabola through them; from 4
    knots (2 extrema) ``splrep``'s spline through the knot values; the ends
    by odd reflection."""
    n = 61
    t = np.linspace(0, 1, n)
    xs = np.cos(np.pi * (extrema + 1) * t) if extrema else np.exp(t)
    x = torch.from_numpy(xs)[None]
    assert int(ref.count_extrema(x)) == extrema
    got = ref.cubic_level(x)[0].numpy()
    assert got[0] == pytest.approx(1.5 * xs[0] - 0.5 * xs[1], abs=1e-14)
    assert got[-1] == pytest.approx(1.5 * xs[-1] - 0.5 * xs[-2], abs=1e-14)
    e = np.concatenate(([0], np.flatnonzero(ref.extrema(x)[0].numpy()),
                        [n - 1]))
    if extrema >= 2:
        want = splev(np.arange(n), splrep(e, got[e], k=3, s=0))
    else:
        want = np.polyval(np.polyfit(e, got[e], extrema + 1), np.arange(n))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_reference_level_passes_few_extrema_through():
    x = _rows(3, 200)
    x[1] = torch.linspace(0, 1, 200, dtype=torch.float64)
    got = ref.cubic_level(x, min_extrema=10)
    assert torch.equal(got[1], x[1])


@pytest.mark.parametrize("m", [1, 2, 7, 64, 1000])
def test_reference_tridiagonal_against_dense(m):
    gen = torch.Generator().manual_seed(m)
    a, c = (torch.rand(3, m, generator=gen, dtype=torch.float64)
            for _ in range(2))
    b = 2.5 + torch.rand(3, m, generator=gen, dtype=torch.float64)
    r = torch.randn(3, m, generator=gen, dtype=torch.float64)
    dense = torch.diag_embed(b) + torch.diag_embed(a[:, 1:], -1) \
        + torch.diag_embed(c[:, :-1], 1)
    want = torch.linalg.solve(dense, r)
    torch.testing.assert_close(ref.tridiagonal(a, b, c, r), want,
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reference_extrema_and_wpe_match_port(dtype):
    x = torch.cat([_rows(5, 777), _signal(6, 777)[None]]).to(dtype)
    assert torch.equal(ref.count_extrema(x), count_extrema(x).long())
    want = weighted_permutation_entropy(x, 3, normalize=True)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(ref.wpe(x), want, rtol=0, atol=tol)


def _reference(x, r, route, seed=5):
    return ref.ensemble(x, n_realizations=r, noise_scale=0.1, wpemax=0.6,
                        noise_seed=seed, level=LEVEL[route])


@pytest.fixture
def route(request, monkeypatch):
    monkeypatch.setattr(port_meitd, "_CUBIC_BACKEND", request.param)
    return request.param


def _close(got, want, route):
    """Rows of ``got`` against ``want`` (..., rows, n), by each row set's
    norm."""
    if route == "gather":
        torch.testing.assert_close(got, want, rtol=0, atol=1e-9)
        return
    gap = (got - want).flatten(-2).norm(dim=-1) \
        / want.flatten(-2).norm(dim=-1)
    assert float(gap.max()) <= F32_REL, gap


@pytest.mark.parametrize("route", ["gather", "fills"], indirect=True)
@pytest.mark.parametrize("r", [4, 8])
def test_port_ensemble_matches_reference(route, r):
    x = _signal(r)
    got = meitd_ensemble(x, torch.Generator().manual_seed(5), r, 0.1, 0.6,
                         device="cpu")
    want = _reference(x, r, route)
    assert torch.equal(got.num_components, want["num_components"].int())
    rows = want["stacks"].shape[1]
    assert not got.stacks[:, rows:].any()
    _close(got.stacks[:, :rows], want["stacks"], route)
    _close(got.mean_stack[:rows], want["mean_stack"], route)
    assert int(got.selected_index) == want["selected_index"]
    tol = 1e-12 if route == "gather" else 1e-5
    assert abs(float(got.completeness) - float(want["completeness"])) <= tol
    torch.testing.assert_close(want["realizations"].mean(0), x, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("route", ["gather", "fills"], indirect=True)
@pytest.mark.parametrize("r", [4, 8])
def test_port_bank_walk_matches_reference(route, r):
    """``meitd_jit_bank`` row by row against the reference's walk."""
    bank = ref.realizations(_signal(10 + r), r, 0.1, 3)
    res = meitd_jit_bank(bank, 0.6, device="cpu")
    walk = ref._Walk(0.6, LEVEL[route])
    for i in range(r):
        high, low, resid = walk(bank[i])
        assert int(res.high_count[i]) == len(high)
        assert int(res.low_count[i]) == len(low)
        got = torch.cat([res.high[i, :len(high)], res.low[i, :len(low)],
                         res.residual[i][None]])
        _close(got, torch.stack(high + low + [resid]), route)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, benchmark.reference.meitd\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    top = set(out.stdout.split())
    assert "torch" in top
    assert not top & {"pyitd_tpu_torch", "pyitd_tpu", "jax", "jaxlib"}
