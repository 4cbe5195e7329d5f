"""The MEITD walks' gate statistics (``ops/wpe.py::walk_stats_cuda``): a
row's interior extrema count and normalised order-3 WPE from one launch of
``csrc/walk_stats.cu::walk_stats_kernel``.

On the CPU the wrapper runs its plain version, which must be
``stack(count_extrema, weighted_permutation_entropy(., 3, normalize=True))``
bit for bit, in both modes and at any batch shape; it refuses what the
kernel does not take.  :func:`kernel_model` writes the kernel's stencil
(the rank pattern from two comparisons of each window's middle and last
sample, the bin table) and its order of additions (a thread's samples in
turn, the warp shuffles, warp 0 over the warps) in numpy, and is held to
the plain version: counts equal, entropies within 1e-12.  The span tree
of a traced ensemble is held in ``tests/test_torch_meitd_spans.py``.

On the card (marked ``cuda``): the kernel against the plain version at the
walk's (32, 32,768) and the select's (1,440, 32,768) and on the edge rows;
the same bits on every run and for a row alone as inside a batch; in the
benchmark's ensemble, one launch per ``pyitd.walk_stats`` span, each the
kernel's.
"""
import json
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pyitd_tpu_torch import count_extrema, meitd_ensemble
from pyitd_tpu_torch import weighted_permutation_entropy as wpe
from pyitd_tpu_torch.decomp import meitd as port_meitd
from pyitd_tpu_torch.ops import wpe as wpe_ops
from pyitd_tpu_torch.ops.wpe import walk_stats_cuda

THREADS = 1024  # csrc/walk_stats.cu's THREADS: it fixes the order of sums
BIN = (-1, 1, 4, 0, -1, 5, 2, 3, -1)


def _edge_rows() -> dict:
    rng = np.random.default_rng(25)
    nan_rows = rng.normal(size=(5, 700))
    nan_rows[0, rng.integers(0, 700, 40)] = np.nan
    nan_rows[1, :] = np.nan
    nan_rows[2, [0, 1, 698, 699]] = np.nan
    nan_rows[3, 300:310] = np.nan
    inf_rows = rng.normal(size=(3, 600))
    inf_rows[0, ::37] = np.inf
    inf_rows[1, 5:9] = -np.inf
    inf_rows[2, 100:103] = [np.inf, np.inf, -np.inf]
    ramp = np.arange(1200, dtype=np.float64)
    return {
        "random": rng.normal(size=(4, 1500)),
        "ties_plateaus": rng.integers(0, 3, size=(4, 1100)).astype(float),
        "staircase": np.repeat(rng.normal(size=(3, 100)), 7, axis=1),
        "constant": np.stack([np.zeros(600), np.full(600, 2.5),
                              np.full(600, -0.0)]),
        "monotone": np.stack([ramp, -ramp, ramp ** 2]),
        "nan": nan_rows,
        "inf": inf_rows,
        "huge": rng.normal(size=(2, 513)) * 1e300,
        "n3": rng.integers(0, 2, size=(16, 3)).astype(float),
        "n4": rng.normal(size=(6, 4)),
    }


EDGE = _edge_rows()


def plain_stats(x: torch.Tensor, entropy: bool = True) -> torch.Tensor:
    c = count_extrema(x).to(torch.float64)
    if not entropy:
        return c[None]
    return torch.stack([c, wpe(x, 3, normalize=True)])


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(torch.int64), b.view(torch.int64)))


def _shuffle_sum(v: np.ndarray) -> np.ndarray:
    """Lane 0's sum of a warp's 32 lanes (last axis) by ``__shfl_down_sync``
    at offsets 16 to 1: a lane whose source lies past the warp adds its own
    value."""
    v = v.copy()
    for o in (16, 8, 4, 2, 1):
        src = np.concatenate([v[..., o:], v[..., 32 - o:]], axis=-1)
        v = v + src
    return v[..., 0]


def kernel_model(x: np.ndarray) -> np.ndarray:
    """``walk_stats_kernel<true>`` on the rows of ``x`` (rows, n) in numpy,
    with the kernel's formulas and order of additions: (2, rows)."""
    rows, n = x.shape
    it = -(-n // THREADS)
    pad = np.full((rows, it * THREADS + 2), np.nan)
    pad[:, :n] = x
    c, r = pad[:, :-2], pad[:, 1:-1]
    l = np.concatenate([np.full((rows, 1), np.nan), pad[:, :-3]], axis=1)
    i = np.arange(it * THREADS)
    with np.errstate(invalid="ignore", over="ignore"):
        db, df = c - l, r - c
        db = np.where(np.isnan(db), np.inf, db)
        df = np.where(np.isnan(df), np.inf, df)
        ext = ((db <= 0) & (df > 0)) | ((db >= 0) & (df < 0))
        ext &= (i > 0) & (i + 1 < n)
        ext &= ~(np.isnan(l) | np.isnan(c) | np.isnan(r))
        v0, v1, v2 = c, r, pad[:, 2:]
        r1 = (v0 <= v1).astype(int) + (v2 < v1)
        r2 = (v0 <= v2).astype(int) + (v1 <= v2)
        b = np.asarray(BIN)[3 * r1 + r2]
        b = np.where(i + 2 < n, b, -1)
        mean = (v0 + v1 + v2) * (1.0 / 3.0)
        var = ((v0 - mean) ** 2 + (v1 - mean) ** 2 + (v2 - mean) ** 2) \
            * (1.0 / 3.0)
        # thread t's samples t, t + THREADS, ... in turn
        acc = np.zeros((6, rows, THREADS))
        cnt = ext.sum(1)  # integers: exact in any order
        for k in range(it):
            sl = slice(k * THREADS, (k + 1) * THREADS)
            for bb in range(6):
                acc[bb] += np.where(b[:, sl] == bb, var[:, sl], 0.0)
        warps = THREADS // 32
        part = _shuffle_sum(acc.reshape(6, rows, warps, 32))
        lanes = np.zeros((6, rows, 32))
        lanes[..., :warps] = part
        bins = _shuffle_sum(lanes)
        total = np.zeros(rows)
        for bb in range(6):
            total = total + bins[bb]
        denom = np.where(total == 0, 1.0, total)
        h = np.zeros(rows)
        for bb in range(6):
            p = bins[bb] / denom
            h = h + np.where(p > 0, p * np.log2(np.where(p > 0, p, 1.0)), 0.0)
    return np.stack([cnt.astype(np.float64), -h / math.log2(6)])


@pytest.mark.parametrize("entropy", [True, False], ids=["both", "count"])
@pytest.mark.parametrize("name", list(EDGE))
def test_plain_path_is_the_stacked_statistics(name, entropy):
    x = torch.from_numpy(EDGE[name])
    assert same_bits(walk_stats_cuda(x, entropy=entropy),
                     plain_stats(x, entropy))
    # a row alone is the same row of the batch; 1-D gives (k,)
    one = walk_stats_cuda(x[1], entropy=entropy)
    assert same_bits(one, plain_stats(x, entropy)[:, 1])


@pytest.mark.parametrize("n", [0, 1, 2])
def test_count_only_takes_short_rows(n):
    x = torch.zeros((3, n), dtype=torch.float64)
    got = walk_stats_cuda(x, entropy=False)
    assert same_bits(got, torch.zeros((1, 3), dtype=torch.float64))


def test_leading_axes_broadcast():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 5, 400)))
    got = walk_stats_cuda(x)
    assert got.shape == (2, 3, 5)
    assert same_bits(got, plain_stats(x))


@pytest.mark.parametrize("bad,kw,match", [
    (torch.zeros((2, 50), dtype=torch.float32), {}, "float64"),
    (torch.zeros((2, 50), dtype=torch.float64), {"order": 4}, "order 3"),
    (torch.zeros((2, 50), dtype=torch.float64), {"delay": 2}, "delay 1"),
    (torch.zeros((2, 2), dtype=torch.float64), {}, "at least 3"),
    (torch.zeros((), dtype=torch.float64), {"entropy": False}, "scalar"),
], ids=["f32", "order", "delay", "short", "scalar"])
def test_wrapper_refuses(bad, kw, match):
    with pytest.raises(ValueError, match=match):
        walk_stats_cuda(bad, **kw)


@pytest.mark.parametrize("name", list(EDGE))
def test_kernel_model_against_plain(name):
    """The kernel's stencil and order of additions, in numpy: counts equal,
    entropies within 1e-12 (the bins summed in another order)."""
    x = EDGE[name]
    want = plain_stats(torch.from_numpy(x)).numpy()
    got = kernel_model(x)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _walk_rows(rows: int, n: int = 32768, seed: int = 0) -> np.ndarray:
    """Rows like the walk's: chirps and tones in noise, some smoothed (the
    baselines), one constant."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 6 * np.pi, n)
    x = (np.sin(20 * t * (1 + 0.1 * t))[None] * rng.uniform(0, 2, (rows, 1))
         + np.sin(13 * t)[None] + 0.25 * rng.normal(size=(rows, n)))
    k = np.ones(64) / 64
    for r in range(0, rows, 3):
        x[r] = np.convolve(x[r], k, mode="same")
    x[-1] = 1.0
    return x


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    g, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(g[0], w[0])
    if g.shape[0] > 1:
        np.testing.assert_allclose(g[1], w[1], rtol=0, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [32, 1440])
def test_kernel_against_plain_at_the_walks_shapes(device, rows):
    x = torch.from_numpy(_walk_rows(rows, seed=rows)).to(device)
    for entropy in (True, False):
        _close(walk_stats_cuda(x, entropy=entropy),
               wpe_ops.walk_stats(x, entropy=entropy))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(EDGE))
def test_kernel_against_plain_on_edge_rows(device, name):
    x = torch.from_numpy(EDGE[name]).to(device)
    for entropy in (True, False):
        _close(walk_stats_cuda(x, entropy=entropy),
               wpe_ops.walk_stats(x, entropy=entropy))


@pytest.mark.cuda
def test_kernel_is_deterministic_and_row_local(device):
    x = torch.from_numpy(_walk_rows(64, seed=3)).to(device)
    first = walk_stats_cuda(x)
    for _ in range(5):
        assert same_bits(walk_stats_cuda(x), first)
    for r in (0, 17, 63):
        assert same_bits(walk_stats_cuda(x[r]), first[:, r])
        assert same_bits(walk_stats_cuda(x[r:r + 1]), first[:, r:r + 1])
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(5))
    assert same_bits(walk_stats_cuda(x[perm.to(device)]), first[:, perm])
    big = torch.cat([x, torch.from_numpy(_walk_rows(1376, seed=4))
                     .to(device)])
    assert same_bits(walk_stats_cuda(big)[:, :64], first)


@pytest.mark.cuda
def test_ensemble_launches_one_stats_kernel_a_span(device, tmp_path):
    """The benchmark's ensemble, 32 x 32,768 f64: ``LAUNCHES["walk_stats"]``
    is the number of ``pyitd.walk_stats`` spans, the reads plus the
    select's one, and each span holds one launch, of the kernel."""
    rng = np.random.default_rng(19)
    t = np.linspace(0, 6 * np.pi, 32768)
    x = torch.from_numpy(np.sin(20 * t * (1 + 0.1 * t)) + np.sin(13 * t)
                         + 0.25 * rng.normal(size=t.size)).to(device)

    def ensemble():
        return meitd_ensemble(x, torch.Generator(device=device).manual_seed(7),
                              32, 0.1, 0.6)

    ensemble()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ensemble()
        torch.cuda.synchronize()
        wpe_ops.reset_launches()
        port_meitd.reset_counts()
        with record_function("test.window"):
            ensemble()
            torch.cuda.synchronize()
    launches, reads = wpe_ops.LAUNCHES["walk_stats"], \
        port_meitd.COUNTS["reads"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    raw = json.loads(path.read_text())
    evs = [e for e in (raw["traceEvents"] if isinstance(raw, dict) else raw)
           if e.get("ph") == "X" and "dur" in e]
    (win,) = [e for e in evs if e["name"] == "test.window"
              and e.get("cat") == "user_annotation"]

    def inside(e, span):
        return span["ts"] <= e["ts"] and e["ts"] + e["dur"] <= \
            span["ts"] + span["dur"]

    def corr(e):
        return (e.get("args") or {}).get("correlation")

    spans_ = [e for e in evs if e.get("cat") == "user_annotation"
              and e["name"] == "pyitd.walk_stats" and inside(e, win)]
    launches_ = [e for e in evs if e.get("cat") in ("cuda_runtime",
                                                    "cuda_driver")
                 and "LaunchKernel" in e["name"] and inside(e, win)]
    kernels = {corr(e): e for e in evs if e.get("cat") == "kernel"}
    assert len(spans_) == launches == reads + 1
    for s in spans_:
        own = [la for la in launches_
               if la["tid"] == s["tid"] and inside(la, s)]
        assert len(own) == 1, (s["ts"], len(own))
        if corr(own[0]) in kernels:
            assert "walk_stats_kernel" in kernels[corr(own[0])]["name"]
