"""The plain version of the K7 kernel (``pyitd_tpu_torch/ops/cuda_cubic.py::
spike_factors``: the partition method on runs, a block PCR over the runs,
the back-substitution) against the PCR of the whole block, the port's
``chained_pcr.shard_spike_factors`` and JAX's (XLA, no Pallas), on the same
blocks.

f64 to 1e-12 of max|x| on ``tools/cubic_bench.py::spike_cases``: random
systems, a block with no knot, a row with one interior knot, knots on the
first and last cell of every run and of blocks, rows that end between
runs; at small blocks (256 cells in runs of 8, and runs of 4 and 16) and
at the kernel's own ``SPIKE_BLK`` / ``SPIKE_RUN``.  In f32, through
``cuda_cubic.chained_block_spike`` on the CPU (no launch), against the f64
grid PCR to 5e-5 of max|u|, the bar of ``tests/test_chained_pcr.py:121``
(``tests/test_torch_chained_pcr.py`` also holds it against JAX's
``chained_block_spike``).

The interface solve and the end moments (``cuda_cubic.
spike_interface_cuda``, whose plain version runs on the CPU) on the cubic
level's own inputs, at 1, 2, 3 and 16 SPIKE blocks, on rows with no
interior knot, one, two, every sample a knot, many, and a row the guard
passes through (``tools/cubic_bench.py::interface_rows``): the wrapper
equals the eager composition it replaced (``spike_interface``, then
``cubic_baseline._end_moments`` on ``_u_at``) and the level equals its
previous form under ``torch.equal``."""
import numpy as np
import pytest
import torch

from pyitd_tpu.ops import chained_pcr as jc
from pyitd_tpu_torch.ops import chained_pcr as tc
from pyitd_tpu_torch.ops import cuda_cubic, cuda_fill
from pyitd_tpu_torch.ops.chained_pcr import notaknot_rows
from pyitd_tpu_torch.ops.cubic_baseline import (_end_moments,
                                                _eval_fills_fused,
                                                _odd_reflect_ends, _u_at,
                                                cubic_baseline_extract)
from pyitd_tpu_torch.tools.cubic_bench import (interface_rows,
                                               recorded_interface,
                                               spike_cases)

TOL = 1e-12
SMALL = list(spike_cases(256, 8, np.float64))
KERNEL = list(spike_cases(cuda_cubic.SPIKE_BLK, cuda_cubic.SPIKE_RUN,
                          np.float64))


def _blocks(x, npad, sb, fill):
    x = np.asarray(x)
    pad = np.full((x.shape[0], npad - x.shape[1]), fill, x.dtype)
    return np.concatenate([x, pad], axis=1).reshape(-1, sb)


def _case_blocks(sys_, sb):
    npad = -(-sys_[0].shape[1] // sb) * sb
    return [_blocks(v, npad, sb, f) for v, f in zip(
        sys_, (False, 0.0, 1.0, 0.0, 0.0))]


@pytest.fixture(scope="module")
def jax_small():
    """JAX's factors of every block of ``SMALL``, in one call (one
    compile), split back per case."""
    per_case = [_case_blocks(sys_, 256) for _, sys_ in SMALL]
    stacked = [np.concatenate(parts) for parts in zip(*per_case)]
    flat = [np.asarray(ch) for pair in jc.shard_spike_factors(*stacked)
            for ch in pair]
    out, start = {}, 0
    for (name, _), parts in zip(SMALL, per_case):
        stop = start + parts[0].shape[0]
        out[name] = [ch[start:stop] for ch in flat]
        start = stop
    return out


def _check(sys_, sb, r, monkeypatch, jax_blocks=None):
    m, a, b, c, d = (torch.from_numpy(np.array(v)) for v in sys_)
    with monkeypatch.context() as mp:  # the plain version follows them
        mp.setattr(cuda_cubic, "SPIKE_BLK", sb)
        mp.setattr(cuda_cubic, "SPIKE_RUN", r)
        got = cuda_cubic.spike_factors(m, a, b, c, d)
    rows, npad = got.shape[1:]
    assert npad % sb == 0 and npad - m.shape[1] < sb
    wants = [[ch.numpy() for pair in tc.shard_spike_factors(
        *(torch.from_numpy(v) for v in _case_blocks(sys_, sb)))
        for ch in pair]]
    if jax_blocks is not None:
        wants.append(jax_blocks)
    for want in wants:
        want = np.stack(want).reshape(6, rows, npad)
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TOL * scale)


@pytest.mark.parametrize("name,sys_", SMALL, ids=[c[0] for c in SMALL])
def test_partition_solve_matches_block_pcr(name, sys_, jax_small,
                                          monkeypatch):
    _check(sys_, 256, 8, monkeypatch, jax_small[name])


@pytest.mark.parametrize("run", [4, 16])
def test_partition_solve_other_runs(run, monkeypatch):
    for _, sys_ in spike_cases(256, run, np.float64):
        _check(sys_, 256, run, monkeypatch)


@pytest.mark.parametrize("name,sys_", KERNEL[:3:2], ids=[c[0] for c in
                                                         KERNEL[:3:2]])
def test_partition_solve_at_kernel_block(name, sys_, monkeypatch):
    _check(sys_, cuda_cubic.SPIKE_BLK, cuda_cubic.SPIKE_RUN, monkeypatch)


F32 = [c for c in spike_cases(cuda_cubic.SPIKE_BLK, cuda_cubic.SPIKE_RUN)
       if c[1][0].any()][:3]


@pytest.mark.parametrize("name,sys_", F32, ids=[c[0] for c in F32])
def test_chained_block_spike_f32_against_f64_pcr(name, sys_):
    mask, *rows = (torch.from_numpy(v) for v in sys_)
    before = dict(cuda_cubic.LAUNCHES)
    u, w = cuda_cubic.chained_block_spike(mask, *rows)
    assert cuda_cubic.LAUNCHES == before  # the plain version on the CPU
    u64, w64 = tc.chained_block_pcr(mask, *(r.double() for r in rows))
    scale = float(u64.abs().max())
    assert float((u.double() - u64).abs().max()) / scale < 5e-5
    assert float((w.double() - w64).abs().max()) / scale < 5e-5


# ---- the interface solve and the end moments ----

# a row length per count of SPIKE blocks: a ragged last block, a full one
IFACE_N = {1: 300, 2: 2 * 2048 - 5, 3: 3 * 2048 - 1, 16: 16 * 2048}


@pytest.fixture(scope="module", params=sorted(IFACE_N),
                ids=[f"nblk{k}" for k in sorted(IFACE_N)])
def level_case(request):
    """``interface_rows`` at ``IFACE_N[nblk]`` and the arguments the cubic
    level handed ``spike_interface_cuda``."""
    nblk = request.param
    n = IFACE_N[nblk]
    assert cuda_cubic.spike_pad(n) == nblk * cuda_cubic.SPIKE_BLK
    x = interface_rows(n)
    calls = []
    with recorded_interface(calls):
        cubic_baseline_extract(x, n + 2, min_extrema=10,
                               eval_backend="fills")
    (factors, mask), = calls
    return nblk, x, factors, mask


def test_interface_wrapper_is_the_eager_composition(level_case):
    nblk, x, factors, mask = level_case
    rows, n = x.shape
    assert sorted(mask.sum(-1).tolist())[:3] == [0, 1, 2]
    assert n - 2 in mask.sum(-1).tolist()
    before = dict(cuda_cubic.LAUNCHES)
    got = cuda_cubic.spike_interface_cuda(factors, mask)
    assert cuda_cubic.LAUNCHES == before  # the plain version on the CPU
    e_prev, f_next, w_first_next = cuda_cubic.spike_interface(factors)
    m0, m_last = _end_moments(
        lambda idx: _u_at(factors, e_prev, f_next, idx), mask, n)
    want = (e_prev, f_next, w_first_next, m0, m_last)
    assert [tuple(t.shape) for t in got] == [(rows, nblk)] * 3 + [(rows,)] * 2
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def _previous_level(x, min_extrema):
    """The cubic level as it was with the interface solve and the end
    moments in eager torch."""
    n = x.shape[-1]
    states = cuda_fill.level_states_cuda(x)
    b_first, b_last = _odd_reflect_ends(x)
    k_site = cuda_cubic.cubic_ksite_cuda(x, states, b_first, b_last)
    nb = cuda_cubic.cubic_neighbors_cuda(x, k_site, states)
    it = torch.arange(n, dtype=torch.int32)
    mask_int = (nb.p1p == it) & (it > 0) & (it < n - 1)
    a, b, c, d = notaknot_rows(
        (it - nb.p2p).to(torch.float32), (nb.n1p - it).to(torch.float32),
        nb.kjm1, k_site, nb.kj1, firstrow=nb.p2p == 0,
        lastrow=nb.n1p == n - 1)
    factors = cuda_cubic.spike_factors_cuda(mask_int, a, b, c, d)
    e_prev, f_next, w_first_next = cuda_cubic.spike_interface(factors)
    m0, m_last = _end_moments(
        lambda idx: _u_at(factors, e_prev, f_next, idx), mask_int, n)
    baseline, rotation = cuda_cubic.spike_backsub_eval_cuda(
        factors, e_prev, f_next, w_first_next, m0, m_last, b_last,
        states.nex < min_extrema, nb, x)
    return baseline, rotation, states.nex


def test_fills_level_is_unchanged(level_case):
    _, x, _, _ = level_case
    got = _eval_fills_fused(x, 10)
    want = _previous_level(x, 10)
    assert bool((got[2] < 10).any()) and bool((got[2] >= 10).any())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_interface_wrapper_refuses_what_it_cannot_take():
    x = interface_rows(300)
    calls = []
    with recorded_interface(calls):
        cubic_baseline_extract(x, 302, eval_backend="fills")
    (factors, mask), = calls
    with pytest.raises(ValueError, match="bool"):
        cuda_cubic.spike_interface_cuda(factors, mask.float())
    with pytest.raises(ValueError, match="float32"):
        cuda_cubic.spike_interface_cuda(factors.double(), mask)
    with pytest.raises(ValueError, match="shape"):
        cuda_cubic.spike_interface_cuda(factors[:, :2].contiguous(), mask)
    with pytest.raises(ValueError, match="rows, n"):
        cuda_cubic.spike_interface_cuda(factors, mask[0])
