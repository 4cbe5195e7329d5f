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
``chained_block_spike``)."""
import numpy as np
import pytest
import torch

from pyitd_tpu.ops import chained_pcr as jc
from pyitd_tpu_torch.ops import chained_pcr as tc
from pyitd_tpu_torch.ops import cuda_cubic
from pyitd_tpu_torch.tools.cubic_bench import spike_cases

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
