"""``linear_fill2`` (K2a) and the ``DistGroup`` gradient on an NVIDIA
GPU.  Needs a card and nvcc, so it is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false.  Run on the card with ``python -m
pytest --noconftest tests/test_torch_cuda_routes.py -q``.

* ``linear_fill2_cuda`` bitwise its plain version (the knot mask, then
  ``fill2``) in both directions: ragged lengths, NaN rows and a NaN
  endpoint, a plateau, a constant row, rows off a 16-byte boundary, 8 x 1M;
* the gradient of ``sharded_itd_sift`` and ``sharded_cubic_baseline`` over
  a one-rank NCCL ``DistGroup`` bitwise ``LocalGroup(1)``'s, under
  ``torch.use_deterministic_algorithms`` (without it ``gather``'s backward
  adds by atomics, and one group differs from itself in the last bits).
"""
import os

import numpy as np
import pytest
import torch

from chip_smoke import bench_signal
from pyitd_tpu_torch.ops import cuda_fill

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def bitwise_equal(a, b) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        same = a.view(torch.int32) == b.view(torch.int32)
        return bool((same | (torch.isnan(a) & torch.isnan(b))).all())
    return bool((a == b).all())


def _fill_cases():
    rng = np.random.default_rng(4)
    for rows, n in [(3, 9001), (2, 4097), (2, 4096), (2, 3), (2, 2),
                    (1, 130)]:
        t = np.linspace(0, 2 * np.pi, n)
        yield f"{rows}x{n}", (np.sin(9 * t)[None] + 0.4 * rng.normal(
            size=(rows, n))).astype(np.float32)
    x = (np.sin(np.linspace(0, 40, 12000))[None]
         + 0.1 * rng.normal(size=(4, 12000))).astype(np.float32)
    x[0, 4095:4098] = np.nan
    x[1, 0] = np.nan
    x[2, 6000:6100] = 0.5
    x[3] = 1.0
    yield "nan-plateau-constant", x


FILL_CASES = list(_fill_cases())


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name,x", FILL_CASES, ids=[c[0] for c in FILL_CASES])
def test_linear_fill2_kernel_is_bitwise_plain(device, name, x, reverse):
    xd = torch.from_numpy(x).to(device)
    # the same rows off a 16-byte boundary: a contiguous view one float in
    flat = torch.empty(xd.numel() + 1, device=device)
    flat[1:] = xd.reshape(-1)
    off = flat[1:].view(xd.shape)
    for xs in (xd, off):
        before = cuda_fill.LAUNCHES["linear_fill2"]
        got = cuda_fill.linear_fill2_cuda(xs, reverse)
        torch.cuda.synchronize()
        assert cuda_fill.LAUNCHES["linear_fill2"] == before + 1
        want = cuda_fill.linear_fill2(xs, reverse)
        for a, b in zip(got, want):
            assert bitwise_equal(a, b), name


def test_linear_fill2_kernel_at_8x1m(device):
    x = torch.from_numpy(bench_signal(8, 1_000_000)).to(device)
    for reverse in (False, True):
        got = cuda_fill.linear_fill2_cuda(x, reverse)
        want = cuda_fill.linear_fill2(x, reverse)
        assert all(bitwise_equal(a, b) for a, b in zip(got, want))


def test_dist_group_gradient_one_rank_nccl(device, tmp_path):
    import torch.distributed as dist
    from pyitd_tpu_torch.parallel import (DistGroup, LocalGroup,
                                          sharded_cubic_baseline,
                                          sharded_itd_sift)

    x = torch.from_numpy(bench_signal(2, 65536)).to(device)

    def grads(group):
        xs = x.clone().requires_grad_()
        rot, _, _, corr = sharded_itd_sift(xs, group, 6)
        ((rot ** 2).sum() + 0.7 * corr.sum()).backward()
        xc = x.clone().requires_grad_()
        rot, base, _ = sharded_cubic_baseline(xc, group, min_extrema=0)
        ((rot ** 2).sum() + torch.sin(base).sum()).backward()
        return xs.grad, xc.grad

    # gather's backward adds by atomics on the card: two runs of one group
    # agree bitwise only under deterministic algorithms
    torch.use_deterministic_algorithms(True)
    try:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp_path, "store"), 1),
            rank=0, world_size=1, device_id=device)
        try:
            got = grads(DistGroup())
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
        want = grads(LocalGroup(1))
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all()) and bitwise_equal(a, b)
