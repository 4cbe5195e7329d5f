"""The sift kernels against their plain PyTorch versions on an NVIDIA GPU:
``chip_smoke.py``'s phase 2 under pytest.  Needs a card and nvcc, so it is
marked ``cuda`` and skips where ``torch.cuda.is_available()`` is false.
Run on the card with ``python -m pytest tests/test_torch_cuda.py -q``.

The comparison is bitwise (NaN equal to NaN): the kernels are built with
``-fmad=false`` and PyTorch's eager kernels contract nothing across ops.
"""
import numpy as np
import pytest
import torch

from pyitd_tpu_torch import itd_sift, linear_baseline_extract
from pyitd_tpu_torch.ops import cuda_fill

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _cases():
    rng = np.random.default_rng(2)
    t = np.linspace(0, 2 * np.pi, 9000)
    x = np.stack([
        np.sin(20 * t) + 0.1 * rng.normal(size=t.size),
        np.sin(7 * t) * (1 + 0.1 * t) + 0.05 * rng.normal(size=t.size),
    ]).astype(np.float32)
    x[1, 4000:4002] = np.nan
    yield "nan-pair", x
    for rows, n in [(3, 8192), (2, 8192 + 128), (2, 130), (2, 2)]:
        tt = np.linspace(0, 2 * np.pi, n)
        yield f"{rows}x{n}", (np.sin(7 * tt)[None] + 0.4 * rng.normal(
            size=(rows, n))).astype(np.float32)
    yield "constant", np.ones((2, 8192), np.float32)


CASES = list(_cases())


def bitwise_equal(a, b) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        same = a.view(torch.int32) == b.view(torch.int32)
        return bool((same | (torch.isnan(a) & torch.isnan(b))).all())
    return bool((a == b).all())


@pytest.mark.parametrize("mode", ["reference", "natural"])
@pytest.mark.parametrize("name,x", CASES, ids=[c[0] for c in CASES])
def test_kernel_sift_is_bitwise_plain(device, name, x, mode):
    xt = torch.from_numpy(x).to(device)
    for max_it in (2, 5):
        cuda_fill.reset_launches()
        a = itd_sift(xt, max_it, endpoint_mode=mode)
        assert cuda_fill.LAUNCHES["sift_level"] == max_it + 3
        b = itd_sift(xt, max_it, endpoint_mode=mode, backend="torch")
        for f in a._fields:
            assert bitwise_equal(getattr(a, f), getattr(b, f)), (max_it, f)
    la = linear_baseline_extract(xt, endpoint_mode=mode)
    lb = linear_baseline_extract(xt, endpoint_mode=mode, backend="torch")
    for f in la._fields:
        assert bitwise_equal(getattr(la, f), getattr(lb, f)), f


def test_kernel_route_refuses_what_it_cannot_take(device):
    with pytest.raises(ValueError, match="f32"):
        itd_sift(torch.zeros(2, 64, dtype=torch.float64, device=device), 2)
    with pytest.raises(NotImplementedError, match="backward"):
        itd_sift(torch.zeros(2, 64, device=device, requires_grad=True), 2)
