"""The plain reference against the sequential oracle and against the
port's plain sift."""
import numpy as np
import pytest
import torch

from benchmark.reference import itd as ref
from benchmark.reference import itd_oracle as oracle


def bank(rows, n, seed):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, n)
    x = np.sin(20 * t * (1 + 0.2 * t)) + 0.3 * rng.normal(size=(rows, n)) \
        + 0.1 * t ** 2
    x[0, 10:14] = 1.0          # a plateau
    x[-1, n // 2:n // 2 + 3] = x[-1, n // 2]
    return x


@pytest.mark.parametrize("rows,n,max_iteration",
                         [(3, 500, 8), (2, 2000, 3), (4, 64, 11), (2, 3, 2)])
def test_bench_reference_matches_oracle(rows, n, max_iteration):
    x = bank(rows, n, n)
    s = ref.sift(torch.tensor(x), max_iteration)
    for r in range(rows):
        rot, why = oracle.itd_sift(x[r], max_iteration)
        k = rot.shape[0]
        assert int(s.num_components[r]) == k
        assert int(s.stop_reason[r]) == (ref.STOP_FLAT if why == "A"
                                         else ref.STOP_BUDGET)
        np.testing.assert_allclose(s.rotations[:k, r].numpy(), rot,
                                   rtol=0, atol=1e-12)
        assert not s.rotations[k:, r].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bench_reference_matches_port(dtype):
    from pyitd_tpu_torch.decomp.itd import itd_sift

    x = torch.tensor(bank(3, 3000, 1), dtype=dtype)
    want = itd_sift(x, 8, store_baselines=False, backend="torch")
    got = ref.sift(x, 8)
    assert torch.equal(got.rotations, want.rotations)
    assert torch.equal(got.correction, want.correction)
    assert torch.equal(got.num_components, want.num_components)
    assert torch.equal(got.stop_reason, want.stop_reason)
    recon = got.rotations.double().sum(0) + got.correction.double()
    assert float((recon - x.double()).abs().max()) <= 1e-12


def test_bench_reference_gradient_matches_port():
    from pyitd_tpu_torch.decomp.itd import itd_sift

    w = {"rot_sq": 1.0, "correction": 0.7}
    x = torch.tensor(bank(2, 2000, 2))  # float64: rounding stays below 1e-9

    def grad(fn):
        xr = x.clone().requires_grad_()
        return torch.autograd.grad(fn(xr), xr)[0]

    def port(xr):
        r = itd_sift(xr, 8, store_baselines=False, backend="torch")
        return (r.rotations ** 2).sum() + 0.7 * r.correction.sum()

    g_ref = grad(lambda xr: ref.sift_loss(ref.sift(xr, 8), w))
    g_port = grad(port)
    assert float((g_ref - g_port).abs().max() / g_port.abs().max()) < 1e-9
