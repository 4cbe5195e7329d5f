"""Shared fixtures of the benchmark's tests: small copies of the cells for
the CPU, and the card for the tests marked ``cuda``."""
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"rows": 4, "n": 3000}


@pytest.fixture(scope="session")
def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def small_load():
    """``workload.load`` with every configuration cut to ``SMALL``."""
    from benchmark import workload

    orig = workload.load

    def load(kind, name):
        d = orig(kind, name)
        return {**d, **SMALL} if kind == "configs" else d
    return load


@pytest.fixture
def plain_kernels(monkeypatch):
    """The calls' sift on the kernel route's plain versions: on a CPU
    tensor the default route is the plain loop, and the card's route is
    the kernels'."""
    import functools

    from benchmark.calls import sift

    monkeypatch.setattr(sift, "itd_sift",
                        functools.partial(sift.itd_sift, backend="kernel"))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
