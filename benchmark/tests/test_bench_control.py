"""The control (the reference computed in bfloat16, in the program's place)
fails the check, and the program passes it: at a small size on the CPU,
and on the card at each cell's own size."""
import pytest
import torch

from benchmark import check, control, workload


def verdicts(cell, seed, device, load):
    traffic = load("traffic", cell["traffic"])
    r = control.readings(cell, seed, device, load=load)
    faults = workload.call_module(traffic).FAULTS
    assert set(r) == {"sound", "control", *faults}
    return {k: check.judge(v, traffic["limits"])[0] for k, v in r.items()}


def expected(verdict):
    return {k: k == "sound" for k in verdict}


@pytest.mark.parametrize("cell", [0, 1, 2])
def test_bench_control_fails_small(spec, cell, small_load, plain_kernels):
    got = verdicts(spec["workloads"][cell], 5, torch.device("cpu"),
                   small_load)
    assert got == expected(got)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [0, 1, 2])
@pytest.mark.parametrize("seed", [101, 2 ** 31 + 5, 9_000_000_001])
def test_bench_control_fails_on_card(spec, cell, seed, card):
    got = verdicts(spec["workloads"][cell], seed, card, workload.load)
    assert got == expected(got)
