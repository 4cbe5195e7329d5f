"""A run with the timed path broken underneath reports ``correct`` false;
a sound run reports it true.  The runs skip the look for a card and run
the kernel route's plain versions on the CPU at a small size."""
import json
import shutil
import time

import pytest
import torch

from benchmark import run, workload

SEED = 2 ** 31 + 977
pytestmark = pytest.mark.usefixtures("plain_kernels")


def faults_of(spec, cell):
    traffic = workload.load("traffic", spec["workloads"][cell]["traffic"])
    return workload.call_module(traffic).FAULTS


def one_run(spec, cell, monkeypatch, small_load, plant=None, trace=False):
    monkeypatch.setattr(workload, "load", small_load)
    return run.run_cell(spec, cell, SEED, 0.2, trace, torch.device("cpu"),
                        time.perf_counter(), plant=plant)


@pytest.mark.parametrize("cell", [0, 1, 2])
@pytest.mark.parametrize("kind", (None, "unchanged", "half_batch",
                                  "altered"))
def test_bench_fault_is_caught(spec, cell, kind, monkeypatch, small_load):
    c = spec["workloads"][cell]
    assert kind is None or kind in faults_of(spec, cell)
    plant = None
    if kind is not None:
        config = small_load("configs", c["config"])
        mod = workload.call_module(small_load("traffic", c["traffic"]))

        def plant(call):
            return mod.plant(call, kind, config)
    result = one_run(spec, c, monkeypatch, small_load, plant)
    assert result["correct"] is (kind is None), result["compared"]
    assert (result["failed"] == 0) is (kind is None)
    assert list(result)[-1] == "compared"
    assert set(result["metrics"]) == {
        m["name"] for m in spec["end_to_end"] if run.in_cell(m, c["name"])}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    json.dumps(result)


def test_bench_new_cell_needs_only_files(spec, tmp_path, monkeypatch):
    """A cell that names a new configuration and a new traffic mix runs
    once their files exist and the cell is listed: no code changes."""
    base = workload.HERE
    for d in ("configs", "traffic"):
        shutil.copytree(base / d, tmp_path / d)
    cfg = json.loads((base / "configs" / "eeg_16k.json").read_text())
    cfg.update(name="eeg_tiny", rows=3, n=2500, max_iteration=4)
    (tmp_path / "configs" / "eeg_tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "sift.json").read_text())
    mix.update(pool=2, checked=2)
    (tmp_path / "traffic" / "sift_pair.json").write_text(json.dumps(mix))
    monkeypatch.setattr(workload, "HERE", tmp_path)
    cell = {"name": "eeg_tiny.sift_pair", "config": "eeg_tiny",
            "traffic": "sift_pair", "chips": 1, "why": "a test"}
    spec = {**spec, "workloads": spec["workloads"] + [cell]}
    result = run.run_cell(spec, cell, SEED, 0.2, False, torch.device("cpu"),
                          time.perf_counter())
    assert result["correct"] and result["attempted"] >= 1


RUNNING_SUM = """
import torch
from benchmark import workload

FAULTS = ("altered",)


def inputs(config, traffic, seed, device):
    return workload.banks(config, traffic, seed, device)


def make_call(config, traffic, span):
    def call(x):
        with span("running_sum"):
            return {"y": torch.cumsum(x, dim=1)}
    return call


def reference(x, config, traffic, dtype=None):
    return {"y": x.double().cumsum(dim=1).to(dtype or x.dtype)}


def numbers(x, out, want):
    return {"gap": float((out["y"] - want["y"]).abs().max())}


def plant(call, kind, config):
    def broken(x):
        out = call(x)
        out["y"][0, 0] += 1.0
        return out
    return broken
"""


@pytest.mark.parametrize("fault", [False, True])
def test_bench_new_call_needs_only_files(spec, tmp_path, monkeypatch, fault):
    """A cell whose traffic names a new kind of call runs once the call's
    module (``calls/<call>.py``) and the mix exist: no file of the harness
    names the kinds."""
    import benchmark.calls

    base = workload.HERE
    for d in ("configs", "traffic"):
        shutil.copytree(base / d, tmp_path / d)
    (tmp_path / "calls").mkdir()
    (tmp_path / "calls" / "running_sum.py").write_text(RUNNING_SUM)
    monkeypatch.setattr(benchmark.calls, "__path__",
                        [*benchmark.calls.__path__, str(tmp_path / "calls")])
    cfg = json.loads((base / "configs" / "eeg_16k.json").read_text())
    cfg.update(name="eeg_tiny", rows=3, n=2500)
    (tmp_path / "configs" / "eeg_tiny.json").write_text(json.dumps(cfg))
    mix = {"call": "running_sum", "pool": 2, "checked": 2,
           "trace_seconds": 1.0, "limits": {"gap": 1e-3}}
    (tmp_path / "traffic" / "running_sum.json").write_text(json.dumps(mix))
    monkeypatch.setattr(workload, "HERE", tmp_path)
    cell = {"name": "eeg_tiny.running_sum", "config": "eeg_tiny",
            "traffic": "running_sum", "chips": 1, "why": "a test"}
    spec = {**spec, "workloads": spec["workloads"] + [cell]}
    mod = workload.call_module(mix)
    plant = (lambda call: mod.plant(call, "altered", cfg)) if fault else None
    result = run.run_cell(spec, cell, SEED, 0.2, False, torch.device("cpu"),
                          time.perf_counter(), plant=plant)
    assert result["correct"] is not fault and result["attempted"] >= 1
    assert set(result["compared"]) == {"gap"}
