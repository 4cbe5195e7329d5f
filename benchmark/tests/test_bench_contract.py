"""``BENCHMARK.json`` keeps to its format (keys, names, units, lengths,
bounds), and every piece a cell names is found by name."""
import json
import re

import pytest

from benchmark import run, workload

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_bench_keys_and_names(spec):
    assert set(spec) == TOP
    names = []
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        names += [w["name"], w["config"], w["traffic"]]
    for m in spec["end_to_end"] + spec["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
    assert all(NAME.match(n) for n in names), names
    for text in [c["why"] for c in spec["configs"] + spec["workloads"]] + \
            [c["source"] for c in spec["configs"]] + \
            [m["layer"] for m in spec["per_layer"]] + spec["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) < 64 * 1024


def test_bench_pieces_found_by_name(spec):
    cells = [w["name"] for w in spec["workloads"]]
    assert len(set(cells)) == len(cells)
    for c in spec["configs"]:
        cfg = json.loads((run.ROOT / c["file"]).read_text())
        assert cfg == workload.load("configs", c["name"])
        assert cfg["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        workload.load("configs", w["config"])
        mod = workload.call_module(workload.load("traffic", w["traffic"]))
        for name in ("inputs", "make_call", "reference", "numbers", "plant"):
            assert callable(getattr(mod, name))
        assert mod.FAULTS
    for m in spec["per_layer"]:
        assert callable(run.load_metric(m["name"]).read)
        for cell in m.get("workloads", []):
            assert cell in cells
    with pytest.raises(FileNotFoundError):
        workload.load("traffic", "no_such_mix")


def test_bench_every_cell_reports_enough(spec):
    for w in spec["workloads"]:
        e2e = [m for m in spec["end_to_end"] if run.in_cell(m, w["name"])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(run.in_cell(m, w["name"]) for m in spec["per_layer"])
    # a per-layer metric's cells each report the metric it moves
    moved = {m["name"]: m for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        for cell in m.get("workloads", [w["name"] for w in spec["workloads"]]):
            assert run.in_cell(moved[m["moves"]], cell), (m["name"], cell)
