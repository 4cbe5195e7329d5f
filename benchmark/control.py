"""Readings that the check's limits are set from, at a cell's own size.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 ...

For each seed it makes the cell's banks as a run does, puts the timed call
on each bank of the pool and reads the compared numbers of

* ``sound``: the program, as the window runs it;
* ``control``: the plain reference computed in the precision below the
  configuration's (bfloat16 for float32), put in the program's place;
* each fault of the cell's call module planted under the program's call;

and prints one JSON line per seed and reading, then, per number, the
largest sound reading and the smallest control reading.  The benchmark's
runs do not run this; ``tests/test_bench_control.py`` does at a small size
and, on the card, at the cell's size.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import check, workload  # noqa: E402

# the precision below each configuration's
LOWER = {torch.float64: torch.float32, torch.float32: torch.bfloat16}


def readings(cell: dict, seed: int, device: torch.device,
             load=workload.load) -> dict:
    """``{reading: worst numbers over the pool}`` for one seed."""
    config = load("configs", cell["config"])
    traffic = load("traffic", cell["traffic"])
    kind = workload.call_module(traffic)
    banks = kind.inputs(config, traffic, seed, device)
    call = kind.make_call(config, traffic, workload.spans(False))
    calls = {"sound": call}
    calls.update({k: kind.plant(call, k, config) for k in kind.FAULTS})
    got = {k: [] for k in ("sound", "control", *kind.FAULTS)}
    lower = LOWER[workload.dtype(config)]
    for x in banks:
        want = kind.reference(x, config, traffic)
        for name, fn in calls.items():
            out = fn(x)
            got[name].append(kind.numbers(x, out, want))
            del out
        low = kind.reference(x, config, traffic, lower)
        got["control"].append(kind.numbers(x, low, want))
        del want, low
    return {k: check.worst(v) for k, v in got.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {c["name"]: c for c in spec["workloads"]}[args.workload]
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    high, low = {}, {}
    for seed in args.seeds:
        r = readings(cell, seed, device)
        for name, nums in r.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": name, **nums}), flush=True)
        for k, v in r["sound"].items():
            high[k] = max(high.get(k, v), v)
        for k, v in r["control"].items():
            low[k] = min(low.get(k, v), v)
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "sound_max": high, "control_min": low}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
