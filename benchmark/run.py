"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port (``pyitd_tpu_torch``).  It
reads the cell from ``BENCHMARK.json``, finds the cell's configuration
(``benchmark/configs/``), traffic mix (``benchmark/traffic/``) and the
kind of call the mix names (``benchmark/calls/``) by name, makes the
cell's inputs on the card from ``--seed``, warms up the cell's one shape,
repeats the call for ``--seconds`` in a closed loop of one caller,
judges a seeded sample of the calls against the plain reference, and
prints one JSON line last on standard output.  ``--trace 0`` reports the
end-to-end metrics; ``--trace 1`` records a ``torch.profiler`` trace of a
window of at most the traffic's ``trace_seconds`` and reports the
per-layer metrics, each read by ``benchmark/metrics/<metric>.py``.

Without a CUDA card, with fewer than the cell asks for, or without the
port beside it, it exits with 2 and prints no result; likewise (3) if JAX
or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import check, workload  # noqa: E402
from benchmark.trace import CALL, WINDOW, Trace  # noqa: E402

T_IMPORTED = time.perf_counter()

FORBIDDEN = ("jax", "jaxlib", "flax", "pyitd_tpu")
WARM_TRACED_CALLS = 2  # calls traced before the window (the tracer's start)


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_metric(name: str):
    """The reader module ``benchmark/metrics/<name>.py``."""
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def in_cell(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (names compared whole: ``pyitd_tpu_torch`` is not ``pyitd_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card_info(device: torch.device, chips: int) -> dict:
    """The card's name, the cards used and the power limit."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
        limit = float(smi.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        limit = None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "power_limit_w": limit}


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile of all ``values``."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def run_cell(spec: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float, plant=None) -> dict:
    """One run of ``cell``; returns the result line as a dict.  ``plant``
    wraps the timed call (the tests' faults)."""
    config = workload.load("configs", cell["config"])
    traffic = workload.load("traffic", cell["traffic"])
    kind = workload.call_module(traffic)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    span = workload.spans(trace)

    banks = kind.inputs(config, traffic, seed, device)
    sync()
    t_banks = time.perf_counter()
    call = kind.make_call(config, traffic, span)
    if plant is not None:
        call = plant(call)
    k = traffic["checked"]
    # the window holds up to k sampled outputs, the last one and the one
    # being made: grow the allocator's cache to that before timing
    held = []
    for i in range(k + 2):
        held.append(call(banks[i % len(banks)]))
        sync()
        if i == 0:
            t_first = time.perf_counter()
    del held
    setup_s = time.perf_counter() - t0
    t_imported = max(t0, T_IMPORTED)
    log(f"setup: {setup_s:.4f} s; imports {t_imported - t0:.4f}, banks "
        f"{t_banks - t_imported:.4f} (with the CUDA context), first call "
        f"{t_first - t_banks:.4f} (with the kernel library), {k + 1} warm "
        f"calls {t0 + setup_s - t_first:.4f}")

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        for i in range(WARM_TRACED_CALLS):
            call(banks[i % len(banks)])
            sync()
        seconds = min(seconds, traffic["trace_seconds"])

    rng = random.Random(seed)
    kept, times, i = [], [], 0
    start = time.perf_counter()
    deadline = start + seconds
    with span(WINDOW):
        while True:
            t = time.perf_counter()
            with span(CALL):
                out = call(banks[i % len(banks)])
                sync()
            now = time.perf_counter()
            times.append(now - t)
            # a uniform sample of the completed calls, drawn from the seed
            if len(kept) < k:
                kept.append((i, out))
            else:
                j = rng.randrange(i + 1)
                if j < k:
                    kept[j] = (i, out)
            i += 1
            if now >= deadline:
                break
    window_s = time.perf_counter() - start
    del out
    calls = len(times)
    dev = card_info(device, cell["chips"]) if cuda else {
        "platform": "cpu", "kind": "cpu", "count": 0, "power_limit_w": None}
    dev["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) \
        if cuda else 0
    samples = banks[0].numel() * calls
    ms = [t * 1e3 for t in times]
    log(f"window: {calls} calls in {window_s:.4f} s, {samples} samples; "
        f"p95 over {calls} calls ({calls - math.ceil(0.95 * calls)} beyond "
        f"it); call ms min {min(ms):.4f} p50 {percentile(ms, 0.5):.4f} p95 "
        f"{percentile(ms, 0.95):.4f} max {max(ms):.4f}; card {dev['kind']}, "
        f"{dev['count']} used, power limit {dev['power_limit_w']} W")

    result = {}
    if trace:
        prof.stop()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            tr = Trace.from_chrome(path)
        del prof
        busy = tr.busy_us()
        log(f"trace: {tr.calls} calls in {tr.window_us / 1e6:.6f} s, "
            f"{len(tr.kernels)} kernel records, {tr.missing} launches "
            f"without a device record (made up), busy {busy / 1e6:.6f} s")
        if busy <= 0:
            raise RuntimeError("the traced window recorded no device time")
        dev["busy_s"] = busy / 1e6
        dev["window_s"] = tr.window_us / 1e6
        peaks = json.loads((ROOT / "benchmark" / "peaks.json").read_text())
        ctx = {"config": config, "traffic": traffic,
               "peaks": peaks["cards"].get(dev["kind"], {}),
               "sample_bytes": torch.finfo(banks[0].dtype).bits // 8}
        metrics = {}
        for m in spec["per_layer"]:
            if not in_cell(m, cell["name"]):
                continue
            value = load_metric(m["name"]).read(tr, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = tr.breakdown()
    else:
        e2e = {"setup_s": setup_s,
               "msamp_s": samples / window_s / 1e6,
               "call_p95_ms": percentile(times, 0.95) * 1e3}
        # ``<quantity>.<cells>`` is the quantity under a bound of its own,
        # in the cells it lists
        metrics = {m["name"]: {"value": e2e[m["name"].split(".")[0]],
                               "unit": m["unit"]}
                   for m in spec["end_to_end"] if in_cell(m, cell["name"])}

    # the check: the reference after the window, on the sampled calls
    t_check = time.perf_counter()
    if cuda:
        torch.cuda.empty_cache()
    readings = []
    for idx, got in kept:
        x = banks[idx % len(banks)]
        want = kind.reference(x, config, traffic)
        readings.append(kind.numbers(x, got, want))
        del want
    correct, compared = check.judge(check.worst(readings), traffic["limits"])
    failed = sum(not check.judge(r, traffic["limits"])[0] for r in readings)
    log(f"check: calls {sorted(i for i, _ in kept)} of {calls} against the "
        f"reference in {time.perf_counter() - t_check:.3f} s")
    for name, value, limit in compared:
        log(f"compared {name}: {value!r} (limit {limit!r})")

    result = {"correct": correct, "attempted": calls, "failed": failed,
              "metrics": metrics, "device": dev, **result,
              "compared": {n: {"value": v, "limit": lim}
                           for n, v, lim in compared}}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = load_spec()
    cells = {c["name"]: c for c in spec["workloads"]}
    if args.workload not in cells:
        log(f"no workload {args.workload!r}; known: {sorted(cells)}")
        return 2
    cell = cells[args.workload]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} found")
        return 2
    try:
        import pyitd_tpu_torch  # noqa: F401
    except ModuleNotFoundError as err:
        log(f"{err}: run from the root of a checkout that holds the port")
        return 2
    device = torch.device("cuda", 0)
    result = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                      device, T0)
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process, which must not be: {bad}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
