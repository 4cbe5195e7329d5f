"""A cell's pieces, found by name: its configuration
(``configs/<name>.json``), its traffic mix (``traffic/<mix>.json``) and the
kind of call the mix names (``calls/<call>.py``), and the one generator of
banks that the calls' inputs come from.

A traffic file gives:

* ``call``: the module of ``benchmark/calls/`` that makes the timed call,
  its inputs and its reference;
* ``pool``: how many distinct inputs the seed makes; call ``i`` takes input
  ``i mod pool``, so calls do not find their input in the cache;
* ``checked``: how many completed calls of the window the check samples;
* ``trace_seconds``: the longest traced window (a trace of every call of a
  long window is too large to read within a run's time);
* ``limits``: the limit of each number the check compares;
* whatever else its call reads (``grad``: the ``loss``).

The window is a closed loop of one caller: the next input goes in only
after the previous call has returned and the device has finished.
"""
from __future__ import annotations

import importlib
import json
from contextlib import nullcontext
from pathlib import Path

import torch

from .signals import make_bank

HERE = Path(__file__).resolve().parent


def load(kind: str, name: str) -> dict:
    """``configs/<name>.json`` or ``traffic/<name>.json``."""
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.name} under {HERE}")
    return json.loads(path.read_text())


def call_module(traffic: dict):
    """The module ``benchmark/calls/<call>.py`` that the traffic names."""
    name = traffic["call"]
    if not name.isidentifier():
        raise ValueError(f"a call is named like a module, not {name!r}")
    return importlib.import_module(f"benchmark.calls.{name}")


def dtype(config: dict) -> torch.dtype:
    dt = getattr(torch, config["dtype"], None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {config['dtype']!r}")
    return dt


def banks(config: dict, traffic: dict, seed: int,
          device: torch.device) -> list[torch.Tensor]:
    """``traffic["pool"]`` banks of the configuration's ``signal``, ``rows``
    by ``n`` in its ``dtype``, made on ``device`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [make_bank(config["signal"], config["rows"], config["n"], gen,
                      device, dtype(config))
            for _ in range(traffic["pool"])]


def spans(on: bool):
    """``span(name)``: a profiler span when tracing, else nothing."""
    if on:
        return torch.profiler.record_function
    return lambda name: nullcontext()
