"""The ``sift`` call: one ``itd_sift`` of a bank, as users call it (the
default route, which on the card is the port's CUDA kernels; the first
call on the card checks that it reached them).

The configuration gives the bank (``workload.banks``) and the sift's
``max_iteration``, ``endpoint_mode``, ``store_baselines`` and
``early_exit``.  The check runs the plain reference (``reference/itd.py``)
on the same bank in blocks of rows.  Compared numbers:

* ``recon``: max |sum of the output rows + correction - input| over
  max |input|, in float64: the configurations' guarantee, exact
  reconstruction;
* ``rot_gap``: max |program's rows - reference's rows| over max |input|;
* ``count_diff``: signals whose ``num_components`` or ``stop_reason``
  differ from the reference's (an exact comparison).

Faults: ``unchanged`` (the call hands its state back untouched: the bank
as its own single component, no correction, a zero gradient),
``half_batch`` (only the first half of the bank's rows is computed, the
rest of the outputs are zero), ``altered`` (one sample of one output row,
and of the gradient, is altered where it is produced).  A bank is one
program on one card, so no exchange between chips can be left out.
"""
from __future__ import annotations

import torch

from benchmark import workload
from benchmark.reference import itd as ref
from pyitd_tpu_torch.decomp.itd import itd_sift
from pyitd_tpu_torch.ops.cuda_fill import LAUNCHES

BLOCK_SAMPLES = 1 << 24  # samples per block of rows the reference takes
FAULTS = ("unchanged", "half_batch", "altered")


def inputs(config, traffic, seed, device):
    return workload.banks(config, traffic, seed, device)


def sift(x, config):
    """``itd_sift`` of ``x`` with the configuration's settings."""
    return itd_sift(x, config["max_iteration"],
                    endpoint_mode=config["endpoint_mode"],
                    store_baselines=config["store_baselines"],
                    early_exit=config["early_exit"])


def outputs(r) -> dict:
    return {"rotations": r.rotations.detach(),
            "num_components": r.num_components,
            "stop_reason": r.stop_reason,
            "correction": r.correction.detach()}


def on_kernels(call):
    """``call``, whose first call on the card raises unless it launched the
    port's sift kernels."""
    seen = []

    def checked(x):
        if seen or not x.is_cuda:
            return call(x)
        before = LAUNCHES["sift_level"]
        out = call(x)
        if LAUNCHES["sift_level"] == before:
            raise RuntimeError("itd_sift on the card launched no sift_level "
                               "kernel: the timed path is not the kernels'")
        seen.append(True)
        return out
    return checked


def make_call(config, traffic, span):
    def call(x):
        with span("itd_sift"):
            return outputs(sift(x, config))
    return on_kernels(call)


def in_blocks(x, block_samples, fn) -> dict:
    """``fn`` over blocks of ``x``'s rows, the parts joined (``rotations``
    along its rows' axis, 1)."""
    rows, n = x.shape
    step = max(1, block_samples // n)
    parts = [fn(x[lo:lo + step]) for lo in range(0, rows, step)]
    return {k: torch.cat([p[k] for p in parts],
                         dim=1 if k == "rotations" else 0)
            for k in parts[0]}


def reference(x, config, traffic, dtype=None) -> dict:
    dtype = dtype or x.dtype
    def block(xb):
        with torch.no_grad():
            s = ref.sift(xb.detach().to(dtype), config["max_iteration"])
        return as_dtype(s, x.dtype)
    return in_blocks(x, BLOCK_SAMPLES, block)


def as_dtype(s, dtype) -> dict:
    """A reference ``Sift``'s outputs, the float ones in ``dtype``."""
    return {"rotations": s.rotations.detach().to(dtype),
            "num_components": s.num_components,
            "stop_reason": s.stop_reason,
            "correction": s.correction.detach().to(dtype)}


def numbers(x, out, want) -> dict:
    x64 = x.detach().double()
    scale = float(x64.abs().max())
    rot = out["rotations"].double()
    recon = (rot.sum(0) + out["correction"].double() - x64).abs().max()
    return {
        "recon": float(recon) / scale,
        "rot_gap": float((rot - want["rotations"].double()).abs().max())
        / scale,
        "count_diff": float(
            ((out["num_components"] != want["num_components"])
             | (out["stop_reason"] != want["stop_reason"])).sum()),
    }


def plant(call, kind, config):
    """``call`` with the fault ``kind``."""
    levels = config["max_iteration"] + 2
    if kind == "unchanged":
        def broken(x):
            x0 = x.detach()
            rot = torch.zeros((levels,) + x0.shape, dtype=x0.dtype,
                              device=x0.device)
            rot[0] = x0
            ones = torch.ones(x0.shape[0], dtype=torch.int32,
                              device=x0.device)
            out = {"rotations": rot, "num_components": ones,
                   "stop_reason": ones * 2,
                   "correction": torch.zeros_like(x0)}
            if x.requires_grad:
                out["grad"] = torch.zeros_like(x0)
            return out
        return broken

    if kind == "half_batch":
        def broken(x):
            half = x.shape[0] // 2
            part = x.detach()[:half]
            if x.requires_grad:
                part.requires_grad_()
            out = {}
            for k, v in call(part).items():
                axis = 1 if k == "rotations" else 0
                pad = list(v.shape)
                pad[axis] = x.shape[0] - half
                out[k] = torch.cat([v, torch.zeros(pad, dtype=v.dtype,
                                                   device=v.device)], axis)
            return out
        return broken

    if kind == "altered":
        def broken(x):
            out = call(x)
            rot = out["rotations"]
            rot[1, 0, rot.shape[-1] // 2] += 1e-3 * float(
                x.detach().abs().max())
            if "grad" in out:
                g = out["grad"]
                g[0, g.shape[-1] // 2] += 1e-2 * float(g.abs().max())
            return out
        return broken

    raise ValueError(f"unknown fault {kind!r}")
