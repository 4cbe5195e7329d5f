"""The ``ensemble`` call: the noise-assisted MEITD ensemble of one recording,
as users call it: ``pyitd_tpu_torch.meitd_ensemble`` on its default route
(on the card the cubic level's kernels; the first call on the card checks
that it reached them), with a ``torch.Generator`` on the recording's device
seeded with the traffic's ``noise_seed`` at every call.

The configuration gives the recording (``workload.banks``, one row, handed
to the call as a 1-D signal), the ``realizations``, the ``noise_scale`` and
``wpemax``.  The check runs the plain reference (``reference/meitd.py``)
on the same recording and the same realizations: its walk in the
configuration's float64, its levels in float32.  Compared numbers:

* ``recon``: the worst, in float64, of max |sum of a realization's stack
  rows - the realization| over the realizations and of max |sum of the
  mean stack's rows - the input|, over max |input|: the configuration's
  guarantee.  Limit 1e-10: the walk subtracts in float64, and sound calls
  read 8.1e-16 to 3.8e-15; a walk in float32 (the control) reads 2.0e-7
  to 1.3e-6, the ``altered`` fault 1e-3.
* ``count_diff``: realizations whose ``num_components`` differs from the
  reference's, an exact comparison (limit 0).  Every realization of the
  sound runs and of the control reached the cap of 21 accepted
  components (1,536 realizations each), so a count has not yet parted
  between two sound float32 walks; ``unchanged`` reads 32, ``half_batch``
  16.
* ``stack_row_median`` and ``stack_row_p90``: over the realizations whose
  counts agree, ``||stack - reference's stack|| / ||reference's stack||``
  per realization, its median and 90th percentile (no such realization
  reads infinity).  Two sound float32 levels part by about 1e-6 of the
  signal, but the walk amplifies that: a deep component comes from a
  baseline with few knots after some 40 levels, and parts by 1e-3 to
  1e-1; two components of near-equal entropy may swap places in the WPE
  sort (each row then reads about 1 although the set agrees); now and
  then the walk's branches part and a realization's later components
  differ whole.  A realization so parted reads 0.15 to 0.35, since its
  trend and tones agree.  Sound medians read 4.3e-5 to 4.1e-4 (limit
  3e-2), the control 1.02 to 1.05; sound 90th percentiles read 0.0065 to
  0.28 (limit 0.6), the control 1.07 to 1.32.
* ``mean_gap``: ``||mean stack - reference's|| / ||reference's||``.  The
  paired noise cancels in the mean, so its norm is small and one parted
  realization moves it by up to about 0.1: sound 0.0013 to 0.121 (limit
  0.3), the control 0.78 to 0.83, ``half_batch`` 0.51 to 0.55.  On a
  recording where it read 0.121, the port read 0.012 from the reference
  on float64 levels and the float32 reference 0.118: the reference's
  walk had parted, not the port's.

Readings: 12 seeds of four recordings at the cell's size on an NVIDIA
H100, the worst of each seed's four, and every sound run of the cell;
``PERF.md`` holds them.  Faults:
``unchanged`` (each realization comes back as its own single component),
``half_batch`` (only the first 16 realizations are decomposed, the rest of
the stacks are zero), ``altered`` (one sample of one stack row is moved by
1e-3 max |input| where it is produced).  The ensemble is one program on
one card, so no exchange between chips can be left out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark import workload
from benchmark.reference import meitd as ref
from pyitd_tpu_torch import meitd_ensemble
from pyitd_tpu_torch.decomp.ensemble import _ensemble_from_bank
from pyitd_tpu_torch.ops.cuda_cubic import LAUNCHES

FAULTS = ("unchanged", "half_batch", "altered")


def inputs(config, traffic, seed, device):
    return [b[0] for b in workload.banks(config, traffic, seed, device)]


def generator(x, traffic) -> torch.Generator:
    gen = torch.Generator(device=x.device)
    gen.manual_seed(traffic["noise_seed"])
    return gen


def outputs(r) -> dict:
    return {"stacks": r.stacks, "mean_stack": r.mean_stack,
            "num_components": r.num_components}


def on_kernels(call):
    """``call``, whose first call on the card raises unless it launched the
    cubic level's last kernel."""
    seen = []

    def checked(x):
        if seen or not x.is_cuda:
            return call(x)
        before = LAUNCHES["spike_backsub_eval"]
        out = call(x)
        if LAUNCHES["spike_backsub_eval"] == before:
            raise RuntimeError("meitd_ensemble on the card launched no "
                               "spike_backsub_eval kernel: the timed path "
                               "is not the cubic kernels'")
        seen.append(True)
        return out
    return checked


def make_call(config, traffic, span):
    def call(x):
        with span("meitd_ensemble"):
            return outputs(meitd_ensemble(
                x, generator=generator(x, traffic),
                n_realizations=config["realizations"],
                noise_scale=config["noise_scale"], wpemax=config["wpemax"]))
    checked = on_kernels(call)
    checked.traffic = traffic  # the faults draw the same realizations
    return checked


def reference(x, config, traffic, dtype=None) -> dict:
    return ref.ensemble(x.detach(), n_realizations=config["realizations"],
                        noise_scale=config["noise_scale"],
                        wpemax=config["wpemax"],
                        noise_seed=traffic["noise_seed"],
                        dtype=dtype or x.dtype)


def _padded(stacks, rows):
    return F.pad(stacks, (0, 0, 0, rows - stacks.shape[-2]))


def numbers(x, out, want) -> dict:
    x64 = x.detach().double()
    scale = float(x64.abs().max())
    got, exp = out["stacks"].double(), want["stacks"].double()
    rows = max(got.shape[-2], exp.shape[-2])
    got, exp = _padded(got, rows), _padded(exp, rows)
    recon = max(
        float((got.sum(1) - want["realizations"].double()).abs().max()),
        float((out["mean_stack"].double().sum(0) - x64).abs().max()))
    counts = out["num_components"].cpu().long()
    same = counts == want["num_components"].cpu().long()
    rel = ((got - exp).flatten(1).norm(dim=1)
           / exp.flatten(1).norm(dim=1)).cpu()[same]
    mean = _padded(want["mean_stack"].double(), rows)
    gap = (_padded(out["mean_stack"].double(), rows) - mean).norm() \
        / mean.norm()
    return {
        "recon": recon / scale,
        "count_diff": float((~same).sum()),
        "stack_row_median": float(rel.quantile(0.5)) if rel.numel()
        else float("inf"),
        "stack_row_p90": float(rel.quantile(0.9)) if rel.numel()
        else float("inf"),
        "mean_gap": float(gap),
    }


def _bank(x, config, traffic):
    """The realizations as the call draws them."""
    v = config["noise_scale"] * torch.randn(
        (config["realizations"] // 2, x.shape[-1]),
        generator=generator(x, traffic), dtype=x.dtype, device=x.device)
    return torch.cat([x[None] + v, x[None] - v])


def _result(stacks, counts) -> dict:
    return {"stacks": stacks, "mean_stack": stacks.mean(0),
            "num_components": counts}


def plant(call, kind, config):
    """``call`` (made by :func:`make_call`) with the fault ``kind``."""
    traffic = call.traffic
    if kind == "unchanged":
        def broken(x):
            bank = _bank(x.detach(), config, traffic)
            return _result(bank[:, None].clone(),
                           torch.ones(bank.shape[0], dtype=torch.int32,
                                      device=bank.device))
        return broken

    if kind == "half_batch":
        def broken(x):
            bank = _bank(x.detach(), config, traffic)
            half = bank.shape[0] // 2
            res = _ensemble_from_bank(bank[:half], config["wpemax"])
            stacks = torch.cat([res.stacks, torch.zeros_like(res.stacks)])
            counts = torch.cat([res.num_components,
                                torch.zeros_like(res.num_components)])
            return _result(stacks, counts)
        return broken

    if kind == "altered":
        def broken(x):
            out = call(x)
            st = out["stacks"]
            st[0, 0, st.shape[-1] // 2] += 1e-3 * float(
                x.detach().abs().max())
            return out
        return broken

    raise ValueError(f"unknown fault {kind!r}")
