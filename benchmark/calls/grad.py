"""The ``grad`` call: the ``sift`` call (``calls/sift.py``), a loss of its
outputs, and the loss's gradient with respect to the bank through
``torch.autograd.grad``.

The traffic's ``loss`` weighs the squared rows summed (``rot_sq``) and the
summed correction (``correction``).  Compared numbers: the sift's, and

* ``grad_row_median`` and ``grad_row_p90``: per signal, the norm of the
  program's input gradient less the reference's over the norm of the
  reference's; the median and the 90th percentile over the signals.

The largest gap and the norm over the whole bank are not compared: the
sift's f32 gradient is ill-conditioned at a few samples (segments whose end
values nearly agree), where two sound f32 evaluations part by as much as
the control does (``PERF.md``).  Faults: the sift's, which alter or zero
the gradient as well.
"""
from __future__ import annotations

import torch

from benchmark.calls import sift as base
from benchmark.reference import itd as ref

BLOCK_SAMPLES = 1 << 22
FAULTS = base.FAULTS
plant = base.plant


def inputs(config, traffic, seed, device):
    return [b.requires_grad_() for b in base.inputs(config, traffic, seed,
                                                    device)]


def make_call(config, traffic, span):
    w = traffic["loss"]

    def call(x):
        with span("itd_sift"):
            r = base.sift(x, config)
        with span("loss"):
            loss = w["rot_sq"] * (r.rotations ** 2).sum() \
                + w["correction"] * r.correction.sum()
        with span("backward"):
            (g,) = torch.autograd.grad(loss, x)
        return {**base.outputs(r), "grad": g}
    return base.on_kernels(call)


def reference(x, config, traffic, dtype=None) -> dict:
    dtype = dtype or x.dtype
    def block(xb):
        xb = xb.detach().to(dtype).requires_grad_()
        with torch.enable_grad():
            s = ref.sift(xb, config["max_iteration"])
            (g,) = torch.autograd.grad(ref.sift_loss(s, traffic["loss"]), xb)
        return {**base.as_dtype(s, x.dtype), "grad": g.to(x.dtype)}
    return base.in_blocks(x, BLOCK_SAMPLES, block)


def numbers(x, out, want) -> dict:
    g = want["grad"].double()
    row = (out["grad"].double() - g).norm(dim=1) / g.norm(dim=1)
    return {**base.numbers(x, out, want),
            "grad_row_median": float(row.quantile(0.5)),
            "grad_row_p90": float(row.quantile(0.9))}
