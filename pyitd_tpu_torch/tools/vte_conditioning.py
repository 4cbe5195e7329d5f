"""How well conditioned BlockFastGPT's step-0 gradient is in f32: the
gradient of the loss at ``chip_smoke.py`` phase 14's model and batch
(``BlockFastGPT()`` from seed 0, 32 x 256 tokens of the motif stream at
vocabulary 66), in f64, in f32, and in f32 after each of ``--perturb``
draws that move every weight by a relative normal 1e-7; each f32 gradient
as its distance from the f64 one over max|g| of the f64 gradient, with
the loss's relative distance.

    python -m pyitd_tpu_torch.tools.vte_conditioning [--device cpu]
        [--perturb 3] [--batch 32]

Prints one JSON line.  A gradient that moves by much more than the
weights did cannot be held across two f32 implementations (the card and
the CPU) at f32 roundoff.
"""
from __future__ import annotations

import argparse
import copy
import json

import torch

from ..examples.train_tiny import make_stream
from ..ml import BatchSampler, BlockFastGPT


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--perturb", type=int, default=3)
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    torch.set_float32_matmul_precision("highest")
    base = BlockFastGPT(device="cpu",
                        generator=torch.Generator().manual_seed(0))
    sampler = BatchSampler(make_stream(400_000, vocab=66), 256, args.batch,
                           seed=2, device=dev)
    x, y = sampler.sample()

    def grad(model):
        loss = model(x, y)[1]
        loss.backward()
        return loss.item(), [p.grad.detach().double().cpu()
                             for p in model.parameters()]

    l64, g64 = grad(copy.deepcopy(base).to(dev, torch.float64))
    gmax = max(float(g.abs().max()) for g in g64)
    out = {"device": str(dev), "max_abs_grad": gmax, "f32": []}
    for k in range(args.perturb + 1):
        m = copy.deepcopy(base)
        if k:
            gen = torch.Generator().manual_seed(k)
            with torch.no_grad():
                for p in m.parameters():
                    p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen))
        loss, g = grad(m.to(dev))
        out["f32"].append({
            "perturbed": bool(k),
            "grad_gap": max(float((a - b).abs().max())
                            for a, b in zip(g, g64)) / gmax,
            "loss_rel": abs(loss - l64) / abs(l64)})
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
