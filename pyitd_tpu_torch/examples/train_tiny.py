"""Tiny end-to-end training run, the ML pieces composed: port of
``examples/train_tiny.py``.

The notebook training loop on synthetic tokens:

* ``BatchSampler``: aligned/jittered block sampling;
* ``UnigramModel``: the context-free calibration baseline (SGD 0.5);
* ``fixed_embedding`` + ``RecurrentMLP``: a tiny LM with a learned
  readout (:class:`TinyLM`), trained by ``Wolf`` at lr 1e-2 with a seeded
  ``torch.Generator`` on the device;
* ``MatrixDashboard``: per-token correctness frames + EWMA loss bar.

After the full 500 steps the LM's last loss must be below the unigram's.
Run on the card (or with ``--device cpu``; ``--steps`` shortens the run
and skips that check):

    python -m pyitd_tpu_torch.examples.train_tiny
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ml import _init
from ..ml.optimizers import wolf
from ..ml.visualizer import MatrixDashboard
from ..ml.zoo import BatchSampler, RecurrentMLP, UnigramModel, fixed_embedding
from ..utils.interop import checked_device

__all__ = ["VOCAB", "DIM", "BLOCK", "BATCH", "STEPS", "make_stream", "TinyLM",
           "train", "main"]

VOCAB = 32
DIM = 48
BLOCK = 64
BATCH = 16
STEPS = 500


def make_stream(n: int = 200_000, seed: int = 0, vocab: int = VOCAB):
    """Structured synthetic tokens: a repeating 17-token motif with 15%
    substitutions, learnable next-token structure, so the LM must beat the
    unigram."""
    rng = np.random.default_rng(seed)
    motif = rng.integers(0, vocab, size=17)
    stream = np.tile(motif, n // motif.size + 1)[:n]
    noise = rng.random(n) < 0.15
    stream[noise] = rng.integers(0, vocab, size=noise.sum())
    return stream.astype(np.int64)


class TinyLM(nn.Module):
    """Frozen-embedding residual-MLP LM with a one-step causal mix and a
    learned readout."""

    def __init__(self, vocab: int = VOCAB, dim: int = DIM, *, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        gen = _init.generator_or_default(generator)
        self.register_buffer("emb", fixed_embedding(vocab, dim, device=device)
                             .to(dtype), persistent=False)
        self.Dense_0 = _init.dense(2 * dim, dim, gen, device, dtype,
                                   bias=False)
        self.RecurrentMLP_0 = RecurrentMLP(dim, k=2, device=device,
                                           dtype=dtype, generator=gen)
        self.Dense_1 = _init.dense(dim, vocab, gen, device, dtype)

    def forward(self, idx, targets=None):
        h = self.emb[idx]
        # causal context: mix in the previous token's features
        prev = F.pad(h[:, :-1], (0, 0, 1, 0))
        h = self.Dense_0(torch.cat([h, prev], dim=-1))
        logits = self.Dense_1(self.RecurrentMLP_0(h))
        if targets is None:
            return logits, None
        return logits, F.cross_entropy(logits.flatten(0, -2),
                                       targets.flatten())


def train(steps: int = STEPS, device="cuda", log=print):
    """Train the LM and the unigram side by side on the same batches;
    returns a dict of the last losses, the last dashboard frame and the
    mean host ms per step (the run synchronized at its end)."""
    dev = checked_device(device)
    sampler = BatchSampler(make_stream(), BLOCK, BATCH, seed=1, device=dev)
    model = TinyLM(device=dev, generator=torch.Generator().manual_seed(0))
    opt = wolf(model.parameters(), learning_rate=1e-2,
               generator=torch.Generator(device=dev).manual_seed(0))
    uni = UnigramModel(VOCAB, device=dev)
    uopt = torch.optim.SGD(uni.parameters(), lr=0.5)
    dash = MatrixDashboard(n_cols=BLOCK, n_rows=16, cell=5)
    frame = loss = uloss = None
    t0 = time.perf_counter()
    for i in range(steps):
        xb, yb = sampler.sample()
        opt.zero_grad()
        logits, loss = model(xb, yb)
        loss.backward()
        opt.step()
        uopt.zero_grad()
        uloss = uni(xb, yb)[1]
        uloss.backward()
        uopt.step()
        loss, uloss = loss.item(), uloss.item()
        frame = dash.update(logits[0].argmax(-1).cpu().numpy(),
                            yb[0].cpu().numpy(), loss)
        if i % 50 == 0 or i == steps - 1:
            log(f"step {i:4d}  loss {loss:.3f} ({loss / np.log(2):.2f} bpc)"
                f"  unigram {uloss:.3f} ({uloss / np.log(2):.2f} bpc)")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
    return {"loss": loss, "unigram_loss": uloss, "frame": frame,
            "ms_per_step": ms}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    t0 = time.time()
    out = train(args.steps, args.device)
    if args.steps < STEPS:
        print(f"LM against unigram not checked: {args.steps} of {STEPS} "
              f"steps")
    elif not out["loss"] < out["unigram_loss"]:
        raise AssertionError("LM should beat the unigram baseline")
    frame = out["frame"]
    try:
        from PIL import Image
    except ImportError:
        print(f"dashboard frame rendered in-memory: {frame.shape}")
    else:
        Image.fromarray(frame).save("dashboard.png")
        print(f"dashboard frame written to dashboard.png "
              f"({frame.shape[1]}x{frame.shape[0]})")
    print(f"done in {time.time() - t0:.1f}s")
    return out


if __name__ == "__main__":
    main()
