"""Distributed training quickstart, the parallel ML stack composed: port
of ``examples/train_parallel.py``.

* ``make_tp_mesh``: a ``("data", "model")`` ``DeviceMesh`` over the
  process group (one rank per device; one process makes a one-rank group);
* ``ParsevalGPT`` with the tensor-parallel rules ``PARSEVAL_TP_RULES``;
* ``make_train_step`` with ``compute_dtype=torch.bfloat16``: the forward
  and backward on bf16 casts, f32 master weights and Adam state;
* ``save_state`` / ``restore_state`` at mid-run, then a fresh sharded
  model and optimizer restored and run to the end: bitwise the run
  without the restore;
* ``MatrixDashboard``: a per-token correctness frame of the final batch.

One process on the card (or ``--device cpu``); under ``torchrun`` every
rank joins the group from the environment:

    python -m pyitd_tpu_torch.examples.train_parallel [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.checkpoint.state_dict import (get_optimizer_state_dict,
                                                     set_optimizer_state_dict)
from torch.func import functional_call

from ..ml.checkpoint import restore_state, save_state
from ..ml.parseval import GPTConfig, ParsevalGPT
from ..ml.visualizer import MatrixDashboard
from ..ml.zoo import BatchSampler
from ..parallel.train import (PARSEVAL_TP_RULES, make_tp_mesh,
                              make_train_step, one_rank_group, param_groups,
                              shard_batch, shard_params)
from .train_tiny import make_stream

VOCAB = 32
BLOCK = 32
STEPS = 60
CONFIG = dict(block_size=BLOCK, vocab_size=VOCAB, n_layer=2, n_embd=64,
              wavelet_levels=2, near_window=8, ancilla_dim=8, n_anchor=8)


@contextlib.contextmanager
def process_group(device_type: str):
    """The torchrun group when launched by it, else a one-rank group."""
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
        try:
            yield
        finally:
            dist.destroy_process_group()
    else:
        with one_rank_group(device_type):
            yield


def build(mesh, dev):
    """A sharded ParsevalGPT (weights from seed 0), its Adam(3e-3) and
    its bf16 train step."""
    model = ParsevalGPT(GPTConfig(**CONFIG), device=dev,
                        generator=torch.Generator().manual_seed(0))
    shard_params(model, mesh, PARSEVAL_TP_RULES)
    opt = torch.optim.Adam(param_groups(model), 3e-3)
    step = make_train_step(
        lambda p, b: functional_call(model, p, b)[1], opt, mesh, model,
        compute_dtype=torch.bfloat16)
    return model, opt, step


def train(device="cuda", steps: int = STEPS, log=print) -> dict:
    dev = torch.device(device)
    t0 = time.time()
    mesh = make_tp_mesh(device_type=dev.type)  # model = 2 when it can
    dp = mesh.size(0)
    batch = max(2, -(-8 // dp)) * dp  # about 8, divisible by the data dim
    log(f"ranks: {dist.get_world_size()} x {dev.type}   mesh: data={dp} x "
        f"model={mesh.size(1)}   batch={batch}")
    sampler = BatchSampler(make_stream(100_000, vocab=VOCAB), BLOCK, batch,
                           seed=1, device=dev)
    batches = [sampler.sample() for _ in range(steps)]
    model, opt, step = build(mesh, dev)
    log(f"ParsevalGPT: {sum(p.numel() for p in model.parameters()) / 1e3:.0f}"
        f"k params, TP rules shard attention/MLP over 'model'")
    mid = steps // 2
    losses = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt")
        for i, b in enumerate(batches):
            if i == mid:
                save_state(path, {"model": model.state_dict(),
                                  "opt": get_optimizer_state_dict(model, opt),
                                  "step": i})
            losses.append(step(shard_batch(b, mesh)).item())
            if i % 20 == 0:
                log(f"step {i:3d}  loss {losses[-1]:.3f}")
        # a fresh sharded model and optimizer, resumed from the checkpoint
        model_b, opt_b, step_b = build(mesh, dev)
        back = restore_state(path, {
            "model": model_b.state_dict(),
            "opt": get_optimizer_state_dict(model_b, opt_b), "step": 0})
    model_b.load_state_dict(back["model"])
    set_optimizer_state_dict(model_b, opt_b, back["opt"])
    for b in batches[back["step"]:]:
        last_b = step_b(shard_batch(b, mesh)).item()
    bitwise = last_b == losses[-1] and all(
        torch.equal(p, q) for p, q in zip(model.parameters(),
                                          model_b.parameters()))
    spec = model_b.lm_head.weight.placements
    log(f"checkpoint at step {mid}, restored into a fresh model with "
        f"lm_head placement {spec}: resumed run bitwise the uninterrupted: "
        f"{bitwise}")
    log(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over {steps} steps "
        f"({time.time() - t0:.0f}s); master weights "
        f"{next(model.parameters()).dtype}")
    # dashboard frame of the final batch's per-token predictions
    xb, yb = batches[-1]
    with torch.no_grad():
        logits, _ = model(xb, yb)
    preds = logits.argmax(-1).cpu().numpy()
    rows = min(16, batch)
    dash = MatrixDashboard(n_cols=BLOCK, n_rows=rows, cell=5)
    for r in range(rows):
        frame = dash.update(preds[r], yb[r].cpu().numpy(), loss=losses[-1])
    return {"losses": losses, "bitwise": bitwise, "frame": frame,
            "dtype": next(model.parameters()).dtype}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    with process_group(torch.device(args.device).type):
        out = train(args.device, args.steps)
    if not out["losses"][-1] < out["losses"][0]:
        raise AssertionError("training must reduce the loss")
    if not out["bitwise"] or out["dtype"] != torch.float32:
        raise AssertionError("the resumed run differs, or the master "
                             "weights are not f32")
    try:
        from PIL import Image
    except ImportError:
        print(f"dashboard frame rendered: {out['frame'].shape} (PIL not "
              f"installed)")
    else:
        Image.fromarray(out["frame"]).save("dashboard_parallel.png")
        print("wrote dashboard_parallel.png")
    return out


if __name__ == "__main__":
    main()
