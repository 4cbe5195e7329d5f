"""Multi-device quickstart, a signal bank over several devices and the ML
stack over a process group: port of ``examples/multichip.py``.

* data parallel (``parallel.batch.pjit_itd_sift``): the bank's rows split
  over the devices, no collective;
* sequence parallel (``parallel.sharded.sharded_itd_sift`` over a
  ``LocalGroup``): the time axis cut into shards, one halo exchange, one
  gather and one sum of small per-row states per trip;
* model parallel over a ``torch.distributed`` group: one tensor-parallel
  ``make_train_step`` of a small ParsevalGPT, and a GPipe pipeline of
  ``BiMLP`` stages against the sequential stack.

Both sifts are held bitwise against the single-device sift.  One process
on the card (or ``--device cpu``) uses every visible card for the data
split and a one-rank group for the ML part; under ``torchrun`` the ML part
spans the ranks:

    python -m pyitd_tpu_torch.examples.multichip [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.func import functional_call

from .. import itd_sift
from ..ml.moe import BiMLP
from ..ml.parseval import GPTConfig, ParsevalGPT
from ..parallel import LocalGroup, pjit_itd_sift, sharded_itd_sift
from ..parallel.pipeline import gpipe_apply, stack_stage_params
from ..parallel.train import (PARSEVAL_TP_RULES, make_tp_mesh,
                              make_train_step, param_groups, shard_batch,
                              shard_params)
from .train_parallel import process_group


def sift_demo(device, batch: int = 4, n: int = 32768) -> dict:
    dev = torch.device(device)
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [dev])
    print(f"devices: {len(devices)} x {dev.type}")
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, n)
    x = torch.from_numpy(
        np.sin(20 * t[None] * (1 + 0.2 * t[None])) + np.sin(13 * t[None])
        + 0.3 * rng.normal(size=(batch, n))).float().to(dev)
    ref = itd_sift(x, 8, store_baselines=False)
    rot_dp = pjit_itd_sift(devices, 8, store_baselines=False)(x)[0]
    dp_same = bool(torch.equal(rot_dp.to(dev), ref.rotations))
    print(f"data-parallel  == single-device: {dp_same}")
    seq = 2
    rot_sp, _, _, corr = sharded_itd_sift(x, LocalGroup(seq), 8)
    sp_same = bool(torch.equal(rot_sp, ref.rotations)
                   and torch.equal(corr, ref.correction))
    err = float((rot_sp.double().sum(0) + corr.double() - x.double()).abs()
                .max())
    print(f"seq-parallel ({seq} shards) == single-device, correction "
          f"included: {sp_same}; compensated recon err {err:.3e}")
    return {"dp_same": dp_same, "sp_same": sp_same, "recon": err}


def ml_demo(device) -> dict:
    dev = torch.device(device)
    mesh = make_tp_mesh(device_type=dev.type)
    dp, tp = mesh.size(0), mesh.size(1)
    cfg = GPTConfig(block_size=16, vocab_size=32, n_layer=1, n_embd=32,
                    wavelet_levels=2, near_window=4, ancilla_dim=8,
                    n_anchor=8)
    gpt = ParsevalGPT(cfg, device=dev,
                      generator=torch.Generator().manual_seed(0))
    shard_params(gpt, mesh, PARSEVAL_TP_RULES)
    step = make_train_step(lambda p, b: functional_call(gpt, p, b)[1],
                           torch.optim.SGD(param_groups(gpt), 0.05), mesh,
                           gpt)
    rng = np.random.default_rng(1)
    xb = torch.from_numpy(rng.integers(0, 32, size=(2 * dp, 16))).to(dev)
    loss = step(shard_batch((xb, xb), mesh)).item()
    print(f"tp train step (data={dp} x model={tp}): loss {loss:.3f}")

    pp = tp
    pmesh = init_device_mesh(dev.type, (dp, pp),
                             mesh_dim_names=("data", "pp"))
    stages = [BiMLP(16, device=dev,
                    generator=torch.Generator().manual_seed(2 + i))
              for i in range(pp)]
    xs = torch.from_numpy(rng.normal(size=(4, 2 * dp, 16))).float().to(dev)
    params = [{n: p.detach() for n, p in s.named_parameters()}
              for s in stages]
    pipe = gpipe_apply(lambda p, h: functional_call(stages[0], p, (h,)),
                       pmesh, n_micro=4)
    with torch.no_grad():
        y = pipe(stack_stage_params(params, pmesh), xs)
        want = xs
        for s in stages:
            want = s(want)
    gap = float((y - want).abs().max())
    print(f"gpipe pipeline (data={dp} x pp={pp}) == sequential stack: "
          f"{gap < 1e-5} (max diff {gap:.2e})")
    return {"loss": loss, "pipe_gap": gap}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=32768)
    args = ap.parse_args(argv)
    out = sift_demo(args.device, n=args.n)
    with process_group(torch.device(args.device).type):
        out.update(ml_demo(args.device))
    if not (out["dp_same"] and out["sp_same"] and out["pipe_gap"] < 1e-5
            and np.isfinite(out["loss"])):
        raise AssertionError(f"a multi-device check failed: {out}")
    return out


if __name__ == "__main__":
    main()
