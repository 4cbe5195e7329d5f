"""Pipeline parallelism, a GPipe microbatch pipeline over a ``"pp"`` mesh
dim: port of ``pyitd_tpu/parallel/pipeline.py``.

Each rank of the ``"pp"`` dim holds one stage's parameters.  Microbatches
tick through ``M + pp - 1`` steps: the first stage injects microbatch
``t``, every stage applies its block, the activations hop one stage per
tick (one send and one receive, ``parallel.comm.shift_to_next``), and the
last stage records microbatch ``t - (pp - 1)``.  This is JAX's tick
schedule (``pyitd_tpu/parallel/pipeline.py:84-106``) with its SPMD
selects kept: every rank runs every tick and keeps every hop and every
record in its autograd graph, so that the backward's hops pair up across
ranks whatever the caller's loss.  ``torch.distributed.pipelining`` runs
the backward itself from a loss given to its schedule; JAX's contract is
a differentiable function, ``f(stacked_params, x)``, that the caller's
own loss and autograd reach, so the port keeps the tick schedule.

The output is replicated to every stage (JAX's ``psum``: an all-reduce
over ``"pp"`` whose backward is the identity), and over the ``"data"``
dim each rank runs its own rows' pipeline.  The result on every rank is
the whole ``(n_micro, mb, ...)`` output, the rows of all data ranks
gathered; the gradients are the sequential fold's, summed over the data
ranks, on every rank.  Bubble: ``(pp - 1) / (M + pp - 1)``.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from .comm import copy_to_group, reduce_from_group, shift_to_next

__all__ = ["gpipe_apply", "stack_stage_params"]


def stack_stage_params(stage_params: list, mesh: DeviceMesh | None = None,
                       pp_axis: str = "pp") -> dict:
    """Stack per-stage parameter dicts (name -> tensor) along a new
    leading stage axis.  With ``mesh``, each stack becomes a ``DTensor``
    split ``Shard(0)`` over ``pp_axis`` (each rank holds its own stage's
    weights) and replicated over the other dims."""
    stacked = {name: torch.stack([p[name] for p in stage_params])
               for name in stage_params[0]}
    if mesh is None:
        return stacked
    placements = [Shard(0) if d == pp_axis else Replicate()
                  for d in mesh.mesh_dim_names]
    return {n: distribute_tensor(a, mesh, placements)
            for n, a in stacked.items()}


class _GatherRows(torch.autograd.Function):
    """All ranks' ``x`` along dim 1 (rank order); the backward takes this
    rank's rows (the result is replicated)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.rows = dist.get_rank(group), x.shape[1]
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def gpipe_apply(block_fn: Callable, mesh: DeviceMesh, n_micro: int,
                pp_axis: str = "pp", data_axis: str | None = "data",
                compute_dtype=None) -> Callable:
    """A pipelined apply, ``f(stacked_params, x) -> y``.

    ``block_fn(stage_params, x) -> x`` is one stage: a dict of the stage's
    tensors by name, and an activation of the same shape and dtype in and
    out.  ``stacked_params`` (:func:`stack_stage_params`) has a leading
    stage axis of ``mesh[pp_axis]``'s size: ``DTensor``s split over
    ``pp_axis`` (each rank reads its own stage) or plain tensors (every
    rank holds every stage).  ``x`` is ``(n_micro, mb, ...)`` microbatch
    major, the same on every rank; with ``data_axis`` on the mesh each
    data rank pipelines its ``mb / data`` rows.  ``f(params, x)[m]`` is
    ``block_{pp-1}(... block_0(x[m]))``, gradients included, on every
    rank.

    ``compute_dtype`` (e.g. ``torch.bfloat16``): the stage parameters and
    ``x`` are cast inside the pipelined function, so the caller's
    gradients come back in the parameters' own dtype; the output is in
    ``compute_dtype``."""
    names = mesh.mesh_dim_names
    pp = mesh.size(names.index(pp_axis))
    stage = mesh.get_local_rank(pp_axis)
    pp_group = mesh.get_group(pp_axis)
    data = data_axis if data_axis in names else None
    dsize = mesh.size(names.index(data)) if data else 1
    d_group = mesh.get_group(data) if dsize > 1 else None

    def stage_params(stacked):
        out = {}
        for name, a in stacked.items():
            if isinstance(a, DTensor):
                local = a.to_local()  # (1, ...): this rank's stage
                if d_group is not None:
                    local = copy_to_group(local, d_group)
                out[name] = local[0]
            else:  # every stage on every rank: sum the stages' gradients
                for g in (d_group, pp_group if pp > 1 else None):
                    if g is not None:
                        a = copy_to_group(a, g)
                out[name] = a[stage]
        return out

    def f(stacked, x):
        if x.shape[0] != n_micro:
            raise ValueError(f"x has {x.shape[0]} microbatches, not "
                             f"{n_micro}")
        params = stage_params(stacked)
        if pp > 1:
            x = copy_to_group(x, pp_group)
        if d_group is not None:
            x = copy_to_group(x, d_group)
            rows = x.shape[1] // dsize
            r = mesh.get_local_rank(data)
            x = x[:, r * rows:(r + 1) * rows]
        if compute_dtype is not None:
            params = {n: a.to(compute_dtype) if a.is_floating_point() else a
                      for n, a in params.items()}
            if x.is_floating_point():
                x = x.to(compute_dtype)
        first = torch.tensor(stage == 0, device=x.device)
        last = stage == pp - 1
        slot = torch.arange(n_micro, device=x.device).reshape(
            (n_micro,) + (1,) * (x.dim() - 1))
        state = torch.zeros_like(x[0])
        outs = torch.zeros_like(x)
        for t in range(n_micro + pp - 1):
            xin = torch.where(first, x[min(t, n_micro - 1)], state)
            y = block_fn(params, xin)
            if y.shape != xin.shape or y.dtype != xin.dtype:
                raise TypeError(
                    "gpipe stage must preserve activation shape/dtype: "
                    f"{tuple(xin.shape)}/{xin.dtype} -> "
                    f"{tuple(y.shape)}/{y.dtype}")
            m = t - (pp - 1)
            take = torch.tensor(last and m >= 0, device=x.device)
            outs = torch.where(take & (slot == max(m, 0)), y[None], outs)
            if pp > 1 and t < n_micro + pp - 2:
                state = shift_to_next(y, pp_group)
        # only the last stage holds real outputs: the sum replicates them
        out = torch.where(torch.tensor(last, device=x.device), outs, 0.0)
        if pp > 1:
            out = reduce_from_group(out, pp_group)
        if d_group is not None:
            out = _GatherRows.apply(out, d_group)
        return out

    return f
