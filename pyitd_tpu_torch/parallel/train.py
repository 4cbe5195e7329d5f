"""Model-parallel training for the ML family: port of
``pyitd_tpu/parallel/train.py``, on ``torch.distributed.tensor`` over a
``DeviceMesh``.

Parameters are placed by regex rules over their dotted names
(megatron-style tensor parallelism: column-parallel up-projections,
row-parallel down-projections, the embedding's feature dim, the expert
banks over the ``"model"`` mesh dim); the batch rides the ``"data"`` dim.
The rules are JAX's in torch's names and layouts: a flax ``kernel`` is
``(in, out)`` and a ``Linear.weight`` ``(out, in)``, so JAX's ``P(None,
"model")`` on a kernel is ``Shard(0)`` of the weight (column-parallel) and
``P("model", None)`` is ``Shard(1)`` (row-parallel); an ``Embed``'s
``P(None, "model")`` is ``Shard(1)`` of the ``(vocab, d)`` weight; the
``(E, ...)`` expert banks are ``Shard(0)``.

:func:`shard_params` turns the rules into a ``parallelize_module`` plan:
``ColwiseParallel`` / ``RowwiseParallel`` on the matched ``Linear`` and
``Embedding`` layers, so that every op between them sees local tensors
(GSPMD partitions every op; DTensor raises on an op without a sharding
strategy).  A column-parallel layer's output is gathered (``Replicate``)
and a row-parallel layer takes a replicated input, except between the two
layers of an MLP (``LOCAL_PAIRS``: elementwise work only in between),
which exchange local shards.  In ``ParsevalGPT``'s attention the value
projection is therefore gathered before the ancilla concat and ``att @
v``, which run replicated.  A raw parameter (the
expert banks) becomes a ``DTensor`` that its module's forward reads
locally (``ModCRTMoE``: each rank its own experts, one all-reduce).

Typical use::

    with one_rank_group("cuda"):                   # or a real group
        mesh = make_tp_mesh(model=1)               # (data, model)
        shard_params(model, mesh, PARSEVAL_TP_RULES)
        opt = torch.optim.Adam(param_groups(model), 3e-3)
        step = make_train_step(
            lambda p, b: functional_call(model, p, b)[1], opt, mesh, model,
            compute_dtype=torch.bfloat16)
        loss = step(shard_batch((x, y), mesh))
"""
from __future__ import annotations

import contextlib
import os
import re
import tempfile
from typing import Any, Callable, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.parallel import (ColwiseParallel,
                                               RowwiseParallel,
                                               parallelize_module)

__all__ = [
    "one_rank_group",
    "make_tp_mesh",
    "PARSEVAL_TP_RULES",
    "MOE_EP_RULES",
    "param_specs",
    "shard_params",
    "param_groups",
    "shard_batch",
    "make_train_step",
]

Rules = Sequence[Tuple[str, Placement]]


@contextlib.contextmanager
def one_rank_group(device_type: str = "cuda"):
    """A one-process ``torch.distributed`` group (NCCL on the card, gloo
    on the CPU) over a ``FileStore`` in a temporary directory, destroyed
    on exit: what a mesh of one device needs."""
    backend = "nccl" if device_type == "cuda" else "gloo"
    kw = {"device_id": torch.device("cuda", torch.cuda.current_device())} \
        if backend == "nccl" else {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, **kw)
        try:
            yield
        finally:
            dist.destroy_process_group()


def make_tp_mesh(n_devices: int | None = None, model: int | None = None,
                 device_type: str = "cuda") -> DeviceMesh:
    """A ``("data", "model")`` mesh over the ranks of the default process
    group (one device each), ``"model"`` the inner dim.

    ``model`` is the tensor/expert-parallel degree (2 when the rank count
    allows, as in JAX).  ``n_devices``, when given, must be the world
    size: a mesh spans the whole group."""
    if not dist.is_initialized():
        raise RuntimeError("make_tp_mesh needs a torch.distributed process "
                           "group (one rank per device; one_rank_group() "
                           "for one device)")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices}: the group has {n} ranks")
    if model is None:
        model = 2 if n % 2 == 0 and n > 1 else 1
    if n % model:
        raise ValueError(f"n_devices={n} not divisible by model={model}")
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))


# Megatron-style rules for ml.parseval.ParsevalGPT (T.py's transformer):
# up-projections column-parallel, down-projections row-parallel, the
# embedding's features and the LM head's vocabulary sharded on "model".
# w_q stays replicated: its per-step QR dual frame is a small (d, d)
# factorization.
PARSEVAL_TP_RULES: Rules = (
    (r"(^|\.)wte\.weight$", Shard(1)),
    (r"attn\.w_v\.weight$", Shard(0)),
    (r"attn\.w_o\.weight$", Shard(1)),
    (r"mlp\.Dense_0\.weight$", Shard(0)),
    (r"mlp\.Dense_1\.weight$", Shard(1)),
    (r"(^|\.)lm_head\.weight$", Shard(0)),
)

# Expert-parallel rules for ml.moe.ModCRTMoE(dispatch="capacity"): the
# expert-stacked banks split over "model", E / model experts per rank.
MOE_EP_RULES: Rules = (
    (r"(^|\.)W1$", Shard(0)),
    (r"(^|\.)W2$", Shard(0)),
    (r"(^|\.)b2$", Shard(0)),
)


def param_specs(module: nn.Module, rules: Rules,
                default: Placement = Replicate()) -> dict:
    """Each parameter's placement on the ``"model"`` mesh dim: the first
    rule whose regex ``re.search``es its dotted name
    (``block_0.mlp.Dense_0.weight``), else ``default``."""
    def spec(name):
        for pat, placement in rules:
            if re.search(pat, name):
                return placement
        return default

    return {name: spec(name) for name, _ in module.named_parameters()}


# parents (by their last name) whose column- and row-parallel children
# exchange local shards: elementwise work only between the two
LOCAL_PAIRS = ("mlp",)


def shard_params(module: nn.Module, mesh: DeviceMesh,
                 rules: Rules) -> nn.Module:
    """Place ``module``'s parameters on ``mesh``'s ``"model"`` dim per
    ``rules``, in place, and return it; the rest stay plain tensors,
    replicated.  A column-parallel ``Linear``'s bias is sharded with its
    weight."""
    tp = mesh["model"]
    plan = {}
    for name, placement in param_specs(module, rules).items():
        if isinstance(placement, Replicate):
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        parent = owner_name.rpartition(".")[0].rpartition(".")[2]
        local = parent in LOCAL_PAIRS
        dim = placement.dim
        if isinstance(owner, (nn.Linear, nn.Embedding)) and leaf == "weight":
            col = dim == 0 if isinstance(owner, nn.Linear) else dim == 1
            if col:
                plan[owner_name] = ColwiseParallel(
                    output_layouts=Shard(-1) if local else Replicate())
            else:
                plan[owner_name] = RowwiseParallel(
                    input_layouts=Shard(-1) if local else Replicate())
        else:
            param = owner._parameters[leaf]
            owner.register_parameter(leaf, nn.Parameter(distribute_tensor(
                param.detach(), tp, [placement]), param.requires_grad))
    return parallelize_module(module, tp, plan) if plan else module


def param_groups(module: nn.Module) -> list:
    """``module``'s parameters as optimizer param groups, the ``DTensor``
    ones apart from the plain ones: a foreach optimizer step takes one
    kind per call."""
    params = list(module.parameters())
    groups = [{"params": [p for p in params if isinstance(p, DTensor)]},
              {"params": [p for p in params
                          if not isinstance(p, DTensor)]}]
    return [g for g in groups if g["params"]]


def shard_batch(batch, mesh: DeviceMesh, axis: str = "data"):
    """This rank's rows of every tensor of ``batch`` (a tensor or a tuple
    or list of them): the leading dim cut into ``mesh[axis]``'s size, the
    slice of this rank's coordinate on it."""
    n, r = mesh.size(mesh.mesh_dim_names.index(axis)), \
        mesh.get_local_rank(axis)

    def cut(b):
        if b.shape[0] % n:
            raise ValueError(f"batch of {b.shape[0]} rows over {n} ranks")
        k = b.shape[0] // n
        return b[r * k:(r + 1) * k]

    if isinstance(batch, torch.Tensor):
        return cut(batch)
    return type(batch)(cut(b) for b in batch)


def make_train_step(loss_fn: Callable[[dict, Any], torch.Tensor],
                    optimizer: torch.optim.Optimizer, mesh: DeviceMesh,
                    module: nn.Module, compute_dtype=None) -> Callable:
    """One optimizer step: ``step(batch) -> loss``.

    ``loss_fn(params, batch) -> scalar`` reads ``module`` through
    ``torch.func.functional_call(module, params, ...)`` on ``params``, a
    dict of its parameters by name.  ``optimizer`` is a torch optimizer
    over ``param_groups(module)`` (JAX takes an optax transformation and
    threads its state; here the optimizer holds it).  The parameters keep
    their layout across steps: the optimizer updates them in place.  With
    ``"data"`` ranks, the gradients and the returned loss are averaged over
    them (the batch rides that dim).

    ``compute_dtype`` (e.g. ``torch.bfloat16``): the forward and backward
    run on every floating parameter cast to that dtype inside the
    differentiated function, so the master weights, their gradients and
    the optimizer's state keep the parameters' own dtype."""
    for group in optimizer.param_groups:
        kinds = {isinstance(p, DTensor) for p in group["params"]}
        if len(kinds) > 1:
            raise ValueError("a param group mixes DTensor and plain "
                             "parameters; build the optimizer over "
                             "param_groups(module)")
    names = mesh.mesh_dim_names
    dp = mesh.size(names.index("data")) if "data" in names else 1
    dp_group = mesh.get_group("data") if dp > 1 else None
    params = dict(module.named_parameters())

    def cast(p):
        if compute_dtype is None or not p.is_floating_point():
            return p
        return p.to(compute_dtype)

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn({n: cast(p) for n, p in params.items()}, batch)
        loss.backward()
        loss = loss.detach()
        if dp_group is not None:
            for p in params.values():
                if p.grad is not None:
                    g = p.grad._local_tensor if isinstance(p.grad, DTensor) \
                        else p.grad
                    dist.all_reduce(g, group=dp_group)
                    g.div_(dp)
            loss = loss.clone()
            dist.all_reduce(loss, group=dp_group)
            loss = loss / dp
        optimizer.step()
        return loss

    return step
