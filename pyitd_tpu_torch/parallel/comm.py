"""Shard groups: what ``jax.sharding.Mesh`` + ``shard_map`` + the ``lax``
collectives are to ``pyitd_tpu/parallel/sharded.py``.

The time axis of a (rows, n) bank is cut into ``size`` equal shards.  Every
shard-local tensor carries a leading shard axis, ``(S_local, rows, n_loc)``,
and ``ranks`` numbers the shards this process holds, so one body of code
serves both groups:

* :class:`LocalGroup` — all ``size`` shards in this process on one device
  (``S_local == size``); a collective is an index operation along axis 0,
  differentiable by autograd.  It is to this package what a mesh of virtual
  CPU devices is to the JAX tests, and it is what runs on one card.
* :class:`DistGroup` — one shard per process (``S_local == 1``) over a
  ``torch.distributed`` process group (gloo on the CPU, NCCL on cards).
  Its halo shifts, gathers and sums are ``torch.autograd.Function`` objects whose
  backward is the collective's transpose (the opposite shift, a sum over
  ranks of this rank's slice, an all-reduce), so a loss that each rank
  computes from its own shard differentiates as the sum of the ranks'
  losses, as ``jax.grad`` through ``shard_map`` does.  Every rank runs the
  same backward collectives in the same order.

The ``data`` axis of JAX's mesh needs no collective; here it is the ``rows``
axis.  For the training tiers (``train``, ``pipeline``, the expert-parallel
MoE) the module also holds three differentiable collectives over a
``torch.distributed`` group: :func:`copy_to_group` (identity, the backward
sums over the group), :func:`reduce_from_group` (a sum, the backward the
identity: every rank's loss reads the replicated result) and
:func:`shift_to_next` (the pipeline's hop to the next rank).  Each group counts its calls by kind in ``calls`` (``halo``,
``all_gather``, ``all_reduce_sum``, ``all_reduce_min``), as
``ops/cuda_fill.py`` counts launches.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["LocalGroup", "DistGroup", "copy_to_group", "reduce_from_group",
           "shift_to_next"]

_KINDS = ("halo", "all_gather", "all_reduce_sum", "all_reduce_min")


class _Group:
    size: int
    differentiable = False  # whether autograd passes through the collectives

    def __init__(self) -> None:
        self.calls = dict.fromkeys(_KINDS, 0)

    def reset_calls(self) -> None:
        for k in self.calls:
            self.calls[k] = 0

    def ranks(self, device) -> torch.Tensor:
        """The ranks of the shards this process holds, (S_local,) int64."""
        raise NotImplementedError


class LocalGroup(_Group):
    """All ``size`` time shards in this process, on one device."""

    differentiable = True

    def __init__(self, size: int) -> None:
        super().__init__()
        if size < 1:
            raise ValueError(f"a group needs at least one shard, got {size}")
        self.size = size

    def ranks(self, device) -> torch.Tensor:
        return torch.arange(self.size, device=device)

    def _is_rank(self, rank: int, like: torch.Tensor) -> torch.Tensor:
        """True on the shard of ``rank``, shaped to broadcast over
        ``like``."""
        return (self.ranks(like.device) == rank).reshape(
            (-1,) + (1,) * (like.dim() - 1))

    def to_shards(self, x: torch.Tensor):
        """``x`` (rows, n) as ``((size, rows, n_loc), n)``: the time axis
        edge-padded to a multiple of ``size`` and cut."""
        rows, n = x.shape
        pad = (-n) % self.size
        if pad:
            x = torch.cat([x, x[:, -1:].expand(rows, pad)], dim=-1)
        return x.reshape(rows, self.size, -1).transpose(0, 1).contiguous(), n

    def from_shards(self, y: torch.Tensor, n: int) -> torch.Tensor:
        """The inverse of :meth:`to_shards` on the last three axes of ``y``
        (..., size, rows, n_loc): (..., rows, n), padding cropped."""
        y = y.transpose(-3, -2)
        return y.reshape(y.shape[:-2] + (-1,))[..., :n]

    def shift_right_edge(self, edge: torch.Tensor, fill) -> torch.Tensor:
        """Per shard, ``edge`` (S_local, ...) of the shard before it;
        ``fill`` (a number or a tensor like ``edge``) on rank 0."""
        self.calls["halo"] += 1
        return torch.where(self._is_rank(0, edge), fill,
                           torch.cat([edge[:1], edge[:-1]]))

    def shift_left_edge(self, edge: torch.Tensor, fill) -> torch.Tensor:
        """Per shard, ``edge`` of the shard after it; ``fill`` on the
        last rank."""
        self.calls["halo"] += 1
        return torch.where(self._is_rank(self.size - 1, edge), fill,
                           torch.cat([edge[1:], edge[-1:]]))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (S_local, ...) of every shard, (size, ...), the same on
        every shard."""
        self.calls["all_gather"] += 1
        return t

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` (S_local, ...) over all shards, (1, ...).  The
        shards are added in rank order, with no zero to start from, so a
        sum whose other terms are -0.0 is bitwise its one term."""
        self.calls["all_reduce_sum"] += 1
        acc = t[0]
        for s in range(1, self.size):
            acc = acc + t[s]
        return acc[None]

    def all_reduce_min(self, t: torch.Tensor) -> torch.Tensor:
        self.calls["all_reduce_min"] += 1
        return t.amin(0, keepdim=True)


class DistGroup(_Group):
    """One time shard per process of a ``torch.distributed`` process group
    (default: the world).  Differentiable: ``all_reduce_min`` alone carries
    no gradient (it decides flags and counts)."""

    differentiable = True

    def __init__(self, process_group=None) -> None:
        super().__init__()
        self.pg = process_group
        self.size = dist.get_world_size(process_group)
        self.rank = dist.get_rank(process_group)

    def ranks(self, device) -> torch.Tensor:
        return torch.full((1,), self.rank, device=device)

    def to_shards(self, x: torch.Tensor):
        """``x`` is this rank's (rows, n_loc) slice; all slices have one
        length."""
        return x[None].contiguous(), x.shape[-1] * self.size

    def from_shards(self, y: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's slice of the result."""
        return y.squeeze(-3)

    def _shift(self, edge: torch.Tensor, fill, step: int) -> torch.Tensor:
        """Send ``edge`` to rank + step, receive rank - step's; ``fill``
        where there is no rank - step."""
        if edge.dtype == torch.bool:  # the backends move numbers
            return self._shift(edge.to(torch.uint8), int(bool(fill)),
                               step) != 0
        self.calls["halo"] += 1
        fill = torch.as_tensor(fill, dtype=edge.dtype, device=edge.device)
        return _HaloShift.apply(edge, fill.expand_as(edge), self.pg, step,
                                not 0 <= self.rank - step < self.size)

    def shift_right_edge(self, edge: torch.Tensor, fill) -> torch.Tensor:
        return self._shift(edge, fill, 1)

    def shift_left_edge(self, edge: torch.Tensor, fill) -> torch.Tensor:
        return self._shift(edge, fill, -1)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        self.calls["all_gather"] += 1
        return _AllGather.apply(t, self.pg, self.rank, self.size)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks, replicated; every rank's loss reads it, so
        the backward all-reduces the gradient (the two Megatron operators
        composed)."""
        self.calls["all_reduce_sum"] += 1
        return reduce_from_group(copy_to_group(t, self.pg), self.pg)

    def all_reduce_min(self, t: torch.Tensor) -> torch.Tensor:
        self.calls["all_reduce_min"] += 1
        out = t.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MIN, group=self.pg)
        return out


class _HaloShift(torch.autograd.Function):
    """``edge`` to rank + step, rank - step's received, ``fill`` (shaped
    like ``edge``) on the rank that has no rank - step (``at_edge``).  The
    backward is the transpose: the gradient hops back by -step (zeros
    where there is no rank + step), and the fill's is the gradient on the
    edge rank."""

    @staticmethod
    def forward(ctx, edge, fill, group, step, at_edge):
        ctx.group, ctx.step, ctx.at_edge = group, step, at_edge
        got = _hop(edge.contiguous(), group, step)
        return fill.clone(memory_format=torch.contiguous_format) \
            if at_edge else got

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        g_edge = _hop(g, ctx.group, -ctx.step)
        g_fill = g if ctx.at_edge else torch.zeros_like(g)
        return g_edge, g_fill, None, None, None


class _AllGather(torch.autograd.Function):
    """Every rank's ``t`` (1, ...), stacked (size, ...) on every rank.  The
    backward is a reduce-scatter: the gradient summed over ranks (every
    rank's loss reads the gathered tensor), this rank's slice kept; gloo
    has no reduce-scatter of tensors, so an all-reduce and a slice."""

    @staticmethod
    def forward(ctx, t, group, rank, size):
        ctx.group, ctx.rank = group, rank
        out = torch.empty((size,) + t.shape[1:], dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank:ctx.rank + 1], None, None, None


# ---- differentiable collectives over a torch.distributed group ----------
# (the two Megatron operators, and the pipeline's one-stage hop)

class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over ``group`` forward; identity backward (the result is
    replicated, and every rank's loss reads the same value)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


class _ShiftToNext(torch.autograd.Function):
    """Rank r's tensor to rank r + 1 of ``group``; rank 0 receives zeros.
    The backward hops the gradient the other way."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _hop(y.contiguous(), group, +1)

    @staticmethod
    def backward(ctx, g):
        return _hop(g.contiguous(), ctx.group, -1), None


def _hop(t: torch.Tensor, group, step: int) -> torch.Tensor:
    """``t`` to rank + step of ``group`` (``None``: the world), and rank -
    step's received; zeros where there is no rank - step."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)

    def peer(r):
        return r if group is None else dist.get_global_rank(group, r)

    got = torch.zeros_like(t)
    dst, src = rank + step, rank - step
    ops = []
    if 0 <= dst < size:
        ops.append(dist.P2POp(dist.isend, t, peer(dst), group))
    if 0 <= src < size:
        ops.append(dist.P2POp(dist.irecv, got, peer(src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got


def shift_to_next(y: torch.Tensor, group) -> torch.Tensor:
    """Each rank's ``y`` on the next rank of ``group`` (zeros on rank 0),
    differentiable."""
    return _ShiftToNext.apply(y, group)
