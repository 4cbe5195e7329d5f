"""Sequence-parallel ITD: the time axis cut over a group of shards — port
of ``pyitd_tpu/parallel/sharded.py``.

For signals far longer than a bank row the time axis is split: extrema
detection needs a 1-sample halo exchange, the knot fills one small gather
of per-shard boundary states, the stop decision one sum; everything else is
shard-local.  Rows stay independent.

Every shard-local tensor is ``(S_local, rows, n_loc)`` and the collectives
come from a group of ``parallel/comm.py`` (``LocalGroup``: all shards on
this device; ``DistGroup``: one per process), which takes the place of
JAX's mesh.  Results equal the unsharded functions': the kernel route of
:func:`sharded_itd_sift` bit for bit ``itd_sift(backend="kernel")``.
"""
from __future__ import annotations

import os

import torch

from ..ops import cuda_fill as cf
from ..ops.chained_pcr import (_sdiv, notaknot_rows, reduced_interface_solve,
                               shard_spike_factors)
from ..ops.cubic_baseline import _end_knot_positions
from ..ops.extrema import compact_indices, extrema_mask
from ..ops.fill import next_index, prev_index, take_last_axis
from ..ops.linear_baseline import (ENDPOINT_MODES, check_kernel_input, interp,
                                   knot_mask_at, knot_value, two_sum_err)
from ..ops.tridiag import spline_moments

__all__ = ["sharded_itd_sift", "sharded_cubic_baseline"]


# ---------------------------------------------------------------------------
# shard-local helpers of the plain route (any float dtype, differentiable
# over either group)
# ---------------------------------------------------------------------------


def _gpos(x, group) -> torch.Tensor:
    """Global positions of the samples of ``x`` (S, rows, n_loc), int64,
    (S, 1, n_loc)."""
    n_loc = x.shape[-1]
    r = group.ranks(x.device)
    return (r[:, None] * n_loc + torch.arange(n_loc, device=x.device))[:, None]


def _halos(x, group, fill):
    """The sample before each shard's first and after its last; ``fill`` at
    the two global ends."""
    return (group.shift_right_edge(x[..., -1], fill),
            group.shift_left_edge(x[..., 0], fill))


def _shift_right(a, group, fill):
    """``a[i-1]`` with the left neighbor's last element crossing over."""
    edge = group.shift_right_edge(a[..., -1], fill)
    return torch.cat([edge[..., None], a[..., :-1]], dim=-1)


def _shift_left(a, group, fill):
    edge = group.shift_left_edge(a[..., 0], fill)
    return torch.cat([a[..., 1:], edge[..., None]], dim=-1)


def _cross_fill(locs, has_local, has_edge, sel, far, group, defaults):
    """The shared tail of :func:`_ffill` / :func:`_bfill`: ``locs`` are the
    channels filled within each shard (``has_local`` where a mark was
    found), ``has_edge`` (S, rows) says whether the shard holds a mark at
    all, ``sel`` (S, size) which shards may serve each shard, ``far`` picks
    the nearest of those (``amax`` or ``amin``)."""
    size = group.size
    dev = has_edge.device
    all_has = group.all_gather(has_edge.to(torch.uint8)) != 0  # (size, rows)
    srange = torch.arange(size, device=dev)
    none = -1 if far == "amax" else size
    cand = torch.where(all_has[None] & sel[:, :, None],
                       srange[None, :, None], none)
    pick = getattr(cand, far)(1)                               # (S, rows)
    found = (pick >= 0) & (pick < size)
    cols = torch.arange(has_edge.shape[1], device=dev)
    edge = -1 if far == "amax" else 0
    out = []
    for loc, d in zip(locs, defaults):
        allg = group.all_gather(loc[..., edge])                # (size, rows)
        other = allg[pick.clamp(0, size - 1), cols]
        other = torch.where(found, other, torch.full_like(other, d))
        out.append(torch.where(has_local, loc, other[..., None]))
    return tuple(out)


def _ffill(values: tuple, mask, group, defaults: tuple):
    """Cross-shard forward fill of several channels under one mask: each
    channel's value at the most recent marked sample, its default before
    the first mark anywhere."""
    idx = prev_index(mask)
    has_local = idx >= 0
    locs = [take_last_axis(v, idx) for v in values]
    r = group.ranks(mask.device)
    sel = torch.arange(group.size, device=mask.device)[None] < r[:, None]
    return _cross_fill(locs, has_local, has_local[..., -1], sel, "amax",
                       group, defaults)


def _bfill(values: tuple, mask, group, defaults: tuple):
    idx = next_index(mask)
    has_local = idx < mask.shape[-1]
    locs = [take_last_axis(v, idx) for v in values]
    r = group.ranks(mask.device)
    sel = torch.arange(group.size, device=mask.device)[None] > r[:, None]
    return _cross_fill(locs, has_local, has_local[..., 0], sel, "amin",
                       group, defaults)


def _owned(x, group, targets):
    """``x`` (S, rows, n_loc) at the global positions ``targets`` (rows, k)
    or (k,), by ownership: each shard contributes the samples it holds and
    zeros elsewhere, one sum.  Exactly one shard holds each position, so the
    sums are the owned values; a position no shard holds reads 0.  Stays
    right when the time axis is padded past the signal.  (rows, k)."""
    n_loc = x.shape[-1]
    r = group.ranks(x.device)
    t = torch.as_tensor(targets, device=x.device)
    loc = t.expand(x.shape[1], -1)[None] - (r * n_loc)[:, None, None]
    mine = (loc >= 0) & (loc < n_loc)
    v = torch.gather(x, -1, loc.clamp(0, n_loc - 1))
    return group.all_reduce_sum(torch.where(mine, v, torch.zeros_like(v)))[0]


def _end_samples_at(x, n_global, group):
    """The signal's samples 0, 1, n_global-2 and n_global-1 as two (rows, 2)
    pairs."""
    v = _owned(x, group, [0, 1, n_global - 2, n_global - 1])
    return v[..., :2], v[..., 2:]


def _extrema(x, group, n_global):
    """``(interior extrema mask, knot mask, global extrema count, gpos)`` of
    the sharded signal, by a 1-sample halo exchange (``+inf`` at the global
    ends, which are knots whatever their neighbours)."""
    gpos = _gpos(x, group)
    halo_l, halo_r = _halos(x, group, float("inf"))
    knots = knot_mask_at(x, halo_l, halo_r, gpos, n_global)
    mask = knots & (gpos > 0) & (gpos < n_global - 1)
    nex = group.all_reduce_sum(mask.sum(-1).to(torch.int32))[0]
    return mask, knots, nex, gpos


def _level(x, group, n_global, endpoint_mode):
    """One sharded linear-baseline level; (rotation, baseline, nex)."""
    _, knots, nex, gpos = _extrema(x, group, n_global)
    first, last = gpos == 0, gpos == n_global - 1
    zero = torch.zeros((), dtype=x.dtype, device=x.device)

    # exclusive neighbors of each knot: fills over shifted (pos, x);
    # positions are integers beside the values, exact at any n
    km1 = _shift_right(knots, group, False)
    pos_m1 = torch.where(first, 0, gpos - 1).expand(x.shape)
    prev_pos, prev_x = _ffill((pos_m1, _shift_right(x, group, zero)), km1,
                              group, (0, 0.0))
    kp1 = _shift_left(knots, group, False)
    pos_p1 = torch.where(last, 0, gpos + 1).expand(x.shape)
    next_pos, next_x = _bfill((pos_p1, _shift_left(x, group, zero)), kp1,
                              group, (0, 0.0))
    knot_val = knot_value(gpos, x, prev_pos, prev_x, next_pos, next_x)

    first2, last2 = _end_samples_at(x, n_global, group)
    b_first = 0.5 * (first2[..., 0] + first2[..., 1])
    b_last = 0.5 * (last2[..., 0] + last2[..., 1])
    knot_val = torch.where(first, b_first[..., None], knot_val)
    knot_val = torch.where(last, b_last[..., None], knot_val)

    b_l, x_l = _ffill((knot_val, x), knots, group, (0.0, 0.0))
    b_r, x_r = _bfill((knot_val, x), knots, group, (0.0, 0.0))
    # the right knot must be strictly after: shift the backward fill left
    b_r = _shift_left(b_r, group, zero)
    x_r = _shift_left(x_r, group, zero)
    baseline = interp(x, gpos, n_global, b_l, x_l, b_r, x_r, endpoint_mode)
    return x - baseline, baseline, nex


def _sift_local(x, group, n_global, max_iteration, endpoint_mode):
    """The plain sharded sift (JAX's ``_sift_local``): the loop of
    ``decomp/itd.py::_itd_sift_torch`` on sharded levels."""
    levels = max_iteration + 2
    rotation, baseline, _ = _level(x, group, n_global, endpoint_mode)
    pending_err = two_sum_err(x, -baseline, rotation)

    rows = x.shape[1]
    izero = torch.zeros(rows, dtype=torch.int32, device=x.device)
    done, reason, ncomp = izero != 0, izero, izero
    prev_base = comp = x * 0
    out = []
    for i in range(levels):
        new_rot, new_base, nex = _level(baseline, group, n_global,
                                        endpoint_mode)
        stop_a = ~done & (nex < 2)
        stop_b = (~done & ~stop_a) if i >= max_iteration + 1 \
            else torch.zeros_like(done)
        cont = ~done & ~stop_a & ~stop_b
        stopping = stop_a | stop_b
        row, comp = cf.emit_row(
            rotation, baseline, prev_base, pending_err, comp,
            stop_a[None, :, None], stop_b[None, :, None], cont[None, :, None])
        out.append(row)
        rotation = new_rot
        pending_err = two_sum_err(baseline, -new_base, new_rot)
        prev_base, baseline = baseline, new_base
        ncomp = torch.where(stopping, i + 1, ncomp)
        reason = torch.where(stop_a, 1, torch.where(stop_b, 2, reason))
        done = done | stopping
    return torch.stack(out), ncomp, reason, comp


# ---------------------------------------------------------------------------
# the kernel route: each trip runs the three sift kernels on every shard
# (one launch each: a kernel row is one (shard, row) pair), or with
# fold_emit two of them after the first trip; across shards per trip: 2
# halo exchanges, ONE gather of the stacked 8-scalar-per-row boundary
# states, ONE sum (knot count + the two global end-knot values)
# ---------------------------------------------------------------------------


def _shard_halos(b3, group):
    """(left neighbor's last, right neighbor's first) sample per shard row;
    the global ends read the shard's own edge sample, as the unsharded
    kernels do."""
    return (group.shift_right_edge(b3[..., -1], b3[..., 0]),
            group.shift_left_edge(b3[..., 0], b3[..., -1]))


def _fold_states_both(tot: cf.ShardTotals, group, s_local: int):
    """The last two knots before each shard and the first two after it, from
    the shards' totals with ONE gather: the 8 scalars per row ride together
    (positions as bit patterns beside the values), then the fill combine
    folds the shards strictly before (after) each shard, nearest last so
    its knots win.  Returns ``(pre_pos, pre_val, suf_pos, suf_val)``, each
    (S_local * rows, 2)."""
    f32 = torch.float32
    stacked = torch.cat([tot.fpos.view(f32), tot.fval, tot.rpos.view(f32),
                         tot.rval], dim=-1)
    rows = stacked.shape[0] // s_local
    gathered = group.all_gather(stacked.view(s_local, rows, 8))
    bits = gathered.view(torch.int32)
    ranks = group.ranks(stacked.device)[:, None]
    none = torch.full((s_local, rows), -1, dtype=torch.int32,
                      device=stacked.device)
    zero = torch.zeros((s_local, rows), dtype=f32, device=stacked.device)

    def fold(c, reverse):
        acc = (none, zero, none, zero)
        order = range(group.size - 1, -1, -1) if reverse else range(group.size)
        for s in order:
            st = (bits[s, :, c], gathered[s, :, c + 2], bits[s, :, c + 1],
                  gathered[s, :, c + 3])
            new = cf._rev_combine(st, acc) if reverse \
                else cf._fwd_combine(acc, st)
            use = ranks < s if reverse else ranks > s
            acc = tuple(torch.where(use, a_new, a)
                        for a_new, a in zip(new, acc))
        return (torch.stack([acc[0], acc[2]], -1).reshape(-1, 2),
                torch.stack([acc[1], acc[3]], -1).reshape(-1, 2))

    return fold(0, False) + fold(4, True)


def _sift_local_kernel(x3, group, n_global, max_iteration, endpoint_mode,
                       fold_emit=None):
    """The sharded trip loop on the sift kernels (JAX's
    ``_sift_local_pallas``): the loop of ``decomp/itd.py::_itd_sift_kernel``
    with the pre-pass split around the cross-shard fold and the stop
    decision taken from the global count, on the device; each row is written
    in place into ``rotations[level]``.  ``x3`` (S_local, rows, n_loc) f32;
    returns the outputs in the same layout.

    ``fold_emit`` (default: the ``PYITD_FOLD_EMIT`` environment flag, as in
    JAX): only the input is summarised by ``level_summaries``; every level
    but the last emits its baseline's interior summaries and the next
    trip's ``tile_scan`` completes them with the tiles' edge samples and
    each shard's last sample, read against the halos that trip exchanges
    anyway.  The same collectives, bit for bit the same result."""
    if fold_emit is None:
        fold_emit = bool(os.environ.get("PYITD_FOLD_EMIT"))
    levels = max_iteration + 2
    s_local, rows, n_loc = x3.shape
    dev = x3.device
    ranks = group.ranks(dev)
    offset = (ranks * n_loc).to(torch.int32).repeat_interleave(rows)
    rank_col = ranks[:, None]
    minus0 = torch.full((), -0.0, dtype=torch.float32, device=dev)

    def per_row(t):  # (rows,) -> one entry per kernel row
        return t.repeat(s_local)

    def owned_pair(b3, g0, g1):
        """This shard's part of 0.5 * (x[g0] + x[g1]): the owner of both
        contributes the mean in the unsharded kernels' order, two owners
        half a sample each, everyone else -0.0 (the sum's identity)."""
        s0, l0 = divmod(g0, n_loc)
        s1, l1 = divmod(g1, n_loc)
        if s0 == s1:
            return torch.where(rank_col == s0,
                               0.5 * (b3[..., l0] + b3[..., l1]), minus0)
        return (torch.where(rank_col == s0, 0.5 * b3[..., l0], minus0)
                + torch.where(rank_col == s1, 0.5 * b3[..., l1], minus0))

    def level(base, interior=None, carry=None, trip=0, emit=False, **book):
        """One trip on ``base`` (S_local * rows, n_loc), whose interior
        summaries the level before it emitted, if it did."""
        b3 = base.view(s_local, rows, n_loc)
        halo_l, halo_r = _shard_halos(b3, group)
        shard = cf.ShardArgs(n_global, offset, halo_l.reshape(-1),
                             halo_r.reshape(-1))
        if interior is None:
            states, tot = cf.tile_scan_cuda(
                cf.level_summaries_cuda(base, shard), totals=True)
        else:
            states, tot = cf.tile_scan_cuda(interior, totals=True,
                                            edges_from=base, shard=shard)
        if group.size > 1:
            seeds = _fold_states_both(tot, group, s_local)
        else:
            seeds = (torch.full_like(tot.fpos, -1), torch.zeros_like(tot.fval),
                     torch.full_like(tot.rpos, -1), torch.zeros_like(tot.rval))
        # one sum for the trip's three scalars per row, in f64: the knot
        # count (exact at any length) and the two end-knot values, which
        # only their owners contribute
        knots = (states.nex + 2).view(s_local, rows)
        tot3 = group.all_reduce_sum(torch.stack(
            [knots.double(), owned_pair(b3, 0, 1).double(),
             owned_pair(b3, n_global - 2, n_global - 1).double()], -1))[0]
        nex = (tot3[:, 0] - 2).to(torch.int32)
        flags = cf.stop_flags(nex, carry, trip, max_iteration)
        states = states._replace(nex=per_row(nex), flags=per_row(flags))
        shard = shard._replace(
            b_first=per_row(tot3[:, 1].float()),
            b_last=per_row(tot3[:, 2].float()), pre_pos=seeds[0],
            pre_val=seeds[1], suf_pos=seeds[2], suf_val=seeds[3])
        return cf.sift_level_cuda(base, states, endpoint_mode=endpoint_mode,
                                  shard=shard, emit=emit, **book)

    x2 = x3.reshape(s_local * rows, n_loc)
    first = level(x2, emit=fold_emit)
    rot, base, perr = first.rotation, first.baseline, first.sub_err
    interior = first.interior
    zero = x2 * 0
    out_rot = torch.empty((levels,) + x2.shape, dtype=x2.dtype, device=dev)
    carry = cf.SiftCarry.zeros(rows, dev)
    prev_base, comp = zero, zero
    for i in range(levels):
        # the last trip's baseline is extracted no further
        new = level(base, interior, carry, i,
                    emit=fold_emit and i + 1 < levels, rotp=rot,
                    pbase=prev_base, perr=perr, comp=comp, out_row=out_rot[i])
        interior = new.interior
        comp = new.comp
        rot, prev_base, base, perr = new.rotation, base, new.baseline, \
            new.sub_err
    return (out_rot.view((levels,) + x3.shape), carry.ncomp, carry.reason,
            comp.view(x3.shape))


class _KernelShardedSift(torch.autograd.Function):
    """The kernel route with JAX's gradient (``sharded.py:758-782``): the
    backward differentiates the plain sharded route on the saved input."""

    @staticmethod
    def forward(ctx, x3, group, n_global, max_iteration, endpoint_mode,
                fold_emit=None):
        ctx.args = (group, n_global, max_iteration, endpoint_mode)
        out = _sift_local_kernel(x3, *ctx.args, fold_emit)
        ctx.save_for_backward(x3)
        ctx.mark_non_differentiable(out[1], out[2])
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, g_rot, _g_ncomp, _g_reason, g_corr):
        (x3,) = ctx.saved_tensors
        with torch.enable_grad():
            xr = x3.detach().requires_grad_()
            rot, _, _, corr = _sift_local(xr, *ctx.args)
            pairs = [(o, g) for o, g in ((rot, g_rot), (corr, g_corr))
                     if g is not None]
            gx = None
            if pairs:
                (gx,) = torch.autograd.grad([o for o, _ in pairs], xr,
                                            [g for _, g in pairs])
        return gx, None, None, None, None, None


def _as_rows(x):
    if x.dim() < 1:
        raise ValueError("expected a signal or a bank of signals")
    return x.reshape(-1, x.shape[-1]), x.shape[:-1]


def _check_grad(x, group) -> bool:
    grad = x.requires_grad and torch.is_grad_enabled()
    if grad and not getattr(group, "differentiable", False):
        raise NotImplementedError(
            f"{type(group).__name__}'s collectives carry no gradient; the "
            "sharded routes differentiate over a LocalGroup or a DistGroup")
    return grad


def sharded_itd_sift(x: torch.Tensor, group, max_iteration: int = 11, *,
                     endpoint_mode: str = "reference", backend: str = "auto"):
    """The canonical sift of ``x`` (batch, n) with the time axis cut over
    ``group``'s shards.

    With a ``LocalGroup`` ``x`` is the whole bank, of ANY length: where the
    group's size does not divide n the time axis is edge-padded to the next
    multiple and the outputs are cropped (pad samples are never knots, so
    the result is the unpadded sift's).  With a ``DistGroup`` ``x`` is this
    rank's slice (all slices of one length) and so are the outputs.  Any
    batch.  n below 2^31: positions are int32 / int64 throughout.

    Returns ``(rotations[levels, batch, n], num_components, stop_reason,
    correction)`` (``decomp.itd.SiftResult`` semantics).

    ``backend``: ``"kernel"`` runs the sift kernels of ``ops/cuda_fill.py``
    on every shard (f32; on a CPU tensor their plain versions), bit for bit
    ``itd_sift(backend="kernel")``; ``"torch"`` the plain sharded fills, any
    float dtype; ``"auto"`` is ``"kernel"`` for f32 on a CUDA tensor and
    ``"torch"`` elsewhere.  The kernel route honours the ``PYITD_FOLD_EMIT``
    environment flag as JAX's does (each level emits the next trip's tile
    summaries; the same bits).  Differentiable over either group: the kernel
    route's backward differentiates the plain route (over a ``DistGroup``
    each rank's gradient is that of the sum of the ranks' losses)."""
    if endpoint_mode not in ENDPOINT_MODES:
        raise ValueError(f"unknown endpoint_mode: {endpoint_mode!r}")
    if backend == "auto":
        backend = "kernel" if (x.is_cuda and x.dtype == torch.float32) \
            else "torch"
    if backend not in ("kernel", "torch"):
        raise ValueError(f"unknown backend: {backend!r}")
    x2, lead = _as_rows(x)
    grad = _check_grad(x2, group)
    x3, n_global = group.to_shards(x2)
    if n_global < 2:
        raise ValueError(f"a signal needs at least 2 samples (got "
                         f"n={n_global})")
    args = (group, n_global, max_iteration, endpoint_mode)
    if backend == "torch":
        rot, ncomp, reason, corr = _sift_local(x3, *args)
    else:
        check_kernel_input(x3)
        run = _KernelShardedSift.apply if grad else _sift_local_kernel
        rot, ncomp, reason, corr = run(x3, *args)
    rot = group.from_shards(rot, n_global)
    corr = group.from_shards(corr, n_global)
    return (rot.reshape((rot.shape[0],) + lead + rot.shape[-1:]),
            ncomp.reshape(lead), reason.reshape(lead),
            corr.reshape(lead + corr.shape[-1:]))


# ---------------------------------------------------------------------------
# sequence-parallel cubic tier, gather method: knots are sparse, so each
# shard contributes its compacted knot buffer via one gather, every shard
# solves the (small) replicated not-a-knot system, and evaluation stays
# local
# ---------------------------------------------------------------------------


def _scatter_channels(n_loc, positions, valid, channels):
    """Scatter per-knot ``channels`` (each broadcastable to ``positions``)
    onto a grid of ``n_loc`` cells at ``positions`` (unique; invalid slots
    and positions off the grid are dropped)."""
    ok = valid & (positions >= 0) & (positions < n_loc)
    pos = torch.where(ok, positions, n_loc)
    out = []
    for ch in channels:
        ch = ch.expand(pos.shape)
        grid = torch.zeros(pos.shape[:-1] + (n_loc + 1,), dtype=ch.dtype,
                           device=ch.device)
        out.append(grid.scatter(-1, pos, ch)[..., :n_loc])
    return tuple(out)


def _cubic_local(x, group, n_global, cap, min_extrema):
    dtype = x.dtype
    n_loc = x.shape[-1]
    size = group.size
    rank = group.ranks(x.device)[:, None, None]
    _, knots, nex, gpos = _extrema(x, group, n_global)

    pos_loc, cnt_loc = compact_indices(knots, cap)  # local indices
    valid_loc = torch.arange(cap, device=x.device) < cnt_loc[..., None]
    gpos_knots = torch.where(valid_loc, pos_loc + rank * n_loc, n_global)
    vals_knots = torch.where(
        valid_loc, torch.gather(x, -1, pos_loc.clamp(0, n_loc - 1).long()),
        torch.zeros_like(x[..., :1]))

    # replicate all shards' knots: (size, rows, cap) -> (rows, size * cap)
    rows = x.shape[1]
    allp = group.all_gather(gpos_knots).transpose(0, 1).reshape(rows, -1)
    allv = group.all_gather(vals_knots).transpose(0, 1).reshape(rows, -1)
    # squeeze out padding: shard-ordered positions stay sorted under a
    # stable sort of (position, padding-at-end)
    order = torch.argsort(allp, dim=-1, stable=True)
    allp = torch.gather(allp, -1, order)
    allv = torch.gather(allv, -1, order)
    total = group.all_reduce_sum(valid_loc.sum(-1).to(torch.int32))[0]

    kk = torch.arange(size * cap, device=x.device)
    cnt = total[..., None]

    # knot values: odd-reflect ends + Frei-Osorio interior; end samples by
    # ownership of global positions (pad-safe)
    first2, last2 = _end_samples_at(x, n_global, group)
    b_first = 0.5 * (3.0 * first2[..., 0] - first2[..., 1])
    b_last = 0.5 * (3.0 * last2[..., 1] - last2[..., 0])

    def prev(a):
        return torch.cat([torch.zeros_like(a[..., :1]), a[..., :-1]], -1)

    def nxt(a):
        return torch.cat([a[..., 1:], torch.zeros_like(a[..., :1])], -1)

    e_prev, e_next = prev(allp), nxt(allp)
    kv = knot_value(allp, allv, e_prev, prev(allv), e_next, nxt(allv))
    kv = torch.where(kk == 0, b_first[..., None], kv)
    kv = torch.where(kk == cnt - 1, b_last[..., None], kv)
    kv = torch.where(kk >= cnt, torch.zeros_like(kv), kv)

    moments = spline_moments(allp, kv, total, bc="not-a-knot")
    h = (e_next - allp).to(dtype)
    h = torch.where(kk < cnt - 1, h, torch.ones_like(h))

    # gather-free evaluation: scatter each knot's channels onto its owning
    # shard's grid, forward-fill the j-side channels from knots 0..count-2,
    # backward-fill the (j+1)-side channels strictly-after from knots
    # 1..count-1, patch the global final sample (no strictly-after knot)
    # with the last knot's channels
    loc = allp[None] - rank * n_loc
    valid_j = (kk < cnt - 1)[None]
    valid_n = ((kk >= 1) & (kk < cnt))[None]
    one = torch.ones_like(kv)
    pj_g, kj_g, mj_g, hj_g, occj = _scatter_channels(
        n_loc, loc, valid_j, (allp, kv, moments, h, one))
    kn_g, mn_g, occn = _scatter_channels(n_loc, loc, valid_n,
                                         (kv, moments, one))

    pos_j, k_j, m_j, h_j = _ffill((pj_g, kj_g, mj_g, hj_g), occj != 0, group,
                                  (0, 0.0, 0.0, 1.0))
    zf = torch.zeros((), dtype=dtype, device=x.device)
    k_j1, m_j1 = _bfill(
        (_shift_left(kn_g, group, zf), _shift_left(mn_g, group, zf)),
        _shift_left(occn != 0, group, False), group, (0.0, 0.0))
    last_idx = (cnt - 1).clamp(min=0).long()
    is_glast = gpos == n_global - 1
    k_j1 = torch.where(is_glast, torch.gather(kv, -1, last_idx)[None], k_j1)
    m_j1 = torch.where(is_glast, torch.gather(moments, -1, last_idx)[None],
                       m_j1)

    h_safe = torch.where(h_j == 0, torch.ones_like(h_j), h_j)
    s = (gpos - pos_j).to(dtype) / h_safe  # int diff first: exact at any n
    omt = 1.0 - s
    baseline = (omt * k_j + s * k_j1
                + h_j * h_j / 6.0 * ((omt**3 - omt) * m_j + (s**3 - s) * m_j1))
    baseline = torch.where((nex < min_extrema)[None, :, None], x, baseline)
    return x - baseline, baseline, nex


# ---------------------------------------------------------------------------
# distributed-SPIKE cubic tier: every shard factorizes its piece of the
# grid-resident chained moment system (ops/chained_pcr.py) with its two
# boundary couplings moved to spike right-hand sides; only SIX scalars per
# shard row cross the group, so the interface gather is O(shards), not
# O(knots)
# ---------------------------------------------------------------------------


def _cubic_local_spike(x, group, n_global, min_extrema):
    dtype = x.dtype
    size = group.size
    rank = group.ranks(x.device)
    zf = torch.zeros((), dtype=dtype, device=x.device)
    mask, knots, nex, gpos = _extrema(x, group, n_global)
    first, last = gpos == 0, gpos == n_global - 1

    # exclusive prev/next knot (position, raw value) -> Frei-Osorio values
    km1 = _shift_right(knots, group, False)
    prev_pos, prev_x = _ffill(
        (torch.where(first, 0, gpos - 1).expand(x.shape),
         _shift_right(x, group, zf)), km1, group, (0, 0.0))
    kp1 = _shift_left(knots, group, False)
    next_pos, next_x = _bfill(
        (torch.where(last, 0, gpos + 1).expand(x.shape),
         _shift_left(x, group, zf)), kp1, group, (0, 0.0))
    k_site = knot_value(gpos, x, prev_pos, prev_x, next_pos, next_x)
    first2, last2 = _end_samples_at(x, n_global, group)
    b_first = 0.5 * (3.0 * first2[..., 0] - first2[..., 1])
    b_last = 0.5 * (3.0 * last2[..., 1] - last2[..., 0])
    k_site = torch.where(first, b_first[..., None], k_site)
    k_site = torch.where(last, b_last[..., None], k_site)

    # exclusive prev/next knot k_site values
    (kv_prev,) = _ffill((_shift_right(k_site, group, zf),), km1, group,
                        (0.0,))
    (kv_next,) = _bfill((_shift_left(k_site, group, zf),), kp1, group, (0.0,))

    # not-a-knot rows at interior knots, with global boundary conditions
    a2, b2, c2, d = notaknot_rows(
        (gpos - prev_pos).to(dtype), (next_pos - gpos).to(dtype),
        kv_prev, k_site, kv_next,
        firstrow=prev_pos == 0, lastrow=next_pos == n_global - 1)

    # local SPIKE factorization + O(shards) interface solve; the six
    # per-shard interface scalars ride ONE stacked gather
    (xp_u, xp_w), (vl_u, vl_w), (vr_u, vr_w) = shard_spike_factors(
        mask, a2, b2, c2, d)
    iface = torch.stack(
        [-vl_u[..., -1], -vl_w[..., 0], -vr_u[..., -1], -vr_w[..., 0],
         xp_u[..., -1], xp_w[..., 0]], dim=-1)
    iface = group.all_gather(iface).permute(1, 2, 0)  # (rows, 6, size)
    e, f = reduced_interface_solve(*(iface[:, i] for i in range(6)))
    e_prev = torch.where(rank[:, None] == 0, zf,
                         e[:, (rank - 1).clamp(min=0)].T)
    f_next = torch.where(rank[:, None] == size - 1, zf,
                         f[:, (rank + 1).clamp(max=size - 1)].T)
    u = xp_u + vl_u * e_prev[..., None] + vr_u * f_next[..., None]
    w_sol = xp_w + vl_w * e_prev[..., None] + vr_w * f_next[..., None]
    m_j = u
    m_j1 = _shift_left(w_sol, group, zf)

    # not-a-knot end moments from the global first/last two interior
    # knots: one local top-2 reduce in both directions, then two stacked
    # minima (the maxima ride negated): the global second is the owner
    # shard's local second, every other shard contributes its local first
    l_il1, l_il2, l_i1, l_i2 = _end_knot_positions(
        mask, n_global, gpos.expand(x.shape))
    s1 = group.all_reduce_min(torch.stack([l_i1, -l_il1], -1))[0]
    i1, il1 = s1[..., 0], -s1[..., 1]
    s2 = group.all_reduce_min(torch.stack(
        [torch.where(l_i1 == i1, l_i2, l_i1),
         -torch.where(l_il1 == il1, l_il2, l_il1)], -1))[0]
    i2, il2 = s2[..., 0], -s2[..., 1]

    # the four end moments by ownership, one stacked sum
    m4 = _owned(u, group, torch.stack([i1, i2, il1, il2], -1))
    m1, m2, ml1, ml2 = m4.unbind(-1)
    # degenerate contract at a single interior knot (pinned to the compact
    # solver): a missing second interior knot keeps its moment at 0 (no
    # shard owns the sentinel) and spans to the far END knot
    has_i2 = i2 < n_global
    has_il2 = il2 >= 0
    h0 = i1.to(dtype)
    h1 = torch.where(has_i2, i2 - i1, n_global - 1 - i1).to(dtype)
    hl = (n_global - 1 - il1).to(dtype)
    hl2 = torch.where(has_il2, il1 - il2, il1).to(dtype)
    m0 = m1 + _sdiv(h0, h1) * (m1 - m2)
    m_last = ml1 + _sdiv(hl, hl2) * (ml1 - ml2)

    # inclusive j-side fill for evaluation
    p1_pos, k_j = _ffill((gpos.expand(x.shape), k_site), knots, group,
                         (0, 0.0))
    m_j = torch.where(p1_pos == 0, m0[..., None], m_j)
    m_j1 = torch.where(next_pos == n_global - 1, m_last[..., None], m_j1)

    pos_j = torch.where(last, prev_pos, p1_pos)
    k_j = torch.where(last, kv_prev, k_j)
    k_j1 = torch.where(last, b_last[..., None], kv_next)
    m_j1 = torch.where(last, m_last[..., None], m_j1)
    right_pos = torch.where(last, gpos, next_pos)

    h_j = (right_pos - pos_j).to(dtype)  # int diff: exact at any n
    s = _sdiv((gpos - pos_j).to(dtype), h_j)
    omt = 1.0 - s
    baseline = (omt * k_j + s * k_j1
                + h_j * h_j / 6.0 * ((omt**3 - omt) * m_j + (s**3 - s) * m_j1))
    baseline = torch.where((nex < min_extrema)[None, :, None], x, baseline)
    return x - baseline, baseline, nex


def _max_knots_per_shard(x: torch.Tensor, seq: int) -> int:
    """The largest per-shard knot-buffer occupancy over rows and shards of
    the whole bank ``x`` (rows, n) cut into ``seq`` shards: interior extrema
    plus the two end knots, each counted in its owning shard."""
    n = x.shape[-1]
    it = torch.arange(n, device=x.device)
    knots = extrema_mask(x) | (it == 0) | (it == n - 1)
    knots = torch.nn.functional.pad(knots, (0, (-n) % seq))
    return int(knots.reshape(x.shape[:-1] + (seq, -1)).sum(-1).max())


def sharded_cubic_baseline(x: torch.Tensor, group, *,
                           capacity_per_shard: int | None = None,
                           min_extrema: int = 10, method: str = "spike"):
    """Sequence-parallel MEITD-tier cubic baseline over ``group``'s shards;
    matches ``ops.cubic_baseline.cubic_baseline_extract``.  Plain PyTorch on
    every device, differentiable over either group.

    ``method="spike"`` (default): every shard SPIKE-factorizes its piece of
    the grid-resident chained moment system; beyond the fills' boundary
    states only six scalars per shard row cross the group, and per-shard
    work stays O(n_loc log n_loc) at any knot density.

    ``method="gather"``: each shard compacts its knots and one gather
    replicates all knot buffers for a redundant solve, O(total knots) per
    shard.  ``capacity_per_shard`` sets the per-shard buffer; when not given
    it is counted exactly (``LocalGroup`` only).

    ``x``, any length and any batch as for :func:`sharded_itd_sift`.
    Returns (rotation, baseline, num_extrema)."""
    x2, lead = _as_rows(x)
    _check_grad(x2, group)
    x3, n_global = group.to_shards(x2)
    n_loc = x3.shape[-1]
    if method == "spike":
        out = _cubic_local_spike(x3, group, n_global, min_extrema)
    elif method == "gather":
        if capacity_per_shard is None:
            if x3.shape[0] != group.size:
                raise ValueError("method='gather' needs capacity_per_shard "
                                 "where a process holds one shard")
            measured = _max_knots_per_shard(x2.detach(), group.size)
            # a multiple of 8, as JAX sizes it
            cap = min(max(-(-measured // 8) * 8, 8), n_loc + 2)
        else:
            cap = capacity_per_shard
        out = _cubic_local(x3, group, n_global, cap, min_extrema)
    else:
        raise ValueError(f"unknown method: {method!r}")
    rot, base, nex = out
    rot = group.from_shards(rot, n_global)
    base = group.from_shards(base, n_global)
    return (rot.reshape(lead + rot.shape[-1:]),
            base.reshape(lead + base.shape[-1:]), nex.reshape(lead))
