"""The hand-written CUDA kernels of the sift and its backward — port of
``pyitd_tpu/ops/pallas_fill.py``: K1 ``sift_level_fused_padded``, its XLA
pre-pass ``level_block_states_fwd`` and K2 ``linear_level_pallas`` in
``csrc/sift_level.cu``; K3 ``fill2_pallas``, ``fillv_pallas``, K4
``segsum_pallas`` and K2a's fills alone, ``linear_fill2_pallas``, in
``csrc/fill_segsum.cu``; and the level adjoint's per-sample work, which
replaces no TPU kernel (the XLA glue of JAX's structural adjoint), in
``csrc/level_bwd.cu`` (see each file's header for the design).

One level is three launches:

* ``level_summaries_cuda(x)``: per (row, tile) last-two knots, first-two
  knots and knot count;
* ``tile_scan_cuda(summ, carry, ...)``: per-tile exclusive forward prefix
  and reverse suffix, the interior extrema count, and, when a sift carry is
  given, the stop flags and the in-place ``done``/``reason``/``ncomp``
  update;
* ``sift_level_cuda(x, states, ...)``: baseline, rotation and its two-sum
  residual, and with the previous extraction's outputs the output row
  (written in place into the caller's ``rotations[level]``) and the
  compensation.

Inside a sift the first of the three runs once, for the input: with
``emit=True`` ``sift_level_cuda`` also returns the summaries of the
baseline it has just computed over each tile's interior (samples 1 ..
``TILE - 2`` of the tile), and ``tile_scan_cuda(interior, ...,
edges_from=baseline)`` completes every tile with its first and last sample
before it scans.  A trip is then two launches.

The backward's scans, each one launch of a single-pass scan with decoupled
look-back over a row's tiles (every input read once, every output written
once):

* ``fill2_cuda(vals, mask, reverse, strict)``: per sample, (position,
  value) of the last two marked samples at or before it (reverse: the
  first two at or after it; ``strict``: strictly), 0 where none;
* ``fillv_cuda(vals, mask, reverse)``: the same at depth one, value only;
* ``linear_fill2_cuda(x, reverse)``: ``fill2`` of the signal under its
  knot mask, computed in the kernel (the first fill round of JAX's
  unfused and compact cubic routes, which the port does not take: no
  caller on a main path);
* ``segsum_cuda(vals, flags, reverse, strict)``: segmented inclusive
  running sums of one or two channels that reset at flagged samples
  (``strict``: the sum up to the previous sample in scan order).

A level's adjoint (``linear_baseline.structural_level_bwd``) runs two
``fill2`` and two ``segsum`` calls between three kernels of its own, each
one launch over every sample:

* ``bwd_knots_cuda(x)``: the knot mask and its one-left shift;
* ``bwd_pre_cuda(x, g_rot, g_base, g_err, fwd, bwd, endpoint_mode)``: from
  the two fills' channels, the four cotangent channels that the segment
  sums take and the gradient's direct term; with a :class:`TripCotangents`
  it first forms the level's cotangents from the kernel sift's output
  cotangents and per-row stop flags (the reverse trip loop of
  ``decomp/itd.py::_KernelSift.backward``);
* ``bwd_post_cuda(knots, gx, seg_a, seg_e, p2p, n1p)``: from the segment
  sums, the gradient.

The torch route of the adjoint calls the plain ``bwd_pre`` and
``bwd_post`` directly, around its own fills and cumulative-sum segment
sums, on any dtype and batch shape.

The three sift kernels also run on time shards of a longer signal (the
port of K9, ``pyitd_tpu/ops/pallas_fill_sharded.py``): with a
:class:`ShardArgs`, a kernel row is one (shard, row) pair that starts at
``offset`` of a signal of ``n_global`` samples, knots are tested and
numbered by global position, the cells beside the row hold the neighbour
shards' edge samples, and ``sift_level_cuda`` combines the knots before and
after the shard into every tile's seeds.  ``tile_scan_cuda(totals=True)``
also returns each row's inclusive totals, which ``parallel/sharded.py``
folds across the shards.  ``sift_level_cuda(..., shard=..., emit=True)``
also leaves out each shard's last sample, whose knot test needs the next
shard's first baseline sample, and ``tile_scan_cuda(..., edges_from=...,
shard=...)`` completes it with the next trip's halos (JAX's ``fold_emit``).

Each wrapper checks its tensors and, for a CUDA tensor, launches its
kernel through :func:`_launch`, the one launch path of this module's and
``cuda_cubic``'s wrappers: PyTorch's current stream, the error check, the
count in ``LAUNCHES``.  The library's build constants are checked once,
where :func:`_lib` first loads it.  Each call runs inside the profiler
span ``pyitd.<wrapper>`` (``utils/spans.py``: recorded only while a
profiler is on), so a trace counts the launches where they are made and
holds each launch inside its wrapper's span.  For a CPU
tensor it runs the plain PyTorch version beside it (``level_summaries``,
``tile_scan``, ``sift_level``, ``fill2``, ``linear_fill2``, ``fillv``,
``segsum``, ``bwd_knots``, ``bwd_pre``, ``bwd_post``); those plain versions
run on any device.  A CUDA tensor never reaches a plain
version through a wrapper.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .fill import (backward_fill2_scan, backward_fill_scan,
                   forward_fill2_scan, forward_fill_scan, prev_index,
                   shift_left, shift_right)
from .linear_baseline import (ENDPOINT_MODES, interp, knot_mask,
                              knot_mask_at, knot_value, two_sum_err)
from ..utils.spans import spanned

__all__ = [
    "TILE", "STOP_A", "STOP_B", "CONT", "LAUNCHES", "SEGSUM_LAUNCHES",
    "MODE_LAUNCHES",
    "reset_launches",
    "TileSummaries", "LevelStates", "SiftCarry", "LevelOut", "ShardArgs",
    "ShardTotals", "TripCotangents",
    "level_summaries", "interior_summaries", "complete_summaries",
    "tile_scan", "level_states", "sift_level",
    "stop_flags", "emit_row", "fill2", "linear_fill2", "fillv", "segsum",
    "segsum_depth", "segsum_error_bound", "SCAN_THREADS", "SCAN_RUN",
    "bwd_knots", "trip_cotangents", "bwd_pre", "bwd_post",
    "level_summaries_cuda", "tile_scan_cuda", "level_states_cuda",
    "sift_level_cuda", "fill2_cuda", "linear_fill2_cuda", "fillv_cuda",
    "segsum_cuda", "bwd_knots_cuda", "bwd_pre_cuda", "bwd_post_cuda",
]

TILE = 4096  # samples per tile; the TILE of both csrc/*.cu (checked at load)
# csrc/fill_segsum.cu's threads per block and samples per thread (checked at
# load): they fix the order of segsum's additions
SCAN_THREADS, SCAN_RUN = 512, 8

# stop-flag bits of LevelStates.flags
STOP_A, STOP_B, CONT = 1, 2, 4

# launches per kernel wrapper, counted where the kernel is launched
LAUNCHES = {"level_summaries": 0, "tile_scan": 0, "sift_level": 0,
            "fill2": 0, "linear_fill2": 0, "fillv": 0, "segsum": 0,
            "bwd_knots": 0, "bwd_pre": 0, "bwd_post": 0}


# LAUNCHES["segsum"] by the call's number of channels
SEGSUM_LAUNCHES = {1: 0, 2: 0}

# of LAUNCHES["sift_level"], those with the sift's bookkeeping and those
# that emit interior summaries, and of these the ones on time shards; of
# LAUNCHES["tile_scan"], those that complete interior summaries with the
# tiles' edge samples, and of these the ones on time shards
MODE_LAUNCHES = {"sift_level_book": 0, "sift_level_emit": 0,
                 "sift_level_shard_emit": 0, "tile_scan_edges": 0,
                 "tile_scan_shard_edges": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, SEGSUM_LAUNCHES, MODE_LAUNCHES):
        for k in counts:
            counts[k] = 0


class TileSummaries(NamedTuple):
    """Per (row, tile): last two knots (``fpos``/``fval``, latest first),
    first two knots (``rpos``/``rval``, earliest first), knot count.
    Positions are int32 within the row, -1 for none (value 0)."""
    fpos: torch.Tensor  # (rows, ntiles, 2) int32
    fval: torch.Tensor  # (rows, ntiles, 2) x.dtype
    rpos: torch.Tensor  # (rows, ntiles, 2) int32
    rval: torch.Tensor  # (rows, ntiles, 2) x.dtype
    cnt: torch.Tensor   # (rows, ntiles) int32


class LevelStates(NamedTuple):
    """Seeds and stop decisions of one trip: ``fpos``/``fval`` hold the last
    two knots before each tile, ``rpos``/``rval`` the first two after it."""
    nex: torch.Tensor    # (rows,) int32 interior extrema count
    flags: torch.Tensor  # (rows,) int32 STOP_A | STOP_B | CONT bits
    fpos: torch.Tensor
    fval: torch.Tensor
    rpos: torch.Tensor
    rval: torch.Tensor


class SiftCarry(NamedTuple):
    """Per-row sift state, int32 on the signal's device, updated in place."""
    done: torch.Tensor
    reason: torch.Tensor
    ncomp: torch.Tensor

    @classmethod
    def zeros(cls, rows: int, device) -> "SiftCarry":
        z = [torch.zeros(rows, dtype=torch.int32, device=device)
             for _ in range(3)]
        return cls(*z)


class ShardArgs(NamedTuple):
    """What makes each row one time shard of a longer signal, per row:
    ``offset`` is the global position of the row's first sample, ``halo_l``
    / ``halo_r`` the samples just before and after the row (at the global
    ends any finite value: those samples are knots whatever their
    neighbours).  ``sift_level`` also needs the global end-knot values
    ``b_first`` / ``b_last`` and the last two knots before the shard
    (``pre_pos``/``pre_val``, latest first) and the first two after it
    (``suf_pos``/``suf_val``, earliest first), -1 and 0 for none."""
    n_global: int
    offset: torch.Tensor   # (rows,) int32
    halo_l: torch.Tensor   # (rows,) x.dtype
    halo_r: torch.Tensor
    b_first: torch.Tensor | None = None  # (rows,) x.dtype
    b_last: torch.Tensor | None = None
    pre_pos: torch.Tensor | None = None  # (rows, 2) int32
    pre_val: torch.Tensor | None = None  # (rows, 2) x.dtype
    suf_pos: torch.Tensor | None = None
    suf_val: torch.Tensor | None = None


class ShardTotals(NamedTuple):
    """Per row, the last two (``fpos``/``fval``) and the first two
    (``rpos``/``rval``) knots of the whole row, as in
    :class:`TileSummaries`."""
    fpos: torch.Tensor  # (rows, 2) int32
    fval: torch.Tensor
    rpos: torch.Tensor
    rval: torch.Tensor


class TripCotangents(NamedTuple):
    """Where the level adjoint of trip ``j`` of the kernel sift's reverse
    trip loop (``decomp/itd.py::_KernelSift.backward``) takes its output
    cotangents from, beside the sift's own: ``g_rot`` is then row ``j``'s
    cotangent ``G_j``, ``g_base`` baseline row ``j``'s ``Gb_j`` and
    ``g_err`` the correction's ``Gc``, each ``None`` where absent.
    ``flags`` are trip ``j``'s stop flags, ``flags_next`` and ``g_next``
    trip ``j + 1``'s and its row's cotangent ``G_{j+1}`` (``None`` past the
    last trip run), ``carry`` the input gradient of level ``j + 1``
    (``None`` at the last), ``zero`` marks level 0, whose gradient also
    takes the zero path (the sift's ``x * 0``: its first ``prev_base`` and
    compensation), and ``g_zero`` a further term of that path (baseline
    row 0's cotangent where no baselines are stored)."""
    flags: torch.Tensor                    # (rows,) int32
    flags_next: torch.Tensor | None = None  # (rows,) int32
    g_next: torch.Tensor | None = None      # (rows, n) f32
    carry: torch.Tensor | None = None       # (rows, n) f32
    zero: bool = False
    g_zero: torch.Tensor | None = None      # (rows, n) f32


class LevelOut(NamedTuple):
    baseline: torch.Tensor
    rotation: torch.Tensor
    sub_err: torch.Tensor
    comp: torch.Tensor | None  # updated compensation (bookkeeping only)
    # with ``emit``: the baseline's summaries over each tile's interior
    interior: TileSummaries | None = None


def _ntiles(n: int) -> int:
    return -(-n // TILE)


def _tiled(a: torch.Tensor, fill, ntiles: int) -> torch.Tensor:
    """(rows, n) -> (rows, ntiles, TILE), padded with ``fill``."""
    rows, n = a.shape
    pad = ntiles * TILE - n
    if pad:
        a = torch.cat([a, a.new_full((rows, pad), fill)], dim=-1)
    return a.reshape(rows, ntiles, TILE)


def _positions(ntiles: int, device) -> torch.Tensor:
    return torch.arange(ntiles * TILE, device=device).reshape(ntiles, TILE)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


_FAR = 1 << 40  # past every position, for the first-knot minima


def _shard_frame(x: torch.Tensor, shard: ShardArgs | None, nt: int):
    """``(knot mask, positions, first position, signal length)`` of rows
    that are whole signals or, with ``shard``, time shards: the mask and
    the positions tiled to (rows, ntiles, TILE), positions global."""
    rows, n = x.shape
    pos = _positions(nt, x.device)
    if shard is None:
        return (_tiled(knot_mask(x), False, nt), pos.expand(rows, nt, TILE),
                0, n)
    off = shard.offset.long()
    gpos = off[:, None] + torch.arange(n, device=x.device)
    knots = knot_mask_at(x, shard.halo_l, shard.halo_r, gpos, shard.n_global)
    return (_tiled(knots, False, nt), pos + off[:, None, None],
            off[:, None], shard.n_global)


def _summarize(m, pos, flat, off) -> TileSummaries:
    """The end knots and the knot count per tile of a tiled knot mask ``m``
    with positions ``pos`` (both (rows, ntiles, TILE)); ``flat`` holds the
    values, (rows, ntiles * TILE), of rows that start at position ``off``."""
    rows = flat.shape[0]
    big = _FAR

    lp = torch.where(m, pos, -1)
    p1 = lp.amax(-1)
    p2 = torch.where(lp < p1[..., None], lp, -1).amax(-1)
    rp = torch.where(m, pos, big)
    q1 = rp.amin(-1)
    q2 = torch.where(rp > q1[..., None], rp, big).amin(-1)
    q1 = torch.where(q1 == big, -1, q1)
    q2 = torch.where(q2 == big, -1, q2)

    def val(p):
        v = torch.gather(flat, 1, (p - off).clamp(min=0).reshape(rows, -1))
        return torch.where(p >= 0, v.reshape(p.shape), 0.0)

    return TileSummaries(
        fpos=torch.stack([p1, p2], -1).to(torch.int32),
        fval=torch.stack([val(p1), val(p2)], -1),
        rpos=torch.stack([q1, q2], -1).to(torch.int32),
        rval=torch.stack([val(q1), val(q2)], -1),
        cnt=m.sum(-1).to(torch.int32),
    )


def level_summaries(x: torch.Tensor,
                    shard: ShardArgs | None = None) -> TileSummaries:
    """Plain version of the ``level_summaries`` kernel."""
    rows, n = x.shape
    nt = _ntiles(n)
    m, pos, off, _ = _shard_frame(x, shard, nt)
    return _summarize(m, pos, _tiled(x, 0.0, nt).reshape(rows, -1), off)


def interior_summaries(x: torch.Tensor,
                       shard: ShardArgs | None = None) -> TileSummaries:
    """The summaries of ``x`` over each tile's interior, samples 1 ..
    ``TILE - 2`` of the tile: what ``sift_level(..., emit=True)`` returns
    for its baseline.  A tile's first and last sample are left to
    ``tile_scan(..., edges_from=x)``.  With ``shard`` (``offset`` and
    ``n_global``; the halos reach only samples left out) positions are
    global and the shard's last sample, local ``n - 1``, is left out too:
    its right neighbour is the next shard's first sample."""
    rows, n = x.shape
    nt = _ntiles(n)
    m, pos, off, _ = _shard_frame(x, shard, nt)
    m = m.clone()
    m[..., 0] = m[..., TILE - 1] = False
    if shard is not None:
        m.view(rows, -1)[:, n - 1] = False
    return _summarize(m, pos, _tiled(x, 0.0, nt).reshape(rows, -1), off)


def complete_summaries(interior: TileSummaries, x: torch.Tensor,
                       shard: ShardArgs | None = None) -> TileSummaries:
    """Interior summaries of ``x`` completed with every tile's first and
    last sample and, with ``shard``, the shard's last sample, tested
    against the halos: equal to ``level_summaries(x, shard)``."""
    rows, n = x.shape
    nt = _ntiles(n)
    m, pos, _, _ = _shard_frame(x, shard, nt)
    xt = _tiled(x, 0.0, nt)

    def state(k, p, v):  # one-sample states where the mask k holds
        p = torch.where(k, p, -1).to(torch.int32)
        v = torch.where(k, v, 0.0)
        return p, v, torch.full_like(p, -1), torch.zeros_like(v)

    def at(j):  # local sample j of every tile
        return state(m[..., j], pos[..., j], xt[..., j])

    def pack(t):
        return torch.stack([t[0], t[2]], -1), torch.stack([t[1], t[3]], -1)

    f = (interior.fpos[..., 0], interior.fval[..., 0],
         interior.fpos[..., 1], interior.fval[..., 1])
    r = (interior.rpos[..., 0], interior.rval[..., 0],
         interior.rpos[..., 1], interior.rval[..., 1])
    # in position order: first, interior, the shard's last sample inside
    # the tile, last
    first, last = at(0), at(TILE - 1)
    f, r = _fwd_combine(first, f), _rev_combine(first, r)
    cnt = interior.cnt + (m[..., 0].to(torch.int32)
                          + m[..., TILE - 1].to(torch.int32))
    k, j = divmod(n - 1, TILE)
    if shard is not None and 0 < j < TILE - 1:
        here = torch.zeros_like(m[..., 0])
        here[:, k] = m[:, k, j]
        mid = state(here, pos[..., j], xt[..., j])
        f, r = _fwd_combine(f, mid), _rev_combine(r, mid)
        cnt = cnt + here.to(torch.int32)
    fpos, fval = pack(_fwd_combine(f, last))
    rpos, rval = pack(_rev_combine(r, last))
    return TileSummaries(fpos, fval, rpos, rval, cnt)


def _fwd_combine(a, b):
    """``a`` covers samples before ``b``'s; keep the last two knots."""
    h1, h2 = b[0] >= 0, b[2] >= 0
    tp = torch.where(h1, a[0], a[2])
    tv = torch.where(h1, a[1], a[3])
    return (torch.where(h1, b[0], a[0]), torch.where(h1, b[1], a[1]),
            torch.where(h2, b[2], tp), torch.where(h2, b[3], tv))


def _rev_combine(a, b):
    """``a`` covers samples before ``b``'s; keep the first two knots."""
    h1, h2 = a[0] >= 0, a[2] >= 0
    tq = torch.where(h1, b[0], b[2])
    tw = torch.where(h1, b[1], b[3])
    return (torch.where(h1, a[0], b[0]), torch.where(h1, a[1], b[1]),
            torch.where(h2, a[2], tq), torch.where(h2, a[3], tw))


def _exclusive(pos, val, combine, reverse):
    """Per-tile exclusive scan of (rows, ntiles, 2) states over tiles, and
    the inclusive total ``(p1, v1, p2, v2)``."""
    ntiles = pos.shape[1]
    acc = (torch.full_like(pos[:, 0, 0], -1), torch.zeros_like(val[:, 0, 0]),
           torch.full_like(pos[:, 0, 0], -1), torch.zeros_like(val[:, 0, 0]))
    out_pos, out_val = torch.empty_like(pos), torch.empty_like(val)
    order = range(ntiles - 1, -1, -1) if reverse else range(ntiles)
    for k in order:
        out_pos[:, k, 0], out_val[:, k, 0] = acc[0], acc[1]
        out_pos[:, k, 1], out_val[:, k, 1] = acc[2], acc[3]
        t = (pos[:, k, 0], val[:, k, 0], pos[:, k, 1], val[:, k, 1])
        acc = combine(t, acc) if reverse else combine(acc, t)
    return out_pos, out_val, acc


def stop_flags(nex, carry: SiftCarry | None, trip: int, max_iteration: int):
    """The sift's stop decision for this trip (``decomp/itd.py:520-522``);
    updates ``carry`` in place and returns the flag bits."""
    if carry is None:
        return torch.zeros_like(nex)
    done = carry.done != 0
    stop_a = ~done & (nex < 2)
    stop_b = (~done & ~stop_a) if trip >= max_iteration + 1 \
        else torch.zeros_like(done)
    cont = ~done & ~stop_a & ~stop_b
    stopping = stop_a | stop_b
    carry.ncomp.copy_(torch.where(stopping, trip + 1, carry.ncomp))
    carry.reason.copy_(torch.where(stop_a, 1, torch.where(stop_b, 2,
                                                          carry.reason)))
    carry.done.copy_((done | stopping).to(torch.int32))
    return (stop_a.to(torch.int32) * STOP_A + stop_b.to(torch.int32) * STOP_B
            + cont.to(torch.int32) * CONT)


def tile_scan(summ: TileSummaries, carry: SiftCarry | None = None,
              trip: int = 0, max_iteration: int = 0, totals: bool = False,
              edges_from: torch.Tensor | None = None,
              shard: ShardArgs | None = None):
    """Plain version of the ``tile_scan`` kernel: the :class:`LevelStates`,
    and with ``totals`` also the rows' :class:`ShardTotals`.  With
    ``edges_from`` (the (rows, n) signal) ``summ`` covers the tiles'
    interiors and is completed with their first and last samples first
    (:func:`complete_summaries`; with ``shard``, of time shards)."""
    if edges_from is not None:
        summ = complete_summaries(summ, edges_from, shard)
    fpos, fval, ft = _exclusive(summ.fpos, summ.fval, _fwd_combine, False)
    rpos, rval, rt = _exclusive(summ.rpos, summ.rval, _rev_combine, True)
    nex = (summ.cnt.sum(-1) - 2).to(torch.int32)
    flags = stop_flags(nex, carry, trip, max_iteration)
    states = LevelStates(nex, flags, fpos, fval, rpos, rval)
    if not totals:
        return states
    return states, ShardTotals(
        torch.stack([ft[0], ft[2]], -1), torch.stack([ft[1], ft[3]], -1),
        torch.stack([rt[0], rt[2]], -1), torch.stack([rt[1], rt[3]], -1))


def level_states(x: torch.Tensor, carry: SiftCarry | None = None,
                 trip: int = 0, max_iteration: int = 0) -> LevelStates:
    """Plain version of one trip's pre-pass (the counterpart of
    ``level_block_states_fwd``): summaries, then the tile scan."""
    return tile_scan(level_summaries(x), carry, trip, max_iteration)


def emit_row(rotation, baseline, prev_base, pending_err, comp, stop_a,
             stop_b, cont):
    """The sift's output row and compensation update for the previous
    extraction's outputs (``decomp/itd.py:247-267``): the rotation while
    running, the stop-A residual ``prev_base``, the stop-B residual
    ``rotation + baseline``; the pending rotation's rounding residual joins
    the compensation when it is emitted, and stop B's addition rounds once
    more.  The stop masks broadcast against the samples."""
    res_sum = rotation + baseline
    residual = torch.where(stop_a, prev_base, res_sum)
    row = torch.where(stop_a | stop_b, residual,
                      torch.where(cont, rotation, torch.zeros_like(rotation)))
    res_err = two_sum_err(rotation, baseline, res_sum)
    comp = comp + torch.where(cont | stop_b, pending_err, 0.0) + torch.where(
        stop_b, res_err, 0.0)
    return row, comp


def sift_level(x: torch.Tensor, states: LevelStates, *,
               endpoint_mode: str = "reference", rotp=None, pbase=None,
               perr=None, comp=None, out_row=None,
               shard: ShardArgs | None = None, emit: bool = False) -> LevelOut:
    """Plain version of the ``sift_level`` kernel: tile-local fills seeded
    from ``states``, the epilogue in the order of the gather form, and,
    when ``rotp`` is given, the bookkeeping (row into ``out_row``).  With
    ``emit`` also the baseline's :func:`interior_summaries`.  With
    ``shard`` the rows are time shards: positions are global, the seeds
    take in the knots of the shards before and after, and the end-knot
    values are the global ones; ``emit`` then also leaves out each shard's
    last sample."""
    rows, n = x.shape
    nt = _ntiles(n)
    m, pos, _, ng = _shard_frame(x, shard, nt)
    xt = _tiled(x, 0.0, nt)
    tbase = pos[..., :1]
    big = _FAR

    def xval(p):  # value at an in-tile position
        return torch.gather(xt, -1, (p - tbase).clamp(0, TILE - 1))

    fseed = (states.fpos[..., 0], states.fval[..., 0],
             states.fpos[..., 1], states.fval[..., 1])
    rseed = (states.rpos[..., 0], states.rval[..., 0],
             states.rpos[..., 1], states.rval[..., 1])
    if shard is not None:  # farther than any of the shard's own knots
        fseed = _fwd_combine(
            (shard.pre_pos[:, :1], shard.pre_val[:, :1],
             shard.pre_pos[:, 1:], shard.pre_val[:, 1:]), fseed)
        rseed = _rev_combine(
            rseed, (shard.suf_pos[:, :1], shard.suf_val[:, :1],
                    shard.suf_pos[:, 1:], shard.suf_val[:, 1:]))
    sp1, sv1, sp2, sv2 = (a[..., None] for a in fseed)
    sq1, sw1, sq2, sw2 = (a[..., None] for a in rseed)
    sp1, sp2, sq1, sq2 = sp1.long(), sp2.long(), sq1.long(), sq2.long()

    # last two knots at or before t
    f1 = torch.cummax(torch.where(m, pos, -1), -1).values
    f1x = torch.cat([torch.full_like(f1[..., :1], -1), f1[..., :-1]], -1)
    f2 = torch.gather(f1x, -1, (f1 - tbase).clamp(0, TILE - 1))
    in1 = f1 >= 0
    in2 = in1 & (f2 >= 0)
    p1 = torch.where(in1, f1, sp1)
    v1 = torch.where(in1, xval(f1), sv1)
    p2 = torch.where(in2, f2, torch.where(in1, sp1, sp2))
    v2 = torch.where(in2, xval(f2), torch.where(in1, sv1, sv2))

    # first two knots strictly after t
    r1 = torch.cummin(torch.where(m, pos, big).flip(-1), -1).values.flip(-1)
    r1x = torch.cat([r1[..., 1:], torch.full_like(r1[..., :1], big)], -1)
    r2 = torch.gather(r1x, -1, (r1x - tbase).clamp(0, TILE - 1))
    jn1 = r1x < big
    jn2 = jn1 & (r2 < big)
    q1 = torch.where(jn1, r1x, sq1)
    w1 = torch.where(jn1, xval(r1x), sw1)
    q2 = torch.where(jn2, r2, torch.where(jn1, sq1, sq2))
    w2 = torch.where(jn2, xval(r2), torch.where(jn1, sw1, sw2))

    # the sample after the signal's last does not exist: the gather form
    # clips to the last
    last = pos == ng - 1
    q1 = torch.where(last, ng - 1, q1)
    w1 = torch.where(last, xt, w1)

    if shard is None:
        b_first = 0.5 * (x[:, 0] + x[:, 1])
        b_last = 0.5 * (x[:, n - 2] + x[:, n - 1])
    else:
        b_first, b_last = shard.b_first, shard.b_last
    b_first, b_last = b_first[:, None, None], b_last[:, None, None]
    b_l = torch.where(p1 == ng - 1, b_last, torch.where(
        p1 == 0, b_first, knot_value(p1, v1, p2, v2, q1, w1)))
    b_r = torch.where(q1 == ng - 1, b_last,
                      knot_value(q1, w1, p1, v1, q2, w2))
    baseline = interp(xt, pos, ng, b_l, v1, b_r, w1, endpoint_mode)
    baseline = baseline.reshape(rows, -1)[:, :n].contiguous()

    rotation = x - baseline
    out = LevelOut(baseline, rotation, two_sum_err(x, -baseline, rotation),
                   None, interior_summaries(baseline, shard) if emit else None)
    if rotp is None:
        return out
    f = states.flags[:, None]
    row, comp = emit_row(rotp, x, pbase, perr, comp, (f & STOP_A) != 0,
                         (f & STOP_B) != 0, (f & CONT) != 0)
    out_row.copy_(row)
    return out._replace(comp=comp)


def fill2(vals: torch.Tensor, mask: torch.Tensor, reverse: bool = False,
          strict: bool = False):
    """Plain version of the ``fill2`` kernel: per sample, ``(p1, v1, p2,
    v2)``, the int32 positions and the values of the last two marked
    samples at or before it (``reverse``: the first two at or after it;
    ``strict``: strictly before / after), nearest first; 0 where fewer
    marks exist.  ``strict`` equals JAX's call on inputs shifted by one
    (``linear_baseline.py:391-393``)."""
    pos = torch.arange(vals.shape[-1], dtype=torch.int32,
                       device=vals.device).expand(vals.shape)
    fill = backward_fill2_scan if reverse else forward_fill2_scan
    (p1, v1), (p2, v2), _ = fill((pos, vals), mask, (0, 0.0))
    out = (p1, v1, p2, v2)
    if strict:  # the non-strict fill of the previous sample in scan order
        shift = shift_left if reverse else shift_right
        out = tuple(shift(o, 0) for o in out)
    return out


def linear_fill2(x: torch.Tensor, reverse: bool = False):
    """Plain version of the ``linear_fill2`` kernel: :func:`fill2` of ``x``
    under its knot mask (``linear_baseline.knot_mask``: the extrema of
    ``ops/extrema.py`` and both endpoints), inclusive."""
    return fill2(x, knot_mask(x), reverse)


def fillv(vals: torch.Tensor, mask: torch.Tensor, reverse: bool = False):
    """Plain version of the ``fillv`` kernel: per sample, the value of the
    last marked sample at or before it (``reverse``: the first at or after
    it); 0 where none."""
    fill = backward_fill_scan if reverse else forward_fill_scan
    return fill((vals,), mask, (0.0,))[0]


def _segsum64(v: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Forward segmented sums of one channel in f64: differences of running
    sums of the finite terms, with NaN and infinities placed where an f32
    sum of the segment would hold them."""
    start = prev_index(flags).clamp(min=0)  # each sample's segment start

    def seg(a):  # sum of a over [start, t]
        c = torch.cumsum(a, -1)
        c = torch.cat([torch.zeros_like(c[..., :1]), c], -1)
        return c[..., 1:] - torch.gather(c, -1, start)

    s = seg(torch.where(torch.isfinite(v), v, 0).double())
    nan = seg(torch.isnan(v).long()) > 0
    pinf = seg((v == math.inf).long()) > 0
    ninf = seg((v == -math.inf).long()) > 0
    s = torch.where(pinf, math.inf, torch.where(ninf, -math.inf, s))
    return torch.where(nan | (pinf & ninf), math.nan, s)


def segsum(vals, flags: torch.Tensor, reverse: bool = False,
           strict: bool = False):
    """Plain version of the ``segsum`` kernel: per channel, ``out[t] = v[t]
    + (flags[t] ? 0 : out[t-1])`` (``reverse``: with ``t+1``), each segment
    summed in f64 and rounded once.  With ``strict`` the result at ``t`` is
    that recurrence's value at the previous sample in scan order (0 at the
    first), which equals JAX's call on values and flags shifted by one
    (``linear_baseline.py:409-425``).  ``vals`` is a tensor or a tuple of
    them; the result has the same form."""
    chans = (vals,) if isinstance(vals, torch.Tensor) else tuple(vals)

    def one(v):
        if reverse:
            out = _segsum64(v.flip(-1), flags.flip(-1)).flip(-1).to(v.dtype)
        else:
            out = _segsum64(v, flags).to(v.dtype)
        if strict:
            out = (shift_left if reverse else shift_right)(out, 0.0)
        return out

    out = tuple(one(v) for v in chans)
    return out[0] if isinstance(vals, torch.Tensor) else out


def segsum_depth(n: int) -> int:
    """The most f32 additions a term passes through in the ``segsum``
    kernel on rows of ``n`` samples (``csrc/fill_segsum.cu``): 4 in the
    fold of its chunk of 4 samples, 5 in the warp scan of its chunk set,
    one per further chunk set of its thread, ``log2(SCAN_THREADS / 32)``
    across the warps, 5 in the fold of a look-back window of 32 tile
    aggregates, one per window walked, two where the prefixes seed a chunk,
    4 in the chunk's walk.  A row that starts off a 16-byte boundary is
    tiled from that boundary, up to 3 samples before it."""
    windows = math.ceil((_ntiles(n + 3) - 1) / 32)
    return 19 + SCAN_RUN // 4 + int(math.log2(SCAN_THREADS // 32)) + windows


def segsum_error_bound(v: torch.Tensor, flags: torch.Tensor,
                       reverse: bool = False,
                       strict: bool = False) -> torch.Tensor:
    """Per-sample bound on ``|segsum_cuda(v) - segsum(v)|`` for one f32
    channel, in f64: ``(d + 2) * 2^-24 * m + 3 * n * 2^-53 * M``.

    ``d = segsum_depth(n)`` is the most f32 additions a term passes through
    in the kernel, so its sum differs from the exact one by at most ``d *
    2^-24`` (to first order) times ``m``, the sum of ``|v|`` over the
    segment up to the sample; the plain version's rounding adds ``2^-24 *
    m`` and its f64 running sums ``2 * n * 2^-53`` times ``M``, the sum of
    ``|v|`` over the row up to the sample in scan order.  With ``strict``
    both sums end at the previous sample in scan order.  Where the sum is
    not finite the two must agree exactly; the bound there is
    meaningless."""
    a = torch.where(torch.isfinite(v), v.abs(), 0).double()
    if reverse:
        a, flags = a.flip(-1), flags.flip(-1)
    m, mm = _segsum64(a, flags), torch.cumsum(a, -1)
    if strict:
        m, mm = shift_right(m, 0.0), shift_right(mm, 0.0)
    if reverse:
        m, mm = m.flip(-1), mm.flip(-1)
    n = v.shape[-1]
    return (segsum_depth(n) + 2) * 2.0 ** -24 * m + 3 * n * 2.0 ** -53 * mm


def bwd_knots(x: torch.Tensor):
    """Plain version of the ``bwd_knots`` kernel: the knot mask of ``x``
    (``linear_baseline.knot_mask``) and its one-left shift, ``False`` at
    each row's last sample (a segment boundary sits between a knot and its
    neighbour, so the reverse segment sums reset where the next sample is a
    knot)."""
    knots = knot_mask(x)
    return knots, shift_left(knots, False)


def trip_cotangents(g_rot, g_base, g_err, trip: TripCotangents,
                    like: torch.Tensor):
    """The output cotangents ``(g_rot, g_base, g_err)`` of level ``j`` in
    the kernel sift's reverse trip loop, and the zero path's term (``None``
    but at level 0), from the sift's output cotangents
    (:class:`TripCotangents`; ``like`` the (rows, n) level input).  The sift writes row ``j`` from
    ``r_j``, ``b_j``, ``e_j`` and ``prev = b_{j-1}`` under trip ``j``'s
    flags (``emit_row``); per row that gives

    * ``g_r = G_j`` under ``CONT``, ``Gc + (G_j - Gc)`` under ``STOP_B``;
    * ``g_e = Gc`` under ``CONT`` or ``STOP_B``;
    * ``g_b``: ``Gc + (G_j - Gc)`` under ``STOP_B``, plus ``G_{j+1}`` under
      trip ``j + 1``'s ``STOP_A``, plus ``Gb_j`` under ``CONT``, plus the
      next level's input gradient;

    0 elsewhere.  ``Gc + (G_j - Gc)`` is what autograd of ``emit_row``
    gives a stop-B row: ``G_j - Gc`` through the residual's sum, ``Gc``
    through the two-sum residual's own operands, whose adjoint is an exact
    zero for a finite ``Gc`` and NaN for an infinite one.  On finite data a
    row gets at most two nonzero terms in ``g_b``, so no order of
    additions rounds otherwise.  The zero path: the sift's ``x * 0`` feeds
    trip 0's ``prev_base`` and the compensation (and, with no baselines
    stored, the baselines' one row), so level 0's gradient also takes
    ``(Gc + [STOP_A] G_0 (+ g_zero)) * 0``: 0 on finite cotangents, NaN
    where one is not.  Each mask is a select, never a product, so a
    non-finite cotangent reaches only the rows that read it."""
    zeros = torch.zeros_like(like)
    f = trip.flags[:, None]
    cont, stop_b = (f & CONT) != 0, (f & STOP_B) != 0
    g = zeros if g_rot is None else g_rot
    c = zeros if g_err is None else g_err
    sb = c + (g - c)
    gr = torch.where(cont, g, torch.where(stop_b, sb, zeros))
    ge = torch.where(cont | stop_b, c, zeros)
    gb = torch.where(stop_b, sb, zeros)
    if trip.g_next is not None:
        gb = gb + torch.where((trip.flags_next[:, None] & STOP_A) != 0,
                              trip.g_next, zeros)
    if g_base is not None:
        gb = gb + torch.where(cont, g_base, zeros)
    if trip.carry is not None:
        gb = gb + trip.carry
    zt = None
    if trip.zero:
        z = c + torch.where((f & STOP_A) != 0, g, zeros)
        if trip.g_zero is not None:
            z = z + trip.g_zero
        zt = z * 0.0
    return gr, gb, ge, zt


def bwd_pre(x: torch.Tensor, g_rot: torch.Tensor | None,
            g_base: torch.Tensor | None, g_err: torch.Tensor | None, fwd,
            bwd, endpoint_mode: str = "reference",
            trip: TripCotangents | None = None):
    """Plain version of the ``bwd_pre`` kernel: the level adjoint's work
    between the fills and the segment sums (port of JAX's
    ``_structural_level_bwd``, in its order of operations).  ``fwd`` is
    ``fill2(x, knots)``, ``bwd`` ``fill2(x, knots, reverse=True,
    strict=True)``; returns the four cotangent channels ``(a_bl, a_xl,
    a_br, a_xr)``, non-finite terms dropped, and the gradient's direct term
    (its NaNs kept).  With ``trip`` (``x`` then (rows, n)) the cotangents
    are the sift's, each may be ``None``, and the level's own are formed
    first (:func:`trip_cotangents`); the zero path's term joins the direct
    term."""
    zt = None
    if trip is not None:
        g_rot, g_base, g_err, zt = trip_cotangents(g_rot, g_base, g_err,
                                                   trip, x)
    n = x.shape[-1]
    it = torch.arange(n, device=x.device).expand(x.shape)
    p1p, p1x, p2p, p2x = fwd
    n1p, n1x, n2p, n2x = bwd

    b_first = (0.5 * (x[..., 0] + x[..., 1]))[..., None]
    b_last = (0.5 * (x[..., n - 2] + x[..., n - 1]))[..., None]
    bl = torch.where(p1p == 0, b_first,
                     knot_value(p1p, p1x, p2p, p2x, n1p, n1x))
    bl = torch.where(p1p == n - 1, b_last, bl)
    br = torch.where(n1p == n - 1, b_last,
                     knot_value(n1p, n1x, p1p, p1x, n2p, n2x))

    xl, xr = p1x, n1x
    d = xr - xl
    dz = d == 0
    safe = torch.where(dz, torch.ones_like(d), d)
    zero = torch.zeros_like(d)
    s = torch.where(dz, zero, (br - bl) / safe)

    # err's coefficients are exactly (+x, -rot, -baseline)
    geff_rot = g_rot - g_err
    geff_base = g_base - g_err
    g_b = geff_base - geff_rot
    if endpoint_mode == "reference":
        g_b = torch.where(it == n - 1, torch.zeros_like(g_b), g_b)

    q = torch.where(dz, zero, (x - xl) / safe)
    coef = torch.where(dz, zero, (br - bl) / (safe * safe))
    a_bl = g_b * torch.where(dz, torch.ones_like(q), 1.0 - q)
    a_br = g_b * q
    a_xl = g_b * coef * (x - xr)
    a_xr = -g_b * coef * (x - xl)

    gx = geff_rot + g_err + g_b * s  # direct dB/dx[t] = slope
    if zt is not None:
        gx = gx + zt

    # Non-finite terms (only inside a NaN quarantine zone, where the
    # gradient is undefined anyway) are dropped: a running sum would carry
    # one NaN into every position after it, where autograd keeps it to the
    # samples involved.  The direct per-sample terms keep their NaNs.
    a_bl, a_xl, a_br, a_xr = (torch.where(torch.isfinite(z), z, 0.0)
                              for z in (a_bl, a_xl, a_br, a_xr))
    return a_bl, a_xl, a_br, a_xr, gx


def bwd_post(knots: torch.Tensor, gx: torch.Tensor, seg_a, seg_e,
             p2p: torch.Tensor, n1p: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``bwd_post`` kernel: the level adjoint's work
    after the segment sums.  ``seg_a`` is ``segsum((a_bl, a_xl), f_next,
    reverse=True)`` (sums over ``[t, nextknot)``), ``seg_e``
    ``segsum((a_br, a_xr), knots, strict=True)`` (over ``[prevknot, t)``),
    ``gx`` the direct term, ``p2p`` and ``n1p`` the fills' previous and
    next knots; returns the x cotangent."""
    n = knots.shape[-1]
    it = torch.arange(n, device=knots.device).expand(knots.shape)
    (seg_a_bl, seg_a_xl), (seg_e_br, seg_e_xr) = seg_a, seg_e
    gkv = torch.where(knots, seg_a_bl + seg_e_br, 0.0)
    gx = gx + torch.where(knots, seg_a_xl + seg_e_xr, 0.0)

    # knot-value adjoint.  Interior knots: kv = 0.5*(x[pe] + w*(x[nx] -
    # x[pe])) + 0.5*x[t]; at a knot site pe = p2p, nx = n1p.
    span = (n1p - p2p).to(gx.dtype)
    w = (it - p2p).to(gx.dtype) / torch.where(span == 0,
                                              torch.ones_like(span), span)
    interior = knots & (it != 0) & (it != n - 1)
    gkv_int = torch.where(interior, gkv, torch.zeros_like(gkv))
    gx = gx + 0.5 * gkv_int

    # pushes: x[pe(k)] += c_p(k); x[nx(k)] += c_n(k).  Every knot is the
    # previous knot of exactly its next knot (and vice versa), so a knot
    # receives the c_p of its next knot and the c_n of its previous one:
    # gathers at the fills' n1p and p2p (none past the row's ends)
    c_p = gkv_int * (0.5 * (1.0 - w))
    c_n = gkv_int * (0.5 * w)
    nxt = torch.where(it == n - 1, 0.0, torch.gather(c_p, -1, n1p.long()))
    prv = torch.where(it == 0, 0.0, torch.gather(c_n, -1, p2p.long()))
    gx = gx + torch.where(knots, nxt + prv, 0.0)

    # end knots: kv[0] = 0.5*(x[0]+x[1]); kv[n-1] = 0.5*(x[n-2]+x[n-1])
    g0 = 0.5 * gkv[..., 0]
    gl = 0.5 * gkv[..., n - 1]
    for i, g in ((0, g0), (1, g0), (n - 2, gl), (n - 1, gl)):
        gx[..., i] += g
    return gx


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


# the kernels' library once loaded and checked, and its scan scratch's
# header and per-(row, tile) descriptor bytes
_LIB = None
_SCAN_BYTES = (0, 0)


def _lib():
    """The kernels' library.  The first call builds and loads it and
    compares its build constants with this module's ``TILE``,
    ``SCAN_THREADS``, ``SCAN_RUN`` and ``cuda_cubic``'s ``SPIKE_BLK``,
    ``SPIKE_RUN`` (a library that disagrees is refused and never kept);
    later calls return it and ask it nothing."""
    global _LIB, _SCAN_BYTES
    if _LIB is None:
        from . import cuda_cubic
        from ._build import load_library

        lib = load_library()
        for src, size in (("sift_level", lib.pyitd_tile_size()),
                          ("fill_segsum", lib.pyitd_scan_tile_size())):
            if size != TILE:
                raise RuntimeError(f"csrc/{src}.cu tiles by {size}, "
                                   f"cuda_fill.TILE is {TILE}")
        shape = (lib.pyitd_scan_threads(), lib.pyitd_scan_run_length())
        if shape != (SCAN_THREADS, SCAN_RUN):
            raise RuntimeError(f"csrc/fill_segsum.cu runs (threads, samples "
                               f"per thread) {shape}, cuda_fill has "
                               f"{(SCAN_THREADS, SCAN_RUN)}")
        cuda_cubic._check_build(lib)
        _SCAN_BYTES = (lib.pyitd_scan_header_bytes(),
                       lib.pyitd_scan_desc_bytes())
        _LIB = lib
    return _LIB


def _launch(name: str, device: torch.device, *args,
            counts: dict = LAUNCHES) -> None:
    """Launch the library's ``pyitd_<name>`` with ``args`` and PyTorch's
    current stream on ``device``, under that device's guard; raise on the
    launch's error code; count the launch in ``counts[name]`` (the calling
    module's ``LAUNCHES``, this module's by default)."""
    lib = _lib()
    with torch.cuda.device(device):
        code = getattr(lib, "pyitd_" + name)(*args, _stream(device))
    if code != 0:
        msg = lib.pyitd_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")
    counts[name] += 1


def _check_signal(x: torch.Tensor, shard: ShardArgs | None = None,
                  seeds: bool = False) -> None:
    """Refuse what the sift kernels do not take; with ``shard`` the rows
    are time shards (``seeds``: with the ``sift_level`` fields)."""
    if x.dim() != 2:
        raise ValueError(f"expected a (rows, n) signal, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"the sift kernels take float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the sift kernels need a contiguous signal")
    rows, n = x.shape
    length = n if shard is None else shard.n_global
    if length < 2 or n < 1:
        raise ValueError(f"a signal needs at least 2 samples (got n={length}"
                         f", {n} in a row)")
    if x.is_cuda and not 0 < rows <= 65535:
        raise ValueError(f"the sift kernels take 1..65535 rows, got {rows}")
    if max(n, length) > 2**31 - 1 - TILE:  # int32 positions in the kernels
        raise ValueError(f"the sift kernels take n < 2^31 - {TILE + 1}, "
                         f"got {max(n, length)}")
    if shard is None:
        return
    _same(x, shard.offset, dtype=torch.int32, shape=(rows,))
    _same(x, shard.halo_l, shard.halo_r, dtype=torch.float32, shape=(rows,))
    if seeds:
        _same(x, shard.b_first, shard.b_last, dtype=torch.float32,
              shape=(rows,))
        _same(x, shard.pre_pos, shard.suf_pos, dtype=torch.int32,
              shape=(rows, 2))
        _same(x, shard.pre_val, shard.suf_val, dtype=torch.float32,
              shape=(rows, 2))


def _same(x: torch.Tensor, *tensors, dtype=None, shape=None) -> None:
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, signal on {x.device}")
        if not t.is_contiguous():
            raise ValueError("the sift kernels need contiguous tensors")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"expected {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"expected shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


@spanned("pyitd.level_summaries")
def level_summaries_cuda(x: torch.Tensor,
                         shard: ShardArgs | None = None) -> TileSummaries:
    """Per-tile knot summaries of ``x`` (rows, n) f32; with ``shard`` of
    rows that are time shards (``offset``, ``halo_l``, ``halo_r``,
    ``n_global``)."""
    _check_signal(x, shard)
    if not x.is_cuda:
        return level_summaries(x, shard)
    rows, n = x.shape
    sh = (0, None, None, None) if shard is None else (
        shard.n_global, shard.offset.data_ptr(), shard.halo_l.data_ptr(),
        shard.halo_r.data_ptr())
    nt = _ntiles(n)
    pos = torch.empty((2, rows, nt, 2), dtype=torch.int32, device=x.device)
    val = torch.empty((2, rows, nt, 2), dtype=torch.float32, device=x.device)
    cnt = torch.empty((rows, nt), dtype=torch.int32, device=x.device)
    _launch("level_summaries", x.device, x.data_ptr(), rows, n, nt, *sh,
            pos[0].data_ptr(), val[0].data_ptr(), pos[1].data_ptr(),
            val[1].data_ptr(), cnt.data_ptr())
    return TileSummaries(pos[0], val[0], pos[1], val[1], cnt)


@spanned("pyitd.tile_scan")
def tile_scan_cuda(summ: TileSummaries, carry: SiftCarry | None = None,
                   trip: int = 0, max_iteration: int = 0,
                   totals: bool = False,
                   edges_from: torch.Tensor | None = None,
                   shard: ShardArgs | None = None):
    """Exclusive per-tile seeds, extrema counts and (with ``carry``) the
    trip's stop flags; ``carry`` is updated in place.  With ``totals`` the
    result is ``(LevelStates, ShardTotals)``: also each row's last two and
    first two knots.  With ``edges_from``, the (rows, n) f32 signal,
    ``summ`` holds its tiles' interior summaries (``sift_level_cuda(...,
    emit=True).interior``) and every tile's first and last sample is
    tested here; with ``shard`` too (``offset``, ``halo_l``, ``halo_r``,
    ``n_global`` of ``edges_from``'s rows, which are time shards) also each
    shard's last sample."""
    rows, nt = summ.cnt.shape
    ref = summ.fval
    _same(ref, summ.fpos, summ.rpos, summ.cnt, dtype=torch.int32)
    _same(ref, summ.fval, summ.rval, dtype=torch.float32, shape=(rows, nt, 2))
    if carry is not None:
        _same(ref, *carry, dtype=torch.int32, shape=(rows,))
    if shard is not None and edges_from is None:
        raise ValueError("shard completes summaries: it needs edges_from")
    n, sh = 0, (0, None, None, None)
    if edges_from is not None:
        _check_signal(edges_from, shard)
        n = edges_from.shape[1]
        _same(ref, edges_from, shape=(rows, n))
        if _ntiles(n) != nt:
            raise ValueError(f"summaries of {nt} tiles for rows of {n}")
        if shard is not None:
            sh = (shard.n_global, shard.offset.data_ptr(),
                  shard.halo_l.data_ptr(), shard.halo_r.data_ptr())
    if not ref.is_cuda:
        return tile_scan(summ, carry, trip, max_iteration, totals, edges_from,
                         shard)
    pos = torch.empty((2, rows, nt, 2), dtype=torch.int32, device=ref.device)
    val = torch.empty((2, rows, nt, 2), dtype=torch.float32, device=ref.device)
    tpos = tval = None
    if totals:
        tpos = torch.empty((2, rows, 2), dtype=torch.int32, device=ref.device)
        tval = torch.empty((2, rows, 2), dtype=torch.float32,
                           device=ref.device)
    tot = (None,) * 4 if not totals else (
        tpos[0].data_ptr(), tval[0].data_ptr(), tpos[1].data_ptr(),
        tval[1].data_ptr())
    nex = torch.empty(rows, dtype=torch.int32, device=ref.device)
    flags = torch.empty(rows, dtype=torch.int32, device=ref.device)
    done, reason, ncomp = (None, None, None) if carry is None else (
        t.data_ptr() for t in carry)
    _launch("tile_scan", ref.device, rows, nt, summ.fpos.data_ptr(),
            summ.fval.data_ptr(), summ.rpos.data_ptr(), summ.rval.data_ptr(),
            summ.cnt.data_ptr(), _ptr(edges_from), n, *sh,
            pos[0].data_ptr(), val[0].data_ptr(), pos[1].data_ptr(),
            val[1].data_ptr(), nex.data_ptr(), flags.data_ptr(), done,
            reason, ncomp, trip, max_iteration, *tot)
    MODE_LAUNCHES["tile_scan_edges"] += edges_from is not None
    MODE_LAUNCHES["tile_scan_shard_edges"] += shard is not None
    states = LevelStates(nex, flags, pos[0], val[0], pos[1], val[1])
    if not totals:
        return states
    return states, ShardTotals(tpos[0], tval[0], tpos[1], tval[1])


def level_states_cuda(x: torch.Tensor, carry: SiftCarry | None = None,
                      trip: int = 0, max_iteration: int = 0) -> LevelStates:
    """One trip's pre-pass: ``level_summaries_cuda``, then
    ``tile_scan_cuda``."""
    return tile_scan_cuda(level_summaries_cuda(x), carry, trip, max_iteration)


@spanned("pyitd.sift_level")
def sift_level_cuda(x: torch.Tensor, states: LevelStates, *,
                    endpoint_mode: str = "reference", rotp=None, pbase=None,
                    perr=None, comp=None, out_row=None,
                    shard: ShardArgs | None = None,
                    emit: bool = False) -> LevelOut:
    """One extraction of ``x`` (rows, n) f32 seeded by ``states``.  With
    ``rotp`` (and ``pbase``, ``perr``, ``comp``, ``out_row``, all (rows, n)
    f32) it also writes the previous extraction's output row into
    ``out_row`` and returns the updated compensation.  With ``shard`` (every
    field set) the rows are time shards and ``states`` the seeds from the
    shard's own tiles.  With ``emit`` the result's ``interior`` holds the
    baseline's summaries over each tile's interior (on time shards without
    each shard's last sample), for ``tile_scan_cuda(...,
    edges_from=baseline, shard=...)``."""
    if endpoint_mode not in ("reference", "natural"):
        raise ValueError(f"unknown endpoint_mode: {endpoint_mode!r}")
    _check_signal(x, shard, seeds=True)
    rows, n = x.shape
    nt = _ntiles(n)
    book = rotp is not None
    _same(x, states.fpos, states.rpos, dtype=torch.int32, shape=(rows, nt, 2))
    _same(x, states.fval, states.rval, dtype=torch.float32,
          shape=(rows, nt, 2))
    if book:
        _same(x, states.flags, dtype=torch.int32, shape=(rows,))
        _same(x, rotp, pbase, perr, comp, out_row, dtype=torch.float32,
              shape=(rows, n))
    if not x.is_cuda:
        return sift_level(x, states, endpoint_mode=endpoint_mode, rotp=rotp,
                          pbase=pbase, perr=perr, comp=comp, out_row=out_row,
                          shard=shard, emit=emit)
    base, rot, err = torch.empty((3, rows, n), dtype=torch.float32,
                                 device=x.device)
    comp_out = torch.empty_like(x) if book else None
    interior, ipt = None, (None,) * 5
    if emit:
        ipos = torch.empty((2, rows, nt, 2), dtype=torch.int32,
                           device=x.device)
        ival = torch.empty((2, rows, nt, 2), dtype=torch.float32,
                           device=x.device)
        icnt = torch.empty((rows, nt), dtype=torch.int32, device=x.device)
        interior = TileSummaries(ipos[0], ival[0], ipos[1], ival[1], icnt)
        ipt = tuple(t.data_ptr() for t in interior)
    sh = (0,) + (None,) * 9 if shard is None else (
        shard.n_global,) + tuple(t.data_ptr() for t in shard[1:])
    _launch("sift_level", x.device, x.data_ptr(), rows, n, nt,
            states.fpos.data_ptr(), states.fval.data_ptr(),
            states.rpos.data_ptr(), states.rval.data_ptr(),
            _ptr(states.flags if book else None), _ptr(rotp), _ptr(pbase),
            _ptr(perr), _ptr(comp), base.data_ptr(), rot.data_ptr(),
            err.data_ptr(), _ptr(out_row), _ptr(comp_out), int(book),
            int(endpoint_mode == "reference"), *sh, *ipt)
    MODE_LAUNCHES["sift_level_book"] += book
    MODE_LAUNCHES["sift_level_emit"] += emit
    MODE_LAUNCHES["sift_level_shard_emit"] += emit and shard is not None
    return LevelOut(base, rot, err, comp_out, interior)


def _check_scan(chans, flags: torch.Tensor | None) -> None:
    x = chans[0]
    if x.dim() != 2:
        raise ValueError(f"expected (rows, n) channels, got {tuple(x.shape)}")
    _same(x, *chans, dtype=torch.float32, shape=x.shape)
    if flags is not None:
        _same(x, flags, dtype=torch.bool, shape=x.shape)
    rows, n = x.shape
    if rows < 1 or n < 1:
        raise ValueError(f"the scan kernels take non-empty rows, got "
                         f"{tuple(x.shape)}")
    if rows * _ntiles(n + 3) > 2**31 - 1 or n > 2**31 - 1 - 2 * TILE:
        raise ValueError(f"the scan kernels take rows * ceil((n + 3) / "
                         f"{TILE}) < 2^31, got {tuple(x.shape)}")


# the scan kernels' scratch by (device index, stream)
_SCAN_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def _scan_scratch(x: torch.Tensor) -> torch.Tensor:
    """The look-back scan's scratch for ``x``'s device and the current
    stream: a header and one descriptor per (row, tile), as bytes.  Zeroed
    when it is allocated or grown and never again: each call leaves it
    ready for the next (``csrc/fill_segsum.cu``), and calls on one stream
    run one after the other."""
    rows, n = x.shape
    _lib()  # its first load sets _SCAN_BYTES
    header, desc = _SCAN_BYTES
    need = header + desc * rows * _ntiles(n + 3)
    key = (x.device.index, _stream(x.device))
    buf = _SCAN_SCRATCH.get(key)
    if buf is None or buf.numel() < need:
        grown = need if buf is None else max(need, 2 * buf.numel())
        buf = torch.zeros(grown, dtype=torch.uint8, device=x.device)
        _SCAN_SCRATCH[key] = buf
    return buf


@spanned("pyitd.fill2")
def fill2_cuda(vals: torch.Tensor, mask: torch.Tensor, reverse: bool = False,
               strict: bool = False):
    """``(p1, v1, p2, v2)`` of :func:`fill2` for ``vals`` (rows, n) f32 and
    ``mask`` (rows, n) bool; positions int32."""
    _check_scan((vals,), mask)
    if not vals.is_cuda:
        return fill2(vals, mask, reverse, strict)
    rows, n = vals.shape
    p1, p2 = (torch.empty((rows, n), dtype=torch.int32, device=vals.device)
              for _ in range(2))
    v1, v2 = torch.empty_like(vals), torch.empty_like(vals)
    _launch("fill2", vals.device, vals.data_ptr(), mask.data_ptr(), rows, n,
            int(reverse), int(strict), p1.data_ptr(), v1.data_ptr(),
            p2.data_ptr(), v2.data_ptr(), _scan_scratch(vals).data_ptr())
    return p1, v1, p2, v2


@spanned("pyitd.linear_fill2")
def linear_fill2_cuda(x: torch.Tensor, reverse: bool = False):
    """``(p1, v1, p2, v2)`` of :func:`linear_fill2` for ``x`` (rows, n)
    f32, n >= 2; positions int32.  The knot mask is computed in the
    kernel."""
    _check_scan((x,), None)
    if x.shape[1] < 2:
        raise ValueError(f"a signal needs at least 2 samples (got "
                         f"n={x.shape[1]})")
    if not x.is_cuda:
        return linear_fill2(x, reverse)
    rows, n = x.shape
    p1, p2 = (torch.empty((rows, n), dtype=torch.int32, device=x.device)
              for _ in range(2))
    v1, v2 = torch.empty_like(x), torch.empty_like(x)
    _launch("linear_fill2", x.device, x.data_ptr(), rows, n, int(reverse),
            p1.data_ptr(), v1.data_ptr(), p2.data_ptr(), v2.data_ptr(),
            _scan_scratch(x).data_ptr())
    return p1, v1, p2, v2


@spanned("pyitd.fillv")
def fillv_cuda(vals: torch.Tensor, mask: torch.Tensor,
               reverse: bool = False) -> torch.Tensor:
    """:func:`fillv` of ``vals`` (rows, n) f32 and ``mask`` (rows, n)
    bool."""
    _check_scan((vals,), mask)
    if not vals.is_cuda:
        return fillv(vals, mask, reverse)
    rows, n = vals.shape
    out = torch.empty_like(vals)
    _launch("fillv", vals.device, vals.data_ptr(), mask.data_ptr(), rows, n,
            int(reverse), out.data_ptr(), _scan_scratch(vals).data_ptr())
    return out


@spanned("pyitd.segsum")
def segsum_cuda(vals, flags: torch.Tensor, reverse: bool = False,
                strict: bool = False):
    """:func:`segsum` of one or two (rows, n) f32 channels (a tensor or a
    tuple, returned in the same form) sharing ``flags`` (rows, n) bool."""
    chans = (vals,) if isinstance(vals, torch.Tensor) else tuple(vals)
    if len(chans) not in (1, 2):
        raise ValueError(f"segsum takes 1 or 2 channels, got {len(chans)}")
    _check_scan(chans, flags)
    x = chans[0]
    if not x.is_cuda:
        return segsum(vals, flags, reverse, strict)
    rows, n = x.shape
    nch = len(chans)
    outs = tuple(torch.empty_like(x) for _ in range(nch))
    second = (chans[1].data_ptr(), outs[1].data_ptr()) if nch == 2 \
        else (None, None)
    _launch("segsum", x.device, nch, x.data_ptr(), second[0],
            flags.data_ptr(), rows, n, int(reverse), int(strict),
            outs[0].data_ptr(), second[1], _scan_scratch(x).data_ptr())
    SEGSUM_LAUNCHES[nch] += 1
    return outs[0] if isinstance(vals, torch.Tensor) else outs


def _check_adjoint(x: torch.Tensor, floats=(), ints=(), masks=()) -> None:
    """Refuse what the adjoint kernels do not take: ``x`` a contiguous
    (rows, n) f32 signal with n >= 2, the other tensors contiguous on its
    device with its shape (f32, int32 positions, bool masks)."""
    if x.dim() != 2:
        raise ValueError(f"expected a (rows, n) signal, got {tuple(x.shape)}")
    rows, n = x.shape
    if n < 2 or rows < 1:
        raise ValueError(f"the adjoint kernels take rows of at least 2 "
                         f"samples, got {tuple(x.shape)}")
    if n > 2**31 - 1:
        raise ValueError(f"the adjoint kernels take n < 2^31, got {n}")
    _same(x, x, *floats, dtype=torch.float32, shape=x.shape)
    _same(x, *ints, dtype=torch.int32, shape=x.shape)
    _same(x, *masks, dtype=torch.bool, shape=x.shape)


@spanned("pyitd.bwd_knots")
def bwd_knots_cuda(x: torch.Tensor):
    """:func:`bwd_knots` of ``x`` (rows, n) f32: ``(knots, f_next)``,
    bool."""
    _check_adjoint(x)
    if not x.is_cuda:
        return bwd_knots(x)
    rows, n = x.shape
    knots = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    f_next = torch.empty_like(knots)
    _launch("bwd_knots", x.device, x.data_ptr(), rows, n, knots.data_ptr(),
            f_next.data_ptr())
    return knots, f_next


@spanned("pyitd.bwd_pre")
def bwd_pre_cuda(x: torch.Tensor, g_rot: torch.Tensor | None,
                 g_base: torch.Tensor | None, g_err: torch.Tensor | None,
                 fwd, bwd, endpoint_mode: str = "reference",
                 trip: TripCotangents | None = None):
    """:func:`bwd_pre` of ``x`` and the cotangents (rows, n) f32 and the two
    fills' ``(p1, v1, p2, v2)`` channels: ``(a_bl, a_xl, a_br, a_xr,
    gx)``.  With ``trip`` the cotangents are the kernel sift's (any may be
    ``None``: the kernel reads no stream for it) and the kernel forms the
    level's own from them."""
    if endpoint_mode not in ENDPOINT_MODES:
        raise ValueError(f"unknown endpoint_mode: {endpoint_mode!r}")
    cts = (g_rot, g_base, g_err)
    if trip is None and any(g is None for g in cts):
        raise ValueError("bwd_pre takes no absent cotangent without trip")
    _check_adjoint(x, tuple(g for g in cts if g is not None)
                   + (fwd[1], fwd[3], bwd[1], bwd[3]),
                   (fwd[0], fwd[2], bwd[0], bwd[2]))
    if trip is not None:
        _check_trip(x, trip)
    if not x.is_cuda:
        return bwd_pre(x, g_rot, g_base, g_err, fwd, bwd, endpoint_mode,
                       trip)
    rows, n = x.shape
    outs = tuple(torch.empty_like(x) for _ in range(5))
    t = trip or TripCotangents(None)
    _launch("bwd_pre", x.device, x.data_ptr(), *(_ptr(g) for g in cts),
            *(a.data_ptr() for a in fwd + bwd), rows, n,
            int(endpoint_mode == "reference"), _ptr(t.flags),
            _ptr(t.flags_next), _ptr(t.g_next), _ptr(t.carry),
            _ptr(t.g_zero), int(t.zero), *(o.data_ptr() for o in outs))
    return outs


def _check_trip(x: torch.Tensor, trip: TripCotangents) -> None:
    """Refuse a :class:`TripCotangents` that the ``bwd_pre`` kernel cannot
    take: per-row int32 flags, the next trip's flags and row cotangent
    together or neither, the zero path's term only at level 0."""
    rows, n = x.shape
    if trip.flags is None:
        raise ValueError("trip needs this trip's flags")
    _same(x, trip.flags, dtype=torch.int32, shape=(rows,))
    if (trip.flags_next is None) != (trip.g_next is None):
        raise ValueError("trip takes flags_next and g_next together")
    if trip.flags_next is not None:
        _same(x, trip.flags_next, dtype=torch.int32, shape=(rows,))
    if trip.g_zero is not None and not trip.zero:
        raise ValueError("g_zero is a term of level 0's zero path")
    _same(x, *(t for t in (trip.g_next, trip.carry, trip.g_zero)
               if t is not None), dtype=torch.float32, shape=(rows, n))


@spanned("pyitd.bwd_post")
def bwd_post_cuda(knots: torch.Tensor, gx: torch.Tensor, seg_a, seg_e,
                  p2p: torch.Tensor, n1p: torch.Tensor) -> torch.Tensor:
    """:func:`bwd_post` of the direct term ``gx`` and the segment sums
    (rows, n) f32, ``knots`` (bool) and the fills' ``p2p`` and ``n1p``
    (int32): the x cotangent."""
    _check_adjoint(gx, seg_a + seg_e, (p2p, n1p), (knots,))
    if not gx.is_cuda:
        return bwd_post(knots, gx, seg_a, seg_e, p2p, n1p)
    rows, n = gx.shape
    out = torch.empty_like(gx)
    _launch("bwd_post", gx.device, knots.data_ptr(), gx.data_ptr(),
            *(t.data_ptr() for t in seg_a + seg_e), p2p.data_ptr(),
            n1p.data_ptr(), rows, n, out.data_ptr())
    return out
