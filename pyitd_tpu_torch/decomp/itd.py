"""Canonical ITD sift — port of ``pyitd_tpu/decomp/itd.py``.

Per level, count the extrema of the current baseline:

* **stop A** (``num_extrema < 2``): the residual row is the previously
  stored baseline (the input of the most recent extraction); if the very
  first baseline is already flat the output is one zero row;
* **stop B** (trip ``> max_iteration``): the residual row is
  ``rotation + baseline``;
* otherwise store the rotation and descend into the baseline.

The loop runs ``max_iteration + 2`` trips (the most output rows there can
be); each trip writes row ``i`` with a per-row payload of rotation,
residual or zeros, so stopping is a per-row flag, not control flow.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import cuda_fill as cf
from ..ops.linear_baseline import (ENDPOINT_MODES,
                                   _structural_level_bwd_kernels,
                                   check_kernel_input,
                                   linear_baseline_extract,
                                   linear_baseline_extract_structural)
from ..utils.spans import span, spanned

__all__ = ["itd_sift", "SiftResult", "ITD", "STOP_RUNNING", "STOP_FLAT",
           "STOP_BUDGET", "BWD_COUNTS"]

STOP_RUNNING = 0  # never appears in outputs
STOP_FLAT = 1     # stop A: baseline has < 2 extrema
STOP_BUDGET = 2   # stop B: level budget exhausted

# the kernel sift's backwards, summed: levels whose input baselines the
# replay recomputed, and trips the reverse loop walked (one level adjoint
# each)
BWD_COUNTS = {"replayed_levels": 0, "reverse_trips": 0}


class SiftResult(NamedTuple):
    """Fixed-shape sift output, level axis first: ``(levels, *batch, n)``.

    ``num_components`` rows of ``rotations`` are valid (the last valid row
    is the residual trend); rows beyond are zero.  ``correction`` collects
    every level's exact two-sum rounding residual, so
    ``sum(rotations[:num_components]) + correction == x`` to the roundoff of
    the correction itself."""

    rotations: torch.Tensor
    baselines: torch.Tensor
    num_components: torch.Tensor  # int32, per batch element
    stop_reason: torch.Tensor     # int32, STOP_FLAT or STOP_BUDGET
    correction: torch.Tensor      # (*batch, n), same dtype as x


def itd_sift(x: torch.Tensor, max_iteration: int = 11, *,
             endpoint_mode: str = "reference", store_baselines: bool = True,
             backend: str = "auto", early_exit: bool = False,
             linear_backend: str = "auto") -> SiftResult:
    """Full canonical sift of ``x`` (last axis = time; leading axes = batch).

    ``backend``:

    * ``"auto"`` — ``"kernel"`` on a CUDA tensor, ``"torch"`` elsewhere;
    * ``"kernel"`` — one trip = the three launches of ``ops/cuda_fill.py``,
      stop flags and counts kept on the device, each row written in place
      into the preallocated output (on a CPU tensor the wrappers run their
      plain versions).  f32 only.  Differentiable with the gradient of
      JAX's kernel sift (``decomp/itd.py:178-187``), which differentiates
      the loop with structural levels (``linear_backend="structural"``):
      the backward recomputes the levels' inputs on the kernels and walks
      the trips in reverse, one structural level adjoint on the kernels a
      trip (:class:`_KernelSift`);
    * ``"torch"`` — the plain loop of the JAX ``xla`` backend, any device,
      any float dtype, differentiable through autograd.

    ``linear_backend`` (the plain loop's levels): ``"auto"`` differentiates
    the plain levels with autograd; ``"structural"`` gives every level the
    hand-written structural backward (``ops/linear_baseline.py``), with the
    plain fills.  The kernel route's backward is always structural.

    ``early_exit`` checks after each trip whether every row has stopped
    (one host sync per trip) and skips the remaining trips, whose rows
    would be zero.
    """
    if endpoint_mode not in ENDPOINT_MODES:
        raise ValueError(f"unknown endpoint_mode: {endpoint_mode!r}")
    if linear_backend not in ("auto", "structural"):
        raise ValueError(f"unknown linear_backend: {linear_backend!r}")
    if x.shape[-1] < 2:
        raise ValueError(
            f"a signal needs at least 2 samples (got n={x.shape[-1]})")
    if backend == "auto":
        backend = "kernel" if x.is_cuda else "torch"
    args = (max_iteration, endpoint_mode, store_baselines, early_exit)
    if backend == "kernel":
        check_kernel_input(x)
        if x.requires_grad and torch.is_grad_enabled():
            return SiftResult(*_KernelSift.apply(x, *args))
        return _itd_sift_kernel(x, *args)
    if backend == "torch":
        return _itd_sift_torch(x, *args, linear_backend=linear_backend)
    raise ValueError(f"unknown backend: {backend!r}")


def _itd_sift_torch(x, max_iteration, endpoint_mode, store_baselines,
                    early_exit, linear_backend="auto", level_backend="torch"):
    """The plain loop of the JAX ``_itd_sift_xla``, in its order of
    operations.  With ``linear_backend="structural"`` each level is a
    :func:`linear_baseline_extract_structural` whose forward and adjoint
    both run ``level_backend`` (``"torch"`` or ``"kernel"``)."""
    levels = max_iteration + 2

    def extract(a):
        if linear_backend == "structural":
            return linear_baseline_extract_structural(
                a, endpoint_mode=endpoint_mode, backend=level_backend)
        return linear_baseline_extract(a, endpoint_mode=endpoint_mode,
                                       backend="torch")

    first = extract(x)
    rotation, baseline = first.rotation, first.baseline
    # exact rounding residual of the not-yet-emitted rotation
    pending_err = first.sub_err
    zero = x * 0
    out_rot, out_base = [], []

    izero = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
    done = izero != 0
    reason = izero
    ncomp = izero
    prev_base = zero  # mirrors the reference's zero-filled container read
    comp = zero       # accumulated correction (see SiftResult.correction)

    for i in range(levels):
        new = extract(baseline)
        nex = new.num_extrema

        stop_a = ~done & (nex < 2)
        stop_b = (~done & ~stop_a) if i >= max_iteration + 1 \
            else torch.zeros_like(done)
        cont = ~done & ~stop_a & ~stop_b
        stopping = stop_a | stop_b

        row, comp = cf.emit_row(rotation, baseline, prev_base, pending_err,
                                comp, stop_a[..., None], stop_b[..., None],
                                cont[..., None])
        out_rot.append(row)
        if store_baselines:
            out_base.append(torch.where(cont[..., None], baseline,
                                        torch.zeros_like(baseline)))

        rotation = new.rotation
        pending_err = new.sub_err
        prev_base = baseline
        baseline = new.baseline

        ncomp = torch.where(stopping, i + 1, ncomp)
        reason = torch.where(stop_a, STOP_FLAT,
                             torch.where(stop_b, STOP_BUDGET, reason))
        done = done | stopping
        if early_exit and bool(done.all()):
            break

    for rows in (out_rot, out_base) if store_baselines else (out_rot,):
        rows.extend(torch.zeros_like(x) for _ in range(levels - len(rows)))
    return SiftResult(
        rotations=torch.stack(out_rot),
        baselines=torch.stack(out_base) if store_baselines
        else (torch.zeros_like(x) + zero)[None],
        num_components=ncomp,
        stop_reason=reason,
        correction=comp,
    )


@spanned("pyitd.sift")
def _itd_sift_kernel(x, max_iteration, endpoint_mode, store_baselines,
                     early_exit, flags_out=None):
    """The loop of the JAX ``_itd_sift_fused``: per trip one tile scan
    (which also decides the stop flags on the device) and one level launch
    that writes the row in place.  Only the input's tiles are summarised
    by a pass of their own: every level emits its baseline's interior
    summaries for the next trip's scan, which completes them with each
    tile's two edge samples.  A call is the profiler span ``pyitd.sift``,
    each trip ``pyitd.trip`` (``utils/spans.py``).  ``flags_out``, a list,
    receives each trip's stop flags ((rows,) int32)."""
    levels = max_iteration + 2
    batch_shape, n = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, n).contiguous()
    rows = x2.shape[0]

    first = cf.sift_level_cuda(x2, cf.level_states_cuda(x2),
                               endpoint_mode=endpoint_mode, emit=True)
    rot, base, perr = first.rotation, first.baseline, first.sub_err
    interior = first.interior

    zero = x2 * 0
    out_rot = torch.empty((levels, rows, n), dtype=x2.dtype, device=x2.device)
    if store_baselines:
        out_base = torch.empty_like(out_rot)
    else:
        out_base = (torch.zeros_like(x2) + zero)[None]
    carry = cf.SiftCarry.zeros(rows, x2.device)
    prev_base, comp = zero, zero

    for i in range(levels):
        with span("pyitd.trip"):
            states = cf.tile_scan_cuda(interior, carry, trip=i,
                                       max_iteration=max_iteration,
                                       edges_from=base)
            if flags_out is not None:
                flags_out.append(states.flags)
            # the last trip's baseline is extracted no further
            new = cf.sift_level_cuda(base, states,
                                     endpoint_mode=endpoint_mode, rotp=rot,
                                     pbase=prev_base, perr=perr, comp=comp,
                                     out_row=out_rot[i], emit=i + 1 < levels)
            interior = new.interior
            if store_baselines:
                cont = (states.flags & cf.CONT)[:, None] != 0
                torch.where(cont, base, torch.zeros_like(base),
                            out=out_base[i])
            comp = new.comp
            rot, prev_base, base, perr = new.rotation, base, new.baseline, \
                new.sub_err
            if early_exit and i + 1 < levels \
                    and bool((carry.done != 0).all()):
                out_rot[i + 1:] = 0
                if store_baselines:
                    out_base[i + 1:] = 0
                break

    return SiftResult(
        rotations=out_rot.reshape((levels,) + batch_shape + (n,)),
        baselines=out_base.reshape((out_base.shape[0],) + batch_shape + (n,)),
        num_components=carry.ncomp.reshape(batch_shape),
        stop_reason=carry.reason.reshape(batch_shape),
        correction=comp.reshape(batch_shape + (n,)),
    )


def _replay_level_inputs(x, trips, endpoint_mode):
    """The inputs of the first ``trips`` levels of the kernel sift of ``x``
    (rows, n): ``x``, then the baselines ``b_0 .. b_{trips-2}``, bitwise
    the forward's, by the forward's launches without its bookkeeping (each
    level emits its baseline's interior summaries, the next level's scan
    completes them)."""
    inputs, interior = [x], None
    for j in range(trips - 1):
        a = inputs[-1]
        states = cf.level_states_cuda(a) if j == 0 \
            else cf.tile_scan_cuda(interior, edges_from=a)
        lvl = cf.sift_level_cuda(a, states, endpoint_mode=endpoint_mode,
                                 emit=j + 2 < trips)
        inputs.append(lvl.baseline)
        interior = lvl.interior
    BWD_COUNTS["replayed_levels"] += trips - 1
    return inputs


class _KernelSift(torch.autograd.Function):
    """The kernel sift with the gradient of JAX's kernel sift
    (``decomp/itd.py:178-187``), which is autograd of the loop with
    structural levels (``_itd_sift_torch(..., linear_backend="structural",
    level_backend="kernel")``), equal to it bit for bit on finite inputs
    and cotangents.

    The forward runs the kernels and keeps each trip's stop flags.  The
    backward (profiler span ``pyitd.sift_bwd``) recomputes the inputs of
    the levels after the first on the kernels (``pyitd.replay``), then
    walks the trips in reverse, each one level adjoint on the kernels
    (``pyitd.level_bwd``) whose ``bwd_pre`` forms the level's cotangents
    from the outputs' cotangents, the trip's and the next trip's flags and
    the next level's input gradient (``cuda_fill.trip_cotangents``): no
    eager op and no autograd node between the adjoints.  Level ``j``'s
    input is ``b_{j-1}`` (``b_{-1} = x``); the trips the forward ran are
    walked, so ``early_exit`` stops where the forward stopped.

    Every level adjoint runs on every row, as autograd runs them, so a row
    with NaN input gets NaN where the replay does.  A non-finite cotangent
    spreads as autograd's ``0 * g`` paths spread it: through the two-sum
    residual of a stop-B row (its ``Gc + (G_j - Gc)``) and through the
    sift's ``x * 0`` (level 0's zero-path term).  With no cotangent that
    reaches a level (only baselines', none stored) the gradient is that
    path's alone.  ``num_components`` and ``stop_reason`` are not
    differentiable."""

    @staticmethod
    def forward(ctx, x, max_iteration, endpoint_mode, store_baselines,
                early_exit):
        ctx.args = (max_iteration, endpoint_mode, store_baselines, early_exit)
        flags = []
        res = _itd_sift_kernel(x, *ctx.args, flags_out=flags)
        ctx.save_for_backward(x, *flags)
        ctx.mark_non_differentiable(res.num_components, res.stop_reason)
        ctx.set_materialize_grads(False)
        return tuple(res)

    @staticmethod
    @spanned("pyitd.sift_bwd")
    def backward(ctx, g_rot, g_base, _g_ncomp, _g_reason, g_corr):
        x, *flags = ctx.saved_tensors
        _, endpoint_mode, store_baselines, _ = ctx.args
        n = x.shape[-1]
        x2 = x.reshape(-1, n).contiguous()
        rows = x2.shape[0]

        def flat(g, lead=()):
            return None if g is None \
                else g.reshape(*lead, rows, n).contiguous()

        g_zero = None
        if not store_baselines:  # the one row is the zero path's
            g_zero, g_base = flat(g_base), None
        G, Gb, Gc = flat(g_rot, (-1,)), flat(g_base, (-1,)), flat(g_corr)
        if G is None and Gb is None and Gc is None:
            gx = None if g_zero is None else (g_zero * 0).reshape(x.shape)
            return gx, None, None, None, None

        trips = len(flags)
        with span("pyitd.replay"):
            inputs = _replay_level_inputs(x2, trips, endpoint_mode)
        gx = None
        for j in reversed(range(trips)):
            nxt = j + 1 < trips and G is not None
            trip = cf.TripCotangents(
                flags[j], flags[j + 1] if nxt else None,
                G[j + 1] if nxt else None, gx, j == 0,
                g_zero if j == 0 else None)
            with span("pyitd.level_bwd"):
                gx = _structural_level_bwd_kernels(
                    inputs[j], None if G is None else G[j],
                    None if Gb is None else Gb[j], Gc, endpoint_mode, trip)
            inputs[j] = None
        BWD_COUNTS["reverse_trips"] += trips
        return gx.reshape(x.shape), None, None, None, None


class ITD:
    """Class API mirroring the reference's ``ITD``: construct, call
    ``itd(data)``, then read ``get_rotations()`` / ``get_baselines()``.

    ``extrema_detection`` accepts the reference's three options; like the
    reference, only the "matlab" behavior exists.  Unlike the reference's,
    ``__call__`` works.

    ``device`` is where the sift runs: the input moves there.  The default
    is the card, and without one the constructor raises; pass
    ``device="cpu"`` to run on the CPU.  ``dtype`` is the sift's dtype: the
    input is cast to it, float32 by default, as JAX's ``ITD`` computes a
    numpy signal in f32 unless x64 is on; on the card f32 runs the kernels.
    ``dtype=None`` keeps the input's dtype; a float64 signal then needs
    ``device="cpu"`` (the kernels are f32-only, and the kernel route raises
    for any other dtype)."""

    def __init__(self, extrema_detection: str = "matlab", *,
                 endpoint_mode: str = "reference", as_numpy: bool = False,
                 device="cuda", dtype: torch.dtype | None = torch.float32):
        if extrema_detection not in ("simple", "parabol", "matlab"):
            raise ValueError(
                "Only 'simple', 'matlab', and 'parabol' values supported")
        self.device = torch.device(device)
        self.dtype = dtype
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"ITD(device={str(self.device)!r}) needs a CUDA device and "
                "torch.cuda.is_available() is false; pass device='cpu' to "
                "run the sift on the CPU")
        self.extrema_detection = extrema_detection
        self.endpoint_mode = endpoint_mode
        self.as_numpy = as_numpy  # convert outputs to host numpy arrays
        self.rotations = None
        self.baselines = None

    def __call__(self, S, max_iteration: int = 11):
        return self.itd(S, max_iteration=max_iteration)

    def itd(self, data, max_iteration: int = 11):
        """Sift a single 1-D signal; returns the valid rotation rows
        (components; last row = residual trend) as a ``(n_comp, N)``
        tensor."""
        x = torch.as_tensor(data, dtype=self.dtype, device=self.device)
        if x.dim() != 1:
            raise ValueError(
                "ITD.itd expects a 1-D signal; use itd_sift for batches")
        res = itd_sift(x, max_iteration, endpoint_mode=self.endpoint_mode)
        n = int(res.num_components)
        self.rotations = res.rotations[:n]
        # reference slice quirk: stop A exposes the stored baselines; stop B
        # additionally exposes one zero row past them
        n_base = n - 1 if int(res.stop_reason) == STOP_FLAT else n
        self.baselines = res.baselines[:n_base]
        if self.as_numpy:
            self.rotations = self.rotations.detach().cpu().numpy()
            self.baselines = self.baselines.detach().cpu().numpy()
        return self.rotations

    def get_rotations(self):
        if self.rotations is None:
            raise ValueError(
                "No IPR found. Please, run ITD method or its variant first.")
        return self.rotations

    def get_baselines(self):
        if self.baselines is None:
            raise ValueError(
                "No baselines found. Please, run ITD method or its variant "
                "first.")
        return self.baselines

    def get_rotations_and_residual(self):
        """``(proper rotations, residual trend)`` — the last valid row of
        :meth:`itd`'s output is the residual."""
        rot = self.get_rotations()
        return rot[:-1], rot[-1]
