"""The hand-written CUDA kernels of the cubic-spline baseline tier — port of
K5 ``pyitd_tpu/ops/pallas_fill.py::cubic_ksite_padded``, K6
``cubic_neighbors_padded`` (``csrc/cubic.cu``), K7
``pyitd_tpu/ops/pallas_spike.py::spike_factors_padded`` (``csrc/spike.cu``)
and K8 ``spike_backsub_eval`` (``csrc/cubic.cu``); see each file's header
for the design.

The padded-resident route of ``ops/cubic_baseline.py`` runs them in order:

* ``cubic_ksite_cuda(x, states, b_first, b_last)``: the Frei-Osorio knot
  value ``k_site`` at every sample, seeded by the sift pre-pass
  (``cuda_fill.level_states_cuda(x)``);
* ``cubic_neighbors_cuda(x, k_site, states)``: per sample the last two
  knots at or before it and the strictly-next knot, positions (int32) and
  ``k_site`` values (:class:`Neighbors`);
* ``spike_factors_cuda(mask, a, b, c, d)``: the SPIKE local factorization
  of the not-a-knot moment system on blocks of ``SPIKE_BLK`` cells, each
  solved by the partition method on runs of ``SPIKE_RUN`` cells, six
  channels ``(6, rows, npad)`` in the order ``xp1, xp2, vl1, vl2, vr1,
  vr2``;
* ``spike_interface_cuda(factors, mask_int)``: the interface solve over
  the SPIKE blocks, the block scalars and the not-a-knot end moments, one
  kernel (``csrc/spike.cu``) in place of the XLA glue of JAX's
  ``_eval_fills_fused``;
* ``spike_backsub_eval_cuda(...)``: the back-substitution with the
  interface solve's block scalars, the end-moment patches and the
  closed-form spline; baseline and rotation.

Each wrapper checks its tensors and, for a CUDA tensor, launches its
kernel through ``cuda_fill._launch``, which counts it in ``LAUNCHES``; a
call runs inside the profiler span ``pyitd.<wrapper>`` (``cubic_ksite``
... ``spike_backsub_eval``), :func:`spike_interface_cuda` inside
``pyitd.interface_solve`` (``utils/spans.py``).  For a CPU tensor it runs
the plain PyTorch version beside it (``cubic_ksite``, ``cubic_neighbors``,
``spike_factors``, ``interface_end_moments``, ``spike_backsub_eval``);
those run on any device, and a CUDA tensor never reaches them through a
wrapper.  :func:`chained_block_spike` is the drop-in twin of JAX's
``pallas_spike.chained_block_spike``: K7, the interface solve and a torch
back-substitution.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .chained_pcr import _safe_inv, interface_pcr, reduced_interface_solve
from .cubic_baseline import (_end_moments, _fo_knot_values, _segment_eval,
                             _u_at)
from ..utils.spans import spanned
from .cuda_fill import (LevelStates, _check_signal, _launch, _ntiles, _ptr,
                        _same)
from .fill import backward_fill_scan, forward_fill2_scan, shift_left
from .linear_baseline import knot_mask
from .tridiag import _shift_l, _shift_r

__all__ = [
    "SPIKE_BLK", "SPIKE_RUN", "LAUNCHES", "reset_launches", "Neighbors",
    "spike_pad", "cubic_ksite", "cubic_neighbors", "spike_factors",
    "spike_backsub_eval", "spike_interface", "interface_end_moments",
    "chained_block_spike", "PLAIN", "cubic_ksite_cuda", "cubic_neighbors_cuda",
    "spike_factors_cuda", "spike_interface_cuda", "spike_backsub_eval_cuda",
]

# cells per SPIKE block and per thread's run: the SB and R of csrc/spike.cu
# (checked by _check_build)
SPIKE_BLK = 2048
SPIKE_RUN = 8
# the interface kernel's channels a SPIKE block, and the most blocks whose
# double-buffered state it keeps in shared memory: beyond them the wrapper
# hands it a scratch (IFACE_CH and IFACE_SMEM_BLOCKS of csrc/spike.cu)
_IFACE_CH = 10
_IFACE_SMEM_BLOCKS = 2048

# launches per kernel wrapper, counted where the kernel is launched
LAUNCHES = {"cubic_ksite": 0, "cubic_neighbors": 0, "spike_factors": 0,
            "spike_interface": 0, "spike_backsub_eval": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Neighbors(NamedTuple):
    """Per sample: positions (int32) of the latest knot at or before it,
    the one before that, and the first strictly after it, with their
    ``k_site`` values; 0 where there is none."""
    p1p: torch.Tensor
    p2p: torch.Tensor
    n1p: torch.Tensor
    kj: torch.Tensor
    kjm1: torch.Tensor
    kj1: torch.Tensor


def spike_pad(n: int) -> int:
    """The row length rounded up to whole SPIKE blocks."""
    return -(-n // SPIKE_BLK) * SPIKE_BLK


def _iota(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[-1], dtype=torch.int32,
                        device=x.device).expand(x.shape)


def _strictly_next(it, vals, mask):
    """Position and value of the first marked sample strictly after each
    sample; 0 where none."""
    return backward_fill_scan((shift_left(it, 0), shift_left(vals, 0.0)),
                              shift_left(mask, False), (0, 0.0))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def cubic_ksite(x: torch.Tensor, b_first: torch.Tensor,
                b_last: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``cubic_ksite`` kernel: the Frei-Osorio value
    over the knot before the latest at or before each sample and the first
    knot strictly after it (at a knot: its own knot value), ``b_first`` /
    ``b_last`` at the ends."""
    it = _iota(x)
    m = knot_mask(x)
    _, (p2p, p2x), _ = forward_fill2_scan((it, x), m, (0, 0.0))
    n1p, n1x = _strictly_next(it, x, m)
    return _fo_knot_values(x, it, p2p, p2x, n1p, n1x, b_first, b_last)


def cubic_neighbors(x: torch.Tensor, k_site: torch.Tensor) -> Neighbors:
    """Plain version of the ``cubic_neighbors`` kernel, under the knot mask
    of ``x``."""
    it = _iota(x)
    m = knot_mask(x)
    (p1p, kj), (p2p, kjm1), _ = forward_fill2_scan((it, k_site), m, (0, 0.0))
    n1p, kj1 = _strictly_next(it, k_site, m)
    return Neighbors(p1p, p2p, n1p, kj, kjm1, kj1)


def spike_factors(mask, a, b, c, d) -> torch.Tensor:
    """Plain version of the ``spike_factors`` kernel: the SPIKE factors of
    blocks of ``SPIKE_BLK`` cells, each solved by the partition method on
    runs of ``SPIKE_RUN`` cells, in the kernel's order of operations; the
    row is padded with unmarked chain rows.  Returns ``(6, rows, npad)``:
    xp1, xp2, vl1, vl2, vr1, vr2, as ``chained_pcr.shard_spike_factors``
    gives them on the same blocks.

    A block's system, in the chain encoding of ``chained_pcr._encode``:
    at a marked cell ``a u[g-1] + b u[g] + c w[g+1] = d`` and ``w[g] =
    u[g]``; at an unmarked one ``u[g] = u[g-1]`` and ``w[g] = w[g+1]``.
    Per run, with ``U`` the ``u`` before it and ``W`` the ``w`` after it:

    1. the forward sweep writes each ``u[g] = al[g] + be[g] U + ga[g]
       w[g+1]`` (Thomas elimination over the run's marked cells; an
       unmarked cell carries the state);
    2. a backward pass of the same form gives the run's first ``w`` as
       ``o0 + oU U + oW W``;
    3. the runs' ``(e, f)`` = (last ``u``, first ``w``) solve
       ``chained_pcr.interface_pcr`` for three right-hand sides: the data
       (``U = W = 0`` at the block's edges), the left spike (``U = 1`` at
       the first run) and the right spike (``W = 1`` at the last run);
    4. each run back-substitutes with its neighbours' ``e`` and ``f``."""
    sb, r = SPIKE_BLK, SPIKE_RUN
    rows, n = mask.shape
    npad = spike_pad(n)
    nrun = sb // r

    def cells(t, fill):
        if npad > n:
            t = torch.cat([t, t.new_full((rows, npad - n), fill)], dim=-1)
        return t.reshape(-1, nrun, r)

    m, av, bv, cv, dv = (cells(mask, False), cells(a, 0.0), cells(b, 1.0),
                         cells(c, 0.0), cells(d, 0.0))
    zero = av.new_zeros(av.shape[:-1])
    one = torch.ones_like(zero)

    # 1. the forward sweep
    al, be, ga = zero, one, zero
    sweep = []
    for k in range(r):
        mk, ak = m[..., k], av[..., k]
        inv = _safe_inv(bv[..., k] + ak * ga)
        al = torch.where(mk, (dv[..., k] - ak * al) * inv, al)
        be = torch.where(mk, -(ak * be) * inv, be)
        ga = torch.where(mk, -cv[..., k] * inv, ga)
        sweep.append((mk, al, be, ga))
    # 2. the run's first w
    o0, ou, ow = zero, zero, one
    for mk, al_k, be_k, ga_k in reversed(sweep):
        o0 = torch.where(mk, al_k + ga_k * o0, o0)
        ou = torch.where(mk, be_k + ga_k * ou, ou)
        ow = torch.where(mk, ga_k * ow, ow)
    # 3. the runs' reduced system
    run_i = torch.arange(nrun, device=av.device)
    first, last = run_i == 0, run_i == nrun - 1
    pairs = interface_pcr(
        torch.where(first, zero, -be), torch.where(first, zero, -ou),
        torch.where(last, zero, -ga), torch.where(last, zero, -ow),
        [(al, o0),
         (torch.where(first, be, zero), torch.where(first, ou, zero)),
         (torch.where(last, ga, zero), torch.where(last, ow, zero))])
    # 4. back-substitution: the data, the left spike, the right spike
    out = []
    for q, (e, f) in enumerate(pairs):
        big_u = _shift_r(e, 1, 1.0 if q == 1 else 0.0)
        w = _shift_l(f, 1, 1.0 if q == 2 else 0.0)
        us, ws = [None] * r, [None] * r
        for k in reversed(range(r)):
            mk, al_k, be_k, ga_k = sweep[k]
            u = ((al_k + be_k * big_u) if q == 0 else be_k * big_u) + ga_k * w
            w = torch.where(mk, u, w)
            us[k], ws[k] = u, w
        out += [torch.stack(us, -1), torch.stack(ws, -1)]
    return torch.stack(out).reshape(6, rows, npad)


def _block_scalars(v: torch.Tensor, npad: int) -> torch.Tensor:
    """A per-(row, SPIKE block) scalar at every cell: (rows, npad)."""
    blk = torch.arange(npad, device=v.device) // SPIKE_BLK
    return v[:, blk]


def spike_backsub_eval(factors, e_prev, f_next, w_first_next, m0, m_last,
                       b_last, passthrough, nb: Neighbors, x):
    """Plain version of the ``spike_backsub_eval`` kernel: ``u`` and ``w``
    from the spike factors and the block scalars, ``m_j1`` the next
    sample's ``w`` (a block's last cell: the next block's first,
    ``w_first_next``), the end-moment patches, then
    ``cubic_baseline._segment_eval``.  Returns ``(baseline, rotation)``."""
    n = x.shape[-1]
    npad = factors.shape[-1]
    xp1, xp2, vl1, vl2, vr1, vr2 = factors
    ep, fn = _block_scalars(e_prev, npad), _block_scalars(f_next, npad)
    u = (xp1 + vl1 * ep + vr1 * fn)[:, :n]
    w = xp2 + vl2 * ep + vr2 * fn
    it = _iota(x)
    edge = (it + 1) % SPIKE_BLK == 0
    w_next = torch.where(edge, _block_scalars(w_first_next, npad)[:, :n],
                         shift_left(w, 0.0)[:, :n])
    m_last = m_last[:, None]
    m_j = torch.where(nb.p1p == 0, m0[:, None], u)
    m_j1 = torch.where(nb.n1p == n - 1, m_last, w_next)
    return _segment_eval(x, it, nb, m_j, m_j1, m_last, b_last, passthrough)


def spike_interface(factors: torch.Tensor):
    """The interface solve over SPIKE blocks (torch ops on (rows, nblk)):
    per block ``e_prev`` (the true ``u`` at the previous block's last
    cell), ``f_next`` (the true ``w`` at the next block's first cell) and
    ``w_first_next`` (the true ``w`` at the next block's first cell, as the
    back-substitution computes it)."""
    _, rows, npad = factors.shape
    xp1, xp2, vl1, vl2, vr1, vr2 = factors.reshape(6, rows, -1, SPIKE_BLK)
    e, f = reduced_interface_solve(-vl1[..., -1], -vl2[..., 0],
                                   -vr1[..., -1], -vr2[..., 0],
                                   xp1[..., -1], xp2[..., 0])
    zero = torch.zeros_like(e[:, :1])
    e_prev = torch.cat([zero, e[:, :-1]], dim=-1)
    f_next = torch.cat([f[:, 1:], zero], dim=-1)
    w_first = xp2[..., 0] + vl2[..., 0] * e_prev + vr2[..., 0] * f_next
    return e_prev, f_next, torch.cat([w_first[:, 1:], zero], dim=-1)


def interface_end_moments(factors: torch.Tensor, mask_int: torch.Tensor):
    """Plain version of the ``spike_interface`` kernel: the block scalars
    of :func:`spike_interface`, then the not-a-knot end moments of
    ``cubic_baseline._end_moments`` from the back-substituted ``u``
    (``_u_at``) at the first two and last two marks of ``mask_int`` (rows,
    n).  Returns ``(e_prev, f_next, w_first_next, m0, m_last)``."""
    e_prev, f_next, w_first_next = spike_interface(factors)
    m0, m_last = _end_moments(
        lambda idx: _u_at(factors, e_prev, f_next, idx), mask_int,
        mask_int.shape[-1])
    return e_prev, f_next, w_first_next, m0, m_last


def chained_block_spike(mask, a, b, c, d):
    """Drop-in twin of ``chained_pcr.chained_block_pcr`` for (rows, n)
    inputs, in f32, solved by SPIKE: the ``spike_factors`` kernel, the
    ``spike_interface`` kernel and a torch back-substitution.  Returns
    ``(u, w)``."""
    rows, n = mask.shape
    mask = mask.contiguous()
    f32 = [t.to(torch.float32).contiguous() for t in (a, b, c, d)]
    factors = spike_factors_cuda(mask, *f32)
    e_prev, f_next, *_ = spike_interface_cuda(factors, mask)
    xp1, xp2, vl1, vl2, vr1, vr2 = factors.reshape(6, rows, -1, SPIKE_BLK)
    ep, fn = e_prev[..., None], f_next[..., None]
    u = xp1 + vl1 * ep + vr1 * fn
    w = xp2 + vl2 * ep + vr2 * fn
    return u.reshape(rows, -1)[:, :n], w.reshape(rows, -1)[:, :n]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

# each wrapper's plain version, taking the wrapper's arguments (the seeds
# are the kernels' alone): swapped in for the wrappers, they run a route on
# its plain versions on any device
PLAIN = {
    "cubic_ksite_cuda": lambda x, states, b_first, b_last: cubic_ksite(
        x, b_first, b_last),
    "cubic_neighbors_cuda": lambda x, k_site, states: cubic_neighbors(
        x, k_site),
    "spike_factors_cuda": spike_factors,
    "spike_interface_cuda": interface_end_moments,
    "spike_backsub_eval_cuda": spike_backsub_eval,
}


def _check_build(lib) -> None:
    """Refuse a library whose SPIKE blocks and runs are not ``SPIKE_BLK``
    and ``SPIKE_RUN``; ``cuda_fill._lib`` calls this once, where it first
    loads the library."""
    sb, r = lib.pyitd_spike_block(), lib.pyitd_spike_run()
    if (sb, r) != (SPIKE_BLK, SPIKE_RUN):
        raise RuntimeError(
            f"csrc/spike.cu blocks by {sb} in runs of {r}, "
            f"cuda_cubic.SPIKE_BLK / SPIKE_RUN are {SPIKE_BLK} / {SPIKE_RUN}")


def _check_seeds(x: torch.Tensor, states: LevelStates) -> None:
    rows, n = x.shape
    shape = (rows, _ntiles(n), 2)
    _same(x, states.fpos, states.rpos, dtype=torch.int32, shape=shape)
    _same(x, states.fval, states.rval, dtype=torch.float32, shape=shape)


@spanned("pyitd.cubic_ksite")
def cubic_ksite_cuda(x: torch.Tensor, states: LevelStates,
                     b_first: torch.Tensor,
                     b_last: torch.Tensor) -> torch.Tensor:
    """``k_site`` of ``x`` (rows, n) f32; ``states`` from
    ``cuda_fill.level_states_cuda(x)``, ``b_first``/``b_last`` (rows,)
    f32."""
    _check_signal(x)
    _check_seeds(x, states)
    rows, n = x.shape
    _same(x, b_first, b_last, dtype=torch.float32, shape=(rows,))
    if not x.is_cuda:
        return cubic_ksite(x, b_first, b_last)
    out = torch.empty_like(x)
    _launch("cubic_ksite", x.device, x.data_ptr(), rows, n, _ntiles(n),
            states.fpos.data_ptr(), states.fval.data_ptr(),
            states.rpos.data_ptr(), states.rval.data_ptr(),
            b_first.data_ptr(), b_last.data_ptr(), out.data_ptr(),
            counts=LAUNCHES)
    return out


@spanned("pyitd.cubic_neighbors")
def cubic_neighbors_cuda(x: torch.Tensor, k_site: torch.Tensor,
                         states: LevelStates) -> Neighbors:
    """:class:`Neighbors` of ``x`` (rows, n) f32 with the values of
    ``k_site`` (rows, n) f32; ``states`` as for :func:`cubic_ksite_cuda`
    (only its positions are read)."""
    _check_signal(x)
    _check_seeds(x, states)
    rows, n = x.shape
    _same(x, k_site, dtype=torch.float32, shape=(rows, n))
    if not x.is_cuda:
        return cubic_neighbors(x, k_site)
    pos = torch.empty((3, rows, n), dtype=torch.int32, device=x.device)
    val = torch.empty((3, rows, n), dtype=torch.float32, device=x.device)
    _launch("cubic_neighbors", x.device, x.data_ptr(), k_site.data_ptr(),
            rows, n, _ntiles(n), states.fpos.data_ptr(),
            states.rpos.data_ptr(), pos[0].data_ptr(), pos[1].data_ptr(),
            pos[2].data_ptr(), val[0].data_ptr(), val[1].data_ptr(),
            val[2].data_ptr(), counts=LAUNCHES)
    return Neighbors(pos[0], pos[1], pos[2], val[0], val[1], val[2])


@spanned("pyitd.spike_factors")
def spike_factors_cuda(mask: torch.Tensor, a, b, c, d) -> torch.Tensor:
    """The six SPIKE factor channels ``(6, rows, npad)`` of the chained
    system with interior-knot ``mask`` (rows, n) bool and rows ``a, b, c,
    d`` (rows, n) f32."""
    if mask.dim() != 2:
        raise ValueError(f"expected a (rows, n) mask, got {tuple(mask.shape)}")
    rows, n = mask.shape
    _same(a, mask, dtype=torch.bool, shape=(rows, n))
    _same(mask, a, b, c, d, dtype=torch.float32, shape=(rows, n))
    if rows < 1 or n < 1 or (mask.is_cuda and rows > 65535):
        raise ValueError(f"spike_factors takes 1..65535 non-empty rows, got "
                         f"{tuple(mask.shape)}")
    if not mask.is_cuda:
        return spike_factors(mask, a, b, c, d)
    npad = spike_pad(n)
    out = torch.empty((6, rows, npad), dtype=torch.float32,
                      device=mask.device)
    _launch("spike_factors", mask.device, mask.data_ptr(), a.data_ptr(),
            b.data_ptr(), c.data_ptr(), d.data_ptr(), rows, n, npad,
            out.data_ptr(), counts=LAUNCHES)
    return out


@spanned("pyitd.interface_solve")
def spike_interface_cuda(factors: torch.Tensor, mask_int: torch.Tensor):
    """The interface solve over the SPIKE blocks of ``factors`` (6, rows,
    npad) f32 and the end moments under the interior-knot ``mask_int``
    (rows, n) bool: ``(e_prev, f_next, w_first_next)``, each (rows, nblk),
    and ``(m0, m_last)``, each (rows,), f32, as
    :func:`interface_end_moments` gives them."""
    if mask_int.dim() != 2:
        raise ValueError(f"expected a (rows, n) mask, got "
                         f"{tuple(mask_int.shape)}")
    rows, n = mask_int.shape
    if rows < 1 or n < 1:
        raise ValueError(f"spike_interface takes non-empty rows, got "
                         f"{tuple(mask_int.shape)}")
    npad = spike_pad(n)
    nblk = npad // SPIKE_BLK
    _same(factors, mask_int, dtype=torch.bool, shape=(rows, n))
    _same(mask_int, factors, dtype=torch.float32, shape=(6, rows, npad))
    if not factors.is_cuda:
        return interface_end_moments(factors, mask_int)
    dev = factors.device
    out = torch.empty((3, rows, nblk), dtype=torch.float32, device=dev)
    ends = torch.empty((2, rows), dtype=torch.float32, device=dev)
    scratch = torch.empty((rows, 2 * _IFACE_CH * nblk), dtype=torch.float32,
                          device=dev) if nblk > _IFACE_SMEM_BLOCKS else None
    _launch("spike_interface", dev, factors.data_ptr(), mask_int.data_ptr(),
            rows, n, npad, _ptr(scratch), out.data_ptr(), ends.data_ptr(),
            counts=LAUNCHES)
    return (*out.unbind(0), *ends.unbind(0))


@spanned("pyitd.spike_backsub_eval")
def spike_backsub_eval_cuda(factors, e_prev, f_next, w_first_next, m0,
                            m_last, b_last, passthrough, nb: Neighbors, x):
    """Baseline and rotation of ``x`` (rows, n) f32 from the SPIKE
    ``factors`` (6, rows, npad), the (rows, nblk) block scalars and the
    (rows,) f32 end moments ``m0``/``m_last`` of
    :func:`spike_interface_cuda`, the (rows,) f32 end value ``b_last``, the
    (rows,) bool ``passthrough`` guard and the :class:`Neighbors`
    channels."""
    _check_signal(x)
    rows, n = x.shape
    npad = spike_pad(n)
    nblk = npad // SPIKE_BLK
    _same(x, factors, dtype=torch.float32, shape=(6, rows, npad))
    _same(x, e_prev, f_next, w_first_next, dtype=torch.float32,
          shape=(rows, nblk))
    _same(x, m0, m_last, b_last, dtype=torch.float32, shape=(rows,))
    _same(x, passthrough, dtype=torch.bool, shape=(rows,))
    _same(x, nb.p1p, nb.p2p, nb.n1p, dtype=torch.int32, shape=(rows, n))
    _same(x, nb.kj, nb.kjm1, nb.kj1, dtype=torch.float32, shape=(rows, n))
    if not x.is_cuda:
        return spike_backsub_eval(factors, e_prev, f_next, w_first_next, m0,
                                  m_last, b_last, passthrough, nb, x)
    out = torch.empty((2, rows, n), dtype=torch.float32, device=x.device)
    guard = passthrough.to(torch.int32)
    _launch("spike_backsub_eval", x.device, factors.data_ptr(), rows, n,
            npad, nblk, SPIKE_BLK, e_prev.data_ptr(), f_next.data_ptr(),
            w_first_next.data_ptr(), m0.data_ptr(), m_last.data_ptr(),
            b_last.data_ptr(), guard.data_ptr(), nb.p1p.data_ptr(),
            nb.p2p.data_ptr(), nb.n1p.data_ptr(), nb.kj.data_ptr(),
            nb.kjm1.data_ptr(), nb.kj1.data_ptr(), x.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), counts=LAUNCHES)
    return out[0], out[1]
