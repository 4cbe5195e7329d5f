"""The fills and segmented sums of the structural backward against the JAX
package, on the CPU.

* the port's value fills (``ops/fill.py``) against JAX's scans
  (``forward_fill2_scan`` and its kin), bitwise;
* the plain versions beside the kernels (``ops/cuda_fill.py``: ``fill2``,
  ``fillv``, ``segsum``) against JAX ``fill2_pallas``, ``fillv_pallas`` and
  ``segsum_pallas`` in interpret mode at n = BLK + 517, which crosses both
  JAX's 8192-sample block and the port's 4096-sample tile.  Fills bitwise
  (positions as integers), with marks on tile and block seams and a row
  with no mark; ``strict`` against JAX's call on inputs shifted by one
  (``linear_baseline.py:391-393``); ``segsum`` bitwise on integer-valued
  inputs, also against the sequential oracle of
  ``tests/test_pallas_fill.py``;
* ``segsum`` on real-valued and non-finite inputs against a sequential f64
  oracle, and ``segsum_error_bound`` against the oracle's own f32 sums;
* ``segsum(strict=True)`` against JAX's call on values and flags shifted
  by one (``linear_baseline.py:409-425``), and in f64 against the oracle;
* ``segsum_model``, the association of the one-pass look-back kernel of
  ``csrc/fill_segsum.cu`` in plain PyTorch f32 (chunks of 4 samples, a
  Kogge-Stone scan per chunk set and over the warps, tile aggregates, the
  look-back's fixed fold that ends at the nearest reset, the seeded walk):
  within ``segsum_error_bound`` of the plain ``segsum`` and exact on
  integer-valued inputs, on the row lengths and flag patterns that try the
  protocol, on rows that start off a 16-byte boundary, and on a row long
  enough for the look-back to walk two windows;
* a wrapper given a CPU tensor runs the plain version, counts no launch,
  and refuses what its kernel does not take.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyitd_tpu.ops import fill as jfill
from pyitd_tpu.ops.pallas_fill import (BLK, fill2_pallas, fillv_pallas,
                                       segsum_pallas)
from pyitd_tpu_torch.ops import cuda_fill as cf
from pyitd_tpu_torch.ops import fill as tfill

torch.set_num_threads(1)

N = BLK + 517


def bitwise(a: np.ndarray, b: np.ndarray) -> bool:
    if a.shape != b.shape:
        return False
    if a.dtype.kind == "f":
        w = {4: np.int32, 8: np.int64}[a.itemsize]
        return bool(np.all((a.view(w) == b.astype(a.dtype).view(w))
                           | (np.isnan(a) & np.isnan(b))))
    return bool(np.array_equal(a, b))


def _inputs(rows=3, n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, n)).astype(np.float32)
    x[0, 100:102] = np.nan                     # a NaN pair among the values
    m = rng.random((rows, n)) < 0.01
    for i in (0, 4095, 4096, 4097, BLK - 1, BLK, n - 1):
        m[0, min(i, n - 1)] = True             # marks on tile / block seams
    m[1, :] = False
    m[1, 4096] = True                          # one mark, on a tile seam
    m[2, :] = False                            # no mark at all
    return x, m


def _sequential_segsum(v, flags, reverse):
    """out[t] = v[t] + (flags[t] ? 0 : out[t-1]), summed in f64 in order
    (``tests/test_pallas_fill.py:333-345``)."""
    out = np.zeros(v.shape, np.float64)
    order = range(v.shape[1] - 1, -1, -1) if reverse else range(v.shape[1])
    for r in range(v.shape[0]):
        acc = 0.0
        for t in order:
            acc = float(v[r, t]) + (0.0 if flags[r, t] else acc)
            out[r, t] = acc
    return out


@pytest.mark.parametrize("reverse", [False, True])
def test_value_fills_match_jax_scans(reverse):
    x, m = _inputs()
    pos = np.broadcast_to(np.arange(N), x.shape)
    chans = (x, x.astype(np.float64) * 3)
    j1 = jfill.backward_fill_scan if reverse else jfill.forward_fill_scan
    j2 = jfill.backward_fill2_scan if reverse else jfill.forward_fill2_scan
    t1 = tfill.backward_fill_scan if reverse else tfill.forward_fill_scan
    t2 = tfill.backward_fill2_scan if reverse else tfill.forward_fill2_scan
    jm, tm = jnp.asarray(m), torch.from_numpy(m)

    want = j1(tuple(jnp.asarray(c) for c in chans), jm, (0.0, -1.0))
    got = t1(tuple(torch.from_numpy(c) for c in chans), tm, (0.0, -1.0))
    for g, w in zip(got, want):
        assert bitwise(g.numpy(), np.asarray(w))

    (w1, w2, wc) = j2((jnp.asarray(pos.astype(np.float32)),) + tuple(
        jnp.asarray(c) for c in chans), jm, (0.0, 0.0, 2.5))
    (g1, g2, gc) = t2((torch.from_numpy(pos.copy()),) + tuple(
        torch.from_numpy(c) for c in chans), tm, (0, 0.0, 2.5))
    for gs, ws in ((g1, w1), (g2, w2)):
        np.testing.assert_array_equal(gs[0].numpy(), np.asarray(ws[0]))
        for g, w in zip(gs[1:], ws[1:]):
            assert bitwise(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("inclusive", [True, False])
def test_forward_backward_fill_match_jax(inclusive):
    """``forward_fill`` / ``backward_fill``: values at the last / next
    mark, ``values[..., 0]`` before the first mark and ``values[..., -1]``
    after the last (rows with one mark and with none included)."""
    x, m = _inputs()
    jm, tm = jnp.asarray(m), torch.from_numpy(m)
    for jf, tf in ((jfill.forward_fill, tfill.forward_fill),
                   (jfill.backward_fill, tfill.backward_fill)):
        want = np.asarray(jf(jnp.asarray(x), jm, inclusive=inclusive))
        got = tf(torch.from_numpy(x), tm, inclusive=inclusive)
        assert bitwise(got.numpy(), want)
    head = tfill.forward_fill(torch.from_numpy(x), tm)[2]
    assert bitwise(head.numpy(), np.full(N, x[2, 0]))


@pytest.mark.parametrize("reverse", [False, True])
def test_fill2_matches_jax_pallas(reverse):
    x, m = _inputs(seed=1)
    pos = np.broadcast_to(np.arange(N, dtype=np.float32), x.shape).copy()
    want = fill2_pallas(jnp.asarray(pos), jnp.asarray(x), jnp.asarray(m),
                        reverse=reverse, interpret=True)
    got = cf.fill2(torch.from_numpy(x), torch.from_numpy(m), reverse)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        if i % 2 == 0:  # positions: int32 against JAX's exact f32
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))
        else:
            assert bitwise(g.numpy(), w)


@pytest.mark.parametrize("reverse", [False, True])
def test_fill2_strict_matches_jax_shifted_call(reverse):
    """``strict`` against JAX's struct_bwd form: the inputs shifted left by
    one, then the fill (``linear_baseline.py:391-393``); forward mirrors it
    with a shift right."""
    x, m = _inputs(seed=2)
    pos = np.broadcast_to(np.arange(N, dtype=np.float32), x.shape)

    def shift(a, fill):
        out = np.full_like(a, fill)
        if reverse:
            out[:, :-1] = a[:, 1:]
        else:
            out[:, 1:] = a[:, :-1]
        return jnp.asarray(out)

    want = fill2_pallas(shift(pos, 0.0), shift(x, 0.0), shift(m, False),
                        reverse=reverse, interpret=True)
    got = cf.fill2(torch.from_numpy(x), torch.from_numpy(m), reverse,
                   strict=True)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        if i % 2 == 0:
            np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))
        else:
            assert bitwise(g.numpy(), w)


@pytest.mark.parametrize("reverse", [False, True])
def test_fillv_matches_jax_pallas(reverse):
    x, m = _inputs(seed=3)
    want = fillv_pallas(jnp.asarray(x), jnp.asarray(m), reverse=reverse,
                        interpret=True)
    got = cf.fillv(torch.from_numpy(x), torch.from_numpy(m), reverse)
    assert bitwise(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("nch", [1, 2])
def test_segsum_integer_valued_matches_jax_and_oracle(nch, reverse):
    rng = np.random.default_rng(23 + nch)
    _, flags = _inputs(seed=4)
    vals = tuple(rng.integers(-8, 9, size=flags.shape).astype(np.float32)
                 for _ in range(nch))
    want = segsum_pallas(tuple(jnp.asarray(v) for v in vals),
                         jnp.asarray(flags), reverse=reverse, interpret=True)
    got = cf.segsum(tuple(torch.from_numpy(v) for v in vals),
                    torch.from_numpy(flags), reverse)
    assert isinstance(got, tuple) and len(got) == nch
    for g, w, v in zip(got, want, vals):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(
            g.numpy(), _sequential_segsum(v, flags, reverse))
    single = cf.segsum(torch.from_numpy(vals[0]), torch.from_numpy(flags),
                       reverse)
    assert torch.equal(single, got[0])


@pytest.mark.parametrize("reverse", [False, True])
def test_segsum_real_and_nonfinite_against_f64_oracle(reverse):
    """Real-valued sums are the f64 sums rounded once; NaN and infinities
    stay inside their segment, as an f32 running sum keeps them.  The f32
    sequential sums of the oracle's own order stay within
    ``segsum_error_bound`` of them."""
    rng = np.random.default_rng(5)
    _, flags = _inputs(rows=3, n=5000, seed=5)
    v = (rng.normal(size=flags.shape) * 10.0 ** rng.integers(
        -3, 4, size=flags.shape)).astype(np.float32)
    v[0, 4000] = np.nan
    v[1, 2000] = np.inf
    v[1, 2100] = -np.inf
    got = cf.segsum(torch.from_numpy(v), torch.from_numpy(flags), reverse)
    want = _sequential_segsum(v, flags, reverse)
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
        fin = np.isfinite(want)
        np.testing.assert_array_equal(got.numpy()[~fin & ~np.isnan(want)],
                                      want[~fin & ~np.isnan(want)])
    np.testing.assert_array_equal(got.numpy()[fin], want[fin].astype(
        np.float32))

    # an f32 sum in another order (sequential) stays within the bound
    seq32 = np.zeros(v.shape, np.float32)
    order = range(v.shape[1] - 1, -1, -1) if reverse else range(v.shape[1])
    with np.errstate(invalid="ignore"):  # inf + -inf inside a segment
        for r in range(v.shape[0]):
            acc = np.float32(0)
            for t in order:
                acc = v[r, t] + (np.float32(0) if flags[r, t] else acc)
                seq32[r, t] = acc
    bound = cf.segsum_error_bound(torch.from_numpy(v),
                                  torch.from_numpy(flags), reverse).numpy()
    err = np.abs(seq32[fin].astype(np.float64)
                 - got.numpy()[fin].astype(np.float64))
    assert np.all(err <= bound[fin])
    assert np.all(bound[fin] > 0) or not np.any(fin)


def _shifted(a, fill, reverse):
    """``a`` moved one sample along the scan direction (JAX's
    ``_shift_right`` forward, ``_shift_left`` in reverse)."""
    out = np.full_like(a, fill)
    if reverse:
        out[:, :-1] = a[:, 1:]
    else:
        out[:, 1:] = a[:, :-1]
    return out


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("nch", [1, 2])
def test_segsum_strict_matches_jax_shifted_call(nch, reverse):
    """``strict`` against the form JAX's adjoint uses for the sums that
    leave their own sample out: values and flags shifted by one, then the
    inclusive sum."""
    rng = np.random.default_rng(31 + nch)
    _, flags = _inputs(seed=7)
    vals = tuple(rng.integers(-8, 9, size=flags.shape).astype(np.float32)
                 for _ in range(nch))
    want = segsum_pallas(
        tuple(jnp.asarray(_shifted(v, 0.0, reverse)) for v in vals),
        jnp.asarray(_shifted(flags, False, reverse)), reverse=reverse,
        interpret=True)
    got = cf.segsum(tuple(torch.from_numpy(v) for v in vals),
                    torch.from_numpy(flags), reverse, strict=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # f64, real-valued: the oracle's inclusive sums, shifted
    v64 = rng.normal(size=(2, 5000))
    f = flags[:2, :5000]
    seq = _shifted(_sequential_segsum(v64, f, reverse), 0.0, reverse)
    got = cf.segsum(torch.from_numpy(v64), torch.from_numpy(f), reverse,
                    strict=True)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), seq, rtol=0, atol=1e-12)
    bound = cf.segsum_error_bound(torch.from_numpy(v64.astype(np.float32)),
                                  torch.from_numpy(f), reverse, strict=True)
    first = -1 if reverse else 0
    assert torch.all(bound[:, first] == 0)


# ---- the kernel's association, in plain PyTorch -------------------------

_SPT = cf.SCAN_RUN
_NWARP = cf.SCAN_THREADS // 32


def _comb(a, b):
    """``comb(a, b)`` of the segsum monoid, ``a`` first in scan order:
    (reset seen, sum after the last reset)."""
    return a[0] | b[0], torch.where(b[0], b[1], a[1] + b[1])


def _shift_lanes(x, o, fill):
    """``x`` moved ``o`` lanes up its last axis (``__shfl_up_sync``)."""
    pad = torch.full_like(x[..., :o], fill)
    return torch.cat([pad, x[..., :x.shape[-1] - o]], -1)


def _kogge_stone(s):
    """Inclusive scan along the last axis: step ``o`` combines lane
    ``l - o`` into every lane ``l >= o``."""
    r, v = s
    width, o = r.shape[-1], 1
    while o < width:
        lanes = torch.arange(width) >= o
        cr, cv = _comb((_shift_lanes(r, o, False), _shift_lanes(v, o, 0.0)),
                       (r, v))
        r, v = torch.where(lanes, cr, r), torch.where(lanes, cv, v)
        o *= 2
    return r, v


def _exclusive(s):
    return _shift_lanes(s[0], 1, False), _shift_lanes(s[1], 1, 0.0)


def _look_back(agg, t):
    """The exclusive prefix of tile ``t`` from the aggregates before it:
    windows of 32, nearest first; lane ``l`` of a window holds tile
    ``base - l``; step ``o`` of the tree combines lane ``l + o`` (farther)
    into lane ``l``; the walk ends once a reset has been seen."""
    zero = torch.zeros((), dtype=agg[1].dtype)
    acc = (torch.tensor(False), zero)
    for base in range(t - 1, -1, -32):
        idx = base - torch.arange(32)
        ok, at = idx >= 0, idx.clamp(min=0)
        a = (agg[0][at] & ok, torch.where(ok, agg[1][at], zero))
        o = 1
        while o < 32:
            lanes = torch.arange(32) + o < 32
            c = _comb((a[0].roll(-o), a[1].roll(-o)), a)
            a = (torch.where(lanes, c[0], a[0]),
                 torch.where(lanes, c[1], a[1]))
            o *= 2
        acc = _comb((a[0][0], a[1][0]), acc)
        if bool(acc[0]):
            break
    return acc


def segsum_model(v, flags, reverse=False, strict=False, offset=0):
    """One channel of ``segsum`` summed in the order of the kernel in
    ``csrc/fill_segsum.cu``, in the dtype of ``v``.  ``offset``: floats from
    a 16-byte boundary to the first row (a row is tiled from the boundary
    at or before its start)."""
    rows, n = v.shape
    aligned = offset % 4 == 0 and n % 4 == 0
    nt = -(-(n + (0 if aligned else 3)) // cf.TILE)
    sets = _SPT // 4
    out = torch.empty_like(v)
    for row in range(rows):
        pad = (offset + row * n) % 4
        vm = torch.zeros(nt * cf.TILE, dtype=v.dtype)
        fm = torch.zeros(nt * cf.TILE, dtype=torch.bool)
        vm[pad:pad + n], fm[pad:pad + n] = v[row], flags[row]
        if reverse:
            vm, fm = vm.flip(0), fm.flip(0)
        # (tile, warp, chunk set, lane, sample of the chunk)
        e = (fm.view(nt, _NWARP, sets, 32, 4),
             vm.view(nt, _NWARP, sets, 32, 4))
        chunk = (torch.zeros_like(e[0][..., 0]),
                 torch.zeros_like(e[1][..., 0]))
        for q in range(4):
            chunk = _comb(chunk, (e[0][..., q], e[1][..., q]))
        inc = _kogge_stone(chunk)
        ex = _exclusive(inc)
        wtot = (torch.zeros(nt, _NWARP, dtype=torch.bool),
                torch.zeros(nt, _NWARP, dtype=v.dtype))
        before = []  # everything before each chunk in its warp
        for c in range(sets):
            before.append(_comb((wtot[0][..., None], wtot[1][..., None]),
                                (ex[0][:, :, c], ex[1][:, :, c])))
            wtot = _comb(wtot, (inc[0][:, :, c, 31], inc[1][:, :, c, 31]))
        wi = _kogge_stone(wtot)
        we = _exclusive(wi)
        agg = (wi[0][:, -1], wi[1][:, -1])
        pre = [_look_back(agg, t) for t in range(nt)]
        pre = tuple(torch.stack([p[i] for p in pre]) for i in (0, 1))
        seed = _comb((pre[0][:, None], pre[1][:, None]), we)
        res = torch.empty_like(e[1])
        for c in range(sets):
            P = _comb((seed[0][..., None], seed[1][..., None]), before[c])
            for q in range(4):
                nx = _comb(P, (e[0][:, :, c, :, q], e[1][:, :, c, :, q]))
                res[:, :, c, :, q] = P[1] if strict else nx[1]
                P = nx
        res = res.reshape(-1)
        if reverse:
            res = res.flip(0)
        out[row] = res[pad:pad + n]
    return out


def _pattern_flags(pattern, rows, n, rng):
    f = np.zeros((rows, n), bool)
    if pattern == "first-tile":
        f[:, min(5, n - 1)] = True
    elif pattern == "every-sample":
        f[:] = True
    elif pattern == "random":
        f = rng.random((rows, n)) < 0.002
        f[-1] = False
    return f


def _check_model(n, pattern, reverse, strict=False, offset=0, rows=2):
    rng = np.random.default_rng(n + 17 * len(pattern))
    flags = torch.from_numpy(_pattern_flags(pattern, rows, n, rng))
    ints = tuple(torch.from_numpy(rng.integers(-8, 9, size=(rows, n)).astype(
        np.float32)) for _ in range(2))
    reals = tuple(torch.from_numpy((rng.normal(size=(rows, n)) * 10.0 ** (
        rng.integers(-3, 4, size=(rows, n)))).astype(np.float32))
        for _ in range(2))
    for nch in (1, 2):
        want = cf.segsum(ints[:nch], flags, reverse, strict)
        for v, w in zip(ints[:nch], want):
            assert torch.equal(
                segsum_model(v, flags, reverse, strict, offset), w)
        want = cf.segsum(reals[:nch], flags, reverse, strict)
        for v, w in zip(reals[:nch], want):
            got = segsum_model(v, flags, reverse, strict, offset)
            err = (got.double() - w.double()).abs()
            assert bool((err <= cf.segsum_error_bound(
                v, flags, reverse, strict)).all())


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("pattern", ["none", "first-tile", "every-sample",
                                     "random"])
@pytest.mark.parametrize("n", [1, 7, 4095, 4096, 4097, 3 * 4096 + 5])
def test_segsum_kernel_association_within_bound(n, pattern, reverse):
    _check_model(n, pattern, reverse)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_segsum_kernel_association_on_unaligned_rows(offset):
    """Rows that start ``offset`` floats past a 16-byte boundary are tiled
    from the boundary, so the association shifts with the start."""
    for reverse in (False, True):
        _check_model(2 * 4096 + 2, "random", reverse, strict=reverse,
                     offset=offset, rows=3)
    v = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 9000))
                         .astype(np.float32))
    f = torch.zeros(1, 9000, dtype=torch.bool)
    assert not torch.equal(segsum_model(v, f),
                           segsum_model(v, f, offset=offset))


def test_segsum_kernel_association_walks_two_windows():
    """40 tiles: the last tiles look back over two windows of 32; with no
    reset the walk reaches the row's start, with one it ends there."""
    n = 40 * 4096 + 7
    assert cf.segsum_depth(n) == cf.segsum_depth(4093) + 2
    for reverse in (False, True):
        _check_model(n, "none", reverse, rows=1)
        _check_model(n, "first-tile", reverse, strict=True, rows=1)


def test_segsum_depth_counts_the_kernel_additions():
    """The depth of ``segsum_error_bound`` at the kernel's shape: 4 + 5 in
    the chunk and its warp scan, one across the two chunk sets, 4 across 16
    warps, 5 + windows in the look-back, 2 seeding, 4 walking."""
    assert (cf.SCAN_THREADS, cf.SCAN_RUN) == (512, 8)
    assert cf.SCAN_THREADS * cf.SCAN_RUN == cf.TILE
    assert cf.segsum_depth(4093) == 4 + 5 + 1 + 4 + 5 + 0 + 2 + 4
    assert cf.segsum_depth(4094) == 26       # 4097 samples when shifted by 3
    assert cf.segsum_depth(1_000_000) == 25 + 8
    # all terms of one sign, one segment: the error is real and the bound
    # holds it with room, but not by orders of magnitude
    v = torch.full((1, 3 * 4096), 0.1)
    f = torch.zeros_like(v, dtype=torch.bool)
    err = (segsum_model(v, f).double() - cf.segsum(v, f).double()).abs()
    bound = cf.segsum_error_bound(v, f)
    assert bool((err <= bound).all()) and float(err.max()) > 0
    assert float((err / bound).max()) > 1e-3


def test_wrappers_run_plain_on_cpu_and_check_arguments():
    x, m = _inputs(rows=3, n=9000, seed=6)
    xt, mt = torch.from_numpy(x), torch.from_numpy(m)
    cf.reset_launches()
    for reverse in (False, True):
        for strict in (False, True):
            for a, b in zip(cf.fill2_cuda(xt, mt, reverse, strict),
                            cf.fill2(xt, mt, reverse, strict)):
                assert bitwise(a.numpy(), b.numpy())
        assert bitwise(cf.fillv_cuda(xt, mt, reverse).numpy(),
                       cf.fillv(xt, mt, reverse).numpy())
        v = torch.round(xt.nan_to_num(0.0) * 4)
        for strict in (False, True):
            for a, b in zip(cf.segsum_cuda((v, v * 2), mt, reverse, strict),
                            cf.segsum((v, v * 2), mt, reverse, strict)):
                assert torch.equal(a, b)
    assert all(v == 0 for v in cf.LAUNCHES.values())

    with pytest.raises(ValueError, match="float32"):
        cf.fill2_cuda(xt.double(), mt)
    with pytest.raises(ValueError, match="bool"):
        cf.fillv_cuda(xt, mt.float())
    with pytest.raises(ValueError, match="contiguous"):
        cf.segsum_cuda(xt.t().contiguous().t(), mt)
    with pytest.raises(ValueError, match="shape"):
        cf.segsum_cuda((xt, xt[:1].contiguous()), mt)
    with pytest.raises(ValueError, match="1 or 2 channels"):
        cf.segsum_cuda((xt, xt, xt), mt)
    with pytest.raises(ValueError, match="rows, n"):
        cf.fill2_cuda(xt[0], mt[0])
    with pytest.raises(ValueError, match="non-empty"):
        cf.fillv_cuda(xt[:0], mt[:0])
