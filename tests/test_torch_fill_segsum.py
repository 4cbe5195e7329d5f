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
        for a, b in zip(cf.segsum_cuda((v, v * 2), mt, reverse),
                        cf.segsum((v, v * 2), mt, reverse)):
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
