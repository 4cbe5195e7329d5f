"""The plain versions beside the sift kernels
(``pyitd_tpu_torch.ops.cuda_fill``) and their wrappers' argument checks,
on the CPU.

* ``level_states``: interior extrema counts and the exclusive forward
  seeds against JAX ``level_block_states_fwd`` (its 8192-sample blocks are
  every second 4096-sample tile), the reverse seeds against a direct
  numpy walk over the knot positions;
* the stop flags and the in-place carry update against the rules of
  ``decomp/itd.py:520-522``;
* a wrapper given a CPU tensor runs the plain version and counts no launch;
* the sift's trips without a summary pass: the interior summaries a level
  emits for its baseline, completed with every tile's two edge samples,
  equal ``level_summaries`` of that baseline bit for bit, on the shapes that
  try the tile edges (``tools/level_bench.py::edge_cases``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyitd_tpu.ops.pallas_fill import BLK, _pad_edges, level_block_states_fwd
from pyitd_tpu_torch.ops import cuda_fill as cf
from pyitd_tpu_torch.ops.linear_baseline import knot_mask
from pyitd_tpu_torch.tools.level_bench import edge_cases

torch.set_num_threads(1)


def _signal(rows, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, n)).astype(np.float32)
    x[0, 4090:4100] = 1.0                   # a plateau across a tile edge
    if n > 9000:
        x[1, 8190:8200] = np.nan            # no knots near 8192
    return x


@pytest.mark.parametrize("n", [9000, 3 * BLK + 5])
def test_level_states_match_jax_and_numpy(n):
    x = _signal(2, n, n)
    st = cf.level_states(torch.from_numpy(x))

    x3, _, _, _, nblk = _pad_edges(jnp.asarray(x))
    nex, fp = level_block_states_fwd(x3, n)
    np.testing.assert_array_equal(st.nex.numpy(), np.asarray(nex))
    fp = np.asarray(fp).reshape(2, nblk, 4)  # (p1, v1, p2, v2) per block
    assert cf.TILE * 2 == BLK
    np.testing.assert_array_equal(st.fpos[:, ::2, 0].numpy(), fp[..., 0])
    np.testing.assert_array_equal(st.fpos[:, ::2, 1].numpy(), fp[..., 2])
    has1, has2 = fp[..., 0] >= 0, fp[..., 2] >= 0
    np.testing.assert_array_equal(st.fval[:, ::2, 0].numpy()[has1],
                                  fp[..., 1][has1])
    np.testing.assert_array_equal(st.fval[:, ::2, 1].numpy()[has2],
                                  fp[..., 3][has2])

    # reverse seeds: the first two knots at or after each tile's end
    knots = knot_mask(torch.from_numpy(x)).numpy()
    for r in range(2):
        kp = np.flatnonzero(knots[r])
        for k in range(st.rpos.shape[1]):
            after = kp[kp >= (k + 1) * cf.TILE][:2]
            want = np.full(2, -1)
            want[:after.size] = after
            np.testing.assert_array_equal(st.rpos[r, k].numpy(), want)
            np.testing.assert_array_equal(
                st.rval[r, k].numpy(),
                np.where(want >= 0, x[r][np.maximum(want, 0)], 0.0))


def test_stop_flags_and_carry():
    nex = torch.tensor([5, 1, 7, 0], dtype=torch.int32)
    carry = cf.SiftCarry.zeros(4, "cpu")
    carry.done[3] = 1
    carry.reason[3], carry.ncomp[3] = 1, 2
    flags = cf.stop_flags(nex, carry, trip=2, max_iteration=8)
    assert flags.tolist() == [cf.CONT, cf.STOP_A, cf.CONT, 0]
    assert carry.done.tolist() == [0, 1, 0, 1]
    assert carry.reason.tolist() == [0, 1, 0, 1]
    assert carry.ncomp.tolist() == [0, 3, 0, 2]
    flags = cf.stop_flags(nex, carry, trip=9, max_iteration=8)
    assert flags.tolist() == [cf.STOP_B, 0, cf.STOP_B, 0]
    assert carry.reason.tolist() == [2, 1, 2, 1]
    assert carry.ncomp.tolist() == [10, 3, 10, 2]
    assert cf.stop_flags(nex, None, 0, 8).tolist() == [0, 0, 0, 0]


def test_wrappers_run_plain_on_cpu_and_check_arguments():
    x = torch.from_numpy(_signal(2, 9000, 1))
    cf.reset_launches()
    summ = cf.level_summaries_cuda(x)
    for a, b in zip(summ, cf.level_summaries(x)):
        assert torch.equal(a, b)
    states = cf.tile_scan_cuda(summ)
    out = cf.sift_level_cuda(x, states)
    ref = cf.sift_level(x, cf.level_states(x))
    for a, b in zip(out[:3], ref[:3]):
        assert torch.equal(a, b)
    assert all(v == 0 for v in cf.LAUNCHES.values())

    with pytest.raises(ValueError, match="float32"):
        cf.level_summaries_cuda(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        cf.level_summaries_cuda(x.t().contiguous().t())
    with pytest.raises(ValueError, match="rows, n"):
        cf.level_summaries_cuda(x[0])
    with pytest.raises(ValueError, match="2 samples"):
        cf.level_summaries_cuda(torch.zeros(2, 1))
    with pytest.raises(ValueError, match="shape"):
        cf.sift_level_cuda(x[:1].contiguous(), states)
    with pytest.raises(ValueError, match="endpoint_mode"):
        cf.sift_level_cuda(x, states, endpoint_mode="bogus")


def same(a, b):
    """Two tuples of tensors bit for bit (NaN equals NaN)."""
    return len(a) == len(b) and all(
        p.shape == q.shape and p.dtype == q.dtype
        and bool(((p == q) | ((p != p) & (q != q))).all())
        for p, q in zip(a, b))


EDGE_CASES = list(edge_cases())


@pytest.mark.parametrize("name,xn", EDGE_CASES,
                         ids=[c[0] for c in EDGE_CASES])
def test_interior_summaries_plus_edges_are_level_summaries(name, xn):
    x = torch.from_numpy(xn)
    states = cf.level_states(x)
    for mode in ("reference", "natural"):
        lvl = cf.sift_level_cuda(x, states, endpoint_mode=mode, emit=True)
        plain = cf.sift_level(x, states, endpoint_mode=mode)
        assert plain.interior is None and same(lvl[:3], plain[:3])
        for sig, interior in ((x, cf.interior_summaries(x)),
                              (lvl.baseline, lvl.interior)):
            whole = cf.level_summaries(sig)
            assert same(interior, cf.interior_summaries(sig))
            assert same(cf.complete_summaries(interior, sig), whole)
            # nothing of a tile's first and last sample is in the interior
            edges = knot_mask(sig)[:, ::cf.TILE].sum(-1) \
                + knot_mask(sig)[:, cf.TILE - 1::cf.TILE].sum(-1)
            assert torch.equal(interior.cnt.sum(-1) + edges,
                               whole.cnt.sum(-1))
            ca, cb = (cf.SiftCarry.zeros(x.shape[0], "cpu") for _ in range(2))
            got = cf.tile_scan_cuda(interior, ca, 1, 3, edges_from=sig)
            want = cf.tile_scan(whole, cb, 1, 3)
            assert same(got, want) and same(ca, cb)
            gt, wt = (cf.tile_scan_cuda(interior, totals=True,
                                        edges_from=sig)[1],
                      cf.tile_scan(whole, totals=True)[1])
            assert same(gt, wt)


def test_new_modes_check_their_arguments():
    x = torch.from_numpy(EDGE_CASES[2][1])
    states = cf.level_states(x)
    interior = cf.interior_summaries(x)
    shard = cf.ShardArgs(x.shape[1], torch.zeros(3, dtype=torch.int32),
                         torch.zeros(3), torch.zeros(3), torch.zeros(3),
                         torch.zeros(3), *(torch.zeros((3, 2), dtype=d)
                                           for d in (torch.int32,
                                                     torch.float32) * 2))
    # time shards emit too (the sharded fold_emit): the interior summaries
    # leave out each shard's last sample, and a shard's edge completion
    # needs the signal they were taken from
    out = cf.sift_level_cuda(x, states, shard=shard, emit=True)
    want = cf.interior_summaries(out.baseline, shard)
    assert all(torch.equal(a, b) for a, b in zip(out.interior, want))
    with pytest.raises(ValueError, match="edges_from"):
        cf.tile_scan_cuda(interior, shard=shard)
    with pytest.raises(ValueError, match="tiles"):
        cf.tile_scan_cuda(interior, edges_from=x[:, :100].contiguous())
    with pytest.raises(ValueError, match="float32"):
        cf.tile_scan_cuda(interior, edges_from=x.double())
    with pytest.raises(ValueError, match="shape"):
        cf.tile_scan_cuda(interior, edges_from=x[:2].contiguous())
