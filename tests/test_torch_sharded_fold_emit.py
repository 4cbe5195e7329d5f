"""The sharded kernel route with ``fold_emit`` (each level emits the next
trip's tile summaries, JAX's ``PYITD_FOLD_EMIT``) against the route without
it, on the wrappers' plain versions, and against JAX's ``fold_emit`` route.

The shard layouts (``chip_smoke.fold_emit_layouts``) put the shard's last
sample, which the emitting level leaves out, mid-tile (``n_loc = 2 * TILE
+ 700``), on a tile's first sample (``2 * TILE + 1``), on a tile's last
sample (``2 * TILE``) and in a single partial tile (``512``).  The rows
(``chip_smoke.fold_emit_signal``) hold a spike on a tile's first sample
inside a shard (or, with one tile a shard, on shard 1's first sample), a
spike on a shard's first sample, NaN across a shard boundary, and a row
that stops flat beside rows that run to the budget.  Each case must give:

* ``_sift_local_kernel(fold_emit=True)`` bit for bit the route without it,
  and ``sharded_itd_sift`` under ``PYITD_FOLD_EMIT=1`` the same;
* ``complete_summaries(interior_summaries(b, s), b, s)`` equal to
  ``level_summaries(b, s)`` on the input and on its first baseline, with
  the interior summaries leaving samples out where the layout says;
* one ``level_summaries`` call per sift with ``fold_emit``, one per trip
  without it, at the same collectives.

At ``n_loc = 512`` the port is held against JAX's ``sharded_itd_sift(...,
backend="pallas")`` under ``PYITD_FOLD_EMIT=1`` in interpret mode on JAX's
virtual CPU devices (the signal of ``tests/test_sharded.py:290-330``, which
holds JAX's two routes bitwise, as the tests above hold the port's): counts
and reasons equal, the correction to ``1e-5 * max|x|`` (the bar of
``tests/test_torch_sharded.py`` for the kernel route: XLA on the CPU
contracts ``a*b+c`` in f32, PyTorch does not), the rotations to ``1e-4 *
max|x|``.  On the chirp row with NaN that contraction moves the rotations
by 6.8e-4 (``max|x|`` is 8): the port's route without ``fold_emit`` reads
the same distance from JAX's pallas and XLA routes without it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import bitwise_equal, fold_emit_layouts, fold_emit_signal
from pyitd_tpu.parallel.sharded import make_mesh
from pyitd_tpu.parallel.sharded import sharded_itd_sift as jax_sharded_sift
from pyitd_tpu_torch.ops import cuda_fill as cf
from pyitd_tpu_torch.parallel import LocalGroup, sharded_itd_sift
from pyitd_tpu_torch.parallel import sharded as sh
from pyitd_tpu_torch.utils.interop import from_numpy

torch.set_num_threads(1)

LAYOUTS = fold_emit_layouts()


def same_result(a, b) -> bool:
    """Two tuples of tensors bit for bit (NaN equal to NaN)."""
    return all(bitwise_equal(p, q) for p, q in zip(a, b))


def shard_args(b3: torch.Tensor, group, n_global: int) -> cf.ShardArgs:
    """The shard arguments the trip loop gives the kernels for ``b3``."""
    s_local, rows, n_loc = b3.shape
    offset = (group.ranks(b3.device) * n_loc).to(torch.int32)
    halo_l, halo_r = sh._shard_halos(b3, group)
    return cf.ShardArgs(n_global, offset.repeat_interleave(rows),
                        halo_l.reshape(-1), halo_r.reshape(-1))


@pytest.mark.parametrize("seq", [2, 4])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_fold_emit_is_bitwise_the_default_route(layout, seq, monkeypatch):
    """Both endpoint modes, stop A beside stop B: the ``fold_emit`` route,
    explicit and through the environment flag, bit for bit the default."""
    monkeypatch.setenv("PYITD_FOLD_EMIT", "1")
    n_loc = LAYOUTS[layout]
    xt = torch.from_numpy(fold_emit_signal(n_loc, seq))
    group = LocalGroup(seq)
    x3, n = group.to_shards(xt)
    for mode, mi in (("reference", 6), ("natural", 2)):
        want = sh._sift_local_kernel(x3, group, n, mi, mode, fold_emit=False)
        got = sh._sift_local_kernel(x3, group, n, mi, mode, fold_emit=True)
        assert same_result(got, want), (mode, mi)
        # the flag through the public entry point
        env = sharded_itd_sift(xt, group, mi, endpoint_mode=mode,
                               backend="kernel")
        assert same_result(env, (group.from_shards(want[0], n), want[1],
                                 want[2], group.from_shards(want[3], n)))
        if mode == "reference":
            assert sorted(set(want[2].tolist())) == [1, 2]


@pytest.mark.parametrize("seq", [2, 4])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_interior_completed_is_level_summaries(layout, seq):
    """The plain versions' contract on the input and its first baseline;
    the emitting level's interior summaries are the plain ones, and they
    leave out what ``tile_scan`` completes."""
    n_loc = LAYOUTS[layout]
    group = LocalGroup(seq)
    x3, n = group.to_shards(torch.from_numpy(fold_emit_signal(n_loc, seq)))
    s = shard_args(x3, group, n)
    states, _ = cf.tile_scan(cf.level_summaries(x3.reshape(-1, n_loc), s),
                             totals=True)
    zeros = (torch.full((s.offset.shape[0], 2), -1, dtype=torch.int32),
             torch.zeros(s.offset.shape[0], 2))
    s = s._replace(b_first=x3.reshape(-1, n_loc)[:, 0],
                   b_last=x3.reshape(-1, n_loc)[:, -1], pre_pos=zeros[0],
                   pre_val=zeros[1], suf_pos=zeros[0], suf_val=zeros[1])
    lvl = cf.sift_level(x3.reshape(-1, n_loc), states, shard=s, emit=True)
    base3 = lvl.baseline.view(x3.shape)
    for b3 in (x3, base3):
        b = b3.reshape(-1, n_loc)
        sb = shard_args(b3, group, n)
        interior = cf.interior_summaries(b, sb)
        whole = cf.level_summaries(b, sb)
        assert same_result(cf.complete_summaries(interior, b, sb), whole)
        assert bool((interior.cnt <= whole.cnt).all())
        assert bool((interior.cnt < whole.cnt).any())
        # the scan of the completed summaries is the scan of the whole ones
        for a, w in zip(cf.tile_scan(interior, totals=True, edges_from=b,
                                     shard=sb),
                        cf.tile_scan(whole, totals=True)):
            assert same_result(a, w)
    assert same_result(lvl.interior,
                           cf.interior_summaries(lvl.baseline, s))


def test_shard_last_sample_is_completed_against_the_next_shard():
    """A knot that only the next shard's first sample makes: the shard's
    last sample is a maximum because halo_r is lower, in each layout; the
    interior summaries leave it out and the completion finds it."""
    for n_loc in LAYOUTS.values():
        seq = 2
        x = np.tile(np.arange(seq * n_loc, dtype=np.float32), (1, 1))
        x[0, n_loc:] = -x[0, n_loc:]    # shard 1 falls away from shard 0
        group = LocalGroup(seq)
        x3, n = group.to_shards(torch.from_numpy(x))
        b = x3.reshape(-1, n_loc)
        s = shard_args(x3, group, n)
        interior = cf.interior_summaries(b, s)
        whole = cf.level_summaries(b, s)
        assert int(whole.cnt[0].sum()) == int(interior.cnt[0].sum()) + 2
        assert int(whole.fpos[0, -1, 0]) == n_loc - 1
        assert same_result(cf.complete_summaries(interior, b, s), whole)


@pytest.mark.parametrize("fold_emit", [False, True])
def test_summary_passes_and_collectives(fold_emit, monkeypatch):
    """With ``fold_emit`` the input alone is summarised; the scans complete
    the emitted summaries; the collectives stay 2 halos, 1 gather and 1 sum
    a trip."""
    calls = {"level_summaries": 0, "tile_scan": 0, "tile_scan_shard": 0,
             "sift_level": 0, "sift_level_emit": 0}

    def counted(name):
        real = getattr(cf, name + "_cuda")

        def fn(*args, **kw):
            calls[name] += 1
            if name == "tile_scan":
                calls["tile_scan_shard"] += kw.get("shard") is not None
            if name == "sift_level":
                calls["sift_level_emit"] += bool(kw.get("emit"))
            return real(*args, **kw)
        monkeypatch.setattr(cf, name + "_cuda", fn)

    for name in ("level_summaries", "tile_scan", "sift_level"):
        counted(name)
    mi, seq = 8, 4
    trips = mi + 3
    group = LocalGroup(seq)
    x3, n = group.to_shards(torch.from_numpy(fold_emit_signal(512, seq)))
    sh._sift_local_kernel(x3, group, n, mi, "reference", fold_emit=fold_emit)
    emits = trips - 1 if fold_emit else 0
    assert calls == {"level_summaries": 1 if fold_emit else trips,
                     "tile_scan": trips, "tile_scan_shard": emits,
                     "sift_level": trips, "sift_level_emit": emits}
    assert group.calls == {"halo": 2 * trips, "all_gather": trips,
                           "all_reduce_sum": trips, "all_reduce_min": 0}


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs 2 virtual devices")
def test_n_loc_512_matches_jax_fold_emit(monkeypatch):
    """n_loc = 512 over 2 shards (tests/test_sharded.py:290-330's smallest
    layout and signal) against JAX's pallas route under the flag."""
    monkeypatch.setenv("PYITD_FOLD_EMIT", "1")
    n_loc = 512
    n = 2 * n_loc
    rng = np.random.default_rng(3)
    t = np.linspace(0, 2 * np.pi, n)
    x = np.stack([
        np.sin(15 * t) + 0.1 * rng.normal(size=n),
        np.sin(5 * t * (1 + 0.2 * t)) + 0.05 * rng.normal(size=n),
    ]).astype(np.float32)
    x[0, n_loc] = 8.0
    x[1, n_loc - 1:n_loc + 2] = np.nan
    want = jax_sharded_sift(jnp.asarray(x), make_mesh(2, seq=2), 4,
                            backend="pallas")
    got = sharded_itd_sift(from_numpy(x), LocalGroup(2), 4, backend="kernel")
    rot, ncomp, reason, corr = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(got[1].numpy(), ncomp)
    np.testing.assert_array_equal(got[2].numpy(), reason)
    scale = float(np.nanmax(np.abs(x)))
    np.testing.assert_allclose(got[0].numpy(), rot, rtol=0,
                               atol=1e-4 * scale, equal_nan=True)
    np.testing.assert_allclose(got[3].numpy(), corr, rtol=0,
                               atol=1e-5 * scale, equal_nan=True)
