"""The shard-aware sift kernels with ``fold_emit`` on an NVIDIA GPU: the
emitting ``sift_level`` on time shards and ``tile_scan`` completing its
interior summaries with the shard arguments, each bitwise its plain version
on ``chip_smoke.fold_emit_layouts`` (the shard's last sample mid-tile, on a
tile's first and on a tile's last sample, in one partial tile) at 2 and 4
shards, with and without the sift's bookkeeping; the completed scan bitwise
the scan of ``level_summaries`` of the same baseline; and the launches of
one sharded sift under ``PYITD_FOLD_EMIT=1``.  Needs a card and nvcc, so it
is marked ``cuda`` and skips where ``torch.cuda.is_available()`` is false.
Run on the card with ``python -m pytest --noconftest
tests/test_torch_cuda_fold_emit.py -q``.
"""
import pytest
import torch

from chip_smoke import bitwise_equal, fold_emit_layouts, fold_emit_signal
from pyitd_tpu_torch import itd_sift
from pyitd_tpu_torch.ops import cuda_fill as cf
from pyitd_tpu_torch.parallel import LocalGroup, sharded_itd_sift
from pyitd_tpu_torch.parallel.sharded import _shard_halos

pytestmark = pytest.mark.cuda

LAYOUTS = fold_emit_layouts()


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def shard_args(b3: torch.Tensor, group, n_global: int) -> cf.ShardArgs:
    """The trip loop's shard arguments for ``b3`` (S, rows, n_loc)."""
    s, rows, n_loc = b3.shape
    offset = (torch.arange(s, device=b3.device) * n_loc).to(
        torch.int32).repeat_interleave(rows)
    halo_l, halo_r = _shard_halos(b3, group)
    return cf.ShardArgs(n_global, offset, halo_l.reshape(-1),
                        halo_r.reshape(-1))


def all_equal(a, b) -> bool:
    return all(bitwise_equal(p, q) for p, q in zip(a, b))


@pytest.mark.parametrize("seq", [2, 4])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_emitting_level_and_edge_scan_bitwise_plain(device, layout, seq):
    n_loc = LAYOUTS[layout]
    group = LocalGroup(seq)
    x3, n = group.to_shards(
        torch.from_numpy(fold_emit_signal(n_loc, seq)).to(device))
    x2 = x3.reshape(-1, n_loc)
    rows = x2.shape[0]
    shard = shard_args(x3, group, n)
    states, _ = cf.tile_scan_cuda(cf.level_summaries_cuda(x2, shard),
                                  totals=True)
    # made-up neighbours: knots 1 and 3 samples before each shard and 0
    # and 2 after it, none past the global ends
    gen = torch.Generator(device=device).manual_seed(rows)
    val = torch.randn((4, rows, 2), generator=gen, device=device)
    off, end = shard.offset, shard.offset + n_loc
    pre = torch.stack([off - 1, off - 3], -1)
    pre = torch.where(pre >= 0, pre, -1).contiguous()
    suf = torch.stack([end, end + 2], -1)
    suf = torch.where(suf < n, suf, -1).contiguous()
    full = shard._replace(
        b_first=val[2, :, 0].contiguous(), b_last=val[3, :, 0].contiguous(),
        pre_pos=pre, pre_val=torch.where(pre >= 0, val[0], 0.0),
        suf_pos=suf, suf_val=torch.where(suf >= 0, val[1], 0.0))
    carry = cf.SiftCarry.zeros(rows, device)
    flags = cf.stop_flags(states.nex, carry, 1, 8)
    states = states._replace(flags=flags)
    book = dict(rotp=x2 * 0.5, pbase=x2 * 0.25, perr=x2 * 1e-8,
                comp=x2 * 1e-9)
    cf.reset_launches()
    for mode in ("reference", "natural"):
        for kw in ({}, book):
            row_k, row_p = torch.empty_like(x2), torch.empty_like(x2)
            extra_k = dict(kw, out_row=row_k) if kw else {}
            extra_p = dict(kw, out_row=row_p) if kw else {}
            lk = cf.sift_level_cuda(x2, states, endpoint_mode=mode,
                                    shard=full, emit=True, **extra_k)
            lp = cf.sift_level(x2, states, endpoint_mode=mode, shard=full,
                               emit=True, **extra_p)
            assert all_equal(lk[:3], lp[:3]), (mode, bool(kw))
            assert all_equal(lk.interior, lp.interior), (mode, bool(kw))
            if kw:
                assert bitwise_equal(lk.comp, lp.comp)
                assert bitwise_equal(row_k, row_p)
            # the next trip's scan, with the halos of this baseline
            sb = shard_args(lk.baseline.view(x3.shape), group, n)
            ek = cf.tile_scan_cuda(lk.interior, totals=True,
                                   edges_from=lk.baseline, shard=sb)
            ep = cf.tile_scan(lp.interior, totals=True,
                              edges_from=lp.baseline, shard=sb)
            whole = cf.tile_scan_cuda(
                cf.level_summaries_cuda(lk.baseline, sb), totals=True)
            for a, b, w in zip(ek, ep, whole):
                assert all_equal(a, b) and all_equal(a, w), (mode, bool(kw))
    assert cf.MODE_LAUNCHES["sift_level_shard_emit"] == 4
    assert cf.MODE_LAUNCHES["tile_scan_shard_edges"] == 4


def test_fold_emit_sharded_sift_launches(device, monkeypatch):
    """One sharded sift of ``max_iteration = 8`` under the flag: one
    ``level_summaries``, 11 scans and 11 levels, 10 of each completing or
    emitting on time shards; bitwise the route without the flag and the
    unsharded kernel sift."""
    x = torch.from_numpy(
        fold_emit_signal(LAYOUTS["mid-tile"], 4)).to(device)
    want = sharded_itd_sift(x, LocalGroup(4), 8)
    monkeypatch.setenv("PYITD_FOLD_EMIT", "1")
    group = LocalGroup(4)
    cf.reset_launches()
    got = sharded_itd_sift(x, group, 8)
    torch.cuda.synchronize()
    assert cf.LAUNCHES == {
        "level_summaries": 1, "tile_scan": 11, "sift_level": 11, "fill2": 0,
        "linear_fill2": 0, "fillv": 0, "segsum": 0, "bwd_knots": 0,
        "bwd_pre": 0, "bwd_post": 0}
    assert cf.MODE_LAUNCHES == {
        "sift_level_book": 10, "sift_level_emit": 10,
        "sift_level_shard_emit": 10, "tile_scan_edges": 10,
        "tile_scan_shard_edges": 10}
    assert group.calls == {"halo": 22, "all_gather": 11,
                           "all_reduce_sum": 11, "all_reduce_min": 0}
    assert all_equal(got, want)
    ref = itd_sift(x, 8, store_baselines=False)
    assert all_equal(got, (ref.rotations, ref.num_components,
                           ref.stop_reason, ref.correction))
