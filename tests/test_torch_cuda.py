"""The kernels against their plain PyTorch versions on an NVIDIA GPU:
``chip_smoke.py``'s phase 2 under pytest.  Needs a card and nvcc, so it is
marked ``cuda`` and skips where ``torch.cuda.is_available()`` is false.
Run on the card with ``python -m pytest --noconftest tests/test_torch_cuda.py
-q``.

The sift kernels and the fills are bitwise (NaN equal to NaN): the kernels
are built with ``-fmad=false`` and PyTorch's eager kernels contract nothing
across ops.  ``segsum`` is exact on integer-valued inputs and within
``segsum_error_bound`` on real ones; the one-pass look-back scan behind the
three scan wrappers also runs ``chip_smoke.scan_protocol_cases`` (rows and
arrays off a 16-byte boundary, 1 tile, 1 tile + 1, 245 tiles, a row with no
mark, more blocks than the card holds at once) and gives the same bits on
every call; the level adjoint on the kernels is
held against the plain route as ``tests/test_pallas_fill.py:394-404`` holds
JAX's two routes; the sift gradient against the plain structural route.
The level adjoint's own kernels (``bwd_knots``, ``bwd_pre``, ``bwd_post``)
equal their plain versions (rtol = atol = 0, NaN equal to NaN) on
``chip_smoke.level_bwd_cases`` (edge shapes, rows of 2 to 5 samples,
arrays off a 16-byte boundary, 256 x 16,384 and 8 x 1,048,576), the sift
gradient equals the same chain with those three swapped for their plain
versions, and they refuse what they cannot take.
The cubic tier's kernels (K5-K8 and the interface solve) are bitwise their
plain versions, and its ``"fills"`` route bitwise the plain route, also with
knots and NaN on K7's run and SPIKE-block edges; K7 alone on
``tools/cubic_bench.py::spike_cases`` and K5 alone on the tile-edge shapes;
the interface solve alone at 1 to 8,192 SPIKE blocks (its state in shared
memory up to 2,048, in a scratch beyond) on
``tools/cubic_bench.py::interface_rows``, and once a level in the MEITD
ensemble at the benchmark's 32 x 32,768.  The shard-aware sift
kernels (the port of K9) are bitwise their plain versions, and
``sharded_itd_sift`` on them is bitwise the unsharded kernel sift on
``chip_smoke.sharded_cases``.  The cubic tier's callers: the MEITD
ensemble and the 2-D ensemble through K5-K8, every launch bitwise its
plain version and the whole result bitwise the plain route.
The sift's trips without a summary pass: every mode of the level kernels
(``sift_level`` emitting interior summaries, ``tile_scan`` completing them)
bitwise its plain version on ``tools/level_bench.py::edge_cases``, the same
bits on 20 calls, and 1 / 11 / 11 launches for the 8-iteration sift.
The FFT family (EFD, modified EFD, the sine sift, the cascade iteration)
launches no kernel of the repo: on the card it is held against the port
on the CPU, its template baselines bitwise unchanged under TF32-permitting
``"high"`` matmul precision, and its moment solves never sequential.
The rest of ``decomp/`` launches no kernel of the repo either: streaming
(scalar and IQ), the transforms, FABADA, SVMD and AFT against the port on
the CPU; the one-hop step and the channel split bitwise the replay;
FABADA's and SVMD's device state machines in a CUDA graph bitwise the same
blocks eager and the per-iteration eager loop.
"""
import numpy as np
import pytest
import torch

from chip_smoke import (bad_trips, check_bwd_pre_trips, check_level_bwd,
                        check_scans, device_launches, equal_values,
                        level_bwd_cases, replay_grad, scan_protocol_cases,
                        sharded_cases, sift_loss)
from pyitd_tpu_torch import (ITD, cubic_baseline_extract, itd_sift,
                             linear_baseline_extract)
from pyitd_tpu_torch.ops import cuda_cubic, cuda_fill
from pyitd_tpu_torch.ops.cubic_baseline import _odd_reflect_ends
from pyitd_tpu_torch.ops.linear_baseline import (knot_mask,
                                                 structural_level_bwd)
from pyitd_tpu_torch.tools.cubic_bench import edge_cases as spike_edges
from pyitd_tpu_torch.tools.cubic_bench import (interface_rows,
                                               recorded_interface,
                                               spike_cases)
from pyitd_tpu_torch.tools.level_bench import check_level, edge_cases, same

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _cases():
    rng = np.random.default_rng(2)
    t = np.linspace(0, 2 * np.pi, 9000)
    x = np.stack([
        np.sin(20 * t) + 0.1 * rng.normal(size=t.size),
        np.sin(7 * t) * (1 + 0.1 * t) + 0.05 * rng.normal(size=t.size),
    ]).astype(np.float32)
    x[1, 4000:4002] = np.nan
    yield "nan-pair", x
    for rows, n in [(3, 8192), (2, 8192 + 128), (2, 130), (2, 2)]:
        tt = np.linspace(0, 2 * np.pi, n)
        yield f"{rows}x{n}", (np.sin(7 * tt)[None] + 0.4 * rng.normal(
            size=(rows, n))).astype(np.float32)
    yield "constant", np.ones((2, 8192), np.float32)


CASES = list(_cases())
SHARDED_CASES = list(sharded_cases())


def bitwise_equal(a, b) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        same = a.view(torch.int32) == b.view(torch.int32)
        return bool((same | (torch.isnan(a) & torch.isnan(b))).all())
    return bool((a == b).all())


@pytest.mark.parametrize("mode", ["reference", "natural"])
@pytest.mark.parametrize("name,x", CASES, ids=[c[0] for c in CASES])
def test_kernel_sift_is_bitwise_plain(device, name, x, mode):
    xt = torch.from_numpy(x).to(device)
    for max_it in (2, 5):
        cuda_fill.reset_launches()
        a = itd_sift(xt, max_it, endpoint_mode=mode)
        assert cuda_fill.LAUNCHES["sift_level"] == max_it + 3
        b = itd_sift(xt, max_it, endpoint_mode=mode, backend="torch")
        for f in a._fields:
            assert bitwise_equal(getattr(a, f), getattr(b, f)), (max_it, f)
    la = linear_baseline_extract(xt, endpoint_mode=mode)
    lb = linear_baseline_extract(xt, endpoint_mode=mode, backend="torch")
    for f in la._fields:
        assert bitwise_equal(getattr(la, f), getattr(lb, f)), f


LEVEL_CASES = list(edge_cases())


@pytest.mark.parametrize("name,x", LEVEL_CASES,
                         ids=[c[0] for c in LEVEL_CASES])
def test_level_kernel_modes_are_bitwise_plain(device, name, x):
    """``level_summaries``, ``tile_scan`` with and without edge completion
    and ``sift_level`` with and without bookkeeping and emission against
    their plain versions; the completed interior summaries against
    ``level_summaries`` of the baseline."""
    check_level(torch.from_numpy(x).to(device), name)


@pytest.mark.parametrize("shape", [(3, 9001), (8, 1_000_000)])
def test_level_kernels_give_the_same_bits_on_every_call(device, shape):
    rng = np.random.default_rng(shape[1])
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)
    summ = cuda_fill.level_summaries_cuda(x)
    states = cuda_fill.tile_scan_cuda(summ)
    lvl = cuda_fill.sift_level_cuda(x, states, emit=True)
    edges = cuda_fill.tile_scan_cuda(lvl.interior, edges_from=lvl.baseline)
    row = torch.empty_like(x)
    kw = dict(rotp=lvl.rotation, pbase=x, perr=lvl.sub_err, comp=x * 0,
              emit=True)
    carry = cuda_fill.SiftCarry.zeros(shape[0], device)
    book_states = cuda_fill.tile_scan_cuda(summ, carry, 1, 8)
    book = cuda_fill.sift_level_cuda(x, book_states, out_row=row, **kw)
    first_row = row.clone()
    for _ in range(19):
        assert same(tuple(cuda_fill.level_summaries_cuda(x)), tuple(summ))
        assert same(tuple(cuda_fill.sift_level_cuda(x, states, emit=True)),
                    tuple(lvl))
        assert same(tuple(cuda_fill.tile_scan_cuda(
            lvl.interior, edges_from=lvl.baseline)), tuple(edges))
        assert same(tuple(cuda_fill.sift_level_cuda(
            x, book_states, out_row=row, **kw)), tuple(book))
        assert same(row, first_row)


def test_sift_launches_one_summary_pass(device):
    """The 8-iteration sift: one ``level_summaries`` (of the input), and one
    ``tile_scan`` and one ``sift_level`` per extraction; every trip's scan
    completes the summaries the level before it emitted."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(4, 20000)).astype(np.float32))
    cuda_fill.reset_launches()
    res = itd_sift(x.to(device), 8, store_baselines=False)
    assert res.stop_reason.tolist() == [2] * 4
    assert cuda_fill.LAUNCHES == {
        "level_summaries": 1, "tile_scan": 11, "sift_level": 11, "fill2": 0,
        "linear_fill2": 0, "fillv": 0, "segsum": 0, "bwd_knots": 0,
        "bwd_pre": 0, "bwd_post": 0}
    assert cuda_fill.MODE_LAUNCHES == {
        "sift_level_book": 10, "sift_level_emit": 10,
        "sift_level_shard_emit": 0, "tile_scan_edges": 10,
        "tile_scan_shard_edges": 0}


def test_itd_class_runs_numpy_f64_on_the_kernels(device):
    """``ITD()`` casts a numpy f64 signal to f32 and sifts it on the
    kernels, bitwise the plain f32 sift."""
    t = np.linspace(0, 2 * np.pi, 9000)
    s = np.sin(20 * t * (1 + 0.2 * t)) + t ** 2 + np.sin(13 * t)
    cuda_fill.reset_launches()
    comps = ITD()(s)
    assert cuda_fill.LAUNCHES["sift_level"] == 11 + 3
    want = itd_sift(torch.from_numpy(s).float().to(device), 11,
                    backend="torch")
    assert bitwise_equal(comps, want.rotations[:int(want.num_components)])
    with pytest.raises(ValueError, match="f32"):
        ITD(dtype=None)(s)


def test_kernel_route_refuses_what_it_cannot_take(device):
    with pytest.raises(ValueError, match="f32"):
        itd_sift(torch.zeros(2, 64, dtype=torch.float64, device=device), 2)
    with pytest.raises(NotImplementedError, match="structural"):
        linear_baseline_extract(
            torch.zeros(2, 64, device=device, requires_grad=True))


def _masks(x):
    """The knot mask, and random marks with seams, an empty row and a
    full one."""
    rng = np.random.default_rng(x.shape[1])
    m = rng.random(x.shape) < 0.01
    m[0, [i for i in (0, 4095, 4096, 4097, 8191, 8192) if i < x.shape[1]]] \
        = True
    m[-1] = False
    if x.shape[0] > 2:
        m[1] = True
    return knot_mask(x), torch.from_numpy(m).to(x.device)


@pytest.mark.parametrize("name,x", CASES, ids=[c[0] for c in CASES])
def test_fills_are_bitwise_plain(device, name, x):
    xt = torch.from_numpy(x).to(device)
    for mask in _masks(xt):
        for reverse in (False, True):
            for strict in (False, True):
                got = cuda_fill.fill2_cuda(xt, mask, reverse, strict)
                want = cuda_fill.fill2(xt, mask, reverse, strict)
                for a, b in zip(got, want):
                    assert bitwise_equal(a, b), (reverse, strict)
            assert bitwise_equal(cuda_fill.fillv_cuda(xt, mask, reverse),
                                 cuda_fill.fillv(xt, mask, reverse))


@pytest.mark.parametrize("name,x", CASES, ids=[c[0] for c in CASES])
def test_segsum_exact_on_integers_and_within_bound(device, name, x):
    xt = torch.from_numpy(x).to(device)
    rng = np.random.default_rng(7)
    ints = torch.from_numpy(rng.integers(-8, 9, size=(2,) + x.shape).astype(
        np.float32)).to(device)
    for flags in _masks(xt):
        for reverse in (False, True):
            for strict in (False, True):
                for nch in (1, 2):
                    got = cuda_fill.segsum_cuda(tuple(ints[:nch]), flags,
                                                reverse, strict)
                    want = cuda_fill.segsum(tuple(ints[:nch]), flags, reverse,
                                            strict)
                    for a, b in zip(got, want):
                        assert torch.equal(a, b)
                got = cuda_fill.segsum_cuda(xt, flags, reverse, strict)
                want = cuda_fill.segsum(xt, flags, reverse, strict)
                bound = cuda_fill.segsum_error_bound(xt, flags, reverse,
                                                     strict)
                fin = torch.isfinite(want)
                assert bitwise_equal(got[~fin], want[~fin])
                err = (got.double() - want.double()).abs()[fin]
                assert bool((err <= bound[fin]).all())


PROTOCOL_CASES = list(scan_protocol_cases())


def _protocol_signal(rows, n, device):
    rng = np.random.default_rng(rows * n)
    t = np.linspace(0, 2 * np.pi, n)
    return torch.from_numpy((np.sin(7 * t)[None] + 0.4 * rng.normal(
        size=(rows, n))).astype(np.float32)).to(device)


@pytest.mark.parametrize("name,rows,n,offsets", PROTOCOL_CASES,
                         ids=[c[0] for c in PROTOCOL_CASES])
def test_scans_on_the_protocol_shapes(device, name, rows, n, offsets):
    """fill2 and fillv bitwise, segsum exact on integers and within its
    bound (``chip_smoke.check_scans`` raises otherwise), on the shapes that
    try the look-back protocol, the kernel's scalar head and tail and its
    scalar stores."""
    err, ratio = check_scans(name, _protocol_signal(rows, n, device), offsets)
    torch.cuda.synchronize()
    assert ratio <= 1.0 and np.isfinite(err)


@pytest.mark.parametrize("rows,n", [(256, 16384), (8, 1_000_000)])
def test_segsum_gives_the_same_bits_on_every_call(device, rows, n):
    """The look-back folds tile aggregates in an order fixed by the data,
    so block timing cannot change a sum."""
    x = _protocol_signal(rows, n, device)
    flags = knot_mask(x)
    flags[-1] = False
    chans = (x, x.flip(-1).contiguous())
    for reverse in (False, True):
        first = cuda_fill.segsum_cuda(chans, flags, reverse)
        for _ in range(19):
            again = cuda_fill.segsum_cuda(chans, flags, reverse)
            assert all(bitwise_equal(a, b) for a, b in zip(again, first))


def test_scan_calls_are_one_launch_each(device):
    x = _protocol_signal(3, 9001, device)
    mask = knot_mask(x)

    def calls():
        cuda_fill.fill2_cuda(x, mask, True, True)
        cuda_fill.fillv_cuda(x, mask)
        cuda_fill.segsum_cuda((x, x), mask, True)
        cuda_fill.segsum_cuda(x, mask, False, True)

    calls()
    assert device_launches(calls, "scan_") == 4
    assert device_launches(calls, "scan_lookback") == 4


def test_a_protocol_fault_is_a_cuda_error_not_a_hang(device):
    """``tools/scan_fault.py`` plants an unpublished tile in a temporary
    copy of the kernel: the look-back's bounded spin must trap."""
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m", "pyitd_tpu_torch.tools.scan_fault"],
        capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "CUDA error" in proc.stdout


ADJOINT = ("bwd_knots", "bwd_pre", "bwd_post")
BWD_CASES = list(level_bwd_cases())


@pytest.mark.parametrize("name,x,offset", BWD_CASES,
                         ids=[c[0] for c in BWD_CASES])
def test_level_adjoint_kernels_equal_plain(device, name, x, offset):
    """Each of the adjoint's own kernels equals its plain version to rtol =
    atol = 0 (``chip_smoke.check_level_bwd`` raises otherwise), one launch
    per call."""
    cuda_fill.reset_launches()
    check_level_bwd(name, torch.from_numpy(x).to(device), offset)
    torch.cuda.synchronize()
    assert [cuda_fill.LAUNCHES[k] for k in ADJOINT] == [1, 2, 2]


@pytest.mark.parametrize("shape", [(2, 9000), (256, 16384)])
def test_sift_grad_equals_its_plain_adjoint_chain(device, shape,
                                                  monkeypatch):
    """The sift gradient on the kernels equals the same route with the
    adjoint's three kernels swapped for their plain versions (the scans
    still the kernels), to rtol = atol = 0."""
    x = torch.from_numpy(CASES[0][1]).to(device) if shape == (2, 9000) \
        else _protocol_signal(*shape, device)

    def grad():
        xg = x.clone().requires_grad_()
        r = itd_sift(xg, 5, store_baselines=False)
        ((r.rotations ** 2).sum() + 0.7 * r.correction.sum()).backward()
        return xg.grad

    cuda_fill.reset_launches()
    got = grad()
    assert all(cuda_fill.LAUNCHES[k] == 7 for k in ADJOINT)
    with monkeypatch.context() as m:
        for k in ADJOINT:
            m.setattr(cuda_fill, f"{k}_cuda", getattr(cuda_fill, k))
        cuda_fill.reset_launches()
        want = grad()
        assert all(cuda_fill.LAUNCHES[k] == 0 for k in ADJOINT)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_bwd_post_takes_positions_of_a_faulty_fill(device):
    """Positions that are not the fills' of this mask, as a fill that drops
    its tile carry gives (``chip_smoke.FAULTS``: 0 where the tile holds no
    earlier or later knot), gather from wherever they point in the row, as
    the plain version does, and read nothing outside it."""
    from chip_smoke import _tile_carry_dropped

    x = _protocol_signal(3, 9001, device)
    g = [_protocol_signal(3, 9001, device).flip(-1).contiguous()
         for _ in range(3)]
    knots, f_next = cuda_fill.bwd_knots_cuda(x)
    fwd = _tile_carry_dropped(cuda_fill.fill2_cuda(x, knots), knots, False,
                              False)
    bwd = _tile_carry_dropped(cuda_fill.fill2_cuda(x, knots, True, True),
                              knots, True, True)
    pre = cuda_fill.bwd_pre_cuda(x, *g, fwd, bwd)
    seg_a = cuda_fill.segsum_cuda(pre[:2], f_next, reverse=True)
    seg_e = cuda_fill.segsum_cuda(pre[2:4], knots, strict=True)
    got = cuda_fill.bwd_post_cuda(knots, pre[4], seg_a, seg_e, fwd[2], bwd[0])
    torch.cuda.synchronize()
    want = cuda_fill.bwd_post(knots, pre[4], seg_a, seg_e, fwd[2], bwd[0])
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_adjoint_kernels_refuse_what_they_cannot_take(device):
    def calls(x):
        z = torch.zeros(3, 8, device=device)
        knots, _ = cuda_fill.bwd_knots(z)
        fwd = cuda_fill.fill2(z, knots)
        bwd = cuda_fill.fill2(z, knots, True, True)
        seg = (z, z)
        return (lambda: cuda_fill.bwd_knots_cuda(x),
                lambda: cuda_fill.bwd_pre_cuda(x, z, z, z, fwd, bwd),
                lambda: cuda_fill.bwd_post_cuda(knots, x, seg, seg, fwd[2],
                                                bwd[0]))

    cuda_fill.reset_launches()
    for x in (torch.zeros(3, 1, device=device),
              torch.zeros(3, 8, dtype=torch.float64, device=device),
              torch.zeros(3, 16, device=device)[:, ::2]):
        for call in calls(x):
            with pytest.raises(ValueError):
                call()
    assert all(cuda_fill.LAUNCHES[k] == 0 for k in ADJOINT)


@pytest.mark.parametrize("name,x,offset", BWD_CASES,
                         ids=[c[0] for c in BWD_CASES])
def test_bwd_pre_on_the_trip_loops_inputs_equals_plain(device, name, x,
                                                       offset):
    """``bwd_pre`` as the reverse trip loop calls it equals its plain
    version to rtol = atol = 0 (``chip_smoke.check_bwd_pre_trips`` raises
    otherwise): four kinds of trip in two endpoint modes, one launch
    each."""
    cuda_fill.reset_launches()
    check_bwd_pre_trips(name, torch.from_numpy(x).to(device), offset)
    torch.cuda.synchronize()
    assert cuda_fill.LAUNCHES["bwd_pre"] == 8


@pytest.mark.parametrize("shape", [(256, 16384), (2, 1_000_000)])
def test_sift_grad_is_the_autograd_replay(device, shape):
    """The kernel sift's gradient (the reverse trip loop) equals autograd
    of the loop with structural levels on the kernels, bit for bit (NaN
    at the same samples), with and without stored baselines; the replay
    recomputes the inputs of all levels but the first, and every trip runs
    one level adjoint."""
    from pyitd_tpu_torch.decomp.itd import BWD_COUNTS

    x = _protocol_signal(*shape, device)
    for store in (False, True):
        before = dict(BWD_COUNTS)
        cuda_fill.reset_launches()
        xg = x.clone().requires_grad_()
        sift_loss(itd_sift(xg, 8, store_baselines=store)).backward()
        assert cuda_fill.LAUNCHES["bwd_pre"] == 10
        assert cuda_fill.LAUNCHES["sift_level"] == 11 + 9
        assert {k: v - before[k] for k, v in BWD_COUNTS.items()} == {
            "replayed_levels": 9, "reverse_trips": 10}
        assert equal_values(xg.grad, replay_grad(x, 8, store)), store


def test_bwd_pre_refuses_bad_trip_arguments(device):
    """Each argument of the reverse trip loop, wrong, is refused before a
    launch (``chip_smoke.bad_trips``)."""
    x = torch.linspace(0, 1, 24, device=device).reshape(3, 8).contiguous()
    cuda_fill.reset_launches()
    for what, call in bad_trips(x).items():
        with pytest.raises(ValueError):
            call()
    assert cuda_fill.LAUNCHES["bwd_pre"] == 0


def test_level_adjoint_on_kernels_against_plain(device):
    rng = np.random.default_rng(11)
    n = 8192 + 130
    t = np.linspace(0, 4 * np.pi, n)
    sig = np.stack([np.sin(9 * t) + 0.2 * rng.standard_normal(n),
                    rng.standard_normal(n)])
    x = torch.from_numpy(sig.astype(np.float32)).to(device)
    cts = [torch.from_numpy(rng.normal(size=sig.shape).astype(np.float32))
           .to(device) for _ in range(3)]
    cuda_fill.reset_launches()
    g_ker = structural_level_bwd(x, *cts, "reference")  # auto: the kernels
    assert cuda_fill.LAUNCHES["fill2"] == 2
    assert cuda_fill.LAUNCHES["segsum"] == 2
    assert [cuda_fill.LAUNCHES[k] for k in ADJOINT] == [1, 1, 1]
    g_tor = structural_level_bwd(x, *cts, "reference", fills="torch")
    torch.testing.assert_close(g_ker, g_tor, rtol=2e-4, atol=2e-4)
    g_true = structural_level_bwd(x.double(), *(c.double() for c in cts),
                                  "reference", fills="torch")
    err_ker = (g_ker.double() - g_true).abs().max().item()
    err_tor = (g_tor.double() - g_true).abs().max().item()
    assert err_ker <= err_tor * 1.5 + 1e-6, (err_ker, err_tor)


def test_sift_grad_on_kernels_against_plain_structural(device, monkeypatch):
    """Against the plain structural route to 1e-4 max|g|; against the same
    route with the scan wrappers swapped for their plain versions to
    5e-5 max|g| (``chip_smoke.py``'s phase 2 limit)."""
    x = torch.from_numpy(CASES[0][1]).to(device)
    for kw in ({}, {"store_baselines": False}, {"early_exit": True}):
        xk = x.clone().requires_grad_()
        cuda_fill.reset_launches()
        rk = itd_sift(xk, 5, **kw)
        ((rk.rotations ** 2).sum() + 0.7 * rk.correction.sum()).backward()
        levels = int(rk.num_components.max()) if kw.get("early_exit") \
            else 5 + 2
        assert cuda_fill.LAUNCHES["fill2"] == 2 * levels, kw
        assert cuda_fill.LAUNCHES["segsum"] == 2 * levels, kw
        assert all(cuda_fill.LAUNCHES[k] == levels for k in ADJOINT), kw
        with monkeypatch.context() as m:
            m.setattr(cuda_fill, "fill2_cuda", cuda_fill.fill2)
            m.setattr(cuda_fill, "segsum_cuda", cuda_fill.segsum)
            xs = x.clone().requires_grad_()
            rs = itd_sift(xs, 5, **kw)
            ((rs.rotations ** 2).sum() + 0.7 * rs.correction.sum()).backward()
        ok = ~torch.isnan(xs.grad)
        assert bitwise_equal(torch.isnan(xk.grad), ~ok)
        assert (xk.grad[ok] - xs.grad[ok]).abs().max() \
            <= 5e-5 * xs.grad[ok].abs().max()
        xp = x.clone().requires_grad_()
        rp = itd_sift(xp, 5, backend="torch", linear_backend="structural",
                      **kw)
        for f in rk._fields:
            assert bitwise_equal(getattr(rk, f).detach(),
                                 getattr(rp, f).detach()), f
        ((rp.rotations ** 2).sum() + 0.7 * rp.correction.sum()).backward()
        gk, gp = xk.grad, xp.grad
        assert bitwise_equal(torch.isnan(gk), torch.isnan(gp))
        ok = ~torch.isnan(gp)
        assert (gk[ok] - gp[ok]).abs().max() <= 1e-4 * gp[ok].abs().max()


# ---- the cubic tier: K5-K8 (csrc/cubic.cu, csrc/spike.cu) ----

def _cubic_cases():
    yield from CASES
    rng = np.random.default_rng(4)
    n = 3 * 4096 + 17   # across tiles and SPIKE blocks
    t = np.linspace(0, 6 * np.pi, n)
    yield "12305", np.stack([np.sin(40 * t) + 0.3 * rng.normal(size=n),
                             rng.normal(size=n)]).astype(np.float32)
    yield "short", rng.normal(size=(2, 64)).astype(np.float32)
    tt = np.arange(32.0)
    yield "tent", np.minimum(tt, 31 - tt)[None].astype(np.float32)
    yield from spike_edges(cuda_cubic.SPIKE_BLK, cuda_cubic.SPIKE_RUN)


CUBIC_CASES = list(_cubic_cases())


def _outs(out):
    return tuple(out) if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name,x", CUBIC_CASES,
                         ids=[c[0] for c in CUBIC_CASES])
def test_cubic_kernels_are_bitwise_plain(device, name, x, monkeypatch):
    """Each kernel against its plain version on the route's own inputs,
    and the route against the plain route, bitwise; one launch each."""
    xt = torch.from_numpy(x).to(device)
    plain = cuda_cubic.PLAIN
    diffs = []

    def checked(k, real):
        def fn(*args):
            out = real(*args)
            diffs.extend(k for a, b in zip(_outs(out), _outs(plain[k](*args)))
                         if not bitwise_equal(a, b))
            return out
        return fn

    cuda_cubic.reset_launches()
    with monkeypatch.context() as m:
        for k in plain:
            m.setattr(cuda_cubic, k, checked(k, getattr(cuda_cubic, k)))
        got = cubic_baseline_extract(xt, xt.shape[-1] + 2, min_extrema=0)
    assert not diffs
    assert cuda_cubic.LAUNCHES == {k: 1 for k in cuda_cubic.LAUNCHES}
    with monkeypatch.context() as m:
        m.setattr(cuda_fill, "level_states_cuda", cuda_fill.level_states)
        for k, fn in plain.items():
            m.setattr(cuda_cubic, k, fn)
        want = cubic_baseline_extract(xt, xt.shape[-1] + 2, min_extrema=0)
    for f in got._fields:
        assert bitwise_equal(getattr(got, f), getattr(want, f)), f


def test_cubic_f64_guard_and_gradient(device):
    """f64 in and out on the kernels; the pass-through guard; the gradient
    (autograd of the gather route) against the gather route's own."""
    x = torch.from_numpy(CASES[1][1]).to(device)
    r64 = cubic_baseline_extract(x.double(), x.shape[-1] + 2, min_extrema=0)
    r32 = cubic_baseline_extract(x, x.shape[-1] + 2, min_extrema=0)
    assert r64.baseline.dtype == torch.float64
    assert bitwise_equal(r64.baseline, r32.baseline.double())
    y = torch.sin(torch.linspace(0, 6, 256, device=device))[None]
    g = cubic_baseline_extract(y, 258, min_extrema=10)
    assert torch.equal(g.baseline, y) and not g.rotation.any()
    xk = x.double().clone().requires_grad_()
    (cubic_baseline_extract(xk, x.shape[-1] + 2, min_extrema=0).rotation
     ** 2).sum().backward()
    xg = x.double().clone().requires_grad_()
    rg = cubic_baseline_extract(xg, x.shape[-1] + 2, min_extrema=0,
                                eval_backend="gather")
    # the gradient's cotangent differs by the f32 forward's rounding
    (rg.rotation ** 2).sum().backward()
    ok = ~torch.isnan(xg.grad)
    assert bitwise_equal(torch.isnan(xk.grad), ~ok)
    assert (xk.grad[ok] - xg.grad[ok]).abs().max() \
        <= 1e-4 * xg.grad[ok].abs().max()


SPIKE_CASES = list(spike_cases(cuda_cubic.SPIKE_BLK, cuda_cubic.SPIKE_RUN))


@pytest.mark.parametrize("name,sys_", SPIKE_CASES,
                         ids=[c[0] for c in SPIKE_CASES])
def test_chained_block_spike_kernel_against_plain(device, name, sys_):
    """K7 bitwise its plain version (the partition solve) at the kernel's
    SPIKE_BLK / SPIKE_RUN, on systems with knots on run and block edges,
    a block without a knot and rows that end between runs."""
    m, *args = (torch.from_numpy(v).to(device) for v in sys_)
    cuda_cubic.reset_launches()
    got = cuda_cubic.spike_factors_cuda(m, *args)
    assert cuda_cubic.LAUNCHES["spike_factors"] == 1
    assert bitwise_equal(got, cuda_cubic.spike_factors(m, *args))
    u, w = cuda_cubic.chained_block_spike(m, *args)
    assert u.shape == m.shape and bool(torch.isfinite(u).all())


# a row length per count of SPIKE blocks; past 2,048 blocks the interface
# kernel keeps its state in a scratch
_SB = cuda_cubic.SPIKE_BLK
IFACE_N = {1: 300, 2: 2 * _SB - 5, 3: 3 * _SB - 1, 5: 4 * _SB + 77,
           16: 16 * _SB, 512: 512 * _SB - 77, 2048: 2048 * _SB,
           2049: 2048 * _SB + 1, 8192: 8192 * _SB}


@pytest.mark.parametrize("nblk", sorted(IFACE_N))
def test_interface_kernel_is_bitwise_plain(device, nblk):
    """The interface solve and the end moments on the cubic level's own
    inputs, bitwise their plain version, twice: rows with no interior
    knot, one, two, every sample a knot, many, and a guarded row."""
    n = IFACE_N[nblk]
    assert cuda_cubic.spike_pad(n) == nblk * _SB
    x = interface_rows(n, device)
    calls = []
    with recorded_interface(calls):
        cubic_baseline_extract(x, n + 2, min_extrema=10,
                               eval_backend="fills")
    (factors, mask), = calls
    del x
    assert sorted(mask.sum(-1).tolist())[:3] == [0, 1, 2]
    want = cuda_cubic.PLAIN["spike_interface_cuda"](factors, mask)
    for _ in range(2):
        cuda_cubic.reset_launches()
        got = cuda_cubic.spike_interface_cuda(factors, mask)
        assert cuda_cubic.LAUNCHES["spike_interface"] == 1
        for a, b in zip(got, want):
            assert bitwise_equal(a, b)


def test_ensemble_launches_one_interface_kernel_a_level(device, monkeypatch):
    """The benchmark's ensemble, 32 x 32,768 f64: one ``spike_interface``
    launch a cubic level, and the result bitwise the same ensemble with
    the wrapper swapped for its plain version."""
    from chip_smoke import ensemble_signal, same_result
    from pyitd_tpu_torch import meitd_ensemble
    from pyitd_tpu_torch.decomp import meitd as pm

    x = torch.from_numpy(ensemble_signal(32768)).to(device)

    def run():
        gen = torch.Generator(device=device).manual_seed(0)
        return meitd_ensemble(x, gen, 32, 0.1, 0.6)

    cuda_cubic.reset_launches()
    pm.reset_counts()
    got = run()
    torch.cuda.synchronize()
    assert pm.COUNTS["levels"] > 0
    assert cuda_cubic.LAUNCHES["spike_interface"] == pm.COUNTS["levels"]
    monkeypatch.setattr(cuda_cubic, "spike_interface_cuda",
                        cuda_cubic.PLAIN["spike_interface_cuda"])
    same_result(got, run(), "ensemble")


@pytest.mark.parametrize("name,x", LEVEL_CASES,
                         ids=[c[0] for c in LEVEL_CASES])
def test_cubic_ksite_kernel_against_plain(device, name, x):
    """K5 on the chunk layout and the knot bitmap bitwise ``cubic_ksite``
    on the tile-edge shapes: seams, NaN, plateaus, n = TILE + 1."""
    xt = torch.from_numpy(x).to(device)
    states = cuda_fill.level_states_cuda(xt)
    b_first, b_last = _odd_reflect_ends(xt)
    cuda_cubic.reset_launches()
    got = cuda_cubic.cubic_ksite_cuda(xt, states, b_first, b_last)
    assert cuda_cubic.LAUNCHES["cubic_ksite"] == 1
    assert bitwise_equal(got, cuda_cubic.cubic_ksite(xt, b_first, b_last))


# ---- the shard-aware sift kernels (the port of K9) ----

def _shard_rows(x, seq, device):
    """``x`` (rows, n) cut into ``seq`` time shards as kernel rows, with
    the :class:`ShardArgs` of the first pre-pass (halos from the neighbour
    shards, their own edge sample at the global ends)."""
    from pyitd_tpu_torch.parallel import LocalGroup
    from pyitd_tpu_torch.parallel.sharded import _shard_halos

    group = LocalGroup(seq)
    x3, n_global = group.to_shards(torch.from_numpy(x).to(device))
    s, rows, n_loc = x3.shape
    halo_l, halo_r = _shard_halos(x3, group)
    offset = (torch.arange(s, device=device) * n_loc).to(
        torch.int32).repeat_interleave(rows)
    return x3.reshape(s * rows, n_loc), cuda_fill.ShardArgs(
        n_global, offset, halo_l.reshape(-1), halo_r.reshape(-1))


@pytest.mark.parametrize("seq", [2, 4, 8])
@pytest.mark.parametrize("name,x", SHARDED_CASES,
                         ids=[c[0] for c in SHARDED_CASES])
def test_shard_aware_kernels_are_bitwise_plain(device, name, x, seq):
    """``level_summaries``, ``tile_scan`` (with totals) and ``sift_level``
    with shard arguments against their plain versions on the same inputs;
    the seeds of ``sift_level`` are made-up knots far before and after."""
    x2, shard = _shard_rows(x, seq, device)
    rows = x2.shape[0]
    sk = cuda_fill.level_summaries_cuda(x2, shard)
    sp = cuda_fill.level_summaries(x2, shard)
    for a, b in zip(sk, sp):
        assert bitwise_equal(a, b)
    (tk, totk), (tp, totp) = (cuda_fill.tile_scan_cuda(sk, totals=True),
                              cuda_fill.tile_scan(sp, totals=True))
    for a, b in zip(tk + totk, tp + totp):
        assert bitwise_equal(a, b)
    gen = torch.Generator(device=device).manual_seed(rows)
    val = torch.randn((4, rows, 2), generator=gen, device=device)
    # made-up neighbours: knots 1 and 3 samples before each shard and 0 and
    # 2 after it, none at the global ends
    off, end = shard.offset, shard.offset + x2.shape[1]
    pre = torch.stack([off - 1, off - 3], -1)
    pre = torch.where(pre >= 0, pre, -1).contiguous()
    suf = torch.stack([end, end + 2], -1)
    suf = torch.where(suf < shard.n_global, suf, -1).contiguous()
    full = shard._replace(
        b_first=val[2, :, 0].contiguous(), b_last=val[3, :, 0].contiguous(),
        pre_pos=pre, pre_val=torch.where(pre >= 0, val[0], 0.0),
        suf_pos=suf, suf_val=torch.where(suf >= 0, val[1], 0.0))
    for mode in ("reference", "natural"):
        lk = cuda_fill.sift_level_cuda(x2, tk, endpoint_mode=mode, shard=full)
        lp = cuda_fill.sift_level(x2, tk, endpoint_mode=mode, shard=full)
        for a, b in zip(lk[:3], lp[:3]):
            assert bitwise_equal(a, b), mode


@pytest.mark.parametrize("seq", [2, 4, 8])
@pytest.mark.parametrize("name,x", SHARDED_CASES,
                         ids=[c[0] for c in SHARDED_CASES])
def test_sharded_sift_is_bitwise_unsharded(device, name, x, seq, monkeypatch):
    """``sharded_itd_sift`` on the kernels against the unsharded kernel
    sift and against itself with every wrapper swapped for its plain
    version: stop A and stop B, both endpoint modes, launches and
    collectives per trip."""
    from pyitd_tpu_torch.parallel import LocalGroup, sharded_itd_sift

    xt = torch.from_numpy(x).to(device)
    for mode, max_it in (("reference", 6), ("natural", 2)):
        group = LocalGroup(seq)
        cuda_fill.reset_launches()
        got = sharded_itd_sift(xt, group, max_it, endpoint_mode=mode)
        trips = max_it + 3
        assert cuda_fill.LAUNCHES["sift_level"] == trips
        assert cuda_fill.LAUNCHES["level_summaries"] == trips
        assert group.calls == {"halo": 2 * trips, "all_gather": trips,
                               "all_reduce_sum": trips, "all_reduce_min": 0}
        ref = itd_sift(xt, max_it, endpoint_mode=mode, store_baselines=False)
        want = (ref.rotations, ref.num_components, ref.stop_reason,
                ref.correction)
        for a, b in zip(got, want):
            assert bitwise_equal(a, b), mode
        with monkeypatch.context() as m:
            for k in ("level_summaries", "tile_scan", "sift_level"):
                m.setattr(cuda_fill, k + "_cuda", getattr(cuda_fill, k))
            plain = sharded_itd_sift(xt, LocalGroup(seq), max_it,
                                     endpoint_mode=mode, backend="kernel")
        for a, b in zip(got, plain):
            assert bitwise_equal(a, b), mode


def test_sharded_cubic_on_the_card(device):
    """``sharded_cubic_baseline`` (plain PyTorch on the card) against the
    gather route of the whole signal, f64."""
    from pyitd_tpu_torch.parallel import LocalGroup, sharded_cubic_baseline

    x = torch.from_numpy(SHARDED_CASES[-1][1]).double().to(device)
    ref = cubic_baseline_extract(x, x.shape[-1] + 2, eval_backend="gather")
    for method in ("spike", "gather"):
        rot, base, nex = sharded_cubic_baseline(x, LocalGroup(4),
                                                method=method)
        assert torch.equal(nex, ref.num_extrema)
        torch.testing.assert_close(base, ref.baseline, rtol=0, atol=1e-9)
        torch.testing.assert_close(rot, ref.rotation, rtol=0, atol=1e-9)


def test_ensemble_on_the_kernels(device):
    """The MEITD ensemble (4 x 512) through K5-K8: every launch bitwise its
    plain version, the whole ensemble bitwise the plain route, the mean
    stack reconstructing the input."""
    from chip_smoke import counted, ensemble_signal, plain_cubic, same_result
    from pyitd_tpu_torch import meitd_ensemble

    x = torch.from_numpy(ensemble_signal(512)).to(device)

    def run():
        gen = torch.Generator(device=device).manual_seed(0)
        return meitd_ensemble(x, gen, 4, noise_scale=0.1)

    got, launches, _, counts, levels = counted(run)
    assert counts["trips"] > 0 and launches["spike_factors"] == len(levels)
    with plain_cubic():
        same_result(got, run(), "ensemble")
    assert (got.mean_stack.sum(0) - x).abs().max() <= 1e-10


def test_2d_ensemble_on_the_kernels(device):
    """``statistical_component`` of a 2 x 64 x 64 ensemble: 4 launches of
    each of K5-K8, each bitwise its plain version, the result bitwise the
    plain route."""
    from chip_smoke import counted, plain_cubic, tile_2d
    from pyitd_tpu_torch.decomp.itd2d import statistical_component

    img = torch.from_numpy(tile_2d(64)).to(device)

    def run():
        gen = torch.Generator(device=device).manual_seed(0)
        return statistical_component(img, gen, 2)

    got, launches, _, _, levels = counted(run)
    assert launches == {k: 4 for k in launches} and len(levels) == 4
    with plain_cubic():
        assert bitwise_equal(got, run())


# ---- the FFT family: no kernel of the repo; the card against the CPU ----

def _fft_signal(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / n
    return (np.cos(2 * np.pi * 30 * t) + 0.7 * np.cos(2 * np.pi * 90 * t)
            + 0.4 * np.cos(2 * np.pi * 200 * t) + 0.05 * rng.normal(size=n))


def test_efd_on_the_card_against_the_cpu(device):
    """EFD and the flipped-domain family of a noisy signal on the card:
    counts and integer bounds equal to the port on the CPU, bands to 1e-12
    (f64) and 1e-5 of max|x| (f32); no kernel of the repo launched."""
    from pyitd_tpu_torch import efd, efd_real, iterative_max

    x = np.stack([_fft_signal(4096, 0), _fft_signal(4096, 1)])
    cuda_cubic.reset_launches()
    cuda_fill.reset_launches()
    for dt, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        xc = torch.from_numpy(x).to(dt)
        got, want = efd(xc.to(device), 6), efd(xc, 6)
        assert torch.equal(got.count.cpu(), want.count)
        torch.testing.assert_close(got.bounds.cpu(), want.bounds, rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(got.bands.cpu(), want.bands, rtol=0,
                                   atol=tol * float(xc.abs().max()))
    row = torch.fft.rfft(torch.from_numpy(x[0])).real
    bands, count, sort = efd_real(row.to(device), 4)
    wb, wc, ws = efd_real(row, 4)
    assert int(count) == int(wc) and torch.equal(sort.cpu(), ws)
    torch.testing.assert_close(bands.cpu(), wb, rtol=0, atol=1e-10)
    comps = iterative_max(row.to(device), 3, 4)
    torch.testing.assert_close(comps.cpu(), iterative_max(row, 3, 4),
                               rtol=0, atol=1e-10)
    assert not any({**cuda_cubic.LAUNCHES, **cuda_fill.LAUNCHES}.values())


def test_sine_sift_and_cascade_on_the_card_against_the_cpu(device):
    """The sine sift (the template tier's static path) and one cascade
    iteration in both modes, f64 on the card against the CPU; the moment
    solves never resolve to the sequential ``"scan"`` on the card."""
    from chip_smoke import recorded_moments
    from pyitd_tpu_torch import itd_sine_sift
    from pyitd_tpu_torch.decomp.itd_fourier import cascade_iteration

    sr, n = 400, 8192
    x = torch.from_numpy(_fft_signal(n, 2))
    scale = float(x.abs().max())
    methods = []
    with recorded_moments(methods):
        rot, res = itd_sine_sift(x.to(device), sr)
        for mode in ("any", "valid"):
            got = cascade_iteration(x.to(device), sr, mode=mode)
            want = cascade_iteration(x, sr, mode=mode)
            assert torch.equal(got[1].cpu(), want[1])
            for a, b in zip(got[:1] + got[2:], want[:1] + want[2:]):
                torch.testing.assert_close(
                    a.cpu(), b, rtol=0,
                    atol=1e-12 * max(scale, float(b.abs().max())))
    wr, ws = itd_sine_sift(x, sr)
    torch.testing.assert_close(rot.cpu(), wr, rtol=0, atol=1e-12 * scale)
    torch.testing.assert_close(res.cpu(), ws, rtol=0, atol=1e-12 * scale)
    assert "scan" not in methods and methods.count("banded") == len(methods)


def test_template_moments_auto_is_affine_on_the_card(device):
    """``reference_spline_moments(method="auto")`` resolves to
    ``"affine"`` on a CUDA tensor, and the dynamic path takes it."""
    from pyitd_tpu_torch import template_fast_baseline
    from pyitd_tpu_torch.decomp.itd_fourier import sine_template_positions
    from pyitd_tpu_torch.ops.tridiag import reference_spline_moments

    rng = np.random.default_rng(3)
    knots = torch.from_numpy(rng.normal(size=(3, 200))).to(device)
    h = torch.from_numpy(rng.integers(1, 9, (3, 200)).astype(float)).to(
        device)
    count = torch.tensor([200, 150, 2], device=device)
    assert torch.equal(reference_spline_moments(knots, h, count),
                       reference_spline_moments(knots, h, count, "affine"))
    x = torch.from_numpy(_fft_signal(2000, 4))
    pos, cnt, _ = sine_template_positions(400, 2000, device="cpu")
    got = template_fast_baseline(x.to(device), pos[0].to(device),
                                 cnt[0].to(device))
    want = template_fast_baseline(x, pos[0], cnt[0])
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-10)


def test_template_ignores_the_callers_matmul_precision(device):
    """Under ``"high"`` (TF32 allowed) the template tier's f32 static path
    gives the bits it gives under ``"highest"`` (no GEMM of it may round
    to TF32), and the caller's setting is kept."""
    from pyitd_tpu_torch import template_fast_baseline
    from pyitd_tpu_torch.decomp.itd_fourier import (_sine_template_np,
                                                     itd_sine_sift)

    sr, n = 2048, 1 << 16
    x = torch.from_numpy(_fft_signal(n, 5)).float().to(device)
    pos, cnt, _ = _sine_template_np(sr, n)
    want = template_fast_baseline(x, pos[0], int(cnt[0]))
    want_rot = itd_sine_sift(x, sr)[0]
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        got = template_fast_baseline(x, pos[0], int(cnt[0]))
        got_rot = itd_sine_sift(x, sr)[0]
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert bitwise_equal(got, want) and bitwise_equal(got_rot, want_rot)
    f64 = template_fast_baseline(x.double(), pos[0], int(cnt[0]))
    assert float((got - f64).abs().max()) <= 2e-6 * float(x.abs().max())


def test_fft_entry_points_send_numpy_to_the_card(device):
    from pyitd_tpu_torch import (efd, itd_fourier_decomposition,
                                 itd_sine_sift, template_fast_baseline)
    from pyitd_tpu_torch.decomp.itd_fourier import _sine_template_np

    x = _fft_signal(2048, 6)
    assert efd(x, 4).bands.device.type == "cuda"
    rot, res = itd_sine_sift(x, 400)
    assert rot.device.type == res.device.type == "cuda"
    pos, cnt, _ = _sine_template_np(400, 2048)
    assert template_fast_baseline(x, pos[0],
                                  int(cnt[0])).device.type == "cuda"
    comps = itd_fourier_decomposition(x[:600], 600, max_outer=30)
    assert isinstance(comps[0], np.ndarray)
    np.testing.assert_allclose(np.sum(comps, axis=0), x[:600], atol=1e-8)


# ---- the rest of decomp/: streaming, transforms, FABADA, SVMD, AFT ----

def _no_repo_launch():
    assert not any({**cuda_cubic.LAUNCHES, **cuda_fill.LAUNCHES}.values())


@pytest.mark.parametrize("iq", [False, True], ids=["scalar", "iq"])
def test_streaming_on_the_card(device, iq):
    """The replay on the card against the CPU (ready flags equal, 1e-10 of
    max|x|); the one-hop step bitwise the replay; ``sharded_streaming_itd``
    on one card bitwise the replay; no kernel of the repo launched."""
    from chip_smoke import iq_bank, stream_bank
    from pyitd_tpu_torch import (streaming_init, streaming_itd,
                                 streaming_itd_iq, streaming_step,
                                 streaming_step_iq)
    from pyitd_tpu_torch.parallel import sharded_streaming_itd

    cuda_cubic.reset_launches()
    cuda_fill.reset_launches()
    hop = 128
    x = torch.from_numpy(iq_bank(3, 4096) if iq else stream_bank(3, 4096))
    run = streaming_itd_iq if iq else streaming_itd
    got = run(x.to(device), hop)
    want = run(x, hop)
    assert torch.equal(got[2].cpu(), want[2])
    scale = float(x.abs().max())
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-10 * scale)
    step = streaming_step_iq if iq else streaming_step
    state = streaming_init(hop, (3,), x.dtype, device=device)
    for k in range(12):
        state, rot, base, ready = step(
            state, x[:, k * hop:(k + 1) * hop].to(device), hop)
        assert torch.equal(rot, got[0][k]) and torch.equal(base, got[1][k])
        assert torch.equal(ready, got[2][k])
    split = sharded_streaming_itd(["cuda:0"], hop, iq=iq)(x.to(device))
    assert all(torch.equal(a, b) for a, b in zip(split, got))
    _no_repo_launch()


def test_transforms_on_the_card_against_the_cpu(device):
    """Trend, the time-causal STFT and STIRFT in f64 on the card against
    the CPU, to 1e-10 of max|x| (of max|S|)."""
    from pyitd_tpu_torch import (compute_synthesis_window, decompose_signal,
                                 istirft, stirft, time_causal_stft)

    t = np.linspace(-10, 10, 3000)
    x = torch.from_numpy(np.stack([np.sin(t) + 0.44 * np.cos(7 * t),
                                   np.sin(1.3 * t) * (1 + 0.1 * t)]))
    gc, gr = decompose_signal(x.to(device))
    wc, wr = decompose_signal(x)
    assert len(gc) == len(wc)
    for a, b in zip(gc + [gr], wc + [wr]):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-10)
    s, ws = time_causal_stft(x.to(device)), time_causal_stft(x)
    torch.testing.assert_close(s.cpu(), ws, rtol=0,
                               atol=1e-10 * float(ws.abs().max()))
    win = torch.from_numpy(compute_synthesis_window(np.hanning(512), 128))
    sx, wsx = stirft(x.to(device), win.to(device)), stirft(x, win)
    torch.testing.assert_close(sx.cpu(), wsx, rtol=0, atol=1e-10)
    syn = torch.from_numpy(np.hanning(512) * 2)
    buf = torch.linspace(-1, 1, 384, dtype=torch.float64)
    y, b = istirft(sx[0], buf.to(device), syn.to(device))
    wy, wb = istirft(wsx[0], buf, syn)
    torch.testing.assert_close(y.cpu(), wy, rtol=0, atol=1e-10)
    torch.testing.assert_close(b.cpu(), wb, rtol=0, atol=1e-10)


@pytest.mark.parametrize("fn", ["fabada", "pfabada"])
def test_fabada_graph_is_bitwise_the_eager_loop(device, fn, monkeypatch):
    """The blocked state machine in a CUDA graph, the same block eager, and
    the per-iteration eager loop: the same bits on the card; the card
    against the CPU to 1e-12 of max|x|."""
    from pyitd_tpu_torch.decomp import fabada as tf
    from pyitd_tpu_torch.utils import device_loop as dl

    rng = np.random.default_rng(1)
    xx, yy = np.meshgrid(np.linspace(-1, 1, 96), np.linspace(-1, 1, 96))
    img = torch.from_numpy(100 * np.exp(-(xx ** 2 + yy ** 2) / 0.2)
                           + 8.0 * rng.normal(size=xx.shape))
    run = getattr(tf, fn)
    arg = 64.0 if fn == "fabada" else 8.0
    dl.reset_runs()
    graph = run(img.to(device), arg)
    assert dl.RUNS[-1]["graph"]
    monkeypatch.setattr(dl, "GRAPHS", False)
    blocked = run(img.to(device), arg)
    monkeypatch.setattr(tf, "_BLOCK", 1)
    eager = run(img.to(device), arg)
    assert not dl.RUNS[-1]["graph"]
    assert dl.RUNS[-1]["reads"] == dl.RUNS[-1]["steps"]
    assert bitwise_equal(graph, eager) and bitwise_equal(blocked, eager)
    cpu = run(img, arg)
    torch.testing.assert_close(graph.cpu(), cpu, rtol=0,
                               atol=1e-12 * float(cpu.abs().max()))


def test_svmd_graph_is_bitwise_the_eager_loop(device, monkeypatch):
    """SVMD's flattened ADMM and annealing machine: graph, blocked eager and
    per-iteration eager give the same bits on the card; the card against
    the CPU (mode count exactly, omega to 1e-10, modes to 1e-9: the
    reductions round otherwise on the two devices)."""
    from chip_smoke import two_tone
    from pyitd_tpu_torch import svmd
    from pyitd_tpu_torch.decomp import svmd as tv
    from pyitd_tpu_torch.utils import device_loop as dl

    x = two_tone(512)
    dl.reset_runs()
    graph = svmd(x, max_modes=3, device=device)
    assert all(r["graph"] for r in dl.RUNS)
    monkeypatch.setattr(dl, "GRAPHS", False)
    blocked = svmd(x, max_modes=3, device=device)
    monkeypatch.setattr(tv, "_BLOCK", 1)
    eager = svmd(x, max_modes=3, device=device)
    for a, b, c in zip(graph, blocked, eager):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    u, _, om = svmd(x, max_modes=3, device="cpu")
    assert graph[0].shape == u.shape
    np.testing.assert_allclose(graph[2], om, rtol=0, atol=1e-10)
    np.testing.assert_allclose(graph[0], u, rtol=0, atol=1e-9)


def test_aft_on_the_card(device):
    """Both DFTs against the FFT within 5e-4 of max|X|; the hierarchical
    one the same bits under ``"high"`` matmul precision."""
    from pyitd_tpu_torch.decomp.aft import accumulator_dft, hierarchical_dft

    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(64, 512)).astype(np.float32)).to(device)
    want = torch.fft.fft(x.double())
    for fn in (accumulator_dft, hierarchical_dft):
        got = fn(x).to(want.dtype)
        assert float((got - want).abs().max()) <= 5e-4 * float(
            want.abs().max())
    ref = hierarchical_dft(x)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        high = hierarchical_dft(x)
    finally:
        torch.set_float32_matmul_precision(prev)
    assert bitwise_equal(torch.view_as_real(high), torch.view_as_real(ref))


def test_decomp_entry_points_send_numpy_to_the_card(device):
    from chip_smoke import stream_bank, two_tone
    from pyitd_tpu_torch import (auto_sigma, decompose_signal, fabada,
                                 iq_baseline_extract, stirft, streaming_init,
                                 streaming_itd, svmd, time_causal_stft)
    from pyitd_tpu_torch.decomp.aft import hierarchical_dft

    x = stream_bank(2, 2048)
    assert streaming_itd(x, 128)[0].device.type == "cuda"
    assert streaming_init(128).window.device.type == "cuda"
    assert iq_baseline_extract(x[0], x[1])[0].device.type == "cuda"
    assert decompose_signal(x[0])[1].device.type == "cuda"
    assert time_causal_stft(x[0]).device.type == "cuda"
    assert stirft(x[0], np.hanning(512)).device.type == "cuda"
    assert fabada(x[0], 0.01).device.type == "cuda"
    assert auto_sigma(x[0]).device.type == "cuda"
    assert hierarchical_dft(x[:, :64]).device.type == "cuda"
    u, _, _ = svmd(two_tone(256), max_modes=1)
    assert isinstance(u, np.ndarray)
