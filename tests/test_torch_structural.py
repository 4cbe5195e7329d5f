"""The structural backward of the port against the JAX package, on the CPU.

* one level, f64: ``structural_level_bwd(fills="torch")`` against JAX
  ``_structural_level_bwd(fills="scan")`` and against autograd of the
  port's own gather level, to 1e-12 (as ``tests/test_itd_sift.py:293-305``);
* one level, f32: ``fills="kernel"`` on a CPU tensor (the plain versions of
  fill2 and segsum) against JAX ``fills="pallas"`` in interpret mode, to
  rtol = atol = 2e-4, and no looser than the torch route against an f64
  truth (``tests/test_pallas_fill.py:394-404``);
* the whole sift, f64: ``linear_backend="structural"`` against
  ``jax.grad`` of ``_itd_sift_xla(..., linear_backend="structural")`` and
  against the port's autograd route, to 1e-11;
* the kernel route with a gradient, f32 on the CPU: forward bit for bit
  the plain loop's, gradient against the plain structural route, and per
  level that reaches the loss one ``bwd_knots``, two fill2, one
  ``bwd_pre``, two segsum and one ``bwd_post`` call;
* the kernel route's gradient (the reverse trip loop) equal to autograd of
  the loop with structural levels on the kernels (``torch.equal``, NaN at
  the same samples), on shapes of 2 to 9,000 samples and a 3-D batch, with
  and without stored baselines, ``early_exit``, both endpoint modes and
  losses on rotations, correction, baselines and all three; a NaN input
  and an infinite cotangent; the replay's levels and the loop's trips
  (``BWD_COUNTS``), and the wrapper refusing bad trip arguments;
* the level adjoint's fused kernels (``cuda_fill.bwd_knots``, ``bwd_pre``,
  ``bwd_post``, their plain versions here) and the whole kernel-route
  adjoint on a CPU tensor equal the route's composition before the fusion
  (:func:`_unfused_adjoint`: eager glue around two fill2 and four segsum
  calls, the knot reads as one-channel segment sums) to rtol = atol = 0,
  NaN equal to NaN and +0 to -0, on banks, batched shapes, flat runs and
  plateaus, a NaN quarantine and rows of 2 to 5 samples, in both endpoint
  modes; the wrappers refuse what the kernels do not take;
* the trainer of ``examples/train_through_itd.py``, f64: the taps gradient
  against ``jax.grad`` of the same loss to 1e-10, at the start and after 3
  SGD steps applied to both sides.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyitd_tpu.decomp.itd import _itd_sift_xla
from pyitd_tpu.decomp.itd import itd_sift as jax_sift
from pyitd_tpu.ops.linear_baseline import _structural_level_bwd
import chip_smoke
from pyitd_tpu_torch import itd_sift, linear_baseline_extract
from pyitd_tpu_torch.decomp.itd import BWD_COUNTS, _itd_sift_torch
from pyitd_tpu_torch.examples import train_through_itd as trainer
from pyitd_tpu_torch.ops import cuda_fill
from pyitd_tpu_torch.ops.linear_baseline import (
    linear_baseline_extract_structural, structural_level_bwd)
from pyitd_tpu_torch.utils.interop import from_numpy, result_to_numpy

torch.set_num_threads(1)


def _signals():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, 384)
    yield "chirp", np.stack([
        np.sin(20 * t * (1 + 0.2 * t)) + np.sin(13 * t)
        + 0.1 * rng.normal(size=384),
        np.sin(5 * t) + 0.3 * t])
    yield "plateaus", np.round(rng.normal(size=(2, 384)) * 2)
    nan = rng.normal(size=(2, 384))
    nan[0, 100:102] = np.nan
    yield "nan", nan
    yield "short", rng.normal(size=(3, 2))


SIGNALS = list(_signals())


def _cts(x, seed=1):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=x.shape) for _ in range(3))


@pytest.mark.parametrize("mode", ["reference", "natural"])
@pytest.mark.parametrize("name,x", SIGNALS, ids=[s[0] for s in SIGNALS])
def test_torch_adjoint_matches_jax_scan_and_autograd_f64(name, x, mode):
    cts = _cts(x)
    want = _structural_level_bwd(jnp.asarray(x), *map(jnp.asarray, cts),
                                 mode, fills="scan")
    got = structural_level_bwd(from_numpy(x), *map(from_numpy, cts), mode,
                               fills="torch")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    if name == "nan":
        return  # autograd carries the NaN into the running sums
    xt = from_numpy(x).requires_grad_()
    r = linear_baseline_extract(xt, endpoint_mode=mode)
    (g_ad,) = torch.autograd.grad([r.rotation, r.baseline, r.sub_err], xt,
                                  [from_numpy(c) for c in cts])
    np.testing.assert_allclose(got.numpy(), g_ad.numpy(), rtol=0, atol=1e-12)


def test_kernel_fills_on_cpu_match_jax_pallas_f32():
    rng = np.random.default_rng(11)
    n = 8322
    t = np.linspace(0, 4 * np.pi, n)
    sig = np.stack([np.sin(9 * t) + 0.2 * rng.standard_normal(n),
                    rng.standard_normal(n)])
    x = sig.astype(np.float32)
    cts = tuple(rng.normal(size=x.shape).astype(np.float32)
                for _ in range(3))
    g_pal = np.asarray(_structural_level_bwd(
        jnp.asarray(x), *map(jnp.asarray, cts), "reference",
        fills="pallas"))
    cuda_fill.reset_launches()
    g_ker = structural_level_bwd(from_numpy(x), *map(from_numpy, cts),
                                 "reference", fills="kernel").numpy()
    g_tor = structural_level_bwd(from_numpy(x), *map(from_numpy, cts),
                                 "reference", fills="torch").numpy()
    assert all(v == 0 for v in cuda_fill.LAUNCHES.values())
    np.testing.assert_allclose(g_ker, g_pal, rtol=2e-4, atol=2e-4)
    g_true = structural_level_bwd(
        from_numpy(x).double(), *(from_numpy(c).double() for c in cts),
        "reference", fills="torch").numpy()
    err_ker = np.abs(g_ker - g_true).max()
    err_tor = np.abs(g_tor - g_true).max()
    assert err_ker <= err_tor * 1.5 + 1e-6, (err_ker, err_tor)


def test_structural_level_function():
    """Unused outputs arrive as no cotangent; the count is not
    differentiable; a bad ``fills`` raises."""
    x = SIGNALS[0][1]
    xt = from_numpy(x).requires_grad_()
    r = linear_baseline_extract_structural(xt, backend="torch")
    assert not r.num_extrema.requires_grad
    (g,) = torch.autograd.grad(r.rotation.sum(), xt)
    zero = torch.zeros_like(xt)
    want = structural_level_bwd(xt.detach(), torch.ones_like(zero), zero,
                                zero, "reference", fills="torch")
    assert torch.equal(g, want)
    with pytest.raises(ValueError, match="fills"):
        structural_level_bwd(xt.detach(), zero, zero, zero, "reference",
                             fills="bogus")
    with pytest.raises(ValueError, match="f32"):
        structural_level_bwd(xt.detach(), zero, zero, zero, "reference",
                             fills="kernel")


def _loss(r):
    return ((r.rotations ** 2).sum() + (r.baselines ** 2).sum()
            + (r.correction * 0.7).sum())


def test_sift_grad_f64_matches_jax_structural():
    x = SIGNALS[0][1]

    def jloss(a):
        r = _itd_sift_xla(a, 4, "reference", True,
                          linear_backend="structural")
        return (jnp.sum(jnp.square(r.rotations)) + jnp.sum(r.baselines ** 2)
                + jnp.sum(r.correction * 0.7))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(_loss(itd_sift(
        xt, 4, backend="torch", linear_backend="structural")), xt)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-11)
    (g_ad,) = torch.autograd.grad(_loss(itd_sift(xt, 4, backend="torch")),
                                  xt)
    np.testing.assert_allclose(got.numpy(), g_ad.numpy(), rtol=0,
                               atol=1e-11)
    with pytest.raises(ValueError, match="linear_backend"):
        itd_sift(xt, 4, linear_backend="bogus")


ADJOINT = ("bwd_knots", "fill2", "bwd_pre", "segsum", "bwd_post")


def _count_calls(monkeypatch):
    calls = dict.fromkeys(ADJOINT, 0)
    for name in calls:
        fn = getattr(cuda_fill, f"{name}_cuda")

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(cuda_fill, f"{name}_cuda", counted)
    return calls


KERNEL_GRAD = [((2, 9000), 5, {}), ((3, 130), 3, {"store_baselines": False}),
               ((2, 8320), 4, {"early_exit": True})]


@pytest.mark.parametrize("shape,max_it,kw", KERNEL_GRAD)
def test_kernel_route_grad_on_cpu_f32(monkeypatch, shape, max_it, kw):
    """Tolerance: the two routes differ only in the segment sums (direct
    sums against differences of row-long running sums), a few ulp of the
    running sums' magnitude; 1e-4 * max|g| at these sizes."""
    rng = np.random.default_rng(shape[1])
    t = np.linspace(0, 2 * np.pi, shape[1])
    x = (np.sin(7 * t)[None] + 0.4 * rng.normal(size=shape)).astype(
        np.float32)
    if shape[1] > 4100:
        x[0, 4095:4097] = np.nan  # across a tile edge
    calls = _count_calls(monkeypatch)
    xk = from_numpy(x).requires_grad_()
    rk = itd_sift(xk, max_it, backend="kernel", **kw)
    xp = from_numpy(x).requires_grad_()
    rp = itd_sift(xp, max_it, backend="torch", linear_backend="structural",
                  **kw)
    a, b = result_to_numpy(rk), result_to_numpy(rp)
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert calls == dict.fromkeys(ADJOINT, 0)

    before = dict(BWD_COUNTS)
    _loss(rk).backward()
    levels = max_it + 2
    if kw.get("early_exit"):
        levels = int(rk.num_components.max())
    # every extraction but the last trip's reaches the loss; the replay
    # recomputes the inputs of all of them but the first
    assert calls == {"bwd_knots": levels, "fill2": 2 * levels,
                     "bwd_pre": levels, "segsum": 2 * levels,
                     "bwd_post": levels}
    assert {k: v - before[k] for k, v in BWD_COUNTS.items()} == {
        "replayed_levels": levels - 1, "reverse_trips": levels}
    _loss(rp).backward()
    gk, gp = xk.grad.numpy(), xp.grad.numpy()
    np.testing.assert_array_equal(np.isnan(gk), np.isnan(gp))
    ok = ~np.isnan(gp)
    np.testing.assert_allclose(gk[ok], gp[ok], rtol=0,
                               atol=1e-4 * np.abs(gp[ok]).max())


LOSSES = {"rotations": ("rotations",), "correction": ("correction",),
          "baselines": ("baselines",),
          "all": ("rotations", "baselines", "correction")}
REPLAY_SHAPES = KERNEL_GRAD + [
    ((2, 3, 200), 3, {"endpoint_mode": "natural"}),
    ((4, 40), 6, {"store_baselines": False, "early_exit": True,
                  "endpoint_mode": "natural"})]
REPLAY_CASES = [(shape, max_it, kw, loss, None)
                for shape, max_it, kw in REPLAY_SHAPES for loss in LOSSES] + [
    ((2, 9000), 5, {}, "all", "nan input"),
    ((2, 9000), 5, {"store_baselines": False}, "all", "inf correction"),
    ((2, 9000), 5, {}, "all", "inf rotation"),
    ((3, 2), 2, {}, "all", None)]


def _replay_ids():
    for shape, max_it, kw, loss, odd in REPLAY_CASES:
        opts = "-".join(f"{k}={v}" for k, v in kw.items())
        yield f"{shape}-{max_it}-{opts}-{loss}-{odd}"


@pytest.mark.parametrize("shape,max_it,kw,loss,odd", REPLAY_CASES,
                         ids=list(_replay_ids()))
def test_kernel_route_grad_is_the_autograd_replay(monkeypatch, shape, max_it,
                                                  kw, loss, odd):
    """The reverse trip loop's gradient equals autograd of
    ``_itd_sift_torch(..., linear_backend="structural",
    level_backend="kernel")`` bit for bit where not NaN, NaN at the same
    samples (``chip_smoke.equal_values``); one level adjoint a trip, the
    replay's levels one fewer, none where no loss term reaches a level."""
    rng = np.random.default_rng(shape[-1] + max_it)
    t = np.linspace(0, 2 * np.pi, shape[-1])
    x = (np.sin(7 * t) + 0.4 * rng.normal(size=shape)).astype(np.float32)
    if odd == "nan input":
        x[0, 3000:3002] = np.nan
    args = (max_it, kw.get("endpoint_mode", "reference"),
            kw.get("store_baselines", True), kw.get("early_exit", False))

    def grad(sift):
        xg = from_numpy(x).requires_grad_()
        r = sift(xg)
        g_rng = np.random.default_rng(7)
        outs = [getattr(r, name) for name in LOSSES[loss]]
        cts = [from_numpy(g_rng.normal(size=o.shape).astype(np.float32))
               for o in outs]
        if odd == "inf correction":
            cts[-1].view(-1)[4321] = np.inf
        if odd == "inf rotation":
            cts[0][0, 1].view(-1)[17] = -np.inf
        (g,) = torch.autograd.grad(outs, xg, cts, allow_unused=True)
        return r, g

    calls = _count_calls(monkeypatch)
    before = dict(BWD_COUNTS)
    rk, gk = grad(lambda a: itd_sift(a, max_it, backend="kernel", **kw))
    trips = max_it + 2
    if kw.get("early_exit"):
        trips = int(rk.num_components.max())
    if loss == "baselines" and not args[2]:
        trips = 0  # the one row of zeros reaches no level
    assert {k: v - before[k] for k, v in BWD_COUNTS.items()} == {
        "replayed_levels": max(trips - 1, 0), "reverse_trips": trips}
    assert calls == {"bwd_knots": trips, "fill2": 2 * trips,
                     "bwd_pre": trips, "segsum": 2 * trips,
                     "bwd_post": trips}
    _, gr = grad(lambda a: _itd_sift_torch(a, *args,
                                           linear_backend="structural",
                                           level_backend="kernel"))
    assert chip_smoke.equal_values(gk, gr)
    if odd == "inf correction":
        assert bool(torch.isnan(gr).any())  # the zero path and two-sum term


@pytest.mark.parametrize("bad", list(chip_smoke.bad_trips(
    torch.zeros(3, 8))))
def test_bwd_pre_wrapper_refuses_bad_trip_arguments(bad):
    x = torch.linspace(0, 1, 24).reshape(3, 8).contiguous()
    with pytest.raises(ValueError):
        chip_smoke.bad_trips(x)[bad]()


def test_kernel_route_grad_through_rotations_only():
    """A loss on one output sends no cotangent to the others."""
    x = SIGNALS[0][1].astype(np.float32)
    xk = from_numpy(x).requires_grad_()
    (gk,) = torch.autograd.grad(itd_sift(xk, 3, backend="kernel")
                                .rotations[0].square().sum(), xk)
    (gp,) = torch.autograd.grad(itd_sift(
        xk, 3, backend="torch", linear_backend="structural")
        .rotations[0].square().sum(), xk)
    np.testing.assert_allclose(gk.numpy(), gp.numpy(), rtol=0,
                               atol=1e-4 * gp.abs().max().item())


def _jax_trainer_loss(x, target):
    """``examples/train_through_itd.py:36-47``."""
    def prefilter(taps, sig):
        pad = taps.shape[0] // 2
        s = jnp.pad(sig, ((0, 0), (pad, pad)), mode="edge")
        windows = jnp.stack(
            [s[:, i: i + sig.shape[1]] for i in range(taps.shape[0])],
            axis=-1)
        return windows @ taps

    def loss_fn(taps):
        res = jax_sift(prefilter(taps, x), 6, store_baselines=False)
        return jnp.mean(jnp.square(res.rotations[0] - target))

    return loss_fn


@pytest.mark.parametrize("linear_backend", ["auto", "structural"])
def test_trainer_grad_f64_matches_jax(linear_backend):
    xn, hi = trainer.make_problem()
    jloss = _jax_trainer_loss(jnp.asarray(xn), jnp.asarray(hi))
    jgrad = jax.jit(jax.grad(jloss))
    x, target = from_numpy(xn), from_numpy(hi)
    taps = trainer.identity_taps()
    for step in range(4):
        want = np.asarray(jgrad(jnp.asarray(taps)))
        tt = from_numpy(taps).requires_grad_()
        loss = trainer.loss_fn(tt, x, target, backend="torch",
                               linear_backend=linear_backend)
        (got,) = torch.autograd.grad(loss, tt)
        np.testing.assert_allclose(float(loss.detach()), float(jloss(taps)),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10,
                                   err_msg=f"step {step}")
        taps = taps - 0.05 * want  # the same SGD step on both sides


# ---- the level adjoint's fused kernels, against the composition before
# the fusion ----

def _unfused_adjoint(x, g_rot, g_base, g_err, endpoint_mode):
    """The kernel route's level adjoint as eager glue around the plain
    fill2 and segsum (the fused kernels' reference): the knot mask and its
    shift, the two fills, the channels, two two-channel segment sums, and
    the pushes read back as one-channel segment sums over the knots.
    Returns its intermediates by the fused kernels' outputs."""
    from pyitd_tpu_torch.ops.fill import shift_left
    from pyitd_tpu_torch.ops.linear_baseline import knot_mask, knot_value

    fill2, segsum = cuda_fill.fill2, cuda_fill.segsum
    n = x.shape[-1]
    it = torch.arange(n, device=x.device).expand(x.shape)
    knots = knot_mask(x)
    f_next = shift_left(knots, False)
    p1p, p1x, p2p, p2x = fill2(x, knots)
    n1p, n1x, n2p, n2x = fill2(x, knots, reverse=True, strict=True)
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
    gx0 = geff_rot + g_err + g_b * s
    chans = tuple(torch.where(torch.isfinite(z), z, 0.0)
                  for z in (a_bl, a_xl, a_br, a_xr))
    seg_a = segsum(chans[:2], f_next, reverse=True)
    seg_e = segsum(chans[2:], knots, strict=True)
    gkv = torch.where(knots, seg_a[0] + seg_e[0], 0.0)
    gx = gx0 + torch.where(knots, seg_a[1] + seg_e[1], 0.0)
    span = (n1p - p2p).to(x.dtype)
    w = (it - p2p).to(x.dtype) / torch.where(span == 0,
                                             torch.ones_like(span), span)
    interior = knots & (it != 0) & (it != n - 1)
    gkv_int = torch.where(interior, gkv, torch.zeros_like(gkv))
    gx = gx + 0.5 * gkv_int
    c_p = gkv_int * (0.5 * (1.0 - w))
    c_n = gkv_int * (0.5 * w)
    gx = gx + torch.where(knots, segsum(c_p, knots, True, True)
                          + segsum(c_n, knots, strict=True), 0.0)
    g0 = 0.5 * gkv[..., 0]
    gl = 0.5 * gkv[..., n - 1]
    for i, g in ((0, g0), (1, g0), (n - 2, gl), (n - 1, gl)):
        gx[..., i] += g
    return {"knots": (knots, f_next), "fills": ((p1p, p1x, p2p, p2x),
                                                (n1p, n1x, n2p, n2x)),
            "pre": chans + (gx0,), "seg": (seg_a, seg_e), "gx": gx}


def _fused_cases():
    rng = np.random.default_rng(18)
    yield "bank", rng.normal(size=(4, 300))
    yield "batched", rng.normal(size=(2, 3, 64))
    t = np.linspace(0, 6 * np.pi, 257)
    yield "sine", np.stack([np.sin(t), np.sin(3 * t) + 0.2 * t])
    yield "plateaus", np.round(rng.normal(size=(3, 200)) * 1.5)
    flat = np.zeros((3, 96))
    flat[1, 40:] = 1.0
    flat[2] = np.repeat(rng.normal(size=12), 8)
    yield "flat_runs", flat
    nan = rng.normal(size=(3, 160))
    nan[0, 50:53] = np.nan
    nan[1, 0] = np.nan
    nan[2, -2:] = np.nan
    yield "nan", nan
    for n in (2, 3, 4, 5):
        yield f"n{n}", rng.normal(size=(3, n))


FUSED_CASES = [(name, x.astype(np.float32)) for name, x in _fused_cases()]
FUSED_IDS = [c[0] for c in FUSED_CASES]


def _fused_inputs(x, seed=3):
    rng = np.random.default_rng(seed)
    cts = [from_numpy(rng.normal(size=x.shape).astype(np.float32))
           for _ in range(3)]
    cts[1][..., ::3] = 0.0  # a baseline cotangent with zeros
    return from_numpy(x), cts


def _same(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, (tuple, list)):
            _same(a, b)
        else:
            assert a.dtype == b.dtype and a.shape == b.shape
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("name,x", FUSED_CASES, ids=FUSED_IDS)
def test_bwd_knots_plain_is_the_unfused_mask(name, x):
    xt, cts = _fused_inputs(x)
    _same(cuda_fill.bwd_knots(xt),
          _unfused_adjoint(xt, *cts, "reference")["knots"])


@pytest.mark.parametrize("mode", ["reference", "natural"])
@pytest.mark.parametrize("name,x", FUSED_CASES, ids=FUSED_IDS)
def test_bwd_pre_plain_is_the_unfused_glue(name, x, mode):
    xt, cts = _fused_inputs(x)
    ref = _unfused_adjoint(xt, *cts, mode)
    _same(cuda_fill.bwd_pre(xt, *cts, *ref["fills"], mode), ref["pre"])


@pytest.mark.parametrize("mode", ["reference", "natural"])
@pytest.mark.parametrize("name,x", FUSED_CASES, ids=FUSED_IDS)
def test_bwd_post_plain_is_the_unfused_glue(name, x, mode):
    """The pushes as gathers at the fills' next and previous knots equal
    the one-channel segment sums over the knots (but for the sign of an
    exact zero)."""
    xt, cts = _fused_inputs(x)
    ref = _unfused_adjoint(xt, *cts, mode)
    (_, _, p2p, _), (n1p, _, _, _) = ref["fills"]
    got = cuda_fill.bwd_post(ref["knots"][0], ref["pre"][4], *ref["seg"],
                             p2p, n1p)
    _same(got, ref["gx"])


@pytest.mark.parametrize("mode", ["reference", "natural"])
@pytest.mark.parametrize("name,x", FUSED_CASES, ids=FUSED_IDS)
def test_kernel_route_adjoint_is_the_unfused_route(monkeypatch, name, x,
                                                   mode):
    """The whole level adjoint on the kernel route (the wrappers' plain
    versions on a CPU tensor): seven wrapper calls, and the unfused
    composition's gradient."""
    xt, cts = _fused_inputs(x)
    calls = _count_calls(monkeypatch)
    got = structural_level_bwd(xt, *cts, mode, fills="kernel")
    assert calls == {"bwd_knots": 1, "fill2": 2, "bwd_pre": 1, "segsum": 2,
                     "bwd_post": 1}
    _same(got, _unfused_adjoint(xt, *cts, mode)["gx"])


def _adjoint_call(name, x):
    """One call of the adjoint wrapper ``name`` with ``x`` as its signal,
    its other inputs made from a sound signal of ``x``'s shape."""
    base = torch.linspace(0, 1, x.shape[-1]).expand(x.shape).contiguous() \
        if x.dim() == 2 else torch.zeros(3, 8)
    knots, f_next = cuda_fill.bwd_knots(base)
    fwd = cuda_fill.fill2(base, knots)
    bwd = cuda_fill.fill2(base, knots, True, True)
    g = torch.zeros_like(base)
    seg = (g, g)
    return {
        "bwd_knots": lambda: cuda_fill.bwd_knots_cuda(x),
        "bwd_pre": lambda: cuda_fill.bwd_pre_cuda(x, g, g, g, fwd, bwd),
        "bwd_post": lambda: cuda_fill.bwd_post_cuda(knots, x, seg, seg,
                                                    fwd[2], bwd[0]),
    }[name]


BAD_SIGNALS = {
    "n1": lambda: torch.zeros(3, 1),
    "f64": lambda: torch.zeros(3, 8, dtype=torch.float64),
    "strided": lambda: torch.zeros(3, 16)[:, ::2],
    "1d": lambda: torch.zeros(8),
}


@pytest.mark.parametrize("bad", list(BAD_SIGNALS))
@pytest.mark.parametrize("name", ["bwd_knots", "bwd_pre", "bwd_post"])
def test_adjoint_wrappers_refuse_what_the_kernels_cannot_take(name, bad):
    call = _adjoint_call(name, BAD_SIGNALS[bad]())
    with pytest.raises(ValueError):
        call()


def test_bwd_pre_wrapper_refuses_a_bad_endpoint_mode():
    x = torch.zeros(2, 8)
    knots, _ = cuda_fill.bwd_knots(x)
    fills = cuda_fill.fill2(x, knots)
    with pytest.raises(ValueError, match="endpoint_mode"):
        cuda_fill.bwd_pre_cuda(x, x, x, x, fills, fills, "bogus")
