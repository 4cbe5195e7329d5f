"""The port's ``ml/`` foundation (``pyitd_tpu_torch/ml/``: activations,
zoo, layers, phase, kalman, visualizer, optimizers), its weight carrier
(``utils/interop.load_flax_params``) and ``examples/train_tiny.py``,
against the JAX package's on the CPU.

Each module is built in flax from a seed, its parameters cast to f64 and
carried into the torch module with ``load_flax_params``; forward outputs
are held to 1e-10 and gradients (``jax.grad`` of a fixed random
projection of the output) to 1e-10 of max|g|, the JAX gradient carried
into a second torch module by the same function.  Numerics where flax and
torch differ by default each have a case: flax's ``gelu`` is the tanh
approximation; ``Mixer`` runs its FFT in f32 whatever the input dtype (1e-5
of max|y|); ``KalmanSweepMHGains`` keeps both layout quirks at B = 2;
``ITDLinear``'s end-slope writes overlap at grids of 2 and 3 and the last
one wins.  Wolf and Phoenix are held step by step against optax on the
same gradients and on JAX's uniforms (its key splits replayed) to 1e-12
after 20 steps.  The initializers are held to flax's distributions in mean,
standard deviation and spread, within sampling error.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from pyitd_tpu.ml import activations as jact
from pyitd_tpu.ml import kalman as jkal
from pyitd_tpu.ml import layers as jlay
from pyitd_tpu.ml import optimizers as jopt
from pyitd_tpu.ml import phase as jph
from pyitd_tpu.ml import visualizer as jvis
from pyitd_tpu.ml import zoo as jzoo
from pyitd_tpu_torch.examples import train_tiny as ttiny
from pyitd_tpu_torch.ml import (ITDLinear, ITDMLP, ITDRNNForecaster,
                                KalmanSweepMHGains, MatrixDashboard, Mixer,
                                PhaseHeads, RecurrentMLP, UnigramModel,
                                VanillaMLP, add_hypersphere_phase_heads,
                                fixed_embedding, phoenix, rainstar, wolf)
from pyitd_tpu_torch.ml import layers as tlay
from pyitd_tpu_torch.ml import optimizers as topt
from pyitd_tpu_torch.ml import visualizer as tvis
from pyitd_tpu_torch.ml import zoo as tzoo
from pyitd_tpu_torch.utils.interop import load_flax_params

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64


def to64(tree):
    return jax.tree.map(lambda a: np.array(a, np.float64), tree)


def t(a, dtype=None):
    return torch.from_numpy(np.array(a)).to(dtype=dtype)


def init_flax(jmod, *args, seed=0):
    """flax's parameters (jitted: one compile per module), cast to f64."""
    return to64(jax.jit(jmod.init)(jax.random.PRNGKey(seed),
                                   *[jnp.asarray(a) for a in args]))


def carried(factory, params):
    mod = factory()
    load_flax_params(mod, params)
    return mod


def held(jmod, factory, args, tol=1e-10, call=None, out=None, seed=0):
    """The flax module and its port on the same f64 parameters and inputs:
    the forward to ``tol``, every parameter's gradient to ``tol`` of
    max|g|.  ``call`` maps (module output) to the tensor compared, ``out``
    likewise for JAX."""
    call = call or (lambda y: y)
    out = out or (lambda y: y)
    params = init_flax(jmod, *args, seed=seed)
    tm = carried(factory, params)
    jargs = [jnp.asarray(a) for a in args]
    targs = [t(a) for a in args]
    jy = np.asarray(out(jax.jit(jmod.apply)(params, *jargs)))
    ty = call(tm(*targs))
    scale = max(1.0, np.abs(jy).max())
    assert ty.shape == jy.shape
    np.testing.assert_allclose(ty.detach().numpy(), jy, rtol=0,
                               atol=tol * scale)
    w = np.random.default_rng(7).normal(size=jy.shape)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(out(jmod.apply(p, *jargs)) * w)))(
        params)
    (call(tm(*targs)) * t(w)).sum().backward()
    gm = carried(factory, jax.tree.map(np.asarray, jg))
    want = dict(gm.named_parameters())
    gmax = max(float(p.detach().abs().max()) for p in want.values()
               if p.numel())
    for name, p in tm.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), want[name].detach().numpy(),
                                   rtol=0, atol=tol * gmax, err_msg=name)
    return tm, params


# ---- the weight carrier -------------------------------------------------

def test_load_flax_params_raises_on_mismatch():
    params = init_flax(jzoo.RecurrentMLP(k=2), np.ones((2, 6)))
    mk = lambda: RecurrentMLP(6, k=2, device=CPU, dtype=F64)  # noqa: E731
    mod = carried(mk, params)
    k = params["params"]["cell_0"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(mod.cell_0.Dense_0.weight.detach().numpy(),
                                  k.T)
    bad = jax.tree.map(lambda a: a, params)
    bad["params"]["cell_1"]["Dense_1"]["bias"] = np.zeros(5)
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(mk(), bad)
    extra = jax.tree.map(lambda a: a, params)
    extra["params"]["cell_0"]["Dense_0"]["bias"] = np.zeros(12)
    with pytest.raises(ValueError, match="no torch"):
        load_flax_params(mk(), extra)
    extra = jax.tree.map(lambda a: a, params)
    extra["params"]["cell_2"] = {"Dense_0": {"kernel": np.zeros((6, 12))}}
    with pytest.raises(ValueError, match="no child"):
        load_flax_params(mk(), extra)
    short = jax.tree.map(lambda a: a, params)
    del short["params"]["cell_1"]
    with pytest.raises(ValueError, match="no flax leaf filled"):
        load_flax_params(mk(), short)


# ---- activations, zoo ---------------------------------------------------

def test_rainstar():
    x = np.linspace(-6, 6, 241)
    xt = t(x).requires_grad_()
    y = rainstar(xt)
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jact.rainstar(jnp.asarray(x))),
                               rtol=0, atol=1e-12)
    y.sum().backward()
    g = jax.grad(lambda a: jnp.sum(jact.rainstar(a)))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g), rtol=0,
                               atol=1e-12)


def test_recurrent_mlp_tanh_gelu():
    x = np.random.default_rng(0).normal(size=(3, 5, 8)) * 2
    tm, params = held(jzoo.RecurrentMLP(k=3, hidden_mult=2),
                      lambda: RecurrentMLP(8, k=3, hidden_mult=2, device=CPU,
                                           dtype=F64), [x])
    # flax's nn.gelu is the tanh approximation: the exact erf GELU is
    # farther from JAX than the bar
    cell = tm.cell_0
    h = cell.Dense_0(t(x))
    exact = cell.Dense_1(F.gelu(h)).detach().numpy()
    want = np.asarray(jzoo._Cell(16).apply(
        {"params": params["params"]["cell_0"]}, jnp.asarray(x)))
    np.testing.assert_allclose(cell(t(x)).detach().numpy(), want, rtol=0,
                               atol=1e-12)
    assert np.abs(exact - want).max() > 1e-6


def test_fixed_embedding_and_sampler():
    e = fixed_embedding(11, 7, seed=3, device=CPU)
    assert e.dtype == torch.float32 and e.device.type == "cpu"
    np.testing.assert_array_equal(e.numpy(),
                                  np.asarray(jzoo.fixed_embedding(11, 7, 3)))
    data = np.arange(5000) % 97
    js = jzoo.BatchSampler(data, 32, 6, seed=4, pad_len=2)
    ts = tzoo.BatchSampler(data, 32, 6, seed=4, pad_len=2, device=CPU)
    assert len(js) == len(ts)
    for _ in range(4):
        (jx, jy), (tx, ty) = js.sample(), ts.sample()
        assert tx.dtype == torch.int64 and tx.device.type == "cpu"
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            fixed_embedding(3, 2)
        with pytest.raises(RuntimeError, match="CUDA"):
            tzoo.BatchSampler(data, 32, 6)


def test_unigram_ignores_minus_one():
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 9, size=(3, 10))
    tgt = rng.integers(0, 9, size=(3, 10))
    tgt[0, :4] = -1
    jm = jzoo.UnigramModel(9)
    params = to64(jm.init(jax.random.PRNGKey(0), jnp.asarray(idx)))
    params["params"]["logits"] = rng.normal(size=9)
    tm = carried(lambda: UnigramModel(9, device=CPU, dtype=F64), params)
    jl, jloss = jm.apply(params, jnp.asarray(idx), jnp.asarray(tgt))
    tl, tloss = tm(t(idx), t(tgt))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=0)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-14)
    tloss.backward()
    jg = jax.grad(lambda p: jm.apply(p, jnp.asarray(idx),
                                     jnp.asarray(tgt))[1])(params)
    np.testing.assert_allclose(tm.logits.grad.numpy(),
                               np.asarray(jg["params"]["logits"]), rtol=0,
                               atol=1e-14)
    all_masked = tm(t(idx), torch.full((3, 10), -1))[1]
    assert all_masked.item() == 0.0


# ---- layers -------------------------------------------------------------

@pytest.mark.parametrize("length,grids", [(4, {2}), (6, {2, 3}),
                                          (8, {2, 3, 4}), (21, {2, 4, 7, 10})])
def test_itd_linear_slope_order_small_grids(length, grids):
    """Banks whose grids have 2, 3 and 4 points: at 2 and 3 the end slopes
    overlap and the last write wins, as in JAX."""
    out_dim = 4
    assert {g for *_, g in tlay._scale_constants(length, out_dim)} == grids
    x = np.random.default_rng(length).normal(size=(2, length, 1))
    jm = jlay.ITDLinear(length, out_dim)
    params = init_flax(jm, x)
    params["params"]["bias"] = np.random.default_rng(1).normal(
        size=(out_dim, 1))
    tm = carried(lambda: ITDLinear(length, out_dim, device=CPU, dtype=F64),
                 params)
    np.testing.assert_allclose(tm(t(x)).detach().numpy(),
                               np.asarray(jm.apply(params, jnp.asarray(x))),
                               rtol=0, atol=1e-12)


def test_itd_linear_bank_and_gradient():
    x = np.random.default_rng(2).normal(size=(2, 24, 1))
    held(jlay.ITDLinear(24, 5), lambda: ITDLinear(24, 5, device=CPU,
                                                   dtype=F64), [x])
    tm = ITDLinear(24, 5, device=CPU, dtype=F64)
    assert tm.idx_0.device.type == "cpu" and len(tm.grid_sizes) == 5
    assert tlay._scale_constants(24, 5) is tlay._scale_constants(24, 5)
    assert ITDLinear(24, 5, use_bias=False, device=CPU).bias is None


def test_vanilla_and_itd_mlp():
    x = np.random.default_rng(3).normal(size=(2, 16, 1))
    held(jlay.VanillaMLP(12, 10),
         lambda: VanillaMLP(16, 12, 10, device=CPU, dtype=F64), [x])
    held(jlay.ITDMLP(16, 6, 12),
         lambda: ITDMLP(16, 6, 12, device=CPU, dtype=F64), [x])


def test_itd_rnn_forecaster():
    x = np.random.default_rng(4).normal(size=(2, 10, 1))
    held(jlay.ITDRNNForecaster(10, hidden_size=6, num_layers=2,
                               output_size=2),
         lambda: ITDRNNForecaster(10, 6, 2, 2, device=CPU, dtype=F64), [x])


# ---- phase heads, Kalman gains ------------------------------------------

@pytest.mark.parametrize("complex_input", [False, True])
def test_phase_heads(complex_input):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 12))
    if complex_input:
        x = x + 1j * rng.normal(size=x.shape)
    for segs in (1, 3, 4):
        want = jph.add_hypersphere_phase_heads(jnp.asarray(x), segs)
        np.testing.assert_allclose(
            add_hypersphere_phase_heads(t(x), segs).numpy(),
            np.asarray(want), rtol=0, atol=1e-12)
        jy, js = jph.add_hypersphere_phase_heads(jnp.asarray(x), segs,
                                                 return_scalar=True)
        ty, ts = PhaseHeads(segs)(t(x))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-12)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-12)
    if not complex_input:
        xt = t(x).requires_grad_()
        y, s = add_hypersphere_phase_heads(xt, 3, return_scalar=True)
        (y.sum() + 3 * s.sum()).backward()
        g = jax.grad(lambda a: (lambda r: jnp.sum(r[0]) + 3 * jnp.sum(r[1]))(
            jph.add_hypersphere_phase_heads(a, 3, return_scalar=True)))(
            jnp.asarray(x))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-10 * np.abs(g).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mixer_fft_in_f32(dtype):
    x = np.random.default_rng(6).normal(size=(2, 9, 8)).astype(dtype)
    jm = jph.Mixer(4)
    params = init_flax(jm, x)
    tm = carried(lambda: Mixer(8, 4, device=CPU, dtype=F64), params)
    y = tm(t(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    assert y.dtype == t(x).dtype and want.dtype == dtype
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the f32 FFT is not the f64 one: a port in f64 would stand apart
    zf64 = torch.fft.ifft(add_hypersphere_phase_heads(
        torch.fft.fft(t(x).double(), dim=2), 4, 1e-16), dim=2).real
    zf32 = torch.fft.ifft(add_hypersphere_phase_heads(
        torch.fft.fft(t(x).float(), dim=2), 4, 1e-16), dim=2).real
    assert (zf64 - zf32.double()).abs().max() > 1e-9


@pytest.mark.parametrize("n_passes", [1, 5])
def test_kalman_quirks_at_batch_2(n_passes):
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(2, 6, 8)) for _ in range(3))
    jm = jkal.KalmanSweepMHGains(2, n_passes=n_passes)
    tm, params = held(jm, lambda: KalmanSweepMHGains(
        8, 2, n_passes=n_passes, device=CPU, dtype=F64), [q, k, v])
    # the contiguous 3dh slices: head 0 reads all of Q, so Q's head-1
    # channels move head 0's gains and leave head 1's (which reads K and
    # the broadcast V) alone.  The flat-prefix modulation rows reach only
    # the state estimate, which the returned gain does not read.
    q2 = q.copy()
    q2[..., 4:] += 1.0
    a = tm(t(q), t(k), t(v)).detach()
    b = tm(t(q2), t(k), t(v)).detach()
    assert (a[..., :4] - b[..., :4]).abs().max() > 1e-3
    assert torch.equal(a[..., 4:], b[..., 4:])


# ---- dashboard ----------------------------------------------------------

def test_dashboard_frames_bitwise():
    rng = np.random.default_rng(8)
    jd = jvis.MatrixDashboard(n_cols=16, n_rows=5, cell=3)
    td = MatrixDashboard(n_cols=16, n_rows=5, cell=3)
    for step in range(9):
        pred, tgt = rng.integers(0, 4, 16), rng.integers(0, 4, 16)
        loss = 3.0 / (step + 1) + rng.random()
        np.testing.assert_array_equal(td.update(pred, tgt, loss),
                                      jd.update(pred, tgt, loss))
    attn = rng.random((2, 6, 6))
    np.testing.assert_array_equal(tvis.flame_attention_panel(attn),
                                  jvis.flame_attention_panel(attn))


# ---- optimizers ---------------------------------------------------------

SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}


def jax_uniforms(seed, steps):
    """JAX's noise: per step, split the key, split the sub-key once per
    leaf (``jax.tree.leaves`` order), one uniform draw per leaf."""
    key = jax.random.PRNGKey(seed)
    names = sorted(SHAPES)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, len(names))
        out.append({n: np.asarray(jax.random.uniform(
            keys[i], SHAPES[n], jnp.float64)) for i, n in enumerate(names)})
    return out


def gradients(steps):
    rng = np.random.default_rng(9)
    return [{n: rng.normal(size=s) for n, s in SHAPES.items()}
            for _ in range(steps)]


def run_optax(tx, grads):
    rng = np.random.default_rng(10)
    params = {n: jnp.asarray(rng.normal(size=s)) for n, s in SHAPES.items()}
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state,
                                   params)
        params = optax.apply_updates(params, updates)
    return {n: np.asarray(p) for n, p in params.items()}


def start_params():
    rng = np.random.default_rng(10)
    return {n: t(rng.normal(size=s)) for n, s in SHAPES.items()}


def test_wolf_update_matches_optax():
    steps, lr = 20, 5e-2
    grads, us = gradients(steps), jax_uniforms(3, steps)
    want = run_optax(jopt.wolf(lr, seed=3), grads)
    params = start_params()
    ints = {n: torch.zeros_like(p) for n, p in params.items()}
    agree = []
    for g, u in zip(grads, us):
        for n in SHAPES:
            gt = t(g[n])
            delta, new = topt.wolf_update(gt, ints[n], params[n], t(u[n]), lr)
            agree.append((torch.sign(ints[n] * topt._ET + gt * topt._ETC)
                          * torch.sign(gt) > 0).flatten())
            ints[n], params[n] = new, params[n] + delta
    agree = torch.cat(agree)
    assert agree.any() and not agree.all()  # both branches taken
    for n in SHAPES:
        np.testing.assert_allclose(params[n].numpy(), want[n], rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("noise_scale", [0.0, 0.3])
def test_phoenix_update_matches_optax(noise_scale):
    steps, lr = 20, 5e-2
    grads, us = gradients(steps), jax_uniforms(4, steps)
    want = run_optax(jopt.phoenix(lr, m=5, noise_scale=noise_scale, seed=4),
                     grads)
    params = start_params()
    ints = {n: [torch.zeros_like(p) for _ in range(5)]
            for n, p in params.items()}
    for g, u in zip(grads, us):
        for n in SHAPES:
            delta, ints[n] = topt.phoenix_update(
                t(g[n]), ints[n], t(u[n]), lr, noise_scale)
            params[n] = params[n] + delta
    for n in SHAPES:
        np.testing.assert_allclose(params[n].numpy(), want[n], rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("make", ["wolf", "phoenix"])
def test_optimizer_draws_from_its_generator(make):
    """The optimizer is its update function on uniforms drawn from its
    generator, applied as ``p + delta``."""
    params = start_params()
    leaves = [p.clone().requires_grad_() for p in params.values()]
    if make == "wolf":
        opt = wolf(leaves, 5e-2, generator=torch.Generator().manual_seed(2))
    else:
        opt = phoenix(leaves, 5e-2, m=3, noise_scale=0.2,
                      generator=torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(2)
    ref = [p.clone() for p in params.values()]
    state = [torch.zeros_like(p) if make == "wolf"
             else [torch.zeros_like(p)] * 3 for p in ref]
    for g in gradients(6):
        for p, gv in zip(leaves, g.values()):
            p.grad = t(gv)
        opt.step()
        for i, gv in enumerate(g.values()):
            u = torch.rand(ref[i].shape, generator=gen, dtype=F64)
            if make == "wolf":
                d, state[i] = topt.wolf_update(t(gv), state[i], ref[i], u,
                                               5e-2)
            else:
                d, state[i] = topt.phoenix_update(t(gv), state[i], u, 5e-2,
                                                  0.2)
            ref[i] = ref[i] + d
    for p, r in zip(leaves, ref):
        assert torch.equal(p.detach(), r)


def same_distribution(tm, fm, what, z=5.0):
    """Every parameter of ``tm`` (the port's init) against the same
    parameter of ``fm`` (flax's init, carried across): constants equal;
    otherwise mean and standard deviation within ``z`` sampling errors and,
    over 1,000 entries or more, max|w|/std within 25% (truncated normal,
    normal and uniform stand apart there)."""
    fparams = dict(fm.named_parameters())
    for name, p in tm.named_parameters():
        a = p.detach().double().flatten()
        b = fparams[name].detach().double().flatten()
        where = f"{what}.{name}"
        if a.numel() < 2 or float(b.std()) == 0.0:
            assert torch.equal(a, b), where
            continue
        if a.numel() < 64:
            assert float(a.std()) > 0.0, where
            continue
        n, s = a.numel(), float(b.std())
        assert abs(float(a.mean() - b.mean())) <= z * s * np.sqrt(2 / n), where
        assert abs(float(a.std()) - s) <= z * s * np.sqrt(1 / n), where
        if n >= 1000:
            ra = float(a.abs().max() / a.std())
            rb = float(b.abs().max() / b.std())
            assert abs(ra - rb) <= 0.25 * rb, (where, ra, rb)


def check_init(cases):
    gen = torch.Generator().manual_seed(11)
    for jm, args, factory in cases:
        fm = carried(lambda: factory(None), init_flax(jm, *args, seed=5))
        same_distribution(factory(gen), fm, type(fm).__name__)


def test_init_statistics_foundation():
    """Each initialized parameter against flax's init of the same module,
    within sampling error."""
    kw = dict(device=CPU)
    check_init([
        (jzoo.RecurrentMLP(k=2), [np.ones((1, 64))],
         lambda g: RecurrentMLP(64, k=2, generator=g, **kw)),
        (jkal.KalmanSweepMHGains(2), [np.ones((1, 2, 128))] * 3,
         lambda g: KalmanSweepMHGains(128, 2, generator=g, **kw)),
        (jph.Mixer(4), [np.ones((1, 3, 512))],
         lambda g: Mixer(512, 4, generator=g, **kw)),
        (jlay.VanillaMLP(64, 32), [np.ones((1, 96, 1))],
         lambda g: VanillaMLP(96, 64, 32, generator=g, **kw)),
    ])


# ---- the example --------------------------------------------------------

def test_tiny_lm_against_flax():
    import sys
    import os

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                    "examples"))
    try:
        import train_tiny as jtiny
    finally:
        sys.path.pop(0)
    idx = np.random.default_rng(12).integers(0, 32, size=(2, 64))
    held(jtiny.TinyLM(), lambda: ttiny.TinyLM(device=CPU, dtype=F64), [idx],
         call=lambda r: r[0], out=lambda r: r[0])


def test_train_tiny_runs(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the example writes dashboard.png here
    out = ttiny.main(["--device", "cpu", "--steps", "20"])
    assert np.isfinite(out["loss"]) and np.isfinite(out["unigram_loss"])
    assert out["frame"].dtype == np.uint8 and out["frame"].ndim == 3
    assert "not checked" in capsys.readouterr().out
