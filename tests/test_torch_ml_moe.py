"""The port's MoE family (``pyitd_tpu_torch/ml/moe.py``) against the JAX
package's on the CPU, case by case after ``tests/test_moe.py`` and the
MoE cases of ``tests/test_train_parallel.py``.

As in ``test_torch_ml_foundation.py``: each module built in flax, carried
across with ``load_flax_params`` in f64, forward to 1e-10, gradients to
1e-10 of max|g|.  The routing is discrete: ``ModCRTMoE``'s expert ids
are held exactly equal to JAX's (a jitted copy of its routing lines) in
f64 and in f32 (the f32 expert outputs to 1e-5 of max|y| given those
ids); ``router_topk``'s indices exactly, ties lowest index first, and its
custom backward (a one-hot product in the port) to 1e-12.  The capacity
dispatch against the gather dispatch where no expert overflows (1e-12:
the einsums sum zeros), and with overflow the dropped rows exactly zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pyitd_tpu.ml import moe as jmoe
from pyitd_tpu_torch.ml import moe as tmoe
from test_torch_ml_foundation import carried, held, init_flax, t

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64


def test_first_primes_and_inverse():
    assert tmoe.first_primes(4) == jmoe.first_primes(4) == [3, 5, 7, 11]
    assert tmoe.first_primes(3, start=10) == jmoe.first_primes(3, start=10)
    for a, m in [(3, 7), (5, 11), (11, 13), (7, 3)]:
        assert tmoe._inv_mod(a, m) == jmoe._inv_mod(a, m)
        assert tmoe._inv_mod(a, m) * a % m == 1
    with pytest.raises(ValueError, match="not invertible"):
        tmoe._inv_mod(6, 9)


def test_router_topk_forward_and_grad():
    """Indices exactly, weights and the custom backward to 1e-12; the
    gradient flows only into the selected entries."""
    rng = np.random.default_rng(0)
    z = rng.normal(size=(5, 8))
    w_out = rng.normal(size=(5, 3))
    jti, jw = jmoe.router_topk(jnp.asarray(z), 3, 0.7)
    zt = t(z).requires_grad_()
    ti, w = tmoe.router_topk(zt, 3, 0.7)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(jti))
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw), rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(w.detach().numpy().sum(-1), 1.0, atol=1e-12)
    (w * t(w_out)).sum().backward()
    jg = np.asarray(jax.grad(lambda a: jnp.sum(
        jmoe.router_topk(a, 3, 0.7)[1] * w_out))(jnp.asarray(z)))
    np.testing.assert_allclose(zt.grad.numpy(), jg, rtol=0, atol=1e-12)
    sel = np.zeros((5, 8), bool)
    np.put_along_axis(sel, ti.numpy(), True, axis=1)
    assert np.all(zt.grad.numpy()[~sel] == 0)
    assert np.any(zt.grad.numpy()[sel] != 0)


def test_router_topk_ties_lowest_index_first():
    z = np.array([[1.0, 3.0, 3.0, 0.0, 3.0], [2.0, 2.0, 2.0, 2.0, 2.0]])
    ti, _ = tmoe.router_topk(t(z), 3, 1.0)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(
        jmoe.router_topk(jnp.asarray(z), 3, 1.0)[0]))
    np.testing.assert_array_equal(ti.numpy(), [[1, 2, 4], [0, 1, 2]])


def test_linear_bilinear_and_bimlp():
    x = np.random.default_rng(1).normal(size=(4, 16))
    held(jmoe.LinearBilinear(rank=5, q_frac=0.3, alpha=0.7, hidden=24),
         lambda: tmoe.LinearBilinear(16, 5, q_frac=0.3, alpha=0.7,
                                     hidden=24, device=CPU, dtype=F64), [x])
    held(jmoe.BiMLP(), lambda: tmoe.BiMLP(16, device=CPU, dtype=F64),
         [x.reshape(2, 2, 16)])


def _jax_eid(x, num_experts, seed=0, moduli=None):
    """JAX's routing of ``x`` (N, D), jitted: ``ModCRTMoE``'s own lines
    (pyitd_tpu/ml/moe.py:166-191) with the residues beside the ids."""
    m_list = jmoe.ModCRTMoE(num_experts, moduli=moduli)._moduli()

    @jax.jit
    def route(xf):
        import math

        d = xf.shape[-1]
        kch = len(m_list)
        rng = np.random.default_rng(seed)
        w_hash = jnp.asarray(rng.normal(size=(d, kch)) / math.sqrt(d),
                             xf.dtype)
        b_hash = jnp.asarray(rng.normal(size=(kch,)) * 0.01, xf.dtype)
        periods = jnp.ones((kch,), xf.dtype)
        m = jnp.asarray(m_list, jnp.int32)
        s = xf @ w_hash + b_hash
        f = jnp.remainder(s, periods)
        r = jnp.floor(f * (m.astype(xf.dtype) / periods) + 0.5)
        r = jnp.remainder(r, m.astype(xf.dtype)).astype(jnp.int32)
        cands = []
        for i in range(kch):
            for j in range(i + 1, kch):
                m1, m2 = m_list[i], m_list[j]
                inv = jmoe._inv_mod(m1 % m2, m2)
                tt = ((r[:, j] - r[:, i]) % m2) * inv % m2
                cands.append((r[:, i] + tt * m1) % (m1 * m2))
        cand = jnp.stack(cands, axis=1)
        match = (cand[:, :, None] % m[None, None, :]) == r[:, None, :]
        best = jnp.take_along_axis(
            cand, jnp.argmax(jnp.sum(match, -1), axis=1)[:, None], 1)[:, 0]
        return r, best % num_experts

    r, eid = route(jnp.asarray(x))
    return np.asarray(r), np.asarray(eid)


@pytest.mark.parametrize("dispatch", ["gather", "capacity"])
def test_modcrt_moe_f64(dispatch):
    """Forward and gradients to 1e-10 in f64, 2-D and 3-D input; the ids
    exactly JAX's; every expert used."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 16, 12))
    kw = dict(seed=5, dispatch=dispatch,
              capacity=64 if dispatch == "capacity" else None)
    tm, params = held(
        jmoe.ModCRTMoE(num_experts=6, **kw),
        lambda: tmoe.ModCRTMoE(12, 6, device=CPU, dtype=F64, **kw), [x])
    jr, jeid = _jax_eid(x.reshape(-1, 12), 6, seed=5)
    eid = tm.route(t(x.reshape(-1, 12)))
    np.testing.assert_array_equal(eid.numpy(), jeid)
    assert len(np.unique(jeid)) == 6
    y3 = tm(t(x)).detach().numpy()
    y2 = tm(t(x.reshape(-1, 12))).detach().numpy()
    np.testing.assert_array_equal(y3.reshape(-1, 12), y2)
    assert tm.moduli == jmoe.ModCRTMoE(6)._moduli() == [3, 5, 7, 11]


def test_modcrt_moe_f32_routes_exactly():
    """f32: the residues' ids exactly JAX's (jitted, XLA may contract the
    fold into an FMA); the expert outputs given those ids to 1e-5 of
    max|y|."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(256, 16)).astype(np.float32)
    jm = jmoe.ModCRTMoE(num_experts=8, seed=3)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    jy = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    _, jeid = _jax_eid(x, 8, seed=3)
    tm = carried(lambda: tmoe.ModCRTMoE(16, 8, seed=3, device=CPU),
                 jax.tree.map(np.asarray, params))
    eid = tm.route(t(x))
    np.testing.assert_array_equal(eid.numpy(), jeid)
    y = tm(t(x)).detach().numpy()
    np.testing.assert_allclose(y, jy, rtol=0, atol=1e-5 * np.abs(jy).max())


def test_expert_init_is_per_expert_fan_in():
    """``W1`` (E, 2D, D) and ``W2`` (E, D, 2D) uniform with variance 2 /
    fan_in of the contraction dim alone (flax's ``batch_axis=0``)."""
    m = tmoe.ModCRTMoE(32, 16, device=CPU, dtype=F64)
    j = init_flax(jmoe.ModCRTMoE(16), np.zeros((4, 32)))["params"]
    for name, fan_in in (("W1", 32), ("W2", 64)):
        w = getattr(m, name).detach().numpy()
        assert w.shape == j[name].shape
        limit = np.sqrt(6.0 / fan_in)
        assert np.abs(w).max() <= limit
        assert abs(w.std() - limit / np.sqrt(3)) < 0.02 * limit
        assert abs(np.asarray(j[name]).std() - limit / np.sqrt(3)) < (
            0.02 * limit)
    assert not m.b2.detach().any()


def test_capacity_dispatch_tensor():
    eid = torch.tensor([0, 2, 0, 1, 0, 2])
    d = tmoe.capacity_dispatch(eid, 3, 2)
    np.testing.assert_array_equal(d.numpy(), np.asarray(
        jmoe.capacity_dispatch(jnp.asarray(eid.numpy()), 3, 2)))
    assert d.shape == (6, 3, 2)
    assert d[0, 0, 0] == 1 and d[2, 0, 1] == 1 and float(d[4].sum()) == 0
    assert float(d.sum()) == 5


def test_moe_capacity_matches_gather():
    """Capacity = all tokens: nothing overflows, the outputs agree with
    the gather dispatch to 1e-12 (f64) and with JAX's capacity path."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 8, 16))
    params = init_flax(jmoe.ModCRTMoE(8, seed=3), x, seed=2)
    gather = carried(lambda: tmoe.ModCRTMoE(16, 8, seed=3, device=CPU,
                                            dtype=F64), params)
    cap = carried(lambda: tmoe.ModCRTMoE(16, 8, seed=3, dispatch="capacity",
                                         capacity=32, device=CPU, dtype=F64),
                  params)
    yg, yc = gather(t(x)), cap(t(x))
    np.testing.assert_allclose(yc.detach().numpy(), yg.detach().numpy(),
                               rtol=0, atol=1e-12)
    jy = np.asarray(jmoe.ModCRTMoE(8, seed=3, dispatch="capacity",
                                   capacity=32).apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(yc.detach().numpy(), jy, rtol=0, atol=1e-12)


def test_moe_capacity_drops_overflow():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(32, 16))
    params = init_flax(jmoe.ModCRTMoE(2, seed=3), x, seed=2)
    m0 = carried(lambda: tmoe.ModCRTMoE(16, 2, seed=3, dispatch="capacity",
                                        capacity=32, device=CPU, dtype=F64),
                 params)
    m1 = carried(lambda: tmoe.ModCRTMoE(16, 2, seed=3, dispatch="capacity",
                                        capacity=1, device=CPU, dtype=F64),
                 params)
    y0, y1 = m0(t(x)).detach().numpy(), m1(t(x)).detach().numpy()
    dropped = np.abs(y1).sum(-1) == 0
    assert dropped.sum() == 30  # 32 tokens, 2 experts x capacity 1
    np.testing.assert_allclose(y1[~dropped], y0[~dropped], rtol=0,
                               atol=1e-12)
    jy1 = np.asarray(jmoe.ModCRTMoE(2, seed=3, dispatch="capacity",
                                    capacity=1).apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(y1, jy1, rtol=0, atol=1e-12)


def test_fast_learned_cell_x3():
    """Three routed tapes (k = 2, 3, 1), forward and gradients (tapes and
    address vectors) to 1e-10 in f64."""
    x = np.random.default_rng(4).normal(size=(2, 10, 8))
    kw = dict(l_w1=6, l_w2=5, l_b2=4, k1=2, k2=3, k3=1, tau=0.5, d_addr=12,
              seed=7)
    held(jmoe.FastLearnedCellX3(hidden=16, d_out=5, **kw),
         lambda: tmoe.FastLearnedCellX3(8, 16, 5, device=CPU, dtype=F64,
                                        **kw), [x])


def test_fast_learned_cell_trains():
    """The JAX test's run (``tests/test_moe.py:68-89``), 120 Adam(3e-3)
    steps on the port: the loss below 0.6 of its start; the tape init's
    rows unit-norm."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 8))
    target = torch.from_numpy(np.tanh(x @ rng.normal(size=(8, 8)))).float()
    x = torch.from_numpy(x).float()
    m = tmoe.FastLearnedCellX3(8, 16, 8, device=CPU,
                               generator=torch.Generator().manual_seed(0))
    norms = m.W1.detach().double().flatten(1).norm(dim=1)
    torch.testing.assert_close(norms, torch.ones(12, dtype=F64), rtol=0,
                               atol=1e-6)
    opt = torch.optim.Adam(m.parameters(), 3e-3)
    loss = lambda: ((m(x) - target) ** 2).mean()  # noqa: E731
    l0 = loss().item()
    for _ in range(120):
        opt.zero_grad()
        loss().backward()
        opt.step()
    assert loss().item() < 0.6 * l0


def test_modcrt_moe_trains_like_optax():
    """Five Adam steps of the capacity MoE in f64, torch.optim.Adam against
    optax.adam from the same weights: parameters to 1e-10."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(8, 8, 16))
    tgt = 0.5 * x
    jm = jmoe.ModCRTMoE(8, seed=3, dispatch="capacity", capacity=80)
    params = init_flax(jm, x, seed=3)
    tm = carried(lambda: tmoe.ModCRTMoE(16, 8, seed=3, dispatch="capacity",
                                        capacity=80, device=CPU, dtype=F64),
                 params)
    tx = optax.adam(1e-2)
    state = tx.init(params)
    step = jax.jit(lambda p, s: (lambda g: (
        optax.apply_updates(p, tx.update(g, s, p)[0]),
        tx.update(g, s, p)[1]))(jax.grad(
            lambda q: jnp.mean((jm.apply(q, jnp.asarray(x)) - tgt) ** 2))(p)))
    opt = torch.optim.Adam(tm.parameters(), 1e-2)
    for _ in range(5):
        params, state = step(params, state)
        opt.zero_grad()
        ((tm(t(x)) - t(tgt)) ** 2).mean().backward()
        opt.step()
    want = carried(lambda: tmoe.ModCRTMoE(16, 8, device=CPU, dtype=F64),
                   jax.tree.map(np.asarray, params))
    for (name, p), q in zip(tm.named_parameters(), want.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=0, atol=1e-10, err_msg=name)


def test_unknown_dispatch_raises():
    with pytest.raises(ValueError, match="unknown dispatch"):
        tmoe.ModCRTMoE(4, 2, dispatch="scatter", device=CPU)


def test_load_flax_params_fills_and_refuses_moe_trees():
    """The MoE bank's raw leaves fill the parameters of their own names;
    a bank of another shape, an extra leaf and a missing one raise."""
    from pyitd_tpu_torch.utils.interop import load_flax_params

    x = np.zeros((4, 16))
    params = init_flax(jmoe.ModCRTMoE(8, seed=3), x)
    mk = lambda: tmoe.ModCRTMoE(16, 8, device=CPU, dtype=F64)  # noqa: E731
    m = carried(mk, params)
    np.testing.assert_array_equal(m.W2.detach().numpy(),
                                  params["params"]["W2"])
    bad = {"params": dict(params["params"], W1=np.zeros((8, 32, 8)))}
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(mk(), bad)
    extra = {"params": dict(params["params"], W3=np.zeros(3))}
    with pytest.raises(ValueError, match="no torch"):
        load_flax_params(mk(), extra)
    short = {"params": {k: v for k, v in params["params"].items()
                        if k != "b2"}}
    with pytest.raises(ValueError, match="no flax leaf filled"):
        load_flax_params(mk(), short)
