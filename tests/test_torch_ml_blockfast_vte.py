"""The port's BlockFast and VTE families (``pyitd_tpu_torch/ml/blockfast.py``,
``ml/vte.py``) against the JAX package's on the CPU, case by case after
``tests/test_blockfast.py`` and ``tests/test_vte.py``.

As in ``test_torch_ml_foundation.py``: flax's weights carried across with
``load_flax_params``, forward outputs and gradients in f64 to 1e-10 (of
max|y| and max|g|), except where a ``Mixer`` runs its FFT in f32 whatever
the dtype (``BlockFastBlock``, ``BlockFastLM``: 1e-5).  The incremental
step path is f32 by design (complex64 mixer ring, f32 conv tail and block
ring): the port's step is held against JAX's step from the first token to
1e-5 of max|y|, and against the port's own full forward after the warm-up
``3 * (h + 1)`` tokens (per layer) at JAX's ``atol=1e-4``.  The VTE guards
are held at their degenerate points (u = ±a, antipodal directions, norms
below tau), forward and gradient, where JAX's gradient is NaN only at the
exact zero-vector points (the port's is finite there: torch's norm has
gradient 0 at zero); QR-based subspaces are compared after
``sign_align`` (LAPACK's and cuSOLVER's Householder signs may differ, R's
diagonal fixes them); ``frft_time`` in complex128 to 1e-10; ``ar1_filter``
(a doubling scan, JAX's is an associative scan) against the sequential
filter to 1e-10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyitd_tpu.ml import blockfast as jbf
from pyitd_tpu.ml import vte as jvte
from pyitd_tpu_torch.ml import blockfast as tbf
from pyitd_tpu_torch.ml import vte as tvte
from test_torch_ml_foundation import carried, held, init_flax, t

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64


def grad_pair(jfn, tfn, x, tol=1e-10, seed=11, jax_nan=()):
    """``jfn`` and ``tfn`` on ``x`` (f64): the forward to ``tol`` of
    max|y| and the gradient of a random projection to ``tol`` of max|g|;
    the port's both finite.  JAX's gradient is finite too, except on the
    time steps ``jax_nan`` of ``x`` (axis -2), where it must be NaN."""
    w = np.random.default_rng(seed).normal(size=np.shape(jfn(jnp.asarray(x))))
    jy = np.asarray(jfn(jnp.asarray(x)))
    jg = np.asarray(jax.grad(lambda a: jnp.sum(jfn(a) * w))(jnp.asarray(x)))
    xt = t(x).requires_grad_()
    ty = tfn(xt)
    if ty.requires_grad:
        (ty * t(w)).sum().backward()
    else:  # the output does not depend on x
        xt.grad = torch.zeros_like(xt)
    nan_steps = np.zeros(jg.shape[-2], bool)
    nan_steps[list(jax_nan)] = True
    jfinite = np.isfinite(jg).all(-1)
    assert np.isfinite(jy).all()
    np.testing.assert_array_equal(~jfinite, np.broadcast_to(
        nan_steps, jfinite.shape) & ~jfinite)
    assert (~jfinite).any(axis=tuple(range(jg.ndim - 2))).tolist() == \
        nan_steps.tolist()
    assert np.isfinite(xt.grad.numpy()).all()
    np.testing.assert_allclose(ty.detach().numpy(), np.broadcast_to(
        jy, ty.shape), rtol=0, atol=tol * max(1.0, np.abs(jy).max()))
    ok = np.broadcast_to(jfinite[..., None], jg.shape)
    np.testing.assert_allclose(xt.grad.numpy()[ok], jg[ok], rtol=0,
                               atol=tol * max(1.0, np.abs(jg[ok]).max()))
    return ty.detach().numpy(), xt.grad.numpy()


# ---- BlockFast ----------------------------------------------------------

def test_circular_student_t_properties():
    c = np.asarray([0.0, 1.5, 3.9, -2.2, 7.1])
    w = tbf.circular_student_t(t(c), 4, 2.0).numpy()
    np.testing.assert_allclose(
        w, np.asarray(jbf.circular_student_t(jnp.asarray(c), 4, 2.0)),
        rtol=0, atol=1e-15)
    np.testing.assert_allclose(w.sum(-1), 1.0, atol=1e-12)
    assert np.argmax(w[0]) == 0 and np.argmax(w[1]) in (1, 2)
    assert w[2, 0] > w[2, 2]  # circular: 3.9 is nearest bin 0


def test_moemlp():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 8))
    s = np.tanh(rng.normal(size=(2, 5)))
    held(jbf.MOEMLP(3), lambda: tbf.MOEMLP(8, 3, device=CPU, dtype=F64),
         [x, s])


def test_blockfast_block_full():
    """The full-sequence block (Mixer FFT in f32: 1e-5)."""
    x = np.random.default_rng(1).normal(size=(2, 12, 16))
    held(jbf.BlockFastBlock(num_heads=4),
         lambda: tbf.BlockFastBlock(16, 4, device=CPU, dtype=F64), [x],
         tol=1e-5)


@pytest.mark.parametrize("with_targets", [True, False])
def test_blockfast_lm(with_targets):
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 12, size=(3, 10))
    tgt = rng.integers(0, 12, size=(3, 10))
    tgt[0, :4] = -1
    args = [idx, tgt] if with_targets else [idx]
    pick = (lambda r: r[1]) if with_targets else (lambda r: r[0])
    tm, _ = held(jbf.BlockFastLM(vocab_size=12, n_embd=16, n_layer=2,
                                 n_head=4),
                 lambda: tbf.BlockFastLM(12, 16, 2, 4, device=CPU,
                                         dtype=F64),
                 args, tol=1e-5, call=pick, out=pick)
    if not with_targets:
        assert tm(t(idx))[1] is None


def _step_block(b=2, tt=26, c=16, h=4):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(b, tt, c)).astype(np.float32)
    jblk = jbf.BlockFastBlock(num_heads=h)
    params = jax.jit(jblk.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    tblk = carried(lambda: tbf.BlockFastBlock(c, h, device=CPU),
                   jax.tree.map(np.asarray, params))
    return x, jblk, params, tblk


def test_step_matches_jax_step_from_first_token():
    """The port's step path against JAX's, token by token from the cold
    start, f32, to 1e-5 of max|y|; the carried rings too."""
    b, tt, c, h = 2, 26, 16, 4
    x, _, params, tblk = _step_block(b, tt, c, h)
    jstates = jbf.blockfast_init_state(b, c, h, n_layer=1)
    tstates = tbf.blockfast_init_state(b, c, h, 1, device=CPU)
    jstep = jax.jit(lambda s, xt: jbf.blockfast_step(
        [params["params"]], s, xt, n_head=h))
    ys, jys = [], []
    with torch.no_grad():
        for k in range(tt):
            jstates, jy = jstep(jstates, jnp.asarray(x[:, k]))
            tstates, y = tbf.blockfast_step([tblk], tstates, t(x[:, k]),
                                            n_head=h)
            jys.append(np.asarray(jy))
            ys.append(y.numpy())
    jys, ys = np.stack(jys, 1), np.stack(ys, 1)
    assert ys.dtype == np.float32
    np.testing.assert_allclose(ys, jys, rtol=0, atol=1e-5 * np.abs(jys).max())
    for jst, st in zip(jax.tree.leaves(jstates), jax.tree.leaves(tstates)):
        assert str(st.dtype).split(".")[-1] == str(jst.dtype)
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=0,
                                   atol=1e-5 * max(1.0,
                                                   np.abs(jst).max()))


def test_step_matches_full_after_warmup():
    """``tests/test_blockfast.py:47-67`` on the port: step against full
    after ``3 * (h + 1)`` tokens, atol 1e-4."""
    b, tt, c, h = 2, 26, 16, 4
    x, _, _, tblk = _step_block(b, tt, c, h)
    with torch.no_grad():
        full = tblk(t(x)).numpy()
        states = tbf.blockfast_init_state(b, c, h, 1, device=CPU)
        outs = []
        for k in range(tt):
            states, y = tbf.blockfast_step([tblk], states, t(x[:, k]),
                                           n_head=h)
            outs.append(y.numpy())
    inc = np.stack(outs, axis=1)
    warm = 3 * (h + 1)
    np.testing.assert_allclose(inc[:, warm:], full[:, warm:], atol=1e-4)
    assert np.abs(inc[:, :2] - full[:, :2]).max() > 1e-4  # the cold start


def test_lm_step_serves_like_full_forward():
    """``BlockFastLM.step`` (embed, every block, head) on a token sequence
    against the full forward's logits after the warm-up, atol 1e-4; the
    states keep JAX's dtypes.  The cold start runs through the stack, so
    the warm-up is JAX's ``3 * (h + 1)`` per layer: at 2 layers JAX's own
    step path is still 2.3e-4 from its full forward at token 15 on this
    sequence."""
    rng = np.random.default_rng(3)
    m = tbf.BlockFastLM(24, 16, 2, 4, device=CPU,
                        generator=torch.Generator().manual_seed(2))
    idx = torch.from_numpy(rng.integers(0, 24, size=(3, 30)))
    with torch.no_grad():
        full, _ = m(idx)
        states = m.init_state(3)
        kinds = [(s.mixer.phase.rb_v.dtype, s.mixer.dw_buf.dtype,
                  s.phase.rb_v.dtype, s.phase.s_prev.dtype) for s in states]
        assert kinds == [(torch.complex64, torch.float32, torch.float32,
                          torch.float32)] * 2
        steps = []
        for k in range(30):
            states, _, logits = m.step(states, idx[:, k])
            steps.append(logits)
    steps = torch.stack(steps, 1)
    warm = 3 * (4 + 1) * 2
    torch.testing.assert_close(steps[:, warm:], full[:, warm:], atol=1e-4,
                               rtol=0)


def test_blockfast_lm_trains():
    """``tests/test_blockfast.py:22-45`` on the port: 30 Adam(3e-3) steps
    lower the loss."""
    rng = np.random.default_rng(0)
    m = tbf.BlockFastLM(12, 16, 1, 4, device=CPU,
                        generator=torch.Generator().manual_seed(0))
    idx = torch.from_numpy(rng.integers(0, 12, (4, 10)))
    opt = torch.optim.Adam(m.parameters(), 3e-3)
    logits, l0 = m(idx, idx)
    assert logits.shape == (4, 10, 12) and torch.isfinite(l0)
    for _ in range(30):
        opt.zero_grad()
        m(idx, idx)[1].backward()
        opt.step()
    assert float(m(idx, idx)[1]) < float(l0)


# ---- VTE: elementwise and guards ----------------------------------------

def test_spiral_and_spiral_mix():
    rng = np.random.default_rng(0)
    for shape, kw in [((4, 6), dict(radius=2.0)),
                      ((2, 3, 5), dict(cube_shell=True, k=0.5)),
                      ((3, 1), {})]:
        x = rng.normal(size=shape)
        grad_pair(lambda a: jvte.pairwise_rot_spiral(a, **kw),
                  lambda a: tvte.pairwise_rot_spiral(a, **kw), x)
    x = rng.normal(size=(2, 10, 4))
    grad_pair(lambda a: jvte.spiral_mix(a, center=0.3, loop_iters=3),
              lambda a: tvte.spiral_mix(a, center=0.3, loop_iters=3), x)
    y = torch.from_numpy(rng.normal(size=(4, 6)) * 0.1)
    for _ in range(200):
        y = tvte.pairwise_rot_spiral(y, radius=2.0, step=0.1)
    assert np.all(np.abs(np.linalg.norm(y.numpy(), axis=-1) - 2.0) < 0.2)


def _degenerate_rows(c=6, d=2, seed=4):
    """(1, T, c) rows whose lagged pairs hit every guard: u = a, u = -a,
    u near ±a within tau, a tiny norm, antipodal pairs, generic pairs."""
    rng = np.random.default_rng(seed)
    a = np.eye(c)[0]
    rows = [rng.normal(size=c) for _ in range(d)]
    for r in (3.0 * a, -2.0 * a, 2.0 * a + 1e-9 * rng.normal(size=c),
              -a + 1e-9 * rng.normal(size=c), 1e-9 * rng.normal(size=c),
              rng.normal(size=c)):
        rows.append(r)
    base = rng.normal(size=c)
    rows += [base, rng.normal(size=c), -0.5 * base, 4.0 * base]
    return np.stack(rows)[None]


@pytest.mark.parametrize("fn", ["phase_tap", "phase_transport"])
def test_guards_forward_and_gradient(fn):
    """Random rows, and rows on every guard: the forward and the gradient
    equal JAX's, the port's finite.  One point differs on purpose: where u
    = a exactly, ``phase_tap``'s unselected Householder branch normalizes
    the zero vector ``a - u``; its cotangent is zero, but JAX's derivative
    of ``jnp.linalg.norm`` at zero is NaN and 0 * NaN reaches x_t's
    gradient, while torch's ``vector_norm`` has gradient 0 there.  On that
    step JAX's gradient is NaN and the port's finite; everywhere else they
    agree.  Likewise ``phase_transport`` at one channel: the antipodal
    branch's perpendicular ``p`` is the zero vector at every step, and
    JAX's gradient is NaN on every lagged step."""
    jf, tf = getattr(jvte, fn), getattr(tvte, fn)
    rng = np.random.default_rng(2)
    tap = fn == "phase_tap"
    exact = (2,) if tap else ()  # the row 3a: u = a exactly
    for d, x, nan in [(3, rng.normal(size=(2, 32, 8)), ()),
                      (2, _degenerate_rows(), exact),
                      (1, _degenerate_rows(seed=5), exact),
                      (4, rng.normal(size=(2, 3, 5)), ()),
                      (2, rng.normal(size=(2, 9, 1)),
                       () if tap else range(7))]:
        grad_pair(lambda a: jf(a, d), lambda a: tf(a, d), x, jax_nan=nan)


def test_guards_preserve_norm():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 40, 8))
    for fn, d in ((tvte.phase_tap, 3), (tvte.phase_transport, 2)):
        y = fn(t(x), d).numpy()
        w = x[:, d:] - x[:, :-d]
        np.testing.assert_allclose(np.linalg.norm(y[:, d:], axis=-1),
                                   np.linalg.norm(w, axis=-1), atol=1e-8)
    y = tvte.phase_tap(t(x), 3).numpy()
    np.testing.assert_allclose(y[:, 0, 0], 1.0 / 3, atol=1e-12)
    assert np.allclose(y[:, 0, 1:], 0.0)


def test_antipodal_transport_reflects():
    """u = -v exactly: the antipodal branch (reflections across v and the
    perpendicular of its smallest coordinate)."""
    v = np.array([0.3, -1.2, 0.05, 0.8])
    x = np.stack([v, -2.0 * v])[None]
    grad_pair(lambda a: jvte.phase_transport(a, 1),
              lambda a: tvte.phase_transport(a, 1), x)


# ---- VTE: subspaces ------------------------------------------------------

def test_orthonorm_and_subspace_iteration():
    rng = np.random.default_rng(4)
    d, r = 16, 3
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    evals = np.sort(rng.uniform(0.1, 1.0, d))
    evals[-r:] = [5.0, 7.0, 10.0]
    cmat = np.stack([(q * evals) @ q.T, np.diag(np.arange(1.0, d + 1))])
    v = tvte.subspace_iteration(t(cmat), r, k=6).numpy()
    top = q[:, np.argsort(evals)[-r:]]
    assert np.linalg.norm(top @ top.T @ v[0] - v[0]) < 1e-3
    np.testing.assert_allclose(v[0].T @ v[0], np.eye(r), atol=1e-8)
    jv = np.asarray(jvte.subspace_iteration(jnp.asarray(cmat), r, k=6))
    a = rng.normal(size=(2, d))
    np.testing.assert_allclose(
        tvte.sign_align(t(v), t(a)).numpy(),
        np.asarray(jvte.sign_align(jnp.asarray(jv), jnp.asarray(a))),
        rtol=0, atol=1e-10)
    m = rng.normal(size=(3, 7, 4))
    np.testing.assert_allclose(
        tvte.orthonorm_columns(t(m)).numpy(),
        np.asarray(jvte.orthonorm_columns(jnp.asarray(m))), rtol=0,
        atol=1e-12)


def test_sign_align_energy_softshrink():
    rng = np.random.default_rng(5)
    v, a = rng.normal(size=(2, 8, 3)), rng.normal(size=(2, 8))
    va = tvte.sign_align(t(v), t(a)).numpy()
    assert np.all(np.sum(va * a[..., None], axis=1) >= -1e-9)
    np.testing.assert_array_equal(va, np.asarray(jvte.sign_align(
        jnp.asarray(v), jnp.asarray(a))))
    tr = rng.normal(size=(2, 30, 3))
    grad_pair(lambda x: jvte.energy_normalize(x)[0] * 2
              + jvte.energy_normalize(x)[1],
              lambda x: tvte.energy_normalize(x)[0] * 2
              + tvte.energy_normalize(x)[1], tr)
    np.testing.assert_allclose(
        (tvte.energy_normalize(t(tr))[0].numpy() ** 2).sum(1), 1.0,
        atol=1e-6)
    x = rng.normal(size=(4, 9))
    grad_pair(lambda a: jvte.soft_shrink(a, 0.3),
              lambda a: tvte.soft_shrink(a, 0.3), x)
    assert tvte.soft_shrink(t(x), 0.0) is not None
    assert np.all(tvte.soft_shrink(t(np.array([0.0, 0.01])), 0.5).numpy()
                  <= 0.011)


def test_lowrank_shift():
    x = np.random.default_rng(6).normal(size=(2, 5, 12))
    held(jvte.LowRankShift(shift_rank=3),
         lambda: tvte.LowRankShift(12, 3, device=CPU, dtype=F64), [x])


def test_frft_time():
    """complex128 against JAX to 1e-10 at alphas on both sides, the
    identity and the reversal; the inverse O(1) and the conjugate
    symmetry of the sign-preserving cot guard."""
    rng = np.random.default_rng(6)
    z = rng.normal(size=(1, 64, 2))
    zc = z + 1j * rng.normal(size=z.shape)
    for alpha in (0.0, np.pi, -np.pi, np.pi / 2, 0.7, -1.3, 2.5, 2.99, 7.0):
        for src in (z, zc):
            got = tvte.frft_time(torch.from_numpy(src), alpha).numpy()
            want = np.asarray(jvte.frft_time(jnp.asarray(src), alpha))
            assert got.dtype == np.complex128
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * max(
                1.0, np.abs(want).max()))
    np.testing.assert_allclose(tvte.frft_time(t(z), 0.0).numpy().real, z,
                               atol=1e-12)
    for a in (0.7, 1.3, 2.5):
        inv = tvte.frft_time(t(z), -a)
        assert float(inv.abs().max()) < 50.0
        alt = tvte.frft_time(torch.from_numpy(z.astype(complex)).conj(),
                             a).conj()
        torch.testing.assert_close(inv, alt, atol=1e-8, rtol=0)
    f32 = tvte.frft_time(torch.from_numpy(z.astype(np.float32)), 0.7)
    assert f32.dtype == torch.complex64


def test_frft_gradient():
    x = np.random.default_rng(7).normal(size=(2, 24, 3))
    grad_pair(lambda a: jnp.real(jvte.frft_time(a, 0.9))
              + jnp.imag(jvte.frft_time(a, -1.7)),
              lambda a: tvte.frft_time(a, 0.9).real
              + tvte.frft_time(a, -1.7).imag, x)


def test_ar1_filter_matches_sequential():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 37, 3))
    rho = 0.7
    want = np.zeros_like(x)
    want[:, 0] = x[:, 0]
    for k in range(1, 37):
        want[:, k] = rho * want[:, k - 1] + x[:, k]
    np.testing.assert_allclose(tvte.ar1_filter(t(x), rho).numpy(), want,
                               atol=1e-10)
    grad_pair(lambda a: jvte.ar1_filter(a, rho),
              lambda a: tvte.ar1_filter(a, rho), x)
    one = rng.normal(size=(1, 1, 2))
    np.testing.assert_array_equal(tvte.ar1_filter(t(one), rho).numpy(), one)


def test_dynmix_cooperative_contraction():
    rng = np.random.default_rng(9)
    comps = [rng.normal(size=(2, 8, 4)) for _ in range(3)]
    out = tvte.dynmix([t(c) for c in comps], loop_iters=2)
    jout = jvte.dynmix([jnp.asarray(c) for c in comps], loop_iters=2)
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-13)
    before = sum(np.linalg.norm(comps[i] - comps[j])
                 for i in range(3) for j in range(i + 1, 3))
    after = sum(float(torch.linalg.norm(out[i] - out[j]))
                for i in range(3) for j in range(i + 1, 3))
    assert after < before
    st = tvte.dynmix(torch.stack([t(c) for c in comps]), loop_iters=2)
    np.testing.assert_allclose(st[0].numpy(), out[0].numpy(), atol=1e-12)
    with pytest.raises(ValueError, match="at least 3"):
        tvte.dynmix([t(c) for c in comps[:2]])


# ---- VTE: the modules ----------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(rank=4, k_iters=2, shift_rank=4, shrink_lambda=0.01),
    dict(rank=3, k_iters=3, shift_rank=0, use_frft=True, n_alphas=4,
         causal=True, ar_rho=0.5, use_layernorm=False),
    dict(rank=4, k_iters=2, shift_rank=8, shrink_lambda=0.01, use_frft=True),
])
def test_manifold_stage(kw):
    x = np.random.default_rng(7).normal(size=(2, 24, 16))
    held(jvte.ManifoldStage(**kw),
         lambda: tvte.ManifoldStage(16, device=CPU, dtype=F64, **kw), [x])


def test_autoencoder_block():
    x = np.random.default_rng(8).normal(size=(2, 12, 16))
    held(jvte.AutoencoderBlock(rank=4),
         lambda: tvte.AutoencoderBlock(16, 4, device=CPU, dtype=F64), [x])


@pytest.mark.parametrize("with_targets", [True, False])
def test_blockfast_gpt(with_targets):
    """To 1e-5: the fixed embeddings are f32 in both packages, and flax's
    first LayerNorm takes its mean and variance of an f32 input in f32
    even with f64 parameters; the port's runs in the model's dtype."""
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 16, size=(2, 12))
    args = [idx, idx] if with_targets else [idx]
    pick = (lambda r: r[1]) if with_targets else (lambda r: r[0])
    tm, _ = held(jvte.BlockFastGPT(vocab_size=16, n_embd=16, n_layer=1,
                                   rank=4),
                 lambda: tvte.BlockFastGPT(16, 16, 1, 4, device=CPU,
                                           dtype=F64),
                 args, tol=1e-5, call=pick, out=pick)
    if not with_targets:
        assert tm(t(idx))[0].shape == (2, 1, 16)
    np.testing.assert_array_equal(
        tm.wte.numpy(), np.asarray(__import__(
            "pyitd_tpu.ml.zoo", fromlist=["fixed_embedding"])
            .fixed_embedding(16, 16, 123)).astype(np.float64))


def test_blockfast_gpt_trains():
    """``tests/test_vte.py:113-147`` on the port: 25 Adam(3e-3) steps
    lower the loss, f32."""
    rng = np.random.default_rng(7)
    m = tvte.BlockFastGPT(16, 16, 1, 4, device=CPU,
                          generator=torch.Generator().manual_seed(2))
    idx = torch.from_numpy(rng.integers(0, 16, size=(2, 12)))
    logits, l0 = m(idx, idx)
    assert logits.shape == (2, 12, 16) and torch.isfinite(l0)
    opt = torch.optim.Adam(m.parameters(), 3e-3)
    for _ in range(25):
        opt.zero_grad()
        m(idx, idx)[1].backward()
        opt.step()
    assert float(m(idx, idx)[1]) < float(l0)


def test_vte_conditioning_tool():
    """``tools/vte_conditioning.py`` at a small batch: one JSON line, the
    unperturbed f32 gradient's gap and a perturbed one's, both finite."""
    from pyitd_tpu_torch.tools import vte_conditioning

    out = vte_conditioning.main(["--device", "cpu", "--perturb", "1",
                                 "--batch", "2"])
    assert [r["perturbed"] for r in out["f32"]] == [False, True]
    assert all(0 < r["grad_gap"] < 1 and r["loss_rel"] < 1e-5
               for r in out["f32"])
