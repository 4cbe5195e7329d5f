"""The port's attention and GPT family (``pyitd_tpu_torch/ml/``: parseval,
newgpt, tape, ultramem), its checkpoints and the ``ml`` exports, against
the JAX package's on the CPU.

As in ``test_torch_ml_foundation.py``: each module built in flax from a
seed, carried across with ``load_flax_params`` in f64, forward to 1e-10,
gradients to 1e-10 of max|g|, at small widths (``GPTConfig(block_size=32,
n_embd=16, near_window=4, wavelet_levels=2, ancilla_dim=4,
n_anchor=4)``).  The cases where flax and torch differ by default: the
LayerNorm epsilon (1e-6, not torch's 1e-5); ``variance_scaled_softmax``
with masked entries (no NaN in the forward or the gradient); the wavelet
attention at ``t < block_size``; ParsevalGPT's last-position logits without
targets; flax's ``SelfAttention`` layout in ``ExplorerEngineerStage``;
``MLayer``'s exact ``expm`` (``torch.linalg.matrix_exp``, other Padé and
squaring choices: 1e-10 relative); a prefix then one token with
``past_kv`` against the whole sequence; ``jax.lax.top_k``'s tie order.
Five Adam steps of a small ParsevalGPT match ``optax.adam`` to 1e-9, and a
checkpoint resume is bitwise the run without it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pyitd_tpu import ml as jml
from pyitd_tpu.ml import newgpt as jnew
from pyitd_tpu.ml import parseval as jpar
from pyitd_tpu.ml import tape as jtape
from pyitd_tpu.ml import ultramem as jum
from pyitd_tpu_torch import ml as tml
from pyitd_tpu_torch.ml import _init
from pyitd_tpu_torch.ml import newgpt as tnew
from pyitd_tpu_torch.ml import parseval as tpar
from pyitd_tpu_torch.ml import tape as ttape
from pyitd_tpu_torch.ml import ultramem as tum
from pyitd_tpu_torch.ml.checkpoint import restore_state, save_state
from test_torch_ml_foundation import carried, check_init, held, init_flax, t

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
SMALL = dict(block_size=32, n_embd=16, near_window=4, wavelet_levels=2,
             ancilla_dim=4, n_anchor=4)


def jcfg(**kw):
    return jpar.GPTConfig(**{**SMALL, "vocab_size": 19, **kw})


def tcfg(**kw):
    return tpar.GPTConfig(**{**SMALL, "vocab_size": 19, **kw})


# ---- parseval -----------------------------------------------------------

def test_variance_scaled_softmax_masked_rows():
    """Masked (-inf) entries, a row with one valid entry and a fully masked
    row: the forward and the gradient equal JAX's, with no NaN where JAX
    has none."""
    rng = np.random.default_rng(0)
    s = rng.normal(size=(4, 9)) * 3
    s[0, 5:] = -np.inf
    s[1, 1:] = -np.inf
    s[2, ::2] = -np.inf
    w = rng.normal(size=s.shape)
    y = tpar.variance_scaled_softmax(t(s))
    jy = np.asarray(jpar.variance_scaled_softmax(jnp.asarray(s)))
    np.testing.assert_allclose(y.numpy(), jy, rtol=0, atol=1e-14)
    assert np.isfinite(y.numpy()).all()
    st = t(s).requires_grad_()
    (tpar.variance_scaled_softmax(st) * t(w)).sum().backward()
    jg = np.asarray(jax.grad(lambda a: jnp.sum(
        jpar.variance_scaled_softmax(a) * w))(jnp.asarray(s)))
    assert np.isfinite(jg).all()
    np.testing.assert_allclose(st.grad.numpy(), jg, rtol=0, atol=1e-13)
    full = s.copy()
    full[3] = -np.inf
    np.testing.assert_array_equal(
        tpar.variance_scaled_softmax(t(full))[3].numpy(), np.zeros(9))
    x = rng.normal(size=(3, 5)) * 50
    np.testing.assert_allclose(tpar.softcap(t(x)).numpy(),
                               np.asarray(jpar.softcap(jnp.asarray(x))),
                               rtol=1e-15)


def test_haar_basis_and_rope_tables():
    for tt, lv in [(32, 2), (12, 3), (5, 4), (1, 2)]:
        np.testing.assert_array_equal(tpar.build_haar_wavelet_basis(tt, lv),
                                      jpar.build_haar_wavelet_basis(tt, lv))
    x = np.random.default_rng(1).normal(size=(2, 7, 10))
    pos = np.arange(7)
    jr = jpar.ParsevalRotaryEmbedding(10, 16)(jnp.asarray(x),
                                              jnp.asarray(pos))
    tr = tpar.ParsevalRotaryEmbedding(10, 16, device=CPU, dtype=F64)(
        t(x), t(pos))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-15)


def test_layer_norm_epsilon_is_flax():
    """At a variance of about 1e-6 the epsilon decides the output: flax's
    1e-6, not torch's default 1e-5."""
    import flax.linen as fnn

    x = np.random.default_rng(2).normal(size=(3, 16)) * 1e-3
    jln = fnn.LayerNorm()
    params = init_flax(jln, x)
    want = np.asarray(jln.apply(params, jnp.asarray(x)))
    ln = carried(lambda: _init.layer_norm(16, CPU, F64), params)
    np.testing.assert_allclose(ln(t(x)).detach().numpy(), want, rtol=0,
                               atol=1e-12)
    torch_default = torch.nn.LayerNorm(16, dtype=F64)(t(x)).detach().numpy()
    assert np.abs(torch_default - want).max() > 0.1


@pytest.mark.parametrize("seq", [32, 13])
def test_single_head_wavelet_attention(seq):
    """t = block_size and t < block_size (the Haar basis cut to t rows)."""
    x = np.random.default_rng(3).normal(size=(2, seq, 16))
    held(jpar.SingleHeadWaveletAttention(jcfg()),
         lambda: tpar.SingleHeadWaveletAttention(tcfg(), device=CPU,
                                                 dtype=F64), [x])


def test_unitary_ancilla_attention_and_anchor():
    x = np.random.default_rng(4).normal(size=(2, 20, 16))
    held(jpar.UnitaryAncillaAttention(jcfg()),
         lambda: tpar.UnitaryAncillaAttention(tcfg(), device=CPU, dtype=F64),
         [x])
    held(jpar.AnchorModule(5), lambda: tpar.AnchorModule(
        16, 5, device=CPU, dtype=F64), [x])


@pytest.mark.parametrize("bias", [True, False])
def test_parseval_gpt(bias):
    """Logits and loss with targets (some -1), and the last position's
    logits without; gradients of the loss; dropout 0 in training mode."""
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 19, size=(2, 32))
    tgt = rng.integers(0, 19, size=(2, 32))
    tgt[1, :5] = -1
    jm = jpar.ParsevalGPT(jcfg(n_layer=2, bias=bias))
    mk = lambda: tpar.ParsevalGPT(tcfg(n_layer=2, bias=bias),  # noqa: E731
                                  device=CPU, dtype=F64)
    tm, params = held(jm, mk, [idx, tgt], call=lambda r: r[1],
                      out=lambda r: r[1])
    apply = jax.jit(jm.apply)
    jl, _ = apply(params, jnp.asarray(idx), jnp.asarray(tgt))
    tl, _ = tm(t(idx), t(tgt), deterministic=False)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=0,
                               atol=1e-10 * np.abs(jl).max())
    jlast, jnone = apply(params, jnp.asarray(idx))
    tlast, tnone = tm(t(idx))
    assert jnone is None and tnone is None and tlast.shape == (2, 1, 19)
    np.testing.assert_allclose(tlast.detach().numpy(), np.asarray(jlast),
                               rtol=0, atol=1e-10 * np.abs(jlast).max())
    if not bias:
        assert tm.block_0.LayerNorm_0.bias is None


def test_parseval_adam_matches_optax():
    """Five Adam steps of a small ParsevalGPT, torch.optim.Adam against
    optax.adam on the same data, parameters to 1e-9."""
    rng = np.random.default_rng(6)
    batches = [(rng.integers(0, 19, size=(2, 32)),
                rng.integers(0, 19, size=(2, 32))) for _ in range(5)]
    jm = jpar.ParsevalGPT(jcfg())
    params = init_flax(jm, *batches[0])
    tm = carried(lambda: tpar.ParsevalGPT(tcfg(), device=CPU, dtype=F64),
                 params)
    tx = optax.adam(3e-3)
    state = tx.init(params)

    @jax.jit
    def step(p, s, x, y):
        g = jax.grad(lambda q: jm.apply(q, x, y)[1])(p)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    opt = torch.optim.Adam(tm.parameters(), 3e-3)
    for x, y in batches:
        params, state = step(params, state, jnp.asarray(x), jnp.asarray(y))
        opt.zero_grad()
        tm(t(x), t(y))[1].backward()
        opt.step()
    want = carried(lambda: tpar.ParsevalGPT(tcfg(), device=CPU, dtype=F64),
                   jax.tree.map(np.asarray, params))
    ref = dict(want.named_parameters())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref[name].detach().numpy(), rtol=0,
                                   atol=1e-9, err_msg=name)


# ---- newgpt -------------------------------------------------------------

def test_newgpt_pieces():
    rng = np.random.default_rng(7)
    x4 = rng.normal(size=(2, 3, 5, 4))
    jw = jnew.WedgeTransform(3)
    params = init_flax(jw, x4)
    params["params"]["A"] = rng.normal(size=(3, 4, 4))
    tw = carried(lambda: tnew.WedgeTransform(3, 4, device=CPU, dtype=F64),
                 params)
    np.testing.assert_allclose(tw(t(x4)).detach().numpy(),
                               np.asarray(jw.apply(params, jnp.asarray(x4))),
                               atol=1e-12)
    s = rng.normal(size=(3, 7)) * 30
    np.testing.assert_allclose(tnew.convex_softmax(t(s)).numpy(),
                               np.asarray(jnew.convex_softmax(jnp.asarray(s))),
                               atol=1e-15)
    x = rng.normal(size=(2, 5, 12))
    held(jnew.AlpertQueryGenerator(3, 4), lambda: tnew.AlpertQueryGenerator(
        12, 3, 4, device=CPU, dtype=F64), [x])


@pytest.mark.parametrize("with_mask", [False, True])
def test_explorer_engineer_stage(with_mask):
    """flax's SelfAttention layout: q/k/v kernels (d, heads, d/heads) with
    biases, the output kernel (heads, d/heads, d), carried across."""
    x = np.random.default_rng(8).normal(size=(2, 6, 8))
    jm = jnew.ExplorerEngineerStage(2)
    mk = lambda: tnew.ExplorerEngineerStage(8, 2, device=CPU,  # noqa: E731
                                            dtype=F64)
    if not with_mask:
        tm, params = held(jm, mk, [x])
        assert params["params"]["engineer_attn"]["query"]["kernel"].shape == (
            8, 2, 4)
        return
    mask = np.ones((6, 6), bool)
    mask[:, 0] = False  # row 0 fully masked: the lowest logit everywhere
    params = init_flax(jm, x)
    tm = carried(mk, params)
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(mask)))
    np.testing.assert_allclose(tm(t(x), t(mask)).detach().numpy(), want,
                               rtol=0, atol=1e-10 * np.abs(want).max())


# ---- tape ---------------------------------------------------------------

def test_tape_pieces():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(31,)) * 4
    np.testing.assert_allclose(
        ttape.reference_activation(t(x)).numpy(),
        np.asarray(jtape.reference_activation(jnp.asarray(x))), atol=1e-15)
    for seq, dim in [(9, 8), (6, 7), (1, 3)]:
        np.testing.assert_array_equal(ttape.sinusoidal_embedding(seq, dim),
                                      jtape.sinusoidal_embedding(seq, dim))
    h = rng.normal(size=(2, 5, 8))
    for off in (0, 3):
        np.testing.assert_allclose(
            ttape.apply_rope(t(h), off).numpy(),
            np.asarray(jtape.apply_rope(jnp.asarray(h), off)), atol=1e-14)
    held(jtape.RectifiedKAN(), lambda: ttape.RectifiedKAN(
        8, device=CPU, dtype=F64), [h])


def test_cached_attention_and_past_kv():
    """The block on the whole sequence, and a prefix then one token with
    ``past_kv``: the last position agrees (attention is unmasked, so only
    the last position sees the same keys)."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 7, 8))
    jm = jtape.TapeHeadBlock(seq_len=12, num_heads=2)
    mk = lambda: ttape.TapeHeadBlock(8, 12, 2, device=CPU,  # noqa: E731
                                     dtype=F64)
    tm, params = held(jm, mk, [x], call=lambda r: r[0], out=lambda r: r[0])
    whole, (k, v) = tm(t(x))
    _, past = tm(t(x[:, :6]))
    last, (k2, v2) = tm(t(x[:, 6:]), past_kv=past, offset=6)
    np.testing.assert_allclose(last.detach().numpy(),
                               whole[:, 6:].detach().numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(k2.detach().numpy(), k.detach().numpy(),
                               atol=1e-12)
    jlast, (jk, _) = jm.apply(params, jnp.asarray(x[:, 6:]),
                              tuple(jnp.asarray(a.detach().numpy())
                                    for a in past), 6)
    np.testing.assert_allclose(last.detach().numpy(), np.asarray(jlast),
                               atol=1e-12)
    np.testing.assert_allclose(k2.detach().numpy(), np.asarray(jk),
                               atol=1e-12)


@pytest.mark.parametrize("approx", [False, True])
def test_mlayer(approx):
    """Exact: torch.linalg.matrix_exp against jax.scipy.linalg.expm to
    1e-10 relative; the approximation to 1e-12."""
    x = np.random.default_rng(11).normal(size=(3, 5))
    jm = jtape.MLayer(4, with_bias=True, use_approx=approx)
    params = init_flax(jm, x)
    tm = carried(lambda: ttape.MLayer(5, 4, with_bias=True, use_approx=approx,
                                      device=CPU, dtype=F64), params)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = tm(t(x)).detach().numpy()
    tol = 1e-12 if approx else 1e-10
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    if not approx:
        held(jm, lambda: ttape.MLayer(5, 4, with_bias=True, device=CPU,
                                      dtype=F64), [x])


def test_lie_mlayer():
    x = np.random.default_rng(12).normal(size=(2, 3, 5))
    held(jtape.LieMLayer(6, latent=4), lambda: ttape.LieMLayer(
        5, 6, latent=4, device=CPU, dtype=F64), [x])


# ---- ultramem -----------------------------------------------------------

def test_top_k_ties_lowest_index_first():
    """jax.lax.top_k gives ties lowest index first; the port's stable
    descending sort does too."""
    rows = np.array([[1., 3., 3., 2., 3., 0.],
                     [5., 5., 5., 5., 5., 5.],
                     [0., -1., 4., 4., -1., 4.]])
    for k in (1, 2, 3, 4):
        jv, ji = jax.lax.top_k(jnp.asarray(rows), k)
        tv, ti = tum.top_k(t(rows), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("tied", [False, True])
def test_ultramem_classifier(tied):
    """The classifier with an input projection and two blocks on one shared
    bank; ``tied`` repeats rows of the key banks, so the preselection meets
    exact ties."""
    cfg = dict(hidden_size=16, n_keys=12, key_dim=4, rb=8, rp=8, qr=8, qc=8,
               topk_rows=4, topk_cols=4, top_m=5, num_classes=6)
    x = np.random.default_rng(13).normal(size=(5, 10))
    jm = jum.UltraMemClassifier(jum.UltraMemCfg(**cfg), input_dim=10)
    mk = lambda: tum.UltraMemClassifier(  # noqa: E731
        tum.UltraMemCfg(**cfg), 10, device=CPU, dtype=F64)
    params = init_flax(jm, x)
    if tied:
        for bank in ("K_row", "K_col"):
            b = params["params"]["shared"][bank]
            b[:, 1::2] = b[:, 0::2]
    jargs = [jnp.asarray(x)]
    tm = carried(mk, params)
    want = np.asarray(jax.jit(jm.apply)(params, *jargs))
    np.testing.assert_allclose(tm(t(x)).detach().numpy(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
    w = np.random.default_rng(14).normal(size=want.shape)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(p, *jargs) * w)))(
        params)
    (tm(t(x)) * t(w)).sum().backward()
    ref = dict(carried(mk, jax.tree.map(np.asarray, jg)).named_parameters())
    gmax = max(float(p.detach().abs().max()) for p in ref.values())
    for name, p in tm.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), ref[name].detach().numpy(),
                                   rtol=0, atol=1e-10 * gmax, err_msg=name)


# ---- initialization -----------------------------------------------------

def test_init_statistics_gpt():
    """ParsevalGPT at its published width (Embed, LayerNorm, lecun Dense,
    xavier w_q, orthogonal ancilla, the anchors), the tape block, LieMLayer
    (orthogonal frame), MLayer and UltraMem's custom inits, against
    flax's within sampling error."""
    kw = dict(device=CPU)
    idx = np.zeros((1, 8), np.int64)
    check_init([
        (jpar.ParsevalGPT(jpar.GPTConfig()), [idx],
         lambda g: tpar.ParsevalGPT(tpar.GPTConfig(), generator=g, **kw)),
        (jtape.TapeHeadBlock(seq_len=8, num_heads=2), [np.ones((1, 4, 64))],
         lambda g: ttape.TapeHeadBlock(64, 8, 2, generator=g, **kw)),
        (jtape.LieMLayer(64, latent=16), [np.ones((1, 64))],
         lambda g: ttape.LieMLayer(64, 64, latent=16, generator=g, **kw)),
        (jtape.MLayer(16, with_bias=True), [np.ones((1, 8))],
         lambda g: ttape.MLayer(8, 16, with_bias=True, generator=g, **kw)),
        (jum.UltraMemClassifier(jum.UltraMemCfg(n_blocks=1)),
         [np.ones((1, 64))],
         lambda g: tum.UltraMemClassifier(tum.UltraMemCfg(n_blocks=1),
                                          generator=g, **kw)),
    ])
    gpt = tpar.ParsevalGPT(tpar.GPTConfig(), device=CPU)
    anc = gpt.block_0.attn.ancilla[0].double()
    torch.testing.assert_close(anc @ anc.T, torch.eye(16, dtype=F64),
                               atol=1e-6, rtol=0)


# ---- checkpoints, exports -----------------------------------------------

@pytest.mark.parametrize("make", ["adam", "wolf"])
def test_checkpoint_resume_bitwise(tmp_path, make):
    """Six steps, against three steps, save, a second save over the first,
    restore into a fresh model and optimizer, three steps: parameters and
    optimizer state bitwise the same."""
    g = torch.Generator().manual_seed(3)
    batches = [(torch.randint(0, 19, (2, 32), generator=g),
                torch.randint(0, 19, (2, 32), generator=g))
               for _ in range(6)]

    def fresh():
        m = tpar.ParsevalGPT(tcfg(), device=CPU,
                             generator=torch.Generator().manual_seed(1))
        o = (torch.optim.Adam(m.parameters(), 3e-3) if make == "adam" else
             tml.wolf(m.parameters(), 1e-2,
                      generator=torch.Generator().manual_seed(4)))
        return m, o

    def run(m, o, bs):
        for x, y in bs:
            o.zero_grad()
            m(x, y)[1].backward()
            o.step()

    a, oa = fresh()
    run(a, oa, batches)
    b, ob = fresh()
    run(b, ob, batches[:3])
    path = tmp_path / "ckpt"
    save_state(path, {"model": a.state_dict(), "step": 0})
    save_state(path, {"model": b.state_dict(), "opt": ob.state_dict(),
                      "step": torch.tensor(3)})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt"]
    c, oc = fresh()
    out = restore_state(path, {"model": c.state_dict(),
                               "opt": oc.state_dict(),
                               "step": torch.tensor(0)})
    c.load_state_dict(out["model"])
    oc.load_state_dict(out["opt"])
    assert int(out["step"]) == 3
    run(c, oc, batches[3:])
    for (name, p), q in zip(a.named_parameters(), c.parameters()):
        assert torch.equal(p, q), name
    flat_a = torch.utils._pytree.tree_leaves(oa.state_dict())
    flat_c = torch.utils._pytree.tree_leaves(oc.state_dict())
    assert len(flat_a) == len(flat_c)
    for x, y in zip(flat_a, flat_c):
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)


def test_ml_exports():
    """Every name the JAX package's ``ml`` exports, the MoE, VTE and
    BlockFast families included."""
    want = set(jml.__all__)
    assert want <= set(tml.__all__)
    for name in want:
        assert getattr(tml, name).__name__ == getattr(jml, name).__name__
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tml.ParsevalGPT(tml.GPTConfig())
