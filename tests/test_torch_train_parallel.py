"""The port's training parallelism (``pyitd_tpu_torch/parallel/train.py``,
``parallel/pipeline.py``) and checkpoints on a mesh, against the JAX
package's on the CPU, case by case after ``tests/test_train_parallel.py``,
``tests/test_pipeline.py`` and ``tests/test_checkpoint.py``.

In this process a one-rank gloo group (``one_rank_group("cpu")``) carries
the ``DeviceMesh``es; JAX runs on the 8 virtual CPU devices of the suite's
conftest.  Every rule lands on the parameter and dim JAX's rule lands on
(kernel dims transposed).  In f64: the port's sharded step and the plain
torch loop agree bitwise on one rank, and against JAX's sharded step to
1e-10; the expert-parallel MoE, forward and gradients, likewise; the
pipeline at pp = 1 against the sequential fold, and the port's fold
against JAX's ``gpipe_apply`` at pp = 4 to 1e-10; bf16 compute keeps f32
master weights and tracks f32 within JAX's bars (rtol 0.1, atol 5e-3);
a checkpoint round trip keeps values and placements, and a resume is
bitwise the run without it.

Multi-rank: worlds of 2 and 4 gloo processes (``FileStore``, one
``subprocess`` each, 120 s limit on each ``communicate``, the children
killed when it expires) run the tensor-parallel ``make_train_step`` at
data x model = 1x2 and 2x2, the expert-parallel MoE, ``gpipe_apply`` at
pp = 2 and 4 (and data 2 x pp 2), gradients included, and (world 4) the
checkpoint on a 2x2 mesh; each rank holds its result against the
single-process run to 1e-10 in f64 and writes the gaps.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P
from torch.distributed.checkpoint.state_dict import (
    get_optimizer_state_dict, set_optimizer_state_dict)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.func import functional_call

from pyitd_tpu.ml import moe as jmoe
from pyitd_tpu.ml import parseval as jpar
from pyitd_tpu.parallel import pipeline as jpipe
from pyitd_tpu.parallel import train as jtrain
from pyitd_tpu_torch.ml import moe as tmoe
from pyitd_tpu_torch.ml import parseval as tpar
from pyitd_tpu_torch.ml.checkpoint import restore_state, save_state
from pyitd_tpu_torch.parallel import pipeline as tpipe
from pyitd_tpu_torch.parallel import train as ttrain
from test_torch_ml_foundation import carried, init_flax, t

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(block_size=16, vocab_size=32, n_layer=1, n_embd=32,
            wavelet_levels=2, near_window=4, ancilla_dim=8, n_anchor=8)


@pytest.fixture(scope="module")
def group():
    with ttrain.one_rank_group("cpu"):
        yield


def tiny_batch():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 32, size=(4, 16)),
            rng.integers(0, 32, size=(4, 16)))


def full(p):
    return (p.full_tensor() if isinstance(p, DTensor) else p).detach()


# ---- mesh and rules -----------------------------------------------------

def test_make_tp_mesh(group):
    mesh = ttrain.make_tp_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="not divisible"):
        ttrain.make_tp_mesh(model=3, device_type="cpu")
    with pytest.raises(ValueError, match="n_devices"):
        ttrain.make_tp_mesh(8, device_type="cpu")


def _torch_name(path: str) -> str:
    """A flax parameter path (``params/block_0/mlp/Dense_0/kernel``) as
    the port's dotted name."""
    parts = path.split("/")[1:]
    if parts[-1] in ("kernel", "embedding", "scale"):
        parts[-1] = "weight"
    return ".".join(parts)


def _jax_dims(params, rules):
    """Every parameter JAX's rules place on "model", and the dim, in the
    port's names and layout (a 2-D kernel's dims transposed)."""
    out = {}
    specs = jtrain.param_specs(params, rules)
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda s: isinstance(s, P))[0]:
        if "model" not in tuple(spec):
            continue
        name = "/".join(str(k.key) for k in path)
        dim = tuple(spec).index("model")
        if name.endswith("kernel"):
            dim = 1 - dim
        out[_torch_name(name)] = dim
    return out


@pytest.mark.parametrize("which", ["parseval", "moe"])
def test_rules_land_like_jax(which):
    """``param_specs`` of the port puts ``Shard(d)`` exactly on the
    parameters, and the dims, that JAX's ``param_specs`` puts "model" on;
    ``w_q`` and every other parameter replicated."""
    if which == "parseval":
        jm, rules = jpar.ParsevalGPT(jpar.GPTConfig(**TINY)), \
            jtrain.PARSEVAL_TP_RULES
        args = tiny_batch()
        tm = tpar.ParsevalGPT(tpar.GPTConfig(**TINY), device=CPU)
        trules = ttrain.PARSEVAL_TP_RULES
    else:
        jm, rules = jmoe.ModCRTMoE(8, dispatch="capacity"), \
            jtrain.MOE_EP_RULES
        args = (np.zeros((4, 16)),)
        tm = tmoe.ModCRTMoE(16, 8, dispatch="capacity", device=CPU)
        trules = ttrain.MOE_EP_RULES
    want = _jax_dims(init_flax(jm, *args), rules)
    got = {n: s.dim for n, s in ttrain.param_specs(tm, trules).items()
           if isinstance(s, Shard)}
    assert got == want and len(got) == (6 if which == "parseval" else 3)
    names = dict(tm.named_parameters())
    assert set(got) <= set(names)
    if which == "parseval":
        assert isinstance(ttrain.param_specs(tm, trules)[
            "block_0.attn.w_q"], Replicate)


def test_shard_params_one_rank(group):
    """On a 1x1 mesh: the matched weights are DTensors with the rule's
    placement, the rest plain; the forward equals the unsharded model's
    bitwise; ``param_groups`` parts the two kinds."""
    mesh = ttrain.make_tp_mesh(device_type="cpu")
    x, y = map(torch.from_numpy, tiny_batch())
    kw = dict(device=CPU, dtype=F64)
    ref = tpar.ParsevalGPT(tpar.GPTConfig(**TINY), **kw)
    m = tpar.ParsevalGPT(tpar.GPTConfig(**TINY), **kw)
    ttrain.shard_params(m, mesh, ttrain.PARSEVAL_TP_RULES)
    specs = ttrain.param_specs(m, ttrain.PARSEVAL_TP_RULES)
    for name, p in m.named_parameters():
        if isinstance(specs[name], Shard):
            assert isinstance(p, DTensor) and p.placements == (specs[name],)
        elif not name.endswith(("mlp.Dense_0.bias", "mlp.Dense_1.bias")):
            assert not isinstance(p, DTensor), name
    groups = ttrain.param_groups(m)
    assert [all(isinstance(p, DTensor) for p in g["params"])
            for g in groups] == [True, False]
    assert torch.equal(m(x, y)[1], ref(x, y)[1])


# ---- make_train_step ------------------------------------------------------

def _jax_sharded_sgd(steps=3):
    """JAX's tensor-parallel SGD run (dp 2 x tp 4), f64: params and
    losses."""
    jm = jpar.ParsevalGPT(jpar.GPTConfig(**TINY))
    xb, yb = tiny_batch()
    params = init_flax(jm, xb, yb)
    tx = optax.sgd(0.05)
    mesh = jtrain.make_tp_mesh(8, model=4)
    specs = jtrain.param_specs(params, jtrain.PARSEVAL_TP_RULES)
    p = jtrain.shard_params(params, mesh, jtrain.PARSEVAL_TP_RULES)
    s = jax.jit(tx.init)(p)
    step = jtrain.make_train_step(
        lambda q, b: jm.apply(q, b[0], b[1])[1], tx, mesh, specs)
    batch = jtrain.shard_batch((jnp.asarray(xb), jnp.asarray(yb)), mesh)
    losses = []
    for _ in range(steps):
        p, s, loss = step(p, s, batch)
        losses.append(float(loss))
    return params, jax.tree.map(np.asarray, p), losses


def test_tp_train_step_matches_plain_and_jax(group):
    """Three SGD(0.05) steps of the tiny ParsevalGPT (f64) through
    ``make_train_step`` on a 1x1 mesh: bitwise the plain torch loop, and
    losses and parameters to 1e-10 against JAX's sharded step; the layout
    survives the steps."""
    params0, jparams, jlosses = _jax_sharded_sgd()
    mk = lambda: carried(lambda: tpar.ParsevalGPT(  # noqa: E731
        tpar.GPTConfig(**TINY), device=CPU, dtype=F64), params0)
    x, y = map(torch.from_numpy, tiny_batch())
    ref, m = mk(), mk()
    opt_ref = torch.optim.SGD(ref.parameters(), 0.05)
    ref_losses = []
    for _ in range(3):
        opt_ref.zero_grad()
        loss = ref(x, y)[1]
        loss.backward()
        opt_ref.step()
        ref_losses.append(loss.item())
    mesh = ttrain.make_tp_mesh(device_type="cpu")
    ttrain.shard_params(m, mesh, ttrain.PARSEVAL_TP_RULES)
    opt = torch.optim.SGD(ttrain.param_groups(m), 0.05)
    step = ttrain.make_train_step(
        lambda p, b: functional_call(m, p, b)[1], opt, mesh, m)
    losses = [step(ttrain.shard_batch((x, y), mesh)).item()
              for _ in range(3)]
    assert losses == ref_losses
    for (name, p), q in zip(m.named_parameters(), ref.parameters()):
        assert torch.equal(full(p), q.detach()), name
    assert m.block_0.mlp.Dense_0.weight.placements == (Shard(0),)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-10, atol=0)
    want = carried(lambda: tpar.ParsevalGPT(tpar.GPTConfig(**TINY),
                                            device=CPU, dtype=F64), jparams)
    for (name, p), q in zip(m.named_parameters(), want.parameters()):
        np.testing.assert_allclose(full(p).numpy(), q.detach().numpy(),
                                   rtol=0, atol=1e-10, err_msg=name)


def test_moe_expert_parallel_one_rank_matches_jax(group):
    """``ModCRTMoE(capacity)`` with ``MOE_EP_RULES`` on a 1x1 mesh: the
    forward and gradients equal the unsharded module's bitwise and JAX's
    expert-parallel forward (dp 2 x ep 4) to 1e-12; the gather dispatch
    refuses the sharded banks."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 8, 16))
    jm = jmoe.ModCRTMoE(8, seed=3, dispatch="capacity", capacity=32)
    params = init_flax(jm, x, seed=2)
    jmesh = jtrain.make_tp_mesh(8, model=4)
    jy = np.asarray(jax.jit(jm.apply)(
        jtrain.shard_params(params, jmesh, jtrain.MOE_EP_RULES),
        jtrain.shard_batch(jnp.asarray(x), jmesh)))
    mk = lambda: carried(lambda: tmoe.ModCRTMoE(  # noqa: E731
        16, 8, seed=3, dispatch="capacity", capacity=32, device=CPU,
        dtype=F64), params)
    ref, m = mk(), mk()
    mesh = ttrain.make_tp_mesh(device_type="cpu")
    ttrain.shard_params(m, mesh, ttrain.MOE_EP_RULES)
    assert m.W1.placements == (Shard(0),)
    yr, y = ref(t(x)), m(t(x))
    assert torch.equal(y, yr)
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=0, atol=1e-12)
    (y ** 2).sum().backward()
    (yr ** 2).sum().backward()
    for (name, p), q in zip(m.named_parameters(), ref.parameters()):
        assert torch.equal(full(p.grad), q.grad), name
    m.dispatch = "gather"
    with pytest.raises(ValueError, match="capacity"):
        m(t(x))


def test_mixed_precision_step_keeps_master_weights(group):
    """``tests/test_train_parallel.py:116-154`` on the port: bf16 compute,
    5 Adam(1e-2) steps of the expert-parallel MoE; the master weights and
    the optimizer state stay f32, the loss falls, and tracks the f32 run
    within rtol 0.1, atol 5e-3."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(8, 8, 16)).astype(np.float32))
    tgt = 0.5 * x

    def run(compute_dtype):
        m = tmoe.ModCRTMoE(16, 8, seed=3, dispatch="capacity", capacity=80,
                           device=CPU,
                           generator=torch.Generator().manual_seed(3))
        mesh = ttrain.make_tp_mesh(device_type="cpu")
        ttrain.shard_params(m, mesh, ttrain.MOE_EP_RULES)
        opt = torch.optim.Adam(ttrain.param_groups(m), 1e-2)
        cd = compute_dtype or torch.float32

        def loss_fn(p, b):
            out = functional_call(m, p, (b[0].to(cd),))
            return ((out.float() - b[1]) ** 2).mean()

        step = ttrain.make_train_step(loss_fn, opt, mesh, m,
                                      compute_dtype=compute_dtype)
        losses = [step((x, tgt)).item() for _ in range(5)]
        return m, opt, losses

    m, opt, l_bf = run(torch.bfloat16)
    _, _, l_f32 = run(None)
    for p in m.parameters():
        assert p.dtype == torch.float32
    for st in opt.state.values():
        assert st["exp_avg"].dtype == torch.float32
    assert l_bf[-1] < l_bf[0]
    np.testing.assert_allclose(l_bf, l_f32, rtol=0.1, atol=5e-3)


# ---- the pipeline ---------------------------------------------------------

PP, M, D = 4, 6, 16


def _stages(seed):
    """PP BiMLP stages built in flax (JAX's test, ``_stages``), the JAX
    stack and the port's carried per-stage parameter dicts (f64)."""
    block = jmoe.BiMLP()
    keys = jax.random.split(jax.random.PRNGKey(seed), PP)
    jparams = [jax.tree.map(lambda a: np.asarray(a, np.float64),
                            jax.jit(block.init)(k, jnp.zeros((2, D))))
               for k in keys]
    mods = [carried(lambda: tmoe.BiMLP(D, device=CPU, dtype=F64), p)
            for p in jparams]
    tparams = [{n: p.detach() for n, p in mod.named_parameters()}
               for mod in mods]
    return block, jparams, mods[0], tparams


def _fold(mod, stacked, x, stages):
    out = x
    for i in range(stages):
        out = functional_call(mod, {n: a[i] for n, a in stacked.items()},
                              (out,))
    return out


def _pp_mesh(shape, names):
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def test_sequential_fold_matches_jax_pipeline():
    """The port's fold of the carried stages against JAX's pipelined
    apply at pp = 4 on a (data 2, pp 4) mesh, f64, to 1e-10."""
    block, jparams, mod, tparams = _stages(0)
    x = np.random.default_rng(1).normal(size=(M, 4, D))
    devs = np.asarray(jax.devices()[:8]).reshape(2, PP)
    f = jpipe.gpipe_apply(lambda p, h: block.apply(p, h),
                          Mesh(devs, ("data", "pp")), M)
    jy = np.asarray(f(jpipe.stack_stage_params(jparams), jnp.asarray(x)))
    y = _fold(mod, tpipe.stack_stage_params(tparams), t(x), PP)
    np.testing.assert_allclose(y.numpy(), jy, rtol=0, atol=1e-10)


@pytest.mark.parametrize("names", [("pp",), ("data", "pp")])
def test_pipeline_pp1_forward_and_grads(group, names):
    """pp = 1 (one stage, no hops, params (1, ...)), on a pp-only and a
    (data, pp) mesh, DTensor and plain stacks: the output is the first
    block's, gradients to 1e-12 of the block's own."""
    _, _, mod, tparams = _stages(2)
    mesh = _pp_mesh((1,) * len(names), names)
    x = t(np.random.default_rng(3).normal(size=(M, 2, D)))
    tgt = t(np.random.default_rng(6).normal(size=(M, 2, D)))
    f = tpipe.gpipe_apply(lambda p, h: functional_call(mod, p, (h,)), mesh,
                          M)
    one = [tparams[0]]
    want_p = {n: a.clone().requires_grad_() for n, a in
              tpipe.stack_stage_params(one).items()}
    want = _fold(mod, want_p, x, 1)
    ((want - tgt) ** 2).mean().backward()
    for stacked in (tpipe.stack_stage_params(one),
                    tpipe.stack_stage_params(one, mesh)):
        leaves = {n: a.requires_grad_() for n, a in stacked.items()}
        y = f(leaves, x)
        torch.testing.assert_close(y, want.detach(), rtol=0, atol=1e-12)
        ((y - tgt) ** 2).mean().backward()
        for n, a in leaves.items():
            torch.testing.assert_close(full(a.grad), want_p[n].grad,
                                       rtol=0, atol=1e-12)


def test_pipeline_pp1_train_step_learns(group):
    """Ten Adam(1e-2) steps through the pp = 1 pipeline lower the loss
    below 0.8 of its start (JAX's bar at pp = 4)."""
    _, _, mod, tparams = _stages(7)
    mesh = _pp_mesh((1,), ("pp",))
    x = t(np.random.default_rng(8).normal(size=(M, 2, D)))
    f = tpipe.gpipe_apply(lambda p, h: functional_call(mod, p, (h,)), mesh,
                          M)
    leaves = {n: a.requires_grad_() for n, a in
              tpipe.stack_stage_params(tparams[:1], mesh).items()}
    opt = torch.optim.Adam(list(leaves.values()), 1e-2)
    losses = []
    for _ in range(10):
        opt.zero_grad()
        loss = ((f(leaves, x) - 0.5 * x) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < 0.8 * losses[0]


def test_pipeline_pp1_mixed_precision(group):
    """bf16 compute: the output is bf16 within rtol 0.1, atol 0.05 of the
    f32 pipeline; the gradients f32 and finite."""
    _, _, mod, tparams = _stages(2)
    mod = mod.float()
    mesh = _pp_mesh((1,), ("pp",))
    x = t(np.random.default_rng(3).normal(size=(M, 4, D)), torch.float32)
    stacked = {n: a.float().requires_grad_() for n, a in
               tpipe.stack_stage_params(tparams[:1]).items()}
    blk = lambda p, h: functional_call(mod, p, (h,))  # noqa: E731
    y32 = tpipe.gpipe_apply(blk, mesh, M)(stacked, x)
    ybf = tpipe.gpipe_apply(blk, mesh, M, compute_dtype=torch.bfloat16)(
        stacked, x)
    assert ybf.dtype == torch.bfloat16
    np.testing.assert_allclose(ybf.float().detach().numpy(),
                               y32.detach().numpy(), rtol=0.1, atol=0.05)
    (ybf.float() ** 2).mean().backward()
    for a in stacked.values():
        assert a.grad.dtype == torch.float32
        assert torch.isfinite(a.grad).all()
    with pytest.raises(TypeError, match="preserve"):
        tpipe.gpipe_apply(lambda p, h: h[:, :1], mesh, M)(stacked, x)


# ---- checkpoints on a mesh ------------------------------------------------

def _moe_run(mesh, steps, params=None):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 8, 16)).astype(np.float32))
    m = tmoe.ModCRTMoE(16, 8, seed=3, dispatch="capacity", capacity=64,
                       device=CPU, generator=torch.Generator().manual_seed(0))
    ttrain.shard_params(m, mesh, ttrain.MOE_EP_RULES)
    opt = torch.optim.Adam(ttrain.param_groups(m), 1e-2)
    step = ttrain.make_train_step(
        lambda p, b: ((functional_call(m, p, (b[0],)) - b[1]) ** 2).mean(),
        opt, mesh, m)
    batch = (x, 0.5 * x)
    return m, opt, lambda: [step(batch) for _ in range(steps)]


def _restore(path, m, opt, **extra):
    """A fresh sharded model and optimizer restored from ``path``: the
    optimizer's state dict from DCP's ``get_optimizer_state_dict``, whose
    fresh state is created with the parameters' placements (a fresh
    ``opt.state_dict()`` has none, and a restored plain tensor beside a
    DTensor parameter breaks the next step)."""
    back = restore_state(path, {"model": m.state_dict(),
                                "opt": get_optimizer_state_dict(m, opt),
                                **extra})
    m.load_state_dict(back["model"])
    set_optimizer_state_dict(m, opt, back["opt"])
    return back


def test_checkpoint_roundtrip_keeps_values_and_placements(group, tmp_path):
    mesh = ttrain.make_tp_mesh(device_type="cpu")
    m, opt, run = _moe_run(mesh, 2)
    run()
    state = {"model": m.state_dict(),
             "opt": get_optimizer_state_dict(m, opt), "step": 7}
    save_state(tmp_path / "ckpt", state)
    m2, opt2, _ = _moe_run(mesh, 0)
    back = _restore(tmp_path / "ckpt", m2, opt2, step=0)
    assert back["step"] == 7
    assert m2.W1.placements == (Shard(0),)
    for (name, p), q in zip(m.named_parameters(), m2.parameters()):
        assert torch.equal(full(p), full(q)), name
    flat = lambda o: [v for s in o.state_dict()["state"].values()  # noqa
                      for v in s.values()]
    for a, b in zip(flat(opt), flat(opt2)):
        assert torch.equal(full(a), full(b))


def test_resume_matches_uninterrupted(group, tmp_path):
    """Two steps, a checkpoint, three more; against a fresh sharded model
    and optimizer restored from it and run three steps: the last loss and
    every parameter bitwise."""
    mesh = ttrain.make_tp_mesh(device_type="cpu")
    m, opt, run2 = _moe_run(mesh, 2)
    run2()
    save_state(tmp_path / "mid", {"model": m.state_dict(),
                                  "opt": get_optimizer_state_dict(m, opt)})
    step3 = _bind(m, opt, mesh)
    loss_a = [step3() for _ in range(3)][-1]
    m2, opt2, _ = _moe_run(mesh, 0)
    _restore(tmp_path / "mid", m2, opt2)
    step3b = _bind(m2, opt2, mesh)
    loss_b = [step3b() for _ in range(3)][-1]
    assert torch.equal(loss_a, loss_b)
    for (name, p), q in zip(m.named_parameters(), m2.parameters()):
        assert torch.equal(full(p), full(q)), name


def _bind(m, opt, mesh):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 8, 16)).astype(np.float32))
    step = ttrain.make_train_step(
        lambda p, b: ((functional_call(m, p, (b[0],)) - b[1]) ** 2).mean(),
        opt, mesh, m)
    return lambda: step((x, 0.5 * x))


# ---- several ranks: gloo worlds in subprocesses ---------------------------

_WORLD = r'''
import os, sys, numpy as np, torch, torch.distributed as dist
from torch.func import functional_call
from torch.distributed.tensor import DTensor, Shard
torch.set_num_threads(1)
store, rank, world, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from pyitd_tpu_torch.ml import moe as tmoe, parseval as tpar
from pyitd_tpu_torch.ml.checkpoint import restore_state, save_state
from pyitd_tpu_torch.parallel import pipeline as tpipe, train as ttrain
from torch.distributed.device_mesh import init_device_mesh
F64 = torch.float64
res = {}


def full(p):
    return (p.full_tensor() if isinstance(p, DTensor) else p).detach()


def gap(a, b):
    return float((full(a).double() - full(b).double()).abs().max())


# tensor parallel: data x model = world/2 x 2, tiny ParsevalGPT, 3 SGD steps
cfg = tpar.GPTConfig(block_size=16, vocab_size=32, n_layer=1, n_embd=32,
                     wavelet_levels=2, near_window=4, ancilla_dim=8,
                     n_anchor=8)
rng = np.random.default_rng(0)
x = torch.from_numpy(rng.integers(0, 32, size=(4, 16)))
y = torch.from_numpy(rng.integers(0, 32, size=(4, 16)))
mk = lambda: tpar.ParsevalGPT(cfg, device="cpu", dtype=F64,
                              generator=torch.Generator().manual_seed(0))
ref, m = mk(), mk()
o = torch.optim.SGD(ref.parameters(), 0.05)
ref_losses = []
for _ in range(3):
    o.zero_grad(); l = ref(x, y)[1]; l.backward(); o.step()
    ref_losses.append(l.item())
mesh = ttrain.make_tp_mesh(model=2, device_type="cpu")
ttrain.shard_params(m, mesh, ttrain.PARSEVAL_TP_RULES)
opt = torch.optim.SGD(ttrain.param_groups(m), 0.05)
step = ttrain.make_train_step(lambda p, b: functional_call(m, p, b)[1], opt,
                              mesh, m)
losses = [step(ttrain.shard_batch((x, y), mesh)).item() for _ in range(3)]
res["tp_loss_gap"] = max(abs(a - b) for a, b in zip(losses, ref_losses))
res["tp_param_gap"] = max(gap(p, q) for p, q in zip(m.parameters(),
                                                     ref.parameters()))
w = m.block_0.mlp.Dense_0.weight
res["tp_local_rows"] = w.to_local().shape[0]
res["tp_placement_ok"] = int(w.placements == (Shard(0),))

# expert parallel: ModCRTMoE(8 experts, capacity) on the same mesh
xm = torch.from_numpy(np.random.default_rng(5).normal(size=(4, 8, 16)))
mk = lambda: tmoe.ModCRTMoE(16, 8, seed=3, dispatch="capacity", capacity=32,
                            device="cpu", dtype=F64,
                            generator=torch.Generator().manual_seed(2))
ref, m = mk(), mk()
ttrain.shard_params(m, mesh, ttrain.MOE_EP_RULES)
res["ep_local_experts"] = m.W1.to_local().shape[0]
xs = ttrain.shard_batch(xm, mesh)
rows = xs.shape[0]
r0 = mesh.get_local_rank("data") * rows
yr = ref(xm)
ys = m(xs)
res["ep_fwd_gap"] = gap(ys, yr[r0:r0 + rows])
((ref(xm) - 0.5 * xm) ** 2).mean().backward()
opt = torch.optim.Adam(ttrain.param_groups(m), 1e-2)
step = ttrain.make_train_step(
    lambda p, b: ((functional_call(m, p, (b,)) - 0.5 * b) ** 2).mean(), opt,
    mesh, m)
step(xs)
# step 0's gradients (averaged over the data ranks) against the full batch
res["ep_grad_gap"] = max(gap(p.grad, q.grad) for p, q in zip(
    m.parameters(), ref.parameters()))
o = torch.optim.Adam(ref.parameters(), 1e-2)
o.step()
for _ in range(4):
    step(xs)
    o.zero_grad(); ((ref(xm) - 0.5 * xm) ** 2).mean().backward(); o.step()
res["ep_param_gap"] = max(gap(p, q) for p, q in zip(m.parameters(),
                                                     ref.parameters()))

# the pipeline: BiMLP stages, M = 6 microbatches, gradients of a loss
M, D = 6, 16
def fold(mod, stacked, xx, n):
    for i in range(n):
        xx = functional_call(mod, {k: a[i] for k, a in stacked.items()}, (xx,))
    return xx
for shape in ([(1, world)] + ([(2, 2)] if world == 4 else [])):
    pp = shape[1]
    mods = [tmoe.BiMLP(D, device="cpu", dtype=F64,
                       generator=torch.Generator().manual_seed(10 + i))
            for i in range(pp)]
    stages = [{k: p.detach() for k, p in mod.named_parameters()}
              for mod in mods]
    xp = torch.from_numpy(np.random.default_rng(5).normal(size=(M, 4, D)))
    tgt = torch.from_numpy(np.random.default_rng(6).normal(size=(M, 4, D)))
    want_p = {k: a.clone().requires_grad_()
              for k, a in tpipe.stack_stage_params(stages).items()}
    want = fold(mods[0], want_p, xp, pp)
    ((want - tgt) ** 2).mean().backward()
    pmesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "pp"))
    f = tpipe.gpipe_apply(lambda p, h: functional_call(mods[0], p, (h,)),
                          pmesh, M)
    tag = f"pp{shape[0]}x{pp}"
    for kind, stacked in (("dtensor", tpipe.stack_stage_params(stages,
                                                               pmesh)),
                          ("plain", tpipe.stack_stage_params(stages))):
        leaves = {k: a.requires_grad_() for k, a in stacked.items()}
        yp = f(leaves, xp)
        ((yp - tgt) ** 2).mean().backward()
        res[f"{tag}_{kind}_fwd_gap"] = gap(yp, want)
        res[f"{tag}_{kind}_grad_gap"] = max(
            gap(leaves[k].grad, want_p[k].grad) for k in leaves)
    bf = [{k: a.float() for k, a in st.items()} for st in stages]
    ybf = tpipe.gpipe_apply(
        lambda p, h: functional_call(mods[0], p, (h,)), pmesh, M,
        compute_dtype=torch.bfloat16)(tpipe.stack_stage_params(bf, pmesh),
                                      xp.float())
    bstack = {k: a.to(torch.bfloat16) for k, a in
              tpipe.stack_stage_params(bf).items()}
    wbf = torch.stack([fold(mods[0], bstack, xp[m].to(torch.bfloat16), pp)
                       for m in range(M)])
    res[f"{tag}_bf16_ok"] = int(ybf.dtype == torch.bfloat16)
    res[f"{tag}_bf16_gap"] = gap(ybf, wbf)

# checkpoint on the mesh (world 4: data 2 x model 2)
if world == 4:
    ck = sys.argv[5]
    xc = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 8, 16)).astype(np.float32))
    def build():
        mm = tmoe.ModCRTMoE(16, 8, seed=3, dispatch="capacity", capacity=64,
                            device="cpu",
                            generator=torch.Generator().manual_seed(0))
        ttrain.shard_params(mm, mesh, ttrain.MOE_EP_RULES)
        oo = torch.optim.Adam(ttrain.param_groups(mm), 1e-2)
        st = ttrain.make_train_step(
            lambda p, b: ((functional_call(mm, p, (b,)) - 0.5 * b) ** 2
                          ).mean(), oo, mesh, mm)
        return mm, oo, lambda: st(ttrain.shard_batch(xc, mesh))
    a, oa, sa = build()
    sa(); sa()
    from torch.distributed.checkpoint.state_dict import (
        get_optimizer_state_dict, set_optimizer_state_dict)
    save_state(ck, {"model": a.state_dict(),
                    "opt": get_optimizer_state_dict(a, oa)})
    la = [sa() for _ in range(3)][-1]
    b, ob, sb = build()
    back = restore_state(ck, {"model": b.state_dict(),
                              "opt": get_optimizer_state_dict(b, ob)})
    b.load_state_dict(back["model"])
    set_optimizer_state_dict(b, ob, back["opt"])
    res["ckpt_placement_ok"] = int(b.W1.placements == (Shard(0),))
    lb = [sb() for _ in range(3)][-1]
    res["ckpt_bitwise"] = int(torch.equal(la, lb) and all(
        torch.equal(p.to_local() if isinstance(p, DTensor) else p,
                    q.to_local() if isinstance(q, DTensor) else q)
        for p, q in zip(a.parameters(), b.parameters())))
np.savez(f"{out}/rank{rank}.npz", **res)
dist.destroy_process_group()
'''


def _run_world(world, tmp):
    script = os.path.join(tmp, "world.py")
    with open(script, "w") as fh:
        fh.write(_WORLD)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, script, os.path.join(tmp, "store"), str(r),
         str(world), tmp, os.path.join(tmp, "ckpt")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * world, outs
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
            for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {w: _run_world(w, str(tmp_path_factory.mktemp(f"world{w}")))
            for w in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
def test_multirank_tp_train_step(worlds, world):
    """data x model = 1x2 and 2x2: three sharded SGD steps against the
    single-process run, losses and parameters to 1e-10 (f64); each rank
    holds half of ``mlp.Dense_0``'s rows."""
    for r in worlds[world]:
        assert r["tp_loss_gap"] <= 1e-10 and r["tp_param_gap"] <= 1e-10, r
        assert int(r["tp_local_rows"]) == 64
        assert int(r["tp_placement_ok"]) == 1


@pytest.mark.parametrize("world", [2, 4])
def test_multirank_moe_expert_parallel(worlds, world):
    """Four experts per rank: the forward of each data rank's rows, step
    0's gradients and five Adam steps against the single process, 1e-10
    (f64)."""
    for r in worlds[world]:
        assert int(r["ep_local_experts"]) == 4
        for k in ("ep_fwd_gap", "ep_grad_gap", "ep_param_gap"):
            assert r[k] <= 1e-10, (k, r[k])


@pytest.mark.parametrize("world", [2, 4])
def test_multirank_pipeline(worlds, world):
    """pp = world (and data 2 x pp 2 at world 4), DTensor and plain
    stacks: output and gradients against the sequential fold, 1e-10 (f64)
    on every rank; bf16 compute bitwise the bf16 fold of each
    microbatch (at pp = 4 the bf16 fold itself is 0.84 from the f64 one,
    beyond JAX's f32 bar: the arithmetic, not the pipeline)."""
    shapes = ["pp1x%d" % world] + (["pp2x2"] if world == 4 else [])
    for r in worlds[world]:
        for tag in shapes:
            for kind in ("dtensor", "plain"):
                for what in ("fwd", "grad"):
                    v = r[f"{tag}_{kind}_{what}_gap"]
                    assert v <= 1e-10, (tag, kind, what, v)
            assert int(r[f"{tag}_bf16_ok"]) == 1
            assert r[f"{tag}_bf16_gap"] == 0


def test_multirank_checkpoint_resume(worlds):
    """World 4, data 2 x model 2, the expert-parallel MoE: the restored
    banks keep ``Shard(0)``, and the resumed run is bitwise the run
    without the restore on every rank."""
    for r in worlds[4]:
        assert int(r["ckpt_placement_ok"]) == 1
        assert int(r["ckpt_bitwise"]) == 1
