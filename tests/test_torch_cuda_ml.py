"""Card tests of the last of ``ml/`` and the training parallelism: marked
``cuda``, they skip where ``torch.cuda.is_available()`` is false.  On the
card (``python -m pytest --noconftest tests/test_torch_cuda_ml.py``):
``blockfast_step`` against the same steps on the CPU (1e-5 of max|y|,
f32); ``router_topk``'s backward under ``use_deterministic_algorithms``
(no scatter) against the CPU's; through a one-rank NCCL mesh,
``make_train_step`` bitwise the plain Adam loop, the expert-parallel
``ModCRTMoE`` bitwise the unsharded module, and ``gpipe_apply`` at pp = 1
bitwise the block.
"""
import copy

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.func import functional_call

from pyitd_tpu_torch.ml import (BiMLP, BlockFastLM, GPTConfig, ModCRTMoE,
                                ParsevalGPT, router_topk)
from pyitd_tpu_torch.parallel import (MOE_EP_RULES, PARSEVAL_TP_RULES,
                                      gpipe_apply, make_tp_mesh,
                                      make_train_step, one_rank_group,
                                      param_groups, shard_batch,
                                      shard_params, stack_stage_params)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def test_blockfast_step_card_matches_cpu(device):
    cpu = BlockFastLM(32, 16, 2, 4, device="cpu",
                      generator=torch.Generator().manual_seed(1))
    card = copy.deepcopy(cpu).to(device)
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, 32, (4, 40)))
    outs = []
    for m, dev in ((cpu, "cpu"), (card, device)):
        with torch.no_grad():
            st, hs = m.init_state(4), []
            for k in range(idx.shape[1]):
                st, h, _ = m.step(st, idx[:, k].to(dev))
                hs.append(h.cpu())
        outs.append(torch.stack(hs, 1))
    scale = float(outs[0].abs().max())
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-5 * scale)


def test_router_topk_deterministic_backward(device):
    z = torch.from_numpy(np.random.default_rng(1).normal(size=(64, 12)))
    w = torch.from_numpy(np.random.default_rng(2).normal(size=(64, 3)))
    grads = []
    torch.use_deterministic_algorithms(True)
    try:
        for dev in ("cpu", device):
            zz = z.to(dev).detach().requires_grad_()
            (router_topk(zz, 3, 0.5)[1] * w.to(dev)).sum().backward()
            grads.append(zz.grad.cpu())
    finally:
        torch.use_deterministic_algorithms(False)
    torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=1e-12)


def test_mesh_step_moe_and_pipeline_on_nccl(device):
    cfg = GPTConfig(block_size=32, vocab_size=64, n_embd=16, near_window=4,
                    wavelet_levels=2, ancilla_dim=4, n_anchor=4)
    rng = np.random.default_rng(3)
    batches = [tuple(torch.from_numpy(rng.integers(0, 64, (4, 32))).to(
        device) for _ in range(2)) for _ in range(3)]
    mk = lambda: ParsevalGPT(cfg, device=device,  # noqa: E731
                             generator=torch.Generator().manual_seed(0))
    ref = mk()
    opt = torch.optim.Adam(ref.parameters(), 3e-3)
    for x, y in batches:
        opt.zero_grad()
        ref(x, y)[1].backward()
        opt.step()
    with one_rank_group("cuda"):
        mesh = make_tp_mesh(device_type="cuda")
        m = mk()
        shard_params(m, mesh, PARSEVAL_TP_RULES)
        step = make_train_step(
            lambda p, b: functional_call(m, p, b)[1],
            torch.optim.Adam(param_groups(m), 3e-3), mesh, m)
        for b in batches:
            step(shard_batch(b, mesh))
        for p, q in zip(m.parameters(), ref.parameters()):
            full = p.full_tensor() if hasattr(p, "full_tensor") else p
            assert torch.equal(full, q)

        x = torch.from_numpy(rng.normal(size=(4, 64, 16)).astype(
            np.float32)).to(device)
        plain = ModCRTMoE(16, 8, dispatch="capacity", device=device)
        ep = copy.deepcopy(plain)
        shard_params(ep, mesh, MOE_EP_RULES)
        assert torch.equal(ep(x), plain(x))

        stage = BiMLP(16, device=device)
        pmesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pp",))
        f = gpipe_apply(lambda p, h: functional_call(stage, p, (h,)), pmesh,
                        4)
        stacked = stack_stage_params(
            [{n: p.detach() for n, p in stage.named_parameters()}], pmesh)
        y = f(stacked, x)
        assert torch.equal(y, torch.stack([stage(x[i]) for i in range(4)]))
