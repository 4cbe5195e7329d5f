"""The gradient over a ``DistGroup`` (``pyitd_tpu_torch/parallel/comm.py``):
``sharded_itd_sift`` on both routes and ``sharded_cubic_baseline``,
differentiated in gloo worlds of 2 and 4 processes, one time shard each.

Each rank computes the loss of its own slice and calls ``backward``; the
collectives' backward (the opposite halo shift, a sum over ranks of this
rank's slice of a gather, an all-reduce of a sum) makes each rank's
gradient that of the sum of the ranks' losses.  The joined gradient is
held against ``LocalGroup(S)``'s gradient of the same total loss, and
against ``jax.grad`` of JAX's ``sharded_itd_sift`` / ``sharded_cubic_
baseline`` on the 8-device CPU mesh the suite's conftest sets up:

* f64, plain route and cubic tier: ``LocalGroup(S)`` to 1e-12 of max|g|
  (the sums over ranks may associate otherwise), JAX to 1e-10;
* f32, the kernel route (its backward is autograd of the plain route on
  the plain versions): ``LocalGroup(S)``'s kernel route to 1e-6 of max|g|,
  the order of the f32 sums over ranks being the only difference.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyitd_tpu.parallel.sharded import make_mesh
from pyitd_tpu.parallel.sharded import sharded_cubic_baseline as jax_cubic
from pyitd_tpu.parallel.sharded import sharded_itd_sift as jax_sift
from pyitd_tpu_torch.parallel import (LocalGroup, sharded_cubic_baseline,
                                      sharded_itd_sift)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, LEVELS = 512, 4


def bank(batch=2, n=N):
    """The bank of tests/test_sharded.py."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, n)
    return np.stack([
        np.sin((10 + 3 * k) * t * (1 + 0.1 * t)) + 0.2 * t**2
        + 0.1 * rng.normal(size=n) for k in range(batch)])


_LOSSES = """
def sift_loss(rot, corr):
    return (rot ** 2).sum() + 0.7 * corr.sum()


def cubic_loss(rot, base):
    return (rot ** 2).sum() + torch.sin(base).sum()
"""
exec(_LOSSES)


_RANK_SCRIPT = """
import sys
import numpy as np, torch, torch.distributed as dist
from pyitd_tpu_torch.parallel import (DistGroup, sharded_cubic_baseline,
                                      sharded_itd_sift)
store_path, rank, size, levels, out = (sys.argv[1], int(sys.argv[2]),
                                       int(sys.argv[3]), int(sys.argv[4]),
                                       sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store_path, size),
                        rank=rank, world_size=size)
x = np.load(out + "/x.npy")
n_loc = x.shape[-1] // size
group = DistGroup()
res = {}
for name, dtype, backend in (("torch", torch.float64, "torch"),
                             ("kernel", torch.float32, "kernel")):
    mine = torch.from_numpy(x[:, rank * n_loc:(rank + 1) * n_loc]).to(dtype)
    mine.requires_grad_()
    rot, ncomp, _, corr = sharded_itd_sift(mine, group, levels,
                                           backend=backend)
    sift_loss(rot, corr).backward()
    res[name] = mine.grad.numpy()
mine = torch.from_numpy(x[:, rank * n_loc:(rank + 1) * n_loc])
mine.requires_grad_()
rot, base, _ = sharded_cubic_baseline(mine, group, min_extrema=0)
cubic_loss(rot, base).backward()
res["cubic"] = mine.grad.numpy()
np.savez(f"{out}/rank{rank}.npz", **res)
dist.destroy_process_group()
"""


def _run_world(tmp_path, x, size):
    np.save(tmp_path / "x.npy", x)
    script = tmp_path / "rank.py"
    script.write_text(_LOSSES + _RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp_path / "store"), str(r),
         str(size), str(LEVELS), str(tmp_path)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(size)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * size, outs
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(size)]
    return {k: np.concatenate([r[k] for r in ranks], axis=-1)
            for k in ("torch", "kernel", "cubic")}


def _local_grads(x, size):
    out = {}
    for name, dtype, backend in (("torch", torch.float64, "torch"),
                                 ("kernel", torch.float32, "kernel")):
        xt = torch.from_numpy(x).to(dtype).requires_grad_()
        rot, _, _, corr = sharded_itd_sift(xt, LocalGroup(size), LEVELS,
                                           backend=backend)
        sift_loss(rot, corr).backward()
        out[name] = xt.grad.numpy()
    xt = torch.from_numpy(x).requires_grad_()
    rot, base, _ = sharded_cubic_baseline(xt, LocalGroup(size),
                                          min_extrema=0)
    cubic_loss(rot, base).backward()
    out["cubic"] = xt.grad.numpy()
    return out


def _jax_grads(x, size):
    mesh = make_mesh(8, seq=size)

    def sift(a):
        rot, _, _, corr = jax_sift(a, mesh, LEVELS, backend="xla")
        return jnp.sum(jnp.square(rot)) + 0.7 * jnp.sum(corr)

    def cubic(a):
        rot, base, _ = jax_cubic(a, mesh, min_extrema=0)
        return jnp.sum(jnp.square(rot)) + jnp.sum(jnp.sin(base))

    xj = jnp.asarray(x)
    return {"torch": np.asarray(jax.grad(sift)(xj)),
            "cubic": np.asarray(jax.grad(cubic)(xj))}


@pytest.mark.parametrize("size", [2, 4])
def test_dist_group_gradient(tmp_path, size):
    """Rows of 512, 8 / size of them: JAX's (data, seq) mesh of 8 devices
    cuts the rows over its data axis."""
    x = bank(8 // size, N)
    got = _run_world(tmp_path, x, size)
    local = _local_grads(x, size)
    want = _jax_grads(x, size)
    for k in ("torch", "cubic"):
        g = got[k]
        scale = np.abs(local[k]).max()
        assert np.isfinite(g).all() and scale > 0
        np.testing.assert_allclose(g, local[k], rtol=0, atol=1e-12 * scale,
                                   err_msg=k)
        np.testing.assert_allclose(g, want[k], rtol=0, atol=1e-10,
                                   err_msg=k)
    scale = np.abs(local["kernel"]).max()
    np.testing.assert_allclose(got["kernel"], local["kernel"], rtol=0,
                               atol=1e-6 * scale)
