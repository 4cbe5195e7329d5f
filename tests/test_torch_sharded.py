"""The port's sequence-parallel sift against the JAX package's and against
the port's own unsharded sift.

* the plain sharded route (``backend="torch"``), f64, over ``LocalGroup(4)``
  and ``(8)`` against JAX's ``sharded_itd_sift(backend="xla")`` on its
  virtual CPU mesh: rotations and correction to 1e-12, counts and reasons
  equal; the NaN, any-length and any-batch cases likewise;
* the kernel route on the CPU (the shard-aware wrappers' plain versions),
  f32, bit for bit against the port's unsharded ``itd_sift(backend=
  "kernel")`` on every shape of ``chip_smoke.sharded_cases`` at 2, 4 and 8
  shards, and on one small shape against JAX's ``backend="pallas"`` in
  interpret mode to ``1e-5 * max|x|`` (XLA on the CPU fuses ``a*b+c`` in
  f32, PyTorch does not) with equal counts and reasons;
* gradients: the plain route in f64 against JAX's to 1e-10; the kernel
  route's (the plain route differentiated on the saved f32 input) against
  the plain route's bitwise and against JAX's ``pallas`` gradient to 1e-5
  of max|g|;
* the per-trip collectives from the group's counters: 2 halo exchanges,
  1 gather, 1 sum;
* ``DistGroup`` over gloo in two processes against ``LocalGroup(2)``, bit
  for bit;
* ``pjit_itd_sift`` / ``shard_bank`` against ``itd_sift``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import sharded_cases
from pyitd_tpu.parallel.sharded import make_mesh
from pyitd_tpu.parallel.sharded import sharded_itd_sift as jax_sharded_sift
from pyitd_tpu_torch import itd_sift
from pyitd_tpu_torch.ops import cuda_fill
from pyitd_tpu_torch.parallel import (DistGroup, LocalGroup, pjit_itd_sift,
                                      shard_bank, sharded_itd_sift,
                                      sharded_streaming_itd)
from pyitd_tpu_torch.parallel.sharded import _sift_local_kernel
from pyitd_tpu_torch.utils.interop import from_numpy

torch.set_num_threads(1)

needs_mesh = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")
CASES = list(sharded_cases())
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bank(batch=4, n=1024):
    """The bank of tests/test_sharded.py."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, n)
    return np.stack([
        np.sin((10 + 3 * k) * t * (1 + 0.1 * t)) + 0.2 * t**2
        + 0.1 * rng.normal(size=n) for k in range(batch)])


def to_shards(x: np.ndarray, seq: int) -> np.ndarray:
    """(rows, n) -> the port's (seq, rows, n_loc) layout (n a multiple of
    seq), as ``NamedSharding(mesh, P("data", "seq"))`` lays it out."""
    rows, n = x.shape
    return np.ascontiguousarray(x.reshape(rows, seq, n // seq).swapaxes(0, 1))


def from_shards(y: np.ndarray) -> np.ndarray:
    """The inverse of :func:`to_shards` on the last three axes."""
    y = np.swapaxes(y, -3, -2)
    return y.reshape(y.shape[:-2] + (-1,))


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        same = a.view(torch.int32) == b.view(torch.int32)
        return bool((same | (torch.isnan(a) & torch.isnan(b))).all())
    return bool((a == b).all())


def unsharded(x, max_it, mode="reference"):
    r = itd_sift(x, max_it, endpoint_mode=mode, backend="kernel",
                 store_baselines=False)
    return r.rotations, r.num_components, r.stop_reason, r.correction


def assert_matches_jax(got, want, atol):
    rot, ncomp, reason, corr = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(got[1].numpy(), ncomp)
    np.testing.assert_array_equal(got[2].numpy(), reason)
    np.testing.assert_allclose(got[0].numpy(), rot, rtol=0, atol=atol,
                               equal_nan=True)
    np.testing.assert_allclose(got[3].numpy(), corr, rtol=0, atol=atol,
                               equal_nan=True)


def test_shard_layout_round_trip():
    x = bank(3, 1024)
    group = LocalGroup(4)
    x3, n = group.to_shards(from_numpy(x))
    assert n == 1024
    np.testing.assert_array_equal(x3.numpy(), to_shards(x, 4))
    np.testing.assert_array_equal(group.from_shards(x3, n).numpy(), x)
    np.testing.assert_array_equal(from_shards(to_shards(x, 4)), x)
    # any length: edge-padded to a multiple of the shards, cropped back
    x3, n = group.to_shards(from_numpy(x[:, :1003]))
    assert x3.shape == (4, 3, 251) and n == 1003
    assert bool((x3[3, :, -1] == from_numpy(x[:, 1002])).all())
    np.testing.assert_array_equal(group.from_shards(x3, n).numpy(),
                                  x[:, :1003])


@needs_mesh
@pytest.mark.parametrize("batch,n,seq,max_it", [(4, 1024, 4, 6),
                                                (2, 512, 8, 4)])
def test_plain_route_matches_jax_xla(batch, n, seq, max_it):
    x = bank(batch, n)
    want = jax_sharded_sift(jnp.asarray(x), make_mesh(8, seq=seq), max_it,
                            backend="xla")
    got = sharded_itd_sift(from_numpy(x), LocalGroup(seq), max_it,
                           backend="torch")
    assert got[0].dtype == torch.float64
    assert_matches_jax(got, want, 1e-12)
    # and the port's own unsharded plain sift
    ref = itd_sift(from_numpy(x), max_it, backend="torch")
    torch.testing.assert_close(got[0], ref.rotations, rtol=0, atol=1e-12)
    assert torch.equal(got[1], ref.num_components)


@needs_mesh
def test_plain_route_nan_any_length_any_batch_match_jax():
    """The cases of tests/test_sharded.py:171-188 and :365-432: a NaN pair
    across a shard edge and a lone NaN, a length and a batch the mesh does
    not divide."""
    x = bank(3, 1003)
    x[0, 501:503] = np.nan   # straddles the edge at 502 of 2 shards of 502
    x[1, 700] = np.nan
    want = jax_sharded_sift(jnp.asarray(x), make_mesh(8, seq=4), 5,
                            backend="xla")
    got = sharded_itd_sift(from_numpy(x), LocalGroup(4), 5, backend="torch")
    assert got[0].shape == (7, 3, 1003) and got[3].shape == (3, 1003)
    assert got[1].shape == (3,)
    assert_matches_jax(got, want, 1e-12)


@needs_mesh
def test_kernel_route_matches_jax_pallas_interpret():
    x = bank(2, 1024).astype(np.float32)
    want = jax_sharded_sift(jnp.asarray(x), make_mesh(8, seq=4), 4,
                            backend="pallas")
    cuda_fill.reset_launches()
    got = sharded_itd_sift(from_numpy(x), LocalGroup(4), 4, backend="kernel")
    assert got[0].dtype == torch.float32
    assert_matches_jax(got, want, 1e-5 * float(np.abs(x).max()))
    # a CPU tensor runs the plain versions: nothing was launched
    assert all(v == 0 for v in cuda_fill.LAUNCHES.values())


@pytest.mark.parametrize("seq", [2, 4, 8])
@pytest.mark.parametrize("name,x", CASES, ids=[c[0] for c in CASES])
def test_kernel_route_is_bitwise_unsharded(name, x, seq):
    """Rotations, correction, counts and reasons of the sharded kernel route
    equal the unsharded kernel sift's bit for bit: stop A and stop B, both
    endpoint modes."""
    xt = torch.from_numpy(x)
    for mode, max_it in (("reference", 6), ("natural", 2)):
        got = sharded_itd_sift(xt, LocalGroup(seq), max_it,
                               endpoint_mode=mode, backend="kernel")
        for a, b in zip(got, unsharded(xt, max_it, mode)):
            assert bitwise_equal(a, b), (mode, max_it)


def test_stop_a_and_stop_b_mixed_over_rows():
    """One row stops flat on the first trips while its neighbour runs to
    the budget, and a third stops flat later."""
    t = np.linspace(0, 2 * np.pi, 2048)
    x = np.stack([np.sin(1.5 * t), bank(1, 2048)[0], np.sin(6 * t) + 0.2 * t]
                 ).astype(np.float32)
    xt = torch.from_numpy(x)
    got = sharded_itd_sift(xt, LocalGroup(4), 3, backend="kernel")
    want = unsharded(xt, 3)
    assert sorted(set(got[2].tolist())) == [1, 2]
    assert len(set(got[1].tolist())) > 1
    for a, b in zip(got, want):
        assert bitwise_equal(a, b)


def test_any_batch_and_flat_signal():
    x = torch.from_numpy(bank(6, 775).astype(np.float32))
    got = sharded_itd_sift(x.reshape(3, 2, 775), LocalGroup(4), 5,
                           backend="kernel")
    want = unsharded(x, 5)
    assert got[0].shape == (7, 3, 2, 775) and got[1].shape == (3, 2)
    assert bitwise_equal(got[0].reshape(7, 6, 775), want[0])
    one = sharded_itd_sift(x[0], LocalGroup(8), 5, backend="kernel")
    assert one[0].shape == (7, 775) and one[1].shape == ()
    assert bitwise_equal(one[0], want[0][:, 0])
    assert bitwise_equal(one[3], want[3][0])


def test_backends_and_refusals():
    x = torch.from_numpy(bank(2, 512))
    auto = sharded_itd_sift(x, LocalGroup(2), 3)  # f64 on the CPU: plain
    plain = sharded_itd_sift(x, LocalGroup(2), 3, backend="torch")
    assert bitwise_equal(auto[0], plain[0])
    with pytest.raises(ValueError, match="f32"):
        sharded_itd_sift(x, LocalGroup(2), 3, backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        sharded_itd_sift(x, LocalGroup(2), 3, backend="xla")
    with pytest.raises(ValueError, match="endpoint_mode"):
        sharded_itd_sift(x, LocalGroup(2), 3, endpoint_mode="bogus")
    with pytest.raises(ValueError, match="2 samples"):
        sharded_itd_sift(x[:, :1], LocalGroup(2), 3)
    with pytest.raises(ValueError, match="at least one shard"):
        LocalGroup(0)
    assert LocalGroup.differentiable and DistGroup.differentiable
    # fold_emit: each level emits the next trip's tile summaries, and the
    # result is the route's without it
    x3, n = LocalGroup(2).to_shards(x.float())
    emit = _sift_local_kernel(x3, LocalGroup(2), n, 3, "reference",
                              fold_emit=True)
    plain = _sift_local_kernel(x3, LocalGroup(2), n, 3, "reference",
                               fold_emit=False)
    assert all(bitwise_equal(a, b) for a, b in zip(emit, plain))
    # sharded_streaming_itd is ported now (its stub raised here): the
    # channel split runs and equals the replay it splits
    from pyitd_tpu_torch import streaming_itd

    split = sharded_streaming_itd(["cpu", "cpu"], 64)(x)
    assert all(torch.equal(a, b) for a, b in zip(split,
                                                 streaming_itd(x, 64)))


@pytest.mark.parametrize("seq,backend", [(4, "kernel"), (8, "kernel"),
                                         (4, "torch")])
def test_collective_budget_per_trip(seq, backend):
    """Per trip of the kernel route: 2 halo exchanges, ONE gather of the
    stacked boundary states, ONE sum (knot count + end knots), as
    tests/test_sharded.py:214-254 pins for JAX, with ``fold_emit`` too; the
    plain route's fills gather per channel and are not pinned, only
    counted."""
    x = torch.from_numpy(bank(4, 1024).astype(np.float32))
    max_it = 4
    trips = (max_it + 2) + 1  # levels + the initial extraction
    group = LocalGroup(seq)
    sharded_itd_sift(x, group, max_it, backend=backend)
    if backend == "kernel":
        budget = {"halo": 2 * trips, "all_gather": trips,
                  "all_reduce_sum": trips, "all_reduce_min": 0}
        assert group.calls == budget
        group.reset_calls()
        x3, n = group.to_shards(x)
        _sift_local_kernel(x3, group, n, max_it, "reference", fold_emit=True)
        assert group.calls == budget
    else:
        assert group.calls["halo"] % trips == 0 and group.calls["halo"] > 0
        assert group.calls["all_reduce_min"] == 0
    group.reset_calls()
    assert not any(group.calls.values())


@needs_mesh
def test_plain_route_gradient_matches_jax():
    """tests/test_sharded.py:498-516 for the port, f64."""
    x = bank(2, 512)
    mesh = make_mesh(8, seq=4)

    def loss_jax(a):
        rot, _, _, corr = jax_sharded_sift(a, mesh, 4, backend="xla")
        return jnp.sum(jnp.square(rot)) + 0.7 * jnp.sum(corr)

    want = np.asarray(jax.grad(loss_jax)(jnp.asarray(x)))
    xt = from_numpy(x).requires_grad_()
    rot, ncomp, _, corr = sharded_itd_sift(xt, LocalGroup(4), 4,
                                           backend="torch")
    ((rot ** 2).sum() + 0.7 * corr.sum()).backward()
    assert not ncomp.requires_grad
    assert np.all(np.isfinite(xt.grad.numpy()))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=0, atol=1e-10)
    # and the unsharded plain sift's own gradient
    xs = from_numpy(x).requires_grad_()
    r = itd_sift(xs, 4, backend="torch")
    ((r.rotations ** 2).sum() + 0.7 * r.correction.sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), xs.grad.numpy(), rtol=0,
                               atol=1e-10)


@needs_mesh
def test_kernel_route_gradient():
    """tests/test_sharded.py:519-539 for the port: the kernel route's
    backward is the plain route's on the same f32 input (bitwise), and
    agrees with JAX's ``pallas`` gradient to f32 roundoff: 1e-5 of max|g|
    (JAX holds its own two routes, one backward path, to 1e-5 absolute; two
    frameworks round the f32 adjoint's sums differently)."""
    x = bank(2, 512).astype(np.float32)
    mesh = make_mesh(8, seq=4)

    def loss(rot, corr):
        return (rot ** 2).sum() + corr.sum()

    def loss_jax(a):
        rot, _, _, corr = jax_sharded_sift(a, mesh, 4, backend="pallas")
        return jnp.sum(jnp.square(rot)) + jnp.sum(corr)

    want = np.asarray(jax.grad(loss_jax)(jnp.asarray(x)))
    grads = {}
    for backend in ("kernel", "torch"):
        xt = torch.from_numpy(x).requires_grad_()
        rot, _, _, corr = sharded_itd_sift(xt, LocalGroup(4), 4,
                                           backend=backend)
        loss(rot, corr).backward()
        grads[backend] = xt.grad
    assert bool(torch.isfinite(grads["kernel"]).all())
    assert bitwise_equal(grads["kernel"], grads["torch"])
    np.testing.assert_allclose(grads["kernel"].numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    with torch.no_grad():
        xt = torch.from_numpy(x).requires_grad_()
        assert not sharded_itd_sift(xt, LocalGroup(4), 4,
                                    backend="kernel")[0].requires_grad


_RANK_SCRIPT = """
import sys
import numpy as np, torch, torch.distributed as dist
from pyitd_tpu_torch.parallel import DistGroup, sharded_itd_sift
store_path, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                        rank=rank, world_size=2)
x = torch.from_numpy(np.load(out + "/x.npy"))
group = DistGroup()
mine = x[:, rank * 1024:(rank + 1) * 1024]
res = {}
for backend in ("kernel", "torch"):
    got = sharded_itd_sift(mine, group, 4, backend=backend)
    res.update({f"{backend}{i}": a.numpy() for i, a in enumerate(got)})
    if backend == "kernel":
        res["calls"] = np.array([group.calls[k] for k in sorted(group.calls)])
# the gradient over the group (it was refused before DistGroup's
# collectives carried one)
xg = mine.double().requires_grad_()
rot, _, _, corr = sharded_itd_sift(xg, group, 4)
((rot ** 2).sum() + corr.sum()).backward()
res["grad"] = xg.grad.numpy()
np.savez(f"{out}/rank{rank}.npz", **res)
dist.destroy_process_group()
"""


def test_dist_group_gloo_two_processes_bitwise_local_group(tmp_path):
    """Two processes, one half of a 2 x 2048 f32 bank each, over gloo with a
    ``FileStore``: the joined result is ``LocalGroup(2)``'s bit for bit, on
    the kernel route (plain versions) and on the plain route, and the
    joined f64 gradient of the ranks' summed losses is ``LocalGroup(2)``'s
    to 1e-12 of max|g| (``tests/test_torch_dist_grad.py`` holds it in
    worlds of 2 and 4 and against JAX)."""
    x = bank(2, 2048).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp_path / "store"), str(r),
         str(tmp_path)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    xt = torch.from_numpy(x)
    for backend in ("kernel", "torch"):
        group = LocalGroup(2)
        want = sharded_itd_sift(xt, group, 4, backend=backend)
        for i, dim in ((0, -1), (3, -1)):
            joined = torch.from_numpy(np.concatenate(
                [r[f"{backend}{i}"] for r in ranks], axis=dim))
            assert bitwise_equal(joined, want[i]), (backend, i)
        for i in (1, 2):
            for r in ranks:
                assert np.array_equal(r[f"{backend}{i}"], want[i].numpy())
    # the kernel route's budget holds in each process: 7 trips
    budget = {"all_gather": 7, "all_reduce_min": 0, "all_reduce_sum": 7,
              "halo": 14}
    for r in ranks:
        assert dict(zip(sorted(budget), r["calls"].tolist())) == budget
    xg = xt.double().requires_grad_()
    rot, _, _, corr = sharded_itd_sift(xg, LocalGroup(2), 4)
    ((rot ** 2).sum() + corr.sum()).backward()
    joined = np.concatenate([r["grad"] for r in ranks], axis=-1)
    scale = float(xg.grad.abs().max())
    assert np.isfinite(joined).all() and scale > 0
    np.testing.assert_allclose(joined, xg.grad.numpy(), rtol=0,
                               atol=1e-12 * scale)


def test_pjit_itd_sift_and_shard_bank_match_itd_sift():
    """tests/test_sharded.py:141-151 for the port: the rows split over the
    devices given (here the CPU, twice), each chunk sifted on its own."""
    x = from_numpy(bank(4, 512))
    devices = ["cpu", "cpu"]
    chunks = shard_bank(x, devices)
    assert [tuple(c.shape) for c in chunks] == [(2, 512), (2, 512)]
    ref = itd_sift(x, 5)
    for arg in (x, chunks):
        rot, base, ncomp, reason = pjit_itd_sift(devices, 5)(arg)
        assert bitwise_equal(rot, ref.rotations)
        assert bitwise_equal(base, ref.baselines)
        assert torch.equal(ncomp, ref.num_components)
        assert torch.equal(reason, ref.stop_reason)
    rot, _, _, _ = pjit_itd_sift(["cpu"], 5, store_baselines=False)(x)
    assert bitwise_equal(rot, ref.rotations)
