"""Wolf / Phoenix optimizers: port of ``pyitd_tpu/ml/optimizers.py``.

* **Wolf**: leaky-integrator momentum with rate 1/e (``update =
  p·(1-1/e) + g/e``, ``p <- p·(1-1/e) + update/e``), the sign agreement
  of the integrated update with the raw gradient taken **before** the
  multiplicative uniform noise (±1/e); where they agree, step along the
  update, where they disagree, decay the parameter toward zero by ``lr``.
* **Phoenix**: a cascade of M leaky integrators with rates
  ``e^{-(i+1)}``, directional confidence (the share of integrators that
  agree with their mean) plus magnitude confidence (inverse spread),
  updates gated by the fastest integrator's sign; noise only when
  ``noise_scale > 0``.

Each update is a plain function of tensors (:func:`wolf_update`,
:func:`phoenix_update`) that takes the uniform draws as an argument; the
``torch.optim.Optimizer`` subclasses :class:`Wolf` and :class:`Phoenix`
draw them from their ``torch.Generator`` (one per device, seeded 0 unless
given) and apply the update as ``p + delta``, as optax's
``apply_updates`` does.  The generator's state is part of the optimizer's
``state_dict``, so a resumed run draws the same noise.
"""
from __future__ import annotations

import math

import torch

__all__ = ["Wolf", "Phoenix", "wolf", "phoenix", "wolf_update",
           "phoenix_update"]

_ETC = 0.367879441  # 1/e, the reference's integrator rate
_ET = 1.0 - _ETC


def wolf_update(grad, p_int, param, uniform, learning_rate: float):
    """One Wolf step of one tensor: ``(delta, new integrator)``.
    ``uniform`` holds draws in [0, 1) of ``grad``'s shape."""
    upd = p_int * _ET + grad * _ETC
    new_p = p_int * _ET + upd * _ETC
    agree = torch.sign(upd) * torch.sign(grad) > 0
    noise = uniform * 2.0 - 1.0
    upd = upd + noise * _ETC * upd
    # agreement: -lr*update; disagreement: decay the parameter toward zero
    delta = torch.where(agree, -learning_rate * upd, -param * learning_rate)
    return delta, new_p


def phoenix_update(grad, integrators, uniform, learning_rate: float,
                   noise_scale: float = 0.0, eps: float = 1e-6):
    """One Phoenix step of one tensor: ``(delta, new integrators)``.
    ``uniform`` (draws in [0, 1)) is read only when ``noise_scale > 0``."""
    m = len(integrators)
    etc = [math.exp(-(i + 1)) for i in range(m)]
    et = [1.0 - e for e in etc]
    u = learning_rate * grad
    new_ints = []
    for i in range(m):
        cur = integrators[i] * et[i] + etc[i] * (u if i == 0
                                                 else new_ints[i - 1])
        new_ints.append(cur)
    stack = torch.stack(new_ints)
    mean = stack.mean(0)
    dir_conf = (torch.sign(stack) * torch.sign(mean) > 0).to(u.dtype).mean(0)
    mags = stack.abs()
    spread = mags.amax(0) - mags.amin(0)
    mag_conf = 1.0 / (spread + eps)
    conf = 0.5 * (dir_conf + mag_conf)

    contribs = [etc[0] * u] + [etc[i] * new_ints[i - 1] for i in range(1, m)]
    upd = sum(contribs) / m
    if noise_scale > 0.0:  # reference: noise precedes the gate
        upd = upd + noise_scale * (2.0 * uniform - 1.0) * upd
    gated = torch.where(torch.sign(new_ints[0]) * torch.sign(upd) > 0,
                        conf * upd, torch.zeros_like(upd))
    return -gated, new_ints


class _Noisy(torch.optim.Optimizer):
    """An optimizer that draws uniforms from one generator per device."""

    def __init__(self, params, defaults, generator):
        super().__init__(params, defaults)
        self._generators = {} if generator is None else {
            generator.device: generator}

    def _uniform(self, like):
        gen = self._generators.get(like.device)
        if gen is None:
            gen = torch.Generator(device=like.device).manual_seed(0)
            self._generators[like.device] = gen
        return torch.rand(like.shape, generator=gen, dtype=like.dtype,
                          device=like.device)

    def state_dict(self):
        out = super().state_dict()
        out["generators"] = {str(d): g.get_state()
                             for d, g in self._generators.items()}
        return out

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        saved = state_dict.pop("generators", {})
        super().load_state_dict(state_dict)
        for dev, st in saved.items():
            dev = torch.device(dev)
            gen = self._generators.get(dev)
            if gen is None:
                gen = self._generators[dev] = torch.Generator(device=dev)
            gen.set_state(st.cpu())


class Wolf(_Noisy):
    def __init__(self, params, lr: float = 2e-3, generator=None):
        super().__init__(params, {"lr": lr}, generator)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["p"] = torch.zeros_like(p)
                delta, st["p"] = wolf_update(p.grad, st["p"], p,
                                             self._uniform(p), group["lr"])
                p.add_(delta)
        return loss


class Phoenix(_Noisy):
    def __init__(self, params, lr: float = 1e-2, m: int = 7,
                 noise_scale: float = 0.0, eps: float = 1e-6,
                 generator=None):
        super().__init__(params, {"lr": lr, "m": m,
                                  "noise_scale": noise_scale, "eps": eps},
                         generator)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["integrators"] = [torch.zeros_like(p)
                                         for _ in range(group["m"])]
                noisy = group["noise_scale"] > 0.0
                delta, st["integrators"] = phoenix_update(
                    p.grad, st["integrators"],
                    self._uniform(p) if noisy else None, group["lr"],
                    group["noise_scale"], group["eps"])
                p.add_(delta)
        return loss


def wolf(params, learning_rate: float = 2e-3, generator=None) -> Wolf:
    """The Wolf optimizer over ``params`` (JAX's factory name)."""
    return Wolf(params, lr=learning_rate, generator=generator)


def phoenix(params, learning_rate: float = 1e-2, m: int = 7,
            noise_scale: float = 0.0, eps: float = 1e-6,
            generator=None) -> Phoenix:
    """The Phoenix optimizer over ``params`` (JAX's factory name)."""
    return Phoenix(params, lr=learning_rate, m=m, noise_scale=noise_scale,
                   eps=eps, generator=generator)
