"""Successive Variational Mode Decomposition — port of
``pyitd_tpu/decomp/svmd.py``.

Behavioral contract (the reference's ``svmd.py``, itself a translation of
Nazari & Sakhaei's MATLAB):

* odd-length inputs drop their first sample; the signal and a
  savgol(25, 8)-residual noise estimate are mirror-extended to 2T;
* spectral domain: ``omega = t - 0.5 - 1/T`` over the extended length, the
  one-sided ``fftshift(fft(.))`` with the lower half zeroed;
* per mode: an ADMM inner loop (mode update / center-frequency update /
  dual ascent) inside an alpha-annealing schedule (m / bf bit-flag walk,
  Alpha = 10 -> e^m -> maxAlpha-1 -> maxAlpha+1);
* four stopping criteria: noise power, exact reconstruction, BIC, power of
  the last mode (default), the last evaluated with the reset Alpha;
* reconstruction: conjugate-symmetric spectrum completion, ifft, de-mirror
  crop to the center half, modes sorted by center frequency.

JAX runs the inner ADMM loop and the annealing loop as two nested
``lax.while_loop``s.  Here they are one device state machine
(``utils/device_loop.run_until``): each step runs an inner iteration while
the inner loop's condition holds and the annealing transition when it
fails, ``torch.where`` picking the branch, and the host reads the stop
flag once per ``_BLOCK`` steps.  The per-mode loop stays on the host, as in
JAX.  The Savitzky-Golay map is applied without an (n, n) matrix: the
interior taps by ``conv1d``, the two edge blocks from the projection;
:func:`savgol_filter_matrix` stays the public numpy function.

Returns numpy arrays, as JAX's.  Numpy input runs on ``device`` (the card
by default); a tensor stays on its own device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device_loop import run_until
from ..utils.interop import as_input

__all__ = ["svmd", "savgol_filter_matrix"]

# steps of the annealed ADMM between host reads of the stop flag
_BLOCK = 64
_EPS = float(np.finfo(np.float64).eps)


def _savgol_projection(window: int, poly: int) -> np.ndarray:
    """The (window, window) polynomial fit-and-evaluate operator.  Centred
    abscissa: the projection does not depend on the basis, and centring
    keeps the Vandermonde well conditioned."""
    half = window // 2
    A = np.vander(np.arange(window, dtype=float) - half, poly + 1,
                  increasing=True)
    return A @ np.linalg.pinv(A)


def savgol_filter_matrix(n: int, window: int = 25,
                         poly: int = 8) -> np.ndarray:
    """Dense (n, n) linear map equal to ``scipy.signal.savgol_filter(window,
    poly, mode='interp')``: interior convolution and polynomial-fit
    edges."""
    half = window // 2
    proj = _savgol_projection(window, poly)
    M = np.zeros((n, n))
    for i in range(half, n - half):
        M[i, i - half:i + half + 1] = proj[half]
    M[:half, :window] = proj[:half]
    M[n - half:, n - window:] = proj[half + 1:]
    return M


def _savgol_apply(x, window: int = 25, poly: int = 8):
    """``savgol_filter_matrix(x.size, window, poly) @ x`` without the
    matrix."""
    half = window // 2
    proj = torch.from_numpy(_savgol_projection(window, poly)).to(x)
    inner = F.conv1d(x[None, None], proj[half][None, None])[0, 0]
    return torch.cat([proj[:half] @ x[:window], inner,
                      proj[half + 1:] @ x[-window:]])


def _extract_mode(f_hat_onesided, omega_freqs, h_coup, u_coup, omega_init,
                  max_alpha, tau, tol, n_inner=300) -> dict:
    """One mode: the final state of the annealed ADMM, with ``u`` (the mode
    spectrum), ``omega_prev`` (the saved center frequency before clamping),
    ``alpha`` (the exit Alpha) and ``inner`` (inner iterations run).

    ``h_coup`` / ``u_coup`` are the couplings to the modes extracted
    before, per frequency bin: constant vectors of the reference's
    whole-matrix sums with ``coupling="scalar"``, the published algorithm's
    per-frequency sums with ``coupling="vector"``."""
    T = omega_freqs.shape[0]
    hi = slice(T // 2, T)
    dev = omega_freqs.device
    log_max = float(np.log(max_alpha))

    def step(s):
        alpha, omega, u, lam = s["alpha"], s["omega"], s["u"], s["lam"]
        # the inner ADMM iteration (svmd.py:166-190)
        dom = omega_freqs - omega
        inter1 = (alpha ** 2) * dom ** 4
        denom = (1.0 + inter1) * (1.0 + 2.0 * alpha * dom ** 2) + h_coup
        u_new = (f_hat_onesided + inter1 * u + lam / 2.0) / denom
        inter2 = u_new[hi].abs() ** 2
        omega_new = torch.dot(omega_freqs[hi], inter2) / inter2.sum()
        lam_new = lam + tau * (
            f_hat_onesided
            - (u_new + (inter1 * (f_hat_onesided - u_new - u_coup + lam / 2.0)
                        - u_coup) / (1.0 + inter1))
            + u_coup)
        du = u_new - u
        # the reference's convergence ratio divides by exactly 0+0j on the
        # first pass (u starts at 0); numpy gives inf+nanj there and |eps +
        # inf+nanj| = inf, so its loop goes on.  vdot(z, z) has an exactly
        # zero imaginary part, so real division keeps that (x/0 = inf,
        # 0/0 = nan) where a complex division would give nan and stop
        num = torch.vdot(du, du).real / T
        den = torch.vdot(u, u).real / T
        udiff = (_EPS + num / den).abs()

        # the annealing transition (svmd.py:197-219) when the inner loop ends
        near = (s["m"] - log_max).abs() <= 1.0
        m = torch.where(near, s["m"] + 0.05, s["m"] + 1.0)
        bf = torch.where(near, s["bf"] + 1, s["bf"])
        a_t = torch.where(bf >= 2, alpha + 1.0, alpha)
        reset = a_t <= max_alpha - 1.0
        a_t = torch.where(reset, torch.where(bf == 1, max_alpha - 1.0,
                                             torch.exp(m)), a_t)

        inner = (s["udiff"] > tol) & (s["n"] + 1 < n_inner)
        # on reset the current mode spectrum carries over as u
        alpha = torch.where(inner, alpha, a_t)
        return {
            "u": torch.where(inner, u_new, u),
            "lam": torch.where(inner, lam_new,
                               torch.where(reset, 0.0, lam)),
            "omega": torch.where(inner, omega_new,
                                 torch.where(reset, omega_init, omega)),
            "omega_prev": torch.where(inner, omega, s["omega_prev"]),
            "udiff": torch.where(inner, udiff,
                                 torch.where(reset, tol + _EPS, s["udiff"])),
            "n": torch.where(inner, s["n"] + 1,
                             torch.where(reset, 0, s["n"])),
            "alpha": alpha,
            "m": torch.where(inner, s["m"], m),
            "bf": torch.where(inner, s["bf"], bf),
            "inner": s["inner"] + inner.to(torch.int32),
            "done": ~((alpha < max_alpha + 1) & torch.isfinite(alpha)),
        }

    def scalar(v, dtype=torch.float64):
        return torch.tensor(v, dtype=dtype, device=dev)

    czero = torch.zeros_like(f_hat_onesided)
    init = {"u": czero, "lam": czero, "omega": scalar(omega_init),
            "omega_prev": scalar(omega_init), "udiff": scalar(tol + _EPS),
            "n": scalar(0, torch.int32), "alpha": scalar(10.0),
            "m": scalar(0.0), "bf": scalar(0, torch.int32),
            "inner": scalar(0, torch.int32), "done": scalar(False, torch.bool)}
    return run_until(step, init, block=_BLOCK)


def svmd(signal, max_alpha: float = 200.0, tau: float = 0.5,
         tol: float = 1e-6, stopc: int = 4, init_omega: int = 0, *,
         max_modes: int = 30, seed: int = 0, coupling: str = "vector",
         device="cuda"):
    """Successive VMD.  Returns ``(u, u_hat, omega)`` like the reference:
    modes (L, T_in), their spectra (T_in, L), center frequencies (L,), as
    numpy arrays.

    ``coupling="vector"`` (default) uses the published algorithm's
    per-frequency couplings to the modes extracted before.
    ``coupling="scalar"`` reproduces the reference translation, which
    collapses those couplings with whole-matrix ``np.sum`` calls
    (``svmd.py:162,176-179``): a fidelity mode, not a useful one."""
    if coupling not in ("vector", "scalar"):
        raise ValueError(coupling)
    x = as_input(signal, torch.float64, device)
    if x.numel() % 2 != 0:
        x = x[1:]
    save_T = x.numel()
    fs = 1.0 / save_T
    noise = x - _savgol_apply(x)

    def mirror(v):
        h = v.shape[0] // 2
        return torch.cat([v[:h].flip(0), v, v[h:].flip(0)])

    f, fn = mirror(x), mirror(noise)
    T = f.shape[0]
    omega_np = np.arange(1, T + 1) / T - 0.5 - 1.0 / T
    omega_freqs = torch.from_numpy(omega_np).to(x.device)

    def onesided(v):
        spec = torch.fft.fftshift(torch.fft.fft(v))
        spec[:T // 2] = 0.0
        return spec

    f_hat_onesided = onesided(f)
    noisepe = float(torch.linalg.norm(onesided(fn)) ** 2)

    rng = np.random.default_rng(seed)
    modes_u, omegas = [], []
    h_sum, u_scalar_sum = 0.0, 0.0 + 0.0j
    h_vec = torch.zeros_like(omega_freqs)
    u_modes_sum = torch.zeros_like(f_hat_onesided)
    sigerror, bic, polm = [], [], []
    polm_temp = None
    min_alpha = 10.0
    done = False
    n2 = 0

    while not done and len(modes_u) < max_modes:
        if init_omega == 0:
            omega_init = 0.0
        else:
            omega_init, n2 = _draw_omega(rng, fs, np.asarray(omegas), n2)

        if coupling == "vector":
            h_coup, u_coup = h_vec, u_modes_sum
        else:
            h_coup = torch.full_like(omega_freqs, h_sum)
            u_coup = torch.full_like(f_hat_onesided, u_scalar_sum)
        s = _extract_mode(f_hat_onesided, omega_freqs, h_coup, u_coup,
                          float(omega_init), float(max_alpha), float(tau),
                          float(tol))
        u = s["u"]
        omega_d = max(float(s["omega_prev"]), 0.0)  # omega_L[omega_L<0]=0
        alpha_exit = float(s["alpha"])
        modes_u.append(u)
        omegas.append(omega_d)

        gamma = 1.0
        h_row = gamma / ((alpha_exit ** 2) * (omega_np - omega_d) ** 4)
        h_sum = h_sum + float(np.sum(h_row))
        h_vec = h_vec + torch.from_numpy(h_row).to(x.device)
        u_scalar_sum = u_scalar_sum + complex(u.sum())
        u_modes_sum = u_modes_sum + u

        l = len(modes_u) - 1
        if stopc == 1:
            err = float(torch.linalg.norm(f_hat_onesided - u_modes_sum) ** 2)
            sigerror.append(err)
            if n2 >= 300 or err <= round(noisepe):
                done = True
        elif stopc == 2:
            val = float(
                (torch.linalg.norm(u_modes_sum - f_hat_onesided) ** 2 / T)
                / (torch.linalg.norm(f_hat_onesided) ** 2 / T))
            if n2 >= 300 or val < 0.005:
                done = True
        elif stopc == 3:
            err = float(torch.linalg.norm(f_hat_onesided - u_modes_sum) ** 2)
            sigerror.append(err)
            bic.append(2 * T * np.log(err) + (3 * l) * np.log(2 * T))
            if l > 0 and bic[l] > bic[l - 1]:
                done = True
        else:
            # the power of the last mode, evaluated with the reset Alpha
            dom = omega_freqs - omega_d
            val = float(torch.linalg.norm(
                (4.0 * min_alpha * u / (1.0 + 2.0 * min_alpha * dom ** 2))
                * u.conj()))
            if polm_temp is None:
                polm_temp = val
                polm.append(val / val)
            else:
                polm.append(val / polm_temp)
                if abs(polm[l] - polm[l - 1]) < tol:
                    done = True

        # svmd.py:332-336: the omega-draw budget (n2 < 300) is per mode
        n2 = 0

    # reconstruction (svmd.py:338-360)
    L = len(modes_u)
    u_stack = torch.stack(modes_u)
    full = torch.zeros((L, T), dtype=torch.complex128, device=x.device)
    full[:, T // 2:T] = u_stack[:, T // 2:T]
    full[:, 1:T // 2 + 1] = u_stack[:, T // 2:T].flip(1).conj()
    full[:, 0] = full[:, -1].conj()

    u_time = torch.fft.ifft(torch.fft.ifftshift(full, dim=1), dim=1).real
    order = np.argsort(np.asarray(omegas))
    u_time = u_time[torch.from_numpy(order).to(x.device)]
    omega_sorted = np.asarray(omegas)[order]
    u_out = u_time[:, T // 4:3 * T // 4]
    u_hat = torch.fft.fftshift(torch.fft.fft(u_out, dim=1), dim=1).conj().T
    return (u_out.cpu().numpy(), u_hat.resolve_conj().cpu().numpy(),
            omega_sorted)


def _draw_omega(rng, fs, existing, n2):
    """The init_omega=1 path: a random center-frequency start distinct from
    the modes extracted before (svmd.py:236-247)."""
    val = 0.0
    while n2 < 300:
        val = float(np.exp(np.log(fs) + (np.log(0.5) - np.log(fs))
                           * rng.random()))
        n2 += 1
        if existing.size == 0 or not np.any(np.abs(existing - val) < 0.02):
            break
    return val, n2
