"""ODE/SDE samplers for Karras-EDM diffusion policies (torch port of
`beso_tpu/sampling/samplers.py`).

Functional parity targets: the `sample_*` functions of the reference
(`beso/agents/diffusion_agents/k_diffusion/gc_sampling.py`), with the JAX
package's step rules as the parity contract.

Conventions, as in the JAX package:
* `denoise_fn(x, sigma_vec) -> denoised` closes over states and goals;
* `sigmas` is a descending host grid with an appended terminal zero, shape
  [n+1]. The JAX `lax.scan` over the grid becomes a Python loop. The grid
  and every per-step coefficient are float32 host values, computed as the
  JAX scan computes them, so no step reads the device, and the JAX
  package's `jnp.where(sigma_next > 0, ...)` selections become `if`s on
  the host sigma (a branch that is not taken is not computed);
* every random draw goes through `sampler_noise`, fed by the caller's
  `torch.Generator`, in call order;
* `clip_fn` optionally clamps the action after every update (the
  reference's `scaler.clip_output` hook).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from beso_tpu_torch.sampling.lms import lms_coefficient_matrix

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
ClipFn = Optional[Callable[[torch.Tensor], torch.Tensor]]

F = np.float32
_INV_SQRT2M1 = 2 ** 0.5 - 1


def sampler_noise(x: torch.Tensor, generator: Optional[torch.Generator],
                  step: int, part: int = 0) -> torch.Tensor:
    """Unit normal draws shaped like x: every draw a sampler makes. `step`
    is the sampler's step (or iteration) and `part` the draw's index within
    it (`sample_dpmpp_sde` draws twice per step); the draws themselves come
    from `generator` in call order."""
    del step, part
    return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)


def _sigma_vec(x: torch.Tensor, sigma) -> torch.Tensor:
    """A host sigma broadcast to the batch, [B] float32."""
    return torch.full((x.shape[0],), float(sigma), dtype=torch.float32, device=x.device)


def _clip(x, clip_fn: ClipFn):
    return clip_fn(x) if clip_fn is not None else x


def _grid(sigmas) -> np.ndarray:
    return np.asarray(sigmas, dtype=np.float32)


def to_d(x: torch.Tensor, sigma, denoised: torch.Tensor) -> torch.Tensor:
    """Denoiser output -> Karras ODE derivative (gc_sampling.py:98-100);
    `sigma` is a host scalar."""
    return (x - denoised) / float(sigma)


def get_ancestral_step(sigma_from, sigma_to, eta: float = 1.0):
    """sigma_down/sigma_up split of an ancestral step (gc_sampling.py:107-114),
    on host float32 scalars."""
    sigma_from, sigma_to = F(sigma_from), F(sigma_to)
    if not eta:
        return sigma_to, F(0.0)
    sigma_up = min(sigma_to, F(F(eta) * np.sqrt(
        sigma_to ** 2 * (sigma_from ** 2 - sigma_to ** 2) / sigma_from ** 2)))
    sigma_down = F(np.sqrt(max(sigma_to ** 2 - sigma_up ** 2, F(0.0))))
    return sigma_down, F(sigma_up)


def _churn(x, sigma, n_steps, generator, step, s_churn, s_tmin, s_tmax, s_noise):
    """Langevin-like churn of Karras Algorithm 2 (gc_sampling.py:198-203).
    Returns (x, sigma_hat)."""
    sigma = F(sigma)
    if s_churn == 0.0:
        return x, sigma
    gamma = (F(min(s_churn / n_steps, _INV_SQRT2M1))
             if F(s_tmin) <= sigma <= F(s_tmax) else F(0.0))
    sigma_hat = F(sigma * (gamma + F(1.0)))
    if gamma > 0:
        bump = F(np.sqrt(max(sigma_hat ** 2 - sigma ** 2, F(0.0))))
        x = x + sampler_noise(x, generator, step) * s_noise * float(bump)
    return x, sigma_hat


# ---------------------------------------------------------------------------
# first-order ODE / ancestral
# ---------------------------------------------------------------------------

def _euler_steps(denoise_fn, x, sigmas, generator, s_churn, s_tmin, s_tmax, s_noise,
                 clip_fn):
    """Yields x after each Euler step with churn (gc_sampling.py:167-213)."""
    sig = _grid(sigmas)
    n = len(sig) - 1
    for i in range(n):
        x, sigma_hat = _churn(x, sig[i], n, generator, i, s_churn, s_tmin, s_tmax, s_noise)
        denoised = denoise_fn(x, _sigma_vec(x, sigma_hat))
        x = x + to_d(x, sigma_hat, denoised) * float(sig[i + 1] - sigma_hat)
        x = _clip(x, clip_fn)
        yield x


def sample_euler(denoise_fn: DenoiseFn, x, sigmas, generator=None, *, s_churn=0.0,
                 s_tmin=0.0, s_tmax=float("inf"), s_noise=1.0, clip_fn: ClipFn = None):
    """Karras Algorithm 2, Euler variant, with optional churn
    (gc_sampling.py:167-213)."""
    for x in _euler_steps(denoise_fn, x, sigmas, generator, s_churn, s_tmin, s_tmax,
                          s_noise, clip_fn):
        pass
    return x


def sample_euler_visualization(denoise_fn: DenoiseFn, x, sigmas, generator=None, *,
                               s_churn=0.0, s_tmin=0.0, s_tmax=float("inf"),
                               s_noise=1.0, clip_fn: ClipFn = None):
    """Euler sampler that also returns the intermediate action trajectory
    (gc_sampling.py:1019-1073). Returns (x0, xs [n, ...])."""
    xs = list(_euler_steps(denoise_fn, x, sigmas, generator, s_churn, s_tmin, s_tmax,
                           s_noise, clip_fn))
    return xs[-1], torch.stack(xs)


def sample_euler_ancestral(denoise_fn: DenoiseFn, x, sigmas, generator=None, *,
                           eta=1.0, clip_fn: ClipFn = None):
    """Ancestral sampling with Euler steps (gc_sampling.py:216-256)."""
    sig = _grid(sigmas)
    for i in range(len(sig) - 1):
        sigma = sig[i]
        denoised = denoise_fn(x, _sigma_vec(x, sigma))
        sigma_down, sigma_up = get_ancestral_step(sigma, sig[i + 1], eta)
        x = x + to_d(x, sigma, denoised) * float(sigma_down - sigma)
        if sigma_down > 0:
            x = x + sampler_noise(x, generator, i) * float(sigma_up)
        x = _clip(x, clip_fn)
    return x


# ---------------------------------------------------------------------------
# second-order ODE (Heun / DPM-2): n-1 two-evaluation steps, Euler epilogue
# ---------------------------------------------------------------------------

def _second_order(step_fn, denoise_fn, x, sigmas, generator, s_churn, s_tmin, s_tmax,
                  s_noise, clip_fn):
    """n-1 churned steps of `step_fn(x, sigma_hat, sigma_next, d)`, then the
    final sigma -> 0 Euler step; NFE = 2n - 1."""
    sig = _grid(sigmas)
    n = len(sig) - 1
    for i in range(n):
        x, sigma_hat = _churn(x, sig[i], n, generator, i, s_churn, s_tmin, s_tmax, s_noise)
        denoised = denoise_fn(x, _sigma_vec(x, sigma_hat))
        d = to_d(x, sigma_hat, denoised)
        if i < n - 1:
            x = step_fn(x, sigma_hat, sig[i + 1], d)
        else:
            x = x + d * float(F(0.0) - sigma_hat)
        x = _clip(x, clip_fn)
    return x


def sample_heun(denoise_fn: DenoiseFn, x, sigmas, generator=None, *, s_churn=0.0,
                s_tmin=0.0, s_tmax=float("inf"), s_noise=1.0, clip_fn: ClipFn = None):
    """Karras Algorithm 2 with the 2nd-order correction (gc_sampling.py:259-314).
    NFE = 2n - 1 (the last step is Euler, as in the reference)."""
    def step(x, sigma_hat, sigma_next, d):
        dt = float(sigma_next - sigma_hat)
        x_2 = x + d * dt
        d_2 = to_d(x_2, sigma_next, denoise_fn(x_2, _sigma_vec(x, sigma_next)))
        return x + (d + d_2) / 2 * dt

    return _second_order(step, denoise_fn, x, sigmas, generator, s_churn, s_tmin,
                         s_tmax, s_noise, clip_fn)


def sample_dpm_2(denoise_fn: DenoiseFn, x, sigmas, generator=None, *, s_churn=0.0,
                 s_tmin=0.0, s_tmax=float("inf"), s_noise=1.0, clip_fn: ClipFn = None):
    """DPM-Solver-2-inspired midpoint sampler (gc_sampling.py:317-375)."""
    def step(x, sigma_hat, sigma_next, d):
        # geometric midpoint in log-sigma (gc_sampling.py:366)
        sigma_mid = F(np.exp((np.log(sigma_hat) + np.log(sigma_next)) / F(2)))
        x_2 = x + d * float(sigma_mid - sigma_hat)
        d_2 = to_d(x_2, sigma_mid, denoise_fn(x_2, _sigma_vec(x, sigma_mid)))
        return x + d_2 * float(sigma_next - sigma_hat)

    return _second_order(step, denoise_fn, x, sigmas, generator, s_churn, s_tmin,
                         s_tmax, s_noise, clip_fn)


def sample_dpm_2_ancestral(denoise_fn: DenoiseFn, x, sigmas, generator=None, *,
                           eta=1.0, clip_fn: ClipFn = None):
    """Ancestral DPM-Solver-2 (gc_sampling.py:378-413)."""
    sig = _grid(sigmas)
    for i in range(len(sig) - 1):
        sigma = sig[i]
        denoised = denoise_fn(x, _sigma_vec(x, sigma))
        sigma_down, sigma_up = get_ancestral_step(sigma, sig[i + 1], eta)
        d = to_d(x, sigma, denoised)
        dt_2 = float(sigma_down - sigma)
        if sigma_down > 0:
            sd_safe = max(sigma_down, F(1e-12))
            sigma_mid = F(np.exp((np.log(sigma) + np.log(sd_safe)) / F(2)))
            x_2 = x + d * float(sigma_mid - sigma)
            d_2 = to_d(x_2, sigma_mid, denoise_fn(x_2, _sigma_vec(x, sigma_mid)))
            x = x + d_2 * dt_2 + sampler_noise(x, generator, i) * float(sigma_up)
        else:
            x = x + d * dt_2
        x = _clip(x, clip_fn)
    return x


# ---------------------------------------------------------------------------
# linear multistep
# ---------------------------------------------------------------------------

def sample_lms(denoise_fn: DenoiseFn, x, sigmas, generator=None, *, order: int = 4,
               clip_fn: ClipFn = None):
    """Linear multistep sampler (gc_sampling.py:432-468). The Lagrange-basis
    integrals over the host sigma grid come from `lms_coefficient_matrix`."""
    sig = _grid(sigmas)
    coeffs = lms_coefficient_matrix(sig, order).astype(np.float32)
    ds = []                                     # newest first
    for i in range(len(sig) - 1):
        denoised = denoise_fn(x, _sigma_vec(x, sig[i]))
        ds = [to_d(x, sig[i], denoised)] + ds[:order - 1]
        update = float(coeffs[i, 0]) * ds[0]
        for c, d in zip(coeffs[i, 1:], ds[1:]):
            update = update + float(c) * d
        x = _clip(x + update, clip_fn)
    return x


# ---------------------------------------------------------------------------
# DDIM / DPM-Solver++ family (exponential-integrator steps in t = -log sigma)
# ---------------------------------------------------------------------------

def sample_ddim(denoise_fn: DenoiseFn, x, sigmas, generator=None, *,
                clip_fn: ClipFn = None):
    """DDIM / DPM-Solver-1 (gc_sampling.py:895-924). BESO's default sampler.

    x <- (sigma_next / sigma) * x - (sigma_next / sigma - 1) * denoised;
    the final step (sigma_next = 0) collapses to x <- denoised.
    """
    sig = _grid(sigmas)
    for i in range(len(sig) - 1):
        denoised = denoise_fn(x, _sigma_vec(x, sig[i]))
        ratio = sig[i + 1] / sig[i]
        x = float(ratio) * x - float(ratio - F(1.0)) * denoised
        x = _clip(x, clip_fn)
    return x


def _log_t(sigma):
    """t = -log(sigma), float32."""
    return F(-np.log(F(sigma)))


def sample_dpmpp_2s(denoise_fn: DenoiseFn, x, sigmas, generator=None, *,
                    clip_fn: ClipFn = None):
    """DPM-Solver++(2S) (gc_sampling.py:928-967). The final step is Euler."""
    sig = _grid(sigmas)
    n = len(sig) - 1
    r = F(0.5)
    for i in range(n):
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = denoise_fn(x, _sigma_vec(x, sigma))
        if i == n - 1:                          # gc_sampling.py:951-955
            x = x + to_d(x, sigma, denoised) * float(F(0.0) - sigma)
        else:
            t, t_next = _log_t(sigma), _log_t(sigma_next)
            h = t_next - t
            sig_s = F(np.exp(-(t + r * h)))
            x_2 = float(sig_s / sigma) * x - float(np.expm1(-h * r)) * denoised
            denoised_2 = denoise_fn(x_2, _sigma_vec(x, sig_s))
            x = float(sigma_next / sigma) * x - float(np.expm1(-h)) * denoised_2
        x = _clip(x, clip_fn)
    return x


def sample_dpmpp_2s_ancestral(denoise_fn: DenoiseFn, x, sigmas, generator=None, *,
                              eta=1.0, s_noise=1.0, clip_fn: ClipFn = None):
    """Ancestral DPM-Solver++(2S) (gc_sampling.py:970-1016)."""
    sig = _grid(sigmas)
    r = F(0.5)
    for i in range(len(sig) - 1):
        sigma = sig[i]
        denoised = denoise_fn(x, _sigma_vec(x, sigma))
        sigma_down, sigma_up = get_ancestral_step(sigma, sig[i + 1], eta)
        if sigma_down > 0:                      # the 2S branch toward sigma_down
            t, t_next = _log_t(sigma), _log_t(sigma_down)
            h = t_next - t
            sig_s = F(np.exp(-(t + r * h)))
            x_2 = float(sig_s / sigma) * x - float(np.expm1(-h * r)) * denoised
            denoised_2 = denoise_fn(x_2, _sigma_vec(x, sig_s))
            x = float(sigma_down / sigma) * x - float(np.expm1(-h)) * denoised_2
        else:                                   # Euler for the final step
            x = x + to_d(x, sigma, denoised) * float(sigma_down - sigma)
        if sigma_up != 0:
            x = x + sampler_noise(x, generator, i) * s_noise * float(sigma_up)
        x = _clip(x, clip_fn)
    return x


def sample_dpmpp_2m(denoise_fn: DenoiseFn, x, sigmas, generator=None, *,
                    clip_fn: ClipFn = None):
    """DPM-Solver++(2M) multistep (gc_sampling.py:702-736)."""
    sig = _grid(sigmas)
    old_denoised, h_last = None, F(1.0)
    for i in range(len(sig) - 1):
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = denoise_fn(x, _sigma_vec(x, sigma))
        h = _log_t(max(sigma_next, F(1e-20))) - _log_t(sigma)
        ratio = sigma_next / sigma
        sel = denoised
        if i > 0 and sigma_next != 0:
            r = h_last / h
            sel = (float(F(1.0) + F(1.0) / (F(2.0) * r)) * denoised
                   - float(F(1.0) / (F(2.0) * r)) * old_denoised)
        x = _clip(float(ratio) * x - float(ratio - F(1.0)) * sel, clip_fn)
        old_denoised, h_last = denoised, h
    return x


def sample_dpmpp_sde(denoise_fn: DenoiseFn, x, sigmas, generator=None, *, eta=1.0,
                     s_noise=1.0, r=0.5, clip_fn: ClipFn = None):
    """DPM-Solver++ (stochastic) (gc_sampling.py:739-795): two draws per
    step (parts 0 and 1 of `sampler_noise`), per-interval gaussians in
    place of the reference's torchsde BrownianTree (same marginals). The
    final (sigma_next == 0) step is a plain, unclipped Euler step
    (gc_sampling.py:768-772), as in the JAX package."""
    sig = _grid(sigmas)
    r = F(r)
    fac = F(1.0) / (F(2.0) * r)
    for i in range(len(sig) - 1):
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = denoise_fn(x, _sigma_vec(x, sigma))
        if sigma_next == 0:
            x = x + to_d(x, sigma, denoised) * float(sigma_next - sigma)
            continue
        t, t_next = _log_t(sigma), _log_t(sigma_next)
        h = t_next - t
        sig_s = F(np.exp(-(t + h * r)))
        # step 1, to the ancestral-reduced midpoint
        sd, su = get_ancestral_step(sigma, sig_s, eta)
        s_ = _log_t(max(sd, F(1e-20)))
        x_2 = float(F(np.exp(-s_)) / sigma) * x - float(np.expm1(t - s_)) * denoised
        if su != 0:
            x_2 = x_2 + sampler_noise(x, generator, i, 0) * s_noise * float(su)
        denoised_2 = denoise_fn(x_2, _sigma_vec(x, sig_s))
        # step 2
        sd, su = get_ancestral_step(sigma, sigma_next, eta)
        t_next_ = _log_t(max(sd, F(1e-20)))
        denoised_d = float(F(1.0) - fac) * denoised + float(fac) * denoised_2
        x = (float(F(np.exp(-t_next_)) / sigma) * x
             - float(np.expm1(t - t_next_)) * denoised_d)
        if su != 0:
            x = x + sampler_noise(x, generator, i, 1) * s_noise * float(su)
        x = _clip(x, clip_fn)
    return x


def sample_dpmpp_2m_sde(denoise_fn: DenoiseFn, x, sigmas, generator=None, *,
                        eta=1.0, s_noise=1.0, solver_type: str = "heun",
                        clip_fn: ClipFn = None):
    """DPM-Solver++(2M) SDE: the intended k-diffusion algorithm, as the JAX
    package implements it (the reference's own body, gc_sampling.py:799-852,
    does not run as shipped)."""
    if solver_type not in {"heun", "midpoint"}:
        raise ValueError("solver_type must be 'heun' or 'midpoint'")
    sig = _grid(sigmas)
    old_denoised, h_last = None, F(1.0)
    for i in range(len(sig) - 1):
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = denoise_fn(x, _sigma_vec(x, sigma))
        h = _log_t(max(sigma_next, F(1e-20))) - _log_t(sigma)
        if sigma_next == 0:
            x = denoised
        else:
            eta_h = F(eta) * h
            em = F(-np.expm1(-h - eta_h))
            x = float(sigma_next / sigma * F(np.exp(-eta_h))) * x + float(em) * denoised
            if old_denoised is not None:
                r = h_last / h
                if solver_type == "heun":
                    c = (em / (-h - eta_h) + F(1.0)) * (F(1.0) / r)
                else:
                    c = F(0.5) * em * (F(1.0) / r)
                x = x + float(c) * (denoised - old_denoised)
            noise_scale = F(np.sqrt(-np.expm1(F(-2.0) * eta_h)))
            if noise_scale != 0:
                x = (x + sampler_noise(x, generator, i) * float(sigma_next)
                     * float(noise_scale) * s_noise)
        x = _clip(x, clip_fn)
        old_denoised, h_last = denoised, h
    return x


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def sample_loop(sampler_type: str, denoise_fn: DenoiseFn, x: torch.Tensor, sigmas,
                generator: Optional[torch.Generator] = None, *, s_churn: float = 0.0,
                s_tmin: float = 0.0, eta: float = 1.0,
                clip_fn: ClipFn = None) -> torch.Tensor:
    """Named sampler dispatch mirroring BesoAgent.sample_loop
    (beso_agent.py:390-456), with its name quirks: 'ancestral' ->
    dpm_2_ancestral, 'dpm' -> dpm_2, 'dpmpp_2m_sde' -> the stochastic
    dpmpp_sde (the reference's own 2M-SDE body does not run), and the
    repaired 2M SDE under 'dpmpp_2m_sde_fixed'."""
    from beso_tpu_torch.sampling.dpm_solver import sample_dpm_adaptive, sample_dpm_fast

    churn = dict(s_churn=s_churn, s_tmin=s_tmin, clip_fn=clip_fn)
    if sampler_type == "lms":
        return sample_lms(denoise_fn, x, sigmas, generator, clip_fn=clip_fn)
    if sampler_type == "heun":
        return sample_heun(denoise_fn, x, sigmas, generator, **churn)
    if sampler_type == "euler":
        return sample_euler(denoise_fn, x, sigmas, generator, **churn)
    if sampler_type == "ancestral":
        return sample_dpm_2_ancestral(denoise_fn, x, sigmas, generator, eta=eta,
                                      clip_fn=clip_fn)
    if sampler_type == "euler_ancestral":
        return sample_euler_ancestral(denoise_fn, x, sigmas, generator, eta=eta,
                                      clip_fn=clip_fn)
    if sampler_type == "dpm":
        return sample_dpm_2(denoise_fn, x, sigmas, generator, **churn)
    if sampler_type == "ddim":
        return sample_ddim(denoise_fn, x, sigmas, generator, clip_fn=clip_fn)
    if sampler_type == "dpm_adaptive":
        return sample_dpm_adaptive(denoise_fn, x, sigmas[-2], sigmas[0], generator)
    if sampler_type == "dpm_fast":
        return sample_dpm_fast(denoise_fn, x, sigmas[-2], sigmas[0], len(sigmas),
                               generator)
    if sampler_type == "dpmpp_2s_ancestral":
        return sample_dpmpp_2s_ancestral(denoise_fn, x, sigmas, generator, eta=eta,
                                         clip_fn=clip_fn)
    if sampler_type == "dpmpp_2s":
        return sample_dpmpp_2s(denoise_fn, x, sigmas, generator, clip_fn=clip_fn)
    if sampler_type == "dpmpp_2m":
        return sample_dpmpp_2m(denoise_fn, x, sigmas, generator, clip_fn=clip_fn)
    if sampler_type in ("dpmpp_2m_sde", "dpmpp_sde"):
        return sample_dpmpp_sde(denoise_fn, x, sigmas, generator, eta=eta, clip_fn=clip_fn)
    if sampler_type == "dpmpp_2m_sde_fixed":
        return sample_dpmpp_2m_sde(denoise_fn, x, sigmas, generator, eta=eta,
                                   clip_fn=clip_fn)
    raise ValueError(f"desired sampler type not found: {sampler_type!r}")


SAMPLERS = (
    "lms", "heun", "euler", "ancestral", "euler_ancestral", "dpm", "ddim",
    "dpm_adaptive", "dpm_fast", "dpmpp_2s_ancestral", "dpmpp_2s", "dpmpp_2m",
    "dpmpp_2m_sde", "dpmpp_sde", "dpmpp_2m_sde_fixed",
)
