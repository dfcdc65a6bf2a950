"""DPM-Solver (Lu et al. 2022, arXiv 2206.00927): fixed-fast and adaptive
(torch port of `beso_tpu/sampling/dpm_solver.py`).

Functional parity targets: the `DPMSolver` class, `sample_dpm_fast` and
`sample_dpm_adaptive` with `PIDStepSizeController`
(`beso/agents/diffusion_agents/k_diffusion/gc_sampling.py:498-699,855-892`).

Solver steps work in t = -log(sigma), on float32 host scalars, as the JAX
package computes them. The JAX `lax.while_loop` of the adaptive solver
becomes a Python loop: each iteration reads its batch-wide error norm to
the host once, and the PID controller, the accept decision and the step
size are host float32 arithmetic on it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from beso_tpu_torch.sampling import samplers
from beso_tpu_torch.sampling.samplers import F, _sigma_vec, get_ancestral_step

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _sigma(t):
    return F(np.exp(-F(t)))


def _t(sigma):
    return F(-np.log(F(sigma)))


def _eps(denoise_fn, x, t):
    """eps(x, t) = (x - D(x, sigma(t))) / sigma(t) (gc_sampling.py:543-550)."""
    sig = _sigma(t)
    return (x - denoise_fn(x, _sigma_vec(x, sig))) / float(sig)


def dpm_solver_1_step(denoise_fn, x, t, t_next, eps=None):
    h = F(t_next - t)
    eps = _eps(denoise_fn, x, t) if eps is None else eps
    return x - float(_sigma(t_next) * F(np.expm1(h))) * eps, eps


def dpm_solver_2_step(denoise_fn, x, t, t_next, r1=1 / 2, eps=None):
    h, r1 = F(t_next - t), F(r1)
    eps = _eps(denoise_fn, x, t) if eps is None else eps
    s1 = F(t + r1 * h)
    u1 = x - float(_sigma(s1) * F(np.expm1(r1 * h))) * eps
    eps_r1 = _eps(denoise_fn, u1, s1)
    em = F(np.expm1(h))
    x2 = (x - float(_sigma(t_next) * em) * eps
          - float(_sigma(t_next) / (F(2) * r1) * em) * (eps_r1 - eps))
    return x2, eps, eps_r1


def dpm_solver_3_step(denoise_fn, x, t, t_next, r1=1 / 3, r2=2 / 3, eps=None,
                      eps_r1=None):
    h, r1, r2 = F(t_next - t), F(r1), F(r2)
    eps = _eps(denoise_fn, x, t) if eps is None else eps
    s1, s2 = F(t + r1 * h), F(t + r2 * h)
    if eps_r1 is None:
        u1 = x - float(_sigma(s1) * F(np.expm1(r1 * h))) * eps
        eps_r1 = _eps(denoise_fn, u1, s1)
    em2 = F(np.expm1(r2 * h))
    u2 = (x - float(_sigma(s2) * em2) * eps
          - float(_sigma(s2) * (r2 / r1) * (em2 / (r2 * h) - F(1))) * (eps_r1 - eps))
    eps_r2 = _eps(denoise_fn, u2, s2)
    em = F(np.expm1(h))
    x3 = (x - float(_sigma(t_next) * em) * eps
          - float(_sigma(t_next) / r2 * (em / h - F(1))) * (eps_r2 - eps))
    return x3, eps


def _ancestral_t(t, t_next, t_end, eta):
    """The noise-reduced target t and the noise scale of an eta > 0 step."""
    sd, _ = get_ancestral_step(_sigma(t), _sigma(t_next), eta)
    t_next_ = min(F(t_end), _t(sd))
    su = F(np.sqrt(max(_sigma(t_next) ** 2 - _sigma(t_next_) ** 2, F(0))))
    return t_next_, su


def sample_dpm_fast(denoise_fn: DenoiseFn, x, sigma_min, sigma_max, n: int,
                    generator=None, *, eta: float = 0.0, s_noise: float = 1.0):
    """DPM-Solver-Fast with a fixed NFE budget (gc_sampling.py:582-619,675-699):
    the order plan depends only on `n`."""
    t_start, t_end = _t(sigma_max), _t(sigma_min)
    m = n // 3 + 1
    ts = t_start + (t_end - t_start) * (np.arange(m + 1, dtype=np.float32) / F(m))
    if n % 3 == 0:
        orders = [3] * (m - 2) + [2, 1]
    else:
        orders = [3] * (m - 1) + [n % 3]
    for i, order in enumerate(orders):
        t, t_next = ts[i], ts[i + 1]
        t_next_, su = _ancestral_t(t, t_next, t_end, eta) if eta else (t_next, F(0))
        if order == 1:
            x, _ = dpm_solver_1_step(denoise_fn, x, t, t_next_)
        elif order == 2:
            x, _, _ = dpm_solver_2_step(denoise_fn, x, t, t_next_)
        else:
            x, _ = dpm_solver_3_step(denoise_fn, x, t, t_next_)
        if eta:
            x = x + float(su * F(s_noise)) * samplers.sampler_noise(x, generator, i)
    return x


def sample_dpm_adaptive(denoise_fn: DenoiseFn, x, sigma_min, sigma_max,
                        generator=None, *, order: int = 3, rtol: float = 0.05,
                        atol: float = 0.0078, h_init: float = 0.05, pcoeff: float = 0.0,
                        icoeff: float = 1.0, dcoeff: float = 0.0,
                        accept_safety: float = 0.81, eta: float = 0.0,
                        s_noise: float = 1.0, max_steps: int = 1000,
                        return_info: bool = False):
    """DPM-Solver-12/23 with PID step-size control
    (gc_sampling.py:498-524,621-672,855-892). With `return_info`, returns
    (x, {"n_accept", "n_reject", "steps"})."""
    if order not in (2, 3):
        raise ValueError("order should be 2 or 3")
    if sigma_min <= 0 or sigma_max <= 0:
        raise ValueError("sigma_min and sigma_max must not be 0")
    t_start, t_end = _t(sigma_max), _t(sigma_min)
    pid_order = 1.5 if eta else order
    b1 = F((pcoeff + icoeff + dcoeff) / pid_order)
    b2 = F(-(pcoeff + 2 * dcoeff) / pid_order)
    b3 = F(dcoeff / pid_order)
    numel = float(x.numel())
    x_prev, s, h = x, t_start, F(abs(h_init))
    errs = None
    n_acc = n_rej = i = 0
    while s < t_end - F(1e-5) and i < max_steps:
        t = min(t_end, F(s + h))
        t_, su = _ancestral_t(s, t, t_end, eta) if eta else (t, F(0))
        eps0 = _eps(denoise_fn, x, s)
        if order == 2:
            x_low, _ = dpm_solver_1_step(denoise_fn, x, s, t_, eps=eps0)
            x_high, _, _ = dpm_solver_2_step(denoise_fn, x, s, t_, eps=eps0)
        else:
            x_low, _, eps_r1 = dpm_solver_2_step(denoise_fn, x, s, t_, r1=1 / 3, eps=eps0)
            x_high, _ = dpm_solver_3_step(denoise_fn, x, s, t_, eps=eps0, eps_r1=eps_r1)
        delta = torch.clamp(rtol * torch.maximum(x_low.abs(), x_prev.abs()), min=atol)
        # the iteration's one device read
        error = F(torch.linalg.vector_norm((x_low - x_high) / delta).item()) / F(numel ** 0.5)
        inv_error = F(1.0) / (error + F(1e-8))
        errs = [inv_error] + (errs[1:] if errs is not None else [inv_error] * 2)
        factor = errs[0] ** b1 * errs[1] ** b2 * errs[2] ** b3
        factor = F(F(1.0) + np.arctan(factor - F(1.0)))       # PID limiter
        h = F(h * factor)
        if factor >= F(accept_safety):
            errs = [errs[0], errs[0], errs[1]]
            x_prev, s = x_low, t
            x = x_high
            if eta:
                x = x + float(su * F(s_noise)) * samplers.sampler_noise(x, generator, i)
            n_acc += 1
        else:
            n_rej += 1
        i += 1
    if return_info:
        return x, {"n_accept": n_acc, "n_reject": n_rej, "steps": i}
    return x
