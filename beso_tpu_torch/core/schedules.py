"""Noise (sigma) schedules for Karras-style continuous diffusion.

Functional parity targets: the eight `get_sigmas_*` grids of the reference
(`beso/agents/diffusion_agents/k_diffusion/gc_sampling.py:22-95`). Every grid
is a descending sequence of `n` positive sigmas terminated with an appended
zero, returned as a float32 numpy array of length n + 1.

Plain numpy, as in `beso_tpu/core/schedules.py`: the grids are host-side
constants that the samplers walk with a Python loop.
"""

from __future__ import annotations

import math

import numpy as np


def append_zero(sigmas) -> np.ndarray:
    """Append a terminal 0 to a sigma grid (reference gc_sampling.py:22-23).

    Returns a host (numpy) array: the samplers read each grid value as a
    Python float, so no step of the sampling loop reads the device.
    """
    sigmas = np.asarray(sigmas, dtype=np.float32)
    return np.concatenate([sigmas, np.zeros((1,), dtype=sigmas.dtype)])


def get_sigmas_karras(n: int, sigma_min: float, sigma_max: float, rho: float = 7.0) -> np.ndarray:
    """Karras et al. (2022) rho-ramp schedule (gc_sampling.py:26-32)."""
    ramp = np.linspace(0, 1, n)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return append_zero(sigmas)


def get_sigmas_exponential(n: int, sigma_min: float, sigma_max: float) -> np.ndarray:
    """Exponential (geometric) schedule (gc_sampling.py:35-38). BESO's default."""
    sigmas = np.exp(np.linspace(math.log(sigma_max), math.log(sigma_min), n))
    return append_zero(sigmas)


def get_sigmas_linear(n: int, sigma_min: float, sigma_max: float) -> np.ndarray:
    """Linear schedule (gc_sampling.py:41-44)."""
    sigmas = np.linspace(sigma_max, sigma_min, n)
    return append_zero(sigmas)


def cosine_beta_schedule(n: int, s: float = 0.008) -> np.ndarray:
    """Cosine beta schedule of Nichol & Dhariwal, flipped + zero-terminated
    (gc_sampling.py:47-58). Note: the reference returns *betas*, not sigmas;
    we keep that behavior for parity.
    """
    steps = n + 1
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    betas_clipped = np.clip(betas, 0, 0.999)
    return append_zero(np.flip(betas_clipped).copy())


def get_sigmas_ve(n: int, sigma_min: float = 0.02, sigma_max: float = 100.0) -> np.ndarray:
    """Variance-exploding schedule (gc_sampling.py:61-68)."""
    t = np.linspace(0, n + 1, n)
    t = (sigma_max ** 2) * ((sigma_min ** 2 / sigma_max ** 2) ** (t / (n - 1)))
    return append_zero(np.sqrt(t))


def get_iddpm_sigmas(
    n: int,
    sigma_min: float = 0.02,
    sigma_max: float = 100.0,
    M: int = 1000,
    j_0: int = 0,
    C_1: float = 0.001,
    C_2: float = 0.008,
) -> np.ndarray:
    """iDDPM-style discretized schedule (gc_sampling.py:71-81)."""
    step_indices = np.arange(n, dtype=np.float64)
    u = np.zeros(M + 1, dtype=np.float64)

    def alpha_bar(j):
        return np.sin(0.5 * np.pi * j / M / (C_2 + 1)) ** 2

    for j in range(M, j_0, -1):
        u[j - 1] = np.sqrt((u[j] ** 2 + 1) / max(alpha_bar(j - 1) / alpha_bar(j), C_1) - 1)
    u_filtered = u[np.logical_and(u >= sigma_min, u <= sigma_max)]
    sigmas = u_filtered[np.round((len(u_filtered) - 1) / (n - 1) * step_indices).astype(np.int64)]
    return append_zero(sigmas)


def get_sigmas_vp(n: int, beta_d: float = 19.9, beta_min: float = 0.1, eps_s: float = 1e-3) -> np.ndarray:
    """Variance-preserving continuous schedule (gc_sampling.py:84-88)."""
    t = np.linspace(1, eps_s, n)
    sigmas = np.sqrt(np.exp(beta_d * t ** 2 / 2 + beta_min * t) - 1)
    return append_zero(sigmas)


def get_sigmas_polyexponential(n: int, sigma_min: float, sigma_max: float, rho: float = 1.0) -> np.ndarray:
    """Polynomial-in-log-sigma schedule (gc_sampling.py:91-95)."""
    ramp = np.linspace(1, 0, n) ** rho
    sigmas = np.exp(ramp * (math.log(sigma_max) - math.log(sigma_min)) + math.log(sigma_min))
    return append_zero(sigmas)


_SCHEDULES = {
    "karras": lambda n, lo, hi, rho: get_sigmas_karras(n, lo, hi, rho),
    "exponential": lambda n, lo, hi, rho: get_sigmas_exponential(n, lo, hi),
    "vp": lambda n, lo, hi, rho: get_sigmas_vp(n),
    "linear": lambda n, lo, hi, rho: get_sigmas_linear(n, lo, hi),
    "cosine_beta": lambda n, lo, hi, rho: cosine_beta_schedule(n),
    "ve": lambda n, lo, hi, rho: get_sigmas_ve(n, lo, hi),
    "iddpm": lambda n, lo, hi, rho: get_iddpm_sigmas(n, lo, hi),
}


def get_noise_schedule(
    n: int,
    sigma_min: float,
    sigma_max: float,
    rho: float = 7.0,
    schedule_type: str = "exponential",
) -> np.ndarray:
    """Named schedule dispatch mirroring BesoAgent.get_noise_schedule
    (beso_agent.py:580-598)."""
    try:
        return _SCHEDULES[schedule_type](n, sigma_min, sigma_max, rho)
    except KeyError:
        raise ValueError(f"Unknown noise schedule type: {schedule_type!r}") from None
