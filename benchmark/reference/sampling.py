"""Classifier-free guidance, the exponential sigma grid and the sampler
steps the benchmark's rollouts use, and the data scaler, in plain PyTorch
and numpy.

CFG stacks the conditional rows and the unconditional ones (goals zeroed)
and returns out_u + lambda (out_c - out_u). DDIM steps
x <- (s'/s) x - (s'/s - 1) D to the next grid sigma s' and ends at D;
Euler steps x <- x + (s' - s_hat) (x - D) / s_hat from the churned sigma
s_hat, and its last step, to s' = 0, is again x <- D.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def exponential_grid(n: int, sigma_min: float, sigma_max: float) -> np.ndarray:
    """n sigmas from sigma_max down to sigma_min, geometric, then 0 (f32)."""
    s = np.exp(np.linspace(math.log(sigma_max), math.log(sigma_min), n))
    return np.concatenate([s, [0.0]]).astype(np.float32)


def cfg_combine(out: torch.Tensor, cond_lambda: float) -> torch.Tensor:
    """The guided prediction from a stacked [cond; uncond] output."""
    if cond_lambda == 1.0:
        return out
    B = out.shape[0] // 2
    return out[B:] + cond_lambda * (out[:B] - out[B:])


def ddim_step(x, denoised, sigma, sigma_next):
    ratio = np.float32(sigma_next) / np.float32(sigma)
    return float(ratio) * x - float(ratio - np.float32(1.0)) * denoised


class Scaler:
    """The BESO standard scaler: (x - mean) / (std + 1e-12) when
    `scale_data`, else the identity; actions clipped to 1.1 x the bounds of
    the (scaled) training actions."""

    def __init__(self, obs: np.ndarray, act: np.ndarray, scale_data: bool, device):
        obs = obs.reshape(-1, obs.shape[-1]).astype(np.float64)
        act = act.reshape(-1, act.shape[-1]).astype(np.float64)
        self.scale_data = scale_data
        eps = 1e-12

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.x_mean, self.x_std = t(obs.mean(0)), t(obs.std(0))
        self.y_mean, self.y_std = t(act.mean(0)), t(act.std(0))
        if scale_data:
            lo = (act.min(0) - act.mean(0)) / (act.std(0) + eps)
            hi = (act.max(0) - act.mean(0)) / (act.std(0) + eps)
        else:
            lo, hi = act.min(0), act.max(0)
        self.y_lo, self.y_hi = t(lo), t(hi)
        self.eps = eps

    def scale_input(self, x):
        return (x - self.x_mean) / (self.x_std + self.eps) if self.scale_data else x

    def scale_output(self, y):
        return (y - self.y_mean) / (self.y_std + self.eps) if self.scale_data else y

    def inverse_scale_output(self, y):
        return y * (self.y_std + self.eps) + self.y_mean if self.scale_data else y

    def clip_action(self, y):
        return torch.clamp(y, self.y_lo * 1.1, self.y_hi * 1.1)
