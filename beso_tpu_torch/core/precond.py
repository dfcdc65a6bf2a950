"""Karras-EDM preconditioner math (torch port of `beso_tpu/core/precond.py`).

Functional parity target: GCDenoiser.get_scalings
(`beso/agents/diffusion_agents/k_diffusion/score_wrappers.py:40-43`).
"""

from __future__ import annotations

import torch


def append_dims(x: torch.Tensor, target_ndim: int) -> torch.Tensor:
    """Right-pad `x` with singleton dims until it has `target_ndim` dims
    (reference utils.py:165-170)."""
    dims_to_append = target_ndim - x.ndim
    if dims_to_append < 0:
        raise ValueError(f"input has {x.ndim} dims but target_ndim is {target_ndim}")
    return x[(...,) + (None,) * dims_to_append]


def edm_scalings(sigma: torch.Tensor, sigma_data: float = 1.0):
    """EDM preconditioning coefficients (score_wrappers.py:40-43).

    c_skip = sigma_d^2 / (sigma^2 + sigma_d^2)
    c_out  = sigma * sigma_d / sqrt(sigma^2 + sigma_d^2)
    c_in   = 1 / sqrt(sigma^2 + sigma_d^2)
    """
    var = sigma ** 2 + sigma_data ** 2
    c_skip = sigma_data ** 2 / var
    c_out = sigma * sigma_data / torch.sqrt(var)
    c_in = 1.0 / torch.sqrt(var)
    return c_skip, c_out, c_in
