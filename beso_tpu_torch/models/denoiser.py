"""Karras-EDM denoiser wrapper (torch port of `beso_tpu/models/denoiser.py`).

Functional parity target: GCDenoiser.forward
(`beso/agents/diffusion_agents/k_diffusion/score_wrappers.py:81-96`):

    D(x, sigma) = inner(s, x*c_in, g, sigma) * c_out + x * c_skip

The training loss waits for the training slice.
"""

from __future__ import annotations

import torch

from beso_tpu_torch.core.precond import append_dims, edm_scalings


def precondition(inner, states, actions, goals, sigma, sigma_data, **kwargs):
    """EDM-preconditioned call of `inner(states, actions, goals, sigma)`."""
    c_skip, c_out, c_in = [append_dims(c, actions.ndim)
                           for c in edm_scalings(sigma, sigma_data)]
    out = inner(states, actions * c_in, goals, sigma, **kwargs)
    return out * c_out + actions * c_skip


class GCDenoiser:
    """An inner DiffusionGPT bundled with EDM preconditioning."""

    def __init__(self, inner_model, sigma_data: float = 0.5):
        self.inner_model = inner_model
        self.sigma_data = sigma_data

    @torch.no_grad()
    def __call__(self, states, actions, goals, sigma, **kwargs) -> torch.Tensor:
        return precondition(self.inner_model, states, actions, goals, sigma,
                            self.sigma_data, **kwargs)
