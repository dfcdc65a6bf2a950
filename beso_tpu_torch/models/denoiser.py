"""Karras-EDM denoiser wrapper (torch port of `beso_tpu/models/denoiser.py`).

Functional parity target: GCDenoiser.forward
(`beso/agents/diffusion_agents/k_diffusion/score_wrappers.py:81-96`):

    D(x, sigma) = inner(s, x*c_in, g, sigma) * c_out + x * c_skip

and the EDM training loss (score_wrappers.py:45-79):

    noised = a + n*sigma;  target = (a - c_skip*noised) / c_out
    MSE(inner(s, noised*c_in, g, sigma), target)

with the `pred_last_action_only` branch (score_wrappers.py:59-68).
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


def denoiser_loss(inner, states, actions, goals, noise, sigma,
                  sigma_data: float = 0.5, pred_last_action_only: bool = False,
                  **kwargs) -> torch.Tensor:
    """EDM training loss, a scalar (`beso_tpu/models/denoiser.py:46-69`)."""
    if pred_last_action_only:
        # only noise the final action token (score_wrappers.py:59-64)
        noise = torch.cat([torch.zeros_like(noise[:, :-1]), noise[:, -1:]], dim=1)
    noised = actions + noise * append_dims(sigma, actions.ndim)
    c_skip, c_out, c_in = [append_dims(c, actions.ndim)
                           for c in edm_scalings(sigma, sigma_data)]
    model_out = inner(states, noised * c_in, goals, sigma, **kwargs)
    target = (actions - c_skip * noised) / c_out
    if pred_last_action_only:
        return torch.mean((model_out[:, -1, :] - target[:, -1, :]) ** 2)
    return torch.mean((model_out - target) ** 2)


class GCDenoiser:
    """An inner DiffusionGPT bundled with EDM preconditioning.

    `params`, where a method takes it, is a name -> tensor dict (the EMA
    shadow, for instance) that the inner model runs with in place of its
    own parameters."""

    def __init__(self, inner_model, sigma_data: float = 0.5):
        self.inner_model = inner_model
        self.sigma_data = sigma_data

    def inner(self, params=None):
        if params is None:
            return self.inner_model
        return lambda *a, **kw: torch.func.functional_call(
            self.inner_model, params, a, kw)

    @torch.no_grad()
    def __call__(self, states, actions, goals, sigma, params=None,
                 **kwargs) -> torch.Tensor:
        return precondition(self.inner(params), states, actions, goals, sigma,
                            self.sigma_data, **kwargs)

    def loss(self, states, actions, goals, noise, sigma,
             pred_last_action_only: bool = False, params=None, **kwargs):
        """Differentiable EDM loss; kwargs (train, generator) go to the
        inner model."""
        return denoiser_loss(self.inner(params), states, actions, goals, noise,
                             sigma, self.sigma_data, pred_last_action_only,
                             **kwargs)
