"""Log-likelihood of actions under the probability-flow ODE (torch port of
`beso_tpu/sampling/likelihood.py`).

Functional parity target: `log_likelihood` (gc_sampling.py:471-495), which
integrates the instantaneous change-of-variables formula with a Hutchinson
trace estimator over torchdiffeq's adaptive dopri5. As in the JAX package,
the divergence is a forward-mode directional derivative (`torch.func.jvp`
through the plain forward: the fused kernels have no forward-mode rule) and
the ODE is integrated with fixed-step RK4 over a log-spaced sigma grid;
accuracy is set by `n_steps`.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from beso_tpu_torch.sampling.samplers import F

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def rademacher_probe(x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """The Hutchinson probe: +-1 entries shaped like x, drawn from
    `generator`; the estimator's only random draw."""
    bits = torch.randint(0, 2, x.shape, generator=generator, device=x.device)
    return (bits * 2 - 1).to(x.dtype)


def log_likelihood(denoise_fn: DenoiseFn, action: torch.Tensor, sigma_min: float,
                   sigma_max: float, generator: Optional[torch.Generator] = None,
                   n_steps: int = 64):
    """Returns (log_likelihood [B], info). Integrates from sigma_min to
    sigma_max (data -> prior), like the reference (gc_sampling.py:490-495)."""
    B = action.shape[0]
    v = rademacher_probe(action, generator)

    def ode_fn(x, sigma):
        sig_vec = torch.full((B,), float(sigma), dtype=torch.float32, device=x.device)

        def drift(y):
            return (y - denoise_fn(y, sig_vec)) / float(sigma)

        d, jvp_v = torch.func.jvp(drift, (x,), (v,))
        return d, torch.sum((v * jvp_v).reshape(B, -1), dim=1)

    sigmas = np.exp(np.linspace(np.log(sigma_min), np.log(sigma_max),
                                n_steps + 1)).astype(np.float32)
    x, ll = action, torch.zeros(B, device=action.device)
    for s0, s1 in zip(sigmas[:-1], sigmas[1:]):
        h = F(s1 - s0)
        s_mid = F(s0 + F(0.5) * h)
        k1, l1 = ode_fn(x, s0)
        k2, l2 = ode_fn(x + float(F(0.5) * h) * k1, s_mid)
        k3, l3 = ode_fn(x + float(F(0.5) * h) * k2, s_mid)
        k4, l4 = ode_fn(x + float(h) * k3, s1)
        x = x + float(h / F(6.0)) * (k1 + 2 * k2 + 2 * k3 + k4)
        ll = ll + float(h / F(6.0)) * (l1 + 2 * l2 + 2 * l3 + l4)

    # prior: N(0, sigma_max^2) per dimension
    D = int(np.prod(action.shape[1:]))
    ll_prior = (torch.sum(-0.5 * (x.reshape(B, -1) / sigma_max) ** 2, dim=1)
                - 0.5 * D * float(np.log(2 * np.pi * sigma_max ** 2)))
    return ll_prior + ll, {"fevals": 4 * n_steps}
