"""Classifier-free guidance wrapper (torch port of `beso_tpu/models/cfg.py`).

Functional parity target: ClassifierFreeSampleModel
(`beso/agents/diffusion_agents/k_diffusion/classifier_free_sampler.py:12-52`):

    out = out_uncond + lambda * (out_cond - out_uncond)

The cond and uncond passes are stacked along the batch into one 2x-batch
forward, with the uncond half's goals zeroed, exactly as `beso_tpu` does;
the prefix-KV engines build their caches for that same stacked batch.

Also classifier *guided* sampling (classifier_free_sampler.py:56-90):
    out = pred + lambda * grad_a Q(s, pred, g) * sigma^2
"""

from __future__ import annotations

import torch

from beso_tpu_torch.core.precond import append_dims


def cfg_denoise_fn(denoise, cond_lambda: float):
    """Wrap `denoise(states, actions, goals, sigma) -> pred` with CFG. For
    cond_lambda == 1 / 0 it reduces to one conditional / unconditional call."""
    if cond_lambda == 1.0:
        return denoise

    if cond_lambda == 0.0:
        def uncond_fn(states, actions, goals, sigma, **kw):
            return denoise(states, actions, torch.zeros_like(goals), sigma, **kw)
        return uncond_fn

    def guided_fn(states, actions, goals, sigma, **kw):
        B = actions.shape[0]
        out = denoise(torch.cat([states, states]), torch.cat([actions, actions]),
                      torch.cat([goals, torch.zeros_like(goals)]),
                      torch.cat([sigma, sigma]), **kw)
        out_cond, out_uncond = out[:B], out[B:]
        return out_uncond + cond_lambda * (out_cond - out_uncond)

    return guided_fn


def classifier_guided_denoise_fn(denoise, guide, cond_lambda: float = 2.0):
    """Classifier-guided variant (classifier_free_sampler.py:78-87) of any
    engine's `denoise(states, actions, goals, sigma) -> pred`.

    `guide(states, actions, goals)` returns one value Q per batch row; the
    prediction moves along the gradient of sum(Q) with respect to the
    actions, taken at `pred`, scaled by lambda sigma^2. The gradient flows
    through the guide only: the denoiser runs as its caller runs it. The
    rollouts run under `torch.inference_mode`, whose tensors autograd
    cannot record, so the guide runs with inference mode off and grad on,
    on clones of its inputs made there; its own weights must be made
    outside inference mode, as a trained guide's are."""

    def guided_fn(states, actions, goals, sigma, **kw):
        pred = denoise(states, actions, goals, sigma, **kw)
        with torch.inference_mode(False), torch.enable_grad():
            a = pred.detach().clone().requires_grad_(True)
            q = guide(states.clone(), a, goals.clone())
            (grad,) = torch.autograd.grad(q.sum(), a)
        return pred + cond_lambda * grad * append_dims(sigma ** 2, actions.ndim)

    return guided_fn
