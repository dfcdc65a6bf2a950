"""Classifier-free guidance wrapper (torch port of `beso_tpu/models/cfg.py`).

Functional parity target: ClassifierFreeSampleModel
(`beso/agents/diffusion_agents/k_diffusion/classifier_free_sampler.py:12-52`):

    out = out_uncond + lambda * (out_cond - out_uncond)

The cond and uncond passes are stacked along the batch into one 2x-batch
forward, with the uncond half's goals zeroed, exactly as `beso_tpu` does;
the prefix-KV engines build their caches for that same stacked batch.
"""

from __future__ import annotations

import torch


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
