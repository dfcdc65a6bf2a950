"""DDIM sampling and the sampler dispatch (torch port of the DDIM part of
`beso_tpu/sampling/samplers.py`).

Convention as in the JAX package: `denoise_fn(x, sigma_vec) -> denoised`
closes over states and goals; `sigmas` is a descending host grid with an
appended terminal zero, shape [n+1]. The `lax.scan` over the grid becomes a
Python loop; grid values are host floats, so no step reads the device.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
ClipFn = Optional[Callable[[torch.Tensor], torch.Tensor]]


def sample_ddim(denoise_fn: DenoiseFn, x: torch.Tensor, sigmas, *,
                clip_fn: ClipFn = None) -> torch.Tensor:
    """DDIM / DPM-Solver-1 (gc_sampling.py:895-924). BESO's default sampler.

    x <- (sigma_next / sigma) * x - (sigma_next / sigma - 1) * denoised;
    the final step (sigma_next = 0) collapses to x <- denoised. The ratio is
    formed in float32, as the JAX scan forms it.
    """
    sig = np.asarray(sigmas, np.float32)
    for i in range(len(sig) - 1):
        sigma_vec = torch.full((x.shape[0],), float(sig[i]),
                               dtype=torch.float32, device=x.device)
        denoised = denoise_fn(x, sigma_vec)
        ratio = sig[i + 1] / sig[i]
        x = float(ratio) * x - float(ratio - np.float32(1.0)) * denoised
        if clip_fn is not None:
            x = clip_fn(x)
    return x


def sample_loop(sampler_type: str, denoise_fn: DenoiseFn, x: torch.Tensor,
                sigmas, *, clip_fn: ClipFn = None) -> torch.Tensor:
    """Named sampler dispatch (beso_agent.py:390-456). Only DDIM is ported;
    the other samplers are ROADMAP item A14 and raise rather than fall back."""
    if sampler_type == "ddim":
        return sample_ddim(denoise_fn, x, sigmas, clip_fn=clip_fn)
    raise NotImplementedError(
        f"sampler {sampler_type!r} is not ported to beso_tpu_torch yet "
        f"(ROADMAP.md, queue A, item A14)")
