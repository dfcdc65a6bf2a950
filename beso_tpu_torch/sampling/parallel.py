"""Parallel (Picard-iteration) diffusion sampling (torch port of
`beso_tpu/sampling/parallel.py`).

No reference equivalent: ParaDiGMS-style parallel sampling (Shih et al.
2023, arXiv:2305.16317). Instead of stepping the sampling recursion through
the n-point sigma grid, hold the whole trajectory {x_i} and iterate Picard
fixed-point sweeps

    D_i^k         = denoise(x_i^k, sigma_i)              (all i, one call)
    x_{i+1}^{k+1} = step(x_i^{k+1}, sigma_i, D_i^k)      (elementwise)

Each sweep evaluates the model once per grid point, batched as one [n*B]
forward with per-row sigmas, so the sequential depth drops from n model
calls to K sweeps; K = n gives the sequential sampler's result. The update
rules are 'euler' (probability-flow Euler, gc_sampling.py:167-213 without
churn) and 'ddim' (gc_sampling.py:916-924).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from beso_tpu_torch.sampling.samplers import F, to_d


def _resweep(update: str, X, D, sig):
    """One Picard sweep: rebuild the trajectory from X[0] with the current
    denoiser evaluations D_i."""
    xs = [X[0]]
    for i in range(len(sig) - 1):
        sigma, sigma_next = sig[i], sig[i + 1]
        if update == "euler":
            # d depends on the point the denoiser was evaluated at, X[i]
            x_new = xs[-1] + to_d(X[i], sigma, D[i]) * float(sigma_next - sigma)
        else:
            ratio = sigma_next / sigma
            x_new = float(ratio) * xs[-1] - float(ratio - F(1.0)) * D[i]
        xs.append(x_new)
    return torch.stack(xs)


def sample_picard(denoise_fn, x, sigmas, generator=None, *, update: str = "ddim",
                  n_iterations: Optional[int] = None, clip_fn=None) -> torch.Tensor:
    """Parallel sampling over the sigma grid; returns x at sigma = 0.

    `denoise_fn(x, sigma)` as for the sequential samplers, but it must take
    a folded batch of n*B rows, grid point major (a conditioned closure
    tiles its conditioning over the leading axis: `Tensor.repeat`), with a
    per-row sigma vector. `n_iterations` defaults to n (exact); fewer trade
    accuracy for sequential depth. `generator` is unused: Picard draws
    nothing.
    """
    del generator
    if update not in ("euler", "ddim"):
        raise ValueError(f"unsupported update rule {update!r}")
    sig = np.asarray(sigmas, dtype=np.float32)
    n, B = len(sig) - 1, x.shape[0]
    K = n if n_iterations is None else int(n_iterations)
    # the folded batch's per-row sigmas: grid point i for rows i*B .. i*B+B-1
    sig_rows = torch.as_tensor(sig[:-1], device=x.device).repeat_interleave(B)
    X = x[None].expand((n + 1,) + x.shape)        # warm start: x everywhere
    for _ in range(K):
        D = denoise_fn(X[:-1].reshape((n * B,) + x.shape[1:]), sig_rows)
        X = _resweep(update, X, D.reshape((n,) + x.shape), sig)
        if clip_fn is not None:
            X = torch.cat([X[:1], clip_fn(X[1:])])
    return X[-1]
