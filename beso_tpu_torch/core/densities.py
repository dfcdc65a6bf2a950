"""Training-time sigma sample densities (torch port of `beso_tpu/core/densities.py`).

Functional parity targets: the `rand_*` family of the reference
(`beso/agents/diffusion_agents/k_diffusion/utils.py:173-220`) and the
`make_sample_density` dispatch (`beso_agent.py:540-578`).

Every density draws from an explicit `torch.Generator` and returns float32
on the generator's device (or `device`). The numbers differ from the JAX
package's for the same seed; the tests compare the distributions.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional, Sequence

import torch

SampleDensity = Callable[..., torch.Tensor]


def _device(generator: Optional[torch.Generator], device):
    if device is not None:
        return device
    return generator.device if generator is not None else None


def _uniform(generator, shape, device):
    return torch.rand(shape, generator=generator, device=_device(generator, device))


def _normal(generator, shape, device):
    return torch.randn(shape, generator=generator, device=_device(generator, device))


def rand_log_normal(generator, shape, loc: float = 0.0, scale: float = 1.0,
                    device=None):
    """Lognormal sigma density (utils.py:173-175)."""
    return torch.exp(_normal(generator, shape, device) * scale + loc)


def rand_log_logistic(generator, shape, loc: float = 0.0, scale: float = 1.0,
                      min_value: float = 0.0, max_value: float = float("inf"),
                      device=None):
    """Optionally truncated log-logistic density (utils.py:178-185): BESO's
    default, with loc=log(sigma_data), scale=0.5, truncated to
    [sigma_min, sigma_max]. The truncation CDF values are host floats."""
    min_cdf = _sigmoid((math.log(min_value) - loc) / scale) if min_value > 0 else 0.0
    max_cdf = (_sigmoid((math.log(max_value) - loc) / scale)
               if max_value != float("inf") else 1.0)
    u = _uniform(generator, shape, device) * (max_cdf - min_cdf) + min_cdf
    return torch.exp((torch.log(u) - torch.log1p(-u)) * scale + loc)


def _sigmoid(x: float) -> float:
    return 1.0 / (1.0 + math.exp(-x))


def rand_log_uniform(generator, shape, min_value: float, max_value: float,
                     device=None):
    """Log-uniform density (utils.py:188-192)."""
    lo, hi = math.log(min_value), math.log(max_value)
    return torch.exp(_uniform(generator, shape, device) * (hi - lo) + lo)


def rand_uniform(generator, shape, min_value: float, max_value: float,
                 device=None):
    """Uniform density (utils.py:195-197)."""
    return _uniform(generator, shape, device) * (max_value - min_value) + min_value


def rand_discrete(generator, shape, values: Sequence[float], device=None):
    """Uniform choice over a discrete sigma grid (utils.py:200-202)."""
    dev = _device(generator, device)
    values = torch.as_tensor(values, dtype=torch.float32, device=dev)
    idx = torch.randint(0, values.shape[0], shape, generator=generator, device=dev)
    return values[idx]


def rand_v_diffusion(generator, shape, sigma_data: float = 1.0,
                     min_value: float = 0.0, max_value: float = float("inf"),
                     device=None):
    """Truncated v-diffusion timestep density (utils.py:205-210)."""
    min_cdf = math.atan(min_value / sigma_data) * 2 / math.pi
    max_cdf = (math.atan(max_value / sigma_data) * 2 / math.pi
               if max_value != float("inf") else 1.0)
    u = _uniform(generator, shape, device) * (max_cdf - min_cdf) + min_cdf
    return torch.tan(u * math.pi / 2) * sigma_data


def rand_split_log_normal(generator, shape, loc: float, scale_1: float,
                          scale_2: float, device=None):
    """Split lognormal density (utils.py:213-220)."""
    n = torch.abs(_normal(generator, shape, device))
    u = _uniform(generator, shape, device)
    ratio = scale_1 / (scale_1 + scale_2)
    return torch.exp(torch.where(u < ratio, n * -scale_1 + loc, n * scale_2 + loc))


def make_sample_density(density_type: str, sigma_data: float, sigma_min: float,
                        sigma_max: float, loc: Optional[float] = None,
                        scale: Optional[float] = None,
                        discrete_values: Optional[Sequence[float]] = None
                        ) -> SampleDensity:
    """Build a `(generator, shape) -> sigmas` callable, as
    `beso_tpu.core.densities.make_sample_density` builds `(key, shape)`."""
    if density_type == "lognormal":
        return partial(rand_log_normal, loc=loc if loc is not None else 0.0,
                       scale=scale if scale is not None else 1.0)
    if density_type == "loglogistic":
        return partial(rand_log_logistic,
                       loc=loc if loc is not None else math.log(sigma_data),
                       scale=scale if scale is not None else 0.5,
                       min_value=sigma_min, max_value=sigma_max)
    if density_type == "loguniform":
        return partial(rand_log_uniform, min_value=sigma_min, max_value=sigma_max)
    if density_type == "uniform":
        return partial(rand_uniform, min_value=sigma_min, max_value=sigma_max)
    if density_type == "v-diffusion":
        return partial(rand_v_diffusion, sigma_data=sigma_data,
                       min_value=sigma_min, max_value=sigma_max)
    if density_type == "discrete":
        if discrete_values is None:
            raise ValueError("'discrete' density needs a sigma grid")
        return partial(rand_discrete, values=discrete_values)
    if density_type == "split-lognormal":
        return partial(rand_split_log_normal, loc=loc, scale_1=scale, scale_2=scale)
    raise ValueError(f"Unknown sample density type: {density_type!r}")
