"""Exponential moving average of parameters (torch port of `beso_tpu/models/ema.py`).

Functional parity target: ExponentialMovingAverage
(`beso/networks/ema_helper/ema.py:10-105`), including the warm-up
decay = min(decay, (1 + n) / (10 + n)) (ema.py:46-48), and EMAWarmup's
inverse-decay schedule (ema.py:108-141).

The shadow is a dict of tensors keyed by parameter name (the names of
`module.named_parameters()`), updated in place without autograd;
evaluation runs the model with these tensors in place of its own
(`torch.func.functional_call`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class EmaState:
    params: Dict[str, torch.Tensor]   # shadow parameters
    num_updates: int = 0


def ema_init(named_params: Iterable[Tuple[str, torch.Tensor]]) -> EmaState:
    return EmaState({n: p.detach().clone() for n, p in named_params}, 0)


@torch.no_grad()
def ema_update(state: EmaState, named_params: Iterable[Tuple[str, torch.Tensor]],
               decay: float, use_num_updates: bool = True) -> EmaState:
    """shadow <- shadow - (1 - d) * (shadow - param), d warm-up capped, in
    place. `d` is formed in float32 as the JAX package forms it."""
    n = state.num_updates + 1
    f32 = np.float32
    d = f32(decay)
    if use_num_updates:
        d = min(d, (f32(1.0) + f32(n)) / (f32(10.0) + f32(n)))
    one_minus = float(f32(1.0) - d)
    params = dict(named_params)
    shadow = list(state.params.values())
    diff = torch._foreach_sub(shadow, [params[k].detach() for k in state.params])
    torch._foreach_mul_(diff, one_minus)
    torch._foreach_sub_(shadow, diff)
    state.num_updates = n
    return state


class EMAWarmup:
    """Inverse-decay EMA warm-up schedule (ema.py:108-141).

    decay(epoch) = clip(1 - (1 + epoch / inv_gamma)^-power, min_value, max_value)
    """

    def __init__(self, inv_gamma: float = 1.0, power: float = 1.0,
                 min_value: float = 0.0, max_value: float = 1.0,
                 start_at: int = 0, last_epoch: int = 0):
        self.inv_gamma = inv_gamma
        self.power = power
        self.min_value = min_value
        self.max_value = max_value
        self.start_at = start_at
        self.last_epoch = last_epoch

    def get_value(self) -> float:
        epoch = max(0, self.last_epoch - self.start_at)
        value = 1 - (1 + epoch / self.inv_gamma) ** -self.power
        return 0.0 if epoch < 0 else min(self.max_value, max(self.min_value, value))

    def step(self) -> None:
        self.last_epoch += 1
