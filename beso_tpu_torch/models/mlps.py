"""Generic MLP score networks (torch port of `beso_tpu/models/mlps.py`).

Functional parity targets: `MLPNetwork` / `ResidualMLPNetwork`
(`beso/networks/mlps/mlps.py:11-134`) and the IBC-style two-layer
pre-activation residual block (`beso/networks/mlps/res_layers.py:7-45`).
As in the JAX package, the reference's spectral-norm option is left out
(the shipped configs do not use it), and 'tanh' is tanh (the reference's
activation table returned Sigmoid for it, `networks/utils.py:37-38`).

Linear layers take flax's initialisation (`models/gpt.py::_lecun_linear`:
lecun-normal weights, zero biases) from an explicit `torch.Generator`; the
input width, which flax infers, is an argument. `models/convert.py::
mlp_entries` names the layers as the flax modules do.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

from beso_tpu_torch.models.gpt import _lecun_linear

ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # flax nn.gelu's default
    "silu": F.silu,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
}


class MLPNetwork(nn.Module):
    """Plain MLP (mlps.py:11-73): `num_hidden_layers` activated Linear
    layers, then a Linear output."""

    def __init__(self, input_dim: int, hidden_dim: int = 100, num_hidden_layers: int = 1,
                 output_dim: int = 1, activation: str = "relu", generator=None, device=None):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        dims = [input_dim] + [hidden_dim] * num_hidden_layers
        self.hidden = nn.ModuleList(_lecun_linear(i, o, generator, device)
                                    for i, o in zip(dims[:-1], dims[1:]))
        self.out = _lecun_linear(dims[-1], output_dim, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lin in self.hidden:
            x = self.act(lin(x))
        return self.out(x)


class TwoLayerPreActivationResNetLinear(nn.Module):
    """IBC-style pre-activation residual block (res_layers.py:7-45)."""

    def __init__(self, hidden_dim: int, activation: str = "relu", generator=None,
                 device=None):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.l1 = _lecun_linear(hidden_dim, hidden_dim, generator, device)
        self.l2 = _lecun_linear(hidden_dim, hidden_dim, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.l2(self.act(self.l1(self.act(x))))


class ResidualMLPNetwork(nn.Module):
    """MLP with residual blocks (mlps.py:76-134): Linear in, max(1,
    num_hidden_layers // 2) residual blocks, Linear out."""

    def __init__(self, input_dim: int, hidden_dim: int = 100, num_hidden_layers: int = 1,
                 output_dim: int = 1, activation: str = "relu", generator=None, device=None):
        super().__init__()
        self.inp = _lecun_linear(input_dim, hidden_dim, generator, device)
        self.blocks = nn.ModuleList(
            TwoLayerPreActivationResNetLinear(hidden_dim, activation, generator, device)
            for _ in range(max(1, num_hidden_layers // 2)))
        self.out = _lecun_linear(hidden_dim, output_dim, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.inp(x)
        for blk in self.blocks:
            x = blk(x)
        return self.out(x)
