"""Time/sigma embedding modules (torch port of `beso_tpu/models/embeddings.py`).

Functional parity target: the embedding factory and classes of
`beso/agents/diffusion_agents/k_diffusion/utils.py:8-134`:
{'GaussianFourier', 'Sinusoidal', 'FourierFeatures', 'Linear', 'MLP'}. The
shipped configs use 'Linear' (configs/agents/model/diffusion_gpt.yaml:23),
which DiffusionGPT computes itself; the others are here for config parity.

Each class keeps the JAX class's name, so that `models/convert.py` finds its
flax subtree (`{name}_0`). Weights are drawn from an explicit
`torch.Generator` with flax's initialisers: lecun-normal Linear weights
(`models/gpt.py::_lecun_linear`), zero biases, normal(scale) Fourier
projections. GaussianFourier's projection is fixed, as in the reference
(`requires_grad=False`, utils.py:32) and in flax's "constants" collection:
here a buffer, which the optimizer and the EMA never see.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from beso_tpu_torch.models.gpt import _lecun_linear


def mish(h: torch.Tensor) -> torch.Tensor:
    return h * torch.tanh(F.softplus(h))


class GaussianFourierProjection(nn.Module):
    """Fixed random Fourier features (utils.py:26-36)."""

    def __init__(self, embed_dim: int, scale: float = 30.0, generator=None, device=None):
        super().__init__()
        W = torch.randn(embed_dim // 2, generator=generator) * scale
        self.register_buffer("W", W.to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj = x.reshape(x.shape[0], 1) * self.W[None, :] * 2 * math.pi
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class GaussianFourierEmbedding(nn.Module):
    """Fourier features -> 2-layer Mish MLP (utils.py:69-82)."""

    def __init__(self, embed_dim: int, generator=None, device=None):
        super().__init__()
        self.proj = GaussianFourierProjection(embed_dim, generator=generator, device=device)
        self.fc1 = _lecun_linear(2 * (embed_dim // 2), 2 * embed_dim, generator, device)
        self.fc2 = _lecun_linear(2 * embed_dim, embed_dim, generator, device)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.fc2(mish(self.fc1(self.proj(t))))


class FourierFeatures(nn.Module):
    """cos/sin of a trainable random projection (utils.py:39-51)."""

    def __init__(self, embed_dim: int, std: float = 1.0, generator=None, device=None):
        super().__init__()
        w = torch.randn(embed_dim // 2, 1, generator=generator) * std
        self.weight = nn.Parameter(w.to(device))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        f = 2 * math.pi * t.reshape(t.shape[0], 1) @ self.weight.T
        return torch.cat([torch.cos(f), torch.sin(f)], dim=-1)


class SinusoidalPosEmb(nn.Module):
    """Transformer-style sinusoidal embedding (utils.py:122-134)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        freq = torch.exp(torch.arange(half, device=x.device) * -(math.log(10000) / (half - 1)))
        emb = x.reshape(-1, 1) * freq[None, :]
        return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


class SinusoidalPosEmbedding(nn.Module):
    """Sinusoidal -> 2-layer Mish MLP (utils.py:85-98)."""

    def __init__(self, embed_dim: int, generator=None, device=None):
        super().__init__()
        self.pos = SinusoidalPosEmb(embed_dim)
        self.fc1 = _lecun_linear(2 * (embed_dim // 2), 2 * embed_dim, generator, device)
        self.fc2 = _lecun_linear(2 * embed_dim, embed_dim, generator, device)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.fc2(mish(self.fc1(self.pos(t))))


class MLPTimeEmbedding(nn.Module):
    """Linear -> SiLU -> Linear (utils.py:54-66)."""

    def __init__(self, embed_dim: int, generator=None, device=None):
        super().__init__()
        self.fc1 = _lecun_linear(1, 2 * embed_dim, generator, device)
        self.fc2 = _lecun_linear(2 * embed_dim, embed_dim, generator, device)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.silu(self.fc1(t.reshape(-1, 1))))


class LinearTimeEmbedding(nn.Module):
    """Linear(1, D), the shipped default (utils.py:18-19)."""

    def __init__(self, embed_dim: int, generator=None, device=None):
        super().__init__()
        self.fc = _lecun_linear(1, embed_dim, generator, device)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.fc(t.reshape(-1, 1))


EMBEDDINGS = {
    "GaussianFourier": GaussianFourierEmbedding,
    "Sinusoidal": SinusoidalPosEmbedding,
    "FourierFeatures": FourierFeatures,
    "Linear": LinearTimeEmbedding,
    "MLP": MLPTimeEmbedding,
}


def make_time_embedding(embedding_type: str, embed_dim: int, generator=None,
                        device=None) -> nn.Module:
    """Factory mirroring return_time_sigma_embedding_model (utils.py:8-23):
    [B] (or [B, 1]) f32 times -> [B, embed_dim] f32."""
    try:
        cls = EMBEDDINGS[embedding_type]
    except KeyError:
        raise ValueError(
            "Embedding not avaiable, please chose an existing one!") from None
    return cls(embed_dim, generator=generator, device=device)
