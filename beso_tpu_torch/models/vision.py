"""Vision pooling modules for image-based policies (torch port of
`beso_tpu/models/vision.py`).

Functional parity targets (`beso/networks/vision_modules/vision_modules.py:
7-117`): CoordConv, SpatialSoftArgmax, GlobalMaxPool2d, GlobalAvgPool2d.
The modules take and return the JAX package's NHWC tensors; the conv
encoder calls the NCHW functions below on the permuted view (a contiguous
NHWC tensor permuted to NCHW is torch's `channels_last` layout).
"""

from __future__ import annotations

import torch
from torch import nn


def coord_grid(h: int, w: int, device=None):
    """(xx, yy) [h, w] of normalized pixel coordinates in [-1, 1]."""
    ys = torch.linspace(-1.0, 1.0, h, device=device)
    xs = torch.linspace(-1.0, 1.0, w, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return xx, yy


def spatial_soft_argmax_nchw(x: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, 2]: per channel the softmax-weighted expected
    (x, y) position over the pixels."""
    B, C, H, W = x.shape
    attn = torch.softmax(x.reshape(B, C, H * W) / temperature, dim=-1)
    xx, yy = coord_grid(H, W, x.device)
    return torch.stack([attn @ xx.reshape(-1).to(attn.dtype),
                        attn @ yy.reshape(-1).to(attn.dtype)], dim=-1)


class CoordConv(nn.Module):
    """Append normalized (x, y) coordinate channels to an NHWC image."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        xx, yy = coord_grid(H, W, x.device)
        coords = torch.stack([xx, yy], dim=-1).to(x.dtype).expand(B, H, W, 2)
        return torch.cat([x, coords], dim=-1)


class SpatialSoftArgmax(nn.Module):
    """Per-channel softmax-weighted expected (x, y) position of an NHWC
    map: [B, H, W, C] -> [B, C, 2] in [-1, 1]."""

    def __init__(self, temperature: float = 1.0):
        super().__init__()
        self.temperature = temperature

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return spatial_soft_argmax_nchw(x.permute(0, 3, 1, 2), self.temperature)


class GlobalMaxPool2d(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(dim=(1, 2))


class GlobalAvgPool2d(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(1, 2))
