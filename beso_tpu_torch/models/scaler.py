"""Data scaler (torch port of `beso_tpu/models/scaler.py`, standard kind).

Functional parity target: `Scaler` (`beso/networks/scaler/scaler_class.py:11-167`):

* standardize inputs and outputs by dataset mean/std; bounds for action
  clipping (scaled bounds when scale_data, raw min/max otherwise);
* clip_action clamps to 1.1x the action bounds (scaler_class.py:161-166);
* special input cases (scaler_class.py:79-92): a 7-dim onehot kitchen goal
  passes through unscaled; a 4-dim block-push goal is scaled with the x/y
  statistics of the two block position pairs.

The kitchen configs run with `scale_data: false`
(`configs/franka_kitchen.yaml:7`, `configs/franka_kitchen_chunked.yaml:9`),
where every map is the identity and only the raw action bounds matter. The
min-max kind (block push) waits for slice 2.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class Scaler:
    scale_data: bool
    x_mean: torch.Tensor
    x_std: torch.Tensor
    y_mean: torch.Tensor
    y_std: torch.Tensor
    x_bounds: torch.Tensor  # [2, x_dim]
    y_bounds: torch.Tensor  # [2, y_dim]

    def scale_input(self, x: torch.Tensor) -> torch.Tensor:
        if not self.scale_data:
            return x
        x_dim = self.x_mean.shape[-1]
        if x.shape[-1] == 7 and x_dim == 30:
            return x  # kitchen onehot goal passthrough (scaler_class.py:84-85)
        if x.shape[-1] == 4 and x_dim == 16:
            sel = [0, 1, 3, 4]
            return (x - self.x_mean[sel]) / (self.x_std[sel] + _EPS)
        return (x - self.x_mean) / (self.x_std + _EPS)

    def inverse_scale_input(self, x: torch.Tensor) -> torch.Tensor:
        if not self.scale_data:
            return x
        return x * (self.x_std + _EPS) + self.x_mean

    def scale_output(self, y: torch.Tensor) -> torch.Tensor:
        if not self.scale_data:
            return y
        return (y - self.y_mean) / (self.y_std + _EPS)

    def inverse_scale_output(self, y: torch.Tensor) -> torch.Tensor:
        if not self.scale_data:
            return y
        return y * (self.y_std + _EPS) + self.y_mean

    def clip_action(self, y: torch.Tensor) -> torch.Tensor:
        return torch.clamp(y, self.y_bounds[0] * 1.1, self.y_bounds[1] * 1.1)


def _flatten(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.float64)
    if a.ndim == 3:
        a = a.reshape(-1, a.shape[-1])
    return a


def fit_scaler(x_data, y_data, scale_data: bool = True,
               device=None) -> Scaler:
    """Standardizing scaler fit (scaler_class.py:15-67), in float64 on the
    host as `beso_tpu` does, stored as float32 tensors on `device`."""
    x, y = _flatten(x_data), _flatten(y_data)
    x_mean, x_std = x.mean(0), x.std(0)
    y_mean, y_std = y.mean(0), y.std(0)
    if scale_data:
        y_bounds = np.stack([(y.min(0) - y_mean) / (y_std + _EPS),
                             (y.max(0) - y_mean) / (y_std + _EPS)])
        x_bounds = np.stack([(x.min(0) - x_mean) / (x_std + _EPS),
                             (x.max(0) - x_mean) / (x_std + _EPS)])
    else:
        y_bounds = np.stack([y.min(0), y.max(0)])
        x_bounds = np.stack([x.min(0), x.max(0)])

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Scaler(scale_data=scale_data, x_mean=f32(x_mean), x_std=f32(x_std),
                  y_mean=f32(y_mean), y_std=f32(y_std),
                  x_bounds=f32(x_bounds), y_bounds=f32(y_bounds))
