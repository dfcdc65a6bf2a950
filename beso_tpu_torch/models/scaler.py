"""Data scalers (torch port of `beso_tpu/models/scaler.py`).

Functional parity targets: `Scaler` and `MinMaxScaler`
(`beso/networks/scaler/scaler_class.py:11-338`):

* standard (`fit_scaler`): standardize inputs and outputs by dataset
  mean/std; bounds for action clipping (scaled bounds when scale_data, raw
  min/max otherwise);
* min-max (`fit_minmax_scaler`, the block-push configs): outputs map to
  [-1, 1] by the dataset min/max, and the action bounds become exactly +-1;
  inputs still standardize (scaler_class.py:214-233, 266-280), while
  `inverse_scale_input` maps back from [-1, 1]. That asymmetry is the JAX
  package's, kept for parity;
* clip_action clamps to 1.1x the action bounds (scaler_class.py:161-166);
* special input cases (scaler_class.py:79-92): a 7-dim onehot kitchen goal
  passes through unscaled; a 4-dim block-push goal is scaled with the x/y
  statistics of the two block position pairs.

Fitting runs in float64 on the host, as in `beso_tpu`; the fitted tensors
are float32 on `device`. The kitchen configs run with `scale_data: false`
(`configs/franka_kitchen.yaml:7`), where every map is the identity and
only the raw action bounds matter.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class Scaler:
    kind: str  # 'standard' | 'minmax'
    scale_data: bool
    x_mean: torch.Tensor
    x_std: torch.Tensor
    y_mean: torch.Tensor
    y_std: torch.Tensor
    x_min: torch.Tensor
    x_max: torch.Tensor
    y_min: torch.Tensor
    y_max: torch.Tensor
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
        if self.kind == "minmax":
            return (x + 1.0) / 2.0 * (self.x_max - self.x_min) + self.x_min
        return x * (self.x_std + _EPS) + self.x_mean

    def scale_output(self, y: torch.Tensor) -> torch.Tensor:
        if not self.scale_data:
            return y
        if self.kind == "minmax":
            return (y - self.y_min) / (self.y_max - self.y_min) * 2.0 - 1.0
        return (y - self.y_mean) / (self.y_std + _EPS)

    def inverse_scale_output(self, y: torch.Tensor) -> torch.Tensor:
        if not self.scale_data:
            return y
        if self.kind == "minmax":
            return (y + 1.0) / 2.0 * (self.y_max - self.y_min) + self.y_min
        return y * (self.y_std + _EPS) + self.y_mean

    def clip_action(self, y: torch.Tensor) -> torch.Tensor:
        return torch.clamp(y, self.y_bounds[0] * 1.1, self.y_bounds[1] * 1.1)


def _flatten(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.float64)
    if a.ndim == 3:
        a = a.reshape(-1, a.shape[-1])
    return a


def _make(kind, scale_data, x, y, x_bounds, y_bounds, device) -> Scaler:
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Scaler(kind=kind, scale_data=scale_data,
                  x_mean=f32(x.mean(0)), x_std=f32(x.std(0)),
                  y_mean=f32(y.mean(0)), y_std=f32(y.std(0)),
                  x_min=f32(x.min(0)), x_max=f32(x.max(0)),
                  y_min=f32(y.min(0)), y_max=f32(y.max(0)),
                  x_bounds=f32(x_bounds), y_bounds=f32(y_bounds))


def _standardized_bounds(a: np.ndarray) -> np.ndarray:
    mean, std = a.mean(0), a.std(0)
    return np.stack([(a.min(0) - mean) / (std + _EPS), (a.max(0) - mean) / (std + _EPS)])


def _raw_bounds(a: np.ndarray) -> np.ndarray:
    return np.stack([a.min(0), a.max(0)])


def fit_scaler(x_data, y_data, scale_data: bool = True, device=None) -> Scaler:
    """Standardizing scaler fit (scaler_class.py:15-67)."""
    x, y = _flatten(x_data), _flatten(y_data)
    if scale_data:
        x_bounds, y_bounds = _standardized_bounds(x), _standardized_bounds(y)
    else:
        x_bounds, y_bounds = _raw_bounds(x), _raw_bounds(y)
    return _make("standard", scale_data, x, y, x_bounds, y_bounds, device)


def fit_minmax_scaler(x_data, y_data, scale_data: bool = True, device=None) -> Scaler:
    """Min-max output scaler fit (scaler_class.py:169-239): the action
    bounds are exactly +-1 when scaling (:215-216), the input bounds stay
    standardized (:219-220)."""
    x, y = _flatten(x_data), _flatten(y_data)
    if scale_data:
        y_bounds = np.stack([-np.ones(y.shape[-1]), np.ones(y.shape[-1])])
        x_bounds = _standardized_bounds(x)
    else:
        x_bounds, y_bounds = _raw_bounds(x), _raw_bounds(y)
    return _make("minmax", scale_data, x, y, x_bounds, y_bounds, device)
