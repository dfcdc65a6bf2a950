"""Dataset export in the reference's on-disk formats (port of
`beso_tpu/data/export.py`).

Writes TrajectoryData out as the exact file layouts the reference consumes
(and `data/trajectories.py`'s loaders read back):
* relay-kitchen: observations_seq.npy (T x N x 60; the last 30 dims are the
  goal block the reference discards, kitchen dataloader.py:18-20),
  actions_seq.npy (T x N x 9), existence_mask.npy (T x N),
  onehot_goals.pth (T x N x 7, torch tensor);
* multimodal-push: multimodal_push_{observations,actions,masks}.npy
  (N x T x d) + onehot_goals.pth (N x T x 4).

This gives synthetic or oracle demo sets a faithful loader round trip and
makes them drop-in replacements wherever the real datasets are expected.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from beso_tpu_torch.data.trajectories import TrajectoryData


def _mask_from_lengths(lengths: np.ndarray, t_max: int) -> np.ndarray:
    return (np.arange(t_max)[None, :] < np.asarray(lengths)[:, None]).astype(np.float64)


def _goals(data: TrajectoryData) -> np.ndarray:
    if data.onehot_goals is None:
        raise ValueError("the dataset formats store one-hot goals: data.onehot_goals is None")
    return data.onehot_goals


def export_relay_kitchen(data: TrajectoryData, directory) -> Path:
    """Write relay-kitchen files (stored T x N, transposed on load)."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    goals = _goals(data)
    N, T, _ = data.observations.shape
    obs60 = np.zeros((N, T, 60), np.float64)
    obs60[:, :, :30] = data.observations
    np.save(d / "observations_seq.npy", np.transpose(obs60, (1, 0, 2)))
    np.save(d / "actions_seq.npy",
            np.transpose(data.actions.astype(np.float64), (1, 0, 2)))
    np.save(d / "existence_mask.npy",
            np.transpose(_mask_from_lengths(data.lengths, T), (1, 0)))
    torch.save(torch.from_numpy(np.ascontiguousarray(np.transpose(goals, (1, 0, 2)))),
               d / "onehot_goals.pth")
    return d


def export_multimodal_push(data: TrajectoryData, directory) -> Path:
    """Write multimodal-push files (stored N x T)."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    goals = _goals(data)
    N, T, _ = data.observations.shape
    np.save(d / "multimodal_push_observations.npy",
            data.observations.astype(np.float64))
    np.save(d / "multimodal_push_actions.npy", data.actions.astype(np.float64))
    np.save(d / "multimodal_push_masks.npy",
            _mask_from_lengths(data.lengths, T))
    torch.save(torch.from_numpy(np.ascontiguousarray(goals)), d / "onehot_goals.pth")
    return d
