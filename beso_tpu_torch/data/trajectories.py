"""Trajectory container, seeded split, dataset loaders and synthetic data.

Port of `beso_tpu/data/trajectories.py`. Importing `beso_tpu.data` would
pull in JAX, so these are carried here as plain numpy, with torch for the
split permutation (which must reproduce the reference's `torch.randperm`
indices exactly: `beso/envs/utils.py:6-10`) and the `.pth` goal tensors.

The loaders read the reference datasets' own file layouts (`data/export.py`
writes them):
* relay kitchen (`beso/envs/franka_kitchen/dataloader.py:15-59`):
  observations_seq.npy (T x N x 60, keep [..., :30]), actions_seq.npy (9-dim),
  existence_mask.npy, onehot_goals.pth (7 tasks), transposed to N x T;
* multimodal block push (`beso/envs/block_pushing/data/dataloader.py:50-103`):
  multimodal_push_{observations,actions,masks}.npy (obs 16-dim, optional
  [..., :10] reduction), onehot_goals.pth (4 tasks).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TrajectoryData:
    """Padded trajectory arrays, host-side numpy."""

    observations: np.ndarray          # [N, Tmax, obs_dim]
    actions: np.ndarray               # [N, Tmax, act_dim]
    lengths: np.ndarray               # [N] int32 valid lengths
    onehot_goals: Optional[np.ndarray] = None  # [N, Tmax, K]

    @property
    def num_trajectories(self) -> int:
        return self.observations.shape[0]

    @property
    def obs_dim(self) -> int:
        return self.observations.shape[-1]

    @property
    def act_dim(self) -> int:
        return self.actions.shape[-1]

    def all_observations(self) -> np.ndarray:
        """Concatenated valid observations (dataloader.py:49-55)."""
        return np.concatenate(
            [self.observations[i, : self.lengths[i]] for i in range(self.num_trajectories)])

    def all_actions(self) -> np.ndarray:
        """Concatenated valid actions (dataloader.py:41-47)."""
        return np.concatenate(
            [self.actions[i, : self.lengths[i]] for i in range(self.num_trajectories)])

    def subset(self, indices) -> "TrajectoryData":
        idx = np.asarray(indices)
        return TrajectoryData(
            observations=self.observations[idx],
            actions=self.actions[idx],
            lengths=self.lengths[idx],
            onehot_goals=None if self.onehot_goals is None else self.onehot_goals[idx],
        )


def get_split_idx(n: int, seed: int, train_fraction: float = 0.95):
    """Seeded randperm split with torch-identical indices (envs/utils.py:6-10)."""
    rng = torch.Generator().manual_seed(seed)
    idx = torch.randperm(n, generator=rng).tolist()
    l_train = int(n * train_fraction)
    return idx[:l_train], idx[l_train:]


def split_trajectories(data: TrajectoryData, seed: int = 42,
                       train_fraction: float = 0.95):
    """Train/val split over whole trajectories (trajectory_loader.py:235-272)."""
    train_idx, val_idx = get_split_idx(data.num_trajectories, seed, train_fraction)
    return data.subset(train_idx), data.subset(val_idx)


def _load_pth(path: Path) -> np.ndarray:
    """A tensor saved with `torch.save` (the datasets' one-hot goals), as
    numpy; `weights_only` loading, which reads tensors and nothing that
    would run code."""
    return np.asarray(torch.load(path, map_location="cpu", weights_only=True))


def load_relay_kitchen(data_directory, onehot_goals: bool = True) -> TrajectoryData:
    """Load the relay-kitchen dataset (franka_kitchen/dataloader.py:16-36)."""
    d = Path(data_directory)
    obs = np.load(d / "observations_seq.npy")[:, :, :30]
    act = np.load(d / "actions_seq.npy")
    mask = np.load(d / "existence_mask.npy")
    # stored T x N x dim -> N x T x dim (envs/utils.py:80-81)
    obs = np.transpose(obs, (1, 0, 2)).astype(np.float32)
    act = np.transpose(act, (1, 0, 2)).astype(np.float32)
    mask = np.transpose(mask, (1, 0))
    goals = None
    if onehot_goals:
        goals = np.transpose(_load_pth(d / "onehot_goals.pth"), (1, 0, 2)).astype(np.float32)
    return TrajectoryData(obs, act, mask.sum(1).astype(np.int32), goals)


def load_multimodal_push(data_directory, onehot_goals: bool = True,
                         reduce_obs_dim: bool = False) -> TrajectoryData:
    """Load the multimodal block-push dataset (block_pushing/data/dataloader.py:50-80)."""
    d = Path(data_directory)
    obs = np.load(d / "multimodal_push_observations.npy").astype(np.float32)
    if reduce_obs_dim:
        obs = obs[:, :, :10]
    act = np.load(d / "multimodal_push_actions.npy").astype(np.float32)
    mask = np.load(d / "multimodal_push_masks.npy")
    goals = None
    if onehot_goals:
        goals = _load_pth(d / "onehot_goals.pth").astype(np.float32)
    return TrajectoryData(obs, act, mask.sum(1).astype(np.int32), goals)


def synthetic_kitchen_data(n_traj: int = 32, t_max: int = 120,
                           seed: int = 0) -> TrajectoryData:
    """Smooth random trajectories with the kitchen shapes (obs 30, act 9,
    7 onehot tasks), drawn exactly as `beso_tpu`'s stand-in for the
    unvendored relay-kitchen dataset."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(t_max // 2, t_max + 1, size=n_traj).astype(np.int32)
    obs = np.zeros((n_traj, t_max, 30), np.float32)
    act = np.zeros((n_traj, t_max, 9), np.float32)
    goals = np.zeros((n_traj, t_max, 7), np.float32)
    for i in range(n_traj):
        T = lengths[i]
        # smooth random walk
        a = rng.randn(T, 9).astype(np.float32) * 0.3
        act[i, :T] = np.clip(np.cumsum(a, 0) * 0.1 + a, -1, 1)
        o = rng.randn(30) + np.cumsum(rng.randn(T, 30) * 0.05, 0)
        obs[i, :T] = o
        # 2-4 tasks "completed" at increasing frames
        n_tasks = rng.randint(2, 5)
        tasks = rng.choice(7, size=n_tasks, replace=False)
        frames = np.sort(rng.choice(np.arange(T // 4, T), n_tasks, replace=False))
        for task, f in zip(tasks, frames):
            goals[i, f:, task] = 0.0
            goals[i, f, task] = 1.0
    return TrajectoryData(obs, act, lengths, goals)


def synthetic_push_data(n_traj: int = 32, t_max: int = 80, obs_dim: int = 16,
                        seed: int = 0) -> TrajectoryData:
    """Smooth random trajectories with block-push shapes (obs 16, act 2,
    4 onehot tasks), drawn exactly as `beso_tpu`'s stand-in for the
    unvendored multimodal block-push dataset."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(t_max // 2, t_max + 1, size=n_traj).astype(np.int32)
    obs = np.zeros((n_traj, t_max, obs_dim), np.float32)
    act = np.zeros((n_traj, t_max, 2), np.float32)
    goals = np.zeros((n_traj, t_max, 4), np.float32)
    for i in range(n_traj):
        T = lengths[i]
        act[i, :T] = np.clip(rng.randn(T, 2) * 0.02, -0.1, 0.1)
        obs[i, :T] = rng.randn(obs_dim) * 0.2 + np.cumsum(rng.randn(T, obs_dim) * 0.01, 0)
        n_tasks = rng.randint(1, 3)
        tasks = rng.choice(4, size=n_tasks, replace=False)
        frames = np.sort(rng.choice(np.arange(T // 4, T), n_tasks, replace=False))
        for task, f in zip(tasks, frames):
            goals[i, f, task] = 1.0
    return TrajectoryData(obs, act, lengths, goals)
