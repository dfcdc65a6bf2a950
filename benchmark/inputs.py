"""What the benchmark makes from `--seed` and hands to both the program and
the reference: the synthetic kitchen trajectories (the relay-kitchen data
are not in the repository), the rollout goals and the weights.

`synthetic_kitchen_data` is a copy of the port's generator, so the data do
not move when the program changes. The weights are drawn on the device
from the seed in one call and cut into the leaves of
`reference.model.weight_shapes`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from benchmark.reference.model import weight_shapes


class Trajectories(NamedTuple):
    observations: np.ndarray   # [N, Tmax, 30]
    actions: np.ndarray        # [N, Tmax, 9]
    lengths: np.ndarray        # [N] int32
    onehot_goals: np.ndarray   # [N, Tmax, 7]

    def valid(self, a: np.ndarray) -> np.ndarray:
        return np.concatenate([a[i, :n] for i, n in enumerate(self.lengths)])


def numpy_seed(seed: int) -> int:
    """A seed for numpy's RandomState (32 bits) from any whole number."""
    return int(seed) % (2 ** 32)


def synthetic_kitchen_data(n_traj: int, t_max: int, seed: int) -> Trajectories:
    """Smooth random trajectories with the kitchen shapes (obs 30, act 9,
    7 onehot tasks)."""
    rng = np.random.RandomState(numpy_seed(seed))
    lengths = rng.randint(t_max // 2, t_max + 1, size=n_traj).astype(np.int32)
    obs = np.zeros((n_traj, t_max, 30), np.float32)
    act = np.zeros((n_traj, t_max, 9), np.float32)
    goals = np.zeros((n_traj, t_max, 7), np.float32)
    for i in range(n_traj):
        T = lengths[i]
        a = rng.randn(T, 9).astype(np.float32) * 0.3
        act[i, :T] = np.clip(np.cumsum(a, 0) * 0.1 + a, -1, 1)
        obs[i, :T] = rng.randn(30) + np.cumsum(rng.randn(T, 30) * 0.05, 0)
        n_tasks = rng.randint(2, 5)
        tasks = rng.choice(7, size=n_tasks, replace=False)
        frames = np.sort(rng.choice(np.arange(T // 4, T), n_tasks, replace=False))
        for task, f in zip(tasks, frames):
            goals[i, f, task] = 1.0
    return Trajectories(obs, act, lengths, goals)


def rollout_goals(data: Trajectories, n_envs: int, goal_len: int, seed: int):
    """Goals [n_envs, G, 30], the last G frames of a trajectory drawn for
    each env, and the expected tasks [n_envs, 7] (those the trajectory
    completes)."""
    rng = np.random.RandomState(numpy_seed(seed) ^ 0x5EED)
    pick = rng.randint(0, len(data.lengths), size=n_envs)
    ends = data.lengths[pick]
    idx = ends[:, None] - goal_len + np.arange(goal_len)[None, :]
    goals = data.observations[pick[:, None], idx]
    expected = (data.onehot_goals[pick].max(axis=1) > 0).astype(np.float32)
    return goals.astype(np.float32), expected


def weight_scale(name: str, shape) -> tuple:
    """(mean, std) of a leaf's draws: Linear weights at 1/sqrt(fan_in)
    (0.02 for the embeddings and the position table, as BESO initialises
    them), biases at 0.02, LayerNorm scales at 1 +- 0.1 and shifts at 0.02:
    every leaf non-zero, so every term of the forward and the backward is
    exercised."""
    if name.endswith("ln1.weight") or name.endswith("ln2.weight") or name == "ln_f.weight":
        return 1.0, 0.1
    if name.endswith(".bias") or "ln" in name:
        return 0.0, 0.02
    if name == "pos_emb" or "emb" in name:
        return 0.0, 0.02
    return 0.0, 1.0 / math.sqrt(shape[-1])


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Name -> float32 tensor on `device`, drawn from `seed` in one call."""
    shapes = weight_shapes(cfg)
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device).manual_seed(int(seed) ^ 0x3E1A)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, i = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        mean, std = weight_scale(name, shape)
        out[name] = (flat[i:i + n] * std + mean).reshape(shape)
        i += n
    return out


def expect_seed(seed: Optional[int]) -> int:
    if seed is None or int(seed) < 0:
        raise ValueError("--seed must be a whole number >= 0")
    return int(seed)
