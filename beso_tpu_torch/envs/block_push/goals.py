"""Block-push evaluation goals (torch port of
`beso_tpu/envs/block_push/goals.py`).

Functional parity target: `beso/envs/block_pushing/data/goals.py:18-116`:

* future: the goal is the final frame of train trajectory
  `train_idx[goal_idx]`, repeated `goal_seq_len` times, with the flip fix
  (goals.py:64-78): when the replayed trajectory's target-0 position lies
  more than 0.2 from the live env's target 0, the block columns
  ([0, 1] <-> [3, 4]) are swapped so that the goal matches the live layout;
  the non-block dims are zeroed (goals.py:79-80);
* onehot: the next incomplete task of the demonstrated order, a task being
  done when its block lies within 0.05 of its target (goals.py:84-114);
* expected tasks: the onehot-labeled tasks of the goal trajectory
  (block_push_workspace.py:218-240).

The goal index wraps at >= 950 (block_push_workspace.py:121-124). The goal
table and task orders are numpy on the host; the goals built from live
observations are torch on their device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from beso_tpu_torch.data.trajectories import TrajectoryData, get_split_idx

_BLOCK0 = [0, 1]
_BLOCK1 = [3, 4]
_TARGET0 = [10, 11]
_TARGET1 = [13, 14]
_ZERO_DIMS = [2, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15]


def _wrap_goal_idx(goal_idx: int) -> int:
    return goal_idx - 950 if goal_idx >= 950 else goal_idx


def _goal_trajectories(data: TrajectoryData, eval_n_times: int, seed: int,
                       train_fraction: float):
    if data.onehot_goals is None:
        raise ValueError("block-push evaluation needs onehot task labels")
    train_idx, _ = get_split_idx(data.num_trajectories, seed, train_fraction)
    for i in range(eval_n_times):
        traj = train_idx[_wrap_goal_idx(i) % len(train_idx)]
        yield i, traj, int(data.lengths[traj])


def block_push_goal_frames(data: TrajectoryData, eval_n_times: int, seed: int,
                           train_fraction: float = 0.95
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Final-frame goal table and expected-task masks: (frames [N, obs_dim]
    f32, expected [N, 4] bool)."""
    frames = np.zeros((eval_n_times, data.obs_dim), np.float32)
    expected = np.zeros((eval_n_times, 4), bool)
    for i, traj, T in _goal_trajectories(data, eval_n_times, seed, train_fraction):
        frames[i] = data.observations[traj, T - 1]
        expected[i] = data.onehot_goals[traj, :T].max(0) > 0.5
    return frames, expected


def build_block_push_goals(obs0: torch.Tensor, goal_frames: torch.Tensor,
                           goal_seq_len: int, zero_goals: bool = True,
                           reduce_obs_dim: bool = True) -> torch.Tensor:
    """The flip fix against the live reset observations obs0 [B, 16]
    (unmasked) applied to goal_frames [B, 16]. Returns [B, G, 10] (reduced)
    or [B, G, 16]."""
    flipped = torch.linalg.vector_norm(goal_frames[:, _TARGET0] - obs0[:, _TARGET0],
                                       dim=-1) > 0.2
    swapped = goal_frames.clone()
    swapped[:, _BLOCK0] = goal_frames[:, _BLOCK1]
    swapped[:, _BLOCK1] = goal_frames[:, _BLOCK0]
    g = torch.where(flipped[:, None], swapped, goal_frames)
    if zero_goals:
        g = g.clone()
        g[:, _ZERO_DIMS] = 0.0
    g = g[:, None, :].expand(-1, goal_seq_len, -1)
    return (g[..., :10] if reduce_obs_dim else g).contiguous()


def block_push_onehot_goal(state_obs: torch.Tensor,
                           demo_order: torch.Tensor) -> torch.Tensor:
    """Next-incomplete-task onehot [B, 4] (goals.py:84-114).

    state_obs: [B, 16] live observations; demo_order: [B, 4] task ids in
    demonstrated order, -1 padded. Task 2*b + t is done when block b lies
    within 0.05 of target t; the goal is the first task not done, else the
    last of the order."""
    B = state_obs.shape[0]
    blocks = torch.stack([state_obs[:, _BLOCK0], state_obs[:, _BLOCK1]], 1)     # [B, 2, 2]
    targets = torch.stack([state_obs[:, _TARGET0], state_obs[:, _TARGET1]], 1)
    dist = torch.linalg.vector_norm(blocks[:, :, None] - targets[:, None], dim=-1)
    done = (dist < 0.05).reshape(B, 4)                                      # index 2*b + t
    order_valid = demo_order >= 0
    order_clipped = torch.clamp(demo_order, min=0).long()
    task_done = torch.gather(done, 1, order_clipped)
    open_and_valid = order_valid & ~task_done
    # first open task (first True, as jnp.argmax), else the last valid one
    ar = torch.arange(4, device=state_obs.device)
    first_open = torch.where(open_and_valid, ar, 4).amin(1)
    last_valid = order_valid.sum(1) - 1
    pick = torch.where(open_and_valid.any(1), first_open, last_valid)
    task = torch.gather(order_clipped, 1, pick[:, None].clamp(min=0))[:, 0]
    return torch.eye(4, device=state_obs.device)[task]


def demo_task_order(data: TrajectoryData, eval_n_times: int, seed: int,
                    train_fraction: float = 0.95) -> np.ndarray:
    """Demonstrated task order per episode [N, 4] int32, -1 padded
    (goals.py:87-92)."""
    out = np.full((eval_n_times, 4), -1, np.int32)
    for i, traj, T in _goal_trajectories(data, eval_n_times, seed, train_fraction):
        onehot = data.onehot_goals[traj, :T]
        mask = onehot.max(0) > 0.5
        first_frame = onehot.argmax(0)
        tasks = sorted((first_frame[t], t) for t in range(4) if mask[t])
        for j, (_, t) in enumerate(tasks):
            out[i, j] = t
    return out
