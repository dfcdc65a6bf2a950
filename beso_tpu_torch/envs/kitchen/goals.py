"""Kitchen multigoal evaluation goals (numpy port of
`beso_tpu/envs/kitchen/goals.py:multigoal_kitchen_goals`).

Functional parity target: `beso/envs/franka_kitchen/goals.py:87-93` and the
expected-task oracle of `kitchen_workspace_manager.py:527-578`: the goal for
episode i is the last `goal_seq_len` observations of TRAIN trajectory
`train_idx[i]` (indices wrap past 536); the expected tasks are the
trajectory's onehot label maxima.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from beso_tpu_torch.data.trajectories import TrajectoryData, get_split_idx


def _wrap_goal_idx(goal_idx: int) -> int:
    """Workspace-loop wrap (kitchen_workspace_manager.py:252-253)."""
    return goal_idx - 536 if goal_idx > 536 else goal_idx


def multigoal_kitchen_goals(data: TrajectoryData, goal_seq_len: int,
                            eval_n_times: int, seed: int,
                            train_fraction: float = 0.95
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (goals [N, G, obs_dim] f32, expected [N, 7] bool)."""
    if data.onehot_goals is None:
        raise ValueError("multigoal evaluation needs onehot task labels")
    train_idx, _ = get_split_idx(data.num_trajectories, seed, train_fraction)
    goals = np.zeros((eval_n_times, goal_seq_len, data.obs_dim), np.float32)
    expected = np.zeros((eval_n_times, 7), bool)
    for i in range(eval_n_times):
        traj = train_idx[_wrap_goal_idx(i) % len(train_idx)]
        T = int(data.lengths[traj])
        goals[i] = data.observations[traj, T - goal_seq_len:T]
        expected[i] = data.onehot_goals[traj, :T].max(0) > 0.5
    return goals, expected
