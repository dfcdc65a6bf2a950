"""Kitchen evaluation goals, dataset-derived (numpy port of
`beso_tpu/envs/kitchen/goals.py`).

Functional parity target: `beso/envs/franka_kitchen/goals.py:31-133` and the
expected-task oracle of `kitchen_workspace_manager.py:527-578`:
* multigoal: the goal for episode i is the last `goal_seq_len`
  observations of TRAIN trajectory `train_idx[i]` (indices wrap past 536);
  the expected tasks are the trajectory's onehot label maxima;
* sequential: the k-th sub-goal window, its timeframe and its task, from
  the onehot ordering (goals.py:95-121);
* onehot: the per-frame 7-dim onehot label (goals.py:123-130).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from beso_tpu_torch.data.trajectories import TrajectoryData, get_split_idx

ALL_TASKS = np.array(
    ["bottom burner", "top burner", "light switch", "slide cabinet",
     "hinge cabinet", "microwave", "kettle"], dtype="<U13")


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


def sequential_kitchen_goals(data: TrajectoryData, goal_seq_len: int,
                             eval_n_times: int, seed: int,
                             train_fraction: float = 0.95):
    """Per-episode sequence of 4 sub-goals (goals.py:95-121). Returns
    (goals [N, 4, G, obs_dim] f32, timeframes [N, 4] int32, task_ids [N, 4]
    int32, expected [N, 7] bool); sub-goal k (1-indexed in the reference)
    is row k-1, and task_ids index `ALL_TASKS`."""
    if data.onehot_goals is None:
        raise ValueError("sequential evaluation needs onehot task labels")
    train_idx, _ = get_split_idx(data.num_trajectories, seed, train_fraction)
    N, G = eval_n_times, goal_seq_len
    goals = np.zeros((N, 4, G, data.obs_dim), np.float32)
    timeframes = np.zeros((N, 4), np.int32)
    task_ids = np.zeros((N, 4), np.int32)
    expected = np.zeros((N, 7), bool)
    for i in range(N):
        traj = train_idx[_wrap_goal_idx(i) % len(train_idx)]
        T = int(data.lengths[traj])
        onehot = data.onehot_goals[traj, :T]
        expected[i] = onehot.max(0) > 0.5
        order = np.sort(onehot.argmax(0)[expected[i]])      # completion frames
        for k in range(3):
            gidx = int(order[k + 1]) if len(order) > k + 1 else int(order[-1])
            win = data.observations[traj, gidx:min(gidx + G, T)]
            goals[i, k, :len(win)] = win
            timeframes[i, k] = gidx
            task_ids[i, k] = _task_at(onehot, min(gidx - 1, T - 1))
        # final sub-goal: the trajectory tail, timeframe pinned to 280, its
        # task read near the last labeled frame (goals.py:113-116)
        goals[i, 3] = data.observations[traj, T - G:T]
        timeframes[i, 3] = 280
        gidx = order[-1] if len(order) else T - 1
        task_ids[i, 3] = _task_at(onehot, min(gidx + 5, T - 1))
    return goals, timeframes, task_ids, expected


def _task_at(onehot: np.ndarray, frame: int) -> int:
    """The task labeled at `frame` (0 when none is)."""
    lab = onehot[frame] > 0.5
    return int(np.argmax(lab)) if lab.any() else 0


def onehot_kitchen_goals(data: TrajectoryData, eval_n_times: int, seed: int,
                         train_fraction: float = 0.95):
    """Per-frame onehot goal table [N, Tmax, 7] f32 and expected masks
    (goals.py:123-130): the goal at env step n is row min(n, T-1)."""
    if data.onehot_goals is None:
        raise ValueError("onehot goals need onehot task labels")
    train_idx, _ = get_split_idx(data.num_trajectories, seed, train_fraction)
    table = np.zeros((eval_n_times, data.observations.shape[1], 7), np.float32)
    expected = np.zeros((eval_n_times, 7), bool)
    for i in range(eval_n_times):
        traj = train_idx[_wrap_goal_idx(i) % len(train_idx)]
        T = int(data.lengths[traj])
        table[i, :T] = data.onehot_goals[traj, :T]
        table[i, T:] = data.onehot_goals[traj, T - 1]
        expected[i] = data.onehot_goals[traj, :T].max(0) > 0.5
    return table, expected
