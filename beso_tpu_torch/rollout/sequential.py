"""Sequential-goal kitchen evaluation (torch port of
`beso_tpu/rollout/sequential.py`).

Functional parity target: `test_agent_on_sequential_tasks`
(`kitchen_workspace_manager.py:318-423`): each episode walks 4 dataset
sub-goals; sub-goal k gets a step budget of
(timeframe_k - timeframe_{k-1} + 50) (k < 4), and the episode moves to the
next sub-goal as soon as the current goal task is completed or the budget
is spent; the last sub-goal runs until done or the 280-step cap.

The reference's per-episode while/break becomes a per-env stage and
stage-step counter on the device, updated with `torch.where` each step:
no host read inside the loop. Any `denoise_fn` serves; no prefix cache is
built, since an env's goal changes mid-episode.
"""

from __future__ import annotations

from typing import Optional

import torch

from beso_tpu_torch.agents.policy import PolicyConfig, policy_predict, policy_reset
from beso_tpu_torch.envs.kitchen.env import kitchen_obs, kitchen_reset, kitchen_step
from beso_tpu_torch.models.scaler import Scaler
from beso_tpu_torch.rollout.rollout import RolloutMetrics


@torch.inference_mode()
def rollout_kitchen_sequential(denoise_fn, scaler: Scaler, cfg: PolicyConfig,
                               goals: torch.Tensor,       # [B, 4, G, 30]
                               timeframes: torch.Tensor,  # [B, 4]
                               task_ids: torch.Tensor,    # [B, 4]
                               expected: torch.Tensor,    # [B, 7]
                               generator: Optional[torch.Generator] = None,
                               n_steps: int = 280, physics_params=None,
                               budget_margin: int = 50) -> RolloutMetrics:
    """Batched sequential evaluation on goals' device; `generator` drives
    the policy's noise. result = |completed ∩ expected|."""
    B, device = goals.shape[0], goals.device
    rows = torch.arange(B, device=device)
    env_state = kitchen_reset(B, device)
    obs = kitchen_obs(env_state)[:, :30]
    pstate = policy_reset(B, cfg, device)
    timeframes = timeframes.long()
    task_ids = task_ids.long()
    # per-stage budgets (kitchen_workspace_manager.py:360-367): stage k < 3
    # tf[k] - tf[k-1] + margin (tf[-1] := 0; the reference's margin is 50),
    # stage 3 the episode cap
    prev_tf = torch.cat([torch.zeros_like(timeframes[:, :1]), timeframes[:, :2]], dim=1)
    budgets = torch.cat([timeframes[:, :3] - prev_tf + budget_margin,
                         torch.full_like(timeframes[:, :1], n_steps)], dim=1)
    stage = torch.zeros(B, dtype=torch.long, device=device)
    stage_steps = torch.zeros(B, dtype=torch.long, device=device)
    total_reward = torch.zeros(B, device=device)
    for _ in range(n_steps):
        action, pstate = policy_predict(denoise_fn, scaler, pstate, obs,
                                        goals[rows, stage], generator, cfg)
        env_state, obs_full, reward, _ = kitchen_step(env_state, action, physics_params)
        obs = obs_full[:, :30]
        total_reward = total_reward + reward
        stage_steps = stage_steps + 1
        task_done = env_state.completed[rows, task_ids[rows, stage]]
        advance = (task_done | (stage_steps >= budgets[rows, stage])) & (stage < 3)
        stage = torch.where(advance, stage + 1, stage)
        stage_steps = torch.where(advance, torch.zeros_like(stage_steps), stage_steps)
    completed = env_state.completed
    results = (completed & expected.bool()).sum(-1).float()
    return RolloutMetrics(rewards=total_reward, results=results, completed=completed,
                          env_steps=B * n_steps,
                          completion_order=env_state.completion_order)
