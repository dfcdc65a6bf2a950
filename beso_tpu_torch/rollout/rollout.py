"""Batched evaluation rollouts (torch port of the kitchen part of
`beso_tpu/rollout/rollout.py`).

All episodes run at once over a batch of B envs; the JAX `lax.scan` over
env steps becomes a Python loop of policy -> physics steps under
`torch.inference_mode`. Success metrics follow the reference protocol:
kitchen result = |completed tasks ∩ expected tasks|
(kitchen_workspace_manager.py:527-578), and success-rate-at-k histograms
(compute_performance, :455-471).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from beso_tpu_torch.agents.policy import (PolicyConfig, policy_predict,
                                          policy_reset)
from beso_tpu_torch.envs.kitchen.env import (kitchen_obs, kitchen_reset,
                                             kitchen_reset_from_qpos,
                                             kitchen_step)
from beso_tpu_torch.models.scaler import Scaler


class RolloutMetrics(NamedTuple):
    rewards: torch.Tensor           # [B] total env reward per episode
    results: torch.Tensor           # [B] conditional success metric
    completed: torch.Tensor         # [B, n_tasks] bool
    env_steps: int                  # total env steps executed (B * T)
    completion_order: torch.Tensor  # [B, n_tasks] int32 step, -1 if never


def average_success_metric(results) -> float:
    """Fraction of fully successful episodes (metrics.py:27-60)."""
    return float((np.asarray(results) >= 1.0).mean())


def success_rate_histogram(n_completed, max_k: int = 5) -> dict:
    """success_rate_k = fraction of episodes with >= k completions
    (kitchen_workspace_manager.py:553-563,455-471)."""
    n = np.asarray(n_completed)
    return {f"success_rate_{k}": float((n >= k).mean()) for k in range(1, max_k + 1)}


def _run_rollout(env_state, step_fn, obs_fn, completed_of, order_of,
                 denoise_fn, scaler: Scaler, cfg: PolicyConfig, goals,
                 expected: torch.Tensor, generator, n_steps: int,
                 obs_slice: Optional[int], result_divisor: float,
                 denoise_factory=None) -> RolloutMetrics:
    B = expected.shape[0]
    device = expected.device
    if denoise_factory is not None:
        # per-episode engine (the prefix-KV cache), built once goals are known
        denoise_fn = denoise_factory(goals)
    obs = obs_fn(env_state)
    obs = obs[:, :obs_slice] if obs_slice is not None else obs
    pstate = policy_reset(B, cfg, device)
    total_reward = torch.zeros(B, device=device)
    for _ in range(n_steps):
        action, pstate = policy_predict(denoise_fn, scaler, pstate, obs,
                                        goals, generator, cfg)
        env_state, obs_full, reward, _ = step_fn(env_state, action)
        obs = obs_full[:, :obs_slice] if obs_slice is not None else obs_full
        total_reward = total_reward + reward
    completed = completed_of(env_state)
    results = (completed & expected.bool()).sum(-1).float() / result_divisor
    return RolloutMetrics(rewards=total_reward, results=results,
                          completed=completed, env_steps=B * n_steps,
                          completion_order=order_of(env_state))


@torch.inference_mode()
def rollout_kitchen(denoise_fn, scaler: Scaler, cfg: PolicyConfig,
                    goals: torch.Tensor,      # [B, G, 30] dataset-tail goals
                    expected: torch.Tensor,   # [B, 7] expected-task masks
                    generator: Optional[torch.Generator] = None,
                    n_steps: int = 280, physics_params=None,
                    init_qpos: Optional[torch.Tensor] = None,
                    denoise_factory=None) -> RolloutMetrics:
    """Batched multigoal kitchen evaluation (kitchen_workspace_manager.py:
    213-316: episodes x 280 steps) on goals' device.

    `generator` drives the policy's action noise. `physics_params`: optional
    KitchenParams override. `init_qpos`: optional [B, 30] known start
    states, one per episode (`_start_from_known`, :500-525)."""
    B, device = expected.shape[0], expected.device
    if init_qpos is not None:
        if init_qpos.shape[0] != B:
            raise ValueError("init_qpos must provide one start state per episode")
        env_state = kitchen_reset_from_qpos(init_qpos.to(device))
    else:
        env_state = kitchen_reset(B, device)
    return _run_rollout(
        env_state, lambda s, a: kitchen_step(s, a, physics_params),
        kitchen_obs, lambda s: s.completed, lambda s: s.completion_order,
        denoise_fn, scaler, cfg, goals, expected, generator, n_steps,
        obs_slice=30, result_divisor=1.0, denoise_factory=denoise_factory)
