"""Batched evaluation rollouts (torch port of `beso_tpu/rollout/rollout.py`:
kitchen and block push).

All episodes run at once over a batch of B envs; the JAX `lax.scan` over
env steps becomes a Python loop of policy -> physics steps under
`torch.inference_mode`. Success metrics follow the reference protocol:
* kitchen: result = |completed tasks ∩ expected tasks|
  (kitchen_workspace_manager.py:527-578), and success-rate-at-k histograms
  (compute_performance, :455-471);
* block push: result = |completed ∩ expected| / 2 in {0, 0.5, 1}
  (block_push_workspace.py:218-240); reward accumulates the env reward.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from beso_tpu_torch.agents.policy import (PolicyConfig, policy_predict,
                                          policy_reset)
from beso_tpu_torch.envs.block_push.env import (block_push_obs, block_push_reset,
                                                block_push_step)
from beso_tpu_torch.envs.block_push.goals import build_block_push_goals
from beso_tpu_torch.envs.kitchen.env import (kitchen_obs, kitchen_reset,
                                             kitchen_reset_from_qpos,
                                             kitchen_step)
from beso_tpu_torch.models.scaler import Scaler
from beso_tpu_torch.utils.metrics import span


class RolloutMetrics(NamedTuple):
    rewards: torch.Tensor           # [B] total env reward per episode
    results: torch.Tensor           # [B] conditional success metric
    completed: torch.Tensor         # [B, n_tasks] bool
    env_steps: int                  # total env steps executed (B * T)
    completion_order: torch.Tensor  # [B, n_tasks] int32 step, -1 if never


def average_success_metric(results) -> float:
    """Fraction of fully successful episodes (metrics.py:27-60)."""
    return float((np.asarray(results) >= 1.0).mean())


def average_final_goal_distance(goal_distances) -> float:
    """Mean final goal distance (metrics.py:63-95)."""
    return float(np.asarray(goal_distances).mean())


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
    """The episode loop. Under a profiler it opens the spans of its layers
    (`utils.metrics.span`): `rollout.episode` around it all,
    `engine.prefix_build` around the per-episode engine, `rollout.step` around
    each env step (its index as `step`), holding `policy.predict` and
    `physics.step` around `step_fn`."""
    B = expected.shape[0]
    device = expected.device
    with span("rollout.episode"):
        obs_full = obs_fn(env_state)
        if callable(goals):
            goals = goals(obs_full)  # goals of the live reset state (the flip fix)
        if denoise_factory is not None:
            # per-episode engine (the prefix-KV cache), built once goals are known
            with span("engine.prefix_build"):
                denoise_fn = denoise_factory(goals)
        obs = obs_full[:, :obs_slice] if obs_slice is not None else obs_full
        pstate = policy_reset(B, cfg, device)
        total_reward = torch.zeros(B, device=device)
        for t in range(n_steps):
            with span("rollout.step", {"step": t}):
                action, pstate = policy_predict(denoise_fn, scaler, pstate, obs,
                                                goals, generator, cfg)
                with span("physics.step"):
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


@torch.inference_mode()
def rollout_block_push(denoise_fn, scaler: Scaler, cfg: PolicyConfig,
                       goal_frames: torch.Tensor,  # [B, 16] dataset final frames
                       expected: torch.Tensor,     # [B, 4] expected-task masks
                       generator: Optional[torch.Generator] = None,
                       n_steps: int = 300, goal_seq_len: int = 1,
                       reduce_obs_dim: bool = True, mask_targets: bool = False,
                       denoise_factory=None) -> RolloutMetrics:
    """Batched block-push evaluation (block_push_workspace.py:90-216:
    episodes x 300 steps; result = |completed ∩ expected| / 2) on
    goal_frames' device.

    `generator` draws the resets, then the policy's action noise. The
    flip-fixed goals (envs/block_push/goals.py) are built from the live reset
    observations, before the per-episode engine. With `mask_targets` and the
    full 16-dim observation, the stepped observations' target dims are
    zeroed (the reset observation is not, as in `beso_tpu`)."""
    B, device = expected.shape[0], expected.device

    def goals_of(obs0_full):
        return build_block_push_goals(obs0_full, goal_frames, goal_seq_len,
                                      zero_goals=True, reduce_obs_dim=reduce_obs_dim)

    def step_masked(state, action):
        s, o, r, d = block_push_step(state, action)
        if mask_targets and not reduce_obs_dim:
            o = torch.cat([o[..., :10], torch.zeros_like(o[..., 10:])], -1)
        return s, o, r, d

    return _run_rollout(
        block_push_reset(B, generator, device), step_masked, block_push_obs,
        lambda s: s.completed,
        lambda s: torch.full_like(s.completed, -1, dtype=torch.int32),  # no order kept
        denoise_fn, scaler, cfg, goals_of, expected,
        generator, n_steps, obs_slice=10 if reduce_obs_dim else None,
        result_divisor=2.0, denoise_factory=denoise_factory)
