"""Scripted multimodal push oracle and demonstration generator (torch port of
`beso_tpu/envs/block_push/oracle.py`).

Functional parity target: `MultimodalOrientedPushOracle`
(`beso/envs/block_pushing/oracles/multimodal_push_oracle.py:29-186`); see
the JAX module for the phase machine and the play-style fields. The JAX
oracle is one env's phase machine, vmapped over episodes and scanned over
steps; here B episodes step together, each with its own rows of
`OracleParams` and `OracleCarry`, and the step loop is a Python loop.

Every random draw of a rollout (the params, the reset, the per-step action
noise, the episode's wander direction, the per-step wander jitter and the
pauses) goes through `oracle_draws`, fed by the caller's `torch.Generator`;
the tests replace it by the JAX package's draws. The one-hot labelling and
the tail truncation are numpy, as in the JAX module.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from beso_tpu_torch.data.trajectories import TrajectoryData
from beso_tpu_torch.envs.block_push.env import (GOAL_DIST_TOLERANCE, BlockPushState,
                                                _norm, _take, block_push_obs,
                                                block_push_reset, block_push_step)

PRE_PUSH_OFFSET = 0.07
CONTACT_OFFSET = 0.034   # block half + effector radius - small press-in
PUSH_ADVANCE = 0.012
REACH_SPEED = 0.05
PUSH_SPEED = 0.02
REACH_TOL = 0.015
LOST_CONTACT_DIST = 0.09


class OracleCarry(NamedTuple):
    cur_idx: torch.Tensor      # [B] int64: 0 = first block, 1 = second, 2 = done
    phase: torch.Tensor        # [B] int64: 0 = reach pre-push, 1 = push
    detour_done: torch.Tensor  # [B] bool: the play-style detour is visited or skipped


class OracleParams(NamedTuple):
    """Per-episode rows; the clean demonstrator has the play-style fields
    at zero (speed_mult at one)."""

    block_order: torch.Tensor    # [B, 2] int64 permutation of blocks
    target_assign: torch.Tensor  # [B, 2] int64 target of block_order[:, i]
    approach_bias: torch.Tensor  # [B] rad
    speed_mult: torch.Tensor     # [B]
    detour: torch.Tensor         # [B, 2] waypoint of the reach
    detour_gate: torch.Tensor    # [B] 1.0 = route via the detour
    wander_steps: torch.Tensor   # [B] int64 undirected prefix
    pause_prob: torch.Tensor     # [B] per-step stop-and-go probability


def sample_oracle_params(batch_size: int, generator: Optional[torch.Generator] = None,
                         device=None, play_style: bool = False) -> OracleParams:
    """Random block order and assignment per episode
    (multimodal_push_oracle.py:137-147); `play_style` also draws the
    execution-style fields from the JAX module's distributions."""
    B, g = batch_size, generator

    def u(*shape):
        return torch.rand(shape, generator=g, device=device)

    first = (u(B) < 0.5).long()
    t_first = (u(B) < 0.5).long()
    order = torch.stack([first, 1 - first], -1)
    assign = torch.stack([t_first, 1 - t_first], -1)
    zeros = torch.zeros(B, device=device)
    if not play_style:
        return OracleParams(order, assign, zeros, torch.ones(B, device=device),
                            torch.zeros(B, 2, device=device), zeros,
                            torch.zeros(B, dtype=torch.long, device=device), zeros)
    return OracleParams(
        order, assign,
        approach_bias=-0.7 + 1.4 * u(B),
        speed_mult=0.6 + 0.8 * u(B),
        detour=torch.stack([0.25 + 0.35 * u(B), -0.35 + 0.45 * u(B)], -1),
        detour_gate=(u(B) < 0.5).float(),
        wander_steps=torch.randint(0, 20, (B,), generator=g, device=device),
        pause_prob=0.15 * u(B))


def oracle_reset(batch_size: int, device=None) -> OracleCarry:
    z = torch.zeros(batch_size, dtype=torch.long, device=device)
    return OracleCarry(z, z.clone(), torch.zeros(batch_size, dtype=torch.bool, device=device))


def _capped(vec: torch.Tensor, speed: torch.Tensor) -> torch.Tensor:
    d = _norm(vec)
    return vec / torch.clamp(d, min=1e-9)[:, None] * torch.minimum(d, speed)[:, None]


def oracle_policy(state: BlockPushState, carry: OracleCarry,
                  params: OracleParams) -> Tuple[torch.Tensor, OracleCarry]:
    """One scripted control step of B envs: (action [B, 2], carry)."""
    idx = torch.clamp(carry.cur_idx, max=1)[:, None]
    block = params.block_order.gather(1, idx)[:, 0]
    target = params.target_assign.gather(1, idx)[:, 0]
    bpos = _take(state.block_pos, block)
    tpos = _take(state.target_pos, target)
    # steer relative to the commanded effector target, which the arm tracks
    eff = state.effector_target

    to_target = tpos - bpos
    dir_bt = to_target / torch.clamp(_norm(to_target), min=1e-9)[:, None]
    # play style: the pre-push pose swung around the block by the approach bias
    ca, sa = torch.cos(params.approach_bias), torch.sin(params.approach_bias)
    dir_pre = torch.stack([ca * dir_bt[:, 0] - sa * dir_bt[:, 1],
                           sa * dir_bt[:, 0] + ca * dir_bt[:, 1]], -1)
    pre_push = bpos - dir_pre * PRE_PUSH_OFFSET
    contact = bpos - dir_bt * CONTACT_OFFSET

    # phase 0: reach the pre-push pose, optionally via the latched detour
    at_detour = _norm(params.detour - eff) < REACH_TOL * 2
    detour_done = carry.detour_done | at_detour | (params.detour_gate < 0.5)
    via_detour = ~detour_done & (carry.cur_idx == 0)
    reach_goal = torch.where(via_detour[:, None], params.detour, pre_push)
    reach_dist = _norm(pre_push - eff)
    reach_act = _capped(reach_goal - eff, REACH_SPEED * params.speed_mult)

    # phase 1: advance through the contact point, slower near the target
    d_bt = _norm(to_target)
    speed = PUSH_SPEED * params.speed_mult * torch.clamp(d_bt / 0.08, 0.25, 1.0)
    push_act = _capped(contact + dir_bt * PUSH_ADVANCE - eff, speed)
    action = torch.where((carry.phase == 1)[:, None], push_act, reach_act)

    # transitions (the reach -> push switch waits for the detour latch)
    block_done = _norm(bpos - tpos) < GOAL_DIST_TOLERANCE * 0.9
    lost = _norm(contact - eff) > LOST_CONTACT_DIST
    one, zero = torch.ones_like(carry.phase), torch.zeros_like(carry.phase)
    phase = torch.where(carry.phase == 0,
                        torch.where((reach_dist < REACH_TOL) & detour_done, one, zero),
                        torch.where(lost, zero, one))
    next_idx = torch.where(block_done, carry.cur_idx + 1, carry.cur_idx)
    phase = torch.where(block_done, zero, phase)
    action = torch.where((next_idx >= 2)[:, None], torch.zeros_like(action), action)
    return action, OracleCarry(next_idx, phase, detour_done)


def oracle_draws(what: str, batch_size: int, generator: Optional[torch.Generator],
                 device, step: int = 0, play_style: bool = False):
    """Every draw of `rollout_oracle`, from `generator` in call order:
    "reset" (a BlockPushState), "params" (OracleParams), "action" (unit
    normals [B, 2] of step `step`), "wander" (the episode's unit-normal
    wander direction [B, 2]), "wander_step" (the step's normal jitter
    [B, 2]) and "pause" (uniforms [B]; paused where below pause_prob)."""
    if what == "reset":
        return block_push_reset(batch_size, generator, device)
    if what == "params":
        return sample_oracle_params(batch_size, generator, device, play_style)
    if what == "pause":
        return torch.rand(batch_size, generator=generator, device=device)
    if what in ("action", "wander", "wander_step"):
        return torch.randn(batch_size, 2, generator=generator, device=device)
    raise ValueError(f"unknown draw {what!r}")


@torch.inference_mode()
def rollout_oracle(n_episodes: int, n_steps: int = 200, action_noise: float = 0.0,
                   play_style: bool = False, generator: Optional[torch.Generator] = None,
                   device=None):
    """B oracle episodes on `device`. Returns (obs [B, T, 16], act [B, T, 2],
    completed [B, 4] bool, in_target [B, 2, 2] bool).

    `action_noise` adds gaussian jitter to the executed (and recorded)
    actions; `play_style` draws per-episode execution styles and adds the
    goal-agnostic wandering prefix and stop-and-go pauses (see the JAX
    module)."""
    B = n_episodes
    env = oracle_draws("reset", B, generator, device)
    params = oracle_draws("params", B, generator, device, play_style=play_style)
    carry = oracle_reset(B, device)
    wander_dir0 = oracle_draws("wander", B, generator, device) if play_style else None
    obs, act = [], []
    for step in range(n_steps):
        obs.append(block_push_obs(env))
        action, carry = oracle_policy(env, carry, params)
        if play_style:
            # wandering prefix: a smooth random drift of the effector target
            wander_dir = wander_dir0 + 0.6 * oracle_draws("wander_step", B, generator,
                                                          device, step)
            wander_act = 0.02 * wander_dir / torch.clamp(_norm(wander_dir), min=1e-9)[:, None]
            action = torch.where((step < params.wander_steps)[:, None], wander_act, action)
            paused = oracle_draws("pause", B, generator, device, step) < params.pause_prob
            action = torch.where(paused[:, None], torch.zeros_like(action), action)
        if action_noise > 0:
            action = action + oracle_draws("action", B, generator, device, step) * action_noise
        act.append(action)
        env = block_push_step(env, action)[0]
    return torch.stack(obs, 1), torch.stack(act, 1), env.completed, env.in_target


def label_demonstrations(obs: np.ndarray, act: np.ndarray) -> TrajectoryData:
    """TrajectoryData with per-frame one-hot completion labels from
    block/target proximity (the row set at each first entry), each demo cut
    5 steps after its last completion (`beso_tpu/envs/block_push/oracle.py:
    218-244`)."""
    n_episodes, n_steps = obs.shape[:2]
    onehot = np.zeros((n_episodes, n_steps, 4), np.float32)
    blocks = np.stack([obs[..., 0:2], obs[..., 3:5]], axis=2)   # [N,T,2,2]
    targets = np.stack([obs[..., 10:12], obs[..., 13:15]], axis=2)
    dist = np.linalg.norm(blocks[:, :, :, None] - targets[:, :, None], axis=-1)
    inside = dist < GOAL_DIST_TOLERANCE   # [N, T, block, target]
    last_completion = np.zeros(n_episodes, np.int64)
    for b in range(2):
        for t in range(2):
            first = np.argmax(inside[:, :, b, t], axis=1)
            has = inside[:, :, b, t].any(axis=1)
            for i in range(n_episodes):
                if has[i]:
                    onehot[i, first[i], 2 * b + t] = 1.0
                    last_completion[i] = max(last_completion[i], first[i])
    # the oracle idles once done; idle-dominated data teaches standing still
    tail = 5
    lengths = np.where(last_completion > 0,
                       np.minimum(last_completion + tail, n_steps),
                       n_steps).astype(np.int32)
    return TrajectoryData(observations=obs, actions=act, lengths=lengths,
                          onehot_goals=onehot)


def generate_demonstrations(n_episodes: int = 64, n_steps: int = 120,
                            action_noise: float = 0.004, play_style: bool = False,
                            generator: Optional[torch.Generator] = None,
                            device=None) -> TrajectoryData:
    """Batched demo synthesis on `device`: TrajectoryData (host numpy) with
    one-hot task goals in the dataset's format."""
    obs, act, _, _ = rollout_oracle(n_episodes, n_steps, action_noise, play_style,
                                    generator, device)
    return label_demonstrations(obs.cpu().numpy(), act.cpu().numpy())
