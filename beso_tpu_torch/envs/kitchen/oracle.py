"""Scripted kitchen demonstrator: differential-IK task executor (torch port
of `beso_tpu/envs/kitchen/oracle.py`).

A phase machine that walks a task sequence, steering the Panda fingertip to
each object handle by damped-least-squares differential IK (the jacobian of
`envs/kitchen/fk.py`) and then driving the object joint toward its goal
value; the kettle task closes the fingers at the handle, carries the kettle
and releases it. See the JAX module for the laws and the play-style fields.

The JAX oracle is one env's phase machine, vmapped over episodes and
scanned over steps; here B episodes step together, each with its own rows
of the task sequence, `KitchenOracleCarry` and `KitchenOracleStyle`, and
the step loop is a Python loop. The fingertip jacobian is forward-mode, as
`jax.jacfwd`: one `torch.func.jvp` of the batched FK over the 7 joint
directions. Every random draw of a rollout (the task sequences, the
styles, the pauses and the per-step action noise) goes through
`kitchen_draws`, fed by the caller's `torch.Generator`; the tests replace
it by the JAX package's draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from beso_tpu_torch.data.trajectories import TrajectoryData
from beso_tpu_torch.envs.kitchen.env import (ACT_AMP, CONTROL_DT, GOAL_VEC,
                                             KITCHEN_BASE_POS, PRIMARY, KitchenParams,
                                             KitchenState, default_kitchen_params,
                                             handle_tangents, kitchen_handles,
                                             kitchen_obs, kitchen_reset, kitchen_step)
from beso_tpu_torch.envs.kitchen.fk import panda_fk

REACH_SPEED = 0.08      # m per control step while approaching
MANIP_SPEED = 0.05      # m per control step while manipulating
CORR_BLEND = 1.0        # fraction of off-arc error corrected per step

TASK_BUDGET = 70  # steps before the oracle gives up on a stuck task

_DETOUR_OFFSET = (0.0, -0.06, 0.04)


class KitchenOracleCarry(NamedTuple):
    task_ptr: torch.Tensor     # [B] int64 index into the task sequence
    task_steps: torch.Tensor   # [B] int64 steps spent on the current task
    detour_done: torch.Tensor  # [B] bool: the play-style detour is done


class KitchenOracleStyle(NamedTuple):
    """Per-episode execution style rows; the clean demonstrator's are
    speed 1 and zeros."""

    speed_mult: torch.Tensor   # [B]
    detour_task: torch.Tensor  # [B] int64 element visited first
    detour_gate: torch.Tensor  # [B] 1.0 = take the detour
    wander_steps: torch.Tensor  # [B] int64
    wander_dir: torch.Tensor   # [B, 3] unit
    pause_prob: torch.Tensor   # [B]


# one episode's clean style (the JAX module's field defaults); a batch of B
# clean rows is this expanded
CLEAN_STYLE = KitchenOracleStyle(
    speed_mult=torch.ones(()), detour_task=torch.zeros((), dtype=torch.long),
    detour_gate=torch.zeros(()), wander_steps=torch.zeros((), dtype=torch.long),
    wander_dir=torch.zeros(3), pause_prob=torch.zeros(()))


def sample_kitchen_style(batch_size: int, generator: Optional[torch.Generator] = None,
                         device=None, play_style: bool = False) -> KitchenOracleStyle:
    """The clean style, or with `play_style` per-episode draws from the JAX
    module's distributions."""
    B, g = batch_size, generator
    if not play_style:
        return KitchenOracleStyle(*(f.to(device).expand(B, *f.shape).clone()
                                    for f in CLEAN_STYLE))

    def u():
        return torch.rand(B, generator=g, device=device)

    speed = 0.6 + 0.7 * u()
    detour_task = torch.randint(0, 7, (B,), generator=g, device=device)
    gate = (u() < 0.5).float()
    wander_steps = torch.randint(0, 25, (B,), generator=g, device=device)
    wd = torch.randn(B, 3, generator=g, device=device)
    wd = wd / torch.clamp(torch.linalg.norm(wd, dim=-1, keepdim=True), min=1e-9)
    return KitchenOracleStyle(speed, detour_task, gate, wander_steps, wd, 0.12 * u())


def sample_task_sequence(batch_size: int, n_tasks: int = 4, kettle_boost: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         device=None) -> torch.Tensor:
    """Random task sequences [B, 4] over the 7 elements, -1 padded.
    `kettle_boost`: probability of moving the kettle (task 6) to the front."""
    B = batch_size
    perm = torch.argsort(torch.rand(B, 7, generator=generator, device=device), dim=-1)
    if kettle_boost > 0.0:
        force = torch.rand(B, generator=generator, device=device) < kettle_boost
        kettle_pos = torch.argmax((perm == 6).int(), dim=-1)
        swapped = perm.clone()
        swapped.scatter_(1, kettle_pos[:, None], perm[:, :1])
        swapped[:, 0] = 6
        perm = torch.where(force[:, None], swapped, perm)
    seq = perm[:, :n_tasks]
    pad = torch.full((B, 4 - n_tasks), -1, dtype=seq.dtype, device=device)
    return torch.cat([seq, pad], dim=1)


def oracle_reset(batch_size: int, device=None) -> KitchenOracleCarry:
    z = torch.zeros(batch_size, dtype=torch.long, device=device)
    return KitchenOracleCarry(z, z.clone(),
                              torch.zeros(batch_size, dtype=torch.bool, device=device))


def fingertip_jacobian(q7: torch.Tensor) -> torch.Tensor:
    """d panda_fk / d q of joint angles q7 [B, 7] -> [B, 3, 7], forward
    mode (`jax.jacfwd`): the 7 directions as one batched jvp. Forward-mode
    AD is off in inference mode (some torch builds then return zero
    tangents), so the jvp runs outside it, on a copy of q7."""
    B = q7.shape[0]
    with torch.inference_mode(False):
        q = q7.clone().repeat(7, 1)
        eye = torch.eye(7, dtype=q7.dtype, device=q7.device)
        _, jt = torch.func.jvp(lambda x: panda_fk(x, KITCHEN_BASE_POS), (q,),
                               (eye.repeat_interleave(B, 0),))
    return jt.reshape(7, B, 3).permute(1, 2, 0)


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[b, idx[b]] for a [B, n, ...] table."""
    return table[torch.arange(idx.shape[0], device=idx.device), idx]


def kitchen_oracle_policy(state: KitchenState, carry: KitchenOracleCarry,
                          task_seq: torch.Tensor, params: Optional[KitchenParams] = None,
                          style: Optional[KitchenOracleStyle] = None,
                          ) -> Tuple[torch.Tensor, KitchenOracleCarry]:
    """One scripted step of B envs: (action [B, 9], carry). `task_seq`
    [B, 4]; `style` None is the clean style."""
    B, dev = state.qpos.shape[0], state.qpos.device
    params = params if params is not None else default_kitchen_params(dev)
    style = style if style is not None else sample_kitchen_style(B, device=dev)
    primary = torch.as_tensor(PRIMARY, device=dev)
    goal_vec = torch.as_tensor(GOAL_VEC, device=dev)

    ptr = torch.clamp(carry.task_ptr, max=3)
    seq_task = task_seq.gather(1, ptr[:, None])[:, 0]
    task = torch.clamp(seq_task, min=0)
    active = (seq_task >= 0) & (carry.task_ptr < 4)
    is_kettle = task == 6

    ee = state.ee_pos
    handles = kitchen_handles(state.qpos, params)  # handles ride their doors
    handle = _rows(handles, task)
    # play-style detour: before the first task, swing by another element's handle
    detour_pt = _rows(handles, style.detour_task) + torch.tensor(_DETOUR_OFFSET, device=dev)
    at_detour = torch.linalg.norm(detour_pt - ee, dim=-1) < 0.06
    detour_done = (carry.detour_done | at_detour | (style.detour_gate < 0.5)
                   | (carry.task_ptr > 0))
    handle = torch.where(~detour_done[:, None], detour_pt, handle)
    dist = torch.linalg.norm(ee - handle, dim=-1)
    # manipulate once the fingertip is hooked (inside the engagement radius)
    near = (dist < torch.where(is_kettle, params.grasp_radius * 0.7,
                               params.interact_radius)) & detour_done

    # desired fingertip displacement while approaching
    reach_vec = handle - ee
    reach_d = torch.linalg.norm(reach_vec, dim=-1)
    reach_dx = reach_vec / torch.clamp(reach_d, min=1e-9)[:, None] * torch.minimum(
        reach_d, REACH_SPEED * style.speed_mult)[:, None]

    # manipulation (v2 arc law): advance along the handle's arc tangent
    # toward the goal joint value, correcting the off-arc error each step
    p_idx = primary[task]
    q_primary = _rows(state.qpos, p_idx)
    goal_primary = goal_vec[p_idx]
    sign = torch.sign(goal_primary - q_primary)
    tangent = _rows(handle_tangents(state.qpos, params), task)
    rad_vec = handle - params.pivots[task]
    ax = params.axes[task]
    r_arc = torch.linalg.norm(rad_vec - ax * torch.sum(rad_vec * ax, dim=-1, keepdim=True),
                              dim=-1)
    is_rotary = params.rotary[task] > 0.5
    eff = torch.clamp(params.drive_eff[task], min=1e-3)
    need = torch.abs(goal_primary - q_primary) / eff
    need_lin = torch.where(is_rotary, need * r_arc, need)
    speed = torch.clamp(torch.where(is_rotary, 0.6 * r_arc,
                                    torch.full_like(r_arc, MANIP_SPEED)), max=MANIP_SPEED)
    step_len = torch.minimum(speed, need_lin)
    perp_err = reach_vec - tangent * torch.sum(tangent * reach_vec, dim=-1, keepdim=True)
    manip_dx = tangent * (sign * step_len)[:, None] + CORR_BLEND * perp_err

    # kettle: once grasped, carry it straight to its goal position
    kettle_vec = goal_vec[23:26] - state.qpos[:, 23:26]
    kettle_d = torch.linalg.norm(kettle_vec, dim=-1)
    kettle_dx = kettle_vec / torch.clamp(kettle_d, min=1e-9)[:, None] * torch.clamp(
        kettle_d, max=MANIP_SPEED)[:, None]
    # until the grasp latches, hold still at the handle (close the fingers)
    grasped = state.kettle_grasped[:, None]
    kettle_dx = torch.where(grasped, kettle_dx, torch.zeros_like(kettle_dx))
    manip_dx = torch.where(is_kettle[:, None], kettle_dx, manip_dx)

    dx = torch.where((near | (is_kettle & state.kettle_grasped))[:, None], manip_dx, reach_dx)
    # play-style wandering prefix: undirected fingertip drift before work
    wandering = (carry.task_ptr == 0) & (carry.task_steps < style.wander_steps)
    dx = torch.where(wandering[:, None], 0.04 * style.wander_dir, dx)
    dx = torch.where(active[:, None], dx, torch.zeros_like(dx))

    # differential IK: joint velocities from the fingertip jacobian
    J = fingertip_jacobian(state.qpos[:, :7])
    H = J @ J.transpose(1, 2) + 1e-4 * torch.eye(3, device=dev)
    dq = (J.transpose(1, 2) @ torch.linalg.solve(H, dx[..., None]))[..., 0]
    action7 = dq / (ACT_AMP * CONTROL_DT)

    # fingers: close at the kettle handle until it is done, open elsewhere
    close = is_kettle & near & ~state.completed[:, 6] & active
    finger = torch.where(close, -1.0, 1.0)[:, None].expand(B, 2)
    action = torch.clamp(torch.cat([action7, finger], dim=-1), -1.0, 1.0)

    task_done = _rows(state.completed, task) & active
    timed_out = carry.task_steps >= TASK_BUDGET
    advance = task_done | (timed_out & active)
    ptr_next = torch.where(advance, carry.task_ptr + 1, carry.task_ptr)
    steps_next = torch.where(advance, torch.zeros_like(carry.task_steps),
                             carry.task_steps + 1)
    return action, KitchenOracleCarry(ptr_next, steps_next, detour_done)


def kitchen_draws(what: str, batch_size: int, generator: Optional[torch.Generator],
                  device, step: int = 0, n_tasks: int = 4, kettle_boost: float = 0.0,
                  play_style: bool = False):
    """Every draw of `rollout_kitchen_oracle`, from `generator` in call
    order: "task_seq" ([B, 4]), "style" (KitchenOracleStyle), "pause"
    (uniforms [B] of step `step`; paused where below pause_prob) and
    "action" (unit normals [B, 9])."""
    if what == "task_seq":
        return sample_task_sequence(batch_size, n_tasks, kettle_boost, generator, device)
    if what == "style":
        return sample_kitchen_style(batch_size, generator, device, play_style)
    if what == "pause":
        return torch.rand(batch_size, generator=generator, device=device)
    if what == "action":
        return torch.randn(batch_size, 9, generator=generator, device=device)
    raise ValueError(f"unknown draw {what!r}")


@torch.no_grad()
def rollout_kitchen_oracle(n_episodes: int, n_steps: int = 280, n_tasks: int = 4,
                           action_noise: float = 0.0,
                           params: Optional[KitchenParams] = None,
                           play_style: bool = False, kettle_boost: float = 0.0,
                           generator: Optional[torch.Generator] = None, device=None):
    """B oracle episodes on `device`: (obs [B, T, 30], act [B, T, 9],
    completed [B, 7], completion_order [B, 7], task_seq [B, 4]).
    `action_noise` jitters the executed and recorded actions; `play_style`
    draws per-episode execution styles (see KitchenOracleStyle)."""
    B = n_episodes
    task_seq = kitchen_draws("task_seq", B, generator, device, n_tasks=n_tasks,
                             kettle_boost=kettle_boost)
    style = kitchen_draws("style", B, generator, device, play_style=play_style)
    env = kitchen_reset(B, device)
    carry = oracle_reset(B, device)
    obs, act = [], []
    for step in range(n_steps):
        obs.append(kitchen_obs(env))
        action, carry = kitchen_oracle_policy(env, carry, task_seq, params, style)
        if play_style:
            paused = kitchen_draws("pause", B, generator, device, step) < style.pause_prob
            action = torch.where(paused[:, None], torch.zeros_like(action), action)
        if action_noise > 0:
            action = torch.clamp(
                action + kitchen_draws("action", B, generator, device, step) * action_noise,
                -1.0, 1.0)
        act.append(action)
        env = kitchen_step(env, action, params)[0]
    return (torch.stack(obs, 1), torch.stack(act, 1), env.completed,
            env.completion_order, task_seq)


def label_kitchen_demonstrations(obs: np.ndarray, act: np.ndarray, completed: np.ndarray,
                                 order: np.ndarray) -> TrajectoryData:
    """Relay-kitchen-format TrajectoryData: a one-hot label row at each
    completion frame, each demo cut 10 steps after its last completion
    (`beso_tpu/envs/kitchen/oracle.py:252-269`)."""
    n_episodes, n_steps = obs.shape[:2]
    onehot = np.zeros((n_episodes, n_steps, 7), np.float32)
    last_completion = np.zeros(n_episodes, np.int64)
    for i in range(n_episodes):
        for t in range(7):
            if completed[i, t] and 0 < order[i, t] <= n_steps:
                onehot[i, order[i, t] - 1, t] = 1.0
                last_completion[i] = max(last_completion[i], order[i, t] - 1)
    # truncate idle tails (idle-dominated demos teach standing still)
    lengths = np.where(last_completion > 0,
                       np.minimum(last_completion + 10, n_steps),
                       n_steps).astype(np.int32)
    return TrajectoryData(observations=obs, actions=act, lengths=lengths,
                          onehot_goals=onehot)


def generate_kitchen_demonstrations(n_episodes: int = 64, n_steps: int = 280,
                                    n_tasks: int = 4, action_noise: float = 0.02,
                                    params: Optional[KitchenParams] = None,
                                    play_style: bool = False, kettle_boost: float = 0.0,
                                    generator: Optional[torch.Generator] = None,
                                    device=None) -> TrajectoryData:
    """Batched relay-kitchen-format demo synthesis on `device` (host numpy
    TrajectoryData)."""
    obs, act, completed, order, _ = rollout_kitchen_oracle(
        n_episodes, n_steps, n_tasks, action_noise, params, play_style, kettle_boost,
        generator, device)
    return label_kitchen_demonstrations(obs.cpu().numpy(), act.cpu().numpy(),
                                        completed.cpu().numpy(), order.cpu().numpy())
