"""Single-block BlockPush env: PUSH, REACH and INSERT, and the normalized
wrapper (torch port of `beso_tpu/envs/block_push/single.py`, the
reference's `BlockPush`, `beso/envs/block_pushing/block_pushing.py:
165-787,790-1003`), batched over B envs.

* one block and one target zone; reset: block at x=0.4+U(+-0.1),
  y=-0.2+U(+-0.15), one uniform draw for both coordinates as in the JAX
  env (which draws them from one key), yaw U(0, pi); target at
  x=0.4+U(+-0.1), y=0.2+U(+-0.15) (one draw), yaw pi+U(+-pi/6);
* obs = [block_xy, block_yaw, effector_xy, effector_target_xy, target_xy,
  target_yaw] (10 dims, block_pushing.py:497-511);
* reward = the best fraction of the goal distance reduced so far; success
  (reward 1, done) at goal distance < 0.01 (block_pushing.py:569-589);
  done envs keep their state and get reward 0;
* REACH: the goal is a point 5 cm before the block on the block -> target
  line (block_pushing.py:481-489); INSERT: the slotted target, whose walls
  hold the block at the rim unless it comes in along the slot opening;
* the quasi-static push law of the multimodal env (`env._push_block`), 24
  substeps per control step.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from beso_tpu_torch.envs.block_push.env import (CONTROL_DT, EFFECTOR_RADIUS, EFFECTOR_SPEED,
                                                EFFECTOR_START, N_SUBSTEPS, WORKSPACE_BOUNDS,
                                                WORKSPACE_CENTER_X, _norm, _push_block)

GOAL_DIST_TOLERANCE = 0.01  # block_pushing.py:193

# INSERT (block_pushing.py:170,370-371,1023): within SLOT_RADIUS of the
# target the block is held at the rim unless its bearing from the target
# lies within SLOT_HALF_ANGLE of the slot opening (the target yaw); inside
# SLOT_INNER it sits in the fixture unconstrained
SLOT_RADIUS = 0.05
SLOT_HALF_ANGLE = math.pi / 5
SLOT_INNER = 0.02

TASKS = ("PUSH", "REACH", "INSERT")


class SingleBlockPushState(NamedTuple):
    effector: torch.Tensor            # [B, 2]
    effector_target: torch.Tensor     # [B, 2]
    block_pos: torch.Tensor           # [B, 2]
    block_yaw: torch.Tensor           # [B]
    target_pos: torch.Tensor          # [B, 2]
    target_yaw: torch.Tensor          # [B]
    reach_target: torch.Tensor        # [B, 2] (REACH)
    init_goal_distance: torch.Tensor  # [B]
    best_fraction: torch.Tensor       # [B]
    done: torch.Tensor                # [B] bool
    steps: torch.Tensor               # [B] int32


def _check(task: str) -> None:
    if task not in TASKS:
        raise ValueError(f"task must be one of {TASKS}, got {task!r}")


def single_block_push_reset(batch_size: int, generator: Optional[torch.Generator] = None,
                            device=None, task: str = "PUSH") -> SingleBlockPushState:
    """Reset B envs, drawing the block, its yaw, the target and its yaw
    (one [B] uniform each, in that order) from `generator`."""
    _check(task)
    B = batch_size

    def u():
        return torch.rand(B, generator=generator, device=device)

    ub, uby, ut, uty = u(), u(), u(), u()
    block = torch.stack([WORKSPACE_CENTER_X - 0.1 + 0.2 * ub, -0.2 - 0.15 + 0.3 * ub], -1)
    byaw = math.pi * uby
    target = torch.stack([WORKSPACE_CENTER_X - 0.1 + 0.2 * ut, 0.2 - 0.15 + 0.3 * ut], -1)
    tyaw = math.pi + (-math.pi / 6 + (math.pi / 3) * uty)
    # REACH: the point 5 cm before the block on the block -> target line
    d = target - block
    reach = block - d / torch.clamp(_norm(d), min=1e-9)[:, None] * 0.05
    start = torch.tensor(EFFECTOR_START, device=device).expand(B, 2)
    goal = reach if task == "REACH" else target
    ref = start if task == "REACH" else block
    zeros = torch.zeros(B, device=device)
    return SingleBlockPushState(
        effector=start.clone(), effector_target=start.clone(), block_pos=block,
        block_yaw=byaw, target_pos=target, target_yaw=tyaw, reach_target=reach,
        init_goal_distance=_norm(goal - ref), best_fraction=zeros,
        done=torch.zeros(B, dtype=torch.bool, device=device),
        steps=torch.zeros(B, dtype=torch.int32, device=device))


def single_block_push_obs(state: SingleBlockPushState) -> torch.Tensor:
    """The 10-dim observation [B, 10] (block_pushing.py:497-511)."""
    return torch.cat([state.block_pos, state.block_yaw[:, None], state.effector,
                      state.effector_target, state.target_pos, state.target_yaw[:, None]], -1)


def _slot_gate(bpos: torch.Tensor, state: SingleBlockPushState) -> torch.Tensor:
    """INSERT's slot walls, applied per substep so that the block cannot
    tunnel through the fixture within a control step."""
    to_block = bpos - state.target_pos
    dist = _norm(to_block)
    bearing = torch.atan2(to_block[:, 1], to_block[:, 0])
    mis = torch.abs(torch.remainder(bearing - state.target_yaw + math.pi, 2 * math.pi) - math.pi)
    blocked = (dist < SLOT_RADIUS) & (dist > SLOT_INNER) & (mis > SLOT_HALF_ANGLE)
    rim = state.target_pos + to_block / torch.clamp(dist, min=1e-9)[:, None] * SLOT_RADIUS
    return torch.where(blocked[:, None], rim, bpos)


def single_block_push_step(state: SingleBlockPushState, action: torch.Tensor,
                           task: str = "PUSH") -> Tuple[SingleBlockPushState, torch.Tensor,
                                                        torch.Tensor, torch.Tensor]:
    """One 10 Hz control step of B envs, action [B, 2] (the effector
    target's delta). Returns (state, obs [B, 10], reward [B], done [B])."""
    _check(task)
    lo = torch.tensor(WORKSPACE_BOUNDS[0], device=action.device)
    hi = torch.tensor(WORKSPACE_BOUNDS[1], device=action.device)
    tgt = torch.minimum(torch.maximum(state.effector_target + action, lo), hi)
    eff, bpos, byaw = state.effector, state.block_pos, state.block_yaw
    for _ in range(N_SUBSTEPS):
        to_tgt = tgt - eff
        d = _norm(to_tgt)
        step_len = torch.clamp(d, max=EFFECTOR_SPEED * CONTROL_DT / N_SUBSTEPS)
        eff = eff + to_tgt / torch.clamp(d, min=1e-9)[:, None] * step_len[:, None]
        bpos, byaw, _ = _push_block(bpos, byaw, eff, EFFECTOR_RADIUS)
        if task == "INSERT":
            bpos = _slot_gate(bpos, state)

    goal_distance = _norm((state.reach_target - eff) if task == "REACH"
                          else (state.target_pos - bpos))
    best = torch.maximum(state.best_fraction, 1.0 - goal_distance / state.init_goal_distance)
    success = goal_distance < GOAL_DIST_TOLERANCE
    reward = torch.where(success, 1.0, best)
    new_state = SingleBlockPushState(
        effector=eff, effector_target=tgt, block_pos=bpos, block_yaw=byaw,
        target_pos=state.target_pos, target_yaw=state.target_yaw,
        reach_target=state.reach_target, init_goal_distance=state.init_goal_distance,
        best_fraction=best, done=state.done | success, steps=state.steps + 1)
    done0 = state.done
    frozen = SingleBlockPushState(*(
        torch.where(done0.reshape(done0.shape + (1,) * (new.dim() - 1)), old, new)
        for new, old in zip(new_state, state)))
    reward = torch.where(done0, 0.0, reward)
    return frozen, single_block_push_obs(frozen), reward, frozen.done


# The BlockPushNormalized wrapper (block_pushing.py:790-1003): the
# observation restructured into relative translations and cos/sin
# orientations, mapped to ~[-1, 1] with the reference's published
# per-feature stats (block_pushing.py:55-86); actions taken in [-1, 1] and
# mapped back with ACTION_MIN/MAX; the reward x100.
ACTION_MIN = (-0.02547718, -0.02090043)
ACTION_MAX = (0.02869084, 0.04272365)
_EFF_TGT = ((0.1774151772260666, -0.6287994794547558), (0.5654461532831192, 0.5441607423126698))
_TO_BLOCK = ((-0.07369826920330524, -0.11395704373717308),
             (0.10131562314927578, 0.19391131028532982))
_TO_TARGET = ((-0.17813862301409245, -0.3309651017189026),
              (0.23726161383092403, 0.8404090404510498))
_BLOCK_CS = ((-2.0649861991405487, -0.6154364347457886), (1.6590178310871124, 1.8811014890670776))
_TARGET_CS = ((-1.0761439241468906, -0.8846937336493284),
              (-0.8344330154359341, 0.8786859593819827))


def _to_unit(v: torch.Tensor, bounds) -> torch.Tensor:
    """[min, max] -> [-1, 1] (block_pushing.py:869-873), in float32 as the
    JAX package's constants are."""
    lo = torch.tensor(bounds[0], dtype=torch.float32, device=v.device)
    hi = torch.tensor(bounds[1], dtype=torch.float32, device=v.device)
    return (v - (hi + lo) * 0.5) / ((hi - lo) * 0.5)


def normalized_obs(state: SingleBlockPushState) -> torch.Tensor:
    """The reference's normalized state [B, 10] in its OrderedDict order
    (calc_normalized_state, block_pushing.py:885-935): effector_target,
    effector_target -> block, block cos/sin, effector_target -> target,
    target cos/sin (effector_translation is dropped, :917-918)."""
    et = state.effector_target
    block_cs = torch.stack([torch.cos(state.block_yaw), torch.sin(state.block_yaw)], -1)
    target_cs = torch.stack([torch.cos(state.target_yaw), torch.sin(state.target_yaw)], -1)
    return torch.cat([_to_unit(et, _EFF_TGT), _to_unit(state.block_pos - et, _TO_BLOCK),
                      _to_unit(block_cs, _BLOCK_CS), _to_unit(state.target_pos - et, _TO_TARGET),
                      _to_unit(target_cs, _TARGET_CS)], -1)


def denormalize_action(action: torch.Tensor) -> torch.Tensor:
    """Clip to [-1, 1], then map onto [ACTION_MIN, ACTION_MAX]
    (block_pushing.py:853-856, 875-880)."""
    lo = torch.tensor(ACTION_MIN, dtype=torch.float32, device=action.device)
    hi = torch.tensor(ACTION_MAX, dtype=torch.float32, device=action.device)
    return torch.clamp(action, -1.0, 1.0) * ((hi - lo) * 0.5) + (hi + lo) * 0.5
