"""Batched Franka Kitchen surrogate environment (torch port of
`beso_tpu/envs/kitchen/env.py`).

Same task table, observation layout, completion/reward/termination logic
and v2 arc-kinematic surrogate physics as the JAX version, written over an
explicit batch dimension: per-env scalars are [B] tensors (masks are [B, 1]
where they gate vectors), the `.at[].set/add` loops are indexed writes on a
clone, and the done-freeze is a `torch.where` per field. `completion_order`
and `steps` stay int32.

`kitchen_step` runs the step as one CUDA kernel (`ops/kitchen_step.py`,
`csrc/kitchen_step.cu`) for CUDA inputs that need no gradient, and this
eager code (`_kitchen_step_eager`) otherwise: on the CPU, and where a
gradient flows through the step.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from beso_tpu_torch.envs.kitchen import geometry as _G
from beso_tpu_torch.envs.kitchen.fk import mdh_table, panda_fk
from beso_tpu_torch.ops import kitchen_step as _step_kernel

# task table (kitchen_env.py:10-28)
ALL_TASKS = (
    "bottom burner", "top burner", "light switch", "slide cabinet",
    "hinge cabinet", "microwave", "kettle",
)
OBS_ELEMENT_INDICES = {
    "bottom burner": np.array([11, 12]),
    "top burner": np.array([15, 16]),
    "light switch": np.array([17, 18]),
    "slide cabinet": np.array([19]),
    "hinge cabinet": np.array([20, 21]),
    "microwave": np.array([22]),
    "kettle": np.array([23, 24, 25, 26, 27, 28, 29]),
}
OBS_ELEMENT_GOALS = {
    "bottom burner": np.array([-0.88, -0.01]),
    "top burner": np.array([-0.92, -0.01]),
    "light switch": np.array([-0.69, -0.05]),
    "slide cabinet": np.array([0.37]),
    "hinge cabinet": np.array([0.0, 1.45]),
    "microwave": np.array([-0.75]),
    "kettle": np.array([-0.23, 0.75, 1.62, 0.99, 0.0, 0.0, -0.06]),
}
BONUS_THRESH = 0.3

GOAL_VEC = np.zeros(30, np.float32)
TASK_MASKS = np.zeros((7, 30), np.float32)
for _i, _t in enumerate(ALL_TASKS):
    GOAL_VEC[OBS_ELEMENT_INDICES[_t]] = OBS_ELEMENT_GOALS[_t]
    TASK_MASKS[_i, OBS_ELEMENT_INDICES[_t]] = 1.0

# D4RL / adept_envs initial configuration (public relay-kitchen init_qpos);
# adept_envs resets deterministically, so there is no reset noise
INIT_QPOS = np.asarray([
    1.48388023e-01, -1.76848573e+00, 1.84390296e+00, -2.47685760e+00,
    2.60252026e-01, 7.12533105e-01, 1.59515394e+00, 4.79267505e-02,
    3.71350621e-02, -2.66279850e-04, -5.18043486e-05, 3.12877220e-05,
    -4.51199853e-05, -3.90842156e-06, -4.22629655e-05, 6.28065475e-05,
    4.04984708e-05, 4.62730939e-04, -2.26906415e-04, -4.65501369e-04,
    -6.44129196e-03, -1.77048263e-03, 1.08009684e-03, -2.69397440e-01,
    3.50383255e-01, 1.61944683e+00, 1.00618764e+00, 4.06395120e-03,
    -6.62095997e-03, -2.68278933e-04,
], np.float32)
# adept_envs resets deterministically: `kitchen_reset` adds no noise (the
# JAX module scales a normal draw by this 0)
RESET_NOISE = 0.0

# Panda joint limits (public spec)
JOINT_LO = np.asarray([-2.8973, -1.7628, -2.8973, -3.0718, -2.8973, -0.0175,
                       -2.8973, 0.0, 0.0], np.float32)
JOINT_HI = np.asarray([2.8973, 1.7628, 2.8973, -0.0698, 2.8973, 3.7525,
                       2.8973, 0.04, 0.04], np.float32)

ACT_AMP = 2.0
CONTROL_DT = 0.08  # 12.5 Hz relay-kitchen control rate
KITCHEN_BASE_POS = (0.0, 0.3, 0.8)

# articulated-object joint ranges; object qpos indices 9..29 -> local 0..20
OBJ_LO = np.full(21, -np.inf, np.float32)
OBJ_HI = np.full(21, np.inf, np.float32)
for _idx, _lo, _hi in [
    (11, *_G.JOINT_RANGE[0]), (12, *_G.JOINT_RANGE[0]),  # bottom burner
    (15, *_G.JOINT_RANGE[1]), (16, *_G.JOINT_RANGE[1]),  # top burner
    (17, *_G.JOINT_RANGE[2]), (18, *_G.JOINT_RANGE[2]),  # light switch
    (19, *_G.JOINT_RANGE[3]),                            # slide cabinet
    (20, -0.2, 0.2), (21, *_G.JOINT_RANGE[4]),           # hinge cabinet
    (22, *_G.JOINT_RANGE[5]),                            # microwave door
    (25, 1.45, 1.75),                   # kettle stays on the counter (z)
]:
    OBJ_LO[_idx - 9], OBJ_HI[_idx - 9] = _lo, _hi
# primary joint obs-index per element, and a secondary joint that follows
# it at a fixed ratio
PRIMARY = np.asarray([11, 15, 17, 19, 21, 22, 23])
SECONDARY = np.asarray([12, 16, 18, 19, 20, 22, 23])
SECONDARY_RATIO = np.asarray([0.01136, 0.01087, 0.07246, 0.0, 0.0, 0.0, 0.0],
                             np.float32)


@dataclasses.dataclass(frozen=True)
class KitchenParams:
    """Surrogate contact/interaction calibration (see the JAX KitchenParams
    for what each constant means and how it was measured)."""

    pivots: torch.Tensor           # [7, 3]
    axes: torch.Tensor             # [7, 3]
    handle0: torch.Tensor          # [7, 3]
    bar_dirs: torch.Tensor         # [7, 3]
    bar_halflen: torch.Tensor      # [7]
    rotary: torch.Tensor           # [7]
    drive_eff: torch.Tensor        # [7]
    interact_radius: torch.Tensor  # []
    grasp_radius: torch.Tensor     # []
    release_radius: torch.Tensor   # []
    grip_close_thresh: torch.Tensor  # []
    grip_open_thresh: torch.Tensor   # []
    kettle_gain: torch.Tensor      # []
    kettle_max_speed: torch.Tensor  # []
    wall_y: torch.Tensor           # []
    micro_lo: torch.Tensor         # [3]
    micro_hi: torch.Tensor         # [3]


@functools.lru_cache(maxsize=None)
def default_kitchen_params(device=None) -> KitchenParams:
    """The shipped calibration (`DEFAULT_KITCHEN_PARAMS` of the JAX env)."""
    def t(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    return KitchenParams(
        pivots=t(_G.PIVOTS), axes=t(_G.AXES), handle0=t(_G.HANDLE0),
        bar_dirs=t(_G.BAR_DIRS), bar_halflen=t(_G.BAR_HALFLEN),
        rotary=t(_G.ELEMENT_KIND == _G.ROTARY),
        drive_eff=t([0.951, 0.951, 0.948, 1.000, 0.990, 0.996, 0.0]),
        interact_radius=t(0.040), grasp_radius=t(0.05),
        release_radius=t(0.07), grip_close_thresh=t(0.020),
        grip_open_thresh=t(0.032), kettle_gain=t(1.0),
        kettle_max_speed=t(0.30), wall_y=t(0.95),
        micro_lo=t([-0.60, 0.80, 0.70]), micro_hi=t([-0.15, 1.30, 1.10]))


def perturb_kitchen_params(params: Optional[KitchenParams] = None, gain_scale: float = 1.0,
                           radius_scale: float = 1.0, kettle_scale: float = 1.0,
                           device=None) -> KitchenParams:
    """Scaled physics for the robustness evaluation: train at the nominal
    constants, evaluate at +-20% drive efficiencies and contact radii and
    report the retention (`beso_tpu/envs/kitchen/env.py:206-220`). `params`
    defaults to the shipped calibration on `device`."""
    if params is None:
        params = default_kitchen_params(device)
    return dataclasses.replace(
        params,
        drive_eff=params.drive_eff * gain_scale,
        interact_radius=params.interact_radius * radius_scale,
        grasp_radius=params.grasp_radius * radius_scale,
        release_radius=params.release_radius * radius_scale,
        kettle_gain=torch.clamp(params.kettle_gain * kettle_scale, 0.0, 1.0),
        kettle_max_speed=params.kettle_max_speed * kettle_scale)


class _Consts(NamedTuple):
    goal_vec: torch.Tensor
    task_masks: torch.Tensor
    joint_lo: torch.Tensor
    joint_hi: torch.Tensor
    obj_lo: torch.Tensor
    obj_hi: torch.Tensor
    primary: torch.Tensor
    secondary_ratio: torch.Tensor
    secondary: torch.Tensor
    fk_table: torch.Tensor  # `fk.mdh_table()`, the kernel's forward kinematics
    base_pos: torch.Tensor


@functools.lru_cache(maxsize=None)
def _consts(device) -> _Consts:
    def t(v):
        return torch.as_tensor(v, device=device)

    return _Consts(t(GOAL_VEC), t(TASK_MASKS), t(JOINT_LO), t(JOINT_HI),
                   t(OBJ_LO), t(OBJ_HI), t(PRIMARY), t(SECONDARY_RATIO), t(SECONDARY),
                   t(mdh_table()), t(np.asarray(KITCHEN_BASE_POS, np.float32)))


class KitchenState(NamedTuple):
    qpos: torch.Tensor              # [B, 30]
    ee_pos: torch.Tensor            # [B, 3] fingertip
    tasks_to_complete: torch.Tensor  # [B, 7] bool (True = still open)
    completed: torch.Tensor         # [B, 7] bool
    completion_order: torch.Tensor  # [B, 7] int32 step at completion (-1)
    kettle_grasped: torch.Tensor    # [B] bool latched gripper state
    done: torch.Tensor              # [B] bool
    steps: torch.Tensor             # [B] int32


def kitchen_reset_from_qpos(qpos: torch.Tensor,
                            task_mask=None) -> KitchenState:
    """Reset B envs from known configurations qpos [B, 30] — the
    `_start_from_known` path (kitchen_workspace_manager.py:500-525)."""
    B, dev = qpos.shape[0], qpos.device
    open_tasks = (torch.ones(B, 7, dtype=torch.bool, device=dev)
                  if task_mask is None else
                  torch.as_tensor(task_mask, dtype=torch.bool,
                                  device=dev).expand(B, 7).clone())
    return KitchenState(
        qpos=qpos, ee_pos=panda_fk(qpos[:, :7], KITCHEN_BASE_POS),
        tasks_to_complete=open_tasks,
        completed=torch.zeros(B, 7, dtype=torch.bool, device=dev),
        completion_order=torch.full((B, 7), -1, dtype=torch.int32, device=dev),
        kettle_grasped=torch.zeros(B, dtype=torch.bool, device=dev),
        done=torch.zeros(B, dtype=torch.bool, device=dev),
        steps=torch.zeros(B, dtype=torch.int32, device=dev))


def kitchen_reset(batch_size: int, device=None, task_mask=None) -> KitchenState:
    """Reset B envs to the deterministic adept_envs start (all 7 tasks open
    unless `task_mask` selects a subset)."""
    qpos = torch.as_tensor(INIT_QPOS, device=device).expand(batch_size, 30)
    return kitchen_reset_from_qpos(qpos.clone(), task_mask)


def load_init_qpos(data_path):
    """Demonstration start states (kitchen_workspace_manager.py:500-509):
    (all_init_qpos.npy, all_init_qvel.npy) of the dataset directory."""
    from pathlib import Path

    return (np.load(Path(data_path) / "all_init_qpos.npy"),
            np.load(Path(data_path) / "all_init_qvel.npy"))


def kitchen_obs(state: KitchenState) -> torch.Tensor:
    return state.qpos


def _rodrigues(v: torch.Tensor, axis: torch.Tensor,
               theta: torch.Tensor) -> torch.Tensor:
    """Rotate v [7,3] about unit axes [7,3] by angles theta [B,7] -> [B,7,3]."""
    c = torch.cos(theta)[..., None]
    s = torch.sin(theta)[..., None]
    dot = torch.sum(v * axis, dim=-1, keepdim=True)
    return v * c + torch.linalg.cross(axis, v) * s + axis * dot * (1.0 - c)


def kitchen_handles(qpos: torch.Tensor, params: KitchenParams) -> torch.Tensor:
    """World handle positions [B, 7, 3] (v2 arc kinematics; the kettle
    handle, row 6, tracks the kettle body qpos[23:26])."""
    c = _consts(qpos.device)
    q_primary = qpos[:, c.primary]                                # [B, 7]
    arc = params.pivots + _rodrigues(params.handle0 - params.pivots,
                                     params.axes, q_primary)
    lin = params.handle0 + params.axes * q_primary[..., None]
    handles = torch.where(params.rotary[:, None] > 0.5, arc, lin)
    return torch.cat([handles[:, :6], qpos[:, None, 23:26]], dim=1)


def handle_tangents(qpos: torch.Tensor, params: KitchenParams) -> torch.Tensor:
    """Unit direction of increasing joint value at each current handle
    position [B, 7, 3]: the arc tangent of a rotary element, the slide axis
    of the slide."""
    tan = torch.linalg.cross(params.axes.expand(qpos.shape[0], 7, 3),
                             kitchen_handles(qpos, params) - params.pivots)
    tan = tan / torch.clamp(torch.linalg.norm(tan, dim=-1, keepdim=True), min=1e-9)
    return torch.where(params.rotary[:, None] > 0.5, tan, params.axes)


def _segment_dist(p: torch.Tensor, centers: torch.Tensor,
                  bar_dirs: torch.Tensor, halflen: torch.Tensor) -> torch.Tensor:
    """Distance from points p [B,3] to each handle bar segment -> [B, 7]."""
    d = p[:, None] - centers                                      # [B,7,3]
    along = torch.sum(d * bar_dirs, dim=-1)
    along = torch.clamp(along, -halflen, halflen)
    closest = centers + bar_dirs * along[..., None]
    return torch.linalg.norm(p[:, None] - closest, dim=-1)


def _angular_advance(p_old: torch.Tensor, p_new: torch.Tensor,
                     params: KitchenParams) -> torch.Tensor:
    """Signed fingertip angle swept about each element's axis -> [B, 7]."""
    ax = params.axes
    u_old = p_old[:, None] - params.pivots
    u_new = p_new[:, None] - params.pivots
    po = u_old - ax * torch.sum(u_old * ax, dim=-1, keepdim=True)
    pn = u_new - ax * torch.sum(u_new * ax, dim=-1, keepdim=True)
    cross = torch.sum(ax * torch.linalg.cross(po, pn), dim=-1)
    dot = torch.sum(po * pn, dim=-1)
    return torch.atan2(cross, torch.clamp(dot, min=1e-12))


def _collides(p: torch.Tensor, params: KitchenParams) -> torch.Tensor:
    """Fingertip vs furniture [B]: cabinet face half-space + microwave AABB."""
    behind_wall = p[:, 1] > params.wall_y
    in_micro = torch.all((p > params.micro_lo) & (p < params.micro_hi), dim=-1)
    return behind_wall | in_micro


def kitchen_step(state: KitchenState, action: torch.Tensor,
                 params: Optional[KitchenParams] = None,
                 ) -> Tuple[KitchenState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One 12.5 Hz control step for B envs. Returns (state, obs30 [B, 30],
    reward [B], done [B]).

    CUDA inputs take the CUDA kernel (one launch, no copy from the host, no
    wait for the card), unless a gradient would flow through the step; the
    CPU and the gradient take the eager code, `_kitchen_step_eager`."""
    dev = state.qpos.device
    params = params if params is not None else default_kitchen_params(dev)
    physics = [getattr(params, f.name) for f in dataclasses.fields(params)]
    if dev.type != "cuda" or (torch.is_grad_enabled() and any(
            t.requires_grad for t in (state.qpos, state.ee_pos, action, *physics))):
        return _kitchen_step_eager(state, action, params)
    *fields, reward = _step_kernel.kitchen_step(
        KitchenState(*(t.contiguous() for t in state)), action.contiguous(), params,
        _consts(dev), ACT_AMP, CONTROL_DT, BONUS_THRESH)
    new_state = KitchenState(*fields)
    return new_state, kitchen_obs(new_state), reward, new_state.done


def _kitchen_step_eager(state: KitchenState, action: torch.Tensor,
                        params: Optional[KitchenParams] = None,
                        ) -> Tuple[KitchenState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`kitchen_step` in eager operations: the CPU's path, the one a gradient
    flows through, and the kernel's reference."""
    dev = state.qpos.device
    params = params if params is not None else default_kitchen_params(dev)
    c = _consts(dev)
    qpos = state.qpos
    a = torch.clamp(action, -1.0, 1.0) * ACT_AMP

    # robot: velocity-integrated joints, clamped to limits
    q_cand = torch.clamp(qpos[:, :9] + a * CONTROL_DT, c.joint_lo, c.joint_hi)
    ee_cand = panda_fk(q_cand[:, :7], KITCHEN_BASE_POS)

    # block arm motion that starts or deepens a penetration; the finger
    # joints (7:9) always move
    blocked = (_collides(ee_cand, params) & ~_collides(state.ee_pos, params))[:, None]
    q_rob = torch.where(blocked, qpos[:, :9], q_cand)
    q_rob[:, 7:9] = q_cand[:, 7:9]
    ee_new = torch.where(blocked, state.ee_pos, ee_cand)
    ee_disp = ee_new - state.ee_pos

    # objects (v2 arc law): a fingertip hooked on a handle at the start of
    # the step drives the joint by drive_eff x its angular advance (slide:
    # linear advance); contact is kept only if the finger ends the step
    # within interact_radius of the driven handle
    handles = kitchen_handles(qpos, params)
    hooked = _segment_dist(state.ee_pos, handles, params.bar_dirs,
                           params.bar_halflen) < params.interact_radius
    dphi = _angular_advance(state.ee_pos, ee_new, params)
    dlin = torch.einsum("td,bd->bt", params.axes, ee_disp)
    drive_try = (torch.where(params.rotary > 0.5, dphi, dlin)
                 * params.drive_eff * hooked)
    # clip to the element joint ranges before the keep check
    q_try = torch.clamp(qpos[:, c.primary] + drive_try,
                        c.obj_lo[c.primary - 9], c.obj_hi[c.primary - 9])
    qpos_try = qpos.clone()
    qpos_try[:, PRIMARY[:6]] = q_try[:, :6]
    handles_end = kitchen_handles(qpos_try, params)
    keep = _segment_dist(ee_new, handles_end, params.bar_dirs,
                         params.bar_halflen) < params.interact_radius
    drive = drive_try * keep
    handle_dist = _segment_dist(ee_new, handles, params.bar_dirs,
                                params.bar_halflen)  # kettle grasp metric

    qpos_new = qpos.clone()
    qpos_new[:, :9] = q_rob
    # articulated elements (all but the kettle); secondary joints follow the
    # primary's motion at a fixed ratio
    for t in range(6):
        p, s = int(PRIMARY[t]), int(SECONDARY[t])
        qpos_new[:, p] += drive[:, t]
        if s != p:
            qpos_new[:, s] += drive[:, t] * c.secondary_ratio[t]

    # kettle: gripper-latched grasp; while grasped it tracks the fingertip
    # displacement with slip gain and a speed cap
    grip = torch.mean(q_rob[:, 7:9], dim=-1)
    kettle_dist = handle_dist[:, 6]
    engage = (~state.kettle_grasped & (kettle_dist < params.grasp_radius)
              & (grip < params.grip_close_thresh))
    release = state.kettle_grasped & ((grip > params.grip_open_thresh)
                                      | (kettle_dist > params.release_radius))
    grasped = (state.kettle_grasped | engage) & ~release

    kettle_disp = ee_disp * params.kettle_gain
    disp_norm = torch.linalg.norm(kettle_disp, dim=-1, keepdim=True)
    kettle_disp = kettle_disp * torch.clamp(
        params.kettle_max_speed / torch.clamp(disp_norm, min=1e-9), max=1.0)
    qpos_new[:, 23:26] = qpos[:, 23:26] + grasped[:, None].float() * kettle_disp
    qpos_new[:, 9:] = torch.clamp(qpos_new[:, 9:], c.obj_lo, c.obj_hi)

    # completion & reward (kitchen_env.py:87-120)
    dists = torch.linalg.norm((qpos_new[:, None] - c.goal_vec) * c.task_masks,
                              dim=-1)
    newly = (dists < BONUS_THRESH) & state.tasks_to_complete
    tasks_left = state.tasks_to_complete & ~newly
    order = torch.where(newly & (state.completion_order < 0),
                        state.steps[:, None] + 1, state.completion_order)
    reward = newly.float().sum(-1)
    new_state = KitchenState(
        qpos=qpos_new, ee_pos=ee_new, tasks_to_complete=tasks_left,
        completed=state.completed | newly, completion_order=order,
        kettle_grasped=grasped, done=state.done | ~tasks_left.any(-1),
        steps=state.steps + 1)

    # freeze finished envs (fixed-length episode semantics)
    was_done = state.done
    frozen = KitchenState(*[
        torch.where(was_done.reshape(-1, *([1] * (new.ndim - 1))), old, new)
        for new, old in zip(new_state, state)])
    reward = torch.where(was_done, torch.zeros_like(reward), reward)
    return frozen, kitchen_obs(frozen), reward, frozen.done
