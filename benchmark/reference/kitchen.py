"""The Franka-kitchen surrogate physics in plain PyTorch, float32: one
12.5 Hz control step of B envs, written out from the port's documented
model (robot joints integrate the clamped action at 2 rad/s per unit,
arm motion that starts a penetration of the cabinet wall or the microwave
box is blocked, a fingertip hooked on a handle drives the element's joint by
its arc or slide advance, the kettle follows a latched grasp, tasks complete
within 0.3 of their goals, finished envs freeze). The constants are those of
the shipped calibration and scene.

A state is a dict: qpos [B, 30], ee_pos [B, 3], tasks_to_complete,
completed [B, 7] bool, completion_order [B, 7] int32, kettle_grasped, done
[B] bool, steps [B] int32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.precision import matmul

# public relay-kitchen start configuration (adept_envs resets without noise)
INIT_QPOS = np.asarray([
    1.48388023e-01, -1.76848573e+00, 1.84390296e+00, -2.47685760e+00,
    2.60252026e-01, 7.12533105e-01, 1.59515394e+00, 4.79267505e-02,
    3.71350621e-02, -2.66279850e-04, -5.18043486e-05, 3.12877220e-05,
    -4.51199853e-05, -3.90842156e-06, -4.22629655e-05, 6.28065475e-05,
    4.04984708e-05, 4.62730939e-04, -2.26906415e-04, -4.65501369e-04,
    -6.44129196e-03, -1.77048263e-03, 1.08009684e-03, -2.69397440e-01,
    3.50383255e-01, 1.61944683e+00, 1.00618764e+00, 4.06395120e-03,
    -6.62095997e-03, -2.68278933e-04], np.float32)

TASK_IDX = ([11, 12], [15, 16], [17, 18], [19], [20, 21], [22],
            [23, 24, 25, 26, 27, 28, 29])
TASK_GOALS = ([-0.88, -0.01], [-0.92, -0.01], [-0.69, -0.05], [0.37], [0.0, 1.45],
              [-0.75], [-0.23, 0.75, 1.62, 0.99, 0.0, 0.0, -0.06])
JOINT_LO = [-2.8973, -1.7628, -2.8973, -3.0718, -2.8973, -0.0175, -2.8973, 0.0, 0.0]
JOINT_HI = [2.8973, 1.7628, 2.8973, -0.0698, 2.8973, 3.7525, 2.8973, 0.04, 0.04]
ACT_AMP, CONTROL_DT, BONUS_THRESH = 2.0, 0.08, 0.3
BASE_POS = (0.0, 0.3, 0.8)

# elements: bottom burner, top burner, light switch, slide cabinet, hinge
# cabinet, microwave, kettle
PIVOTS = [[0.35, 0.92, 1.00], [0.35, 0.92, 1.10], [0.25, 0.92, 1.30], [0.40, 0.85, 1.40],
          [0.15, 0.95, 1.40], [-0.60, 0.80, 0.90], [0.0, 0.0, 0.0]]
AXES = [[0.0, -1.0, 0.0], [0.0, -1.0, 0.0], [0.0, -1.0, 0.0], [1.0, 0.0, 0.0],
        [0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, 0.0]]
HANDLE0 = [[0.35, 0.89, 1.04], [0.35, 0.89, 1.14], [0.25, 0.89, 1.36], [0.40, 0.85, 1.40],
           [-0.15, 0.85, 1.40], [-0.20, 0.75, 0.90], [0.0, 0.0, 0.0]]
BAR_DIRS = [[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0],
            [0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]]
BAR_HALFLEN = [0.0, 0.0, 0.0, 0.06, 0.08, 0.06, 0.03]
ROTARY = [1.0, 1.0, 1.0, 0.0, 1.0, 1.0, 0.0]
DRIVE_EFF = [0.951, 0.951, 0.948, 1.000, 0.990, 0.996, 0.0]
INTERACT_R, GRASP_R, RELEASE_R = 0.040, 0.05, 0.07
GRIP_CLOSE, GRIP_OPEN, KETTLE_GAIN, KETTLE_MAX_SPEED = 0.020, 0.032, 1.0, 0.30
WALL_Y, MICRO_LO, MICRO_HI = 0.95, [-0.60, 0.80, 0.70], [-0.15, 1.30, 1.10]
# each element's primary joint (qpos index), and a secondary joint that
# follows it at a fixed ratio
PRIMARY = [11, 15, 17, 19, 21, 22, 23]
SECONDARY = [12, 16, 18, 19, 20, 22, 23]
SECONDARY_RATIO = [0.01136, 0.01087, 0.07246, 0.0, 0.0, 0.0, 0.0]
# object joint ranges, by qpos index
OBJ_RANGE = {11: (-1.5, 0.1), 12: (-1.5, 0.1), 15: (-1.5, 0.1), 16: (-1.5, 0.1),
             17: (-1.0, 0.1), 18: (-1.0, 0.1), 19: (-0.1, 0.6), 20: (-0.2, 0.2),
             21: (-0.1, 2.4), 22: (-1.6, 0.1), 25: (1.45, 1.75)}

# Panda modified-DH rows (a_{i-1}, d_i, alpha_{i-1}), flange and fingertip
PANDA_DH = ((0.0, 0.333, 0.0), (0.0, 0.0, -math.pi / 2), (0.0, 0.316, math.pi / 2),
            (0.0825, 0.0, math.pi / 2), (-0.0825, 0.384, -math.pi / 2),
            (0.0, 0.0, math.pi / 2), (0.088, 0.0, math.pi / 2))
TIP_D = 0.107 + 0.103


class Consts:
    """The constants as float32 tensors on one device."""

    def __init__(self, device):
        def t(v, dtype=torch.float32):
            return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)

        self.device = device
        goal, masks = np.zeros(30, np.float32), np.zeros((7, 30), np.float32)
        for i, (idx, g) in enumerate(zip(TASK_IDX, TASK_GOALS)):
            goal[idx], masks[i, idx] = g, 1.0
        lo, hi = np.full(21, -np.inf, np.float32), np.full(21, np.inf, np.float32)
        for j, (a, b) in OBJ_RANGE.items():
            lo[j - 9], hi[j - 9] = a, b
        self.goal, self.masks = t(goal), t(masks)
        self.joint_lo, self.joint_hi = t(JOINT_LO), t(JOINT_HI)
        self.obj_lo, self.obj_hi = t(lo), t(hi)
        self.pivots, self.axes, self.handle0 = t(PIVOTS), t(AXES), t(HANDLE0)
        self.bar_dirs, self.bar_halflen = t(BAR_DIRS), t(BAR_HALFLEN)
        self.rotary, self.drive_eff = t(ROTARY), t(DRIVE_EFF)
        self.primary = t(PRIMARY, torch.long)
        self.secondary_ratio = t(SECONDARY_RATIO)
        self.micro_lo, self.micro_hi = t(MICRO_LO), t(MICRO_HI)


def _mdh(a, d, alpha, theta):
    al = torch.tensor(alpha, dtype=torch.float32)
    ca, sa = torch.cos(al).item(), torch.sin(al).item()
    ct, st = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    rows = [[ct, -st, z, z + a], [st * ca, ct * ca, z - sa, z - d * sa],
            [st * sa, ct * sa, z + ca, z + d * ca], [z, z, z, o]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def fingertip(q7: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """Fingertip world position [B, 3] of the Panda at joint angles [B, 7]."""
    T = torch.eye(4, dtype=q7.dtype, device=q7.device).expand(q7.shape[0], 4, 4)
    for i, (a, d, alpha) in enumerate(PANDA_DH):
        T = matmul(T, _mdh(a, d, alpha, q7[:, i]), precision)
    T = matmul(T, _mdh(0.0, TIP_D, 0.0, torch.zeros_like(q7[:, 0])), precision)
    return T[:, :3, 3] + torch.tensor(BASE_POS, dtype=q7.dtype, device=q7.device)


def reset(batch: int, device) -> dict:
    qpos = torch.as_tensor(INIT_QPOS, device=device).expand(batch, 30).clone()
    return dict(qpos=qpos, ee_pos=fingertip(qpos[:, :7]),
                tasks_to_complete=torch.ones(batch, 7, dtype=torch.bool, device=device),
                completed=torch.zeros(batch, 7, dtype=torch.bool, device=device),
                completion_order=torch.full((batch, 7), -1, dtype=torch.int32,
                                            device=device),
                kettle_grasped=torch.zeros(batch, dtype=torch.bool, device=device),
                done=torch.zeros(batch, dtype=torch.bool, device=device),
                steps=torch.zeros(batch, dtype=torch.int32, device=device))


def _rotate(v, axis, theta):
    c, s = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    dot = torch.sum(v * axis, dim=-1, keepdim=True)
    return v * c + torch.linalg.cross(axis, v) * s + axis * dot * (1.0 - c)


def handles(qpos, k: Consts):
    q = qpos[:, k.primary]
    arc = k.pivots + _rotate(k.handle0 - k.pivots, k.axes, q)
    lin = k.handle0 + k.axes * q[..., None]
    h = torch.where(k.rotary[:, None] > 0.5, arc, lin)
    return torch.cat([h[:, :6], qpos[:, None, 23:26]], dim=1)


def _segment_dist(p, centers, k: Consts):
    d = p[:, None] - centers
    along = torch.clamp(torch.sum(d * k.bar_dirs, dim=-1), -k.bar_halflen, k.bar_halflen)
    return torch.linalg.norm(p[:, None] - (centers + k.bar_dirs * along[..., None]), dim=-1)


def _angle_swept(p_old, p_new, k: Consts):
    u_old, u_new = p_old[:, None] - k.pivots, p_new[:, None] - k.pivots
    po = u_old - k.axes * torch.sum(u_old * k.axes, dim=-1, keepdim=True)
    pn = u_new - k.axes * torch.sum(u_new * k.axes, dim=-1, keepdim=True)
    cross = torch.sum(k.axes * torch.linalg.cross(po, pn), dim=-1)
    return torch.atan2(cross, torch.clamp(torch.sum(po * pn, dim=-1), min=1e-12))


def _collides(p, k: Consts):
    inside = torch.all((p > k.micro_lo) & (p < k.micro_hi), dim=-1)
    return (p[:, 1] > WALL_Y) | inside


def step(state: dict, action: torch.Tensor, k: Consts, precision: str = "f32") -> dict:
    """The state after one control step of `action` [B, 9]; `precision`
    is that of the arm's kinematic products."""
    qpos, ee = state["qpos"], state["ee_pos"]
    a = torch.clamp(action, -1.0, 1.0) * ACT_AMP
    q_cand = torch.clamp(qpos[:, :9] + a * CONTROL_DT, k.joint_lo, k.joint_hi)
    ee_cand = fingertip(q_cand[:, :7], precision)
    blocked = (_collides(ee_cand, k) & ~_collides(ee, k))[:, None]
    q_rob = torch.where(blocked, qpos[:, :9], q_cand)
    q_rob[:, 7:9] = q_cand[:, 7:9]
    ee_new = torch.where(blocked, ee, ee_cand)
    ee_disp = ee_new - ee

    h0 = handles(qpos, k)
    hooked = _segment_dist(ee, h0, k) < INTERACT_R
    advance = torch.where(k.rotary > 0.5, _angle_swept(ee, ee_new, k),
                          torch.einsum("td,bd->bt", k.axes, ee_disp))
    drive_try = advance * k.drive_eff * hooked
    q_try = torch.clamp(qpos[:, k.primary] + drive_try, k.obj_lo[k.primary - 9],
                        k.obj_hi[k.primary - 9])
    qpos_try = qpos.clone()
    qpos_try[:, PRIMARY[:6]] = q_try[:, :6]
    keep = _segment_dist(ee_new, handles(qpos_try, k), k) < INTERACT_R
    drive = drive_try * keep
    handle_dist = _segment_dist(ee_new, h0, k)

    qpos_new = qpos.clone()
    qpos_new[:, :9] = q_rob
    for t in range(6):
        p, s = PRIMARY[t], SECONDARY[t]
        qpos_new[:, p] += drive[:, t]
        if s != p:
            qpos_new[:, s] += drive[:, t] * k.secondary_ratio[t]

    grip = torch.mean(q_rob[:, 7:9], dim=-1)
    kettle_dist = handle_dist[:, 6]
    grasped0 = state["kettle_grasped"]
    engage = ~grasped0 & (kettle_dist < GRASP_R) & (grip < GRIP_CLOSE)
    release = grasped0 & ((grip > GRIP_OPEN) | (kettle_dist > RELEASE_R))
    grasped = (grasped0 | engage) & ~release
    kettle_disp = ee_disp * KETTLE_GAIN
    norm = torch.linalg.norm(kettle_disp, dim=-1, keepdim=True)
    kettle_disp = kettle_disp * torch.clamp(KETTLE_MAX_SPEED / torch.clamp(norm, min=1e-9),
                                            max=1.0)
    qpos_new[:, 23:26] = qpos[:, 23:26] + grasped[:, None].float() * kettle_disp
    qpos_new[:, 9:] = torch.clamp(qpos_new[:, 9:], k.obj_lo, k.obj_hi)

    dists = torch.linalg.norm((qpos_new[:, None] - k.goal) * k.masks, dim=-1)
    newly = (dists < BONUS_THRESH) & state["tasks_to_complete"]
    left = state["tasks_to_complete"] & ~newly
    order = torch.where(newly & (state["completion_order"] < 0),
                        state["steps"][:, None] + 1, state["completion_order"])
    new = dict(qpos=qpos_new, ee_pos=ee_new, tasks_to_complete=left,
               completed=state["completed"] | newly, completion_order=order,
               kettle_grasped=grasped, done=state["done"] | ~left.any(-1),
               steps=state["steps"] + 1)
    was_done = state["done"]
    return {f: torch.where(was_done.reshape(-1, *([1] * (v.ndim - 1))), state[f], v)
            for f, v in new.items()}
