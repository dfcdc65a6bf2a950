"""Scripted kitchen episodes through `kitchen_step`, on any device, and the
MuJoCo golden bands of `tests/test_kitchen_fidelity.py` held on their
outcome. Imports torch, numpy and the port only (no JAX), so that the CPU
tests and `chip_smoke.py` share it.

One batch of six envs, N_STEPS control steps:
  0. an arc drag: the fingertip starts on the microwave's handle and follows
     the handle's arc, STEP_LEN per step;
  1. a straight pull along the handle's initial tangent;
  2. the gripper closes with the kettle's handle bar at the largest golden
     offset that MuJoCo grasps, then the arm turns: the kettle must follow;
  3. the same at the smallest offset that MuJoCo does not grasp;
  4. a latched grasp at the largest gap MuJoCo holds under a yank;
  5. a latched grasp 0.02 beyond it (plus a margin of RELEASE_MARGIN).
`script_kitchen_scenarios` finds the actions on the CPU (the drags by
damped least-squares inverse kinematics of the arm, with the state fed
back); `replay` runs the actions from the same start on any device.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from beso_tpu_torch.envs.kitchen import env as kenv
from beso_tpu_torch.envs.kitchen.fk import panda_fk

GOLDEN = Path(__file__).parent / "golden" / "kitchen_mujoco_v2.npz"
N_STEPS, STEP_LEN = 16, 0.03
MICROWAVE = 5
RELEASE_MARGIN = 0.001
TURN = 0.1            # env 2's joint-0 action while it holds the kettle
BAND_NAMES = ("arc drag opens the microwave", "straight pull slips",
              "arc drive within 0.02 of MuJoCo's steady slope",
              "grasp at MuJoCo's largest grasped offset",
              "no grasp at MuJoCo's smallest missed offset",
              "held kettle follows the fingertip at gain 1",
              "held kettle moves below the speed cap", "MuJoCo's yank gap stays held",
              "0.02 beyond the yank gap releases")


class Trajectory(NamedTuple):
    qpos: np.ndarray      # [N_STEPS + 1, 6, 30]
    ee: np.ndarray        # [N_STEPS + 1, 6, 3]
    grasped: np.ndarray   # [N_STEPS + 1, 6] bool


def _ik(q: torch.Tensor, target: torch.Tensor, iters: int = 200) -> torch.Tensor:
    """Arm joints [7] (float64) that put the fingertip at target [3]: damped
    least squares from q, steps capped at 0.1 rad, joint limits kept."""
    lo = torch.as_tensor(kenv.JOINT_LO[:7], dtype=torch.float64)
    hi = torch.as_tensor(kenv.JOINT_HI[:7], dtype=torch.float64)

    def fk(x):
        return panda_fk(x[None], kenv.KITCHEN_BASE_POS)[0]

    for _ in range(iters):
        err = target - fk(q)
        if float(err.norm()) < 1e-10:
            break
        J = torch.autograd.functional.jacobian(fk, q)
        dq = J.T @ torch.linalg.solve(J @ J.T + 1e-8 * torch.eye(3, dtype=q.dtype), err)
        dq = dq * min(1.0, 0.1 / float(dq.abs().max()))
        q = torch.clamp(q + dq, lo, hi)
    return q


def _start(golden):
    """The batch's start qpos [6, 30] (each arm placed by inverse kinematics,
    every object at its reset pose) and latched grasps [6]."""
    params = kenv.default_kitchen_params(torch.device("cpu"))
    qpos = torch.as_tensor(kenv.INIT_QPOS).repeat(6, 1)
    handles = kenv.kitchen_handles(qpos[:1], params)[0].double()
    offs, ok = golden["kettle_grasp_offsets"], golden["kettle_grasp_ok"]
    gap = float(golden["kettle_yank_gap"])
    # the kettle's handle bar runs along x: a fingertip below it by `off`
    # is `off` from it
    tips = [handles[MICROWAVE]] * 2 + [
        handles[6] - torch.tensor([0.0, 0.0, float(off)], dtype=torch.float64)
        for off in (offs[ok].max(), offs[~ok].min(), gap, gap + 0.02 + RELEASE_MARGIN)]
    for env, tip in enumerate(tips):
        qpos[env, :7] = _ik(qpos[env, :7].double(), tip).float()
    grasped = torch.tensor([False, False, False, False, True, True])
    return qpos, grasped


def replay(qpos0, grasped0, actions, device, params=None) -> Trajectory:
    """`kitchen_step` from the start state over actions [N_STEPS, 6, 9] on
    `device`; the states as numpy arrays."""
    state = kenv.kitchen_reset_from_qpos(qpos0.to(device))._replace(
        kettle_grasped=grasped0.to(device))
    states = [state]
    for a in actions:
        state = kenv.kitchen_step(state, a.to(device), params)[0]
        states.append(state)
    return Trajectory(*(torch.stack([getattr(s, f) for s in states]).cpu().numpy()
                        for f in ("qpos", "ee_pos", "kettle_grasped")))


def script_kitchen_scenarios():
    """(qpos0 [6, 30], grasped0 [6], actions [N_STEPS, 6, 9]) on the CPU:
    the drags' arm actions by inverse kinematics on the states the CPU's
    `kitchen_step` reaches; the grippers of envs 2-5 close on step 1."""
    golden = np.load(GOLDEN)
    cpu = torch.device("cpu")
    params = kenv.default_kitchen_params(cpu)
    qpos0, grasped0 = _start(golden)
    state = kenv.kitchen_reset_from_qpos(qpos0.clone())._replace(kettle_grasped=grasped0)
    pivot, axis = params.pivots[MICROWAVE], params.axes[MICROWAVE]
    r_vec0 = state.ee_pos[0] - pivot
    r0 = torch.linalg.norm(r_vec0 - axis * torch.dot(r_vec0, axis))
    tan0 = kenv.handle_tangents(state.qpos[1:2], params)[0, MICROWAVE]
    actions = []
    for step in range(N_STEPS):
        a = torch.zeros(6, 9)
        tan = kenv.handle_tangents(state.qpos[:1], params)[0, MICROWAVE]
        rad = state.ee_pos[0] - tan * STEP_LEN - pivot
        rad_p = rad - axis * torch.dot(rad, axis)
        targets = (pivot + axis * torch.dot(rad, axis) + rad_p / torch.linalg.norm(rad_p) * r0,
                   state.ee_pos[1] - tan0 * STEP_LEN)
        for env, tgt in enumerate(targets):
            q = state.qpos[env, :7]
            q_new = _ik(q.double(), tgt.double()).float()
            a[env, :7] = (q_new - q) / (kenv.ACT_AMP * kenv.CONTROL_DT)
        if step == 0:
            a[2:, 7:9] = -1.0          # close the grippers
        elif step >= 2:
            a[2, 0] = TURN             # turn the arm holding the kettle
        if float(a.abs().max()) > 1.0:
            raise RuntimeError(f"step {step}: an action leaves [-1, 1]: {a.abs().max()}")
        actions.append(a)
        state = kenv.kitchen_step(state, a, params)[0]
    return qpos0, grasped0, torch.stack(actions)


def _swept(ee, params):
    """Fingertip angle about the microwave's hinge per step [N_STEPS]."""
    pivot = params.pivots[MICROWAVE].numpy().astype(np.float64)
    axis = params.axes[MICROWAVE].numpy().astype(np.float64)
    u = ee - pivot
    u = u - np.outer(u @ axis, axis)
    cross = np.cross(u[:-1], u[1:]) @ axis
    return np.arctan2(cross, np.sum(u[:-1] * u[1:], -1))


def kitchen_bands(traj: Trajectory) -> dict:
    """{band: (held, value)} of the golden bands (BAND_NAMES) on a
    trajectory of the scenario batch."""
    golden = np.load(GOLDEN)
    params = kenv.default_kitchen_params(torch.device("cpu"))
    j = int(kenv.PRIMARY[MICROWAVE])
    q_arc, q_straight = float(traj.qpos[-1, 0, j]), float(traj.qpos[-1, 1, j])
    # the arc's steady drive: door angle over swept fingertip angle (the
    # golden slope: the door's steps over the MuJoCo arc's constant sweep)
    dq = np.abs(np.diff(traj.qpos[:, 0, j]))[2:]
    eff = float(dq.sum() / np.abs(_swept(traj.ee[:, 0], params))[2:].sum())
    arc = golden["arc_microwave"]
    golden_eff = float(np.abs(np.diff(arc))[2:].mean() / (0.75 / len(arc)))
    kettle = np.diff(traj.qpos[:, 2, 23:26], axis=0)[2:]
    moved = np.diff(traj.ee[:, 2], axis=0)[2:]
    gain = float(np.linalg.norm(kettle, axis=-1).sum() / np.linalg.norm(moved, axis=-1).sum())
    checks = [  # (held, value) in the order of BAND_NAMES
        (q_arc < -0.6, q_arc),
        (abs(q_straight) < 0.5 * abs(q_arc), q_straight),
        (abs(eff - golden_eff) < 0.02, eff),
        (bool(traj.grasped[1:, 2].all()),
         float(golden["kettle_grasp_offsets"][golden["kettle_grasp_ok"]].max())),
        (not traj.grasped[:, 3].any(),
         float(golden["kettle_grasp_offsets"][~golden["kettle_grasp_ok"]].min())),
        (abs(gain - 1.0) < 1e-3 and float(np.abs(kettle - moved).max()) < 1e-4, gain),
        (float(np.linalg.norm(kettle, axis=-1).max()) <= float(params.kettle_max_speed),
         float(np.linalg.norm(kettle, axis=-1).max())),
        (bool(traj.grasped[:, 4].all()),
         float(golden["kettle_yank_gap"])),
        (not traj.grasped[1:, 5].any(),
         float(golden["kettle_yank_gap"]) + 0.02 + RELEASE_MARGIN),
    ]
    return dict(zip(BAND_NAMES, checks))
