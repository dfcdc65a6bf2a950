"""UFACTORY xArm6 kinematics: FK and damped-least-squares IK (torch port of
`beso_tpu/envs/block_push/xarm.py`, the reference's `XArmSimRobot`,
`beso/envs/block_pushing/utils/xarm_sim_robot.py:33-235`).

The joint chain is the public xArm6 URDF's joint origins with the JAX
package's link-6 offset, calibrated to the reference test's golden FK
(joints [0, pi/2, pi, 0, 0, 0] -> (0.714479, -0.0006)). Batched over
leading dims: joints [..., 6]. The IK runs the reference's 100 iterations
of damped least squares on the FK's jacobian, taken in forward mode as in
`jax.jacfwd`: the six directions as one batched jvp, outside inference
mode (some torch builds return zero tangents inside it; ROADMAP C2).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from beso_tpu_torch.envs.pose3d import (Pose3d, quat_conj, quat_from_matrix, quat_mul,
                                        quat_to_rotvec)

# joint origins (xyz, rpy) from pybullet_data xarm/xarm6_robot.urdf
_JOINTS = (
    ((0.0, 0.0, 0.267), (0.0, 0.0, 0.0)),
    ((0.0, 0.0, 0.0), (-1.5708, 0.0, 0.0)),
    ((0.0535, -0.2845, 0.0), (0.0, 0.0, 0.0)),
    ((0.0775, 0.3425, 0.0), (-1.5708, 0.0, 0.0)),
    ((0.0, 0.0, 0.0), (1.5708, 0.0, 0.0)),
    ((0.076, 0.097, 0.0), (-1.5708, 0.0, 0.0)),
)
# link-6 frame offset (Bullet reports the link COM frame), calibrated to the
# reference FK test values
_TIP_OFFSET = (0.0, 0.0006, -0.009521)
HOME_JOINTS = (0.0, -0.5, -0.5, 0.0, 0.0, 0.0)


def _rpy_matrix(r, p, y) -> np.ndarray:
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    Rz = np.asarray([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]], np.float32)
    Ry = np.asarray([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]], np.float32)
    Rx = np.asarray([[1.0, 0.0, 0.0], [0.0, cr, -sr], [0.0, sr, cr]], np.float32)
    return Rz @ Ry @ Rx


def _joint_frames(device, dtype) -> torch.Tensor:
    """The six fixed joint-origin transforms [6, 4, 4]."""
    T = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    for i, (xyz, rpy) in enumerate(_JOINTS):
        T[i, :3, :3] = _rpy_matrix(*rpy)
        T[i, :3, 3] = xyz
    return torch.as_tensor(T, device=device, dtype=dtype)


def xarm_fk(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics: joint angles [..., 6] -> (position [..., 3],
    rotation [..., 3, 3])."""
    frames = _joint_frames(q.device, q.dtype)
    T = torch.eye(4, device=q.device, dtype=q.dtype).expand(*q.shape[:-1], 4, 4)
    zero, one = torch.zeros_like(q[..., 0]), torch.ones_like(q[..., 0])
    for i in range(6):
        c, s = torch.cos(q[..., i]), torch.sin(q[..., i])
        Rz = torch.stack([torch.stack([c, -s, zero, zero], -1),
                          torch.stack([s, c, zero, zero], -1),
                          torch.stack([zero, zero, one, zero], -1),
                          torch.stack([zero, zero, zero, one], -1)], -2)
        T = T @ frames[i] @ Rz
    offset = torch.tensor(_TIP_OFFSET, device=q.device, dtype=q.dtype)
    pos = T[..., :3, 3] + (T[..., :3, :3] @ offset[:, None])[..., 0]
    return pos, T[..., :3, :3]


def xarm_fk_pose(q: torch.Tensor) -> Pose3d:
    pos, R = xarm_fk(q)
    return Pose3d(rotation=quat_from_matrix(R), translation=pos)


def xarm_ik(target_pose: Pose3d, q_init: Optional[torch.Tensor] = None, iters: int = 100,
            damping: float = 1e-4) -> torch.Tensor:
    """Damped-least-squares IK toward (position, orientation) over leading
    dims (the reference's 100 Bullet IK iterations, xarm_sim_robot.py:
    185-200); ~1e-3 pose error for reachable targets. `q_init` defaults to
    HOME_JOINTS."""
    t, rot = target_pose.translation, target_pose.rotation
    lead = t.shape[:-1]
    q = (torch.tensor(HOME_JOINTS, device=t.device, dtype=t.dtype) if q_init is None
         else q_init)
    q = q.expand(*lead, 6).reshape(-1, 6)
    t, rot = t.reshape(-1, 3), rot.reshape(-1, 4)
    n = q.shape[0]

    def error(qq, tt, rr):   # target - fk(q): position, then rotation as a rotvec
        pose = xarm_fk_pose(qq)
        return torch.cat([tt - pose.translation,
                          quat_to_rotvec(quat_mul(rr, quat_conj(pose.rotation)))], -1)

    with torch.inference_mode(False):
        q = q.clone()
        t6, r6 = t.clone().repeat(6, 1), rot.clone().repeat(6, 1)
        dirs = torch.eye(6, device=q.device, dtype=q.dtype).repeat_interleave(n, 0)
        eye = torch.eye(6, device=q.device, dtype=q.dtype)
        for _ in range(iters):
            e6, jt = torch.func.jvp(lambda x: error(x, t6, r6), (q.repeat(6, 1),), (dirs,))
            e = e6[:n]
            J = -jt.reshape(6, n, 6).permute(1, 2, 0)          # d fk / d q [n, 6, 6]
            H = J @ J.transpose(1, 2) + damping * eye
            dq = (J.transpose(1, 2) @ torch.linalg.solve(H, e[..., None]))[..., 0]
            q = q + torch.clamp(dq, -0.3, 0.3)
    return q.reshape(*lead, 6)
