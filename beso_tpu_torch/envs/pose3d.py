"""Minimal 3D pose math: quaternions (x, y, z, w), rotvecs, yaw (torch port
of `beso_tpu/envs/pose3d.py`, itself the reference's `Pose3d`,
`beso/envs/block_pushing/utils/pose3d.py:40-70`, which wraps
scipy.spatial.transform.Rotation).

Every function works over leading dims: a quaternion is [..., 4], a rotvec
[..., 3], a rotation matrix [..., 3, 3].
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Pose3d(NamedTuple):
    rotation: torch.Tensor     # quaternion [..., 4] (x, y, z, w)
    translation: torch.Tensor  # [..., 3]

    @property
    def vec7(self) -> torch.Tensor:
        """[tx, ty, tz, qx, qy, qz, qw] (pose3d.py:55-58)."""
        return torch.cat([self.translation, self.rotation], -1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1)


def quat_from_rotvec(rotvec: torch.Tensor) -> torch.Tensor:
    angle = _norm(rotvec)
    axis = rotvec / torch.clamp(angle, min=1e-12)[..., None]
    half = angle / 2.0
    xyz = torch.where((angle > 1e-12)[..., None], axis * torch.sin(half)[..., None],
                      rotvec / 2.0)
    return torch.cat([xyz, torch.cos(half)[..., None]], -1)


def quat_to_rotvec(q: torch.Tensor) -> torch.Tensor:
    q = q * torch.sign(q[..., 3:4] + 1e-30)  # shortest arc
    xyz, w = q[..., :3], q[..., 3]
    n = _norm(xyz)
    angle = 2.0 * torch.atan2(n, w)
    return torch.where((n > 1e-12)[..., None],
                       xyz / torch.clamp(n, min=1e-12)[..., None] * angle[..., None],
                       2.0 * xyz)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], -1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], -1)


def quat_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion: of the four candidate constructions,
    the one with the largest pivot (the first on ties), normalized."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    cands = torch.stack([
        torch.stack([m21 - m12, m02 - m20, m10 - m01, 1 + tr], -1),
        torch.stack([1 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], -1),
        torch.stack([m01 + m10, 1 - m00 + m11 - m22, m12 + m21, m02 - m20], -1),
        torch.stack([m02 + m20, m12 + m21, 1 - m00 - m11 + m22, m10 - m01], -1),
    ], -2)
    pivots = torch.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                          1 - m00 - m11 + m22], -1)
    idx = torch.argmax(pivots, -1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    return q / _norm(q)[..., None]


def matrix_from_quat(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def yaw_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Z euler angle ('xyz' convention last component, block_pushing.py:500-501)."""
    x, y, z, w = q.unbind(-1)
    return torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
