"""Franka Emika Panda forward kinematics, batched (torch port of
`beso_tpu/envs/kitchen/fk.py`).

Modified-DH (Craig convention) parameters of the published Panda, chained
in float32 like the JAX version: the fingertip position of the kitchen
surrogate dynamics.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# modified DH rows: (a_{i-1}, d_i, alpha_{i-1}) for joints 1..7
_PANDA_DH = (
    (0.0, 0.333, 0.0),
    (0.0, 0.0, -math.pi / 2),
    (0.0, 0.316, math.pi / 2),
    (0.0825, 0.0, math.pi / 2),
    (-0.0825, 0.384, -math.pi / 2),
    (0.0, 0.0, math.pi / 2),
    (0.088, 0.0, math.pi / 2),
)
_FLANGE_D = 0.107
_GRIPPER_TIP_D = 0.103  # flange -> fingertip (Franka hand)


def _cos_sin(alpha: float):
    """cos and sin of a link's twist, computed in f32 as jnp.cos does."""
    al = torch.tensor(alpha, dtype=torch.float32)
    return torch.cos(al).item(), torch.sin(al).item()


def _mdh_transform(a: float, d: float, alpha: float,
                   theta: torch.Tensor) -> torch.Tensor:
    """[B, 4, 4] link transforms for joint angles theta [B]."""
    ca, sa = _cos_sin(alpha)
    ct, st = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(theta), torch.ones_like(theta)
    rows = [
        [ct, -st, zero, zero + a],
        [st * ca, ct * ca, zero - sa, zero - d * sa],
        [st * sa, ct * sa, zero + ca, zero + d * ca],
        [zero, zero, zero, one],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def panda_fk(q: torch.Tensor, base_pos=(0.0, 0.0, 0.0),
             tip_offset: float = _FLANGE_D + _GRIPPER_TIP_D) -> torch.Tensor:
    """Fingertip world positions [B, 3] for joint angles q [B, 7]."""
    T = torch.eye(4, dtype=q.dtype, device=q.device).expand(q.shape[0], 4, 4)
    for i, (a, d, alpha) in enumerate(_PANDA_DH):
        T = T @ _mdh_transform(a, d, alpha, q[:, i])
    T = T @ _mdh_transform(0.0, tip_offset, 0.0, torch.zeros_like(q[:, 0]))
    return T[:, :3, 3] + torch.tensor(base_pos, dtype=q.dtype, device=q.device)


def mdh_table(tip_offset: float = _FLANGE_D + _GRIPPER_TIP_D) -> np.ndarray:
    """The constant entries of `panda_fk`'s transforms, the 7 links and the
    fingertip (theta 0), as `_mdh_transform` rounds them to f32: rows
    (a, cos alpha, sin alpha, d sin alpha, d cos alpha) [8, 5], the table
    of the CUDA kitchen step (`csrc/kitchen_step.cu`)."""
    rows = []
    for a, d, alpha in (*_PANDA_DH, (0.0, tip_offset, 0.0)):
        ca, sa = _cos_sin(alpha)
        rows.append((a, ca, sa, d * sa, d * ca))
    return np.asarray(rows, np.float32)
