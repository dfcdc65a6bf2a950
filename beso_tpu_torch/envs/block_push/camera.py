"""Pinhole-camera rendering of the block-push scene (torch port of
`beso_tpu/envs/block_push/camera.py`).

Functional parity target: the reference's GL camera with RealSense D415
parameters (`beso/envs/block_pushing/block_pushing.py:103-117`) and its
view construction (`:627-658`); see the JAX module for the scene model.
The camera is fixed, so the pixel ray directions and their tabletop hits
are numpy float64 grids computed once per (h, w, zoom), as in the JAX
module, then moved to each device once. A frame is ray-cast analytically
over that grid: the two blocks as yaw-oriented boxes, the effector as a
vertical cylinder, nearest-hit occlusion with top/side shading, and the
target zones as tabletop decals.

The JAX functions render one observation and are vmapped; these take a
batch of observations [N, 16] and return [N, h, w, C], every per-frame
scalar broadcast as [N, 1, 1] against the [h, w] grid. Callers render
under `torch.no_grad()`: the frames are a function of the data only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from beso_tpu_torch.envs.block_push.env import (BLOCK_HALF, EFFECTOR_RADIUS,
                                                GOAL_DIST_TOLERANCE)

# reference camera constants (block_pushing.py:103-117)
CAMERA_POSE = np.asarray([1.0, 0.0, 0.75])
CAMERA_ORIENTATION = np.asarray([np.pi / 4, np.pi, -np.pi / 2])  # XYZ Euler
FOCAL_SCALE = 0.803          # fx = fy = 0.803 * width

IMG_H, IMG_W = 64, 64

_EDGE = 0.004                # soft edge width (m) for anti-aliased blends

# scene palette (background table, blocks, targets, effector)
_BG = np.asarray([0.92, 0.92, 0.90])
_BLOCK_COLORS = np.asarray([[0.85, 0.20, 0.15], [0.15, 0.65, 0.25]])
_TARGET_COLORS = np.asarray([[0.95, 0.55, 0.50], [0.55, 0.85, 0.60]])
_EFFECTOR_COLOR = np.asarray([0.10, 0.10, 0.12])

_FAR = 1e9
_EFFECTOR_HEIGHT = 0.135     # cylinder_real.urdf total length


def _euler_xyz_to_matrix(e):
    """pybullet getQuaternionFromEuler convention: extrinsic XYZ."""
    rx, ry, rz = e
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.asarray([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.asarray([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.asarray([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _camera_rays(h: int, w: int, zoom: float) -> np.ndarray:
    """World-frame pixel ray directions [h, w, 3], float64; `zoom` != 1
    scales the focal length and re-aims the principal point at the
    workspace center's projection (see `table_grid`)."""
    R = _euler_xyz_to_matrix(CAMERA_ORIENTATION)
    fx = fy = FOCAL_SCALE * w * zoom
    cx, cy = w / 2.0, h / 2.0
    if zoom != 1.0:
        c_world = np.asarray([0.425, 0.0, 0.0])
        d = R.T @ (c_world - CAMERA_POSE)       # camera-frame direction
        cx = w / 2.0 - fx * d[0] / d[2]
        cy = h / 2.0 - fy * d[1] / d[2]
    u = np.arange(w) + 0.5
    v = np.arange(h) + 0.5
    uu, vv = np.meshgrid(u, v)
    d_cam = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu)], -1)
    return d_cam @ R.T


@functools.lru_cache(maxsize=8)
def ray_grid(h: int = IMG_H, w: int = IMG_W, zoom: float = 1.0) -> np.ndarray:
    """Precomputed [h, w, 3] world-frame pixel ray directions (float32)."""
    return _camera_rays(h, w, zoom).astype(np.float32)


@functools.lru_cache(maxsize=8)
def table_grid(h: int = IMG_H, w: int = IMG_W, zoom: float = 1.0) -> np.ndarray:
    """Precomputed [h, w, 2] world xy where each pixel ray meets the
    tabletop plane z=0. `zoom` > 1 is a central crop of the same camera
    (identical pose and projective geometry)."""
    d_world = _camera_rays(h, w, zoom)
    t = -CAMERA_POSE[2] / d_world[..., 2]       # ray parameter to z=0
    pts = CAMERA_POSE[None, None, :] + d_world * t[..., None]
    return pts[..., :2].astype(np.float32)


@functools.lru_cache(maxsize=16)
def _grids(h: int, w: int, zoom: float, device: torch.device):
    """(table grid [h, w, 2], ray grid [h, w, 3]) on `device`."""
    return (torch.as_tensor(table_grid(h, w, zoom), device=device),
            torch.as_tensor(ray_grid(h, w, zoom), device=device))


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def _col(v) -> torch.Tensor:
    """Per-frame scalars [N] -> [N, 1, 1]."""
    return v[:, None, None]


def _soft_in_circle(grid, center, radius):
    """grid [h, w, 2], centers [N, 2] -> soft disc masks [N, h, w]."""
    rel = grid - center[:, None, None, :]
    d = torch.sqrt(rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1])
    return torch.clamp((radius - d) / _EDGE + 0.5, 0.0, 1.0)


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    # |d| < 1e-9 maps to +1e-9, tiny negative directions included (as JAX)
    return 1.0 / torch.where(torch.abs(d) < 1e-9, torch.full_like(d, 1e-9), d)


def _slab(o, d, half):
    """Entry and exit ray parameters of the slab |x| <= half along one axis,
    ray origin o and direction d in the box frame."""
    inv = _safe_inv(d)
    t1 = (-half - o) * inv
    t2 = (half - o) * inv
    return torch.minimum(t1, t2), torch.maximum(t1, t2)


def _ray_box(rays, center_xy, yaw, half, height):
    """Ray / yaw-oriented box (z in [0, height]) over the pixel grid for N
    boxes: centers [N, 2], yaws [N]. Returns (t_enter [N, h, w], _FAR where
    missed; soft mask [N, h, w]; top [N, h, w] bool, the entry face is the
    top: the first argmax of the per-axis entries is z)."""
    o = CAMERA_POSE.astype(np.float32)
    c, s = _col(torch.cos(yaw)), _col(torch.sin(yaw))
    # box-local frame: rotate xy by -yaw, shift z so the box is centered
    rx, ry = _col(float(o[0]) - center_xy[:, 0]), _col(float(o[1]) - center_xy[:, 1])
    ox = c * rx + s * ry
    oy = -s * rx + c * ry
    oz = float(np.float32(o[2]) - np.float32(height / 2.0))
    lo_x, hi_x = _slab(ox, c * rays[..., 0] + s * rays[..., 1], float(np.float32(half)))
    lo_y, hi_y = _slab(oy, -s * rays[..., 0] + c * rays[..., 1], float(np.float32(half)))
    lo_z, hi_z = _slab(oz, rays[..., 2], float(np.float32(height / 2.0)))
    t_enter = torch.maximum(torch.maximum(lo_x, lo_y), lo_z)
    t_exit = torch.minimum(torch.minimum(hi_x, hi_y), hi_z)
    # soft silhouette: the chord length fades grazing rays
    chord = t_exit - t_enter
    mask = torch.clamp(chord / (_EDGE * 4.0), 0.0, 1.0) * (t_enter > 0)
    top = (lo_z == t_enter) & (lo_x != t_enter) & (lo_y != t_enter)
    t = torch.where((chord > 0) & (t_enter > 0), t_enter, torch.full_like(t_enter, _FAR))
    return t, mask, top


def _ray_cylinder(rays, center_xy, radius, height):
    """Ray / vertical cylinder (z in [0, height]) for N cylinders, centers
    [N, 2]. Returns (t_enter with _FAR where missed, soft mask, top bool)."""
    o = CAMERA_POSE.astype(np.float32)
    ox = _col(float(o[0]) - center_xy[:, 0])
    oy = _col(float(o[1]) - center_xy[:, 1])
    dx, dy, dz = rays[..., 0], rays[..., 1], rays[..., 2]
    a = dx * dx + dy * dy
    b = 2.0 * (ox * dx + oy * dy)
    cc = ox * ox + oy * oy - radius * radius
    disc = b * b - 4 * a * cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_in = (-b - sq) / (2 * a)
    t_out = (-b + sq) / (2 * a)
    # clip to the z-slab [0, height]
    inv_z = _safe_inv(dz)
    tz1 = (0.0 - o[2]) * inv_z
    tz2 = (np.float32(height) - o[2]) * inv_z
    tz_lo = torch.minimum(tz1, tz2)
    tz_hi = torch.maximum(tz1, tz2)
    t_enter = torch.maximum(t_in, tz_lo)
    t_exit = torch.minimum(t_out, tz_hi)
    chord = torch.where(disc > 0, t_exit - t_enter, torch.full_like(t_enter, -1.0))
    mask = torch.clamp(chord / (_EDGE * 4.0), 0.0, 1.0) * (t_enter > 0)
    top = tz_lo > t_in                      # entered through the top cap
    t = torch.where((chord > 0) & (t_enter > 0), t_enter, torch.full_like(t_enter, _FAR))
    return t, mask, top


def _solid_hits(obs16, rays):
    """(t, mask, shade, color) per 3-D solid: 2 blocks + effector. Side
    faces are darkened 0.72x (effector 0.80x), top faces lit 1.0x."""
    dev = rays.device
    hits = []
    for b, (p0, yi) in enumerate(((0, 2), (3, 5))):
        t, m, top = _ray_box(rays, obs16[:, p0:p0 + 2], obs16[:, yi],
                             BLOCK_HALF, 2 * BLOCK_HALF)
        shade = torch.where(top, 1.0, 0.72)
        hits.append((t, m, shade, _f32(_BLOCK_COLORS[b], dev)))
    t, m, top = _ray_cylinder(rays, obs16[:, 6:8], EFFECTOR_RADIUS, _EFFECTOR_HEIGHT)
    shade = torch.where(top, 1.0, 0.80)
    hits.append((t, m, shade, _f32(_EFFECTOR_COLOR, dev)))
    return hits


def _blend(img, mask, color):
    return img * (1 - mask[..., None]) + mask[..., None] * color


def render_obs_rgb(obs16: torch.Tensor, h: int = IMG_H, w: int = IMG_W,
                   zoom: float = 2.0) -> torch.Tensor:
    """RGB [N, h, w, 3] float32 in [0, 1] from observations [N, 16] (the
    block_push_obs layout). Default zoom=2 is the policy crop. Blocks and
    the effector are ray-cast 3-D solids with nearest-hit occlusion;
    targets are tabletop decals."""
    dev = obs16.device
    grid, rays = _grids(h, w, float(zoom), dev)
    img = _f32(_BG, dev).expand(obs16.shape[0], h, w, 3)

    # target zones (tabletop decals, underneath everything)
    for t, p0 in enumerate((10, 13)):
        mask = _soft_in_circle(grid, obs16[:, p0:p0 + 2], GOAL_DIST_TOLERANCE)
        img = _blend(img, mask, _f32(_TARGET_COLORS[t], dev))

    # 3-D solids: each draws only where it is nearer than all drawn so far
    t_near = torch.full(img.shape[:3], _FAR, device=dev)
    for t_hit, mask, shade, color in _solid_hits(obs16, rays):
        vis = mask * (t_hit < t_near)
        img = _blend(img, vis, color * shade[..., None])
        t_near = torch.minimum(t_near, torch.where(mask > 0.5, t_hit,
                                                   torch.full_like(t_hit, _FAR)))
    return img


def render_obs_masks(obs16: torch.Tensor, h: int = IMG_H, w: int = IMG_W,
                     zoom: float = 2.0) -> torch.Tensor:
    """Per-object soft masks [N, h, w, 5] through the same camera:
    (block0, block1, target0, target1, effector); the solid channels are
    the ray-cast 3-D silhouettes (the reference's GL render requests the
    segmentation mask, block_pushing.py:670)."""
    grid, rays = _grids(h, w, float(zoom), obs16.device)
    _, mb0, _ = _ray_box(rays, obs16[:, 0:2], obs16[:, 2], BLOCK_HALF, 2 * BLOCK_HALF)
    _, mb1, _ = _ray_box(rays, obs16[:, 3:5], obs16[:, 5], BLOCK_HALF, 2 * BLOCK_HALF)
    _, me, _ = _ray_cylinder(rays, obs16[:, 6:8], EFFECTOR_RADIUS, _EFFECTOR_HEIGHT)
    return torch.stack([mb0, mb1,
                        _soft_in_circle(grid, obs16[:, 10:12], GOAL_DIST_TOLERANCE),
                        _soft_in_circle(grid, obs16[:, 13:15], GOAL_DIST_TOLERANCE),
                        me], dim=-1)
