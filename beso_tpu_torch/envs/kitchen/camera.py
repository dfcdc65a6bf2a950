"""Pinhole-camera RGB rendering of the Franka-kitchen scene (torch port of
`beso_tpu/envs/kitchen/camera.py`).

The kitchen XML is not vendored, so the renderer ray-casts the documented
scene geometry that the surrogate physics shares (`envs/kitchen/geometry.py`,
`kitchen_handles`) from a fixed MuJoCo-like viewpoint: ray / oriented-box,
ray / cylinder and ray / sphere hits, nearest-hit occlusion and face
shading. Every task-relevant state is visible: the doors ride their joints,
the knob and switch levers their arcs, the light strip and the burner
patches brighten with their joints, the kettle tracks qpos[23:26], and the
robot is drawn as fingertip, wrist and finger spheres from the physics' FK.

The camera is fixed, so the pixel rays are a numpy grid computed once per
(h, w), as in the JAX module, and moved to each device once. The JAX
function renders one observation and is vmapped; this one takes a batch
[N, 30] and returns [N, h, w, 3]. The ~25 primitives are composed one after
the other, as in the JAX module; the static furniture (the same for every
frame) is cast once at [h, w] and broadcast, and so are the geometry of
the light strip and the burner patches, whose colours alone vary per
frame. Callers render under `torch.no_grad()`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from beso_tpu_torch.envs.kitchen.env import (KITCHEN_BASE_POS, default_kitchen_params,
                                             kitchen_handles)
from beso_tpu_torch.envs.kitchen.fk import panda_fk

# fixed viewpoint: in front of the kitchen, looking slightly down at the wall
CAMERA_POS = np.asarray([0.15, -1.15, 1.55], np.float32)
CAMERA_TARGET = np.asarray([-0.05, 0.90, 1.15], np.float32)
IMG_H, IMG_W = 128, 128
FOCAL_SCALE = 0.95            # fx = fy = FOCAL_SCALE * width

_FAR = 1e9
_EDGE = 0.004

# palette
_BG = np.asarray([0.93, 0.93, 0.91])
_WALL = np.asarray([0.82, 0.80, 0.76])
_COUNTER = np.asarray([0.55, 0.45, 0.38])
_PANEL = np.asarray([0.70, 0.70, 0.72])
_MICRO_BODY = np.asarray([0.25, 0.25, 0.28])
_MICRO_DOOR = np.asarray([0.45, 0.45, 0.50])
_SLIDE_DOOR = np.asarray([0.80, 0.60, 0.30])
_HINGE_DOOR = np.asarray([0.75, 0.55, 0.25])
_KNOB = np.asarray([0.85, 0.15, 0.12])
_KNOB2 = np.asarray([0.95, 0.45, 0.10])
_SWITCH = np.asarray([0.20, 0.45, 0.90])
_LIGHT_ON = np.asarray([1.00, 0.95, 0.55])
_KETTLE = np.asarray([0.30, 0.60, 0.30])
_ROBOT = np.asarray([0.12, 0.12, 0.14])
_FINGER = np.asarray([0.55, 0.55, 0.60])

_SHADE = np.asarray([0.80, 0.68, 1.0], np.float32)   # x-, y-, z-entry face brightness


def _look_at(eye, target, up=(0.0, 0.0, 1.0)):
    """Camera rotation whose +z looks from eye toward target (x right, y
    down, z forward)."""
    f = np.asarray(target, np.float64) - np.asarray(eye, np.float64)
    f = f / np.linalg.norm(f)
    r = np.cross(f, np.asarray(up, np.float64))
    r = r / np.linalg.norm(r)
    d = np.cross(f, r)                      # image-down
    return np.stack([r, d, f], axis=1)      # columns: cam axes in world


@functools.lru_cache(maxsize=4)
def kitchen_ray_grid(h: int = IMG_H, w: int = IMG_W) -> np.ndarray:
    """Precomputed [h, w, 3] world-frame pixel ray directions (float32)."""
    R = _look_at(CAMERA_POS, CAMERA_TARGET)
    fx = fy = FOCAL_SCALE * w
    cx, cy = w / 2.0, h / 2.0
    u = np.arange(w) + 0.5
    v = np.arange(h) + 0.5
    uu, vv = np.meshgrid(u, v)
    d_cam = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu)], -1)
    return (d_cam @ R.T).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _rays(h: int, w: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(kitchen_ray_grid(h, w), device=device)


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    # |d| < 1e-9 maps to +1e-9, tiny negative directions included (as JAX)
    return 1.0 / torch.where(torch.abs(d) < 1e-9, torch.full_like(d, 1e-9), d)


def _far_where(hit, t):
    return torch.where(hit, t, torch.full_like(t, _FAR))


def _ray_box_r(rays, center, Rbox, halfs):
    """Ray / oriented box (full rotation) for boxes with leading dims L:
    center [*L, 3], Rbox [*L, 3, 3] (box axes as columns), halfs (3 floats).
    Returns (t_enter [*L, h, w], _FAR at misses; mask; the shade of the
    entry face, `_SHADE` at the first argmax of the per-axis entries)."""
    o = _f32(CAMERA_POS, rays.device) - center
    lead = (...,) + (None,) * 2           # box scalars against the [h, w] grid
    los, his = [], []
    for i in range(3):
        # box-frame origin and ray direction along axis i (Rbox.T @ v)
        o_i = (Rbox[..., 0, i] * o[..., 0] + Rbox[..., 1, i] * o[..., 1]
               + Rbox[..., 2, i] * o[..., 2])[lead]
        d_i = (Rbox[..., 0, i][lead] * rays[..., 0] + Rbox[..., 1, i][lead] * rays[..., 1]
               + Rbox[..., 2, i][lead] * rays[..., 2])
        inv = _safe_inv(d_i)
        h = float(np.float32(halfs[i]))
        t1, t2 = (-h - o_i) * inv, (h - o_i) * inv
        los.append(torch.minimum(t1, t2))
        his.append(torch.maximum(t1, t2))
    t_enter = torch.maximum(torch.maximum(los[0], los[1]), los[2])
    t_exit = torch.minimum(torch.minimum(his[0], his[1]), his[2])
    hit = (t_exit > t_enter) & (t_enter > 0)
    mask = torch.clamp((t_exit - t_enter) / (_EDGE * 4.0), 0.0, 1.0) * hit
    shade = torch.where(los[0] == t_enter, float(_SHADE[0]),
                        torch.where(los[1] == t_enter, float(_SHADE[1]), float(_SHADE[2])))
    return _far_where(hit, t_enter), mask, shade


def _rot_z(a: torch.Tensor) -> torch.Tensor:
    """[N] angles -> [N, 3, 3] rotations about z."""
    c, s = torch.cos(a), torch.sin(a)
    z, one = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, one], -1)], -2)


def _ray_sphere(rays, center, radius):
    """Ray / sphere for N centers [N, 3]: (t [N, h, w], mask)."""
    o = _f32(CAMERA_POS, rays.device) - center
    b = 2.0 * torch.einsum("hwi,ni->nhw", rays, o)
    a = torch.sum(rays * rays, dim=-1)
    c = (torch.sum(o * o, dim=-1) - radius * radius)[:, None, None]
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = (-b - sq) / (2 * a)
    hit = (disc > 0) & (t > 0)
    mask = torch.clamp(sq / (_EDGE * 40.0), 0.0, 1.0) * hit
    return _far_where(hit, t), mask


def _ray_cyl_z(rays, center, radius, half_h):
    """Vertical cylinders centered at [N, 3] (z extent +-half_h)."""
    o = (_f32(CAMERA_POS, rays.device) - center)[:, None, None, :]
    dx, dy, dz = rays[..., 0], rays[..., 1], rays[..., 2]
    a = dx * dx + dy * dy
    b = 2.0 * (o[..., 0] * dx + o[..., 1] * dy)
    c = o[..., 0] * o[..., 0] + o[..., 1] * o[..., 1] - radius * radius
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_in = (-b - sq) / (2 * a)
    t_out = (-b + sq) / (2 * a)
    inv_z = _safe_inv(dz)
    tz1 = (-half_h - o[..., 2]) * inv_z
    tz2 = (half_h - o[..., 2]) * inv_z
    t_enter = torch.maximum(t_in, torch.minimum(tz1, tz2))
    t_exit = torch.minimum(t_out, torch.maximum(tz1, tz2))
    hit = (disc > 0) & (t_exit > t_enter) & (t_enter > 0)
    return _far_where(hit, t_enter), hit.float()


def _static_boxes():
    """(center, halfs, color) of the static furniture (axis-aligned)."""
    return [
        # cabinet-run wall plane (thick slab behind everything)
        ((0.0, 1.00, 1.20), (1.1, 0.03, 0.65), _WALL),
        # knob backsplash panel
        ((0.30, 0.935, 1.17), (0.22, 0.015, 0.28), _PANEL),
        # counter top (the kettle body bottom rests at z ~ 1.56)
        ((0.0, 0.80, 1.54), (1.0, 0.18, 0.02), _COUNTER),
        # microwave body (hinge at x=-0.60; body to the left/behind)
        ((-0.38, 0.88, 0.90), (0.24, 0.12, 0.17), _MICRO_BODY),
        # hinge-cabinet body (door hinge at x=0.15, z=1.40)
        ((0.0, 1.0, 1.40), (0.16, 0.05, 0.18), _MICRO_BODY),
    ]


class _Canvas:
    """Image [.., h, w, 3] and nearest depth [.., h, w] composed one
    primitive at a time: each draws only where it is nearer than all drawn
    so far (`add_box` / `add_sphere` / `add_cyl` of the JAX module)."""

    def __init__(self, img, t_near):
        self.img, self.t_near = img, t_near

    def add(self, t, m, col):
        vis = m * (t < self.t_near)
        self.img = self.img * (1 - vis[..., None]) + vis[..., None] * col
        self.t_near = torch.minimum(self.t_near, _far_where(m > 0.5, t))


def render_kitchen_obs_rgb(obs30: torch.Tensor, h: int = IMG_H,
                           w: int = IMG_W) -> torch.Tensor:
    """RGB [N, h, w, 3] float32 in [0, 1] from kitchen observations [N, 30]
    (the kitchen_obs layout, qpos[:30])."""
    N, dev = obs30.shape[0], obs30.device
    rays = _rays(h, w, dev)
    eye = torch.eye(3, device=dev)

    def box_hit(center, R, halfs):
        t, m, shade = _ray_box_r(rays, center, R, halfs)
        return t, m, shade[..., None]

    # --- static furniture, the same in every frame --------------------------
    cv = _Canvas(_f32(_BG, dev).expand(h, w, 3), torch.full((h, w), _FAR, device=dev))
    for center, halfs, color in _static_boxes():
        t, m, sh = box_hit(_f32(center, dev), eye, halfs)
        cv.add(t, m, _f32(color, dev) * sh)
    cv = _Canvas(cv.img.expand(N, h, w, 3), cv.t_near.expand(N, h, w))

    def col(c):   # per-frame colours [N, 3] -> [N, 1, 1, 3]
        return c[:, None, None, :]

    # light indicator: the backsplash strip brightens with the light joint
    on = torch.clamp(obs30[:, 17] / -0.69, 0.0, 1.0)[:, None]
    strip_col = (1 - on) * _f32(_PANEL, dev) + on * _f32(_LIGHT_ON, dev)
    t, m, sh = box_hit(_f32((0.12, 0.925, 1.30), dev), eye, (0.05, 0.012, 0.03))
    cv.add(t, m, col(strip_col) * sh)
    # burner glow patches: the stove glows as the knob turns
    for idx, z, glow_col in ((11, 1.00, _KNOB), (15, 1.10, _KNOB2)):
        glow = torch.clamp(obs30[:, idx] / -0.9, 0.0, 1.0)[:, None]
        patch = (1 - glow) * _f32(_PANEL, dev) + glow * _f32(glow_col, dev)
        t, m, sh = box_hit(_f32((0.46, 0.925, z), dev), eye, (0.035, 0.012, 0.035))
        cv.add(t, m, col(patch) * sh)

    # --- articulated doors (qpos-driven oriented boxes) ---------------------
    # microwave door: hinge line at x=-0.60, y=0.80; opens toward -y
    Rm = _rot_z(obs30[:, 22])
    c_m = _f32((-0.60, 0.80, 0.90), dev) + torch.einsum(
        "nij,j->ni", Rm, _f32((0.21, -0.02, 0.0), dev))
    t, m, sh = box_hit(c_m, Rm, (0.21, 0.015, 0.16))
    cv.add(t, m, _f32(_MICRO_DOOR, dev) * sh)
    # hinge-cabinet door: hinge at x=0.15, y=0.95, z=1.40; opens +1.45
    Rh = _rot_z(obs30[:, 21])
    c_h = _f32((0.15, 0.95, 1.40), dev) + torch.einsum(
        "nij,j->ni", Rh, _f32((-0.15, -0.05, 0.0), dev))
    t, m, sh = box_hit(c_h, Rh, (0.15, 0.015, 0.17))
    cv.add(t, m, _f32(_HINGE_DOOR, dev) * sh)
    # slide-cabinet door: translates along +x by q19
    c_s = _f32((0.47, 0.87, 1.40), dev) + obs30[:, 19:20] * _f32((1.0, 0.0, 0.0), dev)
    t, m, sh = box_hit(c_s, eye.expand(N, 3, 3), (0.10, 0.015, 0.15))
    cv.add(t, m, _f32(_SLIDE_DOOR, dev) * sh)

    # --- levers (handle positions ride their true arcs) ---------------------
    handles = kitchen_handles(obs30, default_kitchen_params(dev))
    for i, radius, color in ((0, 0.030, _KNOB), (1, 0.030, _KNOB2), (2, 0.032, _SWITCH)):
        cv.add(*_ray_sphere(rays, handles[:, i], radius), _f32(color, dev))
    # slide / hinge / microwave handle bars (vertical cylinders)
    for i, half_h, color in ((3, 0.06, _SLIDE_DOOR), (4, 0.08, _HINGE_DOOR),
                             (5, 0.06, _MICRO_DOOR)):
        cv.add(*_ray_cyl_z(rays, handles[:, i], 0.012, half_h), _f32(color * 0.6, dev))

    # --- kettle (free body) --------------------------------------------------
    kpos = obs30[:, 23:26]
    cv.add(*_ray_cyl_z(rays, kpos, 0.065, 0.055), _f32(_KETTLE, dev))
    cv.add(*_ray_sphere(rays, kpos + _f32((0.0, 0.0, 0.09), dev), 0.022),
           _f32(_KETTLE * 0.7, dev))

    # --- robot: fingertip + wrist from the same FK the physics uses ---------
    ee = panda_fk(obs30[:, :7], KITCHEN_BASE_POS)
    base = _f32(KITCHEN_BASE_POS, dev)
    cv.add(*_ray_sphere(rays, base + 0.75 * (ee - base), 0.045), _f32(_ROBOT, dev))
    cv.add(*_ray_sphere(rays, ee, 0.030), _f32(_ROBOT, dev))
    # finger opening is task-relevant (kettle grasp): two pads split by q7
    gap = torch.stack([0.012 + obs30[:, 7], torch.zeros_like(ee[:, 0]),
                       torch.zeros_like(ee[:, 0])], -1)
    cv.add(*_ray_sphere(rays, ee + gap, 0.012), _f32(_FINGER, dev))
    cv.add(*_ray_sphere(rays, ee - gap, 0.012), _f32(_FINGER, dev))
    return cv.img
