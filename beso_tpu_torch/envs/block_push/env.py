"""Batched planar Block Push Multimodal environment (torch port of
`beso_tpu/envs/block_push/env.py`).

Same scene, reset distributions, 16-dim observation layout, reward and
completion logic and planar rigid-body contact model as the JAX version
(see its docstring for the parity targets in the reference's
`block_pushing_multimodal.py` and the calibration of every constant), written
over an explicit leading batch dimension instead of `vmap`:

* per-env scalars are [B] tensors, per-block ones [B, 2], vectors carry a
  trailing xy dim; the two blocks of the pusher contact, of the ground
  friction and of the reward are one batched op each;
* the 24-substep `lax.scan` is a Python loop over substeps;
* reset rejection sampling stays a branch-free first-valid pick over 64
  candidate pairs, drawn from an explicit `torch.Generator`;
* every argmin / argmax is an explicit first-index pick (`_first_true`),
  the convention of `jnp.argmin` / `jnp.argmax` on ties;
* finished envs stay frozen field by field.

`_push_block`, the quasi-static point push of the single-block envs
(`envs/block_push/single.py`), is ported beside the multimodal env's
dynamics; `block_push_step` does not call it.

Only the shipped laws are ported: the 2-point box-box manifold for the
block-block contact (`BB_BOX_BOX = True` in the JAX module; the legacy
box-vs-disk pair behind `BB_BOX_BOX = False` is not), and the face-slab
normal in the pusher contact's corner region (`CORNER_RADIAL = False`;
the radial normal is not).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

# scene constants (block_pushing.py:46-49, block_pushing_multimodal.py:45-52)
EFFECTOR_HEIGHT = 0.06
WORKSPACE_BOUNDS = ((0.15, -0.5), (0.7, 0.5))
MIN_BLOCK_DIST = 0.1
MIN_TARGET_DIST = 0.12
RANDOM_X_SHIFT = 0.1
RANDOM_Y_SHIFT = 0.15
GOAL_DIST_TOLERANCE = 0.05
WORKSPACE_CENTER_X = 0.4
EFFECTOR_START = (0.3, -0.4)

# contact-model constants: the JAX module's values (URDF-derived or
# calibrated against the host-MuJoCo golden rollouts; its comments say which)
BLOCK_HALF = 0.02
EFFECTOR_RADIUS = 0.0127
BLOCK_BLOCK_RADIUS = 0.026
EFFECTOR_SPEED = 1.0
CONTROL_DT = 0.1
N_SUBSTEPS = 24
FRICTION_K2 = (2.0 / 3.0) * BLOCK_HALF * BLOCK_HALF
# pusher-block friction of the quasi-static push law's motion cone
# (`_push_block`; beso_tpu/envs/block_push/env.py:78)
PUSHER_MU = 0.5
SUB_DT = CONTROL_DT / N_SUBSTEPS
BLOCK_MASS = 0.01
INV_I = 1.0 / (BLOCK_MASS * FRICTION_K2)   # inverse yaw inertia at the shipped k2
GRAVITY = 9.81
GROUND_MU = 1.0
CONTACT_MU = 0.05
FN_CAP = 0.16
TIP_LEAK = 0.1
BACKED_MARGIN = 0.005
BACKED_COS = 0.6
PLOW_RANGE = 0.12
BACKED_STIFF = 8.0
TIP_TORQUE_LEAK = 0.0
DAMP_RATIO = 1.0
CONTACT_K = BLOCK_MASS / (0.02 * 0.02)
CONTACT_B = 2.0 * BLOCK_MASS / 0.02
V_EPS = 0.002
CONTACT_DITHER = 5e-4
DITHER_ANG = 0.08
BB_DITHER_ANG = 0.08
# ground friction at the 4 face corners, each carrying m g / 4
_GROUND_PTS = np.asarray([[1.0, 1.0], [1.0, -1.0], [-1.0, 1.0], [-1.0, -1.0]]) * BLOCK_HALF
F_G_MAX = GROUND_MU * BLOCK_MASS * GRAVITY / 4.0

_RESET_CANDIDATES = 64

_HASH_W = np.asarray([[12.9898, 78.233, 37.719, 93.989, 53.711],
                      [26.651, 9.271, 61.423, 41.339, 83.155],
                      [7.151, 94.673, 17.923, 57.341, 31.117],
                      [68.237, 23.989, 88.409, 11.131, 47.777]], np.float32)
_HASH_F = np.asarray([43.7585453, 24.6346345, 36.1274199, 52.9832117], np.float32)


class BlockPushState(NamedTuple):
    """Physics and bookkeeping state of B envs."""

    effector: torch.Tensor          # [B, 2]
    effector_target: torch.Tensor   # [B, 2]
    block_pos: torch.Tensor         # [B, 2, 2]
    block_yaw: torch.Tensor         # [B, 2]
    target_pos: torch.Tensor        # [B, 2, 2]
    target_yaw: torch.Tensor        # [B, 2]
    in_target: torch.Tensor         # [B, 2, 2] bool, first-entry latch [t, b]
    completed: torch.Tensor         # [B, 4] bool, task ids 2*b + t
    done: torch.Tensor              # [B] bool
    steps: torch.Tensor             # [B] int32
    block_vel: torch.Tensor         # [B, 2, 2] m/s
    block_yawrate: torch.Tensor     # [B, 2] rad/s


class _Consts(NamedTuple):
    hash_w: torch.Tensor     # [4, 5]
    hash_f: torch.Tensor     # [4]
    hash_f_rev: torch.Tensor  # [4], reversed
    lo: torch.Tensor         # [2] workspace lower bound
    hi: torch.Tensor         # [2] workspace upper bound


@functools.lru_cache(maxsize=None)
def _consts(device) -> _Consts:
    def t(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    return _Consts(t(_HASH_W), t(_HASH_F), t(_HASH_F[::-1].copy()),
                   t(WORKSPACE_BOUNDS[0]), t(WORKSPACE_BOUNDS[1]))


# ---- small vector helpers (trailing xy dim) --------------------------------

def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last dim, 0 where there is none
    (`jnp.argmax` of a bool vector)."""
    n = mask.shape[-1]
    ar = torch.arange(n, device=mask.device)
    idx = torch.where(mask, ar, n).amin(-1)
    return torch.where(idx == n, 0, idx)


def _first_argmin(v: torch.Tensor) -> torch.Tensor:
    return _first_true(v == v.amin(-1, keepdim=True))


def _first_argmax(v: torch.Tensor) -> torch.Tensor:
    return _first_true(v == v.amax(-1, keepdim=True))


def _take(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v[..., idx, :] for one index per leading position: [..., n, 2] -> [..., 2]."""
    return torch.gather(v, -2, idx[..., None, None].expand(*idx.shape, 1, v.shape[-1]))[..., 0, :]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1])


def _rot(yaw: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 2, 2] of yaw angles [...]."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def _mv(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R @ v over leading dims: [..., 2, 2] x [..., 2] -> [..., 2]."""
    return torch.stack([R[..., 0, 0] * v[..., 0] + R[..., 0, 1] * v[..., 1],
                        R[..., 1, 0] * v[..., 0] + R[..., 1, 1] * v[..., 1]], -1)


def _mtv(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R^T @ v over leading dims."""
    return torch.stack([R[..., 0, 0] * v[..., 0] + R[..., 1, 0] * v[..., 1],
                        R[..., 0, 1] * v[..., 0] + R[..., 1, 1] * v[..., 1]], -1)


def _perp(v: torch.Tensor) -> torch.Tensor:
    return torch.stack([-v[..., 1], v[..., 0]], -1)


def _cross2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


# ---- reset / observation ----------------------------------------------------

def _uniform(gen, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device)


def _sample_block_positions(gen, B: int, device) -> torch.Tensor:
    """[B, 2 blocks, 2] positions with |x1 - x2| > MIN_BLOCK_DIST: the first
    valid of _RESET_CANDIDATES candidate pairs per env (the first one if
    none is valid, as the JAX pick)."""
    u = _uniform(gen, (B, _RESET_CANDIDATES, 2, 2), device)
    x = WORKSPACE_CENTER_X + (u[..., 0] * 2 - 1) * RANDOM_X_SHIFT   # [B, C, 2]
    y = -0.2 + (u[..., 1] * 2 - 1) * RANDOM_Y_SHIFT
    idx = _first_true(torch.abs(x[..., 0] - x[..., 1]) > MIN_BLOCK_DIST)
    xy = torch.stack([x, y], -1)                                      # [B, C, 2, 2]
    return torch.gather(xy, 1, idx[:, None, None, None].expand(B, 1, 2, 2))[:, 0]


def block_push_reset(batch_size: int, generator: Optional[torch.Generator] = None,
                     device=None, horizontal: bool = False) -> BlockPushState:
    """Reset B envs (block_pushing_multimodal.py:163-310), drawing from
    `generator` (on `device`).

    `horizontal=True` gives the BlockPushHorizontalMultimodal layout
    (block_pushing_multimodal.py:583-703): blocks left/right of center
    (y = +-0.2 + noise, x ~ 0.35), both targets at x ~ 0.5 mirrored in y.
    """
    B, g = batch_size, generator
    sign = torch.tensor([1.0, -1.0], device=device)

    def flip():  # +1 or -1 per env with probability 1/2
        return torch.where(_uniform(g, (B,), device) < 0.5, 1.0, -1.0)

    if horizontal:
        add = 0.2 * flip()
        u = _uniform(g, (B, 2, 2), device)
        bx = 0.35 + 0.5 * (u[..., 0] * 2 - 1) * RANDOM_X_SHIFT
        by = sign * add[:, None] + 0.5 * (u[..., 1] * 2 - 1) * RANDOM_Y_SHIFT
        block_pos = torch.stack([bx, by], -1)
    else:
        block_pos = _sample_block_positions(g, B, device)
    block_yaw = _uniform(g, (B, 2), device) * math.pi

    if horizontal:
        add = 0.2 * flip()
        tx = 0.5 + (_uniform(g, (B, 2), device) * 2 - 1) * 0.05 * RANDOM_X_SHIFT
        ty = sign * add[:, None] + (_uniform(g, (B, 2), device) * 2 - 1) * 0.05 * RANDOM_Y_SHIFT
    else:
        add = 0.12 * flip()
        tx = (WORKSPACE_CENTER_X + sign * add[:, None]
              + (_uniform(g, (B, 2), device) * 2 - 1) * 0.05 * RANDOM_X_SHIFT)
        ty = 0.2 + (_uniform(g, (B, 2), device) * 2 - 1) * 0.05 * RANDOM_Y_SHIFT
    tyaw = math.pi + (_uniform(g, (B, 2), device) * 2 - 1) * math.pi / 30

    start = torch.tensor(EFFECTOR_START, device=device).expand(B, 2)
    return BlockPushState(
        effector=start.clone(), effector_target=start.clone(),
        block_pos=block_pos, block_yaw=block_yaw,
        target_pos=torch.stack([tx, ty], -1), target_yaw=tyaw,
        in_target=torch.zeros(B, 2, 2, dtype=torch.bool, device=device),
        completed=torch.zeros(B, 4, dtype=torch.bool, device=device),
        done=torch.zeros(B, dtype=torch.bool, device=device),
        steps=torch.zeros(B, dtype=torch.int32, device=device),
        block_vel=torch.zeros(B, 2, 2, device=device),
        block_yawrate=torch.zeros(B, 2, device=device))


def block_push_obs(state: BlockPushState) -> torch.Tensor:
    """The 16-dim observation [B, 16] in the reference's order
    (block_pushing_multimodal.py:332-366, block_push_workspace.py:147-148)."""
    return torch.cat([
        state.block_pos[:, 0], state.block_yaw[:, 0:1],
        state.block_pos[:, 1], state.block_yaw[:, 1:2],
        state.effector, state.effector_target,
        state.target_pos[:, 0], state.target_yaw[:, 0:1],
        state.target_pos[:, 1], state.target_yaw[:, 1:2],
    ], -1)


# ---- contact geometry -------------------------------------------------------

def _hash_noise(bpos: torch.Tensor, byaw: torch.Tensor, eff: torch.Tensor) -> torch.Tensor:
    """Zero-mean pseudo-noise in [-1, 1]^4 [..., 4], a sin-hash of the
    contact configuration (block pose [..., 2] and [...], pusher [..., 2]):
    the deterministic chaos seed of the contact dithers. Its arguments reach
    the thousands, so an ulp of difference in the product moves the hash by
    up to ~0.1: it agrees with the JAX hash only to that level."""
    c = _consts(bpos.device)
    u = torch.cat([bpos, byaw[..., None], eff], -1)           # [..., 5]
    pr = c.hash_w * u[..., None, :]                            # [..., 4, 5]
    # _HASH_W @ u, summed in the order XLA's CPU dot sums it
    wu = ((pr[..., 0] + pr[..., 1]) + (pr[..., 2] + pr[..., 3])) + pr[..., 4]
    s = torch.sin(wu * c.hash_f)
    return 2.0 * torch.remainder(s * 10.0 * c.hash_f_rev, 1.0) - 1.0


def _box_point_geom(block_pos, block_yaw, point, radius):
    """Disk-vs-oriented-box closest-point geometry over leading dims.

    Returns (pen [...], n_in [..., 2], c_local [..., 2], R [..., 2, 2]):
    penetration depth, inward contact normal in the box frame (the face
    normal of the deepest-crossed slab, also in the corner region; the
    direction to the center when the point is inside the box), the closest
    point on the box in its frame, and the box's rotation."""
    R = _rot(block_yaw)
    local = _mtv(R, point - block_pos)
    clamped = torch.clamp(local, -BLOCK_HALF, BLOCK_HALF)
    delta = local - clamped
    dist = _norm(delta)
    inside = dist < 1e-9
    face = torch.where(local >= 0, BLOCK_HALF - local, -BLOCK_HALF - local)
    pen = torch.where(inside, radius + torch.abs(face).amin(-1), radius - dist)
    p_ax = torch.abs(local) - BLOCK_HALF
    corner = (p_ax > 0).all(-1)
    ax1 = p_ax[..., 1] < p_ax[..., 0]                     # argmin, first on ties
    s_ax = -torch.sign(torch.where(ax1, local[..., 1], local[..., 0]))
    zero = torch.zeros_like(s_ax)
    n_face = torch.stack([torch.where(ax1, zero, s_ax), torch.where(ax1, s_ax, zero)], -1)
    n_out = delta / torch.clamp(dist, min=1e-9)[..., None]
    to_center = -local / torch.clamp(_norm(local), min=1e-9)[..., None]
    n_in = torch.where(inside[..., None], to_center,
                       torch.where(corner[..., None], n_face, -n_out))
    return pen, n_in, clamped, R


def _box_box_manifold(pos_a, yaw_a, pos_b, yaw_b, half):
    """Two-point contact manifold between two oriented squares of
    half-extent `half` (2-D SAT reference face + incident-face clipping, the
    Box2D box-box algorithm planarized), over leading dims.

    Returns (pen [..., 2], n [..., 2], pts [..., 2, 2], live [..., 2]): up
    to two world contact points with a shared unit normal from box A toward
    box B; point k is active iff live[..., k]."""
    Ra, Rb = _rot(yaw_a), _rot(yaw_b)
    d = pos_b - pos_a
    axes = torch.stack([Ra[..., :, 0], Ra[..., :, 1], Rb[..., :, 0], Rb[..., :, 1]], -2)

    def proj(v):  # axes @ v: [..., 4]
        return axes[..., 0] * v[..., None, 0] + axes[..., 1] * v[..., None, 1]

    ra = half * (torch.abs(proj(Ra[..., :, 0])) + torch.abs(proj(Ra[..., :, 1])))
    rb = half * (torch.abs(proj(Rb[..., :, 0])) + torch.abs(proj(Rb[..., :, 1])))
    sep = torch.abs(proj(d)) - (ra + rb)
    overlap = (sep < 0).all(-1)
    k = _first_argmax(sep)
    axis = _take(axes, k)
    n = axis * torch.where(_dot(axis, d) >= 0, 1.0, -1.0)[..., None]
    a_is_ref = (k < 2)[..., None]
    pos_ref = torch.where(a_is_ref, pos_a, pos_b)
    pos_inc = torch.where(a_is_ref, pos_b, pos_a)
    R_inc = torch.where(a_is_ref[..., None], Rb, Ra)
    n_out = torch.where(a_is_ref, n, -n)
    t_ref = _perp(n_out)
    cand_n = torch.stack([R_inc[..., :, 0], -R_inc[..., :, 0],
                          R_inc[..., :, 1], -R_inc[..., :, 1]], -2)
    face_n = _take(cand_n, _first_argmin(cand_n[..., 0] * n_out[..., None, 0]
                                         + cand_n[..., 1] * n_out[..., None, 1]))
    face_t = _perp(face_n)
    face_c = pos_inc + face_n * half
    c0 = _dot(t_ref, face_c - pos_ref)
    dc = half * _dot(t_ref, face_t)
    par = torch.abs(dc) < 1e-9
    denom = torch.where(par, torch.where(dc < 0, -1e-9, 1e-9), dc)
    s1 = (-half - c0) / denom
    s2 = (half - c0) / denom
    s_lo = torch.clamp(torch.minimum(s1, s2), min=-1.0)
    s_hi = torch.clamp(torch.maximum(s1, s2), max=1.0)
    inside_par = torch.abs(c0) <= half
    s_lo = torch.where(par, torch.where(inside_par, -1.0, 1.0), s_lo)
    s_hi = torch.where(par, torch.where(inside_par, 1.0, -1.0), s_hi)
    svals = torch.stack([s_lo, s_hi], -1)
    pts = face_c[..., None, :] + svals[..., None] * (half * face_t)[..., None, :]
    rel = pts - pos_ref[..., None, :]
    pen = half - (rel[..., 0] * n_out[..., None, 0] + rel[..., 1] * n_out[..., None, 1])
    live = (overlap & (s_lo <= s_hi))[..., None] & (pen > 0)
    return pen, n, pts, live


def _push_block(block_pos, block_yaw, point, radius, k2: float = FRICTION_K2,
                mu: float = PUSHER_MU):
    """Quasi-static point push of an oriented box with the sticking /
    slipping motion cone (Mason/Lynch; `beso_tpu/envs/block_push/env.py:
    444-524`, whose docstring derives it), over leading dims, without the
    pusher's tangential drive (the single-block envs pass none). The
    contact impulse moves the contact point by A f, A = (k^2 I + p p^T) /
    (k^2 + |c|^2), p = perp(c); the sticking force (norm-capped at 4x the
    penetration) applies if it lies in the friction cone, else the cone-edge
    force at the penetration's magnitude. Returns (new_pos, new_yaw, contact)."""
    pen, n_in, c, R = _box_point_geom(block_pos, block_yaw, point, radius)
    # the per-substep penetration capped at the effector's substep advance
    pen = torch.clamp(pen, 0.0, EFFECTOR_SPEED * CONTROL_DT / N_SUBSTEPS)
    t_dir = _perp(n_in)
    p = _perp(c)
    D = k2 + _dot(c, c)
    eye = torch.eye(2, dtype=c.dtype, device=c.device)
    A = (k2 * eye + p[..., :, None] * p[..., None, :]) / D[..., None, None]
    u = pen[..., None] * n_in
    f_stick = torch.linalg.solve(A, u[..., None])[..., 0]
    fn, ft = _dot(f_stick, n_in), _dot(f_stick, t_dir)
    stick = torch.abs(ft) <= mu * torch.clamp(fn, min=0.0)
    edge = (n_in + mu * torch.sign(ft)[..., None] * t_dir) / math.sqrt(1.0 + mu * mu)
    fmax = 4.0 * torch.clamp(pen, min=1e-9)
    f_st = f_stick * torch.clamp(fmax / torch.clamp(_norm(f_stick), min=1e-9), max=1.0)[..., None]
    f = torch.where(stick[..., None], f_st, pen[..., None] * edge)
    v_local = (k2 * f + _dot(c, f)[..., None] * c) / D[..., None]
    dyaw = _dot(p, f) / D
    return block_pos + _mv(R, v_local), block_yaw + dyaw, pen > 0


# ---- dynamics ----------------------------------------------------------------

def _solve_contact_velocities(bpos, byaw, bvel, byr, eff, v_push, inv_i: float = INV_I):
    """One substep's contact-force integration: pusher-block spring-damper
    with the tipping plateau, the 2-point box-box block contact, then
    4-point ground friction by sequential impulses (3 passes).

    bpos [B, 2, 2], byaw [B, 2], bvel [B, 2, 2], byr [B, 2], eff and
    v_push [B, 2]; `inv_i` the blocks' inverse yaw inertia (a Python
    float). Returns (bvel, byr) after force integration."""
    inv_m = 1.0 / BLOCK_MASS

    # block-block adjacency (the backed-block plateau exemption)
    d01 = bpos[:, 1] - bpos[:, 0]
    dist01 = _norm(d01)
    dir01 = d01 / torch.clamp(dist01, min=1e-9)[:, None]
    near_bb = dist01 < 2 * BLOCK_BLOCK_RADIUS + BACKED_MARGIN

    # pusher-block spring-damper + Coulomb tangent, both blocks at once
    eff_b = eff[:, None, :].expand(-1, 2, -1)
    pen, n_l, c_l, R_b = _box_point_geom(bpos, byaw, eff_b, EFFECTOR_RADIUS)
    to_other = torch.stack([dir01, -dir01], 1)
    ahead = _dot(_mv(R_b, n_l), to_other) > BACKED_COS
    backed = near_bb[:, None] & ahead
    plow_blocked = ahead & (dist01 < PLOW_RANGE)[:, None]
    live = pen > 0
    # the contact dithers; the angle one is off while the other block lies
    # ahead in the push cone within PLOW_RANGE
    h = _hash_noise(bpos, byaw, eff_b)
    c_l = c_l + torch.where(live, CONTACT_DITHER, 0.0)[..., None] * h[..., 0:2]
    n_l = _mv(_rot(torch.where(live & ~plow_blocked, DITHER_ANG, 0.0) * h[..., 2]), n_l)
    n = _mv(R_b, n_l)
    r = _mv(R_b, c_l)
    u = bvel + byr[..., None] * _perp(r) - v_push[:, None, :]
    closing = -_dot(n, u)
    k_eff = CONTACT_K * torch.where(backed, BACKED_STIFF, 1.0)
    spring = k_eff * pen
    damper = torch.minimum(CONTACT_B * closing, DAMP_RATIO * spring)
    raw = torch.clamp(spring + damper, min=0.0)
    capped = torch.clamp(raw, max=FN_CAP)
    excess = torch.clamp(raw - FN_CAP, min=0.0)
    leak = torch.where(backed, 1.0, TIP_LEAK)
    fn = torch.where(live, capped + leak * excess, 0.0)
    fn_tq = torch.where(live, capped + torch.where(backed, 1.0, TIP_TORQUE_LEAK) * excess, 0.0)
    t = _perp(n)
    vt = _dot(t, u)
    ft = -CONTACT_MU * fn * torch.tanh(vt / V_EPS)
    forces = fn[..., None] * n + ft[..., None] * t                       # [B, 2, 2]
    torques = _cross2(r, fn_tq[..., None] * n + ft[..., None] * t)      # [B, 2]

    # block-block contact: the 2-point box-box manifold with the face-normal
    # dither; effective half-extent 2 * BLOCK_BLOCK_RADIUS / 2
    pen_bb, n, pts, live_bb = _box_box_manifold(bpos[:, 0], byaw[:, 0], bpos[:, 1],
                                                byaw[:, 1], BLOCK_BLOCK_RADIUS)
    h_bb = _hash_noise(bpos[:, 0], byaw[:, 0] - byaw[:, 1], bpos[:, 1])
    n = _mv(_rot(torch.where(live_bb.any(-1), BB_DITHER_ANG, 0.0) * h_bb[:, 2]), n)
    n_a = -n                                   # direction block 0 separates
    t = _perp(n_a)
    r_i = pts - bpos[:, None, 0]               # [B, 2 points, 2] arms on block 0
    r_j = pts - bpos[:, None, 1]               # arms on block 1
    u = ((bvel[:, None, 0] + byr[:, None, 0, None] * _perp(r_i))
         - (bvel[:, None, 1] + byr[:, None, 1, None] * _perp(r_j)))
    closing_bb = -_dot(n_a[:, None], u)
    spring_bb = CONTACT_K * pen_bb
    damper_bb = torch.minimum(CONTACT_B * closing_bb, DAMP_RATIO * spring_bb)
    fn_bb = torch.where(live_bb, 0.5 * torch.clamp(spring_bb + damper_bb, min=0.0), 0.0)
    ft_bb = -CONTACT_MU * fn_bb * torch.tanh(_dot(t[:, None], u) / V_EPS)
    f = fn_bb[..., None] * n_a[:, None] + ft_bb[..., None] * t[:, None]   # [B, 2 points, 2]
    # accumulated point by point, in the JAX loop's order
    f0 = forces[:, 0] + f[:, 0] + f[:, 1]
    f1 = forces[:, 1] + -f[:, 0] + -f[:, 1]
    tq0 = torques[:, 0] + _cross2(r_i[:, 0], f[:, 0]) + _cross2(r_i[:, 1], f[:, 1])
    tq1 = torques[:, 1] + _cross2(r_j[:, 0], -f[:, 0]) + _cross2(r_j[:, 1], -f[:, 1])
    bvel = bvel + torch.stack([f0, f1], 1) * (SUB_DT * inv_m)
    byr = byr + torch.stack([tq0, tq1], 1) * (SUB_DT * inv_i)

    # ground friction: sequential impulses at the 4 corner points, 3 passes,
    # each point's accumulated impulse clamped to mu (m g / 4) h
    lam_max = F_G_MAX * SUB_DT
    c, s = torch.cos(byaw), torch.sin(byaw)
    vx, vy, wb = bvel[..., 0], bvel[..., 1], byr
    points = []
    for gx, gy in _GROUND_PTS.tolist():
        rx, ry = gx * c + gy * -s, gx * s + gy * c      # R @ point, world arm
        px, py = -ry, rx                                  # perp(arm)
        k00 = inv_m + inv_i * px * px
        k11 = inv_m + inv_i * py * py
        k01 = inv_i * px * py
        points.append((rx, ry, px, py, k00, k11, k01, k00 * k11 - k01 * k01))
    lam = [(torch.zeros_like(vx), torch.zeros_like(vx)) for _ in points]
    for _ in range(3):
        for i, (rx, ry, px, py, k00, k11, k01, det) in enumerate(points):
            ux, uy = vx + wb * px, vy + wb * py
            djx = -(k11 * ux - k01 * uy) / det
            djy = -(k00 * uy - k01 * ux) / det
            lx, ly = lam[i]
            nx, ny = lx + djx, ly + djy
            scale = torch.clamp(lam_max / torch.clamp(torch.sqrt(nx * nx + ny * ny), min=1e-12),
                                max=1.0)
            nx, ny = nx * scale, ny * scale
            dx, dy = nx - lx, ny - ly
            vx, vy = vx + dx * inv_m, vy + dy * inv_m
            wb = wb + (rx * dy - ry * dx) * inv_i
            lam[i] = (nx, ny)
    return torch.stack([vx, vy], -1), wb


def block_push_step(state: BlockPushState, action: torch.Tensor,
                    friction_k2: Optional[float] = None,
                    ) -> Tuple[BlockPushState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One 10 Hz control step of B envs, action [B, 2]. Returns (state,
    obs [B, 16], reward [B], done [B]).

    Envs already done keep their state and get reward 0. `friction_k2`
    overrides FRICTION_K2, the squared radius of gyration of the blocks'
    yaw inertia (the calibration tool's sweep; larger k2, a stiffer
    rotation response)."""
    k2 = FRICTION_K2 if friction_k2 is None else float(friction_k2)
    inv_i = 1.0 / (BLOCK_MASS * k2)
    c = _consts(action.device)
    tgt = torch.minimum(torch.maximum(state.effector_target + action, c.lo), c.hi)

    eff, bpos, byaw = state.effector, state.block_pos, state.block_yaw
    bvel, byr = state.block_vel, state.block_yawrate
    for _ in range(N_SUBSTEPS):
        # velocity-limited tracking of the target (kinematic pusher)
        to_tgt = tgt - eff
        d = _norm(to_tgt)
        step_len = torch.clamp(d, max=EFFECTOR_SPEED * SUB_DT)
        de = to_tgt / torch.clamp(d, min=1e-9)[:, None] * step_len[:, None]
        eff = eff + de
        bvel, byr = _solve_contact_velocities(bpos, byaw, bvel, byr, eff, de / SUB_DT, inv_i)
        bpos = bpos + bvel * SUB_DT
        byaw = byaw + byr * SUB_DT

    # reward and completion (block_pushing_multimodal.py:395-438);
    # dists[:, t, b] = |block_b - target_t|
    dists = _norm(bpos[:, None, :, :] - state.target_pos[:, :, None, :])
    within = dists < GOAL_DIST_TOLERANCE
    entered = within & ~state.in_target
    in_target = state.in_target | within
    reward = 0.49 * entered.sum((1, 2)).float()
    # task id 2*b + t on first entry
    completed = state.completed | entered.transpose(1, 2).reshape(-1, 4)
    # both blocks in DIFFERENT targets -> reward 0.51, done
    closest_t = dists[:, 1] < dists[:, 0]            # argmin over t, first on ties
    closest_d = torch.minimum(dists[:, 0], dists[:, 1])
    success = (closest_d < GOAL_DIST_TOLERANCE).all(-1) & (closest_t[:, 0] != closest_t[:, 1])
    reward = torch.where(success, 0.51, reward)

    new_state = BlockPushState(
        effector=eff, effector_target=tgt, block_pos=bpos, block_yaw=byaw,
        target_pos=state.target_pos, target_yaw=state.target_yaw,
        in_target=in_target, completed=completed, done=state.done | success,
        steps=state.steps + 1, block_vel=bvel, block_yawrate=byr)
    done0 = state.done
    frozen = BlockPushState(*(
        torch.where(done0.reshape(done0.shape + (1,) * (new.dim() - 1)), old, new)
        for new, old in zip(new_state, state)))
    reward = torch.where(done0, 0.0, reward)
    return frozen, block_push_obs(frozen), reward, frozen.done
