"""Kitchen scene geometry (numpy copy of `beso_tpu/envs/kitchen/geometry.py`).

The adept_envs Franka-kitchen MuJoCo XML is not vendored in the reference
repository (it ships only the task table,
`beso/envs/franka_kitchen/kitchen_env.py:10-28`), so exact-XML geometry is
unreachable; what this module provides instead is a DOCUMENTED, internally
consistent scene at adept_envs-plausible dimensions that is used by BOTH

* the JAX surrogate physics (`beso_tpu/envs/kitchen/env.py`) and its torch
  port (`beso_tpu_torch/envs/kitchen/env.py`), and
* the MuJoCo golden calibration scenes (`scripts/calibrate_kitchen.py`),

so every articulation constant the surrogate ships is measured in a real
rigid-body simulation of the SAME geometry — nothing is hand-asserted.

Element model: each articulated element is a 1-DoF joint (rotary hinge or
prismatic slide) with a handle the fingertip drags:

* kind 0 (rotary): the handle rides a circular arc about `pivot` around the
  unit `axis`; the handle rest position is `handle0` (joint value 0).
* kind 1 (slide): the handle translates along `axis` by the joint value.
* kind 2 (free): the kettle — a free body moved by a latched two-finger
  grasp (see the gripper golden scene).

Handles are finite BARS (capsules), not points: `bar_dir` is the bar axis
(zero for point-like knob lever tips) and `bar_halflen` its half length —
contact distance is fingertip-to-segment, so engagement is tight in the
plane of motion but permissive along the bar, exactly like hooking a real
handle anywhere along its length.

Task-table indices/goals come from the reference (kitchen_env.py:10-28);
world placement keeps every handle (and its full goal stroke) inside the
Panda's reach envelope from the pedestal base (verified by the oracle
tests). All dimensions in meters.
"""

from __future__ import annotations

import numpy as np

ROTARY, SLIDE, FREE = 0, 1, 2

# element order matches ALL_TASKS in env.py
ELEMENT_KIND = np.asarray([ROTARY, ROTARY, ROTARY, SLIDE, ROTARY, ROTARY,
                           FREE], np.int32)

# world-frame articulation frames -------------------------------------------
# knob panel (backsplash) face at y=0.92, in front of the cabinet-run wall
# plane y=0.95; burner knobs r=0.04 levers, light switch a r=0.06 lever
# (typical range-knob / rocker dimensions).
PIVOTS = np.asarray([
    [0.35, 0.92, 1.00],    # bottom burner knob hub
    [0.35, 0.92, 1.10],    # top burner knob hub
    [0.25, 0.92, 1.30],    # light switch hub
    [0.40, 0.85, 1.40],    # slide cabinet: handle rest position (= handle0)
    [0.15, 0.95, 1.40],    # hinge cabinet: hinge line (right door edge)
    [-0.60, 0.80, 0.90],   # microwave: hinge line (left body edge)
    [0.00, 0.00, 0.00],    # kettle: unused (free body)
], np.float32)

# rotary: unit rotation axis (sign chosen so the task-table goal value is
# reached by the physically sensible opening motion); slide: translation dir
AXES = np.asarray([
    [0.0, -1.0, 0.0],      # knob axis points out of the panel
    [0.0, -1.0, 0.0],
    [0.0, -1.0, 0.0],
    [1.0, 0.0, 0.0],       # slide cabinet opens to +x (goal +0.37)
    [0.0, 0.0, 1.0],       # hinge cabinet swings out toward +x/-y (goal +1.45)
    [0.0, 0.0, 1.0],       # microwave door opens toward -y (goal -0.75)
    [0.0, 0.0, 0.0],
], np.float32)

# handle rest positions (joint value = 0, the reset configuration)
HANDLE0 = np.asarray([
    [0.35, 0.89, 1.04],    # lever tip: r=0.04 up, 0.03 standoff off panel
    [0.35, 0.89, 1.14],
    [0.25, 0.89, 1.36],    # r=0.06 lever
    [0.40, 0.85, 1.40],
    [-0.15, 0.85, 1.40],   # 0.30 from hinge along the door, 0.10 standoff
    [-0.20, 0.75, 0.90],   # 0.40 from hinge along the door, 0.05 standoff
    [0.00, 0.00, 0.00],    # kettle handle tracks qpos[23:26]
], np.float32)

# handle bar axes (zero = point handle) and half lengths
BAR_DIRS = np.asarray([
    [0.0, 0.0, 0.0],       # knob lever tip: point
    [0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0],       # switch lever tip: point
    [0.0, 0.0, 1.0],       # slide handle: vertical bar
    [0.0, 0.0, 1.0],       # hinge cabinet: vertical bar
    [0.0, 0.0, 1.0],       # microwave: vertical bar
    [1.0, 0.0, 0.0],       # kettle handle: horizontal bar
], np.float32)
BAR_HALFLEN = np.asarray([0.0, 0.0, 0.0, 0.06, 0.08, 0.06, 0.03], np.float32)
BAR_RADIUS = 0.012         # handle bar/lever capsule radius (all elements)
FINGER_RADIUS = 0.02       # fingertip pad sphere radius (Panda fingertip)

# in-plane handle radius about the axis (rotary rows only)
_r_vec = HANDLE0 - PIVOTS
_ax = AXES / np.maximum(np.linalg.norm(AXES, axis=1, keepdims=True), 1e-9)
_r_perp = _r_vec - _ax * np.sum(_r_vec * _ax, axis=1, keepdims=True)
HANDLE_RADIUS = np.linalg.norm(_r_perp, axis=1).astype(np.float32)  # [7]

# plausible furniture joint dynamics for the golden scenes (the adept_envs
# values are unknown; these are ordinary damped furniture joints — the
# measured engagement efficiency is insensitive to them at drag speeds,
# which the calibration prints as a cross-check)
SCENE_DYNAMICS = {
    "knob": dict(damping=0.02, frictionloss=0.02, mass=0.06),
    "lever": dict(damping=0.05, frictionloss=0.02, mass=0.08),
    "slide": dict(damping=2.0, frictionloss=0.5, mass=1.0),
    "door": dict(damping=0.5, frictionloss=0.2, mass=1.2),
}
# per-element golden-scene class
ELEMENT_SCENE = ("knob", "knob", "lever", "slide", "door", "door", None)

# joint ranges (element joints; from the task-table goal values with
# physical headroom — e.g. a door cannot open past ~140 deg)
JOINT_RANGE = np.asarray([
    [-1.5, 0.1],    # burner knobs
    [-1.5, 0.1],
    [-1.0, 0.1],    # light switch
    [-0.1, 0.6],    # slide cabinet
    [-0.1, 2.4],    # hinge cabinet
    [-1.6, 0.1],    # microwave
    [0.0, 0.0],     # kettle (free)
], np.float32)
