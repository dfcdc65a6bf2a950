"""Geometry-complete calibration of the kitchen surrogate against MuJoCo
(port of `scripts/calibrate_kitchen.py`).

One MuJoCo scene per articulated element, built in world coordinates from
the geometry table the surrogate uses (`beso_tpu_torch/envs/kitchen/
geometry.py`), plus a torque-actuated two-finger gripper scene for the
kettle (mocap fingers teleport with zero velocity, so tangential friction
cannot drag). Every constant the surrogate ships in its kitchen parameters
is measured here:

* `drive_eff[e]`: engaged articulation efficiency, the joint angle advanced
  per radian of fingertip angular advance about the element's pivot axis
  (per meter per meter for the slide), from a fingertip dragged along the
  ideal handle arc or line at the oracle's speed (`drive_eff_steady`: the
  per-step slope once contact is loaded);
* `interact_radius`: engagement onset, the largest fingertip-to-handle
  distance at which an arc drag still moves the joint;
* slip: a straight tangential pull on an arc handle loses engagement;
* `kettle_gain` / `kettle_max_speed`: the grasped kettle's tracking ratio
  and the fastest per-step displacement that still tracks >= 0.9;
* `grasp_radius`: the largest lateral hand-to-handle offset at which
  closing the fingers still lifts the kettle;
* the grasp's breakaway when the hand is yanked faster than the grip.

`--full-scene` composes every element, the furniture volumes and the
kettle into one scene and drives two-task routes through it (transit
clearance, crosstalk, stroke reproduction against the per-element goldens
read from `--golden`); it writes `kitchen_full_scene.npz` beside `--out`.

The tool runs MuJoCo on the host and no surrogate compute, so it needs no
card and runs on a CPU host with the `mujoco` package; it raises an
ImportError without it. Files are written under `logs/calibration/` unless
`--out` says otherwise; never under `tests/golden/`, whose files the JAX
package's fidelity tests read.

Run: python -m beso_tpu_torch.scripts.calibrate_kitchen [--out PATH]
     [--full-scene [--golden PATH]]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from beso_tpu_torch.envs.kitchen import geometry as G

REPO = Path(__file__).resolve().parents[2]
GOLDEN_DIR = REPO / "tests" / "golden"
DEFAULT_OUT = Path("logs") / "calibration" / "kitchen_mujoco_v2.npz"

SUBSTEP_HZ = 240
CONTROL_DT = 0.08           # kitchen control step (12.5 Hz)
SUB = int(SUBSTEP_HZ * CONTROL_DT)

_DYN_FMT = 'damping="{damping}" frictionloss="{frictionloss}"'


def _rot(axis, theta, v):
    """Rodrigues rotation of v about unit axis by theta."""
    axis = np.asarray(axis, float)
    v = np.asarray(v, float)
    c, s = np.cos(theta), np.sin(theta)
    return (v * c + np.cross(axis, v) * s
            + axis * np.dot(axis, v) * (1 - c))


def element_scene_xml(e: int) -> str:
    """World-coordinate single-element scene: the element body at its pivot
    with its real axis/handle geometry + a mocap fingertip sphere."""
    joint, geoms, body_pos = _element_body_parts(e)
    return f"""
<mujoco>
  <option timestep="{1.0 / SUBSTEP_HZ}" integrator="implicitfast"
          gravity="0 0 0"/>
  <worldbody>
    <body name="elem" pos="{body_pos[0]} {body_pos[1]} {body_pos[2]}">
      {joint}
      {''.join(geoms)}
    </body>
    <body name="finger" mocap="true" pos="0 0 0">
      <geom type="sphere" size="{G.FINGER_RADIUS}" contype="1"
            conaffinity="1" mass="0.5"/>
    </body>
  </worldbody>
</mujoco>
"""


def _element_body_parts(e: int, jname: str = "elem"):
    """The element's joint XML, geom XML list, and body position — shared by
    the per-element calibration scenes and the round-5 FULL scene."""
    kind = int(G.ELEMENT_KIND[e])
    pivot = G.PIVOTS[e]
    axis = G.AXES[e]
    h0 = G.HANDLE0[e]
    rng = G.JOINT_RANGE[e]
    dyn = G.SCENE_DYNAMICS[G.ELEMENT_SCENE[e]]
    r_vec = h0 - pivot

    hname = "handle" if jname == "elem" else f"handle_{jname}"
    geoms = []
    if kind == G.ROTARY:
        joint = (f'<joint name="{jname}" type="hinge" '
                 f'axis="{axis[0]} {axis[1]} {axis[2]}" '
                 f'range="{rng[0]} {rng[1]}" '
                 + _DYN_FMT.format(**dyn) + '/>')
        # hub at the pivot
        geoms.append('<geom type="sphere" size="0.02" mass="0.02"/>')
        if G.ELEMENT_SCENE[e] in ("knob", "lever"):
            # lever capsule from hub to tip
            geoms.append(
                f'<geom name="{hname}" type="capsule" fromto="0 0 0 '
                f'{r_vec[0]} {r_vec[1]} {r_vec[2]}" size="{G.BAR_RADIUS}" '
                f'mass="{dyn["mass"]}"/>')
        else:
            # door slab in the wall plane + standoff strut + handle bar
            ax_comp = np.dot(r_vec, axis) * axis
            r_in = r_vec - ax_comp                   # in-plane to the bar
            # slab runs from hinge toward the bar attach point (project the
            # bar onto the door plane: remove the standoff, which is the
            # component of r_in perpendicular to the slab). The slab
            # direction is the in-plane direction of the attach point.
            standoff = r_in - _slab_component(r_in, axis)
            attach = r_in - standoff
            mid = attach / 2.0
            slab_len = np.linalg.norm(attach) / 2.0
            zdir = axis / np.linalg.norm(axis)
            xdir = attach / max(np.linalg.norm(attach), 1e-9)
            ydir = np.cross(zdir, xdir)
            geoms.append(
                f'<geom type="box" pos="{mid[0]} {mid[1]} {mid[2]}" '
                f'size="{slab_len} 0.012 0.22" mass="{dyn["mass"]}" '
                f'xyaxes="{xdir[0]} {xdir[1]} {xdir[2]} '
                f'{ydir[0]} {ydir[1]} {ydir[2]}"/>')
            geoms.append(
                f'<geom type="capsule" fromto="{attach[0]} {attach[1]} '
                f'{attach[2]} {r_vec[0]} {r_vec[1]} {r_vec[2]}" '
                f'size="0.008" mass="0.02"/>')
            bd = G.BAR_DIRS[e] * G.BAR_HALFLEN[e]
            geoms.append(
                f'<geom name="{hname}" type="capsule" '
                f'fromto="{r_vec[0] - bd[0]} {r_vec[1] - bd[1]} '
                f'{r_vec[2] - bd[2]} {r_vec[0] + bd[0]} {r_vec[1] + bd[1]} '
                f'{r_vec[2] + bd[2]}" size="{G.BAR_RADIUS}" mass="0.1"/>')
    else:  # SLIDE
        joint = (f'<joint name="{jname}" type="slide" '
                 f'axis="{axis[0]} {axis[1]} {axis[2]}" '
                 f'range="{rng[0]} {rng[1]}" '
                 + _DYN_FMT.format(**dyn) + '/>')
        # door slab behind the handle (toward the wall), handle bar at origin
        geoms.append(
            f'<geom type="box" pos="-0.15 0.10 0" size="0.18 0.012 0.20" '
            f'mass="{dyn["mass"]}"/>')
        geoms.append('<geom type="capsule" fromto="0 0.10 0  0 0 0" '
                     'size="0.008" mass="0.02"/>')
        bd = G.BAR_DIRS[e] * G.BAR_HALFLEN[e]
        geoms.append(
            f'<geom name="{hname}" type="capsule" fromto="{-bd[0]} {-bd[1]} '
            f'{-bd[2]} {bd[0]} {bd[1]} {bd[2]}" size="{G.BAR_RADIUS}" '
            f'mass="0.1"/>')

    body_pos = pivot if kind == G.ROTARY else h0
    return joint, geoms, body_pos


def _slab_component(r_in, axis):
    """Split the in-plane handle offset into slab direction + standoff.
    Convention: the standoff is the smaller perpendicular component (doors
    stand their handles off the slab face toward the robot)."""
    # pick the dominant in-plane direction as the slab direction
    r_in = np.asarray(r_in, float)
    slab_dir = r_in.copy()
    # zero the smallest-magnitude component perpendicular to axis: the
    # standoff direction (e.g. hinge cabinet r_in=[-0.30,-0.10,0] ->
    # slab along x, standoff along y)
    perp_axes = [i for i in range(3) if abs(axis[i]) < 0.9]
    small = min(perp_axes, key=lambda i: abs(r_in[i]))
    keep = np.zeros(3)
    keep[small] = r_in[small]
    return keep


def import_mujoco():
    try:
        import mujoco
    except ImportError as e:
        raise ImportError("calibrate_kitchen runs MuJoCo, which is not installed here "
                          "(pip package `mujoco`)") from e
    return mujoco


def _mj(scene_xml):
    mujoco = import_mujoco()
    model = mujoco.MjModel.from_xml_string(scene_xml)
    data = mujoco.MjData(model)
    mujoco.mj_forward(model, data)
    return mujoco, model, data


def _drag_path(scene_xml, path, start):
    """Teleport-free mocap drag through `path` (list of world positions, one
    per control step, interpolated at substep resolution). Returns joint
    value per control step."""
    mujoco, model, data = _mj(scene_xml)
    data.mocap_pos[0] = start
    mujoco.mj_forward(model, data)
    pos = np.asarray(start, float)
    out = []
    for tgt in path:
        for s in range(SUB):
            frac = (s + 1) / SUB
            data.mocap_pos[0] = pos + (np.asarray(tgt) - pos) * frac
            mujoco.mj_step(model, data)
        pos = np.asarray(tgt, float)
        out.append(float(data.qpos[0]))
    return np.asarray(out)


def _arc_stroke_path(e: int, n_ctrl: int = 14, frac: float = 1.0,
                     radial_offset: float = 0.0):
    """Ideal-stroke fingertip path for a rotary element: (f0, path, swept)."""
    from beso_tpu_torch.envs.kitchen.env import GOAL_VEC, PRIMARY

    pivot, axis, h0 = G.PIVOTS[e], G.AXES[e], G.HANDLE0[e]
    goal_q = float(np.asarray(GOAL_VEC)[int(np.asarray(PRIMARY)[e])])
    theta_goal = goal_q * frac
    r_vec = h0 - pivot
    ax = axis / np.linalg.norm(axis)
    r_perp = r_vec - ax * np.dot(r_vec, ax)
    r_hat = r_perp / np.linalg.norm(r_perp)
    tangent0 = np.cross(ax, r_hat)
    sgn = np.sign(theta_goal) if theta_goal else 1.0
    # contact start: finger center behind the bar along the drag direction
    gap = G.FINGER_RADIUS + G.BAR_RADIUS + 0.002
    f0 = h0 - sgn * tangent0 * gap + r_hat * radial_offset
    path = [pivot + _rot(ax, theta_goal * (i + 1) / n_ctrl, f0 - pivot)
            for i in range(n_ctrl)]
    return f0, path, abs(theta_goal)


def arc_drag(e: int, n_ctrl: int = 14, frac: float = 1.0,
             radial_offset: float = 0.0):
    """Drag the fingertip along the ideal handle arc toward the element's
    goal joint value. Returns (q trajectory, swept finger angle)."""
    f0, path, swept = _arc_stroke_path(e, n_ctrl, frac, radial_offset)
    q = _drag_path(element_scene_xml(e), path, f0)
    return q, swept


def straight_drag(e: int, n_ctrl: int = 14, stroke_frac: float = 1.0):
    """Straight pull along the INITIAL tangent (no arc tracking): measures
    slip — the handle swings off the line and engagement is lost."""
    from beso_tpu_torch.envs.kitchen.env import GOAL_VEC, PRIMARY

    pivot, axis, h0 = G.PIVOTS[e], G.AXES[e], G.HANDLE0[e]
    goal_q = float(np.asarray(GOAL_VEC)[int(np.asarray(PRIMARY)[e])])
    r = float(G.HANDLE_RADIUS[e])
    stroke_len = abs(goal_q) * r * stroke_frac
    r_vec = h0 - pivot
    ax = axis / np.linalg.norm(axis)
    r_perp = r_vec - ax * np.dot(r_vec, ax)
    r_hat = r_perp / np.linalg.norm(r_perp)
    tangent0 = np.cross(ax, r_hat)
    sgn = np.sign(goal_q) if goal_q else 1.0
    gap = G.FINGER_RADIUS + G.BAR_RADIUS + 0.002
    f0 = h0 - sgn * tangent0 * gap
    path = [f0 + sgn * tangent0 * stroke_len * (i + 1) / n_ctrl
            for i in range(n_ctrl)]
    return _drag_path(element_scene_xml(e), path, f0)


def _slide_stroke_path(n_ctrl: int = 14, radial_offset: float = 0.0):
    """Ideal-stroke fingertip path for the slide cabinet: (f0, path, stroke)."""
    e = 3
    axis = G.AXES[e] / np.linalg.norm(G.AXES[e])
    h0 = G.HANDLE0[e]
    stroke = 0.37
    gap = G.FINGER_RADIUS + G.BAR_RADIUS + 0.002
    # push from behind the bar; radial offset moves the finger off the bar
    # in the horizontal direction perpendicular to travel
    off_dir = np.asarray([0.0, -1.0, 0.0])
    f0 = h0 - axis * gap + off_dir * radial_offset
    path = [f0 + axis * stroke * (i + 1) / n_ctrl for i in range(n_ctrl)]
    return f0, path, stroke


def slide_drag(n_ctrl: int = 14, radial_offset: float = 0.0):
    """Slide cabinet: push the handle bar along the slide axis."""
    f0, path, stroke = _slide_stroke_path(n_ctrl, radial_offset)
    q = _drag_path(element_scene_xml(3), path, f0)
    return q, stroke


def engagement_probe(e: int, offsets):
    """Radial-offset probe: how far off the handle can the fingertip be and
    still drive the joint? Returns per-offset |q| response for a 30% drag."""
    out = []
    for d in offsets:
        if int(G.ELEMENT_KIND[e]) == G.SLIDE:
            q, _ = slide_drag(n_ctrl=6, radial_offset=d)
            out.append(abs(q[-1]) / (0.37 * 6 / 14))
        else:
            q, swept = arc_drag(e, n_ctrl=6, frac=0.3, radial_offset=d)
            out.append(abs(q[-1]) / (swept * 0.3 if swept else 1.0))
    return np.asarray(out)


# ---------------------------------------------------------------------------
# kettle: torque-actuated two-finger gripper scene
# ---------------------------------------------------------------------------

_KETTLE_SCENE = f"""
<mujoco>
  <option timestep="{1.0 / SUBSTEP_HZ}" integrator="implicitfast"/>
  <worldbody>
    <geom type="plane" size="2 2 0.1" friction="0.6 0.001 0.0001"/>
    <body name="kettle" pos="0 0 0.061">
      <freejoint/>
      <geom type="cylinder" size="0.08 0.06" mass="1.6"
            friction="0.6 0.001 0.0001"/>
      <geom type="capsule" fromto="-0.03 0 0.12 -0.03 0 0.15" size="0.006"
            mass="0.02"/>
      <geom type="capsule" fromto="0.03 0 0.12 0.03 0 0.15" size="0.006"
            mass="0.02"/>
      <geom name="khandle" type="capsule"
            fromto="-{float(G.BAR_HALFLEN[6])} 0 0.155
                    {float(G.BAR_HALFLEN[6])} 0 0.155"
            size="{G.BAR_RADIUS}" friction="1.2 0.01 0.001" mass="0.05"
            solref="0.004 1"/>
    </body>
    <body name="hand" pos="0 0 0.30">
      <joint name="hx" type="slide" axis="1 0 0" damping="80"/>
      <joint name="hy" type="slide" axis="0 1 0" damping="80"/>
      <joint name="hz" type="slide" axis="0 0 1" damping="80"/>
      <geom type="box" size="0.04 0.05 0.02" mass="0.5" contype="0"
            conaffinity="0"/>
      <!-- fingers collide with the kettle (contype 2 vs conaffinity 1)
           but NOT with each other (2 & 1 == 0) -->
      <body name="fingerL" pos="0 -0.045 -0.09">
        <joint name="fL" type="slide" axis="0 1 0" range="0 0.04"
               damping="15"/>
        <geom type="box" size="0.01 0.008 0.045" mass="0.2" contype="2"
              conaffinity="1" friction="1.5 0.01 0.001" solref="0.004 1"/>
      </body>
      <body name="fingerR" pos="0 0.045 -0.09">
        <joint name="fR" type="slide" axis="0 -1 0" range="0 0.04"
               damping="15"/>
        <geom type="box" size="0.01 0.008 0.045" mass="0.2" contype="2"
              conaffinity="1" friction="1.5 0.01 0.001" solref="0.004 1"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <position joint="hx" kp="400" forcerange="-60 60"/>
    <position joint="hy" kp="400" forcerange="-60 60"/>
    <position joint="hz" kp="2500" forcerange="-250 250"/>
    <position joint="fL" kp="300" forcerange="-25 25"/>
    <position joint="fR" kp="300" forcerange="-25 25"/>
  </actuator>
</mujoco>
"""
# the hand starts with finger pads straddling the handle bar height:
# hand z=0.30, fingers at -0.09 -> pad center z=0.21; handle z=0.155+0.061
# = 0.216. Pads at y=+-0.053 around the bar (radius 0.012).


# ---------------------------------------------------------------------------
# FULL scene (round 5, VERDICT r4 #8): every element composed into ONE
# MuJoCo scene, plus the furniture volumes the surrogate's collision model
# documents (wall plane, knob backsplash panel, microwave body, the raised
# stove deck the kettle stands on) and the kettle as a static obstacle.
# Validates what per-element calibration cannot: fingertip TRANSIT between
# elements along real oracle routes (furniture clearance, cross-element
# crosstalk) and stroke reproduction with every neighbor present.
# ---------------------------------------------------------------------------

# furniture AABBs (lo, hi) — the documented surrogate volumes
# (env.py DEFAULT_KITCHEN_PARAMS wall_y/micro_lo/micro_hi + geometry.py
# panel comments + the stove deck implied by the kettle rest height)
FURNITURE_BOXES = {
    "wall": (np.asarray([-1.0, 0.95, 0.4]), np.asarray([1.0, 1.05, 2.0])),
    "knob_panel": (np.asarray([0.10, 0.92, 0.90]),
                   np.asarray([0.50, 0.95, 1.45])),
    "microwave_body": (np.asarray([-0.60, 0.80, 0.70]),
                       np.asarray([-0.15, 1.30, 1.10])),
    "stove_deck": (np.asarray([-0.45, 0.20, 1.50]),
                   np.asarray([-0.05, 0.58, 1.56])),
}
KETTLE_POS = np.asarray([-0.269, 0.350, 1.619])   # INIT_QPOS[23:26]


def full_scene_xml() -> str:
    bodies = []
    for e in range(6):
        joint, geoms, body_pos = _element_body_parts(e, jname=f"j{e}")
        bodies.append(
            f'<body name="elem{e}" pos="{body_pos[0]} {body_pos[1]} '
            f'{body_pos[2]}">{joint}{"".join(geoms)}</body>')
    # furniture group: contype/conaffinity 2 — colliding with the finger
    # (3) but not the elements (1), so element joints see exactly the
    # contacts the per-element calibration measured
    furn = []
    for name, (lo, hi) in FURNITURE_BOXES.items():
        c, s = (lo + hi) / 2, (hi - lo) / 2
        furn.append(f'<geom name="{name}" type="box" pos="{c[0]} {c[1]} '
                    f'{c[2]}" size="{s[0]} {s[1]} {s[2]}" contype="2" '
                    f'conaffinity="2"/>')
    furn.append(f'<geom name="kettle_body" type="cylinder" '
                f'pos="{KETTLE_POS[0]} {KETTLE_POS[1]} {KETTLE_POS[2]}" '
                f'size="0.07 0.06" contype="2" conaffinity="2"/>')
    return f"""
<mujoco>
  <option timestep="{1.0 / SUBSTEP_HZ}" integrator="implicitfast"
          gravity="0 0 0"/>
  <worldbody>
    {''.join(bodies)}
    {''.join(furn)}
    <body name="finger" mocap="true" pos="0 -0.4 1.2">
      <geom name="fingertip" type="sphere" size="{G.FINGER_RADIUS}"
            contype="3" conaffinity="3" mass="0.5"/>
    </body>
  </worldbody>
</mujoco>
"""


def _aabb_distance(p, lo, hi):
    """Distance from point p to an AABB (0 inside)."""
    d = np.maximum(np.maximum(lo - p, 0.0), p - hi)
    return float(np.linalg.norm(d))


def _stroke_path(e: int, n_ctrl: int = 14):
    if int(G.ELEMENT_KIND[e]) == G.SLIDE:
        return _slide_stroke_path(n_ctrl)
    return _arc_stroke_path(e, n_ctrl)


def run_full_scene(out_path, golden_path=GOLDEN_DIR / "kitchen_mujoco_v2.npz"):
    """Two-task routes in the FULL MuJoCo scene: the per-element IDEAL
    stroke paths (the exact paths the per-element calibration measured)
    joined by straight-line transits — the oracle's route shape. An
    open-loop replay of the surrogate ORACLE's ee path is the wrong
    protocol here (the oracle is a feedback policy: replayed open-loop in
    a sim with different contact response it over/under-drives); what the
    full scene can validate that per-element scenes cannot is
    (a) fingertip-furniture clearance along real transit routes,
    (b) cross-element crosstalk (the finger brushing neighbor handles the
    surrogate does not model), and
    (c) stroke reproduction with every neighbor body present, vs the
    per-element golden trajectories read from `golden_path`; the results
    go to `kitchen_full_scene.npz` beside `out_path`."""
    mujoco = import_mujoco()
    out = _check_out(Path(out_path)).with_name("kitchen_full_scene.npz")
    names = ["bottom_burner", "top_burner", "light_switch", "slide_cabinet",
             "hinge_cabinet", "microwave"]
    golden = np.load(Path(golden_path))
    routes = [(5, 0), (4, 3), (2, 4), (3, 5), (0, 2), (1, 4)]
    model = mujoco.MjModel.from_xml_string(full_scene_xml())
    qadr = [model.jnt_qposadr[model.joint(f"j{e}").id] for e in range(6)]
    finger_geom = model.geom("fingertip").id
    handle_geoms = {model.geom(f"handle_j{e}").id: e for e in range(6)}
    results = {}
    print("=== full-scene two-task routes (ideal strokes + transits) ===")
    n_ctrl = 14
    for seq in routes:
        f0_a, path_a, _ = _stroke_path(seq[0], n_ctrl)
        f0_b, path_b, _ = _stroke_path(seq[1], n_ctrl)
        # transit: straight line from stroke-A end to stroke-B start, at
        # the oracle's reach speed (~0.05 m per control step)
        end_a = np.asarray(path_a[-1], float)
        n_transit = max(int(np.linalg.norm(f0_b - end_a) / 0.05), 4)
        transit = [end_a + (f0_b - end_a) * (i + 1) / n_transit
                   for i in range(n_transit)]
        full_path = list(path_a) + transit + list(path_b)
        seg = (["A"] * len(path_a) + ["T"] * len(transit)
               + ["B"] * len(path_b))

        data = mujoco.MjData(model)
        pos = np.asarray(f0_a, float)
        data.mocap_pos[0] = pos
        mujoco.mj_forward(model, data)
        mj_joints, clear, transit_contacts = [], [], set()
        for tgt, s_tag in zip(full_path, seg):
            for s in range(SUB):
                frac = (s + 1) / SUB
                data.mocap_pos[0] = pos + (np.asarray(tgt) - pos) * frac
                mujoco.mj_step(model, data)
                if s_tag == "T":
                    for ci in range(data.ncon):
                        g1, g2 = data.contact[ci].geom1, data.contact[ci].geom2
                        if finger_geom in (g1, g2):
                            other = g2 if g1 == finger_geom else g1
                            nm = mujoco.mj_id2name(
                                model, mujoco.mjtObj.mjOBJ_GEOM, other)
                            transit_contacts.add(nm or f"geom{other}")
            pos = np.asarray(tgt, float)
            mj_joints.append([data.qpos[a] for a in qadr])
            clear.append(min(_aabb_distance(pos, lo, hi)
                             for lo, hi in FURNITURE_BOXES.values()))
        mj_joints = np.asarray(mj_joints)
        clear = np.asarray(clear)
        tag = f"{names[seq[0]]}->{names[seq[1]]}"

        # stroke reproduction vs the per-element golden trajectory
        rows = []
        for k, e in enumerate(seq):
            g = golden[f"arc_{names[e]}"]
            sl = (slice(0, n_ctrl) if k == 0
                  else slice(len(path_a) + n_transit, None))
            q = mj_joints[sl, e]
            final_ratio = q[-1] / g[-1] if abs(g[-1]) > 1e-9 else 0.0
            rows.append((e, float(q[-1]), float(g[-1]), float(final_ratio)))
        # crosstalk: other elements moved DURING this route beyond where
        # the route's own strokes put them (exclude both driven elements)
        spect = [e for e in range(6) if e not in seq]
        crosstalk = float(np.abs(mj_joints[:, spect]).max())
        print(f"  {tag}: min furniture clearance {clear.min()*1000:.0f} mm | "
              f"spectator crosstalk {crosstalk:.4f} | transit contacts "
              f"{sorted(transit_contacts) or '-'}")
        for e, mjf, gf, ratio in rows:
            print(f"    {names[e]:15s} full-scene final {mjf:+.3f} vs "
                  f"per-element golden {gf:+.3f} (ratio {ratio:.3f})")
        results[f"route_{tag}__mj"] = mj_joints
        results[f"route_{tag}__clear"] = clear
        results[f"route_{tag}__finals"] = np.asarray(
            [[r[1], r[2]] for r in rows])
        results[f"route_{tag}__crosstalk"] = np.asarray([crosstalk])
        results[f"route_{tag}__n_transit_contacts"] = np.asarray(
            [len(transit_contacts)], np.int32)
    np.savez(out, **results)
    print(f"wrote {out}")


def kettle_grasp_run(drag_vec, n_ctrl=10, lateral_offset=0.0, yank=False):
    """Close the actuated gripper on the kettle handle, LIFT the kettle off
    the counter, then command the hand through `drag_vec` (xy, meters) over
    n_ctrl control steps (yank=True: one instantaneous step command instead,
    to measure grasp breakaway). Returns kettle/hand trajectories and the
    grasp outcome (airborne after lift)."""
    mujoco, model, data = _mj(_KETTLE_SCENE)
    qadr = {n: model.jnt_qposadr[model.joint(n).id] for n in ("hx", "hy", "hz")}
    # start with the gripper around the bar, optionally offset along y
    data.qpos[qadr["hy"]] = lateral_offset
    data.ctrl[0], data.ctrl[1], data.ctrl[2] = 0.0, lateral_offset, 0.0
    # fingers open
    data.ctrl[3] = data.ctrl[4] = 0.0
    mujoco.mj_forward(model, data)
    for _ in range(SUB):
        mujoco.mj_step(model, data)
    # close: overdrive the finger targets so the clamp force saturates
    # (Panda-like firm grip; forcerange bounds it)
    data.ctrl[3] = data.ctrl[4] = 0.08
    for _ in range(2 * SUB):
        mujoco.mj_step(model, data)
    # lift 12 cm
    for s in range(2 * SUB):
        data.ctrl[2] = 0.12 * min(1.0, (s + 1) / SUB)
        mujoco.mj_step(model, data)
    kz = float(data.body("kettle").xpos[2])
    grasp_held = kz > 0.10  # airborne (resting height is 0.061)

    per = np.asarray(drag_vec, float) / n_ctrl
    hand_traj, kettle_traj = [], []
    for i in range(n_ctrl):
        for s in range(SUB):
            if yank:
                # step input: command the full displacement instantly
                data.ctrl[0], data.ctrl[1] = per[0] * n_ctrl, per[1] * n_ctrl
            else:
                cur = per * i + per * ((s + 1) / SUB)
                data.ctrl[0], data.ctrl[1] = cur[0], cur[1]
            mujoco.mj_step(model, data)
        hand_traj.append([data.qpos[qadr["hx"]], data.qpos[qadr["hy"]]])
        kettle_traj.append(data.body("kettle").xpos[:2].copy())
    still_held = float(data.body("kettle").xpos[2]) > 0.10
    return dict(hand=np.asarray(hand_traj), kettle=np.asarray(kettle_traj),
                grasp_held=grasp_held, still_held=still_held)


def _check_out(out: Path) -> Path:
    """`out`, unless it lies under tests/golden/, which the JAX package's
    fidelity tests read."""
    if GOLDEN_DIR.resolve() in (out.resolve(), *out.resolve().parents):
        raise ValueError(f"refusing to write {out} under {GOLDEN_DIR}: pass --out elsewhere")
    out.parent.mkdir(parents=True, exist_ok=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=str(DEFAULT_OUT),
                        help="where the measurements go (--full-scene: its file beside it)")
    parser.add_argument("--golden", default=str(GOLDEN_DIR / "kitchen_mujoco_v2.npz"),
                        help="the per-element goldens --full-scene compares against")
    parser.add_argument("--full-scene", action="store_true",
                        help="replay two-task routes in the all-elements scene "
                             "(transit clearance, crosstalk, stroke reproduction)")
    args = parser.parse_args(argv)

    if args.full_scene:
        run_full_scene(args.out, args.golden)
        return None

    results = {}
    names = ["bottom_burner", "top_burner", "light_switch", "slide_cabinet",
             "hinge_cabinet", "microwave"]

    print("=== engaged articulation efficiency (arc/line-following drag) ===")
    effs = np.zeros(6)
    steady = np.zeros(6)
    for e in range(6):
        if int(G.ELEMENT_KIND[e]) == G.SLIDE:
            q, swept = slide_drag()
        else:
            q, swept = arc_drag(e)
        eff = abs(q[-1]) / swept
        # steady-state engaged slope: per-step joint advance once contact
        # is loaded (skip the 2-step contact-gap take-up) per unit of
        # per-step fingertip advance — the constant the surrogate ships as
        # drive_eff (the full-stroke ratio folds in the one-time gap
        # take-up, which the surrogate models via the engagement radius)
        per = swept / len(q)
        steady[e] = np.abs(np.diff(q))[2:].mean() / per
        effs[e] = eff
        results[f"arc_{names[e]}"] = q
        print(f"  {names[e]:15s}: full-stroke eff {eff:.3f}  "
              f"steady slope {steady[e]:.3f}")
    results["drive_eff"] = effs
    results["drive_eff_steady"] = steady

    print("=== straight-pull slip (hinged elements) ===")
    for e in (4, 5):
        qs = straight_drag(e)
        results[f"straight_{names[e]}"] = qs
        print(f"  {names[e]:15s}: final {qs[-1]:+.3f} "
              f"(arc-follow reaches {results[f'arc_{names[e]}'][-1]:+.3f})")

    print("=== engagement radial-offset probe ===")
    offsets = np.asarray([0.0, 0.01, 0.02, 0.03, 0.04, 0.05, 0.06, 0.08])
    results["probe_offsets"] = offsets
    for e, nm in ((0, "bottom_burner"), (4, "hinge_cabinet"),
                  (3, "slide_cabinet")):
        resp = engagement_probe(e, offsets)
        results[f"probe_{nm}"] = resp
        engaged = offsets[resp > 0.25]
        onset = engaged.max() if engaged.size else 0.0
        print(f"  {nm:15s}: response {np.round(resp, 2)} -> onset {onset:.3f} m")

    print("=== kettle: torque-actuated gripper transport ===")
    # tracking at oracle speed (0.05 m per control step)
    run = kettle_grasp_run([0.0, 0.5], n_ctrl=10)
    track = (np.linalg.norm(run["kettle"][-1] - run["kettle"][0])
             / max(np.linalg.norm(run["hand"][-1] - run["hand"][0]), 1e-9))
    results["kettle_hand"] = run["hand"]
    results["kettle_kettle"] = run["kettle"]
    print(f"  grasp held: {run['grasp_held']} (still held after drag: "
          f"{run['still_held']})  tracking ratio {track:.3f} "
          f"(0.05 m/step drag)")

    # speed sweep: largest per-step displacement that still tracks >= 0.9
    speeds = [0.05, 0.10, 0.15, 0.20, 0.30]
    tracks = []
    for sp in speeds:
        r2 = kettle_grasp_run([0.0, sp * 8], n_ctrl=8)
        t = (np.linalg.norm(r2["kettle"][-1] - r2["kettle"][0])
             / max(np.linalg.norm(r2["hand"][-1] - r2["hand"][0]), 1e-9))
        tracks.append(t if r2["grasp_held"] else 0.0)
        print(f"  speed {sp:.2f} m/step: tracking {tracks[-1]:.3f} "
              f"(held after: {r2['still_held']})")
    results["kettle_speeds"] = np.asarray(speeds)
    results["kettle_tracks"] = np.asarray(tracks)

    # lateral grasp offset tolerance (grasp succeeds = kettle airborne)
    offs = [0.0, 0.02, 0.04, 0.06, 0.08, 0.10]
    grasp_ok = []
    for d in offs:
        r3 = kettle_grasp_run([0.0, 0.1], n_ctrl=3, lateral_offset=d)
        grasp_ok.append(bool(r3["grasp_held"]))
        print(f"  lateral offset {d:.2f}: grasp "
              f"{'OK' if r3['grasp_held'] else 'FAILED'}")
    results["kettle_grasp_offsets"] = np.asarray(offs)
    results["kettle_grasp_ok"] = np.asarray(grasp_ok)

    # breakaway: instantaneous 0.4 m step command — does the grasp survive?
    r4 = kettle_grasp_run([0.0, 0.4], n_ctrl=4, yank=True)
    gap = np.linalg.norm(r4["hand"][-1] - r4["kettle"][-1])
    print(f"  yank (0.4 m step): held {r4['still_held']}, "
          f"final hand-kettle xy gap {gap:.3f}")
    results["kettle_yank_held"] = np.asarray(r4["still_held"])
    results["kettle_yank_gap"] = np.asarray(gap)

    out = _check_out(Path(args.out))
    np.savez(out, **results)
    print(f"\nwrote {out}")
    return results


if __name__ == "__main__":
    main()
