"""Calibrate the port's block-push contact model against MuJoCo golden
rollouts (port of `scripts/calibrate_block_push.py`).

The reference's block push runs Bullet rigid-body physics on the CPU; the
surrogate (`beso_tpu_torch/envs/block_push/env.py`) replaces it with a
batched planar contact model. This tool builds the same scene in MuJoCo
(0.04 m cube blocks of mass 0.01 and lateral friction 1.0, a 0.0127 m
cylinder effector, from the reference's `block2.urdf` and
`suction/cylinder_real.urdf`), drives the effector through scripted push
scenarios (central, off-center at several lever arms, rotated, diagonal,
block into block) and records the blocks' (x, y, yaw) at 10 Hz.

The scenarios split into STABLE ones (off-center, rotated, diagonal: MuJoCo's
final-state dispersion under +-0.5 mm initial perturbation is a few mm and
a few degrees), matched point by point, and CHAOTIC ones (central,
block_into_block: 30-50 mm), judged against MuJoCo's perturbation band.

Modes (MuJoCo is imported only by the modes that run it, and they raise an
ImportError without it; the surrogate runs on `--device`, the card unless
`--device cpu`):

* default: the 7 scenarios in MuJoCo, written to `--out`, then the
  surrogate's RMSE against them (`--sweep`: at 0.5, 1 and 2 x FRICTION_K2);
* `--ensemble N [--sweep]`: N randomized pushes in MuJoCo, their statistics
  written beside `--out` (`block_push_mujoco_ensemble.npz`), and the
  surrogate's (`--sweep`: at 0.25-4 x FRICTION_K2);
* `--burst`: a per-substep trace of one MuJoCo contact burst (block
  velocity, spin, floor z, contact count and normal force);
* `--dispersion`: MuJoCo's final-state band of each scenario under
  perturbation; `--surrogate-dispersion`: the surrogate's beside it;
* `--rot-sweep`: the contact model's rotational constants (CONTACT_MU, the
  ground corner-point arm, TIP_TORQUE_LEAK) scored on the stable-5 RMSE
  and the 48-push ensemble against the stored goldens of `--golden-dir`
  (no MuJoCo);
* `--dither-sweep`: CONTACT_DITHER, BACKED_STIFF, DITHER_ANG and
  BB_DITHER_ANG against the chaotic scenarios' MuJoCo bands, the stable-5
  RMSE against the stored goldens re-checked at each.

The sweeps patch the env module's constants, which `block_push_step` reads
at call time, inside `patched_constants`, which restores them. Files are
written under `logs/calibration/` unless `--out` says otherwise; never under
`tests/golden/`, whose files the JAX package's fidelity tests read.

Run: python -m beso_tpu_torch.scripts.calibrate_block_push [--device cpu]
     [--out PATH] [--golden-dir DIR] [--ensemble N] [--sweep] [--burst]
     [--dispersion] [--surrogate-dispersion] [--rot-sweep] [--dither-sweep]
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
GOLDEN_DIR = REPO / "tests" / "golden"
DEFAULT_OUT = Path("logs") / "calibration" / "block_push_mujoco.npz"

CONTROL_DT = 0.1          # 10 Hz control (block_pushing.py:188)
SUBSTEP_HZ = 240          # Bullet step frequency (block_pushing.py:269-281)
EFFECTOR_SPEED = 1.0      # m/s tracking cap (as the surrogate)
BLOCK_HALF = 0.02         # block2.urdf: 0.04 box
EFF_RADIUS = 0.0127       # cylinder_real.urdf
N_CONTROL_STEPS = 12

STABLE_SCENARIOS = ("offcenter_0.25", "offcenter_0.5", "offcenter_0.75",
                    "rotated", "diagonal")

# the sweeps' full grids: (CONTACT_MU, ground arm scale, TIP_TORQUE_LEAK)
# and (CONTACT_DITHER, BACKED_STIFF, DITHER_ANG, BB_DITHER_ANG)
ROT_COMBOS = tuple(itertools.product((0.02, 0.05, 0.1, 0.2), (1.0, 1.25, 1.5), (0.0, 0.1)))
DITHER_COMBOS = tuple(itertools.product((0.0, 2e-4, 5e-4, 1e-3), (4.0, 6.0, 8.0),
                                        (0.05, 0.1), (0.0, 0.1)))

_SCENE = f"""
<mujoco>
  <option timestep="{1.0 / SUBSTEP_HZ}" integrator="implicitfast"/>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 0.1"
          friction="1.0 0.001 0.0001"/>
    <body name="b0" pos="0.4 -0.2 {BLOCK_HALF}">
      <freejoint/>
      <geom type="box" size="{BLOCK_HALF} {BLOCK_HALF} {BLOCK_HALF}"
            mass="0.01" friction="1.0 0.001 0.0001"/>
    </body>
    <body name="b1" pos="0.8 0.6 {BLOCK_HALF}">
      <freejoint/>
      <geom type="box" size="{BLOCK_HALF} {BLOCK_HALF} {BLOCK_HALF}"
            mass="0.01" friction="1.0 0.001 0.0001"/>
    </body>
    <body name="eff" mocap="true" pos="0.3 -0.4 {BLOCK_HALF}">
      <geom type="cylinder" size="{EFF_RADIUS} 0.0675"
            contype="1" conaffinity="1" mass="1.0"/>
    </body>
  </worldbody>
</mujoco>
"""


def import_mujoco():
    try:
        import mujoco
    except ImportError as e:
        raise ImportError("this mode runs MuJoCo, which is not installed here "
                          "(pip package `mujoco`); --rot-sweep needs only the "
                          "stored goldens") from e
    return mujoco


def _scenarios():
    """Each: (name, b0_pos, b0_yaw, b1_pos, effector_start, target_offsets);
    target_offsets are the per-control-step xy deltas of the effector
    target (the policy's action space)."""
    fwd = [(0.0, 0.035)] * N_CONTROL_STEPS
    out = [("central", (0.4, -0.2), 0.0, (0.8, 0.6), (0.4, -0.33), fwd)]
    # off-center pushes: lever arms of 1/4, 1/2, 3/4 block half-width
    for frac in (0.25, 0.5, 0.75):
        out.append((f"offcenter_{frac}", (0.4, -0.2), 0.0, (0.8, 0.6),
                    (0.4 + frac * BLOCK_HALF, -0.33), fwd))
    out.append(("rotated", (0.4, -0.2), 0.6, (0.8, 0.6), (0.4, -0.33), fwd))
    diag = [(0.025, 0.025)] * N_CONTROL_STEPS
    out.append(("diagonal", (0.42, -0.2), 0.0, (0.8, 0.6), (0.36, -0.3), diag))
    # block into block: the second block directly in the push path
    out.append(("block_into_block", (0.4, -0.2), 0.0, (0.4, -0.11), (0.4, -0.3), fwd))
    return out


def run_mujoco(scn):
    """One scenario in MuJoCo: [T, 5] per control step, b0 (x, y, yaw) and
    b1 (x, y)."""
    mujoco = import_mujoco()
    name, b0, yaw0, b1, eff0, offsets = scn
    model = mujoco.MjModel.from_xml_string(_SCENE)
    data = mujoco.MjData(model)
    # block poses (freejoint qpos: 3 pos + 4 quat)
    data.qpos[0:3] = [b0[0], b0[1], BLOCK_HALF]
    data.qpos[3:7] = [np.cos(yaw0 / 2), 0, 0, np.sin(yaw0 / 2)]
    data.qpos[7:10] = [b1[0], b1[1], BLOCK_HALF]
    data.qpos[10:14] = [1, 0, 0, 0]
    data.mocap_pos[0] = [eff0[0], eff0[1], 0.0675]
    mujoco.mj_forward(model, data)

    sub_per_ctrl = int(SUBSTEP_HZ * CONTROL_DT)
    max_step = EFFECTOR_SPEED / SUBSTEP_HZ
    eff = np.asarray(eff0, float)
    tgt = eff.copy()
    traj = []
    for delta in offsets:
        tgt = tgt + np.asarray(delta)
        for _ in range(sub_per_ctrl):
            to_tgt = tgt - eff
            d = np.linalg.norm(to_tgt)
            if d > 1e-9:
                eff = eff + to_tgt / d * min(d, max_step)
            data.mocap_pos[0] = [eff[0], eff[1], 0.0675]
            mujoco.mj_step(model, data)
        qw, qx, qy, qz = data.qpos[3:7]
        yaw = np.arctan2(2 * (qw * qz + qx * qy), 1 - 2 * (qy * qy + qz * qz))
        traj.append([data.qpos[0], data.qpos[1], yaw, data.qpos[7], data.qpos[8]])
    return np.asarray(traj)


def _states(scns, device):
    """The scenarios' start states as one batch of len(scns) envs."""
    from beso_tpu_torch.envs.block_push.env import BlockPushState

    B = len(scns)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    eff = f32([s[4] for s in scns])
    return BlockPushState(
        effector=eff, effector_target=eff.clone(),
        block_pos=f32([[s[1], s[3]] for s in scns]),
        block_yaw=f32([[s[2], 0.0] for s in scns]),
        target_pos=f32([[[0.28, 0.2], [0.52, 0.2]]] * B),
        target_yaw=f32([[np.pi, np.pi]] * B),
        in_target=torch.zeros(B, 2, 2, dtype=torch.bool, device=device),
        completed=torch.zeros(B, 4, dtype=torch.bool, device=device),
        done=torch.zeros(B, dtype=torch.bool, device=device),
        steps=torch.zeros(B, dtype=torch.int32, device=device),
        block_vel=torch.zeros(B, 2, 2, device=device),
        block_yawrate=torch.zeros(B, 2, device=device))


@torch.inference_mode()
def run_surrogate(scns, device="cuda", friction_k2=None):
    """All scenarios as one batch of envs through the port's
    `block_push_step`: [N, T, 5] like `run_mujoco`'s, on the host."""
    from beso_tpu_torch.envs.block_push.env import block_push_step

    state = _states(scns, device)
    offsets = torch.tensor([s[5] for s in scns], dtype=torch.float32, device=device)
    traj = []
    for i in range(offsets.shape[1]):
        state, obs, _, _ = block_push_step(state, offsets[:, i], friction_k2)
        traj.append(obs[:, :5])
    return torch.stack(traj, 1).cpu().numpy()


@contextlib.contextmanager
def patched_constants(**values):
    """Set the env module's constants to `values` inside the block and
    restore the shipped ones after it, whatever happens in it."""
    import beso_tpu_torch.envs.block_push.env as bpe

    saved = {k: getattr(bpe, k) for k in values}
    try:
        for k, v in values.items():
            setattr(bpe, k, v)
        yield bpe
    finally:
        for k, v in saved.items():
            setattr(bpe, k, v)


def wrap_angle(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def error(mj, sg):
    """(position RMSE over both blocks' xy, b0 yaw RMSE) of a surrogate
    trajectory against MuJoCo's."""
    pos = np.sqrt(np.mean((mj[:, [0, 1, 3, 4]] - sg[:, [0, 1, 3, 4]]) ** 2))
    yaw = np.sqrt(np.mean(wrap_angle(mj[:, 2] - sg[:, 2]) ** 2))
    return pos, yaw


def stable_rmse(golden, stable, trajs):
    """Mean position RMSE (mm) and yaw RMSE (degrees) over the stable
    scenarios."""
    errs = np.asarray([error(golden[s[0]], t) for s, t in zip(stable, trajs)])
    return errs[:, 0].mean() * 1000, np.degrees(errs[:, 1].mean())


def ensemble_scenarios(n=48, seed=0):
    """Randomized northward pushes: random block yaw, random lateral
    approach offset. Single contact-rich trajectories are chaotic, so the
    ensemble is judged on its statistics."""
    rng = np.random.default_rng(seed)
    fwd = [(0.0, 0.035)] * N_CONTROL_STEPS
    out = []
    for i in range(n):
        yaw = float(rng.uniform(0, np.pi))
        dx = float(rng.uniform(-0.8, 0.8) * BLOCK_HALF)
        out.append((f"ens_{i}", (0.4, -0.2), yaw, (0.8, 0.6), (0.4 + dx, -0.33), fwd))
    return out


def ensemble_stats(trajs):
    """Per-push net effect: the push is northward, so 'parallel' is the y
    displacement and 'perp' the x one; |dyaw| from the first step's yaw."""
    d_par = np.asarray([t[-1, 1] - (-0.2) for t in trajs])
    d_perp = np.asarray([t[-1, 0] - 0.4 for t in trajs])
    d_yaw = np.asarray([np.abs(wrap_angle(t[-1, 2] - t[0, 2])) for t in trajs])
    return d_par, d_perp, d_yaw


def report_ensemble(name, d_par, d_perp, d_yaw):
    print(f"{name}: push-parallel {d_par.mean()*1000:6.1f} +- "
          f"{d_par.std()*1000:5.1f} mm | perp |{np.abs(d_perp).mean()*1000:5.1f}| mm "
          f"| |dyaw| {np.degrees(d_yaw.mean()):5.1f} +- "
          f"{np.degrees(d_yaw.std()):4.1f} deg")


def run_burst(dx=0.01):
    """Per-substep trace of one MuJoCo contact burst (the measurement
    behind the surrogate's tipping-plateau law): block velocity, spin,
    floor z, pusher contact count and total normal force."""
    mujoco = import_mujoco()
    model = mujoco.MjModel.from_xml_string(_SCENE)
    data = mujoco.MjData(model)
    data.qpos[0:3] = [0.4, -0.2, BLOCK_HALF]
    data.qpos[3:7] = [1, 0, 0, 0]
    data.qpos[7:10] = [0.8, 0.6, BLOCK_HALF]
    data.qpos[10:14] = [1, 0, 0, 0]
    data.mocap_pos[0] = [0.4 + dx, -0.24, 0.0675]
    mujoco.mj_forward(model, data)
    eff = np.array([0.4 + dx, -0.24])
    tgt = eff + np.array([0.0, 0.07])
    max_step = EFFECTOR_SPEED / SUBSTEP_HZ
    print("sub | blk_y    blk_x   | vy     vx     wz    | z      | nc  Fn")
    for s in range(48):
        to = tgt - eff
        d = np.linalg.norm(to)
        if d > 1e-9:
            eff = eff + to / d * min(d, max_step)
        data.mocap_pos[0] = [eff[0], eff[1], 0.0675]
        mujoco.mj_step(model, data)
        fn, nc = 0.0, 0
        for ci in range(data.ncon):
            names = {mujoco.mj_id2name(model, mujoco.mjtObj.mjOBJ_GEOM, g)
                     for g in (data.contact[ci].geom1, data.contact[ci].geom2)}
            if "floor" not in names:
                f6 = np.zeros(6)
                mujoco.mj_contactForce(model, data, ci, f6)
                nc += 1
                fn += f6[0]
        if s % 2 == 0:
            print(f"{s:3d} | {data.qpos[1]:7.4f} {data.qpos[0]:7.4f} | "
                  f"{data.qvel[1]:6.3f} {data.qvel[0]:6.3f} "
                  f"{data.qvel[5]:6.2f} | {data.qpos[2]:.4f} | {nc}  {fn:.2f}")


def _perturbed(scn, perts):
    name, b0, yaw0, b1, eff0, offsets = scn
    return [(name, (b0[0] + p[0], b0[1] + p[1]), yaw0, b1, eff0, offsets) for p in perts]


def _fmt_band(f):
    return (f"x {f[:, 0].mean():.3f}+-{f[:, 0].std()*1000:5.1f}mm "
            f"y {f[:, 1].mean():.3f}+-{f[:, 1].std()*1000:5.1f}mm "
            f"yaw {np.degrees(f[:, 2].mean()):6.1f}"
            f"+-{np.degrees(f[:, 2].std()):5.1f}deg")


def run_dispersion(n=8, seed=1, surrogate_side=False, device="cuda"):
    """Final-state band of each scripted scenario under +-0.5 mm initial
    block perturbation: MuJoCo's, and with `surrogate_side` the
    surrogate's beside it (all scenarios' copies in one batch)."""
    perts = np.random.default_rng(seed).uniform(-5e-4, 5e-4, (n, 2))
    scns = _scenarios()
    sg = (run_surrogate([p for s in scns for p in _perturbed(s, perts)], device)[:, -1, :3]
          .reshape(len(scns), n, 3) if surrogate_side else None)
    for i, scn in enumerate(scns):
        tag = "stable " if scn[0] in STABLE_SCENARIOS else "CHAOTIC"
        f = np.asarray([run_mujoco(s)[-1, :3] for s in _perturbed(scn, perts)])
        print(f"{tag} {scn[0]:18s} mj  {_fmt_band(f)}")
        if surrogate_side:
            print(f"{tag} {scn[0]:18s} sur {_fmt_band(sg[i])}")


def load_goldens(golden_dir):
    golden_dir = Path(golden_dir)
    return (np.load(golden_dir / "block_push_mujoco.npz"),
            np.load(golden_dir / "block_push_mujoco_ensemble.npz"))


def run_rot_sweep(golden_dir=GOLDEN_DIR, combos=ROT_COMBOS, device="cuda"):
    """Score each (CONTACT_MU, ground arm scale, TIP_TORQUE_LEAK) on the
    stable-5 RMSE against the stored goldens (target: yaw <= 10 deg with pos
    <= 6 mm) and on the 48-push ensemble's statistics against MuJoCo's.
    Returns one dict per combination."""
    import beso_tpu_torch.envs.block_push.env as bpe

    golden, ens_mj = load_goldens(golden_dir)
    stable = [s for s in _scenarios() if s[0] in STABLE_SCENARIOS]
    ens = ensemble_scenarios(48)
    base_pts = np.asarray(bpe._GROUND_PTS)
    rows = []
    for mu, arm, tleak in combos:
        with patched_constants(CONTACT_MU=mu, TIP_TORQUE_LEAK=tleak,
                               _GROUND_PTS=base_pts * arm):
            trajs = run_surrogate(stable + ens, device)
        tp, ty = stable_rmse(golden, stable, trajs[:len(stable)])
        d_par, d_perp, d_yaw = ensemble_stats(list(trajs[len(stable):]))
        ok = "<=OK=>" if (ty <= 10.0 and tp <= 6.0) else "      "
        print(f"{ok} mu={mu:<4} arm={arm:<4} tq_leak={tleak}: stable pos {tp:5.1f} mm "
              f"yaw {ty:5.1f} deg | ens par {d_par.mean()*1000:5.1f} perp "
              f"{np.abs(d_perp).mean()*1000:5.1f} |dyaw| {np.degrees(d_yaw.mean()):5.1f} "
              f"(mj {ens_mj['d_par'].mean()*1000:.1f}/"
              f"{np.abs(ens_mj['d_perp']).mean()*1000:.1f}/"
              f"{np.degrees(ens_mj['d_yaw'].mean()):.1f})")
        rows.append({"contact_mu": mu, "arm": arm, "tip_torque_leak": tleak,
                     "stable_pos_mm": float(tp), "stable_yaw_deg": float(ty),
                     "ens_par_mm": float(d_par.mean() * 1000),
                     "ens_perp_mm": float(np.abs(d_perp).mean() * 1000),
                     "ens_dyaw_deg": float(np.degrees(d_yaw.mean()))})
    return rows


def run_dither_sweep(golden_dir=GOLDEN_DIR, combos=DITHER_COMBOS, n=16, seed=1,
                     device="cuda"):
    """Each (CONTACT_DITHER, BACKED_STIFF, DITHER_ANG, BB_DITHER_ANG)
    against the chaotic scenarios' MuJoCo self-dispersion bands (mean and
    spread should land inside), with the stable-5 RMSE against the stored
    goldens re-checked. Returns one dict per combination, with the
    surrogate's final (x, y, yaw) per chaotic scenario and perturbation."""
    perts = np.random.default_rng(seed).uniform(-5e-4, 5e-4, (n, 2))
    chaotic = [s for s in _scenarios() if s[0] not in STABLE_SCENARIOS]
    stable = [s for s in _scenarios() if s[0] in STABLE_SCENARIOS]
    golden, _ = load_goldens(golden_dir)
    print(f"MuJoCo bands (n={n}):")
    for scn in chaotic:
        f = np.asarray([run_mujoco(s)[-1, :3] for s in _perturbed(scn, perts)])
        print(f"  {scn[0]:18s} {_fmt_band(f)}")
    batch = [p for s in chaotic for p in _perturbed(s, perts)] + stable
    rows = []
    for dither, stiff, ang, bba in combos:
        with patched_constants(CONTACT_DITHER=dither, BACKED_STIFF=stiff, DITHER_ANG=ang,
                               BB_DITHER_ANG=bba):
            trajs = run_surrogate(batch, device)
        finals = trajs[:len(chaotic) * n, -1, :3].reshape(len(chaotic), n, 3)
        tp, ty = stable_rmse(golden, stable, trajs[len(chaotic) * n:])
        print(f"dither={dither:g} stiff={stiff:g} ang={ang:g} bba={bba:g} (stable-5 pos "
              f"{tp:.1f} mm yaw {ty:.1f} deg)")
        for scn, f in zip(chaotic, finals):
            print(f"  {scn[0]:18s} {_fmt_band(f)}")
        rows.append({"contact_dither": dither, "backed_stiff": stiff, "dither_ang": ang,
                     "bb_dither_ang": bba, "stable_pos_mm": float(tp),
                     "stable_yaw_deg": float(ty),
                     "bands": {s[0]: f for s, f in zip(chaotic, finals)}})
    return rows


def _check_out(out: Path) -> Path:
    """`out`, unless it lies under tests/golden/, which the JAX package's
    fidelity tests read."""
    if GOLDEN_DIR.resolve() in (out.resolve(), *out.resolve().parents):
        raise ValueError(f"refusing to write {out} under {GOLDEN_DIR}: pass --out elsewhere")
    out.parent.mkdir(parents=True, exist_ok=True)
    return out


def _k2_report(label, golden, scns, trajs, per_scenario):
    errs = [error(golden[s[0]], t) for s, t in zip(scns, trajs)]
    if per_scenario:
        for s, (p, y) in zip(scns, errs):
            print(f"  surrogate {s[0]}: pos RMSE {p*1000:.1f} mm, yaw RMSE "
                  f"{np.degrees(y):.1f} deg")
    errs = np.asarray(errs)
    print(f"{label}: mean pos RMSE {errs[:, 0].mean()*1000:.1f} mm, mean yaw RMSE "
          f"{np.degrees(errs[:, 1].mean()):.1f} deg")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=str(DEFAULT_OUT),
                        help="where the MuJoCo goldens go (the ensemble's beside it)")
    parser.add_argument("--golden-dir", default=str(GOLDEN_DIR),
                        help="the stored goldens the sweeps read")
    parser.add_argument("--device", default="cuda",
                        help="the surrogate's torch device (default: cuda; --device cpu)")
    parser.add_argument("--sweep", action="store_true",
                        help="sweep FRICTION_K2 and report errors")
    parser.add_argument("--ensemble", type=int, default=0,
                        help="also run an N-scenario randomized ensemble and "
                             "report distribution statistics")
    parser.add_argument("--burst", action="store_true",
                        help="per-substep instrumented burst trace")
    parser.add_argument("--dispersion", action="store_true",
                        help="MuJoCo self-dispersion of each scenario")
    parser.add_argument("--surrogate-dispersion", action="store_true",
                        help="print the surrogate's dispersion bands next to MuJoCo's")
    parser.add_argument("--rot-sweep", action="store_true",
                        help="sweep the contact model's rotational legs "
                             "(CONTACT_MU, ground arm, tip-torque leak) "
                             "against the stored golden data")
    parser.add_argument("--dither-sweep", action="store_true",
                        help="sweep CONTACT_DITHER and the dither angles against "
                             "the chaotic scenarios' MuJoCo dispersion bands")
    args = parser.parse_args(argv)
    device = torch.device(args.device)

    if args.burst:
        return run_burst()
    if args.dispersion or args.surrogate_dispersion:
        return run_dispersion(surrogate_side=args.surrogate_dispersion, device=device)
    if args.rot_sweep:
        return run_rot_sweep(args.golden_dir, device=device)
    if args.dither_sweep:
        return run_dither_sweep(args.golden_dir, device=device)

    import beso_tpu_torch.envs.block_push.env as bpe

    out = _check_out(Path(args.out))
    if args.ensemble:
        scns = ensemble_scenarios(args.ensemble)
        mj_stats = ensemble_stats([run_mujoco(s) for s in scns])
        report_ensemble("mujoco", *mj_stats)
        ens_out = out.with_name("block_push_mujoco_ensemble.npz")
        np.savez(ens_out, d_par=mj_stats[0], d_perp=mj_stats[1], d_yaw=mj_stats[2])
        print(f"wrote {ens_out}")
        k2s = ([bpe.FRICTION_K2 * m for m in (0.25, 0.5, 1.0, 2.0, 4.0)]
               if args.sweep else [None])
        for k2 in k2s:
            label = f"surrogate k2={k2:.2e}" if k2 is not None else "surrogate shipped"
            report_ensemble(label, *ensemble_stats(list(run_surrogate(scns, device, k2))))
        return None

    scns = _scenarios()
    golden = {}
    for scn in scns:
        golden[scn[0]] = run_mujoco(scn)
        print(f"mujoco {scn[0]}: final b0 = {golden[scn[0]][-1, :3].round(4)}")
    meta = {f"{s[0]}__meta": np.asarray([*s[1], s[2], *s[3], *s[4]], float) for s in scns}
    offs = {f"{s[0]}__offsets": np.asarray(s[5], float) for s in scns}
    np.savez(out, **golden, **meta, **offs)
    print(f"wrote {out}")
    k2s = [bpe.FRICTION_K2 * m for m in (0.5, 1.0, 2.0)] if args.sweep else [None]
    for k2 in k2s:
        label = f"k2={k2:.2e}" if k2 is not None else "shipped constants"
        _k2_report(label, golden, scns, run_surrogate(scns, device, k2), not args.sweep)
    return golden


if __name__ == "__main__":
    main()
