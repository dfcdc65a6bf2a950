"""The kitchen MuJoCo golden bands of `tests/test_kitchen_fidelity.py`, held
on the port's env (`beso_tpu_torch.envs.kitchen`): its shipped constants
(`default_kitchen_params`, the geometry, BONUS_THRESH) against
`tests/golden/kitchen_mujoco_v2.npz` and `kitchen_full_scene.npz`, and
the scripted `kitchen_step` episodes of `kitchen_scenarios.py` (the
microwave drags, kettle grasps, tracking and release) held to the same
bands. The bands that read the golden files alone stay in that file."""

from pathlib import Path

import numpy as np
import pytest
import kitchen_scenarios
import torch

from beso_tpu_torch.envs.kitchen import env as tenv
from beso_tpu_torch.envs.kitchen import geometry as G

GOLDEN = Path(__file__).parent / "golden" / "kitchen_mujoco_v2.npz"
FULL = Path(__file__).parent / "golden" / "kitchen_full_scene.npz"
GOALS = {"bottom_burner": -0.88, "top_burner": -0.92, "light_switch": -0.69,
         "slide_cabinet": 0.37, "hinge_cabinet": 1.45, "microwave": -0.75}


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def params():
    return tenv.default_kitchen_params(torch.device("cpu"))


def test_drive_eff_matches_steady_slopes(golden, params):
    eff = params.drive_eff.numpy()
    for e, (name, goal) in enumerate(GOALS.items()):
        q = golden[f"arc_{name}"]
        measured = np.abs(np.diff(q))[2:].mean() / (abs(goal) / len(q))
        assert abs(eff[e] - measured) < 0.02, f"{name}: {eff[e]:.3f} vs {measured:.3f}"
    assert float(eff[6]) == 0.0          # the kettle is grasp-tracked, not driven


def test_interact_radius_from_probe(golden, params):
    offsets = golden["probe_offsets"]
    onset = max(float(offsets[golden[k] > 0.25].max()) for k in (
        "probe_bottom_burner", "probe_hinge_cabinet", "probe_slide_cabinet"))
    measured = G.FINGER_RADIUS + G.BAR_RADIUS + 0.002 + onset
    assert abs(float(params.interact_radius) - measured) < 0.01


def test_grasp_release_and_kettle_bands(golden, params):
    offs, ok = golden["kettle_grasp_offsets"], golden["kettle_grasp_ok"]
    assert offs[ok].max() <= float(params.grasp_radius) <= offs[~ok].min()
    speeds, tracks = golden["kettle_speeds"], golden["kettle_tracks"]
    assert float(params.kettle_gain) == pytest.approx(1.0)
    held = speeds[tracks > 0.9]
    assert held.size and float(params.kettle_max_speed) <= held.max() + 1e-6
    assert 0.9 < tracks[0] < 1.2
    gap = float(golden["kettle_yank_gap"])
    assert bool(golden["kettle_yank_held"])
    assert gap < float(params.release_radius) <= gap + 0.02


def test_crosstalk_below_completion_threshold():
    full = np.load(FULL)
    keys = [k for k in full.files if k.endswith("__crosstalk")]
    assert keys
    for k in keys:
        assert float(full[k][0]) < tenv.BONUS_THRESH, k


@pytest.fixture(scope="module")
def scripted():
    """The scripted scenario batch of `kitchen_scenarios`, run by
    `kitchen_step` on the CPU, and its bands."""
    traj = kitchen_scenarios.replay(*kitchen_scenarios.script_kitchen_scenarios(), "cpu")
    return traj, kitchen_scenarios.kitchen_bands(traj)


def test_surrogate_straight_pull_disengages(scripted):
    """Through `kitchen_step`: an arc-following drag opens the microwave; a
    straight pull along the handle's initial tangent swings off the handle
    and stops short."""
    traj, _ = scripted
    j = int(tenv.PRIMARY[5])
    q_arc, q_straight = float(traj.qpos[-1, 0, j]), float(traj.qpos[-1, 1, j])
    assert q_arc < -0.6, q_arc
    assert abs(q_straight) < 0.5 * abs(q_arc), (q_straight, q_arc)


@pytest.mark.parametrize("band", kitchen_scenarios.BAND_NAMES)
def test_scripted_kitchen_band(scripted, band):
    """Each band of the scripted batch (drags, grasps, the held kettle's
    tracking, release) on `kitchen_step`'s outcome."""
    held, value = scripted[1][band]
    assert held, (band, value)


def test_handle_tangents_match_jax():
    import jax.numpy as jnp

    from beso_tpu.envs.kitchen import env as jenv

    qpos = tenv.INIT_QPOS + 0.1 * np.random.RandomState(0).randn(3, 30).astype(np.float32)
    got = tenv.handle_tangents(torch.as_tensor(qpos),
                               tenv.default_kitchen_params(torch.device("cpu")))
    for b in range(3):
        np.testing.assert_allclose(got[b].numpy(),
                                   np.asarray(jenv.handle_tangents(jnp.asarray(qpos[b]))),
                                   atol=1e-6)
