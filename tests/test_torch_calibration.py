"""The port's calibration tools (`beso_tpu_torch/scripts/calibrate_*.py`)
against the stored MuJoCo goldens and the JAX tools.

MuJoCo runs on the host here; the goldens of tests/golden/ are what the
JAX tools wrote, and the port's MuJoCo side reproduces them bit for bit.
The surrogate side runs the port's batched `block_push_step` on the CPU
against JAX's `run_jax_batch`, both packages on the smooth stand-in hash
(`torch_parity.smooth_block_push_hashes`)."""

from __future__ import annotations

import hashlib
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("mujoco")

import beso_tpu_torch.envs.block_push.env as tenv  # noqa: E402
import beso_tpu_torch.scripts.calibrate_block_push as cbp  # noqa: E402
import beso_tpu_torch.scripts.calibrate_kitchen as ck  # noqa: E402
from tests.torch_parity import smooth_block_push_hashes  # noqa: E402

CPU = torch.device("cpu")
GOLDEN = cbp.GOLDEN_DIR
SWEPT = ("CONTACT_MU", "TIP_TORQUE_LEAK", "_GROUND_PTS", "CONTACT_DITHER", "BACKED_STIFF",
         "DITHER_ANG", "BB_DITHER_ANG")


def _golden_digest():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in GOLDEN.iterdir()}


def _constants():
    return {k: np.array(getattr(tenv, k), copy=True) for k in SWEPT}


def _fixed_step():
    """One `block_push_step` of the stable scenarios from their start
    states, pushing the blocks: the whole output state."""
    stable = [s for s in cbp._scenarios() if s[0] in cbp.STABLE_SCENARIOS]
    state = cbp._states(stable, CPU)
    for _ in range(4):
        state, _, _, _ = tenv.block_push_step(state, torch.tensor([[0.0, 0.035]] * len(stable)))
    return state


@pytest.mark.parametrize("name", [s[0] for s in cbp._scenarios()])
def test_mujoco_runner_reproduces_golden(name):
    golden = np.load(GOLDEN / "block_push_mujoco.npz")
    scn = next(s for s in cbp._scenarios() if s[0] == name)
    np.testing.assert_array_equal(cbp.run_mujoco(scn), golden[name])
    meta = golden[f"{name}__meta"]
    np.testing.assert_array_equal(meta, np.asarray([*scn[1], scn[2], *scn[3], *scn[4]], float))
    np.testing.assert_array_equal(golden[f"{name}__offsets"], np.asarray(scn[5], float))


def test_block_push_default_mode_writes_goldens(tmp_path):
    """The default mode's file, written to tmp_path, equals the stored one
    key for key."""
    out = tmp_path / "bp.npz"
    cbp.main(["--device", "cpu", "--out", str(out)])
    got, ref = np.load(out), np.load(GOLDEN / "block_push_mujoco.npz")
    assert sorted(got.files) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_kitchen_tool_reproduces_golden(tmp_path):
    out = tmp_path / "kitchen.npz"
    ck.main(["--out", str(out)])
    got, ref = np.load(out), np.load(GOLDEN / "kitchen_mujoco_v2.npz")
    # the tool also writes drive_eff_steady, which the stored file lacks
    assert set(ref.files) <= set(got.files)
    for k in ref.files:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_kitchen_full_scene_reproduces_golden(tmp_path):
    """--full-scene reads the per-element goldens from --golden and writes
    beside --out."""
    ck.main(["--out", str(tmp_path / "kitchen.npz"), "--full-scene",
             "--golden", str(GOLDEN / "kitchen_mujoco_v2.npz")])
    got, ref = np.load(tmp_path / "kitchen_full_scene.npz"), np.load(
        GOLDEN / "kitchen_full_scene.npz")
    assert sorted(got.files) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _assert_trajectories_close(got, ref):
    """test_torch_block_push.py's tolerances for its multi-step rollouts:
    positions within 1e-5 m, yaws within 5e-5 rad."""
    np.testing.assert_allclose(got[..., [0, 1, 3, 4]], ref[..., [0, 1, 3, 4]], atol=1e-5)
    np.testing.assert_allclose(got[..., 2], ref[..., 2], atol=5e-5)


def test_surrogate_runner_matches_jax_batch(monkeypatch):
    """The stable-5 scenarios, 12 control steps, as one batch of envs in the
    port against JAX's vmapped `run_jax_batch`."""
    import scripts.calibrate_block_push as jcal

    smooth_block_push_hashes(monkeypatch)
    stable = [s for s in cbp._scenarios() if s[0] in cbp.STABLE_SCENARIOS]
    got = cbp.run_surrogate(stable, CPU)
    ref = jcal.run_jax_batch(stable)
    assert got.shape == ref.shape == (5, cbp.N_CONTROL_STEPS, 5)
    _assert_trajectories_close(got, ref)
    moved = np.abs(got[:, -1, :2] - got[:, 0, :2]).max()
    assert moved > 0.02      # the blocks were pushed


def test_friction_k2_matches_jax(monkeypatch):
    """`block_push_step(friction_k2=2 * FRICTION_K2)` against JAX's over the
    stable-5 scenarios; the default and an explicit FRICTION_K2 are
    bit-equal."""
    import jax
    import jax.numpy as jnp

    import beso_tpu.envs.block_push.env as jenv
    import scripts.calibrate_block_push as jcal

    smooth_block_push_hashes(monkeypatch)
    stable = [s for s in cbp._scenarios() if s[0] in cbp.STABLE_SCENARIOS]
    k2 = 2 * tenv.FRICTION_K2
    got = cbp.run_surrogate(stable, CPU, friction_k2=k2)
    states = jax.tree.map(lambda *xs: jnp.stack(xs),
                          *[jcal._mk_state(s[1], s[2], s[3], s[4]) for s in stable])
    offs = jnp.asarray([s[5] for s in stable], jnp.float32)

    def one(state, offsets):
        def body(s, a):
            s, obs, _, _ = jenv.block_push_step(s, a, friction_k2=k2)
            return s, obs[:5]
        return jax.lax.scan(body, state, offsets)[1]

    ref = np.asarray(jax.jit(jax.vmap(one))(states, offs))
    _assert_trajectories_close(got, ref)
    shipped = cbp.run_surrogate(stable, CPU)
    assert np.abs(got - shipped).max() > 1e-4      # k2 reaches the physics
    np.testing.assert_array_equal(cbp.run_surrogate(stable, CPU, tenv.FRICTION_K2), shipped)


def test_rot_sweep_restores_constants():
    before, step0 = _constants(), _fixed_step()
    rows = cbp.run_rot_sweep(GOLDEN, [(0.05, 1.0, 0.0), (0.2, 1.5, 0.1)], CPU)
    after = _constants()
    for k in SWEPT:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    for a, b in zip(_fixed_step(), step0):
        assert torch.equal(a, b)
    assert [(r["contact_mu"], r["arm"], r["tip_torque_leak"]) for r in rows] == [
        (0.05, 1.0, 0.0), (0.2, 1.5, 0.1)]
    # the combinations score differently, and the shipped one within the
    # sweep's own targets
    assert rows[0]["stable_yaw_deg"] != rows[1]["stable_yaw_deg"]
    assert rows[0]["stable_pos_mm"] <= 6.0 and rows[0]["stable_yaw_deg"] <= 10.0


def test_dither_sweep_varies_contact_dither_and_restores(monkeypatch):
    seen = []
    step = tenv.block_push_step

    def recording(*args, **kwargs):
        seen.append((tenv.CONTACT_DITHER, tenv.BACKED_STIFF, tenv.DITHER_ANG,
                     tenv.BB_DITHER_ANG))
        return step(*args, **kwargs)

    before, step0 = _constants(), _fixed_step()
    monkeypatch.setattr(tenv, "block_push_step", recording)
    combos = [(0.0, 4.0, 0.05, 0.0), (1e-3, 8.0, 0.1, 0.1)]
    rows = cbp.run_dither_sweep(GOLDEN, combos, n=2, device=CPU)
    assert sorted(set(seen)) == combos
    assert [r["contact_dither"] for r in rows] == [0.0, 1e-3]
    assert set(rows[0]["bands"]) == {"central", "block_into_block"}
    monkeypatch.undo()
    after = _constants()
    for k in SWEPT:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    for a, b in zip(_fixed_step(), step0):
        assert torch.equal(a, b)


def test_patched_constants_restore_after_an_error():
    mu = tenv.CONTACT_MU
    with pytest.raises(RuntimeError):
        with cbp.patched_constants(CONTACT_MU=0.5):
            assert tenv.CONTACT_MU == 0.5
            raise RuntimeError("inside the sweep")
    assert tenv.CONTACT_MU == mu


@pytest.mark.parametrize("tool, argv", [
    (cbp, ["--device", "cpu"]),
    (cbp, ["--device", "cpu", "--ensemble", "2"]),
    (ck, []),
    (ck, ["--full-scene"]),
])
def test_no_mode_writes_under_golden(tool, argv):
    digest = _golden_digest()
    with pytest.raises(ValueError, match="refusing"):
        tool.main(argv + ["--out", str(GOLDEN / "out.npz")])
    assert _golden_digest() == digest
    assert GOLDEN.resolve() not in tool.DEFAULT_OUT.resolve().parents


def test_reading_modes_write_nothing(tmp_path, monkeypatch, capsys):
    """--burst, --surrogate-dispersion and --rot-sweep print and write no
    file, in the working directory or under tests/golden/."""
    monkeypatch.chdir(tmp_path)
    digest = _golden_digest()
    cbp.main(["--burst"])
    cbp.run_dispersion(n=2, surrogate_side=True, device=CPU)
    out = capsys.readouterr().out
    assert "CHAOTIC central" in out and " sur " in out and " mj " in out
    assert list(tmp_path.iterdir()) == []
    assert _golden_digest() == digest


def test_modes_without_mujoco_say_so(monkeypatch):
    monkeypatch.setitem(sys.modules, "mujoco", None)
    with pytest.raises(ImportError, match="MuJoCo"):
        cbp.run_mujoco(cbp._scenarios()[0])
    with pytest.raises(ImportError, match="MuJoCo"):
        ck.arc_drag(0)
    # the rot sweep runs MuJoCo nowhere
    rows = cbp.run_rot_sweep(GOLDEN, [(0.05, 1.0, 0.0)], CPU)
    assert np.isfinite(rows[0]["stable_pos_mm"])
