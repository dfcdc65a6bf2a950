"""Block-push physics and goals: `beso_tpu_torch` against `beso_tpu`.

The contact dithers are a sin-hash of the state whose arguments reach the
thousands: an ulp of difference in the 4 x 5 product moves the hash by up
to ~0.1, and XLA sums that product in an order that depends on the
surrounding computation. So the hash is held alone (exactly where its
product is one multiply, statistically elsewhere), and the step is held
from identical states with both packages' hash replaced, in the test only,
by the same smooth stand-in (`sin(_HASH_W @ u)`); the shipped hash's
behaviour is held by the MuJoCo golden bands at the thresholds of
`tests/test_block_push_fidelity.py`. RNG streams differ, so resets are held
by their constraints and their distribution.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from torch_parity import smooth_block_push_hashes as _smooth_hashes
from torch_parity import t

import beso_tpu.envs.block_push.env as jenv
import beso_tpu_torch.envs.block_push.env as tenv
from beso_tpu.data.trajectories import synthetic_push_data as j_synthetic_push_data
from beso_tpu.envs.block_push import goals as jgoals
from beso_tpu_torch.data.trajectories import synthetic_push_data
from beso_tpu_torch.envs.block_push import goals as tgoals

GOLDEN = Path(__file__).parent / "golden" / "block_push_mujoco.npz"
STABLE = ["offcenter_0.25", "offcenter_0.5", "offcenter_0.75", "rotated", "diagonal"]


def _to_torch(js) -> tenv.BlockPushState:
    return tenv.BlockPushState(*(torch.as_tensor(np.array(v)) for v in js))


def _jax_reset(B, seed=0):
    return jax.vmap(jenv.block_push_reset)(jax.random.split(jax.random.PRNGKey(seed), B))


# ---- reset and observation ---------------------------------------------------

@pytest.mark.parametrize("horizontal", [False, True])
def test_reset_constraints_and_distribution(horizontal):
    """Constraints as tests/test_envs.py:126-139 holds them for JAX; every
    coordinate's distribution against JAX's (two-sample KS, p > 1e-3; 512
    envs each)."""
    B = 512
    ts = tenv.block_push_reset(B, torch.Generator().manual_seed(0), horizontal=horizontal)
    js = jax.vmap(lambda k: jenv.block_push_reset(k, horizontal=horizontal))(
        jax.random.split(jax.random.PRNGKey(0), B))
    bx, ty = ts.block_pos[..., 0].numpy(), ts.target_pos[..., 1].numpy()
    tx = ts.target_pos[..., 0].numpy()
    if horizontal:
        assert (np.abs(bx - 0.35) <= 0.05 + 1e-6).all()
        by = ts.block_pos[..., 1].numpy()
        assert (np.abs(np.abs(by) - 0.2) <= 0.075 + 1e-6).all()
        assert (np.abs(tx - 0.5) <= 0.005 + 1e-6).all()
        assert (np.abs(ty[:, 0] - ty[:, 1]) > 0.3).all()
    else:
        assert (np.abs(bx[:, 0] - bx[:, 1]) > tenv.MIN_BLOCK_DIST).all()
        assert (np.abs(bx - 0.4) <= 0.1 + 1e-6).all()
        assert (np.abs(ty - 0.2) < 0.01).all()
        assert (np.abs(tx[:, 0] - tx[:, 1]) > 0.2).all()
        assert (tx[:, 0] > tx[:, 1]).any() and (tx[:, 0] < tx[:, 1]).any()
    assert ((ts.block_yaw >= 0) & (ts.block_yaw <= np.pi)).all()
    assert (torch.abs(ts.target_yaw - np.pi) <= np.pi / 30 + 1e-6).all()
    np.testing.assert_array_equal(ts.effector.numpy(), np.tile([0.3, -0.4], (B, 1)).astype(
        np.float32))
    for name in ("block_pos", "block_yaw", "target_pos", "target_yaw"):
        a = getattr(ts, name).numpy().reshape(B, -1)
        b = np.asarray(getattr(js, name)).reshape(B, -1)
        for k in range(a.shape[1]):
            assert stats.ks_2samp(a[:, k], b[:, k]).pvalue > 1e-3, (name, k)
    for name in ("in_target", "completed", "done", "steps", "block_vel", "block_yawrate"):
        a, b = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        assert a.dtype == b.dtype and a.shape == b.shape and not a.any(), name


def test_obs_layout_matches_jax():
    js = _jax_reset(8, seed=1)
    obs = tenv.block_push_obs(_to_torch(js)).numpy()
    np.testing.assert_array_equal(obs, np.asarray(jax.vmap(jenv.block_push_obs)(js)))
    np.testing.assert_array_equal(obs[:, 6:8], np.asarray(js.effector))
    np.testing.assert_array_equal(obs[:, 13:15], np.asarray(js.target_pos[:, 1]))


def test_first_index_picks_follow_jnp():
    """argmin/argmax as first index on ties, and the all-False pick 0."""
    v = np.asarray([[1.0, 0.0, 0.0, 2.0], [3.0, 3.0, 1.0, 1.0], [0.0, 0.0, 0.0, 0.0]],
                   np.float32)
    np.testing.assert_array_equal(tenv._first_argmin(t(v)).numpy(), np.argmin(v, -1))
    np.testing.assert_array_equal(tenv._first_argmax(t(v)).numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(v), -1)))
    m = v > 0.5
    np.testing.assert_array_equal(tenv._first_true(t(m)).numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(m), -1)))


# ---- the dither hash ---------------------------------------------------------

def test_hash_noise_against_jax():
    """Where the hash's product is a single multiply (one nonzero input)
    both packages agree within 5e-4 in circular distance on [-1, 1) (measured
    2.4e-4: an ulp of sin times the x500 scale). On general states the
    products round differently and 62% of the values agree within 1e-3
    (measured; bound 50%); the rest are decorrelated draws of the same
    zero-mean law (std within 0.02 of each other)."""
    rng = np.random.RandomState(0)
    jhash = jax.jit(jax.vmap(jenv._hash_noise))
    N = 4000

    def circ(a, b):
        d = np.abs(a - b)
        return np.minimum(d, 2.0 - d)

    u = np.zeros((N, 5), np.float32)
    u[np.arange(N), rng.randint(0, 5, N)] = rng.uniform(-0.6, 0.6, N)
    got = tenv._hash_noise(t(u[:, :2]), t(u[:, 2]), t(u[:, 3:])).numpy()
    assert circ(got, np.asarray(jhash(u[:, :2], u[:, 2], u[:, 3:]))).max() < 5e-4

    bp = rng.uniform(0.2, 0.6, (N, 2)).astype(np.float32)
    by = rng.uniform(0.0, 3.2, N).astype(np.float32)
    ef = rng.uniform(-0.5, 0.6, (N, 2)).astype(np.float32)
    got = tenv._hash_noise(t(bp), t(by), t(ef)).numpy()
    ref = np.asarray(jhash(bp, by, ef))
    assert got.shape == (N, 4) and (np.abs(got) <= 1.0).all()
    assert (circ(got, ref) < 1e-3).mean() > 0.5
    assert abs(got.std() - ref.std()) < 0.02 and abs(got.mean()) < 0.03


# ---- contact geometry and laws -------------------------------------------------

def _random_pairs(N, seed):
    rng = np.random.RandomState(seed)
    bp = rng.uniform(0.3, 0.5, (N, 2)).astype(np.float32)
    by = rng.uniform(0.0, 3.2, N).astype(np.float32)
    pt = bp + rng.uniform(-0.04, 0.04, (N, 2)).astype(np.float32)
    pb = bp + rng.uniform(-0.06, 0.06, (N, 2)).astype(np.float32)
    yb = rng.uniform(0.0, 3.2, N).astype(np.float32)
    return bp, by, pt, pb, yb


def test_contact_geometry_matches_jax():
    """Disk-box geometry and the box-box manifold on 400 random
    configurations (inside, corner, face, apart), to 1e-6."""
    bp, by, pt, pb, yb = _random_pairs(400, 1)
    ref = jax.vmap(lambda a, b, c: jenv._box_point_geom(a, b, c, jenv.EFFECTOR_RADIUS))(
        bp, by, pt)
    got = tenv._box_point_geom(t(bp), t(by), t(pt), tenv.EFFECTOR_RADIUS)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)
    ref = jax.vmap(lambda a, b, c, d: jenv._box_box_manifold(a, b, c, d, 0.026))(
        bp, by, pb, yb)
    got = tenv._box_box_manifold(t(bp), t(by), t(pb), t(yb), 0.026)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)
    assert got[3].any() and not got[3].all()


def test_contact_velocities_match_jax(monkeypatch):
    """One substep's force integration (pusher, box-box, 4-point ground
    friction) from 400 random states with the smooth stand-in hash, to 2e-5
    of the velocities (up to ~30 m/s and rad/s here)."""
    _smooth_hashes(monkeypatch)
    rng = np.random.RandomState(3)
    bp, by, pt, pb, yb = _random_pairs(400, 4)
    bpos, byaw = np.stack([bp, pb], 1), np.stack([by, yb], 1)
    bvel = (rng.randn(400, 2, 2) * 0.1).astype(np.float32)
    byr = rng.randn(400, 2).astype(np.float32)
    v_push = (rng.randn(400, 2) * 0.5).astype(np.float32)
    inv_i = 1.0 / (jenv.BLOCK_MASS * jenv.FRICTION_K2)
    ref = jax.jit(jax.vmap(lambda *a: jenv._solve_contact_velocities(*a, inv_i)))(
        bpos, byaw, bvel, byr, pt, v_push)
    got = tenv._solve_contact_velocities(t(bpos), t(byaw), t(bvel), t(byr), t(pt),
                                         t(v_push))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, atol=2e-5 * np.abs(r).max())


# ---- the control step ------------------------------------------------------------

def _scenario(name, B=32, seed=0):
    """JAX reset states with the effector placed for the scenario, and the
    per-step actions [3, B, 2]."""
    rng = np.random.RandomState(seed)
    js = _jax_reset(B, seed)
    b0 = np.asarray(js.block_pos[:, 0])
    bpos = np.asarray(js.block_pos).copy()
    if name == "free":
        eff = np.tile([0.2, -0.45], (B, 1))
        acts = rng.uniform(-0.03, 0.03, (3, B, 2))
    else:
        eff = b0 - np.asarray([0.0, 0.05]) + rng.uniform(-0.02, 0.02, (B, 2))
        acts = np.asarray([0.0, 0.03]) + rng.uniform(-0.01, 0.01, (3, B, 2))
        if name == "train":  # block 1 just ahead of block 0
            bpos[:, 1] = b0 + np.asarray([0.0, 0.055]) + rng.uniform(-0.01, 0.01, (B, 2))
    eff = jnp.asarray(eff, jnp.float32)
    js = js._replace(effector=eff, effector_target=eff,
                     block_pos=jnp.asarray(bpos, jnp.float32))
    return js, acts.astype(np.float32)


@pytest.mark.parametrize("name", ["free", "push", "train"])
def test_step_matches_jax(name, monkeypatch):
    """3 control steps (72 substeps) from identical states, both packages on
    the smooth stand-in hash: positions to 1e-5 m (7e-7 measured), yaws to
    5e-5 rad (1.7e-5 measured), velocities and yaw rates to 1e-4 of the
    field's largest magnitude (2.3e-5 measured, on yaw rates up to 25
    rad/s), flags, rewards and done exactly. "free" never touches a block,
    "push" drives the pusher into block 0, "train" pushes block 0 into
    block 1."""
    _smooth_hashes(monkeypatch)
    js, acts = _scenario(name)
    ts = _to_torch(js)
    step = jax.jit(jax.vmap(jenv.block_push_step))
    b0 = ts.block_pos.clone()
    for a in acts:
        js, jobs, jrew, jdone = step(js, jnp.asarray(a))
        ts, obs, rew, done = tenv.block_push_step(ts, t(a))
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=5e-5)
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        for field, g in zip(ts._fields, ts):
            r = np.asarray(getattr(js, field))
            if field in ("block_vel", "block_yawrate"):
                np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * max(np.abs(r).max(), 1.0),
                                           err_msg=field)
            elif g.dtype == torch.float32:
                tol = 5e-5 if field in ("block_yaw", "target_yaw") else 1e-5
                np.testing.assert_allclose(g.numpy(), r, atol=tol, err_msg=field)
            else:
                np.testing.assert_array_equal(g.numpy(), r, err_msg=field)
    moved = (ts.block_pos - b0).abs().amax((1, 2))
    if name == "free":
        assert moved.max() == 0.0
    else:
        assert (moved > 1e-3).float().mean() > 0.5
    if name == "train":
        assert ((ts.block_pos[:, 1] - b0[:, 1]).abs().amax(1) > 1e-3).any()


def test_done_envs_stay_frozen():
    js, acts = _scenario("push", B=8, seed=2)
    ts = _to_torch(js)
    done = torch.tensor([True, False] * 4)
    ts = ts._replace(done=done)
    new, obs, rew, d = tenv.block_push_step(ts, t(acts[0]))
    for field, old, g in zip(ts._fields, ts, new):
        assert torch.equal(g[done], old[done]), field
    assert (rew[done] == 0).all() and d[done].all()
    assert not torch.equal(new.effector[~done], ts.effector[~done])
    np.testing.assert_array_equal(obs.numpy(), tenv.block_push_obs(new).numpy())


def _teleport(state, block, target_of):
    pos = state.block_pos.clone()
    pos[:, block] = target_of(state)
    return state._replace(block_pos=pos)


def test_reward_and_completion_match_jax():
    """The scripted sequence of tests/test_envs.py:171-199 on 4 envs, each
    state handed to both packages: block 0 into target 0 (0.49, task 0),
    then block 1 into target 1 (0.51, done, task 3); and both blocks into
    target 0 (0.98, not done)."""
    step = jax.jit(jax.vmap(jenv.block_push_step))
    park = jnp.tile(jnp.asarray([0.6, -0.45]), (4, 1))
    js = _jax_reset(4, seed=4)._replace(effector=park, effector_target=park)
    zero = np.zeros((4, 2), np.float32)

    def both(ts):
        jn, _, jr, jd = step(jenv.BlockPushState(*(jnp.asarray(v.numpy()) for v in ts)),
                             jnp.asarray(zero))
        tn, _, tr, td = tenv.block_push_step(ts, t(zero))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tn.completed.numpy(), np.asarray(jn.completed))
        np.testing.assert_array_equal(tn.in_target.numpy(), np.asarray(jn.in_target))
        return tn, tr, td

    ts = _teleport(_to_torch(js), 0, lambda s: s.target_pos[:, 0])
    ts2, r, d = both(ts)
    assert torch.allclose(r, torch.tensor(0.49)) and not d.any() and ts2.completed[:, 0].all()
    ts3 = _teleport(ts2, 1, lambda s: s.target_pos[:, 1])
    ts4, r, d = both(ts3)
    assert torch.allclose(r, torch.tensor(0.51)) and d.all() and ts4.completed[:, 3].all()
    same = _teleport(_teleport(_to_torch(js), 0, lambda s: s.target_pos[:, 0]), 1,
                     lambda s: s.target_pos[:, 0] + 0.01)
    _, r, d = both(same)
    assert torch.allclose(r, torch.tensor(0.98)) and not d.any()


# ---- fidelity against the MuJoCo golden rollouts -----------------------------

def _run_torch(b0, yaw0, b1, eff0, offsets):
    """Scripted effector offsets [T, 2] (or [T, B, 2]) from one start per env
    (each argument [2] / scalar, or batched); returns obs[..., :5] per step."""
    offsets = np.asarray(offsets, np.float32)
    if offsets.ndim == 2:
        offsets = offsets[:, None]
    B = offsets.shape[1]

    def bt(v, shape):
        return torch.as_tensor(np.broadcast_to(np.asarray(v, np.float32), shape).copy())

    b0, b1 = bt(b0, (B, 2)), bt(b1, (B, 2))
    eff = bt(eff0, (B, 2))
    state = tenv.BlockPushState(
        effector=eff, effector_target=eff.clone(), block_pos=torch.stack([b0, b1], 1),
        block_yaw=torch.stack([bt(yaw0, (B,)), torch.zeros(B)], 1),
        target_pos=bt([[0.28, 0.2], [0.52, 0.2]], (B, 2, 2)),
        target_yaw=torch.full((B, 2), np.pi),
        in_target=torch.zeros(B, 2, 2, dtype=torch.bool),
        completed=torch.zeros(B, 4, dtype=torch.bool),
        done=torch.zeros(B, dtype=torch.bool), steps=torch.zeros(B, dtype=torch.int32),
        block_vel=torch.zeros(B, 2, 2), block_yawrate=torch.zeros(B, 2))
    traj = []
    for a in offsets:
        state, obs, _, _ = tenv.block_push_step(state, t(a))
        traj.append(obs[:, :5].numpy())
    return np.stack(traj, 1)       # [B, T, 5]


def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _golden_scenario(golden, name):
    meta = golden[f"{name}__meta"]
    return golden[name], (meta[:2], float(meta[2]), meta[3:5], meta[5:7],
                          golden[f"{name}__offsets"])


def test_geometry_constants_match_jax():
    for name in ("BLOCK_HALF", "EFFECTOR_RADIUS", "N_SUBSTEPS", "BLOCK_MASS", "FRICTION_K2",
                 "F_G_MAX", "CONTACT_K", "CONTACT_B", "CONTACT_MU", "FN_CAP", "TIP_LEAK",
                 "BACKED_STIFF", "BACKED_COS", "BACKED_MARGIN", "PLOW_RANGE",
                 "CONTACT_DITHER", "DITHER_ANG", "BB_DITHER_ANG", "V_EPS", "SUB_DT",
                 "BLOCK_BLOCK_RADIUS", "TIP_TORQUE_LEAK", "DAMP_RATIO"):
        assert getattr(tenv, name) == getattr(jenv, name), name
    assert tenv.INV_I == 1.0 / (jenv.BLOCK_MASS * jenv.FRICTION_K2)
    assert jenv.BB_BOX_BOX and not jenv.CORNER_RADIAL
    np.testing.assert_array_equal(tenv._GROUND_PTS.astype(np.float32), np.asarray(jenv._GROUND_PTS))
    np.testing.assert_array_equal(tenv._HASH_F, np.asarray(jenv._HASH_F))


@pytest.mark.parametrize("name", ["central", "offcenter_0.5", "rotated"])
def test_early_contact_phase_matches_mujoco(golden, name):
    """First engaged control step within 12 mm / 0.20 rad of MuJoCo."""
    mj, scn = _golden_scenario(golden, name)
    tr = _run_torch(*scn)[0]
    pos_err = np.abs(mj[2, :2] - tr[2, :2]).max()
    assert pos_err < 0.012, f"{name}: {pos_err * 1000:.1f} mm"
    assert np.abs(_wrap(mj[2, 2] - tr[2, 2])) < 0.20


def test_offcenter_rotation_sign(golden):
    mj, scn = _golden_scenario(golden, "offcenter_0.5")
    tr = _run_torch(*scn)[0]
    assert tr[2, 2] > 0.01 and np.sign(tr[2, 2]) == np.sign(mj[2, 2])


def test_stable_rmse(golden):
    """Mean pointwise RMSE over the dispersion-stable scenarios: position
    under 8 mm and yaw under 16 deg."""
    tp = ty = 0.0
    for name in STABLE:
        mj, scn = _golden_scenario(golden, name)
        tr = _run_torch(*scn)[0]
        tp += np.sqrt(np.mean((mj[:, [0, 1, 3, 4]] - tr[:, [0, 1, 3, 4]]) ** 2))
        ty += np.sqrt(np.mean(_wrap(mj[:, 2] - tr[:, 2]) ** 2))
    assert tp / len(STABLE) < 0.008, f"pos RMSE {tp / len(STABLE) * 1000:.1f} mm"
    assert np.degrees(ty / len(STABLE)) < 16.0


def test_ensemble_statistics():
    """The 16-push ensemble of tests/test_block_push_fidelity.py (same draws,
    same bands), batched in one rollout: 12 northward pushes of 35 mm."""
    rng = np.random.default_rng(0)
    draws = [(float(rng.uniform(0, np.pi)), float(rng.uniform(-0.8, 0.8) * tenv.BLOCK_HALF))
             for _ in range(16)]
    yaw = np.asarray([d[0] for d in draws])
    eff0 = np.stack([0.4 + np.asarray([d[1] for d in draws]), np.full(16, -0.33)], -1)
    offsets = np.tile(np.asarray([0.0, 0.035], np.float32), (12, 16, 1))
    tr = _run_torch((0.4, -0.2), yaw, (0.8, 0.6), eff0, offsets)
    d_par = tr[:, -1, 1] + 0.2
    d_perp = np.abs(tr[:, -1, 0] - 0.4)
    d_yaw = np.abs(_wrap(tr[:, -1, 2] - yaw))
    assert 0.016 < d_par.mean() < 0.045, d_par.mean()
    assert 0.010 < d_perp.mean() < 0.045, d_perp.mean()
    assert 3.0 < np.degrees(d_yaw.mean()) < 21.0


def test_knocked_block_comes_to_rest():
    offsets = [(0.0, 0.035)] * 3 + [(0.0, 0.0)] * 6
    tr = _run_torch((0.4, -0.24), 0.3, (0.8, 0.6), (0.405, -0.30), offsets)[0]
    assert np.linalg.norm(tr[3, :2] - [0.4, -0.24]) > 0.005
    assert np.linalg.norm(tr[-1, :2] - tr[-3, :2]) < 5e-4
    assert abs(_wrap(tr[-1, 2] - tr[-3, 2])) < 0.01


def test_two_block_train_no_tunneling():
    tr = _run_torch((0.4, -0.2), 0.0, (0.4, -0.11), (0.4, -0.3), [(0.0, 0.035)] * 8)[0]
    assert tr[-1, 4] > -0.11 + 0.005, "second block never moved"
    assert tr[-1, 1] < tr[-1, 4], "blocks swapped / pusher tunneled through"


# ---- goals -------------------------------------------------------------------

def test_goal_frames_and_task_order_equal_jax():
    data, jdata = synthetic_push_data(24, 60, seed=3), j_synthetic_push_data(24, 60, seed=3)
    frames, expected = tgoals.block_push_goal_frames(data, 30, seed=6)
    jframes, jexpected = jgoals.block_push_goal_frames(jdata, 30, seed=6)
    np.testing.assert_array_equal(frames, jframes)
    np.testing.assert_array_equal(expected, jexpected)
    np.testing.assert_array_equal(tgoals.demo_task_order(data, 30, seed=6),
                                  jgoals.demo_task_order(jdata, 30, seed=6))
    assert tgoals._wrap_goal_idx(950) == jgoals._wrap_goal_idx(950) == 0


@pytest.mark.parametrize("reduce_obs_dim", [True, False])
def test_build_goals_flip_fix_matches_jax(reduce_obs_dim):
    """Goals from dataset frames against live resets, some flipped and some
    not; G = 2 to show the repeat."""
    data = synthetic_push_data(24, 60, seed=3)
    frames, _ = tgoals.block_push_goal_frames(data, 16, seed=6)
    js = _jax_reset(16, seed=5)
    obs0 = np.asarray(jax.vmap(jenv.block_push_obs)(js))
    # half the goal frames carry a live target layout, half the mirrored one
    frames[:, 10:12] = obs0[:, 10:12]
    frames[::2, 10:12] = obs0[::2, 13:15]
    flipped = np.linalg.norm(frames[:, 10:12] - obs0[:, 10:12], axis=-1) > 0.2
    assert flipped.any() and not flipped.all()
    got = tgoals.build_block_push_goals(t(obs0), t(frames), 2,
                                        reduce_obs_dim=reduce_obs_dim).numpy()
    ref = np.asarray(jgoals.build_block_push_goals(jnp.asarray(obs0), jnp.asarray(frames), 2,
                                                   reduce_obs_dim=reduce_obs_dim))
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (16, 2, 10 if reduce_obs_dim else 16)
    np.testing.assert_array_equal(got[flipped, 0, 0:2], frames[flipped, 3:5])


def test_onehot_goal_matches_jax():
    rng = np.random.RandomState(7)
    js = _jax_reset(64, seed=6)
    obs = np.asarray(jax.vmap(jenv.block_push_obs)(js)).copy()
    # put blocks on targets in a third of the envs, each block its own draw
    for b, cols in ((0, slice(0, 2)), (1, slice(3, 5))):
        on = rng.rand(64) < 0.35
        tgt = np.where(rng.rand(64)[:, None] < 0.5, obs[:, 10:12], obs[:, 13:15])
        obs[on, cols] = tgt[on] + rng.uniform(-0.02, 0.02, (on.sum(), 2))
    order = np.full((64, 4), -1, np.int32)
    for i in range(64):
        k = rng.randint(0, 5)
        order[i, :k] = rng.permutation(4)[:k]
    got = tgoals.block_push_onehot_goal(t(obs), t(order)).numpy()
    ref = np.asarray(jgoals.block_push_onehot_goal(jnp.asarray(obs), jnp.asarray(order)))
    np.testing.assert_array_equal(got, ref)
