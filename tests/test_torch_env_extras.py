"""The single-block envs, the env registry, env-state I/O and the host
renderers of `beso_tpu_torch` against `beso_tpu` (the counterpart of
`tests/test_env_extras.py`).

Steps run from the same states in both packages (JAX's resets converted,
then placed for contact: pushes in free space, and blocks at the INSERT
slot's rim at several bearings): every state field within 1e-5 after 4
steps, rewards within 1e-5, done exactly. Resets by their constraints and
a KS test against JAX's. States saved by either package load in the other.
The renderers draw the same pixels as JAX's on the same states.
"""

import math
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import beso_tpu.envs.block_push.env as jenv
import beso_tpu.envs.block_push.single as jsingle
import beso_tpu.envs.kitchen.env as jkitchen
import beso_tpu_torch.envs.block_push.env as tenv
import beso_tpu_torch.envs.block_push.single as tsingle
import beso_tpu_torch.envs.kitchen.env as tkitchen
from beso_tpu.envs import registry as jregistry
from beso_tpu.envs.state_io import load_env_state as j_load
from beso_tpu.envs.state_io import save_env_state as j_save
from beso_tpu_torch.envs import registry
from beso_tpu_torch.envs.state_io import load_env_state, save_env_state

B, STEPS = 8, 4
TOL = dict(atol=1e-5, rtol=1e-5)


def to_port(cls, jstate):
    return cls(*(torch.as_tensor(np.array(v)) for v in jstate))


def _contact_states(task):
    """8 JAX resets placed for contact: envs 0-3 with the effector just
    behind the block, pushing toward the target; envs 4-7 with the block
    4.5 cm from the target at bearings 0, 0.3, 1.2 and 2.5 rad off the slot
    opening, the effector behind it pushing inward; env 7 at its goal with
    the effector still, so it is done after one step and frozen after. Returns
    (state, actions [STEPS, B, 2])."""
    s = jax.vmap(partial(jsingle.single_block_push_reset, task=task))(
        jax.random.split(jax.random.PRNGKey(3), B))
    s = {k: np.array(v) for k, v in s._asdict().items()}
    block, target = s["block_pos"], s["target_pos"]
    for i, off in zip(range(4, 8), (0.0, 0.3, 1.2, 2.5)):
        ang = s["target_yaw"][i] + off
        block[i] = target[i] + 0.045 * np.array([math.cos(ang), math.sin(ang)], np.float32)
    block[7] = target[7]
    d = target - block
    d[7] = [0.0, 1.0]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    eff = (block - 0.035 * d).astype(np.float32)
    # env 7 at its goal, the effector clear of the block (REACH: on its point)
    eff[7] = s["reach_target"][7] if task == "REACH" else target[7] + [0.0, -0.2]
    s["effector"], s["effector_target"] = eff, eff.copy()
    actions = np.broadcast_to(0.02 * d, (STEPS, B, 2)).astype(np.float32).copy()
    actions[:, 7] = 0.0
    return jsingle.SingleBlockPushState(**{k: jnp.asarray(v) for k, v in s.items()}), actions


@pytest.mark.parametrize("task", ["PUSH", "REACH", "INSERT"])
def test_single_block_steps_match_jax(task):
    js, actions = _contact_states(task)
    ts = to_port(tsingle.SingleBlockPushState, js)
    jstep = jax.jit(jax.vmap(partial(jsingle.single_block_push_step, task=task)))
    moved = False
    for a in actions:
        js, jobs, jr, jd = jstep(js, jnp.asarray(a))
        ts, tobs, tr, td = tsingle.single_block_push_step(ts, torch.as_tensor(a), task=task)
        for name, got, want in zip(ts._fields, ts, js):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=name)
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **TOL)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        moved |= bool((np.abs(np.asarray(js.block_pos) - np.asarray(
            _contact_states(task)[0].block_pos)) > 1e-3).any())
    assert moved, "no block was pushed"
    assert bool(td[7]) and float(tr[7]) == 0.0   # done after step 1, frozen since


def test_slot_gate_holds_misaligned_blocks():
    """INSERT keeps a misaligned block at the slot's rim and lets an aligned
    one in; PUSH lets the misaligned one in too."""
    js, actions = _contact_states("INSERT")
    out = {}
    for task in ("INSERT", "PUSH"):
        ts = to_port(tsingle.SingleBlockPushState, js)
        for a in actions:
            ts, *_ = tsingle.single_block_push_step(ts, torch.as_tensor(a), task=task)
        out[task] = torch.linalg.vector_norm(ts.block_pos - ts.target_pos, dim=-1)
    # bearings 0 and 0.3 rad lie within the opening's pi/5; 1.2 rad does not
    assert (out["INSERT"][4:6] < tsingle.SLOT_RADIUS - 1e-3).all()
    assert out["INSERT"][6] >= tsingle.SLOT_RADIUS - 1e-5
    assert out["PUSH"][6] < tsingle.SLOT_RADIUS - 1e-3


def test_single_block_reset_constraints_and_distribution():
    s = tsingle.single_block_push_reset(512, torch.Generator().manual_seed(0), task="REACH")
    bx, by = s.block_pos[:, 0], s.block_pos[:, 1]
    assert ((bx >= 0.3) & (bx <= 0.5) & (by >= -0.35) & (by <= -0.05)).all()
    # x and y of the block come from one draw, as in the JAX env
    torch.testing.assert_close(by, -0.35 + 1.5 * (bx - 0.3), atol=1e-6, rtol=0)
    assert ((s.target_pos[:, 1] >= 0.05) & (s.target_pos[:, 1] <= 0.35)).all()
    assert ((s.block_yaw >= 0) & (s.block_yaw <= math.pi)).all()
    assert (torch.abs(s.target_yaw - math.pi) <= math.pi / 6 + 1e-6).all()
    torch.testing.assert_close(torch.linalg.vector_norm(s.reach_target - s.block_pos, dim=-1),
                               torch.full((512,), 0.05), atol=1e-6, rtol=0)
    torch.testing.assert_close(s.init_goal_distance, torch.linalg.vector_norm(
        s.reach_target - s.effector, dim=-1))
    j = jax.vmap(partial(jsingle.single_block_push_reset, task="REACH"))(
        jax.random.split(jax.random.PRNGKey(1), 512))
    for got, want in ((bx, j.block_pos[:, 0]), (s.target_yaw, j.target_yaw),
                      (s.block_yaw, j.block_yaw)):
        assert stats.ks_2samp(got.numpy(), np.asarray(want)).pvalue > 1e-3


def test_reward_is_best_fraction_and_success_latches():
    s = tsingle.single_block_push_reset(2, torch.Generator().manual_seed(1))
    s1, _, r1, d1 = tsingle.single_block_push_step(s, torch.zeros(2, 2))
    assert ((r1 >= 0) & (r1 < 1)).all() and not d1.any()
    s2 = s1._replace(block_pos=s1.target_pos.clone())
    _, _, r2, d2 = tsingle.single_block_push_step(s2, torch.zeros(2, 2))
    assert (r2 == 1.0).all() and d2.all()


def test_normalized_wrapper_matches_jax():
    js, _ = _contact_states("PUSH")
    ts = to_port(tsingle.SingleBlockPushState, js)
    np.testing.assert_allclose(tsingle.normalized_obs(ts).numpy(),
                               np.asarray(jax.vmap(jsingle.normalized_obs)(js)), **TOL)
    a = np.random.RandomState(0).uniform(-1.5, 1.5, (B, 2)).astype(np.float32)
    np.testing.assert_allclose(tsingle.denormalize_action(torch.as_tensor(a)).numpy(),
                               np.asarray(jsingle.denormalize_action(jnp.asarray(a))), **TOL)
    np.testing.assert_allclose(tsingle.denormalize_action(torch.ones(2)).numpy(),
                               tsingle.ACTION_MAX, rtol=1e-6)


def _jax_batch(spec, key, n):
    return jax.vmap(spec.reset_fn)(jax.random.split(key, n))


_JITTED = {}


def _jit_step(fn):
    """jit(vmap(fn)), compiled once per step function and its keywords (the
    ids share the multimodal, kitchen and single-block steps)."""
    key = (getattr(fn, "func", fn), tuple(sorted(getattr(fn, "keywords", {}).items())))
    if key not in _JITTED:
        _JITTED[key] = jax.jit(jax.vmap(fn))
    return _JITTED[key]


@pytest.mark.parametrize("env_id", jregistry.registered_ids())
def test_registry_id_matches_jax(env_id):
    """Each of the 17 ids: the same limits and renderer presence, a port
    reset of the right shape, and 3 steps from JAX's resets that match
    JAX's step (obs, reward, done; block ids without contact, whose dither
    hash would decorrelate at an ulp: ROADMAP C2)."""
    assert registry.registered_ids() == jregistry.registered_ids()
    spec, jspec = registry.make(env_id), jregistry.make(env_id)
    assert spec.max_episode_steps == jspec.max_episode_steps
    assert (spec.render_fn is None) == (jspec.render_fn is None)
    kitchen = env_id.startswith("kitchen")
    A = 9 if kitchen else 2
    ts = spec.reset_fn(3, torch.Generator().manual_seed(0))
    assert spec.obs_fn(ts).shape[0] == 3
    js = _jax_batch(jspec, jax.random.PRNGKey(2), 4)
    cls = type(ts)
    ts = to_port(cls, js)
    if kitchen:
        np.testing.assert_array_equal(spec.reset_fn(4).tasks_to_complete.numpy(),
                                      np.asarray(js.tasks_to_complete))
    rng = np.random.RandomState(4)
    jstep = _jit_step(jspec.step_fn)
    for _ in range(3):
        a = (rng.uniform(-1, 1, (4, A)) * (1.0 if kitchen or "Normalized" in env_id
                                           else 0.005)).astype(np.float32)
        if not kitchen and "Normalized" not in env_id:
            a[:, 1] = -abs(a[:, 1])   # away from the blocks
        js, jo, jr, jd = jstep(js, jnp.asarray(a))
        ts, to, tr, td = spec.step_fn(ts, torch.as_tensor(a))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_unknown_id_raises():
    with pytest.raises(ValueError, match="unknown env id"):
        registry.make("BlockPull-v0")


@pytest.mark.parametrize("kind", ["multimodal", "single", "kitchen"])
def test_state_io_across_packages(kind, tmp_path):
    """A batched state saved by JAX loads in the port, and back."""
    if kind == "multimodal":
        js = jax.vmap(jenv.block_push_reset)(jax.random.split(jax.random.PRNGKey(0), 4))
        js, *_ = _jit_step(jenv.block_push_step)(js, jnp.ones((4, 2)) * 0.01)
        template, jcls = tenv.block_push_reset(4), jenv.BlockPushState
    elif kind == "single":
        js = jax.vmap(jsingle.single_block_push_reset)(jax.random.split(jax.random.PRNGKey(0), 4))
        template, jcls = tsingle.single_block_push_reset(4), jsingle.SingleBlockPushState
    else:
        js = jax.vmap(jkitchen.kitchen_reset)(jax.random.split(jax.random.PRNGKey(0), 4))
        js, *_ = _jit_step(jkitchen.kitchen_step)(js, jnp.full((4, 9), 0.3))
        template, jcls = tkitchen.kitchen_reset(4), jkitchen.KitchenState
    j_save(js, tmp_path / "jax.npz")
    ts = load_env_state(template, tmp_path / "jax.npz")
    assert type(ts) is type(template)
    for got, want in zip(ts, js):
        assert got.dtype == torch.as_tensor(np.array(want)).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    save_env_state(ts, tmp_path / "port.npz")
    back = j_load(js, tmp_path / "port.npz")
    for got, want in zip(back, js):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    again = load_env_state(template, tmp_path / "port.npz")
    assert all(a.equal(b) for a, b in zip(again, ts))


def test_state_io_refuses_another_format(tmp_path):
    np.savez(tmp_path / "x.npz", _version=np.asarray("other"), leaf_0=np.zeros(1))
    with pytest.raises(ValueError, match="unknown state format"):
        load_env_state(tenv.block_push_reset(1), tmp_path / "x.npz")


def _index(tree, i):
    return jax.tree.map(lambda x: x[i], tree)


def test_renderers_draw_the_jax_pixels():
    from beso_tpu.envs.block_push import render as jrender
    from beso_tpu.envs.kitchen import render as jkrender
    from beso_tpu_torch.envs.block_push import render as trender
    from beso_tpu_torch.envs.kitchen import render as tkrender

    js = jax.vmap(jenv.block_push_reset)(jax.random.split(jax.random.PRNGKey(0), 2))
    ts = to_port(tenv.BlockPushState, js)
    frame = trender.render_frame(ts, 1)
    assert frame.dtype == np.uint8 and frame.shape == (256, 256, 3) and frame.std() > 1.0
    np.testing.assert_array_equal(frame, jrender.render_frame(_index(js, 1)))
    for task in ("PUSH", "REACH", "INSERT"):
        jss = jax.vmap(partial(jsingle.single_block_push_reset, task=task))(
            jax.random.split(jax.random.PRNGKey(1), 2))
        tss = to_port(tsingle.SingleBlockPushState, jss)
        np.testing.assert_array_equal(trender.render_single_frame(tss, 0, task=task),
                                      jrender.render_single_frame(_index(jss, 0), task=task))
    jk = jax.vmap(jkitchen.kitchen_reset)(jax.random.split(jax.random.PRNGKey(0), 2))
    jk, *_ = _jit_step(jkitchen.kitchen_step)(jk, jnp.full((2, 9), 0.5))
    np.testing.assert_array_equal(tkrender.render_frame(to_port(tkitchen.KitchenState, jk), 1),
                                  jkrender.render_frame(_index(jk, 1)))


def test_renderers_without_matplotlib_or_imageio_raise(monkeypatch, tmp_path):
    from beso_tpu_torch.envs.block_push import render as trender

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    with pytest.raises(ImportError, match="pip install matplotlib"):
        trender.render_frame(tenv.block_push_reset(1))
    with pytest.raises(ImportError, match="pip install imageio"):
        trender.save_video([np.zeros((4, 4, 3), np.uint8)], tmp_path / "v.gif")
