"""Batched kitchen physics: `beso_tpu_torch` against `beso_tpu` (vmapped).

16 envs for 40 steps; half follow the JAX scripted oracle (so fingertips
hook handles, drive joints and complete tasks), half take random actions.
Each step both packages get the same action; qpos agrees to 1e-5, flags
and completion order exactly. The same holds for one step of the CUDA
kernel's case pool (`test_torch_kitchen_kernel._pool`: every branch of the
step, four physics settings) through the port's eager step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from beso_tpu.envs.kitchen import env as jenv
from beso_tpu.envs.kitchen.fk import panda_fk as jax_fk
from beso_tpu.envs.kitchen.oracle import kitchen_oracle_policy, oracle_reset
from beso_tpu_torch.envs.kitchen import env as tenv
from beso_tpu_torch.envs.kitchen.fk import panda_fk
from test_torch_kitchen_kernel import SETTINGS, _params, _pool

B, STEPS = 16, 40
FLAGS = ("tasks_to_complete", "completed", "completion_order",
         "kettle_grasped", "done", "steps")


def test_fk_matches():
    q = np.random.RandomState(0).uniform(-2, 2, size=(8, 7)).astype(np.float32)
    ref = jax.vmap(lambda v: jax_fk(v, (0.0, 0.3, 0.8)))(jnp.asarray(q))
    np.testing.assert_allclose(panda_fk(t(q), (0.0, 0.3, 0.8)).numpy(),
                               np.asarray(ref), atol=1e-5, rtol=1e-5)


def _assert_same(ts, js):
    np.testing.assert_allclose(ts.qpos.numpy(), np.asarray(js.qpos),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ts.ee_pos.numpy(), np.asarray(js.ee_pos),
                               atol=1e-5, rtol=1e-5)
    for name in FLAGS:
        a, b = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_kitchen_step_matches_jax():
    rng = np.random.RandomState(5)
    # oracle task sequences: every element leads in some env
    seqs = np.stack([np.roll(np.arange(7), -i)[:4] for i in range(B // 2)])
    oracle = jax.jit(jax.vmap(
        lambda s, c, q: kitchen_oracle_policy(s, c, q)))
    step = jax.jit(jax.vmap(jenv.kitchen_step))

    js = jax.vmap(jenv.kitchen_reset)(jax.random.split(jax.random.PRNGKey(0), B))
    ts = tenv.kitchen_reset(B)
    _assert_same(ts, js)
    carry = jax.vmap(lambda _: oracle_reset())(jnp.arange(B // 2))
    total_reward = np.zeros(B, np.float32)
    for _ in range(STEPS):
        head = jax.tree.map(lambda v: v[:B // 2], js)
        act_o, carry = oracle(head, carry, jnp.asarray(seqs, jnp.int32))
        act_r = rng.uniform(-1.5, 1.5, size=(B // 2, 9)).astype(np.float32)
        action = np.concatenate([np.asarray(act_o), act_r])
        js, jobs, jrew, jdone = step(js, jnp.asarray(action))
        ts, obs, rew, done = tenv.kitchen_step(ts, t(action))
        _assert_same(ts, js)
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-5)
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        total_reward += rew.numpy()
    # the scripted half really interacts with the furniture
    assert total_reward.sum() >= 1
    assert bool(ts.completed.any())


@pytest.mark.parametrize("setting", SETTINGS)
def test_kitchen_step_matches_jax_on_the_case_pool(setting):
    """One step of the kernel's 1,000-row case pool (blocked motion, hooked,
    kept and lost drives, the kettle's engage, capped tracking and both
    releases, completions with an order already set, frozen envs, task
    subsets, known starts) under the shipped, the +-20% and the capped-kettle
    physics: the eager step, which the kernel is held to on the card, and
    `beso_tpu`'s step, jitted and vmapped over the rows, agree to 1e-5 in
    the floats and exactly in the flags, completion steps and reward."""
    state, action = _pool()
    params = _params(setting, torch.device("cpu"))
    jparams = jenv.KitchenParams(**{f.name: jnp.asarray(getattr(params, f.name).numpy())
                                    for f in dataclasses.fields(params)})
    js = jenv.KitchenState(*(jnp.asarray(f.numpy()) for f in state))
    jstate, jobs, jrew, jdone = jax.jit(jax.vmap(jenv.kitchen_step, in_axes=(0, 0, None)))(
        js, jnp.asarray(action.numpy()), jparams)
    ts, obs, rew, done = tenv._kitchen_step_eager(state, action, params)
    _assert_same(ts, jstate)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))


def test_reset_from_qpos_and_task_mask():
    q = tenv.INIT_QPOS[None].repeat(3, 0) + 0.01
    ts = tenv.kitchen_reset_from_qpos(t(q), task_mask=[1, 0, 1, 0, 1, 0, 1])
    js = jax.vmap(lambda v: jenv.kitchen_reset_from_qpos(
        v, task_mask=[1, 0, 1, 0, 1, 0, 1]))(jnp.asarray(q))
    _assert_same(ts, js)
    assert ts.qpos.dtype == torch.float32
