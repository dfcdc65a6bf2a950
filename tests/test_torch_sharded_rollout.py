"""`rollout_kitchen_sharded` / `rollout_block_push_sharded` of the port on 4
spawned gloo CPU ranks (`torch_dist_workers.rollout_worker`) against
`beso_tpu.rollout.sharded` on 4 of the 8 virtual CPU devices.

JAX's shard s draws from `fold_in(key, s)` (`_fold_shard_key`); the test
replays that key's splits per shard and hands each rank its shard's action
noise (and, for block push, its resets; both packages on the smooth
stand-in hash, `torch_parity.smooth_block_push_hashes`). Each rank's actions
at every step against JAX's for the same shard at the tolerance of
`test_torch_rollout.py` (1e-4); the gathered completions, results and
completion order exactly, rewards to 1e-5. Without injection, the sharded
metrics equal single-process rollouts of each shard on its generator
(`shard_generator`) bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_workers as workers
from torch_parity import make_models, smooth_block_push_hashes, t

import beso_tpu.envs.block_push.env as jenv
from beso_tpu.agents.policy import PolicyConfig as JaxPolicyConfig
from beso_tpu.agents.policy import policy_predict, policy_reset
from beso_tpu.envs.block_push.goals import build_block_push_goals as j_build_goals
from beso_tpu.envs.kitchen.env import kitchen_reset, kitchen_step
from beso_tpu.models.cached import make_rollout_denoise_factory as jax_factory
from beso_tpu.models.scaler import fit_minmax_scaler as j_fit_minmax
from beso_tpu.models.scaler import fit_scaler as j_fit_scaler
from beso_tpu.parallel import make_mesh as j_make_mesh
from beso_tpu.rollout import rollout_block_push_sharded as j_push_sharded
from beso_tpu.rollout import rollout_kitchen_sharded as j_kitchen_sharded
from beso_tpu_torch.agents.policy import PolicyConfig
from beso_tpu_torch.data.trajectories import synthetic_kitchen_data, synthetic_push_data
from beso_tpu_torch.envs.block_push.goals import block_push_goal_frames
from beso_tpu_torch.envs.kitchen.goals import multigoal_kitchen_goals
from beso_tpu_torch.models.cached import make_rollout_denoise_factory
from beso_tpu_torch.models.scaler import fit_minmax_scaler, fit_scaler
from beso_tpu_torch.parallel.launch import spawn
from beso_tpu_torch.rollout import rollout_kitchen
from beso_tpu_torch.rollout.sharded import shard_generator, shard_seed

B, STEPS, SHARDS = 8, 4, 4
KITCHEN_CFG = dict(window_size=4, obs_dim=30, action_dim=9, num_sampling_steps=3,
                   sigma_min=0.005, sigma_max=1.0, sampler_type="ddim", cond_lambda=1.5)
PUSH_MODEL = dict(state_dim=10, action_dim=2, goal_seq_len=1, obs_seq_len=5, n_heads=2)
PUSH_CFG = dict(window_size=5, obs_dim=10, action_dim=2, num_sampling_steps=3,
                sigma_min=0.05, sigma_max=1.0, sampler_type="ddim", cond_lambda=2.0)
DRAW_SEED = 11


def _shard_keys(key):
    """Per shard: (reset key, the step keys), as JAX's shard s splits
    `fold_in(key, s)` (`beso_tpu/rollout/rollout.py:75,99`)."""
    out = []
    for s in range(SHARDS):
        k_reset, k_roll = jax.random.split(jax.random.fold_in(key, s))
        out.append((k_reset, jax.random.split(k_roll, STEPS)))
    return out


def _kitchen_jax(jden, params, jscaler, goals, expected, key):
    jcfg = JaxPolicyConfig(**KITCHEN_CFG)
    jfactory = jax_factory(jden, params, jscaler, jcfg, engine="cached")
    mesh = j_make_mesh(SHARDS, tp=1)
    with mesh:
        ref = jax.jit(lambda k: j_kitchen_sharded(None, jscaler, jcfg, jnp.asarray(goals),
                                                  jnp.asarray(expected), k, mesh,
                                                  n_steps=STEPS, denoise_factory=jfactory))(key)
    b = B // SHARDS

    @jax.jit
    def step(g, env, obs, pstate, k):
        action, pstate = policy_predict(jfactory(g), jscaler, pstate, obs, g, k, jcfg)
        env, obs, _, _ = jax.vmap(kitchen_step)(env, action)
        return action, env, obs, pstate

    actions, noise = [], []
    for s, (k_reset, step_keys) in enumerate(_shard_keys(key)):
        g = jnp.asarray(goals[s * b:(s + 1) * b])
        env = jax.vmap(kitchen_reset)(jax.random.split(k_reset, b))
        obs, pstate, acts = env.qpos, policy_reset(b, jcfg), []
        for k in step_keys:
            action, env, obs, pstate = step(g, env, obs, pstate, k)
            acts.append(np.asarray(action))
        actions.append(np.stack(acts))
        noise.append([np.asarray(jax.random.normal(k, (b, 9))) for k in step_keys])
    return ref, actions, noise


def _push_jax(jden, params, jscaler, frames, expected, key):
    jcfg = JaxPolicyConfig(**PUSH_CFG)
    jfactory = jax_factory(jden, params, jscaler, jcfg, engine="cached")
    mesh = j_make_mesh(SHARDS, tp=1)
    with mesh:
        ref = jax.jit(lambda k: j_push_sharded(None, jscaler, jcfg, jnp.asarray(frames),
                                               jnp.asarray(expected), k, mesh, n_steps=STEPS,
                                               denoise_factory=jfactory))(key)
    b = B // SHARDS

    @jax.jit
    def step(g, env, obs, pstate, k):
        action, pstate = policy_predict(jfactory(g), jscaler, pstate, obs, g, k, jcfg)
        env, obs_full, _, _ = jax.vmap(jenv.block_push_step)(env, action)
        return action, env, obs_full[:, :10], pstate

    actions, noise, resets = [], [], []
    for s, (k_reset, step_keys) in enumerate(_shard_keys(key)):
        env = jax.vmap(jenv.block_push_reset)(jax.random.split(k_reset, b))
        resets.append(tuple(np.asarray(v) for v in env))
        obs0 = jax.vmap(jenv.block_push_obs)(env)
        g = j_build_goals(obs0, jnp.asarray(frames[s * b:(s + 1) * b]), 1, reduce_obs_dim=True)
        obs, pstate, acts = obs0[:, :10], policy_reset(b, jcfg), []
        for k in step_keys:
            action, env, obs, pstate = step(g, env, obs, pstate, k)
            acts.append(np.asarray(action))
        actions.append(np.stack(acts))
        noise.append([np.asarray(jax.random.normal(k, (b, 2))) for k in step_keys])
    return ref, actions, noise, resets


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    kw, jden, params, tden = make_models(seed=31)
    data = synthetic_kitchen_data(n_traj=16, t_max=40, seed=0)
    obs_all, act_all = data.all_observations(), data.all_actions()
    scaler = fit_scaler(obs_all, act_all, False)
    goals, expected = multigoal_kitchen_goals(data, 2, B, seed=42)
    k_ref, k_actions, k_noise = _kitchen_jax(jden, params, j_fit_scaler(obs_all, act_all, False),
                                             goals, expected, jax.random.PRNGKey(3))
    kitchen = dict(env="kitchen", model_kw=kw, state=tden.inner_model.state_dict(),
                   scaler=scaler, cfg=KITCHEN_CFG, goals=goals, expected=expected,
                   n_steps=STEPS, seed=0, engine="fused_cached")

    pkw, pjden, pparams, ptden = make_models(seed=41, **PUSH_MODEL)
    pdata = synthetic_push_data(n_traj=16, t_max=40, seed=0)
    pobs = pdata.all_observations()[:, :10]
    frames, pexpected = block_push_goal_frames(pdata, B, seed=6)
    with pytest.MonkeyPatch.context() as mp:
        smooth_block_push_hashes(mp)
        p_ref, p_actions, p_noise, resets = _push_jax(
            pjden, pparams, j_fit_minmax(pobs, pdata.all_actions()), frames, pexpected,
            jax.random.PRNGKey(5))
    push = dict(env="block_push", model_kw=pkw, state=ptden.inner_model.state_dict(),
                scaler=fit_minmax_scaler(pobs, pdata.all_actions()), cfg=PUSH_CFG,
                goals=frames, expected=pexpected, n_steps=STEPS, seed=0, engine="cached",
                noise=p_noise, reset=resets)

    cases = {"kitchen_dp4": dict(kitchen, mesh=("dp", 4, 1), noise=k_noise),
             "kitchen_dcn2x2": dict(kitchen, mesh=("dcn", 2, 1), noise=k_noise),
             "kitchen_draws": dict(kitchen, mesh=("dp", 4, 1), seed=DRAW_SEED),
             "kitchen_uneven": dict(kitchen, mesh=("dp", 4, 1), goals=goals[:6],
                                    expected=expected[:6]),
             "push_dp4": dict(push, mesh=("dp", 4, 1))}
    path = tmp_path_factory.mktemp("rollout_ranks")
    torch.save(dict(cases=cases), path / "spec.pt")
    spawn(workers.rollout_worker, SHARDS, "gloo", args=(str(path),), timeout_s=240)
    out = {name: [torch.load(path / f"{name}_rank{r}.pt", weights_only=False)
                  for r in range(SHARDS)] for name in cases}
    return dict(out=out, cases=cases, kitchen_ref=(k_ref, k_actions),
                push_ref=(p_ref, p_actions), tden=tden)


def _check_against_jax(ranks, ref, jactions):
    for r in ranks:
        np.testing.assert_allclose(r["actions"], jactions[r["shard"]], atol=1e-4, rtol=1e-4)
    assert sorted(r["shard"] for r in ranks) == list(range(SHARDS))
    m = ranks[0]["metrics"]
    for field in ("completed", "results", "completion_order"):
        np.testing.assert_array_equal(m[field].numpy(), np.asarray(getattr(ref, field)), field)
    np.testing.assert_allclose(m["rewards"].numpy(), np.asarray(ref.rewards), atol=1e-5)
    assert m["env_steps"] == B * STEPS == int(ref.env_steps)
    for r in ranks[1:]:   # every rank holds the gathered metrics
        for k, v in m.items():
            assert (r["metrics"][k] == v) if k == "env_steps" else r["metrics"][k].equal(v)


def test_kitchen_sharded_matches_jax(run):
    _check_against_jax(run["out"]["kitchen_dp4"], *run["kitchen_ref"])


def test_block_push_sharded_matches_jax(run):
    _check_against_jax(run["out"]["push_dp4"], *run["push_ref"])
    assert (run["out"]["push_dp4"][0]["metrics"]["completion_order"].numpy() == -1).all()


def test_multislice_mesh_gathers_in_env_order(run):
    """2 slices x dp=2: the same shards (data index dcn * 2 + dp), gathered
    over "dp" then "dcn", equal the dp=4 rollout's metrics."""
    a, b = run["out"]["kitchen_dcn2x2"][0]["metrics"], run["out"]["kitchen_dp4"][0]["metrics"]
    for k in ("rewards", "results", "completed", "completion_order"):
        assert a[k].equal(b[k]), k


def test_sharded_equals_single_process_shards(run):
    """Generator draws, no injection: the gathered metrics equal B / 4-env
    rollouts of each shard on `shard_generator(seed, s)`, bit for bit."""
    case = run["cases"]["kitchen_draws"]
    cfg = PolicyConfig(**case["cfg"])
    factory = make_rollout_denoise_factory(run["tden"], case["scaler"], cfg,
                                           engine="fused_cached")
    b = B // SHARDS
    parts = [rollout_kitchen(None, case["scaler"], cfg, t(case["goals"][s * b:(s + 1) * b]),
                             t(case["expected"][s * b:(s + 1) * b]),
                             shard_generator(DRAW_SEED, s, "cpu"), n_steps=STEPS,
                             denoise_factory=factory) for s in range(SHARDS)]
    got = run["out"]["kitchen_draws"][0]["metrics"]
    for k in ("rewards", "results", "completed", "completion_order"):
        assert got[k].equal(torch.cat([getattr(p, k) for p in parts])), k


def test_batch_not_divisible_raises(run):
    for r in run["out"]["kitchen_uneven"]:
        assert "not divisible" in r["error"]


def test_shard_seeds_are_distinct_and_fixed():
    seeds = {shard_seed(s, i) for s in range(4) for i in range(64)}
    assert len(seeds) == 256 and all(0 <= x < 2 ** 63 for x in seeds)
    assert shard_seed(5, 3) == shard_seed(5, 3)
    a = torch.rand(4, generator=shard_generator(5, 3, "cpu"))
    assert a.equal(torch.rand(4, generator=shard_generator(5, 3, "cpu")))
