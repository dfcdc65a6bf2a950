"""`record_block_push_video` of `beso_tpu_torch` against `beso_tpu`'s on the
CPU (the counterpart of `tests/test_video_metrics.py::TestVideo`): with
JAX's reset and per-step action noise injected and both packages on the
smooth stand-in hash (`torch_parity.smooth_block_push_hashes`), the same
number of frames and every frame's pixels equal in all but 0.5% of them;
the gif is written."""

import jax
import numpy as np
import torch
from torch_parity import make_models, smooth_block_push_hashes, t

import beso_tpu.envs.block_push.env as jenv
import beso_tpu_torch.agents.policy as tpolicy
import beso_tpu_torch.envs.block_push.env as tenv
import beso_tpu_torch.rollout.video as tvideo
from beso_tpu.agents.policy import PolicyConfig as JaxPolicyConfig
from beso_tpu.models.scaler import fit_minmax_scaler as j_fit_minmax
from beso_tpu.rollout.video import record_block_push_video as j_record
from beso_tpu_torch.agents.policy import PolicyConfig
from beso_tpu_torch.data.trajectories import synthetic_push_data
from beso_tpu_torch.models.scaler import fit_minmax_scaler

MODEL = dict(state_dim=10, action_dim=2, goal_seq_len=1, obs_seq_len=5, n_heads=2)
CFG = dict(window_size=5, obs_dim=10, action_dim=2, sigma_min=0.05, num_sampling_steps=2)
STEPS = 3


def test_video_matches_jax(tmp_path, monkeypatch):
    smooth_block_push_hashes(monkeypatch)
    _, jden, params, tden = make_models(seed=61, **MODEL)
    data = synthetic_push_data(8, 40, seed=0)
    obs, act = data.all_observations()[:, :10], data.all_actions()
    goal = np.asarray(data.observations[0, int(data.lengths[0]) - 1], np.float32)
    key = jax.random.PRNGKey(1)
    jframes = j_record(lambda s, a, g, sig: jden.apply(params, s, a, g, sig),
                       j_fit_minmax(obs, act), JaxPolicyConfig(**CFG), goal, key,
                       str(tmp_path / "jax.gif"), n_steps=STEPS)

    # JAX's reset and its per-step noise (`jax.random.fold_in(k_roll, t)`)
    k_env, k_roll = jax.random.split(key)
    reset = jenv.block_push_reset(k_env)
    noises = iter([t(jax.random.normal(jax.random.fold_in(k_roll, i), (1, 2)))
                   for i in range(STEPS)])
    monkeypatch.setattr(tvideo, "block_push_reset", lambda *a, **k: tenv.BlockPushState(
        *(torch.as_tensor(np.array(v))[None] for v in reset)))
    monkeypatch.setattr(tpolicy, "action_noise", lambda *a: next(noises))
    path = tmp_path / "port.gif"
    frames = tvideo.record_block_push_video(tden, fit_minmax_scaler(obs, act),
                                            PolicyConfig(**CFG), torch.as_tensor(goal), None,
                                            path, n_steps=STEPS)
    assert path.exists() and path.stat().st_size > 0
    assert len(frames) == len(jframes) == STEPS + 1
    for got, want in zip(frames, jframes):
        assert got.shape == want.shape == (256, 256, 3) and got.dtype == np.uint8
        assert (got != want).any(-1).mean() <= 0.005


def test_video_without_a_file_returns_frames():
    _, _, _, tden = make_models(seed=62, **MODEL)
    data = synthetic_push_data(8, 40, seed=1)
    scaler = fit_minmax_scaler(data.all_observations()[:, :10], data.all_actions())
    frames = tvideo.record_block_push_video(tden, scaler, PolicyConfig(**CFG),
                                            torch.zeros(16), torch.Generator().manual_seed(0),
                                            None, n_steps=2)
    assert len(frames) == 3 and frames[0].std() > 1.0
