"""Rollout video of one block-push episode (torch port of
`beso_tpu/rollout/video.py`; the reference's `store_video` paths,
kitchen_workspace_manager.py:243-314 and block_push_workspace.py:107-188:
rgb_array frames -> imageio at 30 fps).

The batched rollouts draw no frames, so this runs one episode of its own,
policy and physics on `goal_frame`'s device, and draws each state with the
host renderer (matplotlib; imageio writes the file).
"""

from __future__ import annotations

from typing import Optional

import torch

from beso_tpu_torch.agents.policy import PolicyConfig, policy_predict, policy_reset
from beso_tpu_torch.envs.block_push.env import block_push_obs, block_push_reset, block_push_step
from beso_tpu_torch.envs.block_push.goals import build_block_push_goals
from beso_tpu_torch.envs.block_push.render import render_frame, save_video


@torch.inference_mode()
def record_block_push_video(denoise_fn, scaler, cfg: PolicyConfig, goal_frame: torch.Tensor,
                            generator: Optional[torch.Generator], video_path, n_steps: int = 150,
                            fps: int = 30, reduce_obs_dim: bool = True) -> list:
    """Roll one episode toward `goal_frame` [16] and write an mp4 or gif to
    `video_path` (None: no file). `generator` draws the reset, then the
    policy's noise. Stops early when the episode is done. Returns the
    frames, the reset's first."""
    device = goal_frame.device
    env = block_push_reset(1, generator, device)
    obs16 = block_push_obs(env)
    goal = build_block_push_goals(obs16, goal_frame[None], 1, zero_goals=True,
                                  reduce_obs_dim=reduce_obs_dim)
    pstate = policy_reset(1, cfg, device)
    frames = [render_frame(env)]
    for _ in range(n_steps):
        obs = obs16[:, :10] if reduce_obs_dim else obs16
        action, pstate = policy_predict(denoise_fn, scaler, pstate, obs, goal, generator, cfg)
        env, obs16, _, done = block_push_step(env, action)
        frames.append(render_frame(env))
        if bool(done[0]):
            break
    if video_path is not None:
        save_video(frames, video_path, fps=fps)
    return frames
