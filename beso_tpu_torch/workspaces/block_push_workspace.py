"""Block Push workspace: data wiring, batched evaluation and metrics (torch
port of `beso_tpu/workspaces/block_push_workspace.py`).

Functional parity target: `BlockPushingManager`
(`beso/workspaces/block_push_workspace.py:21-240`):
* the goal functions read the full 16-dim observations (the flip fix reads
  the targets); slicing and scaling see the first 10 dims when
  `reduce_obs_dim`;
* min-max scaler over the train split (`use_minmax_scaler`), else the
  standard one;
* the slicer masks goals (and targets, with `mask_targets`) through
  `blockpush_mask_targets`;
* evaluation: eval_n_times episodes x eval_n_steps steps of
  BlockPushMultimodal in one batched rollout on the workspace's device;
  result = |completed ∩ expected| / 2 in {0, 0.5, 1} (:218-240).

`data_path` names a directory in the multimodal-push dataset's own layout
(`data/trajectories.py::load_multimodal_push`; `data/export.py` writes one).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import torch

from beso_tpu_torch.data.slicer import SlicedDataset
from beso_tpu_torch.data.trajectories import (TrajectoryData, load_multimodal_push,
                                             split_trajectories, synthetic_push_data)
from beso_tpu_torch.data.transforms import blockpush_mask_targets
from beso_tpu_torch.envs.block_push.goals import block_push_goal_frames
from beso_tpu_torch.models.scaler import fit_minmax_scaler, fit_scaler
from beso_tpu_torch.rollout.rollout import rollout_block_push

log = logging.getLogger(__name__)


class BlockPushWorkspace:
    def __init__(self, seed: int = 6, data_path: Optional[str] = None,
                 eval_n_times: int = 100, eval_n_steps: int = 300,
                 scale_data: bool = True, window_size: int = 5,
                 goal_seq_len: int = 1, use_minmax_scaler: bool = True,
                 mask_targets: bool = False, reduce_obs_dim: bool = True,
                 train_fraction: float = 0.95, metrics_writer=None,
                 data: Optional[TrajectoryData] = None, device="cuda"):
        self.seed = seed
        self.eval_n_times = eval_n_times
        self.eval_n_steps = eval_n_steps
        self.goal_seq_len = goal_seq_len
        self.train_fraction = train_fraction
        self.mask_targets = mask_targets
        self.reduce_obs_dim = reduce_obs_dim
        self.metrics_writer = metrics_writer
        self.device = torch.device(device)

        if data is not None:
            self.full_data = data
        elif data_path is not None:
            self.full_data = load_multimodal_push(data_path, onehot_goals=True,
                                                  reduce_obs_dim=False)
        else:  # dataset not vendored: synthetic stand-in
            log.warning("no block-push data_path given: using synthetic data")
            self.full_data = synthetic_push_data(n_traj=64, t_max=100, seed=seed)

        train, test = split_trajectories(self.full_data, seed=seed,
                                         train_fraction=train_fraction)
        if reduce_obs_dim:
            train, test = (dataclasses.replace(d, observations=d.observations[..., :10])
                           for d in (train, test))
        slicer_kw = dict(window=window_size, future_seq_len=goal_seq_len,
                         transform=blockpush_mask_targets(mask_targets, reduce_obs_dim),
                         device=self.device)
        self.train_set = SlicedDataset(train, **slicer_kw)
        self.test_set = SlicedDataset(test, **slicer_kw)
        fit = fit_minmax_scaler if use_minmax_scaler else fit_scaler
        self.scaler = fit(train.all_observations(), train.all_actions(),
                          scale_data=scale_data, device=self.device)
        self.data_loader = {"train": self.train_set, "test": self.test_set}

    def test_agent(self, agent, evaluate_multigoal: bool = True,
                   evaluate_sequential: bool = True,
                   generator: Optional[torch.Generator] = None,
                   log_metrics: bool = True, cond_lambda: Optional[float] = None) -> dict:
        """The block-push evaluation: eval_n_times episodes in one batched
        rollout; `cond_lambda` overrides the agent's CFG weight.
        `evaluate_multigoal` and `evaluate_sequential` are accepted and
        ignored, as in the reference ("just for same input as kitchen
        environment", block_push_workspace.py:90-99): block push has one
        evaluation protocol."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(self.seed)
        frames, expected = block_push_goal_frames(self.full_data, self.eval_n_times,
                                                  self.seed, self.train_fraction)
        cfg = agent.policy_config(cond_lambda=cond_lambda)
        metrics = rollout_block_push(
            agent.make_denoise_fn(), agent.scaler, cfg,
            torch.as_tensor(frames, device=self.device),
            torch.as_tensor(expected, device=self.device), generator,
            n_steps=self.eval_n_steps, goal_seq_len=self.goal_seq_len,
            reduce_obs_dim=self.reduce_obs_dim, mask_targets=self.mask_targets,
            denoise_factory=agent.make_denoise_factory(cfg))
        rewards = metrics.rewards.cpu().numpy()
        results = metrics.results.cpu().numpy()
        out = {
            "avrg_reward": float(rewards.mean()),
            "std_reward": float(rewards.std()),
            "avrg_result": float(results.mean()),
            "std_result": float(results.std()),
        }
        out["cond_success_ratio"] = out["avrg_result"] / (out["avrg_reward"] + 1e-6)
        if log_metrics:
            log.info("avg reward %.3f +- %.3f | avg result %.3f +- %.3f",
                     out["avrg_reward"], out["std_reward"],
                     out["avrg_result"], out["std_result"])
            if self.metrics_writer is not None:
                self.metrics_writer.log({
                    "Average_reward": out["avrg_reward"],
                    "Average_result": out["avrg_result"],
                    "Cond_success_ratio": out["cond_success_ratio"],
                })
        return out
