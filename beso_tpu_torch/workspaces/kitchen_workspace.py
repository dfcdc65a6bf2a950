"""Franka Kitchen workspace: data wiring, batched multigoal evaluation and
metrics (torch port of `beso_tpu/workspaces/kitchen_workspace.py`).

Functional parity target: `FrankaKitchenManager`
(`beso/workspaces/kitchen_workspace_manager.py:27-708`):
* builds the kitchen datasets + Scaler + train/test streams (:137-167);
* multigoal evaluation: eval_n_times episodes x eval_n_steps steps against
  dataset-tail goals; result = |completed ∩ expected| (:213-316, 527-578),
  optionally from known start states (:500-525) or under other physics;
* sequential evaluation: 4 sub-goals with per-goal step budgets (:318-423);
* compute_performance: avg/std reward+result, Cond_success_ratio,
  success-rate-at-1..5, per-task solved/expected counts, trajectory
  multimodality census and the task-transition tree (:425-498, 596-708).

`data_path` names a directory in the relay-kitchen dataset's own layout
(`data/trajectories.py::load_relay_kitchen`; `data/export.py` writes one).
The comparison studies come from `workspaces/base.py`.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from beso_tpu_torch.data.slicer import SlicedDataset
from beso_tpu_torch.data.trajectories import (TrajectoryData, load_relay_kitchen,
                                             split_trajectories,
                                             synthetic_kitchen_data)
from beso_tpu_torch.envs.kitchen.env import ALL_TASKS
from beso_tpu_torch.envs.kitchen.goals import (multigoal_kitchen_goals,
                                               sequential_kitchen_goals)
from beso_tpu_torch.models.scaler import fit_scaler
from beso_tpu_torch.rollout.rollout import rollout_kitchen, success_rate_histogram
from beso_tpu_torch.rollout.sequential import rollout_kitchen_sequential
from beso_tpu_torch.workspaces.base import BaseWorkspace

log = logging.getLogger(__name__)


class FrankaKitchenWorkspace(BaseWorkspace):
    def __init__(self, seed: int = 42, data_path: Optional[str] = None,
                 eval_n_times: int = 100, eval_n_steps: int = 280,
                 scale_data: bool = False, window_size: int = 4,
                 goal_seq_len: int = 2, train_fraction: float = 0.95,
                 metrics_writer=None, data: Optional[TrajectoryData] = None,
                 device="cuda"):
        self.seed = seed
        self.eval_n_times = eval_n_times
        self.eval_n_steps = eval_n_steps
        self.goal_seq_len = goal_seq_len
        self.train_fraction = train_fraction
        self.metrics_writer = metrics_writer
        self.device = torch.device(device)

        if data is not None:
            self.full_data = data
        elif data_path is not None:
            self.full_data = load_relay_kitchen(data_path, onehot_goals=True)
        else:  # datasets not vendored (osf.io/q3dx2): synthetic stand-in
            log.warning("no kitchen data_path given: using synthetic data")
            self.full_data = synthetic_kitchen_data(n_traj=64, t_max=120, seed=seed)
        train, test = split_trajectories(self.full_data, seed=seed,
                                         train_fraction=train_fraction)
        slicer_kw = dict(window=window_size, future_seq_len=goal_seq_len,
                         device=self.device)
        self.train_set = SlicedDataset(train, **slicer_kw)
        self.test_set = SlicedDataset(test, **slicer_kw)
        # Scaler over the TRAIN split (kitchen_workspace_manager.py:144-147)
        self.scaler = fit_scaler(train.all_observations(), train.all_actions(),
                                 scale_data=scale_data, device=self.device)
        self.data_loader = {"train": self.train_set, "test": self.test_set}

    # -- evaluation ----------------------------------------------------------
    def test_agent(self, agent, evaluate_multigoal: bool = True,
                   evaluate_sequential: bool = False,
                   generator: Optional[torch.Generator] = None, extra_args=None,
                   log_metrics: bool = True, physics_params=None,
                   start_from_known: bool = False, init_qpos=None, **overrides):
        """The multigoal and/or the sequential evaluation (both: a pair of
        results); `overrides` (new_sampler_type, n_inference_steps,
        noise_scheduler, cond_lambda, get_mean, aggregation) and
        `extra_args` (s_churn, s_min) change the agent's policy config for
        them (`_policy_cfg`). Each evaluation starts from the draws of
        `generator` as the call found it (the sequential one on a copy of
        its state, as JAX hands both evaluations the same key), or from a
        generator seeded with the workspace's seed."""
        seq_generator = generator
        if generator is not None and evaluate_multigoal:
            seq_generator = torch.Generator(generator.device)
            seq_generator.set_state(generator.get_state())
        mg = seq = None
        if evaluate_multigoal:
            mg = self.test_agent_on_multigoal(
                agent, generator, extra_args, log_metrics, physics_params=physics_params,
                start_from_known=start_from_known, init_qpos=init_qpos, **overrides)
        if evaluate_sequential:
            seq = self.test_agent_on_sequential_tasks(
                agent, seq_generator, extra_args, log_metrics,
                physics_params=physics_params, **overrides)
        if evaluate_multigoal and evaluate_sequential:
            return mg, seq
        return mg if mg is not None else seq

    def _generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(self.seed)
        return generator

    def test_agent_on_multigoal(self, agent, generator: Optional[torch.Generator] = None,
                                extra_args=None, log_metrics: bool = True,
                                physics_params=None, start_from_known: bool = False,
                                init_qpos=None, **overrides) -> dict:
        """Multigoal evaluation: all eval_n_times episodes in one batched
        rollout on the workspace's device, with the policy overrides of
        `test_agent`. `physics_params` (a KitchenParams) evaluates under
        other surrogate physics. `start_from_known` starts episode i from
        known start state i (wrapping) of `init_qpos` [N, 30] (e.g. from
        `envs.kitchen.env.load_init_qpos`), or of the dataset's first
        frames (the reference's `_start_from_known`, :500-525)."""
        goals, expected = multigoal_kitchen_goals(
            self.full_data, self.goal_seq_len, self.eval_n_times, self.seed,
            self.train_fraction)
        starts = None
        if start_from_known:
            pool = (np.asarray(init_qpos) if init_qpos is not None
                    else np.asarray(self.full_data.observations[:, 0, :30]))
            starts = torch.as_tensor(pool[np.arange(self.eval_n_times) % len(pool)],
                                     dtype=torch.float32, device=self.device)
        cfg = self._policy_cfg(agent, extra_args=extra_args, **overrides)
        metrics = rollout_kitchen(agent.make_denoise_fn(), agent.scaler, cfg,
                                  torch.as_tensor(goals, device=self.device),
                                  torch.as_tensor(expected, device=self.device),
                                  self._generator(generator), n_steps=self.eval_n_steps,
                                  physics_params=physics_params, init_qpos=starts,
                                  denoise_factory=agent.make_denoise_factory(cfg))
        return self.compute_performance(metrics, expected, "multigoal", log_metrics)

    def test_agent_on_sequential_tasks(self, agent,
                                       generator: Optional[torch.Generator] = None,
                                       extra_args=None, log_metrics: bool = True,
                                       physics_params=None, budget_margin: int = 50,
                                       **overrides) -> dict:
        """Sequential evaluation: each episode walks its 4 dataset sub-goals
        with per-goal step budgets (`rollout/sequential.py`), on the agent's
        uncached denoiser (the goal changes mid-episode, so no prefix cache:
        B4 under 'fused_cached', else the plain forward)."""
        goals, timeframes, task_ids, expected = sequential_kitchen_goals(
            self.full_data, self.goal_seq_len, self.eval_n_times, self.seed,
            self.train_fraction)
        cfg = self._policy_cfg(agent, extra_args=extra_args, **overrides)

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        metrics = rollout_kitchen_sequential(
            agent.make_uncached_denoise_fn(), agent.scaler, cfg, dev(goals), dev(timeframes),
            dev(task_ids), dev(expected), self._generator(generator),
            n_steps=self.eval_n_steps, physics_params=physics_params,
            budget_margin=budget_margin)
        return self.compute_performance(metrics, expected, "sequential", log_metrics)

    # -- metrics -------------------------------------------------------------
    def compute_performance(self, metrics, expected: np.ndarray,
                            eval_type: str, log_metrics: bool = True) -> dict:
        rewards = metrics.rewards.cpu().numpy()
        results = metrics.results.cpu().numpy()
        completed = metrics.completed.cpu().numpy()
        out = {
            "avrg_reward": float(rewards.mean()),
            "std_reward": float(rewards.std()),
            "avrg_result": float(results.mean()),
            "std_result": float(results.std()),
        }
        out["cond_success_ratio"] = out["avrg_result"] / (out["avrg_reward"] + 1e-6)
        out.update(success_rate_histogram(completed.sum(-1)))
        # per-task solved/expected counts (kitchen_workspace_manager.py:571-576)
        out["solved_tasks"] = {f"n_{t}": int(completed[:, i].sum())
                               for i, t in enumerate(ALL_TASKS)}
        out["expected_tasks"] = {f"n_{t}": int(np.asarray(expected)[:, i].sum())
                                 for i, t in enumerate(ALL_TASKS)}
        out["traj_count"] = self.trajectory_census(completed,
                                                   metrics.completion_order.cpu().numpy())
        out["task_tree"] = self.get_state_transitions(out["traj_count"])
        if log_metrics:
            log.info("[%s] avg reward %.3f +- %.3f | avg result %.3f +- %.3f",
                     eval_type, out["avrg_reward"], out["std_reward"],
                     out["avrg_result"], out["std_result"])
            for k in range(1, 6):
                log.info("Success rate %d: %.3f", k, out[f"success_rate_{k}"])
            if self.metrics_writer is not None:
                self.metrics_writer.log({
                    f"{eval_type}/Average_reward": out["avrg_reward"],
                    f"{eval_type}/Average_result": out["avrg_result"],
                    f"{eval_type}/Cond_success_ratio": out["cond_success_ratio"],
                })
        return out

    @staticmethod
    def trajectory_census(completed: np.ndarray, order: np.ndarray) -> dict:
        """Counts of completed-task sequences keyed in completion order
        (kitchen_workspace_manager.py:564-570)."""
        census: dict = {}
        for b in range(completed.shape[0]):
            done_idx = sorted((i for i in range(completed.shape[1]) if completed[b, i]),
                              key=lambda i: int(order[b, i]))
            key = ", ".join(ALL_TASKS[i] for i in done_idx)
            census[key] = census.get(key, 0) + 1
        return census

    @staticmethod
    def get_state_transitions(traj_count: dict) -> dict:
        """Task-transition tree with conditional probabilities
        (kitchen_workspace_manager.py:637-708), up to depth 4."""
        tree: dict = {}
        total = sum(traj_count.values()) or 1
        for traj, count in traj_count.items():
            node = tree
            for task in [t.strip() for t in traj.split(",") if t.strip()][:4]:
                node = node.setdefault(task, {"count": 0})
                node["count"] += count

        def annotate(node: dict, parent_count: int):
            for k, child in node.items():
                if k in ("count", "prob"):
                    continue
                child["prob"] = child["count"] / max(parent_count, 1)
                annotate(child, child["count"])

        annotate(tree, total)
        return tree
