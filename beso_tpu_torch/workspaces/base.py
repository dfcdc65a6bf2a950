"""Workspace base: the comparison studies (torch port of
`beso_tpu/workspaces/base.py`).

Functional parity target: `BaseWorkspaceManger` [sic]
(`beso/workspaces/base_workspace_manager.py:19-662`), whose public surface is
`.data_loader`, `.scaler`, `.test_agent(...)` and six sweep studies. Every
study runs `test_agent` per configuration, collects avg/std of reward and
result, and saves numpy arrays and a matplotlib plot when given a
`store_path`.

Each `test_agent` call is one batched rollout of all episodes.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

# the 8 samplers studied by the reference (base_workspace_manager.py:81-82)
STUDY_SAMPLERS = ("euler", "ancestral", "euler_ancestral", "heun", "lms",
                  "dpm", "dpmpp_2s_ancestral", "dpmpp_2m")
# deterministic-vs-noisy study list (base_workspace_manager.py:158-159)
NOISY_STUDY_SAMPLERS = ("euler", "dpm", "dpmpp_2m", "euler_ancestral",
                        "ancestral", "dpmpp_2m_sde")
STUDY_STEP_COUNTS = (3, 4, 5, 10, 20, 40, 50)   # scripts/evaluate.py:93
STUDY_CFG_LAMBDAS = (0.0, 1.0, 1.5, 2.0, 2.5)   # scripts/evaluate.py:109


class BaseWorkspace:
    """Subclasses implement `test_agent(agent, **overrides) -> dict` with
    keys avrg_reward/std_reward/avrg_result/std_result."""

    eval_n_times: int
    eval_n_steps: int

    def test_agent(self, agent, **kwargs) -> dict:
        raise NotImplementedError

    @staticmethod
    def _policy_cfg(agent, new_sampler_type=None, n_inference_steps=None,
                    noise_scheduler=None, cond_lambda=None, get_mean=None,
                    aggregation=None, extra_args=None):
        """The agent's policy config with a study's or the evaluation CLI's
        overrides; None keeps the agent's value (`beso_tpu/workspaces/
        kitchen_workspace.py:73-86`, `block_push_workspace.py:81-94`)."""
        extra_args = extra_args or {}
        return agent.policy_config(
            sampler_type=new_sampler_type,
            num_sampling_steps=n_inference_steps,
            noise_scheduler=noise_scheduler,
            cond_lambda=cond_lambda,
            n_action_samples=get_mean,
            aggregation=aggregation,
            s_churn=extra_args.get("s_churn"),
            s_tmin=extra_args.get("s_min"),
        )

    # -- studies -----------------------------------------------------------
    def _sweep(self, agent, configs: Sequence[dict], labels: Sequence[str],
               num_runs=None, num_steps_per_run=None, store_path=None,
               plot_name="study", **common) -> dict:
        old_times, old_steps = self.eval_n_times, self.eval_n_steps
        if num_runs is not None:
            self.eval_n_times = num_runs
        if num_steps_per_run is not None:
            self.eval_n_steps = num_steps_per_run
        rewards, results, std_r, std_q = [], [], [], []
        try:
            for label, overrides in zip(labels, configs):
                rd = self.test_agent(agent, **{**common, **overrides})
                rewards.append(round(rd["avrg_reward"], 2))
                results.append(round(rd["avrg_result"], 2))
                std_r.append(round(rd["std_reward"], 2))
                std_q.append(round(rd["std_result"], 2))
                log.info("%s: reward %.3f +- %.3f, result %.3f +- %.3f",
                         label, rewards[-1], std_r[-1], results[-1], std_q[-1])
        finally:
            self.eval_n_times, self.eval_n_steps = old_times, old_steps
        out = {"labels": list(labels), "avrg_rewards": rewards,
               "results": results, "std_rewards": std_r, "std_results": std_q}
        if store_path is not None:
            os.makedirs(store_path, exist_ok=True)
            for k in ("avrg_rewards", "results", "std_rewards", "std_results"):
                np.save(os.path.join(store_path, f"{plot_name}_{k}.npy"),
                        np.asarray(out[k]))
            self._bar_plot(out, store_path, plot_name)
        return out

    @staticmethod
    def _bar_plot(out: dict, store_path: str, plot_name: str):
        """Grouped reward/result bar chart (base_workspace_manager.py:96-135).
        matplotlib is imported here, so only a study with a store_path needs
        it."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        x = np.arange(len(out["labels"]))
        width = 0.35
        fig, ax = plt.subplots(figsize=(10, 5), dpi=200)
        r1 = ax.bar(x - width / 2, out["avrg_rewards"], width,
                    yerr=out["std_rewards"], ecolor="black", alpha=0.5,
                    label="Reward")
        r2 = ax.bar(x + width / 2, out["results"], width,
                    yerr=out["std_results"], ecolor="black", label="Result")
        ax.set_xticks(x, out["labels"])
        ax.bar_label(r1, padding=3)
        ax.bar_label(r2, padding=3)
        ax.yaxis.grid(True)
        ax.legend()
        fig.tight_layout()
        plt.savefig(os.path.join(store_path, plot_name + ".png"))
        plt.close(fig)

    def compare_sampler_types(self, agent, num_runs, num_steps_per_run,
                              n_inference_steps=None, store_path=None,
                              get_mean=None, **kw):
        """8-sampler sweep (base_workspace_manager.py:47-135)."""
        return self._sweep(
            agent, [dict(new_sampler_type=s) for s in STUDY_SAMPLERS],
            STUDY_SAMPLERS, num_runs, num_steps_per_run, store_path,
            "sampler_comparison", n_inference_steps=n_inference_steps,
            get_mean=get_mean, **kw)

    def compare_noisy_sampler(self, agent, num_runs, num_steps_per_run,
                              n_inference_steps=None, store_path=None, **kw):
        """Deterministic-vs-stochastic samplers (base_workspace_manager.py:137-266)."""
        return self._sweep(
            agent, [dict(new_sampler_type=s) for s in NOISY_STUDY_SAMPLERS],
            NOISY_STUDY_SAMPLERS, num_runs, num_steps_per_run, store_path,
            "noisy_sampler_comparison", n_inference_steps=n_inference_steps, **kw)

    def compare_sde_sampling(self, agent, num_runs, num_steps_per_run,
                             churn_list: Sequence[float],
                             n_inference_steps=None, s_min: float = 0.0,
                             store_path=None, **kw):
        """s_churn sweep over the euler sampler (base_workspace_manager.py:268-342)."""
        return self._sweep(
            agent,
            [dict(new_sampler_type="euler",
                  extra_args={"s_churn": c, "s_min": s_min}) for c in churn_list],
            [f"churn={c}" for c in churn_list], num_runs, num_steps_per_run,
            store_path, "sde_churn_comparison",
            n_inference_steps=n_inference_steps, **kw)

    def compare_classifier_free_guidance(self, agent, num_runs,
                                         num_steps_per_run,
                                         cond_lambda_list: Sequence[float] = STUDY_CFG_LAMBDAS,
                                         n_inference_steps=None,
                                         store_path=None, **kw):
        """CFG lambda sweep (base_workspace_manager.py:344-430)."""
        return self._sweep(
            agent, [dict(cond_lambda=lam) for lam in cond_lambda_list],
            [f"lambda={lam}" for lam in cond_lambda_list], num_runs,
            num_steps_per_run, store_path, "cfg_lambda_comparison",
            n_inference_steps=n_inference_steps, **kw)

    def compare_kde_vs_mean_vs_single(self, agent, num_runs, num_steps_per_run,
                                      sampler_type, n_inference_steps=None,
                                      get_mean: int = 16, store_path=None, **kw):
        """single vs mean-of-n vs KDE-of-n action selection
        (base_workspace_manager.py:432-518)."""
        strategies = ["single", "mean", "kde"]
        return self._sweep(
            agent,
            [dict(new_sampler_type=sampler_type, get_mean=None if s == "single" else get_mean,
                  aggregation=s) for s in strategies],
            strategies, num_runs, num_steps_per_run, store_path,
            "generation_strategy_comparison",
            n_inference_steps=n_inference_steps, **kw)

    def compare_sampler_types_over_n_steps(self, agent, num_runs,
                                           num_steps_per_run,
                                           steps_list: Sequence[int] = STUDY_STEP_COUNTS,
                                           samplers_list: Optional[Sequence[str]] = None,
                                           store_path=None, **kw):
        """Sampler x NFE grid with line plots (base_workspace_manager.py:520-662)."""
        samplers = tuple(samplers_list) if samplers_list else STUDY_SAMPLERS
        result_arr = np.zeros((len(samplers), len(steps_list)))
        reward_arr = np.zeros_like(result_arr)
        result_std = np.zeros_like(result_arr)
        reward_std = np.zeros_like(result_arr)
        old_times, old_steps = self.eval_n_times, self.eval_n_steps
        self.eval_n_times, self.eval_n_steps = num_runs, num_steps_per_run
        try:
            for i, s in enumerate(samplers):
                for j, n in enumerate(steps_list):
                    rd = self.test_agent(agent, new_sampler_type=s,
                                         n_inference_steps=n, **kw)
                    reward_arr[i, j] = rd["avrg_reward"]
                    result_arr[i, j] = rd["avrg_result"]
                    reward_std[i, j] = rd["std_reward"]
                    result_std[i, j] = rd["std_result"]
        finally:
            self.eval_n_times, self.eval_n_steps = old_times, old_steps
        if store_path is not None:
            os.makedirs(store_path, exist_ok=True)
            np.save(os.path.join(store_path, "steps_grid_result.npy"), result_arr)
            np.save(os.path.join(store_path, "steps_grid_reward.npy"), reward_arr)
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(10, 5), dpi=200)
            for i, s in enumerate(samplers):
                ax.plot(list(steps_list), result_arr[i], marker="o", label=s)
            ax.set_xlabel("denoising steps")
            ax.set_ylabel("avg result")
            ax.legend()
            ax.grid(True)
            fig.tight_layout()
            plt.savefig(os.path.join(store_path, "sampler_steps_grid.png"))
            plt.close(fig)
        return {"samplers": list(samplers), "steps": list(steps_list),
                "result": result_arr, "reward": reward_arr,
                "result_std": result_std, "reward_std": reward_std}
