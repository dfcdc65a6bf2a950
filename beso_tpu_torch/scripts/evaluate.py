"""Evaluation CLI of the PyTorch port (port of `scripts/evaluate.py`).

Functional parity target: `scripts/evaluate.py:20-128` of the reference:
reload the stored run config from `<model_store_path>/config.yaml`, rebuild
workspace and agent, load the train state the training CLI stored
(`train_state.pt`), take the eval config's sigma range, and dispatch one of
the five study modes:
  test_single_variant | test_all_samplers |
  compare_samplers_over_diffent_steps [sic] |
  compare_classifier_free_guidance | compare_noisy_sampler.

The agent serves with the engine that the eval config's `inference_engine`
names, by default "auto" (the plain cached engine where the sampler allows
it, else the plain forward), as the JAX CLI's does. `inference_engine=
fused_cached`, a port option, serves every configuration of a study on the
fused-layer kernels: B1 where the sampler stays on the sigma grid, B4
(`BesoAgent.make_uncached_denoise_fn`) where it does not.

Usage:
    python -m beso_tpu_torch.scripts.evaluate \\
        --config configs/evaluate_kitchen.yaml [--device cpu] \\
        [model_store_path=logs/.../run num_runs=100 ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
from pathlib import Path

import torch


def eval_agent_config(eval_cfg, model_cfg):
    """The trained run's agent config with the eval config's sigma range
    (evaluate.py:49-50) and serving engine."""
    from beso_tpu_torch.scripts.training import build_agent_config

    agent_cfg = build_agent_config(model_cfg)
    return dataclasses.replace(
        agent_cfg,
        sigma_min=eval_cfg.get("sigma_min", agent_cfg.sigma_min),
        sigma_max=eval_cfg.get("sigma_max", agent_cfg.sigma_max),
        inference_engine=eval_cfg.get("inference_engine", agent_cfg.inference_engine))


def policy_overrides(eval_cfg, model_cfg) -> dict:
    """The workspace's policy overrides from the eval config; CFG wraps the
    model only when it was trained with goal dropout (evaluate.py:57-61)."""
    cond_lambda = (eval_cfg.get("cond_lambda", 1.0)
                   if model_cfg.get("cond_mask_prob", 0) > 0 else None)
    return dict(new_sampler_type=eval_cfg.get("sampler_type"),
                n_inference_steps=eval_cfg.get("n_inference_steps"),
                noise_scheduler=eval_cfg.get("noise_scheduler"),
                cond_lambda=cond_lambda,
                get_mean=eval_cfg.get("n_action_samples"),
                aggregation=eval_cfg.get("aggregation"))


def run_study(workspace, agent, eval_cfg, model_cfg, generator: torch.Generator):
    """The study the eval config selects, on `agent`; returns its results.
    `generator` draws the single variant's noise; each configuration of a
    study draws from the workspace's own seed, as in the JAX CLI."""
    num_runs = eval_cfg.get("num_runs", 100)
    num_steps = eval_cfg.get("num_steps_per_run", workspace.eval_n_steps)
    store_path = eval_cfg.get("store_path")
    n_steps = eval_cfg.get("n_inference_steps")
    if eval_cfg.get("test_all_samplers"):
        return workspace.compare_sampler_types(agent, num_runs, num_steps,
                                               n_inference_steps=n_steps,
                                               store_path=store_path)
    if eval_cfg.get("compare_samplers_over_diffent_steps"):
        return workspace.compare_sampler_types_over_n_steps(agent, num_runs, num_steps,
                                                            store_path=store_path)
    if eval_cfg.get("compare_classifier_free_guidance"):
        return workspace.compare_classifier_free_guidance(
            agent, num_runs, num_steps, n_inference_steps=n_steps, store_path=store_path)
    if eval_cfg.get("compare_noisy_sampler"):
        return workspace.compare_noisy_sampler(agent, num_runs, num_steps,
                                               n_inference_steps=n_steps,
                                               store_path=store_path)
    # test_single_variant
    workspace.eval_n_times = num_runs
    workspace.eval_n_steps = num_steps
    extra = {"s_churn": eval_cfg.get("s_churn", 0.0), "s_min": eval_cfg.get("s_min", 0.0)}
    return workspace.test_agent(agent, generator=generator, extra_args=extra,
                                **policy_overrides(eval_cfg, model_cfg))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; --device cpu runs on the CPU)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")

    from beso_tpu_torch.agents.beso_agent import BesoAgent
    from beso_tpu_torch.scripts.training import build_workspace
    from beso_tpu_torch.utils.config import load_config

    eval_cfg = load_config(args.config, args.overrides)
    store = Path(eval_cfg["model_store_path"])
    # config round-trip: rebuild the exact trained model (evaluate.py:33-47)
    model_cfg = load_config(store / "config.yaml")
    device = torch.device(args.device)

    workspace = build_workspace(model_cfg, device)
    agent = BesoAgent(eval_agent_config(eval_cfg, model_cfg), workspace.scaler,
                      device=device)
    seed = eval_cfg.get("seed", model_cfg["seed"])
    agent.init(torch.Generator().manual_seed(seed))
    agent.load_pretrained_model(str(store))
    out = run_study(workspace, agent, eval_cfg, model_cfg,
                    torch.Generator(device).manual_seed(seed))
    logging.info("evaluation results: %s", out)
    return out


if __name__ == "__main__":
    main()
