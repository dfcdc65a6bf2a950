"""Training CLI of the PyTorch port (port of `scripts/training.py`).

Functional parity target: `scripts/training.py:22-78` of the reference: seed
the generators, build workspace + agent from the config, train, store the
train state, then run the final evaluation (CFG-wrapped when
cond_mask_prob > 0), keeping the resolved config and checkpoints in a run
directory.

Usage:
    python -m beso_tpu_torch.scripts.training \\
        --config configs/block_push.yaml \\
        [--run-dir logs/run1] [--device cuda] [max_train_steps=2000 seed=7 ...]

A config with obs_dim 30 builds the kitchen workspace, any other the
block-push workspace, as `scripts/training.py` does.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np
import torch


def build_agent_config(cfg):
    from beso_tpu_torch.agents.beso_agent import BesoAgentConfig

    return BesoAgentConfig(
        obs_dim=cfg["obs_dim"],
        action_dim=cfg["action_dim"],
        hidden_dim=cfg["hidden_dim"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["n_heads"],
        goal_seq_len=cfg["future_seq_length"],
        window_size=cfg["window_size"],
        goal_conditioned=cfg.get("goal_conditioning", True),
        attn_pdrop=cfg.get("attn_pdrop", 0.0),
        resid_pdrop=cfg.get("resid_pdrop", 0.0),
        cond_mask_prob=cfg.get("cond_mask_prob", 0.0),
        linear_output=cfg.get("linear_output", True),
        attention=cfg.get("attention", "auto"),
        sampler_type=cfg.get("sampler_type", "ddim"),
        num_sampling_steps=cfg.get("n_timesteps", 3),
        sigma_data=cfg.get("sigma_data", 0.5),
        sigma_min=cfg.get("sigma_min", 0.005),
        sigma_max=cfg.get("sigma_max", 1.0),
        rho=cfg.get("rho", 5.0),
        noise_scheduler=cfg.get("noise_scheduler", "exponential"),
        sigma_sample_density_type=cfg.get("sigma_sample_density_type", "loglogistic"),
        sigma_sample_density_mean=cfg.get("sigma_sample_density_mean", -0.6),
        sigma_sample_density_std=cfg.get("sigma_sample_density_std", 1.6),
        optimizer=cfg.get("optimizer", "adamw"),
        lr=float(cfg.get("lr", 1e-4)),
        betas=tuple(cfg.get("betas", (0.9, 0.999))),
        weight_decay=float(cfg.get("weight_decay", 0.01)),
        lr_step_size=cfg.get("lr_step_size", 100),
        lr_gamma=cfg.get("lr_gamma", 0.99),
        max_train_steps=cfg.get("max_train_steps", 1000),
        eval_every_n_steps=cfg.get("eval_every_n_steps", 500),
        train_batch_size=cfg.get("train_batch_size", 1024),
        use_ema=cfg.get("use_ema", True),
        decay=cfg.get("decay", 0.999),
        update_ema_every_n_steps=cfg.get("update_ema_every_n_steps", 1),
        pred_last_action_only=cfg.get("pred_last_action_only", False),
        cond_lambda=cfg.get("cond_lambda", 1.0),
        compute_dtype=cfg.get("compute_dtype", "float32"),
    )


def build_workspace(cfg, device, metrics_writer=None):
    from beso_tpu_torch.workspaces import BlockPushWorkspace, FrankaKitchenWorkspace

    common = dict(seed=cfg["seed"], data_path=cfg.get("data_path"),
                  eval_n_times=cfg.get("eval_n_times", 100),
                  window_size=cfg["window_size"],
                  goal_seq_len=cfg["future_seq_length"],
                  train_fraction=cfg.get("train_fraction", 0.95),
                  metrics_writer=metrics_writer, device=device)
    if cfg["obs_dim"] == 30:
        return FrankaKitchenWorkspace(
            eval_n_steps=cfg.get("eval_n_steps", 280),
            scale_data=cfg.get("scale_data", False), **common)
    return BlockPushWorkspace(
        eval_n_steps=cfg.get("eval_n_steps", 300),
        scale_data=cfg.get("scale_data", True),
        use_minmax_scaler=cfg.get("use_minmax_scaler", True),
        mask_targets=cfg.get("mask_targets", False),
        reduce_obs_dim=cfg.get("reduce_obs_dim", True), **common)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--run-dir", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; --device cpu runs on the CPU)")
    parser.add_argument("--resume", default=None,
                        help="run dir with a saved train_state to resume from")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    from beso_tpu_torch.agents.beso_agent import BesoAgent
    from beso_tpu_torch.utils.config import load_config, save_config
    from beso_tpu_torch.utils.metrics import make_metrics_writer

    cfg = load_config(args.config, args.overrides)
    device = torch.device(args.device)
    run_dir = Path(args.run_dir or Path(cfg.get("log_dir", "logs")) / "runs" /
                   time.strftime("%Y-%m-%d/%H-%M-%S"))
    run_dir.mkdir(parents=True, exist_ok=True)
    save_config(cfg, run_dir)

    np.random.seed(cfg["seed"])
    torch.manual_seed(cfg["seed"])
    writer = make_metrics_writer(
        log_dir=str(run_dir),
        use_wandb=cfg.get("wandb", {}).get("enabled", False),
        project=cfg.get("wandb", {}).get("project"))

    workspace = build_workspace(cfg, device, writer)
    agent = BesoAgent(build_agent_config(cfg), workspace.scaler,
                      checkpoint_dir=str(run_dir), metrics_writer=writer,
                      device=device)
    agent.init(torch.Generator().manual_seed(cfg["seed"]))
    if args.resume:
        agent.load_pretrained_model(args.resume)
        logging.info("resumed from %s at step %d", args.resume, agent.state.step)
    train_gen = torch.Generator(device).manual_seed(cfg["seed"] + 1)
    agent.train_agent(workspace.train_set, workspace.test_set, train_gen,
                      train_method=cfg.get("train_method", "steps"),
                      max_epochs=cfg.get("max_epochs", 100),
                      patience=cfg.get("patience", 80))
    agent.store_model_weights(str(run_dir))

    # final evaluation; CFG-wrapped when trained with goal dropout
    # (reference training.py:53-69)
    cond_lambda = (cfg.get("cond_lambda", 1.0) if cfg.get("cond_mask_prob", 0) > 0
                   else None)
    results = workspace.test_agent(
        agent, evaluate_multigoal=cfg.get("evaluate_multigoal", True),
        evaluate_sequential=cfg.get("evaluate_sequential", False),
        generator=torch.Generator(device).manual_seed(cfg["seed"] + 2),
        cond_lambda=cond_lambda)
    logging.info("final evaluation: %s", results)
    writer.close()
    return results


if __name__ == "__main__":
    main()
