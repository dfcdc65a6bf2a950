"""Sweep CLI of the PyTorch port: the reference's `--multirun` (port of
`scripts/sweep.py`).

The reference fans Hydra multiruns out as one process per (seed, override)
cell (README.md:94-98). Here the seeds of a cell train together as one
program (`beso_tpu_torch/train/sweep.py`: stacked parameters under
`torch.func.vmap`), and non-seed grids, which change the program, loop over
cells.

Usage:
    python -m beso_tpu_torch.scripts.sweep --config configs/block_push.yaml \\
        --seeds 1,2,3 [--grid lr=1e-4,3e-4 --grid n_timesteps=3,10] \\
        [--run-dir logs/sweep1] [--final-eval] [--device cpu] \\
        [max_train_steps=2000 ...]

Each cell and seed gets its own run dir (<run_dir>/<cell>/seed_<s>/) with
the resolved config and the full train state, which
`beso_tpu_torch.scripts.evaluate` loads (`model_store_path=`); each cell
and the root get a `summary.json`.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch


def parse_grid(entries):
    """['lr=1e-4,3e-4', 'n_timesteps=3,10'] -> list of override dicts."""
    if not entries:
        return [{}]
    keys, value_lists = [], []
    for e in entries:
        k, _, vs = e.partition("=")
        keys.append(k)
        value_lists.append(vs.split(","))
    return [dict(zip(keys, combo)) for combo in itertools.product(*value_lists)]


def cell_name(overrides: dict) -> str:
    if not overrides:
        return "base"
    return "_".join(f"{k.split('.')[-1]}-{v}" for k, v in overrides.items())


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--seeds", default="0",
                        help="comma-separated seeds; trained together as one program")
    parser.add_argument("--grid", action="append", default=[],
                        help="key=v1,v2,... (repeatable); cells loop serially")
    parser.add_argument("--run-dir", default=None)
    parser.add_argument("--final-eval", action="store_true",
                        help="run the workspace evaluation per seed at the end")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; --device cpu runs on the CPU)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    from beso_tpu_torch.agents.beso_agent import BesoAgent
    from beso_tpu_torch.models.denoiser import GCDenoiser
    from beso_tpu_torch.scripts.training import build_agent_config, build_workspace
    from beso_tpu_torch.train.checkpoint import save_train_state
    from beso_tpu_torch.train.sweep import run_sweep, seed_state
    from beso_tpu_torch.utils.config import load_config, save_config

    device = torch.device(args.device)
    seeds = [int(s) for s in args.seeds.split(",")]
    cells = parse_grid(args.grid)
    root = Path(args.run_dir or Path("logs") / "sweeps" / time.strftime("%Y-%m-%d/%H-%M-%S"))
    root.mkdir(parents=True, exist_ok=True)
    summary = {}

    for cell in cells:
        name = cell_name(cell)
        cell_over = [f"{k}={v}" for k, v in cell.items()]
        cfg = load_config(args.config, list(args.overrides) + cell_over)
        logging.info("=== sweep cell %s: seeds %s ===", name, seeds)

        np.random.seed(seeds[0])
        workspace = build_workspace(cfg, device)
        # one agent per cell provides the model, optimizer and density; it
        # serves each seed's final evaluation
        agent = BesoAgent(build_agent_config(cfg), workspace.scaler, device=device)
        agent.init(torch.Generator().manual_seed(seeds[0]))

        test_batch = workspace.test_set.sample_batch(
            torch.Generator(device).manual_seed(1), min(cfg.get("test_batch_size", 1024), 256))
        ss, history = run_sweep(
            agent.build_model, agent.trainer.optimizer_factory, agent.sample_density,
            workspace.scaler, workspace.train_set, test_batch, seeds, device=device,
            sigma_data=cfg.get("sigma_data", 0.5),
            batch_size=cfg.get("train_batch_size", 1024),
            max_train_steps=cfg.get("max_train_steps", 1000),
            eval_every_n_steps=cfg.get("eval_every_n_steps", 500),
            use_ema=cfg.get("use_ema", True),
            num_sampling_steps=cfg.get("n_timesteps", 3),
            sigma_min=cfg.get("sigma_min", 0.005),
            sigma_max=cfg.get("sigma_max", 1.0),
            sampler_type=cfg.get("sampler_type", "ddim"),
            pred_last_action_only=cfg.get("pred_last_action_only", False),
            ema_decay=cfg.get("decay", 0.999),
            update_ema_every_n_steps=cfg.get("update_ema_every_n_steps", 1),
        )

        cell_summary = {"history": [(int(s), list(map(float, l)), list(map(float, m)))
                                    for s, l, m in history], "seeds": {}}
        for i, seed in enumerate(seeds):
            sdir = root / name / f"seed_{seed}"
            sdir.mkdir(parents=True, exist_ok=True)
            save_config({**cfg, "seed": seed}, sdir)
            state = seed_state(ss, i)
            save_train_state(state, sdir, "train_state")
            entry = {"final_loss": float(history[-1][1][i]),
                     "final_test_mse": float(history[-1][2][i])}
            if args.final_eval:
                # the agent serves seed i: its state and its model
                agent.state = state
                agent.denoiser = GCDenoiser(state.model, sigma_data=agent.denoiser.sigma_data)
                entry["eval"] = workspace.test_agent(
                    agent, evaluate_multigoal=cfg.get("evaluate_multigoal", True),
                    evaluate_sequential=cfg.get("evaluate_sequential", False),
                    generator=torch.Generator(device).manual_seed(seed + 2))
            cell_summary["seeds"][seed] = entry
        summary[name] = cell_summary
        (root / name / "summary.json").write_text(json.dumps(cell_summary, indent=2,
                                                             default=str))

    (root / "summary.json").write_text(json.dumps(summary, indent=2, default=str))
    logging.info("sweep complete: %s", root)
    return summary


if __name__ == "__main__":
    main()
