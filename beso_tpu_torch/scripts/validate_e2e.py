"""End-to-end validation of the state policies: oracle demos -> BESO
training -> simulated success (port of `scripts/validate_e2e.py`).

The public BESO datasets and checkpoints are not vendored, so the loop
closes inside the framework:
 1. synthesize demonstrations with the scripted oracle
    (`envs/block_push/oracle.py`, the reference's data-generating
    MultimodalOrientedPushOracle, or `envs/kitchen/oracle.py`),
 2. train the state DiffusionGPT on them (the reference's hyperparameters,
    a cut step budget by default),
 3. evaluate with the batched rollout under the reference protocol (result
    = |completed and expected| / 2), before training (the random-init
    baseline) and after, on the agent's "auto" engine.

A policy that imitates the oracle reaches a high result; the random-init
baseline sits near 0. Prints one JSON summary with the JAX script's keys.

Usage: python -m beso_tpu_torch.scripts.validate_e2e [--env kitchen]
       [--train-steps 10000] [--episodes 512] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import time

import torch


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--env", choices=["block_push", "kitchen"], default="block_push")
    parser.add_argument("--train-steps", type=int, default=10000)
    parser.add_argument("--episodes", type=int, default=512)
    parser.add_argument("--demo-steps", type=int, default=160)
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--eval-n-times", type=int, default=100)
    parser.add_argument("--eval-n-steps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=6)
    parser.add_argument("--robustness", action="store_true",
                        help="kitchen only: after training, re-evaluate under"
                             " +-20%% perturbed physics and report retention")
    parser.add_argument("--play-style", action="store_true",
                        help="draw per-episode execution styles for the demos"
                             " (approach angle, speed, detours, wandering,"
                             " pauses)")
    parser.add_argument("--lambda-sweep", action="store_true",
                        help="after training, evaluate the CFG guidance"
                             " sweep lambda in {0, 1, 1.5, 2, 2.5}")
    parser.add_argument("--kettle-boost", type=float, default=0.0,
                        help="kitchen only: probability of leading each demo"
                             " sequence with the kettle")
    parser.add_argument("--eval-nfe-sweep", action="store_true",
                        help="after training, evaluate ddim at NFE {3, 5, 8, 16}")
    parser.add_argument("--eval-kde-sweep", action="store_true",
                        help="after training, sweep KDE action-selection "
                             "width {8, 16, 32, 64} under euler churn 0.5")
    parser.add_argument("--eval-best-configs", action="store_true",
                        help="after training, also evaluate three eval configs"
                             " (euler+churn0.5, ddim+KDE-16, churn+KDE-16)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; --device cpu runs on the CPU)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    log = logging.getLogger("validate_e2e")

    from beso_tpu_torch.agents.beso_agent import BesoAgent, BesoAgentConfig
    from beso_tpu_torch.workspaces import BlockPushWorkspace, FrankaKitchenWorkspace

    device = torch.device(args.device)
    # the JAX script's five keys (demo, init, train, eval, baseline eval)
    # as five generators
    demo_seed, init_seed, train_seed, eval_seed, eval0_seed = (args.seed + i for i in range(5))

    t0 = time.time()
    log.info("generating %d oracle demonstrations...", args.episodes)
    if args.env == "block_push":
        from beso_tpu_torch.envs.block_push.oracle import generate_demonstrations

        data = generate_demonstrations(args.episodes, args.demo_steps,
                                       play_style=args.play_style,
                                       generator=_generator(device, demo_seed), device=device)
    else:
        from beso_tpu_torch.envs.kitchen.oracle import generate_kitchen_demonstrations

        data = generate_kitchen_demonstrations(
            args.episodes, max(args.demo_steps, 280), play_style=args.play_style,
            kettle_boost=args.kettle_boost, generator=_generator(device, demo_seed),
            device=device)
    log.info("demos done in %.1fs (success label count %.2f/ep)",
             time.time() - t0, float(data.onehot_goals.sum()) / args.episodes)

    if args.env == "block_push":
        ws = BlockPushWorkspace(seed=args.seed, data=data, eval_n_times=args.eval_n_times,
                                eval_n_steps=args.eval_n_steps or 300, device=device)
        cfg = BesoAgentConfig(
            obs_dim=10, action_dim=2, hidden_dim=240, n_layers=4, n_heads=12,
            goal_seq_len=1, window_size=5, attn_pdrop=0.05, resid_pdrop=0.05,
            cond_mask_prob=0.1, sigma_min=0.05, sigma_max=1.0,
            optimizer="adam", lr=1e-4, max_train_steps=args.train_steps,
            eval_every_n_steps=max(args.train_steps // 4, 1),
            train_batch_size=args.batch_size, cond_lambda=1.0,
            compute_dtype="bfloat16")
    else:
        ws = FrankaKitchenWorkspace(seed=42, data=data, eval_n_times=args.eval_n_times,
                                    eval_n_steps=args.eval_n_steps or 280, device=device)
        cfg = BesoAgentConfig(
            obs_dim=30, action_dim=9, hidden_dim=360, n_layers=6, n_heads=6,
            goal_seq_len=2, window_size=4, attn_pdrop=0.3, resid_pdrop=0.0,
            cond_mask_prob=0.1, sigma_min=0.005, sigma_max=1.0,
            optimizer="adamw", lr=1e-4, max_train_steps=args.train_steps,
            eval_every_n_steps=max(args.train_steps // 4, 1),
            train_batch_size=args.batch_size, cond_lambda=1.0,
            compute_dtype="bfloat16")
    agent = BesoAgent(cfg, ws.scaler, device=device)
    agent.init(torch.Generator().manual_seed(init_seed))

    def evaluate(seed: int, **kw) -> dict:
        return ws.test_agent(agent, generator=_generator(device, seed), log_metrics=False, **kw)

    baseline = evaluate(eval0_seed)
    log.info("random-init baseline: result %.3f reward %.3f",
             baseline["avrg_result"], baseline["avrg_reward"])

    t0 = time.time()
    agent.train_agent(ws.train_set, ws.test_set, _generator(device, train_seed))
    train_time = time.time() - t0
    log.info("training done in %.1fs (%.1f steps/s)", train_time,
             args.train_steps / train_time)

    trained = evaluate(eval_seed)
    summary = {
        "baseline_result": baseline["avrg_result"],
        "trained_result": trained["avrg_result"],
        "trained_reward": trained["avrg_reward"],
        "train_steps_per_sec": round(args.train_steps / train_time, 1),
        "improvement": round(trained["avrg_result"] - baseline["avrg_result"], 3),
        "success_rates": {k: trained[k] for k in trained if k.startswith("success_rate")},
    }

    if args.eval_best_configs:
        best = {}
        for label, kw in [
            ("euler_churn0.5", dict(new_sampler_type="euler", extra_args={"s_churn": 0.5})),
            ("ddim_kde16", dict(get_mean=16, aggregation="kde")),
            ("euler_churn0.5_kde16", dict(new_sampler_type="euler",
                                          extra_args={"s_churn": 0.5},
                                          get_mean=16, aggregation="kde")),
        ]:
            out = evaluate(eval_seed, **kw)
            best[label] = round(out["avrg_result"], 3)
            log.info("eval config %s: result %.3f", label, out["avrg_result"])
        summary["best_configs"] = best

    if args.eval_kde_sweep:
        kde = {}
        for n in (8, 16, 32, 64):
            out = evaluate(eval_seed, new_sampler_type="euler", extra_args={"s_churn": 0.5},
                           get_mean=n, aggregation="kde")
            kde[str(n)] = round(out["avrg_result"], 3)
            log.info("KDE %d (euler churn 0.5): result %.3f", n, out["avrg_result"])
        summary["kde_sweep"] = kde

    if args.eval_nfe_sweep:
        nfe = {}
        for n in (3, 5, 8, 16):
            out = evaluate(eval_seed, n_inference_steps=n)
            nfe[str(n)] = round(out["avrg_result"], 3)
            log.info("NFE %d: result %.3f", n, out["avrg_result"])
        summary["nfe_sweep"] = nfe

    if args.lambda_sweep:
        sweep = {}
        for lam in (0.0, 1.0, 1.5, 2.0, 2.5):
            out = evaluate(eval_seed, cond_lambda=lam)
            sweep[str(lam)] = round(out["avrg_result"], 3)
            log.info("lambda %.1f: result %.3f", lam, out["avrg_result"])
        summary["lambda_sweep"] = sweep

    if args.robustness and args.env == "kitchen":
        # train at the nominal constants, evaluate at +-20% gains and
        # contact radii, report the retention
        from beso_tpu_torch.envs.kitchen.env import perturb_kitchen_params

        nominal = trained["avrg_result"]
        rb = {}
        for label, gs, rs in [("gain-20", 0.8, 1.0), ("gain+20", 1.2, 1.0),
                              ("radius-20", 1.0, 0.8), ("radius+20", 1.0, 1.2)]:
            out = evaluate(eval_seed, physics_params=perturb_kitchen_params(
                gain_scale=gs, radius_scale=rs, device=device))
            rb[label] = {"result": round(out["avrg_result"], 3),
                         "retention": round(out["avrg_result"] / max(nominal, 1e-9), 3)}
            log.info("robustness %s: result %.3f (retention %.0f%%)", label,
                     out["avrg_result"], 100 * rb[label]["retention"])
        summary["robustness"] = rb

    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
