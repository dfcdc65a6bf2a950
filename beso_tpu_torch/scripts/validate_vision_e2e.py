"""End-to-end image-policy validation: camera renders -> conv encoder ->
VisionDiffusionGPT -> batched evaluation (port of
`scripts/validate_vision_e2e.py`).

Scripted-oracle demonstrations (low-dim observations), rendered on the fly
by the ray-cast cameras (`envs/block_push/camera.py`, the reference's
RealSense model, or `envs/kitchen/camera.py`) inside every train and
denoise call, a CoordConv + SpatialSoftArgmax encoder trained end to end
through the diffusion loss (optionally pretrained by state regression and
frozen), and the standard evaluation protocols on the plain forward (the
images rule out the prefix cache), all on the device.

Usage: python -m beso_tpu_torch.scripts.validate_vision_e2e [--env kitchen]
       [--train-steps 20000] [--goal-stack] [--device cpu]

Prints one JSON line: the result, the reward, train steps/s and the
parameter count (or, with --probe-only, the pretraining probe's RMSE).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import logging
import time

import numpy as np
import torch

from beso_tpu_torch.agents.policy import PolicyConfig
from beso_tpu_torch.core.densities import make_sample_density
from beso_tpu_torch.envs.block_push.goals import block_push_goal_frames
from beso_tpu_torch.envs.block_push.oracle import generate_demonstrations
from beso_tpu_torch.envs.kitchen.goals import multigoal_kitchen_goals
from beso_tpu_torch.envs.kitchen.oracle import generate_kitchen_demonstrations
from beso_tpu_torch.models.denoiser import GCDenoiser
from beso_tpu_torch.models.ema import ema_init
from beso_tpu_torch.models.pretrain import graft_encoder_params, pretrain_state_regression
from beso_tpu_torch.models.vision_policy import KitchenVisionPolicyGPT, VisionPolicyGPT
from beso_tpu_torch.rollout.rollout import rollout_block_push, rollout_kitchen
from beso_tpu_torch.train.trainer import Trainer, make_optimizer

# demonstration and evaluation episode lengths per env (the JAX script's)
DEMO_STEPS = {"block_push": 160, "kitchen": 280}
EVAL_STEPS = {"block_push": 300, "kitchen": 280}


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--env", choices=["block_push", "kitchen"], default="block_push")
    parser.add_argument("--train-steps", type=int, default=20000)
    parser.add_argument("--episodes", type=int, default=1024)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--eval-n-times", type=int, default=100)
    parser.add_argument("--seed", type=int, default=6)
    parser.add_argument("--img", type=int, default=128)
    parser.add_argument("--semantic", action="store_true",
                        help="per-object mask channels instead of RGB")
    parser.add_argument("--goal-stack", action="store_true",
                        help="block push: encode state+goal images jointly "
                             "as 6 stacked channels (spatially aligned "
                             "relational conditioning)")
    parser.add_argument("--pretrain-steps", type=int, default=0,
                        help="pretrain the conv encoder by state regression "
                             "from pixels before policy training (the "
                             "in-framework analogue of the reference's "
                             "precomputed pretrained embeddings)")
    parser.add_argument("--freeze-encoder", action="store_true",
                        help="stop gradients into the (pretrained) encoder "
                             "during policy training")
    parser.add_argument("--embed-size", type=int, default=48,
                        help="image embedding width")
    parser.add_argument("--probe-only", action="store_true",
                        help="run only the encoder state-regression "
                             "pretrain probe and print its per-dim RMSE")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; --device cpu runs on the CPU)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    log = logging.getLogger("validate_vision_e2e")
    from beso_tpu_torch.workspaces import BlockPushWorkspace, FrankaKitchenWorkspace

    device = torch.device(args.device)
    kitchen = args.env == "kitchen"
    t0 = time.time()
    demo_gen = _generator(device, args.seed)
    if kitchen:
        data = generate_kitchen_demonstrations(args.episodes, DEMO_STEPS["kitchen"],
                                               generator=demo_gen, device=device)
    else:
        data = generate_demonstrations(args.episodes, DEMO_STEPS["block_push"],
                                       generator=demo_gen, device=device)
    log.info("demos done in %.1fs", time.time() - t0)

    init_gen = _generator(device, args.seed + 1)
    if kitchen:
        # raw 30-dim observations (the renderer needs raw qpos); identity
        # scaling, as the state-policy kitchen path
        ws = FrankaKitchenWorkspace(seed=args.seed, data=data, eval_n_times=args.eval_n_times,
                                    eval_n_steps=EVAL_STEPS["kitchen"], device=device)
        scaler = ws.scaler
        model = KitchenVisionPolicyGPT(
            img_hw=(args.img, args.img), cond_mask_prob=0.1, embed_size=args.embed_size,
            freeze_encoder=args.freeze_encoder, dtype=torch.bfloat16,
            generator=init_gen, device=device)
    else:
        # full 16-dim observations (the renderer needs raw coordinates);
        # identity input scaling, min-max action scaling
        ws = BlockPushWorkspace(seed=args.seed, data=data, reduce_obs_dim=False,
                                eval_n_times=args.eval_n_times,
                                eval_n_steps=EVAL_STEPS["block_push"], device=device)
        scaler = dataclasses.replace(ws.scaler, x_mean=torch.zeros_like(ws.scaler.x_mean),
                                     x_std=torch.ones_like(ws.scaler.x_std))
        model = VisionPolicyGPT(
            action_dim=2, embed_dim=240, n_layers=4, n_heads=12, goal_seq_len=1,
            obs_seq_len=5, img_hw=(args.img, args.img), cond_mask_prob=0.1,
            semantic=args.semantic, goal_stack=args.goal_stack,
            embed_size=args.embed_size, freeze_encoder=args.freeze_encoder,
            dtype=torch.bfloat16, generator=init_gen, device=device)
    return _run(args, log, ws, scaler, GCDenoiser(model, sigma_data=0.5), kitchen, device)


def _block_push_target(b: torch.Tensor) -> torch.Tensor:
    """Symmetry-adapted regression targets: the square block renders alike
    under pi/2 rotation, so each yaw regresses as (cos 4y, sin 4y); the
    never-rendered effector target (8:10) and the zone yaws drop."""
    y1, y2 = 4.0 * b[..., 2:3], 4.0 * b[..., 5:6]
    return torch.cat([b[..., 0:2], torch.cos(y1), torch.sin(y1),
                      b[..., 3:5], torch.cos(y2), torch.sin(y2),
                      b[..., 6:8],                        # effector xy
                      b[..., 10:12], b[..., 13:15]], -1)  # zone centers


def _block_push_weight(b: torch.Tensor) -> torch.Tensor:
    """Per-row weights of those targets: out-of-frame dims (the 10.0 far
    sentinel of goal rows) masked."""
    vis = (torch.abs(b) < 5.0).float()
    ones = torch.ones_like(b[..., 0:1]).expand(*b.shape[:-1], 8)
    return torch.cat([ones, vis[..., 6:8], vis[..., 10:12], vis[..., 13:15]], -1)


def _pretrain_encoder(args, log, ws, model, kitchen, device):
    """State-regression pretraining of the policy's conv encoder
    (models/pretrain.py). Returns (encoder state dict, info)."""
    obs, lens = ws.full_data.observations, ws.full_data.lengths
    pool = np.concatenate([obs[i, :lens[i]] for i in range(obs.shape[0])])
    target_fn = weight_fn = jitter_std = None
    std_floor = 1e-3
    if not kitchen:
        # jitter scale from the demo rows only (the 10.0 far sentinel of the
        # goal rows would inflate it); normalization floor at 1 cm
        jitter_std = 0.1 * np.maximum(pool.std(axis=0), 1e-3)
        std_floor = 0.01
        # the encoder also sees goal pictures: blocks kept, the rest far away
        goal_rows = np.concatenate(
            [pool[:, :6], np.full((pool.shape[0], 10), 10.0, np.float32)], 1)
        pool = np.concatenate([pool, goal_rows])
        target_fn, weight_fn = _block_push_target, _block_push_weight

    rng = np.random.default_rng(args.seed)
    pool = pool[rng.permutation(pool.shape[0])[:200_000]]

    t0 = time.time()
    enc_state, info = pretrain_state_regression(
        _generator(device, args.seed + 2), pool, model.render,
        embed_size=model.embed_size, features=model.enc_features, dtype=model.dtype,
        steps=args.pretrain_steps, batch_size=args.batch_size, target_fn=target_fn,
        weight_fn=weight_fn, std_floor=std_floor, jitter_std=jitter_std, device=device)
    log.info("encoder pretraining: %d steps in %.1fs, loss %.4f -> %.4f, "
             "state RMSE (orig units) mean %.4f", args.pretrain_steps, time.time() - t0,
             info["first_loss"], info["final_loss"], info["rmse_mean"])
    log.info("per-dim RMSE: %s", np.array2string(info["rmse_per_dim"], precision=3))
    return enc_state, info


def _run(args, log, ws, scaler, den, kitchen, device):
    model = den.inner_model
    sigma_min = 0.005 if kitchen else 0.05
    trainer = Trainer(
        denoiser=den,
        optimizer_factory=functools.partial(make_optimizer, name="adam", lr=1e-4,
                                            weight_decay=0.0),
        sample_density=make_sample_density("loglogistic", sigma_data=0.5,
                                           sigma_min=sigma_min, sigma_max=1.0),
        scaler=scaler, max_train_steps=args.train_steps,
        eval_every_n_steps=max(args.train_steps // 4, 1),
        num_sampling_steps=3, sigma_min=sigma_min, sigma_max=1.0)
    ts = trainer.init_state()
    n_params = sum(p.numel() for p in model.parameters())
    log.info("vision policy: %d params", n_params)

    if args.probe_only:
        if args.pretrain_steps <= 0:
            raise SystemExit("--probe-only needs --pretrain-steps > 0")
        _, info = _pretrain_encoder(args, log, ws, model, kitchen, device)
        out = {"env": args.env, "img": int(args.img), "probe_only": True,
               "pretrain_steps": int(args.pretrain_steps),
               "pretrain_rmse_mean": round(info["rmse_mean"], 4),
               "rmse_per_dim": [round(float(v), 4) for v in info["rmse_per_dim"]]}
        print(json.dumps(out))
        return out

    pretrain_info = None
    if args.pretrain_steps > 0:
        if args.goal_stack:
            raise SystemExit("--pretrain-steps does not support --goal-stack "
                             "(the stacked encoder takes 6 channels)")
        enc_state, pretrain_info = _pretrain_encoder(args, log, ws, model, kitchen, device)
        graft_encoder_params(model, enc_state)
        ts.ema = ema_init(model.named_parameters())

    t0 = time.time()
    ts = trainer.train(ts, ws.train_set,
                       lambda: [ws.test_set.sample_batch(_generator(device, 123), 512)],
                       _generator(device, args.seed + 3), batch_size=args.batch_size)
    train_time = time.time() - t0
    log.info("training done in %.1fs (%.1f steps/s)", train_time,
             args.train_steps / train_time)

    # evaluation: the standard protocol on the plain forward with the EMA
    # weights (images rule out the prefix cache), raw observations
    params = trainer.eval_params(ts)

    def denoise(s, a, g, sig):
        return den(s, a, g, sig, params=params)

    eval_gen = _generator(device, args.seed + 4)
    if kitchen:
        cfg = PolicyConfig(window_size=4, obs_dim=30, action_dim=9, num_sampling_steps=3,
                           sigma_min=sigma_min, sampler_type="ddim")
        goals, expected = multigoal_kitchen_goals(ws.full_data, ws.goal_seq_len,
                                                  args.eval_n_times, ws.seed,
                                                  ws.train_fraction)
        metrics = rollout_kitchen(denoise, scaler, cfg, torch.as_tensor(goals, device=device),
                                  torch.as_tensor(expected, device=device), eval_gen,
                                  n_steps=EVAL_STEPS["kitchen"])
    else:
        cfg = PolicyConfig(window_size=5, obs_dim=16, action_dim=2, num_sampling_steps=3,
                           sigma_min=sigma_min, sampler_type="ddim")
        goal_frames, expected = block_push_goal_frames(ws.full_data, args.eval_n_times,
                                                       args.seed, ws.train_fraction)
        metrics = rollout_block_push(denoise, scaler, cfg,
                                     torch.as_tensor(goal_frames, device=device),
                                     torch.as_tensor(expected, device=device), eval_gen,
                                     n_steps=EVAL_STEPS["block_push"], reduce_obs_dim=False)
    result = float(metrics.results.float().mean())
    reward = float(metrics.rewards.float().mean())
    out = {"env": args.env, "semantic": bool(args.semantic),
           "goal_stack": bool(args.goal_stack),
           "pretrain_steps": int(args.pretrain_steps),
           "freeze_encoder": bool(args.freeze_encoder),
           "embed_size": int(args.embed_size),
           "vision_result": round(result, 3), "vision_reward": round(reward, 3),
           "train_steps_per_sec": round(args.train_steps / train_time, 1),
           "params": int(n_params)}
    if pretrain_info is not None:
        out["pretrain_rmse_mean"] = round(pretrain_info["rmse_mean"], 4)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
