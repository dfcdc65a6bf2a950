#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`beso_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA card, the CUDA toolkit's
`nvcc` (the kernels are built here from `beso_tpu_torch/csrc/` on first use,
into `build/`) and no network; it imports no JAX. Phases, each of which
exits non-zero on failure:

0. device: name and power limit (nvidia-smi), torch/CUDA versions, TF32 off;
1. build: compile the kernel library for sm_90a, print seconds, ptxas's
   registers, stack and spill bytes per kernel (each bf16 flash kernel at
   tile width 64, and the nine width-128
   `wgmma` instantiations of flash_attention_wide.cu, all of which must be
   there; no bf16 flash kernel may spill, flash_attention.cu must build no
   f32 forward, and the bf16 width-128 dQ and dK/dV kernels must have
   HGMMA instructions; the f32 width-64 forward, dQ and dK/dV kernels of
   flash_attention_f32.cu, each in its bulk-copy and its `cp.async` form,
   must all be there, none may spill and each must have HGMMA
   instructions) and, from cuobjdump -sass,
   the HGMMA (wgmma)
   instructions of each of the five instantiations of the bf16 and of the
   f32 fused-layer kernel (tanh: B2's group, the single layer, the timed
   one; erf: the group, the single layer), none of which may have none,
   with each f32 instantiation's registers and spill bytes;
2. kernel: `fused_layer_prefix` (CUDA) against its plain PyTorch version at
   the kitchen (D=360, H=6, P=3, 2T=8) and block-push (D=240, H=12, hd=20,
   P=2, 2T=10) shapes, epilogue on and off, every sigma row, each with a
   ragged last tile; max |diff| must stay within 2^-5 of max |ref| in bf16,
   then 2^-12 in f32, in f32 also at batches whose odd tile count leaves
   the last 2-block cluster's second block empty (1985 kitchen, 1995
   block-push envs); prints the f32 kernel's rows per block and cluster
   size. Times both dtypes at the kitchen serving shape with CUDA events
   (f32 beside the f32 torch.matmul time of its four products, TF32 off),
   and runs B1's phase clock there in both dtypes
   (`fused_layer_prefix_timed`, which must equal B1 bit for bit): each
   phase's mean clock64() cycles per 64-row block and its share (f32 with
   the cycles spent on the weight ring, held apart); f32 also at the
   block-push serving shape (2048 rows x 10 tokens, D=240, 12 heads, P=2):
   time, plain time, torch.matmul time, bound and phase clock;
3. engine: the `fused_cached` engine against the plain `cached` engine on
   the same inputs at every grid sigma, for a bf16 kitchen model (2^-5) and
   an f32 one (2^-10);
4. main path, serving: a 1024-env x 280-step kitchen rollout with the
   shipped kitchen serving config on the `fused_cached` engine in bf16; the
   kernel's launch counter must move by exactly 280 steps x 3 NFE x 6
   layers, the kitchen step kernel's by exactly 280, every metric must be
   finite; [4b] the kitchen step kernel (`csrc/kitchen_step.cu`) against
   the eager step `_kitchen_step_eager` on the same inputs: the states this
   rollout and a 100-env x 280-step one (the benchmark cells' envs) hand
   the physics at steps 0, 1, 140 and 279, floats within 1e-6, flags and
   completion steps equal; both timed per step with CUDA events at 100 and
   1024 envs, beside a bound from the bytes the kernel moves and the
   card's per-launch floor (a one-element add, timed the same way);
5. flash kernels: the forward (B5) and the backward (B6: the dQ kernel,
   which also computes delta = rowsum(dO * O), and the dK/dV kernel)
   against their plain PyTorch versions, o, lse, dq, delta, dk and dv each
   within 2^-5 of max |ref| in bf16, then the same in f32 within 2^-12, at
   the chunked training shape [256, 6, 131, 60], at ragged small shapes
   ([3, 2, 77, 20]; T 16, 63, 65 and 144 at hd 60; T 64 at hd 20; T 65
   and 131 at hd 18; hd 15: the f32 width-64 kernels' ragged and whole
   tiles in their bulk-copy and `cp.async` forms), each of these causal
   and full, and at the width-128 shapes [2, 4, 131, 128] causal,
   [2, 2, 77, 96] full, [2, 3, 131, 120] causal, [2, 2, 65, 100] causal (rows
   not 16-byte aligned), [2, 2, 16, 72] full, and the timed width-128 shapes
   [256, 3, 131, 120] and [256, 3, 131, 128] causal (the 3-head model's
   grid, with blocks sharing SMs); a second launch of each
   kernel must be bit-equal to
   the first; prints the three kernels' resident blocks per SM in both
   instantiations at both widths; one f32 forward at the chunked shape
   must run exactly one device kernel, flash_attention_f32.cu's
   `flash_fwd_f32_kernel`, and the autograd backward exactly
   two device kernels, the dQ and the dK/dV kernel, at the chunked shape
   in bf16 and in f32 (flash_attention_f32.cu's `wgmma` kernels) and at
   the 3-head model's hd 120 (torch.profiler; "not measured" if it sees no
   kernel). Times each kernel, the backward total
   (dQ with delta + dK/dV) and forward + backward against the plain
   versions at the chunked shape, and each kernel at [256, 3, 131, 128]
   (width 128) and at the 3-head model's [256, 3, 131, 120], with CUDA
   events, in bf16 and in f32, and, as their yardstick,
   F.scaled_dot_product_attention's forward and backward in the same dtype
   at the same shape with the attention kernels it ran;
6. model: the chunked kitchen model (`configs/franka_kitchen_chunked.yaml`,
   full width) from one seeded state: loss and every parameter's gradient
   with attention="pallas" (the flash kernels) against
   attention="broadcast" (plain PyTorch) on the same batch, sigma, noise
   and goal mask, in bf16, then in f32 (loss within 2^-12, every gradient
   within 2^-10 of its max |ref|), exactly 6 launches of each kernel; then
   the same model at 3 heads (hd 120: the width-128 instantiations);
7. main path, training: `BesoAgent.train_agent` on the chunked config for
   TRAIN_STEPS steps at batch 256 with a test-set evaluation every
   EVAL_EVERY steps; the flash launch counters must move by exactly 6 per
   step (each kernel) plus 6 x 3 NFE per evaluation batch (forward), every
   loss and test MSE must be finite. Prints train steps/s and peak memory
   (informational); then WIDE_TRAIN_STEPS steps of the same config at 3
   heads (hd 120: the width-128 kernels), with the same exact launch counts,
   and its train steps/s (informational);
8. fused-layer kernels B2, B3 and B4 against their plain PyTorch versions,
   each within 2^-5 of max |ref| in bf16 and 2^-12 in f32: B4
   (`fused_layer`, whole causal sequence) at the kitchen (11 tokens, 2047
   envs) and block-push (12 tokens, 2001 envs) shapes; B3
   (`fused_layer_with_prefix`) at the kitchen (P=3, 2T=8) and block-push
   (P=2, 2T=10) shapes, and bit-equal to B1 on the same row; B2
   (`fused_layers_prefix_group`) with groups of 2 and 4 layers, epilogue on
   and off, and bit-equal to the chain of B1 launches; in f32 also B4 at
   2041 envs, B3 and B2 at 1985 (the last cluster's second block empty).
   Times B4 at 2048 x 11, B3 at 2048 x 8 and B2 (group 2) against two B1
   launches and against the plain versions, with CUDA events, and each
   form's four products as torch.matmul in the same dtype (information
   only);
9. engines: `make_fused_denoise_fn` (B4) against the plain `GCDenoiser`
   forward at the three grid sigmas and one off-grid sigma, with and
   without zeroed (uncond) goals, linear and MLP heads; the `fused_cached`
   engine with `token_lanes=False` (B3) and with `layer_group` 2 and 4 (B2)
   against the default `fused_cached` engine (B1) at every grid sigma; in
   bf16 (2^-5), then in f32 (2^-10);
10. main paths of the other engine forms: 1024-env x ROLLOUT_STEPS-step
   kitchen rollouts with lambda=1.5 CFG (2048 rows per call), the launch
   counters exact: (a) `fused_cached` with BESO_LAYER_GROUP=2, 3 B2
   launches per call and no B1; (b) `fused_cached` with token_lanes=False,
   6 B3 launches per call; (c) `make_fused_denoise_fn` as the rollout's
   denoise fn, 6 B4 launches per call; each for the bf16 and the f32
   kitchen model. Every metric finite; env-steps/s printed (informational);
11. main path, the shipped kitchen config as shipped (f32): relay-kitchen
   files written by `export_relay_kitchen` from synthetic trajectories,
   loaded by `FrankaKitchenWorkspace(data_path=...)`, an f32 `BesoAgent`
   trained MAIN_TRAIN_STEPS steps at batch 1024, then the workspace's
   1024-env x 280-step multigoal evaluation on the agent's `fused_cached`
   engine: exactly 280 x 3 x 6 f32 B1 launches and no other fused-layer
   launch, every metric finite, env-steps/s printed (informational);
12. main path, the shipped block-push config as shipped (f32,
   `configs/block_push.yaml`: 4 layers x 240 x 12 heads, window 5, one goal
   token, the min-max scaler, lambda=2 CFG): multimodal-push files written
   by `export_multimodal_push` from synthetic trajectories, loaded by
   `BlockPushWorkspace(data_path=...)`, `block_push_step` on the card
   against the CPU (256 envs x 3 steps pushing a block, the dither hash
   replaced on both sides by a smooth stand-in: positions within 1e-5),
   the shipped dither hash on the card against the CPU (within 5e-4 where
   its product is one multiply), every MuJoCo golden band of
   tests/test_block_push_fidelity.py on the card with the shipped hash,
   an f32 `BesoAgent` trained
   MAIN_TRAIN_STEPS steps at batch 1024 (adam), its EMA model's
   `fused_cached` engine against the plain `cached` one at every grid sigma
   (2^-10), then the workspace's 1024-env x 100-step evaluation (300 cut
   to 100) on `fused_cached`: exactly 100 x 3 x 4 f32 B1 launches and no other
   fused-layer launch, every metric finite, env-steps/s printed; then a
   30-step evaluation with a host clock around each physics step (after a
   device sync): the physics' share of the wall time. Prints one JSON line
   with f32 B1's numbers at this shape (phase 2's times, its bound, the
   launches) (informational);
13. the reference-checkpoint model and the evaluation CLI: (a) the erf GELU
   form (`approximate_gelu=False`) of B1 (every sigma row, epilogue on), B2
   (a group of 2), B3 and B4 at the kitchen shape (D=360, 6 heads, 2048 CFG
   rows) against their plain versions, within 2^-5 of max |ref| in bf16 and
   2^-12 in f32, each bit-equal on a second launch, B3 and B2 bit-equal to
   erf B1 launches; erf B1 timed beside tanh B1 on the same inputs in both
   dtypes; (b) an f32 and a bf16 kitchen `DiffusionGPT(approximate_gelu=
   False)` written to a reference-keyed .pth by `export_torch_state_dict`
   and read back by `load_torch_checkpoint` (every tensor bit-equal), its
   `fused_cached` engine against `cached` at the three grid sigmas (2^-5
   bf16, 2^-10 f32) and its uncached engine (erf B4) against the plain
   forward, then a 1024-env x 40-step kitchen rollout on it: exactly 40 x 3
   x 6 erf B1 launches and no other fused-layer launch, every metric finite;
   (c) the training CLI on the shipped kitchen config for 20 steps (phase
   11's files; its final evaluation cut to 8 envs x 3 steps), then
   `beso_tpu_torch.scripts.evaluate` with `configs/evaluate_kitchen.yaml` as
   shipped (100 runs x 280 steps) and its CFG study at 5 lambdas x 40 steps;
   the same for `configs/block_push.yaml` (phase 12's files) and
   `configs/evaluate_blocks.yaml` (100 runs, 300 steps cut to 50; its CFG
   study at 10 steps): the agent's "auto" engine,
   the plain cached one, so no fused-layer launch; env-steps/s over each
   command's wall time and finite metrics printed;
14. every sampler, the mean and KDE action selection and the sequential
   kitchen evaluation, on phase 11's f32 `fused_cached` agent (EMA
   weights), through the engines it serves the workspaces with (its
   per-episode factory: B1 where the prefix cache serves the config, B4
   where it does not; its uncached engine: B4): (a) a W+1-step
   `policy_predict` window, 1024 envs, lambda=1.5 CFG, for every name in
   `SAMPLERS` and Picard on B4 against the plain forward (the same
   generator seed, 2^-10 of max |ref|), the grid samplers (ddim, euler,
   dpmpp_2m, lms) also on B1 against `cached`, every engine's launches
   exactly 6 per denoiser call (calls counted by wrapping the denoise fn),
   and dpm_adaptive's accepted and rejected steps equal on B4 and the
   plain forward; (b) 4 action samples per env with the mean and the KDE
   aggregation on B4 (8192 rows per call): the first step against the
   plain forward (mean: the actions; KDE: the candidates, and B4's pick a
   maximum of the plain candidates' density), then the workspace's
   multigoal evaluation with those overrides, 1024 envs x 40 steps, exact
   launch counts; (c) the workspace's sequential evaluation
   (`test_agent(evaluate_sequential=True)`), 1024 envs x 280 steps on B4,
   exact launch counts; (d) the scripted `kitchen_step` episodes of
   tests/kitchen_scenarios.py (microwave drags, kettle grasps, tracking,
   release) replayed on the card against the CPU (1e-5), and their MuJoCo
   golden bands held on the card's outcome; (e) the evaluation CLI's
   `test_all_samplers` and `compare_noisy_sampler` modes on
   `configs/evaluate_kitchen.yaml` and phase 13c's run (100 runs, 20 steps
   cut from 280) with `inference_engine=fused_cached`: exactly 6 B1 or B4
   launches per denoiser call, both kernels launched, the command's
   seconds; (f) `bench_picard` at
   BESO scale (window 4, batch 4, 50 NFE), information only;
15. the vision path, at the scripts' widths (no kernel on it: the vision
   models run the plain forward, as the JAX package's do): (a)
   `generate_demos` through its CLI on the card, 1024 episodes of block
   push (160 steps) and of kitchen (280 steps): the files read back by the
   port's loaders equal the oracle's rollout, and the JAX tests' bands hold
   on the card's outcome (tests/test_oracle.py: both blocks done in >= 90%
   of the episodes, >= 1.5 labels per episode, actions within the cap;
   tests/test_kitchen_oracle.py: >= 3.8 of 4 assigned tasks); seconds and
   env-steps/s of each command; (b) both cameras at 128 x 128 on 1024 demo
   frames (block push RGB and masks, kitchen RGB), the card against the
   port's CPU render of the same observations: all but 0.5% of the pixels
   within 1e-5; ms per 1536-frame batch (one batch-256 train step's frames)
   and its peak memory; (c) both vision policies at full width, batch 64 of
   demo windows: the f32 loss and every gradient on the card against the
   CPU with the same weights, sigma and noise (both encode the CPU's
   renders), within 2^-10 of max |ref|; the bf16 forward against the f32
   one (2^-5); (d) `validate_vision_e2e` through its CLI (128 px, batch
   256, embed 48, 1024 episodes, bf16), block push (demos of 80 steps, 160
   cut) with 50 pretraining steps, then kitchen, train steps cut from
   20,000 to 200 and the 100-env evaluation from 300 / 280 steps to 30:
   the JSON line parses and is
   finite; train steps/s, peak memory, demo seconds, evaluation
   env-steps/s; (e) torch.profiler over three block-push vision train steps
   at batch 256: device time by kernel family and the idle share
   (information).

16. the training tools: (a) B5 and B6 under `torch.func.vmap` over a
   leading seed axis (the seed sweep's rule), bf16 at [4, 256, 6, 131, 60]
   and [2, 256, 3, 131, 120]: forward and backward bit-equal to one launch
   on the folded [S*B, H, T, hd] tensors and exactly one launch of each
   kernel per call (the backward outside the map and inside it), the
   folded launches within 2^-5 of max |ref| of the plain versions; (b)
   `scripts/sweep.py` on configs/franka_kitchen_chunked.yaml, seeds 1-4 at
   batch 256 for 40 steps (40,000 cut) with an evaluation every 20: exactly
   6 launches of each flash kernel per step for all seeds together plus 6 x
   3 NFE B5 per evaluation, every loss finite, the seeds' losses different,
   seed 1's per-step losses within 2^-8 of a run of its own on its draws,
   train steps/s beside a 1-seed sweep's; (c) the sweep on
   configs/franka_kitchen.yaml (f32, batch 1024, phase 11's files) with 1
   and 8 seeds for 20 steps, per-seed steps/s, and one seed's run dir
   through `scripts/evaluate.py` with configs/evaluate_kitchen.yaml as
   shipped; (d) `scripts/validate_e2e.py`, kitchen with --robustness
   --lambda-sweep, then block push with 40 demo steps (160 cut), 200 train
   steps (10,000 cut), a 100 x 30 evaluation (280 / 300 cut): finite
   summaries with their keys; (e) `scripts/profile_train.py`: the device
   time of 50 fused train steps of the kitchen model at batch 1024 by
   kernel category and the idle share, then a --scaling grid (information).
17. the multi-device layer on `torch.distributed`, in spawned ranks (each
   with a time limit on its rendezvous, its collectives and the whole; a
   failed or hung rank fails the phase): one NCCL rank (W=1; one card,
   and NCCL refuses two ranks on one device), then two gloo ranks that
   share the card (W=2; their sums and gathers go through the host). (a)
   `rollout_kitchen_sharded` at the shipped kitchen width, 1024 envs x 40
   steps (280 cut) on `fused_cached`, bf16 and f32: the gathered metrics
   bit-equal to one process's rollouts of each shard on its generator,
   each rank's B1 launches exactly 40 x 3 NFE x 6 layers, env-steps/s at
   W=1 and W=2 (information; the two ranks share one card); (b)
   `rollout_block_push_sharded` at the shipped block-push width (f32 B1 at
   its shape), 1024 envs x 10 steps (300 cut) over W=2: bit-equal to the
   shards' single-process rollouts, 10 x 3 x 4 B1 launches per rank; (c)
   one train step of the chunked config (bf16, batch 256) at dp=2 and at
   dp=1 x tp=2 (3 heads per rank) against one process's: loss within 2^-8,
   every gradient within 2^-5 of its max |ref|, exactly 6 launches of each
   flash kernel per rank; then `dryrun_body` on the NCCL rank (cuda); (d)
   `shard_sweep_state`, seeds 1-4 of the chunked config over the 2 ranks,
   4 steps at batch 64, each seed's losses within 2^-8 of the one-process
   sweep's (bit-equality printed); (e) every registry id stepped on the
   card against the CPU (1e-5 (1 + |cpu|); the single-block ids placed for
   contact, each step from the CPU's state), xArm FK on the card against the CPU and IK
   on the card to under 1e-3, a CUDA env state saved and loaded, and the
   native loader's batches streamed to the card equal to its host batches.
18. the last ported pieces: (a) `classifier_guided_denoise_fn` (a seeded
   two-layer tanh guide, lambda 2) around the f32 kitchen model's
   `fused_cached` engine (B1) against the same guide around the plain
   `cached` engine, a W+1-step policy window of 1024 envs (lambda 1.5 CFG)
   inside `torch.inference_mode`, within 2^-10 of max |ref| with exactly 6
   B1 launches per denoiser call, then a guided 1024-env x 20-step rollout
   (280 cut): exactly 20 x 3 x 6 f32 B1 launches, finite metrics,
   env-steps/s; (b) `utils.metrics.profile_trace` around 5 fused train steps
   of phase 7's chunked model at batch 256 inside a `step_timer` writing to
   a `MetricsWriter`: the exported Chrome trace names the B5 and both B6
   kernels, exactly 6 launches of each per step, the timer's record read
   back; (c) `scripts/profile_train.py --scaling --configs 1024:20` without
   and with --mu-bf16: f32, then bf16 first moments, finite losses, both
   runs' steps/s (information); (d) `scripts/calibrate_block_push.py`'s
   rot-sweep scoring of the shipped (mu 0.05, arm 1.0, leak 0) and one
   other combination on the card against tests/golden/: the shipped one's
   stable-5 mean position and yaw RMSE within 1 mm and 1 degree of the
   CPU's, every swept constant restored (a fixed `block_push_step`
   bit-equal before and after), `friction_k2=FRICTION_K2` bit-equal to the
   default step.

The second-to-last line is the kernels' JSON record (per kernel its
launches on its main path, max |diff|, ms, plain ms, the roofline bound
of its work at the timed shape with what bounds it (f32 B1 and B4 with
phase 14's launches added, B1 with phase 17a/b's, f32 B1 with phase 18a's and
the bf16 flash kernels with phase 16b's, 17c's and 18b's, each path apart in
`launches_by_path`), the PyTorch library
call's ms where one computes the same function, and for the fused layers
the torch.matmul ms of their products in the same dtype; f32 forms as
`*_f32`, the flash kernels' width-128 instantiations as `*_hd128`, B1's
erf GELU form as `fused_layer_prefix_erf` and `fused_layer_prefix_f32_erf`);
the last line `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

N_ENVS, N_STEPS, NFE, N_LAYERS = 1024, 280, 3, 6
ROLLOUT_STEPS = 40    # phase 10's rollouts of the other engine forms (280 cut to 40)
ERR_FRACTION = 2.0 ** -5   # kernel and engine bound: fraction of max |ref|
# phase 4b: the benchmark cells' envs, the episode steps whose physics
# inputs are recorded, and the kitchen step kernel's limit against the
# eager step on the card
KS_CELL_ENVS, KS_RECORD_STEPS, KS_LIMIT = 100, (0, 1, 140, 279), 1e-6
F32_FRACTION = 2.0 ** -12  # the same for the kernels' f32 forms
# the f32 fused engines against the plain f32 engines: six f32 layers (each
# within ~2^-16 relative per product) and the preconditioning around them
F32_ENGINE_FRACTION = 2.0 ** -10
TRAIN_STEPS, EVAL_EVERY, TRAIN_BATCH = 240, 80, 256
CHUNKED_SHAPE = (256, 6, 131, 60)   # [B, H, T, hd] of the chunked train step
WIDE_SHAPE = (256, 3, 131, 128)     # the flash kernels' width-128 instantiations, timed
WIDE_HEADS = 3   # the chunked model at 3 heads: hd 120, the width-128 instantiations
WIDE_MODEL_SHAPE = (256, WIDE_HEADS, 131, 120)   # its attention shape, also timed
WIDE_TRAIN_STEPS = 40   # phase 7's timed train run of the 3-head model
MAIN_TRAIN_STEPS = 20   # phase 11's, 12's and 13c's train steps before the evaluation
MS_STEPS, N_SAMPLES = 40, 4   # phase 14b's mean / KDE rollouts (280 cut to 40), samples
CLI_STEPS = 20          # phase 14e's CLI studies (num_steps_per_run: 280, cut to 20)
ERF_ROLLOUT_STEPS = 40  # phase 13b's rollout of the erf model (280 cut to 40)
# block push: phase 12's evaluation steps (eval_n_steps: 300, configs/block_push.yaml:62,
# cut to 100 since phase 13 came, to hold the run near half its time limit), layers
BP_STEPS, BP_LAYERS = 100, 4
BP_PHYSICS_STEPS = 30   # phase 12's second, instrumented evaluation (300 cut to 30)
# phase 13c's block-push evaluation CLI, cut to hold the cold run near
# 1,000 s: evaluate_blocks.yaml's num_steps_per_run 300 cut to 100 and its
# CFG study's 40 steps to 20 when phase 15 came, to 50 and 10 when phase 17
# came; the kitchen one stays as shipped
CLI_BP_STEPS, CLI_CFG_STEPS = 50, {"kitchen": 40, "block_push": 10}
# phase 15, the vision path: generate_demos at validate_vision_e2e's 1024
# episodes (--episodes; each env's default --steps, 160 and 280), the
# cameras held on RENDER_FRAMES frames and timed on one batch-256 train
# step's frames, 256 x (5 + 1), the vision gradients at VISION_GRAD_BATCH,
# and validate_vision_e2e at its own widths with its step counts cut
DEMO_EPISODES = 1024
RENDER_FRAMES, RENDER_BATCH, VISION_GRAD_BATCH = 1024, 1536, 64
VISION_PROFILE_BATCH = 256   # 15e: the script's --batch-size
VISION_TRAIN_STEPS = 200     # --train-steps: 20,000, cut to 200
VISION_EVAL_STEPS = 30       # its evaluation: 300 (block push) and 280 (kitchen) steps, cut to 30
VISION_BP_DEMO_STEPS = 80    # its block-push demos: 160 steps, cut to 80 (eager physics)
VISION_PRETRAIN_STEPS = 50   # --pretrain-steps of the block-push run
PIXEL_TOL, PIXEL_SHARE = 1e-5, 0.005   # images: all but 0.5% of pixels within 1e-5
# phase 16, the training tools: B5/B6 under a seed axis [S, B, H, T, hd]
# (the chunked shape at 4 seeds, the 3-head model's at 2); the sweeps'
# seeds and step counts (max_train_steps: 40,000 in both kitchen configs,
# eval_every_n_steps: 4,000, cut); validate_e2e's train steps (--train-steps:
# 10,000, cut), evaluation steps (--eval-n-steps: 280 kitchen, 300 block
# push, cut) and block-push demo steps (--demo-steps: 160, cut to 80, and to
# 40 when phase 17 came: its eager physics takes ~0.3 s per step; the
# evaluation steps of 15d and 16d from 60 to 30, and 15d's block-push demo
# steps from 160 to 80, when phase 18 came);
# profile_train's --scaling grid; the steps
# of each profiled sweep call in 16b (information, no shipped value)
SEED_AXIS_SHAPES = ((4, *CHUNKED_SHAPE), (2, *WIDE_MODEL_SHAPE))
SEED_AXIS_REPS = 21
SWEEP_SEEDS, SWEEP_STEPS, SWEEP_EVAL_EVERY = (1, 2, 3, 4), 40, 20
KITCHEN_SWEEP_SEEDS, KITCHEN_SWEEP_STEPS = 8, 20
E2E_TRAIN_STEPS, E2E_EVAL_STEPS, E2E_BP_DEMO_STEPS = 200, 30, 40
PROFILE_SCALING = "1024:50,2048:25"
SWEEP_PROFILE_STEPS = 10
VISION_GRAD_FRACTION = 2.0 ** -10      # the f32 vision loss and gradients, card vs CPU
# a serving layer's (D, heads, prefix tokens P, suffix tokens 2T)
KITCHEN_LAYER = (360, 6, 3, 8)      # sigma + 2 goal tokens, window 4
BLOCK_PUSH_LAYER = (240, 12, 2, 10)  # sigma + 1 goal token, window 5; hd 20
# model-level bounds, flash kernels vs broadcast in bf16 (phase 6): the two
# forms round the probabilities to bf16 at different points (after the
# normalisation in the broadcast form, before it in the online softmax), so
# they agree to bf16 rounding carried through 6 layers, not exactly. On an
# H100 the loss agreed to 4e-5 and the worst gradient tensor to 1% of its
# max |ref|.
MODEL_LOSS_FRACTION = 2.0 ** -8
MODEL_GRAD_FRACTION = 2.0 ** -5
# in f32 both forms compute in f32 and differ in summation order only
MODEL_LOSS_FRACTION_F32 = 2.0 ** -12
MODEL_GRAD_FRACTION_F32 = 2.0 ** -10
FLASH_SHAPES = ((CHUNKED_SHAPE, True), ((3, 2, 77, 20), True), ((3, 2, 77, 20), False),
                *(((2, 3, T, hd), causal) for T, hd in ((16, 60), (144, 60), (131, 18),
                                                         (63, 60), (65, 60), (65, 18),
                                                         (64, 20))
                  for causal in (True, False)),
                ((2, 2, 50, 15), False), ((2, 2, 50, 15), True), (CHUNKED_SHAPE, False),
                ((2, 4, 131, 128), True), ((2, 2, 77, 96), False),
                ((2, 3, 131, 120), True), ((2, 2, 65, 100), True), ((2, 2, 16, 72), False),
                (WIDE_MODEL_SHAPE, True), (WIDE_SHAPE, True))
# phase 17, the multi-device layer: 17a's kitchen rollouts (280 steps cut
# to 40) and 17b's block-push rollout (300 cut to 10) at N_ENVS envs over
# all ranks; 17c's one train step of the chunked config at TRAIN_BATCH;
# 17d's sweep (40,000 steps cut to 4, batch 256 cut to 64); the seed of
# every weight, batch and shard generator; each spawned group's time limit
P17_STEPS, P17_BP_STEPS, P17_SEED = 40, 10, 17
P17_SWEEP_SEEDS, P17_SWEEP_STEPS, P17_SWEEP_BATCH = (1, 2, 3, 4), 4, 64
P17_TIMEOUT = 600
# phase 18: the guided rollout's steps (280 cut to 20), the traced chunked
# train steps, profile_train's --scaling point, and the calibration sweep's
# combinations (CONTACT_MU, ground arm scale, TIP_TORQUE_LEAK): the shipped
# one first. CAL_CPU_*: the shipped combination's stable-5 mean RMSE from
# `calibrate_block_push.run_rot_sweep` with device "cpu" (the port, torch
# 2.13 CPU build), which the card's must match within 1 mm and 1 degree
P18_GUIDED_STEPS, P18_TRACE_STEPS, P18_SCALING = 20, 5, "1024:20"
P18_GUIDE_LAMBDA = 2.0
CAL_COMBOS = ((0.05, 1.0, 0.0), (0.1, 1.25, 0.1))
CAL_CPU_POS_MM, CAL_CPU_YAW_DEG = 4.125739753996931, 9.273126677111044
# roofline of one H100 SXM at its 700 W limit (NVIDIA's data sheet): dense
# bf16 tensor-core operations and HBM3 bytes per second. The flash kernels'
# f32 instantiations run each f32 product on the tensor cores as three bf16
# products (hi.hi + lo.hi + hi.lo), so their operations count at a third of
# the bf16 rate.
PEAK_BF16_FLOPS, PEAK_HBM_BYTES = 989e12, 3.35e12
PEAK_F32_BF16X3_FLOPS = PEAK_BF16_FLOPS / 3


def bound(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    """(bound_ms, bound_by): the least time the card could take for this
    work, the larger of its operations over the peak of their type (bf16
    unless given) and its bytes over the memory rate, and which of the two
    it is."""
    t_ops, t_mem = flops / peak_flops * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def layer_work(B, T, D, P, n_layers=1, elem=2):
    """Operations and bytes of n_layers fused layers over B envs x T tokens,
    each token seeing P prefix keys and its causal own keys, with
    `elem`-byte activations and weights (2: bf16, 4: f32): 24 D^2 per token
    per layer for the four products and 4 D per (query, key) pair for the
    scores and P.V; x read once and out written once, and per layer its
    weights (12 D^2, 13 D f32 of biases and LayerNorm) and one sigma row of
    prefix K and V (2 B P D)."""
    rows, pairs = B * T, B * sum(P + t + 1 for t in range(T))
    flops = n_layers * (rows * 24 * D * D + pairs * 4 * D)
    nbytes = (2 * rows * D * elem
              + n_layers * (12 * D * D * elem + 13 * D * 4 + 2 * B * P * D * elem))
    return flops, nbytes


def flash_work(name, B, H, T, hd, elem=2):
    """Operations and bytes of one causal flash kernel at [B, H, T, hd] with
    `elem`-byte elements (2: bf16, 4: f32): 2 hd operations per (query,
    key) pair per product (forward 2 products, dQ 3, dK/dV 4), and for dQ
    2 hd per row for delta; each input read once and each output written
    once (lse and delta f32): the forward reads q, k, v and writes o and
    lse, dQ reads q, k, v, o, dO and lse and writes dq and delta, dK/dV
    reads q, k, v, dO, lse and delta and writes dk and dv."""
    rows = B * H * T
    pairs = rows * (T + 1) // 2
    n, stat = rows * hd * elem, rows * 4
    return {"flash_forward": (4 * hd * pairs, 3 * n + n + stat),
            "flash_backward_dq": (6 * hd * pairs + 2 * hd * rows, 5 * n + stat + n + stat),
            "flash_backward_dkv": (8 * hd * pairs, 4 * n + 2 * stat + 2 * n)}[name]


def sass_counts(so, kernels, opcode):
    """{kernel and template arguments (mangled): number of `opcode`
    instructions} over the functions of the built library whose name holds
    `kernels` (a name, or a tuple of names any of which may match; cuobjdump
    -sass, beside nvcc). A name must not occur in a source file's name:
    nvcc mangles the anonymous namespace with it (`..._flash_attention_cu_...`)."""
    from beso_tpu_torch.ops.build import find_nvcc

    keys = (kernels,) if isinstance(kernels, str) else kernels
    cuobjdump = Path(find_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                         timeout=300).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            # the mangled name from the kernel's on: its template arguments
            key = next((k for k in keys if k in name), None)
            fn = name[name.index(key):] if key else None
            fn = fn[:fn.index("EE") + 2] if fn and "EE" in fn else fn
            if fn:
                counts[fn] = 0
        elif fn and opcode in line:
            counts[fn] += 1
    return counts


def ptxas_report(log):
    """{kernel (mangled, from its name on): its spill and register lines}
    from `nvcc -Xptxas -v` output."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[1].strip()
            fn = next((name[name.index(k):] for k in ("flash_fwd", "flash_bwd",
                                                      "fused_layer_prefix_kernel",
                                                      "fused_layer_f32_kernel")
                       if k in name), name)
            out[fn] = ""
        elif fn and ("spill" in line or "Used" in line):
            props = line.replace("ptxas info    :", "").strip()
            out[fn] = f"{out[fn]}; {props}" if out[fn] else props
    return out


def spill_bytes(props):
    """Spill stores plus spill loads, in bytes, of one `ptxas_report` line."""
    return sum(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", props))


_T0 = time.perf_counter()


def since_start() -> str:
    """Seconds since the script started, for the phase headers."""
    return f"{time.perf_counter() - _T0:.1f} s"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def kitchen_agent_config():
    """The shipped kitchen config, `configs/franka_kitchen.yaml`, as
    BesoAgentConfig fields (no YAML parser on the card's host, so the values
    are written out). Only the step counts are cut."""
    return dict(obs_dim=30, action_dim=9,              # (:13, :12)
                hidden_dim=360, n_layers=N_LAYERS,     # (:17, :18)
                n_heads=6, goal_seq_len=2,             # (:19, :8)
                window_size=4, goal_conditioned=True,  # (:9, :10)
                attn_pdrop=0.3, resid_pdrop=0.0,       # (:20, :21)
                linear_output=True,                    # (:22)
                max_train_steps=MAIN_TRAIN_STEPS,      # max_train_steps: 40000 (:26), cut
                eval_every_n_steps=MAIN_TRAIN_STEPS,   # eval_every_n_steps: 4000 (:27), cut
                train_batch_size=1024,                 # (:28)
                optimizer="adamw", lr=1e-4,            # (:30, :31)
                betas=(0.9, 0.999), weight_decay=0.01,  # (:32, :33)
                lr_step_size=100, lr_gamma=0.99,       # (:34, :35)
                use_ema=True, decay=0.999,             # (:36, :37)
                update_ema_every_n_steps=1,            # (:38)
                compute_dtype="float32",               # compute_dtype: float32 (:39)
                sampler_type="ddim", sigma_data=0.5,   # (:42, :43)
                sigma_min=0.005, sigma_max=1.0,        # (:44, :45)
                rho=5.0, noise_scheduler="exponential",  # (:46, :47)
                sigma_sample_density_type="loglogistic",  # (:48)
                sigma_sample_density_mean=-0.6,        # (:49)
                sigma_sample_density_std=1.6,          # (:50)
                cond_mask_prob=0.1, cond_lambda=1.5,   # (:51, :52)
                num_sampling_steps=NFE,                # n_timesteps: 3 (:53)
                pred_last_action_only=False,           # (:54)
                inference_engine="fused_cached")       # the CUDA fused-layer engine


def kitchen_config():
    """The shipped kitchen serving config as DiffusionGPT fields, PolicyConfig
    fields and its scale_data, from `kitchen_agent_config`."""
    c = kitchen_agent_config()
    model = dict(state_dim=c["obs_dim"], action_dim=c["action_dim"], embed_dim=c["hidden_dim"],
                 n_layers=c["n_layers"], n_heads=c["n_heads"], goal_seq_len=c["goal_seq_len"],
                 obs_seq_len=c["window_size"], linear_output=c["linear_output"])
    policy = {k: c[k] for k in ("window_size", "obs_dim", "action_dim", "sampler_type",
                                "num_sampling_steps", "sigma_min", "sigma_max", "sigma_data",
                                "rho", "noise_scheduler", "cond_lambda")}
    return model, policy, False   # scale_data: false (:7)


def chunked_config():
    """The chunked kitchen training config, `configs/franka_kitchen_chunked.yaml`,
    as BesoAgentConfig fields (no YAML parser on the card's host, so the
    values are written out). Only the step counts are cut."""
    return dict(obs_dim=30,                       # obs_dim: 30 (:15)
                action_dim=9,                     # action_dim: 9 (:14)
                hidden_dim=360,                   # hidden_dim: 360 (:19)
                n_layers=N_LAYERS,                # num_hidden_layers: 6 (:20)
                n_heads=6,                        # n_heads: 6 (:21)
                goal_seq_len=2,                   # future_seq_length: 2 (:10)
                window_size=64,                   # window_size: 64 (:11)
                goal_conditioned=True,            # goal_conditioning: true (:12)
                attn_pdrop=0.0,                   # attn_pdrop: 0.0 (:22)
                resid_pdrop=0.0,                  # resid_pdrop: 0.0 (:23)
                linear_output=True,               # linear_output: true (:24)
                attention="pallas",               # attention: pallas (:25)
                max_train_steps=TRAIN_STEPS,      # max_train_steps: 40000 (:29), cut
                eval_every_n_steps=EVAL_EVERY,    # eval_every_n_steps: 4000 (:30), cut
                train_batch_size=TRAIN_BATCH,     # train_batch_size: 256 (:31)
                optimizer="adamw",                # optimizer: adamw (:33)
                lr=1e-4,                          # lr: 1e-4 (:34)
                betas=(0.9, 0.999),               # betas (:35)
                weight_decay=0.01,                # weight_decay: 0.01 (:36)
                lr_step_size=100,                 # lr_step_size: 100 (:37)
                lr_gamma=0.99,                    # lr_gamma: 0.99 (:38)
                use_ema=True,                     # use_ema: true (:39)
                decay=0.999,                      # decay: 0.999 (:40)
                update_ema_every_n_steps=1,       # (:41)
                compute_dtype="bfloat16",         # compute_dtype: bfloat16 (:42)
                sampler_type="ddim",              # sampler_type: ddim (:45)
                sigma_data=0.5,                   # sigma_data: 0.5 (:46)
                sigma_min=0.005,                  # sigma_min: 0.005 (:47)
                sigma_max=1.0,                    # sigma_max: 1.0 (:48)
                rho=5.0,                          # rho: 5.0 (:49)
                noise_scheduler="exponential",    # (:50)
                sigma_sample_density_type="loglogistic",  # (:51)
                cond_mask_prob=0.1,               # cond_mask_prob: 0.1 (:54)
                cond_lambda=1.5,                  # cond_lambda: 1.5 (:55)
                num_sampling_steps=NFE,           # n_timesteps: 3 (:56)
                pred_last_action_only=False)      # (:57)


def random_layer(D, H, M, gen, device, dtype=None):
    """One layer's weights (prepared, bf16 unless `dtype`) and an f32
    epilogue."""
    import torch

    from beso_tpu_torch.ops.fused_layer import FusedEpilogue, prepare_layer_params

    def w(o, i):
        return torch.randn(o, i, generator=gen) / math.sqrt(i)

    def v(n, base=0.0):
        return base + 0.1 * torch.randn(n, generator=gen)

    lp = dict(wqkv=w(3 * D, D), bqkv=v(3 * D), wproj=w(D, D), bproj=v(D),
              wfc=w(4 * D, D), bfc=v(4 * D), wfc2=w(D, 4 * D), bfc2=v(D),
              ln1_s=v(D, 1.0), ln1_b=v(D), ln2_s=v(D, 1.0), ln2_b=v(D))
    p = prepare_layer_params({k: a.to(device) for k, a in lp.items()}, H,
                             dtype or torch.bfloat16)
    epi = FusedEpilogue(v(D, 1.0).to(device), v(D).to(device),
                        w(M, D).to(device), v(M).to(device))
    return p, epi


def check_kernel(name, D, H, P, T2, S, M, B, device, gen, dtype=None, frac=ERR_FRACTION):
    """Kernel vs plain version at one shape in `dtype` (bf16 unless given),
    epilogue on/off, every row, within frac of max |ref|. Returns the
    largest |diff| seen."""
    import torch

    from beso_tpu_torch.ops.fused_layer import (fused_layer_prefix,
                                                fused_layer_prefix_reference)

    dtype = dtype or torch.bfloat16
    p, epi = random_layer(D, H, M, gen, device, dtype)
    x = _rand(gen, B, T2, D, device=device, dtype=dtype)
    pk = _rand(gen, S, B, P, D, device=device, dtype=dtype)
    pv = _rand(gen, S, B, P, D, device=device, dtype=dtype)
    worst = 0.0
    for use_epi in (False, True):
        for row in range(S):
            idx = torch.tensor([row], dtype=torch.int32, device=device)
            e = epi if use_epi else None
            got = fused_layer_prefix(x, pk, pv, idx, p, n_heads=H, epilogue=e)
            ref = fused_layer_prefix_reference(x, pk, pv, idx, p, n_heads=H,
                                               epilogue=e)
            if device.type == "cuda":
                torch.cuda.synchronize()
            pairs = [(got, ref)] if e is None else [(got[0], ref[0]), (got[1], ref[1])]
            for what, (g_, r_) in zip(("out", "pred"), pairs):
                err = (g_.float() - r_.float()).abs().max().item()
                lim = frac * r_.float().abs().max().item()
                ok = math.isfinite(err) and err <= lim
                print(f"  {name} {str(dtype)[6:]} B={B} epilogue={use_epi} row={row} {what}: "
                      f"max|diff| {err:.6g} (limit {lim:.6g}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"kernel disagrees with its plain version ({name})")
                worst = max(worst, err)
    return worst


def time_ms(fn, n, device):
    """Mean milliseconds per call: CUDA events around n calls after warm-up."""
    import torch

    for _ in range(3):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3 / n
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_kernel(B, device, gen, dtype=None, shape=KITCHEN_LAYER):
    """Kernel and plain-version times at a serving shape (D, heads, prefix
    P, suffix tokens 2T; the kitchen's unless given): B rows of the
    CFG-stacked batch, one inner layer (no epilogue), in `dtype` (bf16
    unless given)."""
    import torch

    from beso_tpu_torch.ops.fused_layer import (fused_layer_prefix,
                                                fused_layer_prefix_reference)

    dtype = dtype or torch.bfloat16
    D, H, P, T2 = shape
    p, _ = random_layer(D, H, 9, gen, device, dtype)
    x = _rand(gen, B, T2, D, device=device, dtype=dtype)
    pk = _rand(gen, 3, B, P, D, device=device, dtype=dtype)
    pv = _rand(gen, 3, B, P, D, device=device, dtype=dtype)
    idx = torch.tensor([1], dtype=torch.int32, device=device)
    ms = time_ms(lambda: fused_layer_prefix(x, pk, pv, idx, p, n_heads=H), 50, device)
    plain_ms = time_ms(lambda: fused_layer_prefix_reference(x, pk, pv, idx, p, n_heads=H),
                       10, device)
    return ms, plain_ms


def phase_split(B, device, gen, dtype=None, shape=KITCHEN_LAYER):
    """B1's phase clock at a serving shape (B rows; D, heads, P and 2T of
    `shape`, the kitchen's unless given; no epilogue) in `dtype` (bf16
    unless given): the timed launch must equal the plain B1 launch bit for
    bit. Returns {phase: mean cycles per block} over the blocks."""
    import torch

    from beso_tpu_torch.ops import fused_layer as fl

    dtype = dtype or torch.bfloat16
    D, H, P, T2 = shape
    p, _ = random_layer(D, H, 9, gen, device, dtype)
    x = _rand(gen, B, T2, D, device=device, dtype=dtype)
    pk, pv = (_rand(gen, 3, B, P, D, device=device, dtype=dtype) for _ in range(2))
    idx = torch.tensor([1], dtype=torch.int32, device=device)
    out, cycles = fl.fused_layer_prefix_timed(x, pk, pv, idx, p, n_heads=H)
    ref = fl.fused_layer_prefix(x, pk, pv, idx, p, n_heads=H)
    torch.cuda.synchronize()
    tag = str(dtype)[6:]
    _same_bits(f"{tag} timed B1 vs B1 at B={B}, D={D}, {H} heads", out, ref)
    names = fl.timed_phases(dtype)
    mean = cycles.double().mean(0).tolist()
    total = sum(mean)
    per_block = cycles.sum(1).double()
    print(f"  {tag} phase clock, {cycles.shape[0]} blocks: cycles per block mean {total:.0f}, "
          f"min {per_block.min().item():.0f}, max {per_block.max().item():.0f}")
    for name, c in zip(names, mean):
        print(f"    {name:>9}: {c:10.0f} cycles  {100 * c / total:5.1f}%")
    return dict(zip(names, mean))


def time_layer_gemms(rows, D, device, gen, n_layers=1, dtype=None):
    """torch.matmul time of a layer's four products (QKV, proj, fc, fc2) at
    `rows` rows, n_layers times, in `dtype` (bf16 unless given; f32 with
    TF32 off, as main() sets it): how near the fused kernel comes to
    cuBLAS's product rate (information only; the port never calls it)."""
    x = _rand(gen, rows, D, device=device, dtype=dtype)
    h = _rand(gen, rows, 4 * D, device=device, dtype=dtype)
    w = [_rand(gen, o, i, device=device, dtype=dtype)
         for o, i in ((3 * D, D), (D, D), (4 * D, D), (D, 4 * D))]

    def products():
        for _ in range(n_layers):
            for a, wt in zip((x, x, x, h), w):
                a @ wt.t()

    return time_ms(products, 20, device)


def time_sdpa(device, gen, dtype, shape=CHUNKED_SHAPE):
    """F.scaled_dot_product_attention (causal, in `dtype`) at `shape`, the
    yardstick of B5 and B6 (the port never calls it): (forward ms, forward +
    backward minus forward ms, the attention kernels that ran)."""
    import torch
    import torch.nn.functional as F

    q, k, v, do = (torch.randn(*shape, generator=gen).to(device, dtype)
                   for _ in range(4))
    fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 50,
                     device)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def fwd_bwd():
        F.scaled_dot_product_attention(*leaves, is_causal=True).backward(do)

    bwd_ms = time_ms(fwd_bwd, 20, device) - fwd_ms
    names = "not measured"
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fwd_bwd()
            torch.cuda.synchronize()
        found = sorted({e.key for e in prof.key_averages()
                        if any(w in e.key.lower() for w in ("attention", "fmha", "flash",
                                                            "cudnn", "sdpa"))})
        names = "; ".join(found) if found else names
    except Exception as e:   # the profiler is informational here
        names = f"not measured ({type(e).__name__})"
    return fwd_ms, bwd_ms, names


def _rand(gen, *shape, device, dtype=None):
    """Seeded normal values in `dtype` (bf16 unless given) on `device`."""
    import torch

    return torch.randn(*shape, generator=gen).to(device, dtype or torch.bfloat16)


def _same_bits(what, got, ref):
    """Fail unless got and ref are equal bit for bit."""
    import torch

    same = torch.equal(got, ref)
    print(f"  {what}: {'bit-equal' if same else 'NOT bit-equal: FAIL'}")
    if not same:
        fail(f"{what}: the kernels disagree")


def check_other_layers(device, gen, dtype=None, frac=ERR_FRACTION):
    """Phase 8: B4, B3 and B2 against their plain versions in `dtype` (bf16
    unless given) within frac of max |ref|, B3 and B2 against B1 launches
    bit for bit; in f32 also at batches that leave the last cluster's
    second block empty. Returns {kernel: largest max |diff| vs plain}."""
    import torch

    from beso_tpu_torch.ops import fused_layer as fl

    dtype = dtype or torch.bfloat16
    tag = str(dtype)[6:]
    err = {"fused_layer": 0.0, "fused_layer_with_prefix": 0.0,
           "fused_layers_prefix_group": 0.0}

    def check(kernel, what, got, ref):
        err[kernel] = max(err[kernel], _rel_check(f"{tag} {what}", got, ref, frac))

    def rand(*shape):
        return _rand(gen, *shape, device=device, dtype=dtype)

    f32 = dtype == torch.float32
    # B4: 5 envs per 64-row tile at 11 and 12 tokens; 2047 and 2001 envs
    # leave the last tile ragged; 2041 envs make 409 tiles (f32: an odd
    # count, so the last cluster's second block is empty)
    for name, D, H, T, B in (("kitchen", 360, 6, 11, 2047), ("block_push", 240, 12, 12, 2001),
                             *((("kitchen", 360, 6, 11, 2041),) if f32 else ())):
        p, _ = random_layer(D, H, 2, gen, device, dtype)
        x = rand(B, T, D)
        got = fl.fused_layer(x, p, n_heads=H)
        ref = fl.fused_layer_reference(x, p, n_heads=H)
        torch.cuda.synchronize()
        check("fused_layer", f"B4 {name} B={B} T={T}", got, ref)
    # B3 on sigma row 2, and B1 on the same row (f32 also at 1985 envs: 249
    # tiles)
    for name, D, H, P, T2, B in (("kitchen", 360, 6, 3, 8, 1999),
                                 ("block_push", 240, 12, 2, 10, 2000),
                                 *((("kitchen", 360, 6, 3, 8, 1985),) if f32 else ())):
        p, _ = random_layer(D, H, 2, gen, device, dtype)
        x = rand(B, T2, D)
        pk, pv = rand(3, B, P, D), rand(3, B, P, D)
        idx = torch.tensor([2], dtype=torch.int32, device=device)
        got = fl.fused_layer_with_prefix(x, pk[2], pv[2], p, n_heads=H)
        ref = fl.fused_layer_with_prefix_reference(x, pk[2], pv[2], p, n_heads=H)
        b1 = fl.fused_layer_prefix(x, pk, pv, idx, p, n_heads=H)
        torch.cuda.synchronize()
        check("fused_layer_with_prefix", f"B3 {name} B={B} P={P} 2T={T2}", got, ref)
        _same_bits(f"{tag} B3 {name} vs B1 on row 2", got, b1)
    # B2: groups of 2 and 4 layers (4 does not divide 6), epilogue off/on;
    # f32 also a group of 2 at 1985 envs
    D, H, P, T2, S, M = 360, 6, 3, 8, 3, 9
    made = [random_layer(D, H, M, gen, device, dtype) for _ in range(4)]
    layers, epi = [m[0] for m in made], made[-1][1]
    idx = torch.tensor([1], dtype=torch.int32, device=device)
    for n, e, B in ((2, None, 1999), (2, epi, 1999), (4, None, 1999), (4, epi, 1999),
                    *(((2, epi, 1985),) if f32 else ())):
        pks = [rand(S, B, P, D) for _ in range(n)]
        pvs = [rand(S, B, P, D) for _ in range(n)]
        x = rand(B, T2, D)
        got = fl.fused_layers_prefix_group(x, pks, pvs, idx, layers[:n], n_heads=H,
                                           epilogue=e)
        ref = fl.fused_layers_prefix_group_reference(x, pks, pvs, idx, layers[:n], n_heads=H,
                                                     epilogue=e)
        y = x
        for li in range(n):
            last = li == n - 1
            chain = fl.fused_layer_prefix(y, pks[li], pvs[li], idx, layers[li],
                                          n_heads=H, epilogue=e if last else None)
            y = chain[0] if (last and e is not None) else chain
        torch.cuda.synchronize()
        outs = [(got, ref, chain)] if e is None else list(zip(got, ref, chain))
        for what, (g_, r_, c_) in zip(("out", "pred"), outs):
            what = f"B2 group {n} B={B} epilogue={e is not None} {what}"
            check("fused_layers_prefix_group", what, g_, r_)
            _same_bits(f"{tag} {what} vs {n} B1 launches", g_, c_)
    return err


def time_other_layers(B, device, gen, dtype=None):
    """Phase 8 timing at the kitchen serving shape (B rows, D=360) in
    `dtype` (bf16 unless given): B4 over 11 tokens, B3 over 8 (and with its
    two row copies), B2 with a group of 2 against two B1 launches; (kernel
    ms, plain ms) each."""
    import torch

    from beso_tpu_torch.ops import fused_layer as fl

    D, H = 360, 6
    (p1, _), (p2, _) = (random_layer(D, H, 9, gen, device, dtype),
                        random_layer(D, H, 9, gen, device, dtype))
    x11 = _rand(gen, B, 11, D, device=device, dtype=dtype)
    x8 = _rand(gen, B, 8, D, device=device, dtype=dtype)
    pk = [_rand(gen, 3, B, 3, D, device=device, dtype=dtype) for _ in range(2)]
    pv = [_rand(gen, 3, B, 3, D, device=device, dtype=dtype) for _ in range(2)]
    idx = torch.tensor([1], dtype=torch.int32, device=device)
    row = idx.long()

    def two_b1(layer_fn):
        y = layer_fn(x8, pk[0], pv[0], idx, p1, n_heads=H)
        return layer_fn(y, pk[1], pv[1], idx, p2, n_heads=H)

    cases = {
        "fused_layer": (lambda: fl.fused_layer(x11, p1, n_heads=H),
                        lambda: fl.fused_layer_reference(x11, p1, n_heads=H)),
        "fused_layer_with_prefix": (
            lambda: fl.fused_layer_with_prefix(x8, pk[0][1], pv[0][1], p1, n_heads=H),
            lambda: fl.fused_layer_with_prefix_reference(x8, pk[0][1], pv[0][1], p1,
                                                         n_heads=H)),
        "fused_layer_with_prefix + row copies": (
            lambda: fl.fused_layer_with_prefix(x8, pk[0].index_select(0, row)[0],
                                               pv[0].index_select(0, row)[0], p1, n_heads=H),
            lambda: fl.fused_layer_with_prefix_reference(
                x8, pk[0].index_select(0, row)[0], pv[0].index_select(0, row)[0], p1,
                n_heads=H)),
        "fused_layers_prefix_group": (
            lambda: fl.fused_layers_prefix_group(x8, pk, pv, idx, [p1, p2], n_heads=H),
            lambda: fl.fused_layers_prefix_group_reference(x8, pk, pv, idx, [p1, p2],
                                                           n_heads=H)),
        "2 x fused_layer_prefix": (lambda: two_b1(fl.fused_layer_prefix),
                                   lambda: two_b1(fl.fused_layer_prefix_reference)),
    }
    return {name: (time_ms(k, 50, device), time_ms(pl, 10, device))
            for name, (k, pl) in cases.items()}


def check_full_engine(den, device, B, gen, label, frac=ERR_FRACTION):
    """Phase 9: `make_fused_denoise_fn` (B4) against the plain GCDenoiser
    forward, three grid sigmas and one off-grid, with and without zeroed
    goals, within frac of max |ref|. Returns the largest max |diff|."""
    import torch

    from beso_tpu_torch.core.schedules import get_noise_schedule
    from beso_tpu_torch.models import make_fused_denoise_fn

    m = den.inner_model
    T, G = m.obs_seq_len, m.goal_seq_len
    s = torch.randn(B, T, m.state_dim, generator=gen).to(device)
    a = torch.randn(B, T, m.action_dim, generator=gen).to(device)
    g = torch.randn(B, G, m.state_dim, generator=gen).to(device)
    fn = make_fused_denoise_fn(den)
    grid = get_noise_schedule(NFE, 0.005, 1.0, 5.0, "exponential")[:-1]
    worst = 0.0
    for sg in [float(v) for v in grid] + [0.3]:
        sig = torch.full((B,), sg, device=device)
        for uncond in (False, True):
            got, ref = fn(s, a, g, sig, uncond=uncond), den(s, a, g, sig, uncond=uncond)
            if got.shape != (B, T, m.action_dim):
                fail(f"make_fused_denoise_fn returned shape {tuple(got.shape)}")
            worst = max(worst, _rel_check(
                f"{label} sigma={sg:.6g} uncond={uncond}: fused (B4) vs plain forward",
                got, ref, frac))
    return worst


def check_cached_forms(den, device, B, gen, frac=ERR_FRACTION):
    """Phase 9: the fused_cached engine with token_lanes=False (B3) and with
    layer_group 2 and 4 (B2) against the default form (B1), every grid
    sigma, within frac of max |ref|."""
    import torch

    from beso_tpu_torch.core.schedules import get_noise_schedule
    from beso_tpu_torch.models.fused import make_fused_cached_denoise_fn

    m = den.inner_model
    T, G = m.obs_seq_len, m.goal_seq_len
    s = torch.randn(B, T, m.state_dim, generator=gen).to(device)
    a = torch.randn(B, T, m.action_dim, generator=gen).to(device)
    g = torch.randn(B, G, m.state_dim, generator=gen).to(device)
    grid = get_noise_schedule(NFE, 0.005, 1.0, 5.0, "exponential")[:-1]
    base = make_fused_cached_denoise_fn(den, g, grid)
    for label, kw in (("token_lanes=False", dict(token_lanes=False)),
                      ("layer_group=2", dict(layer_group=2)),
                      ("layer_group=4", dict(layer_group=4))):
        dn = make_fused_cached_denoise_fn(den, g, grid, **kw)
        for sg in grid:
            sig = torch.full((B,), float(sg), device=device)
            got, ref = dn(s, a, g, sig), base(s, a, g, sig)
            same = "bit-equal" if torch.equal(got, ref) else "not bit-equal"
            _rel_check(f"{str(m.dtype)[6:]} {label} sigma={float(sg):.6g} vs default "
                       f"fused_cached ({same})", got, ref, frac)


def run_engine_rollout(den, policy_kw, scale_data, device, engine, expect, card):
    """Phase 10: one ROLLOUT_STEPS-step rollout of an engine form, after a
    2-step warm-up, with every fused-layer counter set to 0 just before it;
    fails unless the counts are exactly `expect` (the rest 0)."""
    import torch

    from beso_tpu_torch.ops import fused_layer as fl

    counters = (fl.fused_layer_prefix, fl.fused_layers_prefix_group,
                fl.fused_layer_with_prefix, fl.fused_layer)
    run_rollout(den, policy_kw, scale_data, N_ENVS, 2, device, seed=1, engine=engine)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    metrics = run_rollout(den, policy_kw, scale_data, N_ENVS, ROLLOUT_STEPS, device, seed=2,
                          engine=engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {c.__name__: c.launches for c in counters}
    want = {c.__name__: expect.get(c.__name__, 0) for c in counters}
    print(f"  launches: {counts} (expected {want})")
    if counts != want:
        fail(f"the {engine} rollout launched the kernels {counts}, not {want}")
    check_rollout_metrics(metrics, N_ENVS, ROLLOUT_STEPS)
    print(f"  wall {wall:.3f} s, {N_ENVS * ROLLOUT_STEPS / wall:.1f} env-steps/s "
          f"(informational; random weights; {card})")
    return counts


def build_model(model_kw, device, seed, dtype=None):
    import torch

    from beso_tpu_torch.models import DiffusionGPT, GCDenoiser

    gen = torch.Generator().manual_seed(seed)
    model = DiffusionGPT(**model_kw, dtype=dtype or torch.bfloat16, generator=gen).to(device)
    return GCDenoiser(model, sigma_data=0.5)


def check_engine(den, device, B, gen, frac=ERR_FRACTION, sigma_min=0.005):
    """fused_cached vs cached engine on the same inputs, every sigma of the
    grid from `sigma_min` (the kitchen configs' unless given), within frac
    of max |cached|, in the model's dtype."""
    import torch

    from beso_tpu_torch.core.schedules import get_noise_schedule
    from beso_tpu_torch.models.cached import make_cached_denoise_fn
    from beso_tpu_torch.models.fused import make_fused_cached_denoise_fn

    m = den.inner_model
    T, G = m.obs_seq_len, m.goal_seq_len
    s = torch.randn(B, T, m.state_dim, generator=gen).to(device)
    a = torch.randn(B, T, m.action_dim, generator=gen).to(device)
    g = torch.randn(B, G, m.state_dim, generator=gen).to(device)
    grid = get_noise_schedule(NFE, sigma_min, 1.0, 5.0, "exponential")[:-1]
    fused = make_fused_cached_denoise_fn(den, g, grid)
    plain = make_cached_denoise_fn(den, g, grid)
    worst = 0.0
    for sg in grid:
        sig = torch.full((B,), float(sg), device=device)
        got, ref = fused(s, a, g, sig), plain(s, a, g, sig)
        err = (got - ref).abs().max().item()
        lim = frac * ref.abs().max().item()
        ok = math.isfinite(err) and err <= lim and got.shape == (B, T, m.action_dim)
        print(f"  {str(m.dtype)[6:]} sigma={float(sg):.6g}: max|fused - cached| {err:.6g} "
              f"(limit {lim:.6g}, max|cached| {ref.abs().max().item():.6g}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("fused_cached engine disagrees with the cached engine")
        worst = max(worst, err)
    return worst


def token_lanes_false_factory(den, scaler, cfg):
    """Per-episode factory on `make_fused_cached_denoise_fn(token_lanes=False)`
    (kernel B3), with the goals stacked as `cfg_denoise_fn` stacks its batch,
    as `make_rollout_denoise_factory` does for the default form."""
    import torch

    from beso_tpu_torch.agents.policy import scale_goal_for_model
    from beso_tpu_torch.core.schedules import get_noise_schedule
    from beso_tpu_torch.models.fused import make_fused_cached_denoise_fn

    sigmas = get_noise_schedule(cfg.num_sampling_steps, cfg.sigma_min, cfg.sigma_max,
                                cfg.rho, cfg.noise_scheduler)[:-1]

    def factory(goals_raw):
        g_s = scale_goal_for_model(scaler, goals_raw)
        g_model = torch.cat([g_s, torch.zeros_like(g_s)])   # lambda != 0, 1
        return make_fused_cached_denoise_fn(den, g_model, sigmas, token_lanes=False)

    return factory


@contextlib.contextmanager
def recording_kitchen_steps():
    """Within: `rollout/rollout.py`'s `kitchen_step` keeps device copies of
    its inputs (state, action, params) at the episode steps
    KS_RECORD_STEPS, in the list this yields."""
    import beso_tpu_torch.rollout.rollout as rollout_mod
    from beso_tpu_torch.envs.kitchen.env import KitchenState

    real, store, calls = rollout_mod.kitchen_step, [], [0]

    def recording(state, action, params=None):
        if calls[0] in KS_RECORD_STEPS:
            store.append((KitchenState(*(f.clone() for f in state)), action.clone(), params))
        calls[0] += 1
        return real(state, action, params)

    rollout_mod.kitchen_step = recording
    try:
        yield store
    finally:
        rollout_mod.kitchen_step = real


def check_kitchen_step_on_card(device, card, recorded):
    """Phase 4b: the kitchen step kernel against `_kitchen_step_eager` on the
    inputs `recorded` ({envs: [(state, action, params)]}, from
    `recording_kitchen_steps`): floats within KS_LIMIT, flags and completion
    steps equal. Times both at each batch with CUDA events (the eager step
    with its own waits for the card), and bounds the kernel by the larger
    of its bytes over the memory rate (the state and action read, the new
    state and reward written, the params and tables staged by each
    128-thread block) and the card's per-launch floor. Returns the kernels
    line's fields."""
    import dataclasses

    import torch

    from beso_tpu_torch.envs.kitchen import env as kenv
    from beso_tpu_torch.ops import kitchen_step as ks

    names = [*kenv.KitchenState._fields, "reward"]
    one = torch.zeros(1, device=device)
    launch_ms = time_ms(lambda: one.add_(1.0), 200, device)
    worst, ms, plain_ms, bounds = 0.0, {}, {}, {}
    for n_envs, steps in recorded.items():
        if len(steps) != len(KS_RECORD_STEPS) or steps[0][0].qpos.shape[0] != n_envs:
            fail(f"recorded {len(steps)} kitchen steps of {n_envs} envs, expected "
                 f"{len(KS_RECORD_STEPS)}")
        for state, action, params in steps:
            before = ks.kitchen_step.launches
            got = kenv.kitchen_step(state, action, params)
            if ks.kitchen_step.launches != before + 1:
                fail("kitchen_step on the card did not launch the kernel once")
            ref = kenv._kitchen_step_eager(state, action, params)
            for name, x, y in zip(names, [*got[0], got[2]], [*ref[0], ref[2]]):
                if x.dtype.is_floating_point:
                    worst = max(worst, float((x - y).abs().max()))
                elif not torch.equal(x, y):
                    fail(f"the kitchen step kernel's {name} differs from the eager step's "
                         f"({n_envs} envs)")
        state, action, params = steps[-1]
        ms[n_envs] = time_ms(lambda: kenv.kitchen_step(state, action, params), 200, device)
        plain_ms[n_envs] = time_ms(lambda: kenv._kitchen_step_eager(state, action, params),
                                   20, device)
        p = params if params is not None else kenv.default_kitchen_params(device)
        staged = (sum(getattr(p, f.name).nbytes for f in dataclasses.fields(p))
                  + sum(getattr(kenv._consts(device), n).nbytes for n, _, _ in ks.TABLES))
        nbytes = (2 * sum(f.nbytes for f in state) + action.nbytes + 4 * n_envs
                  + -(-n_envs // 128) * staged)
        t_mem = nbytes / PEAK_HBM_BYTES * 1e3
        bounds[n_envs] = (t_mem, "bytes") if t_mem >= launch_ms else (launch_ms, "launch")
        print(f"  {n_envs} envs, steps {list(KS_RECORD_STEPS)}: kernel {ms[n_envs]:.4f} ms, "
              f"eager step {plain_ms[n_envs]:.4f} ms per step; {nbytes} bytes, bound "
              f"{bounds[n_envs][0]:.4f} ms ({bounds[n_envs][1]}; one launch {launch_ms:.4f} ms), "
              f"{100 * bounds[n_envs][0] / ms[n_envs]:.1f}% of the roofline ({card})")
    print(f"  max |kernel - eager| over the float fields and the reward: {worst:.3g} "
          f"(limit {KS_LIMIT:g}); flags and completion steps equal")
    if worst > KS_LIMIT:
        fail(f"the kitchen step kernel is {worst:.3g} from the eager step on the card")
    return {"max_abs_err": worst, "ms": ms[N_ENVS], "plain_ms": plain_ms[N_ENVS],
            "bound_ms": bounds[N_ENVS][0], "bound_by": bounds[N_ENVS][1],
            "ms_by_envs": ms, "plain_ms_by_envs": plain_ms,
            "bound_ms_by_envs": {n: b for n, (b, _) in bounds.items()}}


def run_rollout(den, policy_kw, scale_data, n_envs, n_steps, device, seed,
                engine="fused_cached", guide=None):
    """A kitchen rollout. `engine`: "fused_cached" (the serving main path,
    B1, or B2 under BESO_LAYER_GROUP), "token_lanes_false" (B3) or
    "uncached" (`make_fused_denoise_fn`, B4, no factory). With `guide`, each
    episode's engine is wrapped by `classifier_guided_denoise_fn`."""
    import torch

    from beso_tpu_torch.agents.policy import PolicyConfig
    from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
    from beso_tpu_torch.envs.kitchen.goals import multigoal_kitchen_goals
    from beso_tpu_torch.models import (fit_scaler, make_fused_denoise_fn,
                                       make_rollout_denoise_factory)
    from beso_tpu_torch.rollout import rollout_kitchen

    data = synthetic_kitchen_data(n_traj=32, t_max=60)
    scaler = fit_scaler(data.all_observations(), data.all_actions(),
                        scale_data=scale_data, device=device)
    goals, expected = multigoal_kitchen_goals(data, 2, n_envs, seed=42)
    cfg = PolicyConfig(**policy_kw)
    denoise_fn = factory = None
    if engine == "fused_cached":
        factory = make_rollout_denoise_factory(den, scaler, cfg, engine="fused_cached")
    elif engine == "token_lanes_false":
        factory = token_lanes_false_factory(den, scaler, cfg)
    else:
        denoise_fn = make_fused_denoise_fn(den)
    if guide is not None:
        from beso_tpu_torch.models.cfg import classifier_guided_denoise_fn

        engine_of = factory

        def factory(goals):
            return classifier_guided_denoise_fn(engine_of(goals), guide, P18_GUIDE_LAMBDA)
    gen = torch.Generator(device=device).manual_seed(seed)
    return rollout_kitchen(denoise_fn, scaler, cfg, torch.as_tensor(goals, device=device),
                           torch.as_tensor(expected, device=device), gen,
                           n_steps=n_steps, denoise_factory=factory)


def check_rollout_metrics(metrics, n_envs, n_steps):
    """Shapes and finiteness of a rollout's metrics."""
    import torch

    for name in ("rewards", "results"):
        v = getattr(metrics, name)
        if v.shape != (n_envs,) or not bool(torch.isfinite(v).all()):
            fail(f"rollout metric {name} is not finite / has shape {tuple(v.shape)}")
    if metrics.completed.shape != (n_envs, 7) or metrics.env_steps != n_envs * n_steps:
        fail("rollout metrics have the wrong shape")
    order = metrics.completion_order
    if bool(((order < -1) | (order > n_steps)).any()):
        fail("completion_order outside [-1, n_steps]")


def _rel_check(what, got, ref, frac):
    """max |got - ref| within frac * max |ref| (and finite); returns the error."""
    err = (got.float() - ref.float()).abs().max().item()
    lim = frac * ref.float().abs().max().item()
    ok = math.isfinite(err) and err <= lim
    print(f"  {what}: max|diff| {err:.6g} (limit {lim:.6g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{what} disagrees with its plain version")
    return err


def check_flash(B, H, T, hd, causal, device, gen, dtype, frac):
    """The three flash kernels against their plain versions at one shape in
    `dtype`, within frac of max |ref|, on the same inputs (the backward
    kernels get the plain forward's o and lse, and the dK/dV kernel the
    plain delta, so each is held alone), and a second launch of each kernel
    bit-equal to the first. Returns {kernel: max |diff|}."""
    import torch

    from beso_tpu_torch.ops import flash_attention as fa

    q, k, v, do = (torch.randn(B, H, T, hd, generator=gen).to(device, dtype)
                   for _ in range(4))
    name = f"{str(dtype).split('.')[-1]} [{B},{H},{T},{hd}] causal={causal}"
    o, lse = fa.flash_forward(q, k, v, causal)
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, causal)
    dq, delta = fa.flash_backward_dq(q, k, v, o_ref, do, lse_ref, causal)
    dq_ref, delta_ref = fa.flash_backward_dq_reference(q, k, v, o_ref, do, lse_ref, causal)
    dk, dv = fa.flash_backward_dkv(q, k, v, do, lse_ref, delta_ref, causal)
    dk_ref, dv_ref = fa.flash_backward_dkv_reference(q, k, v, do, lse_ref, delta_ref, causal)
    again = (*fa.flash_forward(q, k, v, causal),
             *fa.flash_backward_dq(q, k, v, o_ref, do, lse_ref, causal),
             *fa.flash_backward_dkv(q, k, v, do, lse_ref, delta_ref, causal))
    if device.type == "cuda":
        torch.cuda.synchronize()
    for what, first, second in zip(("o", "lse", "dq", "delta", "dk", "dv"),
                                   (o, lse, dq, delta, dk, dv), again):
        _same_bits(f"{name} {what}, second launch", second, first)
    return {
        "flash_forward": max(_rel_check(f"{name} o", o, o_ref, frac),
                             _rel_check(f"{name} lse", lse, lse_ref, frac)),
        "flash_backward_dq": max(_rel_check(f"{name} dq", dq, dq_ref, frac),
                                 _rel_check(f"{name} delta", delta, delta_ref, frac)),
        "flash_backward_dkv": max(_rel_check(f"{name} dk", dk, dk_ref, frac),
                                  _rel_check(f"{name} dv", dv, dv_ref, frac)),
    }


def _device_kernels(run):
    """The device kernels (no copies or fills) that `run()` launches
    (torch.profiler), or None where the profiler saw no device kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))]
    return names or None


def forward_kernels(device, gen, shape=CHUNKED_SHAPE, dtype=None):
    """The device kernels of one `flash_forward` at `shape` in `dtype`
    (bf16 unless given), after a warm-up, or None as in `_device_kernels`."""
    from beso_tpu_torch.ops import flash_attention as fa

    q, k, v = (_rand(gen, *shape, device=device, dtype=dtype) for _ in range(3))
    fa.flash_forward(q, k, v)   # warm-up
    return _device_kernels(lambda: fa.flash_forward(q, k, v))


def backward_kernels(device, gen, shape=CHUNKED_SHAPE, dtype=None):
    """The device kernels that one autograd backward through
    `flash_attention` runs at `shape` (in `dtype`, bf16 unless given,
    contiguous cotangent, leaves without a gradient yet), or None as in
    `_device_kernels`."""
    from beso_tpu_torch.ops import flash_attention as fa

    leaves = [_rand(gen, *shape, device=device, dtype=dtype).requires_grad_() for _ in range(3)]
    do = _rand(gen, *shape, device=device, dtype=dtype)
    fa.flash_attention(*leaves).backward(do)   # warm-up
    for t in leaves:
        t.grad = None
    o = fa.flash_attention(*leaves)
    return _device_kernels(lambda: o.backward(do))


def time_flash(device, gen, dtype, shape=CHUNKED_SHAPE):
    """Kernel and plain-version ms at `shape` in `dtype`: each kernel, the
    backward total (dQ with delta, then dK/dV on that delta) and forward +
    backward."""
    import torch

    from beso_tpu_torch.ops import flash_attention as fa

    q, k, v, do = (torch.randn(*shape, generator=gen).to(device, dtype)
                   for _ in range(4))
    o, lse = fa.flash_forward_reference(q, k, v)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)

    def bwd(bdq, bdkv, o, lse):
        dq, d = bdq(q, k, v, o, do, lse)
        return dq, bdkv(q, k, v, do, lse, d)

    def fwd_bwd(fwd, bdq, bdkv):
        return bwd(bdq, bdkv, *fwd(q, k, v))

    t = {
        "flash_forward": (lambda: fa.flash_forward(q, k, v),
                          lambda: fa.flash_forward_reference(q, k, v)),
        "flash_backward_dq": (
            lambda: fa.flash_backward_dq(q, k, v, o, do, lse),
            lambda: fa.flash_backward_dq_reference(q, k, v, o, do, lse)),
        "flash_backward_dkv": (
            lambda: fa.flash_backward_dkv(q, k, v, do, lse, delta),
            lambda: fa.flash_backward_dkv_reference(q, k, v, do, lse, delta)),
        "backward": (
            lambda: bwd(fa.flash_backward_dq, fa.flash_backward_dkv, o, lse),
            lambda: bwd(fa.flash_backward_dq_reference, fa.flash_backward_dkv_reference, o, lse)),
        "forward+backward": (
            lambda: fwd_bwd(fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv),
            lambda: fwd_bwd(fa.flash_forward_reference, fa.flash_backward_dq_reference,
                            fa.flash_backward_dkv_reference)),
    }
    return {name: (time_ms(kern, 50, device), time_ms(plain, 10, device))
            for name, (kern, plain) in t.items()}


def check_model_grads(device, seed, dtype, B=64, n_heads=None):
    """Loss and gradients of the chunked model computing in `dtype` (with
    `n_heads` heads if given) under attention="broadcast" and "pallas", same
    state, inputs and goal mask: {impl: (loss, grads)}."""
    import torch

    from beso_tpu_torch.core.densities import make_sample_density
    from beso_tpu_torch.models import DiffusionGPT, GCDenoiser

    c = chunked_config()
    gen = torch.Generator().manual_seed(seed)
    model = DiffusionGPT(
        state_dim=c["obs_dim"], action_dim=c["action_dim"], embed_dim=c["hidden_dim"],
        n_layers=c["n_layers"], n_heads=n_heads or c["n_heads"],
        goal_seq_len=c["goal_seq_len"],
        obs_seq_len=c["window_size"], cond_mask_prob=c["cond_mask_prob"],
        dtype=dtype, generator=gen).to(device)
    den = GCDenoiser(model, sigma_data=c["sigma_data"])
    T, G = c["window_size"], c["goal_seq_len"]
    s = torch.randn(B, T, c["obs_dim"], generator=gen).to(device)
    a = torch.randn(B, T, c["action_dim"], generator=gen).clamp(-1, 1).to(device)
    g = torch.randn(B, G, c["obs_dim"], generator=gen).to(device)
    noise = torch.randn(B, T, c["action_dim"], generator=gen).to(device)
    sigma = make_sample_density("loglogistic", 0.5, 0.005, 1.0)(gen, (B,)).to(device)
    out = {}
    for impl in ("broadcast", "pallas"):
        model.attention = impl
        model.zero_grad(set_to_none=True)
        mask_gen = torch.Generator(device).manual_seed(seed)  # same goal mask
        loss = den.loss(s, a, g, noise, sigma, train=True, generator=mask_gen)
        loss.backward()
        out[impl] = (loss.detach(), {n: p.grad.detach().clone()
                                     for n, p in model.named_parameters()})
    return out


def run_training(device, seed, writer, **overrides):
    """The training main path: BesoAgent.train_agent on the chunked config
    (with `overrides` of its fields)."""
    import torch

    from beso_tpu_torch.agents.beso_agent import BesoAgent, BesoAgentConfig
    from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
    from beso_tpu_torch.workspaces import FrankaKitchenWorkspace

    # trajectories of 100-200 steps: windows of 64 plus future goals exist
    data = synthetic_kitchen_data(n_traj=96, t_max=200, seed=seed)
    ws = FrankaKitchenWorkspace(seed=42, data=data, window_size=64, goal_seq_len=2,
                                scale_data=False,        # scale_data: false (:9)
                                train_fraction=0.95,     # train_fraction: 0.95 (:64)
                                eval_n_times=64, eval_n_steps=4, device=device)
    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
    agent = BesoAgent(BesoAgentConfig(**{**chunked_config(), **overrides}), ws.scaler,
                      checkpoint_dir=str(ckpt), metrics_writer=writer, device=device)
    agent.init(torch.Generator().manual_seed(seed))
    return ws, agent


def run_f32_main_path(device, card):
    """Phase 11, the shipped kitchen config as shipped: relay-kitchen files
    written by `export_relay_kitchen` (synthetic trajectories), loaded by
    `FrankaKitchenWorkspace(data_path=...)`; an f32 BesoAgent trained
    MAIN_TRAIN_STEPS steps; then the workspace's multigoal evaluation, N_ENVS
    envs x N_STEPS steps on the agent's `fused_cached` engine in f32, with
    every fused-layer counter set to 0 just before it and read just after.
    Returns the counts, the workspace and the trained agent."""
    import torch

    from beso_tpu_torch.agents.beso_agent import BesoAgent, BesoAgentConfig
    from beso_tpu_torch.data.export import export_relay_kitchen
    from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
    from beso_tpu_torch.ops import fused_layer as fl
    from beso_tpu_torch.workspaces import FrankaKitchenWorkspace

    data_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_relay_kitchen"
    export_relay_kitchen(synthetic_kitchen_data(n_traj=64, t_max=120, seed=11), data_dir)
    ws = FrankaKitchenWorkspace(seed=42, data_path=str(data_dir),   # seed: 42 (:6)
                                eval_n_times=N_ENVS,        # eval_n_times: 100 (:59), raised
                                eval_n_steps=N_STEPS,       # eval_n_steps: 280 (:60)
                                scale_data=False,           # scale_data: false (:7)
                                window_size=4, goal_seq_len=2,
                                train_fraction=0.95,        # train_fraction: 0.95 (:61)
                                device=device)
    print(f"  data_path {data_dir.name}: {ws.full_data.num_trajectories} trajectories, "
          f"{len(ws.train_set)} train / {len(ws.test_set)} test windows")
    records = Records()
    agent = BesoAgent(BesoAgentConfig(**kitchen_agent_config()), ws.scaler,
                      metrics_writer=records, device=device)
    agent.init(torch.Generator().manual_seed(12))
    if agent.denoiser.inner_model.dtype != torch.float32:
        fail("the shipped kitchen config did not build an f32 model")
    agent.train_agent(ws.train_set, ws.test_set, torch.Generator(device).manual_seed(13))
    torch.cuda.synchronize()
    losses = [r[k] for r in records.rows for k in ("loss", "test_loss") if k in r]
    print(f"  {MAIN_TRAIN_STEPS} f32 train steps at batch {agent.cfg.train_batch_size}: "
          f"losses {losses}")
    if not losses or not all(math.isfinite(x) for x in losses):
        fail("an f32 training loss is not finite")
    counters = (fl.fused_layer_prefix, fl.fused_layers_prefix_group,
                fl.fused_layer_with_prefix, fl.fused_layer)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    mg = ws.test_agent(agent, generator=torch.Generator(device).manual_seed(14),
                       log_metrics=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {c.__name__: c.launches for c in counters}
    want = {c.__name__: 0 for c in counters}
    want["fused_layer_prefix"] = N_STEPS * NFE * N_LAYERS
    print(f"  launches: {counts} (expected {want})")
    if counts != want:
        fail(f"the f32 evaluation launched the fused-layer kernels {counts}, not {want}")
    finite = [k for k in ("avrg_reward", "std_reward", "avrg_result", "std_result")
              if not math.isfinite(mg[k])]
    if finite or not all(math.isfinite(mg[f"success_rate_{k}"]) for k in range(1, 6)):
        fail(f"the f32 evaluation's metrics are not finite ({finite})")
    print(f"  multigoal evaluation, {N_ENVS} envs x {N_STEPS} steps on fused_cached (f32): "
          f"avrg_reward {mg['avrg_reward']:.4f}, avrg_result {mg['avrg_result']:.4f}; wall "
          f"{wall:.3f} s, {N_ENVS * N_STEPS / wall:.1f} env-steps/s (informational; "
          f"{card})")
    return counts, ws, agent


def block_push_agent_config():
    """The shipped block-push config, `configs/block_push.yaml`, as
    BesoAgentConfig fields (no YAML parser on the card's host, so the values
    are written out). Only the step counts are cut."""
    return dict(obs_dim=10, action_dim=2,              # (:14, :13)
                hidden_dim=240, n_layers=BP_LAYERS,    # (:18, :19)
                n_heads=12, goal_seq_len=1,            # (:20, :7)
                window_size=5, goal_conditioned=True,  # (:8, :11)
                attn_pdrop=0.05, resid_pdrop=0.05,     # (:21, :22)
                linear_output=True,                    # (:23)
                max_train_steps=MAIN_TRAIN_STEPS,      # max_train_steps: 60000 (:27), cut
                eval_every_n_steps=MAIN_TRAIN_STEPS,   # eval_every_n_steps: 4000 (:28), cut
                train_batch_size=1024,                 # (:29)
                optimizer="adam", lr=1e-4,             # (:31, :32)
                betas=(0.9, 0.999), weight_decay=0.0,  # (:33, :34)
                lr_step_size=100, lr_gamma=0.99,       # (:35, :36)
                use_ema=True, decay=0.999,             # (:37, :38)
                update_ema_every_n_steps=1,            # (:39)
                compute_dtype="float32",               # compute_dtype: float32 (:40)
                sampler_type="ddim", sigma_data=0.5,   # (:43, :44)
                sigma_min=0.05, sigma_max=1.0,         # (:45, :46)
                rho=5.0, noise_scheduler="exponential",  # (:47, :48)
                sigma_sample_density_type="loglogistic",  # (:49)
                sigma_sample_density_mean=-0.6,        # (:50)
                sigma_sample_density_std=1.6,          # (:51)
                cond_mask_prob=0.1, cond_lambda=2.0,   # (:52, :53)
                num_sampling_steps=NFE,                # n_timesteps: 3 (:54)
                pred_last_action_only=False,           # (:55)
                inference_engine="fused_cached")       # the CUDA fused-layer engine


def check_physics_on_card(device, n_envs=256, steps=3):
    """`block_push_step` on the card against the same steps on the CPU:
    n_envs envs from one reset, the pusher driven into block 0, with the
    dither hash replaced on both sides by the smooth sin(_HASH_W @ u) (the
    shipped sin-hash decorrelates at an ulp, and the card's sin is not the
    CPU's): positions within 1e-5 m, yaws within 5e-5 rad, velocities within
    1e-4 of their largest magnitude, flags, rewards and done equal."""
    import torch

    import beso_tpu_torch.envs.block_push.env as bp

    w = torch.as_tensor(bp._HASH_W.copy())

    def smooth_hash(bpos, byaw, eff):
        u = torch.cat([bpos, byaw[..., None], eff], -1)
        return torch.sin((w.to(u.device) * u[..., None, :]).sum(-1))

    state = bp.block_push_reset(n_envs, torch.Generator().manual_seed(28))
    eff = state.block_pos[:, 0] - torch.tensor([0.0, 0.05])
    state = state._replace(effector=eff, effector_target=eff.clone())
    action = torch.tensor([0.0, 0.03]).expand(n_envs, 2)
    cpu, card = state, bp.BlockPushState(*(v.to(device) for v in state))
    real_hash, bp._hash_noise = bp._hash_noise, smooth_hash
    try:
        for _ in range(steps):
            cpu, _, r_cpu, d_cpu = bp.block_push_step(cpu, action)
            card, _, r_card, d_card = bp.block_push_step(card, action.to(device))
    finally:
        bp._hash_noise = real_hash
    worst = {}
    for field, a, b in zip(cpu._fields, cpu, card):
        b = b.cpu()
        if a.dtype != torch.float32:
            worst[field] = 0.0 if torch.equal(a, b) else math.inf
            continue
        err = (a - b).abs().max().item()
        lim = {"block_vel": 1e-4 * max(a.abs().max().item(), 1.0),
               "block_yawrate": 1e-4 * max(a.abs().max().item(), 1.0),
               "block_yaw": 5e-5, "target_yaw": 5e-5}.get(field, 1e-5)
        worst[field] = err if err <= lim else math.inf
    moved = (cpu.block_pos - state.block_pos).abs().amax((1, 2))
    print(f"  physics on the card vs the CPU, {n_envs} envs x {steps} steps pushing block 0 "
          f"(smooth stand-in hash): max |diff| per field {json.dumps(worst)}; "
          f"{int((moved > 1e-3).sum())} envs moved a block")
    if (not all(math.isfinite(v) for v in worst.values()) or not torch.equal(r_cpu, r_card.cpu())
            or not torch.equal(d_cpu, d_card.cpu()) or (moved > 1e-3).float().mean() < 0.5):
        fail("block_push_step on the card disagrees with the CPU")


def check_hash_on_card(device, n=4000):
    """The shipped dither hash `_hash_noise` on the card against the CPU, as
    tests/test_torch_block_push.py holds it against JAX: where its product is
    one multiply (one nonzero input) within 5e-4 in circular distance on
    [-1, 1) (an ulp of sin times the x500 scale); on general states more
    than half within 1e-3 and the same zero-mean law (std within 0.02)."""
    import numpy as np
    import torch

    from beso_tpu_torch.envs.block_push.env import _hash_noise

    def both(u):
        u = torch.as_tensor(u)
        args = (u[:, :2], u[:, 2], u[:, 3:])
        cpu = _hash_noise(*args)
        card = _hash_noise(*(a.to(device) for a in args)).cpu()
        d = (cpu - card).abs()
        return cpu, card, torch.minimum(d, 2.0 - d)

    rng = np.random.RandomState(0)
    u = np.zeros((n, 5), np.float32)
    u[np.arange(n), rng.randint(0, 5, n)] = rng.uniform(-0.6, 0.6, n)
    _, _, d_one = both(u)
    u = np.concatenate([rng.uniform(0.2, 0.6, (n, 2)), rng.uniform(0.0, 3.2, (n, 1)),
                        rng.uniform(-0.5, 0.6, (n, 2))], 1).astype(np.float32)
    cpu, card, d = both(u)
    near = (d < 1e-3).float().mean().item()
    print(f"  shipped dither hash on the card vs the CPU, {n} states: single-multiply max "
          f"circular diff {d_one.max().item():.3g} (bound 5e-4); general states max "
          f"{d.max().item():.3g}, {100 * near:.1f}% within 1e-3 (bound 50%), std "
          f"{card.std().item():.4f} vs {cpu.std().item():.4f}")
    if (d_one.max().item() > 5e-4 or near <= 0.5
            or abs(card.std().item() - cpu.std().item()) >= 0.02
            or card.mean().abs().item() >= 0.03 or not bool((card.abs() <= 1.0).all())):
        fail("the block-push dither hash on the card disagrees with the CPU")


def check_fidelity_on_card(device):
    """Every band of tests/test_block_push_fidelity.py, on the card with the
    shipped dither hash: the MuJoCo golden scenarios (first engaged step
    within 12 mm / 0.20 rad; the off-center push's rotation sign; stable-push
    RMSE under 8 mm and 16 deg), the 16-push ensemble's displacement bands,
    the knocked block coming to rest and the two-block train. All 24 scripted
    pushes run as one batch of 12 control steps (shorter scripts padded with
    a still pusher, read at their own last step)."""
    import numpy as np
    import torch

    import beso_tpu_torch.envs.block_push.env as bp

    golden = np.load(Path(__file__).resolve().parent / "tests" / "golden"
                     / "block_push_mujoco.npz")
    stable = ["offcenter_0.25", "offcenter_0.5", "offcenter_0.75", "rotated", "diagonal"]
    starts, scripts = [], []          # (b0, yaw0, b1, eff0), offsets [T, 2]
    for name in ["central"] + stable:
        meta = golden[f"{name}__meta"]
        starts.append((meta[:2], meta[2], meta[3:5], meta[5:7]))
        scripts.append(golden[f"{name}__offsets"])
    rng = np.random.default_rng(0)    # the ensemble's draws
    for _ in range(16):
        yaw, dx = rng.uniform(0, np.pi), rng.uniform(-0.8, 0.8) * bp.BLOCK_HALF
        starts.append(((0.4, -0.2), yaw, (0.8, 0.6), (0.4 + dx, -0.33)))
        scripts.append(np.tile([0.0, 0.035], (12, 1)))
    starts.append(((0.4, -0.24), 0.3, (0.8, 0.6), (0.405, -0.30)))      # knocked block
    scripts.append(np.asarray([(0.0, 0.035)] * 3 + [(0.0, 0.0)] * 6))
    starts.append(((0.4, -0.2), 0.0, (0.4, -0.11), (0.4, -0.3)))        # two-block train
    scripts.append(np.asarray([(0.0, 0.035)] * 8))
    B, T = len(starts), 12
    offsets = np.zeros((T, B, 2), np.float32)
    for i, sc in enumerate(scripts):
        offsets[:len(sc), i] = sc

    def col(k):
        return torch.as_tensor(np.asarray([s[k] for s in starts], np.float32), device=device)

    b0, yaw0, b1, eff = col(0), col(1), col(2), col(3)
    state = bp.BlockPushState(
        effector=eff, effector_target=eff.clone(), block_pos=torch.stack([b0, b1], 1),
        block_yaw=torch.stack([yaw0, torch.zeros_like(yaw0)], 1),
        target_pos=torch.tensor([[0.28, 0.2], [0.52, 0.2]], device=device).expand(B, 2, 2),
        target_yaw=torch.full((B, 2), math.pi, device=device),
        in_target=torch.zeros(B, 2, 2, dtype=torch.bool, device=device),
        completed=torch.zeros(B, 4, dtype=torch.bool, device=device),
        done=torch.zeros(B, dtype=torch.bool, device=device),
        steps=torch.zeros(B, dtype=torch.int32, device=device),
        block_vel=torch.zeros(B, 2, 2, device=device),
        block_yawrate=torch.zeros(B, 2, device=device))
    traj = []
    for a in torch.as_tensor(offsets, device=device):
        state, obs, _, _ = bp.block_push_step(state, a)
        traj.append(obs[:, :5].cpu().numpy())
    tr = np.stack(traj, 1).astype(np.float64)    # [B, T, 5]

    def wrap(a):
        return (a + np.pi) % (2 * np.pi) - np.pi

    names = ["central"] + stable
    got, ok = {}, []
    for name in ("central", "offcenter_0.5", "rotated"):
        mj, t_ = golden[name], tr[names.index(name)]
        got[f"early_mm_{name}"] = 1e3 * np.abs(mj[2, :2] - t_[2, :2]).max()
        got[f"early_rad_{name}"] = abs(wrap(mj[2, 2] - t_[2, 2]))
        ok += [got[f"early_mm_{name}"] < 12.0, got[f"early_rad_{name}"] < 0.20]
    mj, t_ = golden["offcenter_0.5"], tr[names.index("offcenter_0.5")]
    got["offcenter_yaw"] = t_[2, 2]
    ok.append(t_[2, 2] > 0.01 and np.sign(t_[2, 2]) == np.sign(mj[2, 2]))
    xy = [0, 1, 3, 4]
    pos = np.mean([np.sqrt(np.mean((golden[n][:, xy] - tr[names.index(n)][:, xy]) ** 2))
                   for n in stable])
    yaw = np.mean([np.sqrt(np.mean(wrap(golden[n][:, 2] - tr[names.index(n)][:, 2]) ** 2))
                   for n in stable])
    got["stable_rmse_mm"], got["stable_rmse_deg"] = 1e3 * pos, np.degrees(yaw)
    ok += [pos < 0.008, np.degrees(yaw) < 16.0]
    ens = tr[len(names):len(names) + 16, -1]
    yaw_e = np.asarray([s[1] for s in starts[len(names):len(names) + 16]])
    got["ens_par"] = (ens[:, 1] + 0.2).mean()
    got["ens_perp"] = np.abs(ens[:, 0] - 0.4).mean()
    got["ens_yaw_deg"] = np.degrees(np.abs(wrap(ens[:, 2] - yaw_e)).mean())
    ok += [0.016 < got["ens_par"] < 0.045, 0.010 < got["ens_perp"] < 0.045,
           3.0 < got["ens_yaw_deg"] < 21.0]
    kn, tw = tr[-2], tr[-1]
    got["knocked_moved"] = np.linalg.norm(kn[3, :2] - [0.4, -0.24])
    got["knocked_drift"] = np.linalg.norm(kn[8, :2] - kn[6, :2])
    got["knocked_spin"] = abs(wrap(kn[8, 2] - kn[6, 2]))
    ok += [got["knocked_moved"] > 0.005, got["knocked_drift"] < 5e-4,
           got["knocked_spin"] < 0.01, tw[7, 4] > -0.11 + 0.005, tw[7, 1] < tw[7, 4]]
    print(f"  MuJoCo golden bands on the card, shipped hash, {B} scripted pushes x {T} steps: "
          f"{json.dumps({k: float(v) for k, v in got.items()})}; "
          f"{sum(map(bool, ok))}/{len(ok)} bands held")
    if not np.isfinite(tr).all() or not all(ok):
        fail("block_push_step on the card left a band of tests/test_block_push_fidelity.py")


def physics_op_count(device):
    """(operations, views): the aten operations one `block_push_step` of
    N_ENVS envs dispatches, views (which launch nothing) counted apart."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from beso_tpu_torch.envs.block_push.env import block_push_reset, block_push_step

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = self.views = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if getattr(func, "is_view", False):
                self.views += 1
            else:
                self.ops += 1
            return func(*args, **(kwargs or {}))

    state = block_push_reset(N_ENVS, torch.Generator(device).manual_seed(27), device)
    with Count() as count:
        block_push_step(state, torch.zeros(N_ENVS, 2, device=device))
    return count.ops, count.views


def run_block_push_main_path(device, card, b1):
    """Phase 12, the shipped block-push config as shipped: multimodal-push
    files written by `export_multimodal_push` (synthetic trajectories),
    loaded by `BlockPushWorkspace(data_path=...)` with the min-max scaler;
    the physics on the card against the CPU (`check_physics_on_card`), the
    shipped dither hash on the card against the CPU (`check_hash_on_card`)
    and the MuJoCo golden bands on the card (`check_fidelity_on_card`);
    an f32 BesoAgent trained MAIN_TRAIN_STEPS steps at batch 1024; its EMA
    model's `fused_cached` engine against the plain `cached` engine at every
    grid sigma (2^-10); then the workspace's evaluation, N_ENVS envs x
    BP_STEPS steps on `fused_cached`, with every fused-layer counter set to 0
    just before it and read just after; then BP_PHYSICS_STEPS steps again
    with a host clock around each physics step (after a device sync).
    `b1`: phase 2's f32 B1 numbers at this shape, printed with the launch
    count as one JSON line. Returns the counts."""
    import torch

    import beso_tpu_torch.rollout.rollout as rollout_mod
    from beso_tpu_torch.agents.beso_agent import BesoAgent, BesoAgentConfig
    from beso_tpu_torch.data.export import export_multimodal_push
    from beso_tpu_torch.data.trajectories import synthetic_push_data
    from beso_tpu_torch.ops import fused_layer as fl
    from beso_tpu_torch.workspaces import BlockPushWorkspace

    data_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_multimodal_push"
    export_multimodal_push(synthetic_push_data(n_traj=64, t_max=100, seed=21), data_dir)
    ws = BlockPushWorkspace(seed=6, data_path=str(data_dir),   # seed: 6 (:5)
                            eval_n_times=N_ENVS,          # eval_n_times: 100 (:61), raised
                            eval_n_steps=BP_STEPS,        # eval_n_steps: 300 (:62), cut
                            scale_data=True,              # scale_data: true (:6)
                            window_size=5, goal_seq_len=1,  # (:8, :7)
                            use_minmax_scaler=True,       # use_minmax_scaler: true (:56)
                            mask_targets=False,           # mask_targets: false (:9)
                            reduce_obs_dim=True,          # reduce_obs_dim: true (:10)
                            train_fraction=0.95,          # train_fraction: 0.95 (:63)
                            device=device)
    check_physics_on_card(device)
    check_hash_on_card(device)
    check_fidelity_on_card(device)
    print(f"  data_path {data_dir.name}: {ws.full_data.num_trajectories} trajectories of "
          f"{ws.full_data.obs_dim} dims, {len(ws.train_set)} train / {len(ws.test_set)} test "
          f"windows, scaler {ws.scaler.kind}")
    if ws.scaler.kind != "minmax":
        fail("the block-push workspace did not fit the min-max scaler")
    records = Records()
    agent = BesoAgent(BesoAgentConfig(**block_push_agent_config()), ws.scaler,
                      metrics_writer=records, device=device)
    agent.init(torch.Generator().manual_seed(22))
    if agent.denoiser.inner_model.dtype != torch.float32:
        fail("the shipped block-push config did not build an f32 model")
    agent.train_agent(ws.train_set, ws.test_set, torch.Generator(device).manual_seed(23))
    torch.cuda.synchronize()
    losses = [r[k] for r in records.rows for k in ("loss", "test_loss") if k in r]
    print(f"  {MAIN_TRAIN_STEPS} f32 train steps at batch {agent.cfg.train_batch_size} "
          f"(adam): losses {losses}")
    if not losses or not all(math.isfinite(x) for x in losses):
        fail("a block-push training loss is not finite")
    check_engine(agent.eval_denoiser(), device, 256, torch.Generator().manual_seed(24),
                 F32_ENGINE_FRACTION, sigma_min=0.05)

    counters = (fl.fused_layer_prefix, fl.fused_layers_prefix_group,
                fl.fused_layer_with_prefix, fl.fused_layer)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    out = ws.test_agent(agent, generator=torch.Generator(device).manual_seed(25),
                        log_metrics=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {c.__name__: c.launches for c in counters}
    want = {c.__name__: 0 for c in counters}
    want["fused_layer_prefix"] = BP_STEPS * NFE * BP_LAYERS
    print(f"  launches: {counts} (expected {want})")
    if counts != want:
        fail(f"the block-push evaluation launched the fused-layer kernels {counts}, not {want}")
    bad = [k for k, v in out.items() if not math.isfinite(v)]
    if bad:
        fail(f"the block-push evaluation's metrics are not finite ({bad})")
    print(f"  evaluation, {N_ENVS} envs x {BP_STEPS} steps on fused_cached (f32): "
          f"{json.dumps(out)}; wall {wall:.3f} s, {N_ENVS * BP_STEPS / wall:.1f} env-steps/s "
          f"(informational; random weights; {card})")

    # where an env step's time goes: a host clock around each physics step,
    # after a device sync, over a shorter evaluation
    real_step, physics = rollout_mod.block_push_step, []

    def clocked_step(state, action):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        result = real_step(state, action)
        torch.cuda.synchronize()
        physics.append(time.perf_counter() - t_start)
        return result

    rollout_mod.block_push_step = clocked_step
    ws.eval_n_steps = BP_PHYSICS_STEPS
    try:
        t0 = time.perf_counter()
        ws.test_agent(agent, generator=torch.Generator(device).manual_seed(26),
                      log_metrics=False)
        torch.cuda.synchronize()
        wall_c = time.perf_counter() - t0
    finally:
        rollout_mod.block_push_step = real_step
        ws.eval_n_steps = BP_STEPS
    if len(physics) != BP_PHYSICS_STEPS:
        fail(f"the clocked evaluation stepped the physics {len(physics)} times")
    t_phys = sum(physics)
    print(f"  clocked {BP_PHYSICS_STEPS}-step evaluation: wall {wall_c:.3f} s, block_push_step "
          f"{t_phys:.3f} s ({100 * t_phys / wall_c:.1f}%, {1e3 * t_phys / len(physics):.2f} ms "
          f"per env step of {N_ENVS} envs), the rest (policy, goals, reset) "
          f"{wall_c - t_phys:.3f} s (host clock; {card})")
    ops, views = physics_op_count(device)
    print(f"  one block_push_step dispatches {ops} aten operations and {views} views "
          f"({ops / 24:.0f} operations per substep)")
    bound_ms, bound_by = bound(*layer_work(2 * N_ENVS, 10, 240, 2, elem=4),
                               PEAK_F32_BF16X3_FLOPS)
    print(json.dumps({"block_push_f32_b1": {
        "shape": "2048 rows x 10 tokens, D=240, 12 heads (hd 20), P=2",
        "launches": counts["fused_layer_prefix"], "ms": b1["ms"], "plain_ms": b1["plain_ms"],
        "gemm_ms": b1["gemm_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
        "env_steps_per_s": N_ENVS * BP_STEPS / wall,
        "physics_share": t_phys / wall_c, "physics_ops_per_step": ops}}))
    return counts


FUSED_WRAPPERS = ("fused_layer_prefix", "fused_layers_prefix_group", "fused_layer_with_prefix",
                  "fused_layer")


def fused_counts():
    """{wrapper: (launches, erf launches)} of the four fused-layer wrappers."""
    from beso_tpu_torch.ops import fused_layer as fl

    return {n: (getattr(fl, n).launches, getattr(fl, n).erf_launches) for n in FUSED_WRAPPERS}


def reset_fused_counts():
    from beso_tpu_torch.ops import fused_layer as fl

    for n in FUSED_WRAPPERS:
        getattr(fl, n).launches = getattr(fl, n).erf_launches = 0


def check_erf_kernels(device, gen, dtype, frac):
    """Phase 13a: the erf GELU form of B1 (every sigma row, epilogue on), B2
    (a group of 2), B3 and B4 at the kitchen shape, 2048 CFG rows, in
    `dtype`, against their plain versions within frac of max |ref|; each
    bit-equal on a second launch, B3 and B2 to erf B1 launches; the erf B1
    launch differs from the tanh one and, in f32, is nearer the erf plain
    version than the tanh one by 4x. Returns {kernel: largest max |diff|}."""
    import torch

    from beso_tpu_torch.ops import fused_layer as fl

    D, H, P, T2 = KITCHEN_LAYER
    S, M, B = 3, 9, 2 * N_ENVS
    erf = dict(approximate_gelu=False)
    tag = str(dtype)[6:]
    (p, epi), (p2, _) = (random_layer(D, H, M, gen, device, dtype) for _ in range(2))

    def rand(*shape):
        return _rand(gen, *shape, device=device, dtype=dtype)

    x8, x11 = rand(B, T2, D), rand(B, 11, D)
    pk, pv, pk2, pv2 = (rand(S, B, P, D) for _ in range(4))
    err = dict.fromkeys(FUSED_WRAPPERS, 0.0)

    def check(kernel, what, launch, plain):
        got, again, ref = launch(), launch(), plain()
        torch.cuda.synchronize()
        got_t, again_t, ref_t = ((v if isinstance(v, tuple) else (v,)) for v in (got, again, ref))
        for part, g_, a_, r_ in zip(("out", "pred"), got_t, again_t, ref_t):
            err[kernel] = max(err[kernel], _rel_check(f"{tag} erf {what} {part}", g_, r_, frac))
            _same_bits(f"{tag} erf {what} {part}, second launch", a_, g_)
        return got

    for row in range(S):
        idx = torch.tensor([row], dtype=torch.int32, device=device)
        check("fused_layer_prefix", f"B1 B={B} row={row} epilogue",
              lambda: fl.fused_layer_prefix(x8, pk, pv, idx, p, n_heads=H, epilogue=epi, **erf),
              lambda: fl.fused_layer_prefix_reference(x8, pk, pv, idx, p, n_heads=H,
                                                      epilogue=epi, **erf))
    idx = torch.tensor([1], dtype=torch.int32, device=device)
    b1 = fl.fused_layer_prefix(x8, pk, pv, idx, p, n_heads=H, **erf)
    # the two forms differ by less than the bounds: the erf launch must
    # differ from the tanh launch, and in f32 be nearer the erf plain version
    tanh = fl.fused_layer_prefix(x8, pk, pv, idx, p, n_heads=H)
    e_erf, e_tanh = ((b1.float() - fl.fused_layer_prefix_reference(
        x8, pk, pv, idx, p, n_heads=H, approximate_gelu=g).float()).abs().max().item()
        for g in (False, True))
    torch.cuda.synchronize()
    print(f"  {tag} erf B1 launch: max|diff| {e_erf:.6g} to the erf plain version, {e_tanh:.6g} "
          f"to the tanh one; equal to the tanh launch: {torch.equal(tanh, b1)}")
    if torch.equal(tanh, b1) or (dtype == torch.float32 and not 4 * e_erf < e_tanh):
        fail(f"the {tag} erf B1 launch cannot be told from the tanh form")
    b3 = check("fused_layer_with_prefix", f"B3 B={B} row=1",
               lambda: fl.fused_layer_with_prefix(x8, pk[1], pv[1], p, n_heads=H, **erf),
               lambda: fl.fused_layer_with_prefix_reference(x8, pk[1], pv[1], p, n_heads=H,
                                                            **erf))
    _same_bits(f"{tag} erf B3 vs erf B1 on row 1", b3, b1)
    b2 = check("fused_layers_prefix_group", f"B2 group 2 B={B}",
               lambda: fl.fused_layers_prefix_group(x8, [pk, pk2], [pv, pv2], idx, [p, p2],
                                                    n_heads=H, **erf),
               lambda: fl.fused_layers_prefix_group_reference(x8, [pk, pk2], [pv, pv2], idx,
                                                              [p, p2], n_heads=H, **erf))
    _same_bits(f"{tag} erf B2 vs 2 erf B1 launches", b2,
               fl.fused_layer_prefix(b1, pk2, pv2, idx, p2, n_heads=H, **erf))
    check("fused_layer", f"B4 B={B} T=11", lambda: fl.fused_layer(x11, p, n_heads=H, **erf),
          lambda: fl.fused_layer_reference(x11, p, n_heads=H, **erf))
    return err


def time_erf_b1(B, device, gen, dtype):
    """Phase 13a: B1 in its tanh and its erf GELU form on the same inputs at
    the kitchen serving shape (one inner layer, no epilogue), timed tanh,
    erf, erf, tanh; returns (tanh ms, erf ms, erf plain ms), each pair's
    mean."""
    import torch

    from beso_tpu_torch.ops import fused_layer as fl

    D, H, P, T2 = KITCHEN_LAYER
    p, _ = random_layer(D, H, 9, gen, device, dtype)
    x = _rand(gen, B, T2, D, device=device, dtype=dtype)
    pk, pv = (_rand(gen, 3, B, P, D, device=device, dtype=dtype) for _ in range(2))
    idx = torch.tensor([1], dtype=torch.int32, device=device)

    def run(tanh):
        return lambda: fl.fused_layer_prefix(x, pk, pv, idx, p, n_heads=H,
                                             approximate_gelu=tanh)

    times = [time_ms(run(tanh), 50, device) for tanh in (True, False, False, True)]
    plain = time_ms(lambda: fl.fused_layer_prefix_reference(x, pk, pv, idx, p, n_heads=H,
                                                            approximate_gelu=False), 10, device)
    return (times[0] + times[3]) / 2, (times[1] + times[2]) / 2, plain


def run_reference_checkpoint_path(device, card, gen):
    """Phase 13b: an f32 and a bf16 kitchen `DiffusionGPT(approximate_gelu=
    False)` through a reference-keyed .pth (`export_torch_state_dict`, then
    `load_torch_checkpoint` into a fresh model: every tensor bit-equal), its
    `fused_cached` engine against `cached` and its uncached engine against
    the plain forward, then an N_ENVS x ERF_ROLLOUT_STEPS kitchen rollout on
    `fused_cached` with every fused-layer counter set to 0 just before it.
    Returns {dtype suffix: erf B1 launches of the rollout}."""
    import torch

    from beso_tpu_torch.models import DiffusionGPT, GCDenoiser
    from beso_tpu_torch.train.checkpoint import (export_torch_state_dict,
                                                 load_reference_weights,
                                                 load_torch_checkpoint)

    model_kw, policy_kw, scale_data = kitchen_config()
    model_kw = {**model_kw, "approximate_gelu": False}
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_reference"
    out_dir.mkdir(parents=True, exist_ok=True)
    launches = {}
    for dtype, suffix, frac in ((torch.float32, "_f32", F32_ENGINE_FRACTION),
                                (torch.bfloat16, "", ERR_FRACTION)):
        tag = str(dtype)[6:]
        src = build_model(model_kw, device, seed=31, dtype=dtype).inner_model
        name = f"model_state_dict_{tag}.pth"
        torch.save(export_torch_state_dict(src.state_dict(), N_LAYERS), out_dir / name)
        model = DiffusionGPT(**model_kw, dtype=dtype).to(device)
        load_reference_weights(model, load_torch_checkpoint(str(out_dir), N_LAYERS, name))
        same = all(torch.equal(v, model.state_dict()[k]) for k, v in src.state_dict().items())
        print(f"  {tag} erf model through {name}: every tensor "
              f"{'bit-equal' if same else 'NOT bit-equal: FAIL'}")
        if not same:
            fail("the reference .pth round trip changed the weights")
        den = GCDenoiser(model, sigma_data=0.5)
        check_engine(den, device, 256, gen, frac)
        before = fused_counts()["fused_layer"]
        check_full_engine(den, device, 256, gen, f"{tag} erf", frac)
        after = fused_counts()["fused_layer"]
        print(f"  uncached engine: {after[1] - before[1]} erf B4 launches of "
              f"{after[0] - before[0]}")
        if after[1] - before[1] != after[0] - before[0] or after[0] == before[0]:
            fail("the erf model's uncached engine did not launch the erf B4 kernel only")
        run_rollout(den, policy_kw, scale_data, N_ENVS, 2, device, seed=1)  # warm-up
        torch.cuda.synchronize()
        reset_fused_counts()
        t0 = time.perf_counter()
        metrics = run_rollout(den, policy_kw, scale_data, N_ENVS, ERF_ROLLOUT_STEPS, device,
                              seed=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = fused_counts()
        n = ERF_ROLLOUT_STEPS * NFE * N_LAYERS
        want = {k: ((n, n) if k == "fused_layer_prefix" else (0, 0)) for k in counts}
        print(f"  {tag} erf rollout, {N_ENVS} envs x {ERF_ROLLOUT_STEPS} steps on fused_cached: "
              f"(launches, erf launches) {counts} (expected {want}); wall {wall:.3f} s, "
              f"{N_ENVS * ERF_ROLLOUT_STEPS / wall:.1f} env-steps/s (informational; {card})")
        if counts != want:
            fail(f"the erf model's rollout launched {counts}, not {want}")
        check_rollout_metrics(metrics, N_ENVS, ERF_ROLLOUT_STEPS)
        launches[suffix] = counts["fused_layer_prefix"][1]
    return launches


def run_evaluation_cli(device, card):
    """Phase 13c: for each shipped evaluation config, the training CLI on its
    model config for MAIN_TRAIN_STEPS steps from phase 11's or 12's data
    files (the final evaluation cut to 8 envs x 3 steps), then
    `beso_tpu_torch.scripts.evaluate` with the evaluation config as shipped
    (block push: its steps cut to CLI_BP_STEPS), then its CFG study at 5
    lambdas x CLI_CFG_STEPS steps; the fused-layer counters set
    to 0 before each evaluation and read after (the "auto" engine is the
    plain cached one: none may launch). Prints env-steps/s over each
    command's wall time, set-up included, and the metrics, which must be
    finite."""
    import torch

    from beso_tpu_torch.scripts import evaluate, training
    from beso_tpu_torch.utils.config import load_config

    repo = Path(__file__).resolve().parent
    build = repo / "build"
    cases = (("kitchen", "franka_kitchen.yaml", "evaluate_kitchen.yaml",
              build / "chip_smoke_relay_kitchen"),
             ("block_push", "block_push.yaml", "evaluate_blocks.yaml",
              build / "chip_smoke_multimodal_push"))
    results = {}
    for name, model_yaml, eval_yaml, data_dir in cases:
        run = build / f"chip_smoke_eval_{name}"
        t0 = time.perf_counter()
        res = training.main(["--config", str(repo / "configs" / model_yaml), "--run-dir",
                             str(run), f"data_path={data_dir}",
                             f"max_train_steps={MAIN_TRAIN_STEPS}",
                             f"eval_every_n_steps={MAIN_TRAIN_STEPS}", "eval_n_times=8",
                             "eval_n_steps=3"])
        torch.cuda.synchronize()
        print(f"  training CLI, {model_yaml}, {MAIN_TRAIN_STEPS} steps from {data_dir.name}: "
              f"{time.perf_counter() - t0:.3f} s, final evaluation (8 envs x 3 steps) "
              f"avrg_reward {res['avrg_reward']:.4f}")
        ev = ["--config", str(repo / "configs" / eval_yaml), f"model_store_path={run}"]
        for study, extra, n_cfg in (
                ("single variant",
                 [f"num_steps_per_run={CLI_BP_STEPS}"] if name == "block_push" else [], 1),
                ("CFG study", ["test_single_variant=false",
                               "compare_classifier_free_guidance=true",
                               f"num_steps_per_run={CLI_CFG_STEPS[name]}"], 5)):
            eval_cfg = load_config(ev[1], extra)
            n_runs, n_steps = eval_cfg["num_runs"], eval_cfg["num_steps_per_run"]
            reset_fused_counts()
            t0 = time.perf_counter()
            out = evaluate.main([*ev, *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = fused_counts()
            vals = ([out[k] for k in ("avrg_reward", "std_reward", "avrg_result", "std_result")]
                    if n_cfg == 1 else out["avrg_rewards"] + out["results"])
            rate = n_runs * n_cfg * n_steps / wall
            print(f"  evaluate CLI, {eval_yaml} {study}: {n_runs} runs x {n_steps} steps x {n_cfg} "
                  f"configuration(s) in {wall:.3f} s, {rate:.1f} env-steps/s (the command's "
                  f"wall, set-up included; random weights; {card}); fused-layer launches "
                  f"{counts}; results {json.dumps(out if n_cfg > 1 else vals)}")
            if any(c != (0, 0) for c in counts.values()):
                fail(f"the evaluation CLI's auto engine launched fused-layer kernels {counts}")
            if not vals or not all(math.isfinite(v) for v in vals):
                fail(f"the evaluation CLI's {eval_yaml} {study} metrics are not finite")
            results[f"{name} {study}"] = {"wall_s": wall, "env_steps_per_s": rate}
    print(json.dumps({"evaluation_cli": results}))


def counted(fn, calls):
    """`fn`, adding one to calls[0] per call: the denoiser calls that the
    launch counts are held to."""
    def wrapped(*args, **kwargs):
        calls[0] += 1
        return fn(*args, **kwargs)

    return wrapped


def policy_window(dn, scaler, cfg, goals, obs_seq, seed, device):
    """`policy_predict` from a reset state over the observations obs_seq,
    its noise from a generator seeded `seed`; the actions [steps, B, A]."""
    import torch

    from beso_tpu_torch.agents.policy import policy_predict, policy_reset

    gen = torch.Generator(device).manual_seed(seed)
    state = policy_reset(goals.shape[0], cfg, device)
    actions = []
    for obs in obs_seq:
        a, state = policy_predict(dn, scaler, state, obs, goals, gen, cfg)
        actions.append(a)
    return torch.stack(actions)


def expect_launches(what, kernel, calls):
    """Fail unless the fused-layer wrappers launched exactly N_LAYERS per
    denoiser call of `kernel` and nothing else since the last reset."""
    counts = fused_counts()
    want = {k: ((N_LAYERS * calls, 0) if k == kernel else (0, 0)) for k in counts}
    if counts != want:
        fail(f"{what} launched {counts}, not {want}")
    return N_LAYERS * calls


def _require_fused_cached(agent):
    if agent.cfg.inference_engine != "fused_cached":
        fail(f"phase 14 needs phase 11's fused_cached agent, not "
             f"{agent.cfg.inference_engine!r}")


def check_samplers_on_card(agent, ws, device, card):
    """Phase 14a: a W+1-step `policy_predict` window, N_ENVS envs with
    lambda=1.5 CFG, for every sampler and Picard, on the engines that the
    fused_cached agent serves the workspaces with: its per-episode factory
    (`make_denoise_factory`: B1 for the grid samplers, B4 for the others)
    and its uncached engine (`make_uncached_denoise_fn`, B4) for the grid
    samplers too; B4 against the plain GCDenoiser forward, B1 against the
    plain `cached` engine, the same generator seed, within
    F32_ENGINE_FRACTION of max |ref|; each engine's launches exactly
    N_LAYERS per denoiser call; dpm_adaptive's accepted and rejected steps
    equal on B4 and the plain forward. Returns {kernel: launches}."""
    import torch

    from beso_tpu_torch.agents.policy import scale_goal_for_model
    from beso_tpu_torch.envs.kitchen.env import INIT_QPOS
    from beso_tpu_torch.envs.kitchen.goals import multigoal_kitchen_goals
    from beso_tpu_torch.models import make_rollout_denoise_factory
    from beso_tpu_torch.models.cached import CACHED_SAFE_SAMPLERS
    from beso_tpu_torch.sampling.dpm_solver import sample_dpm_adaptive
    from beso_tpu_torch.sampling.samplers import SAMPLERS

    _require_fused_cached(agent)
    den = agent.eval_denoiser()
    b4 = agent.make_uncached_denoise_fn()
    goals = torch.as_tensor(multigoal_kitchen_goals(ws.full_data, 2, N_ENVS, ws.seed)[0],
                            device=device)
    gen = torch.Generator().manual_seed(31)
    W = agent.cfg.window_size
    obs_seq = [(torch.as_tensor(INIT_QPOS) + 0.05 * torch.randn(N_ENVS, 30, generator=gen))
               .to(device) for _ in range(W + 1)]
    launches = {"fused_layer": 0, "fused_layer_prefix": 0}
    t0 = time.perf_counter()
    for name in SAMPLERS + ("picard",):
        cfg = agent.policy_config(sampler_type=name)
        served = agent.make_denoise_factory(cfg)(goals)
        if name in CACHED_SAFE_SAMPLERS:
            cached = make_rollout_denoise_factory(den, ws.scaler, cfg, engine="cached")(goals)
            engines = [("fused_layer", "B4 (the agent's uncached engine) vs plain forward",
                        b4, den),
                       ("fused_layer_prefix", "B1 (the agent's factory) vs cached", served,
                        cached)]
        else:
            engines = [("fused_layer", "B4 (the agent's factory) vs plain forward", served,
                        den)]
        for kernel, label, fused, plain in engines:
            calls = [0]
            reset_fused_counts()
            got = policy_window(counted(fused, calls), ws.scaler, cfg, goals, obs_seq, 41,
                                device)
            torch.cuda.synchronize()
            launches[kernel] += expect_launches(f"{name} on {kernel}", kernel, calls[0])
            ref = policy_window(plain, ws.scaler, cfg, goals, obs_seq, 41, device)
            _rel_check(f"{name}, {W + 1} steps x {N_ENVS} envs, {calls[0]} denoiser calls: "
                       f"{label}", got, ref, F32_ENGINE_FRACTION)
    # dpm_adaptive's PID decisions on both engines, one batch of the window
    s = ws.scaler.scale_input(torch.stack(obs_seq[:W], 1))
    g_in = scale_goal_for_model(ws.scaler, goals)
    x = torch.randn(N_ENVS, W, 9, generator=gen).to(device)
    infos = [sample_dpm_adaptive(lambda a, sig, fn=fn: fn(s, a, g_in, sig), x, 0.005, 1.0,
                                 return_info=True) for fn in (b4, den)]
    print(f"  dpm_adaptive on B4 {infos[0][1]}, on the plain forward {infos[1][1]}")
    if infos[0][1] != infos[1][1]:
        fail("dpm_adaptive accepted or rejected other steps on B4 than on the plain forward")
    _rel_check("dpm_adaptive, B4 vs plain forward", infos[0][0], infos[1][0],
               F32_ENGINE_FRACTION)
    print(f"  {len(SAMPLERS) + 1} samplers in {time.perf_counter() - t0:.3f} s; launches "
          f"{launches} ({card})")
    return launches


def _workspace_eval(ws, n_steps, **kw):
    """`ws.test_agent` at N_ENVS envs x n_steps steps, its wall seconds
    (device synced) and metrics; the workspace's sizes restored after."""
    import torch

    old = ws.eval_n_times, ws.eval_n_steps
    ws.eval_n_times, ws.eval_n_steps = N_ENVS, n_steps
    t0 = time.perf_counter()
    try:
        out = ws.test_agent(log_metrics=False, **kw)
    finally:
        ws.eval_n_times, ws.eval_n_steps = old
    torch.cuda.synchronize()
    vals = [out[k] for k in ("avrg_reward", "std_reward", "avrg_result", "std_result")]
    if not all(math.isfinite(v) for v in vals):
        fail(f"the workspace evaluation {kw} gave metrics that are not finite: {vals}")
    return time.perf_counter() - t0, out


def check_multi_sample_on_card(agent, ws, device, card):
    """Phase 14b: N_SAMPLES action samples per env with the mean and the
    KDE aggregation, on the engine the fused_cached agent's factory gives
    such a config (B4, N_ENVS x N_SAMPLES x 2 CFG rows per call): the first
    step against the plain forward (mean: the actions; KDE: the candidates,
    and B4's pick a maximum of the plain candidates' density within
    F32_ENGINE_FRACTION); then the workspace's multigoal evaluation with
    the same overrides (`test_agent(get_mean=, aggregation=)`), N_ENVS envs
    x MS_STEPS steps, with exactly N_LAYERS B4 launches per denoiser call
    (NFE per step) and finite metrics. Returns the B4 launches."""
    import torch

    from beso_tpu_torch.agents import policy
    from beso_tpu_torch.envs.kitchen.goals import multigoal_kitchen_goals

    _require_fused_cached(agent)
    den = agent.eval_denoiser()
    goals = torch.as_tensor(multigoal_kitchen_goals(ws.full_data, 2, N_ENVS, ws.seed)[0],
                            device=device)
    obs = ws.full_data.observations[:1, 0, :30].repeat(N_ENVS, 0)
    obs = torch.as_tensor(obs, device=device)
    launches = 0
    for agg in ("mean", "kde"):
        cfg = agent.policy_config(n_action_samples=N_SAMPLES, aggregation=agg)
        b4 = agent.make_denoise_factory(cfg)(goals)
        cands, real = [], policy._kde_select
        policy._kde_select = lambda c: cands.append(c) or real(c)
        calls = [0]
        reset_fused_counts()
        try:
            first = [policy.policy_predict(fn, ws.scaler, policy.policy_reset(N_ENVS, cfg, device),
                                           obs, goals, torch.Generator(device).manual_seed(51),
                                           cfg)[0] for fn in (counted(b4, calls), den)]
        finally:
            policy._kde_select = real
        torch.cuda.synchronize()
        expect_launches(f"the agent's {agg} engine", "fused_layer", calls[0])
        if agg == "mean":
            _rel_check(f"mean of {N_SAMPLES}, first step: B4 vs plain forward", *first,
                       F32_ENGINE_FRACTION)
        else:
            _rel_check(f"KDE candidates ({N_SAMPLES} per env), first step: B4 vs plain "
                       f"forward", *cands, F32_ENGINE_FRACTION)
            dens = policy.kde_density(cands[1])
            pick = policy.kde_density(cands[0]).argmax(-1)
            at_pick = dens.gather(1, pick[:, None])[:, 0]
            near_max = at_pick >= dens.max(-1).values * (1 - F32_ENGINE_FRACTION)
            same = int((pick == dens.argmax(-1)).sum())
            print(f"  KDE picks: {same} of {N_ENVS} envs pick the plain forward's candidate; "
                  f"{int(near_max.sum())} of {N_ENVS} pick a maximum of its density within "
                  f"{F32_ENGINE_FRACTION:.6g}")
            if not bool(near_max.all()):
                fail("a KDE pick on B4 is not a density maximum of the plain candidates")
        reset_fused_counts()
        wall, mg = _workspace_eval(ws, MS_STEPS, agent=agent, get_mean=N_SAMPLES,
                                   aggregation=agg,
                                   generator=torch.Generator(device).manual_seed(52))
        n = expect_launches(f"the workspace's {agg} evaluation", "fused_layer",
                            MS_STEPS * NFE)
        launches += n
        print(f"  workspace test_agent(get_mean={N_SAMPLES}, aggregation={agg!r}): {N_ENVS} "
              f"envs x {MS_STEPS} steps on B4 ({2 * N_SAMPLES * N_ENVS} rows per call), {n} "
              f"B4 launches, avrg result {mg['avrg_result']:.4f}; wall {wall:.3f} s, "
              f"{N_ENVS * MS_STEPS / wall:.1f} env-steps/s (informational; {card})")
    return launches


def run_sequential_on_card(agent, ws, device, card):
    """Phase 14c: the workspace's sequential evaluation
    (`test_agent(evaluate_sequential=True)`, `rollout_kitchen_sequential`
    on the agent's uncached engine: the goal changes per env mid-episode,
    so no prefix cache), N_ENVS envs x N_STEPS steps on B4, exactly
    N_LAYERS launches per denoiser call (NFE per step), finite metrics,
    env-steps/s. Returns the B4 launches."""
    import torch

    _require_fused_cached(agent)
    reset_fused_counts()
    wall, out = _workspace_eval(ws, N_STEPS, agent=agent, evaluate_multigoal=False,
                                evaluate_sequential=True,
                                generator=torch.Generator(device).manual_seed(61))
    launches = expect_launches("the workspace's sequential evaluation", "fused_layer",
                               N_STEPS * NFE)
    print(f"  workspace test_agent(evaluate_sequential=True), {N_ENVS} envs x {N_STEPS} steps "
          f"on B4: {launches} launches, avrg result {out['avrg_result']:.4f}; wall "
          f"{wall:.3f} s, {N_ENVS * N_STEPS / wall:.1f} env-steps/s (informational; {card})")
    return launches


def check_kitchen_fidelity_on_card(device):
    """Phase 14d: the scripted batch of tests/kitchen_scenarios.py (microwave
    drags, kettle grasps, tracking and release), its actions found on the
    CPU, replayed by `kitchen_step` on the card (one kernel launch per step)
    and on the CPU: states within 1e-5, the same grasps, and every golden
    band of the batch held on the card's outcome. The bands on the shipped constants alone do not depend
    on the device and are held on the CPU only
    (tests/test_torch_kitchen_fidelity.py)."""
    import numpy as np

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import kitchen_scenarios

    from beso_tpu_torch.ops import kitchen_step as ks

    script = kitchen_scenarios.script_kitchen_scenarios()
    cpu = kitchen_scenarios.replay(*script, "cpu")
    before = ks.kitchen_step.launches
    card = kitchen_scenarios.replay(*script, device)
    launches = ks.kitchen_step.launches - before
    err = max(float(np.abs(card.qpos - cpu.qpos).max()), float(np.abs(card.ee - cpu.ee).max()))
    bands = kitchen_scenarios.kitchen_bands(card)
    failed = [name for name, (held, _) in bands.items() if not held]
    print(f"  {kitchen_scenarios.N_STEPS} scripted kitchen_step steps x 6 envs on the card: "
          f"max |card - CPU| {err:.3g} over qpos and fingertip; grasps equal: "
          f"{bool((card.grasped == cpu.grasped).all())}; {launches} kitchen_step kernel "
          f"launches; {len(bands) - len(failed)} of "
          f"{len(bands)} bands held: " + json.dumps({k: v for k, (_, v) in bands.items()}))
    if launches != kitchen_scenarios.N_STEPS:
        fail(f"{launches} kitchen_step kernel launches, expected one per step")
    if err > 1e-5 or not (card.grasped == cpu.grasped).all():
        fail("kitchen_step on the card left the CPU's trajectory")
    if failed:
        fail(f"kitchen bands left on the card: {failed}")


def run_cli_modes(card):
    """Phase 14e: the evaluation CLI's sampler study (`test_all_samplers`) and
    noisy-sampler study (`compare_noisy_sampler`) on the shipped
    `configs/evaluate_kitchen.yaml` (100 runs) with `inference_engine=
    fused_cached`, on phase 13c's kitchen run, num_steps_per_run cut from
    280 to CLI_STEPS: every configuration's engine from the agent's factory,
    its denoiser calls counted, exactly N_LAYERS launches per call of B1
    (configs the prefix cache serves) and of B4 (the others), both kernels
    launched, finite results; prints each command's seconds. Returns the
    launches of each kernel."""
    import torch

    from beso_tpu_torch.agents.beso_agent import BesoAgent
    from beso_tpu_torch.models.cached import CACHED_SAFE_SAMPLERS
    from beso_tpu_torch.scripts import evaluate

    calls = {"fused_layer": [0], "fused_layer_prefix": [0]}
    real = BesoAgent.make_denoise_factory

    def factory(self, cfg, params=None):
        make = real(self, cfg, params)
        cached = (cfg.sampler_type in CACHED_SAFE_SAMPLERS and not cfg.s_churn
                  and cfg.n_action_samples == 1)
        tally = calls["fused_layer_prefix" if cached else "fused_layer"]
        return lambda goals: counted(make(goals), tally)

    repo = Path(__file__).resolve().parent
    ev = ["--config", str(repo / "configs" / "evaluate_kitchen.yaml"),
          f"model_store_path={repo / 'build' / 'chip_smoke_eval_kitchen'}",
          f"num_steps_per_run={CLI_STEPS}", "test_single_variant=false",
          "inference_engine=fused_cached"]
    results = {}
    BesoAgent.make_denoise_factory = factory
    try:
        for mode in ("test_all_samplers", "compare_noisy_sampler"):
            for c in calls.values():
                c[0] = 0
            reset_fused_counts()
            t0 = time.perf_counter()
            out = evaluate.main([*ev, f"{mode}=true"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = fused_counts()
            want = {k: (N_LAYERS * calls[k][0] if k in calls else 0, 0) for k in counts}
            if counts != want or not all(c[0] for c in calls.values()):
                fail(f"the evaluation CLI's {mode} launched {counts}, not {want} (both "
                     f"kernels launched)")
            vals = out["avrg_rewards"] + out["results"]
            if not all(math.isfinite(v) for v in vals):
                fail(f"the evaluation CLI's {mode} results are not finite")
            print(f"  evaluate CLI, evaluate_kitchen.yaml {mode} inference_engine=fused_cached: "
                  f"{len(out['labels'])} samplers x 100 runs x {CLI_STEPS} steps in {wall:.3f} s "
                  f"(the command's wall, set-up included; {card}); launches "
                  f"{ {k: v[0] for k, v in counts.items() if v[0]} }; results {json.dumps(out)}")
            results[mode] = {"wall_s": wall, "samplers": out["labels"],
                             "launches": {k: N_LAYERS * c[0] for k, c in calls.items()}}
    finally:
        BesoAgent.make_denoise_factory = real
    print(json.dumps({"evaluation_cli_modes": results}))
    return {k: sum(r["launches"][k] for r in results.values()) for k in calls}


class Records:
    """In-memory metrics writer: keeps every record the trainer logs."""

    def __init__(self):
        self.rows = []

    def log(self, metrics, step=None):
        self.rows.append({"_time": time.perf_counter(), "_step": step, **metrics})


# ---- phase 15: the vision path ------------------------------------------------

def _recording(module, name, store):
    """Replace `module.name` by a wrapper that keeps each call's result and
    wall seconds (after a device sync) in `store[name]`; returns the undo."""
    import torch

    real = getattr(module, name)

    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        store.setdefault(name, []).append((out, time.perf_counter() - t0))
        return out

    setattr(module, name, wrapped)
    return lambda: setattr(module, name, real)


def run_demo_generation(card):
    """Phase 15a: `generate_demos` through its CLI on the card, block push
    (DEMO_EPISODES x 160 steps) and kitchen (x 280): the files read back by
    the port's loaders equal the oracle's rollout; the JAX tests' bands on
    the card's outcome (tests/test_oracle.py: both blocks done in >= 90% of
    the episodes, >= 1.5 labels per episode, actions within the env's cap;
    tests/test_kitchen_oracle.py: >= 3.8 of the 4 assigned tasks); seconds
    and env-steps/s of each command. Returns {env: observations [N, T, D]}."""
    import numpy as np
    import torch

    from beso_tpu_torch.data.trajectories import load_multimodal_push, load_relay_kitchen
    from beso_tpu_torch.envs.block_push import oracle as bp_oracle
    from beso_tpu_torch.envs.kitchen import oracle as k_oracle
    from beso_tpu_torch.scripts import generate_demos

    out_obs = {}
    for env, steps, module, fn in (("block_push", 160, bp_oracle, "rollout_oracle"),
                                   ("kitchen", 280, k_oracle, "rollout_kitchen_oracle")):
        runs = {}
        undo = _recording(module, fn, runs)
        out = Path("build") / f"chip_smoke_demos_{env}"
        t0 = time.perf_counter()
        try:
            generate_demos.main(["--env", env, "--out", str(out), "--episodes",
                                 str(DEMO_EPISODES), "--seed", "0"])
        finally:
            undo()
        secs = time.perf_counter() - t0
        rollout, _ = runs[fn][0]
        obs, act = rollout[0].cpu().numpy(), rollout[1].cpu().numpy()
        data = (load_multimodal_push(out, onehot_goals=True, reduce_obs_dim=False)
                if env == "block_push" else load_relay_kitchen(out, onehot_goals=True))
        if data.observations.shape != obs.shape or not np.array_equal(data.observations, obs):
            fail(f"{env} demos read back from {out} differ from the oracle's rollout")
        if not np.isfinite(obs).all():
            fail(f"{env} demos not finite")
        labels = float(data.onehot_goals.sum((1, 2)).mean())
        if env == "block_push":
            both = float((rollout[2].sum(1) >= 2).float().mean())
            cap = float(np.abs(act).max())
            band = f"both blocks done in {both:.4f} of the episodes (>= 0.9), " \
                   f"{labels:.3f} labels per episode (>= 1.5), max |action| {cap:.4f} (<= 0.1)"
            ok = both >= 0.9 and labels >= 1.5 and cap <= 0.1 + 1e-6
        else:
            completed, seqs = rollout[2].cpu().numpy(), rollout[4].cpu().numpy()
            assigned = float(np.mean([completed[i, s[s >= 0]].sum()
                                      for i, s in enumerate(seqs)]))
            band = f"{assigned:.4f} of 4 assigned tasks done (>= 3.8), {labels:.3f} labels " \
                   f"per episode"
            ok = assigned >= 3.8
        print(f"  {env}: {DEMO_EPISODES} episodes x {steps} steps in {secs:.3f} s of command "
              f"time ({DEMO_EPISODES * steps / secs:,.1f} env-steps/s; rollout "
              f"{runs[fn][0][1]:.3f} s), read back equal; {band} ({card})")
        if not ok:
            fail(f"{env} oracle demos outside the JAX tests' bands")
        out_obs[env] = obs
    return out_obs


def _pixel_share(what, got, ref):
    bad = ((got - ref).abs() > PIXEL_TOL).any(-1)
    share = bad.float().mean().item()
    print(f"  {what}: {int(bad.sum())} of {bad.numel()} pixels off by > {PIXEL_TOL} "
          f"({100 * share:.4f}%; max {(got - ref).abs().max().item():.3g})")
    if share > PIXEL_SHARE:
        fail(f"{what}: {share:.4f} of the pixels differ from the CPU's")


def check_cameras_on_card(device, card, demo_obs):
    """Phase 15b: both cameras at 128 x 128 on RENDER_FRAMES demo frames,
    the card's render against the port's CPU render of the same
    observations by pixel share (block push RGB and masks, kitchen RGB);
    then ms per RENDER_BATCH-frame batch on the card (CUDA events) and the
    peak memory of one."""
    import numpy as np
    import torch

    from beso_tpu_torch.envs.block_push.camera import render_obs_masks, render_obs_rgb
    from beso_tpu_torch.envs.kitchen.camera import render_kitchen_obs_rgb

    rng = np.random.RandomState(15)
    cams = (("block_push", "rgb", render_obs_rgb), ("block_push", "masks", render_obs_masks),
            ("kitchen", "rgb", render_kitchen_obs_rgb))
    for env, what, render in cams:
        flat = demo_obs[env].reshape(-1, demo_obs[env].shape[-1])
        frames = torch.as_tensor(flat[rng.choice(len(flat), RENDER_BATCH, replace=False)])
        with torch.no_grad():
            got = render(frames[:RENDER_FRAMES].to(device), 128, 128).cpu()
            ref = render(frames[:RENDER_FRAMES], 128, 128)
            _pixel_share(f"{env} {what}, {RENDER_FRAMES} frames, card vs CPU", got, ref)
            batch = frames.to(device)
            ms = time_ms(lambda: render(batch, 128, 128), 5, device)
            torch.cuda.reset_peak_memory_stats()
            render(batch, 128, 128)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  {env} {what}: {ms:.3f} ms per {RENDER_BATCH}-frame batch at 128 x 128, "
              f"peak {peak:.2f} GiB ({card})")


def _vision_models(kind, dtype, device, seed=0):
    """A vision policy at the script's widths (128 px, embed 48, encoder
    (24, 48, 64); block push 4 x 240 x 12 heads, kitchen 6 x 360 x 6), no
    dropout and no goal masking, so that a train-mode loss draws nothing."""
    import torch

    from beso_tpu_torch.models.vision_policy import KitchenVisionPolicyGPT, VisionPolicyGPT

    cls = VisionPolicyGPT if kind == "block_push" else KitchenVisionPolicyGPT
    return cls(attn_pdrop=0.0, resid_pdrop=0.0, dtype=dtype,
               generator=torch.Generator().manual_seed(seed)).to(device)


def check_vision_grads_on_card(device, card, demo_obs):
    """Phase 15c: both vision policies at full width, batch
    VISION_GRAD_BATCH of demo windows: the f32 EDM loss and every gradient
    on the card against the CPU with the same weights, sigma and noise,
    within VISION_GRAD_FRACTION of max |ref| (both sides encode the CPU's
    renders, so this holds the encoder and the GPT; 15b holds the renders);
    then the bf16 policy's forward against the f32 one on the card
    (ERR_FRACTION)."""
    import numpy as np
    import torch

    from beso_tpu_torch.models.denoiser import GCDenoiser

    B = VISION_GRAD_BATCH
    rng = np.random.RandomState(16)
    for kind, T, G, A in (("block_push", 5, 1, 2), ("kitchen", 4, 2, 9)):
        obs = demo_obs[kind]
        ep = rng.randint(0, obs.shape[0], B)
        t0 = rng.randint(0, obs.shape[1] - T - G - 10, B)
        states = np.stack([obs[e, s:s + T] for e, s in zip(ep, t0)])
        goals = np.stack([obs[e, s + T + 10:s + T + 10 + G] for e, s in zip(ep, t0)])
        if kind == "block_push":
            goals[..., 6:] = 0.0
        inputs = [torch.as_tensor(a, dtype=torch.float32) for a in (
            states, rng.uniform(-1, 1, (B, T, A)), goals, rng.randn(B, T, A),
            np.exp(rng.uniform(np.log(0.05), 0.0, B)))]
        cpu = _vision_models(kind, torch.float32, "cpu")
        dev = _vision_models(kind, torch.float32, device)
        dev.load_state_dict(cpu.state_dict())
        dev.render = lambda o, _cpu=cpu: _cpu.render(o.cpu()).to(device)
        losses, grads = [], []
        for model, d in ((cpu, "cpu"), (dev, device)):
            x = [a.to(d) for a in inputs]
            loss = GCDenoiser(model, 0.5).loss(x[0], x[1], x[2], x[3], x[4], train=True)
            loss.backward()
            losses.append(loss.detach().cpu())
            grads.append({n: p.grad.detach().cpu() for n, p in model.named_parameters()})
        print(f"  {kind}: loss {losses[0].item():.6f} (CPU), {losses[1].item():.6f} (card)")
        _rel_check(f"{kind} f32 loss, card vs CPU", losses[1], losses[0], VISION_GRAD_FRACTION)
        worst = max(((grads[1][n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30), n)
                    for n, g in grads[0].items())
        print(f"  {kind}: {len(grads[0])} gradient tensors, worst max|diff| / max|ref| "
              f"{worst[0]:.3g} ({worst[1]}; limit {VISION_GRAD_FRACTION:.3g})")
        if not worst[0] <= VISION_GRAD_FRACTION:
            fail(f"{kind} vision gradient {worst[1]} on the card disagrees with the CPU")
        bf = _vision_models(kind, torch.bfloat16, device)
        bf.load_state_dict(cpu.state_dict())
        with torch.no_grad():
            x = [a.to(device) for a in inputs]
            ref = dev(x[0], x[1], x[2], x[4])
            got = bf(x[0], x[1], x[2], x[4])
        _rel_check(f"{kind} bf16 forward vs f32, on the card", got, ref, ERR_FRACTION)


def run_vision_cli(card):
    """Phase 15d: `validate_vision_e2e` through its CLI at the script's widths
    (128 px, batch 256, embed 48, 1024 episodes, bf16 policies), the
    block-push demos cut to VISION_BP_DEMO_STEPS steps, train steps cut to
    VISION_TRAIN_STEPS and the evaluation (100 envs) to
    VISION_EVAL_STEPS: block push with --pretrain-steps
    VISION_PRETRAIN_STEPS, then kitchen. The JSON line parses and is finite;
    prints train steps/s, peak memory, demo seconds and evaluation
    env-steps/s. Returns {env: JSON}."""
    import contextlib
    import io

    import torch

    from beso_tpu_torch.scripts import validate_vision_e2e as vcli

    saved = vcli.EVAL_STEPS, vcli.DEMO_STEPS
    vcli.EVAL_STEPS = {"block_push": VISION_EVAL_STEPS, "kitchen": VISION_EVAL_STEPS}
    vcli.DEMO_STEPS = {**vcli.DEMO_STEPS, "block_push": VISION_BP_DEMO_STEPS}
    results = {}
    try:
        for env, extra in (("block_push", ["--pretrain-steps", str(VISION_PRETRAIN_STEPS)]),
                           ("kitchen", [])):
            timed = {}
            undo = [_recording(vcli, name, timed) for name in (
                "generate_demonstrations", "generate_kitchen_demonstrations",
                "rollout_block_push", "rollout_kitchen", "pretrain_state_regression")]
            torch.cuda.reset_peak_memory_stats()
            buf = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    vcli.main(["--env", env, "--train-steps", str(VISION_TRAIN_STEPS),
                               *extra])
            finally:
                for u in undo:
                    u()
            secs = time.perf_counter() - t0
            line = buf.getvalue().strip().splitlines()[-1]
            print(f"  {line}")
            out = json.loads(line)
            bad = [k for k, v in out.items() if isinstance(v, float) and not math.isfinite(v)]
            if bad:
                fail(f"validate_vision_e2e --env {env}: not finite: {bad}")
            demo_s = sum(s for name in ("generate_demonstrations",
                                        "generate_kitchen_demonstrations")
                         for _, s in timed.get(name, []))
            eval_s = sum(s for name in ("rollout_block_push", "rollout_kitchen")
                         for _, s in timed.get(name, []))
            pre = "".join(f", pretraining {s:.3f} s" for _, s in
                          timed.get("pretrain_state_regression", []))
            print(f"  {env}: {secs:.3f} s of command time; demos {demo_s:.3f} s{pre}; "
                  f"{out['train_steps_per_sec']} train steps/s (the CLI's, over "
                  f"{VISION_TRAIN_STEPS} steps with its evaluations); evaluation 100 x "
                  f"{VISION_EVAL_STEPS} in {eval_s:.3f} s ({100 * VISION_EVAL_STEPS / eval_s:,.1f}"
                  f" env-steps/s); peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
                  f"({card})")
            results[env] = out
    finally:
        vcli.EVAL_STEPS, vcli.DEMO_STEPS = saved
    return results


def profile_vision_step(device, card):
    """Phase 15e (information): where one block-push vision train step's
    device time goes, torch.profiler over 3 steps of the script's model at
    batch VISION_PROFILE_BATCH after 2 of warm-up: the render, the
    convolutions, the GPT and the optimizer by kernel-name family."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from beso_tpu_torch.models.denoiser import GCDenoiser

    B, T = VISION_PROFILE_BATCH, 5
    model = _vision_models("block_push", torch.bfloat16, device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    rng = np.random.RandomState(17)
    obs = torch.as_tensor(np.tile(np.asarray(
        [0.4, -0.2, 0.3, 0.5, -0.1, 1.0, 0.3, -0.4, 0.3, -0.4, 0.28, 0.2, 3.1, 0.52, 0.2, 3.1],
        np.float32), (B, T + 1, 1)) + rng.uniform(-0.05, 0.05, (B, T + 1, 16)).astype(
        np.float32), device=device)
    den = GCDenoiser(model, 0.5)

    def step():
        with record_function("vision_train_step"):
            a = torch.randn(B, T, 2, device=device)
            loss = den.loss(obs[:, :T], a, obs[:, T:], torch.randn_like(a),
                            torch.rand(B, device=device) + 0.05, train=True)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3 * 1e3
    families = {"conv": ("conv", "cudnn", "implicit", "wgrad", "dgrad", "sm90_xmma", "nchw",
                         "nhwc"),
                "gemm": ("gemm", "cutlass", "cublas", "sm90_", "ampere_", "matmul"),
                "optimizer": ("adam", "foreach", "multi_tensor")}
    total, by = 0.0, {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0))
        if ev.key == "vision_train_step" or dev_us <= 0:
            continue
        name = ev.key.lower()
        fam = next((f for f, keys in families.items() if any(k in name for k in keys)),
                   "elementwise (render, GELU, LN, softmax, casts)")
        by[fam] = by.get(fam, 0.0) + dev_us
        total += dev_us
    if total <= 0:
        print(f"  torch.profiler saw no device time: not measured ({card})")
        return
    shares = ", ".join(f"{f} {us / 3e3:.2f} ms ({100 * us / total:.1f}%)"
                       for f, us in sorted(by.items(), key=lambda kv: -kv[1]))
    print(f"  block-push vision train step, batch {B} (bf16): {wall:.2f} ms of wall, "
          f"{total / 3e3:.2f} ms of device time ({100 - 100 * total / 3e3 / wall:.1f}% idle); "
          f"{shares} ({card})")



# ---- phase 16: the training tools --------------------------------------------

def _flash_fns():
    from beso_tpu_torch.ops import flash_attention as fa

    return fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv


def flash_launches() -> dict:
    return {f.__name__: f.launches for f in _flash_fns()}


def reset_flash_launches() -> None:
    for f in _flash_fns():
        f.launches = 0


def check_flash_seed_axis(device, card):
    """Phase 16a: B5 and B6 under `torch.func.vmap` over a leading seed axis
    (the sweep's rule) at SEED_AXIS_SHAPES, bf16: the forward and the
    backward (`.backward()` outside the map) bit-equal to one launch on the
    folded [S*B, H, T, hd] tensors, and exactly one launch of each kernel
    per call; a backward inside the map (`vmap(grad)`) also one launch each;
    the folded launches within ERR_FRACTION of max |ref| of the plain
    versions. Returns {(S, hd): vmapped ms, folded ms} of forward + backward,
    each the median host wall of SEED_AXIS_REPS synced calls, alternating
    (the map's cost is on the host)."""
    import torch

    from beso_tpu_torch.ops import flash_attention as fa

    times = {}
    for shape in SEED_AXIS_SHAPES:
        S, B, H, T, hd = shape
        gen = torch.Generator(device).manual_seed(S)
        q, k, v, do = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
                       for _ in range(4))
        fold = [x.reshape(S * B, H, T, hd) for x in (q, k, v, do)]
        o_ref, lse_ref = fa.flash_forward(*fold[:3])
        dq_ref, delta = fa.flash_backward_dq(*fold[:3], o_ref, fold[3], lse_ref)
        dk_ref, dv_ref = fa.flash_backward_dkv(*fold[:3], fold[3], lse_ref, delta)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        torch.cuda.synchronize()
        reset_flash_launches()
        o = torch.func.vmap(fa.flash_attention)(*leaves)
        o.backward(do)
        torch.cuda.synchronize()
        outer = flash_launches()
        same = [torch.equal(o.reshape(S * B, H, T, hd), o_ref)] + [
            torch.equal(x.grad.reshape(S * B, H, T, hd), ref)
            for x, ref in zip(leaves, (dq_ref, dk_ref, dv_ref))]

        def f(q, k, v, do):
            return (fa.flash_attention(q, k, v).float() * do.float()).sum()

        reset_flash_launches()
        grads = torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2)))(q, k, v, do)
        torch.cuda.synchronize()
        inner = flash_launches()
        inner_err = max(((g.reshape(S * B, H, T, hd).float() - r.float()).abs().max()
                         / r.float().abs().max()).item()
                        for g, r in zip(grads, (dq_ref, dk_ref, dv_ref)))
        p_o, p_lse = fa.flash_forward_reference(*fold[:3])
        p_dq, p_delta = fa.flash_backward_dq_reference(*fold[:3], p_o, fold[3], p_lse)
        p_dk, p_dv = fa.flash_backward_dkv_reference(*fold[:3], fold[3], p_lse, p_delta)
        plain_err = max(((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
                        for got, ref in ((o_ref, p_o), (dq_ref, p_dq), (dk_ref, p_dk),
                                         (dv_ref, p_dv)))

        def vmapped():
            x = [t.detach().requires_grad_() for t in (q, k, v)]
            torch.func.vmap(fa.flash_attention)(*x).backward(do)

        def folded():
            x = [t.detach().requires_grad_() for t in fold[:3]]
            fa.flash_attention(*x).backward(fold[3])

        def wall_ms(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        for _ in range(3):
            vmapped(), folded()
        walls = [(wall_ms(vmapped), wall_ms(folded)) for _ in range(SEED_AXIS_REPS)]
        times[S, hd] = tuple(sorted(w)[len(w) // 2] for w in zip(*walls))
        print(f"  seed axis {list(shape)} bf16: bit-equal to the folded launch "
              f"{dict(zip(('o', 'dq', 'dk', 'dv'), same))}; launches per call, backward "
              f"outside the map {outer}, inside it (vmap(grad)) {inner} (its gradients within "
              f"{inner_err:.3g} of max |ref|); folded launches vs plain {plain_err:.3g} of max "
              f"|ref| (bound {ERR_FRACTION:.3g}); forward + backward, median of "
              f"{SEED_AXIS_REPS} synced calls alternating: {times[S, hd][0]:.4f} ms vmapped, "
              f"{times[S, hd][1]:.4f} ms folded ({card})")
        if not all(same):
            fail(f"the vmapped flash kernels at {list(shape)} differ from the folded launch")
        if outer != dict.fromkeys(outer, 1) or inner != dict.fromkeys(inner, 1):
            fail(f"a vmapped flash call at {list(shape)} launched {outer} / {inner}, not one "
                 f"launch of each kernel")
        if not (plain_err <= ERR_FRACTION and inner_err <= ERR_FRACTION):
            fail(f"the flash kernels at {list(shape)} disagree with their plain versions")
    return times


def _timed_sweep_steps(store):
    """Wrap `train/sweep.py::make_sweep_train_steps` so that each fused call
    is timed between two device syncs and its losses kept in `store`
    (a list of (seconds, losses [S, n])); returns the undo."""
    import torch

    from beso_tpu_torch.train import sweep as tsweep

    real = tsweep.make_sweep_train_steps

    def make(*a, **kw):
        fused = real(*a, **kw)

        def timed(ss, generators):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ss, losses = fused(ss, generators)
            torch.cuda.synchronize()
            store.append((time.perf_counter() - t0, losses.detach().float().cpu()))
            return ss, losses
        return timed

    tsweep.make_sweep_train_steps = make

    def undo():
        tsweep.make_sweep_train_steps = real
    return undo


def run_sweep_cli(config, seeds, run_dir, overrides):
    """`beso_tpu_torch.scripts.sweep` through its `main`: (summary, flash
    launches of the command, train steps/s over its timed fused calls, the
    per-step losses [S, steps], the command's seconds)."""
    import torch

    from beso_tpu_torch.scripts import sweep

    store = []
    undo = _timed_sweep_steps(store)
    torch.cuda.synchronize()
    reset_flash_launches()
    t0 = time.perf_counter()
    try:
        summary = sweep.main(["--config", str(config), "--seeds", ",".join(map(str, seeds)),
                              "--run-dir", str(run_dir), *overrides])
    finally:
        undo()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = flash_launches()
    losses = torch.cat([l for _, l in store], dim=1)
    rate = losses.shape[1] / sum(s for s, _ in store)
    return summary, launches, rate, losses, secs


def single_seed_losses(config, overrides, seed, device):
    """The per-step losses of one run of its own on `seed`'s draws:
    `make_fused_train_steps` on the model `BesoAgent.init` draws from
    `seed`, the train stream seeded seed + 1 after its evaluation child, as
    the sweep's seed `seed` trains."""
    import numpy as np
    import torch

    from beso_tpu_torch.agents.beso_agent import BesoAgent
    from beso_tpu_torch.scripts.training import build_agent_config, build_workspace
    from beso_tpu_torch.train.trainer import _child_generator, make_fused_train_steps
    from beso_tpu_torch.utils.config import load_config

    cfg = load_config(config, overrides)
    np.random.seed(seed)
    ws = build_workspace(cfg, device)
    agent = BesoAgent(build_agent_config(cfg), ws.scaler, device=device)
    agent.init(torch.Generator().manual_seed(seed))
    gen = torch.Generator(device).manual_seed(seed + 1)
    _child_generator(gen)
    fused = make_fused_train_steps(agent.denoiser, agent.sample_density, ws.scaler,
                                   ws.train_set, cfg["train_batch_size"],
                                   cfg["max_train_steps"], ema_decay=cfg["decay"])
    _, losses = fused(agent.state, gen)
    return losses.float().cpu()


def profile_sweep_steps(config, overrides, device, card):
    """Phase 16b, information: where a step of the chunked sweep spends its
    time. SWEEP_PROFILE_STEPS steps of SWEEP_SEEDS stacked seeds, then of
    one seed, each after a warm-up call, under `profile_train.profile_window`:
    the device's busy time against the wall time of the same window."""
    import torch

    from beso_tpu_torch.agents.beso_agent import BesoAgent
    from beso_tpu_torch.scripts.profile_train import profile_window
    from beso_tpu_torch.scripts.training import build_agent_config, build_workspace
    from beso_tpu_torch.train.sweep import (init_sweep_state, make_sweep_train_steps,
                                            seed_generators)
    from beso_tpu_torch.utils.config import load_config

    cfg = load_config(config, overrides)
    ws = build_workspace(cfg, device)
    agent = BesoAgent(build_agent_config(cfg), ws.scaler, device=device)
    agent.init(torch.Generator().manual_seed(SWEEP_SEEDS[0]))
    busy = {}
    for seeds in (SWEEP_SEEDS, SWEEP_SEEDS[:1]):
        ss = init_sweep_state(agent.build_model, agent.trainer.optimizer_factory, seeds,
                              cfg["sigma_data"])
        gens, _ = seed_generators(seeds, device)
        fused = make_sweep_train_steps(agent.sample_density, ws.scaler, ws.train_set,
                                       cfg["train_batch_size"], SWEEP_PROFILE_STEPS,
                                       ema_decay=cfg["decay"])
        fused(ss, gens)   # warm-up
        (_, losses), st = profile_window(lambda: fused(ss, gens), SWEEP_PROFILE_STEPS, device)
        if "categories" not in st or not torch.isfinite(losses).all():
            fail(f"the profiled {len(seeds)}-seed sweep saw no device kernel or a loss "
                 f"that is not finite")
        busy[len(seeds)] = st["device_ms_per_step"]
        print(f"  profiled {len(seeds)}-seed sweep step: {st['wall_ms_per_step']:.3f} ms of wall, "
              f"{st['device_ms_per_step']:.3f} ms of device time "
              f"({100 * st['idle_share']:.1f}% idle, the same window); " + ", ".join(
                  f"{c} {v['ms_per_step']:.3f} ms ({100 * v['share']:.1f}%)"
                  for c, v in st["categories"].items()) + f" ({card})")
    print(f"  device time per step, {len(SWEEP_SEEDS)} seeds / 1 seed: "
          f"{busy[len(SWEEP_SEEDS)] / busy[1]:.3f}x ({card})")


def run_chunked_sweep(device, card):
    """Phase 16b: `scripts/sweep.py` on configs/franka_kitchen_chunked.yaml,
    SWEEP_SEEDS at batch 256 for SWEEP_STEPS steps with an evaluation every
    SWEEP_EVAL_EVERY: exactly 6 B5 and 6 of each B6 kernel per step for all
    seeds together, plus 6 x 3 NFE B5 per evaluation; every loss finite, the
    seeds' losses different, seed 1's per-step losses within 2^-8 of a run
    of its own on seed 1's draws; then the same sweep with one seed (train
    steps/s beside the 4-seed sweep's); then `profile_sweep_steps`. Returns
    the flash launches of both sweeps."""
    import torch

    repo = Path(__file__).resolve().parent
    config = repo / "configs" / "franka_kitchen_chunked.yaml"
    over = [f"max_train_steps={SWEEP_STEPS}", f"eval_every_n_steps={SWEEP_EVAL_EVERY}",
            f"train_batch_size={TRAIN_BATCH}"]
    n_evals = SWEEP_STEPS // SWEEP_EVAL_EVERY
    expect = {"flash_forward": N_LAYERS * SWEEP_STEPS + N_LAYERS * NFE * n_evals,
              "flash_backward_dq": N_LAYERS * SWEEP_STEPS,
              "flash_backward_dkv": N_LAYERS * SWEEP_STEPS}
    total = dict.fromkeys(expect, 0)
    rates, per_step = {}, {}
    for seeds in (SWEEP_SEEDS, SWEEP_SEEDS[:1]):
        summary, launches, rate, losses, secs = run_sweep_cli(
            config, seeds, repo / "build" / f"chip_smoke_sweep_{len(seeds)}", over)
        rates[len(seeds)], per_step[len(seeds)] = rate, losses
        mse = summary["base"]["history"][-1][2]
        print(f"  {len(seeds)} seed(s) {list(seeds)} x {SWEEP_STEPS} steps: launches {launches} "
              f"(expected {expect}); {rate:.2f} train steps/s ({rate * len(seeds):.2f} seed-steps/s, "
              f"the timed fused calls), command {secs:.3f} s; last losses "
              f"{[round(x, 4) for x in losses[:, -1].tolist()]}, test MSE "
              f"{[round(x, 4) for x in mse]} ({card})")
        if launches != expect:
            fail(f"the {len(seeds)}-seed sweep launched the flash kernels {launches}")
        if not (torch.isfinite(losses).all() and all(math.isfinite(x) for x in mse)):
            fail("a sweep loss or test MSE is not finite")
        for k in total:
            total[k] += launches[k]
        if len(seeds) > 1:
            d = (losses[:, None] - losses[None]).abs().amax(-1)
            if (d + torch.eye(len(seeds)) * 1e9).min() <= 1e-6:
                fail("two seeds of the sweep have the same losses")
    alone = single_seed_losses(config, over, SWEEP_SEEDS[0], device)
    rel = ((per_step[len(SWEEP_SEEDS)][0] - alone).abs() / alone.abs()).max().item()
    print(f"  seed {SWEEP_SEEDS[0]}'s per-step losses against a run of its own on its draws: "
          f"max relative diff {rel:.3g} (bound {2.0 ** -8:.3g}); train steps/s, "
          f"{len(SWEEP_SEEDS)} seeds {rates[len(SWEEP_SEEDS)]:.2f} vs 1 seed {rates[1]:.2f} "
          f"({len(SWEEP_SEEDS) * rates[len(SWEEP_SEEDS)] / rates[1]:.2f}x the seed-steps/s) "
          f"({card})")
    if not rel <= 2.0 ** -8:
        fail(f"seed {SWEEP_SEEDS[0]} of the sweep trains differently from a run of its own")
    profile_sweep_steps(config, over, device, card)
    return total


def run_kitchen_sweep(device, card):
    """Phase 16c: `scripts/sweep.py` on configs/franka_kitchen.yaml (11
    tokens, f32, batch 1024) from phase 11's files, 1 and KITCHEN_SWEEP_SEEDS
    seeds for KITCHEN_SWEEP_STEPS steps: train steps/s of each (information:
    the JAX package's "within ~15% of a single run" is a TPU figure); then
    one seed's run dir through `scripts/evaluate.py` with
    configs/evaluate_kitchen.yaml as shipped (100 x 280): finite metrics."""
    import torch

    from beso_tpu_torch.scripts import evaluate

    repo = Path(__file__).resolve().parent
    over = [f"data_path={repo / 'build' / 'chip_smoke_relay_kitchen'}",
            f"max_train_steps={KITCHEN_SWEEP_STEPS}",
            f"eval_every_n_steps={KITCHEN_SWEEP_STEPS}"]
    rates = {}
    for n in (1, KITCHEN_SWEEP_SEEDS):
        seeds = list(range(1, n + 1))
        run_dir = repo / "build" / f"chip_smoke_kitchen_sweep_{n}"
        summary, _, rate, losses, secs = run_sweep_cli(
            repo / "configs" / "franka_kitchen.yaml", seeds, run_dir, over)
        rates[n] = rate
        print(f"  {n} seed(s) x {KITCHEN_SWEEP_STEPS} steps at batch 1024 (f32): {rate:.2f} "
              f"train steps/s, {rate * n:.2f} seed-steps/s; command {secs:.3f} s ({card})")
        if not torch.isfinite(losses).all():
            fail(f"the {n}-seed kitchen sweep has a loss that is not finite")
    print(f"  per-seed throughput at {KITCHEN_SWEEP_SEEDS} seeds: "
          f"{KITCHEN_SWEEP_SEEDS * rates[KITCHEN_SWEEP_SEEDS] / rates[1]:.3f}x a single run's "
          f"steps/s per seed ({card})")
    t0 = time.perf_counter()
    out = evaluate.main(["--config", str(repo / "configs" / "evaluate_kitchen.yaml"),
                         f"model_store_path={run_dir / 'base' / 'seed_2'}"])
    torch.cuda.synchronize()
    vals = [out[k] for k in ("avrg_reward", "std_reward", "avrg_result", "std_result")]
    print(f"  evaluate CLI, evaluate_kitchen.yaml on sweep seed 2's run dir: "
          f"{time.perf_counter() - t0:.3f} s, {json.dumps(vals)} ({card})")
    if not all(math.isfinite(v) for v in vals):
        fail("the evaluation of a sweep seed's run dir is not finite")
    return rates


def run_validate_e2e(card):
    """Phase 16d: `scripts/validate_e2e.py` through its `main`, kitchen with
    --robustness --lambda-sweep, then block push with its demos cut
    (E2E_BP_DEMO_STEPS), E2E_TRAIN_STEPS train steps and a 100 x
    E2E_EVAL_STEPS evaluation: each summary printed, finite, the robustness
    and sweep keys present. A trained result below the baseline is printed,
    not failed: the steps are cut."""
    import contextlib
    import io

    from beso_tpu_torch.scripts import validate_e2e

    common = ["--train-steps", str(E2E_TRAIN_STEPS), "--eval-n-steps", str(E2E_EVAL_STEPS)]
    for env, extra, keys in (
            ("kitchen", ["--robustness", "--lambda-sweep"], ("robustness", "lambda_sweep")),
            ("block_push", ["--demo-steps", str(E2E_BP_DEMO_STEPS)], ())):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = validate_e2e.main(["--env", env, *common, *extra])
        secs = time.perf_counter() - t0
        print(f"  {env} ({secs:.3f} s of command time; {card}): "
              f"{buf.getvalue().strip().splitlines()[-1]}")
        vals = [out[k] for k in ("baseline_result", "trained_result", "trained_reward",
                                 "train_steps_per_sec", "improvement")]
        vals += list(out["success_rates"].values())
        for k in keys:
            if k not in out:
                fail(f"validate_e2e --env {env}: no {k} in its summary")
            vals += [x for v in out[k].values()
                     for x in (v.values() if isinstance(v, dict) else [v])]
        if not all(math.isfinite(v) for v in vals):
            fail(f"validate_e2e --env {env}: a summary value is not finite")
        if out["improvement"] < 0:
            print(f"  {env}: trained result {out['trained_result']} below the baseline "
                  f"{out['baseline_result']} after {E2E_TRAIN_STEPS} steps")


def run_profile_train(card):
    """Phase 16e: `scripts/profile_train.py`, the default profile (50 steps
    at batch 1024) and a --scaling grid of PROFILE_SCALING (information)."""
    from beso_tpu_torch.scripts import profile_train

    prof = profile_train.main([])
    cats = prof.get("categories")
    if cats is None:
        print(f"  torch.profiler saw no device kernel: not measured ({card})")
    else:
        print(f"  kitchen train step at batch {prof['batch']} (bf16, {prof['chunk']} fused "
              f"steps): {prof['wall_ms_per_step']:.3f} ms of wall, "
              f"{prof['device_ms_per_step']:.3f} ms of device time "
              f"({100 * prof['idle_share']:.1f}% idle, the same window); " + ", ".join(
                  f"{c} {v['ms_per_step']:.3f} ms ({100 * v['share']:.1f}%)"
                  for c, v in cats.items()) + f" ({card})")
    rows = profile_train.main(["--scaling", "--configs", PROFILE_SCALING])
    print("  scaling: " + "; ".join(
        f"batch {r['batch']} x {r['chunk']}: {r['steps_per_sec']:.2f} steps/s, "
        f"{r['samples_per_sec']:.0f} samples/s, MFU {r['mfu']:.4f}" for r in rows)
        + f" ({card})")
    if not all(r["loss_finite"] for r in rows) or not prof["loss_finite"]:
        fail("profile_train's losses are not finite")


# ---- phase 17: the multi-device layer (torch.distributed) -------------------

def _p17_dir() -> Path:
    out = Path(__file__).resolve().parent / "build" / "chip_smoke_phase17"
    out.mkdir(parents=True, exist_ok=True)
    return out


def p17_kitchen_setup(dtype, device):
    """The shipped kitchen serving width (`kitchen_config`) in `dtype`, seeded
    weights (the same in every process), its scaler, policy config,
    `fused_cached` factory and N_ENVS goals: what phase 4 serves."""
    import torch

    from beso_tpu_torch.agents.policy import PolicyConfig
    from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
    from beso_tpu_torch.envs.kitchen.goals import multigoal_kitchen_goals
    from beso_tpu_torch.models import fit_scaler, make_rollout_denoise_factory

    model_kw, policy_kw, scale_data = kitchen_config()
    den = build_model(model_kw, device, seed=P17_SEED + (dtype == torch.float32), dtype=dtype)
    data = synthetic_kitchen_data(n_traj=32, t_max=60)
    scaler = fit_scaler(data.all_observations(), data.all_actions(), scale_data=scale_data,
                        device=device)
    goals, expected = multigoal_kitchen_goals(data, 2, N_ENVS, seed=42)
    cfg = PolicyConfig(**policy_kw)
    return (scaler, cfg, make_rollout_denoise_factory(den, scaler, cfg, engine="fused_cached"),
            torch.as_tensor(goals, device=device), torch.as_tensor(expected, device=device))


def p17_block_push_setup(device):
    """The shipped block-push config's model (f32, 4 x 240 x 12 heads),
    scaler, policy config, `fused_cached` factory and N_ENVS goal frames."""
    import torch

    from beso_tpu_torch.agents.policy import PolicyConfig
    from beso_tpu_torch.data.trajectories import synthetic_push_data
    from beso_tpu_torch.envs.block_push.goals import block_push_goal_frames
    from beso_tpu_torch.models import fit_minmax_scaler, make_rollout_denoise_factory

    c = block_push_agent_config()
    model_kw = dict(state_dim=c["obs_dim"], action_dim=c["action_dim"],
                    embed_dim=c["hidden_dim"], n_layers=c["n_layers"], n_heads=c["n_heads"],
                    goal_seq_len=c["goal_seq_len"], obs_seq_len=c["window_size"],
                    linear_output=c["linear_output"])
    den = build_model(model_kw, device, seed=P17_SEED + 2, dtype=torch.float32)
    data = synthetic_push_data(n_traj=64, t_max=100, seed=21)
    scaler = fit_minmax_scaler(data.all_observations()[:, :10], data.all_actions(),
                               device=device)
    frames, expected = block_push_goal_frames(data, N_ENVS, seed=6)
    cfg = PolicyConfig(window_size=5, obs_dim=10, action_dim=2, sampler_type="ddim",
                       num_sampling_steps=NFE, sigma_min=c["sigma_min"], sigma_max=1.0,
                       cond_lambda=c["cond_lambda"])
    return (scaler, cfg, make_rollout_denoise_factory(den, scaler, cfg, engine="fused_cached"),
            torch.as_tensor(frames, device=device), torch.as_tensor(expected, device=device))


def p17_rollout(env, setup, mesh, n_steps, shard=0, n_shards=1):
    """A sharded rollout under `mesh` (each rank its shard of the N_ENVS
    envs), or with `mesh` None one process's rollout of shard `shard` of
    `n_shards` on that shard's generator (`shard_generator`)."""
    from beso_tpu_torch.rollout import (rollout_block_push, rollout_block_push_sharded,
                                        rollout_kitchen, rollout_kitchen_sharded)
    from beso_tpu_torch.rollout.sharded import shard_generator

    scaler, cfg, factory, goals, expected = setup
    if mesh is not None:
        fn = rollout_kitchen_sharded if env == "kitchen" else rollout_block_push_sharded
        return fn(None, scaler, cfg, goals, expected, P17_SEED, mesh, n_steps=n_steps,
                  denoise_factory=factory)
    b = goals.shape[0] // n_shards
    rows = slice(shard * b, (shard + 1) * b)
    fn = rollout_kitchen if env == "kitchen" else rollout_block_push
    return fn(None, scaler, cfg, goals[rows], expected[rows],
              shard_generator(P17_SEED, shard, goals.device), n_steps=n_steps,
              denoise_factory=factory)


def p17_timed_rollout(env, setup, mesh, n_steps):
    """A 2-step warm-up, every fused-layer counter set to 0, the sharded
    rollout, a sync: (metrics on the host, {wrapper: launches}, wall s)."""
    import torch

    p17_rollout(env, setup, mesh, 2)
    torch.cuda.synchronize()
    reset_fused_counts()
    t0 = time.perf_counter()
    m = p17_rollout(env, setup, mesh, n_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v[0] for k, v in fused_counts().items()}
    return {k: (v.cpu() if hasattr(v, "cpu") else v) for k, v in m._asdict().items()}, counts, wall


def p17_train_setup(device):
    """The chunked config's model (bf16, 131 tokens, B5/B6 in every layer),
    its data, scaler and density, and one global batch of TRAIN_BATCH."""
    import torch

    from beso_tpu_torch.core.densities import make_sample_density
    from beso_tpu_torch.data.slicer import SlicedDataset
    from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
    from beso_tpu_torch.models import fit_scaler

    data = synthetic_kitchen_data(n_traj=96, t_max=200, seed=P17_SEED)
    ds = SlicedDataset(data, window=64, future_seq_len=2, device=device)
    scaler = fit_scaler(data.all_observations(), data.all_actions(), scale_data=False,
                        device=device)
    density = make_sample_density("loglogistic", 0.5, 0.005, 1.0)
    batch = ds.sample_batch(torch.Generator(device).manual_seed(P17_SEED), TRAIN_BATCH)
    return ds, scaler, density, batch


def p17_chunked_model(device, gen):
    import torch

    from beso_tpu_torch.models import DiffusionGPT

    c = chunked_config()
    return DiffusionGPT(
        state_dim=c["obs_dim"], action_dim=c["action_dim"], embed_dim=c["hidden_dim"],
        n_layers=c["n_layers"], n_heads=c["n_heads"], goal_seq_len=c["goal_seq_len"],
        obs_seq_len=c["window_size"], cond_mask_prob=c["cond_mask_prob"], attention="pallas",
        dtype=torch.bfloat16, generator=gen).to(device)


def p17_train_step(device, mesh):
    """One `make_train_step` of the chunked config from seeded weights, on
    the global batch and generator (under `mesh` each rank its rows, or its
    heads under tp): (loss, full gradients, this rank's flash launches)."""
    import torch

    from beso_tpu_torch.models import GCDenoiser
    from beso_tpu_torch.models.ema import ema_init
    from beso_tpu_torch.parallel import gather_full, partition_params
    from beso_tpu_torch.train.trainer import TrainState, make_optimizer, make_train_step

    _, scaler, density, batch = p17_train_setup(device)
    model = p17_chunked_model(device, torch.Generator().manual_seed(P17_SEED))
    if mesh is not None:
        partition_params(model, mesh)
    opt, sched = make_optimizer(model.parameters(), "adamw", 1e-4)
    ts = TrainState(model, opt, sched, ema_init(model.named_parameters()))
    step = make_train_step(GCDenoiser(model, 0.5), density, scaler, mesh=mesh)
    torch.cuda.synchronize()
    reset_flash_launches()
    loss = step(ts, batch, torch.Generator(device).manual_seed(P17_SEED + 1))
    torch.cuda.synchronize()
    launches = flash_launches()
    grads = {n: p.grad for n, p in model.named_parameters()}
    grads = gather_full(grads, mesh) if mesh is not None else {
        n: g.detach().clone() for n, g in grads.items()}
    return float(loss), {n: g.float().cpu() for n, g in grads.items()}, launches


def p17_sweep(device, mesh):
    """The seed sweep of the chunked config, P17_SWEEP_SEEDS at batch
    P17_SWEEP_BATCH for P17_SWEEP_STEPS steps; under `mesh` each "dp" rank
    trains its seeds (`shard_sweep_state`). (seeds, losses [S, steps])."""
    from functools import partial

    import torch

    from beso_tpu_torch.train.sweep import (init_sweep_state, make_sweep_train_steps,
                                            seed_generators, shard_sweep_state)
    from beso_tpu_torch.train.trainer import make_optimizer

    ds, scaler, density, _ = p17_train_setup(device)
    ss = init_sweep_state(lambda g: p17_chunked_model(device, g),
                          partial(make_optimizer, name="adamw", lr=1e-4), P17_SWEEP_SEEDS)
    if mesh is not None:
        ss = shard_sweep_state(ss, mesh, "dp")
    fused = make_sweep_train_steps(density, scaler, ds, P17_SWEEP_BATCH, P17_SWEEP_STEPS)
    _, losses = fused(ss, seed_generators(ss.seeds, device)[0])
    return ss.seeds, losses.float().cpu()


def p17_nccl_rank(rank, world_size, device_type):
    """The NCCL rank (W=1, the one card): an all-reduce through NCCL, 17a's
    kitchen rollouts in bf16 and f32 under a ("dp", "tp") mesh of 1, and
    17c's dry-run body, on `device_type` (the caller's)."""
    import torch

    from beso_tpu_torch.parallel import make_mesh
    from beso_tpu_torch.parallel.comm import all_reduce_
    from beso_tpu_torch.parallel.dryrun import dryrun_body

    device = torch.device(device_type)   # init_distributed set the rank's card
    mesh = make_mesh(world_size, tp=1, backend="nccl")
    x = all_reduce_(torch.full((4,), 3.0, device=device), mesh.get_group("dp"))
    if not bool((x == 3.0 * world_size).all()):
        raise RuntimeError(f"NCCL all-reduce gave {x}")
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        out[str(dtype)] = p17_timed_rollout("kitchen", p17_kitchen_setup(dtype, device), mesh,
                                            P17_STEPS)
    d = dryrun_body(rank, world_size, backend="nccl", device=device)
    out["dryrun_loss"] = float(d["loss"])
    torch.save(out, _p17_dir() / f"nccl_rank{rank}.pt")


def p17_gloo_rank(rank, world_size, device_type):
    """A gloo rank of W=2 sharing the card (gathers and sums through the
    host): 17a's kitchen rollouts, 17b's block-push rollout, 17c's train
    step at dp=2 and at dp=1 x tp=2, 17d's sweep over "dp", on
    `device_type` (the caller's)."""
    import torch

    from beso_tpu_torch.parallel import make_mesh

    device = torch.device(device_type)
    if device.type == "cuda":
        torch.cuda.set_device(0)
    dp = make_mesh(world_size, tp=1, backend="gloo")
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        out[str(dtype)] = p17_timed_rollout("kitchen", p17_kitchen_setup(dtype, device), dp,
                                            P17_STEPS)
    out["block_push"] = p17_timed_rollout("block_push", p17_block_push_setup(device), dp,
                                          P17_BP_STEPS)
    out["train_dp"] = p17_train_step(device, dp)
    out["train_tp"] = p17_train_step(device, make_mesh(world_size, tp=world_size,
                                                       backend="gloo"))
    out["sweep"] = p17_sweep(device, dp)
    torch.save(out, _p17_dir() / f"gloo_rank{rank}.pt")


def _p17_same(what, got, ref):
    """Fail unless the metrics dicts are equal bit for bit."""
    bad = [k for k in ("rewards", "results", "completed", "completion_order")
           if not got[k].equal(ref[k])]
    print(f"  {what}: {'bit-equal' if not bad else f'NOT bit-equal in {bad}: FAIL'}")
    if bad:
        fail(f"{what} differs from the single-process rollouts of its shards")


def _p17_launches(what, counts, want_b1):
    want = {k: (want_b1 if k == "fused_layer_prefix" else 0) for k in counts}
    print(f"  {what}: launches {counts} (expected {want})")
    if counts != want:
        fail(f"{what} launched {counts}, not {want}")


def single_contact_placement(state, reach):
    """8 single-block envs of `state` (CPU) placed for contact, as the CPU
    tests place JAX's: envs 0-3 with the effector just behind the block,
    pushing it toward the target; envs 4-7 with the block 4.5 cm from the
    target at bearings 0, 0.3, 1.2 and 2.5 rad off the slot opening, the
    effector behind it pushing inward (INSERT's gate holds env 6 at the
    rim); env 7 at its goal with the effector still. Returns (state, the
    action [8, 2] of every step)."""
    import torch

    block, target = state.block_pos.clone(), state.target_pos
    ang = state.target_yaw[4:8] + torch.tensor([0.0, 0.3, 1.2, 2.5])
    block[4:8] = target[4:8] + 0.045 * torch.stack([ang.cos(), ang.sin()], -1)
    block[7] = target[7]
    d = target - block
    d[7] = torch.tensor([0.0, 1.0])
    d = d / d.norm(dim=-1, keepdim=True)
    eff = block - 0.035 * d
    eff[7] = state.reach_target[7] if reach else target[7] + torch.tensor([0.0, -0.2])
    action = 0.02 * d
    action[7] = 0.0
    return state._replace(effector=eff, effector_target=eff.clone(), block_pos=block), action


def check_registry_on_card(device):
    """17e: every registry id's step on the card against the CPU (obs and
    reward within 1e-5 (1 + |cpu|), done equal). The single-block ids
    (PUSH, REACH, INSERT, normalized and Rgb) step 4 times from
    `single_contact_placement`, so the push law and INSERT's slot gate act;
    each card step starts from the CPU's state, since contact is chaotic
    (f32 against f64 grows ~4x per step on the CPU), and the blocks must
    have moved. The multimodal and kitchen ids step 3 times, free running,
    with the block ids' actions scaled to 0.005 and away from the blocks
    (the multimodal env's dither hash decorrelates at an ulp). Then every
    id is reset on the card from a card generator (finite, its shapes).
    Prints each id's largest gap."""
    import numpy as np
    import torch

    from beso_tpu_torch.envs import registry
    from beso_tpu_torch.envs.block_push.single import (ACTION_MAX, ACTION_MIN,
                                                       SingleBlockPushState)

    def card(x):
        return type(x)(*(v.to(device) for v in x))

    def gap(got, want):
        return ((got.cpu() - want).abs() / (1 + want.abs())).max().item()

    lo, hi = torch.tensor(ACTION_MIN), torch.tensor(ACTION_MAX)
    rng = np.random.RandomState(4)
    worst = {}
    for env_id in registry.registered_ids():
        spec = registry.make(env_id)
        kitchen = env_id.startswith("kitchen")
        cpu = spec.reset_fn(8, torch.Generator().manual_seed(0))
        single = isinstance(cpu, SingleBlockPushState)
        if single:
            cpu, a = single_contact_placement(cpu, "Reach" in env_id)
            if "Normalized" in env_id:   # the action that denormalizes to `a`
                a = (a - (hi + lo) * 0.5) / ((hi - lo) * 0.5)
            start, actions = cpu.block_pos.clone(), [a] * 4
        else:
            actions = [rng.uniform(-1, 1, (8, 9 if kitchen else 2)).astype(np.float32)
                       for _ in range(3)]
            if not kitchen:
                for a in actions:
                    a *= 0.005
                    a[:, 1] = -abs(a[:, 1])   # away from the blocks
            actions = [torch.as_tensor(a) for a in actions]
        on_card = card(cpu)
        worst[env_id] = 0.0
        for a in actions:
            if single:
                on_card = card(cpu)
            on_card, oc, rc, dc = spec.step_fn(on_card, a.to(device))
            cpu, o, r, d = spec.step_fn(cpu, a)
            err = max(gap(oc, o), gap(rc, r))
            worst[env_id] = max(worst[env_id], err)
            if not (err <= 1e-5 and dc.cpu().equal(d)):
                fail(f"{env_id} on the card differs from the CPU by {err}")
        if single and not bool(((cpu.block_pos - start).norm(dim=-1)[:7] > 1e-3).all()):
            fail(f"{env_id}: the contact placement pushed no block")
        fresh = spec.reset_fn(8, torch.Generator(device).manual_seed(0), device)
        obs = spec.obs_fn(fresh)
        if obs.device.type != device.type or obs.shape[0] != 8 or not bool(
                torch.isfinite(obs).all()):
            fail(f"{env_id}: a reset on the card gave obs {tuple(obs.shape)} on {obs.device}")
    print(f"  {len(worst)} registry ids on the card vs the CPU, max |diff| / (1 + |cpu|) of obs "
          f"and reward (limit 1e-5; single-block ids over 4 contact steps, each from the CPU's "
          f"state): " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    print("  resets on the card finite")


def check_xarm_state_loader_on_card(device):
    """17e: xArm FK on the card against the CPU, IK on the card to under
    1e-3 of two targets; a CUDA env state saved and loaded; the native
    loader's batches streamed to the card equal to its host batches."""
    import numpy as np
    import torch

    from beso_tpu_torch.data.native import NativeSlicedLoader
    from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
    from beso_tpu_torch.envs.block_push.env import block_push_reset, block_push_step
    from beso_tpu_torch.envs.block_push.xarm import xarm_fk, xarm_fk_pose, xarm_ik
    from beso_tpu_torch.envs.pose3d import (Pose3d, quat_conj, quat_from_rotvec, quat_mul,
                                            quat_to_rotvec)
    from beso_tpu_torch.envs.state_io import load_env_state, save_env_state

    q = torch.as_tensor(np.random.RandomState(0).uniform(-1, 1, (64, 6)).astype(np.float32))
    err = (xarm_fk(q.to(device))[0].cpu() - xarm_fk(q)[0]).abs().max().item()
    if not err <= 1e-5:
        fail(f"xArm FK on the card differs from the CPU by {err}")
    rv = torch.tensor([[0.0, math.pi / 2, 0.0], [0.0, math.pi / 2, 0.2]], device=device)
    t = torch.tensor([[0.5, 0.0, 0.1], [0.45, 0.1, 0.15]], device=device)
    target = Pose3d(quat_from_rotvec(rv), t)
    with torch.inference_mode():
        qi = xarm_ik(target)
        pose = xarm_fk_pose(qi)
    pos_err = (pose.translation - t).abs().max().item()
    rot_err = quat_to_rotvec(quat_mul(target.rotation, quat_conj(pose.rotation))).norm(
        dim=-1).max().item()
    print(f"  xArm: FK card vs CPU max |diff| {err:.3g} (limit 1e-5); IK on the card in "
          f"inference mode: position error {pos_err:.3g}, rotation {rot_err:.3g} rad "
          f"(limit 1e-3)")
    if not (pos_err < 1e-3 and rot_err < 1e-3):
        fail("xArm IK on the card missed its targets")

    state = block_push_reset(16, torch.Generator(device).manual_seed(1), device)
    state, *_ = block_push_step(state, torch.full((16, 2), 0.01, device=device))
    path = _p17_dir() / "state.npz"
    save_env_state(state, path)
    back = load_env_state(block_push_reset(16, None, device), path)
    if not all(a.device.type == device.type and a.equal(b) for a, b in zip(back, state)):
        fail("a CUDA env state did not load back equal")

    data = synthetic_kitchen_data(n_traj=32, t_max=80, seed=3)
    nl = NativeSlicedLoader(data.observations, data.actions, data.lengths, window=4,
                            future_seq_len=2)
    n = 0
    for k, batch in enumerate(nl.batches(seed=5, batch_size=256, n_batches=6, device=device)):
        host = nl.sample_batch_host(5, k, 256)
        if not all(batch[x].device.type == device.type and batch[x].cpu().equal(host[x])
                   for x in host):
            fail(f"native loader batch {k} on the card differs from its host batch")
        n += 1
    print(f"  env state on the card saved and loaded equal; native loader: {n} batches of "
          f"256 streamed to the card through pinned memory, each equal to its host batch")


def run_phase17(device, card):
    """Phase 17 (see the module docstring). Returns {path: launches} per
    kernel for the kernels line."""
    import torch

    from beso_tpu_torch.parallel.launch import spawn

    out = _p17_dir()
    for old in out.glob("*_rank*.pt"):
        old.unlink()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        spawn(p17_nccl_rank, 1, "nccl", args=(device.type,), timeout_s=P17_TIMEOUT,
              init_timeout_s=120)
        t_nccl = time.perf_counter() - t0
        spawn(p17_gloo_rank, 2, "gloo", args=(device.type,), timeout_s=P17_TIMEOUT,
              init_timeout_s=120)
    except (RuntimeError, TimeoutError) as e:
        fail(f"phase 17's ranks: {e}")
    t_ranks = time.perf_counter() - t0
    nccl = torch.load(out / "nccl_rank0.pt", weights_only=False)
    gloo = [torch.load(out / f"gloo_rank{r}.pt", weights_only=False) for r in range(2)]
    print(f"  ranks: NCCL W=1 {t_nccl:.1f} s, gloo W=2 {t_ranks - t_nccl:.1f} s "
          f"(process start, set-up and warm-ups included)")
    paths = {"fused_layer_prefix": {}, "fused_layer_prefix_f32": {}, "flash": {}}

    print(f"[17a] ({since_start()}) kitchen rollouts sharded over W=1 (NCCL) and W=2 "
          f"(gloo, one card), {N_ENVS} envs x {P17_STEPS} steps, fused_cached")
    for dtype, key in ((torch.bfloat16, "fused_layer_prefix"),
                       (torch.float32, "fused_layer_prefix_f32")):
        setup = p17_kitchen_setup(dtype, device)
        whole = p17_rollout("kitchen", setup, None, P17_STEPS)
        halves = [p17_rollout("kitchen", setup, None, P17_STEPS, s, 2) for s in range(2)]
        halves = {k: torch.cat([getattr(h, k) for h in halves]).cpu()
                  for k in ("rewards", "results", "completed", "completion_order")}
        m1, c1, w1 = nccl[str(dtype)]
        tag = str(dtype)[6:]
        _p17_same(f"{tag} W=1 (NCCL) vs one process, shard 0 of 1", m1,
                  {k: getattr(whole, k).cpu() for k in halves})
        check_rollout_metrics(whole, N_ENVS, P17_STEPS)
        _p17_launches(f"{tag} W=1 rank 0", c1, P17_STEPS * NFE * N_LAYERS)
        paths[key]["phase 17a W=1"] = c1["fused_layer_prefix"]
        walls = []
        for r, g in enumerate(gloo):
            m2, c2, w2 = g[str(dtype)]
            _p17_same(f"{tag} W=2 (gloo) rank {r}'s gathered metrics vs one process per shard",
                      m2, halves)
            _p17_launches(f"{tag} W=2 rank {r}", c2, P17_STEPS * NFE * N_LAYERS)
            paths[key][f"phase 17a W=2 rank {r}"] = c2["fused_layer_prefix"]
            walls.append(w2)
        print(f"  {tag}: W=1 {N_ENVS * P17_STEPS / w1:.1f} env-steps/s; W=2 on one card "
              f"{N_ENVS * P17_STEPS / max(walls):.1f} env-steps/s (information; the ranks "
              f"share the card; {card})")

    print(f"[17b] ({since_start()}) block-push rollout sharded over W=2 (gloo), f32 B1 at "
          f"its shape, {N_ENVS} envs x {P17_BP_STEPS} steps")
    setup = p17_block_push_setup(device)
    halves = [p17_rollout("block_push", setup, None, P17_BP_STEPS, s, 2) for s in range(2)]
    halves = {k: torch.cat([getattr(h, k) for h in halves]).cpu()
              for k in ("rewards", "results", "completed", "completion_order")}
    walls = []
    for r, g in enumerate(gloo):
        m, c, w = g["block_push"]
        _p17_same(f"W=2 rank {r}'s gathered metrics vs one process per shard", m, halves)
        _p17_launches(f"W=2 rank {r}", c, P17_BP_STEPS * NFE * BP_LAYERS)
        paths["fused_layer_prefix_f32"][f"phase 17b W=2 rank {r}"] = c["fused_layer_prefix"]
        walls.append(w)
    print(f"  W=2 {N_ENVS * P17_BP_STEPS / max(walls):.1f} env-steps/s (information; {card})")

    print(f"[17c] ({since_start()}) the chunked config's train step at dp=2 and at dp=1 x "
          f"tp=2 (3 heads per rank) vs one process, batch {TRAIN_BATCH}, bf16")
    ref_loss, ref_grads, _ = p17_train_step(device, None)
    for form in ("train_dp", "train_tp"):
        loss, grads, _ = gloo[0][form]
        lerr = abs(loss - ref_loss)
        ok = math.isfinite(loss) and lerr <= MODEL_LOSS_FRACTION * abs(ref_loss)
        worst = 0.0
        for n, g in ref_grads.items():
            err, top = (grads[n] - g).abs().max().item(), g.abs().max().item()
            ok &= math.isfinite(err) and err <= MODEL_GRAD_FRACTION * top
            worst = max(worst, err / max(top, 1e-30))
        print(f"  {form[6:]}: loss {loss:.6f} vs {ref_loss:.6f} (|diff| {lerr:.3g}, limit "
              f"{MODEL_LOSS_FRACTION * abs(ref_loss):.3g}); worst gradient |diff| / max|ref| "
              f"{worst:.3g} (limit {MODEL_GRAD_FRACTION:.3g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the {form[6:]} train step disagrees with one process's")
        for r, g in enumerate(gloo):
            counts = g[form][2]
            want = dict.fromkeys(counts, N_LAYERS)
            print(f"  {form[6:]} rank {r}: flash launches {counts} (expected {want})")
            if counts != want:
                fail(f"the {form[6:]} step launched {counts}, not {want}")
            paths["flash"][f"phase 17c {form[6:]} rank {r}"] = counts
    if not math.isfinite(nccl["dryrun_loss"]):
        fail("the NCCL dry run's loss is not finite")
    print(f"  dryrun_body on NCCL at W=1 (cuda): loss {nccl['dryrun_loss']:.6f}, sharded "
          f"fused rollout ok")

    print(f"[17d] ({since_start()}) shard_sweep_state: seeds {list(P17_SWEEP_SEEDS)} over 2 "
          f"ranks vs one process, {P17_SWEEP_STEPS} steps at batch {P17_SWEEP_BATCH}")
    seeds, losses = p17_sweep(device, None)
    worst, same = 0.0, True
    for g in gloo:
        part_seeds, part = g["sweep"]
        for j, s in enumerate(part_seeds):
            ref = losses[seeds.index(s)]
            same &= bool(part[j].equal(ref))
            worst = max(worst, ((part[j] - ref).abs() / ref.abs()).max().item())
    covered = sorted(s for g in gloo for s in g["sweep"][0]) == sorted(seeds)
    print(f"  each seed's loss trace: {'bit-equal' if same else 'not bit-equal'}, max relative "
          f"|diff| {worst:.3g} (limit {MODEL_LOSS_FRACTION:.3g}); every seed on one rank: "
          f"{covered}")
    if not (covered and worst <= MODEL_LOSS_FRACTION):
        fail("the sharded sweep's seeds differ from the one-process sweep's")

    print(f"[17e] ({since_start()}) the single-device modules on the card: registry ids, "
          f"xArm, env state I/O, the native loader")
    check_registry_on_card(device)
    check_xarm_state_loader_on_card(device)
    return paths


# ---- phase 18: guidance on B1, the profiler trace, bf16 moments, calibration --

def tanh_guide(device, seed=5, hidden=64):
    """A seeded two-layer tanh guide Q(s, a, g) = w2 . tanh(W1 x + b1) over
    the last (scaled) state, every action of the window and the last goal."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    n_in = 30 + 4 * 9 + 30
    W1 = torch.as_tensor((rng.randn(n_in, hidden) / np.sqrt(n_in)).astype(np.float32)).to(device)
    b1 = torch.as_tensor((0.1 * rng.randn(hidden)).astype(np.float32)).to(device)
    w2 = torch.as_tensor(rng.randn(hidden).astype(np.float32)).to(device)

    def guide(s, a, g):
        x = torch.cat([s[:, -1], a.reshape(a.shape[0], -1), g[:, -1]], -1)
        return torch.tanh(x @ W1 + b1) @ w2

    return guide


def run_guided_policy(den32, policy_kw, scale_data, device, card):
    """Phase 18a: `classifier_guided_denoise_fn` around the f32 kitchen
    model's `fused_cached` engine (B1) against the same guide around the
    plain `cached` engine: a W+1-step policy window of N_ENVS envs (lambda
    1.5 CFG) inside `torch.inference_mode`, within F32_ENGINE_FRACTION of
    max |ref|, exactly N_LAYERS B1 launches per denoiser call; then a
    guided N_ENVS x P18_GUIDED_STEPS rollout with every counter set to 0
    just before it. Returns the rollout's B1 launches."""
    import torch

    from beso_tpu_torch.agents.policy import PolicyConfig
    from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
    from beso_tpu_torch.envs.kitchen.env import INIT_QPOS
    from beso_tpu_torch.envs.kitchen.goals import multigoal_kitchen_goals
    from beso_tpu_torch.models import fit_scaler, make_rollout_denoise_factory
    from beso_tpu_torch.models.cfg import classifier_guided_denoise_fn

    guide = tanh_guide(device)
    data = synthetic_kitchen_data(n_traj=32, t_max=60)
    scaler = fit_scaler(data.all_observations(), data.all_actions(), scale_data=scale_data,
                        device=device)
    goals = torch.as_tensor(multigoal_kitchen_goals(data, 2, N_ENVS, seed=42)[0], device=device)
    cfg = PolicyConfig(**policy_kw)
    gen = torch.Generator().manual_seed(181)
    obs_seq = [(torch.as_tensor(INIT_QPOS) + 0.05 * torch.randn(N_ENVS, 30, generator=gen))
               .to(device) for _ in range(cfg.window_size + 1)]
    with torch.inference_mode():
        fused, plain = (classifier_guided_denoise_fn(
            make_rollout_denoise_factory(den32, scaler, cfg, engine=e)(goals), guide,
            P18_GUIDE_LAMBDA) for e in ("fused_cached", "cached"))
        calls = [0]
        reset_fused_counts()
        got = policy_window(counted(fused, calls), scaler, cfg, goals, obs_seq, 182, device)
        torch.cuda.synchronize()
        expect_launches("the guided window on fused_cached", "fused_layer_prefix", calls[0])
        ref = policy_window(plain, scaler, cfg, goals, obs_seq, 182, device)
        unguided = policy_window(make_rollout_denoise_factory(den32, scaler, cfg,
                                                              engine="cached")(goals),
                                 scaler, cfg, goals, obs_seq, 182, device)
    _rel_check(f"guided window, {cfg.window_size + 1} steps x {N_ENVS} envs, {calls[0]} "
               f"denoiser calls: B1 vs cached (f32)", got, ref, F32_ENGINE_FRACTION)
    moved = (ref - unguided).abs().max().item()
    print(f"  the guide moved the plain engine's actions by up to {moved:.6g}")
    if not moved > 0:
        fail("the guide did not move the actions")
    run_rollout(den32, policy_kw, scale_data, N_ENVS, 2, device, seed=1, guide=guide)
    torch.cuda.synchronize()
    reset_fused_counts()
    t0 = time.perf_counter()
    metrics = run_rollout(den32, policy_kw, scale_data, N_ENVS, P18_GUIDED_STEPS, device,
                          seed=2, guide=guide)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = expect_launches("the guided rollout", "fused_layer_prefix",
                               P18_GUIDED_STEPS * NFE)
    check_rollout_metrics(metrics, N_ENVS, P18_GUIDED_STEPS)
    print(f"  guided rollout (lambda {P18_GUIDE_LAMBDA}), {N_ENVS} envs x {P18_GUIDED_STEPS} "
          f"steps on f32 B1: launches {launches}, avrg reward "
          f"{metrics.rewards.mean().item():.4f}; wall {wall:.3f} s, "
          f"{N_ENVS * P18_GUIDED_STEPS / wall:.1f} env-steps/s (informational; random "
          f"weights; {card})")
    return launches


def run_profile_trace(ws, agent, device, card):
    """Phase 18b: `utils.metrics.profile_trace` around P18_TRACE_STEPS fused
    train steps of phase 7's chunked model (bf16, batch TRAIN_BATCH) inside
    a `step_timer` writing to a `MetricsWriter`: the Chrome trace names the
    B5 and both B6 kernels, each launched exactly N_LAYERS per step (the
    counters set to 0 just before); the timer's record read back. Returns
    the flash launches."""
    import torch

    from beso_tpu_torch.ops import flash_attention as fa
    from beso_tpu_torch.train.trainer import make_fused_train_steps
    from beso_tpu_torch.utils.metrics import MetricsWriter, profile_trace, step_timer

    out = Path(__file__).resolve().parent / "build" / "chip_smoke_trace"
    for f in ("trace.json", "metrics.jsonl"):
        (out / f).unlink(missing_ok=True)
    fused = make_fused_train_steps(agent.denoiser, agent.trainer.sample_density, ws.scaler,
                                   ws.train_set, TRAIN_BATCH, P18_TRACE_STEPS)
    gen = torch.Generator(device).manual_seed(183)
    fused(agent.state, gen)    # warm-up
    torch.cuda.synchronize()
    counters = (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv)
    for f in counters:
        f.launches = 0
    writer = MetricsWriter(str(out))
    t0 = time.perf_counter()
    with profile_trace(str(out)), step_timer(writer, "chunked_train", step=agent.state.step):
        _, losses = fused(agent.state, gen)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    writer.close()
    launches = {f.__name__: f.launches for f in counters}
    want = dict.fromkeys(launches, N_LAYERS * P18_TRACE_STEPS)
    print(f"  launches: {launches} (expected {want}); losses {losses.tolist()}")
    if launches != want or not bool(torch.isfinite(losses).all()):
        fail("the traced train steps launched the flash kernels otherwise or lost finiteness")
    trace = out / "trace.json"
    if not trace.exists():
        fail("profile_trace wrote no trace")
    events = json.loads(trace.read_text())["traceEvents"]
    kernel_us = {}
    for ev in events:
        if ev.get("cat") == "kernel":
            for k in ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
                if k in ev.get("name", ""):
                    n, us = kernel_us.get(k, (0, 0.0))
                    kernel_us[k] = (n + 1, us + float(ev.get("dur", 0.0)))
    print(f"  {trace.name}: {trace.stat().st_size / 2 ** 20:.1f} MiB, {len(events)} events; "
          f"flash kernels named (count, device us): {kernel_us}")
    if set(kernel_us) != {"flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"}:
        fail("the trace does not name the B5 and both B6 kernels")
    rows = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    timed = [r["time/chunked_train_s"] for r in rows if "time/chunked_train_s" in r]
    if len(timed) != 1 or not 0 < timed[0] <= wall:
        fail(f"step_timer's record is missing or wrong: {rows}")
    print(f"  step_timer: {timed[0]:.3f} s for {P18_TRACE_STEPS} traced steps (profiler on; "
          f"{card})")
    return launches


def run_mu_bf16(card):
    """Phase 18c: `profile_train --scaling --configs P18_SCALING`, without
    and with --mu-bf16, in this process: the first moments f32, then bf16,
    the losses finite; both runs' steps/s (information)."""
    from beso_tpu_torch.scripts import profile_train

    rows = {}
    for flag in ((), ("--mu-bf16",)):
        (row,) = profile_train.main(["--scaling", "--configs", P18_SCALING, *flag])
        rows[bool(flag)] = row
    print(f"  first moments: {rows[False]['mu_dtype']} / --mu-bf16 {rows[True]['mu_dtype']}; "
          f"steps/s {rows[False]['steps_per_sec']:.3f} / --mu-bf16 "
          f"{rows[True]['steps_per_sec']:.3f} (information only; {card})")
    if rows[False]["mu_dtype"] != "torch.float32" or rows[True]["mu_dtype"] != "torch.bfloat16":
        fail("--mu-bf16 did not keep the first moments in bf16")
    if not (rows[False]["loss_finite"] and rows[True]["loss_finite"]):
        fail("profile_train's losses are not finite")


def run_calibration_surrogate(device, card):
    """Phase 18d: `calibrate_block_push`'s rot-sweep scoring of CAL_COMBOS
    on the card against the stored goldens: the shipped combination's
    stable-5 mean RMSE within 1 mm and 1 degree of the CPU's; every swept
    constant restored (a `block_push_step` from a fixed state bit-equal
    before and after); `friction_k2=FRICTION_K2` bit-equal to the default."""
    import numpy as np
    import torch

    import beso_tpu_torch.envs.block_push.env as bpe
    from beso_tpu_torch.scripts import calibrate_block_push as cal

    stable = [s for s in cal._scenarios() if s[0] in cal.STABLE_SCENARIOS]

    def fixed_step():
        state = cal._states(stable, device)
        with torch.inference_mode():
            for _ in range(4):
                state = bpe.block_push_step(
                    state, torch.tensor([[0.0, 0.035]] * len(stable), device=device))[0]
        return state

    swept = ("CONTACT_MU", "TIP_TORQUE_LEAK", "_GROUND_PTS")
    before, step0 = {k: np.array(getattr(bpe, k), copy=True) for k in swept}, fixed_step()
    t0 = time.perf_counter()
    rows = cal.run_rot_sweep(cal.GOLDEN_DIR, CAL_COMBOS, device)
    sweep_s = time.perf_counter() - t0
    restored = (all(np.array_equal(getattr(bpe, k), v) for k, v in before.items())
                and all(torch.equal(a, b) for a, b in zip(fixed_step(), step0)))
    shipped = rows[0]
    d_pos = abs(shipped["stable_pos_mm"] - CAL_CPU_POS_MM)
    d_yaw = abs(shipped["stable_yaw_deg"] - CAL_CPU_YAW_DEG)
    print(f"  shipped combination on the card: stable-5 pos {shipped['stable_pos_mm']:.6f} mm, "
          f"yaw {shipped['stable_yaw_deg']:.6f} deg (CPU {CAL_CPU_POS_MM:.6f} mm, "
          f"{CAL_CPU_YAW_DEG:.6f} deg: |diff| {d_pos:.6f} mm, {d_yaw:.6f} deg; limits 1 mm, "
          f"1 deg); {len(rows)} combinations in {sweep_s:.3f} s ({card})")
    if not (d_pos <= 1.0 and d_yaw <= 1.0):
        fail("the calibration surrogate on the card is off the CPU's numbers")
    print(f"  swept constants restored, a fixed step bit-equal before and after: {restored}")
    if not restored:
        fail("the rot sweep left a constant changed")
    k2_same = np.array_equal(cal.run_surrogate(stable, device, bpe.FRICTION_K2),
                             cal.run_surrogate(stable, device))
    print(f"  friction_k2=FRICTION_K2 bit-equal to the default on the card: {k2_same}")
    if not k2_same:
        fail("friction_k2=FRICTION_K2 differs from the default step on the card")


def run_phase18(device, card, den32, policy_kw, scale_data, ws, agent):
    """Phase 18; returns {"fused_layer_prefix_f32": 18a's rollout launches,
    "flash": 18b's launches}."""
    print(f"[18a] ({since_start()}) classifier guidance around f32 fused_cached (B1) vs "
          f"cached, then a guided {N_ENVS} x {P18_GUIDED_STEPS} rollout")
    b1 = run_guided_policy(den32, policy_kw, scale_data, device, card)
    print(f"[18b] ({since_start()}) profile_trace around {P18_TRACE_STEPS} chunked train "
          f"steps at batch {TRAIN_BATCH}")
    flash = run_profile_trace(ws, agent, device, card)
    print(f"[18c] ({since_start()}) profile_train --scaling --configs {P18_SCALING}, with and "
          f"without --mu-bf16")
    run_mu_bf16(card)
    print(f"[18d] ({since_start()}) calibrate_block_push's rot-sweep scoring on the card")
    run_calibration_surrogate(device, card)
    return {"fused_layer_prefix_f32": b1, "flash": flash}


def main() -> None:
    repo = Path(__file__).resolve().parent
    if not (repo / "beso_tpu_torch" / "csrc").is_dir():
        fail(f"no beso_tpu_torch/csrc beside {Path(__file__).name}: run from a checkout")
    sys.path.insert(0, str(repo))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    from beso_tpu_torch.ops import build
    from beso_tpu_torch.ops import fused_layer as fl
    from beso_tpu_torch.ops import kitchen_step as ks
    from beso_tpu_torch.rollout import success_rate_histogram

    # ---- 0. device --------------------------------------------------------
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not measured"
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    so = build.build_kernels()
    print(f"[1] ({since_start()}) build: {so.name} in {time.perf_counter() - t0:.1f} s")
    log = so.with_suffix(".log")
    report = ptxas_report(log.read_text()) if log.exists() else {}
    for name, props in report.items():
        print(f"  ptxas {name}: {props}")
    # no bf16 flash kernel may spill, at either tile width; the f32 ones may
    flash_bf16 = {n: p for n, p in report.items()
                  if n.startswith("flash_") and "bfloat16" in n}
    if not any(n.startswith("flash_fwd") for n in flash_bf16):
        fail("ptxas reported no bf16 flash forward")
    spilled = [n for n, p in flash_bf16.items() if spill_bytes(p)]
    if spilled:
        fail(f"bf16 flash kernels spill: {spilled}")
    hgmma = sass_counts(so, "fused_layer_prefix_kernel", "HGMMA")
    print(f"  cuobjdump -sass, HGMMA (wgmma) instructions of the bf16 fused layer: {hgmma}")
    # three tanh instantiations (B2's group, the single layer, the timed one)
    # and two erf ones (the group, the single layer)
    if len(hgmma) != 5 or not all(hgmma.values()):
        fail("the fused-layer kernel's instantiations do not all run their products on wgmma")
    hgmma_f32 = sass_counts(so, "fused_layer_f32_kernel", "HGMMA")
    print(f"  cuobjdump -sass, HGMMA (wgmma) instructions of the f32 fused layer: {hgmma_f32}")
    if len(hgmma_f32) != 5 or not all(hgmma_f32.values()):
        fail("the f32 fused-layer kernel's instantiations do not all run their products on "
             "wgmma")
    for name, props in report.items():
        if name.startswith("fused_layer_f32_kernel"):
            print(f"  f32 fused layer {name}: {spill_bytes(props)} spill bytes; {props}")
    # flash_attention.cu is bf16 only: the f32 forward at tile width 64 is
    # flash_attention_f32.cu's
    f32_fwd64 = [n for n in report if n.startswith("flash_fwd_kernel") and "bfloat16" not in n]
    if f32_fwd64:
        fail(f"flash_attention.cu built an f32 forward: {f32_fwd64}")
    # nine width-128 kernels: the bf16 forward, dQ and dK/dV, each with its
    # TMA and its cp.async instantiation, and the f32 forward, dQ and dK/dV
    wide = {n: p for n, p in report.items() if n.startswith("flash_") and "_wide_" in n}
    if len(wide) != 9:
        fail(f"ptxas reported {len(wide)} width-128 wgmma flash instantiations, not 9")
    for name, props in wide.items():
        print(f"  width-128 flash {name}: {spill_bytes(props)} spill bytes; {props}")
    hgmma_flash = sass_counts(so, ("flash_bwd_", "flash_fwd_f32_kernel"), "HGMMA")
    hgmma_bwd = {n: c for n, c in hgmma_flash.items()
                 if n.startswith("flash_bwd_") and "_wide_bf16_" in n}
    print(f"  cuobjdump -sass, HGMMA (wgmma) instructions of the bf16 width-128 backward: "
          f"{hgmma_bwd}")
    if len(hgmma_bwd) != 4 or not all(hgmma_bwd.values()):
        fail("the bf16 width-128 dQ and dK/dV kernels do not all run their products on wgmma")
    # the f32 width-64 kernels: the forward, dQ and dK/dV, each <true> (bulk
    # tensor copies) and <false> (cp.async)
    f32_narrow = ("flash_fwd_f32_kernel", "flash_bwd_dq_f32_kernel", "flash_bwd_dkv_f32_kernel")
    narrow = {n: p for n, p in report.items() if n.startswith(f32_narrow)}
    for name, props in narrow.items():
        print(f"  f32 width-64 flash {name}: {spill_bytes(props)} spill bytes; {props}")
    if len(narrow) != 6:
        fail(f"ptxas reported {len(narrow)} f32 width-64 flash instantiations, not 6")
    if any(spill_bytes(p) for p in narrow.values()):
        fail("the f32 width-64 flash kernels spill")
    hgmma_f32_narrow = {n: c for n, c in hgmma_flash.items() if n.startswith(f32_narrow)}
    print(f"  cuobjdump -sass, HGMMA (wgmma) instructions of the f32 width-64 kernels: "
          f"{hgmma_f32_narrow}")
    if len(hgmma_f32_narrow) != 6 or not all(hgmma_f32_narrow.values()):
        fail("the f32 width-64 forward, dQ and dK/dV kernels do not all run their products on "
             "wgmma")

    # ---- 2. kernel against its plain version -----------------------------
    print(f"[2] ({since_start()}) kernel vs plain version (bf16, then f32)")
    gen = torch.Generator().manual_seed(0)
    # batches that leave the last 64-row tile part-filled: 1999 envs of 8
    # tokens (8 envs per tile), 2000 envs of 10 tokens (6 envs per tile)
    err = max(check_kernel("kitchen", 360, 6, 3, 8, 3, 9, 1999, device, gen),
              check_kernel("block_push", 240, 12, 2, 10, 3, 2, 2000, device, gen))
    lim = fl._limits(torch.float32)
    print(f"  f32 kernel: {lim.rows} rows per block, clusters of {lim.cluster} blocks")
    # and in f32 batches with an odd tile count: 1985 envs of 8 tokens (249
    # tiles), 1995 of 10 (333): the last cluster's second block has no rows
    err_f32 = max(check_kernel(name, D, H, P, T2, 3, M, B, device, gen, torch.float32,
                               F32_FRACTION)
                  for name, D, H, P, T2, M, B in (
                      ("kitchen", 360, 6, 3, 8, 9, 1999), ("block_push", 240, 12, 2, 10, 2, 2000),
                      ("kitchen", 360, 6, 3, 8, 9, 1985),
                      ("block_push", 240, 12, 2, 10, 2, 1995)))
    B_serve = 2 * N_ENVS  # lambda=1.5 CFG stacks [cond, uncond]
    ms, plain_ms = time_kernel(B_serve, device, gen)
    print(f"  time at the kitchen serving shape (B={B_serve}, 2T=8, D=360): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per layer ({card})")
    ms_f32, plain_ms_f32 = time_kernel(B_serve, device, gen, torch.float32)
    gemm_b1_f32 = time_layer_gemms(B_serve * 8, 360, device, gen, dtype=torch.float32)
    print(f"  f32 at the same shape: kernel {ms_f32:.4f} ms, plain {plain_ms_f32:.4f} ms, "
          f"f32 torch.matmul of its four products (TF32 off) {gemm_b1_f32:.4f} ms ({card})")
    phases = phase_split(B_serve, device, gen)
    print(f"  phase split: {json.dumps({k: round(v) for k, v in phases.items()})}")
    phases_f32 = phase_split(B_serve, device, gen, torch.float32)
    print(f"  f32 phase split: {json.dumps({k: round(v) for k, v in phases_f32.items()})}")
    # f32 B1 at the block-push serving shape (phase 12's launches)
    bp_ms, bp_plain_ms = time_kernel(B_serve, device, gen, torch.float32, BLOCK_PUSH_LAYER)
    bp_gemm_ms = time_layer_gemms(B_serve * 10, 240, device, gen, dtype=torch.float32)
    bp_bound, bp_bound_by = bound(*layer_work(B_serve, 10, 240, 2, elem=4),
                                  PEAK_F32_BF16X3_FLOPS)
    print(f"  f32 at the block-push serving shape (B={B_serve}, 2T=10, D=240, 12 heads, P=2): "
          f"kernel {bp_ms:.4f} ms, plain {bp_plain_ms:.4f} ms, f32 torch.matmul of its four "
          f"products {bp_gemm_ms:.4f} ms, bound {bp_bound:.4f} ms ({bp_bound_by}), "
          f"{100 * bp_bound / bp_ms:.1f}% of the roofline ({card})")
    phases_bp = phase_split(B_serve, device, gen, torch.float32, BLOCK_PUSH_LAYER)
    print(f"  f32 block-push phase split: "
          f"{json.dumps({k: round(v) for k, v in phases_bp.items()})}")
    b1_block_push = {"ms": bp_ms, "plain_ms": bp_plain_ms, "gemm_ms": bp_gemm_ms}

    # ---- 3. engine parity -------------------------------------------------
    print(f"[3] ({since_start()}) fused_cached vs cached engine (kitchen model, bf16, "
          f"then f32)")
    model_kw, policy_kw, scale_data = kitchen_config()
    den = build_model(model_kw, device, seed=0)
    check_engine(den, device, 256, gen)
    den32 = build_model(model_kw, device, seed=8, dtype=torch.float32)
    check_engine(den32, device, 256, gen, F32_ENGINE_FRACTION)

    # ---- 4. main path -----------------------------------------------------
    print(f"[4] ({since_start()}) kitchen rollout: {N_ENVS} envs x {N_STEPS} steps, "
          f"fused_cached")
    run_rollout(den, policy_kw, scale_data, N_ENVS, 2, device, seed=1)  # warm-up
    torch.cuda.synchronize()
    fl.fused_layer_prefix.launches = 0
    ks.kitchen_step.launches = 0
    with recording_kitchen_steps() as recorded:
        t0 = time.perf_counter()
        metrics = run_rollout(den, policy_kw, scale_data, N_ENVS, N_STEPS, device, seed=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = fl.fused_layer_prefix.launches
    physics_launches = {"phase 4 rollout": ks.kitchen_step.launches}
    expect = N_STEPS * NFE * N_LAYERS
    print(f"  launches: {launches} (expected {expect}); kitchen_step kernel "
          f"{ks.kitchen_step.launches} (expected {N_STEPS})")
    if launches != expect:
        fail(f"the main path launched the kernel {launches} times, not {expect}")
    if ks.kitchen_step.launches != N_STEPS:
        fail(f"the main path launched the kitchen step kernel {ks.kitchen_step.launches} "
             f"times, not {N_STEPS}")
    check_rollout_metrics(metrics, N_ENVS, N_STEPS)
    hist = success_rate_histogram(metrics.completed.sum(-1).cpu().numpy())
    print(f"  wall {wall:.3f} s, {N_ENVS * N_STEPS / wall:.1f} env-steps/s "
          f"(informational; random weights; {card})")
    print(f"  success_rate_histogram: {json.dumps(hist)}")
    print(f"[4b] ({since_start()}) kitchen_step kernel vs the eager step on the states of "
          f"{N_ENVS}- and {KS_CELL_ENVS}-env rollouts")
    ks.kitchen_step.launches = 0
    with recording_kitchen_steps() as recorded_cell:
        run_rollout(den, policy_kw, scale_data, KS_CELL_ENVS, N_STEPS, device, seed=3)
    physics_launches[f"phase 4b {KS_CELL_ENVS}-env rollout"] = ks.kitchen_step.launches
    if ks.kitchen_step.launches != N_STEPS:
        fail(f"the {KS_CELL_ENVS}-env rollout launched the kitchen step kernel "
             f"{ks.kitchen_step.launches} times, not {N_STEPS}")
    ks_entry = check_kitchen_step_on_card(device, card,
                                          {N_ENVS: recorded, KS_CELL_ENVS: recorded_cell})

    # ---- 5. flash kernels against their plain versions --------------------
    from beso_tpu_torch.ops import flash_attention as fa

    print(f"[5] ({since_start()}) flash kernels vs plain versions (bf16, then f32)")
    flash_err = {}
    for dtype, frac, suffix in ((torch.bfloat16, ERR_FRACTION, ""),
                                (torch.float32, F32_FRACTION, "_f32")):
        for shape, causal in FLASH_SHAPES:
            width = "_hd128" if shape[3] > 64 else ""
            for k, e in check_flash(*shape, causal, device, gen, dtype, frac).items():
                key = k + width + suffix
                flash_err[key] = max(flash_err.get(key, 0.0), e)
    for dtype in (torch.bfloat16, torch.float32):
        for hd in (64, 128):
            print(f"  resident blocks per SM, {dtype}, tile width {hd} (occupancy "
                  f"calculator): {fa.blocks_per_sm(dtype, hd)}")
    # one f32 forward at hd 60: flash_attention_f32.cu's kernel alone
    fwd_kernels = forward_kernels(device, gen, CHUNKED_SHAPE, torch.float32)
    print(f"  device kernels of one f32 forward at {list(CHUNKED_SHAPE)}: "
          f"{fwd_kernels if fwd_kernels is not None else 'not measured'}")
    if fwd_kernels is not None and (len(fwd_kernels) != 1
                                    or "flash_fwd_f32_kernel" not in fwd_kernels[0]):
        fail(f"the f32 forward at {list(CHUNKED_SHAPE)} is not exactly one launch of "
             f"flash_fwd_f32_kernel")
    # at hd 60 the width-64 kernels (bf16: the mma.sync template; f32: the
    # wgmma kernels of flash_attention_f32.cu), at the 3-head model's hd 120
    # the bf16 wgmma kernels of flash_attention_wide.cu
    for shape, dtype, names in (
            (CHUNKED_SHAPE, torch.bfloat16, ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")),
            (CHUNKED_SHAPE, torch.float32, ("flash_bwd_dq_f32_kernel",
                                            "flash_bwd_dkv_f32_kernel")),
            (WIDE_MODEL_SHAPE, torch.bfloat16, ("flash_bwd_dq_wide_bf16_kernel",
                                                "flash_bwd_dkv_wide_bf16_kernel"))):
        bwd_kernels = backward_kernels(device, gen, shape, dtype)
        print(f"  device kernels of one autograd backward at {list(shape)} {dtype}: "
              f"{bwd_kernels if bwd_kernels is not None else 'not measured'}")
        if bwd_kernels is not None and (len(bwd_kernels) != 2 or not all(
                any(k in n for n in bwd_kernels) for k in names)):
            fail(f"the autograd backward at {list(shape)} {dtype} is not exactly the launches "
                 f"of {' and '.join(names)}")
    flash_ms, sdpa_ms = {}, {}
    for dtype, suffix in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        tag = str(dtype).split(".")[-1]
        times = time_flash(device, gen, dtype)
        for name, (ms_k, ms_p) in times.items():
            flash_ms[name + suffix] = (ms_k, ms_p)
            print(f"  time {name} at {list(CHUNKED_SHAPE)} {tag}: kernel {ms_k:.4f} ms, "
                  f"plain {ms_p:.4f} ms ({card})")
        fwd_ms, bwd_ms_sdpa, sdpa_kernels = time_sdpa(device, gen, dtype)
        sdpa_ms[suffix] = (fwd_ms, bwd_ms_sdpa)
        print(f"  yardstick F.scaled_dot_product_attention(is_causal=True) at "
              f"{list(CHUNKED_SHAPE)} {tag}: forward {fwd_ms:.4f} ms, backward (forward + "
              f"backward minus forward) {bwd_ms_sdpa:.4f} ms; kernels: {sdpa_kernels} ({card})")
        fwd_k, bwd_k = times["flash_forward"][0], times["backward"][0]
        peak = PEAK_BF16_FLOPS if suffix == "" else PEAK_F32_BF16X3_FLOPS
        fwd_bound = bound(*flash_work("flash_forward", *CHUNKED_SHAPE, elem=dtype.itemsize),
                          peak)[0]
        bwd_bound = sum(bound(*flash_work(n, *CHUNKED_SHAPE, elem=dtype.itemsize), peak)[0]
                        for n in ("flash_backward_dq", "flash_backward_dkv"))
        print(f"  {tag} forward {fwd_k:.4f} ms against SDPA's forward {fwd_ms:.4f} ms: "
              f"{fwd_k / fwd_ms:.3f}x, {100 * fwd_bound / fwd_k:.1f}% of its {fwd_bound:.4f} ms "
              f"bound; backward total (dQ with delta + dK/dV) {bwd_k:.4f} ms "
              f"against SDPA's backward {bwd_ms_sdpa:.4f} ms: {bwd_k / bwd_ms_sdpa:.3f}x; "
              f"{100 * bwd_bound / bwd_k:.1f}% of its {bwd_bound:.4f} ms bound ({card})")
        # the width-128 instantiations at WIDE_SHAPE, beside SDPA there
        for name, (ms_k, ms_p) in time_flash(device, gen, dtype, WIDE_SHAPE).items():
            flash_ms[name + "_hd128" + suffix] = (ms_k, ms_p)
            print(f"  time {name} at {list(WIDE_SHAPE)} {tag}: kernel {ms_k:.4f} ms, "
                  f"plain {ms_p:.4f} ms ({card})")
        fwd_w, bwd_w, kern_w = time_sdpa(device, gen, dtype, WIDE_SHAPE)
        sdpa_ms["_hd128" + suffix] = (fwd_w, bwd_w)
        print(f"  yardstick SDPA at {list(WIDE_SHAPE)} {tag}: forward {fwd_w:.4f} ms, backward "
              f"{bwd_w:.4f} ms; kernels: {kern_w} ({card})")
        # and at the 3-head chunked model's shape (hd 120), information
        times_m = time_flash(device, gen, dtype, WIDE_MODEL_SHAPE)
        fwd_m, bwd_m, _ = time_sdpa(device, gen, dtype, WIDE_MODEL_SHAPE)
        print(f"  time at {list(WIDE_MODEL_SHAPE)} {tag}: forward {times_m['flash_forward'][0]:.4f}"
              f" ms (SDPA {fwd_m:.4f}), dQ {times_m['flash_backward_dq'][0]:.4f} + dK/dV "
              f"{times_m['flash_backward_dkv'][0]:.4f} = backward {times_m['backward'][0]:.4f} ms "
              f"(SDPA {bwd_m:.4f}) ({card})")

    # ---- 6. model-level: flash kernels vs broadcast -----------------------
    counts_by_dtype = {}
    for heads, dtype, loss_frac, grad_frac in (
            (None, torch.bfloat16, MODEL_LOSS_FRACTION, MODEL_GRAD_FRACTION),
            (None, torch.float32, MODEL_LOSS_FRACTION_F32, MODEL_GRAD_FRACTION_F32),
            (WIDE_HEADS, torch.bfloat16, MODEL_LOSS_FRACTION, MODEL_GRAD_FRACTION),
            (WIDE_HEADS, torch.float32, MODEL_LOSS_FRACTION_F32, MODEL_GRAD_FRACTION_F32)):
        print(f"[6] ({since_start()}) chunked model"
              f"{f' at {heads} heads (hd 120)' if heads else ''}, loss and gradients: "
              f"attention=pallas vs broadcast ({dtype})")
        for f in (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv):
            f.launches = 0
        res = check_model_grads(device, seed=3, dtype=dtype, n_heads=heads)
        torch.cuda.synchronize()
        flash_counts = {f.__name__: f.launches
                        for f in (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv)}
        (loss_b, grads_b), (loss_p, grads_p) = res["broadcast"], res["pallas"]
        _rel_check("loss", loss_p.reshape(1), loss_b.reshape(1), loss_frac)
        worst = max(((grads_p[n] - grads_b[n]).abs().max().item()
                     / max(grads_b[n].abs().max().item(), 1e-30), n) for n in grads_b)
        print(f"  gradients: worst max|diff| / max|ref| {worst[0]:.6g} ({worst[1]}), "
              f"bound {grad_frac:.6g}, over {len(grads_b)} tensors; launches {flash_counts}")
        if not (math.isfinite(worst[0]) and worst[0] <= grad_frac):
            fail(f"gradient of {worst[1]} with the flash kernels disagrees with broadcast")
        if flash_counts != dict.fromkeys(flash_counts, N_LAYERS):
            fail(f"the pallas form launched the flash kernels {flash_counts}, not {N_LAYERS} each")
        counts_by_dtype[heads, dtype] = flash_counts

    # ---- 7. main path: training -------------------------------------------
    print(f"[7] ({since_start()}) chunked kitchen training: {TRAIN_STEPS} steps x batch "
          f"{TRAIN_BATCH}, "
          f"evaluation every {EVAL_EVERY}")
    records = Records()
    ws, agent = run_training(device, seed=4, writer=records)
    n_test_batches = len(ws.test_set) // min(TRAIN_BATCH, len(ws.test_set))
    n_evals = -(-TRAIN_STEPS // EVAL_EVERY)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_forward.launches = 0
    fa.flash_backward_dq.launches = 0
    fa.flash_backward_dkv.launches = 0
    t0 = time.perf_counter()
    agent.train_agent(ws.train_set, ws.test_set, torch.Generator(device).manual_seed(5))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"flash_forward": fa.flash_forward.launches,
              "flash_backward_dq": fa.flash_backward_dq.launches,
              "flash_backward_dkv": fa.flash_backward_dkv.launches}
    expect = {"flash_forward": N_LAYERS * TRAIN_STEPS
              + N_LAYERS * NFE * n_evals * n_test_batches,
              "flash_backward_dq": N_LAYERS * TRAIN_STEPS,
              "flash_backward_dkv": N_LAYERS * TRAIN_STEPS}
    print(f"  launches: {counts} (expected {expect}; {n_evals} evaluations x "
          f"{n_test_batches} test batches)")
    if counts != expect:
        fail("the training path did not launch the flash kernels as expected")
    losses = [r["loss"] for r in records.rows if "loss" in r]
    means = [r["mean_loss"] for r in records.rows if "mean_loss" in r]
    mses = [r["test_loss"] for r in records.rows if "test_loss" in r]
    print(f"  losses (last of each interval): {losses}; test mse: {mses}")
    if (len(mses) != n_evals or not losses
            or not all(math.isfinite(x) for x in losses + means + mses)):
        fail("a training loss or test mse is not finite")
    # train-only rate: from the end of the step-0 evaluation to the loss
    # read-out after the first EVAL_EVERY steps (both sync the device)
    t_eval0 = next(r["_time"] for r in records.rows if "test_loss" in r)
    t_loss1 = next(r["_time"] for r in records.rows if "loss" in r)
    print(f"  wall {wall:.3f} s for {TRAIN_STEPS} steps and {n_evals} evaluations; "
          f"train {EVAL_EVERY / (t_loss1 - t_eval0):.2f} steps/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
          f"(informational; random weights; {card})")
    mg = ws.test_agent(agent, generator=torch.Generator(device).manual_seed(6),
                       log_metrics=False, cond_lambda=1.5)
    if not all(math.isfinite(mg[k]) for k in ("avrg_reward", "avrg_result")):
        fail("the trained agent's rollout metrics are not finite")
    print(f"  trained agent, {ws.eval_n_times} envs x {ws.eval_n_steps} steps on the "
          f"cached engine: avrg_reward {mg['avrg_reward']:.4f}")
    # the same config at WIDE_HEADS heads (hd 120): the width-128 flash kernels
    # end to end, WIDE_TRAIN_STEPS steps after the step-0 evaluation
    records_w = Records()
    ws_w, agent_w = run_training(device, seed=7, writer=records_w, n_heads=WIDE_HEADS,
                                 max_train_steps=WIDE_TRAIN_STEPS,
                                 eval_every_n_steps=WIDE_TRAIN_STEPS)
    for f in (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv):
        f.launches = 0
    agent_w.train_agent(ws_w.train_set, ws_w.test_set, torch.Generator(device).manual_seed(8))
    torch.cuda.synchronize()
    counts_w = {f.__name__: f.launches
                for f in (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv)}
    n_batches_w = len(ws_w.test_set) // min(TRAIN_BATCH, len(ws_w.test_set))
    expect_w = {"flash_forward": N_LAYERS * WIDE_TRAIN_STEPS + N_LAYERS * NFE * n_batches_w,
                "flash_backward_dq": N_LAYERS * WIDE_TRAIN_STEPS,
                "flash_backward_dkv": N_LAYERS * WIDE_TRAIN_STEPS}
    losses_w = [r["loss"] for r in records_w.rows if "loss" in r]
    if counts_w != expect_w or not losses_w or not all(math.isfinite(x) for x in losses_w):
        fail(f"the {WIDE_HEADS}-head training launched {counts_w} (expected {expect_w}) or "
             f"a loss is not finite ({losses_w})")
    t_eval0 = next(r["_time"] for r in records_w.rows if "test_loss" in r)
    t_loss1 = next(r["_time"] for r in records_w.rows if "loss" in r)
    print(f"  {WIDE_HEADS}-head model (hd 120, the width-128 kernels): {WIDE_TRAIN_STEPS} steps "
          f"x batch {TRAIN_BATCH}, launches {counts_w}; train "
          f"{WIDE_TRAIN_STEPS / (t_loss1 - t_eval0):.2f} steps/s (informational; random "
          f"weights; {card})")

    # ---- 8. fused-layer kernels B2, B3, B4 against their plain versions ---
    print(f"[8] ({since_start()}) fused-layer kernels B4, B3, B2 vs plain versions "
          f"(bf16, then f32)")
    layer_err = check_other_layers(device, gen)
    layer_err.update({k + "_f32": e for k, e in check_other_layers(
        device, gen, torch.float32, F32_FRACTION).items()})
    layer_ms = time_other_layers(B_serve, device, gen)
    layer_ms.update({k + "_f32": t for k, t in time_other_layers(
        B_serve, device, gen, torch.float32).items()})
    for name, (ms_k, ms_p) in layer_ms.items():
        print(f"  time {name} at B={B_serve}, D=360: kernel {ms_k:.4f} ms, "
              f"plain {ms_p:.4f} ms ({card})")
    # the four products of each form as torch.matmul in the same dtype
    # (information only; f32 with TF32 off)
    gemm_ms = {}
    for dtype, suffix in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        gemm_ms.update({
            "fused_layer_prefix" + suffix: time_layer_gemms(B_serve * 8, 360, device, gen,
                                                            dtype=dtype),
            "fused_layers_prefix_group" + suffix: time_layer_gemms(B_serve * 8, 360, device,
                                                                   gen, 2, dtype),
            "fused_layer" + suffix: time_layer_gemms(B_serve * 11, 360, device, gen,
                                                     dtype=dtype)})
        gemm_ms["fused_layer_with_prefix" + suffix] = gemm_ms["fused_layer_prefix" + suffix]
    for name, t in gemm_ms.items():
        print(f"  torch.matmul of the same products ({name}): {t:.4f} ms ({card})")

    # ---- 9. the other engine forms against plain forwards -----------------
    print(f"[9] ({since_start()}) make_fused_denoise_fn vs plain forward; fused_cached "
          f"forms vs default "
          "(bf16, then f32)")
    check_full_engine(den, device, 256, gen, "linear head")
    den_mlp = build_model({**model_kw, "linear_output": False}, device, seed=7)
    check_full_engine(den_mlp, device, 256, gen, "MLP head")
    check_cached_forms(den, device, 256, gen)
    check_full_engine(den32, device, 256, gen, "f32 linear head", F32_ENGINE_FRACTION)
    den32_mlp = build_model({**model_kw, "linear_output": False}, device, seed=9,
                            dtype=torch.float32)
    check_full_engine(den32_mlp, device, 256, gen, "f32 MLP head", F32_ENGINE_FRACTION)
    check_cached_forms(den32, device, 256, gen, F32_ENGINE_FRACTION)

    # ---- 10. main paths of the other engine forms -------------------------
    calls = ROLLOUT_STEPS * NFE
    form_counts = {}
    for model, suffix in ((den, ""), (den32, "_f32")):
        tag = str(model.inner_model.dtype)[6:]
        print(f"[10a] ({since_start()}) kitchen rollout: {N_ENVS} envs x {ROLLOUT_STEPS} "
              f"steps, fused_cached, "
              f"BESO_LAYER_GROUP=2 ({tag})")
        os.environ["BESO_LAYER_GROUP"] = "2"
        try:
            counts_a = run_engine_rollout(
                model, policy_kw, scale_data, device, "fused_cached",
                {"fused_layers_prefix_group": calls * -(-N_LAYERS // 2)}, card)
        finally:
            del os.environ["BESO_LAYER_GROUP"]
        print(f"[10b] ({since_start()}) kitchen rollout: {N_ENVS} envs x {ROLLOUT_STEPS} "
              f"steps, fused_cached, "
              f"token_lanes=False ({tag})")
        counts_b = run_engine_rollout(model, policy_kw, scale_data, device, "token_lanes_false",
                                      {"fused_layer_with_prefix": calls * N_LAYERS}, card)
        print(f"[10c] ({since_start()}) kitchen rollout: {N_ENVS} envs x {ROLLOUT_STEPS} "
              f"steps, "
              f"make_fused_denoise_fn (no cache) ({tag})")
        counts_c = run_engine_rollout(model, policy_kw, scale_data, device, "uncached",
                                      {"fused_layer": calls * N_LAYERS}, card)
        form_counts.update({"fused_layers_prefix_group" + suffix:
                            counts_a["fused_layers_prefix_group"],
                            "fused_layer_with_prefix" + suffix:
                            counts_b["fused_layer_with_prefix"],
                            "fused_layer" + suffix: counts_c["fused_layer"]})

    # ---- 11. main path: the shipped kitchen config as shipped (f32) -------
    print(f"[11] ({since_start()}) shipped kitchen config (f32) from data_path files: "
          f"{MAIN_TRAIN_STEPS} train "
          f"steps, then a {N_ENVS}-env x {N_STEPS}-step multigoal evaluation on fused_cached")
    f32_counts, kitchen_ws, kitchen_agent = run_f32_main_path(device, card)

    # ---- 12. main path: the shipped block-push config as shipped (f32) ----
    print(f"[12] ({since_start()}) shipped block-push config (f32) from data_path files: "
          f"{MAIN_TRAIN_STEPS} train steps, then a {N_ENVS}-env x {BP_STEPS}-step evaluation "
          f"on fused_cached")
    run_block_push_main_path(device, card, b1_block_push)

    # ---- 13. the reference-checkpoint model and the evaluation CLI -------
    print(f"[13a] ({since_start()}) erf GELU form of B1-B4 vs plain versions (bf16, then "
          f"f32); erf B1 timed beside tanh B1")
    erf_err = {"": check_erf_kernels(device, gen, torch.bfloat16, ERR_FRACTION),
               "_f32": check_erf_kernels(device, gen, torch.float32, F32_FRACTION)}
    erf_ms = {}
    for dtype, suffix in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        tanh_ms, e_ms, e_plain = time_erf_b1(B_serve, device, gen, dtype)
        erf_ms[suffix] = (e_ms, e_plain)
        print(f"  {str(dtype)[6:]} B1 at the kitchen serving shape: tanh {tanh_ms:.4f} ms, erf "
              f"{e_ms:.4f} ms ({e_ms / tanh_ms:.4f}x), erf plain {e_plain:.4f} ms ({card})")
    print(f"[13b] ({since_start()}) reference-checkpoint model (erf GELU, kitchen width) "
          f"through a .pth: engines, then a {N_ENVS}-env x {ERF_ROLLOUT_STEPS}-step rollout")
    erf_launches = run_reference_checkpoint_path(device, card, gen)
    print(f"[13c] ({since_start()}) evaluation CLI on the shipped evaluation configs")
    run_evaluation_cli(device, card)

    # ---- 14. every sampler, mean/KDE, the sequential evaluation -----------
    t14 = time.perf_counter()
    print(f"[14a] ({since_start()}) every sampler and Picard on phase 11's f32 fused_cached "
          f"agent's engines: B4 vs plain forward, B1 vs cached")
    seq_launches = check_samplers_on_card(kitchen_agent, kitchen_ws, device, card)
    print(f"[14b] ({since_start()}) mean and KDE of {N_SAMPLES} action samples: the agent's "
          f"engine (B4), then the workspace's multigoal evaluation")
    seq_launches["fused_layer"] += check_multi_sample_on_card(kitchen_agent, kitchen_ws,
                                                              device, card)
    print(f"[14c] ({since_start()}) the workspace's sequential kitchen evaluation on B4")
    seq_launches["fused_layer"] += run_sequential_on_card(kitchen_agent, kitchen_ws, device,
                                                          card)
    print(f"[14d] ({since_start()}) scripted kitchen_step episodes on the card vs the CPU, "
          f"the MuJoCo bands on the card's outcome")
    check_kitchen_fidelity_on_card(device)
    print(f"[14e] ({since_start()}) evaluation CLI modes test_all_samplers and "
          f"compare_noisy_sampler, inference_engine=fused_cached")
    for kernel, n in run_cli_modes(card).items():
        seq_launches[kernel] += n
    print(f"[14f] ({since_start()}) bench_picard at BESO scale (information only)")
    from beso_tpu_torch.scripts import bench_picard

    bench_picard.main(["--window", "4", "--batch", "4", "--nfe", "50", "--reps", "10"])
    print(f"  phase 14: {time.perf_counter() - t14:.3f} s; its f32 launches {seq_launches}")

    # ---- 15. the vision path: oracle demos, cameras, vision policies -------
    t15 = time.perf_counter()
    print(f"[15a] ({since_start()}) generate_demos on the card: {DEMO_EPISODES} episodes of "
          f"block push and of kitchen")
    demo_obs = run_demo_generation(card)
    print(f"[15b] ({since_start()}) both cameras at 128 x 128, card vs CPU, timed")
    check_cameras_on_card(device, card, demo_obs)
    print(f"[15c] ({since_start()}) both vision policies at full width: f32 loss and "
          f"gradients, card vs CPU; bf16 forward vs f32")
    check_vision_grads_on_card(device, card, demo_obs)
    print(f"[15d] ({since_start()}) validate_vision_e2e through its CLI: block push with "
          f"encoder pretraining, then kitchen")
    run_vision_cli(card)
    print(f"[15e] ({since_start()}) where a vision train step's device time goes "
          f"(information)")
    profile_vision_step(device, card)
    print(f"  phase 15: {time.perf_counter() - t15:.3f} s")

    # ---- 16. the training tools: seed sweep, validate_e2e, profile_train --
    t16 = time.perf_counter()
    print(f"[16a] ({since_start()}) B5/B6 under a seed axis (vmap): one launch on the folded "
          f"batch")
    check_flash_seed_axis(device, card)
    print(f"[16b] ({since_start()}) scripts/sweep.py on the chunked kitchen config: seeds "
          f"{list(SWEEP_SEEDS)} x {SWEEP_STEPS} steps x batch {TRAIN_BATCH}, then 1 seed")
    sweep_launches = run_chunked_sweep(device, card)
    print(f"[16c] ({since_start()}) scripts/sweep.py on the 11-token kitchen config (f32): 1 "
          f"and {KITCHEN_SWEEP_SEEDS} seeds; a seed's run dir through scripts/evaluate.py")
    run_kitchen_sweep(device, card)
    print(f"[16d] ({since_start()}) scripts/validate_e2e.py: kitchen with --robustness "
          f"--lambda-sweep, then block push")
    run_validate_e2e(card)
    print(f"[16e] ({since_start()}) scripts/profile_train.py: the profile and a --scaling grid")
    run_profile_train(card)
    print(f"  phase 16: {time.perf_counter() - t16:.3f} s")

    # ---- 17. the multi-device layer: sharded rollouts, dp / tp steps -------
    t17 = time.perf_counter()
    print(f"[17] ({since_start()}) the multi-device layer on torch.distributed: an NCCL "
          f"rank (W=1) and two gloo ranks sharing the card (W=2)")
    p17_paths = run_phase17(device, card)
    print(f"  phase 17: {time.perf_counter() - t17:.3f} s")

    # ---- 18. guidance on B1, the profiler trace, bf16 moments, calibration -
    t18 = time.perf_counter()
    p18 = run_phase18(device, card, den32, policy_kw, scale_data, ws, agent)
    print(f"  phase 18: {time.perf_counter() - t18:.3f} s")

    # one launch each at the timed shapes: B1, B3 2048 envs x 8 tokens, P=3;
    # B2 a group of 2; B4 2048 x 11 tokens, P=0, in bf16 and f32; the flash
    # kernels at the chunked shape and their width-128 instantiations at
    # WIDE_SHAPE, bf16 and f32 (f32 operations as three bf16 products each,
    # PEAK_F32_BF16X3_FLOPS; f32 bytes at 4 per element). library_ms: one
    # PyTorch call computing the same function in the same dtype, where
    # there is one (SDPA for B5; for both B6 kernels SDPA's whole backward,
    # forward + backward minus forward). Launches: bf16 B1 on phase 4, f32 B1
    # on phase 11, B2-B4 on phase 10, the flash kernels on phase 7 (bf16: the
    # 6-head model at width 64, the 3-head model at width 128) and phase 6
    # (f32: the 6-head and the 3-head model); B1's erf form on phase 13b.
    work, library_ms = {}, {}
    for suffix, elem in (("", 2), ("_f32", 4)):
        work.update({"fused_layer_prefix" + suffix: layer_work(B_serve, 8, 360, 3, elem=elem),
                     "fused_layer_with_prefix" + suffix: layer_work(B_serve, 8, 360, 3,
                                                                    elem=elem),
                     "fused_layers_prefix_group" + suffix: layer_work(B_serve, 8, 360, 3, 2,
                                                                      elem),
                     "fused_layer" + suffix: layer_work(B_serve, 11, 360, 0, elem=elem)})
        for width, shape in (("", CHUNKED_SHAPE), ("_hd128", WIDE_SHAPE)):
            work.update({name + width + suffix: flash_work(name, *shape, elem=elem)
                         for name in ("flash_forward", "flash_backward_dq",
                                      "flash_backward_dkv")})
            fwd_l, bwd_l = sdpa_ms[width + suffix]
            library_ms.update({"flash_forward" + width + suffix: fwd_l,
                               "flash_backward_dq" + width + suffix: bwd_l,
                               "flash_backward_dkv" + width + suffix: bwd_l})
    layer_src = "beso_tpu_torch/csrc/fused_layer_prefix.cu"
    f32_src = "beso_tpu_torch/csrc/fused_layer_f32.cu"
    # B1: each path's launches (phase 17's per rank) beside their sum
    by_path = {"fused_layer_prefix": {"phase 4 rollout": launches,
                                      **p17_paths["fused_layer_prefix"]},
               "fused_layer_prefix_f32": {
                   "phase 11 evaluation": f32_counts["fused_layer_prefix"],
                   "phase 14": seq_launches["fused_layer_prefix"],
                   **p17_paths["fused_layer_prefix_f32"],
                   "phase 18a guided rollout": p18["fused_layer_prefix_f32"]}}
    entries = [("fused_layer_prefix", layer_src, "beso_tpu/ops/fused_layer.py:618",
                sum(by_path["fused_layer_prefix"].values()), err, ms, plain_ms),
               ("fused_layer_prefix_f32", f32_src, "beso_tpu/ops/fused_layer.py:618",
                sum(by_path["fused_layer_prefix_f32"].values()), err_f32, ms_f32,
                plain_ms_f32)]
    form_counts["fused_layer_f32"] += seq_launches["fused_layer"]
    for name, line in (("fused_layers_prefix_group", 488), ("fused_layer_with_prefix", 258),
                       ("fused_layer", 298)):
        for suffix, src in (("", layer_src), ("_f32", f32_src)):
            entries.append((name + suffix, src, f"beso_tpu/ops/fused_layer.py:{line}",
                            form_counts[name + suffix], layer_err[name + suffix],
                            *layer_ms[name + suffix]))
    gemm_ms["fused_layer_prefix_f32"] = gemm_b1_f32
    # B1's erf GELU form: the same work and products as tanh B1 (the GELU
    # adds elementwise work only); launches on phase 13b's rollouts
    for suffix, src in (("", "beso_tpu_torch/csrc/fused_layer_prefix_erf.cu"),
                        ("_f32", "beso_tpu_torch/csrc/fused_layer_f32_erf.cu")):
        name = "fused_layer_prefix" + suffix
        work[name + "_erf"] = work[name]
        gemm_ms[name + "_erf"] = gemm_ms[name]
        entries.append((name + "_erf", src, "beso_tpu/ops/fused_layer.py:618",
                        erf_launches[suffix], erf_err[suffix]["fused_layer_prefix"],
                        *erf_ms[suffix]))
    flash_src = "beso_tpu_torch/csrc/flash_attention.cu"
    wide_src = "beso_tpu_torch/csrc/flash_attention_wide.cu"
    f32_flash_src = "beso_tpu_torch/csrc/flash_attention_f32.cu"
    # the bf16 width-64 kernels: phase 7's training, phase 16b's sweeps and
    # phase 17c's dp and tp steps (per rank), each path's own count printed
    # beside the sum
    by_path.update({k: {"phase 7 training": n, "phase 16b sweeps": sweep_launches[k],
                        **{path: c[k] for path, c in p17_paths["flash"].items()},
                        "phase 18b trace": p18["flash"][k]}
                    for k, n in counts.items()})
    counts = {k: sum(by_path[k].values()) for k in counts}
    flash_counts_of = {"": counts, "_f32": counts_by_dtype[None, torch.float32],
                       "_hd128": counts_w,
                       "_hd128_f32": counts_by_dtype[WIDE_HEADS, torch.float32]}
    for key, n_of in flash_counts_of.items():
        for name, line in (("flash_forward", 269), ("flash_backward_dq", 78),
                           ("flash_backward_dkv", 112)):
            # width 128: every kernel in the wgmma source; width 64: bf16 in
            # flash_attention.cu, f32 in its own
            src = (wide_src if key.startswith("_hd128") else
                   f32_flash_src if key == "_f32" else flash_src)
            entries.append((name + key, src, f"beso_tpu/ops/flash_attention.py:{line}",
                            n_of[name], flash_err[name + key], *flash_ms[name + key]))
    kernels = []
    for name, source, replaces, n, e, k_ms, p_ms in entries:
        bound_ms, bound_by = bound(*work[name], PEAK_F32_BF16X3_FLOPS if "_f32" in name
                                   else PEAK_BF16_FLOPS)
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": n, "max_abs_err": e, "ms": k_ms, "plain_ms": p_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": library_ms.get(name)}
        if name in gemm_ms:
            entry["gemm_ms"] = gemm_ms[name]
        if name in by_path:
            entry["launches_by_path"] = by_path[name]
        kernels.append(entry)
        print(f"  {name}: {k_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{100 * bound_ms / k_ms:.1f}% of the roofline ({card})")
    # the kitchen step (no TPU kernel: beso_tpu's is jnp that XLA fuses), at
    # N_ENVS envs, with its times and bound at the cells' 100 beside them
    kernels.append({"name": "kitchen_step", "route": "cuda",
                    "source": "beso_tpu_torch/csrc/kitchen_step.cu",
                    "replaces": "beso_tpu/envs/kitchen/env.py:351 (jnp, no TPU kernel)",
                    "launches": sum(physics_launches.values()),
                    "launches_by_path": physics_launches, **ks_entry, "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
