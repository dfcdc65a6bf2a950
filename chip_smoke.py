#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`beso_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA card, the CUDA toolkit's
`nvcc` (the kernels are built here from `beso_tpu_torch/csrc/` on first use,
into `build/`) and no network; it imports no JAX. Phases, each of which
exits non-zero on failure:

0. device: name and power limit (nvidia-smi), torch/CUDA versions, TF32 off;
1. build: compile the kernel library for sm_90a, print seconds, ptxas's
   registers, stack and spill bytes per kernel (each flash kernel in its
   bf16 and f32 instantiation at tile width 64, the bf16 backward at 128,
   and the five width-128 `wgmma` kernels of flash_attention_wide.cu, all
   of which must be there; no bf16 width-64 flash kernel may spill) and,
   from cuobjdump -sass, the HGMMA (wgmma)
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
   layers, every metric must be finite;
5. flash kernels: the forward (B5) and the backward (B6: the dQ kernel,
   which also computes delta = rowsum(dO * O), and the dK/dV kernel)
   against their plain PyTorch versions, o, lse, dq, delta, dk and dv each
   within 2^-5 of max |ref| in bf16, then the same in f32 within 2^-12, at
   the chunked training shape [256, 6, 131, 60] (causal), at ragged small
   shapes ([3, 2, 77, 20] causal and full, T = 16 and 144 at hd 60, hd 18
   and hd 15) and at the width-128 shapes [2, 4, 131, 128] causal,
   [2, 2, 77, 96] full, [2, 3, 131, 120] causal, [2, 2, 65, 100] causal (rows
   not 16-byte aligned), [2, 2, 16, 72] full, and the timed width-128 shapes
   [256, 3, 131, 120] and [256, 3, 131, 128] causal (the 3-head model's
   grid, with blocks sharing SMs); a second launch of each
   kernel must be bit-equal to
   the first; prints the three kernels' resident blocks per SM in both
   instantiations at both widths; the autograd backward must run exactly
   two device kernels, the dQ and the dK/dV kernel (torch.profiler; "not
   measured" if it sees no kernel). Times each kernel, the backward total
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
   `configs/evaluate_blocks.yaml` (100 x 300): the agent's "auto" engine,
   the plain cached one, so no fused-layer launch; env-steps/s over each
   command's wall time and finite metrics printed.

The second-to-last line is the kernels' JSON record (per kernel its
launches on its main path, max |diff|, ms, plain ms, the roofline bound
of its work at the timed shape with what bounds it, the PyTorch library
call's ms where one computes the same function, and for the fused layers
the torch.matmul ms of their products in the same dtype; f32 forms as
`*_f32`, the flash kernels' width-128 instantiations as `*_hd128`, B1's
erf GELU form as `fused_layer_prefix_erf` and `fused_layer_prefix_f32_erf`);
the last line `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

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
ERF_ROLLOUT_STEPS = 40  # phase 13b's rollout of the erf model (280 cut to 40)
# block push: phase 12's evaluation steps (eval_n_steps: 300, configs/block_push.yaml:62,
# cut to 100 since phase 13 came, to hold the run near half its time limit), layers
BP_STEPS, BP_LAYERS = 100, 4
BP_PHYSICS_STEPS = 30   # phase 12's second, instrumented evaluation (300 cut to 30)
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
                ((2, 3, 16, 60), True), ((2, 3, 144, 60), True), ((2, 3, 131, 18), True),
                ((2, 2, 50, 15), False), ((2, 4, 131, 128), True), ((2, 2, 77, 96), False),
                ((2, 3, 131, 120), True), ((2, 2, 65, 100), True), ((2, 2, 16, 72), False),
                (WIDE_MODEL_SHAPE, True), (WIDE_SHAPE, True))
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


def sass_counts(so, kernel, opcode):
    """{kernel and template arguments (mangled): number of `opcode`
    instructions} over the functions of the built library whose name holds
    `kernel` (cuobjdump -sass, beside nvcc)."""
    from beso_tpu_torch.ops.build import find_nvcc

    cuobjdump = Path(find_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                         timeout=300).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            # the mangled name from the kernel's on: its template arguments
            fn = name[name.index(kernel):] if kernel in name else None
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


def run_rollout(den, policy_kw, scale_data, n_envs, n_steps, device, seed,
                engine="fused_cached"):
    """A kitchen rollout. `engine`: "fused_cached" (the serving main path,
    B1, or B2 under BESO_LAYER_GROUP), "token_lanes_false" (B3) or
    "uncached" (`make_fused_denoise_fn`, B4, no factory)."""
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


def backward_kernels(device, gen):
    """The device kernels that one autograd backward through
    `flash_attention` runs at the chunked shape (torch.profiler; bf16,
    contiguous cotangent, leaves without a gradient yet), or None where
    the profiler saw no device kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from beso_tpu_torch.ops import flash_attention as fa

    leaves = [_rand(gen, *CHUNKED_SHAPE, device=device).requires_grad_() for _ in range(3)]
    do = _rand(gen, *CHUNKED_SHAPE, device=device)
    fa.flash_attention(*leaves).backward(do)   # warm-up
    for t in leaves:
        t.grad = None
    o = fa.flash_attention(*leaves)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        o.backward(do)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))]
    return names or None


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
    Returns the counts."""
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
    return counts


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
    `beso_tpu_torch.scripts.evaluate` with the evaluation config as shipped,
    then its CFG study at 5 lambdas x 40 steps; the fused-layer counters set
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
                ("single variant", [], 1),
                ("CFG study", ["test_single_variant=false",
                               "compare_classifier_free_guidance=true",
                               "num_steps_per_run=40"], 5)):
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


class Records:
    """In-memory metrics writer: keeps every record the trainer logs."""

    def __init__(self):
        self.rows = []

    def log(self, metrics, step=None):
        self.rows.append({"_time": time.perf_counter(), "_step": step, **metrics})


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
    # the width-64 bf16 instantiations (template argument 64: "Li64E") may
    # not spill; the width-128 and f32 ones may
    flash_bf16 = {n: p for n, p in report.items()
                  if n.startswith("flash_") and "bfloat16" in n and "Li64E" in n}
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
    wide = {n: p for n, p in report.items() if n.startswith("flash_") and "_wide_" in n}
    if len(wide) != 5:
        fail(f"ptxas reported {len(wide)} width-128 wgmma flash kernels, not 5")
    for name, props in wide.items():
        print(f"  width-128 flash {name}: {spill_bytes(props)} spill bytes; {props}")

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
    t0 = time.perf_counter()
    metrics = run_rollout(den, policy_kw, scale_data, N_ENVS, N_STEPS, device, seed=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fl.fused_layer_prefix.launches
    expect = N_STEPS * NFE * N_LAYERS
    print(f"  launches: {launches} (expected {expect})")
    if launches != expect:
        fail(f"the main path launched the kernel {launches} times, not {expect}")
    check_rollout_metrics(metrics, N_ENVS, N_STEPS)
    hist = success_rate_histogram(metrics.completed.sum(-1).cpu().numpy())
    print(f"  wall {wall:.3f} s, {N_ENVS * N_STEPS / wall:.1f} env-steps/s "
          f"(informational; random weights; {card})")
    print(f"  success_rate_histogram: {json.dumps(hist)}")

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
    bwd_kernels = backward_kernels(device, gen)
    print(f"  device kernels of one autograd backward: "
          f"{bwd_kernels if bwd_kernels is not None else 'not measured'}")
    if bwd_kernels is not None and (len(bwd_kernels) != 2 or not all(
            any(k in n for n in bwd_kernels) for k in ("flash_bwd_dq_kernel",
                                                       "flash_bwd_dkv_kernel"))):
        fail("the autograd backward is not exactly the dQ and the dK/dV kernel launches")
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
        bwd_bound = sum(bound(*flash_work(n, *CHUNKED_SHAPE, elem=dtype.itemsize),
                              PEAK_BF16_FLOPS if suffix == "" else PEAK_F32_BF16X3_FLOPS)[0]
                        for n in ("flash_backward_dq", "flash_backward_dkv"))
        print(f"  {tag} forward {fwd_k:.4f} ms against SDPA's forward {fwd_ms:.4f} ms: "
              f"{fwd_k / fwd_ms:.3f}x; backward total (dQ with delta + dK/dV) {bwd_k:.4f} ms "
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
    f32_counts = run_f32_main_path(device, card)

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
    entries = [("fused_layer_prefix", layer_src, "beso_tpu/ops/fused_layer.py:618", launches,
                err, ms, plain_ms),
               ("fused_layer_prefix_f32", f32_src, "beso_tpu/ops/fused_layer.py:618",
                f32_counts["fused_layer_prefix"], err_f32, ms_f32, plain_ms_f32)]
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
    flash_counts_of = {"": counts, "_f32": counts_by_dtype[None, torch.float32],
                       "_hd128": counts_w,
                       "_hd128_f32": counts_by_dtype[WIDE_HEADS, torch.float32]}
    for key, n_of in flash_counts_of.items():
        for name, line in (("flash_forward", 269), ("flash_backward_dq", 78),
                           ("flash_backward_dkv", 112)):
            # width 128: the forward and the f32 backward in the wgmma source
            wide = key.startswith("_hd128") and (name == "flash_forward" or key.endswith("_f32"))
            entries.append((name + key, wide_src if wide else flash_src,
                            f"beso_tpu/ops/flash_attention.py:{line}",
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
        kernels.append(entry)
        print(f"  {name}: {k_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{100 * bound_ms / k_ms:.1f}% of the roofline ({card})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
