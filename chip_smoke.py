#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`beso_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA card, the CUDA toolkit's
`nvcc` (the kernels are built here from `beso_tpu_torch/csrc/` on first use,
into `build/`) and no network; it imports no JAX. Phases, each of which
exits non-zero on failure:

0. device: name and power limit (nvidia-smi), torch/CUDA versions, TF32 off;
1. build: compile the kernel library for sm_90a, print seconds and ptxas;
2. kernel: `fused_layer_prefix` (CUDA) against its plain PyTorch version in
   bf16 at the kitchen (D=360, H=6, P=3, 2T=8) and block-push (D=240,
   H=12, hd=20, P=2, 2T=10) shapes, epilogue on and off, every sigma row,
   each with a ragged last tile;
   max |diff| must stay within 2^-5 of max |ref|. Times both at the kitchen
   serving shape with CUDA events;
3. engine: the `fused_cached` engine against the plain `cached` engine on
   the same inputs at every grid sigma;
4. main path: a 1024-env x 280-step kitchen rollout with the shipped kitchen
   serving config on the `fused_cached` engine; the kernel's launch counter
   must move by exactly 280 steps x 3 NFE x 6 layers, every metric must be
   finite.

The second-to-last line is the kernels' JSON record, the last line
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

N_ENVS, N_STEPS, NFE, N_LAYERS = 1024, 280, 3, 6
ERR_FRACTION = 2.0 ** -5   # kernel and engine bound: fraction of max |ref|


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def kitchen_config():
    """The shipped kitchen serving config, `configs/franka_kitchen.yaml`
    (no YAML parser on the card's host, so the values are written out)."""
    model = dict(state_dim=30,        # obs_dim: 30 (:13)
                 action_dim=9,        # action_dim: 9 (:12)
                 embed_dim=360,       # hidden_dim: 360 (:17)
                 n_layers=6,          # num_hidden_layers: 6 (:18)
                 n_heads=6,           # n_heads: 6 (:19)
                 goal_seq_len=2,      # future_seq_length: 2 (:8)
                 obs_seq_len=4,       # window_size: 4 (:9)
                 linear_output=True)  # linear_output: true (:22)
    policy = dict(window_size=4, obs_dim=30, action_dim=9,
                  sampler_type="ddim",           # sampler_type (:42)
                  num_sampling_steps=NFE,        # n_timesteps: 3 (:53)
                  sigma_min=0.005, sigma_max=1.0,  # (:44-45)
                  sigma_data=0.5, rho=5.0,       # (:43, :46)
                  noise_scheduler="exponential",  # (:47)
                  cond_lambda=1.5)               # cond_lambda: 1.5 (:52)
    scale_data = False                           # scale_data: false (:7)
    return model, policy, scale_data


def random_layer(D, H, M, gen, device):
    """One layer's weights (prepared, bf16) and an f32 epilogue."""
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
                             torch.bfloat16)
    epi = FusedEpilogue(v(D, 1.0).to(device), v(D).to(device),
                        w(M, D).to(device), v(M).to(device))
    return p, epi


def check_kernel(name, D, H, P, T2, S, M, B, device, gen):
    """Kernel vs plain version at one shape, epilogue on/off, every row.
    Returns the largest |diff| seen."""
    import torch

    from beso_tpu_torch.ops.fused_layer import (fused_layer_prefix,
                                                fused_layer_prefix_reference)

    p, epi = random_layer(D, H, M, gen, device)
    x = torch.randn(B, T2, D, generator=gen).to(device, torch.bfloat16)
    pk = torch.randn(S, B, P, D, generator=gen).to(device, torch.bfloat16)
    pv = torch.randn(S, B, P, D, generator=gen).to(device, torch.bfloat16)
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
                lim = ERR_FRACTION * r_.float().abs().max().item()
                ok = math.isfinite(err) and err <= lim
                print(f"  {name} B={B} epilogue={use_epi} row={row} {what}: "
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


def time_kernel(B, device, gen):
    """Kernel and plain-version times at the kitchen serving shape: B rows
    of the CFG-stacked batch, one inner layer (no epilogue)."""
    import torch

    from beso_tpu_torch.ops.fused_layer import (fused_layer_prefix,
                                                fused_layer_prefix_reference)

    p, _ = random_layer(360, 6, 9, gen, device)
    x = torch.randn(B, 8, 360, generator=gen).to(device, torch.bfloat16)
    pk = torch.randn(3, B, 3, 360, generator=gen).to(device, torch.bfloat16)
    pv = torch.randn(3, B, 3, 360, generator=gen).to(device, torch.bfloat16)
    idx = torch.tensor([1], dtype=torch.int32, device=device)
    ms = time_ms(lambda: fused_layer_prefix(x, pk, pv, idx, p, n_heads=6), 50, device)
    plain_ms = time_ms(lambda: fused_layer_prefix_reference(x, pk, pv, idx, p, n_heads=6),
                       10, device)
    return ms, plain_ms


def build_model(model_kw, device, seed):
    import torch

    from beso_tpu_torch.models import DiffusionGPT, GCDenoiser

    gen = torch.Generator().manual_seed(seed)
    model = DiffusionGPT(**model_kw, dtype=torch.bfloat16, generator=gen).to(device)
    return GCDenoiser(model, sigma_data=0.5)


def check_engine(den, device, B, gen):
    """fused_cached vs cached engine on the same inputs, every grid sigma."""
    import torch

    from beso_tpu_torch.core.schedules import get_noise_schedule
    from beso_tpu_torch.models.cached import make_cached_denoise_fn
    from beso_tpu_torch.models.fused import make_fused_cached_denoise_fn

    m = den.inner_model
    T, G = m.obs_seq_len, m.goal_seq_len
    s = torch.randn(B, T, m.state_dim, generator=gen).to(device)
    a = torch.randn(B, T, m.action_dim, generator=gen).to(device)
    g = torch.randn(B, G, m.state_dim, generator=gen).to(device)
    grid = get_noise_schedule(NFE, 0.005, 1.0, 5.0, "exponential")[:-1]
    fused = make_fused_cached_denoise_fn(den, g, grid)
    plain = make_cached_denoise_fn(den, g, grid)
    worst = 0.0
    for sg in grid:
        sig = torch.full((B,), float(sg), device=device)
        got, ref = fused(s, a, g, sig), plain(s, a, g, sig)
        err = (got - ref).abs().max().item()
        lim = ERR_FRACTION * ref.abs().max().item()
        ok = math.isfinite(err) and err <= lim and got.shape == (B, T, m.action_dim)
        print(f"  sigma={float(sg):.6g}: max|fused - cached| {err:.6g} "
              f"(limit {lim:.6g}, max|cached| {ref.abs().max().item():.6g}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("fused_cached engine disagrees with the cached engine")
        worst = max(worst, err)
    return worst


def run_rollout(den, policy_kw, scale_data, n_envs, n_steps, device, seed):
    """The main path: kitchen rollout on the fused_cached engine."""
    import torch

    from beso_tpu_torch.agents.policy import PolicyConfig
    from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
    from beso_tpu_torch.envs.kitchen.goals import multigoal_kitchen_goals
    from beso_tpu_torch.models import fit_scaler, make_rollout_denoise_factory
    from beso_tpu_torch.rollout import rollout_kitchen

    data = synthetic_kitchen_data(n_traj=32, t_max=60)
    scaler = fit_scaler(data.all_observations(), data.all_actions(),
                        scale_data=scale_data, device=device)
    goals, expected = multigoal_kitchen_goals(data, 2, n_envs, seed=42)
    cfg = PolicyConfig(**policy_kw)
    factory = make_rollout_denoise_factory(den, scaler, cfg, engine="fused_cached")
    gen = torch.Generator(device=device).manual_seed(seed)
    return rollout_kitchen(None, scaler, cfg, torch.as_tensor(goals, device=device),
                           torch.as_tensor(expected, device=device), gen,
                           n_steps=n_steps, denoise_factory=factory)


def main() -> None:
    repo = Path(__file__).resolve().parent
    if not (repo / "beso_tpu_torch" / "csrc").is_dir():
        fail(f"no beso_tpu_torch/csrc beside {Path(__file__).name}: run from a checkout")
    sys.path.insert(0, str(repo))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
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
    so = fl.build_kernels()
    print(f"[1] build: {so.name} in {time.perf_counter() - t0:.1f} s")
    log = so.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}")

    # ---- 2. kernel against its plain version -----------------------------
    print("[2] kernel vs plain version (bf16)")
    gen = torch.Generator().manual_seed(0)
    # batches that leave the last 64-row tile part-filled: 1999 envs of 8
    # tokens (8 envs per tile), 2000 envs of 10 tokens (6 envs per tile)
    err = max(check_kernel("kitchen", 360, 6, 3, 8, 3, 9, 1999, device, gen),
              check_kernel("block_push", 240, 12, 2, 10, 3, 2, 2000, device, gen))
    B_serve = 2 * N_ENVS  # lambda=1.5 CFG stacks [cond, uncond]
    ms, plain_ms = time_kernel(B_serve, device, gen)
    print(f"  time at the kitchen serving shape (B={B_serve}, 2T=8, D=360): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per layer ({card})")

    # ---- 3. engine parity -------------------------------------------------
    print("[3] fused_cached vs cached engine (kitchen model, bf16)")
    model_kw, policy_kw, scale_data = kitchen_config()
    den = build_model(model_kw, device, seed=0)
    check_engine(den, device, 256, gen)

    # ---- 4. main path -----------------------------------------------------
    print(f"[4] kitchen rollout: {N_ENVS} envs x {N_STEPS} steps, fused_cached")
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
    for name in ("rewards", "results"):
        v = getattr(metrics, name)
        if v.shape != (N_ENVS,) or not bool(torch.isfinite(v).all()):
            fail(f"rollout metric {name} is not finite / has shape {tuple(v.shape)}")
    if metrics.completed.shape != (N_ENVS, 7) or metrics.env_steps != N_ENVS * N_STEPS:
        fail("rollout metrics have the wrong shape")
    order = metrics.completion_order
    if bool(((order < -1) | (order > N_STEPS)).any()):
        fail("completion_order outside [-1, n_steps]")
    hist = success_rate_histogram(metrics.completed.sum(-1).cpu().numpy())
    print(f"  wall {wall:.3f} s, {N_ENVS * N_STEPS / wall:.1f} env-steps/s "
          f"(informational; random weights; {card})")
    print(f"  success_rate_histogram: {json.dumps(hist)}")

    print(json.dumps({"kernels": [{
        "name": "fused_layer_prefix", "route": "cuda",
        "source": "beso_tpu_torch/csrc/fused_layer_prefix.cu",
        "replaces": "beso_tpu/ops/fused_layer.py:618",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
