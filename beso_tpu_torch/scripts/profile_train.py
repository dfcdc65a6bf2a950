"""Train-step device profile and throughput scaling (port of
`scripts/profile_train.py`).

Both modes run the kitchen training shapes: a 6L x 360D DiffusionGPT (6
heads, window 4, 2 goal tokens: 11 tokens), bf16, AdamW + EMA, the steps
fused by `make_fused_train_steps` (the loop the reference runs in
beso/agents/base_agent.py:70-116 at batch 1024):

* default: one torch.profiler window over a fused call of 50 steps at batch
  1024, the device time by kernel category (GEMM, attention kernels,
  elementwise and casts, optimizer, other), and the device's idle share,
  its busy time against the wall time of the same profiled call;
* --scaling: steps/s, samples/s and MFU across (batch, chunk) pairs. The
  FLOPs are counted from the model's shapes (`train_step_flops`); the peak
  is the H100's dense bf16 tensor-core rate, an f32 product counted as
  three bf16 ones.

--mu-bf16 keeps AdamW's first moment in bf16, as optax's `mu_dtype`
(`make_optimizer(mu_dtype=torch.bfloat16)`).

Usage: python -m beso_tpu_torch.scripts.profile_train [--scaling]
       [--configs 1024:50,2048:50] [--mu-bf16] [--trace-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from functools import partial

import torch

# one H100 SXM at its 700 W limit (NVIDIA's data sheet): dense bf16
# tensor-core operations per second; an f32 product runs as three bf16 ones
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = PEAK_BF16_FLOPS / 3

# kernel-name families, in the order they are tried (lower case)
CATEGORIES = (
    ("attention kernels", ("flash_", "softmax")),
    ("optimizer", ("multi_tensor", "foreach", "adam")),
    ("GEMM", ("gemm", "cutlass", "cublas", "sm90_xmma", "ampere_", "matmul", "gemv",
              "splitk")),
    ("elementwise and casts", ("elementwise", "vectorized", "unrolled", "reduce", "copy",
                               "cat", "fill", "index", "gather", "scatter", "norm", "where",
                               "philox")),
)


def categorize(kernel_name: str) -> str:
    """The category of a device kernel, by its name."""
    name = kernel_name.lower()
    return next((cat for cat, keys in CATEGORIES if any(k in name for k in keys)), "other")


def forward_flops(model, batch_size: int, attention: str = "broadcast") -> tuple:
    """(embedding FLOPs, body FLOPs) of one training forward over
    `batch_size` windows: the matrix products, 2 per multiply-add. The
    embeddings are the sigma, goal, state and action tokens; the body is
    the blocks (the four products per token, and the attention's scores
    and weighted sum, whole for the broadcast form, the causal half for the
    flash kernels) and the head."""
    D, L = model.embed_dim, model.n_layers
    G, T = model.eff_goal_len, model.obs_seq_len
    N = 1 + G + 2 * T
    goal_dim = model.goal_dim if model.has_goal_emb else model.state_dim
    embed = 2 * D * (1 + G * goal_dim + T * (model.state_dim + model.action_dim))
    pairs = N * N if attention == "broadcast" else N * (N + 1) // 2
    block = 24 * N * D * D + 4 * pairs * D
    if model.linear_output:
        head = 2 * T * D * model.action_dim
    else:
        head = 2 * T * (D * 100 + 100 * model.action_dim)
    return batch_size * embed, batch_size * (L * block + head)


def train_step_flops(model, batch_size: int) -> int:
    """Matrix-product FLOPs of one train step: the forward, then the
    backward's two products per product (inputs and weights), one for the
    embeddings, whose inputs need no gradient."""
    impl = model.attention_impl(1 + model.eff_goal_len + 2 * model.obs_seq_len, train=True)
    embed, body = forward_flops(model, batch_size, impl)
    return 3 * body + 2 * embed


def _setup(batch: int, chunk: int, device, mu_bf16: bool = False):
    from beso_tpu_torch.core.densities import make_sample_density
    from beso_tpu_torch.data.slicer import SlicedDataset
    from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
    from beso_tpu_torch.models import DiffusionGPT, GCDenoiser
    from beso_tpu_torch.models.scaler import fit_scaler
    from beso_tpu_torch.train.trainer import Trainer, make_fused_train_steps, make_optimizer

    model = DiffusionGPT(state_dim=30, action_dim=9, embed_dim=360, n_layers=6, n_heads=6,
                         goal_seq_len=2, obs_seq_len=4, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0)).to(device)
    den = GCDenoiser(model, sigma_data=0.5)
    data = synthetic_kitchen_data(n_traj=64, t_max=80)
    scaler = fit_scaler(data.all_observations(), data.all_actions(), device=device)
    train_set = SlicedDataset(data, window=4, future_conditional=True, future_seq_len=2,
                              device=device)
    # optax.adamw(1e-4) of the JAX script: weight decay 1e-4; with mu_bf16 its
    # mu_dtype=jnp.bfloat16
    trainer = Trainer(den, partial(make_optimizer, name="adamw", lr=1e-4, weight_decay=1e-4,
                                   mu_dtype=torch.bfloat16 if mu_bf16 else None),
                      make_sample_density("loglogistic", sigma_data=0.5, sigma_min=0.005,
                                          sigma_max=1.0), scaler)
    ts = trainer.init_state()
    fused = make_fused_train_steps(den, trainer.sample_density, scaler, train_set, batch, chunk)
    return model, ts, fused


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_time(kernels, wall_ms: float, n_steps: int) -> dict:
    """Per-step device time of `n_steps` steps from their kernels, (name,
    start us, end us) on the device, and the wall time `wall_ms` of the
    same window: busy time (the union of the kernels' intervals), the idle
    share (one less busy over wall, unclamped: a negative share says the
    two clocks disagree) and the time by category."""
    by_cat = {}
    for name, start, end in kernels:
        by_cat[categorize(name)] = by_cat.get(categorize(name), 0.0) + (end - start) / 1e3
    busy_ms, last = 0.0, float("-inf")
    for _, start, end in sorted(kernels, key=lambda k: k[1]):
        if end > last:
            busy_ms += (end - max(start, last)) / 1e3
            last = end
    total = sum(by_cat.values())
    return {"wall_ms_per_step": wall_ms / n_steps, "device_ms_per_step": busy_ms / n_steps,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "categories": {c: {"ms_per_step": ms / n_steps, "share": ms / total}
                           for c, ms in sorted(by_cat.items(), key=lambda kv: -kv[1])}}


def profile_window(run, n_steps: int, device, trace_path=None):
    """`run()` (`n_steps` train steps) once under torch.profiler with the
    device's activity only, its wall time taken between two syncs inside
    the window: (run's result, `device_time` of the window, or {"device":
    "not measured"} where no device kernel was seen, as on the CPU)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activity = ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU
    with torch_profile(activities=[activity]) as prof:
        _sync(device)
        t0 = time.perf_counter()
        out = run()
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_path is not None:
        prof.export_chrome_trace(str(trace_path))
    kernels = [(ev.name, ev.time_range.start, ev.time_range.end) for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return out, {"wall_ms_per_step": wall_ms / n_steps, "device": "not measured"}
    return out, device_time(kernels, wall_ms, n_steps)


def profile(device, trace_dir=None, batch: int = 1024, chunk: int = 50,
            mu_bf16: bool = False) -> dict:
    """Device time of one fused call by kernel category and the device's
    idle share, both from one profiled window (`profile_window`), after a
    warm-up call (information)."""
    _, ts, fused = _setup(batch, chunk, device, mu_bf16)
    gen = torch.Generator(device).manual_seed(1)
    ts, _ = fused(ts, gen)   # warm-up
    (ts, losses), stats = profile_window(
        lambda: fused(ts, gen), chunk, device,
        None if trace_dir is None else f"{trace_dir}/train_trace.json")
    out = {"batch": batch, "chunk": chunk, **stats,
           "loss_finite": bool(torch.isfinite(losses).all())}
    print(json.dumps({"train_profile": out}))
    return out


def first_moment_dtype(optimizer) -> str:
    """The dtype of the optimizer's stored first moments ("none" before
    its first step)."""
    dtypes = {str(st["exp_avg"].dtype) for st in optimizer.state.values()}
    return ",".join(sorted(dtypes)) or "none"


def scaling(configs, device, mu_bf16: bool = False) -> list:
    """steps/s, samples/s and MFU of each (batch, chunk): the best of three
    fused calls after a first one (information)."""
    rows = []
    for batch, chunk in configs:
        model, ts, fused = _setup(batch, chunk, device, mu_bf16)
        gen = torch.Generator(device).manual_seed(1)
        t0 = time.perf_counter()
        ts, _ = fused(ts, gen)
        _sync(device)
        first_s = time.perf_counter() - t0
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            ts, losses = fused(ts, gen)
            _sync(device)
            times.append(time.perf_counter() - t0)
        sps = chunk / min(times)
        peak = PEAK_BF16_FLOPS if model.dtype == torch.bfloat16 else PEAK_F32_FLOPS
        flops = train_step_flops(model, batch)
        row = {"batch": batch, "chunk": chunk, "steps_per_sec": sps,
               "samples_per_sec": sps * batch, "flops_per_step": flops,
               "mfu": flops * sps / peak, "first_call_s": first_s,
               "mu_dtype": first_moment_dtype(ts.optimizer),
               "loss_finite": bool(torch.isfinite(losses).all())}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"scaling_table": rows}))
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--scaling", action="store_true")
    parser.add_argument("--mu-bf16", action="store_true",
                        help="first-moment optimizer state in bf16")
    parser.add_argument("--configs", default=None,
                        help="comma-separated batch:chunk pairs, e.g. 1024:200,2048:50")
    parser.add_argument("--trace-dir", default=None,
                        help="also write the profiled window as a chrome trace there")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; --device cpu runs on the CPU)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if args.scaling:
        if args.configs:
            cfgs = [tuple(int(x) for x in c.split(":")) for c in args.configs.split(",")]
        else:
            cfgs = [(1024, 50), (1024, 200), (2048, 50), (4096, 50), (8192, 25)]
        return scaling(cfgs, device, args.mu_bf16)
    return profile(device, args.trace_dir, mu_bf16=args.mu_bf16)


if __name__ == "__main__":
    main()
