"""Picard against sequential DDIM, wall clock per control step (port of
`scripts/bench_picard.py`).

The kitchen DiffusionGPT (6 layers x 360 x 6 heads, bf16 on the card, its
attention on the flash kernels) at window `--window` (64: the chunked
config's 131 tokens; 4: BESO's 11), batch `--batch`, `--nfe` grid points:
sequential DDIM (nfe denoiser calls of B rows) against Picard with K = 7
and K = 12 sweeps (K calls of nfe x B rows each, `sampling/parallel.py`).
Each time is the mean over `--reps` control steps between two device
synchronisations, after one warm-up step. Information only: Picard pays
only where a denoiser call's time does not grow with its rows.

Usage:
    python -m beso_tpu_torch.scripts.bench_picard [--batch 4] [--nfe 50] \\
        [--window 64] [--reps 10] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--nfe", type=int, default=50)
    parser.add_argument("--window", type=int, default=64)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; --device cpu runs on the CPU)")
    args = parser.parse_args(argv)

    from beso_tpu_torch.core.schedules import get_noise_schedule
    from beso_tpu_torch.models import DiffusionGPT, GCDenoiser
    from beso_tpu_torch.sampling.parallel import sample_picard
    from beso_tpu_torch.sampling.samplers import sample_ddim

    device = torch.device(args.device)
    B, T = args.batch, args.window
    model = DiffusionGPT(state_dim=30, action_dim=9, embed_dim=360, n_layers=6, n_heads=6,
                         goal_seq_len=2, obs_seq_len=T, attention="pallas",
                         dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    den = GCDenoiser(model.to(device), sigma_data=0.5)
    s = torch.zeros(B, T, 30, device=device)
    g = torch.zeros(B, 2, 30, device=device)
    sigmas = get_noise_schedule(args.nfe, 0.005, 1.0, 5.0, "exponential")
    gen = torch.Generator(device).manual_seed(1)

    def dn(x, sigma):
        # Picard folds the sigma grid into the batch: tile the conditioning
        r = x.shape[0] // B
        return den(s.repeat(r, 1, 1), x, g.repeat(r, 1, 1), sigma)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def timed(sample, label):
        def step():
            return sample(torch.randn(B, T, 9, generator=gen, device=device) * float(sigmas[0]))

        step()                                   # warm-up
        sync()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = step()
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / args.reps
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{label}: non-finite actions")
        print(f"{label}: {ms:.3f} ms/control-step (B={B}, T={T}, NFE={args.nfe})")
        return ms

    results = {"device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                          else "cpu"),
               "batch": B, "tokens": 2 * T + 3, "nfe": args.nfe,
               "sequential_ddim_ms": timed(lambda x: sample_ddim(dn, x, sigmas),
                                           "sequential ddim")}
    for K in (7, 12):
        results[f"picard_k{K}_ms"] = timed(
            lambda x, K=K: sample_picard(dn, x, sigmas, update="ddim", n_iterations=K),
            f"picard K={K}")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
