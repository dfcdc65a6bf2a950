"""Synthesize scripted-oracle demonstrations in the reference dataset format
(port of `scripts/generate_demos.py`).

The public BESO datasets are not vendored; this CLI writes drop-in
replacements with the port's oracles (`envs/block_push/oracle.py`,
`envs/kitchen/oracle.py`), batched over the episodes on the device, in the
file layouts that `data/export.py` writes and the workspaces' `data_path`
loaders read.

Usage:
    python -m beso_tpu_torch.scripts.generate_demos --env block_push --out data/push \\
        --episodes 1000 [--device cpu]
    python -m beso_tpu_torch.scripts.generate_demos --env kitchen --out data/kitchen \\
        --episodes 566
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--env", choices=["block_push", "kitchen"], required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--episodes", type=int, default=512)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--play-style", action="store_true",
                        help="per-episode execution styles (approach angle,"
                             " speed, detours, wandering, pauses)")
    parser.add_argument("--kettle-boost", type=float, default=0.0,
                        help="kitchen: probability of leading the task"
                             " sequence with the kettle (data curriculum)")
    parser.add_argument("--census", action="store_true",
                        help="print demo-diversity statistics: completion-"
                             "order census entropy + execution dispersion"
                             " (mean pairwise trajectory distance among"
                             " episodes with the SAME completion order)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; --device cpu runs on the CPU)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    device = torch.device(args.device)
    generator = torch.Generator(device).manual_seed(args.seed)
    if args.env == "block_push":
        from beso_tpu_torch.data.export import export_multimodal_push
        from beso_tpu_torch.envs.block_push.oracle import generate_demonstrations

        data = generate_demonstrations(args.episodes, args.steps or 160,
                                       play_style=args.play_style,
                                       generator=generator, device=device)
        out = export_multimodal_push(data, args.out)
    else:
        from beso_tpu_torch.data.export import export_relay_kitchen
        from beso_tpu_torch.envs.kitchen.oracle import generate_kitchen_demonstrations

        data = generate_kitchen_demonstrations(args.episodes, args.steps or 280,
                                               play_style=args.play_style,
                                               kettle_boost=args.kettle_boost,
                                               generator=generator, device=device)
        out = export_relay_kitchen(data, args.out)
    logging.info("wrote %d episodes to %s (labels/ep %.2f)", args.episodes,
                 out, float(data.onehot_goals.sum()) / args.episodes)
    if args.census:
        print_census(data)
    return out


def print_census(data):
    """Demo-diversity statistics: the completion-order census (task-level
    multimodality) and the execution dispersion, the mean pairwise distance
    of downsampled trajectories sharing a completion order (execution-level
    multimodality, which only the play style raises)."""
    onehot = np.asarray(data.onehot_goals)
    obs = np.asarray(data.observations)
    N = onehot.shape[0]
    orders = {}
    for i in range(N):
        frames, tasks = np.nonzero(onehot[i])
        key = tuple(tasks[np.argsort(frames)])
        orders.setdefault(key, []).append(i)
    counts = np.asarray([len(v) for v in orders.values()], float)
    p = counts / counts.sum()
    entropy = float(-(p * np.log2(p)).sum())
    print(f"census: {len(orders)} distinct completion orders over {N} "
          f"episodes, entropy {entropy:.2f} bits")
    # execution dispersion within same-order groups (>= 4 members)
    disps = []
    rng = np.random.default_rng(0)
    for idxs in orders.values():
        if len(idxs) < 4:
            continue
        pick = rng.choice(idxs, size=min(8, len(idxs)), replace=False)
        trajs = obs[pick, ::10, :2]          # downsampled leading dims
        d = [np.linalg.norm(trajs[a] - trajs[b], axis=-1).mean()
             for a in range(len(pick)) for b in range(a + 1, len(pick))]
        disps.append(np.mean(d))
    if disps:
        print(f"execution dispersion (same-order groups): "
              f"{np.mean(disps):.4f} mean pairwise traj distance "
              f"({len(disps)} groups)")


if __name__ == "__main__":
    main()
