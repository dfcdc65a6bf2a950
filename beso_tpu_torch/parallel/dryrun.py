"""A dry run of the whole multi-device path on n ranks (the counterpart of
`dryrun_multichip`, `__graft_entry__.py:72-215`).

    python -m beso_tpu_torch.parallel.dryrun 4

`dryrun_multigpu(n)` spawns n gloo ranks on the CPU (`parallel/launch.py`);
each runs `dryrun_body`: one training step of a tiny kitchen model (64
wide, 2 layers, 2 heads, window 4, goal length 2) over a ("dp", "tp") mesh
with tp=2 when n is even and at least 4, one sharded rollout step on the
`fused_cached` engine over a ("dp",) mesh (the layer kernels on a card, their
plain versions on the CPU), and, when n is even and at least 4, one step
over a 2-slice ("dcn", "dp") mesh. Each loss and metric must be finite.
On cards (`torchrun --nproc-per-node n`, NCCL) call `dryrun_body(rank, n,
backend="nccl", device="cuda")` in each rank.
"""

from __future__ import annotations

import math
import sys

import torch

from beso_tpu_torch.parallel.launch import spawn
from beso_tpu_torch.parallel.mesh import (gather_full, make_mesh, make_multislice_mesh,
                                          partition_params)


def _tiny_model(device) -> torch.nn.Module:
    from beso_tpu_torch.models.gpt import DiffusionGPT

    return DiffusionGPT(state_dim=30, action_dim=9, embed_dim=64, n_layers=2, n_heads=2,
                        goal_seq_len=2, obs_seq_len=4, cond_mask_prob=0.1,
                        generator=torch.Generator().manual_seed(1)).to(device)


def _train_state(model):
    from beso_tpu_torch.models.ema import ema_init
    from beso_tpu_torch.train.trainer import TrainState, make_optimizer

    optimizer, scheduler = make_optimizer(model.parameters(), "adamw", 1e-4)
    return TrainState(model, optimizer, scheduler, ema_init(model.named_parameters()))


def dryrun_body(rank: int, world_size: int, backend: str = "gloo", device="cpu") -> dict:
    """One rank of the dry run (the process group already joined); returns
    this rank's {"loss", "rollout_rewards", "multislice_loss"} (the last
    None unless world_size is even and at least 4)."""
    from beso_tpu_torch.agents.policy import PolicyConfig
    from beso_tpu_torch.core.densities import make_sample_density
    from beso_tpu_torch.data.slicer import SlicedDataset
    from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
    from beso_tpu_torch.envs.kitchen.goals import multigoal_kitchen_goals
    from beso_tpu_torch.models.cached import make_rollout_denoise_factory
    from beso_tpu_torch.models.denoiser import GCDenoiser
    from beso_tpu_torch.models.scaler import fit_scaler
    from beso_tpu_torch.rollout.sharded import rollout_kitchen_sharded
    from beso_tpu_torch.train.trainer import make_train_step

    device = torch.device(device)
    n = world_size
    multi = n % 2 == 0 and n >= 4
    tp = 2 if multi else 1
    mesh = make_mesh(n, tp=tp, backend=backend)
    data = synthetic_kitchen_data(n_traj=8, t_max=40)
    ds = SlicedDataset(data, window=4, future_seq_len=2, device=device)
    scaler = fit_scaler(data.all_observations(), data.all_actions(), device=device)
    density = make_sample_density("loglogistic", 0.5, 0.005, 1.0)
    shards = n // tp
    B = shards * math.ceil(max(2 * n, 8) / shards)
    gen = torch.Generator(device).manual_seed(2)
    batch = ds.sample_batch(gen, B)

    model = partition_params(_tiny_model(device), mesh)
    ts = _train_state(model)
    den = GCDenoiser(model, 0.5)
    loss = make_train_step(den, density, scaler, mesh=mesh)(ts, batch, gen)
    if not torch.isfinite(loss):
        raise RuntimeError(f"rank {rank}: the dp x tp train step gave loss {loss}")

    # the sharded rollout serves the whole EMA model on every data rank
    serve = _tiny_model(device)
    with torch.no_grad():
        for name, t in gather_full(ts.ema.params, mesh).items():
            serve.get_parameter(name).copy_(t)
    goals, expected = multigoal_kitchen_goals(data, 2, B, seed=42)
    cfg = PolicyConfig(window_size=4, obs_dim=30, action_dim=9, num_sampling_steps=2,
                       sigma_min=0.005)
    factory = make_rollout_denoise_factory(GCDenoiser(serve, 0.5), scaler, cfg,
                                           engine="fused_cached")
    m = rollout_kitchen_sharded(None, scaler, cfg, torch.as_tensor(goals, device=device),
                                torch.as_tensor(expected, device=device), 5,
                                make_mesh(n, tp=1, backend=backend), n_steps=2,
                                denoise_factory=factory)
    if m.rewards.shape[0] != B or not torch.isfinite(m.rewards).all():
        raise RuntimeError(f"rank {rank}: the sharded rollout gave rewards {m.rewards}")

    loss_ms = None
    if multi:
        # two slices: batch over ("dcn", "dp"), the gradient sum crossing slices
        ms = make_multislice_mesh(2, tp=1, backend=backend)
        ts_ms = _train_state(partition_params(_tiny_model(device), ms))
        loss_ms = make_train_step(GCDenoiser(ts_ms.model, 0.5), density, scaler,
                                  mesh=ms)(ts_ms, batch, torch.Generator(device).manual_seed(4))
        if not torch.isfinite(loss_ms):
            raise RuntimeError(f"rank {rank}: the multislice train step gave loss {loss_ms}")
    if rank == 0:
        print(f"dryrun_multigpu OK on {n} ranks ({backend}, {device}): mesh dp={n // tp} x "
              f"tp={tp}, loss {float(loss):.6f}; sharded fused rollout ok"
              + (f"; multislice dcn=2 loss {float(loss_ms):.6f}" if multi else ""), flush=True)
    return {"loss": loss, "rollout_rewards": m.rewards, "multislice_loss": loss_ms}


def _rank(rank: int, world_size: int) -> None:
    dryrun_body(rank, world_size)


def dryrun_multigpu(n_devices: int, timeout_s: float = 300.0) -> None:
    """Run `dryrun_body` on `n_devices` spawned gloo CPU ranks; raises if a
    rank fails or hangs past `timeout_s`."""
    spawn(_rank, n_devices, "gloo", timeout_s=timeout_s)


if __name__ == "__main__":
    dryrun_multigpu(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
