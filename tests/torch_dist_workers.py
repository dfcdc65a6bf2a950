"""Rank bodies of the multi-process port tests (`test_torch_parallel.py`,
`test_torch_sharded_rollout.py`), started by `beso_tpu_torch.parallel.
launch.spawn` on gloo CPU ranks.

JAX-free: a spawned rank imports this module only. The parent test writes
a spec (`spec.pt`: weights, batches, scalers, and JAX's draws where a case
injects them) into a directory; each rank installs the injected draws
itself (a monkeypatch does not cross `spawn`), runs its cases and writes
its results beside the spec.
"""

from __future__ import annotations

import contextlib
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch


def _mesh(desc):
    """("dp", n, tp) -> make_mesh(n, tp); ("dcn", slices, tp) -> a multislice mesh."""
    from beso_tpu_torch.parallel import make_mesh, make_multislice_mesh

    kind, n, tp = desc
    if kind == "dp":
        return make_mesh(n, tp=tp, backend="gloo")
    return make_multislice_mesh(n, tp=tp, backend="gloo")


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _model(case):
    from beso_tpu_torch.models.gpt import DiffusionGPT

    model = DiffusionGPT(**case["model_kw"])
    model.load_state_dict(case["state"])
    return model


def train_worker(rank: int, world_size: int, path: str) -> None:
    """Each case: one `make_train_step` under its mesh from the spec's
    weights; rank 0 saves the loss and the full parameters, gradients and
    EMA shadow. Then the sweep: the spec's seeds sharded over "dp" by
    `shard_sweep_state`, trained on their own generators; every rank saves
    its seeds' losses and parameters."""
    import beso_tpu_torch.train.trainer as ttr
    from beso_tpu_torch.core.densities import make_sample_density
    from beso_tpu_torch.models.denoiser import GCDenoiser
    from beso_tpu_torch.models.ema import ema_init
    from beso_tpu_torch.parallel import gather_full, partition_params

    path = Path(path)
    spec = torch.load(path / "spec.pt", weights_only=False)
    for name, case in spec["cases"].items():
        mesh = _mesh(case["mesh"])
        model = partition_params(_model(case), mesh)
        opt, sched = ttr.make_optimizer(model.parameters(), case["opt"], case["lr"])
        ts = ttr.TrainState(model, opt, sched, ema_init(model.named_parameters()))
        batch = {k: torch.as_tensor(v) for k, v in case["batch"].items()}
        noise = step_noise = None
        if "sigma" in case:   # JAX's global draws
            sigma, noise = torch.as_tensor(case["sigma"]), torch.as_tensor(case["noise"])

            def density(gen, shape, device=None):
                return sigma

            def step_noise(shape, gen, device):
                return noise

            gen = None
        else:
            density = make_sample_density("loglogistic", 0.5, 0.005, 1.0)
            gen = torch.Generator().manual_seed(case["seed"])
        with _patched(ttr, "step_noise", step_noise or ttr.step_noise):
            loss = ttr.make_train_step(GCDenoiser(model, 0.5), density, case["scaler"],
                                       mesh=mesh)(ts, batch, gen)
        named = dict(model.named_parameters())
        out = dict(loss=float(loss), params=gather_full(named, mesh),
                   grads=gather_full({n: p.grad for n, p in named.items()}, mesh),
                   ema=gather_full(ts.ema.params, mesh))
        if rank == 0:
            torch.save(out, path / f"{name}.pt")

    sw = spec.get("sweep")
    if sw is not None:
        from beso_tpu_torch.data.slicer import SlicedDataset
        from beso_tpu_torch.models.gpt import DiffusionGPT
        from beso_tpu_torch.train.sweep import (init_sweep_state, make_sweep_train_steps,
                                                seed_generators, shard_sweep_state)

        mesh = _mesh(sw["mesh"])
        ss = init_sweep_state(lambda g: DiffusionGPT(**sw["model_kw"], generator=g),
                              partial(ttr.make_optimizer, name="adamw", lr=1e-4), sw["seeds"])
        local = shard_sweep_state(ss, mesh, "dp")
        ds = SlicedDataset(sw["data"], window=sw["model_kw"]["obs_seq_len"],
                           future_seq_len=sw["model_kw"]["goal_seq_len"], device="cpu")
        fused = make_sweep_train_steps(make_sample_density("loglogistic", 0.5, 0.005, 1.0),
                                       sw["scaler"], ds, sw["batch"], sw["steps"])
        _, losses = fused(local, seed_generators(local.seeds, "cpu")[0])
        torch.save(dict(seeds=local.seeds, losses=losses,
                        params={k: v.detach() for k, v in local.params.items()}),
                   path / f"sweep_rank{rank}.pt")


def smooth_torch_hash(bpos, byaw, eff):
    """The port's side of `torch_parity.smooth_block_push_hashes`."""
    from beso_tpu_torch.envs.block_push.env import _HASH_W

    w = torch.as_tensor(np.asarray(_HASH_W))
    u = torch.cat([bpos, byaw[..., None], eff], -1)
    return torch.sin((w * u[..., None, :]).sum(-1))


def rollout_worker(rank: int, world_size: int, path: str) -> None:
    """Each case: a sharded kitchen or block-push rollout under its mesh,
    with JAX's per-shard draws installed where the case holds them (the
    action noise per step; the block-push resets and the smooth hash).
    Every rank saves the gathered metrics, its shard index and the actions
    its env steps received; a case whose batch the shards do not divide
    saves the error instead."""
    import beso_tpu_torch.agents.policy as tpolicy
    import beso_tpu_torch.envs.block_push.env as tenv
    import beso_tpu_torch.rollout.rollout as trollout
    from beso_tpu_torch.agents.policy import PolicyConfig
    from beso_tpu_torch.models.cached import make_rollout_denoise_factory
    from beso_tpu_torch.models.denoiser import GCDenoiser
    from beso_tpu_torch.parallel import data_index
    from beso_tpu_torch.rollout.sharded import (rollout_block_push_sharded,
                                                rollout_kitchen_sharded)

    path = Path(path)
    spec = torch.load(path / "spec.pt", weights_only=False)
    for name, case in spec["cases"].items():
        mesh = _mesh(case["mesh"])
        shard = data_index(mesh)[0]
        cfg = PolicyConfig(**case["cfg"])
        factory = make_rollout_denoise_factory(GCDenoiser(_model(case), 0.5), case["scaler"],
                                               cfg, engine=case["engine"])
        goals, expected = torch.as_tensor(case["goals"]), torch.as_tensor(case["expected"])
        actions = []
        with contextlib.ExitStack() as stack:
            if "noise" in case:
                noises = iter(case["noise"][shard])
                stack.enter_context(_patched(tpolicy, "action_noise",
                                             lambda *a: torch.as_tensor(next(noises))))
            step_name = "kitchen_step" if case["env"] == "kitchen" else "block_push_step"
            real_step = getattr(trollout, step_name)

            def recording(state, action, *a):
                actions.append(action.numpy().copy())
                return real_step(state, action, *a)

            stack.enter_context(_patched(trollout, step_name, recording))
            try:
                if case["env"] == "kitchen":
                    m = rollout_kitchen_sharded(None, case["scaler"], cfg, goals, expected,
                                                case["seed"], mesh, n_steps=case["n_steps"],
                                                denoise_factory=factory)
                else:
                    stack.enter_context(_patched(tenv, "_hash_noise", smooth_torch_hash))
                    reset = tenv.BlockPushState(*(torch.as_tensor(v)
                                                  for v in case["reset"][shard]))
                    stack.enter_context(_patched(trollout, "block_push_reset",
                                                 lambda *a, **k: reset))
                    m = rollout_block_push_sharded(None, case["scaler"], cfg, goals, expected,
                                                   case["seed"], mesh, n_steps=case["n_steps"],
                                                   denoise_factory=factory)
            except ValueError as e:
                torch.save(dict(error=str(e)), path / f"{name}_rank{rank}.pt")
                continue
        torch.save(dict(shard=shard, actions=np.stack(actions), metrics=m._asdict()),
                   path / f"{name}_rank{rank}.pt")


def fail_on_rank_1(rank: int, world_size: int) -> None:
    if rank == 1:
        raise ValueError("rank 1 fails")


def hang(rank: int, world_size: int) -> None:
    time.sleep(120)


def nccl_rollout_worker(rank: int, world_size: int, path: str) -> None:
    """An NCCL rank on its card: the spec's kitchen model served by
    `fused_cached` in a sharded rollout; saves the gathered metrics and
    the B1 launches of the rollout alone."""
    from beso_tpu_torch.agents.policy import PolicyConfig
    from beso_tpu_torch.models.cached import make_rollout_denoise_factory
    from beso_tpu_torch.models.denoiser import GCDenoiser
    from beso_tpu_torch.models.scaler import fit_scaler
    from beso_tpu_torch.ops import fused_layer as fl
    from beso_tpu_torch.parallel import make_mesh
    from beso_tpu_torch.rollout.sharded import rollout_kitchen_sharded

    path = Path(path)
    spec = torch.load(path / "spec.pt", weights_only=False)
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = PolicyConfig(**spec["cfg"])
    scaler = fit_scaler(spec["obs"], spec["act"], False, device=device)
    factory = make_rollout_denoise_factory(GCDenoiser(_model(spec).to(device), 0.5), scaler,
                                           cfg, engine="fused_cached")
    mesh = make_mesh(world_size, tp=1, backend="nccl")
    fl.fused_layer_prefix.launches = 0
    m = rollout_kitchen_sharded(None, scaler, cfg, torch.as_tensor(spec["goals"], device=device),
                                torch.as_tensor(spec["expected"], device=device), spec["seed"],
                                mesh, n_steps=spec["n_steps"], denoise_factory=factory)
    torch.cuda.synchronize()
    torch.save(dict(metrics={k: v.cpu() if torch.is_tensor(v) else v
                             for k, v in m._asdict().items()},
                    launches=fl.fused_layer_prefix.launches), path / f"rank{rank}.pt")
