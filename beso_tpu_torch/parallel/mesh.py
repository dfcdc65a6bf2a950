"""Multi-device meshes and sharding rules on `torch.distributed` (torch port
of `beso_tpu/parallel/mesh.py`).

The JAX package drives every device from one controller (`shard_map`,
GSPMD); here each rank is its own process, as `torchrun` starts it, and
owns one device. A mesh is a `torch.distributed.device_mesh.DeviceMesh`
over all ranks with the JAX package's axis names:

* ("dp", "tp"): data parallelism over the batch or env dimension, tensor
  parallelism over attention heads and the MLP's hidden units;
* ("dcn", "dp", "tp"): the multi-slice form, whose outer axis is the slow
  link between slices; a batch shards over ("dcn", "dp") and the gradient
  sum runs over "dp" first, then over "dcn".

The backend is the caller's explicit choice, `init_distributed(backend,
...)`: "nccl" when each rank owns a card (the mesh's device type "cuda"),
"gloo" on the CPU (device type "cpu"; CUDA tensors given to it go through
the host, `parallel/comm.py`). `make_mesh` raises when the default group's
backend is another one; nothing switches backends on its own.

Training: every rank samples the global batch and every draw of the step
from the same generator and takes its data rows (`data_rows`), so the
values equal one process's; gradients are summed over the data axes and
divided by their size (`all_reduce_grads`). Tensor parallelism is
Megatron's: `partition_params` keeps on each "tp" rank its heads' rows of
q, k and v and its block of the MLP's hidden units, and the blocks sum the
row-parallel products over "tp" (`models/gpt.py::block_forward`).
"""

from __future__ import annotations

import dataclasses
import re
from datetime import timedelta
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from beso_tpu_torch.parallel.comm import all_gather, all_reduce_, broadcast_

_DEVICE_TYPE = {"nccl": "cuda", "gloo": "cpu"}


def init_distributed(backend: str, rank: int, world_size: int, init_method: str,
                     timeout_s: float = 300.0) -> None:
    """`init_process_group` with an explicit backend, rank, world size and
    rendezvous address (`tcp://localhost:<port>`, or "env://" under
    torchrun). `timeout_s` bounds the rendezvous and every collective. An
    "nccl" rank takes the card `rank % device_count()`; raises if this torch
    has no NCCL or no card."""
    if backend not in _DEVICE_TYPE:
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        if not dist.is_nccl_available() or not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs a CUDA card and a torch built with NCCL")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timedelta(seconds=timeout_s))


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...], backend: str):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    if backend not in _DEVICE_TYPE:
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if dist.get_backend() != backend:
        raise RuntimeError(f"the default process group runs {dist.get_backend()!r}, "
                           f"not the mesh's {backend!r}")
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {shape} needs {n} ranks, the group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(_DEVICE_TYPE[backend], shape, mesh_dim_names=names)


def make_mesh(n_devices: Optional[int] = None, tp: int = 1, *, backend: str):
    """A ("dp", "tp") mesh over all `n_devices` ranks (default: the world)."""
    n = dist.get_world_size() if n_devices is None else n_devices
    if n % tp:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    return _mesh((n // tp, tp), ("dp", "tp"), backend)


def make_multislice_mesh(n_slices: int, tp: int = 1, *, backend: str):
    """A ("dcn", "dp", "tp") mesh: `n_slices` slices of world / n_slices
    ranks, each a (dp, tp) grid (`beso_tpu/parallel/mesh.py:47-75`)."""
    n = dist.get_world_size()
    if n % n_slices:
        raise ValueError(f"{n} devices not divisible into {n_slices} slices")
    per_slice = n // n_slices
    if per_slice % tp:
        raise ValueError(f"{per_slice} per-slice devices vs tp={tp}")
    return _mesh((n_slices, per_slice // tp, tp), ("dcn", "dp", "tp"), backend)


def data_axes(mesh) -> tuple:
    """The mesh axes the batch / env dimension shards over."""
    return tuple(a for a in ("dcn", "dp") if a in mesh.mesh_dim_names)


def _size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def data_index(mesh) -> Tuple[int, int]:
    """(this rank's data shard, the number of shards): the shard is the
    rank's coordinate over the data axes, "dcn" outer."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index, count = 0, 1
    for ax in data_axes(mesh):
        index = index * _size(mesh, ax) + coord[ax]
        count *= _size(mesh, ax)
    return index, count


def data_rows(mesh, n: int) -> slice:
    """This rank's rows of a global batch of `n`; raises unless the data
    shards divide `n`."""
    index, count = data_index(mesh)
    if n % count:
        raise ValueError(f"batch {n} not divisible by {count} data shards")
    return slice(index * n // count, (index + 1) * n // count)


def all_reduce_data_(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum `t` in place over the data axes: over "dp", then over "dcn"."""
    for ax in reversed(data_axes(mesh)):
        if _size(mesh, ax) > 1:
            all_reduce_(t, mesh.get_group(ax))
    return t


def gather_data(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every data shard's `t` concatenated along dim 0 in shard order (the
    order of the global batch `data_rows` splits)."""
    for ax in reversed(data_axes(mesh)):
        if _size(mesh, ax) > 1:
            t = torch.cat(all_gather(t, mesh.get_group(ax)))
    return t


def tp_group(mesh):
    """The "tp" group, or None for a mesh without tensor parallelism."""
    if "tp" not in mesh.mesh_dim_names or _size(mesh, "tp") == 1:
        return None
    return mesh.get_group("tp")


@dataclasses.dataclass(frozen=True)
class TPShard:
    """A block's place in its "tp" group: rank `rank` of `size`."""

    group: Any
    rank: int
    size: int


# Tensor-parallel rules for DiffusionGPT parameters (`beso_tpu/parallel/
# mesh.py:78-90`): qkv and fc split their output features over "tp", proj
# and fc_proj their input features. Torch weights are [out, in], so JAX's
# P(None, "tp") on a [in, out] kernel is dim 0 here. (pattern, sharded dim,
# split per q/k/v third): JAX splits the fused [D, 3D] kernel's columns
# contiguously, which does not align with the heads; the port takes each
# rank's heads out of q, k and v alike.
_TP_RULES = (
    (re.compile(r".*attn\.qkv\.weight$"), 0, True),
    (re.compile(r".*attn\.qkv\.bias$"), 0, True),
    (re.compile(r".*attn\.proj\.weight$"), 1, False),
    (re.compile(r".*\bfc\.weight$"), 0, False),
    (re.compile(r".*\bfc\.bias$"), 0, False),
    (re.compile(r".*\bfc_proj\.weight$"), 1, False),
)


def _rule(name: str):
    for pat, dim, thirds in _TP_RULES:
        if pat.match(name):
            return dim, thirds
    return None


def tp_param_spec(model: nn.Module) -> Dict[str, tuple]:
    """Per parameter name its placement over torch's dims: "tp" on the
    sharded dim, None elsewhere, () for a replicated parameter."""
    out = {}
    for name, p in model.named_parameters():
        rule = _rule(name)
        out[name] = (() if rule is None else
                     tuple("tp" if d == rule[0] else None for d in range(p.dim())))
    return out


def _shard(t: torch.Tensor, dim: int, thirds: bool, r: int, n: int) -> torch.Tensor:
    parts = t.chunk(3, dim) if thirds else (t,)
    return torch.cat([p.chunk(n, dim)[r] for p in parts], dim).contiguous()


def _unshard(shards, dim: int, thirds: bool) -> torch.Tensor:
    if not thirds:
        return torch.cat(shards, dim)
    split = [s.chunk(3, dim) for s in shards]
    return torch.cat([torch.cat([s[i] for s in split], dim) for i in range(3)], dim)


def partition_params(model: nn.Module, mesh) -> nn.Module:
    """Place a DiffusionGPT on the mesh, in place: every parameter made equal
    to rank 0's (`replicate`), then, on a mesh with "tp" > 1, each
    tensor-parallel parameter cut to this rank's shard (`tp_param_spec`)
    and every block told its group. Build the optimizer and the EMA after
    this call."""
    replicate(model, mesh)
    group = tp_group(mesh)
    if group is None:
        return model
    n = _size(mesh, "tp")
    r = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))["tp"]
    if model.n_heads % n:
        raise ValueError(f"{model.n_heads} heads not divisible by tp={n}")
    for name, p in list(model.named_parameters()):
        rule = _rule(name)
        if rule is None:
            continue
        owner, attr = name.rsplit(".", 1)
        setattr(model.get_submodule(owner), attr,
                nn.Parameter(_shard(p.detach(), *rule, r, n), requires_grad=p.requires_grad))
    for blk in model.blocks:
        blk.tp = TPShard(group, r, n)
    return model


def gather_full(named: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Full tensors from this rank's shards, by parameter name (parameters,
    their gradients or the EMA shadow of a `partition_params` model)."""
    group = tp_group(mesh)
    out = {}
    for name, t in named.items():
        rule = None if group is None else _rule(name)
        t = t.detach()
        out[name] = t.clone() if rule is None else _unshard(all_gather(t, group), *rule)
    return out


def partition_batch(batch: Any, mesh) -> Any:
    """This rank's rows of a global batch: a tensor, or a dict of them, cut
    along dim 0 over the data axes ("dp", and "dcn" on a multi-slice mesh)."""
    if isinstance(batch, dict):
        return {k: partition_batch(v, mesh) for k, v in batch.items()}
    return batch[data_rows(mesh, batch.shape[0])]


def replicate(tree: Any, mesh) -> Any:
    """Make a module's parameters and buffers, a dict of tensors or a tensor
    equal on every rank to global rank 0's, in place; returns `tree`."""
    del mesh  # a mesh spans the whole default group
    if isinstance(tree, nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    else:
        tensors = [tree]
    with torch.no_grad():
        for t in tensors:
            broadcast_(t.data if isinstance(t, nn.Parameter) else t, 0, dist.group.WORLD)
    return tree


def all_reduce_grads(model: nn.Module, mesh) -> None:
    """Gradients of the global-batch mean from each rank's gradient of its
    rows' mean: summed over the data axes in one flat buffer, divided by
    the number of data shards."""
    _, count = data_index(mesh)
    params = [p for p in model.parameters() if p.grad is not None]
    if count == 1 or not params:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    all_reduce_data_(flat, mesh).div_(count)
    offset = 0
    for p in params:
        p.grad.copy_(flat[offset:offset + p.numel()].view_as(p.grad))
        offset += p.numel()
