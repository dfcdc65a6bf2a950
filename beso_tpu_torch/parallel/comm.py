"""The collectives of the multi-device layer, on `torch.distributed`.

Every collective takes an explicit process group. NCCL moves CUDA tensors
between the cards; a gloo group moves CPU tensors, and a CUDA tensor given
to a gloo group (ranks that share one card, or a CPU-only group driving
card-resident work) goes through the host: copied to the CPU, reduced or
gathered there, copied back. That is the only routing rule, and it follows
the group's backend, which the caller chose (`mesh.init_distributed`).

`copy_to_tp` and `reduce_from_tp` are the two autograd-aware collectives of
Megatron-style tensor parallelism: the first is the identity forward and
sums the gradient over the group backward (the input of a column-parallel
product), the second sums the partial outputs forward and is the identity
backward (the output of a row-parallel product).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce `t` in place over `group` (sum by default); returns `t`."""
    if _via_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Overwrite `t` in place with global rank `src`'s `t`; returns `t`."""
    if _via_host(t, group):
        host = t.cpu()
        dist.broadcast(host, src=src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `t` (same shape on every rank), in the group's rank
    order, on `t`'s device. Bool tensors travel as uint8."""
    is_bool = t.dtype == torch.bool
    x = t.to(torch.uint8) if is_bool else t.contiguous()
    host = _via_host(x, group)
    if host:
        x = x.cpu()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    if host:
        parts = [p.to(t.device) for p in parts]
    return [p.bool() for p in parts] if is_bool else parts


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Identity forward; the gradient summed over `group` backward."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The sum of `x` over `group` forward; the identity backward."""
    return _ReduceFromTP.apply(x, group)
