"""Start n ranks on this host, each a process of its own (what `torchrun
--nproc-per-node n` does), for the dry run, the tests and the smoke run.

`spawn(fn, n, backend, args)` starts n processes through
`torch.multiprocessing.start_processes` by the "spawn" method; rank r
joins a process group of `backend` at `tcp://localhost:<a free port>`
(`init_distributed`, with `init_timeout_s` on the rendezvous and every
collective), calls `fn(rank, n, *args)` and leaves the group. The caller
waits at most `timeout_s` in all: a rank still running then is killed with
the others and `spawn` raises TimeoutError; a rank that fails makes it
raise RuntimeError with that rank's traceback. `fn` must be importable by
name (a module's top-level function), and results travel through files
the caller names.
"""

from __future__ import annotations

import socket
import time
from typing import Callable, Sequence

import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world_size, backend, init_method, init_timeout_s, args):
    import torch
    import torch.distributed as dist

    from beso_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    init_distributed(backend, rank, world_size, init_method, init_timeout_s)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, backend: str, args: Sequence = (),
          timeout_s: float = 600.0, init_timeout_s: float = 120.0) -> None:
    """Run `fn(rank, world_size, *args)` on `world_size` new processes in
    one `backend` group; raises if a rank fails or the whole takes longer
    than `timeout_s`. Every process it started has ended when it returns
    or raises."""
    init_method = f"tcp://127.0.0.1:{free_port()}"
    ctx = mp.start_processes(_rank_main, nprocs=world_size, join=False, start_method="spawn",
                             args=(fn, world_size, backend, init_method, init_timeout_s,
                                   tuple(args)))
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(max(0.0, deadline - time.monotonic()), grace_period=5):
            if time.monotonic() >= deadline:
                hung = [r for r, p in enumerate(ctx.processes) if p.is_alive()]
                raise TimeoutError(f"{fn.__name__}: ranks {hung} still running after "
                                   f"{timeout_s} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        raise RuntimeError(f"{fn.__name__}: ranks [{e.error_index}] failed:{e.msg}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
