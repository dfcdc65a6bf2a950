"""Native (C++) windowed-trajectory batch loader (torch port of
`beso_tpu/data/native/__init__.py`).

`NativeSlicedLoader` is the host-side counterpart of `data/slicer.py`'s
`SlicedDataset` for datasets larger than device memory: a thread-pooled
C++ gather over (memory-mappable) float32 trajectory buffers with a
background prefetch ring, in place of the reference's torch DataLoader
with 4 worker processes (`kitchen_workspace_manager.py:149-163`). Batches
are a pure function of (seed, batch id), the same as the JAX package's
loader gives (`slicer.cc` is the same code).

The library is built from the port's own `slicer.cc` with g++ at first
use into the git-ignored `build/native/`, keyed by a hash of the source;
the build writes a file of its own and renames it into place, so parallel
builds (pytest workers) never load a half-written library. It binds
through ctypes. Batches are torch tensors; the prefetching stream copies
each batch into pinned host memory and from there to a CUDA device with
`non_blocking=True`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

_SRC = Path(__file__).with_name("slicer.cc")
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
_LIB: Optional[ctypes.CDLL] = None


def _build_lib() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"libslicer_{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / f"libslicer_{tag}.{os.getpid()}.tmp.so"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(_SRC), "-o", str(tmp),
           "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native loader build failed:\n{proc.stderr[-2000:]}")
    os.replace(tmp, out)   # atomic on one filesystem; a concurrent build wrote the same bytes
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build_lib()))
        vp, i32, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
        lib.loader_create.restype = vp
        lib.loader_create.argtypes = [vp, vp, vp] + [i32] * 11
        lib.loader_num_slices.restype = ctypes.c_int64
        lib.loader_num_slices.argtypes = [vp]
        lib.loader_slices.argtypes = [vp, vp]
        lib.loader_sample_batch.argtypes = [vp, u64, u64, i32, vp, vp, vp]
        lib.loader_start_prefetch.argtypes = [vp, u64, i32, i32]
        lib.loader_wait_next.restype = i32
        lib.loader_wait_next.argtypes = [vp] + [ctypes.POINTER(vp)] * 3
        lib.loader_release.argtypes = [vp, i32]
        lib.loader_destroy.argtypes = [vp]
        _LIB = lib
    return _LIB


def _as_c_f32(x) -> np.ndarray:
    """C-contiguous float32 (a memory-mapped array in that layout passes through)."""
    return np.ascontiguousarray(np.asarray(x), dtype=np.float32)


class NativeSlicedLoader:
    """Thread-pooled windowed batch sampler over host trajectory arrays, with
    SlicedDataset's window and goal semantics; batches depend on (seed,
    batch id) only, whatever the thread count."""

    def __init__(self, observations, actions, lengths, window: int,
                 future_conditional: bool = True, min_future_sep: int = 0,
                 future_seq_len: Optional[int] = None, only_sample_tail: bool = False,
                 only_sample_seq_end: bool = False, n_threads: int = 4):
        if future_conditional and future_seq_len is None:
            raise ValueError("a future-conditional loader needs future_seq_len")
        self.obs = _as_c_f32(observations)
        self.act = _as_c_f32(actions)
        self.lengths = np.ascontiguousarray(np.asarray(lengths), dtype=np.int32)
        if not np.any(self.lengths >= window):
            # the C++ slice table would be empty and its modulo divide by zero
            raise ValueError(f"no trajectory is at least window={window} steps long "
                             f"(max length {int(self.lengths.max(initial=0))})")
        n_traj, t_max, obs_dim = self.obs.shape
        self.window = window
        self.future_seq_len = future_seq_len or 1
        self.future_conditional = future_conditional
        self.obs_dim, self.act_dim = obs_dim, self.act.shape[-1]
        self._lib = _lib()
        self._ptr = self._lib.loader_create(
            self.obs.ctypes.data, self.act.ctypes.data, self.lengths.ctypes.data, n_traj,
            t_max, obs_dim, self.act_dim, window, int(future_conditional),
            self.future_seq_len, min_future_sep, int(only_sample_tail),
            int(only_sample_seq_end), n_threads)

    def __len__(self) -> int:
        return int(self._lib.loader_num_slices(self._ptr))

    @property
    def slices(self) -> np.ndarray:
        """The (traj, start) table, as `data.slicer.make_slices` builds it."""
        out = np.empty((len(self), 2), dtype=np.int32)
        self._lib.loader_slices(self._ptr, out.ctypes.data)
        return out

    def _shapes(self, batch_size: int) -> dict:
        shapes = {"observation": (batch_size, self.window, self.obs_dim),
                  "action": (batch_size, self.window, self.act_dim)}
        if self.future_conditional:
            shapes["goal_observation"] = (batch_size, self.future_seq_len, self.obs_dim)
        return shapes

    def sample_batch_host(self, seed: int, batch_id: int, batch_size: int) -> dict:
        """One batch as float32 CPU tensors."""
        W, G = self.window, self.future_seq_len
        obs = torch.empty(batch_size, W, self.obs_dim)
        act = torch.empty(batch_size, W, self.act_dim)
        goal = torch.empty(batch_size, G, self.obs_dim)
        self._lib.loader_sample_batch(self._ptr, ctypes.c_uint64(seed), ctypes.c_uint64(batch_id),
                                      batch_size, obs.data_ptr(), act.data_ptr(), goal.data_ptr())
        batch = {"observation": obs, "action": act}
        if self.future_conditional:
            batch["goal_observation"] = goal
        return batch

    def batches(self, seed: int, batch_size: int, n_batches: int, n_buffers: int = 3,
                device="cuda") -> Iterator[dict]:
        """Batches 0, 1, ... of `seed` from the prefetch ring: the C++
        producer fills batch k+1 while batch k is copied and used. On a
        CUDA `device` (the default, as `SlicedDataset`'s and JAX's
        `batches(device_put=True)`) each batch goes through one of
        `n_buffers` pinned staging buffers (reused once its copy has
        completed) with `non_blocking=True`; with `device="cpu"` the
        batches are CPU tensors of their own."""
        device = torch.device(device)
        shapes = self._shapes(batch_size)
        staging, events = None, None
        if device.type == "cuda":
            staging = [{k: torch.empty(s, pin_memory=True) for k, s in shapes.items()}
                       for _ in range(n_buffers)]
            events = [None] * n_buffers
        self._lib.loader_start_prefetch(self._ptr, ctypes.c_uint64(seed), batch_size, n_buffers)
        ptrs = {k: ctypes.c_void_p() for k in ("observation", "action", "goal_observation")}
        for i in range(n_batches):
            buf = self._lib.loader_wait_next(self._ptr, *(ctypes.byref(p) for p in ptrs.values()))
            ring = {k: torch.from_numpy(np.ctypeslib.as_array(
                ctypes.cast(ptrs[k], ctypes.POINTER(ctypes.c_float)),
                (int(np.prod(s)),)).reshape(s)) for k, s in shapes.items()}
            if staging is None:
                batch = {k: v.clone() for k, v in ring.items()}
            else:
                slot = i % n_buffers
                if events[slot] is not None:
                    events[slot].synchronize()
                for k, v in ring.items():
                    staging[slot][k].copy_(v)
                batch = {k: v.to(device, non_blocking=True) for k, v in staging[slot].items()}
                events[slot] = torch.cuda.Event()
                events[slot].record()
            self._lib.loader_release(self._ptr, buf)
            yield batch

    def __del__(self):
        try:
            self._lib.loader_destroy(self._ptr)
        except Exception:
            pass
