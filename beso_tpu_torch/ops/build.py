"""Build and load the port's CUDA kernels (nvcc -> one shared library -> ctypes).

Every `csrc/*.cu` is compiled for sm_90a into an object file, all sources at
once in parallel `nvcc` processes, and the objects are linked into one
shared library with a plain C interface. The library is keyed by a hash of
the sources and flags and lives in the git-ignored `build/kernels/`, so a
checkout builds it once at first use. The ptxas report (registers, shared
memory, spills) is kept beside it as `.log`.

Each ops module declares the `argtypes` of its own entry points on the
library that `library()` returns; every entry returns `cudaGetLastError()`,
and `error_string` turns a non-zero code into CUDA's message.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
# build output, keyed by a hash of the sources and flags (listed in .gitignore)
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (on PATH or under CUDA_HOME)")


def sources() -> list:
    return sorted(_CSRC.glob("*.cu"))


def kernel_library_path() -> Path:
    """Path of the shared library for the current sources (may not exist)."""
    srcs = sources() + sorted(_CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return _BUILD_DIR / f"libbeso_kernels_{h.hexdigest()[:16]}.so"


def build_kernels() -> Path:
    """Compile `csrc/*.cu` for sm_90a and link them into the library, unless
    a library for these exact sources is there already."""
    so = kernel_library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources()]
        procs = [subprocess.Popen([nvcc, *_NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for s, o in zip(sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        for s, p, log in zip(sources(), procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s.name} ({p.returncode}):\n{log}")
        lib = Path(tmp) / so.name
        res = subprocess.run([nvcc, *_NVCC_FLAGS[:2], "-shared", "-o", str(lib),
                              *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        so.with_suffix(".log").write_text("".join(logs) + res.stdout + res.stderr)
        os.replace(lib, so)
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    lib = ctypes.CDLL(str(build_kernels()))
    lib.beso_cuda_error_string.argtypes = [ctypes.c_int]
    lib.beso_cuda_error_string.restype = ctypes.c_char_p
    return lib


def error_string(code: int) -> str:
    return library().beso_cuda_error_string(code).decode()


def check_tensor(t: torch.Tensor, name: str, shape, dtype, device, align: int = 32) -> None:
    """Raise unless `t` is what a kernel takes: device, dtype, shape,
    contiguous and `align`-byte aligned (32 for vector loads; a kernel of
    scalar loads passes 1, as every tensor is aligned to its element)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")
