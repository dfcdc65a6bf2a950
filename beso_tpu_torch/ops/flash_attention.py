"""Causal flash attention: CUDA kernels, wrappers, plain versions, autograd.

Replaces the TPU kernels B5, the forward (`_flash_forward`,
`beso_tpu/ops/flash_attention.py:269-308`, body `_flash_kernel` :34-75), and
B6, the FlashAttention-2 backward (`_flash_attention_bwd` :182-259: the dQ
kernel `_bwd_dq_kernel` :78-109 and the dK/dV kernel `_bwd_dkv_kernel`
:112-153). Layout as in the JAX package: q, k, v [B, H, T, hd]; the forward
returns o in q's dtype and the f32 logsumexp `lse` [B, H, T, 1] of the
scaled scores. `delta = rowsum(dO * O)` [B, H, T, 1] f32, which the JAX
package computes outside Pallas (:212-214), comes out of the dQ kernel
beside dq, so a backward is exactly two launches.

What bounds the kernels on the H100, and the design (details in
`csrc/flash_attention.cu`, `csrc/flash_attention_f32.cu` and
`csrc/flash_attention_wide.cu`): at the chunked training shape
[256, 6, 131, 60] a launch reads ~24 MB per tensor in bf16 and its products
take a few microseconds at the tensor cores' peak, so it is bound by bytes
and latency. Up to hd 64 in bf16 (`flash_attention.cu`) each warp keeps its
16 rows' score, P and dS tiles in `mma.sync` fragments (the forward runs its
online softmax on them), the streamed tiles come in by `cp.async` two
stages deep, and warps skip the 16-row chunks past T and above the
diagonal. Up to hd 64 in f32 (`flash_attention_f32.cu`) all three kernels
run 64-row tiles on `wgmma`, their f32 tiles by bulk tensor copies (where
rows are 16-byte aligned) split in place into bf16 hi/lo parts. Above hd 64
all three kernels, in both dtypes, run 64-row tiles on `wgmma` (the bf16
kernels' tiles by bulk tensor copies where rows are 16-byte aligned). The
head dim is zero-padded to a multiple of 16 in shared memory and the ragged
edge is masked in the kernels, with no padded copies.

The kernels take q, k, v (and o, dO) all bf16 or all f32, as the JAX
kernels take the model's dtype, and head dims up to 128; the f32
instantiations compute to f32 accuracy (each operand split into bf16 hi and
lo parts, three products).
Each wrapper (`flash_forward`, `flash_backward_dq`, `flash_backward_dkv`)
runs its plain PyTorch version for CPU tensors and, for CUDA tensors,
launches its kernel or raises; its `launches` counter goes up by one per
kernel launch. The three are also operators (`torch.ops.beso.*`) whose vmap
rules fold a mapped axis (the seeds of `train/sweep.py`) into the batch
axis. `flash_attention` is the differentiable entry point:
`FlashAttention` saves (q, k, v, o, lse) and its backward is the two
backward launches, also under `torch.func.vmap`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from beso_tpu_torch.ops import build


def _scale(q: torch.Tensor) -> float:
    return 1.0 / math.sqrt(q.shape[-1])


def _causal_mask(T: int, device) -> torch.Tensor:
    return torch.ones(T, T, dtype=torch.bool, device=device).tril()


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scaled f32 scores [B, H, T, T], masked with -inf above the diagonal."""
    s = (q.float() * _scale(q)) @ k.float().transpose(-1, -2)
    if causal:
        s = s.masked_fill(~_causal_mask(q.shape[2], q.device), float("-inf"))
    return s


def flash_forward_reference(q, k, v, causal: bool = True):
    """Plain version of the forward: (o in q's dtype, lse [B, H, T, 1] f32)."""
    s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    o = torch.exp(s - lse) @ v.float()
    return o.to(q.dtype), lse


def _probs_ds(q, k, v, do, lse, delta, causal):
    """Recomputed probabilities p = exp(s - lse) and dS = p * (dO V^T - delta)."""
    p = torch.exp(_scores(q, k, causal) - lse)
    ds = p * (do.float() @ v.float().transpose(-1, -2) - delta)
    return p, ds


def flash_backward_dq_reference(q, k, v, o, do, lse, causal: bool = True):
    """Plain version of the dQ kernel: (dq = (dS K) * scale in q's dtype,
    delta = rowsum(dO * O) [B, H, T, 1] f32)."""
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    _, ds = _probs_ds(q, k, v, do, lse, delta, causal)
    return ((ds @ k.float()) * _scale(q)).to(q.dtype), delta


def flash_backward_dkv_reference(q, k, v, do, lse, delta, causal: bool = True):
    """Plain version of the dK/dV kernel: dv = P^T dO, dk = dS^T (q * scale)."""
    p, ds = _probs_ds(q, k, v, do, lse, delta, causal)
    dv = p.transpose(-1, -2) @ do.float()
    dk = ds.transpose(-1, -2) @ (q.float() * _scale(q))
    return dk.to(q.dtype), dv.to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.library()
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.beso_flash_fwd.argtypes = [vp] * 5 + [ci] * 5 + [vp]
    lib.beso_flash_bwd_dq.argtypes = [vp] * 8 + [ci] * 5 + [vp]
    lib.beso_flash_bwd_dkv.argtypes = [vp] * 8 + [ci] * 5 + [vp]
    for fn in (lib.beso_flash_fwd, lib.beso_flash_bwd_dq, lib.beso_flash_bwd_dkv):
        fn.restype = ci
    lib.beso_flash_max_head_dim.argtypes = []
    lib.beso_flash_max_head_dim.restype = ci
    lib.beso_flash_blocks_per_sm.argtypes = [ci, ci, ci]
    lib.beso_flash_blocks_per_sm.restype = ci
    return lib


KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MAX_HEAD_DIM = 128   # the kernels' largest head dim (beso_flash_max_head_dim)


def blocks_per_sm(dtype: torch.dtype = torch.bfloat16, head_dim: int = 64) -> dict:
    """Resident blocks per SM of the three kernels that `dtype` and
    `head_dim` select (tile width 64 up to hd 64, else 128) on the current
    card, as the CUDA runtime's occupancy calculator gives them."""
    lib = _library()
    f32 = int(dtype == torch.float32)
    return {name: lib.beso_flash_blocks_per_sm(i, f32, head_dim) for i, name in enumerate(
        ("flash_forward", "flash_backward_dq", "flash_backward_dkv"))}


def _on_cpu(name: str, q: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for CUDA; raises otherwise."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA, got {q.device}")
    return False


def kernel_dtype(name: str, tensors: dict) -> torch.dtype:
    """The element type a kernel runs in: the dtype that the [B, H, T, hd]
    tensors `tensors` (name -> tensor) share, bf16 or f32. Raises TypeError
    on mixed or other dtypes."""
    dtypes = {n: t.dtype for n, t in tensors.items()}
    dtype = next(iter(dtypes.values()))
    if dtype not in KERNEL_DTYPES or any(d != dtype for d in dtypes.values()):
        raise TypeError(f"{name} takes {', '.join(dtypes)} all bf16 or all f32, got "
                        + ", ".join(f"{n} {d}" for n, d in dtypes.items()))
    return dtype


def _check(name, q, k, v, rows, stats):
    """Check q, k, v and the [B, H, T, hd] tensors `rows` (name -> tensor;
    all bf16 or all f32) and the f32 [B, H, T, 1] tensors `stats`, the
    dtypes and the head dim (<= MAX_HEAD_DIM) before the library loads.
    Returns (library, B * H, T, hd, 1 for f32 else 0)."""
    rows = {"q": q, "k": k, "v": v, **rows}
    dtype = kernel_dtype(name, rows)
    B, H, T, hd = q.shape
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"{name} takes head dims up to {MAX_HEAD_DIM}, got {hd}")
    lib = _library()
    if lib.beso_flash_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError(f"the kernels take head dims up to {lib.beso_flash_max_head_dim()}, "
                           f"flash_attention.py says {MAX_HEAD_DIM}")
    for n, t in rows.items():
        build.check_tensor(t, n, q.shape, dtype, q.device)
    for n, t in stats.items():
        build.check_tensor(t, n, (*q.shape[:3], 1), torch.float32, q.device)
    return lib, B * H, T, hd, int(dtype == torch.float32)


def _launch(name: str, fn, device, *args) -> None:
    rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {build.error_string(rc)}")


def flash_forward(q, k, v, causal: bool = True):
    """Kernel B5: (o in q's dtype, lse [B, H, T, 1] f32) of causal (or full)
    attention over [B, H, T, hd]."""
    if _on_cpu("flash_forward", q):
        return flash_forward_reference(q, k, v, causal)
    lib, BH, T, hd, f32 = _check("flash_forward", q, k, v, {}, {})
    o = torch.empty_like(q)
    lse = torch.empty(*q.shape[:3], 1, dtype=torch.float32, device=q.device)
    _launch("flash_forward", lib.beso_flash_fwd, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr(), BH, T, hd, int(causal), f32)
    flash_forward.launches += 1
    return o, lse


def flash_backward_dq(q, k, v, o, do, lse, causal: bool = True):
    """Kernel B6, dQ: (dq [B, H, T, hd] in q's dtype, delta = rowsum(dO * O)
    [B, H, T, 1] f32), the delta for `flash_backward_dkv`."""
    if _on_cpu("flash_backward_dq", q):
        return flash_backward_dq_reference(q, k, v, o, do, lse, causal)
    lib, BH, T, hd, f32 = _check("flash_backward_dq", q, k, v, {"o": o, "do": do},
                                 {"lse": lse})
    dq = torch.empty_like(q)
    delta = torch.empty(*q.shape[:3], 1, dtype=torch.float32, device=q.device)
    _launch("flash_backward_dq", lib.beso_flash_bwd_dq, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
            delta.data_ptr(), BH, T, hd, int(causal), f32)
    flash_backward_dq.launches += 1
    return dq, delta


def flash_backward_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """Kernel B6, dK/dV: (dk, dv) [B, H, T, hd] in q's dtype."""
    if _on_cpu("flash_backward_dkv", q):
        return flash_backward_dkv_reference(q, k, v, do, lse, delta, causal)
    lib, BH, T, hd, f32 = _check("flash_backward_dkv", q, k, v, {"do": do},
                                 {"lse": lse, "delta": delta})
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_backward_dkv", lib.beso_flash_bwd_dkv, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), BH, T, hd, int(causal), f32)
    flash_backward_dkv.launches += 1
    return dk, dv


flash_forward.launches = 0
flash_backward_dq.launches = 0
flash_backward_dkv.launches = 0


# ---------------------------------------------------------------------------
# operators: autograd and a leading seed axis
# ---------------------------------------------------------------------------
# The three wrappers are registered as operators (`beso::flash_forward`,
# `beso::flash_backward_dq`, `beso::flash_backward_dkv`) so that
# `torch.func.vmap` reaches them as it reaches a built-in operator. Each
# operator's vmap rule folds the mapped axis into the batch axis: a call
# mapped over S models at [S, B, H, T, hd] is one launch at [S*B, H, T, hd],
# as `jax.vmap` of a `pallas_call` is one kernel over a larger grid. The
# backward operators need rules of their own: under `torch.func` the
# backward runs at the same map level as the forward. The autograd lives in
# `FlashAttention`, since an operator's own autograd formula does not
# compose with `torch.func.grad`.


@torch.library.custom_op("beso::flash_forward", mutates_args=())
def _flash_forward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_forward(q, k, v, causal)


@torch.library.custom_op("beso::flash_backward_dq", mutates_args=())
def _flash_backward_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                          causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_backward_dq(q, k, v, o, do, lse, causal)


@torch.library.custom_op("beso::flash_backward_dkv", mutates_args=())
def _flash_backward_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                           causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_backward_dkv(q, k, v, do, lse, delta, causal)


def _fold(x: torch.Tensor, dim, size: int) -> torch.Tensor:
    """A mapped tensor with its mapped axis `dim` (None: not mapped, so
    broadcast) folded into its batch axis: [size * B, ...], contiguous."""
    x = x.expand(size, *x.shape) if dim is None else x.movedim(dim, 0)
    return x.reshape(size * x.shape[1], *x.shape[2:]).contiguous()


def _folded_rule(op):
    """The vmap rule of `op`, whose tensor arguments and two outputs all lead
    with the batch axis: one call on the folded tensors."""

    def rule(info, in_dims, *args):
        S = info.batch_size
        args = [_fold(a, d, S) if isinstance(a, torch.Tensor) else a
                for a, d in zip(args, in_dims)]
        outs = op(*args)
        return tuple(o.unflatten(0, (S, -1)) for o in outs), (0, 0)

    return rule


for _name in ("flash_forward", "flash_backward_dq", "flash_backward_dkv"):
    torch.library.register_vmap(f"beso::{_name}",
                                _folded_rule(getattr(torch.ops.beso, _name)))


class FlashAttention(torch.autograd.Function):
    """o = softmax(q k^T / sqrt(hd)) v through kernels B5 and B6, on the
    operators above. Its vmap rule is generated: the forward and the
    backward run under the map, where the operators' rules fold it."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, causal):
        return torch.ops.beso.flash_forward(q, k, v, causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal = inputs
        ctx.save_for_backward(q, k, v, *output)
        ctx.causal = causal
        ctx.mark_non_differentiable(output[1])
        # no zero-filled cotangent for lse: the backward is the two launches
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, do, dlse):
        del dlse   # lse is the backward's statistics, not differentiated
        if do is None:
            return None, None, None, None
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        with torch.no_grad():   # the backward kernels have no derivative
            dq, delta = torch.ops.beso.flash_backward_dq(q, k, v, o, do, lse, ctx.causal)
            dk, dv = torch.ops.beso.flash_backward_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q, k, v [B, H, T, hd] -> softmax(q k^T / sqrt(hd)) v, differentiable
    in q, k and v (`beso_tpu.ops.flash_attention.flash_attention`); under
    `torch.func.vmap` one launch per kernel for all mapped slices."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal)[0]
