"""Fused prefix-KV transformer layer: CUDA kernel, wrapper, plain version.

Replaces the TPU kernel B1, `fused_layer_prefix_tl_v2`
(`beso_tpu/ops/fused_layer.py:618-682`, kernel body `:564-615`, attention
`_tl_attention` `:346-413`): one pre-LN GPT block over the 2T suffix tokens
of every environment, attending to the cached [sigma, goal] prefix K/V of
the sigma-grid row `idx`, with an optional ln_f + linear-head epilogue that
writes f32 predictions.

The port keeps the math and drops the TPU layout: no environments in lanes,
no head-dim padding to 32, no 128-environment blocks. Activations are
`x [B, 2T, D]` bf16 and the layer's prefix cache `pk/pv [S, B, P, D]` bf16;
`idx` is a device int32[1] the kernel reads itself, so choosing the sigma
row never syncs the host.

What bounds it on the H100, and the design (details in
`csrc/fused_layer_prefix.cu`): at kitchen shapes a launch does ~51 GFLOP of
matrix products against ~36 MB of traffic (~1,400 FLOP/byte, far above the
card's ~295 balance point), so it is compute-bound. The kernel keeps a
64-row tile's intermediates in shared memory, runs QKV, proj, fc and fc2 on
tensor cores (wmma bf16, f32 accumulate), builds QKV head by head, streams
the 4D MLP hidden layer in 128-column chunks and does the 11-key attention
on CUDA cores.

`fused_layer_prefix` takes the plain PyTorch version only for CPU tensors;
for CUDA tensors it launches the kernel or raises. Its `launches` counter
goes up by one per kernel launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from beso_tpu_torch.models.gpt import attend, dense, gelu, layer_norm
from beso_tpu_torch.ops import build


def _ceil16(n: int) -> int:
    return -(-n // 16) * 16


class FusedLayerParams(NamedTuple):
    """One layer's weights in the kernel's layout.

    Weights are [out, in] in the compute dtype, zero-padded to multiples of
    16: each q/k/v head to hdp = ceil16(hd) rows, the model width to
    Dp = ceil16(D), the MLP width to Fp = ceil16(4D). Padding is zero, so
    padded products are exact. Biases and LayerNorm parameters are f32.
    """

    ln1_s: torch.Tensor    # [D]
    ln1_b: torch.Tensor    # [D]
    wqkv: torch.Tensor     # [3*H*hdp, Dp]
    bqkv: torch.Tensor     # [3*H*hdp]
    wproj: torch.Tensor    # [Dp, H*hdp]
    bproj: torch.Tensor    # [Dp]
    ln2_s: torch.Tensor    # [D]
    ln2_b: torch.Tensor    # [D]
    wfc: torch.Tensor      # [Fp, Dp]
    bfc: torch.Tensor      # [Fp]
    wfc2: torch.Tensor     # [Dp, Fp]
    bfc2: torch.Tensor     # [Dp]


class FusedEpilogue(NamedTuple):
    """ln_f + linear head applied after the layer, all f32."""

    lnf_s: torch.Tensor    # [D]
    lnf_b: torch.Tensor    # [D]
    w: torch.Tensor        # [M, D]
    b: torch.Tensor        # [M]


def prepare_layer_params(lp: dict, n_heads: int,
                         dtype: torch.dtype = torch.bfloat16) -> FusedLayerParams:
    """Pad and cast one layer (the dict of `models.cached.extract_gpt_params`,
    Linear weights [out, in]) into the kernel's layout. Call once per model."""
    D = lp["wqkv"].shape[1]
    H = n_heads
    hd = D // H
    hdp, Dp, Fp = _ceil16(hd), _ceil16(D), _ceil16(lp["wfc"].shape[0])

    def pad_to(w, rows, cols):
        return F.pad(w, (0, cols - w.shape[1], 0, rows - w.shape[0]))

    # qkv rows [3, H, hd] -> [3, H, hdp]; proj input columns [H, hd] -> [H, hdp]
    wqkv = F.pad(lp["wqkv"].reshape(3, H, hd, D), (0, Dp - D, 0, hdp - hd))
    bqkv = F.pad(lp["bqkv"].reshape(3, H, hd), (0, hdp - hd))
    wproj = F.pad(lp["wproj"].reshape(D, H, hd), (0, hdp - hd))

    def w(t):
        return t.to(dtype).contiguous()

    def f32(t):
        return t.float().contiguous()

    return FusedLayerParams(
        ln1_s=f32(lp["ln1_s"]), ln1_b=f32(lp["ln1_b"]),
        wqkv=w(wqkv.reshape(3 * H * hdp, Dp)), bqkv=f32(bqkv.reshape(-1)),
        wproj=w(pad_to(wproj.reshape(D, H * hdp), Dp, H * hdp)),
        bproj=f32(F.pad(lp["bproj"], (0, Dp - D))),
        ln2_s=f32(lp["ln2_s"]), ln2_b=f32(lp["ln2_b"]),
        wfc=w(pad_to(lp["wfc"], Fp, Dp)),
        bfc=f32(F.pad(lp["bfc"], (0, Fp - lp["bfc"].shape[0]))),
        wfc2=w(pad_to(lp["wfc2"], Dp, Fp)),
        bfc2=f32(F.pad(lp["bfc2"], (0, Dp - D))))


def fused_layer_prefix_reference(x: torch.Tensor, pk: torch.Tensor,
                                 pv: torch.Tensor, idx: torch.Tensor,
                                 p: FusedLayerParams, *, n_heads: int,
                                 epilogue: Optional[FusedEpilogue] = None):
    """Plain PyTorch version of the kernel, same inputs and outputs.

    x [B, T2, D]; pk/pv [S, B, P, D]; idx int32[1]. Returns out [B, T2, D]
    in x's dtype, or (out, pred [B, T2, M] f32) with an epilogue. Rounds at
    the kernel's points: after every bias, the attention probabilities, and
    each residual add.
    """
    B, T2, D = x.shape
    H = n_heads
    hd = D // H
    P = pk.shape[2]
    dtype = x.dtype
    Dp = p.wqkv.shape[1]
    hdp = p.wqkv.shape[0] // (3 * H)

    h = F.pad(layer_norm(x, p.ln1_s, p.ln1_b, dtype), (0, Dp - D))
    qkv = dense(h, p.wqkv, p.bqkv, dtype).reshape(B, T2, 3, H, hdp)[..., :hd]
    q, k, v = qkv.unbind(2)
    row = idx.reshape(1).long()
    pk_r = pk.index_select(0, row)[0].reshape(B, P, H, hd)
    pv_r = pv.index_select(0, row)[0].reshape(B, P, H, hd)
    causal = torch.ones(T2, T2, dtype=torch.bool, device=x.device).tril()
    mask = torch.cat([torch.ones(T2, P, dtype=torch.bool, device=x.device),
                      causal], dim=1)
    y = attend(q, torch.cat([pk_r.to(dtype), k], 1),
               torch.cat([pv_r.to(dtype), v], 1), mask)
    y = F.pad(y.reshape(B, T2, H, hd), (0, hdp - hd)).reshape(B, T2, H * hdp)
    x1 = x + dense(y, p.wproj, p.bproj, dtype)[..., :D]
    h2 = F.pad(layer_norm(x1, p.ln2_s, p.ln2_b, dtype), (0, Dp - D))
    h2 = gelu(dense(h2, p.wfc, p.bfc, dtype))
    out = x1 + dense(h2, p.wfc2, p.bfc2, dtype)[..., :D]
    if epilogue is None:
        return out
    xe = layer_norm(out, epilogue.lnf_s, epilogue.lnf_b, torch.float32)
    return out, F.linear(xe, epilogue.w.float(), epilogue.b.float())


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.library()
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.beso_fused_layer_prefix.argtypes = [vp] * 22 + [ci] * 8 + [vp]
    lib.beso_fused_layer_prefix.restype = ci
    lib.beso_fused_layer_prefix_limits.argtypes = [ci]
    lib.beso_fused_layer_prefix_limits.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _limits():
    """(rows per block, max keys, max head width, max Dp, max hdp), as the
    compiled kernel reports them."""
    return tuple(_library().beso_fused_layer_prefix_limits(i) for i in range(5))


def fused_layer_prefix(x: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                       idx: torch.Tensor, p: FusedLayerParams, *,
                       n_heads: int, epilogue: Optional[FusedEpilogue] = None):
    """One fused block (see module docstring). CPU tensors take the plain
    version; CUDA tensors launch the kernel (bf16 only) or raise."""
    if x.device.type == "cpu":
        return fused_layer_prefix_reference(x, pk, pv, idx, p, n_heads=n_heads,
                                            epilogue=epilogue)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_prefix runs on CPU or CUDA, got {x.device}")
    B, T2, D = x.shape
    S, _, P, _ = pk.shape
    H = n_heads
    if D % H:
        raise ValueError(f"D={D} not divisible by n_heads={H}")
    hd = D // H
    hdp, Dp = _ceil16(hd), _ceil16(D)
    Fp = p.wfc.shape[0]
    lib = _library()
    rows, max_keys, max_m, max_dp, max_hdp = _limits()
    if T2 > rows or P + T2 > max_keys or Dp > max_dp or hdp > max_hdp:
        raise ValueError(f"shape outside the kernel's limits: T2={T2} (<= {rows}), "
                         f"P+T2={P + T2} (<= {max_keys}), Dp={Dp} (<= {max_dp}), "
                         f"hdp={hdp} (<= {max_hdp})")
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    build.check_tensor(x, "x", (B, T2, D), bf, dev)
    build.check_tensor(pk, "pk", (S, B, P, D), bf, dev)
    build.check_tensor(pv, "pv", (S, B, P, D), bf, dev)
    build.check_tensor(idx, "idx", (1,), torch.int32, dev)
    shapes = dict(ln1_s=(D,), ln1_b=(D,), wqkv=(3 * H * hdp, Dp),
                  bqkv=(3 * H * hdp,), wproj=(Dp, H * hdp), bproj=(Dp,),
                  ln2_s=(D,), ln2_b=(D,), wfc=(Fp, Dp), bfc=(Fp,),
                  wfc2=(Dp, Fp), bfc2=(Dp,))
    if Fp % 16:
        raise ValueError(f"MLP width {Fp} not a multiple of 16")
    for name, shape in shapes.items():
        build.check_tensor(getattr(p, name), name, shape,
                           bf if name.startswith("w") else f32, dev)
    out = torch.empty_like(x)
    pred = None
    M = 0
    epi_ptrs = [None] * 4
    if epilogue is not None:
        M = epilogue.w.shape[0]
        if M > max_m:
            raise ValueError(f"head width {M} > {max_m}")
        for name, shape in dict(lnf_s=(D,), lnf_b=(D,), w=(M, D), b=(M,)).items():
            build.check_tensor(getattr(epilogue, name), f"epilogue.{name}", shape, f32, dev)
        pred = torch.empty(B, T2, M, dtype=f32, device=dev)
        epi_ptrs = [t.data_ptr() for t in epilogue]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.beso_fused_layer_prefix(
        x.data_ptr(), pk.data_ptr(), pv.data_ptr(), idx.data_ptr(),
        *[t.data_ptr() for t in p], *epi_ptrs,
        out.data_ptr(), None if pred is None else pred.data_ptr(),
        B, T2, D, H, P, S, Fp, M, stream)
    if rc != 0:
        raise RuntimeError("fused_layer_prefix launch failed: "
                           + build.error_string(rc))
    fused_layer_prefix.launches += 1
    return out if epilogue is None else (out, pred)


fused_layer_prefix.launches = 0
