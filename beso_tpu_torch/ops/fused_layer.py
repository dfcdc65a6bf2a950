"""Fused transformer layers: CUDA kernels, wrappers, plain versions.

Replaces the four fused-layer TPU kernels of `beso_tpu/ops/fused_layer.py`,
each a pre-LN GPT block with its intermediates kept on chip:

- B1 `fused_layer_prefix` for `fused_layer_prefix_tl_v2` (`:618-682`, body
  `:564-615`, attention `_tl_attention` `:346-413`): one block over the 2T
  suffix tokens of every environment, attending to the cached [sigma, goal]
  prefix K/V of the sigma-grid row `idx`, with an optional ln_f +
  linear-head epilogue that writes f32 predictions;
- B2 `fused_layers_prefix_group` for `fused_layers_prefix_tl_v2_group`
  (`:488-561`, body `:442-485`): N consecutive B1 blocks in one launch, the
  epilogue after the last;
- B3 `fused_layer_with_prefix` for `fused_layer_with_prefix` (`:258-295`,
  body `:195-255`): one block against one prefix row already selected;
- B4 `fused_layer` for `fused_layer` (`:298-334`, body `:129-192`): one
  block over the whole causal token sequence, no prefix.

The port keeps the math and drops the TPU layouts: no environments in lanes,
no head-dim padding to 32, no 128-environment blocks. Activations are
`x [B, T, D]` and a layer's prefix cache `pk/pv [S, B, P, D]`, both bf16 or
both f32 (the model's dtype, as the JAX kernels take it); `idx` is a device
int32[1] the kernel reads itself, so choosing the sigma row never syncs the
host. In each dtype all four run one kernel body (bf16
`csrc/fused_layer_prefix.cu`, f32 `csrc/fused_layer_f32.cu`), so B2 equals
a chain of B1 launches and B3 a B1 launch on the same row, bit for bit.

What bounds it on the H100, and the design (details in
`csrc/fused_layer_prefix.cu`): at kitchen shapes a launch does ~51 GFLOP of
matrix products against ~36 MB of traffic (~1,400 FLOP/byte, far above the
card's ~295 balance point), so it is compute-bound. The kernel keeps a
64-row tile's intermediates in shared memory and streams the layer's
weights through a ring of shared-memory slots, filled by bulk asynchronous
copies from the tiled copy `tile_layer_weights` lays out once per model;
QKV, proj, fc and fc2 run on `wgmma` (bf16, f32 accumulators in registers)
and the attention on `mma.sync`. `fused_layer_prefix_timed` reports each
block's clock cycles per phase of B1. The f32 form keeps f32 accuracy on
the tensor cores: every operand is split into bf16 hi + lo parts (the
weights once per model, in the tiled copy) and each product is
hi.hi + lo.hi + hi.lo on `wgmma`, 64 rows per block, in clusters of two
blocks that share each weight chunk, the residual in registers.

Each wrapper takes its plain PyTorch version only for CPU tensors; for CUDA
tensors it launches its kernel (the bf16 or the f32 one, by x's dtype) or
raises, and for any other device it raises. Its `launches` counter goes up
by one per kernel launch, in either dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from beso_tpu_torch.models.gpt import attend, dense, gelu, layer_norm
from beso_tpu_torch.ops import build


# the dtypes the kernels take: bf16 and f32 (csrc/fused_layer_f32.cu)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _ceil16(n: int) -> int:
    return -(-n // 16) * 16


class FusedLayerParams(NamedTuple):
    """One layer's weights in the kernel's layout.

    Weights are [out, in] in the compute dtype, zero-padded to multiples of
    16: each q/k/v head to hdp = ceil16(hd) rows, the model width to
    Dp = ceil16(D), the MLP width to Fp = ceil16(4D). Padding is zero, so
    padded products are exact. Biases and LayerNorm parameters are f32.
    `tiles` is the kernels' copy of the four weights, derived from them by
    `tile_layer_weights` for a bf16 or an f32 layer (None otherwise).
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
    tiles: Optional[torch.Tensor] = None   # flat bf16, `tile_layer_weights`


class FusedEpilogue(NamedTuple):
    """ln_f + linear head applied after the layer, all f32."""

    lnf_s: torch.Tensor    # [D]
    lnf_b: torch.Tensor    # [D]
    w: torch.Tensor        # [M, D]
    b: torch.Tensor        # [M]


def prepare_layer_params(lp: dict, n_heads: int,
                         dtype: torch.dtype = torch.bfloat16) -> FusedLayerParams:
    """Pad and cast one layer (the dict of `models.cached.extract_gpt_params`,
    Linear weights [out, in]) into the kernel's layout, with the tiled copy
    of the weights when dtype is bf16 or f32 (the kernels' types). Call once
    per model."""
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

    p = FusedLayerParams(
        ln1_s=f32(lp["ln1_s"]), ln1_b=f32(lp["ln1_b"]),
        wqkv=w(wqkv.reshape(3 * H * hdp, Dp)), bqkv=f32(bqkv.reshape(-1)),
        wproj=w(pad_to(wproj.reshape(D, H * hdp), Dp, H * hdp)),
        bproj=f32(F.pad(lp["bproj"], (0, Dp - D))),
        ln2_s=f32(lp["ln2_s"]), ln2_b=f32(lp["ln2_b"]),
        wfc=w(pad_to(lp["wfc"], Fp, Dp)),
        bfc=f32(F.pad(lp["bfc"], (0, Fp - lp["bfc"].shape[0]))),
        wfc2=w(pad_to(lp["wfc2"], Dp, Fp)),
        bfc2=f32(F.pad(lp["bfc2"], (0, Dp - D))))
    if dtype in KERNEL_DTYPES:
        p = p._replace(tiles=tile_layer_weights(p, H))
    return p


def check_fused_dtype(device, dtype: torch.dtype) -> None:
    """Raise TypeError unless the fused layer kernels can run a model that
    computes in `dtype` on `device`: on the card they take bf16 and f32; on
    the CPU the plain versions take any dtype. The engines call it when they
    are built, so an unsupported dtype shows before a rollout starts."""
    if torch.device(device).type == "cuda" and dtype not in KERNEL_DTYPES:
        raise TypeError(
            f"the fused layer kernels take bf16 or f32 on the card, and this model "
            f"computes in {dtype}: use a bf16 or f32 model or the 'cached' or 'full' "
            f"engine")


# Tiling constants shared with csrc/fused_layer_prefix.cu (SLOT_BYTES, FC)
# and csrc/fused_layer_f32.cu (F32_SLOT_BYTES, FC), which `_limits()` reads
# back from the compiled kernels on the card.
SLOT_BYTES = 12288       # one slot of the bf16 kernel's weight ring
F32_SLOT_BYTES = 24576   # one slot of the f32 kernel's ring: a chunk's hi and lo parts
MLP_CHUNK = 160          # FC: hidden columns per MLP chunk


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def layer_products(p: FusedLayerParams, n_heads: int):
    """The B operands [N, K] of one layer's products in the order the
    kernel of the layer's dtype consumes them: per head the [q|k|v] rows
    (3 hdp x Dp), proj with its rows padded to Dq = ceil128(Dp) (Dq x H hdp;
    in f32 cut by head, each head's Dq x hdp right after its [q|k|v]), then
    per MLP chunk of MLP_CHUNK hidden columns fc (MLP_CHUNK x Dp) and fc2
    (Dq x MLP_CHUNK), F padded to a multiple of MLP_CHUNK. Padding is
    zero."""
    H = n_heads
    Dp = p.wqkv.shape[1]
    hdp = p.wqkv.shape[0] // (3 * H)
    Fp = p.wfc.shape[0]
    Dq, Fq = _ceil_to(Dp, 128), _ceil_to(Fp, MLP_CHUNK)
    wqkv = p.wqkv.reshape(3, H, hdp, Dp)
    wproj = F.pad(p.wproj, (0, 0, 0, Dq - Dp))
    if p.wqkv.dtype == torch.float32:
        prods = [w for h in range(H)
                 for w in (wqkv[:, h].reshape(3 * hdp, Dp), wproj[:, h * hdp:(h + 1) * hdp])]
    else:
        prods = [wqkv[:, h].reshape(3 * hdp, Dp) for h in range(H)] + [wproj]
    wfc = F.pad(p.wfc, (0, 0, 0, Fq - Fp))
    wfc2 = F.pad(p.wfc2, (0, Fq - Fp, 0, Dq - Dp))
    for c in range(0, Fq, MLP_CHUNK):
        prods += [wfc[c:c + MLP_CHUNK], wfc2[:, c:c + MLP_CHUNK]]
    return prods


def chunk_steps(n_rows: int, ksteps: int, f32: bool = False):
    """16-deep k-steps of each ring chunk of a B operand with n_rows rows:
    as many as fit a ring slot (at least one; f32: a hi and a lo part in
    F32_SLOT_BYTES, else SLOT_BYTES), the last chunk the rest."""
    parts, slot = (2, F32_SLOT_BYTES) if f32 else (1, SLOT_BYTES)
    kpc = max(1, slot // (parts * n_rows * 32))
    return [min(kpc, ksteps - k) for k in range(0, ksteps, kpc)]


def _core_matrices(blk: torch.Tensor) -> torch.Tensor:
    """[N, 16 k] as 8 x 8 core matrices of 128 contiguous bytes, ordered
    [k/8][n/8][8 rows][8], flat."""
    N, K = blk.shape
    return blk.reshape(N // 8, 8, K // 8, 8).permute(2, 0, 1, 3).reshape(-1)


def tile_layer_weights(p: FusedLayerParams, n_heads: int) -> torch.Tensor:
    """The kernels' tiled copy of one layer's weights: each product of
    `layer_products`, cut into the chunks of `chunk_steps`, each chunk
    [N, 16 k] laid out as the K-major unswizzled operand (8 x 8 core
    matrices of 128 contiguous bytes, ordered [k/8][n/8][8 rows][8]) and the
    chunks concatenated, so the kernel fills a ring slot with one bulk copy
    of contiguous bytes. Flat bf16. For an f32 layer each chunk is its hi
    part bf16(w) followed by its lo part bf16(w - hi), which the f32 kernel
    multiplies as hi.hi + lo.hi + hi.lo."""
    f32 = p.wqkv.dtype == torch.float32
    parts = []
    for wt in layer_products(p, n_heads):
        N, K = wt.shape
        k0 = 0
        for ks in chunk_steps(N, K // 16, f32):
            blk = wt[:, k0 * 16:(k0 + ks) * 16]
            if f32:
                hi = blk.to(torch.bfloat16)
                parts += [_core_matrices(hi),
                          _core_matrices((blk - hi.float()).to(torch.bfloat16))]
            else:
                parts.append(_core_matrices(blk))
            k0 += ks
    return torch.cat(parts).contiguous()


def _block_reference(x: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                     p: FusedLayerParams, n_heads: int) -> torch.Tensor:
    """One block over x [B, T, D] whose queries see all P keys of pk/pv
    [B, P, D] (P may be 0) plus their own causal keys. Rounds at the
    kernels' points: after every bias, the attention probabilities, and
    each residual add."""
    B, T, D = x.shape
    H = n_heads
    hd = D // H
    P = pk.shape[1]
    dtype = x.dtype
    Dp = p.wqkv.shape[1]
    hdp = p.wqkv.shape[0] // (3 * H)

    h = F.pad(layer_norm(x, p.ln1_s, p.ln1_b, dtype), (0, Dp - D))
    qkv = dense(h, p.wqkv, p.bqkv, dtype).reshape(B, T, 3, H, hdp)[..., :hd]
    q, k, v = qkv.unbind(2)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    mask = torch.cat([torch.ones(T, P, dtype=torch.bool, device=x.device),
                      causal], dim=1)
    y = attend(q, torch.cat([pk.reshape(B, P, H, hd).to(dtype), k], 1),
               torch.cat([pv.reshape(B, P, H, hd).to(dtype), v], 1), mask)
    y = F.pad(y.reshape(B, T, H, hd), (0, hdp - hd)).reshape(B, T, H * hdp)
    x1 = x + dense(y, p.wproj, p.bproj, dtype)[..., :D]
    h2 = F.pad(layer_norm(x1, p.ln2_s, p.ln2_b, dtype), (0, Dp - D))
    h2 = gelu(dense(h2, p.wfc, p.bfc, dtype))
    return x1 + dense(h2, p.wfc2, p.bfc2, dtype)[..., :D]


def fused_layer_prefix_reference(x: torch.Tensor, pk: torch.Tensor,
                                 pv: torch.Tensor, idx: torch.Tensor,
                                 p: FusedLayerParams, *, n_heads: int,
                                 epilogue: Optional[FusedEpilogue] = None):
    """Plain PyTorch version of B1, same inputs and outputs.

    x [B, T2, D]; pk/pv [S, B, P, D]; idx int32[1]. Returns out [B, T2, D]
    in x's dtype, or (out, pred [B, T2, M] f32) with an epilogue.
    """
    row = idx.reshape(1).long()
    out = _block_reference(x, pk.index_select(0, row)[0],
                           pv.index_select(0, row)[0], p, n_heads)
    if epilogue is None:
        return out
    xe = layer_norm(out, epilogue.lnf_s, epilogue.lnf_b, torch.float32)
    return out, F.linear(xe, epilogue.w.float(), epilogue.b.float())


def fused_layers_prefix_group_reference(x: torch.Tensor, pk_layers, pv_layers,
                                        idx: torch.Tensor, layer_params, *,
                                        n_heads: int,
                                        epilogue: Optional[FusedEpilogue] = None):
    """Plain PyTorch version of B2: the chain of B1's plain version over the
    group's layers, the epilogue on the last."""
    n = len(layer_params)
    for li, (pk, pv, p) in enumerate(zip(pk_layers, pv_layers, layer_params)):
        out = fused_layer_prefix_reference(
            x, pk, pv, idx, p, n_heads=n_heads,
            epilogue=epilogue if li == n - 1 else None)
        x = out if (epilogue is None or li < n - 1) else out[0]
    return out


def fused_layer_with_prefix_reference(x: torch.Tensor, pk: torch.Tensor,
                                      pv: torch.Tensor, p: FusedLayerParams, *,
                                      n_heads: int) -> torch.Tensor:
    """Plain PyTorch version of B3: x [B, T2, D] against one prefix row
    pk/pv [B, P, D]."""
    return _block_reference(x, pk, pv, p, n_heads)


def fused_layer_reference(x: torch.Tensor, p: FusedLayerParams, *,
                          n_heads: int) -> torch.Tensor:
    """Plain PyTorch version of B4: one causal block over x [B, T, D]."""
    empty = x.new_zeros(x.shape[0], 0, x.shape[2])
    return _block_reference(x, empty, empty, p, n_heads)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.library()
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for prefix in ("beso_fused_", "beso_fused_f32_"):
        getattr(lib, prefix + "layer_prefix").argtypes = [vp] * 11 + [ci] * 8 + [vp]
        getattr(lib, prefix + "layers_prefix_group").argtypes = (
            [vp] * 3 + [ci] + [vp] * 6 + [ci] * 8 + [vp])
        getattr(lib, prefix + "layer_with_prefix").argtypes = [vp] * 5 + [ci] * 6 + [vp]
        getattr(lib, prefix + "layer").argtypes = [vp] * 3 + [ci] * 5 + [vp]
        for name in ("layer_prefix", "layers_prefix_group", "layer_with_prefix", "layer"):
            getattr(lib, prefix + name).restype = ci
    for fn in (lib.beso_fused_layer_prefix_timed, lib.beso_fused_f32_layer_prefix_timed):
        fn.argtypes = [vp] * 12 + [ci] * 8 + [vp]
        fn.restype = ci
    for fn in (lib.beso_fused_layer_prefix_limits, lib.beso_fused_f32_limits):
        fn.argtypes = [ci]
        fn.restype = ci
    return lib


def _entry(name: str, dtype: torch.dtype):
    """The library's entry point `name` (e.g. "layer_prefix") of the bf16
    or the f32 kernel."""
    f32 = "f32_" if dtype == torch.float32 else ""
    return getattr(_library(), f"beso_fused_{f32}{name}")


class _Limits(NamedTuple):
    rows: int         # token rows per block
    max_keys: int     # P + T
    max_m: int        # head outputs of the epilogue
    max_dp: int
    max_hdp: int
    max_layers: int   # layers of one B2 group
    max_hdp_all: int  # H * hdp
    block_keys: Optional[int]   # keys of the envs of a 16-row block (bf16 only)
    cluster: int = 1  # blocks per cluster: the grid is whole clusters


@functools.lru_cache(maxsize=None)
def _limits(dtype: torch.dtype = torch.bfloat16) -> _Limits:
    """The `dtype` kernel's limits, as the compiled kernel reports them.
    Raises if its tiling constants are not this module's."""
    lib = _library()
    if dtype == torch.float32:
        lim = [lib.beso_fused_f32_limits(i) for i in range(11)]
        if (lim[7], lim[8], lim[9]) != (F32_SLOT_BYTES, MLP_CHUNK, len(F32_PHASES)):
            raise RuntimeError(f"f32 kernel constants {lim} do not match fused_layer.py "
                               f"(F32_SLOT_BYTES {F32_SLOT_BYTES}, MLP_CHUNK {MLP_CHUNK}, "
                               f"{len(F32_PHASES)} phases)")
        return _Limits(*lim[:7], block_keys=None, cluster=lim[10])
    lim = [lib.beso_fused_layer_prefix_limits(i) for i in range(11)]
    if (lim[6], lim[8], lim[9]) != (len(PHASES), SLOT_BYTES, MLP_CHUNK):
        raise RuntimeError(f"kernel constants {lim} do not match fused_layer.py "
                           f"({len(PHASES)} phases, SLOT_BYTES {SLOT_BYTES}, "
                           f"MLP_CHUNK {MLP_CHUNK})")
    return _Limits(*lim[:6], max_hdp_all=lim[7], block_keys=lim[10])


def _on_cuda(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA, got {x.device}")
    return True


def _kernel_dtype(x: torch.Tensor) -> torch.dtype:
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the fused layer kernels take bf16 or f32 activations, got {x.dtype}")
    return x.dtype


def _check_launch(x: torch.Tensor, P: int, n_heads: int, layer_params):
    """Raise unless x [B, T, D] (bf16 or f32) with P prefix keys and these
    layers fit x's kernel; returns (B, T, D, Fp) and the layers' weight
    pointers."""
    B, T, D = x.shape
    H = n_heads
    if D % H:
        raise ValueError(f"D={D} not divisible by n_heads={H}")
    dtype = _kernel_dtype(x)
    hd = D // H
    hdp, Dp = _ceil16(hd), _ceil16(D)
    Fp = layer_params[0].wfc.shape[0]
    lim = _limits(dtype)
    # keys of the envs each 16 query rows of a tile belong to (the bf16
    # kernel's attention holds at most `block_keys` of them)
    tile = lim.rows // T * T if T <= lim.rows else 0
    span = max(((min(r + 15, tile - 1) // T - r // T + 1) * (P + T)
                for r in range(0, tile, 16)), default=0)
    if (T > lim.rows or P + T > lim.max_keys or Dp > lim.max_dp or hdp > lim.max_hdp
            or H * hdp > lim.max_hdp_all
            or (lim.block_keys is not None and span > lim.block_keys)):
        raise ValueError(f"shape outside the {dtype} kernel's limits: T={T} (<= {lim.rows}), "
                         f"P+T={P + T} (<= {lim.max_keys}), Dp={Dp} (<= {lim.max_dp}), "
                         f"hdp={hdp} (<= {lim.max_hdp}), H*hdp={H * hdp} "
                         f"(<= {lim.max_hdp_all}), keys of a 16-row block {span} "
                         f"(<= {lim.block_keys})")
    if Fp % 16:
        raise ValueError(f"MLP width {Fp} not a multiple of 16")
    dev, f32 = x.device, torch.float32
    build.check_tensor(x, "x", (B, T, D), dtype, dev)
    shapes = dict(ln1_s=(D,), ln1_b=(D,), wqkv=(3 * H * hdp, Dp),
                  bqkv=(3 * H * hdp,), wproj=(Dp, H * hdp), bproj=(Dp,),
                  ln2_s=(D,), ln2_b=(D,), wfc=(Fp, Dp), bfc=(Fp,),
                  wfc2=(Dp, Fp), bfc2=(Dp,))
    Dq, Fq = _ceil_to(Dp, 128), _ceil_to(Fp, MLP_CHUNK)
    n_tiles = 3 * H * hdp * Dp + Dq * H * hdp + Fq * Dp + Dq * Fq   # `layer_products`
    if dtype == f32:
        n_tiles *= 2   # hi and lo parts
    ptrs = []
    for p in layer_params:
        for name, shape in shapes.items():
            build.check_tensor(getattr(p, name), name, shape,
                               dtype if name.startswith("w") else f32, dev)
        if p.tiles is None:
            raise ValueError("the layer has no tiled weights: prepare it with "
                             f"prepare_layer_params(..., dtype={dtype})")
        build.check_tensor(p.tiles, "tiles", (n_tiles,), torch.bfloat16, dev)
        ptrs.append([t.data_ptr() for t in p])
    return (B, T, D, Fp), ptrs


def _check_epilogue(epilogue: Optional[FusedEpilogue], x: torch.Tensor):
    """(M, [4 pointers], pred tensor or None) for an optional epilogue."""
    if epilogue is None:
        return 0, [None] * 4, None
    B, T, D = x.shape
    M = epilogue.w.shape[0]
    max_m = _limits(x.dtype).max_m
    if M > max_m:
        raise ValueError(f"head width {M} > {max_m}")
    for name, shape in dict(lnf_s=(D,), lnf_b=(D,), w=(M, D), b=(M,)).items():
        build.check_tensor(getattr(epilogue, name), f"epilogue.{name}", shape,
                           torch.float32, x.device)
    pred = torch.empty(B, T, M, dtype=torch.float32, device=x.device)
    return M, [t.data_ptr() for t in epilogue], pred


def _ptr_array(ptrs):
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: " + build.error_string(rc))


def _launch_b1(x, pk, pv, idx, p, n_heads, epilogue, cycles=None):
    """Checks and launches B1 (with the phase clock when `cycles` is given);
    returns what `fused_layer_prefix` does."""
    S, B, P, D = pk.shape
    (B, T2, D, Fp), (w,) = _check_launch(x, P, n_heads, [p])
    for name, t in (("pk", pk), ("pv", pv)):
        build.check_tensor(t, name, (S, B, P, D), x.dtype, x.device)
    build.check_tensor(idx, "idx", (1,), torch.int32, x.device)
    M, epi, pred = _check_epilogue(epilogue, x)
    out = torch.empty_like(x)
    args = [x.data_ptr(), pk.data_ptr(), pv.data_ptr(), idx.data_ptr(), _ptr_array(w),
            *epi, out.data_ptr(), None if pred is None else pred.data_ptr()]
    tail = [B, T2, D, n_heads, P, S, Fp, M, torch.cuda.current_stream(x.device).cuda_stream]
    if cycles is None:
        rc = _entry("layer_prefix", x.dtype)(*args, *tail)
    else:
        rc = _entry("layer_prefix_timed", x.dtype)(*args, cycles.data_ptr(), *tail)
    _raise_on(rc, "fused_layer_prefix")
    return out if epilogue is None else (out, pred)


def fused_layer_prefix(x: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                       idx: torch.Tensor, p: FusedLayerParams, *,
                       n_heads: int, epilogue: Optional[FusedEpilogue] = None):
    """B1 (see module docstring). CPU tensors take the plain version; CUDA
    tensors launch the kernel of their dtype (bf16 or f32) or raise."""
    if not _on_cuda(x, "fused_layer_prefix"):
        return fused_layer_prefix_reference(x, pk, pv, idx, p, n_heads=n_heads,
                                            epilogue=epilogue)
    res = _launch_b1(x, pk, pv, idx, p, n_heads, epilogue)
    fused_layer_prefix.launches += 1
    return res


# Phases of B1's timed launch, in the kernel's order (enum Phase); the f32
# kernel adds the cycles thread 0 spent on the weight ring (waiting for a
# slot to fill or free, issuing the copies), held apart from the phase that
# waited.
PHASES = ("load", "ln1", "qkv", "attention", "proj", "ln2", "fc", "fc2",
          "write", "epilogue")
F32_PHASES = PHASES + ("ring_wait",)


def timed_phases(dtype: torch.dtype):
    """The phases `fused_layer_prefix_timed` reports for x of `dtype`."""
    return F32_PHASES if dtype == torch.float32 else PHASES


def fused_layer_prefix_timed(x: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                             idx: torch.Tensor, p: FusedLayerParams, *,
                             n_heads: int, epilogue: Optional[FusedEpilogue] = None):
    """B1 with the kernel's phase clock, for measurement only (nothing on
    the serving path calls it, and it leaves B1's launch count alone).
    Returns (what `fused_layer_prefix` returns, cycles int64 [blocks,
    len(phases)]): each block's clock64() cycles per phase of
    `timed_phases(x.dtype)`. Needs CUDA tensors (bf16 or f32): a clock has
    no plain version."""
    if not _on_cuda(x, "fused_layer_prefix_timed"):
        raise ValueError("fused_layer_prefix_timed needs CUDA tensors")
    lim = _limits(_kernel_dtype(x))
    tiles = -(-x.shape[0] // (lim.rows // x.shape[1]))
    blocks = -(-tiles // lim.cluster) * lim.cluster
    cycles = torch.zeros(blocks, len(timed_phases(x.dtype)), dtype=torch.int64,
                         device=x.device)
    return _launch_b1(x, pk, pv, idx, p, n_heads, epilogue, cycles), cycles


def fused_layers_prefix_group(x: torch.Tensor, pk_layers: Sequence[torch.Tensor],
                              pv_layers: Sequence[torch.Tensor], idx: torch.Tensor,
                              layer_params: Sequence[FusedLayerParams], *,
                              n_heads: int,
                              epilogue: Optional[FusedEpilogue] = None):
    """B2: the blocks of `layer_params` in one launch, each against its own
    pk/pv [S, B, P, D] at row `idx`, the epilogue after the last. Returns
    what the last B1 launch of the chain would. CPU tensors take the plain
    version; CUDA tensors launch the kernel of their dtype (bf16 or f32) or
    raise."""
    if not _on_cuda(x, "fused_layers_prefix_group"):
        return fused_layers_prefix_group_reference(
            x, pk_layers, pv_layers, idx, layer_params, n_heads=n_heads,
            epilogue=epilogue)
    n = len(layer_params)
    max_layers = _limits(_kernel_dtype(x)).max_layers
    if not 1 <= n <= max_layers or len(pk_layers) != n or len(pv_layers) != n:
        raise ValueError(f"a group holds 1 to {max_layers} layers, each with its "
                         f"pk and pv; got {n} layers, {len(pk_layers)} pk, "
                         f"{len(pv_layers)} pv")
    S, B, P, D = pk_layers[0].shape
    (B, T2, D, Fp), ws = _check_launch(x, P, n_heads, layer_params)
    ptrs = []
    for li, (w, pk, pv) in enumerate(zip(ws, pk_layers, pv_layers)):
        for name, t in (("pk", pk), ("pv", pv)):
            build.check_tensor(t, f"{name}[{li}]", (S, B, P, D), x.dtype, x.device)
        ptrs += w + [pk.data_ptr(), pv.data_ptr()]
    build.check_tensor(idx, "idx", (1,), torch.int32, x.device)
    M, epi, pred = _check_epilogue(epilogue, x)
    out = torch.empty_like(x)
    rc = _entry("layers_prefix_group", x.dtype)(
        x.data_ptr(), idx.data_ptr(), _ptr_array(ptrs), n, *epi, out.data_ptr(),
        None if pred is None else pred.data_ptr(), B, T2, D, n_heads, P, S, Fp, M,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "fused_layers_prefix_group")
    fused_layers_prefix_group.launches += 1
    return out if epilogue is None else (out, pred)


def fused_layer_with_prefix(x: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                            p: FusedLayerParams, *, n_heads: int) -> torch.Tensor:
    """B3: one block over x [B, T2, D] against the prefix row pk/pv
    [B, P, D] the caller selected. CPU tensors take the plain version; CUDA
    tensors launch the kernel of their dtype (bf16 or f32) or raise."""
    if not _on_cuda(x, "fused_layer_with_prefix"):
        return fused_layer_with_prefix_reference(x, pk, pv, p, n_heads=n_heads)
    B, P, D = pk.shape
    (B, T2, D, Fp), (w,) = _check_launch(x, P, n_heads, [p])
    for name, t in (("pk", pk), ("pv", pv)):
        build.check_tensor(t, name, (B, P, D), x.dtype, x.device)
    out = torch.empty_like(x)
    rc = _entry("layer_with_prefix", x.dtype)(
        x.data_ptr(), pk.data_ptr(), pv.data_ptr(), _ptr_array(w), out.data_ptr(),
        B, T2, D, n_heads, P, Fp, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "fused_layer_with_prefix")
    fused_layer_with_prefix.launches += 1
    return out


def fused_layer(x: torch.Tensor, p: FusedLayerParams, *, n_heads: int) -> torch.Tensor:
    """B4: one causal block over the whole token sequence x [B, T, D]. CPU
    tensors take the plain version; CUDA tensors launch the kernel of their
    dtype (bf16 or f32) or raise."""
    if not _on_cuda(x, "fused_layer"):
        return fused_layer_reference(x, p, n_heads=n_heads)
    (B, T, D, Fp), (w,) = _check_launch(x, 0, n_heads, [p])
    out = torch.empty_like(x)
    rc = _entry("layer", x.dtype)(
        x.data_ptr(), _ptr_array(w), out.data_ptr(), B, T, D, n_heads, Fp,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "fused_layer")
    fused_layer.launches += 1
    return out


fused_layer_prefix.launches = 0
fused_layers_prefix_group.launches = 0
fused_layer_with_prefix.launches = 0
fused_layer.launches = 0
