// Flash attention at tile width 128 (padded head dims 80-128) on Hopper
// `wgmma`: the forward (TPU kernel B5, `_flash_forward` / `_flash_kernel`,
// beso_tpu/ops/flash_attention.py:34-75, 269-308) and the backward (TPU
// kernel B6, `_flash_attention_bwd` :182-259: the dQ kernel `_bwd_dq_kernel`
// :78-109 with delta (:212-214), call :221, and the dK/dV kernel
// `_bwd_dkv_kernel` :112-153, call :240), each in bf16 and f32. The width-64
// kernels are in flash_attention.cu (bf16) and flash_attention_f32.cu (f32);
// flash_attention.cu's launchers call these above it. What both `wgmma`
// sources share, the forward's online-softmax step and end among it, is
// flash_wgmma.cuh.
//
// Layout and numerics as in flash_attention.cu: q, k, v, o, dO, dq, dk, dv
// [B*H, T, hd] contiguous, lse and delta [B*H, T] f32, lse of the scaled
// scores; f32 operands as bf16 hi + lo pairs with three products each
// (hi.hi + lo.hi + hi.lo, f32 accumulation); no atomics, so every result is
// the same bit for bit from launch to launch.
//
// What bounds them on the H100: at [256, 3, 131, 128] the bf16 forward
// moves ~103 MB (0.031 ms at 3.35 TB/s) for ~3.4 GFLOP (about 33 operations
// per byte against the card's ~295), so bytes and latency bound it, not the
// tensor cores. The `mma.sync` template at width 128 spent, per warp, ~7,000
// cycles per 64-key tile on dependent 16-key chains, ~6,800 cycles waiting
// for its first tiles and ~6,800 storing its output with 4-byte stores, with
// 8-12 warps per SM (4 in f32) to hide any of it (PERF.md §6, the clock). And
// per-thread `cp.async` copies keep only a few tens of KB in flight per SM:
// a block that issues its tiles that way spends most of its life issuing.
// What the design does about it:
// - One warpgroup per 64-row tile on `wgmma`: S = Q K^T is one asynchronous
//   chain of m64nNk16 products (Q and K from shared memory, K-major), with
//   one row-max update and one rescale of O per 64-key tile; P (or dS)
//   stays in registers as the A operand of the next product (O += P V,
//   dQ += dS K, dV += P^T dO, dK += dS^T Q), whose B is read MN-major
//   through the descriptor's transpose bit. A 64-key tile costs a few
//   hundred cycles of products instead of four dependent chains per warp.
// - bf16 forward: one query tile per block, K/V through a ring of three
//   stages, so at T <= 192 every key tile is in flight at once. Where rows
//   are 16-byte aligned (hd % 8 == 0), thread 0 fills the ring with bulk
//   tensor copies (TMA: 64 x 64 boxes in the 128-byte swizzle that `wgmma`
//   reads, out-of-bounds rows and columns zero-filled) on mbarriers; else
//   all threads copy into the same layout with `cp.async`. Two blocks per
//   SM.
// - bf16 backward, the same copies: the bound at [256, 3, 131, 128] is
//   bytes, ~155 MB per launch of either kernel (q, k, v, o, dO in and dq
//   out, or q, k, v, dO in and dk, dv out, with lse and delta: 0.0464 ms at
//   3.35 TB/s), for 5.1 GFLOP (dQ) or 6.8 (dK/dV) of causal products, 33-44
//   operations per byte. The dQ kernel keeps a query tile's Q and dO
//   and streams K/V two stages deep on two warpgroups, each taking half of
//   every key tile, two blocks per SM; delta comes from O and dO read once
//   from global memory while the first tiles land. The dK/dV kernel keeps a
//   key tile's K and V and streams Q, dO, lse and delta two stages deep on
//   one warpgroup (dK and dV, 128 accumulator registers, in one warpgroup:
//   no exchange of sums), two blocks per SM. One product per step where
//   the `mma.sync` template ran 16-key chains per warp; whole 64-row tiles
//   at the ragged edge (at T = 131 the last tile's 3 rows cost a full
//   tile's products, which the tensor cores have to spare).
// - f32: the f32 tiles land by 16-byte `cp.async` in an f32 staging buffer
//   (rows padded to 132 floats: conflict-free reads) while the previous
//   tile computes, and all threads split them into hi/lo tiles of 8 x 8
//   core matrices after. Blocks of two warpgroups: the forward pairs query
//   tiles p and n - 1 - p of a (b, h) (even causal work, each K/V tile read
//   once for both); the dQ kernel keeps a query tile's Q and dO and streams
//   K and V, the dK/dV kernel keeps a key tile's K and V and streams Q, dO,
//   lse and delta, each warpgroup taking half of every streamed tile (two
//   m64n32 products) and the two halves' sums added at the end in a fixed
//   order. That is 8 warps per SM where the `mma.sync` kernels held 4.
// - Outputs: bf16 through shared memory (rows padded by 16 bytes, so the
//   fragment writes are conflict-free) and out with 16-byte stores; f32
//   straight from the fragments (a warp's store covers whole 32-byte
//   sectors).
// - The ragged edge and the causal diagonal are masked in the kernels on
//   64-row tiles: key tiles above the diagonal are skipped; V rows past T
//   are zero (P = 0 times garbage could be NaN); q and k rows past T only
//   reach rows or masked columns that are never kept.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention.cuh"
#include "flash_wgmma.cuh"
#include "hopper.cuh"

namespace {

constexpr int MAX_HDP = 128;
constexpr int TILE = ROWS * MAX_HDP; // bf16 elements of a [64, 128] core-matrix tile
constexpr int MAX_PITCH = MAX_HDP + 4;   // f32 staging row, in floats (conflict-free reads)
constexpr int STAGE_F32 = ROWS * MAX_PITCH;   // floats of one staged f32 tile

// Element (r, c) of a 128-byte-swizzle tile (the bf16 forward's layout, as
// a bulk tensor copy writes it): two boxes of 64 columns, 8 KB each, rows
// of 128 bytes, 16-byte chunk j of row r at chunk j ^ (r % 8). K-major
// operands: SBO 1024 bytes, a k16 step 32 bytes further (the next box
// from step 4 on); the MN-major B of P V: LBO 8192 (the next box), SBO 1024,
// a k16 step (16 keys) 2048 bytes further.
__device__ __forceinline__ int sw(int r, int c) {
  return (c >> 6) * (ROWS * 64) + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// ---- copies into shared memory ------------------------------------------
// Rows [0, nrows) of a bf16 [*, hd] source into the swizzled tile dst,
// columns [0, hdp), for head dims whose rows are not 16-byte aligned (the
// bulk tensor copies take the others); columns >= hd zero, and rows >=
// nrows zero if `tail`, else not written (their products only reach rows or
// masked columns of the result that are never kept; V's must be zero: P = 0
// times garbage could be NaN). kBytes-wide `cp.async` copies (hd a multiple
// of kBytes / 2), eight consecutive indices on eight consecutive rows of one
// column, which the swizzle spreads over the banks; the index math is on
// the fixed width MAX_HDP (shifts, no division), columns >= hdp skipped.
template <int kBytes>
__device__ __forceinline__ void copy_rows_async(bf16* dst, const bf16* src, int nrows, int hd,
                                                int hdp, bool tail, int t, int nt) {
  constexpr int EPC = kBytes / 2, CPR = MAX_HDP / EPC;
  for (int i = t; i < ROWS * CPR; i += nt) {
    const int j = i >> 3, r = (i & 7) + (j / CPR) * 8, c = (j % CPR) * EPC;
    if (c >= hdp || (!tail && r >= nrows)) continue;
    const bool ok = r < nrows && c < hd;
    hopper::cp_async<kBytes>(dst + sw(r, c), ok ? src + static_cast<size_t>(r) * hd + c : src,
                             ok ? kBytes : 0);
  }
}

__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int nrows, int hd, int hdp,
                                          bool tail, int t, int nt) {
  if ((hd & 3) == 0) {
    copy_rows_async<8>(dst, src, nrows, hd, hdp, tail, t, nt);
  } else if ((hd & 1) == 0) {
    copy_rows_async<4>(dst, src, nrows, hd, hdp, tail, t, nt);
  } else {   // odd hd: no aligned copy size, plain loads
    for (int i = t; i < (tail ? ROWS : min(nrows, ROWS)) * hdp; i += nt) {
      const int r = i / hdp, c = i - r * hdp;
      dst[sw(r, c)] = r < nrows && c < hd ? src[static_cast<size_t>(r) * hd + c]
                                          : __float2bfloat16(0.f);
    }
  }
}

// Rows [0, nrows) of an f32 [*, hd] source into the f32 staging tile dst
// (row pitch MAX_PITCH floats), columns [0, hdp), zero-filled past nrows and
// hd; row-major indices, so both sides are contiguous.
template <int kBytes>
__device__ __forceinline__ void stage_rows_async(float* dst, const float* src, int nrows, int hd,
                                                 int hdp, int t, int nt) {
  constexpr int EPC = kBytes / 4, CPR = MAX_HDP / EPC;
  for (int i = t; i < ROWS * CPR; i += nt) {
    const int r = i / CPR, c = (i % CPR) * EPC;
    if (c >= hdp) continue;
    const bool ok = r < nrows && c < hd;
    hopper::cp_async<kBytes>(dst + r * MAX_PITCH + c,
                             ok ? src + static_cast<size_t>(r) * hd + c : src, ok ? kBytes : 0);
  }
}

__device__ __forceinline__ void stage_rows(float* dst, const float* src, int nrows, int hd, int hdp,
                                           int t, int nt) {
  if ((hd & 3) == 0)
    stage_rows_async<16>(dst, src, nrows, hd, hdp, t, nt);
  else if ((hd & 1) == 0)
    stage_rows_async<8>(dst, src, nrows, hd, hdp, t, nt);
  else
    stage_rows_async<4>(dst, src, nrows, hd, hdp, t, nt);
}

// The staged f32 tile as its hi part (core-matrix tile at dst) and its lo
// part (at dst + TILE): eight lanes in a row write one core matrix.
__device__ __forceinline__ void split_staged(bf16* dst, const float* src, int hdp, int t, int nt) {
  constexpr int CPR = MAX_HDP / 8;
  for (int i = t; i < ROWS * CPR; i += nt) {
    const int j = i >> 3, c8 = j % CPR, r = (i & 7) + (j / CPR) * 8;
    if (8 * c8 >= hdp) continue;
    const float4 x0 = *reinterpret_cast<const float4*>(src + r * MAX_PITCH + 8 * c8);
    const float4 x1 = *reinterpret_cast<const float4*>(src + r * MAX_PITCH + 8 * c8 + 4);
    uint4 hi, lo;
    split_bf2(x0.x, x0.y, hi.x, lo.x);
    split_bf2(x0.z, x0.w, hi.y, lo.y);
    split_bf2(x1.x, x1.y, hi.z, lo.z);
    split_bf2(x1.z, x1.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(dst + cm(r, 8 * c8)) = hi;
    *reinterpret_cast<uint4*>(dst + TILE + cm(r, 8 * c8)) = lo;
  }
}

// ---- output ---------------------------------------------------------------
// bf16 rows [0, nrows) of this warpgroup's 64 x 128 accumulator (times
// mul[u] on rows g + 8 u) to the [nrows, hd] rows at dst (the f32 form is
// flash_wgmma.cuh's): through `buf` (this warpgroup's shared memory, 64 (hd + 8)
// elements), rows padded by 16 bytes where hd % 8 == 0 so that the
// fragment writes are free of bank conflicts, then out with 16-byte stores
// (scalar stores for other hd, where the rows are not 16-byte aligned); only
// columns [c0, c1) (multiples of 8), where a warpgroup stores part of a tile.
__device__ __forceinline__ void store_tile(bf16* dst, const float (&acc)[64],
                                           const float (&mul)[2], bf16* buf, int nrows, int hd,
                                           int t, int wg, int c0 = 0, int c1 = MAX_HDP) {
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q4 = lane & 3;
  const bool vec = (hd & 7) == 0;
  const int pitch = vec ? hd + 8 : hd;
  c1 = min(c1, hd);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = 16 * warp + g + 8 * u, c = 8 * j + 2 * q4;
      if (r < nrows && c >= c0 && c < c1) {
        bf16* p = buf + r * pitch + c;
        const float x0 = acc[4 * j + 2 * u] * mul[u], x1 = acc[4 * j + 2 * u + 1] * mul[u];
        if ((hd & 1) == 0) {
          *reinterpret_cast<uint32_t*>(p) = pack_bf2(x0, x1);
        } else {
          p[0] = __float2bfloat16(x0);
          if (c + 1 < hd) p[1] = __float2bfloat16(x1);
        }
      }
    }
  wg_sync(wg);
  if (vec) {   // 16-byte chunk c8 of row r; rows 16-byte aligned
    for (int i = t; i < ROWS * (MAX_HDP / 8); i += WG) {
      const int r = i >> 4, c = 8 * (i & 15);
      if (r < nrows && c >= c0 && c < c1)
        *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * hd + c) =
            *reinterpret_cast<const uint4*>(buf + r * pitch + c);
    }
  } else {
    for (int i = t; i < nrows * hd; i += WG) {
      const int c = i % hd;
      if (c >= c0 && c < c1) dst[i] = buf[i];
    }
  }
}

// ---------------------------------------------------------------------------
// B5, forward, bf16: grid B*H * n for n = ceil(T / 64) query tiles, a (b, h)'s
// tiles adjacent (they share its K/V in L2); block = one warpgroup on one
// query tile, with K/V through a ring of FWD_STAGES stages (at T <= 192
// every key tile in flight at once). kTma (hd % 8 == 0, rows 16-byte
// aligned): thread 0 fills each stage with four bulk tensor copies
// (64 x 64 boxes, 128-byte swizzle, out-of-bounds rows and columns
// zero-filled) completing on the stage's mbarrier; the copies then cost the
// other threads nothing and the bytes in flight are bounded only by the
// ring (per-thread `cp.async` copies stalled at a few tens of KB in flight
// per SM). Else all threads copy with `cp.async` into the same swizzled
// layout, one commit group per stage.
// ---------------------------------------------------------------------------
constexpr int FWD_STAGES = 3;
constexpr size_t FWD_BF16_RING = sizeof(bf16) * (1 + 2 * FWD_STAGES) * TILE;   // q, ring
constexpr size_t FWD_BF16_SMEM = FWD_BF16_RING + sizeof(uint64_t) * (FWD_STAGES + 1);

struct FwdMaps {   // the tensor maps of q, k, v as [B*H, T, hd]
  CUtensorMap q, k, v;
};

template <bool kTma>
__global__ void __launch_bounds__(WG, 2) flash_fwd_wide_bf16_kernel(
    const __grid_constant__ FwdMaps maps, const FwdArgs<bf16> a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = qs + TILE;   // stage s: K at ring + 2 s TILE, V TILE further
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + FWD_BF16_RING);   // the stages', then q's
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, q4 = lane & 3;
  const int T = a.T, hd = a.hd, hdp = a.hdp;
  const int n = n_tiles(T), qt = blockIdx.x % n, bh = blockIdx.x / n;
  const int nkt = a.causal ? qt + 1 : n;
  const size_t rbase = static_cast<size_t>(bh) * T, base = rbase * hd;
  if (hopper::smem_u32(smem) & 1023) __trap();   // the swizzle atoms need 1024-byte alignment

  if constexpr (kTma) {
    if (t == 0) {
      for (int i = 0; i <= FWD_STAGES; ++i) hopper::mbar_init(&full[i], 1);
      hopper::fence_mbar_init();
    }
    __syncthreads();
  }
  auto fill = [&](int kt) {   // key tile kt into its stage
    bf16* st = ring + (kt % FWD_STAGES) * 2 * TILE;
    if constexpr (kTma) {
      if (t == 0 && kt < nkt) {
        uint64_t* bar = &full[kt % FWD_STAGES];
        hopper::mbar_arrive_expect_tx(bar, 4 * sizeof(bf16) * ROWS * 64);
        for (int b = 0; b < 2; ++b) {
          hopper::tma_load_3d(st + b * ROWS * 64, &maps.k, 64 * b, kt * ROWS, bh, bar);
          hopper::tma_load_3d(st + TILE + b * ROWS * 64, &maps.v, 64 * b, kt * ROWS, bh, bar);
        }
      }
    } else {
      if (kt < nkt) {
        const size_t off = base + static_cast<size_t>(kt) * ROWS * hd;
        copy_rows(st, a.k + off, T - kt * ROWS, hd, hdp, false, t, WG);
        copy_rows(st + TILE, a.v + off, T - kt * ROWS, hd, hdp, true, t, WG);
      }
      hopper::cp_async_commit();   // one group per stage, empty past the last tile
    }
  };
  if constexpr (kTma) {
    if (t == 0) {
      hopper::mbar_arrive_expect_tx(&full[FWD_STAGES], 2 * sizeof(bf16) * ROWS * 64);
      for (int b = 0; b < 2; ++b)
        hopper::tma_load_3d(qs + b * ROWS * 64, &maps.q, 64 * b, qt * ROWS, bh, &full[FWD_STAGES]);
    }
  } else {
    copy_rows(qs, a.q + base + static_cast<size_t>(qt) * ROWS * hd, T - qt * ROWS, hd, hdp,
                    false, t, WG);   // joins the first stage's group
  }
  for (int s = 0; s < FWD_STAGES; ++s) fill(s);

  const float scale2 = a.scale * LOG2E;
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < nkt; ++kt) {
    if constexpr (kTma) {
      if (kt == 0) hopper::mbar_wait(&full[FWD_STAGES], 0);
      hopper::mbar_wait(&full[kt % FWD_STAGES], (kt / FWD_STAGES) & 1);
    } else {
      hopper::cp_async_wait<FWD_STAGES - 1>();   // tile kt has landed
      hopper::fence_proxy_async();
      __syncthreads();
    }
    const bf16* st = ring + (kt % FWD_STAGES) * 2 * TILE;
    fwd_step<MAX_HDP, 1, true>(o, m, l, qs, st, st + TILE, hdp >> 4, kt, qt, T, a.causal, scale2,
                               warp, g, q4);
    __syncthreads();   // everyone is done with this stage before it is refilled
    fill(kt + FWD_STAGES);
  }
  float inv[2];
  fwd_lse(a, inv, l, m, qt, rbase, t);
  wg_sync(0);   // out through the q tile and the ring, once every product is done with them
  store_tile(a.o + (rbase + static_cast<size_t>(qt) * ROWS) * a.hd, o, inv, qs,
             min(ROWS, a.T - qt * ROWS), a.hd, t, 0);
}

// ---------------------------------------------------------------------------
// B5, forward, f32: grid B*H * ceil(n / 2); block (b, h, p) = two warpgroups,
// warpgroup 0 on query tile p and warpgroup 1 on tile n - 1 - p (none if
// that is p), sharing every K/V tile up to the later one's diagonal. The f32
// K/V tile kt + 1 is staged while tile kt computes on its hi/lo split.
// ---------------------------------------------------------------------------
constexpr size_t KV_F32_BYTES = 2 * sizeof(float) * STAGE_F32;   // >= 4 bf16 tiles
// two q tile pairs (hi, lo), K and V hi/lo (before the loop the two staged
// f32 q tiles), the f32 staging of K and V
constexpr size_t FWD_F32_SMEM = sizeof(bf16) * 4 * TILE + 2 * KV_F32_BYTES;

__global__ void __launch_bounds__(2 * WG, 1) flash_fwd_wide_f32_kernel(const FwdArgs<float> a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);        // [2][hi, lo][TILE]: the two query tiles
  bf16* kv = qs + 4 * TILE;                        // K hi, lo, V hi, lo
  float* stg = reinterpret_cast<float*>(smem + sizeof(bf16) * 4 * TILE + KV_F32_BYTES);  // K, V

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & (WG - 1);
  const int warp = t >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int T = a.T, hd = a.hd, hdp = a.hdp;
  const int n = n_tiles(T), np = (n + 1) >> 1, p = blockIdx.x % np;
  const int last = n - 1 - p;                      // the later tile of the pair
  const int qt = wg ? last : p;
  const int nkt = a.causal ? last + 1 : n;         // key tiles the block streams
  const int my_nkt = (wg == 0 || last != p) ? (a.causal ? qt + 1 : n) : 0;
  const size_t rbase = static_cast<size_t>(blockIdx.x / np) * T, base = rbase * hd;

  // prologue: the query tiles staged where K/V hi/lo go, the first K/V tile
  for (int w = 0; w < 2; ++w) {
    const int tq = w ? last : p;
    if (w == 0 || last != p)
      stage_rows(reinterpret_cast<float*>(kv) + w * STAGE_F32,
                 a.q + base + static_cast<size_t>(tq) * ROWS * hd, T - tq * ROWS, hd, hdp, tid,
                 2 * WG);
  }
  stage_rows(stg, a.k + base, T, hd, hdp, tid, 2 * WG);
  stage_rows(stg + STAGE_F32, a.v + base, T, hd, hdp, tid, 2 * WG);
  hopper::cp_async_commit();

  const float scale2 = a.scale * LOG2E;
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < nkt; ++kt) {
    hopper::cp_async_wait<0>();
    __syncthreads();   // tile kt staged; everyone is done with the last hi/lo tiles
    if (kt == 0) {
      for (int w = 0; w < 2; ++w)
        split_staged(qs + 2 * w * TILE, reinterpret_cast<float*>(kv) + w * STAGE_F32, hdp, tid,
                     2 * WG);
      __syncthreads();   // the staged q tiles are read before K/V overwrite them
    }
    split_staged(kv, stg, hdp, tid, 2 * WG);
    split_staged(kv + 2 * TILE, stg + STAGE_F32, hdp, tid, 2 * WG);
    hopper::fence_proxy_async();
    __syncthreads();
    if (kt + 1 < nkt) {
      const size_t off = base + static_cast<size_t>(kt + 1) * ROWS * hd;
      const int rows = T - (kt + 1) * ROWS;
      stage_rows(stg, a.k + off, rows, hd, hdp, tid, 2 * WG);
      stage_rows(stg + STAGE_F32, a.v + off, rows, hd, hdp, tid, 2 * WG);
    }
    hopper::cp_async_commit();
    if (kt < my_nkt) {
      fwd_step<MAX_HDP, 2, false>(o, m, l, qs + 2 * wg * TILE, kv, kv + 2 * TILE, hdp >> 4, kt,
                                  qt, T, a.causal, scale2, warp, g, q4);
      if (kt == my_nkt - 1)   // this warpgroup's last tile
        fwd_end<MAX_HDP>(a, o, m, l, qt, rbase, t);
    }
  }
}

// ---------------------------------------------------------------------------
// B6, f32: one 64-row tile per block of two warpgroups, which split every
// streamed 64-row tile in halves of 32 rows (m64n32 products) and add their
// partial sums at the end (warpgroup 0's plus warpgroup 1's, always in that
// order). Shared memory: three regions of KV_F32_BYTES, the kept hi/lo tiles,
// the streamed hi/lo tiles and the f32 staging of the next streamed pair, and
// the rows' statistics.
// ---------------------------------------------------------------------------
constexpr size_t BWD_SMEM = 3 * KV_F32_BYTES + 4 * ROWS * sizeof(float);

// acc += the other warpgroup's acc, in warpgroup 0 (through buf, 64 x 128
// floats; both warpgroups call it).
__device__ __forceinline__ void add_partials(float (&acc)[64], float* buf, int wg, int t) {
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 64; ++i) buf[i * WG + t] = acc[i];
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += buf[i * WG + t];
  }
}

// The dQ kernel: grid B*H * n; block = query tile qt of a (b, h), keeping Q
// and dO (hi/lo) and streaming the K/V tiles up to the diagonal, warpgroup w
// on keys 32 w .. 32 w + 31 of each. delta = rowsum(dO * O) from the staged
// f32 tiles; dq = (sum_k dS K) * scale.
__global__ void __launch_bounds__(2 * WG, 1) flash_bwd_dq_wide_kernel(const BwdArgs<float> a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* kept = reinterpret_cast<bf16*>(smem);                     // Q hi, lo, dO hi, lo
  bf16* strm = reinterpret_cast<bf16*>(smem + KV_F32_BYTES);      // K hi, lo, V hi, lo
  float* stg = reinterpret_cast<float*>(smem + 2 * KV_F32_BYTES);  // K, V f32
  float* stats = reinterpret_cast<float*>(smem + 3 * KV_F32_BYTES);   // lse2 [64], delta [64]

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & (WG - 1);
  const int warp = t >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int T = a.T, hd = a.hd, hdp = a.hdp, nks = hdp >> 4;
  const int n = n_tiles(T), qt = blockIdx.x % n, q0 = qt * ROWS;
  const int nkt = a.causal ? qt + 1 : n;
  const size_t rbase = static_cast<size_t>(blockIdx.x / n) * T, base = rbase * hd;
  const size_t qoff = base + static_cast<size_t>(q0) * hd;

  // prologue: q and dO staged in the streamed region, o in the kept one, K/V tile 0
  stage_rows(reinterpret_cast<float*>(strm), a.q + qoff, T - q0, hd, hdp, tid, 2 * WG);
  stage_rows(reinterpret_cast<float*>(strm) + STAGE_F32, a.dout + qoff, T - q0, hd, hdp, tid,
             2 * WG);
  stage_rows(reinterpret_cast<float*>(kept), a.o + qoff, T - q0, hd, hdp, tid, 2 * WG);
  stage_rows(stg, a.k + base, T, hd, hdp, tid, 2 * WG);
  stage_rows(stg + STAGE_F32, a.v + base, T, hd, hdp, tid, 2 * WG);
  hopper::cp_async_commit();
  if (tid < ROWS) stats[tid] = q0 + tid < T ? a.lse[rbase + q0 + tid] * LOG2E : 0.f;

  const float scale2 = a.scale * LOG2E;
  float dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;
  float lse2[2], delta[2];   // rows g, g + 8 of this warp's 16
  for (int kt = 0; kt < nkt; ++kt) {
    hopper::cp_async_wait<0>();
    __syncthreads();   // tile kt staged; everyone is done with the last hi/lo tiles
    if (kt == 0) {
      // delta in f32, four threads per row
      const int r = tid >> 2, c0 = (tid & 3) * (hdp >> 2);
      const float* x = reinterpret_cast<const float*>(strm) + STAGE_F32 + r * MAX_PITCH;
      const float* y = reinterpret_cast<const float*>(kept) + r * MAX_PITCH;
      float d = 0.f;
      for (int c = c0; c < c0 + (hdp >> 2); c += 4) {
        const float4 u = *reinterpret_cast<const float4*>(x + c);
        const float4 w = *reinterpret_cast<const float4*>(y + c);
        d = fmaf(u.x, w.x, d);
        d = fmaf(u.y, w.y, d);
        d = fmaf(u.z, w.z, d);
        d = fmaf(u.w, w.w, d);
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      if ((tid & 3) == 0) {
        stats[ROWS + r] = d;
        if (q0 + r < T) a.delta[rbase + q0 + r] = d;
      }
      __syncthreads();   // o is read: the kept tiles may overwrite it
      split_staged(kept, reinterpret_cast<const float*>(strm), hdp, tid, 2 * WG);
      split_staged(kept + 2 * TILE, reinterpret_cast<const float*>(strm) + STAGE_F32, hdp, tid,
                   2 * WG);
      __syncthreads();   // q and dO are read: K/V may overwrite them
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        lse2[u] = stats[16 * warp + g + 8 * u];
        delta[u] = stats[ROWS + 16 * warp + g + 8 * u];
      }
    }
    split_staged(strm, stg, hdp, tid, 2 * WG);
    split_staged(strm + 2 * TILE, stg + STAGE_F32, hdp, tid, 2 * WG);
    hopper::fence_proxy_async();
    __syncthreads();
    if (kt + 1 < nkt) {
      const size_t off = base + static_cast<size_t>(kt + 1) * ROWS * hd;
      stage_rows(stg, a.k + off, T - (kt + 1) * ROWS, hd, hdp, tid, 2 * WG);
      stage_rows(stg + STAGE_F32, a.v + off, T - (kt + 1) * ROWS, hd, hdp, tid, 2 * WG);
    }
    hopper::cp_async_commit();

    const bf16* kh = strm + 256 * wg;   // this warpgroup's 32 keys (row 32 wg)
    float s[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
    hopper::wgmma_fence();
    issue_abt<MAX_HDP, 2, 32>(s, kept, kh, nks);
    issue_abt<MAX_HDP, 2, 32>(dp, kept + 2 * TILE, kh + 2 * TILE, nks);
    hopper::wgmma_wait<0>();
    hopper::fence_regs<16>(s);
    hopper::fence_regs<16>(dp);
    const bool edge = (kt + 1) * ROWS > T || (a.causal && kt == qt);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int u = (i >> 1) & 1;
      const int key = kt * ROWS + 32 * wg + 8 * (i >> 2) + 2 * q4 + (i & 1);
      const int row = q0 + 16 * warp + g + 8 * u;
      const bool ok = !edge || (key < T && (!a.causal || key <= row));
      const float p = ok ? exp2f(s[i] * scale2 - lse2[u]) : 0.f;
      s[i] = p * (dp[i] - delta[u]);   // dS
    }
    uint32_t dsf[2][2][4];
    pack_frags<2, 2>(dsf, s);
    hopper::fence_regs<64>(dq);
    hopper::wgmma_fence();
    issue_xb<MAX_HDP, 2, 2>(dq, dsf, kh);   // dQ += dS K
    hopper::wgmma_wait<0>();
    hopper::fence_regs<64>(dq);
  }
  __syncthreads();   // every product is done with the streamed and kept tiles
  add_partials(dq, reinterpret_cast<float*>(strm), wg, t);
  if (wg == 0) {
    const float mul[2] = {a.scale, a.scale};
    store_tile(a.dq + qoff, dq, mul, min(ROWS, T - q0), hd, t);
  }
}

// The dK/dV kernel: grid B*H * n; block = key tile kt of a (b, h), keeping K
// and V (hi/lo) and streaming the query tiles from the diagonal on (q, dO,
// lse and delta), warpgroup w on queries 32 w .. 32 w + 31 of each.
// dv = sum_q P^T dO; dk = (sum_q dS^T Q) * scale.
__global__ void __launch_bounds__(2 * WG, 1) flash_bwd_dkv_wide_kernel(const BwdArgs<float> a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* kept = reinterpret_cast<bf16*>(smem);                     // K hi, lo, V hi, lo
  bf16* strm = reinterpret_cast<bf16*>(smem + KV_F32_BYTES);      // Q hi, lo, dO hi, lo
  float* stg = reinterpret_cast<float*>(smem + 2 * KV_F32_BYTES);  // Q, dO f32
  float* cur = reinterpret_cast<float*>(smem + 3 * KV_F32_BYTES);   // lse [64], delta [64]
  float* nxt = cur + 2 * ROWS;                                      // the staged tile's

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & (WG - 1);
  const int warp = t >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int T = a.T, hd = a.hd, hdp = a.hdp, nks = hdp >> 4;
  const int n = n_tiles(T), kt = blockIdx.x % n, k0 = kt * ROWS;
  const int qt0 = a.causal ? kt : 0;   // causal: from the diagonal on
  const size_t rbase = static_cast<size_t>(blockIdx.x / n) * T, base = rbase * hd;
  const size_t koff = base + static_cast<size_t>(k0) * hd;

  auto stage = [&](int qt) {   // q, dO, lse and delta of query tile qt
    const int q0 = qt * ROWS;
    stage_rows(stg, a.q + base + static_cast<size_t>(q0) * hd, T - q0, hd, hdp, tid, 2 * WG);
    stage_rows(stg + STAGE_F32, a.dout + base + static_cast<size_t>(q0) * hd, T - q0, hd, hdp,
               tid, 2 * WG);
    if (tid < 2 * ROWS) {   // lse (threads 0-63) and delta (64-127), 0 past T
      const int i = tid & (ROWS - 1), ok = q0 + i < T;
      const float* src = (tid < ROWS ? a.lse : a.delta) + rbase + (ok ? q0 + i : 0);
      hopper::cp_async<4>(nxt + tid, src, ok ? 4 : 0);
    }
  };
  // prologue: K and V staged in the streamed region, the first query tile
  stage_rows(reinterpret_cast<float*>(strm), a.k + koff, T - k0, hd, hdp, tid, 2 * WG);
  stage_rows(reinterpret_cast<float*>(strm) + STAGE_F32, a.v + koff, T - k0, hd, hdp, tid,
             2 * WG);
  stage(qt0);
  hopper::cp_async_commit();

  const float scale2 = a.scale * LOG2E;
  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  for (int qt = qt0; qt < n; ++qt) {
    hopper::cp_async_wait<0>();
    __syncthreads();   // tile qt staged; everyone is done with the last hi/lo tiles
    if (qt == qt0) {
      split_staged(kept, reinterpret_cast<const float*>(strm), hdp, tid, 2 * WG);
      split_staged(kept + 2 * TILE, reinterpret_cast<const float*>(strm) + STAGE_F32, hdp, tid,
                   2 * WG);
      __syncthreads();   // K and V are read: q and dO may overwrite them
    }
    split_staged(strm, stg, hdp, tid, 2 * WG);
    split_staged(strm + 2 * TILE, stg + STAGE_F32, hdp, tid, 2 * WG);
    if (tid < 2 * ROWS) cur[tid] = nxt[tid];
    hopper::fence_proxy_async();
    __syncthreads();
    if (qt + 1 < n) stage(qt + 1);
    hopper::cp_async_commit();

    const bf16* qh = strm + 256 * wg;   // this warpgroup's 32 queries (row 32 wg)
    float s[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
    hopper::wgmma_fence();
    issue_abt<MAX_HDP, 2, 32>(s, kept, qh, nks);                      // S^T = K Q^T
    issue_abt<MAX_HDP, 2, 32>(dp, kept + 2 * TILE, qh + 2 * TILE, nks);   // dP^T = V dO^T
    hopper::wgmma_wait<0>();
    hopper::fence_regs<16>(s);
    hopper::fence_regs<16>(dp);
    const bool edge = (qt + 1) * ROWS > T || (a.causal && qt == kt);
    float ds[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int qc = 32 * wg + 8 * (i >> 2) + 2 * q4 + (i & 1);   // query column in the tile
      const int qi = qt * ROWS + qc, key = k0 + 16 * warp + g + 8 * ((i >> 1) & 1);
      // mask p, not s: padded query columns would give exp(s - 0) != 0
      const bool ok = !edge || (qi < T && (!a.causal || qi >= key));
      const float p = ok ? exp2f(s[i] * scale2 - cur[qc] * LOG2E) : 0.f;
      ds[i] = p * (dp[i] - cur[ROWS + qc]);
      s[i] = p;
    }
    uint32_t f[2][2][4];
    pack_frags<2, 2>(f, s);
    hopper::fence_regs<64>(dv);
    hopper::wgmma_fence();
    issue_xb<MAX_HDP, 2, 2>(dv, f, qh + 2 * TILE);   // dV += P^T dO
    hopper::wgmma_wait<0>();
    hopper::fence_regs<64>(dv);
    pack_frags<2, 2>(f, ds);
    hopper::fence_regs<64>(dk);
    hopper::wgmma_fence();
    issue_xb<MAX_HDP, 2, 2>(dk, f, qh);              // dK += dS^T Q
    hopper::wgmma_wait<0>();
    hopper::fence_regs<64>(dk);
  }
  __syncthreads();   // every product is done with the streamed and kept tiles
  add_partials(dk, reinterpret_cast<float*>(strm), wg, t);
  add_partials(dv, reinterpret_cast<float*>(strm) + ROWS * MAX_HDP, wg, t);
  if (wg == 0) {
    const float mk[2] = {a.scale, a.scale}, mv[2] = {1.f, 1.f};
    const int nrows = min(ROWS, T - k0);
    store_tile(a.dk + koff, dk, mk, nrows, hd, t);
    store_tile(a.dv + koff, dv, mv, nrows, hd, t);
  }
}

// ---------------------------------------------------------------------------
// B6, bf16: the tiles a block keeps and the tiles it streams arrive as the
// bf16 forward's do: kTma (hd % 8 == 0), thread 0 issues bulk tensor copies
// of 64 x 64 boxes in the 128-byte swizzle (rows past T and columns past hd
// zero-filled) on the stage's mbarrier; else all threads copy with
// `cp.async` into the same layout, rows past T zero, one commit group per
// stage. The zeros matter in K and V of the dQ kernel and in Q and dO of
// the dK/dV kernel: B operands of dS K, P^T dO and dS^T Q, where 0 times
// garbage could be NaN.
// The dK/dV kernel's lse and delta come by 4-byte `cp.async` in the same
// groups (their rows are not 16-byte aligned), 0 past T.
// ---------------------------------------------------------------------------
struct BwdMaps {   // the tensor maps of the two kept and the two streamed tensors
  CUtensorMap kept[2], strm[2];
};

// Rows of tile `tile` of the (b, h) at row rbase of x0 and x1 into the two
// swizzled tiles at dst and dst + TILE, rows past T zero (TMA: by thread 0
// from the maps m, counted on `bar`).
template <bool kTma>
__device__ __forceinline__ void load_pair(bf16* dst, const CUtensorMap* m, const bf16* x0,
                                          const bf16* x1, int tile, int bh, size_t rbase,
                                          const BwdArgs<bf16>& a, uint64_t* bar, int tid,
                                          int nt) {
  if constexpr (kTma) {
    if (tid == 0) {
      hopper::mbar_arrive_expect_tx(bar, 4 * sizeof(bf16) * ROWS * 64);
      for (int b = 0; b < 2; ++b) {
        hopper::tma_load_3d(dst + b * ROWS * 64, &m[0], 64 * b, tile * ROWS, bh, bar);
        hopper::tma_load_3d(dst + TILE + b * ROWS * 64, &m[1], 64 * b, tile * ROWS, bh, bar);
      }
    }
  } else {
    const size_t off = (rbase + static_cast<size_t>(tile) * ROWS) * a.hd;
    copy_rows(dst, x0 + off, a.T - tile * ROWS, a.hd, a.hdp, true, tid, nt);
    copy_rows(dst + TILE, x1 + off, a.T - tile * ROWS, a.hd, a.hdp, true, tid, nt);
  }
}

// The dQ kernel: grid B*H * n, the query tiles of a (b, h) adjacent and the
// last (most key tiles) first; block = two warpgroups on query tile qt,
// keeping Q and dO and streaming K/V through DQ_STAGES stages, warpgroup w
// on keys 32 w .. 32 w + 31 of each (S = Q K^T and dP = dO V^T as m64n32
// products from shared memory, dQ += dS K with dS in registers and K read
// MN-major). delta = rowsum(dO * O) in f32 from O and dO in global memory
// (16-byte loads where rows are aligned) while the first tiles land. The
// warpgroups' sums meet once: each gives the other the 64-column half it
// stores (a + b == b + a bit for bit, so both halves are fixed-order sums).
// Two stages, not the forward's three: 96 KB of tiles and 128 registers let
// two blocks (16 warps) share an SM, so one block's copies overlap the
// other's products; three stages (128 KB) would leave one. The cp.async
// form (hd % 8 != 0) asks for one block per SM: its copy loops spill at 128
// registers.
constexpr int DQ_STAGES = 2;
constexpr size_t DQ_TILES = sizeof(bf16) * (2 + 2 * DQ_STAGES) * TILE;   // Q, dO, K/V stages
constexpr size_t DQ_SMEM = DQ_TILES + sizeof(float) * 2 * ROWS + sizeof(uint64_t) * (DQ_STAGES + 1);
constexpr int STORE_BUF = ROWS * (MAX_HDP + 8);   // bf16 elements of one store_tile buffer

template <bool kTma>
__global__ void __launch_bounds__(2 * WG, kTma ? 2 : 1) flash_bwd_dq_wide_bf16_kernel(
    const __grid_constant__ BwdMaps maps, const BwdArgs<bf16> a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* kept = reinterpret_cast<bf16*>(smem);   // Q, dO
  bf16* ring = kept + 2 * TILE;                 // stage s: K at ring + 2 s TILE, V TILE further
  float* stats = reinterpret_cast<float*>(smem + DQ_TILES);   // lse2 [64], delta [64]
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + 2 * ROWS);   // the stages', then Q/dO's
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & (WG - 1);
  const int warp = t >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int T = a.T, hd = a.hd, nks = a.hdp >> 4;
  const int n = n_tiles(T), qt = n - 1 - blockIdx.x % n, bh = blockIdx.x / n, q0 = qt * ROWS;
  const int nkt = a.causal ? qt + 1 : n;
  const size_t rbase = static_cast<size_t>(bh) * T, qoff = (rbase + q0) * hd;
  if (hopper::smem_u32(smem) & 1023) __trap();   // the swizzle atoms need 1024-byte alignment

  if constexpr (kTma) {
    if (tid == 0) {
      for (int i = 0; i <= DQ_STAGES; ++i) hopper::mbar_init(&full[i], 1);
      hopper::fence_mbar_init();
    }
    __syncthreads();
  }
  auto fill = [&](int kt) {   // key tile kt into its stage
    if (kt < nkt)
      load_pair<kTma>(ring + (kt % DQ_STAGES) * 2 * TILE, maps.strm, a.k, a.v, kt, bh, rbase, a,
                      &full[kt % DQ_STAGES], tid, 2 * WG);
    if constexpr (!kTma) hopper::cp_async_commit();   // one group per stage, empty past the last
  };
  load_pair<kTma>(kept, maps.kept, a.q, a.dout, qt, bh, rbase, a, &full[DQ_STAGES], tid,
                  2 * WG);   // cp.async: joins the first stage's group
  for (int s = 0; s < DQ_STAGES; ++s) fill(s);

  {   // delta in f32, four threads per row, while the copies fly; lse in log2 units
    const int r = tid >> 2, j = tid & 3;
    float d = 0.f;
    if (q0 + r < T) {
      const bf16* x = a.dout + qoff + static_cast<size_t>(r) * hd;
      const bf16* y = a.o + qoff + static_cast<size_t>(r) * hd;
      if ((hd & 7) == 0) {
        for (int c = 8 * j; c < hd; c += 32) {
          const uint4 u = *reinterpret_cast<const uint4*>(x + c);
          const uint4 w = *reinterpret_cast<const uint4*>(y + c);
          const uint32_t uu[4] = {u.x, u.y, u.z, u.w}, ww[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 fu = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&uu[e]));
            const float2 fw = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ww[e]));
            d = fmaf(fu.x, fw.x, d);
            d = fmaf(fu.y, fw.y, d);
          }
        }
      } else {
        for (int c = j; c < hd; c += 4) d = fmaf(__bfloat162float(x[c]), __bfloat162float(y[c]), d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (j == 0) {
      stats[ROWS + r] = d;
      if (q0 + r < T) a.delta[rbase + q0 + r] = d;
    }
    if (tid < ROWS) stats[tid] = q0 + tid < T ? a.lse[rbase + q0 + tid] * LOG2E : 0.f;
  }
  if constexpr (!kTma) {
    hopper::cp_async_wait<DQ_STAGES - 1>();   // Q, dO and key tile 0 have landed
    hopper::fence_proxy_async();
  }
  __syncthreads();   // the rows' statistics (and the cp.async tiles) are visible
  float lse2[2], delta[2];   // rows g, g + 8 of this warp's 16
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    lse2[u] = stats[16 * warp + g + 8 * u];
    delta[u] = stats[ROWS + 16 * warp + g + 8 * u];
  }

  const float scale2 = a.scale * LOG2E;
  float dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    if constexpr (kTma) {
      if (kt == 0) hopper::mbar_wait(&full[DQ_STAGES], 0);
      hopper::mbar_wait(&full[kt % DQ_STAGES], (kt / DQ_STAGES) & 1);
    }
    const bf16* kh = ring + (kt % DQ_STAGES) * 2 * TILE + 32 * 64 * wg;   // this warpgroup's keys
    const bf16* vh = kh + TILE;
    float s[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
    hopper::wgmma_fence();
    issue_abt<MAX_HDP, 1, 32, true>(s, kept, kh, nks);          // S = Q K^T
    issue_abt<MAX_HDP, 1, 32, true>(dp, kept + TILE, vh, nks);  // dP = dO V^T
    hopper::wgmma_wait<0>();
    hopper::fence_regs<16>(s);
    hopper::fence_regs<16>(dp);
    const bool edge = (kt + 1) * ROWS > T || (a.causal && kt == qt);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int u = (i >> 1) & 1;
      const int key = kt * ROWS + 32 * wg + 8 * (i >> 2) + 2 * q4 + (i & 1);
      const int row = q0 + 16 * warp + g + 8 * u;
      const bool ok = !edge || (key < T && (!a.causal || key <= row));
      const float p = ok ? exp2f(s[i] * scale2 - lse2[u]) : 0.f;
      s[i] = p * (dp[i] - delta[u]);   // dS
    }
    uint32_t f[1][2][4];
    pack_frags<1, 2>(f, s);
    hopper::fence_regs<64>(dq);
    hopper::wgmma_fence();
    issue_xb<MAX_HDP, 1, 2, true>(dq, f, kh);   // dQ += dS K
    hopper::wgmma_wait<0>();
    hopper::fence_regs<64>(dq);
    if constexpr (!kTma) {
      hopper::cp_async_wait<DQ_STAGES - 2>();   // key tile kt + 1 has landed
      hopper::fence_proxy_async();
    }
    __syncthreads();   // everyone is done with this stage before it is refilled
    fill(kt + DQ_STAGES);
  }
  // warpgroup w stores columns 64 w .. 64 w + 63: it gives the other half
  // away through the ring (32 x WG floats per warpgroup) and adds the other's
  float* xbuf = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int i = 0; i < 32; ++i) xbuf[(32 * wg + i) * WG + t] = wg ? dq[i] : dq[32 + i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float x = xbuf[(32 * (1 - wg) + i) * WG + t];
    if (wg)
      dq[32 + i] += x;
    else
      dq[i] += x;
  }
  __syncthreads();   // the exchange is read: the store buffers may overwrite it
  const float mul[2] = {a.scale, a.scale};
  store_tile(a.dq + qoff, dq, mul, ring + wg * STORE_BUF, min(ROWS, T - q0), hd, t, wg, 64 * wg,
             64 * wg + 64);
}

// The dK/dV kernel: grid B*H * n; block = one warpgroup on key tile kt of a
// (b, h), keeping K and V and streaming the query tiles from the diagonal on
// (Q, dO, lse, delta) through DKV_STAGES stages, each in two halves of 32
// queries: S^T = K Q^T and dP^T = V dO^T as m64n32 products from shared
// memory, then dV += P^T dO and dK += dS^T Q with P and dS in registers and
// Q, dO read MN-major (a half wholly past T is skipped). dv = sum_q P^T dO,
// dk = (sum_q dS^T Q) * scale. One warpgroup holds dK and dV (128
// registers), so no sums are exchanged; at up to 255 registers two blocks
// (97.5 KB each with two stages) share an SM, and one block's copies
// overlap the other's products. Two warpgroups splitting each tile would
// hold the same 8 warps per SM in one block (256 threads at > 128
// registers), idle while it waits for its copies; three stages would leave
// one block per SM.
constexpr int DKV_STAGES = 2;
constexpr size_t DKV_TILES = sizeof(bf16) * (2 + 2 * DKV_STAGES) * TILE;   // K, V, Q/dO stages
constexpr size_t DKV_SMEM =
    DKV_TILES + sizeof(float) * 2 * ROWS * DKV_STAGES + sizeof(uint64_t) * (DKV_STAGES + 1);

template <bool kTma>
__global__ void __launch_bounds__(WG, 2) flash_bwd_dkv_wide_bf16_kernel(
    const __grid_constant__ BwdMaps maps, const BwdArgs<bf16> a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* kept = reinterpret_cast<bf16*>(smem);   // K, V
  bf16* ring = kept + 2 * TILE;                 // stage s: Q at ring + 2 s TILE, dO TILE further
  float* stats = reinterpret_cast<float*>(smem + DKV_TILES);   // stage s: lse [64], delta [64]
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + 2 * ROWS * DKV_STAGES);   // stages, K/V
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, q4 = lane & 3;
  const int T = a.T, hd = a.hd, nks = a.hdp >> 4;
  const int n = n_tiles(T), kt = blockIdx.x % n, bh = blockIdx.x / n, k0 = kt * ROWS;
  const int qt0 = a.causal ? kt : 0, nq = n - qt0;   // causal: from the diagonal on
  const size_t rbase = static_cast<size_t>(bh) * T, koff = (rbase + k0) * hd;
  if (hopper::smem_u32(smem) & 1023) __trap();

  if constexpr (kTma) {
    if (t == 0) {
      for (int i = 0; i <= DKV_STAGES; ++i) hopper::mbar_init(&full[i], 1);
      hopper::fence_mbar_init();
    }
    __syncthreads();
  }
  auto fill = [&](int j) {   // query tile qt0 + j into stage j % DKV_STAGES
    if (j < nq) {
      const int slot = j % DKV_STAGES, q0 = (qt0 + j) * ROWS;
      load_pair<kTma>(ring + slot * 2 * TILE, maps.strm, a.q, a.dout, qt0 + j, bh, rbase, a,
                      &full[slot], t, WG);
      // lse (threads 0-63) and delta (64-127), 0 past T
      const int i = t & (ROWS - 1), ok = q0 + i < T;
      const float* src = (t < ROWS ? a.lse : a.delta) + rbase + (ok ? q0 + i : 0);
      hopper::cp_async<4>(stats + slot * 2 * ROWS + t, src, ok ? 4 : 0);
    }
    hopper::cp_async_commit();   // one group per stage, empty past the last
  };
  load_pair<kTma>(kept, maps.kept, a.k, a.v, kt, bh, rbase, a, &full[DKV_STAGES], t,
                  WG);   // cp.async: joins the first stage's group
  for (int s = 0; s < DKV_STAGES; ++s) fill(s);
  hopper::cp_async_wait<DKV_STAGES - 1>();   // the first tile's lse and delta (cp.async: K, V, Q, dO)
  if constexpr (!kTma) hopper::fence_proxy_async();
  __syncthreads();

  const float scale2 = a.scale * LOG2E;
  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  for (int j = 0; j < nq; ++j) {
    const int qt = qt0 + j, slot = j % DKV_STAGES;
    if constexpr (kTma) {
      if (j == 0) hopper::mbar_wait(&full[DKV_STAGES], 0);
      hopper::mbar_wait(&full[slot], (j / DKV_STAGES) & 1);
    }
    const float* st = stats + slot * 2 * ROWS;
    const bool edge = (qt + 1) * ROWS > T || (a.causal && qt == kt);
    for (int h = 0; h < 2; ++h) {
      if (qt * ROWS + 32 * h >= T) break;   // a half wholly past T
      const bf16* qh = ring + slot * 2 * TILE + 32 * 64 * h;   // its 32 queries
      const bf16* doh = qh + TILE;
      float s[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
      hopper::wgmma_fence();
      issue_abt<MAX_HDP, 1, 32, true>(s, kept, qh, nks);           // S^T = K Q^T
      issue_abt<MAX_HDP, 1, 32, true>(dp, kept + TILE, doh, nks);  // dP^T = V dO^T
      hopper::wgmma_wait<0>();
      hopper::fence_regs<16>(s);
      hopper::fence_regs<16>(dp);
      float ds[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int qc = 32 * h + 8 * (i >> 2) + 2 * q4 + (i & 1);   // query column in the tile
        const int qi = qt * ROWS + qc, key = k0 + 16 * warp + g + 8 * ((i >> 1) & 1);
        // mask p, not s: padded query columns would give exp(s - 0) != 0
        const bool ok = !edge || (qi < T && (!a.causal || qi >= key));
        const float p = ok ? exp2f(s[i] * scale2 - st[qc] * LOG2E) : 0.f;
        ds[i] = p * (dp[i] - st[ROWS + qc]);
        s[i] = p;
      }
      uint32_t fp[1][2][4], fd[1][2][4];
      pack_frags<1, 2>(fp, s);
      pack_frags<1, 2>(fd, ds);
      hopper::fence_regs<64>(dv);
      hopper::fence_regs<64>(dk);
      hopper::wgmma_fence();
      issue_xb<MAX_HDP, 1, 2, true>(dv, fp, doh);   // dV += P^T dO
      issue_xb<MAX_HDP, 1, 2, true>(dk, fd, qh);    // dK += dS^T Q
      hopper::wgmma_wait<0>();
      hopper::fence_regs<64>(dv);
      hopper::fence_regs<64>(dk);
    }
    hopper::cp_async_wait<DKV_STAGES - 2>();   // tile j + 1's lse and delta (cp.async: and tiles)
    if constexpr (!kTma) hopper::fence_proxy_async();
    __syncthreads();   // everyone is done with this stage before it is refilled
    fill(j + DKV_STAGES);
  }
  const float mk[2] = {a.scale, a.scale}, mv[2] = {1.f, 1.f};
  const int nrows = min(ROWS, T - k0);
  store_tile(a.dk + koff, dk, mk, ring, nrows, hd, t, 0);
  store_tile(a.dv + koff, dv, mv, ring + STORE_BUF, nrows, hd, t, 0);
}

}  // namespace

// Entries for flash_attention.cu's launchers (flash_attention.cuh).
int flash_wide_fwd(const FwdArgs<float>& a, int BH, void* stream) {
  return hopper::launch(flash_fwd_wide_f32_kernel, FWD_F32_SMEM, BH * ((n_tiles(a.T) + 1) / 2),
                        2 * WG, stream, a);
}

int flash_wide_fwd(const FwdArgs<bf16>& a, int BH, void* stream) {
  FwdMaps maps = {};
  if (a.hd % 8)   // rows not 16-byte aligned: no tensor map, cp.async copies
    return hopper::launch(flash_fwd_wide_bf16_kernel<false>, FWD_BF16_SMEM, BH * n_tiles(a.T), WG,
                          stream, maps, a);
  if (!bf16_map(&maps.q, a.q, BH, a.T, a.hd) || !bf16_map(&maps.k, a.k, BH, a.T, a.hd) ||
      !bf16_map(&maps.v, a.v, BH, a.T, a.hd))
    return static_cast<int>(cudaErrorInvalidValue);
  return hopper::launch(flash_fwd_wide_bf16_kernel<true>, FWD_BF16_SMEM, BH * n_tiles(a.T), WG,
                        stream, maps, a);
}

// The f32 backward: dQ with delta, then dK/dV.
int flash_wide_bwd_dq(const BwdArgs<float>& a, int BH, void* stream) {
  return hopper::launch(flash_bwd_dq_wide_kernel, BWD_SMEM, BH * n_tiles(a.T), 2 * WG, stream, a);
}

int flash_wide_bwd_dkv(const BwdArgs<float>& a, int BH, void* stream) {
  return hopper::launch(flash_bwd_dkv_wide_kernel, BWD_SMEM, BH * n_tiles(a.T), 2 * WG, stream,
                        a);
}

// The bf16 backward: the tensor maps of the kept and the streamed tensors
// where rows are 16-byte aligned (a failed encode returns an error, no
// other path), else the cp.async form.
int flash_wide_bwd_dq(const BwdArgs<bf16>& a, int BH, void* stream) {
  BwdMaps maps = {};
  const int blocks = BH * n_tiles(a.T);
  if (a.hd % 8)
    return hopper::launch(flash_bwd_dq_wide_bf16_kernel<false>, DQ_SMEM, blocks, 2 * WG, stream,
                          maps, a);
  if (!bf16_map(&maps.kept[0], a.q, BH, a.T, a.hd) ||
      !bf16_map(&maps.kept[1], a.dout, BH, a.T, a.hd) ||
      !bf16_map(&maps.strm[0], a.k, BH, a.T, a.hd) || !bf16_map(&maps.strm[1], a.v, BH, a.T, a.hd))
    return static_cast<int>(cudaErrorInvalidValue);
  return hopper::launch(flash_bwd_dq_wide_bf16_kernel<true>, DQ_SMEM, blocks, 2 * WG, stream, maps,
                        a);
}

int flash_wide_bwd_dkv(const BwdArgs<bf16>& a, int BH, void* stream) {
  BwdMaps maps = {};
  const int blocks = BH * n_tiles(a.T);
  if (a.hd % 8)
    return hopper::launch(flash_bwd_dkv_wide_bf16_kernel<false>, DKV_SMEM, blocks, WG, stream,
                          maps, a);
  if (!bf16_map(&maps.kept[0], a.k, BH, a.T, a.hd) ||
      !bf16_map(&maps.kept[1], a.v, BH, a.T, a.hd) ||
      !bf16_map(&maps.strm[0], a.q, BH, a.T, a.hd) ||
      !bf16_map(&maps.strm[1], a.dout, BH, a.T, a.hd))
    return static_cast<int>(cudaErrorInvalidValue);
  return hopper::launch(flash_bwd_dkv_wide_bf16_kernel<true>, DKV_SMEM, blocks, WG, stream, maps,
                        a);
}

int flash_wide_blocks_per_sm(int which, int f32) {
  if (which == 0)
    return f32 ? hopper::blocks_per_sm(flash_fwd_wide_f32_kernel, FWD_F32_SMEM, 2 * WG)
               : hopper::blocks_per_sm(flash_fwd_wide_bf16_kernel<true>, FWD_BF16_SMEM, WG);
  if (f32)
    return hopper::blocks_per_sm(
        which == 1 ? flash_bwd_dq_wide_kernel : flash_bwd_dkv_wide_kernel, BWD_SMEM, 2 * WG);
  return which == 1
             ? hopper::blocks_per_sm(flash_bwd_dq_wide_bf16_kernel<true>, DQ_SMEM, 2 * WG)
             : hopper::blocks_per_sm(flash_bwd_dkv_wide_bf16_kernel<true>, DKV_SMEM, WG);
}
