// What the flash kernels on `wgmma` share: flash_attention_wide.cu's
// (tile width 128: the forward and the backward in both dtypes) and
// flash_attention_f32.cu's (tile width 64: the f32 forward and backward).
// 64-row tiles of bf16 8 x 8 core matrices, the f32 operands split into bf16
// hi and lo parts, the products (S = Q K^T from shared memory; P or dS as a
// register A operand against an MN-major B), the forward's online-softmax
// step over one 64-key tile and its end (lse, and the f32 output straight
// from the accumulator fragments), and the tensor maps of the bulk tensor
// copies.
// The functions that depend on the tile width take it as their first
// template argument, HDP (64 or 128): a core-matrix tile of one part is
// ROWS x HDP bf16, and an operand's lo part starts that far past its hi part.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention.cuh"
#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int ROWS = 64;             // rows of a tile: one wgmma M, one key tile
constexpr int WG = 128;              // threads of a warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Element (r, c) of a core-matrix tile: the 8-column chunk c / 8 holds the
// 64 rows' 16-byte pieces one after another, so a core matrix (8 rows of one
// chunk) is 128 contiguous bytes; K-major operands (Q, K as B of Q K^T) have
// LBO 1024 and SBO 128 bytes, a k16 step starting 1024 elements further, and
// the MN-major B of P V (V [key, hd]) has LBO 128 and SBO 1024, a k16 step
// (16 keys) starting 128 elements further.
__device__ __forceinline__ int cm(int r, int c) { return (c >> 3) * (ROWS * 8) + r * 8 + (c & 7); }

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x0, x1) as the bf16 pairs hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void split_bf2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf2(x0 - hf.x, x1 - hf.y);
}

// Named barrier of one warpgroup (ids 1 and up; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG) : "memory");
}

__host__ __device__ constexpr int n_tiles(int T) { return (T + ROWS - 1) / ROWS; }

// ---- products -------------------------------------------------------------
// acc[0:N/2] = A[64, hdp] . B[N, hdp]^T, both core-matrix tiles at their
// first row (NS = 2: hi at the pointer, lo ROWS * HDP further; hi.hi +
// lo.hi + hi.lo; kSw: the width-128 bf16 swizzled layout). Issued and
// committed, not waited for.
template <int HDP, int NS, int N, bool kSw = false>
__device__ __forceinline__ void issue_abt(float (&acc)[N / 2], const bf16* A, const bf16* B,
                                          int nks) {
  constexpr int LO = ROWS * HDP;
#pragma unroll
  for (int k = 0; k < HDP / 16; ++k) {
    if (k < nks) {
      const int at = (k >> 2) * (ROWS * 64) + (k & 3) * 16;
      const uint64_t da = kSw ? hopper::smem_desc_sw128(A + at, 16, 1024)
                              : hopper::smem_desc(A + k * 1024, 1024, 128);
      const uint64_t db = kSw ? hopper::smem_desc_sw128(B + at, 16, 1024)
                              : hopper::smem_desc(B + k * 1024, 1024, 128);
      hopper::wgmma<N>(acc, da, db, k > 0);
      if constexpr (NS == 2) {
        hopper::wgmma<N>(acc, hopper::smem_desc(A + LO + k * 1024, 1024, 128), db, 1);
        hopper::wgmma<N>(acc, da, hopper::smem_desc(B + LO + k * 1024, 1024, 128), 1);
      }
    }
  }
  hopper::wgmma_commit();
}

// The k16 A fragments (NS parts) of the 64 x 16 KS accumulator x (P or
// dS), rounded to bf16 as operands: fragment kk covers columns 16 kk .. + 15.
template <int NS, int KS>
__device__ __forceinline__ void pack_frags(uint32_t (&f)[NS][KS][4], const float (&x)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 8 * kk + 4 * (i >> 1) + 2 * (i & 1);   // d[4 j + 2 u], j = 2 kk + i / 2
      if constexpr (NS == 1)
        f[0][kk][i] = pack_bf2(x[e], x[e + 1]);
      else
        split_bf2(x[e], x[e + 1], f[0][kk][i], f[1][kk][i]);
    }
}

// acc[0:HDP/2] += X[64, 16 KS] . B[16 KS, HDP] with X in registers
// (fragments f) and B the core-matrix tile rows at B (the product's K) read
// MN-major.
template <int HDP, int NS, int KS, bool kSw = false>
__device__ __forceinline__ void issue_xb(float (&acc)[HDP / 2], uint32_t (&f)[NS][KS][4],
                                         const bf16* B) {
  constexpr int LO = ROWS * HDP;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t db = kSw ? hopper::smem_desc_sw128(B + kk * 1024, 8192, 1024)
                            : hopper::smem_desc(B + kk * 128, 128, 1024);
    hopper::wgmma_rs<HDP, 1>(acc, f[0][kk], db, 1);
    if constexpr (NS == 2) {
      hopper::wgmma_rs<HDP, 1>(acc, f[1][kk], db, 1);
      hopper::wgmma_rs<HDP, 1>(acc, f[0][kk], hopper::smem_desc(B + LO + kk * 128, 128, 1024),
                               1);
    }
  }
  hopper::wgmma_commit();
}

// ---- output ---------------------------------------------------------------
// Rows [0, nrows) of this warpgroup's 64 x 2N accumulator (times mul[u] on
// rows g + 8 u) to the f32 [nrows, hd] rows at dst, straight from the
// fragments (a warp's store covers eight rows of 32 bytes, whole sectors).
template <int N>
__device__ __forceinline__ void store_tile(float* dst, const float (&acc)[N],
                                           const float (&mul)[2], int nrows, int hd, int t) {
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = 16 * warp + g + 8 * u, c = 8 * j + 2 * q4;
      if (r < nrows && c < hd) {
        float* p = dst + static_cast<size_t>(r) * hd + c;
        const float x0 = acc[4 * j + 2 * u] * mul[u], x1 = acc[4 * j + 2 * u + 1] * mul[u];
        if ((hd & 1) == 0) {
          *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
        } else {
          p[0] = x0;
          if (c + 1 < hd) p[1] = x1;
        }
      }
    }
}

// ---- the forward's step and end -------------------------------------------
// One 64-key tile kt of the online softmax for this warpgroup's query tile
// qt (q: its core-matrix tile, NS parts; k, v: the key tile's): S = Q K^T on
// wgmma, the mask (only on the ragged or diagonal tile), one row-max update
// and one rescale of O, P into registers, O += P V. Thread rows g and
// g + 8 of its warp's 16; m in log2 units, l this thread's share of the sum.
template <int HDP, int NS, bool kSw>
__device__ __forceinline__ void fwd_step(float (&o)[HDP / 2], float (&m)[2], float (&l)[2],
                                         const bf16* q, const bf16* k, const bf16* v, int nks,
                                         int kt, int qt, int T, bool causal, float scale2,
                                         int warp, int g, int q4) {
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  hopper::wgmma_fence();
  issue_abt<HDP, NS, 64, kSw>(s, q, k, nks);
  hopper::wgmma_wait<0>();
  hopper::fence_regs<32>(s);
  // every row keeps key kt * 64 (< T; and <= the row when causal, since kt <= qt)
  const bool edge = (kt + 1) * ROWS > T || (causal && kt == qt);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int u = (i >> 1) & 1;
    const int key = kt * ROWS + 8 * (i >> 2) + 2 * q4 + (i & 1);
    const int row = qt * ROWS + 16 * warp + g + 8 * u;
    const bool ok = !edge || (key < T && (!causal || key <= row));
    s[i] = ok ? s[i] * scale2 : -INFINITY;
    mx[u] = fmaxf(mx[u], s[i]);
  }
  float alpha[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
    mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
    const float m_new = fmaxf(m[u], mx[u]);
    alpha[u] = exp2f(m[u] - m_new);   // 0 on the first tile (m = -inf)
    m[u] = m_new;
    l[u] *= alpha[u];
  }
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int u = (i >> 1) & 1;
    s[i] = exp2f(s[i] - m[u]);   // P; masked scores give 0
    l[u] += s[i];
  }
  uint32_t pf[NS][4][4];
  pack_frags<NS, 4>(pf, s);
  hopper::fence_regs<HDP / 2>(o);
  hopper::wgmma_fence();
  issue_xb<HDP, NS, 4, kSw>(o, pf, v);
  hopper::wgmma_wait<0>();
  hopper::fence_regs<HDP / 2>(o);
}

// The end of a query tile's forward: l summed over a row's four lanes,
// lse = m + log(l) (natural log) for the rows < T, and inv = 1 / l, the
// sum clamped at 1e-30 as in the JAX kernel (:73,75), for rows g, g + 8.
template <typename E>
__device__ __forceinline__ void fwd_lse(const FwdArgs<E>& a, float (&inv)[2], float (&l)[2],
                                        const float (&m)[2], int qt, size_t rbase, int t) {
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
    const float lc = fmaxf(l[u], 1e-30f);
    inv[u] = 1.f / lc;
    const int row = qt * ROWS + 16 * warp + g + 8 * u;
    if (q4 == 0 && row < a.T) a.lse[rbase + row] = m[u] * LN2 + logf(lc);
  }
}

// f32: lse, and o / l out to the tile's rows straight from the fragments.
template <int HDP>
__device__ __forceinline__ void fwd_end(const FwdArgs<float>& a, float (&o)[HDP / 2],
                                        float (&m)[2], float (&l)[2], int qt, size_t rbase,
                                        int t) {
  float inv[2];
  fwd_lse(a, inv, l, m, qt, rbase, t);
  store_tile(a.o + (rbase + static_cast<size_t>(qt) * ROWS) * a.hd, o, inv,
             min(ROWS, a.T - qt * ROWS), a.hd, t);
}

// ---- tensor maps (host) -----------------------------------------------------
// cuTensorMapEncodeTiled from the driver, through the runtime (no link
// against the driver library).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static void* fn = nullptr;
  if (!fn) {
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &res) !=
            cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      fn = nullptr;
  }
  return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
}

// The tensor map of a [BH, T, hd] tensor of `type` (elem bytes each; rows a
// multiple of 16 bytes) in boxes of `cols` x ROWS elements with the 128-byte
// swizzle (cols * elem == 128): elements past T and past hd read as zeros.
// False on an error.
bool tile_map(CUtensorMap* m, CUtensorMapDataType type, int elem, int cols, const void* p,
              int BH, int T, int hd) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * elem,
                                 static_cast<cuuint64_t>(T) * hd * elem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols), ROWS, 1}, steps[3] = {1, 1, 1};
  return encode(m, type, 3, const_cast<void*>(p), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16 (hd % 8 == 0) in 64 x 64 boxes; f32 (hd % 4 == 0) in 32-column boxes.
bool bf16_map(CUtensorMap* m, const void* p, int BH, int T, int hd) {
  return tile_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 64, p, BH, T, hd);
}
bool f32_map(CUtensorMap* m, const void* p, int BH, int T, int hd) {
  return tile_map(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 32, p, BH, T, hd);
}

}  // namespace
