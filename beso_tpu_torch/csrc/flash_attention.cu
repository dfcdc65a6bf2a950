// Causal flash attention on Hopper: the forward (TPU kernel B5,
// `_flash_forward` / `_flash_kernel`, beso_tpu/ops/flash_attention.py:34-75,
// 269-308) and the FlashAttention-2 backward (TPU kernel B6,
// `_flash_attention_bwd`, :182-259, bodies `_bwd_dq_kernel` :78-109 and
// `_bwd_dkv_kernel` :112-153): one kernel for dQ over key tiles, one for
// dK/dV over query tiles, so no block reduces across blocks, nothing is
// written twice and the result is deterministic (no atomics).
//
// Layout: q, k, v, o, dO, dq, dk, dv [B*H, T, hd] bf16, contiguous (the
// JAX layout [B, H, T, hd]); lse and delta [B*H, T] f32. lse is the
// logsumexp of the SCALED scores s = (q . k) / sqrt(hd). delta =
// rowsum(dO * O) (the JAX package computes it outside Pallas, :212-214) is
// computed by the dQ kernel, which uses it and writes it for the dK/dV
// kernel, so a backward is exactly two launches.
//
// The forward (B5): wmma bf16 16x16x16 products with f32 accumulation;
// each warp stages its score tiles in shared memory, where two lanes per
// row apply the mask and the online softmax. The running sum l is clamped
// at 1e-30 as in the JAX kernel (:73,75), so a fully masked row gives 0.
//
// The backward (B6). What bounds it: at the chunked training shape
// [256, 6, 131, 60] a launch reads ~24 MB per tensor and its products take
// ~5 us at the tensor cores' peak, so it is bound by bytes and latency, not
// by the tensor cores; `wgmma` is not the lever (its 64-row tiles would
// also compute more of the ragged edge). What the design does about it:
// - Fragments stay in registers. Each warp owns 16 rows (queries in the dQ
//   kernel, keys in the dK/dV kernel) and walks the streamed tile in chunks
//   of 16 with `mma.sync` m16n8k16 (bf16, f32 accumulation): S = Q K^T and
//   dP = dO V^T (or S^T = K Q^T and dP^T = V dO^T) as accumulator
//   fragments, P = exp(S scale - lse) and dS = P (dP - delta) on them in
//   f32, then the two n8 accumulator tiles repacked into one k16 A operand
//   (rounded to bf16 only there, as operand of the next product) for
//   dQ += dS K, or dV += P^T dO and dK += dS^T Q, the B operand through
//   `ldmatrix.trans`. No score tile touches shared memory.
// - Streamed tiles (K/V, or Q/dO with their lse and delta) come in by
//   `cp.async`, two stages deep: the next tile loads while this one
//   computes. Rows are hd * 2 bytes (120 at hd = 60), so only 8-byte copies
//   (hd % 4 == 0) or 4-byte ones (hd even) are aligned; their source size
//   zero-fills the pad columns [hd, hdp) and the rows >= T. Odd hd takes
//   plain loads.
// - The ragged edge and the diagonal are skipped at 16-row granularity: a
//   warp whose rows all lie at or beyond T does no products (it still
//   copies and meets the barriers), and a warp skips the chunks wholly
//   above the diagonal; only chunks that straddle T or the diagonal are
//   masked. At T = 131 each kernel computes 11,520 (query, key) pairs per
//   (b, h) instead of the 24,576 of whole 64 x 64 tiles.
// - Occupancy: with no f32 staging a block holds its own tile(s) and two
//   stages (dQ 46,080 bytes, the q/dO/o region reused as stage 1; dK/dV
//   56,320 bytes), four 128-thread blocks per SM at <= 128 registers.
// Padded rows get lse = 0 and zero q/k, so their p is finite; the dK/dV
// kernel masks p (not s) for query columns >= T, as the JAX kernel does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TILE = 64;            // query (or key) rows per block and per streamed tile
constexpr int WARPS = 4;            // each warp owns 16 rows of the block's tile
constexpr int THREADS = WARPS * 32;
constexpr int MAX_HDP = 64;         // padded head dim, multiple of 16
constexpr int NT_D = MAX_HDP / 16;  // head-dim column tiles (k16 steps) at most
constexpr int NT_D8 = MAX_HDP / 8;  // head-dim n8 tiles at most
constexpr int LDH = MAX_HDP + 8;    // bf16 row stride of [TILE, hdp] tiles (144 bytes)
constexpr int LDT = TILE + 8;       // bf16 row stride of a warp's [16, TILE] tiles
constexpr int LDF = TILE + 4;       // f32 row stride of a warp's [16, TILE] staging
constexpr float LOG2E = 1.4426950408889634f;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Args {  // forward
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;
  int T, hd, hdp, causal;
  float scale;
};

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;     // forward output (dQ kernel: delta)
  const bf16* dout;
  const float* lse;
  float* delta;      // written by the dQ kernel, read by the dK/dV kernel
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int T, hd, hdp, causal;
  int vec;           // bytes per tile copy: 8 (hd % 4 == 0), 4 (hd even), 2 (plain loads)
  float scale;
};

__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Copy `nrows` rows of `hd` bf16 (contiguous, row stride hd) into a
// [TILE, LDH] shared tile; rows >= nrows and columns [hd, hdp) are zero.
__device__ void load_tile(bf16* dst, const bf16* src, int nrows, int hd, int hdp,
                          int tid) {
  if ((hd & 3) == 0) {  // 8-byte copies: row offsets stay 8-byte aligned
    const int vpr = hd >> 2, vld = hdp >> 2;
    for (int i = tid; i < TILE * vld; i += THREADS) {
      const int r = i / vld, c = i - r * vld;
      uint2 val = make_uint2(0u, 0u);
      if (r < nrows && c < vpr)
        val = *reinterpret_cast<const uint2*>(src + static_cast<size_t>(r) * hd + c * 4);
      *reinterpret_cast<uint2*>(dst + r * LDH + c * 4) = val;
    }
    return;
  }
  for (int i = tid; i < TILE * hdp; i += THREADS) {
    const int r = i / hdp, c = i - r * hdp;
    dst[r * LDH + c] = (r < nrows && c < hd) ? src[static_cast<size_t>(r) * hd + c] : f2bf(0.f);
  }
}

// load_tile as kBytes asynchronous copies (completing in the caller's
// commit group), the source size zero-filling rows >= nrows and columns
// [hd, hdp).
template <int kBytes>
__device__ __forceinline__ void copy_tile_async(bf16* dst, const bf16* src, int nrows, int hd,
                                                int hdp, int tid) {
  constexpr int E = kBytes / 2;  // bf16 per copy
  const int per_row = hdp / E, real = hd / E;
  for (int i = tid; i < TILE * per_row; i += THREADS) {
    const int r = i / per_row, c = i - r * per_row;
    const bool ok = r < nrows && c < real;
    hopper::cp_async<kBytes>(dst + r * LDH + c * E,
                             ok ? src + static_cast<size_t>(r) * hd + c * E : src,
                             ok ? kBytes : 0);
  }
}

__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src, int nrows, const BwdArgs& a,
                                          int tid) {
  if (a.vec == 8)
    copy_tile_async<8>(dst, src, nrows, a.hd, a.hdp, tid);
  else if (a.vec == 4)
    copy_tile_async<4>(dst, src, nrows, a.hd, a.hdp, tid);
  else
    load_tile(dst, src, nrows, a.hd, a.hdp, tid);  // odd hd: no aligned copy size
}

// out[16, TILE] (f32, ld LDF) = A[16, hdp] . B[TILE, hdp]^T, with A the
// warp's rows of a [*, LDH] tile and B a whole [TILE, LDH] tile.
__device__ __forceinline__ void rows_times_tile_t(float* out, const bf16* a, const bf16* b,
                                                  int ksteps) {
#pragma unroll
  for (int n = 0; n < TILE / 16; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < ksteps; ++kk) {
      FragA fa;
      FragBc fb;
      wmma::load_matrix_sync(fa, a + kk * 16, LDH);
      wmma::load_matrix_sync(fb, b + n * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, LDF, wmma::mem_row_major);
  }
}

// acc[n] += A[16, TILE] . B[TILE, hdp] for the head-dim column tiles
// n < ntd, with A a warp's [16, LDT] tile and B a [TILE, LDH] tile.
__device__ __forceinline__ void acc_tile_times(FragC (&acc)[NT_D], const bf16* a,
                                               const bf16* b, int ntd) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, LDT);
#pragma unroll
    for (int n = 0; n < NT_D; ++n) {
      if (n < ntd) {
        FragBr fb;
        wmma::load_matrix_sync(fb, b + kk * 16 * LDH + n * 16, LDH);
        wmma::mma_sync(acc[n], fa, fb, acc[n]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B5: forward. grid (B*H, ceil(T / TILE)); block = one 64-row query tile.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);        // [TILE, LDH]
  bf16* ks = qs + TILE * LDH;                      // [TILE, LDH]
  bf16* vs = ks + TILE * LDH;                      // [TILE, LDH]
  bf16* ps = vs + TILE * LDH;                      // [WARPS, 16, LDT]
  float* st = reinterpret_cast<float*>(ps + WARPS * 16 * LDT);  // [WARPS, 16, LDF]
  float* os = st + WARPS * 16 * LDF;               // [WARPS, 16, LDF] running output

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int T = a.T, hd = a.hd, hdp = a.hdp;
  const int qt = blockIdx.y, q0 = qt * TILE;
  const size_t base = static_cast<size_t>(blockIdx.x) * T * hd;
  load_tile(qs, a.q + base + static_cast<size_t>(q0) * hd, min(TILE, T - q0), hd, hdp, tid);

  bf16* pw = ps + warp * 16 * LDT;
  float* sw = st + warp * 16 * LDF;
  float* ow = os + warp * 16 * LDF;
  const int r = lane >> 1, c0 = (lane & 1) * 32;  // this lane's row and column half
  const int qrow = q0 + warp * 16 + r;
  const int c1 = min(c0 + 32, hdp);  // this lane's head-dim columns [c0, c1)
  for (int c = c0; c < c1; ++c) ow[r * LDF + c] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int n_all = (T + TILE - 1) / TILE;
  const int nkt = a.causal ? min(n_all, qt + 1) : n_all;  // causal: up to the diagonal
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_tile(ks, a.k + base + static_cast<size_t>(k0) * hd, min(TILE, T - k0), hd, hdp, tid);
    load_tile(vs, a.v + base + static_cast<size_t>(k0) * hd, min(TILE, T - k0), hd, hdp, tid);
    __syncthreads();

    rows_times_tile_t(sw, qs + warp * 16 * LDH, ks, hdp / 16);
    __syncwarp();
    float sv[32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + c0 + j;
      const bool ok = key < T && (!a.causal || key <= qrow);
      sv[j] = ok ? sw[r * LDF + c0 + j] * a.scale : -INFINITY;
      mx = fmaxf(mx, sv[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = m == -INFINITY ? 0.f : expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = sv[j] == -INFINITY ? 0.f : expf(sv[j] - m_new);
      sum += p;
      pw[r * LDT + c0 + j] = f2bf(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();

    FragC acc[NT_D];
#pragma unroll
    for (int n = 0; n < NT_D; ++n) wmma::fill_fragment(acc[n], 0.f);
    acc_tile_times(acc, pw, vs, hdp / 16);
#pragma unroll
    for (int n = 0; n < NT_D; ++n)
      if (n < hdp / 16) wmma::store_matrix_sync(sw + n * 16, acc[n], LDF, wmma::mem_row_major);
    __syncwarp();
    for (int c = c0; c < c1; ++c) ow[r * LDF + c] = ow[r * LDF + c] * alpha + sw[r * LDF + c];
    __syncwarp();
  }

  if (qrow < T) {
    const float lc = fmaxf(l, 1e-30f);
    bf16* orow = a.o + base + static_cast<size_t>(qrow) * hd;
    for (int c = c0; c < min(c0 + 32, hd); ++c) orow[c] = f2bf(ow[r * LDF + c] / lc);
    if (c0 == 0) a.lse[static_cast<size_t>(blockIdx.x) * T + qrow] = m + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// B6 helpers on m16n8k16 fragments (hopper.cuh): with g = lane / 4 and
// q4 = lane % 4, an accumulator pair c[j][0:4] over 16 rows x 16 columns
// holds rows g (i < 2) and g + 8 (i >= 2) at columns 8 j + 2 q4 + i % 2.
// ---------------------------------------------------------------------------

// c[0:2][0:4] = A . B^T over the head dim, for 16 rows (A: the warp's A
// fragments, one per k16 step) against the 16 rows of `b` (a [*, LDH]
// shared tile at the chunk's first row).
__device__ __forceinline__ void rows_times_chunk_t(float (&c)[2][4], uint32_t (&af)[NT_D][4],
                                                   const bf16* b, int nks, int lane) {
  const bf16* row = b + ((lane & 7) + ((lane >> 4) << 3)) * LDH + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < NT_D; ++kk) {
    if (kk < nks) {
      uint32_t bf[4];   // columns 0-7 of the chunk, then 8-15
      hopper::ldmatrix_x4<false>(bf, row + kk * 16);
      hopper::mma_16816(c[0], af[kk], bf);
      hopper::mma_16816(c[1], af[kk], bf + 2);
    }
  }
}

// c[0:2][0:4] = A . B^T as above, with A the warp's 16 rows of the shared
// tile `a` (at its first row), one k16 step at a time.
__device__ __forceinline__ void smem_rows_times_chunk_t(float (&c)[2][4], const bf16* a,
                                                        const bf16* b, int nks, int lane) {
  const bf16* arow = a + (lane & 15) * LDH + (lane >> 4) * 8;
  const bf16* brow = b + ((lane & 7) + ((lane >> 4) << 3)) * LDH + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < NT_D; ++kk) {
    if (kk < nks) {
      uint32_t af[4], bf[4];
      hopper::ldmatrix_x4<false>(af, arow + kk * 16);
      hopper::ldmatrix_x4<false>(bf, brow + kk * 16);
      hopper::mma_16816(c[0], af, bf);
      hopper::mma_16816(c[1], af, bf + 2);
    }
  }
}

// acc[0 : hdp / 8] += P . B, with P the 16 x 16 A fragment `pf` and B the
// chunk's 16 rows of `b` (a [*, LDH] shared tile at the chunk's first row),
// through ldmatrix.trans.
__device__ __forceinline__ void acc_chunk_times(float (&acc)[NT_D8][4], uint32_t (&pf)[4],
                                                const bf16* b, int nks, int lane) {
  const bf16* row = b + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDH + (lane >> 4) * 8;
#pragma unroll
  for (int t = 0; t < NT_D8; t += 2) {
    if (t < 2 * nks) {
      uint32_t bf[4];   // head-dim columns 8 t .. 8 t + 7, then 8 t + 8 ..
      hopper::ldmatrix_x4<true>(bf, row + 8 * t);
      hopper::mma_16816(acc[t], pf, bf);
      hopper::mma_16816(acc[t + 1], pf, bf + 2);
    }
  }
}

// The warp's 16 rows of a [*, LDH] shared tile as A fragments over the
// head dim.
__device__ __forceinline__ void load_rows(uint32_t (&af)[NT_D][4], const bf16* rows, int nks,
                                          int lane) {
  const bf16* row = rows + (lane & 15) * LDH + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NT_D; ++kk)
    if (kk < nks) hopper::ldmatrix_x4<false>(af[kk], row + kk * 16);
}

// Rows r0 + g and r0 + g + 8 (< T) of a [*, hd] bf16 output <- acc * mul.
__device__ __forceinline__ void store_rows(bf16* out, float (&acc)[NT_D8][4], float mul,
                                           int r0, const BwdArgs& a, int lane) {
  const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int t = 0; t < NT_D8; ++t) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int row = r0 + g + 8 * u, col = 8 * t + 2 * q4;
      if (t < 2 * (a.hdp >> 4) && row < a.T && col < a.hd) {
        bf16* p = out + static_cast<size_t>(row) * a.hd + col;
        const float x0 = acc[t][2 * u] * mul, x1 = acc[t][2 * u + 1] * mul;
        if ((a.hd & 1) == 0) {
          *reinterpret_cast<uint32_t*>(p) = pack_bf2(x0, x1);
        } else {
          p[0] = f2bf(x0);
          if (col + 1 < a.hd) p[1] = f2bf(x1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B6, dQ (and delta): grid B*H * ceil(T / TILE), a (b, h)'s tiles adjacent
// (they share its K/V in L2); block = one query tile, looping over key
// tiles up to the diagonal. delta = rowsum(dO * O),
// dq = (sum_k dS K) * scale.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS, 4) flash_bwd_dq_kernel(const BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);        // [TILE, LDH] q, dO, o; then stage 1
  bf16* dos = qs + TILE * LDH;
  bf16* os = dos + TILE * LDH;
  auto stage = [&](int i) { return i ? qs : os + TILE * LDH; };  // K [TILE, LDH], then V

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int T = a.T, hd = a.hd, nks = a.hdp >> 4;
  const int n_all = (T + TILE - 1) / TILE, qt = blockIdx.x % n_all;
  const int q0 = qt * TILE, r0 = q0 + 16 * warp;  // r0: this warp's first query row
  const bool active = r0 < T;
  const size_t rbase = static_cast<size_t>(blockIdx.x / n_all) * T, base = rbase * hd;
  const int nkt = a.causal ? qt + 1 : n_all;

  const size_t qoff = base + static_cast<size_t>(q0) * hd;
  copy_tile(qs, a.q + qoff, T - q0, a, tid);
  copy_tile(dos, a.dout + qoff, T - q0, a, tid);
  copy_tile(os, a.o + qoff, T - q0, a, tid);
  hopper::cp_async_commit();
  copy_tile(stage(0), a.k + base, T, a, tid);
  copy_tile(stage(0) + TILE * LDH, a.v + base, T, a, tid);
  hopper::cp_async_commit();
  hopper::cp_async_wait<1>();
  __syncthreads();

  uint32_t qf[NT_D][4], dof[NT_D][4];
  float lse2[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};   // rows g, g + 8; lse2 = lse * log2(e)
  if (active) {
    load_rows(qf, qs + 16 * warp * LDH, nks, lane);
    load_rows(dof, dos + 16 * warp * LDH, nks, lane);
    // delta in f32: lanes 2 i and 2 i + 1 sum halves of row 16 warp + i
    const int rr = 16 * warp + (lane >> 1), c0 = (lane & 1) * 32;
    float d = 0.f;
    for (int c = c0; c < min(c0 + 32, a.hdp); c += 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(dos + rr * LDH + c);
      const uint4 y = *reinterpret_cast<const uint4*>(os + rr * LDH + c);
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 fx = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[j]));
        const float2 fy = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[j]));
        d = fmaf(fx.x, fy.x, d);
        d = fmaf(fx.y, fy.y, d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if ((lane & 1) == 0 && q0 + rr < T) a.delta[rbase + q0 + rr] = d;
    delta[0] = __shfl_sync(0xffffffffu, d, 2 * g);
    delta[1] = __shfl_sync(0xffffffffu, d, 2 * g + 16);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int row = r0 + g + 8 * u;
      lse2[u] = row < T ? a.lse[rbase + row] * LOG2E : 0.f;
    }
  }
  __syncthreads();   // q, dO and o are in registers: stage 1 may overwrite them

  const float scale2 = a.scale * LOG2E;
  float acc[NT_D8][4] = {};
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      const int k1 = (kt + 1) * TILE;
      bf16* st = stage((kt + 1) & 1);
      copy_tile(st, a.k + base + static_cast<size_t>(k1) * hd, T - k1, a, tid);
      copy_tile(st + TILE * LDH, a.v + base + static_cast<size_t>(k1) * hd, T - k1, a, tid);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();   // tile kt has landed
    __syncthreads();
    const bf16* ks = stage(kt & 1);
    const bf16* vs = ks + TILE * LDH;
    if (active) {
      for (int c = 0; c < TILE / 16; ++c) {
        const int kc = kt * TILE + 16 * c;   // the chunk's first key
        if (kc >= T || (a.causal && kc > r0)) break;   // past T, or above the diagonal
        float s[2][4] = {}, dp[2][4] = {};
        rows_times_chunk_t(s, qf, ks + 16 * c * LDH, nks, lane);
        rows_times_chunk_t(dp, dof, vs + 16 * c * LDH, nks, lane);
        const bool edge = kc + 16 > T || (a.causal && kc == r0);
        float ds[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int u = i >> 1, key = kc + 8 * j + 2 * q4 + (i & 1), row = r0 + g + 8 * u;
            const bool ok = !edge || (key < T && (!a.causal || key <= row));
            const float p = ok ? exp2f(s[j][i] * scale2 - lse2[u]) : 0.f;
            ds[j][i] = p * (dp[j][i] - delta[u]);
          }
        uint32_t dsf[4] = {pack_bf2(ds[0][0], ds[0][1]), pack_bf2(ds[0][2], ds[0][3]),
                                 pack_bf2(ds[1][0], ds[1][1]), pack_bf2(ds[1][2], ds[1][3])};
        acc_chunk_times(acc, dsf, ks + 16 * c * LDH, nks, lane);
      }
    }
    __syncthreads();   // everyone is done with this stage before it is refilled
  }
  if (active) store_rows(a.dq + base, acc, a.scale, r0, a, lane);
}

// ---------------------------------------------------------------------------
// B6, dK/dV: grid B*H * ceil(T / TILE), a (b, h)'s tiles adjacent; block =
// one key tile, looping over query tiles from the diagonal on.
// dv = sum_q P^T dO; dk = (sum_q dS^T Q) * scale, which equals the JAX
// kernel's sum against the scaled q (:144,152).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS, 4) flash_bwd_dkv_kernel(const BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);        // [TILE, LDH]
  bf16* vs = ks + TILE * LDH;                      // [TILE, LDH]
  // two stages, each q [TILE, LDH], dO [TILE, LDH], lse [TILE], delta [TILE]
  constexpr int kStage = 2 * TILE * LDH + TILE * 2 * (sizeof(float) / sizeof(bf16));
  auto stage = [&](int i) { return vs + TILE * LDH + i * kStage; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int T = a.T, hd = a.hd, nks = a.hdp >> 4;
  const int nqt = (T + TILE - 1) / TILE, kt = blockIdx.x % nqt;
  const int k0 = kt * TILE, r0 = k0 + 16 * warp;  // r0: this warp's first key
  const bool active = r0 < T;
  const size_t rbase = static_cast<size_t>(blockIdx.x / nqt) * T, base = rbase * hd;
  const int qt0 = a.causal ? kt : 0;  // causal: from the diagonal on

  copy_tile(ks, a.k + base + static_cast<size_t>(k0) * hd, T - k0, a, tid);
  copy_tile(vs, a.v + base + static_cast<size_t>(k0) * hd, T - k0, a, tid);
  hopper::cp_async_commit();
  auto copy_stage = [&](int qt) {
    const int q0 = qt * TILE;
    bf16* st = stage((qt - qt0) & 1);
    copy_tile(st, a.q + base + static_cast<size_t>(q0) * hd, T - q0, a, tid);
    copy_tile(st + TILE * LDH, a.dout + base + static_cast<size_t>(q0) * hd, T - q0, a, tid);
    // lse (threads 0-63) and delta (64-127) of the tile's rows, 0 past T
    float* stat = reinterpret_cast<float*>(st + 2 * TILE * LDH);
    const int i = tid & (TILE - 1), ok = q0 + i < T;
    const float* src = (tid < TILE ? a.lse : a.delta) + rbase + (ok ? q0 + i : 0);
    hopper::cp_async<4>(stat + tid, src, ok ? 4 : 0);
  };
  copy_stage(qt0);
  hopper::cp_async_commit();

  const float scale2 = a.scale * LOG2E;
  float dk[NT_D8][4] = {}, dv[NT_D8][4] = {};
  for (int qt = qt0; qt < nqt; ++qt) {
    if (qt + 1 < nqt) copy_stage(qt + 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();   // k, v and tile qt have landed
    __syncthreads();
    const bf16* qs = stage((qt - qt0) & 1);
    const bf16* dos = qs + TILE * LDH;
    const float* lse_s = reinterpret_cast<const float*>(dos + TILE * LDH);
    const float* delta_s = lse_s + TILE;
    if (active) {
      // causal: on the diagonal tile, the chunks before this warp's keys are above it
      for (int c = (a.causal && qt == kt) ? warp : 0; c < TILE / 16; ++c) {
        const int qc = qt * TILE + 16 * c;   // the chunk's first query
        if (qc >= T) break;
        float s[2][4] = {}, dp[2][4] = {};
        smem_rows_times_chunk_t(s, ks + 16 * warp * LDH, qs + 16 * c * LDH, nks, lane);
        smem_rows_times_chunk_t(dp, vs + 16 * warp * LDH, dos + 16 * c * LDH, nks, lane);
        const bool edge = qc + 16 > T || (a.causal && qc == r0);
        float p[2][4], ds[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 16 * c + 8 * j + 2 * q4;   // this thread's query columns col, col + 1
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
          const float2 d2 = *reinterpret_cast<const float2*>(delta_s + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = i & 1, qi = qc + 8 * j + 2 * q4 + e, key = r0 + g + 8 * (i >> 1);
            // mask p, not s: padded query columns would give exp(s - 0) != 0
            const bool ok = !edge || (qi < T && (!a.causal || qi >= key));
            p[j][i] = ok ? exp2f(s[j][i] * scale2 - (e ? l2.y : l2.x) * LOG2E) : 0.f;
            ds[j][i] = p[j][i] * (dp[j][i] - (e ? d2.y : d2.x));
          }
        }
        uint32_t pf[4] = {pack_bf2(p[0][0], p[0][1]), pack_bf2(p[0][2], p[0][3]),
                                pack_bf2(p[1][0], p[1][1]), pack_bf2(p[1][2], p[1][3])};
        uint32_t dsf[4] = {pack_bf2(ds[0][0], ds[0][1]), pack_bf2(ds[0][2], ds[0][3]),
                                 pack_bf2(ds[1][0], ds[1][1]), pack_bf2(ds[1][2], ds[1][3])};
        acc_chunk_times(dv, pf, dos + 16 * c * LDH, nks, lane);   // dV += P^T dO
        acc_chunk_times(dk, dsf, qs + 16 * c * LDH, nks, lane);   // dK += dS^T Q
      }
    }
    __syncthreads();   // everyone is done with this stage before it is refilled
  }
  if (active) {
    store_rows(a.dk + base, dk, a.scale, r0, a, lane);
    store_rows(a.dv + base, dv, 1.f, r0, a, lane);
  }
}

constexpr size_t kTileBytes = sizeof(bf16) * TILE * LDH;
constexpr size_t kWarpBf16Bytes = sizeof(bf16) * WARPS * 16 * LDT;
constexpr size_t kWarpF32Bytes = sizeof(float) * WARPS * 16 * LDF;
constexpr size_t kFwdSmem = 3 * kTileBytes + kWarpBf16Bytes + 2 * kWarpF32Bytes;
// q, dO, o (then stage 1 of K/V), and stage 0 of K/V
constexpr size_t kDqSmem = 3 * kTileBytes + 2 * kTileBytes;
// K, V, and two stages of q, dO, lse and delta
constexpr size_t kDkvSmem = 2 * kTileBytes + 2 * (2 * kTileBytes + 2 * sizeof(float) * TILE);

// Sets the kernel's dynamic shared memory, launches it on `grid` and
// returns cudaGetLastError(). The backward kernels (`bwd`) also ask for the
// largest shared-memory carveout, for four blocks per SM.
template <typename A>
int launch(void (*kernel)(const A), size_t smem, const A& a, dim3 grid, void* stream, bool bwd) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && bwd)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int tiles(int T) { return (T + TILE - 1) / TILE; }

template <typename A>
int blocks_per_sm(void (*kernel)(const A), size_t smem) {
  int n = -1;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, smem) != cudaSuccess)
    return -1;
  return n;
}

BwdArgs make_bwd_args(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, int T, int hd, int causal) {
  BwdArgs a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.T = T;
  a.hd = hd;
  a.hdp = (hd + 15) / 16 * 16;
  a.causal = causal;
  a.vec = hd % 4 == 0 ? 8 : (hd % 2 == 0 ? 4 : 2);
  a.scale = 1.0f / sqrtf(static_cast<float>(hd));
  return a;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 =
// launched). Shapes, types, contiguity and 32-byte alignment are checked by
// the Python wrappers (ops/flash_attention.py).

int beso_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                   int T, int hd, int causal, void* stream) {
  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  a.lse = static_cast<float*>(lse);
  a.T = T;
  a.hd = hd;
  a.hdp = (hd + 15) / 16 * 16;
  a.causal = causal;
  a.scale = 1.0f / sqrtf(static_cast<float>(hd));
  return launch(flash_fwd_kernel, kFwdSmem, a, dim3(BH, tiles(T)), stream, false);
}

// dq and delta ([BH, T] f32) from q, k, v, o, dout and lse.
int beso_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, void* dq, void* delta, int BH, int T,
                      int hd, int causal, void* stream) {
  BwdArgs a = make_bwd_args(q, k, v, dout, lse, T, hd, causal);
  a.o = static_cast<const bf16*>(o);
  a.dq = static_cast<bf16*>(dq);
  a.delta = static_cast<float*>(delta);
  return launch(flash_bwd_dq_kernel, kDqSmem, a, dim3(BH * tiles(T)), stream, true);
}

int beso_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int BH, int T,
                       int hd, int causal, void* stream) {
  BwdArgs a = make_bwd_args(q, k, v, dout, lse, T, hd, causal);
  a.delta = const_cast<float*>(static_cast<const float*>(delta));
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  return launch(flash_bwd_dkv_kernel, kDkvSmem, a, dim3(BH * tiles(T)), stream, true);
}

int beso_flash_max_head_dim(void) { return MAX_HDP; }

// Resident blocks per SM of the dQ (which = 0) and the dK/dV kernel (1) as
// launched, from the CUDA runtime's occupancy calculator; -1 on an error.
int beso_flash_bwd_blocks_per_sm(int which) {
  return which ? blocks_per_sm(flash_bwd_dkv_kernel, kDkvSmem)
               : blocks_per_sm(flash_bwd_dq_kernel, kDqSmem);
}

}  // extern "C"
