// Causal flash attention on Hopper: the forward (TPU kernel B5,
// `_flash_forward` / `_flash_kernel`, beso_tpu/ops/flash_attention.py:34-75,
// 269-308) and the FlashAttention-2 backward (TPU kernel B6,
// `_flash_attention_bwd`, :182-259, bodies `_bwd_dq_kernel` :78-109 and
// `_bwd_dkv_kernel` :112-153): one kernel for dQ over key tiles, one for
// dK/dV over query tiles, so no block reduces across blocks, nothing is
// written twice and the result is deterministic (no atomics).
//
// Layout: q, k, v, o, dO, dq, dk, dv [B*H, T, hd], contiguous (the JAX
// layout [B, H, T, hd]), all bf16 (the entries below also take all f32, for
// flash_attention_f32.cu's and flash_attention_wide.cu's kernels); lse and
// delta [B*H, T] f32.
// lse is the logsumexp of the SCALED scores s = (q . k) / sqrt(hd). delta =
// rowsum(dO * O) (the JAX package computes it outside Pallas, :212-214) is
// computed by the dQ kernel, which uses it and writes it for the dK/dV
// kernel, so a backward is exactly two launches.
//
// What bounds the three kernels: at the chunked training shape
// [256, 6, 131, 60] bf16 a launch reads ~24 MB per tensor (the forward moves
// ~97 MB, 0.029 ms at 3.35 TB/s) and its products take a few microseconds at
// the tensor cores' peak, so each is bound by bytes and latency, not by the
// tensor cores; `wgmma` is not the lever (its 64-row tiles would also compute
// more of the ragged edge). What the design does about it:
// - Fragments stay in registers. Each warp owns 16 rows (queries in the
//   forward and the dQ kernel, keys in the dK/dV kernel) and walks the
//   streamed tile in chunks of 16 with `mma.sync` m16n8k16 (bf16, f32
//   accumulation): S = Q K^T (and dP = dO V^T, or S^T = K Q^T and
//   dP^T = V dO^T) as accumulator fragments, then the two n8 accumulator
//   tiles repacked into one k16 A operand (rounded to bf16 only there, as
//   operand of the next product) for O += P V, dQ += dS K, or dV += P^T dO
//   and dK += dS^T Q, the B operand through `ldmatrix.trans`. No score tile
//   touches shared memory.
// - The forward's online softmax runs on those fragments: a thread holds
//   rows g and g + 8 of its warp's 16; the chunk's row max is reduced over
//   the four lanes of a row (shuffles 1 and 2), the O accumulator is
//   rescaled by alpha = exp2(m - m_new) per chunk, P = exp2(s - m) on scores
//   prescaled by scale * log2(e), and the running sum stays per thread until
//   the end. The sum is clamped at 1e-30 as in the JAX kernel (:73,75).
// - Streamed tiles (K/V, or Q/dO with their lse and delta) come in by
//   `cp.async`, two stages deep: the next tile loads while this one
//   computes. Rows are hd * 2 bytes (120 at hd = 60), so only 8-byte copies
//   (hd % 4 == 0) or 4-byte ones (hd even) are aligned; their source size
//   zero-fills the pad columns [hd, hdp) and the rows >= T. Odd hd takes
//   plain loads. The tile a block keeps (Q; or q, dO, o) is read into
//   fragments first and its shared memory then serves as the second stage.
// - The ragged edge and the diagonal are skipped at 16-row granularity: a
//   warp whose rows all lie at or beyond T does no products (it still
//   copies and meets the barriers), and a warp skips the chunks wholly
//   above the diagonal; only chunks that straddle T or the diagonal are
//   masked. At T = 131 each kernel computes 11,520 (query, key) pairs per
//   (b, h) instead of the 24,576 of whole 64 x 64 tiles.
// - Occupancy: a block holds two stages and what it keeps (forward 36,864
//   bytes, dQ 46,080, dK/dV 56,320), four 128-thread blocks per SM at <= 128
//   registers.
// - Head dims up to 128 (the JAX kernels' working range): these kernels
//   take tile width 64 (hdp <= 64: the chunked training path's hd 60) in
//   bf16. The launchers call flash_attention_f32.cu's `wgmma` kernels for
//   f32 inputs (the model's dtype, as in the JAX kernels, which compute in
//   f32) at that width, and flash_attention_wide.cu's above it in both
//   dtypes: this source's kernels are bf16 only.
// Padded rows get lse = 0 and zero q/k, so their p is finite; the dK/dV
// kernel masks p (not s) for query columns >= T, as the JAX kernel does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention.cuh"
#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TILE = 64;            // query (or key) rows per block and per streamed tile
constexpr int WARPS = 4;            // each warp owns 16 rows of the block's tile
constexpr int THREADS = WARPS * 32;
constexpr int MIN_BLOCKS = 4;       // resident blocks per SM the launch bounds ask for
constexpr int MAX_HDP = 128;        // the largest padded head dim of either source
// The tile width HDP (these kernels' padded head dims, up to 64): head-dim
// column tiles (k16 steps) and n8 tiles at most, the bf16 row stride of
// [TILE, hdp] tiles (144 bytes, an odd number of 16-byte units, so ldmatrix
// is free of bank conflicts) and the bf16 elements TS of a [TILE, LDH] tile.
constexpr int HDP = 64;
constexpr int NT_D = HDP / 16;
constexpr int NT_D8 = HDP / 8;
constexpr int LDH = HDP + 8;
constexpr int TS = TILE * LDH;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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
    dst[r * LDH + c] =
        (r < nrows && c < hd) ? src[static_cast<size_t>(r) * hd + c] : f2bf(0.f);
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

template <class A>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src, int nrows, const A& a,
                                          int tid) {
  if (a.vec == 8)
    copy_tile_async<8>(dst, src, nrows, a.hd, a.hdp, tid);
  else if (a.vec == 4)
    copy_tile_async<4>(dst, src, nrows, a.hd, a.hdp, tid);
  else
    load_tile(dst, src, nrows, a.hd, a.hdp, tid);  // odd hd: no aligned copy size
}

// ---------------------------------------------------------------------------
// Helpers on m16n8k16 fragments (hopper.cuh): with g = lane / 4 and
// q4 = lane % 4, an accumulator pair c[j][0:4] over 16 rows x 16 columns
// holds rows g (i < 2) and g + 8 (i >= 2) at columns 8 j + 2 q4 + i % 2.
// ---------------------------------------------------------------------------

// c[0:2][0:4] += A . B^T over the head dim, for 16 rows (A: the warp's A
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

// c[0:2][0:4] += A . B^T as above (bf16), with A the warp's 16 rows of the
// shared tile `a` (at its first row), one k16 step at a time.
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

// The 16 x 16 A fragment of a chunk's two n8 accumulator tiles c (P or
// dS), rounded to bf16 as an operand.
__device__ __forceinline__ void pack_a(uint32_t (&f)[4], const float (&c)[2][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = pack_bf2(c[i >> 1][2 * (i & 1)], c[i >> 1][2 * (i & 1) + 1]);
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

// Eight values of a bf16 shared tile row from a 16-byte aligned column, in
// f32.
__device__ __forceinline__ void row8(float (&x)[8], const bf16* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}

// Rows r0 + g (times mul0) and r0 + g + 8 (times mul1), those < T, of a
// bf16 [*, hd] output <- acc.
template <class A>
__device__ __forceinline__ void store_rows(bf16* out, float (&acc)[NT_D8][4], float mul0,
                                           float mul1, int r0, const A& a, int lane) {
  const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int t = 0; t < NT_D8; ++t) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int row = r0 + g + 8 * u, col = 8 * t + 2 * q4;
      if (t < 2 * (a.hdp >> 4) && row < a.T && col < a.hd) {
        bf16* p = out + static_cast<size_t>(row) * a.hd + col;
        const float mul = u ? mul1 : mul0;
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
// B5, forward: grid B*H * ceil(T / TILE), a (b, h)'s tiles adjacent (they
// share its K/V in L2); block = one query tile, looping over key tiles up
// to the diagonal with the online softmax. o = (sum_k P V) / l,
// lse = m + log(l) in natural-log units. bf16 (the f32 forward is
// flash_attention_f32.cu's).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) flash_fwd_kernel(const FwdArgs<bf16> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);        // [TS] q; then stage 1 (K, V)
  auto stage = [&](int i) { return i ? qs : qs + 2 * TS; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int T = a.T, hd = a.hd, nks = a.hdp >> 4;
  const int n_all = (T + TILE - 1) / TILE, qt = blockIdx.x % n_all;
  const int q0 = qt * TILE, r0 = q0 + 16 * warp;  // r0: this warp's first query row
  const bool active = r0 < T;
  const size_t rbase = static_cast<size_t>(blockIdx.x / n_all) * T, base = rbase * hd;
  const int nkt = a.causal ? qt + 1 : n_all;

  copy_tile(qs, a.q + base + static_cast<size_t>(q0) * hd, T - q0, a, tid);
  hopper::cp_async_commit();
  copy_tile(stage(0), a.k + base, T, a, tid);
  copy_tile(stage(0) + TS, a.v + base, T, a, tid);
  hopper::cp_async_commit();
  hopper::cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[NT_D][4];
  if (active) load_rows(qf, qs + 16 * warp * LDH, nks, lane);
  __syncthreads();   // q is in registers: stage 1 may overwrite it

  const float scale2 = a.scale * LOG2E;
  float acc[NT_D8][4] = {};
  // rows g, g + 8: running max of the scores in log2 units, and this
  // thread's share of the running sum (its four lanes' shares add up to l)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      const int k1 = (kt + 1) * TILE;
      bf16* st = stage((kt + 1) & 1);
      copy_tile(st, a.k + base + static_cast<size_t>(k1) * hd, T - k1, a, tid);
      copy_tile(st + TS, a.v + base + static_cast<size_t>(k1) * hd, T - k1, a, tid);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();   // tile kt has landed
    __syncthreads();
    const bf16* ks = stage(kt & 1);
    const bf16* vs = ks + TS;
    if (active) {
      for (int c = 0; c < TILE / 16; ++c) {
        const int kc = kt * TILE + 16 * c;   // the chunk's first key
        if (kc >= T || (a.causal && kc > r0)) break;   // past T, or above the diagonal
        float s[2][4] = {};
        rows_times_chunk_t(s, qf, ks + 16 * c * LDH, nks, lane);
        // every row keeps key kc (kc < T, and kc <= r0 when causal), so m stays finite
        const bool edge = kc + 16 > T || (a.causal && kc == r0);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int u = i >> 1, key = kc + 8 * j + 2 * q4 + (i & 1), row = r0 + g + 8 * u;
            const bool ok = !edge || (key < T && (!a.causal || key <= row));
            s[j][i] = ok ? s[j][i] * scale2 : -INFINITY;
            mx[u] = fmaxf(mx[u], s[j][i]);
          }
        float alpha[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
          mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
          const float m_new = fmaxf(m[u], mx[u]);
          alpha[u] = exp2f(m[u] - m_new);   // 0 on the first chunk (m = -inf)
          m[u] = m_new;
          l[u] *= alpha[u];
        }
#pragma unroll
        for (int t = 0; t < NT_D8; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[t][i] *= alpha[i >> 1];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[j][i] = exp2f(s[j][i] - m[i >> 1]);   // P; masked scores give 0
            l[i >> 1] += s[j][i];
          }
        uint32_t pf[4];
        pack_a(pf, s);
        acc_chunk_times(acc, pf, vs + 16 * c * LDH, nks, lane);   // O += P V
      }
    }
    __syncthreads();   // everyone is done with this stage before it is refilled
  }
  if (active) {
    float inv[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
      l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
      const float lc = fmaxf(l[u], 1e-30f);
      inv[u] = 1.f / lc;
      const int row = r0 + g + 8 * u;
      if (q4 == 0 && row < T) a.lse[rbase + row] = m[u] * LN2 + logf(lc);
    }
    store_rows(a.o + base, acc, inv[0], inv[1], r0, a, lane);
  }
}

// ---------------------------------------------------------------------------
// B6, dQ (and delta): grid B*H * ceil(T / TILE), a (b, h)'s tiles adjacent
// (they share its K/V in L2); block = one query tile, looping over key
// tiles up to the diagonal. delta = rowsum(dO * O),
// dq = (sum_k dS K) * scale. bf16 (the f32 backward is
// flash_attention_f32.cu's).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    flash_bwd_dq_kernel(const BwdArgs<bf16> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);        // [TS] q, dO, o; then stage 1
  bf16* dos = qs + TS;
  bf16* os = dos + TS;
  auto stage = [&](int i) { return i ? qs : os + TS; };  // K [TS], then V

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
  copy_tile(stage(0) + TS, a.v + base, T, a, tid);
  hopper::cp_async_commit();
  hopper::cp_async_wait<1>();
  __syncthreads();

  uint32_t qf[NT_D][4], dof[NT_D][4];
  float lse2[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};   // rows g, g + 8; lse2 = lse * log2(e)
  if (active) {
    load_rows(qf, qs + 16 * warp * LDH, nks, lane);
    load_rows(dof, dos + 16 * warp * LDH, nks, lane);
    // delta in f32: lanes 2 i and 2 i + 1 sum halves of row 16 warp + i
    const int rr = 16 * warp + (lane >> 1), c0 = (lane & 1) * (HDP / 2);
    float d = 0.f;
    for (int c = c0; c < min(c0 + HDP / 2, a.hdp); c += 8) {
      float x[8], y[8];
      row8(x, dos + rr * LDH + c);
      row8(y, os + rr * LDH + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) d = fmaf(x[j], y[j], d);
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
      copy_tile(st + TS, a.v + base + static_cast<size_t>(k1) * hd, T - k1, a, tid);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();   // tile kt has landed
    __syncthreads();
    const bf16* ks = stage(kt & 1);
    const bf16* vs = ks + TS;
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
        uint32_t dsf[4];
        pack_a(dsf, ds);
        acc_chunk_times(acc, dsf, ks + 16 * c * LDH, nks, lane);
      }
    }
    __syncthreads();   // everyone is done with this stage before it is refilled
  }
  if (active) store_rows(a.dq + base, acc, a.scale, a.scale, r0, a, lane);
}

// ---------------------------------------------------------------------------
// B6, dK/dV: grid B*H * ceil(T / TILE), a (b, h)'s tiles adjacent; block =
// one key tile, looping over query tiles from the diagonal on.
// dv = sum_q P^T dO; dk = (sum_q dS^T Q) * scale, which equals the JAX
// kernel's sum against the scaled q (:144,152). bf16, as the dQ kernel.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    flash_bwd_dkv_kernel(const BwdArgs<bf16> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);        // [TS]
  bf16* vs = ks + TS;                              // [TS]
  // two stages, each q [TS], dO [TS], lse [TILE], delta [TILE]
  constexpr int kStage = 2 * TS + TILE * 2 * (sizeof(float) / sizeof(bf16));
  auto stage = [&](int i) { return vs + TS + i * kStage; };

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
    copy_tile(st + TS, a.dout + base + static_cast<size_t>(q0) * hd, T - q0, a, tid);
    // lse (threads 0-63) and delta (64-127) of the tile's rows, 0 past T
    float* stat = reinterpret_cast<float*>(st + 2 * TS);
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
    const bf16* dos = qs + TS;
    const float* lse_s = reinterpret_cast<const float*>(dos + TS);
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
        uint32_t pf[4], dsf[4];
        pack_a(pf, p);
        pack_a(dsf, ds);
        acc_chunk_times(dv, pf, dos + 16 * c * LDH, nks, lane);   // dV += P^T dO
        acc_chunk_times(dk, dsf, qs + 16 * c * LDH, nks, lane);   // dK += dS^T Q
      }
    }
    __syncthreads();   // everyone is done with this stage before it is refilled
  }
  if (active) {
    store_rows(a.dk + base, dk, a.scale, a.scale, r0, a, lane);
    store_rows(a.dv + base, dv, 1.f, 1.f, r0, a, lane);
  }
}

constexpr size_t kTileBytes = sizeof(bf16) * TS;
// forward: q (then half of stage 1), the second tile of stage 1, and stage 0 of K/V
constexpr size_t fwd_smem() { return 4 * kTileBytes; }
// bf16 dQ: q, dO, o (then stage 1 of K/V), and stage 0 of K/V
constexpr size_t dq_smem() { return 5 * kTileBytes; }
// bf16 dK/dV: K, V, and two stages of q, dO, lse and delta
constexpr size_t dkv_smem() {
  return 2 * kTileBytes + 2 * (2 * kTileBytes + 2 * sizeof(float) * TILE);
}

// Launches `kernel` on one block of THREADS per query (or key) tile.
template <typename K, typename A>
int launch(K kernel, size_t smem, const A& a, int BH, void* stream) {
  return hopper::launch(kernel, smem, BH * ((a.T + TILE - 1) / TILE), THREADS, stream, a);
}

template <typename K>
int blocks_per_sm(K kernel, size_t smem) { return hopper::blocks_per_sm(kernel, smem, THREADS); }

// The fields every kernel's arguments share.
template <class A>
void set_inputs(A& a, const void* q, const void* k, const void* v, int T, int hd, int causal) {
  using P = decltype(a.q);
  a.q = static_cast<P>(q);
  a.k = static_cast<P>(k);
  a.v = static_cast<P>(v);
  a.T = T;
  a.hd = hd;
  a.hdp = (hd + 15) / 16 * 16;
  a.causal = causal;
  a.vec = hd % 4 == 0 ? 8 : (hd % 2 == 0 ? 4 : 2);
  a.scale = 1.0f / sqrtf(static_cast<float>(hd));
}

// Each launcher takes these kernels for bf16 at hd <= 64 (the chunked
// training path's), flash_attention_f32.cu's for f32 there, and
// flash_attention_wide.cu's above.
template <typename E>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int T, int hd,
        int causal, void* stream) {
  FwdArgs<E> a = {};
  set_inputs(a, q, k, v, T, hd, causal);
  a.o = static_cast<E*>(o);
  a.lse = static_cast<float*>(lse);
  if (a.hdp > 64) return flash_wide_fwd(a, BH, stream);
  if constexpr (sizeof(E) == 4)
    return flash_f32_fwd(a, BH, stream);
  else
    return launch(flash_fwd_kernel, fwd_smem(), a, BH, stream);
}

template <typename E>
int bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* dq, void* delta, int BH, int T, int hd, int causal,
           void* stream) {
  BwdArgs<E> a = {};
  set_inputs(a, q, k, v, T, hd, causal);
  a.o = static_cast<const E*>(o);
  a.dout = static_cast<const E*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.dq = static_cast<E*>(dq);
  a.delta = static_cast<float*>(delta);
  if (a.hdp > 64) return flash_wide_bwd_dq(a, BH, stream);
  if constexpr (sizeof(E) == 4)
    return flash_f32_bwd_dq(a, BH, stream);
  else
    return launch(flash_bwd_dq_kernel, dq_smem(), a, BH, stream);
}

template <typename E>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, void* dk, void* dv, int BH, int T, int hd, int causal,
            void* stream) {
  BwdArgs<E> a = {};
  set_inputs(a, q, k, v, T, hd, causal);
  a.dout = static_cast<const E*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = const_cast<float*>(static_cast<const float*>(delta));
  a.dk = static_cast<E*>(dk);
  a.dv = static_cast<E*>(dv);
  if (a.hdp > 64) return flash_wide_bwd_dkv(a, BH, stream);
  if constexpr (sizeof(E) == 4)
    return flash_f32_bwd_dkv(a, BH, stream);
  else
    return launch(flash_bwd_dkv_kernel, dkv_smem(), a, BH, stream);
}

template <typename E>
int kernel_blocks_per_sm(int which) {
  if constexpr (sizeof(E) == 4) {
    return flash_f32_blocks_per_sm(which);
  } else {
    if (which == 0) return blocks_per_sm(flash_fwd_kernel, fwd_smem());
    if (which == 1) return blocks_per_sm(flash_bwd_dq_kernel, dq_smem());
    return blocks_per_sm(flash_bwd_dkv_kernel, dkv_smem());
  }
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 =
// launched); `f32` selects the f32 instantiation (q, k, v, o, dO and the
// outputs f32), else bf16. Shapes, types, contiguity and 32-byte alignment
// are checked by the Python wrappers (ops/flash_attention.py).

int beso_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                   int T, int hd, int causal, int f32, void* stream) {
  return f32 ? fwd<float>(q, k, v, o, lse, BH, T, hd, causal, stream)
             : fwd<bf16>(q, k, v, o, lse, BH, T, hd, causal, stream);
}

// dq and delta ([BH, T] f32) from q, k, v, o, dout and lse.
int beso_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, void* dq, void* delta, int BH, int T,
                      int hd, int causal, int f32, void* stream) {
  return f32 ? bwd_dq<float>(q, k, v, o, dout, lse, dq, delta, BH, T, hd, causal, stream)
             : bwd_dq<bf16>(q, k, v, o, dout, lse, dq, delta, BH, T, hd, causal, stream);
}

int beso_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int BH, int T,
                       int hd, int causal, int f32, void* stream) {
  return f32 ? bwd_dkv<float>(q, k, v, dout, lse, delta, dk, dv, BH, T, hd, causal, stream)
             : bwd_dkv<bf16>(q, k, v, dout, lse, delta, dk, dv, BH, T, hd, causal, stream);
}

int beso_flash_max_head_dim(void) { return MAX_HDP; }

// Resident blocks per SM of the forward (which = 0), the dQ (1) and the
// dK/dV kernel (2) as launched, bf16 or (f32) f32 instantiation, for head
// dim hd (these kernels up to 64, flash_attention_wide.cu's above), from
// the CUDA runtime's occupancy calculator; -1 on an error.
int beso_flash_blocks_per_sm(int which, int f32, int hd) {
  if (hd <= 64) return f32 ? kernel_blocks_per_sm<float>(which) : kernel_blocks_per_sm<bf16>(which);
  return flash_wide_blocks_per_sm(which, f32);
}

}  // extern "C"
