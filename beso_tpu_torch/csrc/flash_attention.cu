// Causal flash attention on Hopper: the forward (TPU kernel B5,
// `_flash_forward` / `_flash_kernel`, beso_tpu/ops/flash_attention.py:34-75,
// 269-308) and the FlashAttention-2 backward (TPU kernel B6,
// `_flash_attention_bwd`, :182-259, bodies `_bwd_dq_kernel` :78-109 and
// `_bwd_dkv_kernel` :112-153): one kernel for dQ over key tiles, one for
// dK/dV over query tiles, so no block reduces across blocks and the result
// is deterministic.
//
// Layout: q, k, v, o, dO, dq, dk, dv [B*H, T, hd] bf16, contiguous (the
// JAX layout [B, H, T, hd]); lse and delta [B*H, T] f32. lse is the
// logsumexp of the SCALED scores s = (q . k) / sqrt(hd); delta = rowsum(dO*O)
// comes from the wrapper (ops/flash_attention.py), as the JAX package
// computes it outside Pallas.
//
// Numerics: QK^T, PV, dO V^T, dS K, P^T dO and dS^T Q run on tensor cores
// (wmma bf16 16x16x16, f32 accumulate); scores, softmax statistics and
// dS are f32, rounded to bf16 only as operands of the next product. The
// running sum l is clamped at 1e-30 as in the JAX kernel (:73,75), so a
// fully masked row gives 0, not NaN.
//
// What bounds it: at the chunked training shape [256, 6, 131, 60] a launch
// moves ~24 MB per tensor read and does a few GFLOP, far below the card's
// compute; it is bound by latency and by the ragged edge. The design: 64
// query (or key) rows per block, four warps of 16 rows each; the block's
// tile and the streamed K/V (or Q/dO) tiles sit in shared memory with the
// head dim zero-padded to hdp = ceil16(hd) <= 64 (hd = 60 -> 64), scaled
// by the true 1/sqrt(hd). T need not be a multiple of 64: rows and keys
// >= T are masked in the kernel (no padded copies), and the dK/dV kernel
// masks p (not s) for query rows >= T. Each warp stages its score tiles in
// shared memory, where two lanes per row apply the mask and the softmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TILE = 64;            // query (or key) rows per block and per streamed tile
constexpr int WARPS = 4;            // each warp owns 16 rows of the block's tile
constexpr int THREADS = WARPS * 32;
constexpr int MAX_HDP = 64;         // padded head dim, multiple of 16
constexpr int NT_D = MAX_HDP / 16;  // head-dim column tiles at most
constexpr int LDH = MAX_HDP + 8;    // bf16 row stride of [TILE, hdp] tiles
constexpr int LDT = TILE + 8;       // bf16 row stride of a warp's [16, TILE] tiles
constexpr int LDF = TILE + 4;       // f32 row stride of a warp's [16, TILE] staging

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* delta;
  bf16* o;       // forward output, or dq
  bf16* dk;
  bf16* dv;
  float* lse;    // written by the forward, read by the backward
  int T, hd, hdp, causal;
  float scale;
};

__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }

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
// B6, dQ: grid (B*H, ceil(T / TILE)); block = one query tile, looping over
// key tiles up to the diagonal. dq = (sum_k dS K) * scale.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);        // [TILE, LDH]
  bf16* dos = qs + TILE * LDH;                     // [TILE, LDH]
  bf16* ks = dos + TILE * LDH;                     // [TILE, LDH]
  bf16* vs = ks + TILE * LDH;                      // [TILE, LDH]
  bf16* dss = vs + TILE * LDH;                     // [WARPS, 16, LDT]
  float* st = reinterpret_cast<float*>(dss + WARPS * 16 * LDT);  // [WARPS, 16, LDF] scores
  float* dpt = st + WARPS * 16 * LDF;              // [WARPS, 16, LDF] dO V^T

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int T = a.T, hd = a.hd, hdp = a.hdp;
  const int qt = blockIdx.y, q0 = qt * TILE;
  const size_t base = static_cast<size_t>(blockIdx.x) * T * hd;
  const size_t rbase = static_cast<size_t>(blockIdx.x) * T;
  load_tile(qs, a.q + base + static_cast<size_t>(q0) * hd, min(TILE, T - q0), hd, hdp, tid);
  load_tile(dos, a.dout + base + static_cast<size_t>(q0) * hd, min(TILE, T - q0), hd, hdp, tid);

  bf16* dsw = dss + warp * 16 * LDT;
  float* sw = st + warp * 16 * LDF;
  float* dpw = dpt + warp * 16 * LDF;
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  const int qrow = q0 + warp * 16 + r;
  const bool qok = qrow < T;
  const float lse = qok ? a.lse[rbase + qrow] : 0.f;
  const float delta = qok ? a.delta[rbase + qrow] : 0.f;

  FragC acc[NT_D];
#pragma unroll
  for (int n = 0; n < NT_D; ++n) wmma::fill_fragment(acc[n], 0.f);

  const int n_all = (T + TILE - 1) / TILE;
  const int nkt = a.causal ? min(n_all, qt + 1) : n_all;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_tile(ks, a.k + base + static_cast<size_t>(k0) * hd, min(TILE, T - k0), hd, hdp, tid);
    load_tile(vs, a.v + base + static_cast<size_t>(k0) * hd, min(TILE, T - k0), hd, hdp, tid);
    __syncthreads();

    rows_times_tile_t(sw, qs + warp * 16 * LDH, ks, hdp / 16);
    rows_times_tile_t(dpw, dos + warp * 16 * LDH, vs, hdp / 16);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = c0 + j, key = k0 + c;
      const bool ok = qok && key < T && (!a.causal || key <= qrow);
      const float p = ok ? expf(sw[r * LDF + c] * a.scale - lse) : 0.f;
      dsw[r * LDT + c] = f2bf(p * (dpw[r * LDF + c] - delta));
    }
    __syncwarp();
    acc_tile_times(acc, dsw, ks, hdp / 16);
  }

#pragma unroll
  for (int n = 0; n < NT_D; ++n)
    if (n < hdp / 16) wmma::store_matrix_sync(sw + n * 16, acc[n], LDF, wmma::mem_row_major);
  __syncwarp();
  if (qok) {
    bf16* row = a.o + base + static_cast<size_t>(qrow) * hd;
    for (int c = c0; c < min(c0 + 32, hd); ++c) row[c] = f2bf(sw[r * LDF + c] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// B6, dK/dV: grid (B*H, ceil(T / TILE)); block = one key tile, looping over
// query tiles from the diagonal on. dv = sum_q P^T dO; dk = (sum_q dS^T Q)
// * scale, which equals the JAX kernel's sum against the scaled q (:144,152).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);        // [TILE, LDH]
  bf16* vs = ks + TILE * LDH;                      // [TILE, LDH]
  bf16* qs = vs + TILE * LDH;                      // [TILE, LDH]
  bf16* dos = qs + TILE * LDH;                     // [TILE, LDH]
  bf16* pts = dos + TILE * LDH;                    // [WARPS, 16, LDT] P^T
  bf16* dss = pts + WARPS * 16 * LDT;              // [WARPS, 16, LDT] dS^T
  float* st = reinterpret_cast<float*>(dss + WARPS * 16 * LDT);  // [WARPS, 16, LDF] S^T
  float* dpt = st + WARPS * 16 * LDF;              // [WARPS, 16, LDF] (dO V^T)^T
  float* lse_s = dpt + WARPS * 16 * LDF;           // [TILE]
  float* delta_s = lse_s + TILE;                   // [TILE]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int T = a.T, hd = a.hd, hdp = a.hdp;
  const int kt = blockIdx.y, k0 = kt * TILE;
  const size_t base = static_cast<size_t>(blockIdx.x) * T * hd;
  const size_t rbase = static_cast<size_t>(blockIdx.x) * T;
  load_tile(ks, a.k + base + static_cast<size_t>(k0) * hd, min(TILE, T - k0), hd, hdp, tid);
  load_tile(vs, a.v + base + static_cast<size_t>(k0) * hd, min(TILE, T - k0), hd, hdp, tid);

  bf16* ptw = pts + warp * 16 * LDT;
  bf16* dsw = dss + warp * 16 * LDT;
  float* sw = st + warp * 16 * LDF;
  float* dpw = dpt + warp * 16 * LDF;
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  const int krow = k0 + warp * 16 + r;
  const bool kok = krow < T;

  FragC dk_acc[NT_D], dv_acc[NT_D];
#pragma unroll
  for (int n = 0; n < NT_D; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  const int nqt = (T + TILE - 1) / TILE;
  for (int qt = a.causal ? kt : 0; qt < nqt; ++qt) {  // causal: from the diagonal on
    const int q0 = qt * TILE, nq = min(TILE, T - q0);
    __syncthreads();
    load_tile(qs, a.q + base + static_cast<size_t>(q0) * hd, nq, hd, hdp, tid);
    load_tile(dos, a.dout + base + static_cast<size_t>(q0) * hd, nq, hd, hdp, tid);
    for (int i = tid; i < TILE; i += THREADS) {
      lse_s[i] = i < nq ? a.lse[rbase + q0 + i] : 0.f;
      delta_s[i] = i < nq ? a.delta[rbase + q0 + i] : 0.f;
    }
    __syncthreads();

    rows_times_tile_t(sw, ks + warp * 16 * LDH, qs, hdp / 16);
    rows_times_tile_t(dpw, vs + warp * 16 * LDH, dos, hdp / 16);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = c0 + j, qi = q0 + c;
      // mask p, not s: padded query rows would give exp(s - lse) != 0
      const bool ok = kok && qi < T && (!a.causal || qi >= krow);
      const float p = ok ? expf(sw[r * LDF + c] * a.scale - lse_s[c]) : 0.f;
      ptw[r * LDT + c] = f2bf(p);
      dsw[r * LDT + c] = f2bf(p * (dpw[r * LDF + c] - delta_s[c]));
    }
    __syncwarp();
    acc_tile_times(dv_acc, ptw, dos, hdp / 16);
    acc_tile_times(dk_acc, dsw, qs, hdp / 16);
  }

#pragma unroll
  for (int n = 0; n < NT_D; ++n)
    if (n < hdp / 16) wmma::store_matrix_sync(sw + n * 16, dk_acc[n], LDF, wmma::mem_row_major);
  __syncwarp();
  if (kok) {
    bf16* row = a.dk + base + static_cast<size_t>(krow) * hd;
    for (int c = c0; c < min(c0 + 32, hd); ++c) row[c] = f2bf(sw[r * LDF + c] * a.scale);
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
    if (n < hdp / 16) wmma::store_matrix_sync(sw + n * 16, dv_acc[n], LDF, wmma::mem_row_major);
  __syncwarp();
  if (kok) {
    bf16* row = a.dv + base + static_cast<size_t>(krow) * hd;
    for (int c = c0; c < min(c0 + 32, hd); ++c) row[c] = f2bf(sw[r * LDF + c]);
  }
}

constexpr size_t kTileBytes = sizeof(bf16) * TILE * LDH;
constexpr size_t kWarpBf16Bytes = sizeof(bf16) * WARPS * 16 * LDT;
constexpr size_t kWarpF32Bytes = sizeof(float) * WARPS * 16 * LDF;
constexpr size_t kFwdSmem = 3 * kTileBytes + kWarpBf16Bytes + 2 * kWarpF32Bytes;
constexpr size_t kDqSmem = 4 * kTileBytes + kWarpBf16Bytes + 2 * kWarpF32Bytes;
constexpr size_t kDkvSmem =
    4 * kTileBytes + 2 * kWarpBf16Bytes + 2 * kWarpF32Bytes + 2 * sizeof(float) * TILE;

Args make_args(const void* q, const void* k, const void* v, int T, int hd, int causal) {
  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.T = T;
  a.hd = hd;
  a.hdp = (hd + 15) / 16 * 16;
  a.causal = causal;
  a.scale = 1.0f / sqrtf(static_cast<float>(hd));
  return a;
}

int launch(void (*kernel)(const Args), size_t smem, const Args& a, int BH, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (a.T + TILE - 1) / TILE);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 =
// launched). Shapes, types and contiguity are checked by the Python
// wrappers (ops/flash_attention.py).

int beso_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                   int T, int hd, int causal, void* stream) {
  Args a = make_args(q, k, v, T, hd, causal);
  a.o = static_cast<bf16*>(o);
  a.lse = static_cast<float*>(lse);
  return launch(flash_fwd_kernel, kFwdSmem, a, BH, stream);
}

int beso_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int BH, int T, int hd,
                      int causal, void* stream) {
  Args a = make_args(q, k, v, T, hd, causal);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = static_cast<const float*>(delta);
  a.o = static_cast<bf16*>(dq);
  return launch(flash_bwd_dq_kernel, kDqSmem, a, BH, stream);
}

int beso_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int BH, int T,
                       int hd, int causal, void* stream) {
  Args a = make_args(q, k, v, T, hd, causal);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = static_cast<const float*>(delta);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  return launch(flash_bwd_dkv_kernel, kDkvSmem, a, BH, stream);
}

int beso_flash_max_head_dim(void) { return MAX_HDP; }

}  // extern "C"
