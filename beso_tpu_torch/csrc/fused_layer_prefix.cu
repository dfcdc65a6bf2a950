// Pre-LN GPT blocks over the tokens of each environment, with or without a
// cached prefix K/V: the Hopper port of the four fused-layer TPU kernels of
// beso_tpu/ops/fused_layer.py. One kernel body serves all four (B2 in its
// own instantiation, with a layer loop); the entry points differ only in
// where the keys come from and how many layers run:
//
//   B1 beso_fused_layer_prefix         (`fused_layer_prefix_tl_v2` :564-682,
//      attention `_tl_attention` :346-413): one block over the 2T suffix
//      tokens against the prefix K/V of sigma-grid row `idx`, optional
//      ln_f + linear-head epilogue;
//   B2 beso_fused_layers_prefix_group  (`fused_layers_prefix_tl_v2_group`
//      :442-561): N consecutive B1 blocks in one launch, the residual kept in
//      shared memory between them, each layer reading its own prefix row
//      `idx`, the epilogue after the last;
//   B3 beso_fused_layer_with_prefix    (`fused_layer_with_prefix` :195-295):
//      one block against ONE prefix row the caller has already selected;
//   B4 beso_fused_layer                (`fused_layer` :129-192, :298-334):
//      one block over the whole token sequence with a plain causal mask and
//      no prefix (P = 0; no index is read).
//
//   LN1 -> fused QKV -> attention over P prefix keys plus the causal own
//   keys -> proj + residual -> LN2 -> 4x tanh-GELU MLP + residual
//   [-> next layer] [-> ln_f (f32) + linear head (f32)]
//
// Layout: x [B, T2, D] bf16, pk/pv [S, B, P, D] bf16 per layer (S = 1 for
// B3), out [B, T2, D] bf16, pred [B, T2, M] f32. Weights are [out, in] bf16,
// zero-padded by `prepare_layer_params` (ops/fused_layer.py) to multiples of
// 16: the QKV rows per head to hdp = ceil16(hd), the model width to
// Dp = ceil16(D) and the MLP width to Fp. Biases and LayerNorm parameters
// are f32. The per-layer pointers travel in the kernel's parameter struct
// (MAX_LAYERS x 14 pointers, under 1 KB of the 4 KB parameter space), read
// in place through __grid_constant__.
//
// Numerics (as the TPU kernels): bf16 operands, f32 accumulation, f32 bias,
// one rounding to bf16 after the bias; LayerNorm statistics in f32 with
// var = E[x^2] - mu^2 and eps 1e-5; scores scaled by 1/sqrt(hd) of the true
// head dim; softmax in f32 with the probabilities rounded to bf16; the
// epilogue's ln_f output stays f32 and feeds an f32 head. Between the layers
// of a group the residual is the same bf16 tile a B1 launch writes to `out`
// and the next reads back, so a group of N equals N B1 launches bit for bit;
// a B3 launch equals a B1 launch on the same row bit for bit.
//
// What bounds it: at kitchen serving shapes (D=360, 16k suffix rows per
// call) each row costs ~24*D^2 = 3.1 MFLOP per layer against ~36 MB moved
// per launch, about 1,400 FLOP/byte, so the layer is compute-bound. The
// design therefore keeps every intermediate of a 64-row tile in shared
// memory and runs the four matrix products on tensor cores (wmma bf16
// 16x16x16, f32 accumulate). A tile is 64/T2 whole environments (8 at 2T=8,
// 5 at B4's 11 or 12 tokens); QKV is built head by head (the whole [64, 3D]
// QKV tile would need 138 KB next to the residual and LN buffers); the 4D
// MLP hidden layer is streamed in 128-column chunks with the fc2 sums kept
// in registers. Attention has at most P+T2 keys per query, so it runs on
// CUDA cores, one warp per query row with the lanes over the head dim,
// against the tile's prefix K/V staged in shared memory. Weights are read
// from L2 through the B fragments, one k-step ahead; each warp reuses one B
// fragment for all four row tiles. With one 8-warp block per SM (~210 KB of
// shared memory at the kitchen shape) the kernel is bound by per-block
// latency, not by the tensor cores: PERF.md has the measurements. Grouping
// layers (B2) saves only the residual's round trip through device memory
// (~12 MB per layer at 2048 envs), a few microseconds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int ROWS = 64;           // token rows per block
constexpr int RT = ROWS / 16;      // row tiles
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int FC = 128;            // MLP hidden chunk width
constexpr int MAX_KEYS = 32;       // P + T2
constexpr int MAX_M = 16;          // head outputs
constexpr int MAX_OUT_TILES = 3;   // Dp <= WARPS * 3 * 16 = 384
constexpr int MAX_HDP = 64;        // two head-dim values per lane
constexpr int MAX_LAYERS = 8;      // layers of one B2 group

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// One layer's weights and prefix cache; the order of the first twelve is
// that of `FusedLayerParams` (ops/fused_layer.py).
struct LayerArgs {
  const float* ln1_s;
  const float* ln1_b;
  const bf16* wqkv;
  const float* bqkv;
  const bf16* wproj;
  const float* bproj;
  const float* ln2_s;
  const float* ln2_b;
  const bf16* wfc;
  const float* bfc;
  const bf16* wfc2;
  const float* bfc2;
  const bf16* pk;     // [S, B, P, D]; unused when P == 0
  const bf16* pv;
};
constexpr int LAYER_PTRS = sizeof(LayerArgs) / sizeof(void*);

struct Args {
  const bf16* x;
  const int* idx;     // sigma-grid row of pk/pv; nullptr: row 0
  LayerArgs layer[MAX_LAYERS];
  int n_layers;
  const float* lnf_s;
  const float* lnf_b;
  const float* whead;
  const float* bhead;
  bf16* out;
  float* pred;
  int B, T2, D, H, P, S, F, M;
  int hd, hdp, Dp, HDp, ywidth, envs_per_block;
  float scale;
};

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ float round_bf(float v) { return bf2f(f2bf(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

// Mean and reciprocal std of one bf16 row (whole warp), f32 statistics.
__device__ __forceinline__ void row_stats(const bf16* xr, int D, int lane,
                                          float& mu, float& rstd) {
  float sum = 0.f, sq = 0.f;
  for (int c = lane; c < D; c += 32) {
    float v = bf2f(xr[c]);
    sum += v;
    sq += v * v;
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  mu = sum / D;
  rstd = rsqrtf(sq / D - mu * mu + 1e-5f);
}

// LayerNorm of the tile's rows src -> dst (both [ROWS, Dp]); pad rows and
// pad columns of dst are written as zero.
__device__ void layernorm_rows(const bf16* src, bf16* dst, const float* s,
                               const float* b, int D, int Dp, int nrows,
                               int warp, int lane) {
  for (int r = warp; r < ROWS; r += WARPS) {
    bf16* yr = dst + r * Dp;
    if (r >= nrows) {
      for (int c = lane; c < Dp; c += 32) yr[c] = f2bf(0.f);
      continue;
    }
    const bf16* xr = src + r * Dp;
    float mu, rstd;
    row_stats(xr, D, lane, mu, rstd);
    for (int c = lane; c < Dp; c += 32)
      yr[c] = c < D ? f2bf((bf2f(xr[c]) - mu) * rstd * s[c] + b[c]) : f2bf(0.f);
  }
}

// One k-step for all row tiles: acc[rt] += A[rt, k] @ fb.
__device__ __forceinline__ void mma_step(FragC (&acc)[RT], const bf16* a, int lda,
                                         const FragB& fb, int k) {
  FragA fa;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) {
    wmma::load_matrix_sync(fa, a + rt * 16 * lda + k * 16, lda);
    wmma::mma_sync(acc[rt], fa, fb, acc[rt]);
  }
}

// acc[rt] += A[rt*16 : rt*16+16, :K] @ W[n0 : n0+16, :K]^T for all row
// tiles; `w` points at weight row n0 (row-major [N, ldw], i.e. the col-major
// K x 16 B operand), `a` at the smem A tile (row-major, lda). The next
// k-step's B fragment is loaded before the current step's products, so its
// L2 latency overlaps them.
__device__ __forceinline__ void mma_rows(FragC (&acc)[RT], const bf16* a, int lda,
                                         const bf16* w, int ldw, int ksteps) {
  FragB b0, b1;
  wmma::load_matrix_sync(b0, w, ldw);
  int k = 0;
  for (; k + 1 < ksteps; k += 2) {
    wmma::load_matrix_sync(b1, w + (k + 1) * 16, ldw);
    mma_step(acc, a, lda, b0, k);
    if (k + 2 < ksteps) wmma::load_matrix_sync(b0, w + (k + 2) * 16, ldw);
    mma_step(acc, a, lda, b1, k + 1);
  }
  if (k < ksteps) mma_step(acc, a, lda, b0, k);
}

// Copy `rows` rows of `width` bf16 from global (row stride `width`) into
// smem (row stride `ld`), zero-filling columns [width, ld) and rows
// [rows, total_rows). 16-byte copies when the widths allow.
__device__ void load_rows(bf16* dst, int ld, const bf16* src, int width, int rows,
                          int total_rows, int tid) {
  if (width % 8 == 0 && ld % 8 == 0) {
    const int vw = width / 8, vld = ld / 8;
    const int4 zero = make_int4(0, 0, 0, 0);
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (int i = tid; i < total_rows * vld; i += THREADS) {
      int r = i / vld, c = i - r * vld;
      d[i] = (r < rows && c < vw) ? s[r * vw + c] : zero;
    }
    return;
  }
  for (int i = tid; i < total_rows * ld; i += THREADS) {
    int r = i / ld, c = i - r * ld;
    dst[i] = (r < rows && c < width) ? src[r * width + c] : f2bf(0.f);
  }
}

// kGroup: the B2 instantiation, with a runtime layer loop over a.layer[];
// the single-layer one (B1, B3, B4) indexes a.layer[0] statically, which
// keeps its weight pointers out of registers (239 registers and no spill,
// against 255 and a spill for the looped body on sm_90a).
template <bool kGroup>
__global__ void __launch_bounds__(THREADS, 1)
fused_layer_prefix_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int Dp = a.Dp, hdp = a.hdp, D = a.D, T2 = a.T2;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);         // [ROWS, Dp] residual
  bf16* hs = xs + ROWS * Dp;                            // [ROWS, Dp] LN output
  bf16* ys = hs + ROWS * Dp;                            // [ROWS, ywidth] attn out / MLP chunk
  bf16* qkv = ys + ROWS * a.ywidth;                     // [ROWS, 3*hdp] one head
  float* stage_all = reinterpret_cast<float*>(qkv + ROWS * 3 * hdp);
  const int pkv_rows = a.envs_per_block * a.P;
  bf16* pks = reinterpret_cast<bf16*>(stage_all + WARPS * 256);  // [envs*P, D]
  bf16* pvs = pks + pkv_rows * D;                                  // [envs*P, D]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* stage = stage_all + warp * 256;
  const int env0 = blockIdx.x * a.envs_per_block;
  const int n_env = min(a.envs_per_block, a.B - env0);
  const int nrows = n_env * T2;
  const size_t row0 = static_cast<size_t>(env0) * T2;
  int sidx = 0;
  if (a.idx != nullptr) {
    sidx = *a.idx;
    sidx = sidx < 0 ? 0 : (sidx >= a.S ? a.S - 1 : sidx);
  }
  const size_t prow = (static_cast<size_t>(sidx) * a.B + env0) * a.P;

  // ---- load x (ragged env edge and pad columns as zero); between layers
  //      the residual stays in xs -------------------------------------------
  load_rows(xs, Dp, a.x + row0 * D, D, nrows, ROWS, tid);
  const int n_layers = kGroup ? a.n_layers : 1;
  for (int l = 0; l < n_layers; ++l) {
    const LayerArgs& w = a.layer[kGroup ? l : 0];
    // ---- this layer's prefix K/V of this tile, sigma row `sidx`; clear ys --
    if (a.P > 0) {
      load_rows(pks, D, w.pk + prow * D, D, n_env * a.P, pkv_rows, tid);
      load_rows(pvs, D, w.pv + prow * D, D, n_env * a.P, pkv_rows, tid);
    }
    for (int i = tid; i < ROWS * a.ywidth; i += THREADS) ys[i] = f2bf(0.f);
    __syncthreads();
    layernorm_rows(xs, hs, w.ln1_s, w.ln1_b, D, Dp, nrows, warp, lane);
    __syncthreads();

    // ---- attention, head by head ------------------------------------------
    const int tpp = hdp / 16;       // column tiles per q/k/v part of one head
    const int qkv_ld = 3 * hdp;
    for (int h = 0; h < a.H; ++h) {
      for (int n = warp; n < 3 * tpp; n += WARPS) {
        const int part = n / tpp, sub = n - part * tpp;
        const int wrow = (part * a.H + h) * hdp + sub * 16;
        FragC acc[RT];
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) wmma::fill_fragment(acc[rt], 0.f);
        mma_rows(acc, hs, Dp, w.wqkv + static_cast<size_t>(wrow) * Dp, Dp, Dp / 16);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          wmma::store_matrix_sync(stage, acc[rt], 16, wmma::mem_row_major);
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            int e = lane * 8 + i, r = rt * 16 + (e >> 4), c = e & 15;
            qkv[r * qkv_ld + part * hdp + sub * 16 + c] = f2bf(stage[e] + w.bqkv[wrow + c]);
          }
          __syncwarp();
        }
      }
      __syncthreads();

      for (int r = warp; r < nrows; r += WARPS) {
        const int el = r / T2, t = r - el * T2;
        const bf16* pkr = pks + el * a.P * D + h * a.hd;
        const bf16* pvr = pvs + el * a.P * D + h * a.hd;
        const bf16* own = qkv + el * T2 * qkv_ld;   // this env's first suffix row
        float qv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          int d = lane + 32 * i;
          qv[i] = d < a.hd ? bf2f(qkv[r * qkv_ld + d]) : 0.f;
        }
        const int nk = a.P + t + 1;
        float sc[MAX_KEYS];
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < MAX_KEYS; ++j) {
          if (j < nk) {
            const bf16* kr = j < a.P ? pkr + j * D : own + (j - a.P) * qkv_ld + hdp;
            float part = 0.f;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              int d = lane + 32 * i;
              if (d < a.hd) part += qv[i] * bf2f(kr[d]);
            }
            sc[j] = warp_sum(part) * a.scale;
            m = fmaxf(m, sc[j]);
          }
        }
        float den = 0.f;
#pragma unroll
        for (int j = 0; j < MAX_KEYS; ++j) {
          if (j < nk) {
            sc[j] = expf(sc[j] - m);
            den += sc[j];
          }
        }
        const float inv = 1.f / den;
        float yv[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < MAX_KEYS; ++j) {
          if (j < nk) {
            const float p = round_bf(sc[j] * inv);
            const bf16* vr = j < a.P ? pvr + j * D : own + (j - a.P) * qkv_ld + 2 * hdp;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              int d = lane + 32 * i;
              if (d < a.hd) yv[i] += p * bf2f(vr[d]);
            }
          }
        }
        bf16* yr = ys + r * a.ywidth + h * hdp;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          int d = lane + 32 * i;
          if (d < hdp) yr[d] = f2bf(d < a.hd ? yv[i] : 0.f);
        }
      }
      __syncthreads();
    }

    // ---- proj + residual (in place on xs; A operand is ys) ----------------
    const int ntD = Dp / 16;
    for (int n = warp; n < ntD; n += WARPS) {
      FragC acc[RT];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) wmma::fill_fragment(acc[rt], 0.f);
      mma_rows(acc, ys, a.ywidth, w.wproj + static_cast<size_t>(n) * 16 * a.HDp, a.HDp,
               a.HDp / 16);
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        wmma::store_matrix_sync(stage, acc[rt], 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          int e = lane * 8 + i, r = rt * 16 + (e >> 4), c = n * 16 + (e & 15);
          if (r < nrows && c < D)
            xs[r * Dp + c] = f2bf(bf2f(xs[r * Dp + c]) + round_bf(stage[e] + w.bproj[c]));
        }
        __syncwarp();
      }
    }
    __syncthreads();
    layernorm_rows(xs, hs, w.ln2_s, w.ln2_b, D, Dp, nrows, warp, lane);
    __syncthreads();

    // ---- MLP: hidden layer streamed in FC-column chunks, fc2 in registers --
    FragC out_acc[MAX_OUT_TILES][RT];
#pragma unroll
    for (int j = 0; j < MAX_OUT_TILES; ++j)
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) wmma::fill_fragment(out_acc[j][rt], 0.f);
    bf16* gbuf = ys;   // [ROWS, FC], ys is free after the projection
    for (int c0 = 0; c0 < a.F; c0 += FC) {
      const int nt = min(FC, a.F - c0) / 16;
      for (int n = warp; n < nt; n += WARPS) {
        FragC acc[RT];
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) wmma::fill_fragment(acc[rt], 0.f);
        mma_rows(acc, hs, Dp, w.wfc + static_cast<size_t>(c0 + n * 16) * Dp, Dp, Dp / 16);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          wmma::store_matrix_sync(stage, acc[rt], 16, wmma::mem_row_major);
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            int e = lane * 8 + i, r = rt * 16 + (e >> 4), c = n * 16 + (e & 15);
            gbuf[r * FC + c] = f2bf(gelu_tanh(round_bf(stage[e] + w.bfc[c0 + c])));
          }
          __syncwarp();
        }
      }
      __syncthreads();
      for (int k = 0; k < nt; ++k) {
        FragA fa[RT];
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
          wmma::load_matrix_sync(fa[rt], gbuf + rt * 16 * FC + k * 16, FC);
#pragma unroll
        for (int j = 0; j < MAX_OUT_TILES; ++j) {
          const int n = warp + j * WARPS;
          if (n < ntD) {
            FragB fb;
            wmma::load_matrix_sync(fb, w.wfc2 + static_cast<size_t>(n) * 16 * a.F + c0 + k * 16,
                                   a.F);
#pragma unroll
            for (int rt = 0; rt < RT; ++rt)
              wmma::mma_sync(out_acc[j][rt], fa[rt], fb, out_acc[j][rt]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < MAX_OUT_TILES; ++j) {
      const int n = warp + j * WARPS;
      if (n < ntD) {
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          wmma::store_matrix_sync(stage, out_acc[j][rt], 16, wmma::mem_row_major);
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            int e = lane * 8 + i, r = rt * 16 + (e >> 4), c = n * 16 + (e & 15);
            if (r < nrows && c < D)
              xs[r * Dp + c] = f2bf(bf2f(xs[r * Dp + c]) + round_bf(stage[e] + w.bfc2[c]));
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();
  }  // layers

  for (int i = tid; i < nrows * D; i += THREADS) {
    int r = i / D, c = i - r * D;
    a.out[(row0 + r) * D + c] = xs[r * Dp + c];
  }

  // ---- optional epilogue: ln_f in f32 + f32 linear head ------------------
  if (a.pred != nullptr) {
    for (int r = warp; r < nrows; r += WARPS) {
      const bf16* xr = xs + r * Dp;
      float mu, rstd;
      row_stats(xr, D, lane, mu, rstd);
      float acc[MAX_M];
#pragma unroll
      for (int m = 0; m < MAX_M; ++m) acc[m] = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float xe = (bf2f(xr[c]) - mu) * rstd * a.lnf_s[c] + a.lnf_b[c];
#pragma unroll
        for (int m = 0; m < MAX_M; ++m)
          if (m < a.M) acc[m] += xe * a.whead[m * D + c];
      }
#pragma unroll
      for (int m = 0; m < MAX_M; ++m) {
        if (m < a.M) {
          const float v = warp_sum(acc[m]);
          if (lane == 0) a.pred[(row0 + r) * a.M + m] = v + a.bhead[m];
        }
      }
    }
  }
}

// The twelve weight pointers of one layer (`FusedLayerParams` order) and its
// prefix cache.
LayerArgs layer_args(const void* const* w, const void* pk, const void* pv) {
  LayerArgs l;
  l.ln1_s = static_cast<const float*>(w[0]);
  l.ln1_b = static_cast<const float*>(w[1]);
  l.wqkv = static_cast<const bf16*>(w[2]);
  l.bqkv = static_cast<const float*>(w[3]);
  l.wproj = static_cast<const bf16*>(w[4]);
  l.bproj = static_cast<const float*>(w[5]);
  l.ln2_s = static_cast<const float*>(w[6]);
  l.ln2_b = static_cast<const float*>(w[7]);
  l.wfc = static_cast<const bf16*>(w[8]);
  l.bfc = static_cast<const float*>(w[9]);
  l.wfc2 = static_cast<const bf16*>(w[10]);
  l.bfc2 = static_cast<const float*>(w[11]);
  l.pk = static_cast<const bf16*>(pk);
  l.pv = static_cast<const bf16*>(pv);
  return l;
}

// Fills the derived sizes, sizes shared memory and launches on `stream`;
// returns cudaGetLastError() (0 = launched). `a.layer[:n_layers]` must be
// set by the caller; `group` takes the B2 instantiation.
int launch(Args& a, bool group, const void* x, const void* idx, int n_layers,
           const void* lnf_s, const void* lnf_b, const void* whead, const void* bhead,
           void* out, void* pred, int B, int T2, int D, int H, int P, int S, int F, int M,
           void* stream) {
  if (n_layers < 1 || n_layers > (group ? MAX_LAYERS : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = static_cast<const bf16*>(x);
  a.idx = static_cast<const int*>(idx);
  a.n_layers = n_layers;
  a.lnf_s = static_cast<const float*>(lnf_s);
  a.lnf_b = static_cast<const float*>(lnf_b);
  a.whead = static_cast<const float*>(whead);
  a.bhead = static_cast<const float*>(bhead);
  a.out = static_cast<bf16*>(out);
  a.pred = static_cast<float*>(pred);
  a.B = B;
  a.T2 = T2;
  a.D = D;
  a.H = H;
  a.P = P;
  a.S = S;
  a.F = F;
  a.M = M;
  a.hd = D / H;
  a.hdp = (a.hd + 15) / 16 * 16;
  a.Dp = (D + 15) / 16 * 16;
  a.HDp = H * a.hdp;
  a.ywidth = a.HDp > FC ? a.HDp : FC;
  a.envs_per_block = ROWS / T2;
  a.scale = 1.0f / sqrtf(static_cast<float>(a.hd));

  const size_t smem = sizeof(bf16) * (2 * ROWS * a.Dp + ROWS * a.ywidth + ROWS * 3 * a.hdp +
                                      2 * a.envs_per_block * P * D) +
                      sizeof(float) * WARPS * 256;
  const auto kernel =
      group ? fused_layer_prefix_kernel<true> : fused_layer_prefix_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + a.envs_per_block - 1) / a.envs_per_block;
  kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches the kernel on `stream` and returns cudaGetLastError()
// (0 = launched). Shapes are checked by the Python wrappers
// (ops/fused_layer.py). `w` points at one layer's twelve weight pointers in
// `FusedLayerParams` order.

// B1: one block against the prefix row `idx` of pk/pv [S, B, P, D].
int beso_fused_layer_prefix(const void* x, const void* pk, const void* pv, const void* idx,
                            const void* const* w, const void* lnf_s, const void* lnf_b,
                            const void* whead, const void* bhead, void* out, void* pred,
                            int B, int T2, int D, int H, int P, int S, int F, int M,
                            void* stream) {
  Args a;
  a.layer[0] = layer_args(w, pk, pv);
  return launch(a, false, x, idx, 1, lnf_s, lnf_b, whead, bhead, out, pred, B, T2, D, H,
                P, S, F, M, stream);
}

// B2: n_layers blocks in one launch. `layers` holds n_layers x 14 pointers:
// each layer's twelve weights, then its pk and pv [S, B, P, D].
int beso_fused_layers_prefix_group(const void* x, const void* idx, const void* const* layers,
                                   int n_layers, const void* lnf_s, const void* lnf_b,
                                   const void* whead, const void* bhead, void* out,
                                   void* pred, int B, int T2, int D, int H, int P, int S,
                                   int F, int M, void* stream) {
  Args a;
  for (int l = 0; l < n_layers && l < MAX_LAYERS; ++l) {
    const void* const* lw = layers + l * LAYER_PTRS;
    a.layer[l] = layer_args(lw, lw[12], lw[13]);
  }
  return launch(a, true, x, idx, n_layers, lnf_s, lnf_b, whead, bhead, out, pred, B, T2,
                D, H, P, S, F, M, stream);
}

// B3: one block against one already selected prefix row, pk/pv [B, P, D].
int beso_fused_layer_with_prefix(const void* x, const void* pk, const void* pv,
                                 const void* const* w, void* out, int B, int T2, int D, int H,
                                 int P, int F, void* stream) {
  Args a;
  a.layer[0] = layer_args(w, pk, pv);
  return launch(a, false, x, nullptr, 1, nullptr, nullptr, nullptr, nullptr, out, nullptr,
                B, T2, D, H, P, 1, F, 0, stream);
}

// B4: one block over the whole causal sequence x [B, T, D], no prefix.
int beso_fused_layer(const void* x, const void* const* w, void* out, int B, int T, int D,
                     int H, int F, void* stream) {
  Args a;
  a.layer[0] = layer_args(w, nullptr, nullptr);
  return launch(a, false, x, nullptr, 1, nullptr, nullptr, nullptr, nullptr, out, nullptr,
                B, T, D, H, 0, 1, F, 0, stream);
}

const char* beso_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Kernel limits the wrapper checks against.
int beso_fused_layer_prefix_limits(int which) {
  switch (which) {
    case 0: return ROWS;
    case 1: return MAX_KEYS;
    case 2: return MAX_M;
    case 3: return WARPS * MAX_OUT_TILES * 16;
    case 4: return MAX_HDP;
    case 5: return MAX_LAYERS;
    default: return -1;
  }
}

}  // extern "C"
