// The f32 form of the fused pre-LN GPT blocks (kernels B1-B4 of
// csrc/fused_layer_prefix.cu) for models that compute in float32, as the
// four fused-layer TPU kernels of beso_tpu/ops/fused_layer.py do when the
// model's dtype is f32 (`fused_layer_prefix_tl_v2` :618-682,
// `fused_layers_prefix_tl_v2_group` :488-561, `fused_layer_with_prefix`
// :258-295, `fused_layer` :298-334). Same entry points, same layouts, same
// sequence of operations:
//
//   LN1 -> fused QKV -> attention over P prefix keys plus the causal own
//   keys -> proj + residual -> LN2 -> 4x tanh-GELU MLP + residual
//   [-> next layer] [-> ln_f + linear head]
//
// Layout: x [B, T2, D] f32, pk/pv [S, B, P, D] f32 per layer (S = 1 for B3),
// out [B, T2, D] f32, pred [B, T2, M] f32; the weights' biases and LayerNorm
// parameters f32 in `FusedLayerParams` order and padding (ops/fused_layer.py).
// The products read the layer's tiled copy (`tile_layer_weights` of an f32
// layer): the B operands in consumption order, each ring chunk a bf16 hi part
// (bf16(w)) followed by its lo part (bf16(w - hi)), both in the K-major
// core-matrix layout of the bf16 body, a chunk holding as many 16-deep
// k-steps as fit F32_SLOT_BYTES (at least one).
//
// Numerics (as the TPU kernels in f32, and the port's plain versions): f32
// operands and accumulation, the bias added in f32, no rounding to bf16
// anywhere; LayerNorm statistics with var = E[x^2] - mu^2 and eps 1e-5;
// softmax in f32 with f32 probabilities; the residual f32 between the layers
// of a group, so a group of N equals N B1 launches bit for bit, and a B3
// launch equals a B1 launch on the same row. The tensor cores take no f32
// operands and TF32 keeps 10 mantissa bits, too few for 2^-12 of max |ref|:
// every product operand is split into bf16 hi + lo (x = hi + lo to ~2^-17
// relative) and each product is hi.hi + lo.hi + hi.lo on `mma.sync`
// m16n8k16 with f32 accumulation, ~2^-16 relative. The attention (a few
// thousand multiply-adds per row) runs on the CUDA cores in plain f32, and
// GELU uses the accurate tanhf (the bf16 body's tanh.approx.f32 errs by
// ~2^-11). Sums whose order could differ between instantiations are written
// with explicit fmaf / __f*_rn, so that no contraction choice of the
// compiler tells B2 from the B1 chain.
//
// What bounds it: at the kitchen serving shape (B = 2048, 2T = 8, D = 360) a
// launch does 51 GFLOP of products, each run three times on the bf16 tensor
// cores, against 71 MB of traffic: operations bound it at ~0.155 ms. The
// design is the simple one that fits shared memory, not yet a fast one:
//   - 32 rows per block (the bf16 body's 64 rows need 286 KB once the
//     residual is f32 and the A tiles are hi/lo pairs), 8 consumer warps as 2
//     row groups of 16 x 4 column groups taking every fourth n8 column tile,
//     and one producer warp;
//   - one producer thread copies the weight chunks into a ring of 2 slots of
//     24 KB with `cp.async.bulk` (full/empty mbarriers), as the bf16 body;
//   - per 16-deep k-step a warp reads its A hi and lo fragments with two
//     `ldmatrix.x4` and each of its B tiles' hi and lo with one (lanes 16-31
//     address the lo chunk), then three `mma.sync`;
//   - epilogues on the accumulator fragments in registers; every A operand
//     (LN output, attention output, GELU chunk) is written as hi/lo bf16
//     tiles with rows of K + 8 elements (conflict-free ldmatrix).
// Shared memory at the kitchen shape, 225,888 of 232,448 bytes: barriers
// 128, ring 2 x 24,576, residual xs 32 x 368 f32 (47,104), LN output hs hi/lo
// 2 x 32 x 376 bf16 (48,128), attention output or two GELU chunks ys
// max(2 x 32 x 392, 4 x 32 x 168) bf16 (50,176), q 32 x 65 f32 (8,320), key
// and value rows 2 x 44 x 65 f32 (22,880). At 32 rows the 512 blocks of a
// launch read the 6.6 MB of hi/lo weights 512 times from L2 (~3.4 GB), and
// the ring is two slots deep: both are the levers of a faster form.
//
// Limits: 32 rows per block, P + T2 <= 32 keys, M <= 16, Dp <= 384,
// hdp <= 64, H * hdp <= 384, at most 8 layers per group; a shape whose shared
// memory does not fit 227 KB (many prefix keys per block) is refused at launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int ROWS = 32;            // token rows per block
constexpr int CONSUMERS = 256;      // 8 warps: 2 row groups x 4 column groups
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int STAGES = 2;           // weight ring slots
constexpr int SLOT_BYTES = 24576;   // one ring slot: a chunk's hi and lo parts
constexpr int FC = 160;             // MLP hidden chunk
constexpr int MAX_KEYS = 32;        // P + T2
constexpr int MAX_M = 16;           // head outputs
constexpr int MAX_DP = 384;
constexpr int MAX_HDP = 64;
constexpr int MAX_HDP_ALL = 384;    // H * hdp, the attention output width
constexpr int MAX_LAYERS = 8;       // layers of one B2 group
constexpr int MAX_SMEM = 232448;    // a block's shared memory on sm_90
constexpr int COL_GROUPS = 4;
// n8 column tiles per warp: QKV (3 hdp <= 192 columns), fc (FC), proj and
// fc2 (Dq <= 384)
constexpr int MT_QKV = 3 * MAX_HDP / 8 / COL_GROUPS;
constexpr int MT_FC = FC / 8 / COL_GROUPS;
constexpr int MT_WIDE = MAX_DP / 8 / COL_GROUPS;

// One layer's weights, tiled weights and prefix cache; the order of the
// first twelve is that of `FusedLayerParams` (ops/fused_layer.py).
struct LayerArgs {
  const float* ln1_s;
  const float* ln1_b;
  const float* wqkv;
  const float* bqkv;
  const float* wproj;
  const float* bproj;
  const float* ln2_s;
  const float* ln2_b;
  const float* wfc;
  const float* bfc;
  const float* wfc2;
  const float* bfc2;
  const bf16* tiles;  // the B operands' hi/lo chunks in consumption order
  const float* pk;    // [S, B, P, D]; unused when P == 0
  const float* pv;
};
constexpr int LAYER_PTRS = sizeof(LayerArgs) / sizeof(void*);

struct Args {
  const float* x;
  const int* idx;     // sigma-grid row of pk/pv; nullptr: row 0
  LayerArgs layer[MAX_LAYERS];
  int n_layers;
  const float* lnf_s;
  const float* lnf_b;
  const float* whead;
  const float* bhead;
  float* out;
  float* pred;
  int B, T2, D, H, P, S, F, M;
  int hd, hdp, Dp, Dq, HDp, n_mlp, envs_per_block, key_rows;
  float scale;
};

// tanh GELU with the accurate tanhf, in the order F.gelu(approximate="tanh")
// writes it.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float u = __fmul_rn(0.7978845608028654f, fmaf(0.044715f, x3, x));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(u)));
}

// x as hi = bf16(x) at p and lo = bf16(x - hi) at p + split.
__device__ __forceinline__ void store_split(bf16* p, int split, float x) {
  const bf16 h = __float2bfloat16(x);
  p[0] = h;
  p[split] = __float2bfloat16(__fsub_rn(x, __bfloat162float(h)));
}

// The consumers' barrier (the producer warp never joins it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// k-steps per ring chunk of a B operand with N rows (hi and lo parts).
__host__ __device__ __forceinline__ int steps_per_chunk(int N) {
  const int k = SLOT_BYTES / (2 * N * 32);
  return k > 0 ? k : 1;
}

// Product p of a layer, in consumption order: rows N and k-steps of its B
// operand. Per head h < H: [q|k|v] (3 hdp x Dp); then proj (Dq x H hdp);
// then per MLP chunk fc (FC x Dp) and fc2 (Dq x FC).
__device__ __forceinline__ void product_shape(const Args& a, int p, int& N, int& ksteps) {
  if (p < a.H) {
    N = 3 * a.hdp;
    ksteps = a.Dp / 16;
  } else if (p == a.H) {
    N = a.Dq;
    ksteps = a.HDp / 16;
  } else if ((p - a.H - 1) % 2 == 0) {
    N = FC;
    ksteps = a.Dp / 16;
  } else {
    N = a.Dq;
    ksteps = FC / 16;
  }
}

// The block's shared memory. A tiles (hs, ys and the GELU chunks) are a hi
// tile [ROWS, K + 8] followed by its lo tile.
struct Smem {
  uint64_t* full;   // [STAGES] a chunk has landed in the slot
  uint64_t* empty;  // [STAGES] the consumer warps are done with the slot
  bf16* slots;      // STAGES x SLOT_BYTES
  float* xs;        // residual [ROWS, Dp]
  bf16* hs;         // LN output, hi/lo [ROWS, Dp + 8]
  bf16* ys;         // attention output hi/lo [ROWS, HDp + 8], or two GELU chunks
  float* qh;        // [ROWS, hdp + 1]
  float* kh;        // [key_rows, hdp + 1]
  float* vh;        // [key_rows, hdp + 1]
};

__host__ __device__ __forceinline__ int ys_elems(int HDp) {
  const int attn = 2 * ROWS * (HDp + 8), gelu = 2 * 2 * ROWS * (FC + 8);
  return attn > gelu ? attn : gelu;
}

__device__ __forceinline__ Smem carve(const Args& a, unsigned char* base) {
  Smem m;
  m.full = reinterpret_cast<uint64_t*>(base);
  m.empty = m.full + STAGES;
  m.slots = reinterpret_cast<bf16*>(base + 128);
  m.xs = reinterpret_cast<float*>(m.slots + STAGES * (SLOT_BYTES / 2));
  m.hs = reinterpret_cast<bf16*>(m.xs + ROWS * a.Dp);
  m.ys = m.hs + 2 * ROWS * (a.Dp + 8);
  m.qh = reinterpret_cast<float*>(m.ys + ys_elems(a.HDp));
  m.kh = m.qh + ROWS * (a.hdp + 1);
  m.vh = m.kh + a.key_rows * (a.hdp + 1);
  return m;
}

// The consumers' view of the weight ring: slot barriers and the running
// chunk count, which the producer thread walks in the same order.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  const bf16* slots;
  int it;
};

// acc[t] (+)= A[r0 : r0 + 16, 0 : 16 ksteps] x B[n8 tile cg + 4 t]^T for the
// warp's tiles t < MT below N / 8, B streamed through the ring as one product
// of N rows; A a hi/lo tile pair with rows of lda elements. accumulate ==
// false starts from zero. Each warp releases a ring slot (one arrival of
// CONSUMERS / 32) once its products that read the slot are done.
template <int MT>
__device__ __forceinline__ void gemm(Ring& ring, float (&acc)[MT][4], const bf16* A, int lda,
                                     int N, int ksteps, bool accumulate) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * (warp & 1), cg = warp >> 1, nt = N >> 3;
  if (!accumulate) {
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;
  }
  const int kpc = steps_per_chunk(N);
  const int split = ROWS * lda;   // A's lo tile
  const bf16* arow = A + (r0 + (lane & 15)) * lda + (lane >> 4) * 8;
  // B: lanes 8 j .. 8 j + 7 address matrix j: j & 1 the k half, j >> 1 hi or lo
  const int bj = lane >> 3;
  for (int k0 = 0; k0 < ksteps; k0 += kpc) {
    const int kn = min(kpc, ksteps - k0);
    const int slot = ring.it % STAGES;
    hopper::mbar_wait(&ring.full[slot], (ring.it / STAGES) & 1);
    const bf16* b = ring.slots + slot * (SLOT_BYTES / 2) + (bj >> 1) * (N * 16 * kn) +
                    (lane & 7) * 8;
    for (int kk = 0; kk < kn; ++kk) {
      const int k = k0 + kk;
      uint32_t ahi[4], alo[4];
      hopper::ldmatrix_x4<false>(ahi, arow + k * 16);
      hopper::ldmatrix_x4<false>(alo, arow + split + k * 16);
      const bf16* bk = b + (2 * kk + (bj & 1)) * (nt * 64);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const int tile = cg + COL_GROUPS * t;
        if (tile < nt) {
          uint32_t bf[4];   // hi k 0-7, hi k 8-15, lo k 0-7, lo k 8-15
          hopper::ldmatrix_x4<false>(bf, bk + tile * 64);
          hopper::mma_16816(acc[t], ahi, bf);
          hopper::mma_16816(acc[t], alo, bf);
          hopper::mma_16816(acc[t], ahi, bf + 2);
        }
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&ring.empty[slot]);
    ++ring.it;
  }
}

// Row and column of accumulator value i of tile t of this warp (hopper.cuh's
// m16n8k16 layout).
__device__ __forceinline__ int acc_row(int i) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return 16 * (warp & 1) + (lane >> 2) + 8 * (i >> 1);
}
__device__ __forceinline__ int acc_col(int t, int i) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return 8 * ((warp >> 1) + COL_GROUPS * t) + 2 * (lane & 3) + (i & 1);
}

// LayerNorm of the residual xs into the hi/lo tile pair hs: one warp per
// row, rows >= nrows and columns >= D zero.
__device__ __forceinline__ void layernorm(const float* xs, bf16* hs, const float* s,
                                          const float* b, int D, int Dp, int nrows, int ctid) {
  const int warp = ctid >> 5, lane = ctid & 31, lda = Dp + 8, split = ROWS * lda;
  for (int r = warp; r < ROWS; r += CONSUMERS / 32) {
    const float* row = xs + r * Dp;
    float sum = 0.f, sq = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float v = row[c];
      sum = __fadd_rn(sum, v);
      sq = fmaf(v, v, sq);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
      sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, o));
    }
    const float mu = __fdiv_rn(sum, static_cast<float>(D));
    const float var = __fsub_rn(__fdiv_rn(sq, static_cast<float>(D)), __fmul_rn(mu, mu));
    const float rstd = rsqrtf(__fadd_rn(var, 1e-5f));
    for (int c = lane; c < Dp; c += 32) {
      const float v = r < nrows && c < D
                          ? fmaf(__fmul_rn(__fsub_rn(row[c], mu), rstd), s[c], b[c])
                          : 0.f;
      store_split(hs + r * lda + c, split, v);
    }
  }
}

// Mean and reciprocal std of row r of xs (whole warp), as `layernorm`.
__device__ __forceinline__ void row_stats(const float* row, int D, int lane, float& mu,
                                          float& rstd) {
  float sum = 0.f, sq = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float v = row[c];
    sum = __fadd_rn(sum, v);
    sq = fmaf(v, v, sq);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
    sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, o));
  }
  mu = __fdiv_rn(sum, static_cast<float>(D));
  rstd = rsqrtf(__fadd_rn(__fsub_rn(__fdiv_rn(sq, static_cast<float>(D)), __fmul_rn(mu, mu)),
                          1e-5f));
}

// Key row of token t of env e: its P prefix keys come first.
__device__ __forceinline__ int key_row(const Args& a, int r) {
  const int e = r / a.T2;
  return e * (a.P + a.T2) + a.P + (r - e * a.T2);
}

// Head h: the block's prefix K/V into their key rows e (P + T2) + j, then
// q, k and v of the tile's rows from the QKV product (bias added) into qh
// and the own key rows.
__device__ __forceinline__ void qkv_head(const Args& a, const LayerArgs& w, Ring& ring,
                                         const Smem& sm, int h, int nrows, int n_env,
                                         const float* pk0, const float* pv0, int ctid) {
  const int ld = a.hdp + 1;
  const int ne = n_env * a.P * a.hd;
  for (int i = ctid; i < 2 * ne; i += CONSUMERS) {
    const bool is_v = i >= ne;
    const int rem = is_v ? i - ne : i, ej = rem / a.hd, d = rem - ej * a.hd;
    const int e = ej / a.P, R = e * (a.P + a.T2) + (ej - e * a.P);
    (is_v ? sm.vh : sm.kh)[R * ld + d] = (is_v ? pv0 : pk0)[ej * a.D + h * a.hd + d];
  }
  float acc[MT_QKV][4];
  gemm<MT_QKV>(ring, acc, sm.hs, a.Dp + 8, 3 * a.hdp, a.Dp / 16, false);
  const int nt = (3 * a.hdp) >> 3, cg = threadIdx.x >> 6;
#pragma unroll
  for (int t = 0; t < MT_QKV; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = acc_row(i), col = acc_col(t, i);
      if (cg + COL_GROUPS * t < nt && r < nrows) {
        const int part = (col >= a.hdp) + (col >= 2 * a.hdp), d = col - part * a.hdp;
        const float v = __fadd_rn(acc[t][i], w.bqkv[(part * a.H + h) * a.hdp + d]);
        if (part == 0)
          sm.qh[r * ld + d] = v;
        else
          (part == 1 ? sm.kh : sm.vh)[key_row(a, r) * ld + d] = v;
      }
    }
  }
}

// Attention of head h on the CUDA cores in f32: 8 threads per row, thread
// `sub` of row r takes keys sub, sub + 8, ... of the row's env (its P prefix
// keys and its causal own keys) and head-dim columns sub, sub + 8, ...;
// the row's max, sum and probabilities pass between its 8 lanes by shuffles.
// Writes the normalised output, hi/lo, into ys columns h hdp + d (rows >=
// nrows zero).
__device__ __forceinline__ void attention_head(const Args& a, const Smem& sm, int h, int nrows,
                                               int ctid) {
  constexpr int KPT = MAX_KEYS / 8, DPT = MAX_HDP / 8;   // keys and columns per thread
  const int ld = a.hdp + 1, lane = ctid & 31, r = ctid >> 3, sub = ctid & 7;
  const bool valid = r < nrows;
  int kb = 0, nk = 0;
  if (valid) {
    const int e = r / a.T2;
    kb = e * (a.P + a.T2);
    nk = a.P + (r - e * a.T2) + 1;
  }
  const float* q = sm.qh + r * ld;
  float s[KPT], mx = -INFINITY;
#pragma unroll
  for (int jj = 0; jj < KPT; ++jj) {
    const int j = sub + 8 * jj;
    s[jj] = -INFINITY;
    if (j < nk) {
      const float* k = sm.kh + (kb + j) * ld;
      float dot = 0.f;
      for (int d = 0; d < a.hd; ++d) dot = fmaf(q[d], k[d], dot);
      s[jj] = __fmul_rn(dot, a.scale);
      mx = fmaxf(mx, s[jj]);
    }
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.f;
#pragma unroll
  for (int jj = 0; jj < KPT; ++jj) {
    s[jj] = s[jj] == -INFINITY ? 0.f : expf(__fsub_rn(s[jj], mx));
    sum = __fadd_rn(sum, s[jj]);
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
  const float inv = sum > 0.f ? __fdiv_rn(1.f, sum) : 0.f;
  float y[DPT];
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) y[dd] = 0.f;
#pragma unroll
  for (int jj = 0; jj < KPT; ++jj) {
#pragma unroll
    for (int src = 0; src < 8; ++src) {
      const float p = __shfl_sync(0xffffffffu, s[jj], (lane & ~7) | src);
      const int j = 8 * jj + src;
      if (j < nk) {
        const float* v = sm.vh + (kb + j) * ld;
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) {
          const int d = sub + 8 * dd;
          if (d < a.hdp) y[dd] = fmaf(p, v[d], y[dd]);
        }
      }
    }
  }
  const int lda = a.HDp + 8;
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) {
    const int d = sub + 8 * dd;
    if (d < a.hdp)
      store_split(sm.ys + r * lda + h * a.hdp + d, ROWS * lda,
                  valid ? __fmul_rn(y[dd], inv) : 0.f);
  }
}

// xs (the residual) += acc + bias over this warp's tiles of a proj or fc2
// product with N columns; rows < nrows and columns < D only.
__device__ __forceinline__ void residual_add(float* xs, const float (&acc)[MT_WIDE][4],
                                             const float* bias, int N, int D, int Dp,
                                             int nrows) {
#pragma unroll
  for (int t = 0; t < MT_WIDE; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = acc_row(i), c = acc_col(t, i);
      if (c < N && r < nrows && c < D) {
        float* p = xs + r * Dp + c;
        *p = __fadd_rn(*p, __fadd_rn(acc[t][i], bias[c]));
      }
    }
  }
}

// The producer (one thread): every weight chunk of every layer, in
// consumption order, into the ring.
template <bool kGroup>
__device__ __forceinline__ void produce(const Args& a, const Smem& sm) {
  const int n_layers = kGroup ? a.n_layers : 1;
  const int n_prod = a.H + 1 + 2 * a.n_mlp;
  int it = 0;
  for (int l = 0; l < n_layers; ++l) {
    const char* src = reinterpret_cast<const char*>(a.layer[kGroup ? l : 0].tiles);
    for (int p = 0; p < n_prod; ++p) {
      int N, ksteps;
      product_shape(a, p, N, ksteps);
      const int kpc = steps_per_chunk(N);
      for (int k0 = 0; k0 < ksteps; k0 += kpc) {
        const uint32_t bytes = 2 * N * 32 * min(kpc, ksteps - k0);
        const int slot = it % STAGES;
        hopper::mbar_wait(&sm.empty[slot], ((it / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&sm.full[slot], bytes);
        hopper::bulk_copy_g2s(sm.slots + slot * (SLOT_BYTES / 2), src, bytes, &sm.full[slot]);
        src += bytes;
        ++it;
      }
    }
  }
}

// One layer over the tile: LN1, QKV and attention head by head, proj +
// residual, LN2, the MLP + residual; the residual stays in sm.xs.
__device__ __forceinline__ void layer(const Args& a, const Smem& sm, const LayerArgs& w,
                                      Ring& ring, int nrows, int n_env, size_t prow) {
  const int ctid = threadIdx.x;
  const int D = a.D, Dp = a.Dp;
  const float* pk0 = a.P > 0 ? w.pk + prow * D : nullptr;
  const float* pv0 = a.P > 0 ? w.pv + prow * D : nullptr;
  layernorm(sm.xs, sm.hs, w.ln1_s, w.ln1_b, D, Dp, nrows, ctid);
  consumer_sync();

  // ---- QKV and attention, head by head --------------------------------------
  for (int h = 0; h < a.H; ++h) {
    qkv_head(a, w, ring, sm, h, nrows, n_env, pk0, pv0, ctid);
    consumer_sync();
    attention_head(a, sm, h, nrows, ctid);
    consumer_sync();
  }

  // ---- proj + residual (A is ys) ------------------------------------------
  {
    float acc[MT_WIDE][4];
    gemm<MT_WIDE>(ring, acc, sm.ys, a.HDp + 8, a.Dq, a.HDp / 16, false);
    residual_add(sm.xs, acc, w.bproj, a.Dq, D, Dp, nrows);
  }
  consumer_sync();
  layernorm(sm.xs, sm.hs, w.ln2_s, w.ln2_b, D, Dp, nrows, ctid);
  consumer_sync();

  // ---- MLP: FC-column chunks of the hidden layer, double-buffered in ys;
  //      the fc2 sums stay in registers ------------------------------------
  float acc2[MT_WIDE][4];
  const int lg = FC + 8, gsplit = ROWS * lg;
  for (int m = 0; m < a.n_mlp; ++m) {
    bf16* gbuf = sm.ys + (m & 1) * 2 * gsplit;
    float acc[MT_FC][4];
    gemm<MT_FC>(ring, acc, sm.hs, Dp + 8, FC, Dp / 16, false);
#pragma unroll
    for (int t = 0; t < MT_FC; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = acc_row(i), c = acc_col(t, i), f = m * FC + c;
        const float g = f < a.F ? gelu_tanh(__fadd_rn(acc[t][i], w.bfc[f])) : 0.f;
        store_split(gbuf + r * lg + c, gsplit, g);
      }
    }
    consumer_sync();
    gemm<MT_WIDE>(ring, acc2, gbuf, lg, a.Dq, FC / 16, m > 0);
  }
  residual_add(sm.xs, acc2, w.bfc2, a.Dq, D, Dp, nrows);
  consumer_sync();
}

// The consumer warps: everything but the weight copies.
template <bool kGroup>
__device__ __forceinline__ void consume(const Args& a, const Smem& sm) {
  const int ctid = threadIdx.x, warp = ctid >> 5, lane = ctid & 31;
  const int n_layers = kGroup ? a.n_layers : 1;
  const int D = a.D, Dp = a.Dp;
  const int env0 = blockIdx.x * a.envs_per_block;
  const int n_env = min(a.envs_per_block, a.B - env0);
  const int nrows = n_env * a.T2;
  const size_t row0 = static_cast<size_t>(env0) * a.T2;
  int sidx = 0;
  if (a.idx != nullptr) {
    sidx = *a.idx;
    sidx = sidx < 0 ? 0 : (sidx >= a.S ? a.S - 1 : sidx);
  }
  const size_t prow = (static_cast<size_t>(sidx) * a.B + env0) * a.P;   // first prefix row
  Ring ring{sm.full, sm.empty, sm.slots, 0};

  // x into the residual; key rows (and their pad columns) start at zero
  const float* x = a.x + row0 * D;
  for (int i = ctid; i < ROWS * Dp; i += CONSUMERS) {
    const int r = i / Dp, c = i - r * Dp;
    sm.xs[i] = r < nrows && c < D ? x[static_cast<size_t>(r) * D + c] : 0.f;
  }
  for (int i = ctid; i < 2 * a.key_rows * (a.hdp + 1); i += CONSUMERS) sm.kh[i] = 0.f;
  consumer_sync();

  for (int l = 0; l < n_layers; ++l)
    layer(a, sm, a.layer[kGroup ? l : 0], ring, nrows, n_env, prow);

  float* out = a.out + row0 * D;
  for (int i = ctid; i < nrows * D; i += CONSUMERS) {
    const int r = i / D;
    out[i] = sm.xs[r * Dp + i - r * D];
  }

  // ---- optional epilogue: ln_f + linear head, f32 ------------------------
  if (a.pred != nullptr) {
    for (int r = warp; r < nrows; r += CONSUMERS / 32) {
      const float* row = sm.xs + r * Dp;
      float mu, rstd;
      row_stats(row, D, lane, mu, rstd);
      float acc[MAX_M];
#pragma unroll
      for (int m = 0; m < MAX_M; ++m) acc[m] = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float xe = fmaf(__fmul_rn(__fsub_rn(row[c], mu), rstd), a.lnf_s[c], a.lnf_b[c]);
#pragma unroll
        for (int m = 0; m < MAX_M; ++m)
          if (m < a.M) acc[m] = fmaf(xe, a.whead[m * D + c], acc[m]);
      }
#pragma unroll
      for (int m = 0; m < MAX_M; ++m) {
        if (m < a.M) {
          float v = acc[m];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
          if (lane == 0) a.pred[(row0 + r) * a.M + m] = __fadd_rn(v, a.bhead[m]);
        }
      }
    }
  }
}

// kGroup: the B2 instantiation, with a runtime layer loop over a.layer[];
// the single-layer one (B1, B3, B4) indexes a.layer[0] statically. Warps 0-7
// consume, warp 8 produces (one thread copies).
template <bool kGroup>
__global__ void __launch_bounds__(THREADS, 1)
fused_layer_f32_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm = carve(a, smem);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&sm.full[s], 1);
      hopper::mbar_init(&sm.empty[s], CONSUMERS / 32);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS) produce<kGroup>(a, sm);
  } else {
    consume<kGroup>(a, sm);
  }
}

// The twelve weight pointers of one layer (`FusedLayerParams` order), its
// tiled weights and its prefix cache.
LayerArgs layer_args(const void* const* w, const void* pk, const void* pv) {
  LayerArgs l;
  l.ln1_s = static_cast<const float*>(w[0]);
  l.ln1_b = static_cast<const float*>(w[1]);
  l.wqkv = static_cast<const float*>(w[2]);
  l.bqkv = static_cast<const float*>(w[3]);
  l.wproj = static_cast<const float*>(w[4]);
  l.bproj = static_cast<const float*>(w[5]);
  l.ln2_s = static_cast<const float*>(w[6]);
  l.ln2_b = static_cast<const float*>(w[7]);
  l.wfc = static_cast<const float*>(w[8]);
  l.bfc = static_cast<const float*>(w[9]);
  l.wfc2 = static_cast<const float*>(w[10]);
  l.bfc2 = static_cast<const float*>(w[11]);
  l.tiles = static_cast<const bf16*>(w[12]);
  l.pk = static_cast<const float*>(pk);
  l.pv = static_cast<const float*>(pv);
  return l;
}

// Fills the derived sizes, sizes shared memory and launches on `stream`;
// returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a
// shape outside the limits. `a.layer[:n_layers]` must be set by the caller.
int launch(Args& a, bool group, const void* x, const void* idx, int n_layers,
           const void* lnf_s, const void* lnf_b, const void* whead, const void* bhead, void* out,
           void* pred, int B, int T2, int D, int H, int P, int S, int F, int M, void* stream) {
  a.x = static_cast<const float*>(x);
  a.idx = static_cast<const int*>(idx);
  a.n_layers = n_layers;
  a.lnf_s = static_cast<const float*>(lnf_s);
  a.lnf_b = static_cast<const float*>(lnf_b);
  a.whead = static_cast<const float*>(whead);
  a.bhead = static_cast<const float*>(bhead);
  a.out = static_cast<float*>(out);
  a.pred = static_cast<float*>(pred);
  a.B = B;
  a.T2 = T2;
  a.D = D;
  a.H = H;
  a.P = P;
  a.S = S;
  a.F = F;
  a.M = M;
  a.hd = H > 0 ? D / H : 0;
  a.hdp = (a.hd + 15) / 16 * 16;
  a.Dp = (D + 15) / 16 * 16;
  a.Dq = (a.Dp + 127) / 128 * 128;
  a.HDp = H * a.hdp;
  a.n_mlp = (F + FC - 1) / FC;
  a.envs_per_block = T2 > 0 ? ROWS / T2 : 0;
  a.key_rows = a.envs_per_block * (P + T2);
  a.scale = 1.0f / sqrtf(static_cast<float>(a.hd > 0 ? a.hd : 1));
  if (n_layers < 1 || n_layers > (group ? MAX_LAYERS : 1) || T2 < 1 || T2 > ROWS ||
      H < 1 || D % H != 0 || P + T2 > MAX_KEYS || M > MAX_M || a.Dp > MAX_DP ||
      a.hdp > MAX_HDP || a.HDp > MAX_HDP_ALL || F % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);

  const size_t smem = 128 + STAGES * SLOT_BYTES + sizeof(float) * ROWS * a.Dp +
                      sizeof(bf16) * (2 * ROWS * (a.Dp + 8) + ys_elems(a.HDp)) +
                      sizeof(float) * (ROWS + 2 * a.key_rows) * (a.hdp + 1);
  if (smem > static_cast<size_t>(MAX_SMEM)) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = group ? fused_layer_f32_kernel<true> : fused_layer_f32_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + a.envs_per_block - 1) / a.envs_per_block;
  kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The f32 forms of the entry points of csrc/fused_layer_prefix.cu, with the
// same arguments (all activations, prefix caches and weights f32; `w[12]`
// the hi/lo tiled weights). Each launches on `stream` and returns
// cudaGetLastError() (0 = launched).

// B1: one block against the prefix row `idx` of pk/pv [S, B, P, D].
int beso_fused_f32_layer_prefix(const void* x, const void* pk, const void* pv, const void* idx,
                                const void* const* w, const void* lnf_s, const void* lnf_b,
                                const void* whead, const void* bhead, void* out, void* pred,
                                int B, int T2, int D, int H, int P, int S, int F, int M,
                                void* stream) {
  Args a;
  a.layer[0] = layer_args(w, pk, pv);
  return launch(a, false, x, idx, 1, lnf_s, lnf_b, whead, bhead, out, pred, B, T2, D, H, P, S,
                F, M, stream);
}

// B2: n_layers blocks in one launch. `layers` holds n_layers x 15 pointers:
// each layer's thirteen (as `w` above), then its pk and pv [S, B, P, D].
int beso_fused_f32_layers_prefix_group(const void* x, const void* idx, const void* const* layers,
                                       int n_layers, const void* lnf_s, const void* lnf_b,
                                       const void* whead, const void* bhead, void* out,
                                       void* pred, int B, int T2, int D, int H, int P, int S,
                                       int F, int M, void* stream) {
  Args a;
  for (int l = 0; l < n_layers && l < MAX_LAYERS; ++l) {
    const void* const* lw = layers + l * LAYER_PTRS;
    a.layer[l] = layer_args(lw, lw[13], lw[14]);
  }
  return launch(a, true, x, idx, n_layers, lnf_s, lnf_b, whead, bhead, out, pred, B, T2, D, H, P,
                S, F, M, stream);
}

// B3: one block against one already selected prefix row, pk/pv [B, P, D].
int beso_fused_f32_layer_with_prefix(const void* x, const void* pk, const void* pv,
                                     const void* const* w, void* out, int B, int T2, int D,
                                     int H, int P, int F, void* stream) {
  Args a;
  a.layer[0] = layer_args(w, pk, pv);
  return launch(a, false, x, nullptr, 1, nullptr, nullptr, nullptr, nullptr, out, nullptr, B, T2,
                D, H, P, 1, F, 0, stream);
}

// B4: one block over the whole causal sequence x [B, T, D], no prefix.
int beso_fused_f32_layer(const void* x, const void* const* w, void* out, int B, int T, int D,
                         int H, int F, void* stream) {
  Args a;
  a.layer[0] = layer_args(w, nullptr, nullptr);
  return launch(a, false, x, nullptr, 1, nullptr, nullptr, nullptr, nullptr, out, nullptr, B, T,
                D, H, 0, 1, F, 0, stream);
}

// Kernel limits the wrapper checks against, and the tiling constants
// `tile_layer_weights` must share with the kernel.
int beso_fused_f32_limits(int which) {
  switch (which) {
    case 0: return ROWS;
    case 1: return MAX_KEYS;
    case 2: return MAX_M;
    case 3: return MAX_DP;
    case 4: return MAX_HDP;
    case 5: return MAX_LAYERS;
    case 6: return MAX_HDP_ALL;
    case 7: return SLOT_BYTES;
    case 8: return FC;
    default: return -1;
  }
}

}  // extern "C"
