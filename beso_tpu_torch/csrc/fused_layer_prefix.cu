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
//   keys -> proj + residual -> LN2 -> 4x GELU MLP + residual (the tanh
//   GELU, or in fused_layer_prefix_erf.cu's build of this source the exact
//   erf one: a template argument, so the tanh instantiations are as they
//   were; as a runtime branch the erf code spilled in B1's register-capped
//   epilogue and slowed the tanh path)
//   [-> next layer] [-> ln_f (f32) + linear head (f32)]
//
// Layout: x [B, T2, D] bf16, pk/pv [S, B, P, D] bf16 per layer (S = 1 for
// B3), out [B, T2, D] bf16, pred [B, T2, M] f32. Biases and LayerNorm
// parameters are f32, in `FusedLayerParams` order and padding
// (ops/fused_layer.py): hdp = ceil16(hd), Dp = ceil16(D), Fp = ceil16(F).
// The weights are read from the layer's tiled copy (`tile_layer_weights`):
// the B operands of the layer's products in the order this kernel consumes
// them (per head [q|k|v] rows x Dp, proj, then per MLP chunk of FC columns
// fc and fc2; proj and fc2 rows padded to Dq = ceil128(Dp), F to a multiple
// of FC), each cut into chunks of whole 16-deep k-steps of at most SLOT_BYTES
// and laid out as the K-major, unswizzled `wgmma` operand (hopper.cuh). The
// per-layer pointers travel in the kernel's parameter struct (MAX_LAYERS x
// 15 pointers, under 1 KB of the 4 KB parameter space).
//
// Limits: 64 rows per block, P + T2 <= 32 keys, the envs of each 16-row
// block at most 48 keys in all, M <= 16, Dp <= 384, hdp <= 64 and
// H * hdp <= 384, at most 8 layers per group; a shape whose shared memory
// does not fit 227 KB (many prefix keys per block) is refused at launch.
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
// per launch, so the products bound it (52 us at the bf16 peak). A 64-row
// block holds its residual, LN output and attention output in shared memory
// and streams the layer's 3.3 MB of weights through them, so the 256 blocks
// pull ~0.85 GB per launch out of L2: next to the products, L2 bandwidth is
// the second limit. The design:
//   - one producer warp copies the weight chunks into a ring of STAGES slots
//     with `cp.async.bulk` (one instruction per chunk, no tensor map),
//     guarded by full/empty mbarriers, up to STAGES chunks ahead;
//   - two consumer warpgroups run every product on `wgmma` (64 x N x 16,
//     bf16, f32 accumulators in registers) with A (LN output, attention
//     output, GELU chunk) and B (the ring slot) in shared memory; each takes
//     half of the output columns, both read every chunk;
//   - the epilogues (bias, bf16 rounding, GELU, residual add, the q/k/v
//     scatter) work on the accumulator fragments in registers; A operands
//     are written in the unswizzled core-matrix layout, where a quad of
//     lanes storing a fragment fills one 16-byte row and a warp one 128-byte
//     core matrix, so the stores are free of bank conflicts;
//   - attention runs on tensor cores too (mma.sync m16n8k16): per 16 query
//     rows the scores against the keys of their envs (at most 48), masked,
//     softmax on the accumulator registers, P.V with P taken from them;
//   - device-memory reads other than the weights wait long behind the
//     copies that fill L2's queues, so they are issued early: the next
//     head's prefix K/V and q/k/v biases over this head's products and
//     attention, the fc bias over the proj products (staged in shared
//     memory); and every register spill is costly, so per-pass addresses
//     are kept from being hoisted across the head and MLP loops.
// One 384-thread block per SM (the shared memory), with `setmaxnreg` moving
// the producer warpgroup's registers to the consumers. The timed
// instantiation adds clock64() marks at the phase boundaries; PERF.md has
// the measurements. B2's layer loop still spills (its body, inlined into
// the loop, keeps more values live than the single-layer one).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

// This source builds the tanh GELU form; fused_layer_prefix_erf.cu includes it
// with BESO_ERF_GELU 1 to build the erf GELU form as a translation unit of
// its own, which the build compiles beside this one, in parallel: its
// kernels are the kErf instantiations, its entries carry `erf_` in their
// names.
#ifndef BESO_ERF_GELU
#define BESO_ERF_GELU 0
#endif

namespace {

constexpr int ROWS = 64;            // token rows per block (one wgmma M)
constexpr int CONSUMERS = 256;      // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int STAGES = 4;           // weight ring slots
constexpr int SLOT_BYTES = 12288;   // one ring slot
constexpr int FC = 160;             // MLP hidden chunk: 80 columns per warpgroup
constexpr int MAX_KEYS = 32;        // P + T2
constexpr int MAX_M = 16;           // head outputs
constexpr int MAX_DP = 384;
constexpr int NSUB = MAX_DP / 128;  // n64 subtiles per warpgroup for proj and fc2
constexpr int MAX_HDP = 64;
constexpr int MAX_HDP_ALL = 384;    // H * hdp, the attention output width
constexpr int MAX_LAYERS = 8;       // layers of one B2 group
constexpr int PREFETCH = 6;         // prefix K/V pairs per thread held over a QKV product
constexpr int BFC_PER_THREAD = 6;   // fc bias values per thread staged in shared memory
constexpr int MMA_KEYS = 48;        // keys of the envs of a 16-row block (attention)
constexpr int MAX_SMEM = 232448;    // a block's shared memory on sm_90

// Phases of the timed instantiation (clock64() cycles summed per block).
enum Phase { PH_LOAD, PH_LN1, PH_QKV, PH_ATTN, PH_PROJ, PH_LN2, PH_FC, PH_FC2,
             PH_WRITE, PH_EPI, N_PHASES };

// Per-block phase clock of the timed instantiation; a no-op otherwise.
// Thread 0 (a consumer) reads clock64() right after a consumer barrier, or
// after its warpgroup's product, and adds the cycles since the previous
// mark to the phase that just ended.
template <bool kOn>
struct PhaseClock {
  long long t = 0, acc[N_PHASES] = {};
  __device__ __forceinline__ void start() {
    if (kOn && threadIdx.x == 0) t = clock64();
  }
  __device__ __forceinline__ void mark(int ph) {
    if (kOn && threadIdx.x == 0) {
      const long long now = clock64();
      acc[ph] += now - t;
      t = now;
    }
  }
  __device__ __forceinline__ void store(long long* out) {
    if (kOn && threadIdx.x == 0)
      for (int i = 0; i < N_PHASES; ++i) out[blockIdx.x * N_PHASES + i] = acc[i];
  }
};

// One layer's weights, tiled weights and prefix cache; the order of the
// first twelve is that of `FusedLayerParams` (ops/fused_layer.py).
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
  const bf16* tiles;  // the B operands in consumption order (header note)
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
  long long* cycles;  // [blocks, N_PHASES] (timed instantiation only)
  int B, T2, D, H, P, S, F, M;
  int hd, hdp, Dp, Dq, HDp, n_mlp, envs_per_block, key_rows;
  float scale;
};

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ float round_bf(float v) { return bf2f(f2bf(v)); }

// tanh GELU with the hardware tanh (tanh.approx.f32, relative error about
// 2^-11, below the bf16 rounding that follows it).
__device__ __forceinline__ float gelu_tanh(float x) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.7978845608028654f * (x + 0.044715f * x * x * x)));
  return 0.5f * x * (1.0f + t);
}

// The exact GELU with the accurate erff, 0.5 x (1 + erf(x / sqrt 2)): the
// reference's nn.GELU(), for its checkpoints.
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

template <bool kErf>
__device__ __forceinline__ float gelu(float x) {
  return kErf ? gelu_erf(x) : gelu_tanh(x);
}

// A zero the compiler cannot see through. Added to the shared-memory
// offsets of a head's or an MLP chunk's epilogue and of attention, it keeps
// their addresses, the same in every pass, from being hoisted out of the
// loop and held (and spilled) across it.
__device__ __forceinline__ int opaque_zero() {
  int z = 0;
  asm volatile("" : "+r"(z));
  return z;
}

// The consumers' barrier (the producer warp never joins it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// Element offset of (row r, column c) in an A tile of the core-matrix
// layout: 8-column groups of 1 KB (64 rows x 16 bytes), 8-row blocks of 128
// bytes inside. The residual, LN output, attention output and GELU chunk
// all use it.
__device__ __forceinline__ int a_off(int r, int c) {
  return (c >> 3) * 512 + (r >> 3) * 64 + (r & 7) * 8 + (c & 7);
}

// Row and column of accumulator value i of this thread (hopper.cuh).
__device__ __forceinline__ int frag_row(int i) {
  const int t = threadIdx.x & 127;
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// k-steps per ring chunk of a B operand with N rows.
__host__ __device__ __forceinline__ int steps_per_chunk(int N) {
  const int k = SLOT_BYTES / (N * 32);
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

// The block's shared memory: barriers, the weight ring and the tiles.
struct Smem {
  uint64_t* full;   // [STAGES] a chunk has landed in the slot
  uint64_t* empty;  // [STAGES] the consumers are done with the slot
  bf16* slots;      // STAGES x SLOT_BYTES
  bf16* xs;         // residual, A tile [ROWS, Dp]
  bf16* hs;         // LN output, A tile [ROWS, Dp]
  bf16* ys;         // attention output [ROWS, HDp] or two GELU chunks [ROWS, FC]
  bf16* qh;         // [ROWS, hdp + 8]
  bf16* kh;         // [key_rows, hdp + 8]
  bf16* vh;         // [key_rows, hdp + 8]
  float* stats;     // [2, 4, ROWS]
};

__device__ __forceinline__ Smem carve(const Args& a, unsigned char* base) {
  Smem m;
  m.full = reinterpret_cast<uint64_t*>(base);
  m.empty = m.full + STAGES;
  m.slots = reinterpret_cast<bf16*>(base + 128);
  m.xs = m.slots + STAGES * (SLOT_BYTES / 2);
  m.hs = m.xs + ROWS * a.Dp;
  m.ys = m.hs + ROWS * a.Dp;
  m.qh = m.ys + max(ROWS * a.HDp, 2 * ROWS * FC);
  m.kh = m.qh + ROWS * (a.hdp + 8);
  m.vh = m.kh + a.key_rows * (a.hdp + 8);
  m.stats = reinterpret_cast<float*>(m.vh + a.key_rows * (a.hdp + 8));
  return m;
}

// The consumers' view of the weight ring: slot barriers and the running
// chunk count, which the producer warp walks in the same order.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  const bf16* slots;
  int it;
};

// acc[s] (+)= A[64, 16 ksteps] x B[n0 + s NW : n0 + (s + 1) NW, :]^T for
// s < ns, B streamed through the ring as one product of N rows. acc holds
// NS x NW / 2 values; accumulate == false starts from zero. Each consumer
// warp releases a ring slot (one arrival of CONSUMERS / 32) once its share
// of the products that read the slot is complete.
template <int NW, int NS>
__device__ __forceinline__ void gemm(Ring& ring, float* acc, const bf16* A, int N, int ksteps,
                                     int n0, int ns, bool accumulate) {
  const int kpc = steps_per_chunk(N);
  const uint32_t b_lbo = N * 16;
  int prev = -1;
  hopper::fence_regs<NS * NW / 2>(acc);
  hopper::wgmma_fence();
  for (int k0 = 0; k0 < ksteps; k0 += kpc) {
    const int kn = min(kpc, ksteps - k0);
    const int slot = ring.it % STAGES;
    hopper::mbar_wait(&ring.full[slot], (ring.it / STAGES) & 1);
    const bf16* b = ring.slots + slot * (SLOT_BYTES / 2);
    for (int kk = 0; kk < kn; ++kk) {
      const int k = k0 + kk;
      const uint64_t da = hopper::smem_desc(A + k * 1024, 1024, 128);
      const int scale_d = (accumulate || k > 0) ? 1 : 0;
#pragma unroll
      for (int s = 0; s < NS; ++s)
        if (s < ns)
          hopper::wgmma<NW>(acc + s * (NW / 2), da,
                            hopper::smem_desc(b + kk * N * 16 + ((n0 + s * NW) >> 3) * 64, b_lbo,
                                              128),
                            scale_d);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    if (prev >= 0 && (threadIdx.x & 31) == 0) hopper::mbar_arrive(&ring.empty[prev]);
    prev = slot;
    ++ring.it;
  }
  hopper::wgmma_wait<0>();
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(&ring.empty[prev]);
  hopper::fence_regs<NS * NW / 2>(acc);
}

// proj and fc2: gemm over ns = Dq / 128 subtiles of 64 columns per
// warpgroup, ns fixed at compile time so that no product is predicated.
__device__ __forceinline__ void gemm_wide(Ring& ring, float* acc, const bf16* A, int N,
                                          int ksteps, int n0, int ns, bool accumulate) {
  switch (ns) {
    case 1: gemm<64, 1>(ring, acc, A, N, ksteps, n0, 1, accumulate); break;
    case 2: gemm<64, 2>(ring, acc, A, N, ksteps, n0, 2, accumulate); break;
    default: gemm<64, NSUB>(ring, acc, A, N, ksteps, n0, NSUB, accumulate); break;
  }
}

// x rows [0, nrows) of width D into the A tile xs; pad rows and columns
// are zero. In the A layout the 64 rows of one 8-column group are 64
// consecutive 16-byte rows.
__device__ __forceinline__ void load_x(bf16* xs, const bf16* x, int D, int Dp, int nrows,
                                       int ctid) {
  for (int i = ctid; i < ROWS * (Dp / 8); i += CONSUMERS) {
    const int r = i & (ROWS - 1), c0 = (i >> 6) * 8;
    const bool in = r < nrows && c0 < D;
    if (D % 8 == 0 || !in) {
      *reinterpret_cast<uint4*>(xs + a_off(r, c0)) =
          in ? *reinterpret_cast<const uint4*>(x + static_cast<size_t>(r) * D + c0)
             : make_uint4(0, 0, 0, 0);
    } else {
      for (int j = 0; j < 8; ++j)
        xs[a_off(r, c0 + j)] = c0 + j < D ? x[static_cast<size_t>(r) * D + c0 + j] : f2bf(0.f);
    }
  }
}

// The tile's rows [0, nrows) of the A tile xs into out [nrows, D].
__device__ __forceinline__ void write_out(bf16* out, const bf16* xs, int D, int Dp, int nrows,
                                          int ctid) {
  for (int i = ctid; i < ROWS * (Dp / 8); i += CONSUMERS) {
    const int r = i & (ROWS - 1), c0 = (i >> 6) * 8;
    if (r >= nrows || c0 >= D) continue;
    if (D % 8 == 0) {
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(r) * D + c0) =
          *reinterpret_cast<const uint4*>(xs + a_off(r, c0));
    } else {
      for (int j = 0; j < 8 && c0 + j < D; ++j)
        out[static_cast<size_t>(r) * D + c0 + j] = xs[a_off(r, c0 + j)];
    }
  }
}

// Two floats rounded to bf16 and packed, and back.
__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack_bf2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// LayerNorm of the A tile src into the A tile dst; pad rows (>= nrows) and
// pad columns (>= D) of dst are zero. Thread t takes row t % 64 and every
// fourth 8-column group from t / 64, so a warp reads 32 consecutive 16-byte
// rows; `stats` holds the 2 x 4 x 64 partial sums. Ends with the fence that
// hands dst to `wgmma` (the caller's barrier completes the hand-over).
__device__ __forceinline__ void layernorm(const bf16* src, bf16* dst, const float* s,
                                          const float* b, int D, int Dp, int nrows, float* stats,
                                          int ctid) {
  const int r = ctid & (ROWS - 1), q = ctid >> 6;
  float sum = 0.f, sq = 0.f;
  for (int c0 = q * 8; c0 < Dp; c0 += 32) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + a_off(r, c0));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const float2 f = unpack_bf2(w[j / 2]);
      const float f0 = c0 + j < D ? f.x : 0.f, f1 = c0 + j + 1 < D ? f.y : 0.f;
      sum += f0 + f1;
      sq += f0 * f0 + f1 * f1;
    }
  }
  stats[q * ROWS + r] = sum;
  stats[4 * ROWS + q * ROWS + r] = sq;
  consumer_sync();
  float ts = 0.f, tq = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ts += stats[k * ROWS + r];
    tq += stats[4 * ROWS + k * ROWS + r];
  }
  const float mu = ts / D, rstd = rsqrtf(tq / D - mu * mu + 1e-5f);
  for (int c0 = q * 8; c0 < Dp; c0 += 32) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + a_off(r, c0));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const float2 f = unpack_bf2(w[j / 2]);
      const int c = c0 + j;
      o[j / 2] = pack_bf2(r < nrows && c < D ? (f.x - mu) * rstd * s[c] + b[c] : 0.f,
                          r < nrows && c + 1 < D ? (f.y - mu) * rstd * s[c + 1] + b[c + 1]
                                                 : 0.f);
    }
    *reinterpret_cast<uint4*>(dst + a_off(r, c0)) = make_uint4(o[0], o[1], o[2], o[3]);
  }
  hopper::fence_proxy_async();
}

// Where this block's prefix K/V elements go, per head: element (e, j, d)
// of pk/pv (env e, prefix key j, head dim d) is read at ej D + h hd + d from
// the block's first prefix row, and written to key row R = e (P + T2) + j
// of kh or vh (both rows of hdp + 8; vh follows kh). With hd even they
// move in pairs, np = n_env P hd / 2 for K and as many for V (K first):
// thread ctid takes pairs ctid + q CONSUMERS.
__device__ __forceinline__ void prefix_place(const Args& a, int ej, int d, bool is_v, int& src,
                                             int& dst) {
  const int e = ej / a.P, R = e * (a.P + a.T2) + (ej - e * a.P);
  src = ej * a.D + d;
  dst = (is_v ? a.key_rows + R : R) * (a.hdp + 8) + d;
}

__device__ __forceinline__ void prefix_pair(const Args& a, int np, int i, int& src, int& dst) {
  const bool is_v = i >= np;
  const int rem = is_v ? i - np : i, half = a.hd >> 1;
  const int ej = rem / half;
  prefix_place(a, ej, 2 * (rem - ej * half), is_v, src, dst);
}

// What a thread reads from device memory for one head's QKV products,
// issued a head ahead so that the loads' latency (long while the weight
// copies fill L2's queues) hides behind the previous head's work:
// its planned prefix K/V pairs and, for ctid < 3 hdp, one of the head's
// q/k/v biases. `store` puts them in place once that attention is done:
// the pairs into kh/vh, the biases into `bias_s` [3 hdp].
struct HeadLoads {
  uint32_t pre[PREFETCH];
  float bias;

  __device__ __forceinline__ void load(const Args& a, const LayerArgs& w, int h,
                                       const bf16* pk0, const bf16* pv0, int np, int ctid) {
    const int z = opaque_zero();
    const bf16* pkh = pk0 + h * a.hd + z;
    const bf16* pvh = pv0 + h * a.hd + z;
#pragma unroll
    for (int q = 0; q < PREFETCH; ++q) {
      const int i = ctid + q * CONSUMERS + z;
      if (i < 2 * np) {
        int src, dst;
        prefix_pair(a, np, i, src, dst);
        pre[q] = *reinterpret_cast<const uint32_t*>((i < np ? pkh : pvh) + src);
      }
    }
    if (ctid < 3 * a.hdp) {
      const int part = ctid / a.hdp;
      bias = w.bqkv[(part * a.H + h) * a.hdp + ctid - part * a.hdp];
    }
  }

  __device__ __forceinline__ void store(const Args& a, const Smem& sm, int np, float* bias_s,
                                        int ctid) const {
    bf16* kh = sm.kh + opaque_zero();
#pragma unroll
    for (int q = 0; q < PREFETCH; ++q) {
      const int i = ctid + q * CONSUMERS;
      if (i < 2 * np) {
        int src, dst;
        prefix_pair(a, np, i, src, dst);
        *reinterpret_cast<uint32_t*>(kh + dst) = pre[q];
      }
    }
    if (ctid < 3 * a.hdp) bias_s[ctid] = bias;
  }
};

// Head h's q, k and v of the tile's rows: q into qh, the own keys and
// values at key row e (P + T2) + P + t of env e, token t (kh, vh: rows of
// hdp + 8), with the bias from `bias_s`; the prefix keys and values beyond
// HeadLoads' share (or all of them, hd odd) go straight from device memory
// to their key rows e (P + T2) + j. The two warpgroups take NW = 3 hdp / 2
// columns of [q|k|v] each.
template <int NW>
__device__ __forceinline__ void qkv_head(const Args& a, Ring& ring, const Smem& sm, int h,
                                         int nrows, int n_env, const bf16* pk0,
                                         const bf16* pv0, int np,
                                         const float* bias_s, int ctid) {
  const int z = opaque_zero();
  bf16 *qh = sm.qh + z, *kh = sm.kh + z, *vh = sm.vh + z;
  bias_s += z;
  const int wg = ctid >> 7, qs = a.hdp + 8;
  const bf16* pkh = pk0 + h * a.hd;
  const bf16* pvh = pv0 + h * a.hd;
  for (int i = ctid + PREFETCH * CONSUMERS; i < 2 * np; i += CONSUMERS) {
    int src, dst;
    prefix_pair(a, np, i, src, dst);
    *reinterpret_cast<uint32_t*>(kh + dst) =
        *reinterpret_cast<const uint32_t*>((i < np ? pkh : pvh) + src);
  }
  if (a.hd & 1) {   // odd head dim: element by element
    const int ne = n_env * a.P * a.hd;
    for (int i = ctid; i < 2 * ne; i += CONSUMERS) {
      const bool is_v = i >= ne;
      const int rem = is_v ? i - ne : i, ej = rem / a.hd;
      int src, dst;
      prefix_place(a, ej, rem - ej * a.hd, is_v, src, dst);
      kh[dst] = (is_v ? pvh : pkh)[src];
    }
  }

  float acc[NW / 2];
  gemm<NW, 1>(ring, acc, sm.hs, 3 * a.hdp, a.Dp / 16, wg * NW, 1, false);
  // this thread's two fragment rows and their own key rows
  int key_row[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = frag_row(2 * u), e = r / a.T2;
    key_row[u] = e * (a.P + a.T2) + a.P + (r - e * a.T2);
  }
#pragma unroll
  for (int i = 0; i < NW / 2; i += 2) {
    const int r = frag_row(i);
    if (r < nrows) {
      const int col = wg * NW + frag_col(i);
      const int part = (col >= a.hdp) + (col >= 2 * a.hdp), d = col - part * a.hdp;
      const int R = key_row[(i >> 1) & 1];
      bf16* dst = part == 0 ? qh + r * qs + d : (part == 1 ? kh : vh) + R * qs + d;
      *reinterpret_cast<uint32_t*>(dst) =
          pack_bf2(acc[i] + bias_s[col], acc[i + 1] + bias_s[col + 1]);
    }
  }
}

// Attention of head h on tensor cores (mma.sync m16n8k16, bf16, f32
// accumulation): warp w takes the 16 query rows from 16 (w % 4) and half of
// the head dim (w / 4). The keys are the key rows of the envs those rows
// belong to (at most MMA_KEYS; the launch checks): S = q k^T over them,
// masked to each row's own env and causal position and scaled by
// 1/sqrt(hd), softmax in f32 with the probabilities rounded to bf16, then
// O = P V with P taken from S's accumulator registers.
__device__ __forceinline__ void attention_head(const Args& a, const Smem& sm, int h, int nrows,
                                               int ctid) {
  constexpr int NT = MMA_KEYS / 8;   // key tiles of 8
  const int z = opaque_zero();
  const bf16 *qh = sm.qh + z, *kh = sm.kh + z, *vh = sm.vh + z;
  bf16* ys = sm.ys + z;
  const int warp = ctid >> 5, lane = ctid & 31, g = lane >> 2, q4 = lane & 3;
  const int r0 = 16 * (warp & 3);
  if (r0 >= nrows) return;
  const int qs = a.hdp + 8, pt = a.P + a.T2;
  const int kb = (r0 / a.T2) * pt;                                 // the block's first key
  const int nt = ((min(r0 + 15, nrows - 1) / a.T2 + 1) * pt - kb + 7) >> 3;
  int lo[2], hi[2];   // this thread's rows g, g + 8: their keys, relative to kb
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = r0 + g + 8 * u, e = r / a.T2;
    lo[u] = r < nrows ? e * pt - kb : 1;
    hi[u] = r < nrows ? lo[u] + a.P + (r - e * a.T2) : 0;
  }
  float sc[NT][4] = {};
  for (int k0 = 0; k0 < a.hdp; k0 += 16) {
    uint32_t qf[4];
    hopper::ldmatrix_x4<false>(qf, qh + (r0 + (lane & 15)) * qs + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j < nt) {
        uint32_t kf[4];   // key tiles j, j + 1
        const int row = min(kb + (j + (lane >> 4)) * 8 + (lane & 7), a.key_rows - 1);
        hopper::ldmatrix_x4<false>(kf, kh + row * qs + k0 + ((lane >> 3) & 1) * 8);
        hopper::mma_16816(sc[j], qf, kf);
        hopper::mma_16816(sc[j + 1], qf, kf + 2);
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = i >> 1, kc = 8 * j + 2 * q4 + (i & 1);
      sc[j][i] = j < nt && kc >= lo[u] && kc <= hi[u] ? sc[j][i] * a.scale : -INFINITY;
      mx[u] = fmaxf(mx[u], sc[j][i]);
    }
#pragma unroll
  for (int u = 0; u < 2; ++u)
    for (int o = 1; o < 4; o <<= 1) mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], o));
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = i >> 1;
      sc[j][i] = sc[j][i] == -INFINITY ? 0.f : __expf(sc[j][i] - mx[u]);
      sum[u] += sc[j][i];
    }
  float inv[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    for (int o = 1; o < 4; o <<= 1) sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], o);
    inv[u] = sum[u] > 0.f ? 1.f / sum[u] : 0.f;
  }
  const int half = (warp >> 2) * (a.hdp >> 1), ndt = a.hdp >> 4;   // 8-wide dim tiles per half
  float out[4][4] = {};
#pragma unroll
  for (int s2 = 0; s2 < NT / 2; ++s2) {
    if (2 * s2 < nt) {
      const uint32_t pf[4] = {pack_bf2(sc[2 * s2][0] * inv[0], sc[2 * s2][1] * inv[0]),
                              pack_bf2(sc[2 * s2][2] * inv[1], sc[2 * s2][3] * inv[1]),
                              pack_bf2(sc[2 * s2 + 1][0] * inv[0], sc[2 * s2 + 1][1] * inv[0]),
                              pack_bf2(sc[2 * s2 + 1][2] * inv[1], sc[2 * s2 + 1][3] * inv[1])};
      const int row = min(kb + 16 * s2 + (lane & 7) + ((lane >> 3) & 1) * 8, a.key_rows - 1);
#pragma unroll
      for (int t = 0; t < 4; t += 2) {
        if (t < ndt) {
          uint32_t vf[4];   // dim tiles t, t + 1
          hopper::ldmatrix_x4<true>(vf, vh + row * qs + half + 8 * t + (lane >> 4) * 8);
          hopper::mma_16816(out[t], pf, vf);
          hopper::mma_16816(out[t + 1], pf, vf + 2);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + g + 8 * u;
      if (t < ndt && r < nrows)
        *reinterpret_cast<uint32_t*>(ys + a_off(r, h * a.hdp + half + 8 * t + 2 * q4)) =
            pack_bf2(out[t][2 * u], out[t][2 * u + 1]);
    }
}

// xs (the residual, A tile) += round_bf(acc + bias) over this warpgroup's
// columns [n0, n0 + 64 ns) of a proj or fc2 product; rows < nrows and
// columns < D only.
__device__ __forceinline__ void residual_add(bf16* xs, const float* acc, const float* bias,
                                             int n0, int ns, int D, int nrows) {
#pragma unroll
  for (int s = 0; s < NSUB; ++s) {
    if (s < ns) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = frag_row(i), c = n0 + 64 * s + frag_col(i);
        if (r < nrows && c < D) {
          bf16* p = xs + a_off(r, c);
          *p = f2bf(bf2f(*p) + round_bf(acc[s * 32 + i] + bias[c]));
        }
      }
    }
  }
}

// Mean and reciprocal std of row r of the A tile xs (whole warp), f32.
__device__ __forceinline__ void row_stats(const bf16* xs, int r, int D, int lane, float& mu,
                                          float& rstd) {
  float sum = 0.f, sq = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float v = bf2f(xs[a_off(r, c)]);
    sum += v;
    sq += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  mu = sum / D;
  rstd = rsqrtf(sq / D - mu * mu + 1e-5f);
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
        const uint32_t bytes = N * 32 * min(kpc, ksteps - k0);
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

// QKV and attention, head by head, for NW = 3 hdp / 2. The next head's
// device loads are in flight over this head's products and attention; the
// LayerNorm statistics buffer holds the head's biases.
template <int NW, bool kTimed>
__device__ __forceinline__ void heads(const Args& a, const LayerArgs& w, Ring& ring,
                                      const Smem& sm, PhaseClock<kTimed>& clk,
                                      int np, int nrows, int n_env,
                                      const bf16* pk0, const bf16* pv0, int ctid) {
  float* bias_s = sm.stats;   // free between the two LayerNorms
  HeadLoads ld;
  ld.load(a, w, 0, pk0, pv0, np, ctid);
  ld.store(a, sm, np, bias_s, ctid);
  consumer_sync();
  for (int h = 0; h < a.H; ++h) {
    if (h + 1 < a.H) ld.load(a, w, h + 1, pk0, pv0, np, ctid);
    qkv_head<NW>(a, ring, sm, h, nrows, n_env, pk0, pv0, np, bias_s, ctid);
    consumer_sync();
    clk.mark(PH_QKV);
    attention_head(a, sm, h, nrows, ctid);
    hopper::fence_proxy_async();
    consumer_sync();
    clk.mark(PH_ATTN);
    if (h + 1 < a.H) {
      ld.store(a, sm, np, bias_s, ctid);
      consumer_sync();
    }
  }
}


// One layer over the tile: LN1, QKV and attention head by head, proj +
// residual, LN2, the MLP + residual; the residual stays in sm.xs.
template <bool kTimed, bool kErf>
__device__ __forceinline__ void layer(const Args& a, const Smem& sm, const LayerArgs& w,
                                      Ring& ring, PhaseClock<kTimed>& clk, int np,
                                      int nrows, int n_env, size_t prow) {
  bf16 *xs = sm.xs, *hs = sm.hs, *ys = sm.ys;
  float* stats = sm.stats;
  const int ctid = threadIdx.x, wg = ctid >> 7;
  const int D = a.D, Dp = a.Dp;
  const int ns = a.Dq / 128;   // n64 subtiles per warpgroup of proj and fc2
  const bf16* pk0 = w.pk + prow * D;
  const bf16* pv0 = w.pv + prow * D;
  layernorm(xs, hs, w.ln1_s, w.ln1_b, D, Dp, nrows, stats, ctid);
  consumer_sync();
  clk.mark(PH_LN1);

  // ---- QKV and attention, head by head --------------------------------------
  switch (a.hdp) {
    case 16: heads<24>(a, w, ring, sm, clk, np, nrows, n_env, pk0, pv0, ctid); break;
    case 32: heads<48>(a, w, ring, sm, clk, np, nrows, n_env, pk0, pv0, ctid); break;
    case 48: heads<72>(a, w, ring, sm, clk, np, nrows, n_env, pk0, pv0, ctid); break;
    default: heads<96>(a, w, ring, sm, clk, np, nrows, n_env, pk0, pv0, ctid); break;
  }

  // ---- proj + residual (A is ys) ------------------------------------------
  // The fc bias goes to shared memory (qh is free until the next layer),
  // loaded before the proj products and stored after them, so that the MLP
  // chunks' epilogues do not each wait on device memory.
  float* bfc_s = reinterpret_cast<float*>(sm.qh);
  const bool staged = a.F <= BFC_PER_THREAD * CONSUMERS && a.F * 4 <= ROWS * (a.hdp + 8) * 2;
  float bfc_r[BFC_PER_THREAD];
#pragma unroll
  for (int q = 0; q < BFC_PER_THREAD; ++q)
    if (staged && ctid + q * CONSUMERS < a.F) bfc_r[q] = w.bfc[ctid + q * CONSUMERS];
  {
    float acc[NSUB * 32];
    gemm_wide(ring, acc, ys, a.Dq, a.HDp / 16, wg * 64 * ns, ns, false);
    residual_add(xs, acc, w.bproj, wg * 64 * ns, ns, D, nrows);
  }
#pragma unroll
  for (int q = 0; q < BFC_PER_THREAD; ++q)
    if (staged && ctid + q * CONSUMERS < a.F) bfc_s[ctid + q * CONSUMERS] = bfc_r[q];
  const float* bfc = staged ? bfc_s : w.bfc;
  consumer_sync();
  clk.mark(PH_PROJ);
  layernorm(xs, hs, w.ln2_s, w.ln2_b, D, Dp, nrows, stats, ctid);
  consumer_sync();
  clk.mark(PH_LN2);

  // ---- MLP: FC-column chunks of the hidden layer, double-buffered in ys;
  //      the fc2 sums stay in registers ------------------------------------
  {
    float acc2[NSUB * 32];
    for (int m = 0; m < a.n_mlp; ++m) {
      bf16* gbuf = ys + (m & 1) * ROWS * FC + opaque_zero();
      float acc[FC / 4];
      gemm<FC / 2, 1>(ring, acc, hs, FC, Dp / 16, wg * (FC / 2), 1, false);
#pragma unroll
      for (int i = 0; i < FC / 4; i += 2) {
        const int c = wg * (FC / 2) + frag_col(i), f = m * FC + c;
        const float g0 = f < a.F ? gelu<kErf>(round_bf(acc[i] + bfc[f])) : 0.f;
        const float g1 = f + 1 < a.F ? gelu<kErf>(round_bf(acc[i + 1] + bfc[f + 1])) : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(gbuf + a_off(frag_row(i), c)) =
            __floats2bfloat162_rn(g0, g1);
      }
      hopper::fence_proxy_async();
      consumer_sync();
      clk.mark(PH_FC);
      gemm_wide(ring, acc2, gbuf, a.Dq, FC / 16, wg * 64 * ns, ns, m > 0);
      clk.mark(PH_FC2);
    }
    residual_add(xs, acc2, w.bfc2, wg * 64 * ns, ns, D, nrows);
  }
  consumer_sync();
  clk.mark(PH_FC2);
}

// The two consumer warpgroups: everything but the weight copies.
template <bool kGroup, bool kTimed, bool kErf>
__device__ __forceinline__ void consume(const Args& a, const Smem& sm) {
  bf16 *xs = sm.xs, *kh = sm.kh;
  const int tid = threadIdx.x;
  const int n_layers = kGroup ? a.n_layers : 1;
  PhaseClock<kTimed> clk;
  clk.start();
  const int ctid = tid, warp = ctid >> 5, lane = ctid & 31;
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
  const int np = (a.hd & 1) == 0 ? n_env * a.P * (a.hd >> 1) : 0;   // prefix K/V pairs
  Ring ring{sm.full, sm.empty, sm.slots, 0};

  // x (the residual stays in xs between the layers of a group); key rows
  // that no token or prefix fills stay zero
  load_x(xs, a.x + row0 * D, D, Dp, nrows, ctid);
  for (int i = ctid; i < 2 * a.key_rows * (a.hdp + 8); i += CONSUMERS) kh[i] = f2bf(0.f);
  consumer_sync();
  clk.mark(PH_LOAD);

  for (int l = 0; l < n_layers; ++l) {
    layer<kTimed, kErf>(a, sm, a.layer[kGroup ? l : 0], ring, clk, np, nrows, n_env, prow);
  }

  write_out(a.out + row0 * D, xs, D, Dp, nrows, ctid);
  if (kTimed) consumer_sync();
  clk.mark(PH_WRITE);

  // ---- optional epilogue: ln_f in f32 + f32 linear head ------------------
  if (a.pred != nullptr) {
    for (int r = warp; r < nrows; r += CONSUMERS / 32) {
      float mu, rstd;
      row_stats(xs, r, D, lane, mu, rstd);
      float acc[MAX_M];
#pragma unroll
      for (int m = 0; m < MAX_M; ++m) acc[m] = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float xe = (bf2f(xs[a_off(r, c)]) - mu) * rstd * a.lnf_s[c] + a.lnf_b[c];
#pragma unroll
        for (int m = 0; m < MAX_M; ++m)
          if (m < a.M) acc[m] += xe * a.whead[m * D + c];
      }
#pragma unroll
      for (int m = 0; m < MAX_M; ++m) {
        if (m < a.M) {
          float v = acc[m];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
          if (lane == 0) a.pred[(row0 + r) * a.M + m] = v + a.bhead[m];
        }
      }
    }
  }
  if (kTimed) consumer_sync();
  clk.mark(PH_EPI);
  clk.store(a.cycles);
}

// kGroup: the B2 instantiation, with a runtime layer loop over a.layer[];
// the single-layer one (B1, B3, B4) indexes a.layer[0] statically. kTimed:
// B1 with the phase clock (tanh GELU only). kErf: the erf GELU. Warpgroups
// 0 and 1 consume, warpgroup 2 produces (one thread copies); `setmaxnreg`
// moves the producer's registers to the consumers: the 384-thread launch
// holds 168 x 384 registers, which become 40 for each producer thread and
// 232 for each consumer thread.
template <bool kGroup, bool kTimed = false, bool kErf = false>
__global__ void __launch_bounds__(THREADS, 1)
fused_layer_prefix_kernel(const __grid_constant__ Args a) {
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
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) produce<kGroup>(a, sm);
  } else {
    hopper::setmaxnreg_inc<232>();
    consume<kGroup, kTimed, kErf>(a, sm);
  }
}

// The twelve weight pointers of one layer (`FusedLayerParams` order), its
// tiled weights and its prefix cache.
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
  l.tiles = static_cast<const bf16*>(w[12]);
  l.pk = static_cast<const bf16*>(pk);
  l.pv = static_cast<const bf16*>(pv);
  return l;
}

// Fills the derived sizes, sizes shared memory and launches on `stream`;
// returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a
// shape outside the limits. `a.layer[:n_layers]` must be set by the caller;
// `group` takes the B2 instantiation, a non-null `cycles` the timed
// single-layer one; in the erf unit the kErf instantiations (no timed one).
int launch(Args& a, bool group, long long* cycles, const void* x, const void* idx,
           int n_layers, const void* lnf_s, const void* lnf_b, const void* whead,
           const void* bhead, void* out, void* pred, int B, int T2, int D, int H, int P, int S,
           int F, int M, void* stream) {
  a.x = static_cast<const bf16*>(x);
  a.idx = static_cast<const int*>(idx);
  a.n_layers = n_layers;
  a.lnf_s = static_cast<const float*>(lnf_s);
  a.lnf_b = static_cast<const float*>(lnf_b);
  a.whead = static_cast<const float*>(whead);
  a.bhead = static_cast<const float*>(bhead);
  a.out = static_cast<bf16*>(out);
  a.pred = static_cast<float*>(pred);
  a.cycles = cycles;
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
  a.Dq = (a.Dp + 127) / 128 * 128;
  a.HDp = H * a.hdp;
  a.n_mlp = (F + FC - 1) / FC;
  a.envs_per_block = T2 > 0 ? ROWS / T2 : 0;
  a.key_rows = a.envs_per_block * (P + T2);
  bool keys_fit = true;   // every 16-row block's envs hold <= MMA_KEYS keys
  for (int r0 = 0; T2 > 0 && r0 < a.envs_per_block * T2; r0 += 16) {
    const int r1 = min(r0 + 15, a.envs_per_block * T2 - 1);
    keys_fit = keys_fit && (r1 / T2 - r0 / T2 + 1) * (P + T2) <= MMA_KEYS;
  }
  a.scale = 1.0f / sqrtf(static_cast<float>(a.hd));
  if (n_layers < 1 || n_layers > (group ? MAX_LAYERS : 1) || T2 < 1 || T2 > ROWS ||
      P + T2 > MAX_KEYS || M > MAX_M || a.Dp > MAX_DP || a.hdp > MAX_HDP ||
      a.HDp > MAX_HDP_ALL || F % 16 != 0 || !keys_fit)
    return static_cast<int>(cudaErrorInvalidValue);

  const size_t smem =
      128 + STAGES * SLOT_BYTES +
      sizeof(bf16) * (2 * ROWS * a.Dp + (ROWS * a.HDp > 2 * ROWS * FC ? ROWS * a.HDp
                                                                        : 2 * ROWS * FC) +
                      (ROWS + 2 * a.key_rows) * (a.hdp + 8)) +
      sizeof(float) * 8 * ROWS;
  if (smem > static_cast<size_t>(MAX_SMEM)) return static_cast<int>(cudaErrorInvalidValue);
#if BESO_ERF_GELU
  if (cycles) return static_cast<int>(cudaErrorInvalidValue);   // the clock times tanh B1
  const auto kernel = group ? fused_layer_prefix_kernel<true, false, true>
                            : fused_layer_prefix_kernel<false, false, true>;
#else
  const auto kernel = group ? fused_layer_prefix_kernel<true>
                      : cycles ? fused_layer_prefix_kernel<false, true>
                               : fused_layer_prefix_kernel<false>;
#endif
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + a.envs_per_block - 1) / a.envs_per_block;
  kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#if BESO_ERF_GELU
// the erf unit's entries: the names below with `erf_` after the prefix
#define beso_fused_layer_prefix beso_fused_erf_layer_prefix
#define beso_fused_layers_prefix_group beso_fused_erf_layers_prefix_group
#define beso_fused_layer_with_prefix beso_fused_erf_layer_with_prefix
#define beso_fused_layer beso_fused_erf_layer
#endif

extern "C" {

// Each entry launches the kernel on `stream` and returns cudaGetLastError()
// (0 = launched). Shapes are checked by the Python wrappers
// (ops/fused_layer.py). `w` points at one layer's thirteen pointers: the
// twelve weights in `FusedLayerParams` order, then its tiled weights.

// B1: one block against the prefix row `idx` of pk/pv [S, B, P, D].
int beso_fused_layer_prefix(const void* x, const void* pk, const void* pv, const void* idx,
                            const void* const* w, const void* lnf_s, const void* lnf_b,
                            const void* whead, const void* bhead, void* out, void* pred,
                            int B, int T2, int D, int H, int P, int S, int F, int M,
                            void* stream) {
  Args a;
  a.layer[0] = layer_args(w, pk, pv);
  return launch(a, false, nullptr, x, idx, 1, lnf_s, lnf_b, whead, bhead, out, pred, B, T2,
                D, H, P, S, F, M, stream);
}

#if !BESO_ERF_GELU
// B1 with the phase clock: as beso_fused_layer_prefix, and each block adds
// its clock64() cycles per phase (enum Phase) to cycles [blocks, N_PHASES].
int beso_fused_layer_prefix_timed(const void* x, const void* pk, const void* pv,
                                  const void* idx, const void* const* w, const void* lnf_s,
                                  const void* lnf_b, const void* whead, const void* bhead,
                                  void* out, void* pred, void* cycles, int B, int T2, int D,
                                  int H, int P, int S, int F, int M, void* stream) {
  Args a;
  a.layer[0] = layer_args(w, pk, pv);
  return launch(a, false, static_cast<long long*>(cycles), x, idx, 1, lnf_s, lnf_b, whead,
                bhead, out, pred, B, T2, D, H, P, S, F, M, stream);
}
#endif

// B2: n_layers blocks in one launch. `layers` holds n_layers x 15 pointers:
// each layer's thirteen (as `w` above), then its pk and pv [S, B, P, D].
int beso_fused_layers_prefix_group(const void* x, const void* idx, const void* const* layers,
                                   int n_layers, const void* lnf_s, const void* lnf_b,
                                   const void* whead, const void* bhead, void* out,
                                   void* pred, int B, int T2, int D, int H, int P, int S,
                                   int F, int M, void* stream) {
  Args a;
  for (int l = 0; l < n_layers && l < MAX_LAYERS; ++l) {
    const void* const* lw = layers + l * LAYER_PTRS;
    a.layer[l] = layer_args(lw, lw[13], lw[14]);
  }
  return launch(a, true, nullptr, x, idx, n_layers, lnf_s, lnf_b, whead, bhead, out, pred,
                B, T2, D, H, P, S, F, M, stream);
}

// B3: one block against one already selected prefix row, pk/pv [B, P, D].
int beso_fused_layer_with_prefix(const void* x, const void* pk, const void* pv,
                                 const void* const* w, void* out, int B, int T2, int D, int H,
                                 int P, int F, void* stream) {
  Args a;
  a.layer[0] = layer_args(w, pk, pv);
  return launch(a, false, nullptr, x, nullptr, 1, nullptr, nullptr, nullptr, nullptr, out,
                nullptr, B, T2, D, H, P, 1, F, 0, stream);
}

// B4: one block over the whole causal sequence x [B, T, D], no prefix.
int beso_fused_layer(const void* x, const void* const* w, void* out, int B, int T, int D,
                     int H, int F, void* stream) {
  Args a;
  a.layer[0] = layer_args(w, nullptr, nullptr);
  return launch(a, false, nullptr, x, nullptr, 1, nullptr, nullptr, nullptr, nullptr, out,
                nullptr, B, T, D, H, 0, 1, F, 0, stream);
}

#if !BESO_ERF_GELU
const char* beso_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Kernel limits the wrapper checks against, and the tiling constants
// `tile_layer_weights` must share with the kernel.
int beso_fused_layer_prefix_limits(int which) {
  switch (which) {
    case 0: return ROWS;
    case 1: return MAX_KEYS;
    case 2: return MAX_M;
    case 3: return MAX_DP;
    case 4: return MAX_HDP;
    case 5: return MAX_LAYERS;
    case 6: return N_PHASES;
    case 7: return MAX_HDP_ALL;
    case 8: return SLOT_BYTES;
    case 9: return FC;
    case 10: return MMA_KEYS;
    default: return -1;
  }
}
#endif

}  // extern "C"
