// The f32 form of the fused pre-LN GPT blocks (kernels B1-B4 of
// csrc/fused_layer_prefix.cu) for models that compute in float32, as the
// four fused-layer TPU kernels of beso_tpu/ops/fused_layer.py do when the
// model's dtype is f32 (`fused_layer_prefix_tl_v2` :618-682,
// `fused_layers_prefix_tl_v2_group` :488-561, `fused_layer_with_prefix`
// :258-295, `fused_layer` :298-334). Same entry points, same layouts, same
// sequence of operations:
//
//   LN1 -> fused QKV -> attention over P prefix keys plus the causal own
//   keys -> proj + residual -> LN2 -> 4x GELU MLP + residual (tanh, or in
//   fused_layer_f32_erf.cu's build of this source the exact erf GELU: a
//   template argument, so the tanh instantiations are as they were)
//   [-> next layer] [-> ln_f + linear head]
//
// Layout: x [B, T2, D] f32, pk/pv [S, B, P, D] f32 per layer (S = 1 for B3),
// out [B, T2, D] f32, pred [B, T2, M] f32; the weights' biases and LayerNorm
// parameters f32 in `FusedLayerParams` order and padding (ops/fused_layer.py).
// The products read the layer's tiled copy (`tile_layer_weights` of an f32
// layer): the B operands in consumption order (per head its [q|k|v] rows,
// then that head's proj columns; then per MLP chunk fc and fc2), each cut
// into chunks of as many 16-deep k-steps as fit SLOT_BYTES (at least one),
// each chunk a bf16 hi part (bf16(w)) followed by its lo part (bf16(w - hi)),
// both in the K-major core-matrix layout of the bf16 body; one chunk fills
// a ring slot.
//
// Numerics (as the TPU kernels in f32, and the port's plain versions): f32
// operands and accumulation, the bias added in f32, no rounding to bf16
// anywhere; LayerNorm statistics with var = E[x^2] - mu^2 and eps 1e-5;
// softmax in f32 with f32 probabilities; the residual f32 between the layers
// of a group, so a group of N equals N B1 launches bit for bit, and a B3
// launch equals a B1 launch on the same row. The tensor cores take no f32
// operands and TF32 keeps 10 mantissa bits, too few for 2^-12 of max |ref|:
// every product operand is split into bf16 hi + lo (x = hi + lo to ~2^-17
// relative) and each product is hi.hi + lo.hi + hi.lo on `wgmma` with f32
// accumulation, ~2^-16 relative. The residual is the accumulator of the proj
// and fc2 products: x + bias first, then the products summed onto it. The
// attention (a few thousand multiply-adds per row) runs on the CUDA cores in
// plain f32, and GELU uses the accurate tanhf (the bf16 body's
// tanh.approx.f32 errs by ~2^-11) or, in its erf form, the accurate erff.
// Sums whose order could differ between instantiations are written with
// explicit fmaf / __f*_rn, so that no contraction choice of the compiler
// tells B2 from the B1 chain.
//
// What bounds it: at the kitchen serving shape (B = 2048, 2T = 8, D = 360) a
// launch does 51 GFLOP of products, each run three times on the bf16 tensor
// cores, against 71 MB of traffic: operations bound it at ~0.155 ms. What
// holds it back on the card is the block's serial work around the products
// (PERF.md has the phase clock): per ring chunk a wait, the copy's issue and
// a release; the attention on the CUDA cores at 8 warps per SM; the epilogues
// between the products. The design:
//   - 64 token rows per block (one `wgmma` M), two warpgroups each taking
//     half of every product's columns and nothing else: 256 threads, so
//     ptxas may give each up to 255 registers (registers are split among
//     the SM's four warp schedulers, so a ninth warp, a producer, caps every
//     thread at 168, and the residual spills);
//   - blocks in clusters of 2 that fetch each weight chunk once: thread 0 of
//     the cluster's block 0 copies every chunk with one multicast
//     `cp.async.bulk` into the slot of both blocks, once the slot's "empty"
//     barrier in block 0 has the arrivals of the warps of both blocks (block
//     1's through `mapa`); thread 0 of block 1 only announces each chunk's
//     bytes on its own "full" barrier. 128 rows share each L2 fetch, so a
//     kitchen launch reads ~0.85 GB from L2, not 3.4 GB. Thread 0 issues a
//     chunk as soon as its slot is free (checked at every chunk, up to
//     STAGES - 1 ahead) and waits for a slot only for the chunk it is about
//     to use. The remote arrival takes the default (CTA-scope) semantics of
//     CUTLASS's cluster barrier: `.release.cluster` made every chunk pay for
//     a cluster-scope fence, and B1 slower on the card;
//   - a ring of STAGES slots of one chunk each (hi and lo parts), released as
//     soon as its products are done: on the card the ring's depth (4 or 6
//     slots of half a chunk) changed nothing, and the count of chunks (each
//     a wait, a release and a copy) a lot;
//   - the residual in registers, as the proj and fc2 accumulators (64 rows x
//     Dq / 2 columns per warpgroup, up to 96 f32 per thread); LayerNorm's
//     row sums meet in a small shared exchange. proj runs head by head right
//     after the head's attention (K = hdp per head), so shared memory holds
//     one head's output (in the room of its q, once the scores are done),
//     and only the final residual goes to shared memory (the LN tile's
//     room) for the write-out and the ln_f + head epilogue.
// Shared memory at the kitchen shape, 231,488 of 232,448 bytes: barriers and
// the LN exchange 1,152, ring 3 x 24,576, LN output hi/lo 2 x 64 x 368 bf16
// (94,208), then max(q 64 x 65 f32 or the head's output hi/lo 2 x 64 x 64
// bf16, + key and value rows 2 x 88 x 65 f32; the GELU chunk hi/lo 2 x 64 x
// 160 bf16) = 62,400: the aliases pay for the ring's 24 KB slots. A block
// with no rows (the second of the last cluster, when the grid has an odd
// number of tiles) computes on zeros and writes nothing, so that its peer's
// ring protocol completes; a cluster barrier before the exit keeps either
// block alive while the other may still write its shared memory or arrive
// on its barriers.
//
// Limits: 64 rows per block, P + T2 <= 32 keys, M <= 16, Dp <= 384,
// hdp <= 64, H * hdp <= 384, at most 8 layers per group; a shape whose shared
// memory does not fit 227 KB (many prefix keys per block) is refused at launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

// This source builds the tanh GELU form; fused_layer_f32_erf.cu includes it
// with BESO_ERF_GELU 1 to build the erf GELU form as a translation unit of
// its own, which the build compiles beside this one, in parallel: its
// kernels are the kErf instantiations, its entries carry `erf_` in their
// names.
#ifndef BESO_ERF_GELU
#define BESO_ERF_GELU 0
#endif

namespace {

constexpr int ROWS = 64;            // token rows per block (one wgmma M)
constexpr int THREADS = 256;        // two warpgroups
constexpr int CLUSTER = 2;          // blocks that share each weight chunk
constexpr int STAGES = 3;           // weight ring slots
constexpr int SLOT_BYTES = 24576;   // one ring slot: a chunk's hi and lo parts
constexpr int FC = 160;             // MLP hidden chunk: 80 columns per warpgroup
constexpr int MAX_KEYS = 32;        // P + T2
constexpr int MAX_M = 16;           // head outputs
constexpr int MAX_DP = 384;
constexpr int NSUB = MAX_DP / 128;  // n64 subtiles per warpgroup of proj and fc2
constexpr int RES = NSUB * 32;      // residual values per consumer thread
constexpr int MAX_HDP = 64;
constexpr int MAX_HDP_ALL = 384;    // H * hdp
constexpr int MAX_LAYERS = 8;       // layers of one B2 group
constexpr int MAX_SMEM = 232448;    // a block's shared memory on sm_90
constexpr int TPR = THREADS / ROWS;  // attention threads per row
constexpr int BAR_BYTES = 128;      // full and empty barriers
constexpr int STATS_BYTES = sizeof(float) * 2 * 2 * ROWS;   // [warpgroup][sum, sq][row]

// Phases of the timed instantiation (clock64() cycles summed per block), and
// PH_RING: the cycles thread 0 spent on the ring (waiting for a slot to fill
// or to free, issuing the copies), held apart from the phase that waited.
enum Phase { PH_LOAD, PH_LN1, PH_QKV, PH_ATTN, PH_PROJ, PH_LN2, PH_FC, PH_FC2,
             PH_WRITE, PH_EPI, PH_RING, N_PHASES };

// Per-block phase clock of the timed instantiation; a no-op otherwise.
// Thread 0 reads clock64() at the phase boundaries (after a block barrier,
// or after its warpgroup's product) and adds the cycles since the previous
// mark, less its ring waits, to the phase that just ended.
template <bool kOn>
struct PhaseClock {
  long long t = 0, wait = 0, acc[N_PHASES] = {};
  __device__ __forceinline__ void start() {
    if (kOn && threadIdx.x == 0) t = clock64();
  }
  __device__ __forceinline__ long long now() const {
    return kOn && threadIdx.x == 0 ? clock64() : 0;
  }
  __device__ __forceinline__ void waited(long long since) {
    if (kOn && threadIdx.x == 0) wait += clock64() - since;
  }
  __device__ __forceinline__ void mark(int ph) {
    if (kOn && threadIdx.x == 0) {
      const long long now = clock64();
      acc[ph] += now - t - wait;
      acc[PH_RING] += wait;
      wait = 0;
      t = now;
    }
  }
  __device__ __forceinline__ void store(long long* out) const {
    if (kOn && threadIdx.x == 0)
      for (int i = 0; i < N_PHASES; ++i) out[blockIdx.x * N_PHASES + i] = acc[i];
  }
};

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
  long long* cycles;  // [blocks, N_PHASES] (timed instantiation only)
  int B, T2, D, H, P, S, F, M;
  int hd, hdp, Dp, Dq, n_mlp, envs_per_block, key_rows;
  float scale;
};

// tanh GELU with the accurate tanhf, in the order F.gelu(approximate="tanh")
// writes it.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float u = __fmul_rn(0.7978845608028654f, fmaf(0.044715f, x3, x));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(u)));
}

// The exact GELU with the accurate erff, 0.5 x (1 + erf(x / sqrt 2)): the
// reference's nn.GELU(), for its checkpoints.
__device__ __forceinline__ float gelu_erf(float x) {
  const float e = erff(__fmul_rn(x, 0.7071067811865476f));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, e));
}

template <bool kErf>
__device__ __forceinline__ float gelu(float x) {
  return kErf ? gelu_erf(x) : gelu_tanh(x);
}

// Element offset of (row r, column c) in an A tile of the core-matrix
// layout: 8-column groups of 1 KB (64 rows x 16 bytes), 8-row blocks of 128
// bytes inside (as the bf16 body). A hi/lo pair of tiles with K columns is
// the hi tile followed by the lo tile, ROWS * K elements on.
__device__ __forceinline__ int a_off(int r, int c) {
  return (c >> 3) * 512 + (r >> 3) * 64 + (r & 7) * 8 + (c & 7);
}

// Two values as bf16 hi parts at p and lo parts (x - hi) at p + split (one
// 32-bit store each; p 4-byte aligned).
__device__ __forceinline__ void store_split2(bf16* p, int split, float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  *reinterpret_cast<__nv_bfloat162*>(p) = h;
  *reinterpret_cast<__nv_bfloat162*>(p + split) =
      __floats2bfloat162_rn(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y));
}

// x as hi = bf16(x) at p and lo = bf16(x - hi) at p + split.
__device__ __forceinline__ void store_split(bf16* p, int split, float x) {
  const bf16 h = __float2bfloat16(x);
  p[0] = h;
  p[split] = __float2bfloat16(__fsub_rn(x, __bfloat162float(h)));
}

// Row and column of accumulator value i of this thread of its warpgroup
// (hopper.cuh's m64nNk16 layout).
__device__ __forceinline__ int frag_row(int i) {
  const int t = threadIdx.x & 127;
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// k-steps per ring chunk of a B operand with N rows (hi and lo parts).
__host__ __device__ __forceinline__ int steps_per_chunk(int N) {
  const int k = SLOT_BYTES / (2 * N * 32);
  return k > 0 ? k : 1;
}

// The block's shared memory (the same carve in both blocks of a cluster:
// the multicast copies land at the same offsets).
struct Smem {
  uint64_t* full;   // [STAGES] a chunk has landed in the slot
  uint64_t* empty;  // [STAGES] both blocks' warps are done with the slot (block 0's)
  float* stats;     // [2 warpgroups][sum, sq][ROWS] LayerNorm row sums
  bf16* slots;      // STAGES x SLOT_BYTES
  bf16* hs;         // LN output, hi/lo A tiles [ROWS, Dp]; f32 [ROWS, Dp] at the end
  bf16* ys;         // one head's output, hi/lo A tiles [ROWS, hdp], in the
                    // room of its q; or the GELU chunk, hi/lo A tiles [ROWS, FC]
  float* qh;        // [ROWS, hdp + 1]
  float* kh;        // [key_rows, hdp + 1]
  float* vh;        // [key_rows, hdp + 1]
};

// Bytes of q (or the head output it turns into), 16-byte aligned.
__host__ __device__ __forceinline__ size_t q_bytes(int hdp) {
  return (sizeof(float) * ROWS * (hdp + 1) + 15) / 16 * 16;
}

// The room after the LN tiles: q or the head output, then the key and value
// rows; or the GELU chunk.
__host__ __device__ __forceinline__ size_t region_bytes(int hdp, int key_rows) {
  const size_t attn = q_bytes(hdp) + sizeof(float) * 2 * key_rows * (hdp + 1);
  const size_t gelu = 2 * sizeof(bf16) * ROWS * FC;
  return attn > gelu ? attn : gelu;
}

__device__ __forceinline__ Smem carve(const Args& a, unsigned char* base) {
  Smem m;
  m.full = reinterpret_cast<uint64_t*>(base);
  m.empty = m.full + STAGES;
  m.stats = reinterpret_cast<float*>(base + BAR_BYTES);
  m.slots = reinterpret_cast<bf16*>(base + BAR_BYTES + STATS_BYTES);
  m.hs = m.slots + STAGES * (SLOT_BYTES / 2);
  m.ys = m.hs + 2 * ROWS * a.Dp;
  m.qh = reinterpret_cast<float*>(m.ys);
  m.kh = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(m.ys) + q_bytes(a.hdp));
  m.vh = m.kh + a.key_rows * (a.hdp + 1);
  return m;
}

// Product p of a layer, in consumption order: rows N and k-steps of its B
// operand. Per head h < H: [q|k|v] (3 hdp x Dp), then the head's proj
// columns (Dq x hdp); then per MLP chunk fc (FC x Dp) and fc2 (Dq x FC).
__device__ __forceinline__ void product_shape(const Args& a, int p, int& N, int& ksteps) {
  if (p < 2 * a.H) {
    N = (p & 1) ? a.Dq : 3 * a.hdp;
    ksteps = (p & 1) ? a.hdp / 16 : a.Dp / 16;
  } else {
    N = ((p - 2 * a.H) & 1) ? a.Dq : FC;
    ksteps = ((p - 2 * a.H) & 1) ? FC / 16 : a.Dp / 16;
  }
}

// The copies into the ring (thread 0 of each block): every chunk of every
// layer in consumption order, chunk `it` into slot it % STAGES of both
// blocks. The cluster's block 0 copies (one multicast per chunk, once the
// slot is free in both blocks); each block announces the chunk's bytes on
// its own "full" barrier.
struct Producer {
  const char* src;
  int it, l, p, k0, N, ksteps;

  __device__ __forceinline__ void start(const Args& a) {
    src = reinterpret_cast<const char*>(a.layer[0].tiles);
    it = l = p = k0 = 0;
    product_shape(a, 0, N, ksteps);
  }

  // Handle chunks while it < limit and the layers last. Block 0 copies each
  // once its slot is free: waiting for the slot when `wait`, else stopping
  // at the first slot still in use.
  template <bool kGroup>
  __device__ __forceinline__ void issue(const Args& a, const Smem& sm, uint32_t rank, int limit,
                                        bool wait) {
    const int n_layers = kGroup ? a.n_layers : 1, n_prod = 2 * a.H + 2 * a.n_mlp;
    for (; it < limit && l < n_layers; ++it) {
      const int slot = it % STAGES;
      if (rank == 0) {
        const uint32_t parity = ((it / STAGES) & 1) ^ 1;
        if (wait)
          hopper::mbar_wait(&sm.empty[slot], parity);
        else if (!hopper::mbar_test_wait(&sm.empty[slot], parity))
          break;
      }
      const int kpc = steps_per_chunk(N);
      const uint32_t bytes = 2 * N * 32 * min(kpc, ksteps - k0);
      hopper::mbar_arrive_expect_tx(&sm.full[slot], bytes);
      if (rank == 0)
        hopper::bulk_copy_g2s_multicast(sm.slots + slot * (SLOT_BYTES / 2), src, bytes,
                                        &sm.full[slot], (1u << CLUSTER) - 1);
      src += bytes;
      k0 += kpc;
      if (k0 < ksteps) continue;
      k0 = 0;
      if (++p == n_prod) {
        p = 0;
        if (++l < n_layers) src = reinterpret_cast<const char*>(a.layer[kGroup ? l : 0].tiles);
      }
      product_shape(a, p, N, ksteps);
    }
  }
};

// A block's view of the weight ring: slot barriers, the running chunk
// count, the block's rank in the cluster and, in thread 0, the copies.
template <bool kGroup>
struct Ring {
  const Args& a;
  const Smem& sm;
  uint32_t rank;
  int it;
  Producer prod;

  // Chunk `it` is announced (and, by block 0, being copied), and block 0
  // copies as many after it as free slots allow.
  __device__ __forceinline__ void refill() {
    if (threadIdx.x == 0) {
      prod.issue<kGroup>(a, sm, rank, it + 1, true);
      if (rank == 0) prod.issue<kGroup>(a, sm, rank, it + STAGES, false);
    }
  }
};

// This warp is done with a ring slot: one arrival on the slot's "empty"
// barrier in the cluster's block 0, which copies the chunks.
template <bool kGroup>
__device__ __forceinline__ void release(const Ring<kGroup>& ring, int slot) {
  if ((threadIdx.x & 31) == 0) {
    if (ring.rank == 0)
      hopper::mbar_arrive(&ring.sm.empty[slot]);
    else
      hopper::mbar_arrive_cluster(&ring.sm.empty[slot], 0);
  }
}

// acc[0 : NW / 2] (+)= A[64, 16 ksteps] x B[n0 : n0 + NW, :]^T with A the
// hi/lo tile pair (K columns) and B streamed through the ring as one product
// of N rows, per chunk of kn k-steps its hi part then its lo part: per
// k-step A-hi.B-hi, A-lo.B-hi, A-hi.B-lo. accumulate == false starts from
// zero. Each warp releases a slot as soon as the products that read it are
// complete.
template <int NW, bool kGroup, bool kTimed>
__device__ __forceinline__ void gemm(Ring<kGroup>& ring, PhaseClock<kTimed>& clk, float* acc,
                                     const bf16* A, int K, int N, int ksteps, int n0,
                                     bool accumulate) {
  const int kpc = steps_per_chunk(N);
  const uint32_t b_lbo = N * 16;
  const bf16* Alo = A + ROWS * K;
  hopper::fence_regs<NW / 2>(acc);
  hopper::wgmma_fence();
  for (int k0 = 0; k0 < ksteps; k0 += kpc) {
    const int kn = min(kpc, ksteps - k0);
    const int slot = ring.it % STAGES;
    const long long w0 = clk.now();
    ring.refill();
    hopper::mbar_wait(&ring.sm.full[slot], (ring.it / STAGES) & 1);
    clk.waited(w0);
    const bf16* b = ring.sm.slots + slot * (SLOT_BYTES / 2) + (n0 >> 3) * 64;
    const bf16* blo = b + kn * N * 16;
    for (int kk = 0; kk < kn; ++kk) {
      const int k = k0 + kk;
      const uint64_t da = hopper::smem_desc(A + k * 1024, 1024, 128);
      const uint64_t db = hopper::smem_desc(b + kk * N * 16, b_lbo, 128);
      hopper::wgmma<NW>(acc, da, db, (accumulate || k > 0) ? 1 : 0);
      hopper::wgmma<NW>(acc, hopper::smem_desc(Alo + k * 1024, 1024, 128), db, 1);
      hopper::wgmma<NW>(acc, da, hopper::smem_desc(blo + kk * N * 16, b_lbo, 128), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    release(ring, slot);
    ++ring.it;
  }
  hopper::fence_regs<NW / 2>(acc);
}

// proj and fc2 onto the residual: ns = Dq / 128 subtiles of 64 columns per
// warpgroup as one product of 64 ns columns, ns fixed at compile time.
template <bool kGroup, bool kTimed>
__device__ __forceinline__ void gemm_wide(Ring<kGroup>& ring, PhaseClock<kTimed>& clk, float* res,
                                          const bf16* A, int K, int N, int ksteps, int n0,
                                          int ns) {
  switch (ns) {
    case 1: gemm<64>(ring, clk, res, A, K, N, ksteps, n0, true); break;
    case 2: gemm<128>(ring, clk, res, A, K, N, ksteps, n0, true); break;
    default: gemm<64 * NSUB>(ring, clk, res, A, K, N, ksteps, n0, true); break;
  }
}

// res (+)= bias over this thread's residual columns (< D; the residual's
// columns from D on stay zero).
__device__ __forceinline__ void add_bias(float* res, const float* bias, int n0, int ns, int D) {
#pragma unroll
  for (int s = 0; s < NSUB; ++s) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = n0 + 64 * s + frag_col(i);
      if (s < ns && c < D) res[s * 32 + i] = __fadd_rn(res[s * 32 + i], bias[c]);
    }
  }
}

// LayerNorm of the residual (this thread's values in `res`, columns [n0,
// n0 + 64 ns) of its warpgroup) into the hi/lo tile pair hs [ROWS, Dp]; rows
// >= nrows and columns >= D zero. A quad of lanes holds a row's columns of
// the warpgroup; the two warpgroups' sums meet in `stats`. Ends with the
// fence that hands hs to `wgmma` (the caller's barrier completes the
// hand-over).
__device__ __forceinline__ void layernorm(const float* res, bf16* hs, const float* s,
                                          const float* b, int D, int Dp, int nrows, int n0,
                                          int ns, float* stats, int ctid) {
  const int wg = ctid >> 7;
  float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
  for (int sb = 0; sb < NSUB; ++sb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int u = (i >> 1) & 1, c = n0 + 64 * sb + frag_col(i);
      if (sb < ns && c < D) {
        const float v = res[sb * 32 + i];
        sum[u] = __fadd_rn(sum[u], v);
        sq[u] = fmaf(v, v, sq[u]);
      }
    }
  }
  float mu[2], rstd[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum[u] = __fadd_rn(sum[u], __shfl_xor_sync(0xffffffffu, sum[u], o));
      sq[u] = __fadd_rn(sq[u], __shfl_xor_sync(0xffffffffu, sq[u], o));
    }
    if ((ctid & 3) == 0) {
      stats[(2 * wg) * ROWS + frag_row(2 * u)] = sum[u];
      stats[(2 * wg + 1) * ROWS + frag_row(2 * u)] = sq[u];
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = frag_row(2 * u);
    const float ts = __fadd_rn(stats[r], stats[2 * ROWS + r]);
    const float tq = __fadd_rn(stats[ROWS + r], stats[3 * ROWS + r]);
    mu[u] = __fdiv_rn(ts, static_cast<float>(D));
    rstd[u] = rsqrtf(__fadd_rn(__fsub_rn(__fdiv_rn(tq, static_cast<float>(D)),
                                         __fmul_rn(mu[u], mu[u])),
                               1e-5f));
  }
  const int split = ROWS * Dp;
#pragma unroll
  for (int sb = 0; sb < NSUB; ++sb) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int u = (i >> 1) & 1, r = frag_row(i), c = n0 + 64 * sb + frag_col(i);
      if (sb < ns && c < Dp) {
        const bool in = r < nrows;
        const float v0 = in && c < D ? fmaf(__fmul_rn(__fsub_rn(res[sb * 32 + i], mu[u]),
                                                      rstd[u]), s[c], b[c])
                                     : 0.f;
        const float v1 = in && c + 1 < D
                             ? fmaf(__fmul_rn(__fsub_rn(res[sb * 32 + i + 1], mu[u]), rstd[u]),
                                    s[c + 1], b[c + 1])
                             : 0.f;
        store_split2(hs + a_off(r, c), split, v0, v1);
      }
    }
  }
  hopper::fence_proxy_async();
}

// Key row of token row r: its env's P prefix keys come first.
__device__ __forceinline__ int key_row(const Args& a, int r) {
  const int e = r / a.T2;
  return e * (a.P + a.T2) + a.P + (r - e * a.T2);
}

// Head h: the block's prefix K/V into their key rows e (P + T2) + j, then
// the QKV product (NW = 3 hdp / 2 columns per warpgroup) and q, k and v of
// the tile's rows (bias added) into qh and the own key rows.
template <int NW, bool kGroup, bool kTimed>
__device__ __forceinline__ void qkv_head(const Args& a, const LayerArgs& w, Ring<kGroup>& ring,
                                         PhaseClock<kTimed>& clk, const Smem& sm, int h,
                                         int nrows, int n_env, const float* pk0,
                                         const float* pv0, int ctid) {
  const int ld = a.hdp + 1;
  const int ne = n_env * a.P * a.hd;
  for (int i = ctid; i < 2 * ne; i += THREADS) {
    const bool is_v = i >= ne;
    const int rem = is_v ? i - ne : i, ej = rem / a.hd, d = rem - ej * a.hd;
    const int e = ej / a.P, R = e * (a.P + a.T2) + (ej - e * a.P);
    (is_v ? sm.vh : sm.kh)[R * ld + d] = (is_v ? pv0 : pk0)[ej * a.D + h * a.hd + d];
  }
  const int n0 = (ctid >> 7) * NW;
  float acc[NW / 2];
  gemm<NW>(ring, clk, acc, sm.hs, a.Dp, 3 * a.hdp, a.Dp / 16, n0, false);
  __syncthreads();   // q takes the room of the previous head's output, read by its proj
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) {
    const int r = frag_row(i), col = n0 + frag_col(i);
    if (r < nrows) {
      const int part = (col >= a.hdp) + (col >= 2 * a.hdp), d = col - part * a.hdp;
      const float v = __fadd_rn(acc[i], w.bqkv[(part * a.H + h) * a.hdp + d]);
      if (part == 0)
        sm.qh[r * ld + d] = v;
      else
        (part == 1 ? sm.kh : sm.vh)[key_row(a, r) * ld + d] = v;
    }
  }
}

// Attention of head h on the CUDA cores in f32: TPR threads per row, thread
// `sub` of row r takes keys sub, sub + TPR, ... of the row's env (its P
// prefix keys and its causal own keys) and head-dim columns sub, sub + TPR,
// ...; the row's max, sum and probabilities pass between its lanes by
// shuffles. Writes the normalised output, hi/lo, into the A tile pair ys
// [ROWS, hdp] (rows >= nrows zero), in q's room once every row's scores are
// done.
__device__ __forceinline__ void attention_head(const Args& a, const Smem& sm, int nrows,
                                               int ctid) {
  constexpr int KPT = MAX_KEYS / TPR, DPT = MAX_HDP / TPR;   // keys and columns per thread
  const int ld = a.hdp + 1, lane = ctid & 31, r = ctid / TPR, sub = ctid % TPR;
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
    const int j = sub + TPR * jj;
    s[jj] = -INFINITY;
    if (j < nk) {
      const float* k = sm.kh + (kb + j) * ld;
      float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;   // four chains: latency, not issue, bounds it
      int d = 0;
      for (; d + 4 <= a.hd; d += 4) {
        d0 = fmaf(q[d], k[d], d0);
        d1 = fmaf(q[d + 1], k[d + 1], d1);
        d2 = fmaf(q[d + 2], k[d + 2], d2);
        d3 = fmaf(q[d + 3], k[d + 3], d3);
      }
      for (; d < a.hd; ++d) d0 = fmaf(q[d], k[d], d0);
      s[jj] = __fmul_rn(__fadd_rn(__fadd_rn(d0, d1), __fadd_rn(d2, d3)), a.scale);
      mx = fmaxf(mx, s[jj]);
    }
  }
  __syncthreads();   // q is read
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.f;
#pragma unroll
  for (int jj = 0; jj < KPT; ++jj) {
    s[jj] = s[jj] == -INFINITY ? 0.f : expf(__fsub_rn(s[jj], mx));
    sum = __fadd_rn(sum, s[jj]);
  }
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
  const float inv = sum > 0.f ? __fdiv_rn(1.f, sum) : 0.f;
  float y[DPT];
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) y[dd] = 0.f;
#pragma unroll
  for (int jj = 0; jj < KPT; ++jj) {
#pragma unroll
    for (int src = 0; src < TPR; ++src) {
      const float p = __shfl_sync(0xffffffffu, s[jj], (lane & ~(TPR - 1)) | src);
      const int j = TPR * jj + src;
      if (j < nk) {
        const float* v = sm.vh + (kb + j) * ld;
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) {
          const int d = sub + TPR * dd;
          if (d < a.hdp) y[dd] = fmaf(p, v[d], y[dd]);
        }
      }
    }
  }
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) {
    const int d = sub + TPR * dd;
    if (d < a.hdp)
      store_split(sm.ys + a_off(r, d), ROWS * a.hdp, valid ? __fmul_rn(y[dd], inv) : 0.f);
  }
}

// QKV, attention and proj, head by head, for NW = 3 hdp / 2: proj's k-steps
// of head h follow its attention, summed onto the residual.
template <int NW, bool kGroup, bool kTimed>
__device__ __forceinline__ void heads(const Args& a, const LayerArgs& w, Ring<kGroup>& ring,
                                      const Smem& sm, PhaseClock<kTimed>& clk, float* res,
                                      int nrows, int n_env, const float* pk0, const float* pv0,
                                      int ns, int ctid) {
  const int n0w = (ctid >> 7) * 64 * ns;
  for (int h = 0; h < a.H; ++h) {
    qkv_head<NW>(a, w, ring, clk, sm, h, nrows, n_env, pk0, pv0, ctid);
    __syncthreads();
    clk.mark(PH_QKV);
    attention_head(a, sm, nrows, ctid);
    hopper::fence_proxy_async();
    __syncthreads();
    clk.mark(PH_ATTN);
    gemm_wide(ring, clk, res, sm.ys, a.hdp, a.Dq, a.hdp / 16, n0w, ns);
    clk.mark(PH_PROJ);
  }
}

// One layer over the tile: LN1, per head QKV, attention and proj onto the
// residual, LN2, the MLP onto the residual. The residual stays in `res`.
template <bool kGroup, bool kTimed, bool kErf>
__device__ __forceinline__ void layer(const Args& a, const Smem& sm, const LayerArgs& w,
                                      Ring<kGroup>& ring, PhaseClock<kTimed>& clk, float* res,
                                      int nrows, int n_env, size_t prow) {
  const int ctid = threadIdx.x, wg = ctid >> 7;
  const int D = a.D, Dp = a.Dp;
  const int ns = a.Dq / 128, n0w = wg * 64 * ns;
  const float* pk0 = a.P > 0 ? w.pk + prow * D : nullptr;
  const float* pv0 = a.P > 0 ? w.pv + prow * D : nullptr;
  layernorm(res, sm.hs, w.ln1_s, w.ln1_b, D, Dp, nrows, n0w, ns, sm.stats, ctid);
  add_bias(res, w.bproj, n0w, ns, D);
  __syncthreads();
  clk.mark(PH_LN1);

  // ---- QKV, attention and proj, head by head ----------------------------
  switch (a.hdp) {
    case 16: heads<24>(a, w, ring, sm, clk, res, nrows, n_env, pk0, pv0, ns, ctid); break;
    case 32: heads<48>(a, w, ring, sm, clk, res, nrows, n_env, pk0, pv0, ns, ctid); break;
    case 48: heads<72>(a, w, ring, sm, clk, res, nrows, n_env, pk0, pv0, ns, ctid); break;
    default: heads<96>(a, w, ring, sm, clk, res, nrows, n_env, pk0, pv0, ns, ctid); break;
  }

  layernorm(res, sm.hs, w.ln2_s, w.ln2_b, D, Dp, nrows, n0w, ns, sm.stats, ctid);
  add_bias(res, w.bfc2, n0w, ns, D);
  __syncthreads();
  clk.mark(PH_LN2);

  // ---- MLP: FC-column chunks of the hidden layer through ys; fc2 sums
  //      onto the residual -----------------------------------------------------
  const int gsplit = ROWS * FC;
  for (int m = 0; m < a.n_mlp; ++m) {
    bf16* gbuf = sm.ys;
    const int n0 = wg * (FC / 2);
    float acc[FC / 4];
    gemm<FC / 2>(ring, clk, acc, sm.hs, Dp, FC, Dp / 16, n0, false);
    __syncthreads();   // the previous chunk's fc2 (or the last head's proj) is done with ys
#pragma unroll
    for (int i = 0; i < FC / 4; i += 2) {
      const int r = frag_row(i), c = n0 + frag_col(i), f = m * FC + c;
      const bool in = r < nrows;
      const float g0 = in && f < a.F ? gelu<kErf>(__fadd_rn(acc[i], w.bfc[f])) : 0.f;
      const float g1 =
          in && f + 1 < a.F ? gelu<kErf>(__fadd_rn(acc[i + 1], w.bfc[f + 1])) : 0.f;
      store_split2(gbuf + a_off(r, c), gsplit, g0, g1);
    }
    hopper::fence_proxy_async();
    __syncthreads();
    clk.mark(PH_FC);
    gemm_wide(ring, clk, res, gbuf, FC, a.Dq, FC / 16, n0w, ns);
    clk.mark(PH_FC2);
  }
}

// Mean and reciprocal std of one row of the f32 residual (whole warp).
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

// The block: two warpgroups over every product and epilogue; thread 0 also
// issues the weight copies.
template <bool kGroup, bool kTimed, bool kErf>
__device__ __forceinline__ void consume(const Args& a, const Smem& sm, uint32_t rank) {
  PhaseClock<kTimed> clk;
  clk.start();
  const int ctid = threadIdx.x, warp = ctid >> 5, lane = ctid & 31, wg = ctid >> 7;
  const int n_layers = kGroup ? a.n_layers : 1;
  const int D = a.D, Dp = a.Dp;
  const int ns = a.Dq / 128, n0w = wg * 64 * ns;
  const int env0 = blockIdx.x * a.envs_per_block;
  const int n_env = max(0, min(a.envs_per_block, a.B - env0));   // 0: a block with no rows
  const int nrows = n_env * a.T2;
  const size_t row0 = static_cast<size_t>(env0) * a.T2;
  int sidx = 0;
  if (a.idx != nullptr) {
    sidx = *a.idx;
    sidx = sidx < 0 ? 0 : (sidx >= a.S ? a.S - 1 : sidx);
  }
  const size_t prow = (static_cast<size_t>(sidx) * a.B + env0) * a.P;   // first prefix row
  Ring<kGroup> ring{a, sm, rank, 0, {}};
  if (ctid == 0) ring.prod.start(a);

  // x into the residual registers; key rows (and their pad columns) start
  // at zero
  float res[RES];
  const float* x = a.x + row0 * D;
#pragma unroll
  for (int s = 0; s < NSUB; ++s) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = frag_row(i), c = n0w + 64 * s + frag_col(i);
      res[s * 32 + i] = s < ns && r < nrows && c < D ? x[static_cast<size_t>(r) * D + c] : 0.f;
    }
  }
  for (int i = ctid; i < 2 * a.key_rows * (a.hdp + 1); i += THREADS) sm.kh[i] = 0.f;
  __syncthreads();
  clk.mark(PH_LOAD);

  for (int l = 0; l < n_layers; ++l)
    layer<kGroup, kTimed, kErf>(a, sm, a.layer[kGroup ? l : 0], ring, clk, res, nrows, n_env,
                                prow);

  // the residual to shared memory (the LN tile's room), then to `out`
  float* xs = reinterpret_cast<float*>(sm.hs);
#pragma unroll
  for (int s = 0; s < NSUB; ++s) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = frag_row(i), c = n0w + 64 * s + frag_col(i);
      if (s < ns && c < Dp)
        *reinterpret_cast<float2*>(xs + r * Dp + c) =
            make_float2(res[s * 32 + i], res[s * 32 + i + 1]);
    }
  }
  __syncthreads();
  float* out = a.out + row0 * D;
  for (int i = ctid; i < nrows * D; i += THREADS) {
    const int r = i / D;
    out[i] = xs[r * Dp + i - r * D];
  }
  if (kTimed) __syncthreads();
  clk.mark(PH_WRITE);

  // ---- optional epilogue: ln_f + linear head, f32 ------------------------
  if (a.pred != nullptr) {
    for (int r = warp; r < nrows; r += THREADS / 32) {
      const float* row = xs + r * Dp;
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
  if (kTimed) __syncthreads();
  clk.mark(PH_EPI);
  clk.store(a.cycles);
}

// kGroup: the B2 instantiation, with a runtime layer loop over a.layer[];
// the single-layer one (B1, B3, B4) indexes a.layer[0] statically. kTimed:
// B1 with the phase clock (tanh GELU only). kErf: the erf GELU.
template <bool kGroup, bool kTimed = false, bool kErf = false>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
fused_layer_f32_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm = carve(a, smem);
  const uint32_t rank = hopper::cluster_ctarank();
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&sm.full[s], 1);
      hopper::mbar_init(&sm.empty[s], CLUSTER * THREADS / 32);
    }
    hopper::fence_mbar_init();
  }
  hopper::cluster_sync();   // both blocks' barriers are ready
  consume<kGroup, kTimed, kErf>(a, sm, rank);
  hopper::cluster_sync();
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
// shape outside the limits. `a.layer[:n_layers]` must be set by the caller;
// `group` takes the B2 instantiation, a non-null `cycles` the timed
// single-layer one; in the erf unit the kErf instantiations (no timed
// one). The grid is rounded up to whole clusters.
int launch(Args& a, bool group, long long* cycles, const void* x, const void* idx,
           int n_layers, const void* lnf_s, const void* lnf_b, const void* whead,
           const void* bhead, void* out, void* pred, int B, int T2, int D, int H, int P, int S,
           int F, int M, void* stream) {
  a.x = static_cast<const float*>(x);
  a.idx = static_cast<const int*>(idx);
  a.n_layers = n_layers;
  a.lnf_s = static_cast<const float*>(lnf_s);
  a.lnf_b = static_cast<const float*>(lnf_b);
  a.whead = static_cast<const float*>(whead);
  a.bhead = static_cast<const float*>(bhead);
  a.out = static_cast<float*>(out);
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
  a.hd = H > 0 ? D / H : 0;
  a.hdp = (a.hd + 15) / 16 * 16;
  a.Dp = (D + 15) / 16 * 16;
  a.Dq = (a.Dp + 127) / 128 * 128;
  a.n_mlp = (F + FC - 1) / FC;
  a.envs_per_block = T2 > 0 ? ROWS / T2 : 0;
  a.key_rows = a.envs_per_block * (P + T2);
  a.scale = 1.0f / sqrtf(static_cast<float>(a.hd > 0 ? a.hd : 1));
  if (n_layers < 1 || n_layers > (group ? MAX_LAYERS : 1) || T2 < 1 || T2 > ROWS ||
      H < 1 || D % H != 0 || P + T2 > MAX_KEYS || M > MAX_M || a.Dp > MAX_DP ||
      a.hdp > MAX_HDP || H * a.hdp > MAX_HDP_ALL || F % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);

  const size_t smem = BAR_BYTES + STATS_BYTES + STAGES * SLOT_BYTES +
                      2 * sizeof(bf16) * ROWS * a.Dp + region_bytes(a.hdp, a.key_rows);
  if (smem > static_cast<size_t>(MAX_SMEM)) return static_cast<int>(cudaErrorInvalidValue);
#if BESO_ERF_GELU
  if (cycles) return static_cast<int>(cudaErrorInvalidValue);   // the clock times tanh B1
  const auto kernel = group ? fused_layer_f32_kernel<true, false, true>
                            : fused_layer_f32_kernel<false, false, true>;
#else
  const auto kernel = group    ? fused_layer_f32_kernel<true>
                      : cycles ? fused_layer_f32_kernel<false, true>
                               : fused_layer_f32_kernel<false>;
#endif
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (B + a.envs_per_block - 1) / a.envs_per_block;
  const int blocks = (tiles + CLUSTER - 1) / CLUSTER * CLUSTER;
  kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#if BESO_ERF_GELU
// the erf unit's entries: the names below with `erf_` after the prefix
#define beso_fused_f32_layer_prefix beso_fused_f32_erf_layer_prefix
#define beso_fused_f32_layers_prefix_group beso_fused_f32_erf_layers_prefix_group
#define beso_fused_f32_layer_with_prefix beso_fused_f32_erf_layer_with_prefix
#define beso_fused_f32_layer beso_fused_f32_erf_layer
#endif

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
  return launch(a, false, nullptr, x, idx, 1, lnf_s, lnf_b, whead, bhead, out, pred, B, T2, D,
                H, P, S, F, M, stream);
}

#if !BESO_ERF_GELU
// B1 with the phase clock: as beso_fused_f32_layer_prefix, and each block
// adds its clock64() cycles per phase (enum Phase) to cycles [blocks,
// N_PHASES], blocks the launch's grid (whole clusters).
int beso_fused_f32_layer_prefix_timed(const void* x, const void* pk, const void* pv,
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
  return launch(a, true, nullptr, x, idx, n_layers, lnf_s, lnf_b, whead, bhead, out, pred, B,
                T2, D, H, P, S, F, M, stream);
}

// B3: one block against one already selected prefix row, pk/pv [B, P, D].
int beso_fused_f32_layer_with_prefix(const void* x, const void* pk, const void* pv,
                                     const void* const* w, void* out, int B, int T2, int D,
                                     int H, int P, int F, void* stream) {
  Args a;
  a.layer[0] = layer_args(w, pk, pv);
  return launch(a, false, nullptr, x, nullptr, 1, nullptr, nullptr, nullptr, nullptr, out,
                nullptr, B, T2, D, H, P, 1, F, 0, stream);
}

// B4: one block over the whole causal sequence x [B, T, D], no prefix.
int beso_fused_f32_layer(const void* x, const void* const* w, void* out, int B, int T, int D,
                         int H, int F, void* stream) {
  Args a;
  a.layer[0] = layer_args(w, nullptr, nullptr);
  return launch(a, false, nullptr, x, nullptr, 1, nullptr, nullptr, nullptr, nullptr, out,
                nullptr, B, T, D, H, 0, 1, F, 0, stream);
}

#if !BESO_ERF_GELU
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
    case 9: return N_PHASES;
    case 10: return CLUSTER;
    default: return -1;
  }
}
#endif

}  // extern "C"
