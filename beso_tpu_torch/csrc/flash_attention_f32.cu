// The f32 flash kernels at tile width 64 (padded head dims 16-64) on Hopper
// `wgmma` with bulk tensor copies: the forward (TPU kernel B5,
// `_flash_forward` / `_flash_kernel`, beso_tpu/ops/flash_attention.py:34-75,
// 269-308) and the backward (TPU kernel B6, `_flash_attention_bwd` :182-259:
// the dQ kernel `_bwd_dq_kernel` (:78-109, call :221) with delta (:212-214)
// and the dK/dV kernel `_bwd_dkv_kernel` (:112-153, call :240)).
// flash_attention.cu's launchers call these for f32 at hdp <= 64; that
// source keeps the bf16 kernels at this width, flash_attention_wide.cu both
// dtypes' above it.
//
// Layout and numerics as in flash_attention.cu: q, k, v, o, dO, dq, dk, dv
// [B*H, T, hd] f32 contiguous, lse and delta [B*H, T] f32, lse the natural
// log of the scaled scores; every f32 operand split into bf16 hi = bf16(x)
// and lo = bf16(x - hi) with three products (hi.hi + lo.hi + hi.lo) and f32
// accumulation; no atomics and sums in a fixed order, so a second launch
// is bit-equal to the first. The dQ kernel computes delta = rowsum(dO * O)
// and writes it for the dK/dV kernel, so a backward is two launches.
//
// What bounds them on the H100: at [256, 6, 131, 60] the forward moves
// ~194 MB (q, k, v in, o and lse out), 0.0579 ms at 3.35 TB/s, and a
// backward launch ~290 MB (dQ: q, k, v, o, dO in and dq out; dK/dV: q, k,
// v, dO in and dk, dv out; with lse and delta), 0.0870 ms. Their products on
// whole 64 x 64 tiles, three per pair, come to ~29 GFLOP (forward) and ~43
// GFLOP per launch of either backward kernel (24,576 (query, key) pairs per
// (b, h); dK/dV 18,432 with the halves past T skipped), 0.029 and 0.044 ms
// at the 989 TFLOP/s bf16 peak: half the byte bound, so the products need
// `wgmma`'s rate and the copies must not wait for them. What the design
// does about it:
// - Copies that cost the compute threads nothing: where hd % 4 == 0 (f32
//   rows a multiple of 16 bytes), thread 0 issues bulk tensor copies of the
//   f32 tiles (tensor maps over [B*H, T, hd], rows past T and columns past
//   hd zero-filled) completing on a stage's mbarrier. The 128-byte swizzle
//   caps a box at 32 floats, so a tile is two boxes of 32 columns (one at
//   hdp <= 32); the swizzle lets the split below read eight rows of one
//   column conflict-free. Other hd (odd, or 2 mod 4) take the `<false>` form:
//   all threads copy into the same layout with zero-filling `cp.async`
//   (8-byte where hd is even, else 4-byte), one commit group per stage.
// - The split in place: a landed f32 tile (16 KB) or pair (32 KB) is read by
//   all threads, split into bf16 hi/lo core-matrix tiles (the layout `wgmma`
//   reads) and written back over the same bytes; the copies of the next
//   stages fly meanwhile. A fence.proxy.async and a barrier hand the tiles
//   to `wgmma`.
// - The products on `wgmma`: S = Q K^T and dP = dO V^T (dK/dV: S^T = K Q^T,
//   dP^T = V dO^T) from shared memory, K-major, three products each; P and
//   dS split in registers as the A operand of O += P V, dQ += dS K,
//   dV += P^T dO and dK += dS^T Q, whose B is read MN-major
//   (`wgmma_rs<64, 1>`). The forward's online softmax updates the row max
//   and rescales O once per 64-key tile (flash_wgmma.cuh's `fwd_step`, the
//   width-128 forwards' too). The dK/dV kernel takes each streamed tile in
//   halves of 32 queries and skips a half wholly past T; all three skip key
//   tiles above the diagonal.
// - Warps per SM: one warpgroup per block, two blocks per SM (8 warps). The
//   forward keeps Q (16 KB) and streams K/V through FWD_STAGES = 3 stages of
//   32 KB: 113 KB, two blocks per SM, and at T <= 192 every key tile of a
//   block in flight at once. A backward block keeps a pair (32 KB: Q and
//   dO, or K and V) and streams K/V (or Q and dO with their lse and delta)
//   through STAGES = 2 stages: 97 KB, two blocks per SM; a third stage
//   there would leave one block of 4 warps per SM, and two resident blocks
//   hide more of the load latency than a deeper ring in one.
// - delta comes from O and dO in global memory while the first tiles land:
//   two threads per row, each issuing all of its 16-byte loads before it
//   sums (a loop that waits for each load in turn left that latency
//   exposed; PERF.md has the times).
// - The ragged edge: K and V rows (forward, dQ) and Q and dO rows (dK/dV)
//   past T are zero, since P = 0 or dS = 0 times garbage could be NaN (the
//   copies zero-fill them); the dK/dV kernel masks p (not s) for query
//   columns >= T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention.cuh"
#include "flash_wgmma.cuh"
#include "hopper.cuh"

namespace {

constexpr int HDP = 64;                // tile width
constexpr int TILE = ROWS * HDP;       // elements of a tile: f32 staged, or one bf16 part
constexpr int STAGES = 2;
constexpr uint32_t BOX_BYTES = sizeof(float) * ROWS * 32;   // a 32-column box of an f32 tile
constexpr size_t PAIR_BYTES = 2 * sizeof(float) * TILE;     // two f32 tiles, or four hi/lo
constexpr size_t RING_BYTES = (1 + STAGES) * PAIR_BYTES;    // the kept pair, then the stages

// Element (r, c) of a staged f32 tile as the bulk tensor copies write it:
// box c / 32 (8 KB), row r at 128 r bytes, 16-byte chunk j of the row at
// chunk j ^ (r % 8).
__device__ __forceinline__ int fsw(int r, int c) {
  return (c >> 5) * (ROWS * 32) + r * 32 + ((((c >> 2) & 7) ^ (r & 7)) << 2) + (c & 3);
}

// Rows [0, nrows) of an f32 [*, hd] source into the staged tile dst,
// columns [0, hdp), zero past nrows and hd, by kBytes-wide `cp.async`
// copies (hd a multiple of kBytes / 4).
template <int kBytes>
__device__ __forceinline__ void stage_async(float* dst, const float* src, int nrows, int hd,
                                            int hdp, int t) {
  constexpr int E = kBytes / 4, PER_ROW = HDP / E;
  for (int i = t; i < ROWS * PER_ROW; i += WG) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * E;
    if (c >= hdp) continue;
    const bool ok = r < nrows && c < hd;
    hopper::cp_async<kBytes>(dst + fsw(r, c), ok ? src + static_cast<size_t>(r) * hd + c : src,
                             ok ? kBytes : 0);
  }
}

// Tile `tile` of the (b, h) at row rbase of x0 (and, NT = 2, of x1) into
// the staged f32 tiles at dst (and dst + TILE), rows past T and columns past
// hd zero; `a` gives T, hd and hdp (forward or backward arguments). kTma:
// thread 0 issues the boxes of the maps m, counted on `bar`; else every
// thread's `cp.async` copies, in the caller's commit group.
template <int NT, bool kTma, class A>
__device__ __forceinline__ void load_tiles(float* dst, const CUtensorMap* m, const float* x0,
                                           const float* x1, int tile, int bh, size_t rbase,
                                           const A& a, uint64_t* bar, int t) {
  if constexpr (kTma) {
    if (t == 0) {
      const int nbox = a.hdp > 32 ? 2 : 1;
      hopper::fence_proxy_async();   // the split's writes to a refilled stage come first
      hopper::mbar_arrive_expect_tx(bar, NT * nbox * BOX_BYTES);
      for (int b = 0; b < nbox; ++b) {
        hopper::tma_load_3d(dst + b * ROWS * 32, &m[0], 32 * b, tile * ROWS, bh, bar);
        if constexpr (NT == 2)
          hopper::tma_load_3d(dst + TILE + b * ROWS * 32, &m[1], 32 * b, tile * ROWS, bh, bar);
      }
    }
  } else {
    const size_t off = (rbase + static_cast<size_t>(tile) * ROWS) * a.hd;
    const int nrows = a.T - tile * ROWS;
    if (a.hd & 1) {
      stage_async<4>(dst, x0 + off, nrows, a.hd, a.hdp, t);
      if constexpr (NT == 2) stage_async<4>(dst + TILE, x1 + off, nrows, a.hd, a.hdp, t);
    } else {
      stage_async<8>(dst, x0 + off, nrows, a.hd, a.hdp, t);
      if constexpr (NT == 2) stage_async<8>(dst + TILE, x1 + off, nrows, a.hd, a.hdp, t);
    }
  }
}

// A thread's share of a staged f32 tile, split: the 8-column chunk
// c = 8 ((t / 8) % 8) of rows (t % 8) + 8 (t / 64 + 2 u), u < 4. Eight
// consecutive threads read eight rows of one chunk (conflict-free in the
// swizzle) and write one core matrix (128 contiguous bytes).
struct Split {
  uint4 hi[4], lo[4];
};

__device__ __forceinline__ void split_read(Split& s, const float* src, int hdp, int t) {
  const int c = 8 * ((t >> 3) & 7);
  if (c >= hdp) return;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = (t & 7) + 8 * ((t >> 6) + 2 * u);
    const float4 x0 = *reinterpret_cast<const float4*>(src + fsw(r, c));
    const float4 x1 = *reinterpret_cast<const float4*>(src + fsw(r, c + 4));
    split_bf2(x0.x, x0.y, s.hi[u].x, s.lo[u].x);
    split_bf2(x0.z, x0.w, s.hi[u].y, s.lo[u].y);
    split_bf2(x1.x, x1.y, s.hi[u].z, s.lo[u].z);
    split_bf2(x1.z, x1.w, s.hi[u].w, s.lo[u].w);
  }
}

__device__ __forceinline__ void split_write(bf16* dst, const Split& s, int hdp, int t) {
  const int c = 8 * ((t >> 3) & 7);
  if (c >= hdp) return;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = (t & 7) + 8 * ((t >> 6) + 2 * u);
    *reinterpret_cast<uint4*>(dst + cm(r, c)) = s.hi[u];
    *reinterpret_cast<uint4*>(dst + TILE + cm(r, c)) = s.lo[u];
  }
}

// The NT landed f32 tiles at p, split in place: hi/lo core-matrix tiles of
// the first at p (bf16 elements [0, 2 TILE)), of the second TILE floats
// further; columns >= hdp are left as they were (no product reads them into
// a stored column). Every thread of the block calls it.
template <int NT>
__device__ __forceinline__ void split_tiles(float* p, int hdp, int t) {
  Split x, y;
  split_read(x, p, hdp, t);
  if constexpr (NT == 2) split_read(y, p + TILE, hdp, t);
  __syncthreads();   // the tiles are read before any thread writes over them
  split_write(reinterpret_cast<bf16*>(p), x, hdp, t);
  if constexpr (NT == 2) split_write(reinterpret_cast<bf16*>(p + TILE), y, hdp, t);
  hopper::fence_proxy_async();   // the hi/lo tiles are visible to wgmma
  __syncthreads();
}

struct F32Maps {   // the tensor maps of the kept tile or pair and the streamed pair
  CUtensorMap kept[2], strm[2];
};

// ---------------------------------------------------------------------------
// The forward: grid B*H * n, the query tiles of a (b, h) adjacent (they
// share its K/V in L2) and the last (most key tiles) first; block = one
// warpgroup on query tile qt, keeping Q (split in place into hi/lo) and
// streaming the K/V tiles up to the diagonal (all n when not causal)
// through FWD_STAGES stages. Each key tile is one `fwd_step`: S = Q K^T as
// one m64n64 product chain over the head dim, the mask on the ragged or
// diagonal tile only, one row-max update and one rescale of O, P split in
// registers, O += P V. o = (sum_k P V) / l straight from the fragments,
// lse = m + log(l) in natural-log units.
// ---------------------------------------------------------------------------
constexpr int FWD_STAGES = 3;
constexpr size_t FWD_RING = sizeof(float) * TILE + FWD_STAGES * PAIR_BYTES;   // Q, the stages
constexpr size_t FWD_SMEM = FWD_RING + sizeof(uint64_t) * (FWD_STAGES + 1);

template <bool kTma>
__global__ void __launch_bounds__(WG, 2) flash_fwd_f32_kernel(
    const __grid_constant__ F32Maps maps, const FwdArgs<float> a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* kept = reinterpret_cast<float*>(smem);   // Q
  float* ring = kept + TILE;                       // stage s: K at ring + 2 s TILE, V TILE further
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + FWD_RING);   // the stages', then Q's
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, q4 = lane & 3;
  const int T = a.T, hdp = a.hdp;
  const int n = n_tiles(T), qt = n - 1 - blockIdx.x % n, bh = blockIdx.x / n;
  const int nkt = a.causal ? qt + 1 : n;
  const size_t rbase = static_cast<size_t>(bh) * T;
  if (hopper::smem_u32(smem) & 1023) __trap();   // the swizzle atoms need 1024-byte alignment

  if constexpr (kTma) {
    if (t == 0) {
      for (int i = 0; i <= FWD_STAGES; ++i) hopper::mbar_init(&full[i], 1);
      hopper::fence_mbar_init();
    }
    __syncthreads();
  }
  auto fill = [&](int kt) {   // key tile kt into its stage
    if (kt < nkt)
      load_tiles<2, kTma>(ring + (kt % FWD_STAGES) * 2 * TILE, maps.strm, a.k, a.v, kt, bh,
                          rbase, a, &full[kt % FWD_STAGES], t);
    if constexpr (!kTma) hopper::cp_async_commit();   // one group per stage, empty past the last
  };
  load_tiles<1, kTma>(kept, maps.kept, a.q, nullptr, qt, bh, rbase, a, &full[FWD_STAGES],
                      t);   // cp.async: joins the first stage's group
  for (int s = 0; s < FWD_STAGES; ++s) fill(s);
  if constexpr (kTma) {
    hopper::mbar_wait(&full[FWD_STAGES], 0);
  } else {
    hopper::cp_async_wait<FWD_STAGES - 1>();   // Q and key tile 0 have landed
    __syncthreads();
  }
  split_tiles<1>(kept, hdp, t);
  const bf16* qs = reinterpret_cast<const bf16*>(kept);   // Q hi, lo

  const float scale2 = a.scale * LOG2E;
  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < nkt; ++kt) {
    float* st = ring + (kt % FWD_STAGES) * 2 * TILE;
    if constexpr (kTma) {
      hopper::mbar_wait(&full[kt % FWD_STAGES], (kt / FWD_STAGES) & 1);
    } else {
      hopper::cp_async_wait<FWD_STAGES - 1>();   // key tile kt has landed
      __syncthreads();
    }
    split_tiles<2>(st, hdp, t);
    const bf16* ks = reinterpret_cast<const bf16*>(st);   // K hi, lo; V hi, lo
    fwd_step<HDP, 2, false>(o, m, l, qs, ks, ks + 2 * TILE, hdp >> 4, kt, qt, T, a.causal,
                            scale2, warp, g, q4);
    __syncthreads();   // everyone is done with this stage before it is refilled
    fill(kt + FWD_STAGES);
  }
  fwd_end<HDP>(a, o, m, l, qt, rbase, t);
}

// ---------------------------------------------------------------------------
// The dQ kernel: grid B*H * n, the query tiles of a (b, h) adjacent (they
// share its K/V in L2) and the last (most key tiles) first; block = one
// warpgroup on query tile qt, keeping Q and dO and streaming the K/V tiles
// up to the diagonal through STAGES stages. S and dP are m64n64 products
// over the head dim, dQ += dS K one m64n64 product per k16 step of keys.
// dq = (sum_k dS K) * scale.
// ---------------------------------------------------------------------------
constexpr size_t DQ_SMEM = RING_BYTES + sizeof(float) * 2 * ROWS + sizeof(uint64_t) * (STAGES + 1);

template <bool kTma>
__global__ void __launch_bounds__(WG, 2) flash_bwd_dq_f32_kernel(
    const __grid_constant__ F32Maps maps, const BwdArgs<float> a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* kept = reinterpret_cast<float*>(smem);   // Q, dO
  float* ring = kept + 2 * TILE;                   // stage s: K at ring + 2 s TILE, V TILE further
  float* stats = reinterpret_cast<float*>(smem + RING_BYTES);        // lse2 [64], delta [64]
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + 2 * ROWS);   // the stages', then Q/dO's
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, q4 = lane & 3;
  const int T = a.T, hd = a.hd, hdp = a.hdp, nks = hdp >> 4;
  const int n = n_tiles(T), qt = n - 1 - blockIdx.x % n, bh = blockIdx.x / n, q0 = qt * ROWS;
  const int nkt = a.causal ? qt + 1 : n;
  const size_t rbase = static_cast<size_t>(bh) * T, qoff = (rbase + q0) * hd;
  if (hopper::smem_u32(smem) & 1023) __trap();   // the swizzle atoms need 1024-byte alignment

  if constexpr (kTma) {
    if (t == 0) {
      for (int i = 0; i <= STAGES; ++i) hopper::mbar_init(&full[i], 1);
      hopper::fence_mbar_init();
    }
    __syncthreads();
  }
  auto fill = [&](int kt) {   // key tile kt into its stage
    if (kt < nkt)
      load_tiles<2, kTma>(ring + (kt % STAGES) * 2 * TILE, maps.strm, a.k, a.v, kt, bh, rbase,
                          a, &full[kt % STAGES], t);
    if constexpr (!kTma) hopper::cp_async_commit();   // one group per stage, empty past the last
  };
  load_tiles<2, kTma>(kept, maps.kept, a.q, a.dout, qt, bh, rbase, a, &full[STAGES],
                      t);   // cp.async: joins the first stage's group
  for (int s = 0; s < STAGES; ++s) fill(s);

  {   // delta in f32, two threads per row, while the copies fly; lse in log2 units
    const int r = t >> 1, j = t & 1;
    float d = 0.f;
    if (q0 + r < T) {
      const float* x = a.dout + qoff + static_cast<size_t>(r) * hd;
      const float* y = a.o + qoff + static_cast<size_t>(r) * hd;
      if ((hd & 3) == 0) {   // every load issued before the sums wait for any
        float4 u[HDP / 8], w[HDP / 8];
#pragma unroll
        for (int i = 0; i < HDP / 8; ++i) {
          const int c = 4 * j + 8 * i;
          u[i] = w[i] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (c < hd) {
            u[i] = *reinterpret_cast<const float4*>(x + c);
            w[i] = *reinterpret_cast<const float4*>(y + c);
          }
        }
#pragma unroll
        for (int i = 0; i < HDP / 8; ++i) {
          d = fmaf(u[i].x, w[i].x, d);
          d = fmaf(u[i].y, w[i].y, d);
          d = fmaf(u[i].z, w[i].z, d);
          d = fmaf(u[i].w, w[i].w, d);
        }
      } else {
        for (int c = j; c < hd; c += 2) d = fmaf(x[c], y[c], d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (j == 0) {
      stats[ROWS + r] = d;
      if (q0 + r < T) a.delta[rbase + q0 + r] = d;
    }
    if (t < ROWS) stats[t] = q0 + t < T ? a.lse[rbase + q0 + t] * LOG2E : 0.f;
  }
  if constexpr (kTma)
    hopper::mbar_wait(&full[STAGES], 0);
  else
    hopper::cp_async_wait<STAGES - 1>();   // Q, dO and key tile 0 have landed
  __syncthreads();   // the rows' statistics (and the cp.async tiles) are visible
  float lse2[2], delta[2];   // rows g, g + 8 of this warp's 16
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    lse2[u] = stats[16 * warp + g + 8 * u];
    delta[u] = stats[ROWS + 16 * warp + g + 8 * u];
  }
  split_tiles<2>(kept, hdp, t);
  const bf16* qs = reinterpret_cast<const bf16*>(kept);   // Q hi, lo; dO hi, lo
  const bf16* dos = qs + 2 * TILE;

  const float scale2 = a.scale * LOG2E;
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    float* st = ring + (kt % STAGES) * 2 * TILE;
    if constexpr (kTma) {
      hopper::mbar_wait(&full[kt % STAGES], (kt / STAGES) & 1);
    } else {
      hopper::cp_async_wait<STAGES - 1>();   // key tile kt has landed
      __syncthreads();
    }
    split_tiles<2>(st, hdp, t);
    const bf16* ks = reinterpret_cast<const bf16*>(st);   // K hi, lo; V hi, lo
    const bf16* vs = ks + 2 * TILE;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    hopper::wgmma_fence();
    issue_abt<HDP, 2, 64>(s, qs, ks, nks);    // S = Q K^T
    issue_abt<HDP, 2, 64>(dp, dos, vs, nks);  // dP = dO V^T
    hopper::wgmma_wait<0>();
    hopper::fence_regs<32>(s);
    hopper::fence_regs<32>(dp);
    const bool edge = (kt + 1) * ROWS > T || (a.causal && kt == qt);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int u = (i >> 1) & 1;
      const int key = kt * ROWS + 8 * (i >> 2) + 2 * q4 + (i & 1);
      const int row = q0 + 16 * warp + g + 8 * u;
      const bool ok = !edge || (key < T && (!a.causal || key <= row));
      const float p = ok ? exp2f(s[i] * scale2 - lse2[u]) : 0.f;
      s[i] = p * (dp[i] - delta[u]);   // dS
    }
    uint32_t f[2][4][4];
    pack_frags<2, 4>(f, s);
    hopper::fence_regs<32>(dq);
    hopper::wgmma_fence();
    issue_xb<HDP, 2, 4>(dq, f, ks);   // dQ += dS K
    hopper::wgmma_wait<0>();
    hopper::fence_regs<32>(dq);
    __syncthreads();   // everyone is done with this stage before it is refilled
    fill(kt + STAGES);
  }
  const float mul[2] = {a.scale, a.scale};
  store_tile(a.dq + qoff, dq, mul, min(ROWS, T - q0), hd, t);
}

// ---------------------------------------------------------------------------
// The dK/dV kernel: grid B*H * n; block = one warpgroup on key tile kt of a
// (b, h), keeping K and V and streaming the query tiles from the diagonal
// on (Q, dO, lse, delta) through STAGES stages, each in two halves of 32
// queries: S^T = K Q^T and dP^T = V dO^T as m64n32 products, then dV +=
// P^T dO and dK += dS^T Q (m64n64, P and dS in registers; a half wholly
// past T is skipped). dv = sum_q P^T dO, dk = (sum_q dS^T Q) * scale, which
// equals the JAX kernel's sum against the scaled q (:144,152). lse and
// delta (rows not 16-byte aligned) come by 4-byte `cp.async` in each
// stage's commit group, 0 past T.
// ---------------------------------------------------------------------------
constexpr size_t DKV_SMEM =
    RING_BYTES + sizeof(float) * 2 * ROWS * STAGES + sizeof(uint64_t) * (STAGES + 1);

template <bool kTma>
__global__ void __launch_bounds__(WG, 2) flash_bwd_dkv_f32_kernel(
    const __grid_constant__ F32Maps maps, const BwdArgs<float> a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* kept = reinterpret_cast<float*>(smem);   // K, V
  float* ring = kept + 2 * TILE;                   // stage s: Q at ring + 2 s TILE, dO TILE further
  float* stats = reinterpret_cast<float*>(smem + RING_BYTES);   // stage s: lse [64], delta [64]
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + 2 * ROWS * STAGES);   // stages, K/V
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, q4 = lane & 3;
  const int T = a.T, hdp = a.hdp, nks = hdp >> 4;
  const int n = n_tiles(T), kt = blockIdx.x % n, bh = blockIdx.x / n, k0 = kt * ROWS;
  const int qt0 = a.causal ? kt : 0, nq = n - qt0;   // causal: from the diagonal on
  const size_t rbase = static_cast<size_t>(bh) * T, koff = (rbase + k0) * a.hd;
  if (hopper::smem_u32(smem) & 1023) __trap();

  if constexpr (kTma) {
    if (t == 0) {
      for (int i = 0; i <= STAGES; ++i) hopper::mbar_init(&full[i], 1);
      hopper::fence_mbar_init();
    }
    __syncthreads();
  }
  auto fill = [&](int j) {   // query tile qt0 + j into stage j % STAGES
    if (j < nq) {
      const int slot = j % STAGES, q0 = (qt0 + j) * ROWS;
      load_tiles<2, kTma>(ring + slot * 2 * TILE, maps.strm, a.q, a.dout, qt0 + j, bh, rbase,
                          a, &full[slot], t);
      // lse (threads 0-63) and delta (64-127), 0 past T
      const int i = t & (ROWS - 1), ok = q0 + i < T;
      const float* src = (t < ROWS ? a.lse : a.delta) + rbase + (ok ? q0 + i : 0);
      hopper::cp_async<4>(stats + slot * 2 * ROWS + t, src, ok ? 4 : 0);
    }
    hopper::cp_async_commit();   // one group per stage, empty past the last
  };
  load_tiles<2, kTma>(kept, maps.kept, a.k, a.v, kt, bh, rbase, a, &full[STAGES],
                      t);   // cp.async: joins the first stage's group
  for (int s = 0; s < STAGES; ++s) fill(s);
  if constexpr (kTma) hopper::mbar_wait(&full[STAGES], 0);
  hopper::cp_async_wait<STAGES - 1>();   // (cp.async) K and V have landed
  __syncthreads();
  split_tiles<2>(kept, hdp, t);
  const bf16* ks = reinterpret_cast<const bf16*>(kept);   // K hi, lo; V hi, lo
  const bf16* vs = ks + 2 * TILE;

  const float scale2 = a.scale * LOG2E;
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  for (int j = 0; j < nq; ++j) {
    const int qt = qt0 + j, slot = j % STAGES;
    float* st = ring + slot * 2 * TILE;
    if constexpr (kTma) hopper::mbar_wait(&full[slot], (j / STAGES) & 1);
    hopper::cp_async_wait<STAGES - 1>();   // tile j's lse and delta (cp.async: and tiles)
    __syncthreads();
    split_tiles<2>(st, hdp, t);
    const float* lse_s = stats + slot * 2 * ROWS;
    const float* delta_s = lse_s + ROWS;
    const bool edge = (qt + 1) * ROWS > T || (a.causal && qt == kt);
    for (int h = 0; h < 2; ++h) {
      if (qt * ROWS + 32 * h >= T) break;   // a half wholly past T
      const bf16* qh = reinterpret_cast<const bf16*>(st) + 32 * 8 * h;   // its 32 queries
      const bf16* doh = qh + 2 * TILE;
      float s[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
      hopper::wgmma_fence();
      issue_abt<HDP, 2, 32>(s, ks, qh, nks);    // S^T = K Q^T
      issue_abt<HDP, 2, 32>(dp, vs, doh, nks);  // dP^T = V dO^T
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
        const float p = ok ? exp2f(s[i] * scale2 - lse_s[qc] * LOG2E) : 0.f;
        ds[i] = p * (dp[i] - delta_s[qc]);
        s[i] = p;
      }
      uint32_t fp[2][2][4], fd[2][2][4];
      pack_frags<2, 2>(fp, s);
      pack_frags<2, 2>(fd, ds);
      hopper::fence_regs<32>(dv);
      hopper::fence_regs<32>(dk);
      hopper::wgmma_fence();
      issue_xb<HDP, 2, 2>(dv, fp, doh);   // dV += P^T dO
      issue_xb<HDP, 2, 2>(dk, fd, qh);    // dK += dS^T Q
      hopper::wgmma_wait<0>();
      hopper::fence_regs<32>(dv);
      hopper::fence_regs<32>(dk);
    }
    __syncthreads();   // everyone is done with this stage before it is refilled
    fill(j + STAGES);
  }
  const float mk[2] = {a.scale, a.scale}, mv[2] = {1.f, 1.f};
  const int nrows = min(ROWS, T - k0);
  store_tile(a.dk + koff, dk, mk, nrows, a.hd, t);
  store_tile(a.dv + koff, dv, mv, nrows, a.hd, t);
}

// The maps of the kept tile x0 (and x1, unless null) and the streamed pair
// (y0, y1) of the [BH, T, hd] tensors; false on an error.
bool f32_maps(F32Maps& maps, int BH, int T, int hd, const float* x0, const float* x1,
              const float* y0, const float* y1) {
  return f32_map(&maps.kept[0], x0, BH, T, hd) &&
         (!x1 || f32_map(&maps.kept[1], x1, BH, T, hd)) &&
         f32_map(&maps.strm[0], y0, BH, T, hd) && f32_map(&maps.strm[1], y1, BH, T, hd);
}

}  // namespace

// Entries for flash_attention.cu's launchers (flash_attention.cuh): the
// tensor maps where f32 rows are 16-byte multiples (a failed encode returns
// an error, no other path), else the cp.async form.
int flash_f32_fwd(const FwdArgs<float>& a, int BH, void* stream) {
  F32Maps maps = {};
  const int blocks = BH * n_tiles(a.T);
  if (a.hd % 4)
    return hopper::launch(flash_fwd_f32_kernel<false>, FWD_SMEM, blocks, WG, stream, maps, a);
  if (!f32_maps(maps, BH, a.T, a.hd, a.q, nullptr, a.k, a.v))
    return static_cast<int>(cudaErrorInvalidValue);
  return hopper::launch(flash_fwd_f32_kernel<true>, FWD_SMEM, blocks, WG, stream, maps, a);
}

int flash_f32_bwd_dq(const BwdArgs<float>& a, int BH, void* stream) {
  F32Maps maps = {};
  const int blocks = BH * n_tiles(a.T);
  if (a.hd % 4)
    return hopper::launch(flash_bwd_dq_f32_kernel<false>, DQ_SMEM, blocks, WG, stream, maps, a);
  if (!f32_maps(maps, BH, a.T, a.hd, a.q, a.dout, a.k, a.v))
    return static_cast<int>(cudaErrorInvalidValue);
  return hopper::launch(flash_bwd_dq_f32_kernel<true>, DQ_SMEM, blocks, WG, stream, maps, a);
}

int flash_f32_bwd_dkv(const BwdArgs<float>& a, int BH, void* stream) {
  F32Maps maps = {};
  const int blocks = BH * n_tiles(a.T);
  if (a.hd % 4)
    return hopper::launch(flash_bwd_dkv_f32_kernel<false>, DKV_SMEM, blocks, WG, stream, maps, a);
  if (!f32_maps(maps, BH, a.T, a.hd, a.k, a.v, a.q, a.dout))
    return static_cast<int>(cudaErrorInvalidValue);
  return hopper::launch(flash_bwd_dkv_f32_kernel<true>, DKV_SMEM, blocks, WG, stream, maps, a);
}

int flash_f32_blocks_per_sm(int which) {
  if (which == 0) return hopper::blocks_per_sm(flash_fwd_f32_kernel<true>, FWD_SMEM, WG);
  return which == 1 ? hopper::blocks_per_sm(flash_bwd_dq_f32_kernel<true>, DQ_SMEM, WG)
                    : hopper::blocks_per_sm(flash_bwd_dkv_f32_kernel<true>, DKV_SMEM, WG);
}
