// What the flash-attention sources share: the kernels' arguments, which
// flash_attention.cu's launchers fill, and the entries those launchers call:
// flash_attention_wide.cu's at tile width 128 (the forward and the backward,
// in both dtypes) and flash_attention_f32.cu's, the f32 forward and backward
// at tile width 64.
#pragma once

#include <cuda_bf16.h>

template <typename E>
struct FwdArgs {
  const E* q;
  const E* k;
  const E* v;
  E* o;
  float* lse;
  int T, hd, hdp, causal;
  int vec;           // bytes per bf16 tile copy: 8 (hd % 4 == 0), 4 (hd even), 2 (plain loads)
  float scale;
};

template <typename E>
struct BwdArgs {
  const E* q;
  const E* k;
  const E* v;
  const E* o;        // forward output (dQ kernel: delta)
  const E* dout;
  const float* lse;
  float* delta;      // written by the dQ kernel, read by the dK/dV kernel
  E* dq;
  E* dk;
  E* dv;
  int T, hd, hdp, causal;
  int vec;           // as in FwdArgs
  float scale;
};

// flash_attention_wide.cu, for hdp 80-128: each launches on `stream` the
// kernel for BH heads' worth of `a` and returns cudaGetLastError() (0 =
// launched). `vec` is the bf16 mma.sync kernels' alone; these ignore it.
int flash_wide_fwd(const FwdArgs<__nv_bfloat16>& a, int BH, void* stream);
int flash_wide_fwd(const FwdArgs<float>& a, int BH, void* stream);
int flash_wide_bwd_dq(const BwdArgs<__nv_bfloat16>& a, int BH, void* stream);
int flash_wide_bwd_dq(const BwdArgs<float>& a, int BH, void* stream);
int flash_wide_bwd_dkv(const BwdArgs<__nv_bfloat16>& a, int BH, void* stream);
int flash_wide_bwd_dkv(const BwdArgs<float>& a, int BH, void* stream);
// Resident blocks per SM of the forward (which = 0), the dQ (1) and the
// dK/dV kernel (2), bf16 or (f32) f32; -1 on an error.
int flash_wide_blocks_per_sm(int which, int f32);

// flash_attention_f32.cu, the f32 kernels for hdp <= 64: as above; and the
// resident blocks per SM of the forward (which = 0), the dQ (1) or the dK/dV
// kernel (2), -1 on an error.
int flash_f32_fwd(const FwdArgs<float>& a, int BH, void* stream);
int flash_f32_bwd_dq(const BwdArgs<float>& a, int BH, void* stream);
int flash_f32_bwd_dkv(const BwdArgs<float>& a, int BH, void* stream);
int flash_f32_blocks_per_sm(int which);
