// The erf GELU form of the bf16 fused-layer kernels B1-B4: the source of
// fused_layer_prefix.cu built with BESO_ERF_GELU 1, as a translation unit of
// its own, so that the build (ops/build.py: one nvcc per source, all at
// once) compiles it beside the tanh form. Its kernels are the kErf
// instantiations (B2's group, and the single layer of B1, B3 and B4); its
// entries are fused_layer_prefix.cu's with `erf_` after `beso_fused_`. The
// phase clock, the limits and the error string stay in the tanh unit.
#define BESO_ERF_GELU 1
#include "fused_layer_prefix.cu"
