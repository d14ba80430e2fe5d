// Shared pieces of the fused bias-GELU FFN kernels (ffn_fwd.cu, ffn_bwd.cu,
// both launches of csrc/gemm.cuh): the tanh GELU and its derivative.
#pragma once

#include "mma.cuh"

namespace apex_tpu_torch {
namespace ffn {

constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluA = 0.044715f;

// tanh GELU (F.gelu(approximate="tanh"), jax.nn.gelu(approximate=True)) in
// the equal form z sigmoid(2u) = 0.5 z (1 + tanh u), u = sqrt(2/pi) (z +
// 0.044715 z^3): one exponential and one division, a few times cheaper than
// tanhf (the forward takes one per entry of the (tokens, ffn) activation),
// within a few f32 ulps of it; large |u| gives z or -0 exactly
__device__ __forceinline__ float gelu(float z) {
  const float u = kGeluC * z * (1.f + kGeluA * z * z);
  return z / (1.f + __expf(-2.f * u));
}

// its derivative in closed form (apex_tpu/ops/fused_ffn.py `_gelu_grad`)
__device__ __forceinline__ float gelu_grad(float z) {
  const float z2 = z * z;
  const float t = tanhf(kGeluC * z * (1.f + kGeluA * z2));
  return 0.5f * (1.f + t) + 0.5f * z * (1.f - t * t) * kGeluC * (1.f + 3.f * kGeluA * z2);
}

}  // namespace ffn
}  // namespace apex_tpu_torch
