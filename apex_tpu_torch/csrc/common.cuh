// Shared helpers for the port's Hopper kernels: dtype codes that match
// apex_tpu_torch/_kernels.py, f32 conversions and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace apex_tpu_torch {

// dtype codes passed from Python (_kernels.DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

// finite "minus infinity" of the JAX kernels: exp(kMask - m) == 0, no NaNs
constexpr float kMask = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as jnp.astype
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

}  // namespace apex_tpu_torch
