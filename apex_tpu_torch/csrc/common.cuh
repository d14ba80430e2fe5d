// Shared helpers for the port's Hopper kernels: dtype codes that match
// apex_tpu_torch/_kernels.py, f32 conversions, warp reductions and the
// attention-dropout counter hash.
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

// v rounded to T and back: where the JAX kernels cast an operand to the
// input dtype before a product (p before PV, dS before dQ/dK)
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

// Probability dropout: the counter hash of apex_tpu/ops/flash_attention.py
// (`_mix32`, `_dropout_hash`), bit for bit.  The keep factor of
// (seed, batch*head, q_pos, k_pos) is keep_scale where the hash is >=
// threshold, else 0; uint32 arithmetic wraps as jnp.uint32 does.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

struct Dropout {
  int on;              // 0: no dropout, the factor is 1
  uint32_t threshold;  // round(rate * 2^32), clamped
  float keep_scale;    // 1 / (1 - rate) in f32
  uint32_t seed;
};

// hash state after (seed, bh, q_pos); mix in k_pos with dropout_factor
__device__ __forceinline__ uint32_t dropout_row_hash(const Dropout& dr, uint32_t bh,
                                                     uint32_t q_pos) {
  return mix32(mix32(bh ^ mix32(dr.seed)) ^ q_pos);
}

__device__ __forceinline__ float dropout_factor(const Dropout& dr, uint32_t row_hash,
                                                uint32_t k_pos) {
  return mix32(row_hash ^ k_pos) >= dr.threshold ? dr.keep_scale : 0.f;
}

}  // namespace apex_tpu_torch
