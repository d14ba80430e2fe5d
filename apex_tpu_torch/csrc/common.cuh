// Shared helpers for the port's Hopper kernels: dtype codes that match
// apex_tpu_torch/_kernels.py, f32 conversions, 16-byte vector loads and
// stores, warp reductions and the attention-dropout counter hash.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace apex_tpu_torch {

// Allow a kernel `bytes` of dynamic shared memory on the current device,
// once per kernel and device: a function's attributes belong to one
// device's context, so `done` (the caller's static) holds a bit a device
// already set (devices 64 and up are set on every call).  Returns a
// cudaError_t.
template <typename Kernel>
int set_smem(Kernel kernel, int bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit) != 0) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  done.fetch_or(bit, std::memory_order_release);
  return 0;
}

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

// One 16-byte load or store (the address a multiple of 16 bytes): the
// kVec16<T> elements at that address, as f32.  Stores round to nearest
// even, as from_f32 rounds one element.
template <typename T>
constexpr int kVec16 = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ void load16(const float* src, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* v) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const __half* src, float* v) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const __half2* h = reinterpret_cast<const __half2*>(&w);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __half22float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store16(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* v) {
  uint4 w;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(dst) = w;
}

__device__ __forceinline__ void store16(__half* dst, const float* v) {
  uint4 w;
  __half2* h = reinterpret_cast<__half2*>(&w);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2half2_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(dst) = w;
}

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

// The sum and the max over each aligned group of kLanes lanes (a power of
// two), exchanged with lane ^ 1, ^ 2, ... ^ kLanes / 2 in that order, so
// every lane of a group gets the same bits; all 32 lanes call it.
template <int kLanes>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

template <int kLanes>
__device__ __forceinline__ float lanes_max(float v) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
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
