// Multi-tensor Adam / AdamW for Hopper.
//
// Replaces apex_tpu/ops/multi_tensor.py `_adam_kernel` (launched by
// `adam_packed`), over the per-leaf state the JAX FusedAdam keeps (no
// packing).  What bounds it on the H100: bytes.  Per element it reads g, p,
// m, v and writes p, m, v with ~15 f32 operations, ~0.5 operations per
// byte; for GPT-350M's 354M f32 elements that is ~9.9 GB, ~3 ms at 3.35
// TB/s.  Design: apex's multi_tensor_apply.  The host walks the list of
// tensors and fills a table passed by value as the kernel's argument (under
// the 4 KB parameter limit): per tensor the g/p/m/v pointers, the element
// count and the dtypes of g and p; per block the tensor and the 64K-element
// chunk it updates.  A table holds at most 36 tensors and 320 blocks; when
// either is full the host launches it and starts the next one, carrying a
// tensor whose chunks are not all issued.  So a call makes ceil(chunks /
// 320) launches, more when the tensor limit fills a table first, never one
// per tensor (the count is returned; 18 for GPT-350M's 291 tensors).  p,
// m and v are updated in place (the JAX kernel aliases them).  The eight
// scalars (lr, beta1, beta2, eps, weight decay, the two bias corrections,
// the gradient scale) and the noop flag are read from device memory, so a
// dynamic-loss-scale skip costs no host sync: a non-zero noop makes every
// block return before it writes.  g and p may be f32, bf16 or f16 (f16
// natively: the TPU's Mosaic lacked it); m, v are f32; math is f32.

#include "common.cuh"

namespace apex_tpu_torch {

constexpr int kAdamMaxTensors = 36;
constexpr int kAdamMaxBlocks = 320;
constexpr int64_t kAdamChunk = 65536;  // elements per block
constexpr int kAdamThreads = 512;

struct AdamTable {
  void* g[kAdamMaxTensors];
  void* p[kAdamMaxTensors];
  float* m[kAdamMaxTensors];
  float* v[kAdamMaxTensors];
  int64_t numel[kAdamMaxTensors];
  unsigned char g_dtype[kAdamMaxTensors];
  unsigned char p_dtype[kAdamMaxTensors];
  unsigned char block_tensor[kAdamMaxBlocks];
  int block_chunk[kAdamMaxBlocks];
};
static_assert(sizeof(AdamTable) + 32 <= 4096, "kernel parameters exceed 4 KB");

__device__ __forceinline__ float load_any(const void* base, int dtype, int64_t i) {
  switch (dtype) {
    case kBF16: return to_f32(static_cast<const __nv_bfloat16*>(base)[i]);
    case kF16: return to_f32(static_cast<const __half*>(base)[i]);
    default: return static_cast<const float*>(base)[i];
  }
}

__device__ __forceinline__ void store_any(void* base, int dtype, int64_t i, float x) {
  switch (dtype) {
    case kBF16: static_cast<__nv_bfloat16*>(base)[i] = from_f32<__nv_bfloat16>(x); break;
    case kF16: static_cast<__half*>(base)[i] = from_f32<__half>(x); break;
    default: static_cast<float*>(base)[i] = x;
  }
}

// scal: [lr, beta1, beta2, eps, weight_decay, bc1, bc2, grad_scale]
__global__ void __launch_bounds__(kAdamThreads)
multi_tensor_adam_kernel(AdamTable tab, const float* __restrict__ scal,
                         const int* __restrict__ noop, int adam_w_mode) {
  if (noop != nullptr && *noop != 0) return;
  const int t = tab.block_tensor[blockIdx.x];
  const int64_t start = static_cast<int64_t>(tab.block_chunk[blockIdx.x]) * kAdamChunk;
  const int64_t end = min(tab.numel[t], start + kAdamChunk);
  const float lr = scal[0], beta1 = scal[1], beta2 = scal[2], eps = scal[3];
  const float wd = scal[4], bc1 = scal[5], bc2 = scal[6], gscale = scal[7];
  void* gp = tab.g[t];
  void* pp = tab.p[t];
  float* mp = tab.m[t];
  float* vp = tab.v[t];
  const int gt = tab.g_dtype[t];
  const int pt = tab.p_dtype[t];
  for (int64_t i = start + threadIdx.x; i < end; i += kAdamThreads) {
    float g = load_any(gp, gt, i) * gscale;
    float p = load_any(pp, pt, i);
    if (!adam_w_mode) g = g + wd * p;  // classic Adam: L2 folded into the gradient
    const float m = beta1 * mp[i] + (1.f - beta1) * g;
    const float v = beta2 * vp[i] + (1.f - beta2) * g * g;
    float update = (m / bc1) / (sqrtf(v / bc2) + eps);
    if (adam_w_mode) update = update + wd * p;  // AdamW: decoupled weight decay
    p = p - lr * update;
    mp[i] = m;
    vp[i] = v;
    store_any(pp, pt, i, p);
  }
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// n tensors: g_ptrs/p_ptrs/m_ptrs/v_ptrs are host arrays of device
// addresses, numels the element counts, g_dtypes/p_dtypes the dtype codes
// (m and v are f32).  scal: device f32[8]; noop: device int32 or null.
// *launches receives the number of kernel launches made.
extern "C" int apex_multi_tensor_adam(int n, const uint64_t* g_ptrs, const uint64_t* p_ptrs,
                                      const uint64_t* m_ptrs, const uint64_t* v_ptrs,
                                      const int64_t* numels, const int* g_dtypes,
                                      const int* p_dtypes, const void* scal, const void* noop,
                                      int adam_w_mode, int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launches = 0;
  AdamTable tab;
  int nt = 0, nb = 0;
  for (int t = 0; t < n; ++t) {
    if (numels[t] <= 0) continue;
    if (g_dtypes[t] < kF32 || g_dtypes[t] > kF16 || p_dtypes[t] < kF32 || p_dtypes[t] > kF16)
      return static_cast<int>(cudaErrorInvalidValue);
    tab.g[nt] = reinterpret_cast<void*>(g_ptrs[t]);
    tab.p[nt] = reinterpret_cast<void*>(p_ptrs[t]);
    tab.m[nt] = reinterpret_cast<float*>(m_ptrs[t]);
    tab.v[nt] = reinterpret_cast<float*>(v_ptrs[t]);
    tab.numel[nt] = numels[t];
    tab.g_dtype[nt] = static_cast<unsigned char>(g_dtypes[t]);
    tab.p_dtype[nt] = static_cast<unsigned char>(p_dtypes[t]);
    ++nt;
    const int64_t n_chunks = (numels[t] + kAdamChunk - 1) / kAdamChunk;
    for (int64_t c = 0; c < n_chunks; ++c) {
      tab.block_tensor[nb] = static_cast<unsigned char>(nt - 1);
      tab.block_chunk[nb] = static_cast<int>(c);
      ++nb;
      const bool tensor_done = c == n_chunks - 1;
      if (nb == kAdamMaxBlocks || (nt == kAdamMaxTensors && tensor_done)) {
        multi_tensor_adam_kernel<<<nb, kAdamThreads, 0, st>>>(
            tab, static_cast<const float*>(scal), static_cast<const int*>(noop), adam_w_mode);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        ++*launches;
        nb = 0;
        if (tensor_done) {
          nt = 0;
        } else {  // the tensor's remaining chunks go into the next table
          tab.g[0] = tab.g[nt - 1];
          tab.p[0] = tab.p[nt - 1];
          tab.m[0] = tab.m[nt - 1];
          tab.v[0] = tab.v[nt - 1];
          tab.numel[0] = tab.numel[nt - 1];
          tab.g_dtype[0] = tab.g_dtype[nt - 1];
          tab.p_dtype[0] = tab.p_dtype[nt - 1];
          nt = 1;
        }
      }
    }
  }
  if (nb > 0) {
    multi_tensor_adam_kernel<<<nb, kAdamThreads, 0, st>>>(
        tab, static_cast<const float*>(scal), static_cast<const int*>(noop), adam_w_mode);
    ++*launches;
  }
  return static_cast<int>(cudaGetLastError());
}
