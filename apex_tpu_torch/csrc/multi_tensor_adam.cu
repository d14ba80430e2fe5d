// Multi-tensor Adam / AdamW for Hopper.
//
// Replaces apex_tpu/ops/multi_tensor.py `_adam_kernel` (launched by
// `adam_packed`), over the per-leaf state the JAX FusedAdam keeps (no
// packing).  What bounds it on the H100: bytes.  Per element it reads g, p,
// m, v and writes p, m, v with ~15 f32 operations, ~0.5 operations per
// byte; for GPT-350M's 354M f32 elements that is ~9.9 GB, ~3 ms at 3.35
// TB/s.  Design: apex's multi_tensor_apply, the by-value table of
// multi_tensor.cuh (lists g, p, m, v), so a call makes ceil(chunks / 320)
// launches or a few more (18 for GPT-350M's 291 tensors).  p, m and v are
// updated in place (the JAX kernel aliases them).  The eight scalars (lr,
// beta1, beta2, eps, weight decay, the two bias corrections, the gradient
// scale) and the noop flag are read from device memory, so a
// dynamic-loss-scale skip costs no host sync: a non-zero noop makes every
// block return before it writes.  g and p may be f32, bf16 or f16 (f16
// natively: the TPU's Mosaic lacked it); m, v are f32; math is f32.

#include "multi_tensor.cuh"

namespace apex_tpu_torch {

// scal: [lr, beta1, beta2, eps, weight_decay, bc1, bc2, grad_scale]
__global__ void __launch_bounds__(kMTThreads)
multi_tensor_adam_kernel(TensorListTable<4> tab, const float* __restrict__ scal,
                         const int* __restrict__ noop, int adam_w_mode) {
  if (noop != nullptr && *noop != 0) return;
  int t;
  int64_t start, end;
  chunk_range(tab, t, start, end);
  const float lr = scal[0], beta1 = scal[1], beta2 = scal[2], eps = scal[3];
  const float wd = scal[4], bc1 = scal[5], bc2 = scal[6], gscale = scal[7];
  const void* gp = tab.ptr[0][t];
  void* pp = tab.ptr[1][t];
  float* mp = static_cast<float*>(tab.ptr[2][t]);
  float* vp = static_cast<float*>(tab.ptr[3][t]);
  const int gt = tab.dtype[0][t];
  const int pt = tab.dtype[1][t];
  for (int64_t i = start + threadIdx.x; i < end; i += kMTThreads) {
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
  const uint64_t* ptrs[4] = {g_ptrs, p_ptrs, m_ptrs, v_ptrs};
  const int* dtypes[4] = {g_dtypes, p_dtypes, nullptr, nullptr};
  return for_each_table<4>(n, ptrs, dtypes, numels, launches,
                           [&](const TensorListTable<4>& tab, int nb) {
    multi_tensor_adam_kernel<<<nb, kMTThreads, 0, st>>>(
        tab, static_cast<const float*>(scal), static_cast<const int*>(noop), adam_w_mode);
    return static_cast<int>(cudaGetLastError());
  });
}
