// Multi-tensor NovoGrad (the element-wise stage) for Hopper.
//
// Replaces apex_tpu/ops/multi_tensor.py `_novograd_kernel` (launched by
// `novograd_packed`; math `_novograd_math`), over the per-leaf state the
// JAX FusedNovoGrad keeps.  NovoGrad's second moment v is one scalar per
// tensor: the optimizer updates it beforehand from #17's per-tensor sums of
// squares (a (n,) vector on the device) and this pass normalises each
// gradient by its tensor's sqrt(v).  What bounds it on the H100: bytes.
// Per element it reads g, p and the f32 moment m and writes p and m (and,
// under master weights, the model's copy): 20 bytes per element with f32
// g and p, ~2.1 ms for GPT-350M's 354M elements at 3.35 TB/s.  Design: the
// by-value table of multi_tensor.cuh.  The TPU kernel broadcasts v per
// 128-lane row; here a block knows its table slot, not the tensor's index
// in the call, so the host puts the address of the tensor's v entry into
// the table as a fifth list (lists g, p, m, copy, v; TensorListTable<5>
// stays under the 4 KB parameter limit, as for LAMB stage 1).  Scalars
// [lr, beta1, weight_decay, eps, grad_scale, beta3] (lr with the bias
// corrections folded in) and the noop flag come from device memory.

#include "multi_tensor.cuh"

namespace apex_tpu_torch {

// scal: [lr, beta1, weight_decay, eps, grad_scale, beta3]
__global__ void __launch_bounds__(kMTThreads)
multi_tensor_novograd_kernel(TensorListTable<5> tab, const float* __restrict__ scal,
                             const int* __restrict__ noop, int reg_inside_moment) {
  if (noop != nullptr && *noop != 0) return;
  int t;
  int64_t start, end;
  chunk_range(tab, t, start, end);
  const float lr = scal[0], beta1 = scal[1], wd = scal[2], eps = scal[3];
  const float gscale = scal[4], beta3 = scal[5];
  const float denom = sqrtf(*static_cast<const float*>(tab.ptr[4][t])) + eps;
  const void* gp = tab.ptr[0][t];
  void* pp = tab.ptr[1][t];
  float* mp = static_cast<float*>(tab.ptr[2][t]);
  void* cp = tab.ptr[3][t];
  const int gt = tab.dtype[0][t], pt = tab.dtype[1][t], ct = tab.dtype[3][t];
  for (int64_t i = start + threadIdx.x; i < end; i += kMTThreads) {
    const float p = load_any(pp, pt, i);
    float g = load_any(gp, gt, i) * gscale;
    g = g / denom;
    if (reg_inside_moment) g = g + wd * p;
    const float m = beta1 * mp[i] + beta3 * g;
    const float upd = reg_inside_moment ? m : m + wd * p;
    const float p_new = p - lr * upd;
    mp[i] = m;
    store_any(pp, pt, i, p_new);
    if (cp != nullptr) store_any(cp, ct, i, p_new);
  }
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// n tensors: g/p/m/copy host arrays of device addresses (m f32; copy 0
// where a tensor has none), v_ptrs the device address of each tensor's f32
// second moment, numels, g/p/copy dtype codes; scal: device f32[6]; noop:
// device int32 or null.  *launches receives the number of launches made.
extern "C" int apex_multi_tensor_novograd(int n, const uint64_t* g_ptrs, const uint64_t* p_ptrs,
                                          const uint64_t* m_ptrs, const uint64_t* copy_ptrs,
                                          const uint64_t* v_ptrs, const int64_t* numels,
                                          const int* g_dtypes, const int* p_dtypes,
                                          const int* copy_dtypes, const void* scal,
                                          const void* noop, int reg_inside_moment, int* launches,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t* ptrs[5] = {g_ptrs, p_ptrs, m_ptrs, copy_ptrs, v_ptrs};
  const int* dtypes[5] = {g_dtypes, p_dtypes, nullptr, copy_dtypes, nullptr};
  return for_each_table<5>(n, ptrs, dtypes, numels, launches,
                           [&](const TensorListTable<5>& tab, int nb) {
    multi_tensor_novograd_kernel<<<nb, kMTThreads, 0, st>>>(
        tab, static_cast<const float*>(scal), static_cast<const int*>(noop), reg_inside_moment);
    return static_cast<int>(cudaGetLastError());
  });
}
