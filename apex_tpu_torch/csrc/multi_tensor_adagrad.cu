// Multi-tensor Adagrad for Hopper.
//
// Replaces apex_tpu/ops/multi_tensor.py `_adagrad_kernel` (launched by
// `adagrad_packed`; math `_adagrad_math`), over the per-leaf state the JAX
// FusedAdagrad keeps.  What bounds it on the H100: bytes.  Per element it
// reads g, p and the f32 sum h and writes p and h (and, under master
// weights, the model's copy), ~8 f32 operations and one square root: 20
// bytes per element with f32 g and p, ~2.1 ms for GPT-350M's 354M elements
// at 3.35 TB/s.  Design: the by-value table of multi_tensor.cuh (lists g,
// p, h, copy), as #18.  Scalars [lr, eps, weight_decay, grad_scale] and
// the noop flag come from device memory.  Without w_mode the decay is L2
// in the gradient; with it (apex `adagrad_w_mode`) the JAX optimizer
// applies `p - lr * wd * p_old` after the kernel (`fused_adagrad.py:30-38`):
// here the same term, from the same old p and after the Adagrad step, is
// fused into the pass.

#include "multi_tensor.cuh"

namespace apex_tpu_torch {

// scal: [lr, eps, weight_decay, grad_scale]
__global__ void __launch_bounds__(kMTThreads)
multi_tensor_adagrad_kernel(TensorListTable<4> tab, const float* __restrict__ scal,
                            const int* __restrict__ noop, int w_mode) {
  if (noop != nullptr && *noop != 0) return;
  int t;
  int64_t start, end;
  chunk_range(tab, t, start, end);
  const float lr = scal[0], eps = scal[1], wd = scal[2], gscale = scal[3];
  const float l2 = w_mode ? 0.f : wd;
  const float decay = lr * wd;
  const void* gp = tab.ptr[0][t];
  void* pp = tab.ptr[1][t];
  float* hp = static_cast<float*>(tab.ptr[2][t]);
  void* cp = tab.ptr[3][t];
  const int gt = tab.dtype[0][t], pt = tab.dtype[1][t], ct = tab.dtype[3][t];
  for (int64_t i = start + threadIdx.x; i < end; i += kMTThreads) {
    const float p = load_any(pp, pt, i);
    const float g = load_any(gp, gt, i) * gscale + l2 * p;
    const float h = hp[i] + g * g;
    float p_new = p - lr * g / (sqrtf(h) + eps);
    if (w_mode) p_new = p_new - decay * p;
    hp[i] = h;
    store_any(pp, pt, i, p_new);
    if (cp != nullptr) store_any(cp, ct, i, p_new);
  }
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// n tensors: g/p/h/copy host arrays of device addresses (h f32; copy 0
// where a tensor has none), numels, g/p/copy dtype codes; scal: device
// f32[4]; noop: device int32 or null; w_mode: decoupled decay.  *launches
// receives the number of launches made.
extern "C" int apex_multi_tensor_adagrad(int n, const uint64_t* g_ptrs, const uint64_t* p_ptrs,
                                         const uint64_t* h_ptrs, const uint64_t* copy_ptrs,
                                         const int64_t* numels, const int* g_dtypes,
                                         const int* p_dtypes, const int* copy_dtypes,
                                         const void* scal, const void* noop, int w_mode,
                                         int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t* ptrs[4] = {g_ptrs, p_ptrs, h_ptrs, copy_ptrs};
  const int* dtypes[4] = {g_dtypes, p_dtypes, nullptr, copy_dtypes};
  return for_each_table<4>(n, ptrs, dtypes, numels, launches,
                           [&](const TensorListTable<4>& tab, int nb) {
    multi_tensor_adagrad_kernel<<<nb, kMTThreads, 0, st>>>(
        tab, static_cast<const float*>(scal), static_cast<const int*>(noop), w_mode);
    return static_cast<int>(cudaGetLastError());
  });
}
