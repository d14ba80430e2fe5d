// Multi-tensor SGD (+ momentum) for Hopper.
//
// Replaces apex_tpu/ops/multi_tensor.py `_sgd_kernel` (launched by
// `sgd_packed`; math `_sgd_math`), over the per-leaf state the JAX FusedSGD
// keeps (no packing).  What bounds it on the H100: bytes.  Per element it
// reads g, p and the f32 momentum buffer and writes p and the buffer (and,
// under master weights, the model's bf16 copy), ~10 f32 operations: 20
// bytes per element with f32 g and p, ~2.1 ms for GPT-350M's 354M elements
// at 3.35 TB/s, ~0.15 ms for ResNet-50's 25.6M.  Design: the by-value
// table of multi_tensor.cuh (lists g, p, buf, copy), as #18.  The five
// scalars [lr, wd, momentum, dampening, grad_scale] and the noop flag are
// read from device memory: the optimizer zeroes the dampening on step 1
// with a device select from its step count (JAX `fused_sgd.py:47`), and a
// dynamic-loss-scale skip makes every block return before it writes.  The
// JAX kernel's static flags are launch arguments: nesterov, first_run (the
// buffer seeded with g), wd_after_momentum, momentum_zero (apex's
// `momentum_mode`: the buffer is neither read nor written).
// p, buf and copy are updated in place (the JAX kernel aliases p and buf).

#include "multi_tensor.cuh"

namespace apex_tpu_torch {

// scal: [lr, wd, momentum, dampening, grad_scale]
__global__ void __launch_bounds__(kMTThreads)
multi_tensor_sgd_kernel(TensorListTable<4> tab, const float* __restrict__ scal,
                        const int* __restrict__ noop, int nesterov, int first_run,
                        int wd_after_momentum, int momentum_zero) {
  if (noop != nullptr && *noop != 0) return;
  int t;
  int64_t start, end;
  chunk_range(tab, t, start, end);
  const float lr = scal[0], wd = scal[1], mom = scal[2], damp = scal[3], gscale = scal[4];
  const void* gp = tab.ptr[0][t];
  void* pp = tab.ptr[1][t];
  float* bp = static_cast<float*>(tab.ptr[2][t]);
  void* cp = tab.ptr[3][t];
  const int gt = tab.dtype[0][t], pt = tab.dtype[1][t], ct = tab.dtype[3][t];
  for (int64_t i = start + threadIdx.x; i < end; i += kMTThreads) {
    float g = load_any(gp, gt, i) * gscale;
    float p = load_any(pp, pt, i);
    if (!wd_after_momentum) g = g + wd * p;
    float upd = g;
    if (!momentum_zero) {
      const float buf = first_run ? g : mom * bp[i] + (1.f - damp) * g;
      bp[i] = buf;
      upd = nesterov ? g + mom * buf : buf;
    }
    if (wd_after_momentum) upd = upd + wd * p;
    p = p - lr * upd;
    store_any(pp, pt, i, p);
    if (cp != nullptr) store_any(cp, ct, i, p);
  }
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// n tensors: g/p/buf/copy host arrays of device addresses (buf f32; copy 0
// where a tensor has none), numels, g/p/copy dtype codes; scal: device
// f32[5]; noop: device int32 or null; then the four static flags.
// *launches receives the number of launches made.
extern "C" int apex_multi_tensor_sgd(int n, const uint64_t* g_ptrs, const uint64_t* p_ptrs,
                                     const uint64_t* buf_ptrs, const uint64_t* copy_ptrs,
                                     const int64_t* numels, const int* g_dtypes,
                                     const int* p_dtypes, const int* copy_dtypes,
                                     const void* scal, const void* noop, int nesterov,
                                     int first_run, int wd_after_momentum, int momentum_zero,
                                     int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t* ptrs[4] = {g_ptrs, p_ptrs, buf_ptrs, copy_ptrs};
  const int* dtypes[4] = {g_dtypes, p_dtypes, nullptr, copy_dtypes};
  return for_each_table<4>(n, ptrs, dtypes, numels, launches,
                           [&](const TensorListTable<4>& tab, int nb) {
    multi_tensor_sgd_kernel<<<nb, kMTThreads, 0, st>>>(
        tab, static_cast<const float*>(scal), static_cast<const int*>(noop), nesterov, first_run,
        wd_after_momentum, momentum_zero);
    return static_cast<int>(cudaGetLastError());
  });
}
