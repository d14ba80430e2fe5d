// Multi-tensor scale with found-inf for Hopper: out = x * s.
//
// Replaces apex_tpu/ops/multi_tensor.py `_scale_kernel` (launched by
// `scale_packed`): the amp unscale (`LossScaler.unscale`) and the rescale of
// `clip_grad_norm_`.  What bounds it on the H100: bytes, one read of x and
// one write of out per element, one f32 multiply; BERT-large's 335M bf16
// and f32 gradients take ~0.4 ms at 3.35 TB/s.  Design: the by-value table
// of multi_tensor.cuh (lists in, out), each block one 64K-element chunk.
// The product is taken in f32 and stored in the output's dtype (f32, bf16
// or f16, round to nearest even), so one call can unscale into another
// dtype; in == out is allowed (each element is read before it is written by
// the same thread).  The found-inf flag is computed on the scaled value, as
// the JAX kernel does.  The TPU kernel carries the flag across its
// sequential grid; here blocks run concurrently, so the caller zeroes the
// flag on the stream before the launch and any block that meets a
// non-finite value stores 1.0 (apex's benign race: every writer writes the
// same value).  s and the flag live in device memory: no host sync.

#include "multi_tensor.cuh"

namespace apex_tpu_torch {

__global__ void __launch_bounds__(kMTThreads)
multi_tensor_scale_kernel(TensorListTable<2> tab, const float* __restrict__ scale,
                          float* __restrict__ found_inf) {
  int t;
  int64_t start, end;
  chunk_range(tab, t, start, end);
  const float s = *scale;
  const void* in = tab.ptr[0][t];
  void* out = tab.ptr[1][t];
  const int it = tab.dtype[0][t], ot = tab.dtype[1][t];
  int bad = 0;
  for (int64_t i = start + threadIdx.x; i < end; i += kMTThreads) {
    const float y = load_any(in, it, i) * s;
    bad |= !isfinite(y);
    store_any(out, ot, i, y);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) *found_inf = 1.f;
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// n tensors: in_ptrs/out_ptrs host arrays of device addresses, numels the
// element counts, in_dtypes/out_dtypes the dtype codes.  scale: device f32
// scalar; found_inf: device f32 scalar the caller has zeroed.  *launches
// receives the number of kernel launches made.
extern "C" int apex_multi_tensor_scale(int n, const uint64_t* in_ptrs, const uint64_t* out_ptrs,
                                       const int64_t* numels, const int* in_dtypes,
                                       const int* out_dtypes, const void* scale, void* found_inf,
                                       int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t* ptrs[2] = {in_ptrs, out_ptrs};
  const int* dtypes[2] = {in_dtypes, out_dtypes};
  return for_each_table<2>(n, ptrs, dtypes, numels, launches,
                           [&](const TensorListTable<2>& tab, int nb) {
    multi_tensor_scale_kernel<<<nb, kMTThreads, 0, st>>>(
        tab, static_cast<const float*>(scale), static_cast<float*>(found_inf));
    return static_cast<int>(cudaGetLastError());
  });
}
