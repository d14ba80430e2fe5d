// Multi-tensor axpby with found-inf for Hopper: out = a * x + b * y.
//
// Replaces apex_tpu/ops/multi_tensor.py `_axpby_kernel` (launched by
// `axpby_packed`; apex's amp_C.multi_tensor_axpby, used to blend gradient
// lists).  What bounds it on the H100: bytes, one read of x and y and one
// write of out per element, three f32 operations; for GPT-350M's 354M f32
// elements that is ~4.2 GB, ~1.27 ms at 3.35 TB/s.  Design: the by-value
// table of multi_tensor.cuh (lists x, y, out), each block one 64K-element
// chunk.  x, y and out may each be f32, bf16 or f16 (the JAX function
// groups by x's dtype only); the sum is taken in f32 and stored in out's
// dtype (round to nearest even).  out may alias x or y: each element is
// read before the same thread writes it.  The found-inf flag is taken on
// the f32 result, as the JAX kernel takes it on its output
// (`_finf_accumulate`): the caller zeroes the flag on the stream, and any
// block that meets a non-finite value stores 1.0.  a and b are device
// scalars, so a changing blend costs no host sync.

#include "multi_tensor.cuh"

namespace apex_tpu_torch {

__global__ void __launch_bounds__(kMTThreads)
multi_tensor_axpby_kernel(TensorListTable<3> tab, const float* __restrict__ ab,
                          float* __restrict__ found_inf) {
  int t;
  int64_t start, end;
  chunk_range(tab, t, start, end);
  const float a = ab[0], b = ab[1];
  const void* xp = tab.ptr[0][t];
  const void* yp = tab.ptr[1][t];
  void* op = tab.ptr[2][t];
  const int xt = tab.dtype[0][t], yt = tab.dtype[1][t], ot = tab.dtype[2][t];
  int bad = 0;
  for (int64_t i = start + threadIdx.x; i < end; i += kMTThreads) {
    const float r = a * load_any(xp, xt, i) + b * load_any(yp, yt, i);
    bad |= !isfinite(r);
    store_any(op, ot, i, r);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) *found_inf = 1.f;
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// n tensors: x/y/out host arrays of device addresses, numels, x/y/out dtype
// codes; ab: device f32[2] = {a, b}; found_inf: device f32 scalar the
// caller has zeroed.  *launches receives the number of launches made.
extern "C" int apex_multi_tensor_axpby(int n, const uint64_t* x_ptrs, const uint64_t* y_ptrs,
                                       const uint64_t* out_ptrs, const int64_t* numels,
                                       const int* x_dtypes, const int* y_dtypes,
                                       const int* out_dtypes, const void* ab, void* found_inf,
                                       int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t* ptrs[3] = {x_ptrs, y_ptrs, out_ptrs};
  const int* dtypes[3] = {x_dtypes, y_dtypes, out_dtypes};
  return for_each_table<3>(n, ptrs, dtypes, numels, launches,
                           [&](const TensorListTable<3>& tab, int nb) {
    multi_tensor_axpby_kernel<<<nb, kMTThreads, 0, st>>>(
        tab, static_cast<const float*>(ab), static_cast<float*>(found_inf));
    return static_cast<int>(cudaGetLastError());
  });
}
