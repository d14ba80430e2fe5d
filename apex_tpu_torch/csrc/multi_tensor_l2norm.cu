// Multi-tensor sum of squares with found-inf for Hopper.
//
// Replaces apex_tpu/ops/multi_tensor.py `_l2norm_kernel` (launched by
// `l2norm_rowsq_packed`): the global gradient norm of FusedLAMB and of
// `clip_grad_norm_`, and the per-tensor norms of `multi_tensor_l2norm`.
// What bounds it on the H100: bytes, one read per element and two f32
// operations; BERT-large's 335M gradients (bf16 and f32, ~0.67 GB) take
// ~0.2 ms at 3.35 TB/s.  Design: the by-value table of multi_tensor.cuh
// (one list).  Each block sums x^2 over its 64K-element chunk in f32 (the
// TPU kernel's per-row sums become per-chunk sums, chunks split at tensor
// boundaries as apex splits them) and writes the partial of its chunk; no
// float atomics.  A second kernel sums the partials in a fixed order: one
// block per tensor for the per-tensor sums (when asked), and one block for
// the global sum over all partials, so the result repeats bit for bit.
// The found-inf flag is taken on the input: zeroed by the caller on the
// stream, set to 1.0 by any block that meets a non-finite value.

#include "multi_tensor.cuh"

namespace apex_tpu_torch {

constexpr int kRangesPerLaunch = 480;  // tensors per launch of the second pass

struct ChunkRanges {
  int base[kRangesPerLaunch];   // the tensor's first partial
  int count[kRangesPerLaunch];  // its number of partials
};
static_assert(sizeof(ChunkRanges) + 48 <= 4096, "kernel parameters exceed 4 KB");

__global__ void __launch_bounds__(kMTThreads)
multi_tensor_l2norm_kernel(TensorListTable<1> tab, float* __restrict__ partials,
                           float* __restrict__ found_inf) {
  __shared__ float smem[32];
  int t;
  int64_t start, end;
  chunk_range(tab, t, start, end);
  const void* x = tab.ptr[0][t];
  const int xt = tab.dtype[0][t];
  float acc = 0.f;
  int bad = 0;
  for (int64_t i = start + threadIdx.x; i < end; i += kMTThreads) {
    const float v = load_any(x, xt, i);
    bad |= !isfinite(v);
    acc += v * v;
  }
  const float s = block_sum(acc, smem);
  if (threadIdx.x == 0) partials[tab.chunk_base[t] + tab.block_chunk[blockIdx.x]] = s;
  if (__syncthreads_or(bad) && threadIdx.x == 0) *found_inf = 1.f;
}

// Blocks [0, n_ranges): the sum of one tensor's partials into per_tensor;
// block n_ranges (launched only with `total`): the sum of all n_partials.
__global__ void __launch_bounds__(kMTThreads)
multi_tensor_sum_partials_kernel(ChunkRanges ranges, int n_ranges,
                                 const float* __restrict__ partials, int n_partials,
                                 float* __restrict__ per_tensor, float* __restrict__ total) {
  __shared__ float smem[32];
  const int b = blockIdx.x;
  const bool global = b == n_ranges;
  const int base = global ? 0 : ranges.base[b];
  const int count = global ? n_partials : ranges.count[b];
  float acc = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) acc += partials[base + i];
  const float s = block_sum(acc, smem);
  if (threadIdx.x == 0) {
    if (global) *total = s;
    else per_tensor[b] = s;
  }
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// n tensors: x_ptrs host array of device addresses, numels the element
// counts, dtypes the dtype codes.  partials: device f32[chunks] scratch (one
// per 64K-element chunk of each tensor); per_tensor: device f32[n] or null;
// total: device f32 scalar; found_inf: device f32 scalar the caller has
// zeroed.  *launches receives the number of launches of both passes.
extern "C" int apex_multi_tensor_l2norm(int n, const uint64_t* x_ptrs, const int64_t* numels,
                                        const int* dtypes, void* partials, void* per_tensor,
                                        void* total, void* found_inf, int* launches,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  const uint64_t* ptrs[1] = {x_ptrs};
  const int* dts[1] = {dtypes};
  int rc = for_each_table<1>(n, ptrs, dts, numels, launches,
                             [&](const TensorListTable<1>& tab, int nb) {
    multi_tensor_l2norm_kernel<<<nb, kMTThreads, 0, st>>>(tab, part,
                                                          static_cast<float*>(found_inf));
    return static_cast<int>(cudaGetLastError());
  });
  if (rc != 0) return rc;
  ChunkRanges ranges;
  int n_partials = 0;
  for (int t = 0; t < n; ++t)
    n_partials += numels[t] > 0 ? static_cast<int>((numels[t] + kMTChunk - 1) / kMTChunk) : 0;
  // tensors in groups of kRangesPerLaunch; the global sum rides with the last
  int first = per_tensor == nullptr ? n : 0, chunk = 0;
  do {
    const int m = n - first < kRangesPerLaunch ? n - first : kRangesPerLaunch;
    for (int j = 0; j < m; ++j) {
      const int64_t numel = numels[first + j];
      ranges.base[j] = chunk;
      ranges.count[j] = numel > 0 ? static_cast<int>((numel + kMTChunk - 1) / kMTChunk) : 0;
      chunk += ranges.count[j];
    }
    const bool last = first + m == n;
    multi_tensor_sum_partials_kernel<<<m + (last ? 1 : 0), kMTThreads, 0, st>>>(
        ranges, last ? m : kRangesPerLaunch + 1, part, n_partials,
        per_tensor == nullptr ? nullptr : static_cast<float*>(per_tensor) + first,
        static_cast<float*>(total));
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    ++*launches;
    first += m;
  } while (first < n);
  return 0;
}
