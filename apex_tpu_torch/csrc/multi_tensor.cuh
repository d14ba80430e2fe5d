// The launch table shared by the port's multi-tensor kernels (Adam, scale,
// L2 norm, the two LAMB stages): apex's multi_tensor_apply design.
//
// The host walks a list of tensors and fills a table that is passed by
// value as the kernel's argument (under the 4 KB parameter limit): per
// tensor one pointer and one dtype code for each of the kernel's N lists,
// the element count, and the index of the tensor's first chunk in the whole
// call; per block the tensor and the 64K-element chunk it owns.  A table
// holds at most 36 tensors and 320 blocks; when either is full the host
// launches it and starts the next one, carrying a tensor whose chunks are
// not all issued.  So a call makes ceil(chunks / 320) launches, more when
// the tensor limit fills a table first, never one per tensor.
//
// Chunk c of a call (counted over the tensors in order, empty tensors
// having none) is chunk_base[t] + block_chunk[b]: kernels that reduce write
// one partial per chunk there, and a second pass sums the partials in a
// fixed order, so no float atomics are used and a run repeats bit for bit.
#pragma once

#include "common.cuh"

namespace apex_tpu_torch {

constexpr int kMTMaxTensors = 36;
constexpr int kMTMaxBlocks = 320;
constexpr int64_t kMTChunk = 65536;  // elements per block
constexpr int kMTThreads = 512;

template <int N>
struct TensorListTable {
  void* ptr[N][kMTMaxTensors];
  int64_t numel[kMTMaxTensors];
  int chunk_base[kMTMaxTensors];
  unsigned char dtype[N][kMTMaxTensors];
  unsigned char block_tensor[kMTMaxBlocks];
  int block_chunk[kMTMaxBlocks];
};
static_assert(sizeof(TensorListTable<5>) + 48 <= 4096, "kernel parameters exceed 4 KB");

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

// Sum of v over the block's threads in a fixed order (warp shuffles, then
// the warps' sums in warp order); the result is valid in warp 0.  smem holds
// 32 floats; the function ends with a barrier, so smem may be reused.
__device__ __forceinline__ float block_sum(float v, float* smem) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (warp == 0) s = warp_sum(lane < static_cast<int>(blockDim.x >> 5) ? smem[lane] : 0.f);
  __syncthreads();
  return s;
}

// The block's element range [start, end) of its tensor's chunk.
template <int N>
__device__ __forceinline__ void chunk_range(const TensorListTable<N>& tab, int& t, int64_t& start,
                                            int64_t& end) {
  t = tab.block_tensor[blockIdx.x];
  start = static_cast<int64_t>(tab.block_chunk[blockIdx.x]) * kMTChunk;
  end = min(tab.numel[t], start + kMTChunk);
}

// Host: walk n tensors and call launch(table, n_blocks) for every full
// table and for the last one.  ptrs[l][t] is the device address of tensor t
// in list l (0 where a list has no tensor there); dtypes[l] is null for an
// f32 list.  *launches receives the number of launches made.
template <int N, typename Launch>
int for_each_table(int n, const uint64_t* const* ptrs, const int* const* dtypes,
                   const int64_t* numels, int* launches, Launch&& launch) {
  *launches = 0;
  TensorListTable<N> tab;
  int nt = 0, nb = 0, chunk = 0;
  for (int t = 0; t < n; ++t) {
    if (numels[t] <= 0) continue;
    for (int l = 0; l < N; ++l) {
      const int code = dtypes[l] == nullptr ? kF32 : dtypes[l][t];
      if (code < kF32 || code > kF16) return static_cast<int>(cudaErrorInvalidValue);
      tab.ptr[l][nt] = reinterpret_cast<void*>(ptrs[l][t]);
      tab.dtype[l][nt] = static_cast<unsigned char>(code);
    }
    tab.numel[nt] = numels[t];
    tab.chunk_base[nt] = chunk;
    ++nt;
    const int64_t n_chunks = (numels[t] + kMTChunk - 1) / kMTChunk;
    for (int64_t c = 0; c < n_chunks; ++c, ++chunk) {
      tab.block_tensor[nb] = static_cast<unsigned char>(nt - 1);
      tab.block_chunk[nb] = static_cast<int>(c);
      ++nb;
      const bool tensor_done = c == n_chunks - 1;
      if (nb == kMTMaxBlocks || (nt == kMTMaxTensors && tensor_done)) {
        const int rc = launch(tab, nb);
        if (rc != 0) return rc;
        ++*launches;
        nb = 0;
        if (tensor_done) {
          nt = 0;
        } else {  // the tensor's remaining chunks go into the next table
          for (int l = 0; l < N; ++l) {
            tab.ptr[l][0] = tab.ptr[l][nt - 1];
            tab.dtype[l][0] = tab.dtype[l][nt - 1];
          }
          tab.numel[0] = tab.numel[nt - 1];
          tab.chunk_base[0] = tab.chunk_base[nt - 1];
          nt = 1;
        }
      }
    }
  }
  if (nb > 0) {
    const int rc = launch(tab, nb);
    if (rc != 0) return rc;
    ++*launches;
  }
  return 0;
}

}  // namespace apex_tpu_torch
