// The by-value launch table of the port's whole-list multi-tensor kernels
// (#15 scale, csrc/multi_tensor_scale.cu; #19 SGD, csrc/multi_tensor_sgd.cu;
// #20 LAMB stage 1, csrc/multi_tensor_lamb.cu).
//
// One table holds up to kMax tensors of N lists and is passed by value as a
// `__grid_constant__` kernel parameter (up to 32,764 bytes of parameters
// since CUDA 12.1 on sm_70 and later), so a list of a few hundred tensors
// takes one launch; a longer list takes ceil(tensors / kMax) launches, each
// full but the last.  The grid is one block per `chunk`-element chunk of
// every tensor; a block finds its tensor by a binary search over the
// tensors' first-chunk indices (`list_tensor`).  Per tensor the table holds
// one pointer per list, the element count, the kernel's dtype signature
// (`sig`, the kernel's own code) and the scalar head (`vector_head`: the
// elements before every list of the tensor is on the 16-byte grid, or
// kListNoVector when no count aligns them), both found on the host.
// Chunk c of a launch is its tensors' chunks in order, empty tensors having
// none; `walk_lists` tells each launch the index of its first chunk in the
// whole call, so a reducing kernel numbers its per-chunk partials as one
// launch over the whole list would.
#pragma once

#include "common.cuh"

#if CUDART_VERSION < 12010
#error "multi_tensor_list.cuh passes tables of ~30 KB: kernel parameters above 4 KB need CUDA 12.1"
#endif

namespace apex_tpu_torch {

constexpr int kListParamLimit = 32764;  // bytes of kernel parameters, CUDA 12.1, sm_70+
constexpr int kListNoVector = 8;        // head code: scalar only

// chunk_start[t] is the launch's index of tensor t's first chunk;
// chunk_start[n] is the grid.
template <int N, int kMax>
struct ListTable {
  void* ptr[N][kMax];
  int64_t numel[kMax];
  int chunk_start[kMax + 1];
  unsigned char sig[kMax];
  unsigned char head[kMax];
};

// the tensor owning `block`: the last t with chunk_start[t] <= block
template <int N, int kMax>
__device__ __forceinline__ int list_tensor(const ListTable<N, kMax>& tab, int n_tensors,
                                           int block) {
  int lo = 0, hi = n_tensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.chunk_start[mid] <= block) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// 8 consecutive elements, 16-byte aligned, to f32 and back (one or two
// 16-byte words)
template <typename T>
__device__ __forceinline__ void load8(const T* src, float (&v)[8]) {
#pragma unroll
  for (int k = 0; k < 8; k += kVec16<T>) load16(src + k, v + k);
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&v)[8]) {
#pragma unroll
  for (int k = 0; k < 8; k += kVec16<T>) store16(dst + k, v + k);
}

constexpr int dtype_size(int code) { return code == kF32 ? 4 : 2; }

// The fewest leading elements (0-7) after which each list's address is a
// multiple of 16 bytes, or kListNoVector when no count aligns them all.
// addr[l] == 0: list l is absent.
template <int N>
static int vector_head(const uint64_t (&addr)[N], const int (&size)[N]) {
  for (int h = 0; h < 8; ++h) {
    bool ok = true;
    for (int l = 0; l < N; ++l) {
      if (addr[l] != 0 && (addr[l] + static_cast<uint64_t>(h * size[l])) % 16 != 0) ok = false;
    }
    if (ok) return h;
  }
  return kListNoVector;
}

// Host: walk n tensors into tables of kMax and call
// launch(table, n_tensors, n_chunks, first_chunk) for every full table and
// for the last one.  ptrs[l][t] is the device address of tensor t in list
// l (0: absent); codes[l] its dtype codes (null: an f32 list; an absent
// entry counts as f32); sig(codes, addr) the kernel's signature byte.
// Empty tensors are skipped.  *launches receives the number of launches
// made.
template <int N, int kMax, typename Sig, typename Launch>
int walk_lists(int n, const uint64_t* const* ptrs, const int* const* codes,
               const int64_t* numels, int64_t chunk, int* launches, Sig&& sig,
               Launch&& launch) {
  *launches = 0;
  ListTable<N, kMax> tab;
  int nt = 0;
  int64_t chunks = 0, first = 0;
  auto flush = [&]() {
    tab.chunk_start[nt] = static_cast<int>(chunks);
    const int rc = launch(tab, nt, chunks, first);
    ++*launches;
    first += chunks;
    nt = 0;
    chunks = 0;
    return rc;
  };
  for (int t = 0; t < n; ++t) {
    if (numels[t] <= 0) continue;
    int code[N], size[N];
    uint64_t addr[N];
    for (int l = 0; l < N; ++l) {
      addr[l] = ptrs[l][t];
      code[l] = codes[l] == nullptr || addr[l] == 0 ? kF32 : codes[l][t];
      if (code[l] < kF32 || code[l] > kF16) return static_cast<int>(cudaErrorInvalidValue);
      size[l] = dtype_size(code[l]);
      tab.ptr[l][nt] = reinterpret_cast<void*>(addr[l]);
    }
    const int64_t n_chunks = (numels[t] + chunk - 1) / chunk;
    if (chunks + n_chunks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    tab.numel[nt] = numels[t];
    tab.chunk_start[nt] = static_cast<int>(chunks);
    tab.sig[nt] = static_cast<unsigned char>(sig(code, addr));
    tab.head[nt] = static_cast<unsigned char>(vector_head<N>(addr, size));
    chunks += n_chunks;
    if (++nt == kMax) {
      const int rc = flush();
      if (rc != 0) return rc;
    }
  }
  if (nt > 0) return flush();
  return 0;
}

}  // namespace apex_tpu_torch
