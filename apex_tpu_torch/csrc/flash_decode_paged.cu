// Single-query decode attention over a paged KV pool for Hopper.
//
// Replaces apex_tpu/ops/flash_attention.py `_decode_paged_kernel` (launched
// by `flash_attention_decode_paged`), where the TPU's DMA engine walks the
// scalar-prefetched block table.  Here each lane computes its own key's
// address through the table: position pos of slot b lives in pool block
// tbl[b, pos / bs] at row pos % bs.  A 32-key chunk spans 2-4 blocks at the
// engine's block sizes (8, 16), so the lookup is per lane, not per chunk.
// The body (bound, design) is decode.cuh's, shared with the contiguous
// kernel, so on a pool this kernel returns bit for bit what
// flash_decode.cu returns on the gathered cache.
//
// Table entries past a slot's blocks are 0 (the pool's garbage block) and
// are never read below cache_lens; an inactive slot carries an all-zero
// table and a length of 1, so it reads block 0, row 0, and writes an
// output nobody reads.  An entry outside [0, num_blocks) is clamped, so a
// bad table reads a wrong block instead of faulting the card.  The pool is
// read through its strides: the caller passes `pool[:, layer, 0]` (block
// stride layers*2*bs*h*d) and nothing is copied.

#include "decode.cuh"

namespace apex_tpu_torch {

struct PagedStrides {
  int64_t q_b, q_h;
  int64_t k_blk, k_s, k_h;
  int64_t v_blk, v_s, v_h;
  int64_t o_b, o_h;
};

// position pos of one (slot, head) through the slot's table row
template <typename T>
struct PagedAddr {
  const T* k;  // pool bases, already at this head
  const T* v;
  const int* tbl;  // this slot's table row
  int bs, num_blocks;
  int64_t k_blk, k_s, v_blk, v_s;
  __device__ __forceinline__ int64_t block(int pos) const {
    return min(max(tbl[pos / bs], 0), num_blocks - 1);
  }
  __device__ __forceinline__ const T* key(int pos) const {
    return k + block(pos) * k_blk + (pos % bs) * k_s;
  }
  __device__ __forceinline__ const T* value(int pos) const {
    return v + block(pos) * v_blk + (pos % bs) * v_s;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
flash_decode_paged_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o,
                          const int* __restrict__ tables, const int* __restrict__ cache_lens,
                          int heads, int num_blocks, int bs, int max_blocks, PagedStrides st,
                          float scale) {
  const int bi = blockIdx.x / heads;
  const int hi = blockIdx.x % heads;
  const int len = max(0, min(cache_lens[bi], max_blocks * bs));
  const PagedAddr<T> addr{k + hi * st.k_h,
                          v + hi * st.v_h,
                          tables + static_cast<int64_t>(bi) * max_blocks,
                          bs,
                          num_blocks,
                          st.k_blk,
                          st.k_s,
                          st.v_blk,
                          st.v_s};
  decode_attend<T, D>(q + bi * st.q_b + hi * st.q_h, o + bi * st.o_b + hi * st.o_h, len, addr,
                      scale);
}

template <typename T, int D>
static void launch_paged(const void* q, const void* k, const void* v, void* o, const void* tables,
                         const void* lens, int batch, int heads, int num_blocks, int bs,
                         int max_blocks, const PagedStrides& st, float scale,
                         cudaStream_t stream) {
  flash_decode_paged_kernel<T, D>
      <<<static_cast<unsigned>(batch * heads), kDecodeThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<T*>(o), static_cast<const int*>(tables), static_cast<const int*>(lens),
          heads, num_blocks, bs, max_blocks, st, scale);
}

template <typename T>
static int dispatch_paged(int head_dim, const void* q, const void* k, const void* v, void* o,
                          const void* tables, const void* lens, int batch, int heads,
                          int num_blocks, int bs, int max_blocks, const PagedStrides& st,
                          float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      launch_paged<T, 16>(q, k, v, o, tables, lens, batch, heads, num_blocks, bs, max_blocks, st,
                          scale, stream);
      return 0;
    case 32:
      launch_paged<T, 32>(q, k, v, o, tables, lens, batch, heads, num_blocks, bs, max_blocks, st,
                          scale, stream);
      return 0;
    case 64:
      launch_paged<T, 64>(q, k, v, o, tables, lens, batch, heads, num_blocks, bs, max_blocks, st,
                          scale, stream);
      return 0;
    case 128:
      launch_paged<T, 128>(q, k, v, o, tables, lens, batch, heads, num_blocks, bs, max_blocks,
                           st, scale, stream);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// q, o: (b, h, d); k/v: pool views (num_blocks, bs, h, d) with the given
// strides (in elements) and a contiguous last dim; tables: (b, max_blocks)
// int32 contiguous; cache_lens: (b,) int32.
extern "C" int apex_flash_decode_paged(const void* q, const void* k, const void* v, void* o,
                                       const void* tables, const void* cache_lens, int batch,
                                       int heads, int head_dim, int num_blocks, int block_size,
                                       int max_blocks, int64_t q_b, int64_t q_h, int64_t k_blk,
                                       int64_t k_s, int64_t k_h, int64_t v_blk, int64_t v_s,
                                       int64_t v_h, int64_t o_b, int64_t o_h, float scale,
                                       int dtype, void* stream) {
  if (batch <= 0 || heads <= 0) return 0;
  if (num_blocks <= 0 || block_size <= 0 || max_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedStrides st{q_b, q_h, k_blk, k_s, k_h, v_blk, v_s, v_h, o_b, o_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case kF32:
      rc = dispatch_paged<float>(head_dim, q, k, v, o, tables, cache_lens, batch, heads,
                                 num_blocks, block_size, max_blocks, st, scale, s);
      break;
    case kBF16:
      rc = dispatch_paged<__nv_bfloat16>(head_dim, q, k, v, o, tables, cache_lens, batch, heads,
                                         num_blocks, block_size, max_blocks, st, scale, s);
      break;
    case kF16:
      rc = dispatch_paged<__half>(head_dim, q, k, v, o, tables, cache_lens, batch, heads,
                                  num_blocks, block_size, max_blocks, st, scale, s);
      break;
    default:
      rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
