// Single-query decode attention over a paged KV pool for Hopper.
//
// Replaces apex_tpu/ops/flash_attention.py `_decode_paged_kernel` (launched
// by `flash_attention_decode_paged`), where the TPU's DMA engine walks the
// scalar-prefetched block table.  Bound by bytes (each valid key and value
// read once).  The body is decode.cuh's split-K pass, shared with the
// contiguous kernel, so on a pool this kernel returns bit for bit what
// flash_decode.cu returns on the gathered cache.  Position pos of slot b
// lives in pool block tbl[b, pos / bs] at row pos % bs; the block size is a
// power of two, so a kDecodeSplit-key chunk covers kDecodeSplit / bs table
// entries (one, inside a block, when bs is larger).  Each block loads its
// chunk's entries once into shared memory, clamped, and a row's address is
// then a shift and a mask away: no table read or divide per key.
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

// row r of one (slot, head)'s chunk through the chunk's table entries
template <typename T>
struct PagedAddr {
  const T* k;        // pool bases, already at this head
  const T* v;
  const int* blk;    // the chunk's clamped block ids (shared memory)
  int first;         // the chunk's first position, as a row of blk[0]
  int shift, mask;   // log2(bs), bs - 1
  int64_t k_blk, k_s, v_blk, v_s;
  __device__ __forceinline__ const T* key(int r) const {
    const int p = first + r;
    return k + blk[p >> shift] * k_blk + (p & mask) * k_s;
  }
  __device__ __forceinline__ const T* value(int r) const {
    const int p = first + r;
    return v + blk[p >> shift] * v_blk + (p & mask) * v_s;
  }
};

// grid (batch * heads, chunks): one chunk of one (slot, head)
template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
flash_decode_paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const int* __restrict__ tables,
                                const int* __restrict__ cache_lens, int heads, int num_blocks,
                                int bs_log2, int max_blocks, PagedStrides st, DecodeWork work,
                                float scale) {
  __shared__ int blk[kDecodeSplit];
  const int bh = blockIdx.x;
  const int bi = bh / heads;
  const int hi = bh % heads;
  const int c0 = blockIdx.y * kDecodeSplit;
  const int len = max(0, min(cache_lens[bi], max_blocks << bs_log2));
  if (c0 >= len) return;
  const int n = min(kDecodeSplit, len - c0);
  const int e0 = c0 >> bs_log2;
  const int entries = ((c0 + n - 1) >> bs_log2) - e0 + 1;
  const int* tbl = tables + static_cast<int64_t>(bi) * max_blocks + e0;
  for (int t = threadIdx.x; t < entries; t += kDecodeThreads)
    blk[t] = min(max(tbl[t], 0), num_blocks - 1);
  __syncthreads();
  const PagedAddr<T> addr{k + hi * st.k_h,
                          v + hi * st.v_h,
                          blk,
                          c0 - (e0 << bs_log2),
                          bs_log2,
                          (1 << bs_log2) - 1,
                          st.k_blk,
                          st.k_s,
                          st.v_blk,
                          st.v_s};
  decode_chunk<T, D>(q + bi * st.q_b + hi * st.q_h, work.acc_at(bh, blockIdx.y),
                     work.ml_at(bh, blockIdx.y), n, addr, scale);
}

// grid batch * heads, D threads: the chunk partials merged in chunk order
template <typename T, int D>
__global__ void __launch_bounds__(D)
flash_decode_paged_combine_kernel(T* __restrict__ o, const int* __restrict__ cache_lens,
                                  int heads, int max_seq, int64_t o_b, int64_t o_h,
                                  DecodeWork work) {
  const int bh = blockIdx.x;
  const int bi = bh / heads;
  const int hi = bh % heads;
  const int len = max(0, min(cache_lens[bi], max_seq));
  decode_combine<T, D>(work.acc_at(bh, 0), work.ml_at(bh, 0), o + bi * o_b + hi * o_h,
                       decode_splits(len), threadIdx.x);
}

template <typename T, int D>
static void launch_paged(const void* q, const void* k, const void* v, void* o, const void* tables,
                         const void* lens, int batch, int heads, int num_blocks, int bs_log2,
                         int max_blocks, const PagedStrides& st, const DecodeWork& work,
                         float scale, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(batch * heads), static_cast<unsigned>(work.n_split));
  flash_decode_paged_split_kernel<T, D><<<grid, kDecodeThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(tables), static_cast<const int*>(lens), heads, num_blocks, bs_log2,
      max_blocks, st, work, scale);
  flash_decode_paged_combine_kernel<T, D><<<static_cast<unsigned>(batch * heads), D, 0, stream>>>(
      static_cast<T*>(o), static_cast<const int*>(lens), heads, max_blocks << bs_log2, st.o_b,
      st.o_h, work);
}

template <typename T>
static int dispatch_paged(int head_dim, const void* q, const void* k, const void* v, void* o,
                          const void* tables, const void* lens, int batch, int heads,
                          int num_blocks, int bs_log2, int max_blocks, const PagedStrides& st,
                          const DecodeWork& work, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      launch_paged<T, 16>(q, k, v, o, tables, lens, batch, heads, num_blocks, bs_log2,
                          max_blocks, st, work, scale, stream);
      return 0;
    case 32:
      launch_paged<T, 32>(q, k, v, o, tables, lens, batch, heads, num_blocks, bs_log2,
                          max_blocks, st, work, scale, stream);
      return 0;
    case 64:
      launch_paged<T, 64>(q, k, v, o, tables, lens, batch, heads, num_blocks, bs_log2,
                          max_blocks, st, work, scale, stream);
      return 0;
    case 128:
      launch_paged<T, 128>(q, k, v, o, tables, lens, batch, heads, num_blocks, bs_log2,
                           max_blocks, st, work, scale, stream);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// q, o: (b, h, d); k/v: pool views (num_blocks, bs, h, d) with the given
// strides (in elements) and a contiguous last dim; q, k, v 16-byte
// aligned, their strides multiples of 16 bytes; bs a power of two;
// tables: (b, max_blocks) int32 contiguous; cache_lens: (b,) int32;
// workspace: f32, batch * heads * n_split * (head_dim + 2), n_split =
// decode_splits(max_blocks * bs).  Two launches: the split pass, then the
// combine.
extern "C" int apex_flash_decode_paged(const void* q, const void* k, const void* v, void* o,
                                       const void* tables, const void* cache_lens,
                                       void* workspace, int batch, int heads, int head_dim,
                                       int num_blocks, int block_size, int max_blocks,
                                       int n_split, int64_t q_b, int64_t q_h, int64_t k_blk,
                                       int64_t k_s, int64_t k_h, int64_t v_blk, int64_t v_s,
                                       int64_t v_h, int64_t o_b, int64_t o_h, float scale,
                                       int dtype, void* stream) {
  if (batch <= 0 || heads <= 0) return 0;
  if (num_blocks <= 0 || block_size <= 0 || max_blocks <= 0 ||
      (block_size & (block_size - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int bs_log2 = 0;
  while ((1 << bs_log2) < block_size) ++bs_log2;
  if (static_cast<int64_t>(max_blocks) << bs_log2 > INT32_MAX ||
      n_split != decode_splits(max_blocks << bs_log2))
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedStrides st{q_b, q_h, k_blk, k_s, k_h, v_blk, v_s, v_h, o_b, o_h};
  const DecodeWork work = decode_work(workspace, batch, heads, n_split, head_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case kF32:
      rc = dispatch_paged<float>(head_dim, q, k, v, o, tables, cache_lens, batch, heads,
                                 num_blocks, bs_log2, max_blocks, st, work, scale, s);
      break;
    case kBF16:
      rc = dispatch_paged<__nv_bfloat16>(head_dim, q, k, v, o, tables, cache_lens, batch, heads,
                                         num_blocks, bs_log2, max_blocks, st, work, scale, s);
      break;
    case kF16:
      rc = dispatch_paged<__half>(head_dim, q, k, v, o, tables, cache_lens, batch, heads,
                                  num_blocks, bs_log2, max_blocks, st, work, scale, s);
      break;
    default:
      rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
