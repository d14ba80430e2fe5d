// Single-query decode attention over a (batch, max_seq, heads, head_dim)
// KV cache for Hopper.
//
// Replaces apex_tpu/ops/flash_attention.py `_decode_kernel` (launched by
// `flash_attention_decode`).  Bound by bytes (each valid key and value read
// once).  The body is decode.cuh's split-K pass, shared with the paged
// kernel: a grid of (slot, head) x kDecodeSplit-key chunks, 16-byte loads,
// f32 chunk partials, then a combine launch that merges them in chunk
// order.  Here row r of a chunk is a stride step along the slot's row.
// The cache is read through its strides: the caller passes the strided
// view `cache[:, layer, 0]` (slot stride layers*2*max_seq*h*d) and nothing
// is copied.

#include "decode.cuh"

namespace apex_tpu_torch {

struct DecodeStrides {
  int64_t q_b, q_h;
  int64_t k_b, k_s, k_h;
  int64_t v_b, v_s, v_h;
  int64_t o_b, o_h;
};

// row r of one (slot, head)'s chunk of the ring
template <typename T>
struct RingAddr {
  const T* k;  // at the chunk's first position
  const T* v;
  int64_t k_s, v_s;
  __device__ __forceinline__ const T* key(int r) const { return k + r * k_s; }
  __device__ __forceinline__ const T* value(int r) const { return v + r * v_s; }
};

// grid (batch * heads, chunks): one chunk of one (slot, head)
template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ cache_lens,
                          int heads, int max_seq, DecodeStrides st, DecodeWork work,
                          float scale) {
  const int bh = blockIdx.x;
  const int bi = bh / heads;
  const int hi = bh % heads;
  const int c0 = blockIdx.y * kDecodeSplit;
  const int len = max(0, min(cache_lens[bi], max_seq));
  if (c0 >= len) return;
  const RingAddr<T> addr{k + bi * st.k_b + hi * st.k_h + c0 * st.k_s,
                         v + bi * st.v_b + hi * st.v_h + c0 * st.v_s, st.k_s, st.v_s};
  decode_chunk<T, D>(q + bi * st.q_b + hi * st.q_h, work.acc_at(bh, blockIdx.y),
                     work.ml_at(bh, blockIdx.y), min(kDecodeSplit, len - c0), addr, scale);
}

// grid batch * heads, D threads: the chunk partials merged in chunk order
template <typename T, int D>
__global__ void __launch_bounds__(D)
flash_decode_combine_kernel(T* __restrict__ o, const int* __restrict__ cache_lens, int heads,
                            int max_seq, int64_t o_b, int64_t o_h, DecodeWork work) {
  const int bh = blockIdx.x;
  const int bi = bh / heads;
  const int hi = bh % heads;
  const int len = max(0, min(cache_lens[bi], max_seq));
  decode_combine<T, D>(work.acc_at(bh, 0), work.ml_at(bh, 0), o + bi * o_b + hi * o_h,
                       decode_splits(len), threadIdx.x);
}

template <typename T, int D>
static void launch_flash_decode(const void* q, const void* k, const void* v, void* o,
                                const void* lens, int batch, int heads, int max_seq,
                                const DecodeStrides& st, const DecodeWork& work, float scale,
                                cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(batch * heads), static_cast<unsigned>(work.n_split));
  flash_decode_split_kernel<T, D><<<grid, kDecodeThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lens), heads, max_seq, st, work, scale);
  flash_decode_combine_kernel<T, D><<<static_cast<unsigned>(batch * heads), D, 0, stream>>>(
      static_cast<T*>(o), static_cast<const int*>(lens), heads, max_seq, st.o_b, st.o_h, work);
}

template <typename T>
static int dispatch_flash_decode(int head_dim, const void* q, const void* k, const void* v,
                                 void* o, const void* lens, int batch, int heads, int max_seq,
                                 const DecodeStrides& st, const DecodeWork& work, float scale,
                                 cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      launch_flash_decode<T, 16>(q, k, v, o, lens, batch, heads, max_seq, st, work, scale,
                                 stream);
      return 0;
    case 32:
      launch_flash_decode<T, 32>(q, k, v, o, lens, batch, heads, max_seq, st, work, scale,
                                 stream);
      return 0;
    case 64:
      launch_flash_decode<T, 64>(q, k, v, o, lens, batch, heads, max_seq, st, work, scale,
                                 stream);
      return 0;
    case 128:
      launch_flash_decode<T, 128>(q, k, v, o, lens, batch, heads, max_seq, st, work, scale,
                                  stream);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// q, o: (b, h, d); k/v: (b, max_seq, h, d) with the given strides (in
// elements) and a contiguous last dim; q, k, v 16-byte aligned, their
// strides multiples of 16 bytes; cache_lens: (b,) int32; workspace: f32,
// batch * heads * n_split * (head_dim + 2), n_split = decode_splits(max_seq).
// Two launches: the split pass, then the combine.
extern "C" int apex_flash_decode(const void* q, const void* k, const void* v, void* o,
                                 const void* cache_lens, void* workspace, int batch, int heads,
                                 int max_seq, int head_dim, int n_split, int64_t q_b,
                                 int64_t q_h, int64_t k_b, int64_t k_s, int64_t k_h,
                                 int64_t v_b, int64_t v_s, int64_t v_h, int64_t o_b,
                                 int64_t o_h, float scale, int dtype, void* stream) {
  if (batch <= 0 || heads <= 0) return 0;
  if (max_seq <= 0 || n_split != decode_splits(max_seq))
    return static_cast<int>(cudaErrorInvalidValue);
  const DecodeStrides st{q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_h};
  const DecodeWork work = decode_work(workspace, batch, heads, n_split, head_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case kF32:
      rc = dispatch_flash_decode<float>(head_dim, q, k, v, o, cache_lens, batch, heads, max_seq,
                                        st, work, scale, s);
      break;
    case kBF16:
      rc = dispatch_flash_decode<__nv_bfloat16>(head_dim, q, k, v, o, cache_lens, batch, heads,
                                                max_seq, st, work, scale, s);
      break;
    case kF16:
      rc = dispatch_flash_decode<__half>(head_dim, q, k, v, o, cache_lens, batch, heads,
                                         max_seq, st, work, scale, s);
      break;
    default:
      rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
