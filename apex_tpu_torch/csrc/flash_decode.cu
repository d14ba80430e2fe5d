// Single-query decode attention over a (batch, max_seq, heads, head_dim)
// KV cache for Hopper.
//
// Replaces apex_tpu/ops/flash_attention.py `_decode_kernel` (launched by
// `flash_attention_decode`).  The body (bound, design) is decode.cuh's,
// shared with the paged kernel; here a position's address is a stride
// step along the slot's row.  The cache is read through its strides: the
// caller passes the strided view `cache[:, layer, 0]` (slot stride
// layers*2*max_seq*h*d) and nothing is copied.

#include "decode.cuh"

namespace apex_tpu_torch {

struct DecodeStrides {
  int64_t q_b, q_h;
  int64_t k_b, k_s, k_h;
  int64_t v_b, v_s, v_h;
  int64_t o_b, o_h;
};

// position pos of one (slot, head) row of the ring
template <typename T>
struct RingAddr {
  const T* k;
  const T* v;
  int64_t k_s, v_s;
  __device__ __forceinline__ const T* key(int pos) const { return k + pos * k_s; }
  __device__ __forceinline__ const T* value(int pos) const { return v + pos * v_s; }
};

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, const int* __restrict__ cache_lens, int heads,
                    int max_seq, DecodeStrides st, float scale) {
  const int bi = blockIdx.x / heads;
  const int hi = blockIdx.x % heads;
  const int len = max(0, min(cache_lens[bi], max_seq));
  const RingAddr<T> addr{k + bi * st.k_b + hi * st.k_h, v + bi * st.v_b + hi * st.v_h, st.k_s,
                         st.v_s};
  decode_attend<T, D>(q + bi * st.q_b + hi * st.q_h, o + bi * st.o_b + hi * st.o_h, len, addr,
                      scale);
}

template <typename T, int D>
static void launch_flash_decode(const void* q, const void* k, const void* v, void* o,
                                const void* lens, int batch, int heads, int max_seq,
                                const DecodeStrides& st, float scale, cudaStream_t stream) {
  flash_decode_kernel<T, D><<<static_cast<unsigned>(batch * heads), kDecodeThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<const int*>(lens), heads, max_seq, st, scale);
}

template <typename T>
static int dispatch_flash_decode(int head_dim, const void* q, const void* k, const void* v,
                                 void* o, const void* lens, int batch, int heads, int max_seq,
                                 const DecodeStrides& st, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      launch_flash_decode<T, 16>(q, k, v, o, lens, batch, heads, max_seq, st, scale, stream);
      return 0;
    case 32:
      launch_flash_decode<T, 32>(q, k, v, o, lens, batch, heads, max_seq, st, scale, stream);
      return 0;
    case 64:
      launch_flash_decode<T, 64>(q, k, v, o, lens, batch, heads, max_seq, st, scale, stream);
      return 0;
    case 128:
      launch_flash_decode<T, 128>(q, k, v, o, lens, batch, heads, max_seq, st, scale, stream);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// q, o: (b, h, d); k/v: (b, max_seq, h, d) with the given strides (in
// elements) and a contiguous last dim; cache_lens: (b,) int32.
extern "C" int apex_flash_decode(const void* q, const void* k, const void* v, void* o,
                                 const void* cache_lens, int batch, int heads, int max_seq,
                                 int head_dim, int64_t q_b, int64_t q_h, int64_t k_b,
                                 int64_t k_s, int64_t k_h, int64_t v_b, int64_t v_s,
                                 int64_t v_h, int64_t o_b, int64_t o_h, float scale, int dtype,
                                 void* stream) {
  if (batch <= 0 || heads <= 0) return 0;
  const DecodeStrides st{q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case kF32:
      rc = dispatch_flash_decode<float>(head_dim, q, k, v, o, cache_lens, batch, heads, max_seq, st, scale, s);
      break;
    case kBF16:
      rc = dispatch_flash_decode<__nv_bfloat16>(head_dim, q, k, v, o, cache_lens, batch, heads, max_seq, st, scale, s);
      break;
    case kF16:
      rc = dispatch_flash_decode<__half>(head_dim, q, k, v, o, cache_lens, batch, heads, max_seq, st, scale, s);
      break;
    default:
      rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
