// Single-query decode attention over a (batch, max_seq, heads, head_dim)
// KV cache for Hopper.
//
// Replaces apex_tpu/ops/flash_attention.py `_decode_kernel` (launched by
// `flash_attention_decode`).  What bounds it on the H100: bytes.  Each
// (slot, head) reads cache_lens[b] keys and values once (64 bf16 each) and
// does two multiply-adds per element read, about one operation per byte.
// Design: one block of 4 warps per (slot, head); the warps stride over the
// cache in 32-key chunks up to cache_lens[b] only (the counterpart of the
// JAX kernel's `ki * block_k < len` block skip), so a short row reads only
// its own keys.  Lane j scores key j in f32 against the query held in
// shared memory; each warp keeps its own online-softmax state and f32
// accumulator, and the four partial results are merged in shared memory at
// the end.  The cache is read through its strides: the caller passes the
// strided view `cache[:, layer, 0]` (slot stride layers*2*max_seq*h*d) and
// nothing is copied.  Split-K across blocks (flash-decoding) and 16-byte
// vector loads are later work.

#include "common.cuh"

namespace apex_tpu_torch {

constexpr int kDecodeThreads = 128;  // 4 warps
constexpr int kDecodeWarps = kDecodeThreads / 32;

struct DecodeStrides {
  int64_t q_b, q_h;
  int64_t k_b, k_s, k_h;
  int64_t v_b, v_s, v_h;
  int64_t o_b, o_h;
};

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, const int* __restrict__ cache_lens, int heads,
                    int max_seq, DecodeStrides st, float scale) {
  constexpr int NC = (D + 31) / 32;
  __shared__ float qs[D];
  __shared__ float w_m[kDecodeWarps];
  __shared__ float w_l[kDecodeWarps];
  __shared__ float w_acc[kDecodeWarps][D];

  const int bi = blockIdx.x / heads;
  const int hi = blockIdx.x % heads;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = max(0, min(cache_lens[bi], max_seq));

  for (int d = threadIdx.x; d < D; d += kDecodeThreads)
    qs[d] = to_f32(q[bi * st.q_b + hi * st.q_h + d]);
  __syncthreads();

  const T* kb = k + bi * st.k_b + hi * st.k_h;
  const T* vb = v + bi * st.v_b + hi * st.v_h;
  float m = kMask;
  float l = 0.f;
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;

  for (int c0 = warp * 32; c0 < len; c0 += kDecodeWarps * 32) {
    const int pos = c0 + lane;
    const bool valid = pos < len;
    float s = kMask;
    if (valid) {
      const T* kr = kb + pos * st.k_s;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += qs[d] * to_f32(kr[d]);
      s = dot * scale;
    }
    const float m_new = fmaxf(warp_max(s), m);
    const float alpha = expf(m - m_new);
    const float p = valid ? expf(s - m_new) : 0.f;
    l = alpha * l + warp_sum(p);
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] *= alpha;
    const int n = min(32, len - c0);  // warp-uniform
    for (int j = 0; j < n; ++j) {
      const float pj = __shfl_sync(kFullMask, p, j);
      const T* vr = vb + (c0 + j) * st.v_s;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        if (col < D) acc[c] += pj * to_f32(vr[col]);
      }
    }
    m = m_new;
  }

  if (lane == 0) {
    w_m[warp] = m;
    w_l[warp] = l;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = lane + 32 * c;
    if (col < D) w_acc[warp][col] = acc[c];
  }
  __syncthreads();

  float m_all = kMask;
#pragma unroll
  for (int w = 0; w < kDecodeWarps; ++w) m_all = fmaxf(m_all, w_m[w]);
  float l_all = 0.f;
#pragma unroll
  for (int w = 0; w < kDecodeWarps; ++w) l_all += w_l[w] * expf(w_m[w] - m_all);
  const float l_safe = l_all == 0.f ? 1.f : l_all;
  for (int d = threadIdx.x; d < D; d += kDecodeThreads) {
    float od = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) od += w_acc[w][d] * expf(w_m[w] - m_all);
    o[bi * st.o_b + hi * st.o_h + d] = from_f32<T>(od / l_safe);
  }
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
