// The single-query decode attention body shared by flash_decode.cu (#6,
// over a contiguous slot ring) and flash_decode_paged.cu (#7, over a block
// table).  The two differ only in where key and value `pos` of the block's
// (slot, head) live, which an address functor answers; the arithmetic is
// one template, so #7 on a pool gives bit for bit what #6 gives on the
// gathered contiguous cache.
//
// What bounds it on the H100: bytes.  Each (slot, head) reads len keys and
// values once (head_dim elements each) and does two multiply-adds per
// element read, about one operation per byte.  Design: one block of 4 warps
// per (slot, head); the warps stride over the cache in 32-key chunks up to
// len only (the counterpart of the JAX kernels' `ki * block_k < len` block
// skip), so a short row reads only its own keys.  Lane j scores key j in
// f32 against the query held in shared memory, its address computed per
// lane (a 32-key chunk spans several blocks of a paged pool); each warp
// keeps its own online-softmax state and f32 accumulator, and the four
// partial results are merged in shared memory at the end.  Split-K across
// blocks (flash-decoding) and 16-byte vector loads are later work.
#pragma once

#include "common.cuh"

namespace apex_tpu_torch {

constexpr int kDecodeThreads = 128;  // 4 warps
constexpr int kDecodeWarps = kDecodeThreads / 32;

// q row -> o row for one (slot, head) over `len` cached positions;
// `addr.key(pos)` / `addr.value(pos)` give the head_dim elements of
// position pos
template <typename T, int D, typename Addr>
__device__ __forceinline__ void decode_attend(const T* __restrict__ q, T* __restrict__ o,
                                              int len, const Addr& addr, float scale) {
  constexpr int NC = (D + 31) / 32;
  __shared__ float qs[D];
  __shared__ float w_m[kDecodeWarps];
  __shared__ float w_l[kDecodeWarps];
  __shared__ float w_acc[kDecodeWarps][D];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int d = threadIdx.x; d < D; d += kDecodeThreads) qs[d] = to_f32(q[d]);
  __syncthreads();

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
      const T* kr = addr.key(pos);
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
      const T* vr = addr.value(c0 + j);
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
    o[d] = from_f32<T>(od / l_safe);
  }
}

}  // namespace apex_tpu_torch
