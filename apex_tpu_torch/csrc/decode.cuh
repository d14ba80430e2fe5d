// The single-query decode attention body shared by flash_decode.cu (#6,
// over a contiguous slot ring) and flash_decode_paged.cu (#7, over a block
// table): a split-K (flash-decoding) pass and its fixed-order combine.  The
// two kernels differ only in where row r of a chunk lives, which an
// address functor answers; the arithmetic is one template, so #7 on a pool
// gives bit for bit what #6 gives on the gathered contiguous cache.
//
// What bounds it on the H100: bytes.  Each (slot, head) reads len keys and
// values once (head_dim elements each) and does two multiply-adds per
// element read, about one operation per byte.  Design:
// - The cache is cut into chunks of kDecodeSplit keys at fixed positions
//   (0, kDecodeSplit, ...), whatever max_seq, the pool, batch or heads, so
//   #6 and #7 split a row alike.  One block of 4 warps per (slot, head,
//   chunk); a block whose chunk starts at or past the row's length exits
//   at once, so a short row reads only its own keys and a long one is
//   spread over as many blocks as it has chunks.
// - Keys and values are read 16 bytes a lane: D * sizeof(T) / 16 lanes
//   share one row (8 at D = 64 bf16, so one warp load covers 4 rows of 128
//   bytes).  Each lane keeps its 16-byte slice of q in registers in f32;
//   a row's dot product is summed over its lanes with __shfl_xor_sync.
//   The first batch of V rows is loaded together with the keys, so both
//   are in flight at once.
// - Inside a chunk the softmax is exact (one score per thread: max, p, l),
//   then each lane accumulates p * V over its group's rows in f32, and the
//   row groups are merged by shuffles and then across the 4 warps in
//   shared memory, in a fixed order.
// - Each live chunk writes an f32 partial (m, l, acc[D]) to a workspace the
//   wrapper allocates; the combine kernel merges the live chunks of each
//   (slot, head) in chunk order, applies the l == 0 guard and casts to T.
//   Nothing depends on the order in which blocks ran: a repeat is bitwise.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace apex_tpu_torch {

constexpr int kDecodeThreads = 128;  // 4 warps
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kDecodeSplit = 128;  // keys per chunk: a multiple of the pool's block sizes 8, 16
static_assert(kDecodeSplit == kDecodeThreads, "the chunk softmax holds one score per thread");

// chunks of a row of s positions (the grid's y extent, the workspace's)
__host__ __device__ constexpr int decode_splits(int s) {
  return (s + kDecodeSplit - 1) / kDecodeSplit;
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// 16 bytes of T as f32 (bf16 is the top half of an f32)
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[16 / sizeof(T)]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same_v<T, float>) {
      f[i] = __uint_as_float(w[i]);
    } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      f[2 * i] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[i] & 0xffffu)));
      f[2 * i + 1] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[i] >> 16)));
    }
  }
}

// One chunk of one (slot, head): rows 0..n-1 (n >= 1) of the chunk, at
// `addr.key(r)` / `addr.value(r)`; writes acc[D] (sum of p * v, p relative
// to the chunk's max m) to acc_out and (m, l) to ml_out.
template <typename T, int D, typename Addr>
__device__ __forceinline__ void decode_chunk(const T* __restrict__ q, float* __restrict__ acc_out,
                                             float* __restrict__ ml_out, int n, const Addr& addr,
                                             float scale) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // elements a lane reads
  constexpr int LPR = D / VEC;                           // lanes reading one row
  constexpr int G = kDecodeThreads / LPR;                // row groups in the block
  constexpr int NR = kDecodeSplit / G;                   // rows of a group in a chunk
  constexpr int RB = NR < 8 ? NR : 8;                    // rows a lane has in flight
  static_assert(D % VEC == 0 && LPR >= 1 && LPR <= 32 && NR % RB == 0, "decode tiling");
  __shared__ float s[kDecodeSplit];
  __shared__ float w_max[kDecodeWarps];
  __shared__ float w_sum[kDecodeWarps];
  __shared__ float w_acc[kDecodeWarps][D];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = tid / LPR;
  const int col = (tid % LPR) * VEC;

  float qf[VEC];
  unpack16<T>(ldg16(q + col), qf);

  uint4 kb[RB], vb[RB];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int b = 0; b < NR / RB; ++b) {
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int r = g + (b * RB + i) * G;
      kb[i] = r < n ? ldg16(addr.key(r) + col) : zero;
      if (b == 0) vb[i] = r < n ? ldg16(addr.value(r) + col) : zero;
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      float kf[VEC];
      unpack16<T>(kb[i], kf);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) dot = fmaf(qf[e], kf[e], dot);
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(kFullMask, dot, off);
      const int r = g + (b * RB + i) * G;
      if (col == 0 && r < n) s[r] = dot * scale;
    }
  }
  __syncthreads();

  // the chunk's softmax: one key per thread, warp then block reductions in
  // a fixed order
  const float sv = tid < n ? s[tid] : kMask;
  float m = warp_max(sv);
  if (lane == 0) w_max[warp] = m;
  __syncthreads();
  m = w_max[0];
#pragma unroll
  for (int w = 1; w < kDecodeWarps; ++w) m = fmaxf(m, w_max[w]);
  const float p = tid < n ? expf(sv - m) : 0.f;
  s[tid] = p;
  const float lw = warp_sum(p);
  if (lane == 0) w_sum[warp] = lw;
  __syncthreads();

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
  for (int b = 0; b < NR / RB; ++b) {
    if (b > 0) {
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int r = g + (b * RB + i) * G;
        vb[i] = r < n ? ldg16(addr.value(r) + col) : zero;
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const float pr = s[g + (b * RB + i) * G];  // 0 past n, where vb is 0
      float vf[VEC];
      unpack16<T>(vb[i], vf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(pr, vf[e], acc[e]);
    }
  }
  // merge the row groups: inside the warp by shuffles, then across warps
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] += __shfl_xor_sync(kFullMask, acc[e], off);
  }
  if (lane < LPR) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) w_acc[warp][col + e] = acc[e];
  }
  __syncthreads();
  for (int d = tid; d < D; d += kDecodeThreads) {
    float a = w_acc[0][d];
#pragma unroll
    for (int w = 1; w < kDecodeWarps; ++w) a += w_acc[w][d];
    acc_out[d] = a;
  }
  if (tid == 0) {
    float l = w_sum[0];
#pragma unroll
    for (int w = 1; w < kDecodeWarps; ++w) l += w_sum[w];
    ml_out[0] = m;
    ml_out[1] = l;
  }
}

// Output element d of one (slot, head) from its n_live chunk partials, in
// chunk order; a row with no live chunk (len 0) gives 0.
template <typename T, int D>
__device__ __forceinline__ void decode_combine(const float* __restrict__ acc,
                                               const float* __restrict__ ml, T* __restrict__ o,
                                               int n_live, int d) {
  float m_all = kMask;
  for (int c = 0; c < n_live; ++c) m_all = fmaxf(m_all, ml[2 * c]);
  float l_all = 0.f;
  float od = 0.f;
  for (int c = 0; c < n_live; ++c) {
    const float w = expf(ml[2 * c] - m_all);
    l_all += ml[2 * c + 1] * w;
    od += acc[c * D + d] * w;
  }
  const float l_safe = l_all == 0.f ? 1.f : l_all;
  o[d] = from_f32<T>(od / l_safe);
}

// Workspace layout (f32): acc[bh][n_split][dim], then ml[bh][n_split][2].
struct DecodeWork {
  float* acc;
  float* ml;
  int n_split, dim;
  __device__ __forceinline__ float* acc_at(int bh, int c) const {
    return acc + (static_cast<int64_t>(bh) * n_split + c) * dim;
  }
  __device__ __forceinline__ float* ml_at(int bh, int c) const {
    return ml + (static_cast<int64_t>(bh) * n_split + c) * 2;
  }
};

inline DecodeWork decode_work(void* workspace, int batch, int heads, int n_split, int dim) {
  float* acc = static_cast<float*>(workspace);
  return DecodeWork{acc, acc + static_cast<int64_t>(batch) * heads * n_split * dim, n_split, dim};
}

}  // namespace apex_tpu_torch
