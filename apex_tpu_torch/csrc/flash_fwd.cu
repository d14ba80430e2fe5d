// Flash-attention forward (causal, kv_seqlens, probability dropout) for
// Hopper.
//
// Replaces apex_tpu/ops/flash_attention.py `_fwd_kernel` (launched by
// `_flash_fwd_impl`).  What bounds it on
// the H100: operations.  At a 512-token prompt every (batch, head) does
// 2 * 512 * 512 * 64 multiply-adds for QK^T and PV (half of them under the
// causal mask) against 3 * 512 * 64 inputs, hundreds of operations per byte.
// This first version runs them on the FMA units in f32, not on the tensor
// cores, so it sits far below the bf16 tensor-core peak; wgmma/TMA tiling is
// later work.  Design: one block per (batch*head, 64-query tile); the TPU's
// sequential k-block grid axis becomes a loop inside the block over 32-key
// tiles staged in shared memory (f32, K padded by one column so that lane j
// reading key j is conflict-free).  Each warp owns 8 query rows with their
// online-softmax state (m, l) and f32 accumulator in registers; lane j scores
// key j, and P.V broadcasts p_j with a shuffle.  Tiles strictly above the
// causal diagonal and past kv_seqlens are never loaded.  head_dim is taken
// as it is (16, 32 or 64), not padded to 128, and the ragged query/key edge
// of any prompt bucket is masked.  The finite mask value and the l == 0
// guard make a fully masked row come out as 0, as in the JAX kernel.
// Dropout regenerates the JAX counter-hash keep factor per (row, key) from
// absolute positions (common.cuh): l sums the undropped p, so the saved
// lse is dropout-free, and the factor scales p only in the PV product.

#include "common.cuh"

namespace apex_tpu_torch {

constexpr int kFlashBQ = 64;       // query rows per block
constexpr int kFlashBK = 32;       // keys per tile (one per lane)
constexpr int kFlashThreads = 256; // 8 warps
constexpr int kFlashRowsPerWarp = kFlashBQ / (kFlashThreads / 32);

struct FlashStrides {
  int64_t q_b, q_h, q_s;
  int64_t k_b, k_h, k_s;
  int64_t v_b, v_h, v_s;
  int64_t o_b, o_h, o_s;
};

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse,
                 const int* __restrict__ kv_lens, int heads, int sq, int sk,
                 FlashStrides st, float scale, int causal, Dropout dr) {
  constexpr int NC = (D + 31) / 32;  // output columns per lane
  __shared__ float qs[kFlashBQ][D];
  __shared__ float ks[kFlashBK][D + 1];
  __shared__ float vs[kFlashBK][D];

  const int bh = blockIdx.x;
  const int bi = bh / heads;
  const int hi = bh % heads;
  const int q0 = blockIdx.y * kFlashBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const T* qb = q + bi * st.q_b + hi * st.q_h;
  const T* kb = k + bi * st.k_b + hi * st.k_h;
  const T* vb = v + bi * st.v_b + hi * st.v_h;
  T* ob = o + bi * st.o_b + hi * st.o_h;

  int kv_len = sk;
  if (kv_lens != nullptr) kv_len = max(0, min(kv_lens[bi], sk));

  for (int idx = threadIdx.x; idx < kFlashBQ * D; idx += kFlashThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int qr = q0 + r;
    qs[r][d] = qr < sq ? to_f32(qb[qr * st.q_s + d]) : 0.f;
  }

  float m[kFlashRowsPerWarp];
  float l[kFlashRowsPerWarp];
  float acc[kFlashRowsPerWarp][NC];
#pragma unroll
  for (int r = 0; r < kFlashRowsPerWarp; ++r) {
    m[r] = kMask;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  // keys past kv_len, and (causal) past this tile's last query, are masked
  // for every row of the block: their tiles are skipped
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q0 + kFlashBQ);
  const int n_tiles = (k_end + kFlashBK - 1) / kFlashBK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kFlashBK;
    __syncthreads();  // the previous tile is consumed (and, at t == 0, qs is written)
    for (int idx = threadIdx.x; idx < kFlashBK * D; idx += kFlashThreads) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int kr = k0 + j;
      const bool in = kr < sk;
      ks[j][d] = in ? to_f32(kb[kr * st.k_s + d]) : 0.f;
      vs[j][d] = in ? to_f32(vb[kr * st.v_s + d]) : 0.f;
    }
    __syncthreads();

    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kFlashRowsPerWarp; ++r) {
      const int row = warp * kFlashRowsPerWarp + r;
      const int qpos = q0 + row;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += qs[row][d] * ks[lane][d];
      const bool valid = kpos < kv_len && (!causal || kpos <= qpos);
      const float s = valid ? dot * scale : kMask;
      const float m_new = fmaxf(warp_max(s), m[r]);
      const float alpha = expf(m[r] - m_new);
      float p = valid ? expf(s - m_new) : 0.f;
      l[r] = alpha * l[r] + warp_sum(p);
      if (kDropout) p *= dropout_factor(dr, dropout_row_hash(dr, bh, qpos), kpos);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
#pragma unroll
      for (int j = 0; j < kFlashBK; ++j) {
        const float pj = __shfl_sync(kFullMask, p, j);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = lane + 32 * c;
          if (col < D) acc[r][c] += pj * vs[j][col];
        }
      }
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < kFlashRowsPerWarp; ++r) {
    const int qpos = q0 + warp * kFlashRowsPerWarp + r;
    if (qpos >= sq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    T* orow = ob + qpos * st.o_s;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < D) orow[col] = from_f32<T>(acc[r][c] / l_safe);
    }
    if (lane == 0 && lse != nullptr) lse[static_cast<int64_t>(bh) * sq + qpos] = m[r] + logf(l_safe);
  }
}

template <typename T, int D>
static void launch_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             const void* kv_lens, int batch, int heads, int sq, int sk,
                             const FlashStrides& st, float scale, int causal,
                             const Dropout& dr, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(batch * heads),
                  static_cast<unsigned>((sq + kFlashBQ - 1) / kFlashBQ));
  // dropout is a template flag: the plain path keeps its registers
  auto kernel = dr.on ? flash_fwd_kernel<T, D, true> : flash_fwd_kernel<T, D, false>;
  kernel<<<grid, kFlashThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), static_cast<const int*>(kv_lens),
      heads, sq, sk, st, scale, causal, dr);
}

template <typename T>
static int dispatch_flash_fwd(int head_dim, const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* kv_lens, int batch, int heads,
                              int sq, int sk, const FlashStrides& st, float scale, int causal,
                              const Dropout& dr, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      launch_flash_fwd<T, 16>(q, k, v, o, lse, kv_lens, batch, heads, sq, sk, st, scale, causal,
                                 dr, stream);
      return 0;
    case 32:
      launch_flash_fwd<T, 32>(q, k, v, o, lse, kv_lens, batch, heads, sq, sk, st, scale, causal,
                                 dr, stream);
      return 0;
    case 64:
      launch_flash_fwd<T, 64>(q, k, v, o, lse, kv_lens, batch, heads, sq, sk, st, scale, causal,
                                 dr, stream);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// q: (b, h, sq, d), k/v: (b, h, sk, d), o: (b, h, sq, d), each with the
// given batch/head/seq strides (in elements) and a contiguous last dim;
// lse: (b*h, sq) f32 or null; kv_lens: (b,) int32 or null; dropout: 0 or 1,
// with the keep threshold, keep scale and seed of common.cuh `Dropout`.
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              const void* kv_lens, int batch, int heads, int sq, int sk,
                              int head_dim, int64_t q_b, int64_t q_h, int64_t q_s,
                              int64_t k_b, int64_t k_h, int64_t k_s, int64_t v_b, int64_t v_h,
                              int64_t v_s, int64_t o_b, int64_t o_h, int64_t o_s, float scale,
                              int causal, int dropout, uint32_t threshold, float keep_scale,
                              uint32_t seed, int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0) return 0;
  const FlashStrides st{q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s};
  const Dropout dr{dropout, threshold, keep_scale, seed};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case kF32:
      rc = dispatch_flash_fwd<float>(head_dim, q, k, v, o, lse, kv_lens, batch, heads, sq, sk, st,
                                             scale, causal, dr, s);
      break;
    case kBF16:
      rc = dispatch_flash_fwd<__nv_bfloat16>(head_dim, q, k, v, o, lse, kv_lens, batch, heads, sq, sk, st,
                                             scale, causal, dr, s);
      break;
    case kF16:
      rc = dispatch_flash_fwd<__half>(head_dim, q, k, v, o, lse, kv_lens, batch, heads, sq, sk, st,
                                             scale, causal, dr, s);
      break;
    default:
      rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
