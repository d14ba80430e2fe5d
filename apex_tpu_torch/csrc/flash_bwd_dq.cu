// Flash-attention backward, dq pass, for Hopper.
//
// Replaces apex_tpu/ops/flash_attention.py `_dq_kernel` (launched by
// `_flash_bwd_impl`).  What bounds it on the H100: operations.  Each
// (batch*head, query) row does three products of head_dim against every
// unmasked key (q.k to recompute p, dO.v for dP, dS.k for dq): at 1024
// tokens that is hundreds of operations per byte of q, k, v and dO.  This
// first version runs them on the FMA units in f32, not on the tensor cores,
// so it sits far below the bf16 tensor-core peak; mma/wgmma tiling is later
// work.  Design: the TPU's sequential k-block grid axis becomes a loop
// inside one block per (batch*head, 32-query tile), so dq is summed in
// registers in a fixed order (no atomics, runs repeat bit for bit).  Each
// warp owns 4 query rows; lane j takes key j of a 32-key tile staged in
// shared memory as f32 (K and V padded by one column, so lane j reading key
// j is conflict-free).  p = exp(s*scale - lse) is recomputed from the
// forward's logsumexp with its masks (causal, kv_seqlens); tiles above the
// causal diagonal and past kv_seqlens are never loaded.  Dropout regenerates
// the forward's keep factor from absolute positions and scales dP.  dS is
// rounded to the input dtype before the dS.K product, where the JAX kernel
// casts it for the MXU.  Operands are read through their strides (the
// model's q/k/v are transposed views of one projection).

#include "common.cuh"

namespace apex_tpu_torch {

constexpr int kDqBQ = 32;        // query rows per block
constexpr int kDqBK = 32;        // keys per tile (one per lane)
constexpr int kDqThreads = 256;  // 8 warps
constexpr int kDqRowsPerWarp = kDqBQ / (kDqThreads / 32);

struct BwdStrides {
  int64_t q_b, q_h, q_s;
  int64_t k_b, k_h, k_s;
  int64_t v_b, v_h, v_s;
  int64_t do_b, do_h, do_s;
  int64_t g_b, g_h, g_s;  // the gradient written (dq)
};

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kDqThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    const int* __restrict__ kv_lens, int heads, int sq, int sk,
                    BwdStrides st, float scale, int causal, Dropout dr) {
  constexpr int NC = (D + 31) / 32;  // output columns per lane
  __shared__ float qs[kDqBQ][D];
  __shared__ float dos[kDqBQ][D];
  __shared__ float ks[kDqBK][D + 1];
  __shared__ float vs[kDqBK][D + 1];

  const int bh = blockIdx.x;
  const int bi = bh / heads;
  const int hi = bh % heads;
  const int q0 = blockIdx.y * kDqBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const T* qb = q + bi * st.q_b + hi * st.q_h;
  const T* kb = k + bi * st.k_b + hi * st.k_h;
  const T* vb = v + bi * st.v_b + hi * st.v_h;
  const T* dob = dout + bi * st.do_b + hi * st.do_h;
  T* gb = dq + bi * st.g_b + hi * st.g_h;

  int kv_len = sk;
  if (kv_lens != nullptr) kv_len = max(0, min(kv_lens[bi], sk));

  for (int idx = threadIdx.x; idx < kDqBQ * D; idx += kDqThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int qr = q0 + r;
    qs[r][d] = qr < sq ? to_f32(qb[qr * st.q_s + d]) : 0.f;
    dos[r][d] = qr < sq ? to_f32(dob[qr * st.do_s + d]) : 0.f;
  }

  float lse_r[kDqRowsPerWarp];
  float delta_r[kDqRowsPerWarp];
  uint32_t hash_r[kDqRowsPerWarp];
  float acc[kDqRowsPerWarp][NC];
#pragma unroll
  for (int r = 0; r < kDqRowsPerWarp; ++r) {
    const int qpos = q0 + warp * kDqRowsPerWarp + r;
    const int64_t stat = static_cast<int64_t>(bh) * sq + qpos;
    lse_r[r] = qpos < sq ? lse[stat] : 0.f;
    delta_r[r] = qpos < sq ? delta[stat] : 0.f;
    hash_r[r] = kDropout ? dropout_row_hash(dr, bh, qpos) : 0u;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  int k_end = kv_len;
  if (causal) k_end = min(k_end, q0 + kDqBQ);
  const int n_tiles = (k_end + kDqBK - 1) / kDqBK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kDqBK;
    __syncthreads();  // the previous tile is consumed (and, at t == 0, qs/dos are written)
    for (int idx = threadIdx.x; idx < kDqBK * D; idx += kDqThreads) {
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
    for (int r = 0; r < kDqRowsPerWarp; ++r) {
      const int row = warp * kDqRowsPerWarp + r;
      const int qpos = q0 + row;
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dot += qs[row][d] * ks[lane][d];
        dp += dos[row][d] * vs[lane][d];
      }
      const bool valid = qpos < sq && kpos < kv_len && (!causal || kpos <= qpos);
      const float p = valid ? expf(dot * scale - lse_r[r]) : 0.f;
      if (kDropout) dp *= dropout_factor(dr, hash_r[r], kpos);
      const float ds = round_to<T>(p * (dp - delta_r[r]) * scale);
#pragma unroll
      for (int j = 0; j < kDqBK; ++j) {
        const float dsj = __shfl_sync(kFullMask, ds, j);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = lane + 32 * c;
          if (col < D) acc[r][c] += dsj * ks[j][col];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kDqRowsPerWarp; ++r) {
    const int qpos = q0 + warp * kDqRowsPerWarp + r;
    if (qpos >= sq) continue;
    T* grow = gb + qpos * st.g_s;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < D) grow[col] = from_f32<T>(acc[r][c]);
    }
  }
}

template <typename T, int D>
static void launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, const void* kv_lens,
                      int batch, int heads, int sq, int sk, const BwdStrides& st, float scale,
                      int causal, const Dropout& dr, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(batch * heads),
                  static_cast<unsigned>((sq + kDqBQ - 1) / kDqBQ));
  // dropout is a template flag: the plain path keeps its registers
  auto kernel = dr.on ? flash_bwd_dq_kernel<T, D, true> : flash_bwd_dq_kernel<T, D, false>;
  kernel<<<grid, kDqThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq),
      static_cast<const int*>(kv_lens), heads, sq, sk, st, scale, causal, dr);
}

template <typename T>
static int dispatch_dq(int head_dim, const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta, void* dq,
                       const void* kv_lens, int batch, int heads, int sq, int sk,
                       const BwdStrides& st, float scale, int causal, const Dropout& dr,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      launch_dq<T, 16>(q, k, v, dout, lse, delta, dq, kv_lens, batch, heads, sq, sk, st, scale,
                       causal, dr, stream);
      return 0;
    case 32:
      launch_dq<T, 32>(q, k, v, dout, lse, delta, dq, kv_lens, batch, heads, sq, sk, st, scale,
                       causal, dr, stream);
      return 0;
    case 64:
      launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, kv_lens, batch, heads, sq, sk, st, scale,
                       causal, dr, stream);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// q, dout, dq: (b, h, sq, d); k, v: (b, h, sk, d); each with the given
// batch/head/seq strides (in elements) and a contiguous last dim.  lse and
// delta: (b*h, sq) f32; kv_lens: (b,) int32 or null; dropout as in
// apex_flash_fwd.
extern "C" int apex_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq,
                                 const void* kv_lens, int batch, int heads, int sq, int sk,
                                 int head_dim, int64_t q_b, int64_t q_h, int64_t q_s,
                                 int64_t k_b, int64_t k_h, int64_t k_s, int64_t v_b,
                                 int64_t v_h, int64_t v_s, int64_t do_b, int64_t do_h,
                                 int64_t do_s, int64_t g_b, int64_t g_h, int64_t g_s,
                                 float scale, int causal, int dropout, uint32_t threshold,
                                 float keep_scale, uint32_t seed, int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0) return 0;
  const BwdStrides st{q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s,
                      do_b, do_h, do_s, g_b, g_h, g_s};
  const Dropout dr{dropout, threshold, keep_scale, seed};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case kF32:
      rc = dispatch_dq<float>(head_dim, q, k, v, dout, lse, delta, dq, kv_lens, batch, heads,
                              sq, sk, st, scale, causal, dr, s);
      break;
    case kBF16:
      rc = dispatch_dq<__nv_bfloat16>(head_dim, q, k, v, dout, lse, delta, dq, kv_lens, batch,
                                      heads, sq, sk, st, scale, causal, dr, s);
      break;
    case kF16:
      rc = dispatch_dq<__half>(head_dim, q, k, v, dout, lse, delta, dq, kv_lens, batch, heads,
                               sq, sk, st, scale, causal, dr, s);
      break;
    default:
      rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
