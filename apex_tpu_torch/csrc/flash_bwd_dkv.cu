// Flash-attention backward, dk/dv pass, for Hopper.
//
// Replaces apex_tpu/ops/flash_attention.py `_dkv_kernel` (launched by
// `_flash_bwd_impl`).  What bounds it on the H100: operations.  Each
// (batch*head, key) row does four products of head_dim against every query
// that sees it (q.k to recompute p, dO.v for dP, (P*D)^T dO for dv, dS^T q
// for dk): hundreds of operations per byte at 1024 tokens.  This first
// version runs them on the FMA units in f32, not on the tensor cores;
// mma/wgmma tiling is later work.  Design: the TPU kernel's sequential
// q-block grid axis becomes a loop inside one block per (batch*head, 32-key
// tile), so dk and dv are summed in registers in a fixed order (no atomics,
// runs repeat bit for bit).  Each warp owns 4 keys (K and V of the block's
// keys stay in shared memory, read as broadcasts); lane i takes query row i
// of a 32-row tile of q and dO staged in shared memory as f32 (padded by
// one column, so lane i reading row i is conflict-free), with its lse and
// delta.  p is recomputed from the forward's logsumexp with its masks;
// query rows past sq are zeroed (the JAX kernel's padded-row guard), query
// tiles wholly before the block's first key under the causal mask are never
// loaded, and a block wholly past kv_seqlens writes zeros.  Dropout
// regenerates the forward's keep factor from absolute positions and scales
// P for dv and dP for dS.  P*D is rounded to dO's dtype before the dv
// product and dS to q's before the dk product, where the JAX kernel casts
// them for the MXU.  Operands are read through their strides.

#include "common.cuh"

namespace apex_tpu_torch {

constexpr int kDkvBK = 32;        // keys per block
constexpr int kDkvBQ = 32;        // query rows per tile (one per lane)
constexpr int kDkvThreads = 256;  // 8 warps
constexpr int kDkvKeysPerWarp = kDkvBK / (kDkvThreads / 32);

struct DkvStrides {
  int64_t q_b, q_h, q_s;
  int64_t k_b, k_h, k_s;
  int64_t v_b, v_h, v_s;
  int64_t do_b, do_h, do_s;
  int64_t dk_b, dk_h, dk_s;
  int64_t dv_b, dv_h, dv_s;
};

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kDkvThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     const int* __restrict__ kv_lens, int heads, int sq, int sk,
                     DkvStrides st, float scale, int causal, Dropout dr) {
  constexpr int NC = (D + 31) / 32;  // output columns per lane
  __shared__ float ks[kDkvBK][D];
  __shared__ float vs[kDkvBK][D];
  __shared__ float qs[kDkvBQ][D + 1];
  __shared__ float dos[kDkvBQ][D + 1];
  __shared__ float lse_s[kDkvBQ];
  __shared__ float delta_s[kDkvBQ];

  const int bh = blockIdx.x;
  const int bi = bh / heads;
  const int hi = bh % heads;
  const int k0 = blockIdx.y * kDkvBK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const T* qb = q + bi * st.q_b + hi * st.q_h;
  const T* kb = k + bi * st.k_b + hi * st.k_h;
  const T* vb = v + bi * st.v_b + hi * st.v_h;
  const T* dob = dout + bi * st.do_b + hi * st.do_h;
  T* dkb = dk + bi * st.dk_b + hi * st.dk_h;
  T* dvb = dv + bi * st.dv_b + hi * st.dv_h;

  int kv_len = sk;
  if (kv_lens != nullptr) kv_len = max(0, min(kv_lens[bi], sk));

  for (int idx = threadIdx.x; idx < kDkvBK * D; idx += kDkvThreads) {
    const int j = idx / D;
    const int d = idx - j * D;
    const int kr = k0 + j;
    ks[j][d] = kr < sk ? to_f32(kb[kr * st.k_s + d]) : 0.f;
    vs[j][d] = kr < sk ? to_f32(vb[kr * st.v_s + d]) : 0.f;
  }

  float acc_k[kDkvKeysPerWarp][NC];
  float acc_v[kDkvKeysPerWarp][NC];
#pragma unroll
  for (int r = 0; r < kDkvKeysPerWarp; ++r) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;
  }

  // keys at or past kv_len get no probability from any query: the whole
  // block is skipped when its first key is; under the causal mask a query
  // tile ending before the block's first key sees none of its keys
  const int q_begin = causal ? (k0 / kDkvBQ) * kDkvBQ : 0;
  const int q_end = k0 < kv_len ? sq : q_begin;
  for (int q0 = q_begin; q0 < q_end; q0 += kDkvBQ) {
    __syncthreads();  // the previous tile is consumed (and, first, ks/vs are written)
    for (int idx = threadIdx.x; idx < kDkvBQ * D; idx += kDkvThreads) {
      const int i = idx / D;
      const int d = idx - i * D;
      const int qr = q0 + i;
      qs[i][d] = qr < sq ? to_f32(qb[qr * st.q_s + d]) : 0.f;
      dos[i][d] = qr < sq ? to_f32(dob[qr * st.do_s + d]) : 0.f;
    }
    if (threadIdx.x < kDkvBQ) {
      const int qr = q0 + threadIdx.x;
      const int64_t stat = static_cast<int64_t>(bh) * sq + qr;
      lse_s[threadIdx.x] = qr < sq ? lse[stat] : 0.f;
      delta_s[threadIdx.x] = qr < sq ? delta[stat] : 0.f;
    }
    __syncthreads();

    const int qpos = q0 + lane;
    const uint32_t row_hash = kDropout ? dropout_row_hash(dr, bh, qpos) : 0u;
#pragma unroll
    for (int r = 0; r < kDkvKeysPerWarp; ++r) {
      const int key = warp * kDkvKeysPerWarp + r;
      const int kpos = k0 + key;
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dot += qs[lane][d] * ks[key][d];
        dp += dos[lane][d] * vs[key][d];
      }
      // qpos < sq zeroes padded query rows (their lse/delta are not real)
      const bool valid = qpos < sq && kpos < kv_len && (!causal || kpos <= qpos);
      const float p = valid ? expf(dot * scale - lse_s[lane]) : 0.f;
      float pd = p;
      if (kDropout) {
        const float f = dropout_factor(dr, row_hash, kpos);
        pd *= f;
        dp *= f;
      }
      pd = round_to<T>(pd);
      const float ds = round_to<T>(p * (dp - delta_s[lane]) * scale);
#pragma unroll
      for (int i = 0; i < kDkvBQ; ++i) {
        const float pdi = __shfl_sync(kFullMask, pd, i);
        const float dsi = __shfl_sync(kFullMask, ds, i);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = lane + 32 * c;
          if (col < D) {
            acc_v[r][c] += pdi * dos[i][col];
            acc_k[r][c] += dsi * qs[i][col];
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kDkvKeysPerWarp; ++r) {
    const int kpos = k0 + warp * kDkvKeysPerWarp + r;
    if (kpos >= sk) continue;
    T* krow = dkb + kpos * st.dk_s;
    T* vrow = dvb + kpos * st.dv_s;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < D) {
        krow[col] = from_f32<T>(acc_k[r][c]);
        vrow[col] = from_f32<T>(acc_v[r][c]);
      }
    }
  }
}

template <typename T, int D>
static void launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv,
                       const void* kv_lens, int batch, int heads, int sq, int sk,
                       const DkvStrides& st, float scale, int causal, const Dropout& dr,
                       cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(batch * heads),
                  static_cast<unsigned>((sk + kDkvBK - 1) / kDkvBK));
  // dropout is a template flag: the plain path keeps its registers
  auto kernel = dr.on ? flash_bwd_dkv_kernel<T, D, true> : flash_bwd_dkv_kernel<T, D, false>;
  kernel<<<grid, kDkvThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<const int*>(kv_lens), heads, sq, sk, st, scale, causal, dr);
}

template <typename T>
static int dispatch_dkv(int head_dim, const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta, void* dk,
                        void* dv, const void* kv_lens, int batch, int heads, int sq, int sk,
                        const DkvStrides& st, float scale, int causal, const Dropout& dr,
                        cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      launch_dkv<T, 16>(q, k, v, dout, lse, delta, dk, dv, kv_lens, batch, heads, sq, sk, st,
                        scale, causal, dr, stream);
      return 0;
    case 32:
      launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, kv_lens, batch, heads, sq, sk, st,
                        scale, causal, dr, stream);
      return 0;
    case 64:
      launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, kv_lens, batch, heads, sq, sk, st,
                        scale, causal, dr, stream);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// q, dout: (b, h, sq, d); k, v, dk, dv: (b, h, sk, d); each with the given
// batch/head/seq strides (in elements) and a contiguous last dim.  lse and
// delta: (b*h, sq) f32; kv_lens: (b,) int32 or null; dropout as in
// apex_flash_fwd.
extern "C" int apex_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, const void* kv_lens, int batch,
                                  int heads, int sq, int sk, int head_dim, int64_t q_b,
                                  int64_t q_h, int64_t q_s, int64_t k_b, int64_t k_h,
                                  int64_t k_s, int64_t v_b, int64_t v_h, int64_t v_s,
                                  int64_t do_b, int64_t do_h, int64_t do_s, int64_t dk_b,
                                  int64_t dk_h, int64_t dk_s, int64_t dv_b, int64_t dv_h,
                                  int64_t dv_s, float scale, int causal, int dropout,
                                  uint32_t threshold, float keep_scale, uint32_t seed,
                                  int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || sk <= 0) return 0;
  const DkvStrides st{q_b,  q_h,  q_s,  k_b,  k_h,  k_s,  v_b,  v_h,  v_s,
                      do_b, do_h, do_s, dk_b, dk_h, dk_s, dv_b, dv_h, dv_s};
  const Dropout dr{dropout, threshold, keep_scale, seed};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case kF32:
      rc = dispatch_dkv<float>(head_dim, q, k, v, dout, lse, delta, dk, dv, kv_lens, batch,
                               heads, sq, sk, st, scale, causal, dr, s);
      break;
    case kBF16:
      rc = dispatch_dkv<__nv_bfloat16>(head_dim, q, k, v, dout, lse, delta, dk, dv, kv_lens,
                                       batch, heads, sq, sk, st, scale, causal, dr, s);
      break;
    case kF16:
      rc = dispatch_dkv<__half>(head_dim, q, k, v, dout, lse, delta, dk, dv, kv_lens, batch,
                                heads, sq, sk, st, scale, causal, dr, s);
      break;
    default:
      rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
