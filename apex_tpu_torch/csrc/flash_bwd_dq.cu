// Flash-attention backward, dq pass, for Hopper.
//
// Replaces apex_tpu/ops/flash_attention.py `_dq_kernel` (launched by
// `_flash_bwd_impl`).  What bounds it on the H100: operations.  Each
// (batch*head, query) row does three products of head_dim against every
// unmasked key (q.k to recompute p, dO.v for dP, dS.k for dq) against
// 5 * s * 64 bf16 inputs and outputs: at GPT-350M's (8, 16, 1024, 64)
// causal and BERT-large's (16, 16, 512, 64) training shapes that is 25.8
// GFLOP, 0.026 ms of bf16 tensor-core time, against 84 MB of inputs and
// outputs, 0.025 ms of memory time.
//
// bf16 (every path of the models) runs the three products on the tensor
// cores (mma.sync m16n8k16, f32 accumulation), in the FlashAttention-2
// structure of the dk/dv kernel (flash_bwd_dkv.cu) with the roles of the
// queries and the keys swapped.  A block is 4 warps over 64 query rows, 16
// per warp, which hold their Q and dO rows as A fragments in registers and
// their rows' lse and delta; the TPU kernel's sequential k-block grid axis
// is a loop inside the block over 64-key tiles of K and V, double-buffered
// in shared memory by 16-byte cp.async copies (rows padded by 8 bf16
// against ldmatrix bank conflicts), the next tile in flight while this one
// is computed.  Per 32 keys of a tile a warp forms S = Q K^T and dP = dO
// V^T (C fragments, 16 x 32 each), P = exp(S * scale - lse) (the
// special-function unit's __expf) with the forward's masks, dS = P * (dP *
// D - delta) * scale, rounded to bf16 where the JAX kernel casts it for the
// MXU and packed from C into A fragments (two adjacent n8 C tiles are one
// k16 A fragment), then dQ += dS K with K read as B fragments through
// ldmatrix .trans.  dq (16 x head_dim f32 per warp) is summed in registers
// in a fixed key order (no atomics: runs repeat bit for bit).  Under the
// causal mask key tiles past the block's last query are never loaded and
// the longest query tiles are scheduled first; the masks run only on the
// causal diagonal and on the tiles holding kv_seqlens or sk (not at all, a
// template flag, for dense non-causal calls whose keys fill whole tiles).
// Query rows past sq are not written; a batch whose kv_seqlens masks every
// key writes zeros.  Dropout (a template flag) regenerates the forward's
// keep factor from absolute positions and scales dP.  Operands are read
// through their strides (the model's q/k/v are transposed views of one
// projection); cp.async needs 16-byte-aligned bases and batch / head / seq
// strides that are multiples of 8 elements, which the wrapper checks.
//
// f32 and f16 keep the first design on the FMA units (f32 arithmetic): the
// same loop inside one block per (batch*head, 32-query tile), 4 query rows
// per warp; lane j takes key j of a 32-key tile staged in shared memory as
// f32 (K and V padded by one column, so lane j reading key j is
// conflict-free).  No path of the models runs it.

#include <type_traits>

#include "mma.cuh"

namespace apex_tpu_torch {

// the FMA (f32, f16) design
constexpr int kDqBQ = 32;        // query rows per block
constexpr int kDqBK = 32;        // keys per tile (one per lane)
constexpr int kDqThreads = 256;  // 8 warps
constexpr int kDqRowsPerWarp = kDqBQ / (kDqThreads / 32);

// the tensor-core (bf16) design
constexpr int kMmaBQ = 64;        // query rows per block, 16 per warp
constexpr int kMmaBK = 64;        // keys per tile
constexpr int kMmaSub = 32;       // keys per step of a warp (S, dP: 16 x 32)
constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kMmaPad = 8;        // bf16 of padding per shared row

struct BwdStrides {
  int64_t q_b, q_h, q_s;
  int64_t k_b, k_h, k_s;
  int64_t v_b, v_h, v_s;
  int64_t do_b, do_h, do_s;
  int64_t g_b, g_h, g_s;  // the gradient written (dq)
};

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kDqThreads)
flash_bwd_dq_fma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
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

template <int D, bool kMasked, bool kDropout>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, const int* __restrict__ kv_lens, int heads, int sq,
                        int sk, BwdStrides st, float scale, int causal, Dropout dr) {
  constexpr int LD = D + kMmaPad;
  constexpr int KD = D / 16;        // k16 steps over head_dim
  constexpr int ND = D / 8;         // n8 tiles of dQ per warp
  constexpr int NK = kMmaSub / 8;   // n8 tiles of S, dP per step
  __shared__ __align__(16) bf16 ks[2][kMmaBK * LD];
  __shared__ __align__(16) bf16 vs[2][kMmaBK * LD];

  const int bh = blockIdx.x;
  const int bi = bh / heads;
  const int hi = bh % heads;
  // the last query tiles, the longest under the causal mask, go first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // this thread's rows: c0, c1 of a C tile are row0, c2, c3 are row0 + 8
  const int row0 = q0 + warp * 16 + g;

  const bf16* qb = q + bi * st.q_b + hi * st.q_h;
  const bf16* kb = k + bi * st.k_b + hi * st.k_h;
  const bf16* vb = v + bi * st.v_b + hi * st.v_h;
  const bf16* dob = dout + bi * st.do_b + hi * st.do_h;
  bf16* gb = dq + bi * st.g_b + hi * st.g_h;
  const float* lseb = lse + static_cast<int64_t>(bh) * sq;
  const float* deltab = delta + static_cast<int64_t>(bh) * sq;

  int kv_len = sk;
  if (kv_lens != nullptr) kv_len = max(0, min(kv_lens[bi], sk));
  // keys at or past kv_len, and under the causal mask keys past the block's
  // last query, are never loaded
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q0 + kMmaBQ);
  const int n_tiles = (k_end + kMmaBK - 1) / kMmaBK;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  }

  if (n_tiles > 0) {
    // Q and dO pass through the second buffers (first used by tile 1) into
    // A fragments that stay in registers for the whole loop
    cp_async_rows<kMmaBQ, D, kMmaThreads>(ks[1], LD, qb, st.q_s, q0, sq);
    cp_async_rows<kMmaBQ, D, kMmaThreads>(vs[1], LD, dob, st.do_s, q0, sq);
    cp_async_commit();
    cp_async_rows<kMmaBK, D, kMmaThreads>(ks[0], LD, kb, st.k_s, 0, sk);
    cp_async_rows<kMmaBK, D, kMmaThreads>(vs[0], LD, vb, st.v_s, 0, sk);
    cp_async_commit();
    float lse_r[2], delta_r[2];
    uint32_t hash_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      lse_r[r] = qpos < sq ? lseb[qpos] : 0.f;
      delta_r[r] = qpos < sq ? deltab[qpos] : 0.f;
      hash_r[r] = kDropout ? dropout_row_hash(dr, bh, qpos) : 0u;
    }
    cp_async_wait(1);
    __syncthreads();
    unsigned qf[KD][4], df[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      load_a(qf[kk], ks[1], LD, warp * 16, kk * 16);
      load_a(df[kk], vs[1], LD, warp * 16, kk * 16);
    }
    __syncthreads();  // Q and dO are read before tile 1 overwrites them

    for (int it = 0; it < n_tiles; ++it) {
      const int k0 = it * kMmaBK;
      const int buf = it & 1;
      if (it + 1 < n_tiles) {  // the next tile streams in while this one is computed
        cp_async_rows<kMmaBK, D, kMmaThreads>(ks[buf ^ 1], LD, kb, st.k_s, k0 + kMmaBK, sk);
        cp_async_rows<kMmaBK, D, kMmaThreads>(vs[buf ^ 1], LD, vb, st.v_s, k0 + kMmaBK, sk);
        cp_async_commit();
        cp_async_wait(1);
      } else {
        cp_async_wait(0);
      }
      __syncthreads();
      // masks only on the causal diagonal and the tile holding kv_len (or sk)
      const bool edge = kMasked && (k0 + kMmaBK > kv_len || (causal && k0 + kMmaBK > q0));

#pragma unroll 1
      for (int kq = 0; kq < kMmaBK; kq += kMmaSub) {
        float s[NK][4], dp[NK][4];
#pragma unroll
        for (int j = 0; j < NK; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
        }
        // S = Q K^T, dP = dO V^T: K and V n-major (row key, d contiguous)
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
          for (int j = 0; j < NK / 2; ++j) {
            unsigned fb[4];
            load_b(fb, ks[buf], LD, kq + j * 16, kk * 16);
            mma_bf16(s[2 * j], qf[kk], fb[0], fb[1]);
            mma_bf16(s[2 * j + 1], qf[kk], fb[2], fb[3]);
            load_b(fb, vs[buf], LD, kq + j * 16, kk * 16);
            mma_bf16(dp[2 * j], df[kk], fb[0], fb[1]);
            mma_bf16(dp[2 * j + 1], df[kk], fb[2], fb[3]);
          }
        }
        // s becomes dS (rounded to bf16 when packed)
#pragma unroll
        for (int j = 0; j < NK; ++j) {
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int kpos = k0 + kq + 8 * j + 2 * t4 + cc;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int c = 2 * r + cc;
              const int qpos = row0 + 8 * r;
              float p = __expf(s[j][c] * scale - lse_r[r]);
              if (edge && !(kpos < kv_len && (!causal || kpos <= qpos))) p = 0.f;
              float dpv = dp[j][c];
              if (kDropout) dpv *= dropout_factor(dr, hash_r[r], kpos);
              s[j][c] = p * (dpv - delta_r[r]) * scale;
            }
          }
        }
        // dQ += dS K: K k-major here (row key, d contiguous)
#pragma unroll
        for (int kk = 0; kk < NK / 2; ++kk) {
          const unsigned da[4] = {bf16x2(s[2 * kk][0], s[2 * kk][1]),
                                  bf16x2(s[2 * kk][2], s[2 * kk][3]),
                                  bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                  bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int n = 0; n < ND / 2; ++n) {
            unsigned fb[4];
            load_b_t(fb, ks[buf], LD, kq + kk * 16, n * 16);
            mma_bf16(acc[2 * n], da, fb[0], fb[1]);
            mma_bf16(acc[2 * n + 1], da, fb[2], fb[3]);
          }
        }
      }
      __syncthreads();  // this tile's buffers are consumed before they are refilled
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + 8 * r;
    if (qpos >= sq) continue;
    bf16* grow = gb + qpos * st.g_s + 2 * t4;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<unsigned*>(grow + 8 * n) = bf16x2(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

template <typename T, int D>
static void launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, const void* kv_lens,
                      int batch, int heads, int sq, int sk, const BwdStrides& st, float scale,
                      int causal, const Dropout& dr, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    const dim3 grid(static_cast<unsigned>(batch * heads),
                    static_cast<unsigned>((sq + kMmaBQ - 1) / kMmaBQ));
    // masks and dropout are template flags; query rows past sq need no mask
    // (they are never written), keys past sk do
    const bool masked = causal || kv_lens != nullptr || sk % kMmaBK != 0;
    auto kernel = masked ? (dr.on ? flash_bwd_dq_mma_kernel<D, true, true>
                                  : flash_bwd_dq_mma_kernel<D, true, false>)
                         : (dr.on ? flash_bwd_dq_mma_kernel<D, false, true>
                                  : flash_bwd_dq_mma_kernel<D, false, false>);
    kernel<<<grid, kMmaThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dq),
        static_cast<const int*>(kv_lens), heads, sq, sk, st, scale, causal, dr);
  } else {
    const dim3 grid(static_cast<unsigned>(batch * heads),
                    static_cast<unsigned>((sq + kDqBQ - 1) / kDqBQ));
    // dropout is a template flag: the plain path keeps its registers
    auto kernel = dr.on ? flash_bwd_dq_fma_kernel<T, D, true>
                        : flash_bwd_dq_fma_kernel<T, D, false>;
    kernel<<<grid, kDqThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dq),
        static_cast<const int*>(kv_lens), heads, sq, sk, st, scale, causal, dr);
  }
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
      rc = dispatch_dq<bf16>(head_dim, q, k, v, dout, lse, delta, dq, kv_lens, batch, heads,
                            sq, sk, st, scale, causal, dr, s);
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
