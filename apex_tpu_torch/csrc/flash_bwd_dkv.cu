// Flash-attention backward, dk/dv pass, for Hopper.
//
// Replaces apex_tpu/ops/flash_attention.py `_dkv_kernel` (launched by
// `_flash_bwd_impl`).  What bounds it on the H100: operations.  Each
// (batch*head, key) row does four products of head_dim against every query
// that sees it (q.k to recompute p, dO.v for dP, (P*D)^T dO for dv, dS^T q
// for dk) against 6 * s * 64 bf16 inputs and outputs: hundreds of
// operations per byte at 512-1024 tokens, above the card's 295 bf16
// operations per byte of device memory.
//
// bf16 (every path of the models) runs the four products on the tensor
// cores (mma.sync m16n8k16, f32 accumulation), in the FlashAttention-2
// structure.  A block is 4 warps over 64 keys, 16 per warp, which hold their
// K and V rows as A fragments in registers; the TPU kernel's sequential
// q-block grid axis is a loop inside the block over 64-query tiles of Q and
// dO, double-buffered in shared memory by 16-byte cp.async copies (rows
// padded by 8 bf16 against ldmatrix bank conflicts), with the tile's lse and
// delta beside them, the next tile in flight while this one is computed.
// Per 32 queries of a tile a warp forms S^T = K Q^T and dP^T = V dO^T (C
// fragments), P^T = exp(S^T * scale - lse) (the special-function unit's
// __expf) with the forward's masks, then
// dV += (P^T * D) dO and dK += dS^T Q with dS^T = P^T * (dP^T * D - delta)
// * scale, each operand going back into the product from registers (two
// adjacent n8 C tiles are one k16 A fragment), rounded to bf16 where the
// JAX kernel casts it for the MXU.  dk and dv are summed in registers in a
// fixed order over the query tiles (no atomics: runs repeat bit for bit).
// Query rows past sq are zeroed (the JAX kernel's padded-row guard: their
// lse / delta are not real), query tiles wholly before the block's first
// key under the causal mask are never loaded, the masks run only on the
// causal diagonal and on edge tiles (not at all, a template flag, for dense
// non-causal calls whose queries fill whole tiles), and a block wholly past
// kv_seqlens writes zeros.  Dropout (a template flag) regenerates the
// forward's keep factor from absolute positions and scales P for dv and dP
// for dS.  Operands are read through their strides; cp.async needs
// 16-byte-aligned bases and batch / head / seq strides that are multiples
// of 8 elements, which the wrapper checks.
//
// f32 and f16 keep the first design on the FMA units (f32 arithmetic): one
// block per (batch*head, 32-key tile), 4 keys per warp (K and V in shared
// memory, read as broadcasts); lane i takes query row i of a 32-row tile of
// q and dO staged as f32 (padded by one column, so lane i reading row i is
// conflict-free), with its lse and delta.  No path of the models runs it.

#include <type_traits>

#include "mma.cuh"

namespace apex_tpu_torch {

// the FMA (f32, f16) design
constexpr int kDkvBK = 32;        // keys per block
constexpr int kDkvBQ = 32;        // query rows per tile (one per lane)
constexpr int kDkvThreads = 256;  // 8 warps
constexpr int kDkvKeysPerWarp = kDkvBK / (kDkvThreads / 32);

// the tensor-core (bf16) design
constexpr int kMmaBK = 64;        // keys per block, 16 per warp
constexpr int kMmaBQ = 64;        // query rows per tile
constexpr int kMmaSub = 32;       // queries per step of a warp (S^T, dP^T: 16 x 32)
constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kMmaPad = 8;        // bf16 of padding per shared row

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
flash_bwd_dkv_fma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
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

// Stage query tile q0 of the tensor-core design: Q and dO by cp.async
// (committed as one group), lse and delta by plain loads; rows past sq read
// zeros.
template <int D>
__device__ __forceinline__ void stage_queries(bf16* qt, bf16* dot, float* lse_t, float* delta_t,
                                              const bf16* qb, const bf16* dob, const float* lseb,
                                              const float* deltab, const DkvStrides& st, int q0,
                                              int sq) {
  cp_async_rows<kMmaBQ, D, kMmaThreads>(qt, D + kMmaPad, qb, st.q_s, q0, sq);
  cp_async_rows<kMmaBQ, D, kMmaThreads>(dot, D + kMmaPad, dob, st.do_s, q0, sq);
  cp_async_commit();
  const int i = threadIdx.x & (kMmaBQ - 1);
  const int qr = q0 + i;
  if (threadIdx.x < kMmaBQ) {
    lse_t[i] = qr < sq ? lseb[qr] : 0.f;
  } else {
    delta_t[i] = qr < sq ? deltab[qr] : 0.f;
  }
}

template <int D, bool kMasked, bool kDropout>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         const int* __restrict__ kv_lens, int heads, int sq, int sk,
                         DkvStrides st, float scale, int causal, Dropout dr) {
  constexpr int LD = D + kMmaPad;
  constexpr int KD = D / 16;         // k16 steps over head_dim
  constexpr int ND = D / 8;          // n8 tiles of dK, dV per warp
  constexpr int NQ = kMmaSub / 8;    // n8 tiles of S^T, dP^T per step
  __shared__ __align__(16) bf16 qs[2][kMmaBQ * LD];
  __shared__ __align__(16) bf16 dos[2][kMmaBQ * LD];
  __shared__ float lse_s[2][kMmaBQ];
  __shared__ float delta_s[2][kMmaBQ];

  const int bh = blockIdx.x;
  const int bi = bh / heads;
  const int hi = bh % heads;
  const int k0 = blockIdx.y * kMmaBK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // this thread's keys: c0, c1 of a C tile are key0, c2, c3 are key0 + 8
  const int key0 = k0 + warp * 16 + g;

  const bf16* qb = q + bi * st.q_b + hi * st.q_h;
  const bf16* kb = k + bi * st.k_b + hi * st.k_h;
  const bf16* vb = v + bi * st.v_b + hi * st.v_h;
  const bf16* dob = dout + bi * st.do_b + hi * st.do_h;
  bf16* dkb = dk + bi * st.dk_b + hi * st.dk_h;
  bf16* dvb = dv + bi * st.dv_b + hi * st.dv_h;
  const float* lseb = lse + static_cast<int64_t>(bh) * sq;
  const float* deltab = delta + static_cast<int64_t>(bh) * sq;

  int kv_len = sk;
  if (kv_lens != nullptr) kv_len = max(0, min(kv_lens[bi], sk));
  // keys at or past kv_len get no probability from any query: the whole
  // block is skipped when its first key is; under the causal mask a query
  // tile ending before the block's first key sees none of its keys
  const int q_begin = causal ? k0 : 0;
  const int q_end = k0 < kv_len ? sq : q_begin;
  const int n_tiles = q_end > q_begin ? (q_end - q_begin + kMmaBQ - 1) / kMmaBQ : 0;

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[n][c] = acc_v[n][c] = 0.f;
  }

  if (n_tiles > 0) {
    // K and V pass through the second buffers (first used by tile 1) into
    // A fragments that stay in registers for the whole loop
    cp_async_rows<kMmaBK, D, kMmaThreads>(qs[1], LD, kb, st.k_s, k0, sk);
    cp_async_rows<kMmaBK, D, kMmaThreads>(dos[1], LD, vb, st.v_s, k0, sk);
    cp_async_commit();
    stage_queries<D>(qs[0], dos[0], lse_s[0], delta_s[0], qb, dob, lseb, deltab, st, q_begin,
                     sq);
    cp_async_wait(1);
    __syncthreads();
    unsigned kf[KD][4], vf[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      load_a(kf[kk], qs[1], LD, warp * 16, kk * 16);
      load_a(vf[kk], dos[1], LD, warp * 16, kk * 16);
    }
    __syncthreads();  // K and V are read before tile 1 overwrites them

    for (int it = 0; it < n_tiles; ++it) {
      const int q0 = q_begin + it * kMmaBQ;
      const int buf = it & 1;
      if (it + 1 < n_tiles) {  // the next tile streams in while this one is computed
        stage_queries<D>(qs[buf ^ 1], dos[buf ^ 1], lse_s[buf ^ 1], delta_s[buf ^ 1], qb, dob,
                         lseb, deltab, st, q0 + kMmaBQ, sq);
        cp_async_wait(1);
      } else {
        cp_async_wait(0);
      }
      __syncthreads();
      // masks only on the causal diagonal, the tile holding sq and the
      // block holding kv_len
      const bool edge = kMasked && (q0 + kMmaBQ > sq || k0 + kMmaBK > kv_len ||
                                    (causal && q0 < k0 + kMmaBK));

#pragma unroll 1
      for (int qq = 0; qq < kMmaBQ; qq += kMmaSub) {
        float s[NQ][4], dp[NQ][4];
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
        }
        // S^T = K Q^T, dP^T = V dO^T: Q and dO n-major (row query, d contiguous)
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
          for (int j = 0; j < NQ / 2; ++j) {
            unsigned fb[4];
            load_b(fb, qs[buf], LD, qq + j * 16, kk * 16);
            mma_bf16(s[2 * j], kf[kk], fb[0], fb[1]);
            mma_bf16(s[2 * j + 1], kf[kk], fb[2], fb[3]);
            load_b(fb, dos[buf], LD, qq + j * 16, kk * 16);
            mma_bf16(dp[2 * j], vf[kk], fb[0], fb[1]);
            mma_bf16(dp[2 * j + 1], vf[kk], fb[2], fb[3]);
          }
        }
        // s becomes P^T * D (rounded for dV), dp becomes dS^T (rounded for dK)
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int col = qq + 8 * j + 2 * t4 + cc;
            const int qpos = q0 + col;
            const float lse_q = lse_s[buf][col];
            const float delta_q = delta_s[buf][col];
            const uint32_t row_hash = kDropout ? dropout_row_hash(dr, bh, qpos) : 0u;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int c = 2 * r + cc;
              const int kpos = key0 + 8 * r;
              float p = __expf(s[j][c] * scale - lse_q);
              // qpos < sq zeroes padded query rows (their lse/delta are not real)
              if (edge && !(qpos < sq && kpos < kv_len && (!causal || kpos <= qpos))) p = 0.f;
              float pd = p, dpv = dp[j][c];
              if (kDropout) {
                const float f = dropout_factor(dr, row_hash, kpos);
                pd *= f;
                dpv *= f;
              }
              s[j][c] = pd;
              dp[j][c] = p * (dpv - delta_q) * scale;
            }
          }
        }
        // dV += (P^T * D) dO, dK += dS^T Q: dO and Q k-major (row query, d contiguous)
#pragma unroll
        for (int kk = 0; kk < NQ / 2; ++kk) {
          const unsigned pa[4] = {bf16x2(s[2 * kk][0], s[2 * kk][1]),
                                  bf16x2(s[2 * kk][2], s[2 * kk][3]),
                                  bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                  bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
          const unsigned da[4] = {bf16x2(dp[2 * kk][0], dp[2 * kk][1]),
                                  bf16x2(dp[2 * kk][2], dp[2 * kk][3]),
                                  bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                  bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
          for (int n = 0; n < ND / 2; ++n) {
            unsigned fb[4];
            load_b_t(fb, dos[buf], LD, qq + kk * 16, n * 16);
            mma_bf16(acc_v[2 * n], pa, fb[0], fb[1]);
            mma_bf16(acc_v[2 * n + 1], pa, fb[2], fb[3]);
            load_b_t(fb, qs[buf], LD, qq + kk * 16, n * 16);
            mma_bf16(acc_k[2 * n], da, fb[0], fb[1]);
            mma_bf16(acc_k[2 * n + 1], da, fb[2], fb[3]);
          }
        }
      }
      __syncthreads();  // this tile's buffers are consumed before they are refilled
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = key0 + 8 * r;
    if (kpos >= sk) continue;
    bf16* krow = dkb + kpos * st.dk_s + 2 * t4;
    bf16* vrow = dvb + kpos * st.dv_s + 2 * t4;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<unsigned*>(krow + 8 * n) = bf16x2(acc_k[n][2 * r], acc_k[n][2 * r + 1]);
      *reinterpret_cast<unsigned*>(vrow + 8 * n) = bf16x2(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

template <typename T, int D>
static void launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv,
                       const void* kv_lens, int batch, int heads, int sq, int sk,
                       const DkvStrides& st, float scale, int causal, const Dropout& dr,
                       cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    const dim3 grid(static_cast<unsigned>(batch * heads),
                    static_cast<unsigned>((sk + kMmaBK - 1) / kMmaBK));
    // masks and dropout are template flags; keys past sk need no mask (their
    // rows are never written), query rows past sq do
    const bool masked = causal || kv_lens != nullptr || sq % kMmaBQ != 0;
    auto kernel = masked ? (dr.on ? flash_bwd_dkv_mma_kernel<D, true, true>
                                  : flash_bwd_dkv_mma_kernel<D, true, false>)
                         : (dr.on ? flash_bwd_dkv_mma_kernel<D, false, true>
                                  : flash_bwd_dkv_mma_kernel<D, false, false>);
    kernel<<<grid, kMmaThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        static_cast<const int*>(kv_lens), heads, sq, sk, st, scale, causal, dr);
  } else {
    const dim3 grid(static_cast<unsigned>(batch * heads),
                    static_cast<unsigned>((sk + kDkvBK - 1) / kDkvBK));
    // dropout is a template flag: the plain path keeps its registers
    auto kernel = dr.on ? flash_bwd_dkv_fma_kernel<T, D, true>
                        : flash_bwd_dkv_fma_kernel<T, D, false>;
    kernel<<<grid, kDkvThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
        static_cast<const int*>(kv_lens), heads, sq, sk, st, scale, causal, dr);
  }
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
      rc = dispatch_dkv<bf16>(head_dim, q, k, v, dout, lse, delta, dk, dv, kv_lens,
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
