// Flash-attention forward (causal, kv_seqlens, probability dropout) for
// Hopper.
//
// Replaces apex_tpu/ops/flash_attention.py `_fwd_kernel` (launched by
// `_flash_fwd_impl`).  What bounds it on the H100: operations.  At a
// 1024-token sequence every (batch, head) does 2 * s * s * 64 multiply-adds
// for QK^T and PV (half of them under the causal mask) against 4 * s * 64
// bf16 inputs and outputs, hundreds of operations per byte, above the
// card's 295 bf16 operations per byte of device memory.
//
// bf16 (every path of the models) runs on the tensor cores, in the
// FlashAttention-2 structure on mma.sync m16n8k16 (f32 accumulation).  A
// block is 4 warps over 64 query rows, 16 per warp; the TPU kernel's
// sequential k-block grid axis is a loop inside the block over 64-key tiles
// of K and V, double-buffered in shared memory by 16-byte cp.async copies
// (rows padded by 8 bf16, so the eight rows an ldmatrix reads fall in eight
// bank groups), the next tile in flight while this one is computed.  A
// warp holds its Q rows as A fragments for the whole loop, S = Q K^T (16 x
// 64 f32) in C fragments, the online-softmax state of its rows (the four
// lanes of a quad share a row: max and sum reduce over shuffles by 1 and 2)
// and its O accumulator (16 x head_dim f32).  P goes back into the product
// from registers: two adjacent n8 C tiles form one k16 A fragment, rounded
// to bf16 after the dropout factor and relative to the running max, where
// the JAX kernel casts p for the MXU; l sums the undropped f32 p, so the
// saved lse is dropout-free.  The exponentials, one per score, take the
// special-function unit's intrinsic (__expf): with the products on the
// tensor cores they are a large share of the work.  The last query tiles,
// the longest under the causal mask, are scheduled first.  Tiles strictly
// above the causal diagonal and past kv_seqlens are never loaded; the masks
// run only on the diagonal and edge tiles, and not at all (a template flag,
// the JAX kernel's static `masked`) for dense non-causal calls whose keys
// fill whole tiles (BERT without padding).  The finite mask value and the l == 0 guard make a
// fully masked row come out as 0.  Dropout (a template flag: a runtime one
// costs registers) regenerates the JAX counter-hash keep factor from
// absolute (q, k) positions, one row hash per row a thread owns
// (common.cuh).  q, k and v are read through their strides; cp.async needs
// 16-byte-aligned bases and batch / head / seq strides that are multiples of
// 8 elements, which the wrapper checks.  Query rows and keys past sq / sk
// read zeros and are never written.  head_dim 16, 32 or 64, a template
// parameter.
//
// f32 and f16 keep the first design on the FMA units (f32 arithmetic): one
// block per (batch*head, 64-query tile), 32-key tiles staged in shared
// memory as f32 (K padded by one column so that lane j reading key j is
// conflict-free), 8 query rows per warp with their online-softmax state;
// lane j scores key j, and P.V broadcasts p_j with a shuffle.  No path of
// the models runs it.

#include <type_traits>

#include "mma.cuh"

namespace apex_tpu_torch {

// the FMA (f32, f16) design
constexpr int kFlashBQ = 64;       // query rows per block
constexpr int kFlashBK = 32;       // keys per tile (one per lane)
constexpr int kFlashThreads = 256; // 8 warps
constexpr int kFlashRowsPerWarp = kFlashBQ / (kFlashThreads / 32);

// the tensor-core (bf16) design
constexpr int kMmaBQ = 64;         // query rows per block, 16 per warp
constexpr int kMmaBK = 64;         // keys per tile
constexpr int kMmaThreads = 128;   // 4 warps
constexpr int kMmaPad = 8;         // bf16 of padding per shared row

struct FlashStrides {
  int64_t q_b, q_h, q_s;
  int64_t k_b, k_h, k_s;
  int64_t v_b, v_h, v_s;
  int64_t o_b, o_h, o_s;
};

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_fma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
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

template <int D, bool kMasked, bool kDropout>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     const int* __restrict__ kv_lens, int heads, int sq, int sk,
                     FlashStrides st, float scale, int causal, Dropout dr) {
  constexpr int LD = D + kMmaPad;
  constexpr int NS = kMmaBK / 8;  // n8 tiles of S per warp
  constexpr int NO = D / 8;       // n8 tiles of O per warp
  constexpr int KD = D / 16;      // k16 steps over head_dim
  __shared__ __align__(16) bf16 qs[kMmaBQ * LD];
  __shared__ __align__(16) bf16 ks[2][kMmaBK * LD];
  __shared__ __align__(16) bf16 vs[2][kMmaBK * LD];

  const int bh = blockIdx.x;
  const int bi = bh / heads;
  const int hi = bh % heads;
  // the last query tiles, the longest under the causal mask, start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // this thread's rows: c0, c1 of a C tile are row0, c2, c3 are row0 + 8
  const int row0 = q0 + warp * 16 + g;

  const bf16* qb = q + bi * st.q_b + hi * st.q_h;
  const bf16* kb = k + bi * st.k_b + hi * st.k_h;
  const bf16* vb = v + bi * st.v_b + hi * st.v_h;
  bf16* ob = o + bi * st.o_b + hi * st.o_h;

  int kv_len = sk;
  if (kv_lens != nullptr) kv_len = max(0, min(kv_lens[bi], sk));
  // keys past kv_len, and (causal) past this block's last query, are masked
  // for every row of the block: their tiles are skipped
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q0 + kMmaBQ);
  const int n_tiles = (k_end + kMmaBK - 1) / kMmaBK;

  cp_async_rows<kMmaBQ, D, kMmaThreads>(qs, LD, qb, st.q_s, q0, sq);
  cp_async_commit();
  if (n_tiles > 0) {
    cp_async_rows<kMmaBK, D, kMmaThreads>(ks[0], LD, kb, st.k_s, 0, kv_len);
    cp_async_rows<kMmaBK, D, kMmaThreads>(vs[0], LD, vb, st.v_s, 0, kv_len);
  }
  cp_async_commit();
  cp_async_wait(1);  // Q has landed; K/V tile 0 may still be in flight
  __syncthreads();
  unsigned qf[KD][4];  // this warp's 16 query rows, for the whole loop
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) load_a(qf[kk], qs, LD, warp * 16, kk * 16);

  float m[2] = {kMask, kMask};
  float l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  uint32_t row_hash[2] = {0u, 0u};
  if (kDropout) {
    row_hash[0] = dropout_row_hash(dr, bh, row0);
    row_hash[1] = dropout_row_hash(dr, bh, row0 + 8);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kMmaBK;
    const int buf = t & 1;
    if (t + 1 < n_tiles) {  // the next tile streams in while this one is computed
      cp_async_rows<kMmaBK, D, kMmaThreads>(ks[buf ^ 1], LD, kb, st.k_s, k0 + kMmaBK, kv_len);
      cp_async_rows<kMmaBK, D, kMmaThreads>(vs[buf ^ 1], LD, vb, st.v_s, k0 + kMmaBK, kv_len);
      cp_async_commit();
      cp_async_wait(1);
    } else {
      cp_async_wait(0);
    }
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        unsigned fb[4];
        load_b(fb, ks[buf], LD, j * 16, kk * 16);
        mma_bf16(s[2 * j], qf[kk], fb[0], fb[1]);
        mma_bf16(s[2 * j + 1], qf[kk], fb[2], fb[3]);
      }
    }

    // masks only on the tile holding kv_len / sk and on the causal diagonal
    const bool edge = kMasked && (k0 + kMmaBK > kv_len ||
                                  (causal && k0 + kMmaBK - 1 > q0 + warp * 16));
    unsigned valid = ~0u;  // bit 4 j + c: element c of S tile j
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[j][c] * scale;
        if (edge) {
          const int kpos = k0 + 8 * j + 2 * t4 + (c & 1);
          const int qpos = row0 + 8 * (c >> 1);
          if (kpos >= kv_len || (causal && kpos > qpos)) {
            x = kMask;
            valid &= ~(1u << (4 * j + c));
          }
        }
        s[j][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFullMask, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFullMask, mx[i], 2));
      alpha[i] = __expf(m[i] - mx[i]);
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float p = __expf(s[j][c] - mx[c >> 1]);
        if (edge && !((valid >> (4 * j + c)) & 1u)) p = 0.f;
        rsum[c >> 1] += p;
        if (kDropout) p *= dropout_factor(dr, row_hash[c >> 1], k0 + 8 * j + 2 * t4 + (c & 1));
        s[j][c] = p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rsum[i] += __shfl_xor_sync(kFullMask, rsum[i], 1);
      rsum[i] += __shfl_xor_sync(kFullMask, rsum[i], 2);
      l[i] = alpha[i] * l[i] + rsum[i];
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P (16 x 64) from registers, V k-major (row key, d contiguous)
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      const unsigned pa[4] = {bf16x2(s[2 * kk][0], s[2 * kk][1]),
                              bf16x2(s[2 * kk][2], s[2 * kk][3]),
                              bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO / 2; ++n) {
        unsigned fb[4];
        load_b_t(fb, vs[buf], LD, kk * 16, n * 16);
        mma_bf16(acc[2 * n], pa, fb[0], fb[1]);
        mma_bf16(acc[2 * n + 1], pa, fb[2], fb[3]);
      }
    }
    __syncthreads();  // this tile's buffers are consumed before they are refilled
  }
  cp_async_wait(0);  // with no tile, the empty K/V group is still open

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = row0 + 8 * i;
    if (qpos >= sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    bf16* orow = ob + qpos * st.o_s + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<unsigned*>(orow + 8 * n) =
          bf16x2(acc[n][2 * i] / l_safe, acc[n][2 * i + 1] / l_safe);
    }
    if (t4 == 0 && lse != nullptr) lse[static_cast<int64_t>(bh) * sq + qpos] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
static void launch_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             const void* kv_lens, int batch, int heads, int sq, int sk,
                             const FlashStrides& st, float scale, int causal,
                             const Dropout& dr, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    const dim3 grid(static_cast<unsigned>(batch * heads),
                    static_cast<unsigned>((sq + kMmaBQ - 1) / kMmaBQ));
    // masks and dropout are template flags: the dense and the plain
    // instantiations carry neither the mask arithmetic nor its registers
    const bool masked = causal || kv_lens != nullptr || sk % kMmaBK != 0;
    auto kernel = masked ? (dr.on ? flash_fwd_mma_kernel<D, true, true>
                                  : flash_fwd_mma_kernel<D, true, false>)
                         : (dr.on ? flash_fwd_mma_kernel<D, false, true>
                                  : flash_fwd_mma_kernel<D, false, false>);
    kernel<<<grid, kMmaThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), static_cast<float*>(lse), static_cast<const int*>(kv_lens),
        heads, sq, sk, st, scale, causal, dr);
  } else {
    const dim3 grid(static_cast<unsigned>(batch * heads),
                    static_cast<unsigned>((sq + kFlashBQ - 1) / kFlashBQ));
    // dropout is a template flag: the plain path keeps its registers
    auto kernel = dr.on ? flash_fwd_fma_kernel<T, D, true> : flash_fwd_fma_kernel<T, D, false>;
    kernel<<<grid, kFlashThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), static_cast<float*>(lse), static_cast<const int*>(kv_lens),
        heads, sq, sk, st, scale, causal, dr);
  }
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
      rc = dispatch_flash_fwd<bf16>(head_dim, q, k, v, o, lse, kv_lens, batch, heads, sq, sk, st,
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
