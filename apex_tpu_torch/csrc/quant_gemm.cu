// Int8 weight dequant-GEMM for Hopper: y = x · dequant(w8, scale)ᵀ, f32 out.
//
// Replaces apex_tpu/ops/quant_gemm.py `_qgemm_kernel` (launched by
// `quant_gemm`).  w8 is int8 (n, k) in the Megatron (out, in) layout with
// one f32 scale per output row; x is (m, k).  As in the TPU kernel, each
// weight is dequantized in registers to f32 (w8 * scale), rounded to x's
// dtype, and the product accumulates in f32.  Any m, n, k: ragged tiles
// are masked (the TPU kernel pads to its blocks instead).
//
// What bounds it on the H100.  At decode (m = the 8 serving slots) the
// int8 weight bytes: 16 operations per weight byte, far below the card's
// ~295 bf16 operations per byte.  At prefill (m up to 512) the operations:
// bf16 on the tensor cores, and the f32 tied head (f32 x) on the FMA
// units.  Three kernels:
//
// * `qgemm_bf16_rows16` (bf16 x, m <= 16): one block per 8 output columns,
//   so n = 1024 already spreads over 128 blocks and every SM streams W.
//   Its 4 warps split k in 64-wide chunks; a lane loads 16 int8 of one W
//   row with one 16-byte load and feeds them, dequantized to bf16, straight
//   into mma.sync m16n8k16 as B fragments, with the matching x values (A)
//   read from device memory (x is a few rows; it stays in L1/L2).  The
//   order of k inside a chunk is permuted identically for A and B, so the
//   16 bytes a lane loads are exactly the 16 k values its fragments need.
//   The four warps' partial sums are added in shared memory in a fixed
//   order (one launch, deterministic).
// * `qgemm_bf16_tiles` (bf16 x, m > 16): 64 x 64 output tiles, 4 warps of
//   32 x 32, k in steps of 32; the int8 tile is dequantized to bf16 into
//   shared memory (n-major, padded rows), x's tile copied beside it, and
//   ldmatrix + mma.sync run the product.  The next tile's loads are in
//   registers while the current one computes.
// * `qgemm_fma` (f32 or f16 x): tiles in shared memory in f32, each thread
//   a TM x TN block of outputs by FMA; 16 x 128 tiles for m <= 16, 64 x 64
//   otherwise.
//
// Later work: cp.async / TMA pipelines, wgmma, and a 3xbf16 split for the
// f32 head.

#include "mma.cuh"

namespace apex_tpu_torch {

constexpr int kQThreads = 128;  // 4 warps in every kernel here

__device__ __forceinline__ int8_t byte_of(const uint32_t (&w)[4], int j) {
  return static_cast<int8_t>((w[j >> 2] >> (8 * (j & 3))) & 0xffu);
}

__device__ __forceinline__ unsigned pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}

// one weight dequantized to f32 and rounded to bf16, as the TPU kernel's
// `(w8.astype(f32) * scale).astype(x.dtype)`
__device__ __forceinline__ bf16 deq_bf16(int8_t q, float s) {
  return __float2bfloat16(static_cast<float>(q) * s);
}

// 16 int8 of row `row` (a pointer to it, or null past n) at k0, zero past k
__device__ __forceinline__ void load_w16(uint32_t (&w)[4], const int8_t* row, int k0, int k,
                                         bool vec) {
  if (row != nullptr && vec && k0 + 16 <= k) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + k0);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = 0u;
  if (row == nullptr) return;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (k0 + j < k)
      w[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(row[k0 + j])) << (8 * (j & 3));
  }
}

// x[k0 .. k0+3] of one row as two bf16 pairs (lo: k0, k0+1; hi: k0+2, k0+3),
// zero past k or for a row past m (null)
__device__ __forceinline__ void load_x4(unsigned& lo, unsigned& hi, const bf16* row, int k0, int k,
                                        bool vec) {
  if (row == nullptr) {
    lo = hi = 0u;
    return;
  }
  if (vec && k0 + 4 <= k) {
    const uint2 v = *reinterpret_cast<const uint2*>(row + k0);
    lo = v.x;
    hi = v.y;
    return;
  }
  unsigned e[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j] = k0 + j < k ? __bfloat16_as_ushort(row[k0 + j]) : 0u;
  lo = e[0] | (e[1] << 16);
  hi = e[2] | (e[3] << 16);
}

// ---------------------------------------------------------------------------
// bf16 x, m <= 16
// ---------------------------------------------------------------------------

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4): B holds
// (k 2t, 2t+1 | 2t+8, 2t+9) of column g, A the same k of rows g and g+8.
// In a 64-wide chunk, lane (g, t) loads W row n0+g at k 16t..16t+15; mma
// step s gives its logical k (2t+e, 2t+8+e) the physical k 16t+4s+e and
// 16t+4s+2+e.  A uses the same map, so the sum runs over every k once.
__global__ void __launch_bounds__(kQThreads)
qgemm_bf16_rows16(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, float* __restrict__ y, int m, int n, int k,
                  int64_t ldx, int vec_x, int vec_w) {
  __shared__ float part[4][32][4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * 8;
  const int wrow = n0 + g;
  const int8_t* wr = wrow < n ? w + static_cast<int64_t>(wrow) * k : nullptr;
  const float s = wrow < n ? scale[wrow] : 0.f;
  const bf16* x0 = g < m ? x + static_cast<int64_t>(g) * ldx : nullptr;
  const bf16* x1 = g + 8 < m ? x + static_cast<int64_t>(g + 8) * ldx : nullptr;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int chunks = (k + 63) / 64;
  for (int c = warp; c < chunks; c += 4) {
    const int kb = c * 64 + 16 * t;
    uint32_t wq[4];
    load_w16(wq, wr, kb, k, vec_w != 0);
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      const int kk = kb + 4 * st;
      unsigned a[4];
      load_x4(a[0], a[2], x0, kk, k, vec_x != 0);
      load_x4(a[1], a[3], x1, kk, k, vec_x != 0);
      const unsigned b0 = pack_bf16(deq_bf16(byte_of(wq, 4 * st), s),
                                    deq_bf16(byte_of(wq, 4 * st + 1), s));
      const unsigned b1 = pack_bf16(deq_bf16(byte_of(wq, 4 * st + 2), s),
                                    deq_bf16(byte_of(wq, 4 * st + 3), s));
      mma_bf16(acc, a, b0, b1);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) part[warp][lane][i] = acc[i];
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v = ((part[0][lane][i] + part[1][lane][i]) + part[2][lane][i]) + part[3][lane][i];
    const int row = g + (i >= 2 ? 8 : 0);
    const int col = n0 + 2 * t + (i & 1);
    if (row < m && col < n) y[static_cast<int64_t>(row) * n + col] = v;
  }
}

// ---------------------------------------------------------------------------
// bf16 x, m > 16
// ---------------------------------------------------------------------------

constexpr int kTileM = 64, kTileN = 64, kTileK = 32;
constexpr int kTileLd = kTileK + 8;  // padded rows: 80 bytes, ldmatrix-aligned

union Bf16x8 {  // eight bf16 as their bits
  uint4 v;
  unsigned short h[8];
};

__global__ void __launch_bounds__(kQThreads)
qgemm_bf16_tiles(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, float* __restrict__ y, int m, int n, int k,
                 int64_t ldx, int vec_x, int vec_w) {
  __shared__ __align__(16) unsigned short xs_bits[kTileM * kTileLd];
  __shared__ __align__(16) unsigned short ws_bits[kTileN * kTileLd];
  bf16* xs = reinterpret_cast<bf16*>(xs_bits);
  bf16* ws = reinterpret_cast<bf16*>(ws_bits);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;

  // this thread's loads: two 8-wide x segments, one 16-wide W segment
  const int w_row = tid >> 1, w_col = (tid & 1) * 16;
  const int8_t* wr = n0 + w_row < n ? w + static_cast<int64_t>(n0 + w_row) * k : nullptr;
  const float w_scale = n0 + w_row < n ? scale[n0 + w_row] : 0.f;
  Bf16x8 xr[2];
  uint32_t wq[4];

  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = tid + j * kQThreads;
      const int row = m0 + (idx >> 2), kg = k0 + (idx & 3) * 8;
      if (row < m && vec_x && kg + 8 <= k) {
        xr[j].v = *reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row) * ldx + kg);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          xr[j].h[e] = row < m && kg + e < k
                           ? __bfloat16_as_ushort(x[static_cast<int64_t>(row) * ldx + kg + e])
                           : static_cast<unsigned short>(0);
      }
    }
    load_w16(wq, wr, k0 + w_col, k, vec_w != 0);
  };
  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = tid + j * kQThreads;
      *reinterpret_cast<uint4*>(&xs[(idx >> 2) * kTileLd + (idx & 3) * 8]) = xr[j].v;
    }
    Bf16x8 d[2];
#pragma unroll
    for (int e = 0; e < 16; ++e)
      d[e >> 3].h[e & 7] = __bfloat16_as_ushort(deq_bf16(byte_of(wq, e), w_scale));
    *reinterpret_cast<uint4*>(&ws[w_row * kTileLd + w_col]) = d[0].v;
    *reinterpret_cast<uint4*>(&ws[w_row * kTileLd + w_col + 8]) = d[1].v;
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int ktiles = (k + kTileK - 1) / kTileK;
  load(0);
  for (int kt = 0; kt < ktiles; ++kt) {
    __syncthreads();  // the previous tile's fragments are read
    store();
    __syncthreads();
    if (kt + 1 < ktiles) load((kt + 1) * kTileK);
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 16) {
      unsigned a[2][4], b[2][4];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf) load_a(a[mf], xs, kTileLd, wm * 32 + mf * 16, kk);
#pragma unroll
      for (int nf2 = 0; nf2 < 2; ++nf2) load_b(b[nf2], ws, kTileLd, wn * 32 + nf2 * 16, kk);
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
          mma_bf16(acc[mf][nf], a[mf], b[nf >> 1][(nf & 1) * 2], b[nf >> 1][(nf & 1) * 2 + 1]);
    }
  }

#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + mf * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn * 32 + nf * 8 + 2 * t + (e & 1);
        if (row < m && col < n) y[static_cast<int64_t>(row) * n + col] = acc[mf][nf][e];
      }
}

// ---------------------------------------------------------------------------
// f32 / f16 x on the FMA units
// ---------------------------------------------------------------------------

template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kQThreads)
qgemm_fma(const T* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
          float* __restrict__ y, int m, int n, int k, int64_t ldx) {
  constexpr int BK = 32, TX = BN / TN, TY = BM / TM;
  static_assert(TX * TY == kQThreads, "one output block per thread");
  __shared__ float xs[BM][BK + 1];  // padded: conflict-free column reads
  __shared__ float ws[BN][BK + 1];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kQThreads) {
      const int r = i / BK, c = i % BK, row = m0 + r, kk = k0 + c;
      xs[r][c] = row < m && kk < k ? to_f32(x[static_cast<int64_t>(row) * ldx + kk]) : 0.f;
    }
    for (int i = tid; i < BN * BK; i += kQThreads) {
      const int r = i / BK, c = i % BK, col = n0 + r, kk = k0 + c;
      ws[r][c] = col < n && kk < k
                     ? round_to<T>(static_cast<float>(w[static_cast<int64_t>(col) * k + kk]) *
                                   scale[col])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[ty + i * TY][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[tx + j * TX][kk];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int row = m0 + ty + i * TY, col = n0 + tx + j * TX;
      if (row < m && col < n) y[static_cast<int64_t>(row) * n + col] = acc[i][j];
    }
}

template <typename T>
static void launch_fma(const void* x, const void* w, const void* scale, void* y, int m, int n,
                       int k, int64_t ldx, cudaStream_t s) {
  if (m <= 16) {
    const dim3 grid((n + 127) / 128, (m + 15) / 16);
    qgemm_fma<T, 16, 128, 2, 8><<<grid, kQThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<float*>(y), m, n, k, ldx);
  } else {
    const dim3 grid((n + 63) / 64, (m + 63) / 64);
    qgemm_fma<T, 64, 64, 4, 8><<<grid, kQThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<float*>(y), m, n, k, ldx);
  }
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// x: (m, k) with row stride ldx and a contiguous last dim; w8: (n, k) int8
// contiguous; scale: (n,) f32; y: (m, n) f32 contiguous.  vec_x / vec_w:
// 1 when x's rows (pointer and ldx) are 16-byte aligned / when w8 is
// 16-byte aligned and k % 16 == 0, allowing vector loads.
extern "C" int apex_quant_gemm(const void* x, const void* w8, const void* scale, void* y, int m,
                               int n, int k, int64_t ldx, int vec_x, int vec_w, int dtype,
                               void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16:
      if (m <= 16) {
        qgemm_bf16_rows16<<<(n + 7) / 8, kQThreads, 0, s>>>(
            static_cast<const bf16*>(x), static_cast<const int8_t*>(w8),
            static_cast<const float*>(scale), static_cast<float*>(y), m, n, k, ldx, vec_x,
            vec_w);
      } else {
        const dim3 grid((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM);
        qgemm_bf16_tiles<<<grid, kQThreads, 0, s>>>(
            static_cast<const bf16*>(x), static_cast<const int8_t*>(w8),
            static_cast<const float*>(scale), static_cast<float*>(y), m, n, k, ldx, vec_x,
            vec_w);
      }
      break;
    case kF32:
      launch_fma<float>(x, w8, scale, y, m, n, k, ldx, s);
      break;
    case kF16:
      launch_fma<__half>(x, w8, scale, y, m, n, k, ldx, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
