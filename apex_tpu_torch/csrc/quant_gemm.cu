// Int8 weight dequant-GEMM for Hopper: y = x · dequant(w8, scale)ᵀ, f32 out.
//
// Replaces apex_tpu/ops/quant_gemm.py `_qgemm_kernel` (launched by
// `quant_gemm`).  w8 is int8 (n, k) in the Megatron (out, in) layout with
// one f32 scale per output row; x is (m, k).  As in the TPU kernel, each
// weight is dequantized to f32 (w8 * scale), rounded to x's dtype, and the
// product accumulates in f32.  Any m, n, k: ragged tiles are masked or
// zero-filled (the TPU kernel pads to its blocks instead).
//
// What bounds it on the H100.  At decode (m = the 8 serving slots) the
// int8 weight bytes: 16 operations per weight byte, far below the card's
// ~295 bf16 operations per byte.  At prefill (m up to 512) the operations
// on the tensor cores, also for the f32 tied head (f32 x), which runs as
// three bf16 products.  The output is small at both (n >= 1024 weight rows
// against m <= 512 tokens), so the card is filled from the weight side.
//
// `qgemm_tma_kernel` (x bf16, or f32; rows of x and w8 on TMA's 16-byte
// grid, k % 16 == 0) computes yᵀ: the tokens stand on wgmma's N side
// ("swap AB"), a block owns 128 weight rows x BN tokens (BN 8 ... 128, the
// least power of two >= m, so a decode step's 8 tokens waste no product),
// and the weight rows give the block count:
//
// * one producer thread keeps a ring of stages in flight by TMA: each
//   stage is the int8 box of 128 weight rows x 64 k (8 KB, 64-byte
//   swizzled) and the x box of BN rows x 64 k bf16 (128-byte swizzled, as
//   wgmma reads B), or for f32 x the three boxes of its bf16 parts;
// * each of two consumer warpgroups owns 64 weight rows and feeds them to
//   wgmma m64nBNk16 as A from registers: a thread loads the 4-byte words
//   of the stage's int8 that hold its fragment's pairs (the 64-byte swizzle
//   spreads a warp's loads over all 32 banks) and dequantizes them in
//   registers: for bf16 x each weight becomes bf16(q * s), the TPU
//   kernel's rounding; for f32 x the exact bf16(q), the scale applied in
//   the epilogue.  The next stage's fragments are made while this
//   stage's products run (two fragment buffers); a stage goes back to the
//   producer once its products have completed.  (Dequantizing into a
//   swizzled bf16 tile in shared memory for wgmma to read ran up to 1.2x
//   slower in the same run, `tools/qgemm_variants_torch.py`: the tile's
//   stores, the proxy fence and the warpgroup barrier sit on every
//   stage's path);
// * f32 x is split once per call (`qgemm_split_x`) into hi = bf16(x), mid
//   = bf16(x - hi), lo = bf16(x - hi - mid), the three planes of a (3, m,
//   k) workspace; each k16 step runs lo, mid, then hi into a stage's f32
//   accumulator, which joins the running sum by a rounded f32 add.  |q| <=
//   127 is exact in bf16 and each bf16 product exact in f32, and the parts
//   carry x to 2^-24 relative, so y = s * acc differs from the f32
//   reference only by f32 rounding.  A non-finite x rides in hi (mid = lo
//   = 0);
// * where the tiles alone leave SMs idle (a decode step's fc2: 8 tiles of
//   1024 weight rows), a thread-block cluster of ks <= 8 blocks splits k
//   (as far as the card holds every cluster at once; 16 ran slower);
//   each block stages its partial tile in shared memory, and each rank sums
//   its share of the tile over the cluster's ranks in rank order through
//   distributed shared memory.  No atomics: a repeat gives the same bits;
// * the yᵀ tile goes out through the drained ring, transposed, so that y
//   (m, n) is written row by row with stores coalesced along n.
//
// The mma.sync and FMA kernels take what the TMA path does not (k % 16 !=
// 0, bases or x rows off 16 bytes, f16 x) and a decode step's shorter
// contractions (bf16, m <= 16, k <= 1024):
//
// * `qgemm_bf16_rows16` (bf16 x, m <= 16): one block per 8 output columns;
//   its 4 warps split k in 64-wide chunks; a lane loads 16 int8 of one W
//   row with one 16-byte load and feeds them, dequantized to bf16, straight
//   into mma.sync m16n8k16 as B fragments, with the matching x values (A)
//   read from device memory.  The order of k inside a chunk is permuted
//   identically for A and B, so the 16 bytes a lane loads are exactly the
//   16 k values its fragments need.  The four warps' partial sums are
//   added in shared memory in a fixed order.
// * `qgemm_bf16_tiles` (bf16 x, m > 16): 64 x 64 output tiles, 4 warps of
//   32 x 32, k in steps of 32; the int8 tile is dequantized to bf16 into
//   shared memory (n-major, padded rows), x's tile copied beside it, and
//   ldmatrix + mma.sync run the product.
// * `qgemm_fma` (f32 off the grid, f16 x): tiles in shared memory in f32,
//   each thread a TM x TN block of outputs by FMA.

#include <cooperative_groups.h>

#include <mutex>
#include <unordered_map>

#include "gemm.cuh"

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

// ---------------------------------------------------------------------------
// TMA + wgmma: yᵀ tiles of 128 weight rows x BN tokens
// ---------------------------------------------------------------------------

constexpr int kQBM = 128;          // weight rows (columns of y) per block
constexpr int kQBK = 64;           // contraction per stage: one 128-byte bf16 row
constexpr int kQTmaThreads = 384;  // a producer warpgroup and two consumers
constexpr int kQLdc = kQBM + 4;    // row stride (floats) of the staged yᵀ tile
constexpr int kQMaxSplit = 8;      // blocks of a k-split cluster (portable size)

// A block's shared memory for BN tokens and P parts of x (1: bf16 x; 3:
// f32 x as three bf16 planes): the ring of stages (later the staged output
// tile), the full / empty mbarriers, and the slack that puts the ring on
// the 1024-byte swizzle grid.
template <int BN, int P>
struct QTma {
  static_assert(BN >= 8 && BN <= 128 && (BN & (BN - 1)) == 0, "BN: 8, 16, 32, 64 or 128");
  static constexpr int kW8 = kQBM * kQBK;      // int8 box: 128 rows x 64 bytes, 64B-swizzled
  static constexpr int kX = BN * kQBK * 2;     // one part's x box: BN rows x 128 bytes
  static constexpr int kStage = kW8 + P * kX;  // every box on the 1024-byte grid
  static constexpr int kFit = 200 * 1024 / kStage;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kEpi = (BN * kQLdc * 4 + 1023) / 1024 * 1024;
  static constexpr int kRegion = kRing > kEpi ? kRing : kEpi;
  static constexpr int kSmem = kRegion + 2 * kStages * 8 + 1024;
  static_assert(kStages >= 2, "a ring of at least two stages");
};

// D (64 x N f32) += A (64 x 16) B (16 x N), A bf16 in registers (per warp
// of the group the A fragment of mma.sync m16n8k16 for its 16 rows), B bf16
// K-major from shared memory through its descriptor; d holds, per warp, the
// C fragments of m16n8 for its 16 rows and the N / 8 n8 tiles in order
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// TMA: the box at (column c0, row c1) of `map` into shared memory, counted
// on `bar` (any element type)
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int c0, int c1,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// the two int8 weights of `w` (four int8 biased by 128 to unsigned) that
// the selectors pick, as a bf16 pair, low k first: each byte goes under
// the exponent of 2^23 and 2^23 + 128 comes off (the f32 integer q), then
// bf16(q * s) (P = 1) or the exact bf16(q) (P = 3: the f32's upper half)
template <int P>
__device__ __forceinline__ uint32_t dequant2(uint32_t w, uint32_t sel0, uint32_t sel1, float s) {
  const float q0 = __uint_as_float(__byte_perm(w, 0x4B000000u, sel0)) - 8388736.f;
  const float q1 = __uint_as_float(__byte_perm(w, 0x4B000000u, sel1)) - 8388736.f;
  if constexpr (P == 1) {
    return bf16x2(q0 * s, q1 * s);
  } else {
    return __byte_perm(__float_as_uint(q0), __float_as_uint(q1), 0x7632u);
  }
}

// the float4 at shared address `addr` of cluster block `rank`
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// four entries of y's row `row` from column `col` (v: the yᵀ tile's sums;
// P = 3 applies the weight rows' scales), masked to (m, n)
template <int P>
__device__ __forceinline__ void store_y4(float* y, const float* scale, int row, int col,
                                         float4 v, int m, int n) {
  if (row >= m) return;
  float e[4] = {v.x, v.y, v.z, v.w};
  if constexpr (P == 3) {
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j] *= col + j < n ? scale[col + j] : 0.f;
  }
  float* dst = y + static_cast<int64_t>(row) * n + col;
  if ((n & 3) == 0 && col + 3 < n) {
    *reinterpret_cast<float4*>(dst) = make_float4(e[0], e[1], e[2], e[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (col + j < n) dst[j] = e[j];
    }
  }
}

// grid (ks x token tiles, weight tiles), clusters of ks blocks along x:
// rank r of a cluster takes the k steps [r nk / ks, (r + 1) nk / ks).
// tw: w8 (n, k) int8 in boxes of 128 rows x 64; tx: x (m, k) bf16, or the
// three parts stacked as (3 part_rows, k), in boxes of BN rows x 64.  Rows
// of a box past its part's m read the next part (or TMA's zeros): they
// only feed yᵀ's columns of tokens >= m, which are never stored.
template <int BN, int P>
__global__ void __launch_bounds__(kQTmaThreads, 1)
qgemm_tma_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
                 const float* __restrict__ scale, float* __restrict__ y, int m, int n, int k,
                 int part_rows) {
  using C = QTma<BN, P>;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::kRegion);
  uint64_t* empty = full + C::kStages;
  cg::cluster_group cluster = cg::this_cluster();
  const int ks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int t0 = static_cast<int>(blockIdx.x) / ks * BN, w0 = blockIdx.y * kQBM;
  const int nk = (k + kQBK - 1) / kQBK;
  const int kt0 = rank * nk / ks, steps = (rank + 1) * nk / ks - kt0;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    // the tensor maps (kernel parameters) on their way before the first copy
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tw)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tx)) : "memory");
    for (int i = 0; i < C::kStages; ++i) {
      gemm::mbar_init(&full[i], 1);   // the producer's arrival, plus the TMA bytes
      gemm::mbar_init(&empty[i], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    if (tid == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % C::kStages;
        if (i >= C::kStages) gemm::mbar_wait(&empty[s], (i / C::kStages - 1) & 1);
        gemm::mbar_expect_tx(&full[s], C::kStage);
        unsigned char* st = ring + s * C::kStage;
        const int kc = (kt0 + i) * kQBK;
        tma_box(st, &tw, kc, w0, &full[s]);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          tma_box(st + C::kW8 + p * C::kX, &tx, kc, p * part_rows + t0, &full[s]);
        }
      }
    }
    return;
  }

  // This consumer's 64 weight rows of the tile; this thread's A fragment
  // rows ra and ra + 8 (mma.sync's A layout: g = lane / 4, t = lane % 4,
  // k 2t, 2t + 1 and 2t + 8, 2t + 9 of each k16 step).  The int8 box is
  // 64-byte swizzled (16-byte chunk j of row r at j ^ (r / 2 % 4), the
  // same for ra and ra + 8), so a warp's 4-byte loads of one chunk hit 32
  // distinct banks; a lane loads the word holding its pair and picks it.
  const int c = wg - 1, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int ra = c * 64 + (tid >> 5) * 16 + g;
  const int sw = (ra >> 1) & 3, woff = 4 * (t4 >> 1);
  const uint32_t sel0 = 0x7540u | (2 * (t4 & 1)), sel1 = sel0 + 1;
  float sa = 1.f, sb = 1.f;
  if constexpr (P == 1) {
    sa = w0 + ra < n ? scale[w0 + ra] : 0.f;
    sb = w0 + ra + 8 < n ? scale[w0 + ra + 8] : 0.f;
  }
  // the A fragments of stage i's four k16 steps
  auto load_a = [&](uint32_t (&af)[4][4], int i) {
    const unsigned char* w8 = ring + (i % C::kStages) * C::kStage;
#pragma unroll
    for (int j = 0; j < kQBK / 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = ((j ^ sw) << 4) + 8 * h + woff;
        const uint32_t va = *reinterpret_cast<const uint32_t*>(w8 + ra * kQBK + off);
        const uint32_t vb = *reinterpret_cast<const uint32_t*>(w8 + (ra + 8) * kQBK + off);
        af[j][2 * h] = dequant2<P>(va ^ 0x80808080u, sel0, sel1, sa);
        af[j][2 * h + 1] = dequant2<P>(vb ^ 0x80808080u, sel0, sel1, sb);
      }
    }
  };
  // f32 x: each stage's three-part sum runs into `part`, then joins acc by
  // a rounded f32 add.  The tensor cores' accumulation truncates: summing
  // all k into one accumulator put the f32 head 2.6x (k 1024) and 5x (k
  // 4096) further from the f64 product than cuBLAS's f32 product.
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
  uint32_t af[2][4][4];
  // stage i's products from A fragments a (wgmma reads them until it completes)
  auto mma = [&](const uint32_t (&a)[4][4], int i) {
    const uint32_t x_addr = smem_u32(ring + (i % C::kStages) * C::kStage + C::kW8);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < kQBK / 16; ++j) {
#pragma unroll
      for (int p = P - 1; p >= 0; --p) {  // lo and mid before hi
        const uint64_t db = gemm::desc_sw128(x_addr + p * C::kX + 32 * j);
        if constexpr (P == 3) {
          wgmma_rs<BN>(part, a[j], db);
        } else {
          wgmma_rs<BN>(acc, a[j], db);
        }
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };
  // step i from fragment buffer B (a constant: registers are not indexed
  // at run time); its products run while step i + 1's fragments are made
  // in the other buffer
  auto step = [&](auto buf, int i) {
    constexpr int B = decltype(buf)::value;
    mma(af[B], i);
    if constexpr (P == 1) {
      // step i - 1's products are done: its stage goes back, its buffer
      // takes step i + 1's fragments
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (i > 0 && tid == 0) gemm::mbar_arrive(&empty[(i - 1) % C::kStages]);
    }
    if (i + 1 < steps) {
      gemm::mbar_wait(&full[(i + 1) % C::kStages], ((i + 1) / C::kStages) & 1);
      load_a(af[B ^ 1], i + 1);
    }
    if constexpr (P == 3) {
      // the stage's three-part sum joins the total by a rounded f32 add
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) {
        acc[j] += part[j];
        part[j] = 0.f;
      }
      if (tid == 0) gemm::mbar_arrive(&empty[i % C::kStages]);
    }
  };
  if (steps > 0) {
    gemm::mbar_wait(&full[0], 0);
    load_a(af[0], 0);
  }
#pragma unroll 1
  for (int i = 0; i < steps; i += 2) {
    step(std::integral_constant<int, 0>(), i);
    if (i + 1 < steps) step(std::integral_constant<int, 1>(), i + 1);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // the partial yᵀ tile into the drained ring, transposed: sc[token][row]
  float* sc = reinterpret_cast<float*>(ring);
  asm volatile("bar.sync 3, 256;\n" ::: "memory");  // both consumers are done with the ring
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const int r0 = ra;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int tok = j * 8 + 2 * t4;
    sc[tok * kQLdc + r0] = acc[4 * j];
    sc[(tok + 1) * kQLdc + r0] = acc[4 * j + 1];
    sc[tok * kQLdc + r0 + 8] = acc[4 * j + 2];
    sc[(tok + 1) * kQLdc + r0 + 8] = acc[4 * j + 3];
  }
  // 256 threads hand out float4s row by row: a warp stores 512 contiguous bytes
  const int ct = threadIdx.x - 128;
  if (ks == 1) {
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
    for (int i = ct; i < BN * kQBM / 4; i += 256) {
      const int tok = i / (kQBM / 4), col = (i % (kQBM / 4)) * 4;
      store_y4<P>(y, scale, t0 + tok, w0 + col,
                  *reinterpret_cast<const float4*>(sc + tok * kQLdc + col), m, n);
    }
    return;
  }
  // k split: rank r sums its share of the tile's float4s over the
  // cluster's partial tiles in rank order
  cluster.sync();
  constexpr int kVecs = BN * kQBM / 4;  // the tile's float4s, token-major
  for (int i = rank * kVecs / ks + ct; i < (rank + 1) * kVecs / ks; i += 256) {
    const int tok = i / (kQBM / 4), col = (i % (kQBM / 4)) * 4;
    const uint32_t src = smem_u32(sc + tok * kQLdc + col);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q0 = 0; q0 < ks; q0 += 4) {  // four ranks' loads in flight, summed in rank order
      float4 u[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q0 + q < ks) u[q] = ld_cluster_f4(src, q0 + q);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q0 + q < ks) {
          v.x += u[q].x;
          v.y += u[q].y;
          v.z += u[q].z;
          v.w += u[q].w;
        }
      }
    }
    store_y4<P>(y, scale, t0 + tok, w0 + col, v, m, n);
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// f32 x (m, k, row stride ldx) into its three bf16 parts, the planes of
// parts (3, m, k): hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
// mid), each difference exact in f32.  A non-finite x is carried by hi
// (mid = lo = 0); a finite x past bf16's largest finite keeps hi finite
// by truncation.
__global__ void __launch_bounds__(256)
qgemm_split_x(const float* __restrict__ x, bf16* __restrict__ parts, int m, int k, int64_t ldx) {
  const int64_t mk = static_cast<int64_t>(m) * k;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= mk) return;
  const int64_t r = i / k;
  const float v = x[r * ldx + (i - r * k)];
  bf16 hi = __float2bfloat16_rn(v);
  bf16 mid = __float2bfloat16_rn(0.f), lo = mid;
  if (isfinite(v)) {
    if (isinf(__bfloat162float(hi))) hi = __float2bfloat16_rz(v);
    const float r1 = v - __bfloat162float(hi);
    mid = __float2bfloat16_rn(r1);
    lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
  }
  parts[i] = hi;
  parts[mk + i] = mid;
  parts[2 * mk + i] = lo;
}

// The TMA map of a row-major (rows, cols) matrix with rows `pitch` bytes
// apart, boxes of 64 columns x box_rows: int8 64-byte swizzled (a box row
// is 64 bytes), bf16 128-byte swizzled; zeros outside.  Returns a
// cudaError_t.
inline int qgemm_map(CUtensorMap* map, const void* base, int rows, int cols, int64_t pitch,
                     int box_rows, bool int8) {
  const gemm::EncodeTiled fn = gemm::encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kQBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r =
      fn(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
         const_cast<void*>(base), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
         int8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// qgemm_map's maps kept by their arguments, of which a map is a function
// alone: a serving step asks for the same weights' maps, and (through the
// caching allocator) mostly the same activations', call after call
struct QMapKey {
  const void* base;
  int64_t pitch;
  int rows, cols, box_rows;
  bool int8;
  bool operator==(const QMapKey& o) const {
    return base == o.base && pitch == o.pitch && rows == o.rows && cols == o.cols &&
           box_rows == o.box_rows && int8 == o.int8;
  }
};

struct QMapHash {
  size_t operator()(const QMapKey& q) const {
    size_t h = std::hash<const void*>()(q.base);
    for (const int64_t v : {q.pitch, static_cast<int64_t>(q.rows), static_cast<int64_t>(q.cols),
                            static_cast<int64_t>(q.box_rows), static_cast<int64_t>(q.int8)}) {
      h = h * 1000003u ^ std::hash<int64_t>()(v);
    }
    return h;
  }
};

inline int qgemm_map_cached(CUtensorMap* map, const void* base, int rows, int cols, int64_t pitch,
                            int box_rows, bool int8) {
  static std::mutex mu;
  static std::unordered_map<QMapKey, CUtensorMap, QMapHash> maps;
  const QMapKey key{base, pitch, rows, cols, box_rows, int8};
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = maps.find(key);
    if (it != maps.end()) {
      *map = it->second;
      return 0;
    }
  }
  const int rc = qgemm_map(map, base, rows, cols, pitch, box_rows, int8);
  if (rc == 0) {
    std::lock_guard<std::mutex> lock(mu);
    if (maps.size() >= 4096) maps.clear();
    maps.emplace(key, *map);
  }
  return rc;
}

// The launch of qgemm_tma_kernel over `blocks` (x: ks per cluster, y:
// weight tiles) with `smem` bytes, in clusters of ks along x (ks = 1: no
// cluster launch, each block its own cluster)
struct QLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  QLaunch(dim3 blocks, int smem, int ks, cudaStream_t s) {
    cfg.gridDim = blocks;
    cfg.blockDim = dim3(kQTmaThreads, 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(ks);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = ks > 1 ? 1 : 0;
  }
};

template <int BN, int P>
int launch_qgemm_tma(const CUtensorMap& tw, const CUtensorMap& tx, const float* scale, float* y,
                     int m, int n, int k, int part_rows, int ks, cudaStream_t s) {
  using C = QTma<BN, P>;
  static std::atomic<uint64_t> attr_set{0};
  const int rc = set_smem(qgemm_tma_kernel<BN, P>, C::kSmem, attr_set);
  if (rc != 0) return rc;
  QLaunch q(dim3(static_cast<unsigned>(ks * ((m + BN - 1) / BN)),
                 static_cast<unsigned>((n + kQBM - 1) / kQBM), 1),
            C::kSmem, ks, s);
  const cudaError_t e =
      cudaLaunchKernelEx(&q.cfg, qgemm_tma_kernel<BN, P>, tw, tx, scale, y, m, n, k, part_rows);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// the blocks of clusters of ks that the card holds at once, 0 on an error
template <int BN, int P>
int qgemm_tma_slots(int ks) {
  using C = QTma<BN, P>;
  static std::atomic<uint64_t> attr_set{0};
  if (set_smem(qgemm_tma_kernel<BN, P>, C::kSmem, attr_set) != 0) return 0;
  QLaunch q(dim3(static_cast<unsigned>(ks), 1, 1), C::kSmem, ks, nullptr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, qgemm_tma_kernel<BN, P>, &q.cfg) != cudaSuccess) {
    return 0;
  }
  return clusters * ks;
}

// f(std::integral_constant<int, bn>) for bn in 8, 16, ..., 128; `other` else
template <class F>
int with_bn(int bn, int other, const F& f) {
  switch (bn) {
    case 8: return f(std::integral_constant<int, 8>());
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    default: return other;
  }
}

// y = x w^T on the TMA path: x bf16 (row pitch ldx elements), or f32 split
// first into `parts` (3 m k bf16, the caller's workspace).  Needs k % 16 ==
// 0, w8, x (bf16) or parts (f32) 16-byte aligned, bf16 x's pitch a multiple
// of 16 bytes, BN in {8, ..., 128}, 1 <= ks <= kQMaxSplit.
constexpr int kBadBn = static_cast<int>(cudaErrorInvalidValue);

static int quant_gemm_tma(const void* x, const void* w8, const float* scale, float* y,
                          void* parts, int m, int n, int k, int64_t ldx, int bn, int ks,
                          int dtype, cudaStream_t s) {
  const bool f32 = dtype == kF32;
  if ((dtype != kBF16 && !f32) || k <= 0 || k % 16 != 0 || !aligned16(w8) || ks < 1 ||
      ks > kQMaxSplit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tw, tx;
  int rc = qgemm_map_cached(&tw, w8, n, k, k, kQBM, true);
  if (rc != 0) return rc;
  if (f32) {
    if (parts == nullptr || !aligned16(parts)) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t mk = static_cast<int64_t>(m) * k;
    qgemm_split_x<<<static_cast<unsigned>((mk + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<bf16*>(parts), m, k, ldx);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    rc = qgemm_map_cached(&tx, parts, 3 * m, k, static_cast<int64_t>(k) * 2, bn, false);
    if (rc != 0) return rc;
    return with_bn(bn, kBadBn, [&](auto b) {
      return launch_qgemm_tma<decltype(b)::value, 3>(tw, tx, scale, y, m, n, k, m, ks, s);
    });
  }
  if (!aligned16(x) || (ldx * 2) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  rc = qgemm_map_cached(&tx, x, m, k, ldx * 2, bn, false);
  if (rc != 0) return rc;
  return with_bn(bn, kBadBn, [&](auto b) {
    return launch_qgemm_tma<decltype(b)::value, 1>(tw, tx, scale, y, m, n, k, m, ks, s);
  });
}

// the kernel codes of ops/quant_gemm.py's plan (QGEMM_KERNELS)
enum QKernel : int { kQTma = 0, kQRows16 = 1, kQTiles = 2, kQFma = 3 };


}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// x: (m, k) with row stride ldx and a contiguous last dim; w8: (n, k) int8
// contiguous; scale: (n,) f32; y: (m, n) f32 contiguous; parts: the (3, m,
// k) bf16 workspace of f32 x on the TMA path (else null).  kernel, bn, ks:
// the plan ops/quant_gemm.py's qgemm_plan made for this shape (QKernel;
// the TMA path's tokens per block and k-split cluster size).  One call is
// one counted launch: the f32 split pass rides with its GEMM.
extern "C" int apex_quant_gemm(const void* x, const void* w8, const void* scale, void* y,
                               void* parts, int m, int n, int k, int64_t ldx, int kernel, int bn,
                               int ks, int dtype, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* out = static_cast<float*>(y);
  const int esize = dtype == kF32 ? 4 : 2;
  // the mma.sync and FMA kernels take 16-byte loads where the operands allow
  const int vec_x = aligned16(x) && (ldx * esize) % 16 == 0 ? 1 : 0;
  const int vec_w = aligned16(w8) && k % 16 == 0 ? 1 : 0;
  switch (kernel) {
    case kQTma:
      return quant_gemm_tma(x, w8, sc, out, parts, m, n, k, ldx, bn, ks, dtype, s);
    case kQRows16:
      if (dtype != kBF16 || m > 16) return static_cast<int>(cudaErrorInvalidValue);
      qgemm_bf16_rows16<<<(n + 7) / 8, kQThreads, 0, s>>>(
          static_cast<const bf16*>(x), static_cast<const int8_t*>(w8), sc, out, m, n, k, ldx,
          vec_x, vec_w);
      break;
    case kQTiles: {
      if (dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
      const dim3 grid((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM);
      qgemm_bf16_tiles<<<grid, kQThreads, 0, s>>>(static_cast<const bf16*>(x),
                                                  static_cast<const int8_t*>(w8), sc, out, m, n,
                                                  k, ldx, vec_x, vec_w);
      break;
    }
    case kQFma:
      if (dtype == kF32) {
        launch_fma<float>(x, w8, scale, y, m, n, k, ldx, s);
      } else if (dtype == kF16) {
        launch_fma<__half>(x, w8, scale, y, m, n, k, ldx, s);
      } else {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The blocks of qgemm_tma_kernel<bn, parts> in k-split clusters of ks that
// the card holds at once (ops/quant_gemm.py's plan keeps a split within
// them: clusters that do not fit wait for a second wave); 0 on an error.
extern "C" int apex_quant_gemm_slots(int bn, int parts, int ks) {
  if (ks < 1 || ks > kQMaxSplit) return 0;
  return with_bn(bn, 0, [&](auto b) {
    return parts == 3 ? qgemm_tma_slots<decltype(b)::value, 3>(ks)
                      : qgemm_tma_slots<decltype(b)::value, 1>(ks);
  });
}
