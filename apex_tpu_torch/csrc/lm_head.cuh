// Shared pieces of the fused LM-head kernels (lm_head_fwd.cu, lm_head_bwd.cu):
// tiles staged with cp.async, fragments loaded with ldmatrix, the bf16 score
// tile S = X W^T on the tensor cores (mma.sync m16n8k16, f32 accumulation),
// the same score tile on the FMA units for the f32 instantiation, the
// forward's online row state and its split of the vocab.
//
// Layout of the bf16 path.  A block of 8 warps keeps a resident operand of
// kRes = 32 rows (token rows of X for the forward and dX, vocab rows of W
// for dW) and streams tiles of kStr = 64 rows of the other operand, each
// row the whole hidden axis (at most kHMax = 1024) in shared memory with a
// pad of 8 elements (row stride ld = round_up(H, 16) + 8: the eight 16-byte
// rows of an ldmatrix fall in eight different bank groups).  A
// streamed tile arrives as kChunks cp.async groups of kChunk columns, and
// the score product waits for each group just before its columns, so the
// load of a tile overlaps its first products.
#pragma once

#include "mma.cuh"

namespace apex_tpu_torch {
namespace lm_head {

constexpr int kThreads = 256;        // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRes = 32;             // rows of the resident operand
constexpr int kStr = 64;             // rows of a streamed tile
constexpr int kHMax = 1024;          // hidden sizes the bf16 kernels take
constexpr int kChunk = 256;          // columns per cp.async group
constexpr int kChunks = kHMax / kChunk;
constexpr int kColsPerWarp = kHMax / kWarps;  // accumulator columns of a warp
constexpr int kAccTiles = kColsPerWarp / 8;   // 16 mma n8 tiles per 16 rows
constexpr int kLdS = kStr + 4;       // f32 scores (32 x 64) row stride
constexpr int kLdSt = kRes + 4;      // f32 scores (64 x 32) row stride
constexpr int kLdD = kStr + 8;       // bf16 dS (32 x 64) row stride
constexpr int kLdDt = kRes + 8;      // bf16 dS (64 x 32) row stride
constexpr int kScoreBytes = kStr * kLdSt * 4;   // >= kRes * kLdS * 4
constexpr int kDsBytes = kStr * kLdDt * 2;      // >= kRes * kLdD * 2
constexpr int kRowBytes = 3 * kStr * 4;         // lse, g, target per row

__host__ __device__ inline int padded_h(int h) { return (h + 15) / 16 * 16; }
__host__ __device__ inline int tile_ld(int h) { return padded_h(h) + 8; }

// dynamic shared memory of a bf16 block: resident + streamed operand, the
// f32 scores, the bf16 dS and the per-row statistics
inline size_t smem_bytes(int h) {
  return static_cast<size_t>(kRes + kStr) * tile_ld(h) * sizeof(bf16) + kScoreBytes +
         kDsBytes + kRowBytes;
}

// Allow a bf16 kernel the dynamic shared memory of the largest hidden size
// (once per kernel: `done` is the caller's flag); returns a cudaError_t.
template <typename Kernel>
int set_smem(Kernel kernel, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem_bytes(kHMax)));
  if (e != cudaSuccess) return static_cast<int>(e);
  done = true;
  return 0;
}

struct Smem {
  bf16* res;     // kRes x ld
  bf16* str;     // kStr x ld
  float* score;  // f32 scores
  bf16* ds;      // bf16 dS
  float* lse;    // per streamed/resident row
  float* g;
  int* tgt;
};

__device__ inline Smem carve(unsigned char* base, int ld) {
  Smem s;
  s.res = reinterpret_cast<bf16*>(base);
  s.str = s.res + kRes * ld;
  s.score = reinterpret_cast<float*>(s.str + kStr * ld);
  s.ds = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(s.score) + kScoreBytes);
  s.lse = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(s.ds) + kDsBytes);
  s.g = s.lse + kStr;
  s.tgt = reinterpret_cast<int*>(s.g + kStr);
  return s;
}

// Issue the copy of rows [row0, row0 + rows) and columns [c_lo, c_hi) of a
// row-major (n_rows, h) bf16 matrix into dst (row stride ld).  Rows past
// n_rows and columns past h are zero-filled (src-size 0); h is a multiple
// of 8, so a 16-byte vector is either all in or all out.
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, int row0,
                                          int n_rows, int rows, int h, int c_lo, int c_hi) {
  const int vecs = (c_hi - c_lo) / 8;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = c_lo + (i - r * vecs) * 8;
    const bool ok = row0 + r < n_rows && c < h;
    const bf16* from = ok ? src + static_cast<int64_t>(row0 + r) * h + c : src;
    cp_async16(dst + r * ld + c, from, ok ? 16 : 0);
  }
}

// A whole streamed tile as kChunks commit groups (empty past round_up(h, 16)).
__device__ __forceinline__ void load_tile_chunked(bf16* dst, int ld, const bf16* src, int row0,
                                                  int n_rows, int h) {
  const int hp = padded_h(h);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int lo = c * kChunk;
    const int hi = min(lo + kChunk, hp);
    if (lo < hi) load_rows(dst, ld, src, row0, n_rows, kStr, h, lo, hi);
    cp_async_commit();
  }
}


// S = A B^T over the hidden axis into f32 scores (row stride lds), A with
// MA rows and B with MB rows, both row-major with the hidden axis
// contiguous; each warp owns one 16 x 16 block of S (MA * MB = 8 blocks).
// Waits for the streamed tile's cp.async groups chunk by chunk; every
// thread of the block must call it.  Even and odd k steps go to separate
// accumulators (four independent mma chains per warp), summed at the end.
template <int MA, int MB>
__device__ __forceinline__ void score_tile(const bf16* a, const bf16* b, int ld, int h,
                                           float* scores, int lds) {
  static_assert((MA / 16) * (MB / 16) == kWarps, "one score block per warp");
  const int warp = threadIdx.x >> 5;
  const int row0 = warp / (MB / 16) * 16;
  const int col0 = warp % (MB / 16) * 16;
  float acc[2][2][4] = {};
  const int hp = padded_h(h);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    cp_async_wait(kChunks - 1 - c);
    __syncthreads();
    const int hi = min((c + 1) * kChunk, hp);
    for (int k = c * kChunk; k < hi; k += 32) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (e == 1 && k + 16 >= hi) break;
        unsigned fa[4], fb[4];
        load_a(fa, a, ld, row0, k + 16 * e);
        load_b(fb, b, ld, col0, k + 16 * e);
        mma_bf16(acc[e][0], fa, fb[0], fb[1]);
        mma_bf16(acc[e][1], fa, fb[2], fb[3]);
      }
    }
  }
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    float* out = scores + (row0 + g) * lds + col0 + nt * 8 + 2 * t;
    *reinterpret_cast<float2*>(out) =
        make_float2(acc[0][nt][0] + acc[1][nt][0], acc[0][nt][1] + acc[1][nt][1]);
    *reinterpret_cast<float2*>(out + 8 * lds) =
        make_float2(acc[0][nt][2] + acc[1][nt][2], acc[0][nt][3] + acc[1][nt][3]);
  }
}

// The f32 instantiation (f32, f16 or a mixed pair: the reference's own math,
// f32 products on the FMA units) takes the same tiles as the bf16 path: a
// score tile of kRes resident rows x kStr streamed rows, but the hidden
// axis staged through shared memory in chunks of kKc columns (any H), and
// the gradient product's streamed rows in slabs of kKr rows x kHc columns.
// dX and dW blocks own kHc columns of their kRes output rows, so a hidden
// size above kHc splits over a second grid axis (the scores recomputed per
// column block).
constexpr int kKc = 32;          // hidden columns per staged chunk of the scores
constexpr int kLdRf = kRes + 1;  // k-major chunk of the resident rows (conflict-free stores)
constexpr int kLdSf = kStr + 4;  // k-major chunk of the streamed rows (float4 reads)
constexpr int kHc = 1024;        // output columns of an f32 dX / dW block
constexpr int kKr = 8;           // streamed rows per slab of the gradient product
constexpr int kHcLane = kHc / 32 / 4;  // float4 accumulator columns of a lane: 8

struct SmemF {
  union {
    struct {
      float res[kKc * kLdRf];
      float str[kKc * kLdSf];
    } chunk;
    float slab[kKr * kHc];
  } u;
  float score[kRes * kLdS];  // scores, then dS in place (kRes x kStr)
  float lse[kStr];           // per token row of the tile
  float g[kStr];
  int tgt[kStr];
};

// S = A B^T over the hidden axis into sm.score (row stride kLdS): A is kRes
// rows from row a0 of an (na, h) matrix, B kStr rows from row b0 of an
// (nb, h) matrix, any float dtype; rows past na / nb are zero.  Thread t
// sums rows 2 (t / 16) and 2 (t / 16) + 1, columns 4 (t % 16) .. + 3, over
// k in ascending order.  Every thread of the block must call it; it starts
// with a barrier, so the caller's reads of sm.score before it are safe.
__device__ __forceinline__ void score_tile_f32(SmemF& sm, const void* a, int ca, int a0, int na,
                                               const void* b, int cb, int b0, int nb, int h) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (threadIdx.x >> 4) * 2, c0 = (threadIdx.x & 15) * 4;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < max(h, 1); k0 += kKc) {  // h = 0: one chunk of zeros
    const int k = k0 + lane;
    __syncthreads();  // the previous chunk (or the caller's scores) consumed
    for (int r = warp; r < kRes; r += kWarps) {
      const bool ok = k < h && a0 + r < na;
      sm.u.chunk.res[lane * kLdRf + r] =
          ok ? load_f(a, ca, static_cast<int64_t>(a0 + r) * h + k) : 0.f;
    }
    for (int r = warp; r < kStr; r += kWarps) {
      const bool ok = k < h && b0 + r < nb;
      sm.u.chunk.str[lane * kLdSf + r] =
          ok ? load_f(b, cb, static_cast<int64_t>(b0 + r) * h + k) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKc; ++kk) {
      const float av[2] = {sm.u.chunk.res[kk * kLdRf + r0], sm.u.chunk.res[kk * kLdRf + r0 + 1]};
      const float4 bv = *reinterpret_cast<const float4*>(&sm.u.chunk.str[kk * kLdSf + c0]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[i][0] = fmaf(av[i], bv.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], bv.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], bv.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], bv.w, acc[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    *reinterpret_cast<float4*>(&sm.score[(r0 + i) * kLdS + c0]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// Forward row state shared by both instantiations: each warp carries the
// running max m, sum l and target logit of kRes / kWarps = 4 token rows of
// the block across the vocab tiles of its range.
constexpr int kFwdRowsPerWarp = kRes / kWarps;

struct FwdRows {
  float m[kFwdRowsPerWarp], l[kFwdRowsPerWarp], t[kFwdRowsPerWarp];
  int tgt[kFwdRowsPerWarp];

  __device__ __forceinline__ void init(const int* targets, int t0, int n) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int r = 0; r < kFwdRowsPerWarp; ++r) {
      const int tok = t0 + warp * kFwdRowsPerWarp + r;
      m[r] = kMask;
      l[r] = 0.f;
      t[r] = 0.f;
      tgt[r] = tok < n ? targets[tok] : -1;
    }
  }

  // fold one (kRes x kStr) f32 score tile (row stride kLdS) of vocab
  // columns [v0, v0 + kStr) into the rows; columns past v give p = 0
  __device__ __forceinline__ void update(const float* score, int v0, int v) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < kFwdRowsPerWarp; ++r) {
      const float* srow = score + (warp * kFwdRowsPerWarp + r) * kLdS;
      float s[2];
      bool valid[2];
      float tmax = kMask;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        valid[j] = v0 + lane + 32 * j < v;
        s[j] = valid[j] ? srow[lane + 32 * j] : kMask;
        tmax = fmaxf(tmax, s[j]);
      }
      const float m_new = fmaxf(warp_max(tmax), m[r]);
      const float alpha = expf(m[r] - m_new);
      float p = 0.f, hit = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (valid[j]) {
          p += expf(s[j] - m_new);
          if (v0 + lane + 32 * j == tgt[r]) hit += s[j];
        }
      }
      l[r] = alpha * l[r] + warp_sum(p);
      m[r] = m_new;
      t[r] += warp_sum(hit);
    }
  }

  // this split's partial (m, l, t) of each row into partials (3, splits, n)
  __device__ __forceinline__ void store(float* partials, int split, int splits, int t0,
                                        int n) const {
    if ((threadIdx.x & 31) != 0) return;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int r = 0; r < kFwdRowsPerWarp; ++r) {
      const int tok = t0 + warp * kFwdRowsPerWarp + r;
      if (tok >= n) continue;
      partials[(0 * static_cast<int64_t>(splits) + split) * n + tok] = m[r];
      partials[(1 * static_cast<int64_t>(splits) + split) * n + tok] = l[r];
      partials[(2 * static_cast<int64_t>(splits) + split) * n + tok] = t[r];
    }
  }
};

// Vocab ranges the forward splits each kRes-row tile into, so that about
// two blocks per SM are in flight: at least 1, at most the vocab tiles.
inline int fwd_splits(int n, int v, int sms) {
  const int tiles = (v + kStr - 1) / kStr;
  const int row_tiles = (n + kRes - 1) / kRes;
  const int want = (2 * sms + row_tiles - 1) / row_tiles;
  const int splits = want < tiles ? want : tiles;
  return splits < 1 ? 1 : splits;
}

}  // namespace lm_head
}  // namespace apex_tpu_torch
