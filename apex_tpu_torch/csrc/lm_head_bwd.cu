// Fused LM-head backward for Hopper: dX = dS W and dW = dS^T X with
// dS = (exp(x W^T - lse) - onehot(target)) g recomputed tile by tile, so
// neither the logits nor their gradient reach device memory.
//
// Replaces apex_tpu/ops/lm_head.py `_dx_kernel` and `_dw_kernel` (launched
// by `_bwd_impl`).  What bounds them on the H100: operations.  Each is
// 4 N V H flops (the score product again, then the gradient product): 1.69
// TFLOP per call at GPT-350M.  Design (lm_head.cuh): both run their two
// products on the tensor cores (ldmatrix fragments, mma.sync m16n8k16 bf16 x
// bf16 with f32 accumulation).
// dS is computed in f32 from the f32 scores and rounded to bf16 before the
// second product, where the TPU kernel casts it to the operand dtype for
// its MXU dot.
//
// dX: a block owns 32 token rows (X resident) and walks the vocab in tiles
// of 64 rows of W; each W tile serves both products (scores, then dS W), and
// the block's (32, H) f32 dX accumulator lives in registers (each warp 32
// rows x 128 columns, 32 mma tiles) in a fixed order over the vocab — the
// TPU kernel keeps a (256, H) f32 accumulator in VMEM, 1 MB, which no SM
// has.  The cost of the small token tile: each of the 256 blocks (at 8192
// tokens) reads all of W, 256 x 103 MB = 26 GB at GPT-350M, 7.9 ms if it all
// came from device memory, above the 1.7 ms bound; the blocks in flight walk
// the same W tiles in the same order, so most of it hits in L2.
//
// dW: a block owns 32 vocab rows (W resident) and walks the tokens in tiles
// of 64 rows of X, accumulating its (32, H) f32 rows of dW in registers.
// Each row of dW is written by one block: no atomics, deterministic.  X
// (16.8 MB bf16 at GPT-350M) stays in L2 for the 1572 blocks.  Token rows
// past N carry dS = 0, as the TPU kernel zeroes its padded rows.
//
// Other dtypes take the f32 instantiation on the FMA units, one kernel for
// dX and dW on the same 32-row resident / 64-row streamed tiles, with f32
// operands staged in shared memory in hidden chunks and slabs
// (lm_head_bwd_fma_kernel below).

#include "lm_head.cuh"

namespace apex_tpu_torch {
namespace lm_head {

using Acc = float[2][kAccTiles][4];

// acc (32 x kHMax, warp w owning columns [128 w, 128 w + 128)) += A B over
// one streamed tile: A is 32 x 64 bf16 dS, stored row-major (dX: token rows,
// vocab contiguous) or, with kATrans, as its transpose (dW: dS^T read from
// the token-major dS); B is the streamed tile, 64 rows (the k axis) of h
// columns (row stride ld).
template <bool kATrans>
__device__ __forceinline__ void accumulate_product(Acc& acc, const bf16* a, int lda,
                                                   const bf16* b, int ld, int hp) {
  const int col0 = (threadIdx.x >> 5) * kColsPerWarp;
  if (col0 >= hp) return;
#pragma unroll
  for (int kk = 0; kk < kStr / 16; ++kk) {
    unsigned fa[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kATrans) {
        load_a_t(fa[i], a, lda, kk * 16, i * 16);
      } else {
        load_a(fa[i], a, lda, i * 16, kk * 16);
      }
    }
#pragma unroll
    for (int j = 0; j < kAccTiles / 2; ++j) {
      const int col = col0 + j * 16;
      if (col < hp) {
        unsigned fb[4];
        load_b_t(fb, b, ld, kk * 16, col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * j], fa[i], fb[0], fb[1]);
          mma_bf16(acc[i][2 * j + 1], fa[i], fb[2], fb[3]);
        }
      }
    }
  }
}

// write the (32, h) accumulator as rows [row0, row0 + 32) of out (rows past
// n_rows dropped), two bf16 per store, straight from the registers
__device__ __forceinline__ void store_acc(const Acc& acc, int h, bf16* out, int row0,
                                          int n_rows) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = (threadIdx.x >> 5) * kColsPerWarp;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < kAccTiles; ++j) {
      const int col = col0 + j * 8 + 2 * t;  // h is a multiple of 8: col + 1 < h too
      if (col >= h) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + i * 16 + g + 8 * half;
        if (row < n_rows) {
          *reinterpret_cast<__nv_bfloat162*>(out + static_cast<int64_t>(row) * h + col) =
              __floats2bfloat162_rn(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
lm_head_dx_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const int* __restrict__ targets, const float* __restrict__ lse,
                      const float* __restrict__ g, bf16* __restrict__ dx, int n, int v, int h) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ld = tile_ld(h);
  const int hp = padded_h(h);
  const Smem sm = carve(smem_raw, ld);
  const int t0 = blockIdx.x * kRes;

  load_rows(sm.res, ld, x, t0, n, kRes, h, 0, hp);
  cp_async_commit();
  if (threadIdx.x < kRes) {
    const int tok = t0 + threadIdx.x;
    const bool in = tok < n;
    sm.lse[threadIdx.x] = in ? lse[tok] : 0.f;
    sm.g[threadIdx.x] = in ? g[tok] : 0.f;
    sm.tgt[threadIdx.x] = in ? targets[tok] : -1;
  }

  Acc acc = {};
  const int n_tiles = (v + kStr - 1) / kStr;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int v0 = tile * kStr;
    __syncthreads();  // the previous tile's W and dS are consumed
    load_tile_chunked(sm.str, ld, w, v0, v, h);
    score_tile<kRes, kStr>(sm.res, sm.str, ld, h, sm.score, kLdS);
    __syncthreads();
    // dS (32 tokens x 64 vocab): 8 entries per thread, f32, rounded to bf16
    {
      const int r = threadIdx.x >> 3;
      const int c0 = (threadIdx.x & 7) * 8;
      const float row_lse = sm.lse[r], row_g = sm.g[r];
      const int row_t = sm.tgt[r];
#pragma unroll
      for (int c = c0; c < c0 + 8; ++c) {
        const int col = v0 + c;
        float ds = 0.f;
        if (col < v) {
          const float p = expf(sm.score[r * kLdS + c] - row_lse);
          ds = (p - (col == row_t ? 1.f : 0.f)) * row_g;
        }
        sm.ds[r * kLdD + c] = __float2bfloat16(ds);
      }
    }
    __syncthreads();
    accumulate_product<false>(acc, sm.ds, kLdD, sm.str, ld, hp);
  }
  store_acc(acc, h, dx, t0, n);
}

__global__ void __launch_bounds__(kThreads)
lm_head_dw_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const int* __restrict__ targets, const float* __restrict__ lse,
                      const float* __restrict__ g, bf16* __restrict__ dw, int n, int v, int h) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ld = tile_ld(h);
  const int hp = padded_h(h);
  const Smem sm = carve(smem_raw, ld);
  const int v0 = blockIdx.x * kRes;

  load_rows(sm.res, ld, w, v0, v, kRes, h, 0, hp);
  cp_async_commit();

  Acc acc = {};
  const int n_tiles = (n + kStr - 1) / kStr;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kStr;
    __syncthreads();  // the previous tile's X, dS and row statistics are consumed
    load_tile_chunked(sm.str, ld, x, t0, n, h);
    if (threadIdx.x < kStr) {
      const int tok = t0 + threadIdx.x;
      const bool in = tok < n;
      sm.lse[threadIdx.x] = in ? lse[tok] : 0.f;
      sm.g[threadIdx.x] = in ? g[tok] : 0.f;
      sm.tgt[threadIdx.x] = in ? targets[tok] : -1;
    }
    score_tile<kStr, kRes>(sm.str, sm.res, ld, h, sm.score, kLdSt);
    __syncthreads();
    // dS (64 tokens x 32 vocab): 8 entries per thread; token rows past n are 0
    {
      const int r = threadIdx.x >> 2;
      const int c0 = (threadIdx.x & 3) * 8;
      const float row_lse = sm.lse[r], row_g = sm.g[r];
      const int row_t = sm.tgt[r];
      const bool row_in = t0 + r < n;
#pragma unroll
      for (int c = c0; c < c0 + 8; ++c) {
        const int col = v0 + c;
        float ds = 0.f;
        if (row_in && col < v) {
          const float p = expf(sm.score[r * kLdSt + c] - row_lse);
          ds = (p - (col == row_t ? 1.f : 0.f)) * row_g;
        }
        sm.ds[r * kLdDt + c] = __float2bfloat16(ds);
      }
    }
    __syncthreads();
    // dW rows (32 vocab) += dS^T (32 x 64 tokens) X (64 x h): dS^T is dS
    // read column-major
    accumulate_product<true>(acc, sm.ds, kLdDt, sm.str, ld, hp);
  }
  store_acc(acc, h, dw, v0, v);
}

// f32 instantiation, dX (kDW false) and dW (kDW true) in one kernel: the
// block's resident rows R (kRes token rows for dX, vocab rows for dW) and
// the streamed tiles T (kStr vocab rows of W for dX, token rows of X for
// dW).  Per tile: S = R T^T (score_tile_f32), dS in f32 in place (not
// rounded: the reference's math), then out[R, cols] += dS T[:, cols] for
// the block's kHc output columns, T staged in slabs of kKr rows.  Warp w
// owns output rows 4 w .. 4 w + 3, lane l the float4 columns 4 l + 128 j,
// j < 8: 128 f32 accumulators per thread, summed over the streamed rows in
// ascending order.
template <bool kDW>
__global__ void __launch_bounds__(kThreads)
lm_head_bwd_fma_kernel(const void* __restrict__ x, int cx, const void* __restrict__ w, int cw,
                       const int* __restrict__ targets, const float* __restrict__ lse,
                       const float* __restrict__ g, void* __restrict__ out, int n, int v,
                       int h) {
  __shared__ __align__(16) SmemF sm;
  const void* res = kDW ? w : x;
  const void* str = kDW ? x : w;
  const int cres = kDW ? cw : cx, cstr = kDW ? cx : cw;
  const int n_res = kDW ? v : n, n_str = kDW ? n : v;
  const int r0 = blockIdx.x * kRes;
  const int hc0 = blockIdx.y * kHc;
  const int hcn = min(kHc, h - hc0);
  const int width = (hcn + 3) / 4 * 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (!kDW && threadIdx.x < kRes) {  // dX: the resident token rows' statistics
    const int tok = r0 + threadIdx.x;
    sm.lse[threadIdx.x] = tok < n ? lse[tok] : 0.f;
    sm.g[threadIdx.x] = tok < n ? g[tok] : 0.f;
    sm.tgt[threadIdx.x] = tok < n ? targets[tok] : -1;
  }
  float acc[kFwdRowsPerWarp][kHcLane][4] = {};
  const int n_tiles = (n_str + kStr - 1) / kStr;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s0 = tile * kStr;
    if (kDW && threadIdx.x < kStr) {  // dW: the streamed token rows' statistics
      const int tok = s0 + threadIdx.x;
      sm.lse[threadIdx.x] = tok < n ? lse[tok] : 0.f;
      sm.g[threadIdx.x] = tok < n ? g[tok] : 0.f;
      sm.tgt[threadIdx.x] = tok < n ? targets[tok] : -1;
    }
    score_tile_f32(sm, res, cres, r0, n_res, str, cstr, s0, n_str, h);
    __syncthreads();
    {  // dS (kRes x kStr), 8 entries per thread; a row or column past its
       // operand is 0 (and so is a token row of g = 0)
      const int r = threadIdx.x >> 3;
      const int c0 = (threadIdx.x & 7) * 8;
#pragma unroll
      for (int c = c0; c < c0 + 8; ++c) {
        const int tr = kDW ? c : r;                  // token index in the tile's stats
        const int tok = kDW ? s0 + c : r0 + r;
        const int col = kDW ? r0 + r : s0 + c;       // vocab row
        float ds = 0.f;
        if (tok < n && col < v) {
          const float p = expf(sm.score[r * kLdS + c] - sm.lse[tr]);
          ds = (p - (col == sm.tgt[tr] ? 1.f : 0.f)) * sm.g[tr];
        }
        sm.score[r * kLdS + c] = ds;
      }
    }
    for (int k0 = 0; k0 < kStr; k0 += kKr) {
      __syncthreads();  // dS written; the previous slab (or score chunk) consumed
      for (int i = threadIdx.x; i < kKr * width; i += kThreads) {
        const int kr = i / width, c = i - kr * width;
        const int row = s0 + k0 + kr;
        sm.u.slab[kr * kHc + c] =
            row < n_str && c < hcn
                ? load_f(str, cstr, static_cast<int64_t>(row) * h + hc0 + c)
                : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kr = 0; kr < kKr; ++kr) {
        float d[kFwdRowsPerWarp];
#pragma unroll
        for (int i = 0; i < kFwdRowsPerWarp; ++i) {
          d[i] = sm.score[(warp * kFwdRowsPerWarp + i) * kLdS + k0 + kr];
        }
#pragma unroll
        for (int j = 0; j < kHcLane; ++j) {
          const int c = 4 * lane + 128 * j;
          if (c < width) {
            const float4 t = *reinterpret_cast<const float4*>(&sm.u.slab[kr * kHc + c]);
#pragma unroll
            for (int i = 0; i < kFwdRowsPerWarp; ++i) {
              acc[i][j][0] = fmaf(d[i], t.x, acc[i][j][0]);
              acc[i][j][1] = fmaf(d[i], t.y, acc[i][j][1]);
              acc[i][j][2] = fmaf(d[i], t.z, acc[i][j][2]);
              acc[i][j][3] = fmaf(d[i], t.w, acc[i][j][3]);
            }
          }
        }
      }
    }
  }
  const int cout = kDW ? cw : cx;
#pragma unroll
  for (int i = 0; i < kFwdRowsPerWarp; ++i) {
    const int row = r0 + warp * kFwdRowsPerWarp + i;
    if (row >= n_res) continue;
#pragma unroll
    for (int j = 0; j < kHcLane; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = 4 * lane + 128 * j + q;
        if (c < hcn) store_f(out, cout, static_cast<int64_t>(row) * h + hc0 + c, acc[i][j][q]);
      }
    }
  }
}

}  // namespace lm_head
}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;
using namespace apex_tpu_torch::lm_head;

// x: (n, h), w: (v, h) row-major in their dtypes; targets: (n,) int32;
// lse, g: (n,) f32; dx: (n, h) in x's dtype.  A bf16 pair takes the
// tensor-core kernel (h a multiple of 8, at most 1024), any other pair the
// f32 kernel.
extern "C" int apex_lm_head_dx(const void* x, const void* w, const void* targets,
                               const void* lse, const void* g, void* dx, int n, int v, int h,
                               int x_dtype, int w_dtype, void* stream) {
  if (n <= 0 || h <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kBF16 && w_dtype == kBF16) {
    if (h % 8 != 0 || h > kHMax) return static_cast<int>(cudaErrorInvalidValue);
    static bool attr_set = false;
    const int rc = set_smem(lm_head_dx_mma_kernel, attr_set);
    if (rc != 0) return rc;
    lm_head_dx_mma_kernel<<<(n + kRes - 1) / kRes, kThreads, smem_bytes(h), s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const int*>(targets), static_cast<const float*>(lse),
        static_cast<const float*>(g), static_cast<bf16*>(dx), n, v, h);
  } else {
    const dim3 grid(static_cast<unsigned>((n + kRes - 1) / kRes),
                    static_cast<unsigned>((h + kHc - 1) / kHc));
    lm_head_bwd_fma_kernel<false><<<grid, kThreads, 0, s>>>(
        x, x_dtype, w, w_dtype, static_cast<const int*>(targets),
        static_cast<const float*>(lse), static_cast<const float*>(g), dx, n, v, h);
  }
  return static_cast<int>(cudaGetLastError());
}

// as apex_lm_head_dx; dw: (v, h) in w's dtype
extern "C" int apex_lm_head_dw(const void* x, const void* w, const void* targets,
                               const void* lse, const void* g, void* dw, int n, int v, int h,
                               int x_dtype, int w_dtype, void* stream) {
  if (v <= 0 || h <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kBF16 && w_dtype == kBF16) {
    if (h % 8 != 0 || h > kHMax) return static_cast<int>(cudaErrorInvalidValue);
    static bool attr_set = false;
    const int rc = set_smem(lm_head_dw_mma_kernel, attr_set);
    if (rc != 0) return rc;
    lm_head_dw_mma_kernel<<<(v + kRes - 1) / kRes, kThreads, smem_bytes(h), s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const int*>(targets), static_cast<const float*>(lse),
        static_cast<const float*>(g), static_cast<bf16*>(dw), n, v, h);
  } else {
    const dim3 grid(static_cast<unsigned>((v + kRes - 1) / kRes),
                    static_cast<unsigned>((h + kHc - 1) / kHc));
    lm_head_bwd_fma_kernel<true><<<grid, kThreads, 0, s>>>(
        x, x_dtype, w, w_dtype, static_cast<const int*>(targets),
        static_cast<const float*>(lse), static_cast<const float*>(g), dw, n, v, h);
  }
  return static_cast<int>(cudaGetLastError());
}
