// LayerNorm / RMSNorm backward for Hopper.
//
// Replaces apex_tpu/ops/layer_norm.py `_bwd_kernel` (launched by
// `_pallas_bwd`), and the cross-block sum of its dgamma/dbeta partials
// (`jnp.sum` over the partials there).  What bounds it on the H100: bytes.
// Per element it reads dy and the saved residual (x, or y under
// memory_efficient) and writes dx, a few FMAs per byte, far below the ~295
// operations per byte where the tensor cores would be the limit; at 8192 x
// 1024 bf16 that is ~50 MB, ~15 us at 3.35 TB/s.  Design: one block of 256
// threads per tile of rows_per_block rows.  Per row, the block sums
// gamma*dy*xhat and gamma*dy with warp shuffles and one pass over the
// warps' partials in shared memory (double-buffered by row parity, so one
// __syncthreads per row), then a second pass over the row (an L1/L2 hit)
// writes dx in the input dtype.  xhat is rebuilt from x and the saved
// mean/rstd, or from y as (y - beta) / gamma with a zero-gamma guard, or as
// x * rstd for RMS.  Thread t owns columns t, t + 256, ... of the block's
// f32 dgamma/dbeta partial row in shared memory, so the partials need no
// atomics; a second small kernel sums the (n_blocks, hidden) partials over
// blocks in a fixed order, so a run repeats bit for bit.  The TPU's
// 8-sublane partial rows and 128-lane padding are not carried over.

#include "common.cuh"

namespace apex_tpu_torch {

constexpr int kLnBwdThreads = 256;
constexpr int kLnBwdWarps = kLnBwdThreads / 32;
constexpr int kLnReduceThreads = 256;

template <typename T>
__device__ __forceinline__ float ln_xhat(const T* res, const float* w, const float* b, int i,
                                         float mean, float rstd, int rms, int from_y) {
  const float r = to_f32(res[i]);
  if (from_y) {
    const float y = b != nullptr ? r - b[i] : r;
    return y / (w[i] == 0.f ? 1.f : w[i]);
  }
  return rms ? r * rstd : (r - mean) * rstd;
}

template <typename T>
__global__ void __launch_bounds__(kLnBwdThreads)
layer_norm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ res,
                      const float* __restrict__ w, const float* __restrict__ b,
                      const float* __restrict__ mean, const float* __restrict__ rstd,
                      T* __restrict__ dx, float* __restrict__ dw_part,
                      float* __restrict__ db_part, int64_t rows, int hidden, int rows_per_block,
                      int rms, int from_y) {
  extern __shared__ float part[];  // [hidden] dgamma, then [hidden] dbeta of this block
  __shared__ float red_a[2][kLnBwdWarps];
  __shared__ float red_c[2][kLnBwdWarps];
  float* dw_s = part;
  float* db_s = part + hidden;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < hidden; i += kLnBwdThreads) dw_s[i] = db_s[i] = 0.f;

  const float inv_h = 1.f / static_cast<float>(hidden);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r1 = min(rows, r0 + rows_per_block);
  for (int64_t row = r0; row < r1; ++row) {
    const int buf = static_cast<int>(row & 1);
    const T* dyr = dy + row * hidden;
    const T* resr = res + row * hidden;
    const float rs = rstd[row];
    const float mu = rms ? 0.f : mean[row];
    float a = 0.f, c = 0.f;
    for (int i = threadIdx.x; i < hidden; i += kLnBwdThreads) {
      const float g = to_f32(dyr[i]);
      const float xh = ln_xhat(resr, w, b, i, mu, rs, rms, from_y);
      const float wdy = g * w[i];
      a += wdy * xh;
      c += wdy;
      dw_s[i] += g * xh;  // column i belongs to this thread alone
      db_s[i] += g;
    }
    a = warp_sum(a);
    c = warp_sum(c);
    if (lane == 0) {
      red_a[buf][warp] = a;
      red_c[buf][warp] = c;
    }
    __syncthreads();
    a = 0.f;
    c = 0.f;
#pragma unroll
    for (int k = 0; k < kLnBwdWarps; ++k) {
      a += red_a[buf][k];
      c += red_c[buf][k];
    }
    const float c1 = a * inv_h;
    const float c2 = c * inv_h;
    T* dxr = dx + row * hidden;
    for (int i = threadIdx.x; i < hidden; i += kLnBwdThreads) {
      const float wdy = to_f32(dyr[i]) * w[i];
      const float xh = ln_xhat(resr, w, b, i, mu, rs, rms, from_y);
      const float d = rms ? (wdy - xh * c1) * rs : (wdy - xh * c1 - c2) * rs;
      dxr[i] = from_f32<T>(d);
    }
  }
  for (int i = threadIdx.x; i < hidden; i += kLnBwdThreads) {
    dw_part[static_cast<int64_t>(blockIdx.x) * hidden + i] = dw_s[i];
    db_part[static_cast<int64_t>(blockIdx.x) * hidden + i] = db_s[i];
  }
}

// sums[j] = sum over blocks p (in order) of parts[p][j], for 2*hidden
// columns laid out as parts = (2, n_parts, hidden), sums = (2, hidden)
__global__ void __launch_bounds__(kLnReduceThreads)
layer_norm_bwd_reduce_kernel(const float* __restrict__ parts, float* __restrict__ sums,
                             int n_parts, int hidden) {
  const int j = blockIdx.x * kLnReduceThreads + threadIdx.x;
  if (j >= 2 * hidden) return;
  const int which = j / hidden;
  const int col = j - which * hidden;
  const float* src = parts + static_cast<int64_t>(which) * n_parts * hidden + col;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += src[static_cast<int64_t>(p) * hidden];
  sums[j] = s;
}

template <typename T>
static int launch_layer_norm_bwd(const void* dy, const void* res, const void* w, const void* b,
                                 const void* mean, const void* rstd, void* dx, void* parts,
                                 void* sums, int64_t rows, int hidden, int rows_per_block,
                                 int rms, int from_y, cudaStream_t stream) {
  const int64_t n_parts = (rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = 2 * static_cast<size_t>(hidden) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        layer_norm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  float* dw_part = static_cast<float*>(parts);
  float* db_part = dw_part + n_parts * hidden;
  layer_norm_bwd_kernel<T><<<static_cast<unsigned>(n_parts), kLnBwdThreads, smem, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(res), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<T*>(dx), dw_part, db_part, rows, hidden,
      rows_per_block, rms, from_y);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned reduce_blocks = (2 * hidden + kLnReduceThreads - 1) / kLnReduceThreads;
  layer_norm_bwd_reduce_kernel<<<reduce_blocks, kLnReduceThreads, 0, stream>>>(
      static_cast<const float*>(parts), static_cast<float*>(sums), static_cast<int>(n_parts),
      hidden);
  return 0;
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// dy, res, dx: (rows, hidden) contiguous of `dtype` (res is x, or y when
// from_y); w: (hidden,) f32; b: (hidden,) f32 or null (read only when
// from_y); mean, rstd: (rows,) f32; parts: (2, ceil(rows / rows_per_block),
// hidden) f32 scratch; sums: (2, hidden) f32, dgamma then dbeta.  Returns
// cudaGetLastError() after the two launches.
extern "C" int apex_layer_norm_bwd(const void* dy, const void* res, const void* w, const void* b,
                                   const void* mean, const void* rstd, void* dx, void* parts,
                                   void* sums, int64_t rows, int hidden, int rows_per_block,
                                   int rms, int from_y, int dtype, void* stream) {
  if (rows <= 0 || hidden <= 0 || rows_per_block <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case kF32:
      rc = launch_layer_norm_bwd<float>(dy, res, w, b, mean, rstd, dx, parts, sums, rows, hidden,
                                        rows_per_block, rms, from_y, st);
      break;
    case kBF16:
      rc = launch_layer_norm_bwd<__nv_bfloat16>(dy, res, w, b, mean, rstd, dx, parts, sums, rows,
                                                hidden, rows_per_block, rms, from_y, st);
      break;
    case kF16:
      rc = launch_layer_norm_bwd<__half>(dy, res, w, b, mean, rstd, dx, parts, sums, rows,
                                         hidden, rows_per_block, rms, from_y, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
