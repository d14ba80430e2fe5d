// LayerNorm / RMSNorm forward for Hopper.
//
// Replaces apex_tpu/ops/layer_norm.py `_fwd_kernel` (launched by
// `_pallas_fwd`).  What bounds it on the H100: bytes.  A row of 1024 bf16
// values is read once from device memory and written once; the work per byte
// is a handful of FMAs, far below the ~295 operations per byte where the
// tensor cores would be the limit.  The math is the JAX kernel's: f32 sums
// of x and x*x, the E[x^2] - mean^2 form, rsqrt(var + eps), RMS with mean 0,
// an optional bias, y rounded to x's dtype, mean / rstd in f32.  None of the
// TPU's 128-lane padding or VMEM row budget is carried over.
//
// Two bodies; the wrapper picks one from hidden, the dtype and the
// alignment before the launch (`ops.layer_norm.layer_norm_fwd_path`):
//
// * Row per warp (`layer_norm_fwd_warp_kernel<T, NV>`): a row held in
//   registers, NV 16-byte vectors a lane (at most kLnMaxLaneElems
//   elements: hidden <= 1024 in every dtype), read once and written once
//   from the registers; each lane sums its vectors, then `warp_sum`
//   combines the lanes by shuffles alone (no shared memory, no barrier).
//   w and b are loaded (16 bytes at a time) once for all the rows a warp
//   walks; the grid is at most one wave of resident blocks, warps striding
//   over the rows.  Needs hidden a multiple of a vector and x, w, b on the
//   16-byte grid.
// * Block per row (`layer_norm_fwd_kernel<T>`), every other shape: f32
//   sums reduced with warp shuffles then across warps in shared memory,
//   then a second pass over the row (an L1/L2 hit) writes y.  It takes any
//   hidden size and alignment.

#include <algorithm>

#include "common.cuh"

namespace apex_tpu_torch {

constexpr int kLnThreads = 256;
constexpr int kLnWarps = 8;            // warps of a row-per-warp block
constexpr int kLnMaxLaneElems = 32;    // row elements a lane holds

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, T* __restrict__ y,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out,
                      int hidden, float eps, int rms) {
  __shared__ float red_s[32];
  __shared__ float red_ss[32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * hidden;
  T* yr = y + row * hidden;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    const float v = to_f32(xr[i]);
    s += v;
    ss += v * v;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    red_s[warp] = s;
    red_ss[warp] = ss;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    s = lane < n_warps ? red_s[lane] : 0.f;
    ss = lane < n_warps ? red_ss[lane] : 0.f;
    s = warp_sum(s);
    ss = warp_sum(ss);
    if (lane == 0) {
      red_s[0] = s;
      red_ss[0] = ss;
    }
  }
  __syncthreads();

  const float inv_h = 1.f / static_cast<float>(hidden);
  const float mean = rms ? 0.f : red_s[0] * inv_h;
  const float ms = red_ss[0] * inv_h;
  const float rstd = rsqrtf((rms ? ms : ms - mean * mean) + eps);
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    float v = (to_f32(xr[i]) - mean) * rstd * w[i];
    if (b != nullptr) v += b[i];
    yr[i] = from_f32<T>(v);
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// Lane l holds the row's 16-byte vectors l, l + 32, ..., l + 32 (NV - 1)
// (those below hidden / kVec16<T>); its partial sums run over them in that
// order, element by element.
template <typename T, int NV>
__global__ void __launch_bounds__(kLnWarps * 32)
layer_norm_fwd_warp_kernel(const T* __restrict__ x, const float* __restrict__ w,
                           const float* __restrict__ b, T* __restrict__ y,
                           float* __restrict__ mean_out, float* __restrict__ rstd_out,
                           int64_t rows, int hidden, float eps, int rms) {
  constexpr int kV = kVec16<T>;
  const int lane = threadIdx.x & 31;
  const int n_vec = hidden / kV;
  const bool has_b = b != nullptr;
  float wv[NV][kV], bv[NV][kV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = j * 32 + lane;
#pragma unroll
    for (int k = 0; k < kV; k += 4) {
      if (v < n_vec) {
        load16(w + v * kV + k, &wv[j][k]);
        if (has_b) load16(b + v * kV + k, &bv[j][k]);
      }
    }
  }
  const float inv_h = 1.f / static_cast<float>(hidden);
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kLnWarps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kLnWarps + (threadIdx.x >> 5);
       row < rows; row += n_warps) {
    const T* xr = x + row * hidden;
    T* yr = y + row * hidden;
    float xv[NV][kV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = j * 32 + lane;
      if (v < n_vec) {
        load16(xr + v * kV, xv[j]);
      } else {
#pragma unroll
        for (int k = 0; k < kV; ++k) xv[j][k] = 0.f;
      }
    }
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        s += xv[j][k];
        ss += xv[j][k] * xv[j][k];
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = rms ? 0.f : s * inv_h;
    const float ms = ss * inv_h;
    const float rstd = rsqrtf((rms ? ms : ms - mean * mean) + eps);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = j * 32 + lane;
      if (v < n_vec) {
        float o[kV];
#pragma unroll
        for (int k = 0; k < kV; ++k) {
          o[k] = (xv[j][k] - mean) * rstd * wv[j][k];
          if (has_b) o[k] += bv[j][k];
        }
        store16(yr + v * kV, o);
      }
    }
    if (lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

template <typename T, int NV>
static void launch_warp_body(const void* x, const void* w, const void* b, void* y, void* mean,
                             void* rstd, int64_t rows, int hidden, float eps, int rms,
                             cudaStream_t stream) {
  auto kernel = layer_norm_fwd_warp_kernel<T, NV>;
  // one wave of resident blocks at most: the warps stride over the rows
  static const int per_sm = [&] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kLnWarps * 32, 0);
    return n > 0 ? n : 1;
  }();
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t wave = static_cast<int64_t>(per_sm) * (sms > 0 ? sms : 1);
  const int64_t blocks = std::min((rows + kLnWarps - 1) / kLnWarps, wave);
  kernel<<<static_cast<unsigned>(blocks), kLnWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<T*>(y), static_cast<float*>(mean), static_cast<float*>(rstd), rows, hidden,
      eps, rms);
}

// The row-per-warp body for nv vectors a lane, 1 <= nv <= NV; false for
// another nv.
template <typename T, int NV>
static bool launch_warp(int nv, const void* x, const void* w, const void* b, void* y,
                        void* mean, void* rstd, int64_t rows, int hidden, float eps, int rms,
                        cudaStream_t st) {
  if constexpr (NV == 0) {
    return false;
  } else {
    if (nv != NV) return launch_warp<T, NV - 1>(nv, x, w, b, y, mean, rstd, rows, hidden, eps,
                                                rms, st);
    launch_warp_body<T, NV>(x, w, b, y, mean, rstd, rows, hidden, eps, rms, st);
    return true;
  }
}

template <typename T>
static int launch_layer_norm_fwd(int nv, const void* x, const void* w, const void* b, void* y,
                                 void* mean, void* rstd, int64_t rows, int hidden, float eps,
                                 int rms, cudaStream_t stream) {
  if (nv == 0) {
    layer_norm_fwd_kernel<T><<<static_cast<unsigned>(rows), kLnThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<T*>(y), static_cast<float*>(mean),
        static_cast<float*>(rstd), hidden, eps, rms);
    return 0;
  }
  // the row-per-warp body's contract, checked before any launch
  constexpr int kV = kVec16<T>;
  auto on_grid = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (hidden % kV != 0 || (hidden / kV + 31) / 32 != nv || !on_grid(x) || !on_grid(y) ||
      !on_grid(w) || (b != nullptr && !on_grid(b)) ||
      !launch_warp<T, kLnMaxLaneElems / kV>(nv, x, w, b, y, mean, rstd, rows, hidden,
                                                  eps, rms, stream)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// x, y: (rows, hidden) contiguous of `dtype`; w, b: (hidden,) f32 (b may be
// null); mean, rstd: (rows,) f32.  nv: 16-byte vectors a lane of the
// row-per-warp body, or 0 for the block-per-row body.  Returns
// cudaGetLastError() after launch.
extern "C" int apex_layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                                   void* mean, void* rstd, int64_t rows, int hidden,
                                   float eps, int rms, int dtype, int nv, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case kF32:
      rc = launch_layer_norm_fwd<float>(nv, x, w, b, y, mean, rstd, rows, hidden, eps, rms, st);
      break;
    case kBF16:
      rc = launch_layer_norm_fwd<__nv_bfloat16>(nv, x, w, b, y, mean, rstd, rows, hidden, eps,
                                                rms, st);
      break;
    case kF16:
      rc = launch_layer_norm_fwd<__half>(nv, x, w, b, y, mean, rstd, rows, hidden, eps, rms, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}

extern "C" const char* apex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
