// LayerNorm / RMSNorm forward for Hopper.
//
// Replaces apex_tpu/ops/layer_norm.py `_fwd_kernel` (launched by
// `_pallas_fwd`).  What bounds it on the H100: bytes.  A row of 1024 bf16
// values is read once from device memory and written once; the work per byte
// is a handful of FMAs, far below the ~295 operations per byte where the
// tensor cores would be the limit.  Design: one block per row, f32 sums of
// x and x*x reduced with warp shuffles then across warps in shared memory
// (the E[x^2] - mean^2 form of the JAX kernel), then a second pass over the
// row (an L1/L2 hit) writes y in x's dtype and mean/rstd in f32.  None of
// the TPU's 128-lane padding or VMEM row budget is carried over: a block
// takes any hidden size and the grid takes any row count.

#include "common.cuh"

namespace apex_tpu_torch {

constexpr int kLnThreads = 256;

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

template <typename T>
static void launch_layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                                  void* mean, void* rstd, int64_t rows, int hidden,
                                  float eps, int rms, cudaStream_t stream) {
  layer_norm_fwd_kernel<T><<<static_cast<unsigned>(rows), kLnThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), hidden, eps, rms);
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// x, y: (rows, hidden) contiguous of `dtype`; w, b: (hidden,) f32 (b may be
// null); mean, rstd: (rows,) f32.  Returns cudaGetLastError() after launch.
extern "C" int apex_layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                                   void* mean, void* rstd, int64_t rows, int hidden,
                                   float eps, int rms, int dtype, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      launch_layer_norm_fwd<float>(x, w, b, y, mean, rstd, rows, hidden, eps, rms, st);
      break;
    case kBF16:
      launch_layer_norm_fwd<__nv_bfloat16>(x, w, b, y, mean, rstd, rows, hidden, eps, rms, st);
      break;
    case kF16:
      launch_layer_norm_fwd<__half>(x, w, b, y, mean, rstd, rows, hidden, eps, rms, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* apex_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
