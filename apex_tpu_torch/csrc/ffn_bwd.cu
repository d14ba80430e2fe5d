// Fused bias-GELU FFN backward for Hopper, recomputing the GELU terms from
// the saved pre-activation z1 (in the activation dtype):
//   dX  = dz W1 with dz = (dy W2) gelu'(z1) rounded to dy's dtype;
//   dW1 = dz^T x (dz rounded), db1 = column sums of the f32 dz, dW2 = dy^T
//   gelu(z1) (gelu(z1) rounded), each accumulated in f32 over all tokens
//   and written once in the weight's dtype.
//
// Replaces apex_tpu/ops/fused_ffn.py `_ffn_dx_kernel` and `_ffn_dw_kernel`
// (launched by `_ffn_bwd_impl`).  What bounds them on the H100: operations.
// The whole backward is four products of 2 m f n or 2 m f k flops (274.9
// GFLOP at 8192 x 1024 -> 4096 -> 1024, 0.278 ms of bf16 tensor-core
// time); dX alone is two of them (137.4 GFLOP, 0.139 ms), dW alone three
// (206.2 GFLOP, 0.208 ms).
//
// Design: launches of csrc/gemm.cuh's tiled GEMM, with the operands in the
// layouts they already have (an MN-major operand is read along M or N,
// wgmma's transpose flag):
//   1. dh = dy W2 (W2 MN-major).  The epilogue reads z1 at each entry and
//      forms dz = dh gelu'(z1) in f32; it writes dz rounded to the
//      activation dtype into an (m, f) scratch, and for dW also h =
//      gelu(z1) rounded into an (m, f) scratch and the column sums of the
//      f32 dz over each block's 128 rows, in a fixed order, into a (ceil(m
//      / 128), f) f32 partial;
//   2. dX = dz W1 (W1 MN-major), rounded to the activation dtype;
//   3. dW1 = dz^T x, 4. dW2 = dy^T h (both operands MN-major, the
//      contraction over tokens), each in its weight's dtype;
//   5. db1: the partials summed per column in row-block order.
// ffn_dx alone runs 1 (dz only) and 2, ffn_dw alone 1, 3, 4 and 5, the
// whole backward all five: dh = dy W2 is computed once.  The TPU kernels
// keep dz out of device memory by recomputing dh in both kernels; here its
// round trip (64 MB of dz and 64 MB of h at 8192 x 4096 bf16, 0.08 ms at
// 3.35 TB/s) costs less than a fifth product (0.07 ms at the bound).
// Each output entry is summed by one block in a fixed order: no atomics,
// no split of the contraction, and a repeat gives the same bits.
//
// Dispatch by shape (gemm::gemm, per launch, decided before it and never
// on an error): bf16 operands that TMA maps (rows of 16-byte multiples,
// 16-byte aligned bases, z1 too) run TMA + wgmma at any number of token
// rows, a 128-row tile zero-filled past m; f32, f16 and bf16 off that grid
// run the FMA tile, which reads any dtype with element-wise loads.

#include "ffn.cuh"
#include "gemm.cuh"

namespace apex_tpu_torch {
namespace ffn {

// Launch 1's epilogue: dz = dh gelu'(z1) in f32 (z1 the aux tile); dz
// rounded (and, for dW, h = gelu(z1) rounded) stored; returns the f32 dz,
// whose column sums over each block's rows go to `partial` (null: dX
// alone)
struct DzFromDh {
  const void* z1;  // (m, f)
  void* dz;        // (m, f)
  void* h;         // (m, f) or null
  float* partial;  // (ceil(m / 128), f) or null
  int m, f, code;
  __host__ __device__ gemm::AuxTile aux_tile() const { return {z1, m, f, code}; }
  __device__ __forceinline__ float2 operator()(int row, int col, float v0, float v1,
                                               float2 z) const {
    if (row >= m || col >= f) return make_float2(0.f, 0.f);
    const bool two = col + 1 < f;
    const int64_t at = static_cast<int64_t>(row) * f + col;
    const float da = v0 * gelu_grad(z.x), db = two ? v1 * gelu_grad(z.y) : 0.f;
    store_pair(dz, code, at, da, db, two);
    if (h != nullptr) store_pair(h, code, at, gelu(z.x), gelu(z.y), two);
    return make_float2(da, db);
  }
  __device__ __forceinline__ void col_sum(int row_block, int col, float sum) const {
    if (partial != nullptr && col < f) partial[static_cast<int64_t>(row_block) * f + col] = sum;
  }
};

// C stored row-major (rows, cols) in the dtype `code`: dX (DxOut), dW1 and
// dW2 (DwOut; two types so that a profile tells the launches apart)
struct Out {
  void* out;
  int rows, cols, code;
  __device__ __forceinline__ void operator()(int row, int col, float v0, float v1) const {
    if (row >= rows || col >= cols) return;
    store_pair(out, code, static_cast<int64_t>(row) * cols + col, v0, v1, col + 1 < cols);
  }
};
struct DxOut : Out {};
struct DwOut : Out {};

// db1[c] = the partials' column c summed in row-block order
static __global__ void ffn_db1_kernel(const float* __restrict__ partial, float* __restrict__ db1,
                                      int blocks, int f) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= f) return;
  float sum = 0.f;
  for (int b = 0; b < blocks; ++b) sum += partial[static_cast<int64_t>(b) * f + c];
  db1[c] = sum;
}

}  // namespace ffn
}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;
using namespace apex_tpu_torch::ffn;

// x: (m, k); dy: (m, n); z1: (m, f); w1: (f, k); w2: (n, f), all row-major
// in the activation dtype `dtype`; dx: (m, k) in `dtype`, or null (no dX);
// dw1: (f, k) in w1_dtype, db1: (f,) f32 and dw2: (n, f) in w2_dtype, or
// dw1 null (no weight gradients: x, db1, dw2, h and partial unused); the
// scratch dz and h: (m, f) in `dtype`, partial: (ceil(m / 128), f) f32;
// w1 may be null without dX.
// Launches: dh (dz, h, partials), dX, dW1, dW2, db1 — those asked for.
extern "C" int apex_ffn_bwd(const void* x, const void* dy, const void* z1, const void* w1,
                            const void* w2, void* dx, void* dw1, void* db1, void* dw2, void* dz,
                            void* h, void* partial, int m, int k, int f, int n, int dtype,
                            int w1_dtype, int w2_dtype, void* stream) {
  if (m <= 0 || k <= 0 || f <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool dw = dw1 != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 1. dh (m x f) = dy (m x n) W2 (n x f, MN-major)
  const DzFromDh first{z1, dz, dw ? h : nullptr, dw ? static_cast<float*>(partial) : nullptr, m,
                       f, dtype};
  int rc = gemm::gemm<false, true>({dy, w2, m, f, n}, first, dtype, s);
  if (rc != 0) return rc;
  if (dx != nullptr) {
    // 2. dX (m x k) = dz (m x f) W1 (f x k, MN-major)
    rc = gemm::gemm<false, true>({dz, w1, m, k, f}, DxOut{{dx, m, k, dtype}}, dtype, s);
    if (rc != 0) return rc;
  }
  if (!dw) return 0;
  // 3. dW1 (f x k) = dz^T x, 4. dW2 (n x f) = dy^T h, over the m tokens
  rc = gemm::gemm<true, true>({dz, x, f, k, m}, DwOut{{dw1, f, k, w1_dtype}}, dtype, s);
  if (rc != 0) return rc;
  rc = gemm::gemm<true, true>({dy, h, n, f, m}, DwOut{{dw2, n, f, w2_dtype}}, dtype, s);
  if (rc != 0) return rc;
  // 5. db1
  ffn_db1_kernel<<<(f + 255) / 256, 256, 0, s>>>(static_cast<const float*>(partial),
                                                 static_cast<float*>(db1),
                                                 (m + gemm::kTmaBM - 1) / gemm::kTmaBM, f);
  return static_cast<int>(cudaGetLastError());
}
