// Fused bias-GELU FFN forward for Hopper: y = gelu_tanh(x W1^T + b1) W2^T + b2
// with f32 accumulation, writing the pre-activation z1 (in x's dtype) for the
// backward.
//
// Replaces apex_tpu/ops/fused_ffn.py `_ffn_fwd_kernel` (launched by
// `_ffn_fwd_impl`).  What bounds it on the H100: operations at training
// width, bytes at decode.  One call is 2 m f (k + n) flops, 137.4 GFLOP at
// GPT-350M's and BERT-large's micro-batch (8192 x 1024 -> 4096 -> 1024)
// against 117 MB of inputs and outputs: 0.139 ms of bf16 tensor-core time,
// 0.035 ms of memory time.  At decode (8 rows) it is the 16 MB of bf16 W1
// and W2 (0.005 ms), 200 times the bytes of x, z1 and y.
//
// Design: two launches of one tiled GEMM mainloop (gemm.cuh), both "NT"
// products with the weights in their (out, in) layout:
//   1. x W1^T, epilogue + b1 in f32, z1 = z rounded to x's dtype, and
//      h = gelu(z) of the unrounded z rounded to x's dtype into an (m, f)
//      scratch that the wrapper allocates;
//   2. h W2^T, epilogue + b2 in f32, y rounded to x's dtype.
// The TPU kernel keeps h out of device memory by carrying a (block_m, n)
// f32 accumulator across a sequential ffn grid axis in VMEM; here that
// accumulator would have to live in one block's registers, which bounds the
// row tile to 32 and makes every block re-read all of W1 and W2 (5 GB from
// L2 at 8192 rows).  h's round trip instead costs 64 MB at 8192 x 4096 bf16,
// 0.04 ms at 3.35 TB/s, and each W tile is read by m / 128 blocks.  bf16 at
// training and prefill width runs TMA-fed wgmma on 128 x 256 (or 128 x 128)
// tiles; decode's few rows run mma.sync on narrow 16 x 16 / 16 x 8 column
// tiles that cover the card (no split of the contraction across blocks).  Every entry
// is summed by one block in a fixed order, so y and z1 are the same bits on
// a repeat.  f32 and f16 activations take the FMA tile of the same
// mainloop (f32 arithmetic, rounding to f16 where the TPU kernel casts).

#include "ffn.cuh"
#include "gemm.cuh"

using namespace apex_tpu_torch;

namespace apex_tpu_torch {
namespace ffn {

// GEMM 1's epilogue: z = acc + b1, z1 = z and h = gelu(z), both rounded
struct BiasGelu {
  const float* b1;
  void* z1;
  void* h;
  int m, f, code;
  __device__ __forceinline__ void operator()(int row, int col, float v0, float v1) const {
    if (row >= m || col >= f) return;
    const bool two = col + 1 < f;
    const float z0 = v0 + b1[col];
    const float z1v = two ? v1 + b1[col + 1] : 0.f;
    const int64_t at = static_cast<int64_t>(row) * f + col;
    store_pair(z1, code, at, z0, z1v, two);
    store_pair(h, code, at, ffn::gelu(z0), ffn::gelu(z1v), two);  // of the unrounded z
  }
};

// GEMM 2's epilogue: y = acc + b2 (b2 may be null), rounded
struct Bias {
  const float* b2;
  void* y;
  int m, n, code;
  __device__ __forceinline__ void operator()(int row, int col, float v0, float v1) const {
    if (row >= m || col >= n) return;
    const bool two = col + 1 < n;
    if (b2 != nullptr) {
      v0 += b2[col];
      if (two) v1 += b2[col + 1];
    }
    store_pair(y, code, static_cast<int64_t>(row) * n + col, v0, v1, two);
  }
};

}  // namespace ffn
}  // namespace apex_tpu_torch

// x: (m, k); w1: (f, k); w2: (n, f), all row-major in the activation dtype
// `dtype` (common.cuh codes); b1: (f,) f32; b2: (n,) f32 or null; y: (m, n),
// z1 and the scratch h: (m, f), in `dtype`.  Two launches: x W1^T into z1
// and h, then h W2^T into y.  bf16 takes the tensor cores, f32 and f16 the
// FMA units.
extern "C" int apex_ffn_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, void* y, void* z1, void* h, int m, int k, int f, int n,
                            int dtype, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || f <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != kF32 && dtype != kBF16 && dtype != kF16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ffn::BiasGelu first{static_cast<const float*>(b1), z1, h, m, f, dtype};
  const int rc = gemm::gemm_nt(x, w1, m, f, k, dtype, first, s);
  if (rc != 0) return rc;
  const ffn::Bias second{static_cast<const float*>(b2), y, m, n, dtype};
  return gemm::gemm_nt(h, w2, m, n, f, dtype, second, s);
}
