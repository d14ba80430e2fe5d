// Fused LM-head forward for Hopper: per-token loss and logsumexp of the
// tied head x W^T without forming the (N, V) logits.
//
// Replaces apex_tpu/ops/lm_head.py `_fwd_kernel` (launched by `_fwd_impl`).
// What bounds it on the H100: operations.  One call is 2 N V H flops (0.84
// TFLOP at GPT-350M's 8192 x 50304 x 1024) against 0.12 GB of operands: the
// product belongs on the tensor cores, and the logits in registers.
//
// Design: one NT product S = x W^T on csrc/gemm.cuh (gemm()) whose epilogue
// (LseFromScores) reduces each row of each column tile of S to a partial
// (m, l, t): m the row's max over the tile's columns below V, l = sum
// exp(s - m) over them, t the target's score where the tile holds the
// target (else 0).  Columns at or past V are left out (TMA zero-fills W's
// missing rows, so their scores are 0, not -inf); a target outside [0, V)
// matches no column.  The partials go to a (3, tiles, N) f32 scratch, and
// a second launch combines each row's tiles in ascending order (no float
// atomics; runs repeat bit for bit): lse = m + log(l) with l = 1 where it
// is 0 (as JAX's `_finish`), loss = lse - t.
//
// Routes (gemm()'s, by dtype and shape): a bf16 pair on TMA's 16-byte grid
// (H a multiple of 8, 16-byte aligned bases) runs the persistent TMA +
// wgmma kernel over 128 x 256 tiles, the partials of a row from the quad of
// lanes that holds it; anything else, bf16 off the grid or f32 operands (f32,
// f16 and mixed pairs, cast by the wrapper; exact), runs the FMA tile, 128 x
// 128, the partials from the 16 lanes that share a row.  So `tiles` is
// ceil(V / 256) or ceil(V / 128) (197 or 393 at V = 50304):
// apex_lm_head_fwd_tiles asks gemm.cuh.
//
// The exponential: 2^x on the special-function unit (ex2.approx) of the
// score scaled by log2(e), the max taken off in the same FMA (s log2e - m
// log2e); the combine rescales the tiles' l with expf of natural-unit
// maxima.  Against the plain version's logsumexp this kept loss and lse
// within 6e-6 at GPT-350M's head (chip_smoke.py phase 2 holds them to 1e-4
// + 1e-5 relative).

#include "gemm.cuh"

namespace apex_tpu_torch {
namespace lm_head {

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (flushing results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the product's epilogue: a row partial (m, l, t) per (row, column tile)
struct LseFromScores {
  static constexpr bool is_row_partial = true;
  const int* targets;
  float* partials;  // (3, tiles, n): m, then l, then t
  int n, v, tiles;

  __device__ __forceinline__ int row_values(int row) const {
    return row < n ? targets[row] : -1;
  }

  // this thread's max of the scores val(i) at columns below v (every
  // column unless kMasked), and its sum of 2^(val(i) log2e - ms) over them,
  // each in four interleaved partial sums (a fixed order)
  template <bool kMasked, int K, class Val, class Col>
  __device__ __forceinline__ float max_of(Val val, Col col) const {
    float a[4] = {kMask, kMask, kMask, kMask};
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (!kMasked || col(i) < v) a[i & 3] = fmaxf(a[i & 3], val(i));
    }
    return fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]));
  }

  template <bool kMasked, int K, class Val, class Col>
  __device__ __forceinline__ float sum_exp(Val val, Col col, float ms) const {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (!kMasked || col(i) < v) a[i & 3] += ex2(fmaf(val(i), kLog2e, -ms));
    }
    return (a[0] + a[1]) + (a[2] + a[3]);
  }

  // val(i) at column col(i), increasing in i, i < K: this thread's scores
  // of `row` in column tile `tile`; the kLanes lanes that share the row
  // reduce them together.  Only the last tile holds columns at or past v.
  template <int kLanes, int K, class Val, class Col>
  __device__ __forceinline__ void row_partial(int row, int tile, Val val, Col col,
                                              int target) const {
    const bool masked = col(K - 1) >= v;
    float m = masked ? max_of<true, K>(val, col) : max_of<false, K>(val, col);
    m = lanes_max<kLanes>(m);
    const float ms = m * kLog2e;
    float l = masked ? sum_exp<true, K>(val, col, ms) : sum_exp<false, K>(val, col, ms);
    float t = 0.f;
    if (target >= col(0) && target <= col(K - 1) && target < v) {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (col(i) == target) t = val(i);
      }
    }
    l = lanes_sum<kLanes>(l);
    t = lanes_sum<kLanes>(t);  // one lane at most holds the target
    if ((threadIdx.x & (kLanes - 1)) == 0 && row < n) {
      const int64_t i = static_cast<int64_t>(tile) * n + row;
      const int64_t plane = static_cast<int64_t>(tiles) * n;
      partials[i] = m;
      partials[plane + i] = l;
      partials[2 * plane + i] = t;
    }
  }
};

// the second launch: per row, the tiles' partials in ascending tile order
__global__ void lm_head_fwd_combine_kernel(const float* __restrict__ partials,
                                           float* __restrict__ loss, float* __restrict__ lse,
                                           int n, int tiles) {
  const int tok = blockIdx.x * blockDim.x + threadIdx.x;
  if (tok >= n) return;
  const float* pm = partials;
  const float* pl = partials + static_cast<int64_t>(tiles) * n;
  const float* pt = partials + 2 * static_cast<int64_t>(tiles) * n;
  float m = kMask;
#pragma unroll 8
  for (int s = 0; s < tiles; ++s) m = fmaxf(m, pm[static_cast<int64_t>(s) * n + tok]);
  float l = 0.f, t = 0.f;
#pragma unroll 8
  for (int s = 0; s < tiles; ++s) {
    const int64_t i = static_cast<int64_t>(s) * n + tok;
    l += pl[i] * expf(pm[i] - m);
    t += pt[i];
  }
  if (l == 0.f) l = 1.f;
  const float out = m + logf(l);
  lse[tok] = out;
  loss[tok] = out - t;
}

}  // namespace lm_head
}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;
using namespace apex_tpu_torch::lm_head;

// The column tiles of apex_lm_head_fwd's product for x (n, h) and w (v, h)
// in the operand dtype `code`: its partials scratch is (3, tiles, n) f32.
extern "C" int apex_lm_head_fwd_tiles(const void* x, const void* w, int v, int h, int code) {
  const int cols = gemm::row_partial_cols({x, w, 0, v, h}, code);
  return (v + cols - 1) / cols;
}

// x: (n, h) and w: (v, h) row-major, both in the operand dtype `code` (bf16
// for a bf16 pair, else f32); targets: (n,) int32; loss, lse: (n,) f32;
// partials: (3, tiles, n) f32 scratch, tiles from apex_lm_head_fwd_tiles.
// Two launches: the product with its row partials, then the combine.
extern "C" int apex_lm_head_fwd(const void* x, const void* w, const void* targets, void* loss,
                                void* lse, void* partials, int n, int v, int h, int tiles,
                                int code, void* stream) {
  if (n <= 0) return 0;
  if (v <= 0 || h < 0 || (code != kBF16 && code != kF32) ||
      tiles != apex_lm_head_fwd_tiles(x, w, v, h, code)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partials);
  const LseFromScores epi{static_cast<const int*>(targets), p, n, v, tiles};
  const int rc = gemm::gemm<false, false>({x, w, n, v, h}, epi, code, s);
  if (rc != 0) return rc;
  lm_head_fwd_combine_kernel<<<(n + 255) / 256, 256, 0, s>>>(p, static_cast<float*>(loss),
                                                             static_cast<float*>(lse), n, tiles);
  return static_cast<int>(cudaGetLastError());
}
