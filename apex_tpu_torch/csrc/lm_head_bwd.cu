// Fused LM-head backward for Hopper: with dS = (exp(x W^T - lse) -
// onehot(target)) g,
//   dX = dS W, summed over the vocab in f32 and rounded once to x's dtype;
//   dW = dS^T x, summed over all tokens in f32 and written in W's dtype.
// dS is rounded to the operand dtype before both products (bf16 for a bf16
// pair; f32 pairs, which every other pair becomes in the wrapper, keep it
// in f32), as the TPU kernels cast it for their dots.
//
// Replaces apex_tpu/ops/lm_head.py `_dx_kernel` and `_dw_kernel` (launched
// by `_bwd_impl`).  What bounds them on the H100: operations.  The TPU
// kernels recompute the scores S = x W^T in each of the two, four products
// of 2 N V H flops; here the whole backward is three (x W^T, dS W, dS^T x:
// 2.56 TFLOP at GPT-350M's 8192 x 1024 x 50304, 2.59 ms of bf16
// tensor-core time).
//
// Design: the vocabulary is cut into chunks of `width` columns (a multiple
// of 64, chosen by the wrapper's plan so that one dS chunk stays within 128
// MiB: 7 chunks at GPT-350M's head, 4 at BERT-large's), and each chunk is
// launches of csrc/gemm.cuh's tiled GEMM:
//   1. dS_c = epilogue(x W_c^T), an NT product (gemm_nt) whose epilogue
//      takes each row's lse, g and target and writes dS_c into an (N,
//      chunk) scratch; columns at or past V are written as 0 (their scores
//      are 0, TMA having zero-filled W's missing rows, but exp(0 - lse) is
//      not).  bf16 runs the GEMM's persistent kernel: H = 1024 is only 16
//      contraction steps a tile, so each tile's epilogue (an exponential
//      per entry) overlaps the next tile's loads, and dS goes out by TMA;
//   2. dX += dS_c W_c (W_c MN-major).  The accumulators start from the f32
//      partial of the chunks before (the GEMM's seed), so dX is summed in
//      f32 across chunks in a fixed order and rounded to x's dtype once, by
//      the last chunk's epilogue; the others write the (N, H) f32 partial;
//   3. dW_c = dS_c^T x (both operands MN-major, the contraction over the
//      tokens), written straight into rows [v0, v0 + valid) of dW.
// dX alone runs 1 and 2 per chunk, dW alone 1 and 3, the whole backward
// all three: dS is computed once per chunk.  The last chunk is padded to
// the 64-column grid so that dS's rows stay 16-byte multiples for TMA; W
// is not: its products are told how many of W's rows exist (Product::
// b_rows), and read zeros past them.  Every output entry is summed by one
// block in a fixed order (no atomics, no split of the contraction across
// blocks), so a repeat gives the same bits, and dX / dW alone give the
// whole backward's bits.
//
// Dispatch by shape (gemm::gemm per launch): bf16 operands that TMA maps
// run TMA + wgmma (launch 1 with at most 64 tokens the narrow mma.sync
// tiles); f32 (any pair but bf16 / bf16, cast by the wrapper) and bf16 off
// TMA's grid run the FMA tile.

#include "gemm.cuh"

namespace apex_tpu_torch {
namespace lm_head {

constexpr int kChunkGrid = 64;  // chunk widths are multiples of this

// a token row's lse, cotangent and target
struct RowStats {
  float lse, g;
  int target;
};

// Launch 1's epilogue: dS at (row, v0 + col) from the f32 score s
struct DsFromScores {
  const float* lse;
  const float* g;
  const int* targets;
  void* ds;   // (rows, cols) in `code`
  int rows;   // tokens
  int cols;   // the chunk's padded width
  int valid;  // the chunk's columns below V
  int v0;
  int code;
  __device__ __forceinline__ RowStats row_values(int row) const {
    if (row >= rows) return {0.f, 0.f, -1};
    return {lse[row], g[row], targets[row]};
  }
  // dS at column col of the chunk from its score s
  __device__ __forceinline__ float value(int col, float s, const RowStats& r) const {
    if (col >= valid) return 0.f;
    return (expf(s - r.lse) - (v0 + col == r.target ? 1.f : 0.f)) * r.g;
  }
  // the output the persistent TMA kernel stores (bf16)
  __host__ __device__ gemm::AuxTile out_tile() const { return {ds, rows, cols, code}; }
  // the narrow and FMA tiles' pairs
  __device__ __forceinline__ void operator()(int row, int col, float s0, float s1,
                                             const RowStats& r) const {
    if (row >= rows || col >= cols) return;  // cols is even: col + 1 < cols too
    store_pair(ds, code, static_cast<int64_t>(row) * cols + col, value(col, s0, r),
               value(col + 1, s1, r), true);
  }
};

// C stored row-major (rows, cols) in the dtype `code`
struct Out {
  void* out;
  int rows, cols, code;
  __device__ __forceinline__ void operator()(int row, int col, float v0, float v1) const {
    if (row >= rows || col >= cols) return;
    store_pair(out, code, static_cast<int64_t>(row) * cols + col, v0, v1, col + 1 < cols);
  }
};

// Launch 2's epilogue: dX (the last chunk) or the f32 partial, the
// accumulators seeded from the partial (null for the first chunk)
struct DxOut : Out {
  const float* partial;
  __host__ __device__ gemm::AuxTile seed() const { return {partial, rows, cols, kF32}; }
};

// Launch 3's epilogue: the chunk's rows of dW (a distinct type, so that a
// profile tells the launches apart)
struct DwOut : Out {};

}  // namespace lm_head
}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;
using namespace apex_tpu_torch::lm_head;

// x: (n, h) and w: (v, h) row-major, both in the operand dtype `code` (bf16
// for a bf16 pair, else f32); targets: (n,) int32; lse, g: (n,) f32; dx:
// (n, h) in dx_dtype, or null (no dX); dw: (v, h) in dw_dtype, or null (no
// dW); the scratch ds: (n, width) in `code`; partial: (n, h) f32, used when
// dX is asked for and the vocab takes more than one chunk.  width: a
// multiple of 64.  Per chunk of the vocab: the dS launch, then dX's and
// dW's, those asked for.
extern "C" int apex_lm_head_bwd(const void* x, const void* w, const void* targets,
                                const void* lse, const void* g, void* dx, void* dw, void* ds,
                                void* partial, int n, int v, int h, int width, int code,
                                int dx_dtype, int dw_dtype, void* stream) {
  if (n <= 0 || v <= 0 || h <= 0 || width <= 0 || width % kChunkGrid != 0 ||
      (code != kBF16 && code != kF32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dx != nullptr && v > width && partial == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t esize = code == kBF16 ? 2 : 4;
  const int64_t dw_esize = dw_dtype == kF32 ? 4 : 2;
  for (int v0 = 0; v0 < v; v0 += width) {
    const int valid = v - v0 < width ? v - v0 : width;
    const int cols = (valid + kChunkGrid - 1) / kChunkGrid * kChunkGrid;
    const void* wc = static_cast<const char*>(w) + static_cast<int64_t>(v0) * h * esize;
    // 1. dS_c (n x cols) from x (n x h) W_c^T, W_c's rows past `valid` zero
    const DsFromScores first{static_cast<const float*>(lse), static_cast<const float*>(g),
                             static_cast<const int*>(targets), ds, n, cols, valid, v0, code};
    int rc = gemm::gemm_nt(x, wc, n, cols, h, code, first, s, valid);
    if (rc != 0) return rc;
    if (dx != nullptr) {
      // 2. dX (n x h) = partial + dS_c (n x cols) W_c (cols x h, MN-major)
      const bool last = v0 + width >= v;
      const DxOut out{{last ? dx : partial, n, h, last ? dx_dtype : static_cast<int>(kF32)},
                      v0 == 0 ? nullptr : static_cast<const float*>(partial)};
      rc = gemm::gemm<false, true>({ds, wc, n, h, cols, valid}, out, code, s);
      if (rc != 0) return rc;
    }
    if (dw != nullptr) {
      // 3. dW_c (cols x h, rows past `valid` dropped) = dS_c^T x over the n tokens
      void* dwc = static_cast<char*>(dw) + static_cast<int64_t>(v0) * h * dw_esize;
      rc = gemm::gemm<true, true>({ds, x, cols, h, n}, DwOut{{dwc, valid, h, dw_dtype}}, code, s);
      if (rc != 0) return rc;
    }
  }
  return 0;
}
