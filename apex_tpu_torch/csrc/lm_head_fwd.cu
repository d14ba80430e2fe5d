// Fused LM-head forward for Hopper: per-token loss and logsumexp of the
// tied head x W^T without forming the (N, V) logits.
//
// Replaces apex_tpu/ops/lm_head.py `_fwd_kernel` (launched by `_fwd_impl`).
// What bounds it on the H100: operations.  One call is 2 N V H flops (0.84
// TFLOP at GPT-350M's 8192 x 50304 x 1024) against 0.12 GB of operands: the
// products belong on the tensor cores.  Design (lm_head.cuh): a block keeps
// 32 token rows of X in shared memory and streams W in tiles of 64 vocab
// rows, the score tile computed by mma.sync (bf16 x bf16, f32 accumulation), so
// the logits exist only as a 32 x 64 f32 tile.  Each warp owns 4 rows of
// the block and carries their running max m, sum l and target logit in
// registers across the vocab tiles (the TPU kernel's scratch across its
// sequential vocab grid axis); columns past V are masked to -1e30 and give
// p = 0.  With 32-row tiles 8192 tokens make 256 blocks, one per SM (the
// tiles take 208 KB of shared memory), so the vocab is split into ranges
// across blocks (apex_lm_head_fwd_splits) when the rows alone would not fill
// the card: each writes partial (m, l, t) per row, and a second launch
// combines them per row in a fixed order (no float atomics; runs repeat bit
// for bit).  Each block
// re-reads its whole vocab range of W: at GPT-350M that is 256 x 103 MB of
// W traffic, mostly hits in the 50 MB L2 because the blocks in flight walk
// the same tiles in the same order.
//
// Other dtypes (f32, f16, a mixed pair) take the f32 instantiation, the
// reference's own math (f32 products), on the same tiles and vocab ranges
// with the score tile on the FMA units (lm_head.cuh score_tile_f32): 2 N V
// H flops against 67 TFLOPS of f32, a bound 15x the bf16 one.

#include "lm_head.cuh"

namespace apex_tpu_torch {
namespace lm_head {

__global__ void __launch_bounds__(kThreads)
lm_head_fwd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const int* __restrict__ targets, float* __restrict__ partials, int n,
                       int v, int h, int splits) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ld = tile_ld(h);
  const Smem sm = carve(smem_raw, ld);
  const int t0 = blockIdx.x * kRes;
  const int split = blockIdx.y;
  const int n_tiles = (v + kStr - 1) / kStr;
  const int tile_lo = static_cast<int>(static_cast<int64_t>(split) * n_tiles / splits);
  const int tile_hi = static_cast<int>(static_cast<int64_t>(split + 1) * n_tiles / splits);

  load_rows(sm.res, ld, x, t0, n, kRes, h, 0, padded_h(h));
  cp_async_commit();
  FwdRows rows;
  rows.init(targets, t0, n);
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    __syncthreads();  // the previous tile's W and scores are consumed
    load_tile_chunked(sm.str, ld, w, tile * kStr, v, h);
    score_tile<kRes, kStr>(sm.res, sm.str, ld, h, sm.score, kLdS);
    __syncthreads();
    rows.update(sm.score, tile * kStr, v);
  }
  rows.store(partials, split, splits, t0, n);
}

// f32 instantiation: the same tiles and vocab ranges, the scores on the
// FMA units from hidden chunks staged in shared memory
__global__ void __launch_bounds__(kThreads)
lm_head_fwd_fma_kernel(const void* __restrict__ x, int cx, const void* __restrict__ w, int cw,
                       const int* __restrict__ targets, float* __restrict__ partials, int n,
                       int v, int h, int splits) {
  __shared__ __align__(16) SmemF sm;
  const int t0 = blockIdx.x * kRes;
  const int split = blockIdx.y;
  const int n_tiles = (v + kStr - 1) / kStr;
  const int tile_lo = static_cast<int>(static_cast<int64_t>(split) * n_tiles / splits);
  const int tile_hi = static_cast<int>(static_cast<int64_t>(split + 1) * n_tiles / splits);
  FwdRows rows;
  rows.init(targets, t0, n);
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    score_tile_f32(sm, x, cx, t0, n, w, cw, tile * kStr, v, h);
    __syncthreads();
    rows.update(sm.score, tile * kStr, v);
  }
  rows.store(partials, split, splits, t0, n);
}

// the second launch: per row, the split partials in ascending split order
__global__ void lm_head_fwd_combine_kernel(const float* __restrict__ partials,
                                           float* __restrict__ loss, float* __restrict__ lse,
                                           int n, int splits) {
  const int tok = blockIdx.x * blockDim.x + threadIdx.x;
  if (tok >= n) return;
  const float* pm = partials;
  const float* pl = partials + static_cast<int64_t>(splits) * n;
  const float* pt = partials + 2 * static_cast<int64_t>(splits) * n;
  float m = kMask;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, pm[static_cast<int64_t>(s) * n + tok]);
  float l = 0.f, t = 0.f;
  for (int s = 0; s < splits; ++s) {
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

// Vocab ranges per row tile for n tokens, v vocab rows and a card of sms
// multiprocessors: the `splits` of apex_lm_head_fwd, whose partials
// scratch is (3, splits, n) f32.
extern "C" int apex_lm_head_fwd_splits(int n, int v, int sms) { return fwd_splits(n, v, sms); }

// x: (n, h), w: (v, h) row-major in their dtypes (codes of common.cuh);
// targets: (n,) int32; loss, lse: (n,) f32; partials: (3, splits, n) f32
// scratch.  Two launches: the split forward, then the combine.  A bf16 pair
// takes the tensor-core kernel (h a multiple of 8, at most 1024, 16-byte
// aligned rows); any other pair the f32 kernel.
extern "C" int apex_lm_head_fwd(const void* x, const void* w, const void* targets, void* loss,
                                void* lse, void* partials, int n, int v, int h, int splits,
                                int x_dtype, int w_dtype, void* stream) {
  if (n <= 0) return 0;
  if (splits <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((n + kRes - 1) / kRes), static_cast<unsigned>(splits));
  if (x_dtype == kBF16 && w_dtype == kBF16) {
    if (h % 8 != 0 || h > kHMax) return static_cast<int>(cudaErrorInvalidValue);
    static bool attr_set = false;
    const int rc = set_smem(lm_head_fwd_mma_kernel, attr_set);
    if (rc != 0) return rc;
    lm_head_fwd_mma_kernel<<<grid, kThreads, smem_bytes(h), s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const int*>(targets), static_cast<float*>(partials), n, v, h, splits);
  } else {
    lm_head_fwd_fma_kernel<<<grid, kThreads, 0, s>>>(x, x_dtype, w, w_dtype,
                                                    static_cast<const int*>(targets),
                                                    static_cast<float*>(partials), n, v, h,
                                                    splits);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  lm_head_fwd_combine_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partials), static_cast<float*>(loss), static_cast<float*>(lse),
      n, splits);
  return static_cast<int>(cudaGetLastError());
}
