// Fused bias-GELU FFN forward for Hopper: y = gelu_tanh(x W1^T + b1) W2^T + b2
// with f32 accumulation, writing the pre-activation z1 (in x's dtype) for the
// backward, without the (tokens, ffn) activation ever reaching device memory.
//
// Replaces apex_tpu/ops/fused_ffn.py `_ffn_fwd_kernel` (launched by
// `_ffn_fwd_impl`).  What bounds it on the H100: operations.  One call is
// 2 m f (k + n) flops, 137.4 GFLOP at GPT-350M's and BERT-large's micro-batch
// (8192 x 1024 -> 4096 -> 1024) against 117 MB of inputs and outputs (0.139
// ms of bf16 tensor-core time, 0.035 ms of memory time); at decode (8 rows)
// it is bound by the bytes of W1 and W2.  Design (ffn.cuh, the row kernel):
// the TPU kernel carries a (block_m, n) f32 accumulator across a sequential
// ffn grid axis in VMEM; here a block owns 32 token rows and up to 1024
// output columns, keeps their f32 accumulator in registers (each warp 32 x
// 128, mma.sync fragments), and walks its range of the ffn axis in steps of
// 64: z for 32 x 64 on the tensor cores (x and W1 streamed in 256-column
// chunks, two cp.async stages), + b1 in f32, z stored rounded, gelu of the
// unrounded z rounded to bf16 into shared memory, then that tile times the
// step's 64 columns of W2 (streamed in 16-column chunks) into the
// accumulator.  An output wider than 1024 takes more column groups, each
// recomputing its z (any width runs).  The ffn axis is split into ranges
// across blocks when the row blocks alone would not fill the card (prefill,
// decode); every call ends with a second launch that sums the per-range f32
// partials in a fixed order and adds b2 (two launches per call, no float
// atomics).  One block per SM (204 KB of shared memory).  What holds it far
// from its bound: every 32-row block re-reads W1 and W2 and, per step, its x
// chunks (256 x 20 MB from L2 at 8192 rows), and the barriers between
// chunks leave the tensor cores idle while a block waits on L2.
//
// f32 and f16 activations take the FMA instantiation: the same tiles with
// f32 operands in shared memory and the products on the FMA units (67
// TFLOPS of f32: a bound 15x the bf16 one), rounding to f16 where the TPU
// kernel casts.

#include "ffn.cuh"

using namespace apex_tpu_torch;
using namespace apex_tpu_torch::ffn;

// Ranges of the ffn axis per row block for m token rows, f ffn columns,
// n_out output columns and a card of sms multiprocessors: the `splits` of
// apex_ffn_fwd (n_out = n) and apex_ffn_dx (n_out = k), whose partials
// scratch is (splits, m, n_out) f32.
extern "C" int apex_ffn_splits(int m, int f, int n_out, int sms) {
  return row_splits(m, f, n_out, sms);
}

// x: (m, k); w1: (f, k); w2: (n, f), all row-major in the activation dtype
// `dtype` (common.cuh codes); b1: (f,) f32; b2: (n,) f32 or null; y: (m, n)
// and z1: (m, f) in `dtype`; partial: (splits, m, n) f32 scratch.  Two
// launches: the row kernel, then the combine.  bf16 takes the tensor cores,
// f32 and f16 the FMA units.
extern "C" int apex_ffn_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, void* y, void* z1, void* partial, int m, int k, int f,
                            int n, int splits, int dtype, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (splits <= 0 || k <= 0 || f <= 0) return static_cast<int>(cudaErrorInvalidValue);
  RowsArgs p;
  p.a = x;
  p.w1 = w1;
  p.w2 = w2;
  p.b1 = static_cast<const float*>(b1);
  p.z1_in = nullptr;
  p.z1_out = z1;
  p.partial = static_cast<float*>(partial);
  p.m = m;
  p.k = k;
  p.f = f;
  p.n = n;
  p.splits = splits;
  p.code = dtype;
  p.vec = k % 8 == 0 && f % 8 == 0 && n % 8 == 0 && aligned16(x) && aligned16(w1) &&
          aligned16(w2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bias = static_cast<const float*>(b2);
  if (dtype == kBF16) return launch_rows<bf16, false>(p, bias, y, s);
  return launch_rows<float, false>(p, bias, y, s);
}
