// Fused bias-GELU FFN backward for Hopper, recomputing the GELU terms from
// the saved pre-activation z1 (in the activation dtype):
//   dX  = dz W1 with dz = (dy W2) gelu'(z1) rounded to dy's dtype;
//   dW1 = dz^T x (dz rounded), db1 = column sums of the f32 dz, dW2 = dy^T
//   gelu(z1), each accumulated in f32 over all tokens and written once in
//   the weight's dtype.
//
// Replaces apex_tpu/ops/fused_ffn.py `_ffn_dx_kernel` and `_ffn_dw_kernel`
// (launched by `_ffn_bwd_impl`).  What bounds them on the H100: operations.
// dX is 2 m f (n + k) flops (137.4 GFLOP at 8192 x 1024 -> 4096 -> 1024,
// 0.139 ms of bf16 tensor-core time); dW is 2 m f (n + k + n) (dh recomputed
// for dW1, then dW1 and dW2: 206.2 GFLOP, 0.208 ms).  Neither the (tokens,
// ffn) dz nor gelu(z1) reaches device memory.
//
// dX (ffn.cuh, the row kernel): a block owns 32 token rows
// and up to 1024 columns of dX in registers and walks its ffn range in steps
// of 64: dh = dy W2 for 32 x 64 on the tensor cores, dz = dh gelu'(z1)
// rounded to bf16 into shared memory, then dz times the step's 64 rows of W1
// into the accumulator.  The ffn axis is split into ranges across blocks
// when the row blocks alone would not fill the card, and a second launch
// sums their partials in a fixed order (two launches, no float atomics).
//
// dW: the TPU kernel carries (block_f, k) and (n, block_f) f32 scratch
// across a sequential token axis; the two together would not fit one block's
// registers at block_f = 32 (256 KB), so they are split across blocks.  A
// block owns 32 ffn rows and one group of at most 1024 columns of either dW1
// (grid y < the k groups) or dW2^T, in registers, and walks all tokens in
// steps of 64: a dW1 block computes dh = dy W2 for 64 x 32 (the TPU kernel
// recomputes it too), dz = dh gelu'(z1), adds the f32 dz into its db1 sums
// and stores dz rounded into shared memory; a dW2 block stores gelu(z1)
// rounded.  Then ACC += tile^T (x or dy) over the step's 64 tokens (x or dy
// streamed in 16-row chunks).  Each entry of dW1, db1 and dW2 is written by
// one block, its sum over tokens in a fixed order: no atomics.  db1 sums
// each thread's columns, then the threads' partials in a fixed order.
//
// f32 and f16 activations take the FMA instantiation of the same tiles.

#include "ffn.cuh"

namespace apex_tpu_torch {
namespace ffn {

struct DwArgs {
  const void* x;   // (m, k)
  const void* dy;  // (m, n)
  const void* z1;  // (m, f)
  const void* w2;  // (n, f)
  void* dw1;       // (f, k) in code_w1
  float* db1;      // (f,)
  void* dw2;       // (n, f) in code_w2
  int m, k, f, n, groups_k, code, code_w1, code_w2, vec;
};

template <typename T>
struct DwLayout {
  static constexpr int kKc1 = Tiles<T>::kKc1, kKc2 = Tiles<T>::kKc2, kPad = Tiles<T>::kPad;
  static constexpr int ldA1 = kKc1 + kPad, szA1 = kWBM * ldA1;  // dy: tokens x n chunk
  static constexpr int ldB1 = kWBF + kPad, szB1 = kKc1 * ldB1;  // W2: n chunk x ffn (k-major)
  static constexpr int ldA2 = kWBF + kPad, szA2 = kWBM * ldA2;  // dz or gelu(z1): tokens x ffn
  static constexpr int ldB2 = kNG + kPad, szB2 = kKc2 * ldB2;   // x or dy: token chunk x columns
  static constexpr int kBytes =
      static_cast<int>((2 * szA1 + 2 * szB1 + szA2 + 2 * szB2) * sizeof(T));
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ffn_dw_kernel(const DwArgs p) {
  using L = DwLayout<T>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sA1 = reinterpret_cast<T*>(smem_raw);  // 2 stages
  T* sB1 = sA1 + 2 * L::szA1;               // 2 stages
  T* sA2 = sB1 + 2 * L::szB1;
  T* sB2 = sA2 + L::szA2;                   // 2 stages
  const int f0 = blockIdx.x * kWBF;
  const bool dw1 = static_cast<int>(blockIdx.y) < p.groups_k;
  const int g0 = (dw1 ? blockIdx.y : blockIdx.y - p.groups_k) * kNG;
  const int n_cols = dw1 ? p.k : p.n;
  const int width = round16(min(kNG, n_cols - g0));
  const void* b_src = dw1 ? p.x : p.dy;
  const bool vec = p.vec != 0;
  const int n_c1 = (p.n + L::kKc1 - 1) / L::kKc1;
  constexpr int n_c2 = kWBM / L::kKc2;

  Acc acc;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[e][q] = 0.f;
  }
  float db[4] = {};  // this thread's f32 dz column sums (dW1 blocks)

  for (int m0 = 0; m0 < p.m; m0 += kWBM) {
    if (dw1) {
      // dh (64 tokens x 32 ffn) = dy W2 over n in chunks, two stages
      auto stage1 = [&](int c) {
        const int kc0 = c * L::kKc1;
        load_tile<T>(sA1 + (c & 1) * L::szA1, L::ldA1, p.dy, p.code, m0, p.m, kWBM, kc0,
                            p.n, L::kKc1, vec);
        load_tile<T>(sB1 + (c & 1) * L::szB1, L::ldB1, p.w2, p.code, kc0, p.n, L::kKc1,
                            f0, p.f, kWBF, vec);
        cp_async_commit();
      };
      float t1[2][4] = {};
      stage1(0);
      for (int c = 0; c < n_c1; ++c) {
        if (c + 1 < n_c1) {
          stage1(c + 1);
          cp_async_wait(1);
        } else {
          cp_async_wait(0);
        }
        __syncthreads();
        tile_product<T, kWBM, kWBF>(t1, sA1 + (c & 1) * L::szA1, L::ldA1,
                                          sB1 + (c & 1) * L::szB1, L::ldB1, L::kKc1);
        __syncthreads();
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          int r, c;
          t1_rc<T, kWBM, kWBF>(threadIdx.x, a, q, r, c);
          const int row = m0 + r, col = f0 + c;
          const float z = row < p.m && col < p.f
                              ? load_f(p.z1, p.code, static_cast<int64_t>(row) * p.f + col)
                              : 0.f;
          const float dz = t1[a][q] * gelu_grad(z);  // rows past m: dy = 0, dz = 0
          db[kMma<T> ? a * 2 + (q & 1) : q] += dz;
          sA2[r * L::ldA2 + c] = to_smem<T>(round_code(dz, p.code));
        }
      }
    } else {
      for (int i = threadIdx.x; i < kWBM * kWBF; i += kThreads) {
        const int r = i / kWBF, c = i - r * kWBF;
        const int row = m0 + r, col = f0 + c;
        const float z = row < p.m && col < p.f
                            ? load_f(p.z1, p.code, static_cast<int64_t>(row) * p.f + col)
                            : 0.f;
        sA2[r * L::ldA2 + c] = to_smem<T>(round_code(gelu(z), p.code));
      }
    }
    // ACC (32 ffn rows x width) += A2^T (32 x 64 tokens) times x or dy
    auto stage2 = [&](int c) {
      load_tile<T>(sB2 + (c & 1) * L::szB2, L::ldB2, b_src, p.code, m0 + c * L::kKc2, p.m,
                          L::kKc2, g0, n_cols, width, vec);
      cp_async_commit();
    };
    stage2(0);
#pragma unroll 1
    for (int c = 0; c < n_c2; ++c) {
      if (c + 1 < n_c2) {
        stage2(c + 1);
        cp_async_wait(1);
      } else {
        cp_async_wait(0);
      }
      __syncthreads();  // also orders A2's stores before its first use
      acc_product<T, true>(acc, sA2 + c * L::kKc2 * L::ldA2, L::ldA2,
                                 sB2 + (c & 1) * L::szB2, L::ldB2, L::kKc2, width);
      __syncthreads();
    }
  }

#pragma unroll
  for (int e = 0; e < 32; ++e) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int r, c;
      acc_rc<T>(e, q, r, c);
      const int frow = f0 + r, col = g0 + c;
      if (frow >= p.f || col >= n_cols) continue;
      if (dw1) {
        store_f(p.dw1, p.code_w1, static_cast<int64_t>(frow) * p.k + col, acc[e][q]);
      } else {
        store_f(p.dw2, p.code_w2, static_cast<int64_t>(col) * p.f + frow, acc[e][q]);
      }
    }
  }
  if (dw1 && blockIdx.y == 0) {
    // db1: the threads' column partials summed per column in thread order
    float* red = reinterpret_cast<float*>(sB2);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 4; ++s) red[threadIdx.x * 4 + s] = db[s];
    __syncthreads();
    if (threadIdx.x < kWBF && f0 + static_cast<int>(threadIdx.x) < p.f) {
      float sum = 0.f;
      for (int t = 0; t < kThreads; ++t) {
        for (int s = 0; s < 4; ++s) {
          int r, c;
          if (kMma<T>) {
            t1_rc<T, kWBM, kWBF>(t, s >> 1, s & 1, r, c);
          } else {
            t1_rc<T, kWBM, kWBF>(t, 0, s, r, c);
          }
          if (c == static_cast<int>(threadIdx.x)) sum += red[t * 4 + s];
        }
      }
      p.db1[f0 + threadIdx.x] = sum;
    }
  }
}

template <typename T>
int launch_dw(const DwArgs& p, cudaStream_t s) {
  using L = DwLayout<T>;
  static bool attr_set = false;
  const int rc = set_smem(ffn_dw_kernel<T>, L::kBytes, attr_set);
  if (rc != 0) return rc;
  const dim3 grid(static_cast<unsigned>((p.f + kWBF - 1) / kWBF),
                  static_cast<unsigned>(p.groups_k + (p.n + kNG - 1) / kNG));
  ffn_dw_kernel<T><<<grid, kThreads, L::kBytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ffn
}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;
using namespace apex_tpu_torch::ffn;

// Ranges of the ffn axis per row block of dX for m token rows, f ffn
// columns, k columns of dX and a card of sms multiprocessors: the `splits`
// of apex_ffn_dx, whose partials scratch is (splits, m, k) f32.
extern "C" int apex_ffn_splits(int m, int f, int k, int sms) { return row_splits(m, f, k, sms); }

// dy: (m, n); z1: (m, f); w1: (f, k); w2: (n, f), all row-major in the
// activation dtype `dtype`; dx: (m, k) in `dtype`; partial: (splits, m, k)
// f32 scratch (splits from apex_ffn_splits(m, f, k, sms)).  Two launches:
// the row kernel, then the combine.
extern "C" int apex_ffn_dx(const void* dy, const void* z1, const void* w1, const void* w2,
                           void* dx, void* partial, int m, int k, int f, int n, int splits,
                           int dtype, void* stream) {
  if (m <= 0 || k <= 0) return 0;
  if (splits <= 0 || f <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  RowsArgs p;
  p.dy = dy;
  p.w1 = w1;
  p.w2 = w2;
  p.z1 = z1;
  p.partial = static_cast<float*>(partial);
  p.m = m;
  p.k = k;
  p.f = f;
  p.n = n;
  p.splits = splits;
  p.code = dtype;
  p.vec = k % 8 == 0 && f % 8 == 0 && n % 8 == 0 && aligned16(dy) && aligned16(w1) &&
          aligned16(w2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch_rows<bf16>(p, dx, s);
  return launch_rows<float>(p, dx, s);
}

// x: (m, k); dy: (m, n); z1: (m, f); w2: (n, f), row-major in `dtype`;
// dw1: (f, k) in w1_dtype; db1: (f,) f32; dw2: (n, f) in w2_dtype.  One
// launch; m = 0 writes zeros.
extern "C" int apex_ffn_dw(const void* x, const void* dy, const void* z1, const void* w2,
                           void* dw1, void* db1, void* dw2, int m, int k, int f, int n, int dtype,
                           int w1_dtype, int w2_dtype, void* stream) {
  if (f <= 0) return 0;
  if (m < 0 || k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  DwArgs p;
  p.x = x;
  p.dy = dy;
  p.z1 = z1;
  p.w2 = w2;
  p.dw1 = dw1;
  p.db1 = static_cast<float*>(db1);
  p.dw2 = dw2;
  p.m = m;
  p.k = k;
  p.f = f;
  p.n = n;
  p.groups_k = (k + kNG - 1) / kNG;
  p.code = dtype;
  p.code_w1 = w1_dtype;
  p.code_w2 = w2_dtype;
  p.vec = k % 8 == 0 && f % 8 == 0 && n % 8 == 0 && aligned16(x) && aligned16(dy) &&
          aligned16(w2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch_dw<bf16>(p, s);
  return launch_dw<float>(p, s);
}
