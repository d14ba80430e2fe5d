// Shared pieces of the fused bias-GELU FFN kernels (ffn_fwd.cu, ffn_bwd.cu):
// the tanh GELU and its derivative, the tile loader, and the two products
// every kernel is built from, each in a tensor-core instantiation (bf16
// operands in shared memory, ldmatrix + mma.sync m16n8k16, f32
// accumulation) and an FMA instantiation (f32 operands in shared memory,
// for f32 and f16 activations).
//
// Layout.  A block of 8 warps computes one of two products per step:
//
// * a tile product, T1 (TM x TN, 8 f32 per thread) = A B over a contraction
//   streamed through shared memory in chunks of Tiles<T>::kKc1 columns: the
//   pre-activation z = x W1^T (forward), dh = dy W2 (dX, dW1);
// * an accumulating product, ACC (32 x kNG, 128 f32 per thread) += A B with
//   A a whole tile in shared memory and B streamed in chunks of
//   Tiles<T>::kKc2 rows: gelu(z) W2^T (forward), dz W1 (dX), dz^T x and
//   gelu(z)^T dy (dW1, dW2^T).
//
// The tensor-core instantiation gives each warp a 16 x 16 block of T1
// (mma fragments) and 32 rows x 128 columns of ACC, as the LM head's dX;
// the FMA one gives each thread 2 rows x 4 columns of T1 and 4 rows x 32
// columns of ACC.  Both describe an element they own by (row, column)
// through t1_rc / acc_rc, so the epilogues are written once.  Shared-memory
// rows are padded by 8 bf16 (16 bytes: the eight rows of an ldmatrix fall in
// eight bank groups) or 4 f32 (float4 reads stay aligned).
#pragma once

#include <type_traits>

#include "mma.cuh"

namespace apex_tpu_torch {
namespace ffn {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 32;        // token rows of a forward / dX block
constexpr int kBF = 64;        // ffn columns per step of a forward / dX block
constexpr int kNG = 1024;      // output columns of a block (wider outputs: more groups)
constexpr int kWBF = 32;       // ffn rows of a dW block
constexpr int kWBM = 64;       // token rows per step of a dW block

template <typename T> struct Tiles;
template <> struct Tiles<bf16> {
  static constexpr int kKc1 = 256;  // contraction columns per chunk of the tile product
  static constexpr int kKc2 = 16;   // contraction rows per chunk of the accumulating product
  static constexpr int kPad = 8;
};
template <> struct Tiles<float> {
  static constexpr int kKc1 = 32;
  static constexpr int kKc2 = 8;
  static constexpr int kPad = 4;
};

template <typename T>
constexpr bool kMma = std::is_same<T, bf16>::value;

constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluA = 0.044715f;

// tanh GELU (F.gelu(approximate="tanh"), jax.nn.gelu(approximate=True))
__device__ __forceinline__ float gelu(float z) {
  return 0.5f * z * (1.f + tanhf(kGeluC * z * (1.f + kGeluA * z * z)));
}

// its derivative in closed form (apex_tpu/ops/fused_ffn.py `_gelu_grad`)
__device__ __forceinline__ float gelu_grad(float z) {
  const float z2 = z * z;
  const float t = tanhf(kGeluC * z * (1.f + kGeluA * z2));
  return 0.5f * (1.f + t) + 0.5f * z * (1.f - t * t) * kGeluC * (1.f + 3.f * kGeluA * z2);
}

// v rounded to the activation dtype (code) and back, where the JAX kernels
// cast with astype
__device__ __forceinline__ float round_code(float v, int code) {
  switch (code) {
    case kBF16: return __bfloat162float(__float2bfloat16(v));
    case kF16: return __half2float(__float2half(v));
    default: return v;
  }
}

template <typename T> __device__ __forceinline__ T to_smem(float v);
template <> __device__ __forceinline__ bf16 to_smem<bf16>(float v) { return __float2bfloat16(v); }
template <> __device__ __forceinline__ float to_smem<float>(float v) { return v; }

// Copy rows [r0, r0 + rows) x columns [c0, c0 + cols) of a row-major
// (n_rows, n_cols) matrix in dtype `code` into shared memory (row stride ld;
// with kTrans element (r, c) goes to dst[c * ld + r]).  Entries outside the
// matrix are zero.  bf16 tiles take 16-byte cp.async copies when `vec` (every
// width a multiple of 8 and 16-byte aligned rows: a vector is all in or all
// out) and are committed by the caller; anything else is copied element by
// element.
template <typename T, bool kTrans>
__device__ __forceinline__ void load_tile(T* dst, int ld, const void* src, int code, int r0,
                                          int n_rows, int rows, int c0, int n_cols, int cols,
                                          bool vec) {
  if constexpr (kMma<T> && !kTrans) {
    if (vec) {
      const int vecs = cols / 8;
      const bf16* s = static_cast<const bf16*>(src);
      for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
        const int r = i / vecs;
        const int c = (i - r * vecs) * 8;
        const bool ok = r0 + r < n_rows && c0 + c < n_cols;
        const bf16* from = ok ? s + static_cast<int64_t>(r0 + r) * n_cols + c0 + c : s;
        cp_async16(dst + r * ld + c, from, ok ? 16 : 0);
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols;
    const int c = i - r * cols;
    const bool ok = r0 + r < n_rows && c0 + c < n_cols;
    const int64_t at = static_cast<int64_t>(r0 + r) * n_cols + c0 + c;
    T v;
    if constexpr (kMma<T>) {
      v = ok ? static_cast<const bf16*>(src)[at] : __float2bfloat16(0.f);
    } else {
      v = ok ? load_f(src, code, at) : 0.f;
    }
    dst[kTrans ? c * ld + r : r * ld + c] = v;
  }
}

// (row, column) in the TM x TN tile T1 of thread `tid`'s element t1[a][q]
template <typename T, int TM, int TN>
__device__ __forceinline__ void t1_rc(int tid, int a, int q, int& r, int& c) {
  if constexpr (kMma<T>) {
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    r = (warp / (TN / 16)) * 16 + g + 8 * (q >> 1);
    c = (warp % (TN / 16)) * 16 + 8 * a + 2 * t + (q & 1);
  } else {
    r = 2 * (tid / (TN / 4)) + a;
    c = 4 * (tid % (TN / 4)) + q;
  }
}

// T1 (TM x TN) += A B over one chunk of kc contraction steps: A row-major
// (row, k) with row stride lda; B (k x TN) stored k-major (row k, ldb) when
// kBKMajor, else n-major (row n, k contiguous).  The FMA instantiation always
// takes B k-major (the loader transposes it).
template <typename T, int TM, int TN, bool kBKMajor>
__device__ __forceinline__ void tile_product(float (&t1)[2][4], const T* a, int lda, const T* b,
                                             int ldb, int kc) {
  static_assert(TM * TN == kThreads * 8, "8 elements of T1 per thread");
  if constexpr (kMma<T>) {
    static_assert((TM / 16) * (TN / 16) == kWarps, "one 16 x 16 block per warp");
    const int warp = threadIdx.x >> 5;
    const int row0 = (warp / (TN / 16)) * 16, col0 = (warp % (TN / 16)) * 16;
#pragma unroll 4
    for (int k = 0; k < kc; k += 16) {
      unsigned fa[4], fb[4];
      load_a(fa, a, lda, row0, k);
      if (kBKMajor) {
        load_b_t(fb, b, ldb, k, col0);
      } else {
        load_b(fb, b, ldb, col0, k);
      }
      mma_bf16(t1[0], fa, fb[0], fb[1]);
      mma_bf16(t1[1], fa, fb[2], fb[3]);
    }
  } else {
    const int r0 = 2 * (threadIdx.x / (TN / 4)), c0 = 4 * (threadIdx.x % (TN / 4));
#pragma unroll 8
    for (int k = 0; k < kc; ++k) {
      const float a0 = a[r0 * lda + k], a1 = a[(r0 + 1) * lda + k];
      const float4 bv = *reinterpret_cast<const float4*>(b + k * ldb + c0);
      t1[0][0] = fmaf(a0, bv.x, t1[0][0]);
      t1[0][1] = fmaf(a0, bv.y, t1[0][1]);
      t1[0][2] = fmaf(a0, bv.z, t1[0][2]);
      t1[0][3] = fmaf(a0, bv.w, t1[0][3]);
      t1[1][0] = fmaf(a1, bv.x, t1[1][0]);
      t1[1][1] = fmaf(a1, bv.y, t1[1][1]);
      t1[1][2] = fmaf(a1, bv.z, t1[1][2]);
      t1[1][3] = fmaf(a1, bv.w, t1[1][3]);
    }
  }
}

using Acc = float[32][4];

// (row, column) in the 32 x kNG accumulator of this thread's acc[e][q]
template <typename T>
__device__ __forceinline__ void acc_rc(int e, int q, int& r, int& c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (kMma<T>) {
    const int g = lane >> 2, t = lane & 3;
    r = 16 * (e >> 4) + g + 8 * (q >> 1);
    c = warp * 128 + 8 * (e & 15) + 2 * t + (q & 1);
  } else {
    r = 4 * warp + (e >> 3);
    c = 4 * lane + 128 * (e & 7) + q;
  }
}

// ACC (32 x width) += A B over kc contraction steps: A (32 x kc) stored
// row-major (row, k; lda), or with kATrans k-major (row k, 32 columns);
// B (kc x width) stored k-major (row k; ldb) when kBKMajor, else n-major
// (FMA: always k-major).  width is the group's output width rounded up to
// 16; warps (mma) or lanes (FMA) past it skip.
template <typename T, bool kATrans, bool kBKMajor>
__device__ __forceinline__ void acc_product(Acc& acc, const T* a, int lda, const T* b, int ldb,
                                            int kc, int width) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (kMma<T>) {
    const int col0 = warp * 128;
    if (col0 >= width) return;
    for (int kk = 0; kk < kc; kk += 16) {
      unsigned fa[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (kATrans) {
          load_a_t(fa[i], a, lda, kk, i * 16);
        } else {
          load_a(fa[i], a, lda, i * 16, kk);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + j * 16;
        if (col < width) {
          unsigned fb[4];
          if (kBKMajor) {
            load_b_t(fb, b, ldb, kk, col);
          } else {
            load_b(fb, b, ldb, col, kk);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(acc[i * 16 + 2 * j], fa[i], fb[0], fb[1]);
            mma_bf16(acc[i * 16 + 2 * j + 1], fa[i], fb[2], fb[3]);
          }
        }
      }
    }
  } else {
    for (int kk = 0; kk < kc; ++kk) {
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * warp + i;
        av[i] = kATrans ? a[kk * lda + r] : a[r * lda + kk];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 4 * lane + 128 * j;
        if (c < width) {
          const float4 bv = *reinterpret_cast<const float4*>(b + kk * ldb + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* o = acc[i * 8 + j];
            o[0] = fmaf(av[i], bv.x, o[0]);
            o[1] = fmaf(av[i], bv.y, o[1]);
            o[2] = fmaf(av[i], bv.z, o[2]);
            o[3] = fmaf(av[i], bv.w, o[3]);
          }
        }
      }
    }
  }
}

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// Allow a kernel `bytes` of dynamic shared memory (once per kernel: `done`
// is the caller's flag); returns a cudaError_t.
template <typename Kernel>
int set_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  done = true;
  return 0;
}

// ---------------------------------------------------------------------------
// The row kernel of the forward (#11) and dX (#12): a block owns kBM token
// rows and one group of at most kNG output columns, and walks its range of
// the ffn axis in steps of kBF columns.  Per step, the tile product gives z
// (forward: x W1^T + b1) or dh (dX: dy W2) for kBM x kBF, the epilogue turns
// it into the activation tile A2 in shared memory (forward: gelu(z), z stored
// as z1; dX: dh gelu'(z1)), both rounded to the activation dtype, and the
// accumulating product adds A2 W2^T (forward) or A2 W1 (dX) into the block's
// (kBM, kNG) f32 accumulator in registers.  The (tokens, ffn) activation
// never reaches device memory.  Blocks run in no order, so the ffn axis is
// split into `splits` ranges (enough blocks for the card at small token
// counts); each writes its f32 partial and a second launch sums them per
// entry in a fixed order (no float atomics).

struct RowsArgs {
  const void* a;      // x (forward) or dy (dX): (m, k) or (m, n)
  const void* w1;     // (f, k)
  const void* w2;     // (n, f)
  const float* b1;    // forward: (f,) f32
  const void* z1_in;  // dX: (m, f)
  void* z1_out;       // forward: (m, f)
  float* partial;     // (splits, m, n or k) f32
  int m, k, f, n, splits, code, vec;
};

template <typename T, bool kBwd>
struct RowsLayout {
  static constexpr int kKc1 = Tiles<T>::kKc1, kKc2 = Tiles<T>::kKc2, kPad = Tiles<T>::kPad;
  // B of the tile product: W1 rows (forward, n-major) or W2 rows (dX,
  // k-major); of the accumulating product: W2 rows (forward, n-major) or W1
  // rows (dX, k-major).  The FMA loader stores every B k-major.
  static constexpr bool kB1K = kBwd || !kMma<T>;
  static constexpr bool kB2K = kBwd || !kMma<T>;
  static constexpr int ldA1 = kKc1 + kPad, szA1 = kBM * ldA1;
  static constexpr int ldB1 = kB1K ? kBF + kPad : kKc1 + kPad;
  static constexpr int szB1 = kB1K ? kKc1 * ldB1 : kBF * ldB1;
  static constexpr int ldA2 = kBF + kPad, szA2 = kBM * ldA2;
  static constexpr int ldB2 = kB2K ? kNG + kPad : kKc2 + kPad;
  static constexpr int szB2 = kB2K ? kKc2 * ldB2 : kNG * ldB2;
  static constexpr int kBytes =
      static_cast<int>((2 * szA1 + 2 * szB1 + szA2 + 2 * szB2) * sizeof(T));
};

template <typename T, bool kBwd>
__global__ void __launch_bounds__(kThreads, 1) ffn_rows_kernel(const RowsArgs p) {
  using L = RowsLayout<T, kBwd>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sA1 = reinterpret_cast<T*>(smem_raw);  // 2 stages
  T* sB1 = sA1 + 2 * L::szA1;               // 2 stages
  T* sA2 = sB1 + 2 * L::szB1;
  T* sB2 = sA2 + L::szA2;                   // 2 stages
  const int k1 = kBwd ? p.n : p.k;          // contraction of the tile product
  const int n2 = kBwd ? p.k : p.n;          // output columns
  const int m0 = blockIdx.x * kBM;
  const int g0 = blockIdx.y * kNG;
  const int width = round16(min(kNG, n2 - g0));
  const int n_ft = (p.f + kBF - 1) / kBF;
  const int split = blockIdx.z;
  const int ft_lo = static_cast<int>(static_cast<int64_t>(split) * n_ft / p.splits);
  const int ft_hi = static_cast<int>(static_cast<int64_t>(split + 1) * n_ft / p.splits);
  const bool vec = p.vec != 0;
  const int n_c1 = (k1 + L::kKc1 - 1) / L::kKc1;
  constexpr int n_c2 = kBF / L::kKc2;

  Acc acc;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[e][q] = 0.f;
  }

  for (int ft = ft_lo; ft < ft_hi; ++ft) {
    const int f0 = ft * kBF;
    // z or dh (kBM x kBF) over the contraction in chunks, two stages
    auto stage1 = [&](int c) {
      const int kc0 = c * L::kKc1;
      load_tile<T, false>(sA1 + (c & 1) * L::szA1, L::ldA1, p.a, p.code, m0, p.m, kBM, kc0, k1,
                          L::kKc1, vec);
      if (kBwd) {  // W2 rows kc0.. (n), columns f0.. (f)
        load_tile<T, false>(sB1 + (c & 1) * L::szB1, L::ldB1, p.w2, p.code, kc0, p.n, L::kKc1,
                            f0, p.f, kBF, vec);
      } else {     // W1 rows f0.. (f), columns kc0.. (k)
        load_tile<T, !kMma<T>>(sB1 + (c & 1) * L::szB1, L::ldB1, p.w1, p.code, f0, p.f, kBF,
                               kc0, p.k, L::kKc1, vec);
      }
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
      tile_product<T, kBM, kBF, L::kB1K>(t1, sA1 + (c & 1) * L::szA1, L::ldA1,
                                         sB1 + (c & 1) * L::szB1, L::ldB1, L::kKc1);
      __syncthreads();
    }
    // epilogue: the activation tile A2, rounded to the activation dtype
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int r, c;
        t1_rc<T, kBM, kBF>(threadIdx.x, a, q, r, c);
        const int row = m0 + r, col = f0 + c;
        const bool in = row < p.m && col < p.f;
        const int64_t at = static_cast<int64_t>(row) * p.f + col;
        float v;
        if (kBwd) {
          const float z = in ? load_f(p.z1_in, p.code, at) : 0.f;
          v = t1[a][q] * gelu_grad(z);
        } else {
          const float z = t1[a][q] + (col < p.f ? p.b1[col] : 0.f);
          if (in && blockIdx.y == 0) store_f(p.z1_out, p.code, at, z);
          v = gelu(z);  // of the unrounded z, as the TPU kernel
        }
        sA2[r * L::ldA2 + c] = to_smem<T>(round_code(v, p.code));
      }
    }
    // ACC += A2 (kBM x kBF) times W2^T (forward) or W1 (dX), B in chunks
    auto stage2 = [&](int c) {
      const int fc0 = f0 + c * L::kKc2;
      if (kBwd) {  // W1 rows fc0.. (f), columns g0.. (k)
        load_tile<T, false>(sB2 + (c & 1) * L::szB2, L::ldB2, p.w1, p.code, fc0, p.f, L::kKc2,
                            g0, p.k, width, vec);
      } else {     // W2 rows g0.. (n), columns fc0.. (f)
        load_tile<T, !kMma<T>>(sB2 + (c & 1) * L::szB2, L::ldB2, p.w2, p.code, g0, p.n, width,
                               fc0, p.f, L::kKc2, vec);
      }
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
      __syncthreads();  // also orders the epilogue's A2 before its first use
      acc_product<T, false, L::kB2K>(acc, sA2 + c * L::kKc2, L::ldA2, sB2 + (c & 1) * L::szB2,
                                     L::ldB2, L::kKc2, width);
      __syncthreads();
    }
  }

  float* out = p.partial + static_cast<int64_t>(split) * p.m * n2;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int r, c;
      acc_rc<T>(e, q, r, c);
      const int row = m0 + r, col = g0 + c;
      if (row < p.m && col < n2) out[static_cast<int64_t>(row) * n2 + col] = acc[e][q];
    }
  }
}

// The second launch: out = sum of the split partials in ascending split
// order (+ bias, f32), in the output dtype.
static __global__ void ffn_combine_kernel(const float* __restrict__ partial,
                                          const float* __restrict__ bias, void* __restrict__ out,
                                          int code, int64_t rows, int cols, int splits) {
  const int64_t total = rows * cols;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += partial[s * total + i];
    if (bias != nullptr) v += bias[i % cols];
    store_f(out, code, i, v);
  }
}

// Ranges of the ffn axis per (row block, column group), so that the blocks
// fill the card in one wave where they can (a block takes one SM's shared
// memory): the most ranges with blocks x ranges <= sms, at least 1, at
// most the ffn steps.
inline int row_splits(int m, int f, int n_out, int sms) {
  const int blocks = ((m + kBM - 1) / kBM) * ((n_out + kNG - 1) / kNG);
  const int steps = (f + kBF - 1) / kBF;
  const int want = sms / blocks;
  const int splits = want < steps ? want : steps;
  return splits < 1 ? 1 : splits;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The two launches of the forward or dX; returns a cudaError_t.
template <typename T, bool kBwd>
int launch_rows(const RowsArgs& p, const float* bias, void* out, cudaStream_t s) {
  using L = RowsLayout<T, kBwd>;
  static bool attr_set = false;
  const int rc = set_smem(ffn_rows_kernel<T, kBwd>, L::kBytes, attr_set);
  if (rc != 0) return rc;
  const int n2 = kBwd ? p.k : p.n;
  const dim3 grid(static_cast<unsigned>((p.m + kBM - 1) / kBM),
                  static_cast<unsigned>((n2 + kNG - 1) / kNG), static_cast<unsigned>(p.splits));
  ffn_rows_kernel<T, kBwd><<<grid, kThreads, L::kBytes, s>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t total = static_cast<int64_t>(p.m) * n2;
  const int64_t blocks = (total + 255) / 256 < 65536 ? (total + 255) / 256 : 65536;
  ffn_combine_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(p.partial, bias, out, p.code,
                                                                   p.m, n2, p.splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ffn
}  // namespace apex_tpu_torch
