// Pieces shared by the port's tensor-core kernels (gemm.cuh and through it
// lm_head*.cu, ffn*.cu and quant_gemm.cu; ffn.cuh; the bf16 flash_fwd.cu /
// flash_bwd_dq.cu / flash_bwd_dkv.cu):
// cp.async copies into shared memory, ldmatrix fragment loads and the
// mma.sync m16n8k16 bf16 product with f32 accumulation, the dynamic
// shared-memory opt-in, and the loads and stores of the f32 (FMA)
// instantiations, which read and write any float dtype through common.cuh's
// DType codes.
#pragma once

#include "common.cuh"

namespace apex_tpu_torch {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's cp.async groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}
// Stage rows [r0, r0 + kRows) of a bf16 operand whose rows are kCols
// contiguous elements ld apart (kCols a multiple of 8; the base and ld*2
// bytes 16-byte aligned) into a shared tile of row stride ldt with 16-byte
// cp.async copies shared out over kThreads threads; rows at or past n_rows
// read zeros (src_bytes 0).  The caller commits.
template <int kRows, int kCols, int kThreads>
__device__ __forceinline__ void cp_async_rows(bf16* tile, int ldt, const bf16* src, int64_t ld,
                                              int r0, int n_rows) {
  constexpr int kVecs = kCols / 8;
  static_assert(kCols % 8 == 0, "rows of whole 16-byte vectors");
#pragma unroll
  for (int i = threadIdx.x; i < kRows * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * 8;
    const bool ok = r0 + r < n_rows;
    cp_async16(tile + r * ldt + c, ok ? src + static_cast<int64_t>(r0 + r) * ld + c : src,
               ok ? 16 : 0);
  }
}

// Warp-level tensor-core pieces.  A lane's address of an ldmatrix.x4 names
// one row of one of four 8x8 bf16 blocks (lanes 8i..8i+7: block i); the
// fragment layouts are those of mma.m16n8k16 (g = lane / 4, t = lane % 4):
// A (16x16): a0 (row g, k 2t..2t+1), a1 (row g+8), a2 (k + 8), a3 (both);
// B (16x8): b0 (k 2t..2t+1, col g), b1 (k + 8); C (16x8 f32): c0, c1
// (row g, cols 2t, 2t+1), c2, c3 (row g+8).
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  if (kTrans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p))
                 : "memory");
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p))
                 : "memory");
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (nearest even, as jnp.astype) in one register,
// lo in the low half: two adjacent n8 C tiles of a product become one k16 A
// fragment of the next (a0 = {c0, c1} of tile 2i, a1 = {c2, c3} of tile 2i,
// a2 / a3 the same of tile 2i + 1)
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// A fragment (16 x 16) at (row0, k0) of a row-major tile with k contiguous
__device__ __forceinline__ void load_a(unsigned (&r)[4], const bf16* tile, int ld, int row0,
                                       int k0) {
  const int lane = threadIdx.x & 31, blk = lane >> 3;
  ldsm_x4<false>(r, tile + (row0 + (lane & 7) + (blk & 1) * 8) * ld + k0 + (blk >> 1) * 8);
}

// two B fragments (k 16 x n 16: r0, r1 for n0..n0+7; r2, r3 for n0+8..) of
// B = T^T, T stored n-major (row n, k contiguous), at (n0, k0) of T
__device__ __forceinline__ void load_b(unsigned (&r)[4], const bf16* tile, int ld, int n0,
                                       int k0) {
  const int lane = threadIdx.x & 31, blk = lane >> 3;
  ldsm_x4<false>(r, tile + (n0 + (lane & 7) + (blk >> 1) * 8) * ld + k0 + (blk & 1) * 8);
}

// the same two B fragments of B stored k-major (row k, n contiguous), at
// (k0, n0)
__device__ __forceinline__ void load_b_t(unsigned (&r)[4], const bf16* tile, int ld, int k0,
                                         int n0) {
  const int lane = threadIdx.x & 31, blk = lane >> 3;
  ldsm_x4<true>(r, tile + (k0 + (lane & 7) + (blk & 1) * 8) * ld + n0 + (blk >> 1) * 8);
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }


// the f32 (FMA) instantiations read and write any float dtype through these
__device__ __forceinline__ float load_f(const void* p, int code, int64_t i) {
  switch (code) {
    case kBF16: return __bfloat162float(static_cast<const bf16*>(p)[i]);
    case kF16: return __half2float(static_cast<const __half*>(p)[i]);
    default: return static_cast<const float*>(p)[i];
  }
}

__device__ __forceinline__ void store_f(void* p, int code, int64_t i, float v) {
  switch (code) {
    case kBF16: static_cast<bf16*>(p)[i] = __float2bfloat16(v); break;
    case kF16: static_cast<__half*>(p)[i] = __float2half(v); break;
    default: static_cast<float*>(p)[i] = v;
  }
}

// v0 at p[i], v1 at p[i + 1] when two, rounded to the dtype `code`; a pair
// at an even index goes as one store (the GEMM epilogues' outputs are
// allocated by the wrappers, so it is aligned)
__device__ __forceinline__ void store_pair(void* p, int code, int64_t i, float v0, float v1,
                                           bool two) {
  if (two && (i & 1) == 0 && code == kF32) {
    *reinterpret_cast<float2*>(static_cast<float*>(p) + i) = make_float2(v0, v1);
  } else if (two && (i & 1) == 0 && code == kBF16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p) + i) = __floats2bfloat162_rn(v0, v1);
  } else if (two && (i & 1) == 0 && code == kF16) {
    *reinterpret_cast<__half2*>(static_cast<__half*>(p) + i) = __floats2half2_rn(v0, v1);
  } else {
    store_f(p, code, i, v0);
    if (two) store_f(p, code, i + 1, v1);
  }
}

}  // namespace apex_tpu_torch
