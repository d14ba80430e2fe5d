// Pieces shared by the port's tensor-core kernels (lm_head*.cu, ffn*.cu):
// cp.async copies into shared memory, ldmatrix fragment loads and the
// mma.sync m16n8k16 bf16 product with f32 accumulation, and the loads and
// stores of the f32 (FMA) instantiations, which read and write any float
// dtype through common.cuh's DType codes.
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

// A fragment (16 x 16) at (row0, k0) of a row-major tile with k contiguous
__device__ __forceinline__ void load_a(unsigned (&r)[4], const bf16* tile, int ld, int row0,
                                       int k0) {
  const int lane = threadIdx.x & 31, blk = lane >> 3;
  ldsm_x4<false>(r, tile + (row0 + (lane & 7) + (blk & 1) * 8) * ld + k0 + (blk >> 1) * 8);
}

// A fragment (16 x 16) of A = T^T, T stored k-major (row k, m contiguous),
// at (k0, m0) of T
__device__ __forceinline__ void load_a_t(unsigned (&r)[4], const bf16* tile, int ld, int k0,
                                         int m0) {
  const int lane = threadIdx.x & 31, blk = lane >> 3;
  ldsm_x4<true>(r, tile + (k0 + (lane & 7) + (blk >> 1) * 8) * ld + m0 + (blk & 1) * 8);
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

}  // namespace apex_tpu_torch
