// A tiled GEMM for Hopper, C (M x N) = A B with f32 accumulation and a
// caller's epilogue that receives each output pair (row, col), (row, col +
// 1) in f32 (col even).  Each operand is row-major in one of two layouts,
// a template flag of the TMA and FMA kernels:
//   K-major (flag false): the contraction contiguous, A stored (M x K), B
//     stored (N x K): "NT", W x^T with W in its (out, in) layout;
//   MN-major (flag true): A stored (K x M), B stored (K x N).
// The FFN forward (ffn_fwd.cu) runs its two NT products on it; the FFN
// backward (ffn_bwd.cu) its four: dy W2 and dz W1 (B MN-major), dz^T x and
// dy^T h (both MN-major, the contraction over tokens); the LM-head backward
// (lm_head_bwd.cu) three per vocab chunk: x W_c^T (NT), dS_c W_c (B
// MN-major, the sum carried across chunks in the accumulator's seed) and
// dS_c^T x (both MN-major); the LM-head forward (lm_head_fwd.cu) one, x W^T
// (NT) reduced to per-row logsumexp partials.
//
// What bounds such a product on the H100 at training width: operations
// (989 TFLOP/s of bf16), as long as the operand tiles reach shared memory
// fast enough.  Tiles copied by the threads themselves (16-byte cp.async)
// top out near 3 TB/s of L2-to-shared traffic, which holds a 128 x 256 tile
// (85 flops per byte) to about 280 TFLOP/s; the Tensor Memory Accelerator
// (TMA) moves the same tiles at twice that rate.  So bf16 operands at
// training and prefill width run the Hopper shape:
//
// * a block of three warpgroups over a 128 x BN tile of C (BN 256 or 128):
//   one thread of the first issues TMA copies of each stage's 128 x 64
//   tile of A and BN x 64 tile of B into a ring of kTmaStages stages,
//   128-byte swizzled as wgmma reads them, announced to an mbarrier per
//   stage ("full").  A K-major tile is one box of 64 contraction columns
//   by 128 (or BN) rows; an MN-major tile is 64-wide boxes along M (or N),
//   each 64 contraction rows deep: one 128-byte swizzle atom wide, so the
//   boxes sit 8 KB apart;
// * the other two warpgroups each own 64 rows, wait on a stage's full
//   barrier, run wgmma m64n128k16 on it (A and B straight from shared
//   memory through 64-bit descriptors; an MN-major operand sets wgmma's
//   transpose immediate and its descriptor's leading offset to the 8 KB
//   between swizzle atoms, and steps 16 contraction rows as 2 KB), wait
//   for their products and hand the stage back through its "empty"
//   mbarrier, which the producer waits on before it refills the stage;
// * TMA zero-fills rows and contraction columns outside the matrices;
// * the two consumers stage their C tile through the drained ring and write
//   it row by row (coalesced stores through the epilogue).  An epilogue
//   that reads a second matrix of C's shape at each entry (aux_tile: the
//   FFN backward's z1) gets its tile copied into the drained ring with
//   16-byte cp.async copies, in flight while C is staged, and takes each
//   pair of it from shared memory; one with a col_sum member returns a
//   value per entry, and the block sums those down its 128 rows in row
//   order (the FFN backward's db1 partials).  An epilogue with a seed (an
//   f32 matrix of C's shape) starts the accumulators from it instead of
//   zero, so that a sum over several launches stays in f32 (the LM head's
//   dX over vocab chunks);
// * an epilogue with per-row values (row_values: the LM head's lse,
//   cotangent and target) and a bf16 output of its own takes a persistent
//   form of the NT block (gemm_tma_rows_kernel): the epilogue of one tile
//   runs while the producer loads the next, and the tile goes out through
//   a swizzled shared tile and a TMA store that runs on under the next
//   mainloop.  A short contraction (the LM head's H) makes each tile's
//   prologue and epilogue a large share of its time.  An epilogue with
//   row partials instead (row_partial: the LM head forward's logsumexp)
//   stores no tile: per row of C and column tile it gets the scores of
//   that row the thread holds, reduces them across the lanes that share
//   the row and writes one partial, all in registers; the ring takes the
//   output tile's shared memory as a fourth stage.
//
// In gemm_nt (the forward) a few token rows (decode), and operands whose
// rows are not 16-byte multiples or bases not 16-byte aligned, take
// mma.sync m16n8k16 on narrow
// 16 x 16 or 16 x 8 column tiles instead: the card is covered by column
// tiles, each stage's 256 or 512 contraction columns split over 8 warps
// whose pieces are summed through shared memory in a fixed warp order, and
// 16-byte cp.async copies (element-wise loads off the 16-byte grid) over a
// ring of 4 stages.
//
// Each output entry is summed by one block in a fixed order (no split of
// the contraction across blocks, no atomics): a repeat gives the same bits.
//
// f32 and f16 operands, and in gemm() (the backwards, the LM-head forward)
// bf16 operands off TMA's 16-byte grid, run a register-blocked FMA tile
// (128 x 128 per block, 8 x 8 per thread, f32 arithmetic), staged through
// registers into double-buffered k-major shared tiles (any dtype:
// common.cuh's codes); an MN-major operand is read along M (or N) and
// stored transposed.
#pragma once

#include <cuda.h>

#include <type_traits>
#include <utility>

#include "mma.cuh"

namespace apex_tpu_torch {
namespace gemm {

// ---------------------------------------------------------------------------
// TMA + wgmma (bf16, most rows)

constexpr int kTmaBM = 128;      // rows of C per block: two consumer warpgroups of 64
constexpr int kTmaBK = 64;       // contraction columns per stage: one 128-byte swizzle row
constexpr int kTmaStages = 4;
constexpr int kTmaThreads = 384;  // producer warpgroup + two consumers

// the wgmma descriptor of a 128-byte-swizzled K-major tile at shared address
// `addr`: rows of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// An MN-major tile is 64-wide swizzle atoms along M (or N), each kTmaBK
// contraction rows of 128 bytes (one TMA box): its descriptor's leading
// offset is the distance between atoms, its stride the 1024 bytes between
// 8-row groups along the contraction
constexpr int kAtomBytes = 64 * 64 * 2;

__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kAtomBytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// the descriptor of k16 step `k16` of a stage's tile at `addr`: 32 bytes
// along a K-major row, 16 rows (2 KB) down an MN-major atom
template <bool kMN>
__device__ __forceinline__ uint64_t desc_k16(uint32_t addr, int k16) {
  if constexpr (kMN) return desc_sw128_mn(addr + 2048 * k16);
  return desc_sw128(addr + 32 * k16);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` completes; a phase that never
// completes (a lost arrival) traps after about two seconds rather than hang
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 4000000000LL) __trap();
  }
}

// TMA: the box at (column c0, row c1) of `map` into shared memory, counted
// on `bar`
__device__ __forceinline__ void tma_load(bf16* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// D (64 x 128 f32) += A B on the tensor cores for one warpgroup, A (64 x
// 16) and B (16 x 128) read from shared memory through their descriptors,
// each K-major or, with its transpose immediate (kTA, kTB) set, MN-major.
// d holds, per warp of the group, the C fragments of mma.sync m16n8 for its
// 16 rows and the 16 n8 tiles in order.
template <bool kTA, bool kTB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTA ? 1 : 0), "n"(kTB ? 1 : 0));
}

// Keeps the compiler from moving reads of registers that an asynchronous
// wgmma writes above the wgmma.wait_group that completes it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The ring of stages, which later holds the f32 C tile (128 x (BN + 4))
// and, for an epilogue with an aux tile, that tile (128 x BN bf16) after
// it; then the mbarriers and the 1024-byte alignment.
template <int BN, bool kAux>
__host__ __device__ constexpr int tma_region_bytes() {
  constexpr int ring = kTmaStages * (kTmaBM + BN) * kTmaBK * 2;
  constexpr int epilogue = kTmaBM * (BN + 4) * 4 + (kAux ? kTmaBM * BN * 2 : 0);
  return ring > epilogue ? ring : epilogue;
}

template <int BN, bool kAux>
constexpr int tma_smem_bytes() {
  return tma_region_bytes<BN, kAux>() + 2 * kTmaStages * 8 + 1024;
}

// An epilogue whose col_sum member takes (row block, col, sum) returns a
// float2 per pair; the kernels sum those down each block's 128 rows.
template <class Epi, class = void>
struct HasColSum : std::false_type {};
template <class Epi>
struct HasColSum<Epi, std::void_t<decltype(&Epi::col_sum)>> : std::true_type {};

// A row-major (rows, cols) matrix of C's shape in dtype `code` that an
// epilogue reads at each entry: an epilogue whose aux_tile() returns one
// takes its pair (row, col), (row, col + 1) in f32 as a fifth argument.
// The TMA kernel (bf16) copies it in 16-byte pieces: cols a multiple of 8,
// the base 16-byte aligned, which gemm() checks on the host (aux_tile() is
// __host__ __device__).
struct AuxTile {
  const void* p;
  int rows, cols, code;
};

template <class Epi, class = void>
struct HasAux : std::false_type {};
template <class Epi>
struct HasAux<Epi, std::void_t<decltype(&Epi::aux_tile)>> : std::true_type {};

// An epilogue whose row_values(row) returns a value per row of C (any
// trivially copyable type) takes that row's value as a fifth argument
// instead of an aux pair.
template <class Epi, class = void>
struct HasRows : std::false_type {
  using type = float;
};
template <class Epi>
struct HasRows<Epi, std::void_t<decltype(&Epi::row_values)>> : std::true_type {
  using type = decltype(std::declval<const Epi&>().row_values(0));
};

// An epilogue whose seed() returns an AuxTile of f32 (p null: none) has
// its accumulators start from that matrix's entries (zero outside it).
template <class Epi, class = void>
struct HasSeed : std::false_type {};
template <class Epi>
struct HasSeed<Epi, std::void_t<decltype(&Epi::seed)>> : std::true_type {};

// An epilogue with row values whose is_row_partial member is true reduces
// each row of a column tile to one partial instead of storing C: the
// kernels call epi.row_partial<kLanes, K>(row, tile, val, col, row value)
// where val(i), i < K, are the entries of that row the thread holds, at
// columns col(i), increasing in i; the kLanes lanes (aligned, a power of
// two) that share the row call it together, with the other lanes of the
// warp.  NT products only, through gemm(); the column tiles are
// row_partial_cols() wide.
template <class Epi, class = void>
struct HasRowPartials : std::false_type {};
template <class Epi>
struct HasRowPartials<Epi, std::void_t<decltype(Epi::is_row_partial)>>
    : std::bool_constant<Epi::is_row_partial> {};

// `extra` is the pair's aux values or its row's value, whichever the
// epilogue takes
template <class Epi, class Extra>
__device__ __forceinline__ auto call_epi(const Epi& epi, int row, int col, float v0, float v1,
                                         const Extra& extra) {
  static_assert(!(HasAux<Epi>::value && HasRows<Epi>::value), "aux tile or row values");
  if constexpr (HasAux<Epi>::value || HasRows<Epi>::value) {
    return epi(row, col, v0, v1, extra);
  } else {
    return epi(row, col, v0, v1);
  }
}

// the seed's entry at (row, col), 0 outside it
__device__ __forceinline__ float seed_at(const AuxTile& sd, int row, int col) {
  return row < sd.rows && col < sd.cols
             ? static_cast<const float*>(sd.p)[static_cast<int64_t>(row) * sd.cols + col]
             : 0.f;
}

template <int BN, bool kTA, bool kTB, class Epi>
__global__ void __launch_bounds__(kTmaThreads, 1)
gemm_tma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                int k, const Epi epi) {
  constexpr int kStageA = kTmaBM * kTmaBK, kStageB = BN * kTmaBK;  // bf16 elements
  constexpr int NH = BN / 128;  // wgmma n128 products per k16 step
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: stages start on that grid
  const uint32_t raw = smem_u32(smem_raw);
  bf16* sa = reinterpret_cast<bf16*>(smem_raw + (((raw + 1023u) & ~1023u) - raw));
  bf16* sb = sa + kTmaStages * kStageA;
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(sa) +
                                               tma_region_bytes<BN, HasAux<Epi>::value>());
  uint64_t* empty = full + kTmaStages;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int m0 = blockIdx.y * kTmaBM, n0 = blockIdx.x * BN;
  const int nk = (k + kTmaBK - 1) / kTmaBK;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kTmaStages; ++i) {
      mbar_init(&full[i], 1);   // the producer's arrival, plus the TMA bytes
      mbar_init(&empty[i], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kTmaStages;
        if (kt >= kTmaStages) mbar_wait(&empty[s], (kt / kTmaStages - 1) & 1);
        mbar_expect_tx(&full[s], (kStageA + kStageB) * 2);
        if constexpr (kTA) {
#pragma unroll
          for (int a = 0; a < kTmaBM / 64; ++a) {
            tma_load(sa + s * kStageA + a * 64 * kTmaBK, &ta, m0 + 64 * a, kt * kTmaBK, &full[s]);
          }
        } else {
          tma_load(sa + s * kStageA, &ta, kt * kTmaBK, m0, &full[s]);
        }
        if constexpr (kTB) {
#pragma unroll
          for (int b = 0; b < BN / 64; ++b) {
            tma_load(sb + s * kStageB + b * 64 * kTmaBK, &tb, n0 + 64 * b, kt * kTmaBK, &full[s]);
          }
        } else {
          tma_load(sb + s * kStageB, &tb, kt * kTmaBK, n0, &full[s]);
        }
      }
    }
    return;
  }

  const int cw = wg - 1;  // this consumer's 64 rows of the tile
  float acc[NH][64];
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  }
  if constexpr (HasSeed<Epi>::value) {
    // C fragment j of product h: (r0, c), (r0, c + 1), (r0 + 8, c), (r0 + 8, c + 1)
    const int lane = tid & 31, t4 = lane & 3;
    const int r0 = cw * 64 + (tid >> 5) * 16 + (lane >> 2);
    const AuxTile sd = epi.seed();
    if (sd.p != nullptr) {
#pragma unroll
      for (int h = 0; h < NH; ++h) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = n0 + h * 128 + j * 8 + 2 * t4;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[h][j * 4 + e] = seed_at(sd, m0 + r0 + (e >> 1) * 8, c + (e & 1));
          }
        }
      }
    }
  }
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kTmaStages;
    mbar_wait(&full[s], (kt / kTmaStages) & 1);
    // 64 rows of A and 128 columns of B are 8 KB and 16 KB in either layout
    const uint32_t a_addr = smem_u32(sa + s * kStageA + cw * 64 * kTmaBK);
    const uint32_t b_addr = smem_u32(sb + s * kStageB);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k16 = 0; k16 < kTmaBK / 16; ++k16) {
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        wgmma_n128<kTA, kTB>(acc[h], desc_k16<kTA>(a_addr, k16),
                             desc_k16<kTB>(b_addr + h * 128 * kTmaBK * 2, k16));
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (tid == 0) mbar_arrive(&empty[s]);  // the stage may be refilled
  }

  // the epilogue: both consumers' tiles go through the drained ring as f32
  // (row stride BN + 4), then the 256 consumer threads hand out row-major
  // pairs, so a warp's 32 stores cover contiguous columns
  constexpr int LDC = BN + 4;
  float* sc = reinterpret_cast<float*>(sa);
  bf16* saux = reinterpret_cast<bf16*>(sc + kTmaBM * LDC);  // the aux tile, row stride BN
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both consumers are done with the ring
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if constexpr (HasAux<Epi>::value) {
    const AuxTile x = epi.aux_tile();
    const bf16* src = static_cast<const bf16*>(x.p);
    for (int i = threadIdx.x - 128; i < kTmaBM * BN / 8; i += 256) {
      const int r = i / (BN / 8), c = (i - r * (BN / 8)) * 8;
      const bool ok = m0 + r < x.rows && n0 + c < x.cols;
      cp_async16(saux + r * BN + c, ok ? src + static_cast<int64_t>(m0 + r) * x.cols + n0 + c : src,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  }
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = cw * 64 + warp * 16 + g;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = h * 128 + j * 8 + 2 * t4;
      *reinterpret_cast<float2*>(sc + r0 * LDC + c) = make_float2(acc[h][j * 4], acc[h][j * 4 + 1]);
      *reinterpret_cast<float2*>(sc + (r0 + 8) * LDC + c) =
          make_float2(acc[h][j * 4 + 2], acc[h][j * 4 + 3]);
    }
  }
  if constexpr (HasAux<Epi>::value) cp_async_wait(0);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  for (int i = threadIdx.x - 128; i < kTmaBM * BN / 2; i += 256) {
    const int r = i / (BN / 2), c = 2 * (i - r * (BN / 2));
    const float2 v = *reinterpret_cast<const float2*>(sc + r * LDC + c);
    float2 aux = make_float2(0.f, 0.f);
    if constexpr (HasAux<Epi>::value) {
      aux = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(saux + r * BN + c));
    }
    if constexpr (HasColSum<Epi>::value) {  // the value to sum replaces the entry
      *reinterpret_cast<float2*>(sc + r * LDC + c) = call_epi(epi, m0 + r, n0 + c, v.x, v.y, aux);
    } else {
      call_epi(epi, m0 + r, n0 + c, v.x, v.y, aux);
    }
  }
  if constexpr (HasColSum<Epi>::value) {
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    for (int c = threadIdx.x - 128; c < BN; c += 256) {
      float sum = 0.f;
      for (int r = 0; r < kTmaBM; ++r) sum += sc[r * LDC + c];
      epi.col_sum(m0 / kTmaBM, n0 + c, sum);
    }
  }
}

// TMA store: the box at (column c0, row c1) of `map` from shared memory,
// in the calling thread's bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const bf16* src, int c0,
                                          int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// The bf16 output tile of gemm_tma_rows_kernel: 128 x 256, four boxes of
// 128 rows x 64 columns, 128-byte swizzled as the output map stores them.
// An epilogue with row partials has no output tile: its ring takes that
// room as a fourth stage.
constexpr int kRowsBN = 256;
constexpr int kRowsOutBytes = kTmaBM * kRowsBN * 2;
template <class Epi>
constexpr int kRowsStages = HasRowPartials<Epi>::value ? 4 : 3;
template <class Epi>
constexpr int kRowsSmemBytes = kRowsStages<Epi> * (kTmaBM + kRowsBN) * kTmaBK * 2 +
                               (HasRowPartials<Epi>::value ? 0 : kRowsOutBytes) +
                               2 * kRowsStages<Epi> * 8 + 1024;

// The NT product (A and B K-major) for an epilogue with row values and a
// bf16 output (the LM head's dS: a contraction of H = 1024, an exponential
// per entry), persistent: one block per SM walks the 128 x 256 output
// tiles (down each tile column, so that the blocks in flight share B's
// tiles); its producer runs on into the next tile's stages (a ring of 3)
// while the consumers finish the last one.  The consumers apply the
// epilogue's value(col, s, row value) to their accumulator registers (each
// thread's entries lie in two rows, whose values it loads before the
// tile's mainloop), write the results as bf16 into a swizzled output tile
// in shared memory, and one thread stores that tile with TMA, which
// clips rows and columns outside C; the store runs on under the next
// tile's mainloop and is waited for before the tile is written again.
// With row partials (the LM head's forward) each consumer thread hands
// its 64 scores of each of its two rows to the epilogue, the four lanes
// of a quad holding the rest of the row's 256; no shared tile, no store,
// no barrier between the consumers (tc is not read), and a ring of 4 in
// which a consumer keeps one stage's products in flight while it hands
// the stage before back (with the ring of 3 beside the output tile that
// slowed the dS launch by 5% on an H100).
template <class Epi>
__global__ void __launch_bounds__(kTmaThreads, 1)
gemm_tma_rows_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tc, int m, int n, int k, const Epi epi) {
  constexpr bool kPartials = HasRowPartials<Epi>::value;
  constexpr int kStages = kRowsStages<Epi>;
  constexpr int BN = kRowsBN, NH = BN / 128;
  constexpr int kStageA = kTmaBM * kTmaBK, kStageB = BN * kTmaBK;  // bf16 elements
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  bf16* sa = reinterpret_cast<bf16*>(smem_raw + (((raw + 1023u) & ~1023u) - raw));
  bf16* sb = sa + kStages * kStageA;
  bf16* so = sb + kStages * kStageB;  // the output tile
  uint64_t* full = reinterpret_cast<uint64_t*>(so + (kPartials ? 0 : kTmaBM * BN));
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int tiles_m = (m + kTmaBM - 1) / kTmaBM;
  const int tiles = tiles_m * ((n + BN - 1) / BN);
  const int nk = (k + kTmaBK - 1) / kTmaBK;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // `it` counts the block's stages over all its tiles: stage it % kStages
  // in its (it / kStages)-th use
  if (wg == 0) {  // the producer
    if (tid == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile % tiles_m * kTmaBM, n0 = tile / tiles_m * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
          mbar_expect_tx(&full[s], (kStageA + kStageB) * 2);
          tma_load(sa + s * kStageA, &ta, kt * kTmaBK, m0, &full[s]);
          tma_load(sb + s * kStageB, &tb, kt * kTmaBK, n0, &full[s]);
        }
      }
    }
    return;
  }

  const int cw = wg - 1;
  const int lane = tid & 31, t4 = lane & 3;
  const int r0 = cw * 64 + (tid >> 5) * 16 + (lane >> 2);  // rows r0 and r0 + 8 of the tile
  const bool storer = threadIdx.x == 128;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile % tiles_m * kTmaBM, n0 = tile / tiles_m * BN;
    const auto rv0 = epi.row_values(m0 + r0);  // in flight during the mainloop
    const auto rv1 = epi.row_values(m0 + r0 + 8);
    float acc[NH][64];
#pragma unroll
    for (int h = 0; h < NH; ++h) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    }
#pragma unroll 1
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint32_t a_addr = smem_u32(sa + s * kStageA + cw * 64 * kTmaBK);
      const uint32_t b_addr = smem_u32(sb + s * kStageB);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k16 = 0; k16 < kTmaBK / 16; ++k16) {
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          wgmma_n128<false, false>(acc[h], desc_k16<false>(a_addr, k16),
                                   desc_k16<false>(b_addr + h * 128 * kTmaBK * 2, k16));
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if constexpr (kPartials) {
        // this stage's products run on while the one before is handed back
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (kt > 0 && tid == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      } else {
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        if (tid == 0) mbar_arrive(&empty[s]);
      }
    }
    if constexpr (kPartials) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (nk > 0 && tid == 0) mbar_arrive(&empty[(it - 1) % kStages]);
#pragma unroll
      for (int h = 0; h < NH; ++h) fence_regs(acc[h]);
    }
    // C fragment j of product h: (r0, c), (r0, c + 1), (r0 + 8, c), (r0 + 8,
    // c + 1), c = 128 h + 8 j + 2 t4
    if constexpr (kPartials) {
      // row r0 + 8 half's entry i = 32 h + 2 j + e at column c + e
      const auto col = [&](int i) {
        return n0 + (i >> 5) * 128 + ((i & 31) >> 1) * 8 + 2 * t4 + (i & 1);
      };
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const auto val = [&](int i) {
          return acc[i >> 5][((i & 31) >> 1) * 4 + 2 * half + (i & 1)];
        };
        epi.template row_partial<4, NH * 32>(m0 + r0 + 8 * half, tile / tiles_m, val, col,
                                             half ? rv1 : rv0);
      }
    } else {
      // the last tile's store has read the output tile
      if (storer) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      // pair (row, c) goes to box 2 h + j / 8, 16-byte chunk j % 8 of its
      // 128-byte row, swizzled by the row's index mod 8
#pragma unroll
      for (int h = 0; h < NH; ++h) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = n0 + h * 128 + j * 8 + 2 * t4;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = r0 + 8 * half;
            const auto& rv = half ? rv1 : rv0;
            const __nv_bfloat162 v =
                __floats2bfloat162_rn(epi.value(c, acc[h][j * 4 + 2 * half], rv),
                                      epi.value(c + 1, acc[h][j * 4 + 2 * half + 1], rv));
            unsigned char* box =
                reinterpret_cast<unsigned char*>(so) + (2 * h + j / 8) * kTmaBM * 128;
            *reinterpret_cast<__nv_bfloat162*>(box + r * 128 + ((j % 8) ^ (r & 7)) * 16 +
                                                4 * t4) = v;
          }
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      if (storer) {
#pragma unroll
        for (int b = 0; b < BN / 64; ++b) tma_store(&tc, so + b * kTmaBM * 64, n0 + 64 * b, m0);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
  }
  if constexpr (!kPartials) {
    if (storer) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's tensor-map encoder, through the runtime (no link to libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The TMA map of a row-major (rows, cols) bf16 matrix copied in boxes of
// box_rows x 64, 128-byte swizzled, zeros outside; returns a cudaError_t.
inline int tma_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kTmaBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// mma.sync (bf16, a few rows or operands off the 16-byte grid)

// ldmatrix.x2: one B fragment (k16 x n8) of B = T^T, T stored n-major (row
// n, k contiguous), at (n0, k0) of T (lanes 16..31 repeat 0..15's addresses)
__device__ __forceinline__ void load_b8(unsigned (&r)[2], const bf16* tile, int ld, int n0,
                                        int k0) {
  const int lane = threadIdx.x & 15;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(tile + (n0 + (lane & 7)) * ld + k0 + (lane >> 3) * 8))
               : "memory");
}

// A mma.sync block configuration: a BM x BN tile of C per block, BK
// contraction columns per stage, warps of WM x WN (a multiple of 16 x 8),
// kWK warps splitting each stage's contraction, kStages stages in flight,
// kMinBlocks resident blocks per SM asked of the compiler.
template <int BM_, int BN_, int BK_, int WM_, int WN_, int WK_, int STAGES_, int MIN_BLOCKS_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int kWK = WK_, kStages = STAGES_, kMinBlocks = MIN_BLOCKS_;
  static constexpr int kWarpsMN = (BM / WM) * (BN / WN);
  static constexpr int kThreads = 32 * kWarpsMN * kWK;
  static constexpr int MT = WM / 16, NT = WN / 8;  // m16 / n8 tiles per warp
  static constexpr int LD = BK + 8;                // bf16 row stride in shared memory
  static constexpr int kStage = (BM + BN) * LD;    // bf16 elements per stage
  static constexpr int kPipeBytes = kStages * kStage * 2;
  static constexpr int kRedBytes = (kWK - 1) * kWarpsMN * 32 * MT * NT * 4 * 4;
  static constexpr int kSmemBytes = kPipeBytes > kRedBytes ? kPipeBytes : kRedBytes;
  static_assert(BM % WM == 0 && BN % WN == 0 && WM % 16 == 0 && WN % 8 == 0, "warp tiling");
  static_assert(BK % (16 * kWK) == 0, "whole k16 steps per warp");
};

// For a few rows (decode) the card is covered by narrow column tiles, each
// stage's contraction split over 8 warps: 16 x 16 where they give every SM
// a block, else 16 x 8 with 512 contraction columns a stage (more bytes in
// flight per block)
using Narrow16 = Cfg<16, 16, 256, 16, 16, 8, 4, 3>;
using Narrow8 = Cfg<16, 8, 512, 16, 8, 8, 4, 2>;
constexpr int kNarrowRows = 64;  // at most this many rows of C take them

// Copy rows [r0, r0 + kRows) x columns [c0, c0 + kCols) of a row-major
// (n_rows, n_cols) bf16 matrix into a shared tile of row stride ld; entries
// outside read zero.  16-byte cp.async copies when vec (the caller commits),
// element-wise otherwise.
template <int kRows, int kCols, int kThreads>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, int r0, int n_rows,
                                          int c0, int n_cols, bool vec) {
  if (vec) {
    constexpr int kVecs = kCols / 8;
#pragma unroll
    for (int i = threadIdx.x; i < kRows * kVecs; i += kThreads) {
      const int r = i / kVecs;
      const int c = (i - r * kVecs) * 8;
      const bool ok = r0 + r < n_rows && c0 + c < n_cols;
      cp_async16(dst + r * ld + c, ok ? src + static_cast<int64_t>(r0 + r) * n_cols + c0 + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols;
      const int c = i - r * kCols;
      const bool ok = r0 + r < n_rows && c0 + c < n_cols;
      dst[r * ld + c] = ok ? src[static_cast<int64_t>(r0 + r) * n_cols + c0 + c]
                           : __float2bfloat16(0.f);
    }
  }
}

template <class C, class Epi>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
gemm_nt_mma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b, int m, int n, int k,
                   int vec, const Epi epi) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wk = warp / C::kWarpsMN, wmn = warp - wk * C::kWarpsMN;
  const int wm = wmn / (C::BN / C::WN), wn = wmn - wm * (C::BN / C::WN);
  const int nk = (k + C::BK - 1) / C::BK;

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i) {
#pragma unroll
    for (int j = 0; j < C::NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
    }
  }

  auto stage = [&](int s) {
    bf16* sa = smem + (s % C::kStages) * C::kStage;
    load_rows<C::BM, C::BK, C::kThreads>(sa, C::LD, a, m0, m, s * C::BK, k, vec);
    load_rows<C::BN, C::BK, C::kThreads>(sa + C::BM * C::LD, C::LD, b, n0, n, s * C::BK, k, vec);
  };
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < nk) stage(s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait(C::kStages - 2);
    __syncthreads();  // stage kt has landed; stage kt - 1 is consumed by every warp
    if (kt + C::kStages - 1 < nk) stage(kt + C::kStages - 1);
    cp_async_commit();
    const bf16* sa = smem + (kt % C::kStages) * C::kStage;
    const bf16* sb = sa + C::BM * C::LD;
#pragma unroll
    for (int kk = wk * 16; kk < C::BK; kk += 16 * C::kWK) {
      unsigned fa[C::MT][4];
#pragma unroll
      for (int i = 0; i < C::MT; ++i) load_a(fa[i], sa, C::LD, wm * C::WM + i * 16, kk);
#pragma unroll
      for (int j = 0; j + 1 < C::NT; j += 2) {
        unsigned fb[4];
        load_b(fb, sb, C::LD, wn * C::WN + j * 8, kk);
#pragma unroll
        for (int i = 0; i < C::MT; ++i) {
          mma_bf16(acc[i][j], fa[i], fb[0], fb[1]);
          mma_bf16(acc[i][j + 1], fa[i], fb[2], fb[3]);
        }
      }
      if constexpr (C::NT % 2 == 1) {
        unsigned fb[2];
        load_b8(fb, sb, C::LD, wn * C::WN + (C::NT - 1) * 8, kk);
#pragma unroll
        for (int i = 0; i < C::MT; ++i) mma_bf16(acc[i][C::NT - 1], fa[i], fb[0], fb[1]);
      }
    }
  }

  if constexpr (C::kWK > 1) {
    // the contraction was split over warps: warps wk > 0 hand their pieces
    // to warp wk = 0 of the same tile, which adds them in ascending wk
    cp_async_wait(0);
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem_raw);
    constexpr int kPiece = C::MT * C::NT * 4;
    if (wk > 0) {
      float* dst = red + (((wk - 1) * C::kWarpsMN + wmn) * 32 + lane) * kPiece;
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
#pragma unroll
        for (int j = 0; j < C::NT; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) dst[(i * C::NT + j) * 4 + c] = acc[i][j][c];
        }
      }
    }
    __syncthreads();
    if (wk > 0) return;
    for (int w = 1; w < C::kWK; ++w) {
      const float* src = red + (((w - 1) * C::kWarpsMN + wmn) * 32 + lane) * kPiece;
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
#pragma unroll
        for (int j = 0; j < C::NT; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] += src[(i * C::NT + j) * 4 + c];
        }
      }
    }
  }

  // C fragments: c0, c1 at (row g, cols 2t, 2t + 1), c2, c3 at row g + 8
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < C::MT; ++i) {
    const int row = m0 + wm * C::WM + i * 16 + g;
    typename HasRows<Epi>::type rv[2] = {};
    if constexpr (HasRows<Epi>::value) {
      rv[0] = epi.row_values(row);
      rv[1] = epi.row_values(row + 8);
    }
#pragma unroll
    for (int j = 0; j < C::NT; ++j) {
      const int col = n0 + wn * C::WN + j * 8 + 2 * t4;
      call_epi(epi, row, col, acc[i][j][0], acc[i][j][1], rv[0]);
      call_epi(epi, row + 8, col, acc[i][j][2], acc[i][j][3], rv[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// FMA (f32, f16; bf16 off TMA's grid)

// the FMA tile: 128 x 128 per block of 256 threads, 8 contraction columns
// per stage; thread (ty, tx) = (tid / 16, tid % 16) owns rows ty * 4 + {0..3}
// and 64 + ty * 4 + {0..3}, columns tx * 4 + {0..3} and 64 + tx * 4 + {0..3}
constexpr int kFmaBM = 128, kFmaBN = 128, kFmaBK = 8, kFmaThreads = 256;
constexpr int kFmaLD = kFmaBM + 4;  // float4 reads stay aligned

// blocks a multiprocessor asked of the compiler: two for MN-major operands
// (the backward), whose loaders' index arithmetic would otherwise take the
// tile past 128 registers a thread; the NT tile (the forward) as it was
template <bool kTA, bool kTB>
constexpr int kFmaMinBlocks = kTA || kTB ? 2 : 1;

// b_rows: the rows of B's storage (n K-major, k MN-major), past which B
// reads zero
template <bool kTA, bool kTB, class Epi>
__global__ void __launch_bounds__(kFmaThreads, (kFmaMinBlocks<kTA, kTB>))
gemm_fma_kernel(const void* __restrict__ a, const void* __restrict__ b, int m, int n, int k,
                int b_rows, int code, const Epi epi) {
  __shared__ __align__(16) float as[2][kFmaBK][kFmaLD];
  __shared__ __align__(16) float bs[2][kFmaBK][kFmaLD];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kFmaBM, n0 = blockIdx.x * kFmaBN;
  // the loaders: row lr of the A or B tile, contraction columns lk .. lk + 3;
  // a K-major operand gives a thread pair one row (4 + 4 contiguous
  // columns), an MN-major one gives a warp 32 contiguous rows
  const int lra = kTA ? tid & 127 : tid >> 1, lka = kTA ? (tid >> 7) * 4 : (tid & 1) * 4;
  const int lrb = kTB ? tid & 127 : tid >> 1, lkb = kTB ? (tid >> 7) * 4 : (tid & 1) * 4;
  const int nk = (k + kFmaBK - 1) / kFmaBK;
  // B's loads stop at its stored rows: along n K-major, along k MN-major
  const int nb = kTB ? n : min(n, b_rows), kb_end = kTB ? min(k, b_rows) : k;
  float ra[4], rb[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ka = k0 + lka + q, kb = k0 + lkb + q;
      const int64_t ia = kTA ? static_cast<int64_t>(ka) * m + m0 + lra
                             : static_cast<int64_t>(m0 + lra) * k + ka;
      const int64_t ib = kTB ? static_cast<int64_t>(kb) * n + n0 + lrb
                             : static_cast<int64_t>(n0 + lrb) * k + kb;
      ra[q] = m0 + lra < m && ka < k ? load_f(a, code, ia) : 0.f;
      rb[q] = n0 + lrb < nb && kb < kb_end ? load_f(b, code, ib) : 0.f;
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      as[buf][lka + q][lra] = ra[q];
      bs[buf][lkb + q][lrb] = rb[q];
    }
  };

  // this thread's C entries: rows fma_row(i), columns fma_col(c)
  auto fma_row = [&](int i) { return m0 + (i < 4 ? 0 : 64) + ty * 4 + (i & 3); };
  auto fma_col = [&](int c) { return n0 + (c < 4 ? 0 : 64) + tx * 4 + (c & 3); };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }
  if constexpr (HasSeed<Epi>::value) {
    const AuxTile sd = epi.seed();
    if (sd.p != nullptr) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = seed_at(sd, fma_row(i), fma_col(c));
      }
    }
  }
  fetch(0);
  put(0);
  __syncthreads();
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * kFmaBK);  // the next stage's loads fly during the FMAs
#pragma unroll
    for (int kk = 0; kk < kFmaBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[buf][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
      }
    }
    if (kt + 1 < nk) put(buf ^ 1);  // buf ^ 1 was consumed before the last barrier
    __syncthreads();
  }

  if constexpr (HasRowPartials<Epi>::value) {
    // a row's 128 columns lie in the 16 lanes that share ty
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = fma_row(i);
      const auto val = [&](int c) { return acc[i][c]; };
      epi.template row_partial<16, 8>(row, blockIdx.x, val, fma_col, epi.row_values(row));
    }
  } else {
    float cs[8] = {};  // column sums over this thread's 8 rows (col_sum epilogues)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = fma_row(i);
      typename HasRows<Epi>::type rv = {};
      if constexpr (HasRows<Epi>::value) rv = epi.row_values(row);
#pragma unroll
      for (int c = 0; c < 8; c += 2) {
        const int col = fma_col(c);
        float2 aux = make_float2(0.f, 0.f);
        if constexpr (HasAux<Epi>::value) {
          const AuxTile x = epi.aux_tile();
          const int64_t at = static_cast<int64_t>(row) * x.cols + col;
          if (row < x.rows && col < x.cols) aux.x = load_f(x.p, x.code, at);
          if (row < x.rows && col + 1 < x.cols) aux.y = load_f(x.p, x.code, at + 1);
        }
        if constexpr (HasRows<Epi>::value) {
          call_epi(epi, row, col, acc[i][c], acc[i][c + 1], rv);
        } else if constexpr (HasColSum<Epi>::value) {
          const float2 v = call_epi(epi, row, col, acc[i][c], acc[i][c + 1], aux);
          cs[c] += v.x;
          cs[c + 1] += v.y;
        } else {
          call_epi(epi, row, col, acc[i][c], acc[i][c + 1], aux);
        }
      }
    }
    if constexpr (HasColSum<Epi>::value) {
      // the 16 row groups' sums of each column, added in row-group order (the
      // main loop's last barrier freed the A tiles)
      float* red = &as[0][0][0];
      static_assert(16 * kFmaBN <= 2 * kFmaBK * kFmaLD, "the partials fit the A tiles");
#pragma unroll
      for (int c = 0; c < 8; ++c) red[ty * kFmaBN + (c < 4 ? 0 : 64) + tx * 4 + (c & 3)] = cs[c];
      __syncthreads();
      if (tid < kFmaBN) {
        float sum = 0.f;
        for (int r = 0; r < 16; ++r) sum += red[r * kFmaBN + tid];
        epi.col_sum(m0 / kFmaBM, n0 + tid, sum);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers

// One product of a launch: C (m x n) = A B over k; A stored (m x k), or
// (k x m) when MN-major, B (n x k), or (k x n) when MN-major.  b_rows > 0:
// only the first b_rows rows of B's storage exist (along n K-major, along
// k MN-major), and B reads zero past them (TMA zero-fills, the other tiles
// test): a product may then run past the end of B, as the LM head's last
// vocab chunk does to keep dS's rows on the 16-byte grid.
struct Product {
  const void* a;
  const void* b;
  int m, n, k;
  int b_rows = 0;
};

// the rows of B's storage that exist
template <bool kTB>
inline int stored_b_rows(const Product& q) {
  const int full = kTB ? q.k : q.n;
  return q.b_rows > 0 && q.b_rows < full ? q.b_rows : full;
}

// the kernel reads n only to bound B's rows: it is given b_rows (all n
// when 0)
template <class C, class Epi>
int launch_mma(const bf16* a, const bf16* b, int m, int n, int k, bool vec, const Epi& epi,
               cudaStream_t s, int b_rows = 0) {
  static std::atomic<uint64_t> attr_set{0};
  const int rc = set_smem(gemm_nt_mma_kernel<C, Epi>, C::kSmemBytes, attr_set);
  if (rc != 0) return rc;
  const dim3 grid(static_cast<unsigned>((n + C::BN - 1) / C::BN),
                  static_cast<unsigned>((m + C::BM - 1) / C::BM));
  const int nb = b_rows > 0 && b_rows < n ? b_rows : n;
  gemm_nt_mma_kernel<C, Epi><<<grid, C::kThreads, C::kSmemBytes, s>>>(a, b, m, nb, k, vec ? 1 : 0,
                                                                       epi);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, bool kTA, bool kTB, class Epi>
int launch_tma(const Product& q, const Epi& epi, cudaStream_t s) {
  constexpr int kBytes = tma_smem_bytes<BN, HasAux<Epi>::value>();
  static std::atomic<uint64_t> attr_set{0};
  int rc = set_smem(gemm_tma_kernel<BN, kTA, kTB, Epi>, kBytes, attr_set);
  if (rc != 0) return rc;
  // a K-major operand is boxed 64 contraction columns by the tile's rows,
  // an MN-major one 64 along M (or N) by 64 contraction rows
  CUtensorMap ta, tb;
  rc = kTA ? tma_map(&ta, q.a, q.k, q.m, kTmaBK) : tma_map(&ta, q.a, q.m, q.k, kTmaBM);
  if (rc != 0) return rc;
  rc = kTB ? tma_map(&tb, q.b, stored_b_rows<kTB>(q), q.n, kTmaBK)
           : tma_map(&tb, q.b, stored_b_rows<kTB>(q), q.k, BN);
  if (rc != 0) return rc;
  const dim3 grid(static_cast<unsigned>((q.n + BN - 1) / BN),
                  static_cast<unsigned>((q.m + kTmaBM - 1) / kTmaBM));
  gemm_tma_kernel<BN, kTA, kTB, Epi><<<grid, kTmaThreads, kBytes, s>>>(ta, tb, q.k, epi);
  return static_cast<int>(cudaGetLastError());
}

// dtype `code` (any) on the FMA tile
template <bool kTA, bool kTB, class Epi>
int launch_fma(const Product& q, const Epi& epi, int code, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((q.n + kFmaBN - 1) / kFmaBN),
                  static_cast<unsigned>((q.m + kFmaBM - 1) / kFmaBM));
  gemm_fma_kernel<kTA, kTB, Epi><<<grid, kFmaThreads, 0, s>>>(q.a, q.b, q.m, q.n, q.k,
                                                               stored_b_rows<kTB>(q), code, epi);
  return static_cast<int>(cudaGetLastError());
}

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// whether TMA maps a bf16 operand whose rows hold `cols` elements: the
// rows 16-byte multiples (and not empty), the base 16-byte aligned
inline bool tma_maps(const void* p, int cols) {
  return cols > 0 && cols % 8 == 0 && aligned16(p);
}

// whether gemm() runs product q of dtype `code` on TMA + wgmma (given an
// aux tile and an output that TMA maps too)
template <bool kTA, bool kTB>
inline bool tma_operands(const Product& q, int code) {
  return code == kBF16 && tma_maps(q.a, kTA ? q.m : q.k) && tma_maps(q.b, kTB ? q.n : q.k);
}

// The columns of C per row partial of an NT product q in dtype `code`
// (epilogues with row partials): the tile width of the route gemm() takes
inline int row_partial_cols(const Product& q, int code) {
  return tma_operands<false, false>(q, code) ? kRowsBN : kFmaBN;
}

// The persistent NT product with a row-value epilogue into its bf16
// output (epi.out_tile()), or with row partials, a grid of at most one
// block per SM
template <class Epi>
int launch_tma_rows(const Product& q, const Epi& epi, cudaStream_t s) {
  constexpr int kBytes = kRowsSmemBytes<Epi>;
  static std::atomic<uint64_t> attr_set{0};
  int rc = set_smem(gemm_tma_rows_kernel<Epi>, kBytes, attr_set);
  if (rc != 0) return rc;
  CUtensorMap ta, tb, tc{};
  rc = tma_map(&ta, q.a, q.m, q.k, kTmaBM);
  if (rc != 0) return rc;
  rc = tma_map(&tb, q.b, stored_b_rows<false>(q), q.k, kRowsBN);
  if (rc != 0) return rc;
  if constexpr (!HasRowPartials<Epi>::value) {
    const AuxTile out = epi.out_tile();
    rc = tma_map(&tc, out.p, out.rows, out.cols, kTmaBM);
    if (rc != 0) return rc;
  }
  const int64_t tiles =
      static_cast<int64_t>((q.m + kTmaBM - 1) / kTmaBM) * ((q.n + kRowsBN - 1) / kRowsBN);
  const int blocks = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  gemm_tma_rows_kernel<Epi><<<blocks, kTmaThreads, kBytes, s>>>(ta, tb, tc, q.m, q.n, q.k, epi);
  return static_cast<int>(cudaGetLastError());
}

// C = A B of one layout through epi, one launch; returns a cudaError_t.
// bf16 (code) operands that TMA maps (and the epilogue's aux tile) take
// TMA + wgmma, on 128 x 128 tiles where those fit the card in one wave
// (at most one block an SM), else on 128 x 256 tiles: between half the
// SMs and all of them, the wide tiles run one wave where the narrow ones
// would take two; an epilogue with row values takes the persistent
// kernel (its bf16 output on TMA's grid too; row partials have none).
// f32, f16 and bf16 off TMA's 16-byte grid take the FMA tile.
template <bool kTA, bool kTB, class Epi>
int gemm(const Product& q, const Epi& epi, int code, cudaStream_t s) {
  bool tma = tma_operands<kTA, kTB>(q, code);
  if constexpr (HasAux<Epi>::value) {
    const AuxTile x = epi.aux_tile();
    tma = tma && tma_maps(x.p, x.cols);
  }
  if (!tma) return launch_fma<kTA, kTB>(q, epi, code, s);
  if constexpr (HasRows<Epi>::value) {
    static_assert(!kTA && !kTB, "row-value epilogues take NT products");
    if constexpr (!HasRowPartials<Epi>::value) {
      const AuxTile out = epi.out_tile();
      if (!tma_maps(out.p, out.cols)) return launch_fma<kTA, kTB>(q, epi, code, s);
    }
    return launch_tma_rows(q, epi, s);
  } else {
    if (2 * static_cast<int64_t>((q.m + kTmaBM - 1) / kTmaBM) * ((q.n + 255) / 256) >
        sm_count()) {
      return launch_tma<256, kTA, kTB>(q, epi, s);
    }
    return launch_tma<128, kTA, kTB>(q, epi, s);
  }
}

// C = A B^T through epi, one launch; returns a cudaError_t.  bf16 (code):
// the TMA + wgmma tiles of gemm(); the narrow mma.sync tiles for at most
// kNarrowRows rows or operands off the 16-byte grid.  f32 and f16 take the
// FMA tile.
template <class Epi>
int gemm_nt(const void* a, const void* b, int m, int n, int k, int code, const Epi& epi,
            cudaStream_t s, int b_rows = 0) {
  if (m <= 0 || n <= 0) return 0;
  if (code == kBF16 && (m <= kNarrowRows || k % 8 != 0 || !aligned16(a) || !aligned16(b))) {
    const bool vec = k % 8 == 0 && aligned16(a) && aligned16(b);
    const bf16* ab = static_cast<const bf16*>(a);
    const bf16* bb = static_cast<const bf16*>(b);
    if (static_cast<int64_t>((m + 15) / 16) * ((n + 15) / 16) >= sm_count()) {
      return launch_mma<Narrow16>(ab, bb, m, n, k, vec, epi, s, b_rows);
    }
    return launch_mma<Narrow8>(ab, bb, m, n, k, vec, epi, s, b_rows);
  }
  return gemm<false, false>(Product{a, b, m, n, k, b_rows}, epi, code, s);
}

}  // namespace gemm
}  // namespace apex_tpu_torch
