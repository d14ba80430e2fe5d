// Tile configurations of apex_tpu_torch's tiled GEMM (the FFN's mainloop,
// apex_tpu_torch/csrc/gemm.cuh): on the forward's NT products against two
// designs its bf16 path replaced (mma.sync on 128 x 128 tiles, and the same
// wgmma products as the TMA kernel with the operand tiles copied by the
// threads: 16-byte cp.async into the 128-byte-swizzled layout wgmma reads),
// and on the backward's products with MN-major operands (TMA 128 x 256 and
// 128 x 128 tiles).  Built and timed by
// tools/sweep_gemm_torch.py; C is stored in bf16.
#include "../apex_tpu_torch/csrc/gemm.cuh"

using namespace apex_tpu_torch;
using namespace apex_tpu_torch::gemm;

struct StoreBf16 {
  bf16* c;
  int m, n;
  __device__ __forceinline__ void operator()(int row, int col, float v0, float v1) const {
    if (row >= m || col >= n) return;
    c[static_cast<int64_t>(row) * n + col] = __float2bfloat16(v0);
    if (col + 1 < n) c[static_cast<int64_t>(row) * n + col + 1] = __float2bfloat16(v1);
  }
};

// rows [r0, r0 + kRows) x 64 columns from c0 of a row-major bf16 matrix into
// a 128-byte-swizzled K-major tile (16-byte chunk c of row r at (c ^ (r & 7)))
template <int kRows, int kThreads>
__device__ __forceinline__ void load_sw128(bf16* dst, const bf16* src, int r0, int n_rows, int c0,
                                           int n_cols) {
#pragma unroll
  for (int i = threadIdx.x; i < kRows * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7;
    const bool ok = r0 + r < n_rows && c0 + c * 8 < n_cols;
    cp_async16(dst + r * 64 + ((c ^ (r & 7)) << 3),
               ok ? src + static_cast<int64_t>(r0 + r) * n_cols + c0 + c * 8 : src, ok ? 16 : 0);
  }
}

// two warpgroups over a 128 x 256 tile, each 64 rows (wgmma m64n128k16 x 2),
// a 4-stage cp.async ring with one barrier per stage
template <class Epi>
__global__ void __launch_bounds__(256, 1)
gemm_nt_cpasync_wgmma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b, int m,
                             int n, int k, const Epi epi) {
  constexpr int BM = 128, BN = 256, S = 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  bf16* smem = reinterpret_cast<bf16*>(smem_raw + (((raw + 1023u) & ~1023u) - raw));
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wg = threadIdx.x >> 7;
  const int nk = (k + 63) / 64;
  float acc[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  }
  auto stage = [&](int s) {
    bf16* sa = smem + (s % S) * (BM + BN) * 64;
    load_sw128<BM, 256>(sa, a, m0, m, s * 64, k);
    load_sw128<BN, 256>(sa + BM * 64, b, n0, n, s * 64, k);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) stage(s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait(S - 2);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (kt + S - 1 < nk) stage(kt + S - 1);
    cp_async_commit();
    const bf16* sa = smem + (kt % S) * (BM + BN) * 64;
    const uint32_t a_addr = smem_u32(sa + wg * 64 * 64);
    const uint32_t b_addr = smem_u32(sa + BM * 64);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wgmma_n128<false, false>(acc[h], desc_sw128(a_addr + 32 * s),
                                 desc_sw128(b_addr + h * 128 * 128 + 32 * s));
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int row = m0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + h * 128 + j * 8 + 2 * (lane & 3);
      epi(row, col, acc[h][j * 4], acc[h][j * 4 + 1]);
      epi(row + 8, col, acc[h][j * 4 + 2], acc[h][j * 4 + 3]);
    }
  }
}

template <class Epi>
int launch_cpasync_wgmma(const bf16* a, const bf16* b, int m, int n, int k, const Epi& epi,
                         cudaStream_t s) {
  constexpr int kBytes = 4 * (128 + 256) * 64 * 2 + 1024;
  static bool done = false;
  const int rc = set_smem(gemm_nt_cpasync_wgmma_kernel<Epi>, kBytes, done);
  if (rc != 0) return rc;
  const dim3 grid((n + 255) / 256, (m + 127) / 128);
  gemm_nt_cpasync_wgmma_kernel<Epi><<<grid, 256, kBytes, s>>>(a, b, m, n, k, epi);
  return static_cast<int>(cudaGetLastError());
}

// cfg: 0 the port's choice (gemm_nt), 1 TMA 128 x 256, 2 TMA 128 x 128,
// 3 mma.sync 16 x 16, 4 mma.sync 16 x 8, 5 mma.sync 128 x 128 (cp.async),
// 6 wgmma 128 x 256 fed by cp.async.  Operands bf16, K a multiple of 8.
extern "C" int sweep_gemm(int cfg, const void* a, const void* b, void* c, int m, int n, int k,
                          void* stream) {
  const bf16* ab = static_cast<const bf16*>(a);
  const bf16* bb = static_cast<const bf16*>(b);
  const StoreBf16 epi{static_cast<bf16*>(c), m, n};
  const Product q{a, b, m, n, k};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cfg) {
    case 0: return gemm_nt(a, b, m, n, k, kBF16, epi, s);
    case 1: return launch_tma<256, false, false>(q, epi, s);
    case 2: return launch_tma<128, false, false>(q, epi, s);
    case 3: return launch_mma<Narrow16>(ab, bb, m, n, k, true, epi, s);
    case 4: return launch_mma<Narrow8>(ab, bb, m, n, k, true, epi, s);
    case 5: return launch_mma<Cfg<128, 128, 32, 64, 32, 1, 4, 2>>(ab, bb, m, n, k, true, epi, s);
    case 6: return launch_cpasync_wgmma(ab, bb, m, n, k, epi, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward's layouts on TMA tiles: B MN-major (a_mn 0: A (m x k), B (k
// x n): dy W2, dz W1) or both (a_mn 1: A (k x m), B (k x n): dz^T x, dy^T
// h); cfg 1: 128 x 256 tiles, 2: 128 x 128.
extern "C" int sweep_gemm_mn(int cfg, int a_mn, const void* a, const void* b, void* c, int m,
                             int n, int k, void* stream) {
  const StoreBf16 e{static_cast<bf16*>(c), m, n};
  const Product q{a, b, m, n, k};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cfg != 1 && cfg != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (a_mn) {
    return cfg == 1 ? launch_tma<256, true, true>(q, e, s) : launch_tma<128, true, true>(q, e, s);
  }
  return cfg == 1 ? launch_tma<256, false, true>(q, e, s) : launch_tma<128, false, true>(q, e, s);
}
