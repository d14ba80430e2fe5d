// LayerNorm / RMSNorm backward for Hopper.
//
// Replaces apex_tpu/ops/layer_norm.py `_bwd_kernel` (launched by
// `_pallas_bwd`), and the cross-block sum of its dgamma/dbeta partials
// (`jnp.sum` over the partials there).  What bounds it on the H100: bytes.
// Per element it reads dy and the saved residual (x, or y under
// memory_efficient) and writes dx, a few FMAs per byte, far below the ~295
// operations per byte where the tensor cores would be the limit; at 8192 x
// 1024 bf16 that is ~50 MB, ~15 us at 3.35 TB/s.  xhat is rebuilt from x
// and the saved mean/rstd, or from y as (y - beta) / gamma with a
// zero-gamma guard, or as x * rstd for RMS.  c1 = sum(dy*w*xhat) / h and
// c2 = sum(dy*w) / h give dx = (dy*w - xhat*c1 - c2) * rstd (RMS: no c2).
// The TPU's 8-sublane partial rows and 128-lane padding are not carried
// over.
//
// Two bodies write per-block f32 dgamma/dbeta partial rows; the wrapper
// picks one from hidden, the dtype and the alignment before the launch
// (`ops.layer_norm.layer_norm_bwd_path`) and sizes the grid
// (`layer_norm_bwd_parts`):
//
// * Row per warp (`layer_norm_bwd_warp_kernel<T, NV, FromY>`): a warp
//   holds its row's dy and residual in registers as raw 16-byte words, NV
//   a lane (at most kLnBwdMaxLaneElems elements: hidden <= 1024 in every
//   dtype), read once; each lane sums its elements' dy*w*xhat and dy*w,
//   `warp_sum` combines the lanes by shuffles alone (no shared memory, no
//   barrier per row), and dx is stored from the registers (no second
//   read).  w (loaded once for all the rows a warp walks) and the warp's
//   dgamma / dbeta sums sit in the lane's own f32 slots of shared memory,
//   laid out so a warp's 16-byte accesses hit no bank twice; at the end
//   the block adds its warps' sums in warp order.  Held in registers, w
//   and the sums took 174 registers: one block of 8 warps an SM.  The
//   body is specialised on from_y: a runtime branch around its division,
//   inside the unrolled element loops, cost the rows 25%.  The grid is
//   one wave of kLnBwdBlocksPerSm blocks an SM at most, the warps striding
//   over the rows.  Needs hidden a multiple of a vector and dy, the
//   residual, dx, w (and beta under from_y) on the 16-byte grid.
// * Block per row tile (`layer_norm_bwd_kernel<T>`), every other shape:
//   256 threads walk a tile of ceil(rows / blocks) rows one after another;
//   per row the two sums take warp shuffles and one pass over the warps'
//   partials in shared memory (double-buffered by row parity, so one
//   __syncthreads per row), then a second pass over the row (an L1/L2 hit)
//   writes dx.  Thread t owns columns t, t + 256, ... of the block's
//   dgamma/dbeta row in shared memory.  Any hidden size and alignment.
//
// A second kernel sums the (blocks, hidden) partials over blocks in a fixed
// order (no atomics), so a run repeats bit for bit.

#include "common.cuh"

namespace apex_tpu_torch {

constexpr int kLnBwdThreads = 256;
constexpr int kLnBwdWarps = kLnBwdThreads / 32;
constexpr int kLnBwdMaxLaneElems = 32;  // row elements a lane of the row-per-warp body holds
constexpr int kLnBwdBlocksPerSm = 2;    // resident blocks of the row-per-warp body an SM
constexpr int kLnReduceGroups = 32;     // partial rows summed apart, then in order

template <typename T>
__device__ __forceinline__ float ln_xhat(const T* res, const float* w, const float* b, int i,
                                         float mean, float rstd, int rms, int from_y) {
  const float r = to_f32(res[i]);
  if (from_y) {
    const float y = b != nullptr ? r - b[i] : r;
    return y / (w[i] == 0.f ? 1.f : w[i]);
  }
  return rms ? r * rstd : (r - mean) * rstd;
}

template <typename T>
__global__ void __launch_bounds__(kLnBwdThreads)
layer_norm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ res,
                      const float* __restrict__ w, const float* __restrict__ b,
                      const float* __restrict__ mean, const float* __restrict__ rstd,
                      T* __restrict__ dx, float* __restrict__ dw_part,
                      float* __restrict__ db_part, int64_t rows, int hidden, int rows_per_block,
                      int rms, int from_y) {
  extern __shared__ float part[];  // [hidden] dgamma, then [hidden] dbeta of this block
  __shared__ float red_a[2][kLnBwdWarps];
  __shared__ float red_c[2][kLnBwdWarps];
  float* dw_s = part;
  float* db_s = part + hidden;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < hidden; i += kLnBwdThreads) dw_s[i] = db_s[i] = 0.f;

  const float inv_h = 1.f / static_cast<float>(hidden);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r1 = min(rows, r0 + rows_per_block);
  for (int64_t row = r0; row < r1; ++row) {
    const int buf = static_cast<int>(row & 1);
    const T* dyr = dy + row * hidden;
    const T* resr = res + row * hidden;
    const float rs = rstd[row];
    const float mu = rms ? 0.f : mean[row];
    float a = 0.f, c = 0.f;
    for (int i = threadIdx.x; i < hidden; i += kLnBwdThreads) {
      const float g = to_f32(dyr[i]);
      const float xh = ln_xhat(resr, w, b, i, mu, rs, rms, from_y);
      const float wdy = g * w[i];
      a += wdy * xh;
      c += wdy;
      dw_s[i] += g * xh;  // column i belongs to this thread alone
      db_s[i] += g;
    }
    a = warp_sum(a);
    c = warp_sum(c);
    if (lane == 0) {
      red_a[buf][warp] = a;
      red_c[buf][warp] = c;
    }
    __syncthreads();
    a = 0.f;
    c = 0.f;
#pragma unroll
    for (int k = 0; k < kLnBwdWarps; ++k) {
      a += red_a[buf][k];
      c += red_c[buf][k];
    }
    const float c1 = a * inv_h;
    const float c2 = c * inv_h;
    T* dxr = dx + row * hidden;
    for (int i = threadIdx.x; i < hidden; i += kLnBwdThreads) {
      const float wdy = to_f32(dyr[i]) * w[i];
      const float xh = ln_xhat(resr, w, b, i, mu, rs, rms, from_y);
      const float d = rms ? (wdy - xh * c1) * rs : (wdy - xh * c1 - c2) * rs;
      dxr[i] = from_f32<T>(d);
    }
  }
  for (int i = threadIdx.x; i < hidden; i += kLnBwdThreads) {
    dw_part[static_cast<int64_t>(blockIdx.x) * hidden + i] = dw_s[i];
    db_part[static_cast<int64_t>(blockIdx.x) * hidden + i] = db_s[i];
  }
}

// xhat of one element of the row-per-warp body, each rounding pinned
// (`tests/test_torch_layer_norm.py` emulates the body's order): from y
// under FromY, else (x - mean) * rstd, where RMS passes mean 0 (x - 0 is x,
// so RMS's x * rstd keeps its bits)
template <bool FromY>
__device__ __forceinline__ float bwd_xhat(float r, float w, const float* b, int col, float mean,
                                          float rstd) {
  if constexpr (FromY) {
    const float y = b != nullptr ? __fsub_rn(r, __ldg(b + col)) : r;
    return __fdiv_rn(y, w == 0.f ? 1.f : w);
  } else {
    return __fmul_rn(__fsub_rn(r, mean), rstd);
  }
}

// A lane's private f32 slots in shared memory for element e of its vector
// j (of kV elements): float4 q = e / 4 of that vector sits at slot row
// j * (kV / 4) + q, lane-major, so a warp's 16-byte accesses to one slot row
// are 512 contiguous bytes (no bank conflicts).  Rows: kLnBwdMaxLaneElems
// / 4 slot rows of 32 lanes x 4 floats, 1024 floats.
template <int kV>
__device__ __forceinline__ int lane_slot(int j, int e, int lane) {
  return ((j * (kV / 4) + (e >> 2)) * 32 + lane) * 4 + (e & 3);
}

constexpr int kLnBwdSlots = kLnBwdMaxLaneElems * 32;
// w, then each warp's dgamma and dbeta slots
constexpr int kLnBwdSmemBytes = (1 + 2 * kLnBwdWarps) * kLnBwdSlots * 4;

// Lane l holds the row's 16-byte vectors l, l + 32, ..., l + 32 (NV - 1)
// (those below hidden / kVec16<T>); its row sums and its columns' dgamma /
// dbeta run over them in that order, element by element.  Warp k of block
// b takes rows b * kLnBwdWarps + k, then every gridDim.x * kLnBwdWarps
// rows, and adds its dgamma / dbeta into its own slots of shared memory.
// w sits in the lane's own slots too: a lane reads only what it wrote, so
// nothing waits on a barrier until the block's sum.
template <typename T, int NV, bool FromY>
__global__ void __launch_bounds__(kLnBwdThreads, kLnBwdBlocksPerSm)
layer_norm_bwd_warp_kernel(const T* __restrict__ dy, const T* __restrict__ res,
                           const float* __restrict__ w, const float* __restrict__ b,
                           const float* __restrict__ mean, const float* __restrict__ rstd,
                           T* __restrict__ dx, float* __restrict__ dw_part,
                           float* __restrict__ db_part, int64_t rows, int hidden, int rms) {
  constexpr int kV = kVec16<T>;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_vec = hidden / kV;
  float* w_s = smem;
  float* dw_s = smem + (1 + 2 * warp) * kLnBwdSlots;
  float* db_s = dw_s + kLnBwdSlots;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = j * 32 + lane;
    if (v < n_vec) {
#pragma unroll
      for (int e = 0; e < kV; e += 4) {
        float w4[4];
        const float zero[4] = {0.f, 0.f, 0.f, 0.f};
        load16(w + v * kV + e, w4);
        store16(w_s + lane_slot<kV>(j, e, lane), w4);
        store16(dw_s + lane_slot<kV>(j, e, lane), zero);
        store16(db_s + lane_slot<kV>(j, e, lane), zero);
      }
    }
  }

  const float inv_h = 1.f / static_cast<float>(hidden);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kLnBwdWarps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kLnBwdWarps + warp; row < rows;
       row += stride) {
    // the row's dy and residual as raw 16-byte words
    uint4 gq[NV], rq[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = j * 32 + lane;
      if (v < n_vec) {
        gq[j] = *reinterpret_cast<const uint4*>(dy + row * hidden + v * kV);
        rq[j] = *reinterpret_cast<const uint4*>(res + row * hidden + v * kV);
      }
    }
    const float rs = rstd[row];
    const float mu = rms || FromY ? 0.f : mean[row];
    float a = 0.f, c = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = j * 32 + lane;
      if (v < n_vec) {
        float g[kV], r[kV], wj[kV], dwa[kV], dba[kV];
        load16(reinterpret_cast<const T*>(&gq[j]), g);
        load16(reinterpret_cast<const T*>(&rq[j]), r);
#pragma unroll
        for (int e = 0; e < kV; e += 4) {
          load16(w_s + lane_slot<kV>(j, e, lane), &wj[e]);
          load16(dw_s + lane_slot<kV>(j, e, lane), &dwa[e]);
          load16(db_s + lane_slot<kV>(j, e, lane), &dba[e]);
        }
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          const float xh = bwd_xhat<FromY>(r[e], wj[e], b, v * kV + e, mu, rs);
          const float wdy = __fmul_rn(g[e], wj[e]);
          a = __fmaf_rn(wdy, xh, a);
          c = __fadd_rn(c, wdy);
          dwa[e] = __fmaf_rn(g[e], xh, dwa[e]);
          dba[e] = __fadd_rn(dba[e], g[e]);
        }
#pragma unroll
        for (int e = 0; e < kV; e += 4) {
          store16(dw_s + lane_slot<kV>(j, e, lane), &dwa[e]);
          store16(db_s + lane_slot<kV>(j, e, lane), &dba[e]);
        }
      }
    }
    a = warp_sum(a);
    c = warp_sum(c);
    const float c1 = __fmul_rn(a, inv_h);
    const float c2 = rms ? 0.f : __fmul_rn(c, inv_h);
    T* dxr = dx + row * hidden;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = j * 32 + lane;
      if (v < n_vec) {
        float g[kV], r[kV], wj[kV];
        load16(reinterpret_cast<const T*>(&gq[j]), g);
        load16(reinterpret_cast<const T*>(&rq[j]), r);
#pragma unroll
        for (int e = 0; e < kV; e += 4) load16(w_s + lane_slot<kV>(j, e, lane), &wj[e]);
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          const float xh = bwd_xhat<FromY>(r[e], wj[e], b, v * kV + e, mu, rs);
          const float wdy = __fmul_rn(g[e], wj[e]);
          g[e] = __fmul_rn(__fsub_rn(__fmaf_rn(-xh, c1, wdy), c2), rs);
        }
        store16(dxr + v * kV, g);
      }
    }
  }
  // the block's partial row: its warps' rows added in warp order
  __syncthreads();
  for (int i = threadIdx.x; i < hidden; i += kLnBwdThreads) {
    const int v = i / kV, e = i - v * kV;
    const int slot = lane_slot<kV>(v >> 5, e, v & 31);
    float sw = 0.f, sb = 0.f;
#pragma unroll
    for (int k = 0; k < kLnBwdWarps; ++k) {
      sw = __fadd_rn(sw, smem[(1 + 2 * k) * kLnBwdSlots + slot]);
      sb = __fadd_rn(sb, smem[(2 + 2 * k) * kLnBwdSlots + slot]);
    }
    dw_part[static_cast<int64_t>(blockIdx.x) * hidden + i] = sw;
    db_part[static_cast<int64_t>(blockIdx.x) * hidden + i] = sb;
  }
}

// sums[j] = sum over blocks p of parts[p][j], for 2*hidden columns laid
// out as parts = (2, n_parts, hidden), sums = (2, hidden), in a fixed
// order: group q of kLnReduceGroups sums the partial rows q, q +
// kLnReduceGroups, ... in order, then the groups' sums are added in group
// order.  A block takes 32 columns (a warp per group, a lane per column).
__global__ void __launch_bounds__(kLnReduceGroups * 32)
layer_norm_bwd_reduce_kernel(const float* __restrict__ parts, float* __restrict__ sums,
                             int n_parts, int hidden) {
  __shared__ float group_s[kLnReduceGroups][32];
  const int lane = threadIdx.x & 31;
  const int group = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (j < 2 * hidden) {
    const int which = j / hidden;
    const int col = j - which * hidden;
    const float* src = parts + static_cast<int64_t>(which) * n_parts * hidden + col;
#pragma unroll 4
    for (int p = group; p < n_parts; p += kLnReduceGroups) {
      s += src[static_cast<int64_t>(p) * hidden];
    }
  }
  group_s[group][lane] = s;
  __syncthreads();
  if (group == 0 && j < 2 * hidden) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kLnReduceGroups; ++q) t += group_s[q][lane];
    sums[j] = t;
  }
}

// The row-per-warp body for nv vectors a lane, 1 <= nv <= NV; false for
// another nv.
template <typename T, int NV>
static bool launch_warp(int nv, const void* dy, const void* res, const void* w, const void* b,
                        const void* mean, const void* rstd, void* dx, float* dw_part,
                        float* db_part, int64_t rows, int hidden, int n_parts, int rms,
                        int from_y, cudaStream_t st) {
  if constexpr (NV == 0) {
    return false;
  } else {
    if (nv != NV) {
      return launch_warp<T, NV - 1>(nv, dy, res, w, b, mean, rstd, dx, dw_part, db_part, rows,
                                    hidden, n_parts, rms, from_y, st);
    }
    auto kernel = from_y ? layer_norm_bwd_warp_kernel<T, NV, true>
                         : layer_norm_bwd_warp_kernel<T, NV, false>;
    static std::atomic<uint64_t> attr_set[2];
    if (set_smem(kernel, kLnBwdSmemBytes, attr_set[from_y != 0]) != 0) return false;
    kernel<<<static_cast<unsigned>(n_parts), kLnBwdThreads, kLnBwdSmemBytes, st>>>(
        static_cast<const T*>(dy), static_cast<const T*>(res), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<const float*>(mean),
        static_cast<const float*>(rstd), static_cast<T*>(dx), dw_part, db_part, rows, hidden,
        rms);
    return true;
  }
}

template <typename T>
static int launch_layer_norm_bwd(int nv, const void* dy, const void* res, const void* w,
                                 const void* b, const void* mean, const void* rstd, void* dx,
                                 void* parts, void* sums, int64_t rows, int hidden, int n_parts,
                                 int rms, int from_y, cudaStream_t stream) {
  float* dw_part = static_cast<float*>(parts);
  float* db_part = dw_part + static_cast<int64_t>(n_parts) * hidden;
  if (nv == 0) {
    const int64_t rows_per_block = (rows + n_parts - 1) / n_parts;
    const size_t smem = 2 * static_cast<size_t>(hidden) * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          layer_norm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    layer_norm_bwd_kernel<T><<<static_cast<unsigned>(n_parts), kLnBwdThreads, smem, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(res), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<const float*>(mean),
        static_cast<const float*>(rstd), static_cast<T*>(dx), dw_part, db_part, rows, hidden,
        static_cast<int>(rows_per_block), rms, from_y);
  } else {
    // the row-per-warp body's contract, checked before any launch
    constexpr int kV = kVec16<T>;
    auto on_grid = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
    if (hidden % kV != 0 || (hidden / kV + 31) / 32 != nv || !on_grid(dy) || !on_grid(res) ||
        !on_grid(dx) || !on_grid(w) || (from_y && b != nullptr && !on_grid(b)) ||
        !launch_warp<T, kLnBwdMaxLaneElems / kV>(nv, dy, res, w, b, mean, rstd, dx, dw_part,
                                                 db_part, rows, hidden, n_parts, rms, from_y,
                                                 stream)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned reduce_blocks = (2 * hidden + 31) / 32;
  layer_norm_bwd_reduce_kernel<<<reduce_blocks, kLnReduceGroups * 32, 0, stream>>>(
      static_cast<const float*>(parts), static_cast<float*>(sums), n_parts, hidden);
  return 0;
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// dy, res, dx: (rows, hidden) contiguous of `dtype` (res is x, or y when
// from_y); w: (hidden,) f32; b: (hidden,) f32 or null (read only when
// from_y); mean, rstd: (rows,) f32; parts: (2, n_parts, hidden) f32
// scratch, one partial row per block; sums: (2, hidden) f32, dgamma then
// dbeta.  nv: 16-byte vectors a lane of the row-per-warp body (n_parts
// blocks striding over the rows), or 0 for the block body (n_parts tiles
// of ceil(rows / n_parts) rows).  Returns cudaGetLastError() after the two
// launches.
extern "C" int apex_layer_norm_bwd(const void* dy, const void* res, const void* w, const void* b,
                                   const void* mean, const void* rstd, void* dx, void* parts,
                                   void* sums, int64_t rows, int hidden, int n_parts, int rms,
                                   int from_y, int dtype, int nv, void* stream) {
  if (rows <= 0 || hidden <= 0 || n_parts <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case kF32:
      rc = launch_layer_norm_bwd<float>(nv, dy, res, w, b, mean, rstd, dx, parts, sums, rows,
                                        hidden, n_parts, rms, from_y, st);
      break;
    case kBF16:
      rc = launch_layer_norm_bwd<__nv_bfloat16>(nv, dy, res, w, b, mean, rstd, dx, parts, sums,
                                                rows, hidden, n_parts, rms, from_y, st);
      break;
    case kF16:
      rc = launch_layer_norm_bwd<__half>(nv, dy, res, w, b, mean, rstd, dx, parts, sums, rows,
                                         hidden, n_parts, rms, from_y, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
