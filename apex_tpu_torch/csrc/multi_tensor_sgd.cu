// Multi-tensor SGD (+ momentum) for Hopper.
//
// Replaces apex_tpu/ops/multi_tensor.py `_sgd_kernel` (launched by
// `sgd_packed`; math `_sgd_math`), over the per-leaf state the JAX FusedSGD
// keeps (no packing).  What bounds it on the H100: bytes.  Per element it
// reads g, p and the f32 momentum buffer and writes p and the buffer (and,
// under master weights, the model's bf16 copy), ~10 f32 operations: 20
// bytes per element with f32 g and p, ~2.1 ms for GPT-350M's 354M elements
// at 3.35 TB/s, ~0.15 ms for ResNet-50's 25.6M.
//
// Design: one launch for a whole list, on the by-value table of
// multi_tensor_list.cuh (kSgdMaxTensors tensors, about 29 KB), so
// ResNet-50's 161 parameters and GPT-350M's 291 take one launch; a longer
// list takes ceil(tensors / kSgdMaxTensors) launches.  The grid is one
// block per kSgdChunk-element chunk of every tensor (several full waves on
// ResNet-50's list; a tensor of 64 elements holds a block for one short
// pass, not an SM).  Each thread moves 8 elements a step with 16-byte
// loads and stores (g: one in bf16 / f16, two in f32; p and the buffer two
// each; the copy one in bf16), kSgdUnroll steps in flight, after the
// tensor's scalar head (`vector_head`); lists that no head can align run
// scalar.  The (g, p, copy) dtype signature is a template of the body,
// selected once per block: all 36 combinations the wrapper takes.
//
// The five scalars [lr, wd, momentum, dampening, grad_scale] and the noop
// flag are read from device memory: the optimizer zeroes the dampening on
// step 1 with a device select from its step count (JAX `fused_sgd.py:47`),
// and a dynamic-loss-scale skip makes every block return before it writes.
// The JAX kernel's static flags are launch arguments: nesterov, first_run
// (the buffer seeded with g), wd_after_momentum, momentum_zero (apex's
// `momentum_mode`: the buffer is neither read nor written).  Each element's
// f32 statements are those of the JAX `_sgd_math`, in its order, rounded
// as the first port of this kernel rounded them (`sgd_update`).  p, buf
// and copy are updated in place (the JAX kernel aliases p and buf).

#include <type_traits>

#include "multi_tensor_list.cuh"

namespace apex_tpu_torch {

constexpr int kSgdMaxTensors = 640;
constexpr int kSgdThreads = 256;
constexpr int kSgdUnroll = 2;                        // 8-element steps in flight
constexpr int64_t kSgdChunk = 8192;                  // elements per block

// lists g, p, buf (f32), copy (null: none); sig = g * 12 + p * 4 + copy
// (dtype codes; copy 0 for none, else 1 + its code)
using SgdTable = ListTable<4, kSgdMaxTensors>;
// the table, two pointers and five ints
static_assert(sizeof(SgdTable) + 2 * 8 + 5 * 4 <= kListParamLimit,
              "kernel parameters exceed the 32,764-byte limit");

struct SgdArgs {
  float lr, wd, mom, damp, gscale;
  int nesterov, first_run, wd_after_momentum, momentum_zero;
};

// one element: the statements of `_sgd_math`, in its order, with each
// rounding pinned by an intrinsic (the compiler contracts nothing) where
// the compiler put them in the first port of this kernel (a scalar loop
// over the shared multi-tensor table), so the same inputs give the same
// bits as that kernel gave: g * grad_scale and wd * p
// rounded apart and added, the buffer as fma(1 - dampening, g, round(mom *
// buf)), Nesterov's g + mom * buf and p - lr * update as FMAs; without
// momentum, g * grad_scale + wd * p as one FMA (over g before the
// momentum, over wd * p after it).
__device__ __forceinline__ float sgd_update(float g, float p, float& buf, const SgdArgs& a) {
  const float wdp = __fmul_rn(a.wd, p);
  float upd;
  if (a.momentum_zero) {
    upd = a.wd_after_momentum ? __fmaf_rn(a.wd, p, __fmul_rn(g, a.gscale))
                              : __fmaf_rn(g, a.gscale, wdp);
  } else {
    g = __fmul_rn(g, a.gscale);
    if (!a.wd_after_momentum) g = __fadd_rn(g, wdp);
    buf = a.first_run ? g : __fmaf_rn(1.f - a.damp, g, __fmul_rn(a.mom, buf));
    upd = a.nesterov ? __fmaf_rn(a.mom, buf, g) : buf;
    if (a.wd_after_momentum) upd = __fadd_rn(upd, wdp);
  }
  return __fmaf_rn(-a.lr, upd, p);
}

// elements [s, e) of tensor t, with g, p, copy of types G, P, C (C void:
// no copy): the scalar head, the 16-byte steps, the scalar tail
template <typename G, typename P, typename C>
__device__ __forceinline__ void sgd_chunk(const SgdTable& tab, int t, int64_t s, int64_t e,
                                          const SgdArgs& a) {
  constexpr bool kCopy = !std::is_void<C>::value;
  const G* g = static_cast<const G*>(tab.ptr[0][t]);
  P* p = static_cast<P*>(tab.ptr[1][t]);
  float* buf = static_cast<float*>(tab.ptr[2][t]);
  C* c = static_cast<C*>(tab.ptr[3][t]);
  const int head = tab.head[t];
  const int64_t vs = head == kListNoVector ? e : min(e, s + head);
  const int64_t n_vec = (e - vs) / 8;
  const int64_t ve = vs + 8 * n_vec;
  const bool read_buf = !a.momentum_zero && !a.first_run;

  auto scalar = [&](int64_t i) {
    float b = read_buf ? buf[i] : 0.f;
    const float pn = sgd_update(to_f32(g[i]), to_f32(p[i]), b, a);
    if (!a.momentum_zero) buf[i] = b;
    p[i] = from_f32<P>(pn);
    if constexpr (kCopy) c[i] = from_f32<C>(pn);
  };
  for (int64_t i = s + threadIdx.x; i < vs; i += kSgdThreads) scalar(i);
  for (int64_t i = ve + threadIdx.x; i < e; i += kSgdThreads) scalar(i);

  for (int64_t v0 = threadIdx.x; v0 < n_vec; v0 += kSgdThreads * kSgdUnroll) {
    float gv[kSgdUnroll][8], pv[kSgdUnroll][8], bv[kSgdUnroll][8];
#pragma unroll
    for (int u = 0; u < kSgdUnroll; ++u) {
      const int64_t i = vs + 8 * (v0 + u * kSgdThreads);
      if (v0 + u * kSgdThreads < n_vec) {
        load8(g + i, gv[u]);
        load8(p + i, pv[u]);
        if (read_buf) {
          load8(buf + i, bv[u]);
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) bv[u][k] = 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kSgdUnroll; ++u) {
      const int64_t i = vs + 8 * (v0 + u * kSgdThreads);
      if (v0 + u * kSgdThreads < n_vec) {
#pragma unroll
        for (int k = 0; k < 8; ++k) pv[u][k] = sgd_update(gv[u][k], pv[u][k], bv[u][k], a);
        store8(p + i, pv[u]);
        if (!a.momentum_zero) store8(buf + i, bv[u]);
        if constexpr (kCopy) store8(c + i, pv[u]);
      }
    }
  }
}

// the body of one (g, p, copy) signature
template <typename G, typename P>
__device__ __forceinline__ void sgd_copy_type(int copy, const SgdTable& tab, int t, int64_t s,
                                              int64_t e, const SgdArgs& a) {
  switch (copy) {
    case 0: sgd_chunk<G, P, void>(tab, t, s, e, a); break;
    case 1 + kF32: sgd_chunk<G, P, float>(tab, t, s, e, a); break;
    case 1 + kBF16: sgd_chunk<G, P, __nv_bfloat16>(tab, t, s, e, a); break;
    default: sgd_chunk<G, P, __half>(tab, t, s, e, a);
  }
}

template <typename G>
__device__ __forceinline__ void sgd_param_type(int sig, const SgdTable& tab, int t, int64_t s,
                                               int64_t e, const SgdArgs& a) {
  switch ((sig / 4) % 3) {
    case kF32: sgd_copy_type<G, float>(sig % 4, tab, t, s, e, a); break;
    case kBF16: sgd_copy_type<G, __nv_bfloat16>(sig % 4, tab, t, s, e, a); break;
    default: sgd_copy_type<G, __half>(sig % 4, tab, t, s, e, a);
  }
}

// scal: [lr, wd, momentum, dampening, grad_scale]
__global__ void __launch_bounds__(kSgdThreads)
multi_tensor_sgd_kernel(const __grid_constant__ SgdTable tab, const float* __restrict__ scal,
                        const int* __restrict__ noop, int n_tensors, int nesterov,
                        int first_run, int wd_after_momentum, int momentum_zero) {
  if (noop != nullptr && *noop != 0) return;
  const int block = static_cast<int>(blockIdx.x);
  const int t = list_tensor(tab, n_tensors, block);
  const int64_t s = static_cast<int64_t>(block - tab.chunk_start[t]) * kSgdChunk;
  const int64_t e = min(tab.numel[t], s + kSgdChunk);
  const SgdArgs a{scal[0], scal[1], scal[2], scal[3], scal[4],
                  nesterov, first_run, wd_after_momentum, momentum_zero};
  const int sig = tab.sig[t];
  switch (sig / 12) {
    case kF32: sgd_param_type<float>(sig, tab, t, s, e, a); break;
    case kBF16: sgd_param_type<__nv_bfloat16>(sig, tab, t, s, e, a); break;
    default: sgd_param_type<__half>(sig, tab, t, s, e, a);
  }
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// n tensors: g/p/buf/copy host arrays of device addresses (buf f32; copy 0
// where a tensor has none), numels, g/p/copy dtype codes; scal: device
// f32[5]; noop: device int32 or null; then the four static flags.
// *launches receives the number of launches made: one per kSgdMaxTensors
// non-empty tensors.
extern "C" int apex_multi_tensor_sgd(int n, const uint64_t* g_ptrs, const uint64_t* p_ptrs,
                                     const uint64_t* buf_ptrs, const uint64_t* copy_ptrs,
                                     const int64_t* numels, const int* g_dtypes,
                                     const int* p_dtypes, const int* copy_dtypes,
                                     const void* scal, const void* noop, int nesterov,
                                     int first_run, int wd_after_momentum, int momentum_zero,
                                     int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t* ptrs[4] = {g_ptrs, p_ptrs, buf_ptrs, copy_ptrs};
  const int* codes[4] = {g_dtypes, p_dtypes, nullptr, copy_dtypes};
  return walk_lists<4, kSgdMaxTensors>(
      n, ptrs, codes, numels, kSgdChunk, launches,
      [](const int (&code)[4], const uint64_t (&addr)[4]) {
        return code[0] * 12 + code[1] * 4 + (addr[3] != 0 ? 1 + code[3] : 0);
      },
      [&](const SgdTable& tab, int nt, int64_t chunks, int64_t) {
        multi_tensor_sgd_kernel<<<static_cast<unsigned>(chunks), kSgdThreads, 0, st>>>(
            tab, static_cast<const float*>(scal), static_cast<const int*>(noop), nt, nesterov,
            first_run, wd_after_momentum, momentum_zero);
        return static_cast<int>(cudaGetLastError());
      });
}
