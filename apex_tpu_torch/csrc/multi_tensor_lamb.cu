// Multi-tensor LAMB, stages 1 and 2, for Hopper.
//
// Replace apex_tpu/ops/multi_tensor.py `_lamb_stage1_kernel` (launched by
// `lamb_stage1_packed`) and `_lamb_stage2_kernel` (`lamb_stage2_packed`),
// over the per-leaf state the JAX FusedLAMB keeps (no packing; its per-leaf
// step runs `_lamb_stage1_math`, which XLA fuses, and eager PyTorch would
// pay ~15 launches per tensor for it).  What bounds them on the H100:
// bytes.  Stage 1 reads g, p, m, v and writes m, v and the raw update u
// (~26 bytes per element with bf16 gradients and f32 masters); stage 2
// reads u and p and writes p and, under master weights, the model's bf16
// copy (~14 bytes).  For BERT-large's 335M elements that is ~13.4 GB, ~4 ms
// at 3.35 TB/s.
//
// Stage 1 (lists g, p, m, v, u): `_lamb_stage1_math` per element, with
// scal = [beta1, beta2, eps, wd, bc1, bc2, grad_scale, clip, beta3] and the
// noop flag read from device memory; m and v in place, u to an f32 scratch
// the optimizer keeps; under noop it writes u = 0 and keeps m and v.  Each
// block writes the partial sums of u^2 and p^2 of its chunk (the TPU
// kernel's row sums; no float atomics).  Design: one launch for a whole
// list, on the by-value table of multi_tensor_list.cuh (kLambMaxTensors
// tensors of five lists, the most that fit the 32,764 bytes of kernel
// parameters), so BERT-large's 299 tensors and GPT-350M's 291 take one
// launch.  A block owns one kMTChunk-element chunk of a tensor, the chunks
// numbered as the shared table of multi_tensor.cuh numbers them, so stage
// 2 reads the partials as it always did.  Each thread moves 8 elements a
// step with 16-byte loads and stores (g, p by their dtype; m, v, u f32),
// kLambUnroll steps in flight, after the tensor's scalar head
// (`vector_head` over the five lists; lists that no head aligns run
// scalar).  The (g, p) dtype signature is a template of the body, selected
// once per block: all nine.  Each element's f32 statements are those of
// `_lamb_stage1_math`, each rounding pinned by an intrinsic where the
// compiler put it in the first port of this kernel (a scalar loop over the
// shared table), so the same inputs give the same m, v and u.
//
// Stage 2 (lists u, p, copy), on the shared table of multi_tensor.cuh:
// each block first sums its tensor's partials in a fixed order (every
// block of a tensor gets the same sums) and forms the trust ratio
// ||p|| / ||u|| with the JAX rule (1 where a norm is 0; use_nvlamb: 1 only
// where ||u|| is 0); then p <- p - (lr * ratio) * u, skipped under noop.
// Where copy is set (p is an f32 master) it also writes p rounded to the
// copy's dtype (nearest even, as astype does).

#include "multi_tensor.cuh"
#include "multi_tensor_list.cuh"

namespace apex_tpu_torch {

constexpr int kLambMaxTensors = 605;
constexpr int kLambThreads = 512;
constexpr int kLambUnroll = 2;  // 8-element steps in flight

// lists g, p, m, v, u (m, v, u f32); sig = g * 3 + p (dtype codes)
using LambTable = ListTable<5, kLambMaxTensors>;
// the table, four pointers and two ints; kLambMaxTensors is the largest
// table that fits
static_assert(sizeof(LambTable) + 4 * 8 + 2 * 4 <= kListParamLimit,
              "kernel parameters exceed the 32,764-byte limit");
static_assert(sizeof(ListTable<5, kLambMaxTensors + 1>) + 4 * 8 + 2 * 4 > kListParamLimit,
              "a larger table would fit");

struct LambArgs {
  float beta1, beta2, eps, wd, bc1, bc2, gscale, clip, beta3;
  int adam_w_mode;
};

// one element: the statements of `_lamb_stage1_math`, in its order, with
// each rounding pinned by an intrinsic (the compiler contracts nothing)
// where the compiler put it in the first port of this kernel: g scaled by
// grad_scale then clip, rounded apart; classic Adam's g + wd * p, and
// AdamW's u + wd * p, as FMAs; m as fma(beta1, m, round(beta3 * g)) and v
// as fma(beta2, v, round(round((1 - beta2) * g) * g)); the divisions and
// the square root correctly rounded.  m and v are updated in place.
__device__ __forceinline__ float lamb_update(float g, float p, float& m, float& v,
                                             const LambArgs& a) {
  g = __fmul_rn(__fmul_rn(g, a.gscale), a.clip);
  if (!a.adam_w_mode) g = __fmaf_rn(a.wd, p, g);
  m = __fmaf_rn(a.beta1, m, __fmul_rn(a.beta3, g));
  v = __fmaf_rn(a.beta2, v, __fmul_rn(__fmul_rn(1.f - a.beta2, g), g));
  float u = __fdiv_rn(__fdiv_rn(m, a.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, a.bc2)), a.eps));
  if (a.adam_w_mode) u = __fmaf_rn(a.wd, p, u);
  return u;
}

// elements [s, e) of tensor t, with g, p of types G, P: the scalar head,
// the 16-byte steps, the scalar tail; returns this thread's sums of u^2
// and p^2 in `us`, `ps`
template <typename G, typename P>
__device__ __forceinline__ void lamb_chunk(const LambTable& tab, int t, int64_t s, int64_t e,
                                           const LambArgs& a, bool skip, float& us, float& ps) {
  const G* g = static_cast<const G*>(tab.ptr[0][t]);
  const P* p = static_cast<const P*>(tab.ptr[1][t]);
  float* m = static_cast<float*>(tab.ptr[2][t]);
  float* v = static_cast<float*>(tab.ptr[3][t]);
  float* u = static_cast<float*>(tab.ptr[4][t]);
  const int head = tab.head[t];
  const int64_t vs = head == kListNoVector ? e : min(e, s + head);
  const int64_t n_vec = (e - vs) / 8;
  const int64_t ve = vs + 8 * n_vec;

  auto scalar = [&](int64_t i) {
    const float pi = to_f32(p[i]);
    float mi = m[i], vi = v[i];
    const float ui = skip ? 0.f : lamb_update(to_f32(g[i]), pi, mi, vi, a);
    if (!skip) {
      m[i] = mi;
      v[i] = vi;
    }
    u[i] = ui;
    us = __fmaf_rn(ui, ui, us);
    ps = __fmaf_rn(pi, pi, ps);
  };
  for (int64_t i = s + threadIdx.x; i < vs; i += kLambThreads) scalar(i);
  for (int64_t i = ve + threadIdx.x; i < e; i += kLambThreads) scalar(i);

  for (int64_t v0 = threadIdx.x; v0 < n_vec; v0 += kLambThreads * kLambUnroll) {
    float gv[kLambUnroll][8], pv[kLambUnroll][8], mv[kLambUnroll][8], vv[kLambUnroll][8];
#pragma unroll
    for (int k = 0; k < kLambUnroll; ++k) {
      const int64_t i = vs + 8 * (v0 + k * kLambThreads);
      if (v0 + k * kLambThreads < n_vec) {
        load8(g + i, gv[k]);
        load8(p + i, pv[k]);
        load8(m + i, mv[k]);
        load8(v + i, vv[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kLambUnroll; ++k) {
      const int64_t i = vs + 8 * (v0 + k * kLambThreads);
      if (v0 + k * kLambThreads < n_vec) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float pj = pv[k][j];
          gv[k][j] = skip ? 0.f : lamb_update(gv[k][j], pj, mv[k][j], vv[k][j], a);
          us = __fmaf_rn(gv[k][j], gv[k][j], us);
          ps = __fmaf_rn(pj, pj, ps);
        }
        store8(u + i, gv[k]);
        if (!skip) {
          store8(m + i, mv[k]);
          store8(v + i, vv[k]);
        }
      }
    }
  }
}

template <typename G>
__device__ __forceinline__ void lamb_param_type(int sig, const LambTable& tab, int t, int64_t s,
                                                int64_t e, const LambArgs& a, bool skip,
                                                float& us, float& ps) {
  switch (sig % 3) {
    case kF32: lamb_chunk<G, float>(tab, t, s, e, a, skip, us, ps); break;
    case kBF16: lamb_chunk<G, __nv_bfloat16>(tab, t, s, e, a, skip, us, ps); break;
    default: lamb_chunk<G, __half>(tab, t, s, e, a, skip, us, ps);
  }
}

// usq / psq: this launch's partials (block b writes entry b)
__global__ void __launch_bounds__(kLambThreads)
multi_tensor_lamb_stage1_kernel(const __grid_constant__ LambTable tab,
                                const float* __restrict__ scal, const int* __restrict__ noop,
                                float* __restrict__ usq, float* __restrict__ psq, int n_tensors,
                                int adam_w_mode) {
  __shared__ float smem[32];
  const int block = static_cast<int>(blockIdx.x);
  const int t = list_tensor(tab, n_tensors, block);
  const int64_t s = static_cast<int64_t>(block - tab.chunk_start[t]) * kMTChunk;
  const int64_t e = min(tab.numel[t], s + kMTChunk);
  const bool skip = noop != nullptr && *noop != 0;
  const LambArgs a{scal[0], scal[1], scal[2], scal[3], scal[4], scal[5], scal[6], scal[7],
                   scal[8], adam_w_mode};
  float us = 0.f, ps = 0.f;
  const int sig = tab.sig[t];
  switch (sig / 3) {
    case kF32: lamb_param_type<float>(sig, tab, t, s, e, a, skip, us, ps); break;
    case kBF16: lamb_param_type<__nv_bfloat16>(sig, tab, t, s, e, a, skip, us, ps); break;
    default: lamb_param_type<__half>(sig, tab, t, s, e, a, skip, us, ps);
  }
  const float su = block_sum(us, smem);
  const float sp = block_sum(ps, smem);
  if (threadIdx.x == 0) {
    usq[block] = su;
    psq[block] = sp;
  }
}

__global__ void __launch_bounds__(kMTThreads)
multi_tensor_lamb_stage2_kernel(TensorListTable<3> tab, const float* __restrict__ usq,
                                const float* __restrict__ psq, const float* __restrict__ lr,
                                const int* __restrict__ noop, int use_nvlamb) {
  __shared__ float smem[32];
  __shared__ float ratio_s;
  if (noop != nullptr && *noop != 0) return;
  int t;
  int64_t start, end;
  chunk_range(tab, t, start, end);
  const int base = tab.chunk_base[t];
  const int n_chunks = static_cast<int>((tab.numel[t] + kMTChunk - 1) / kMTChunk);
  float a = 0.f, b = 0.f;
  for (int c = threadIdx.x; c < n_chunks; c += kMTThreads) {
    a += usq[base + c];
    b += psq[base + c];
  }
  const float su = block_sum(a, smem);
  const float sp = block_sum(b, smem);
  if (threadIdx.x == 0) {
    const float u_norm = sqrtf(su), p_norm = sqrtf(sp);
    const bool apply = use_nvlamb ? u_norm > 0.f : (p_norm > 0.f && u_norm > 0.f);
    ratio_s = apply ? p_norm / u_norm : 1.f;
  }
  __syncthreads();
  const float step = *lr * ratio_s;
  const float* up = static_cast<const float*>(tab.ptr[0][t]);
  void* pp = tab.ptr[1][t];
  void* cp = tab.ptr[2][t];
  const int pt = tab.dtype[1][t], ct = tab.dtype[2][t];
  for (int64_t i = start + threadIdx.x; i < end; i += kMTThreads) {
    const float p = load_any(pp, pt, i) - step * up[i];
    store_any(pp, pt, i, p);
    if (cp != nullptr) store_any(cp, ct, i, p);
  }
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// Stage 1 over n tensors: g/p/m/v/u host arrays of device addresses (m, v,
// u f32), numels, g_dtypes/p_dtypes dtype codes; scal: device f32[9]; noop:
// device int32 or null; usq/psq: device f32[chunks].  *launches receives
// the number of launches made: one per kLambMaxTensors non-empty tensors.
extern "C" int apex_multi_tensor_lamb_stage1(int n, const uint64_t* g_ptrs, const uint64_t* p_ptrs,
                                             const uint64_t* m_ptrs, const uint64_t* v_ptrs,
                                             const uint64_t* u_ptrs, const int64_t* numels,
                                             const int* g_dtypes, const int* p_dtypes,
                                             const void* scal, const void* noop, int adam_w_mode,
                                             void* usq, void* psq, int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t* ptrs[5] = {g_ptrs, p_ptrs, m_ptrs, v_ptrs, u_ptrs};
  const int* codes[5] = {g_dtypes, p_dtypes, nullptr, nullptr, nullptr};
  return walk_lists<5, kLambMaxTensors>(
      n, ptrs, codes, numels, kMTChunk, launches,
      [](const int (&code)[5], const uint64_t (&)[5]) { return code[0] * 3 + code[1]; },
      [&](const LambTable& tab, int nt, int64_t chunks, int64_t first) {
        multi_tensor_lamb_stage1_kernel<<<static_cast<unsigned>(chunks), kLambThreads, 0, st>>>(
            tab, static_cast<const float*>(scal), static_cast<const int*>(noop),
            static_cast<float*>(usq) + first, static_cast<float*>(psq) + first, nt,
            adam_w_mode);
        return static_cast<int>(cudaGetLastError());
      });
}

// Stage 2 over the same n tensors: u (f32), p and copy (0 where a tensor has
// no copy) host arrays of device addresses, numels, p_dtypes/copy_dtypes;
// usq/psq: stage 1's partials; lr: device f32 scalar; noop: device int32 or
// null.  *launches receives the number of launches made.
extern "C" int apex_multi_tensor_lamb_stage2(int n, const uint64_t* u_ptrs, const uint64_t* p_ptrs,
                                             const uint64_t* copy_ptrs, const int64_t* numels,
                                             const int* p_dtypes, const int* copy_dtypes,
                                             const void* usq, const void* psq, const void* lr,
                                             const void* noop, int use_nvlamb, int* launches,
                                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t* ptrs[3] = {u_ptrs, p_ptrs, copy_ptrs};
  const int* dtypes[3] = {nullptr, p_dtypes, copy_dtypes};
  return for_each_table<3>(n, ptrs, dtypes, numels, launches,
                           [&](const TensorListTable<3>& tab, int nb) {
    multi_tensor_lamb_stage2_kernel<<<nb, kMTThreads, 0, st>>>(
        tab, static_cast<const float*>(usq), static_cast<const float*>(psq),
        static_cast<const float*>(lr), static_cast<const int*>(noop), use_nvlamb);
    return static_cast<int>(cudaGetLastError());
  });
}
