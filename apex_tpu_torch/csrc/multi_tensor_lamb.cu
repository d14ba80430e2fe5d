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
// at 3.35 TB/s.  Design: the by-value table of multi_tensor.cuh.
//
// Stage 1 (lists g, p, m, v, u): `_lamb_stage1_math` per element, with
// scal = [beta1, beta2, eps, wd, bc1, bc2, grad_scale, clip, beta3] and the
// noop flag read from device memory; m and v in place, u to an f32 scratch
// the optimizer keeps; under noop it writes u = 0 and keeps m and v.  Each
// block writes the partial sums of u^2 and p^2 of its chunk (the TPU
// kernel's row sums; no float atomics).
//
// Stage 2 (lists u, p, copy): each block first sums its tensor's partials
// in a fixed order (every block of a tensor gets the same sums) and forms
// the trust ratio ||p|| / ||u|| with the JAX rule (1 where a norm is 0;
// use_nvlamb: 1 only where ||u|| is 0); then p <- p - (lr * ratio) * u,
// skipped under noop.  Where copy is set (p is an f32 master) it also
// writes p rounded to the copy's dtype (nearest even, as astype does).

#include "multi_tensor.cuh"

namespace apex_tpu_torch {

__global__ void __launch_bounds__(kMTThreads)
multi_tensor_lamb_stage1_kernel(TensorListTable<5> tab, const float* __restrict__ scal,
                                const int* __restrict__ noop, int adam_w_mode,
                                float* __restrict__ usq, float* __restrict__ psq) {
  __shared__ float smem[32];
  int t;
  int64_t start, end;
  chunk_range(tab, t, start, end);
  const bool skip = noop != nullptr && *noop != 0;
  const float beta1 = scal[0], beta2 = scal[1], eps = scal[2], wd = scal[3];
  const float bc1 = scal[4], bc2 = scal[5], gscale = scal[6], clip = scal[7], beta3 = scal[8];
  const void* gp = tab.ptr[0][t];
  const void* pp = tab.ptr[1][t];
  float* mp = static_cast<float*>(tab.ptr[2][t]);
  float* vp = static_cast<float*>(tab.ptr[3][t]);
  float* up = static_cast<float*>(tab.ptr[4][t]);
  const int gt = tab.dtype[0][t], pt = tab.dtype[1][t];
  float us = 0.f, ps = 0.f;
  for (int64_t i = start + threadIdx.x; i < end; i += kMTThreads) {
    float g = load_any(gp, gt, i) * gscale * clip;
    const float p = load_any(pp, pt, i);
    if (!adam_w_mode) g = g + wd * p;  // classic Adam: L2 folded into the gradient
    const float m = beta1 * mp[i] + beta3 * g;
    const float v = beta2 * vp[i] + (1.f - beta2) * g * g;
    float u = (m / bc1) / (sqrtf(v / bc2) + eps);
    if (adam_w_mode) u = u + wd * p;  // decoupled weight decay
    if (skip) {
      u = 0.f;
    } else {
      mp[i] = m;
      vp[i] = v;
    }
    up[i] = u;
    us += u * u;
    ps += p * p;
  }
  const int slot = tab.chunk_base[t] + tab.block_chunk[blockIdx.x];
  const float su = block_sum(us, smem);
  const float sp = block_sum(ps, smem);
  if (threadIdx.x == 0) {
    usq[slot] = su;
    psq[slot] = sp;
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
// the number of launches made.
extern "C" int apex_multi_tensor_lamb_stage1(int n, const uint64_t* g_ptrs, const uint64_t* p_ptrs,
                                             const uint64_t* m_ptrs, const uint64_t* v_ptrs,
                                             const uint64_t* u_ptrs, const int64_t* numels,
                                             const int* g_dtypes, const int* p_dtypes,
                                             const void* scal, const void* noop, int adam_w_mode,
                                             void* usq, void* psq, int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t* ptrs[5] = {g_ptrs, p_ptrs, m_ptrs, v_ptrs, u_ptrs};
  const int* dtypes[5] = {g_dtypes, p_dtypes, nullptr, nullptr, nullptr};
  return for_each_table<5>(n, ptrs, dtypes, numels, launches,
                           [&](const TensorListTable<5>& tab, int nb) {
    multi_tensor_lamb_stage1_kernel<<<nb, kMTThreads, 0, st>>>(
        tab, static_cast<const float*>(scal), static_cast<const int*>(noop), adam_w_mode,
        static_cast<float*>(usq), static_cast<float*>(psq));
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
