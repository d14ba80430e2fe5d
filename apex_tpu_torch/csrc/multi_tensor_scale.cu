// Multi-tensor scale with found-inf for Hopper: out = x * s.
//
// Replaces apex_tpu/ops/multi_tensor.py `_scale_kernel` (launched by
// `scale_packed`): the amp unscale (`LossScaler.unscale`), the rescale of
// `clip_grad_norm_`, `multi_tensor_scale` and FusedAdam's copy of f32
// masters into the model's 16-bit parameters.  What bounds it on the H100:
// bytes, one read of x and one write of out per element, one f32 multiply;
// BERT-large's 335M bf16 and f32 gradients take ~0.4 ms at 3.35 TB/s.
//
// Design: one launch for a whole list, on the by-value table of
// multi_tensor_list.cuh (kScaleMaxTensors tensors of two lists, about 30
// KB), so BERT-large's 299 tensors and GPT-350M's 291 take one launch; a
// longer list takes ceil(tensors / kScaleMaxTensors) launches.  The grid is
// one block per kScaleChunk-element chunk of every tensor.  Each thread
// moves 8 elements a step with 16-byte loads and stores (x and out: one
// word each in bf16 / f16, two in f32), kScaleUnroll steps in flight, after
// the tensor's scalar head (`vector_head` over x and out); a tensor whose
// two lists no head aligns runs scalar.  The (in, out) dtype pair is a
// template of the body, selected once per block from the table's `sig`:
// all nine pairs of f32, bf16 and f16, nothing switched inside the element
// loop.
//
// The product is taken in f32 (`__fmul_rn`) and stored in the output's
// dtype (round to nearest even), as the first port of this kernel did, so
// the outputs are bitwise its outputs; in == out is allowed (each element
// is read before it is written, by the same thread).  The found-inf flag
// is taken on the f32 product before rounding, as the JAX kernel takes it
// (an f16 output that overflows is not flagged).  The TPU kernel carries
// the flag across its sequential grid; here blocks run concurrently, so the
// caller zeroes the flag on the stream before the launch and any block
// that meets a non-finite product stores 1.0 once (apex's benign race:
// every writer writes the same value).  s and the flag live in device
// memory: no host sync.

#include "multi_tensor_list.cuh"

namespace apex_tpu_torch {

constexpr int kScaleMaxTensors = 1024;
constexpr int kScaleThreads = 512;
constexpr int kScaleUnroll = 2;        // 8-element steps in flight
constexpr int64_t kScaleChunk = 8192;  // elements per block

// lists in, out; sig = in * 3 + out (dtype codes)
using ScaleTable = ListTable<2, kScaleMaxTensors>;
// the table, two pointers and an int
static_assert(sizeof(ScaleTable) + 2 * 8 + 4 <= kListParamLimit,
              "kernel parameters exceed the 32,764-byte limit");
static_assert(kScaleChunk % 8 == 0, "a chunk must keep the tensor's 16-byte phase");

// elements [s, e) of tensor t, x of type I into out of type O: the scalar
// head, the 16-byte steps, the scalar tail; returns whether a product of
// this thread was not finite
template <typename I, typename O>
__device__ __forceinline__ bool scale_chunk(const ScaleTable& tab, int t, int64_t s, int64_t e,
                                            float sc) {
  const I* in = static_cast<const I*>(tab.ptr[0][t]);
  O* out = static_cast<O*>(tab.ptr[1][t]);
  const int head = tab.head[t];
  const int64_t vs = head == kListNoVector ? e : min(e, s + head);
  const int64_t n_vec = (e - vs) / 8;
  const int64_t ve = vs + 8 * n_vec;
  bool bad = false;

  auto scalar = [&](int64_t i) {
    const float y = __fmul_rn(to_f32(in[i]), sc);
    bad |= !isfinite(y);
    out[i] = from_f32<O>(y);
  };
  for (int64_t i = s + threadIdx.x; i < vs; i += kScaleThreads) scalar(i);
  for (int64_t i = ve + threadIdx.x; i < e; i += kScaleThreads) scalar(i);

  for (int64_t v0 = threadIdx.x; v0 < n_vec; v0 += kScaleThreads * kScaleUnroll) {
    float v[kScaleUnroll][8];
#pragma unroll
    for (int u = 0; u < kScaleUnroll; ++u) {
      if (v0 + u * kScaleThreads < n_vec) load8(in + vs + 8 * (v0 + u * kScaleThreads), v[u]);
    }
#pragma unroll
    for (int u = 0; u < kScaleUnroll; ++u) {
      if (v0 + u * kScaleThreads < n_vec) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          v[u][k] = __fmul_rn(v[u][k], sc);
          bad |= !isfinite(v[u][k]);
        }
        store8(out + vs + 8 * (v0 + u * kScaleThreads), v[u]);
      }
    }
  }
  return bad;
}

template <typename I>
__device__ __forceinline__ bool scale_out_type(int sig, const ScaleTable& tab, int t, int64_t s,
                                               int64_t e, float sc) {
  switch (sig % 3) {
    case kF32: return scale_chunk<I, float>(tab, t, s, e, sc);
    case kBF16: return scale_chunk<I, __nv_bfloat16>(tab, t, s, e, sc);
    default: return scale_chunk<I, __half>(tab, t, s, e, sc);
  }
}

__global__ void __launch_bounds__(kScaleThreads)
multi_tensor_scale_kernel(const __grid_constant__ ScaleTable tab, const float* __restrict__ scale,
                          float* __restrict__ found_inf, int n_tensors) {
  const int block = static_cast<int>(blockIdx.x);
  const int t = list_tensor(tab, n_tensors, block);
  const int64_t s = static_cast<int64_t>(block - tab.chunk_start[t]) * kScaleChunk;
  const int64_t e = min(tab.numel[t], s + kScaleChunk);
  const float sc = *scale;
  const int sig = tab.sig[t];
  bool bad;
  switch (sig / 3) {
    case kF32: bad = scale_out_type<float>(sig, tab, t, s, e, sc); break;
    case kBF16: bad = scale_out_type<__nv_bfloat16>(sig, tab, t, s, e, sc); break;
    default: bad = scale_out_type<__half>(sig, tab, t, s, e, sc);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) *found_inf = 1.f;
}

}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// n tensors: in_ptrs/out_ptrs host arrays of device addresses, numels the
// element counts, in_dtypes/out_dtypes the dtype codes.  scale: device f32
// scalar; found_inf: device f32 scalar the caller has zeroed.  *launches
// receives the number of kernel launches made: one per kScaleMaxTensors
// non-empty tensors.
extern "C" int apex_multi_tensor_scale(int n, const uint64_t* in_ptrs, const uint64_t* out_ptrs,
                                       const int64_t* numels, const int* in_dtypes,
                                       const int* out_dtypes, const void* scale, void* found_inf,
                                       int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t* ptrs[2] = {in_ptrs, out_ptrs};
  const int* codes[2] = {in_dtypes, out_dtypes};
  return walk_lists<2, kScaleMaxTensors>(
      n, ptrs, codes, numels, kScaleChunk, launches,
      [](const int (&code)[2], const uint64_t (&)[2]) { return code[0] * 3 + code[1]; },
      [&](const ScaleTable& tab, int nt, int64_t chunks, int64_t) {
        multi_tensor_scale_kernel<<<static_cast<unsigned>(chunks), kScaleThreads, 0, st>>>(
            tab, static_cast<const float*>(scale), static_cast<float*>(found_inf), nt);
        return static_cast<int>(cudaGetLastError());
      });
}
