// Shared helpers for the port's hand-written Hopper kernels.
//
// decode_tile is the flash-decoding step of the paged (decode over a block
// table) and the dense (decode over a per-slot cache) decode kernels.
//
// Every kernel library is built on its own by nvcc into a shared object with
// a plain C interface (see kernels/build.py) and loaded with ctypes.  Each
// launch function returns cudaGetLastError() as an int; the Python wrapper
// raises with the message from repro_cuda_error_string when it is not 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

constexpr float kNeg = -1e30f;   // masked score, as the JAX package uses

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// One step of GQA flash-decoding, shared by the paged and the dense decode
// kernels: the G query rows of one kv head (shared memory qs [G][hd])
// against the visible keys [t0, t1) of one tile, whose key and value t sit
// at kb + t * row and vb + t * row (head dim contiguous).  ps [G][ldp] holds
// the tile's scores and then its probabilities; ms / ls / as the running
// max, the running denominator and this tile's rescale of each row; every
// thread owns the accumulator entries idx = threadIdx.x + j * kThreads of
// the [G][hd] output.  Any head dim up to kMaxHd: lane l of a warp owns the
// dims l, l + 32, ...; lanes past hd hold zeros.  All threads of the block
// call it (it synchronises).
template <int kThreads, int kMaxHd, int kMaxPairs, typename T>
__device__ __forceinline__ void decode_tile(
    const float* qs, const T* __restrict__ kb, const T* __restrict__ vb,
    size_t row, int t0, int t1, int G, int hd, int ldp, float scale,
    float* ps, float* ms, float* ls, float* as, float (&acc)[kMaxPairs]) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nd = (hd + 31) / 32;             // 32-wide lane groups, tail masked

  // ---- scores s[g][t] = q[g] . k[t] * scale, one key per warp at a time
  for (int t = t0 + warp; t < t1; t += kWarps) {
    float kr[kMaxHd / 32];
#pragma unroll
    for (int j = 0; j < kMaxHd / 32; ++j)
      kr[j] = j < nd && lane + 32 * j < hd
          ? to_float(kb[t * row + lane + 32 * j]) : 0.f;
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxHd / 32; ++j)
        if (j < nd && lane + 32 * j < hd) s += qs[g * hd + lane + 32 * j] * kr[j];
      s = warp_sum(s);
      if (lane == 0) ps[g * ldp + t] = s * scale;
    }
  }
  __syncthreads();

  // ---- online softmax statistics, one warp per query row
  for (int g = warp; g < G; g += kWarps) {
    float mx = kNeg;
    for (int t = t0 + lane; t < t1; t += 32) mx = fmaxf(mx, ps[g * ldp + t]);
    mx = warp_max(mx);
    const float m_new = fmaxf(ms[g], mx);
    float sum = 0.f;
    for (int t = t0 + lane; t < t1; t += 32) {
      const float p = expf(ps[g * ldp + t] - m_new);
      ps[g * ldp + t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float alpha = expf(ms[g] - m_new);
      as[g] = alpha;
      ls[g] = ls[g] * alpha + sum;
      ms[g] = m_new;
    }
  }
  __syncthreads();

  // ---- acc[g][d] = acc * alpha + sum_t p[g][t] v[t][d]
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) {
    const int idx = tid + j * kThreads;
    if (idx < G * hd) {
      const int g = idx / hd, d = idx - (idx / hd) * hd;
      float a = acc[j] * as[g];
      for (int t = t0; t < t1; ++t)
        a += ps[g * ldp + t] * to_float(vb[t * row + d]);
      acc[j] = a;
    }
  }
  __syncthreads();
}

}  // namespace repro

REPRO_EXPORT const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
