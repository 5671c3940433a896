// Shared helpers for the port's hand-written Hopper kernels: the masked
// score, bf16/f32 conversions and warp reductions.  The decode kernels'
// warp tile is in decode_warp.cuh, the wgmma attention tile in
// attn_tile.cuh.
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

}  // namespace repro

REPRO_EXPORT const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
