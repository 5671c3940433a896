// Helpers shared by the paged and the dense GQA decode kernels (sm_90a):
// their launch shape (kThreads threads, up to kG query rows a block, a
// kStages-deep cp.async ring of 16-byte K/V pieces per warp), the 16-byte
// row loads, the programmatic-dependent kernel that merges the key-range
// splits' partials, and the choice of lane layout from the head dim.
//
// The warp tile itself (copy ring, scores, online softmax, warp merge) is
// written out in each kernel.  One shared tile, parametrised by how a
// position maps to its K/V row, compiled to the same main loop but a
// prologue 77 instructions longer in the paged kernel, and made its
// 4096-position time 1.9% slower than with its own tile on an H100
// (PERF.md, Findings); so the paged kernel keeps its own tile and the
// dense kernel a copy with strides in place of the block table.
#pragma once

#include <cstdint>
#include <type_traits>

#include "attn_tile.cuh"

namespace repro {
namespace dec {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kG = 4;                        // query rows a block holds
constexpr int kStages = 3;                   // tiles in a warp's copy ring

// uint4 slots of one warp's ring: [stage][K, V][step][piece][lane]
template <int kC>
__host__ __device__ constexpr int ring_slots() {
  return kStages * 2 * (8 / kC) * kC * 32;
}

// Dynamic shared memory of a kernel's tile: the warps' rings, then the
// per-warp max and denominator of each query row; its own data follows.
template <int kC>
__host__ __device__ constexpr size_t smem_bytes() {
  return 16 * static_cast<size_t>(kWarps) * ring_slots<kC>() +
         sizeof(float) * 2 * kWarps * kG;
}

// 16 bytes of a row: elements [ci * kE, ci * kE + kE), zero past hd.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ row, int ci,
                                            int hd, bool vec) {
  constexpr int kE = 16 / sizeof(T);
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  const int d0 = ci * kE;
  if (vec) {
    if (d0 < hd) u = __ldg(reinterpret_cast<const uint4*>(row + d0));
  } else {
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < kE; ++i)
      if (d0 + i < hd) e[i] = row[d0 + i];
  }
  return u;
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {              // bf16 -> f32 is exact
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Merge the splits' partials of one query row (grid: one block a row).
// Launched as a programmatic dependent of the split kernel, so its launch
// overlaps that kernel; griddepcontrol.wait holds it until the split
// kernel has finished and its partials are visible.
template <typename T>
__global__ void __launch_bounds__(kThreads) combine_kernel(
    const float* __restrict__ part, T* __restrict__ out, int hd,
    int nsplit) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t row = blockIdx.x;
  const float* pr = part + row * nsplit * (hd + 2);
  float M = kNeg;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, pr[s * (hd + 2) + hd]);
  float den = 0.f;
  for (int s = 0; s < nsplit; ++s)
    den += expf(pr[s * (hd + 2) + hd] - M) * pr[s * (hd + 2) + hd + 1];
  const float inv = 1.f / fmaxf(den, 1e-20f);
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float num = 0.f;
    for (int s = 0; s < nsplit; ++s)
      num += expf(pr[s * (hd + 2) + hd] - M) * pr[s * (hd + 2) + d];
    out[row * hd + d] = from_float<T>(num * inv);
  }
}

// Launch combine_kernel over `rows` query rows as a programmatic dependent
// of the kernel just launched on `stream` (which must execute
// griddepcontrol.launch_dependents).
template <typename T>
__host__ inline cudaError_t launch_combine(const float* part, T* out,
                                           int rows, int hd, int nsplit,
                                           cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, combine_kernel<T>, part, out,
                                       hd, nsplit);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Call go(kL, kC) (std::integral_constant values) with the lane layout of
// head dim hd: the fewest lanes a key that hold its 16-byte pieces, two
// pieces a lane past 32 pieces (float32 above hd 128).  Unsupported head
// dims return cudaErrorInvalidValue.
template <typename T, typename Go>
__host__ inline int with_lanes(int hd, const Go& go) {
  constexpr int kE = 16 / sizeof(T);
  const int pieces = (hd + kE - 1) / kE;
  using One = std::integral_constant<int, 1>;
  if (pieces <= 8) return go(std::integral_constant<int, 8>{}, One{});
  if (pieces <= 16) return go(std::integral_constant<int, 16>{}, One{});
  if (pieces <= 32) return go(std::integral_constant<int, 32>{}, One{});
  if constexpr (sizeof(T) == 4) {            // float32, hd up to 256
    if (pieces <= 64)
      return go(std::integral_constant<int, 32>{},
                std::integral_constant<int, 2>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace dec
}  // namespace repro
