// Tensor-core pieces shared by the SSD scan's forward (ssd_scan.cu) and its
// backward (ssd_scan_bwd.cu): ldmatrix fragment loads, the bf16 mma.sync
// m16n8k16 with f32 accumulators, the split of an f32 pair into a bf16 head
// and the bf16 of its remainder, and the staging of rows of a chunk into
// shared memory.
//
// Fragment layout (PTX mma.m16n8k16): thread (g = lane / 4, t = lane % 4)
// holds rows g and g + 8 of a 16-row A or C tile, columns 2t, 2t + 1 (and
// 2t + 8, 2t + 9 of an A tile's second k half); of a B tile the k rows 2t,
// 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of column g.  The lower 16 bits of a
// packed pair hold the element of the lower column.
#pragma once

#include <cstdint>

#include "attn_tile.cuh"
#include "ssd_gates.cuh"

namespace repro {
namespace ssd {

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(repro::attn::smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(repro::attn::smem_u32(p))
      : "memory");
}
// two 8 x 8 matrices, addressed by lanes 0-15
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(repro::attn::smem_u32(p))
      : "memory");
}
// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// (x, y) as a bf16 pair (the head), and the bf16 pair of the remainder
__device__ __forceinline__ uint32_t split2(float x, float y, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  lo = *reinterpret_cast<const uint32_t*>(&l);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Rows [j0, j0 + nrows) of a (Q, width) operand of the chunk starting at
// position t0 into dst (row stride ld, wpad columns): row j is position
// t0 + j; rows past the chunk or in the front pad and columns past width
// are zero.  vec (aligned base and row stride, width a multiple of 16
// bytes): asynchronous 16-byte copies, zero-filled where out of range —
// the caller commits, waits and synchronises; otherwise element copies.
// kT: the block's threads.
template <int kT = kThreads, typename T>
__device__ __forceinline__ void stage(T* dst, int ld, int wpad, int nrows,
                                      const T* __restrict__ src,
                                      long long rs, int j0, int t0, int Q,
                                      int width, bool vec) {
  constexpr int kE = 16 / sizeof(T);
  const int nc = wpad / kE;
  for (int i = threadIdx.x; i < nrows * nc; i += kT) {
    const int r = i / nc, c = (i - r * nc) * kE;
    const int j = j0 + r, t = t0 + j;
    const bool row_ok = j < Q && t >= 0;
    T* d = dst + r * ld + c;
    if (vec) {
      const bool in = row_ok && c < width;
      repro::attn::cp_async16(d, in ? src + t * rs + c : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e)
        d[e] = row_ok && c + e < width ? src[t * rs + c + e]
                                       : repro::from_float<T>(0.f);
    }
  }
}

}  // namespace ssd
}  // namespace repro
