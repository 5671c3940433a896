// Dense GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (body _kernel): one query token per sequence against the
// sequence's own dense cache, q (B, Kv, G, hd) against k, v (B, Kv, S, hd),
// keys at positions < length[b] visible and, with a window, only the trailing
// `window` of them.  It serves the dense layout's decode ticks (the tree
// lane's edge ticks) and zamba2's shared attention.
//
// Bound on the H100: the bytes of the visible K/V rows it reads (a GEMV per
// kv head with G <= 8 query rows, far below the tensor cores' ridge).  At
// the serving shapes (8 slots; smollm-135m heads Kv 3, G 3, hd 64, or
// zamba2's Kv 32, G 1, hd 80; at most 80 positions; bf16) that is under
// 1 MB, well under a microsecond at 3.35 TB/s, so the kernel is bound by
// its latency chain: length, then K/V, then the softmax and the write.  Over
// a 4096-position cache it is tens of MB and the kernel must stream.
//
// Design: the paged kernel's warp tile, copied here (decode_warp.cuh says
// why it is not shared), with the block table replaced by the cache's
// strides (sb, sh, ss): position p of
// sequence b, kv head h lies at b * sb + h * sh + p * ss, so the serving
// cache's (B, S, Kv, hd) layout goes in permuted, with no copy.
// * The grid is (b * Kv * groups of 4 query rows, split).  The wrapper
//   picks the split count from shapes only (the positions walked, B * Kv
//   and the SM count; never `length`, which it cannot read without a
//   sync): one split at the serving shapes, so the block writes the
//   output itself; over a long cache enough splits to cover two blocks per
//   SM, merged by the programmatic-dependent combine kernel.
// * Split s walks the visible positions [lo + s * eps, lo + (s + 1) * eps)
//   clipped to [lo, hi), lo = max(length - window, 0) (0 without a
//   window), hi = min(length, S): any S, and a length above S clamps.
// * Each warp keeps a three-stage cp.async ring of 16-byte K/V pieces, the
//   query rows live in registers, one online-softmax update per tile,
//   masked positions are never copied and get probability 0 by selection;
//   warps merge once through shared memory.
//
// Any head dim up to 256, float32 or bfloat16; 16-byte copies when hd and
// the strides fill whole 16-byte pieces and the pointers are aligned,
// element loads otherwise.
#include "decode_warp.cuh"

namespace {

using namespace repro::dec;
namespace attn = repro::attn;
using repro::from_float;
using repro::kNeg;

// The block's query rows qrow .. qrow + ng - 1 (of hd elements each) into
// registers: this lane's pieces li, li + kL, ...; rows past ng are zero.
template <typename T, int kL, int kC>
__device__ __forceinline__ void load_q(float (&qf)[kG][kC][16 / sizeof(T)],
                                       const T* __restrict__ q, size_t qrow,
                                       int ng, int hd, bool vec) {
  const int li = (threadIdx.x & 31) % kL;
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const uint4 u = g < ng ? load_chunk(q + (qrow + g) * hd, li + c * kL,
                                          hd, vec)
                             : make_uint4(0u, 0u, 0u, 0u);
      unpack(u, qf[g][c]);
    }
}

// Attend the query rows in qf to the positions [pa, pb), whose K and V rows
// start at k + head + p * ss and v + head + p * ss, and write the result of
// query rows qrow .. qrow + ng - 1: the output (nsplit == 1) or this
// split's partial.  Every thread of the block calls it.
template <typename T, int kL, int kC>
__device__ __forceinline__ void attend(
    const float (&qf)[kG][kC][16 / sizeof(T)], const T* __restrict__ k,
    const T* __restrict__ v, int pa, int pb, size_t head, size_t ss,
    uint4* smem, T* __restrict__ out, float* __restrict__ part, size_t qrow,
    int ng, int hd, int split, int nsplit, float scale, bool vec) {
  constexpr int kE = 16 / sizeof(T);         // elements of a 16-byte piece
  constexpr int kKPW = 32 / kL;              // keys a warp scores at once
  constexpr int kSteps = 8 / kC;             // key groups of a tile
  constexpr int kTile = kSteps * kKPW;       // keys of a warp tile
  constexpr int kDP = kL * kC * kE;          // padded head dim
  constexpr int kRing = ring_slots<kC>();
  static_assert(kRing >= kG * kL * kC * 4, "wacc fits a ring");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / kL, li = lane - grp * kL;
  uint4* ring = smem + warp * kRing;
  float* wm = reinterpret_cast<float*>(smem + kWarps * kRing);   // [kWarps][kG]
  float* wl = wm + kWarps * kG;              // [kWarps][kG] denominator

  // copy the tile at t0 into ring stage st (positions past pb zero-filled,
  // nothing copied for a tile wholly past pb), one commit group a tile
  auto copy_tile = [&](int st, int t0) {
    if (t0 < pb) {
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int p = t0 + j * kKPW + grp;
        const size_t off = p < pb ? head + static_cast<size_t>(p) * ss : 0;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int ci = li + c * kL;
          uint4* dk = ring + (((st * 2) * kSteps + j) * kC + c) * 32 + lane;
          uint4* dv = dk + kSteps * kC * 32;
          if (vec) {
            const bool in = p < pb && ci * kE < hd;
            attn::cp_async16(dk, in ? k + off + ci * kE : k, in ? 16 : 0);
            attn::cp_async16(dv, in ? v + off + ci * kE : v, in ? 16 : 0);
          } else {
            const uint4 z = make_uint4(0u, 0u, 0u, 0u);
            *dk = p < pb ? load_chunk(k + off, ci, hd, false) : z;
            *dv = p < pb ? load_chunk(v + off, ci, hd, false) : z;
          }
        }
      }
    }
    attn::cp_async_commit();
  };

  float m[kG], l[kG], acc[kG][kC][kE];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[g][c][e] = 0.f;
  }

  constexpr int kStride = kWarps * kTile;
  int tnext = pa + warp * kTile;             // next tile to copy
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s, tnext += kStride) copy_tile(s, tnext);
  int st = 0;
  for (int t0 = pa + warp * kTile; t0 < pb; t0 += kStride) {
    copy_tile((st + kStages - 1) % kStages, tnext);
    tnext += kStride;
    attn::cp_async_wait<kStages - 1>();      // tile t0 has landed
    const uint4* rk = ring + (st * 2) * kSteps * kC * 32 + lane;
    const uint4* rv = rk + kSteps * kC * 32;
    st = (st + 1) % kStages;
    // scores: partial dots over this lane's pieces, summed over the kL
    // lanes of the key; a position past pb is selected out (-1e30)
    float s[kSteps][kG];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
#pragma unroll
      for (int g = 0; g < kG; ++g) s[j][g] = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        float kf[kE];
        unpack(rk[(j * kC + c) * 32], kf);
#pragma unroll
        for (int g = 0; g < kG; ++g)
#pragma unroll
          for (int e = 0; e < kE; ++e) s[j][g] += qf[g][c][e] * kf[e];
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
#pragma unroll
        for (int o = kL / 2; o > 0; o >>= 1)
          s[j][g] += __shfl_xor_sync(0xffffffffu, s[j][g], o);
        s[j][g] = t0 + j * kKPW + grp < pb ? s[j][g] * scale : kNeg;
      }
    }
    // one online-softmax update per tile, the max taken over the warp
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int j = 1; j < kSteps; ++j) mx = fmaxf(mx, s[j][g]);
#pragma unroll
      for (int o = kL; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[g][c][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const bool valid = t0 + j * kKPW + grp < pb;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        float vf[kE];
        unpack(rv[(j * kC + c) * 32], vf);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const float p = valid ? expf(s[j][g] - m[g]) : 0.f;
          if (c == 0) l[g] += p;
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[g][c][e] += p * vf[e];
        }
      }
    }
  }
  attn::cp_async_wait<0>();                  // the ring is free again

  // the warp's key groups share its max: sum their denominators and
  // accumulators, then merge the warps through shared memory
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int o = kL; o < 32; o <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int e = 0; e < kE; ++e)
          acc[g][c][e] += __shfl_xor_sync(0xffffffffu, acc[g][c][e], o);
    }
  float* wacc = reinterpret_cast<float*>(ring);   // [kG][kDP], own ring
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int e = 0; e < kE; ++e)
          wacc[g * kDP + (li + c * kL) * kE + e] = acc[g][c][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      wm[warp * kG + g] = m[g];
      wl[warp * kG + g] = l[g];
    }
  }
  __syncthreads();
  for (int i = tid; i < ng * hd; i += kThreads) {
    const int g = i / hd, d = i - g * hd;
    float M = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * kG + g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wm[w * kG + g] - M);
      num += f * reinterpret_cast<const float*>(smem + w * kRing)
                     [g * kDP + d];
      den += f * wl[w * kG + g];
    }
    if (nsplit == 1) {
      out[(qrow + g) * hd + d] = from_float<T>(num / fmaxf(den, 1e-20f));
    } else {
      float* pr = part + ((qrow + g) * nsplit + split) * (hd + 2);
      pr[d] = num;
      if (d == 0) {
        pr[hd] = M;
        pr[hd + 1] = den;
      }
    }
  }
}

template <typename T, int kL, int kC>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ length, T* __restrict__ out,
    float* __restrict__ part, int Kv, int G, int hd, int S, long long sb,
    long long sh, long long ss, int window, int eps, float scale, int vec) {
  const int ngg = (G + kG - 1) / kG;
  const int bkv = blockIdx.x / ngg, g0 = (blockIdx.x - bkv * ngg) * kG;
  const int b = bkv / Kv, kv = bkv - b * Kv;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int ng = min(kG, G - g0);
  extern __shared__ uint4 smem[];

  const int len = length[b];
  const size_t qrow = static_cast<size_t>(bkv) * G + g0;
  float qf[kG][kC][16 / sizeof(T)];
  load_q<T, kL, kC>(qf, q, qrow, ng, hd, vec);
  // the merge kernel may launch now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // visible positions of this split: [pa, pb)
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int hi = min(len, S);
  const long long first = lo + static_cast<long long>(split) * eps;
  const int pa = static_cast<int>(min(first, 0LL + hi));
  const int pb = static_cast<int>(min(first + eps, 0LL + hi));
  const size_t head =
      static_cast<size_t>(b) * sb + static_cast<size_t>(kv) * sh;
  attend<T, kL, kC>(qf, k, v, pa, pb, head, static_cast<size_t>(ss), smem,
                    out, part, qrow, ng, hd, split, nsplit, scale, vec);
}

template <typename T, int kL, int kC>
int launch(const T* q, const T* k, const T* v, const int* length, T* out,
           float* part, int B, int Kv, int G, int hd, int S, long long sb,
           long long sh, long long ss, int window, int nsplit, int eps,
           float scale, bool vec, cudaStream_t stream) {
  cudaError_t err = repro::attn::allow_smem<
      decode_attention_kernel<T, kL, kC>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ngg = (G + kG - 1) / kG;
  decode_attention_kernel<T, kL, kC>
      <<<dim3(B * Kv * ngg, nsplit), kThreads, smem_bytes<kC>(), stream>>>(
          q, k, v, length, out, part, Kv, G, hd, S, sb, sh, ss, window, eps,
          scale, vec ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  return static_cast<int>(launch_combine<T>(part, out, B * Kv * G, hd,
                                            nsplit, stream));
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* length,
             void* out, float* part, int B, int Kv, int G, int hd, int S,
             long long sb, long long sh, long long ss, int window,
             int nsplit, int eps, float scale, cudaStream_t stream) {
  constexpr int kE = 16 / sizeof(T);
  const bool vec = hd % kE == 0 && (sb | sh | ss) % kE == 0 &&
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  return with_lanes<T>(hd, [&](auto kl, auto kc) {
    return launch<T, decltype(kl)::value, decltype(kc)::value>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), length, static_cast<T*>(out), part, B, Kv,
        G, hd, S, sb, sh, ss, window, nsplit, eps, scale, vec, stream);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out (B, Kv, G, hd) contiguous; k and
// v (B, Kv, S, hd) with element strides sb, sh, ss over (b, kv head,
// position) and the head dim contiguous, the same for both; length (B,).
// nsplit splits of eps positions each; part: float32 scratch of
// B * Kv * G * nsplit * (hd + 2) entries (unused, may be null, when nsplit
// is 1).  Returns a cudaError_t as int.
REPRO_EXPORT int repro_decode_attention(
    int dtype, const void* q, const void* k, const void* v, const int* length,
    void* out, float* part, int B, int Kv, int G, int hd, int S, long long sb,
    long long sh, long long ss, int window, int nsplit, int eps, float scale,
    void* stream) {
  if (hd < 1 || hd > 256 || nsplit < 1 || eps < 1 ||
      (nsplit > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, length, out, part, B, Kv, G, hd, S, sb,
                           sh, ss, window, nsplit, eps, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, length, out, part, B, Kv, G, hd,
                                   S, sb, sh, ss, window, nsplit, eps, scale,
                                   s);
  return static_cast<int>(cudaErrorInvalidValue);
}
