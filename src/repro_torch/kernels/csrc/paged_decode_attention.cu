// Paged GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::
// paged_decode_attention (body _paged_kernel): one query token per sequence
// against a shared (NB, bs, Kv, hd) K/V block pool, read through a (B, MB)
// int32 block table, with an online softmax over the sequence's blocks.
//
// Bound on the H100: the bytes of K/V it reads (decode is a GEMV per kv
// head with G <= 8 query rows, far below the tensor cores' ridge, so a
// 64-row wgmma tile would waste most of itself).  At the serving path's
// shapes (8 sequences, 3 kv heads, at most 96 positions, hd 64, bf16) that
// is under 1 MB and the kernel is bound by its latency chain; over a long
// table (4096 positions) it is 25 MB, 7.5 us at 3.35 TB/s.  The design
// answers both:
//
// * The key range is split across blocks: the grid is (b * Kv * groups of
//   4 query rows, split).  The wrapper picks the split count from B * Kv
//   and the number of table entries walked (never from `length`, which it
//   cannot read without a sync), so a long table fills the card; at the
//   serving shape one split remains and the block writes the output
//   itself.  With more than one split, each block writes its partial
//   (max, denominator, unnormalised accumulator) and a second small kernel,
//   launched by the same C call as a programmatic dependent (its launch
//   overlaps the split kernel), merges them.  A split that sees no key
//   writes an empty partial (max -1e30, sum 0), which merges to nothing.
//   (Merging in the last-arriving split block instead, through a counter,
//   measured slower on the long table: the merge then trails the slowest
//   block.)
// * Short latency chain inside a block: the block's slice of the table is
//   loaded once into shared memory, its load in flight beside the length's
//   (no window: the slice does not depend on the length).  Each warp takes
//   tiles of positions: a tile is kSteps groups of 32 / kL keys, lanes
//   split over the head dim in 16-byte pieces (kL lanes a key).  A warp
//   keeps a ring of three tiles in shared memory, filled by 16-byte
//   cp.async copies two tiles ahead of the one it computes, so each warp
//   has up to 16 KB of K/V in flight without spending registers on it; a
//   lane reads back only the pieces it copied, so the ring needs no
//   barrier.  The G query rows live in registers; scores are reduced over
//   the kL lanes of a key by shuffles; one online-softmax update per tile;
//   P.V accumulates in registers.  Warps merge once at the end through
//   shared memory.
// * Masked keys are excluded by selection, never by multiplying by zero:
//   a position outside [max(length - window, 0), length) is not copied
//   (its ring slot is zero-filled) and its probability is chosen as 0.
//   The trap block and blocks not yet written hold whatever was last
//   stored there, NaN included.
// * The windowed variant walks logical blocks from max(length - window, 0)
//   // bs, at most ns of them, and clamps the table index to MB - 1,
//   exactly as decode_attention.py:187-194 of the JAX package does.
//
// Any head dim up to 256, float32 or bfloat16; 16-byte copies when hd
// fills whole 16-byte pieces and the pointers are aligned, element loads
// otherwise.  The 16-byte loads, the merge kernel and the lane layout come
// from decode_warp.cuh, shared with the dense decode kernel.
#include "decode_warp.cuh"

namespace {

using namespace repro::dec;

// kL lanes per key (16-byte pieces of the head dim, kC pieces a lane);
// 32 / kL keys per warp step, kSteps steps per tile.
template <typename T, int kL, int kC>
__global__ void __launch_bounds__(kThreads) paged_decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ length, T* __restrict__ out,
    float* __restrict__ part, int Kv, int G, int hd, int bs, int MB, int ns,
    int window, int eps, float scale, int vec) {
  constexpr int kE = 16 / sizeof(T);         // elements of a 16-byte piece
  constexpr int kKPW = 32 / kL;              // keys a warp scores at once
  constexpr int kSteps = 8 / kC;             // key groups of a tile
  constexpr int kTile = kSteps * kKPW;       // keys of a warp tile
  constexpr int kDP = kL * kC * kE;          // padded head dim
  const int ngg = (G + kG - 1) / kG;
  const int bkv = blockIdx.x / ngg, g0 = (blockIdx.x - bkv * ngg) * kG;
  const int b = bkv / Kv, kv = bkv - b * Kv;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / kL, li = lane - grp * kL;
  const int ng = min(kG, G - g0);

  // each warp's ring of kStages tiles, [stage][K, V][step][piece][lane] as
  // 16-byte pieces: a lane reads back only what it copied itself
  constexpr int kRing = kStages * 2 * kSteps * kC * 32;   // uint4 a warp
  extern __shared__ uint4 smem[];
  uint4* ring = smem + warp * kRing;
  float* wm = reinterpret_cast<float*>(smem + kWarps * kRing);   // [kWarps][kG]
  float* wl = wm + kWarps * kG;              // [kWarps][kG] denominator
  int* tab = reinterpret_cast<int*>(wl + kWarps * kG);   // [eps] slice

  // the length and the table slice: without a window the slice does not
  // depend on the length, so both loads are in flight together
  const int len = length[b];
  const int e0 = split * eps, e1 = min(e0 + eps, ns);
  const int sb = window > 0 ? max(len - window, 0) / bs : 0;
  if (window == 0) {
    for (int e = e0 + tid; e < e1; e += kThreads)
      tab[e - e0] = table[b * MB + e];
  } else {
    for (int e = e0 + tid; e < e1; e += kThreads)
      tab[e - e0] = table[b * MB + min(sb + e, MB - 1)];
  }
  const size_t qrow = static_cast<size_t>(bkv) * G + g0;
  float qf[kG][kC][kE];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const uint4 u = g < ng ? load_chunk(q + (qrow + g) * hd, li + c * kL,
                                          hd, vec)
                             : make_uint4(0u, 0u, 0u, 0u);
      unpack(u, qf[g][c]);
    }
  // the merge kernel may launch now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // visible positions of this split: [pa, pb)
  const int lo = window > 0 ? len - window : 0;
  const int pa = max((sb + e0) * bs, lo), pb = min((sb + e1) * bs, len);
  const size_t prow = static_cast<size_t>(Kv) * hd;    // pool position
  __syncthreads();

  // copy the tile at t0 into ring stage st (positions past pb zero-filled,
  // nothing copied for a tile wholly past pb), one commit group a tile
  auto copy_tile = [&](int st, int t0) {
    if (t0 < pb) {
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int p = t0 + j * kKPW + grp;
        size_t off = 0;
        if (p < pb) {
          const int il = p / bs;
          off = (static_cast<size_t>(tab[il - sb - e0]) * bs + (p - il * bs)) *
                    prow + static_cast<size_t>(kv) * hd;
        }
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int ci = li + c * kL;
          uint4* dk = ring + (((st * 2) * kSteps + j) * kC + c) * 32 + lane;
          uint4* dv = dk + kSteps * kC * 32;
          if (vec) {
            const bool in = p < pb && ci * kE < hd;
            repro::attn::cp_async16(dk, in ? k_pool + off + ci * kE : k_pool,
                                    in ? 16 : 0);
            repro::attn::cp_async16(dv, in ? v_pool + off + ci * kE : v_pool,
                                    in ? 16 : 0);
          } else {
            const uint4 z = make_uint4(0u, 0u, 0u, 0u);
            *dk = p < pb ? load_chunk(k_pool + off, ci, hd, false) : z;
            *dv = p < pb ? load_chunk(v_pool + off, ci, hd, false) : z;
          }
        }
      }
    }
    repro::attn::cp_async_commit();
  };

  float m[kG], l[kG], acc[kG][kC][kE];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = repro::kNeg;
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
    repro::attn::cp_async_wait<kStages - 1>();   // tile t0 has landed
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
        s[j][g] = t0 + j * kKPW + grp < pb ? s[j][g] * scale : repro::kNeg;
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
  repro::attn::cp_async_wait<0>();           // the ring is free again

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
    float M = repro::kNeg;
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
      out[(qrow + g) * hd + d] = repro::from_float<T>(num / fmaxf(den, 1e-20f));
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
int launch(const T* q, const T* k_pool, const T* v_pool, const int* table,
           const int* length, T* out, float* part, int B, int Kv, int G,
           int hd, int bs, int MB, int ns, int window, int nsplit, int eps,
           float scale, bool vec, cudaStream_t stream) {
  static_assert(ring_slots<kC>() >= kG * kL * kC * 4, "wacc fits a ring");
  const size_t smem = smem_bytes<kC>() + sizeof(int) * eps;
  cudaError_t err = repro::attn::allow_smem<
      paged_decode_attention_kernel<T, kL, kC>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ngg = (G + kG - 1) / kG;
  paged_decode_attention_kernel<T, kL, kC>
      <<<dim3(B * Kv * ngg, nsplit), kThreads, smem, stream>>>(
          q, k_pool, v_pool, table, length, out, part, Kv, G, hd, bs, MB,
          ns, window, eps, scale, vec ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  return static_cast<int>(launch_combine<T>(part, out, B * Kv * G, hd,
                                            nsplit, stream));
}

template <typename T>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const int* table, const int* length, void* out, float* part,
             int B, int Kv, int G, int hd, int bs, int MB, int ns, int window,
             int nsplit, int eps, float scale, cudaStream_t stream) {
  constexpr int kE = 16 / sizeof(T);
  const bool vec = hd % kE == 0 &&
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_pool) |
       reinterpret_cast<uintptr_t>(v_pool)) % 16 == 0;
  return with_lanes<T>(hd, [&](auto kl, auto kc) {
    return launch<T, decltype(kl)::value, decltype(kc)::value>(
        static_cast<const T*>(q), static_cast<const T*>(k_pool),
        static_cast<const T*>(v_pool), table, length, static_cast<T*>(out),
        part, B, Kv, G, hd, bs, MB, ns, window, nsplit, eps, scale, vec,
        stream);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Shapes as the Python wrapper checked
// them: q/out (B, Kv, G, hd), pools (NB, bs, Kv, hd), table (B, MB),
// length (B,), all contiguous.  ns: table entries walked; nsplit splits of
// eps entries each; part: float32 scratch of B * Kv * G * nsplit * (hd + 2)
// entries (unused, may be null, when nsplit is 1).  Returns a cudaError_t
// as int.
REPRO_EXPORT int repro_paged_decode_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const int* table, const int* length, void* out, float* part, int B,
    int Kv, int G, int hd, int bs, int MB, int ns, int window, int nsplit,
    int eps, float scale, void* stream) {
  if (hd < 1 || hd > 256 || nsplit < 1 || eps < 1 || eps > 4096 ||
      (nsplit > 1 && part == nullptr) || (nsplit - 1) * eps >= ns)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k_pool, v_pool, table, length, out, part, B, Kv,
                           G, hd, bs, MB, ns, window, nsplit, eps, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k_pool, v_pool, table, length, out,
                                   part, B, Kv, G, hd, bs, MB, ns, window,
                                   nsplit, eps, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
