// Paged GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::
// paged_decode_attention (body _paged_kernel): one query token per sequence
// against a shared (NB, bs, Kv, hd) K/V block pool, read through a (B, MB)
// int32 block table, with an online softmax over the sequence's blocks.
//
// Design: one thread block per (sequence b, kv head).  It holds the G query
// rows of that kv head in shared memory, reads table[b, i] itself (the TPU
// kernel's scalar prefetch) and walks the blocks in order, stopping at the
// first block past `length`.  Each block is one step of repro::decode_tile
// (common.cuh, shared with the dense decode kernel): four warps score the
// block's keys (one key per warp at a time, lanes split the head dim), one
// warp per query row updates the running max / denominator, and every
// thread owns a few (g, d) accumulator entries for the P.V product.  Masked keys are skipped, never
// weighted by zero: the trap block and blocks not yet written hold whatever
// was last stored there.  The windowed variant starts at logical block
// max(length - window, 0) // bs, walks at most ns blocks and clamps the
// table index to MB - 1, exactly as decode_attention.py:187-194 does.
//
// Bound on the H100: the bytes of K/V it reads.  At the serving path's
// shapes (8 sequences, 3 kv heads, at most 96 positions, hd 64, bf16) that is
// under 1 MB, a fraction of a microsecond at 3.35 TB/s, so the kernel is
// bound by its launch; it reads each K/V row once and keeps every
// intermediate on chip, which is what a longer cache would need.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxHd = 256;                 // head dim, any up to 256
constexpr int kMaxPairs = 32;               // G * hd <= kThreads * kMaxPairs

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ length, T* __restrict__ out, int Kv, int G, int hd,
    int bs, int MB, int ns, int window, float scale) {
  const int b = blockIdx.x, kv = blockIdx.y;
  const int tid = threadIdx.x;
  extern __shared__ float smem[];
  float* qs = smem;              // [G][hd] query rows
  float* ps = qs + G * hd;       // [G][bs] scores, then probabilities
  float* ms = ps + G * bs;       // [G] running max
  float* ls = ms + G;            // [G] running denominator
  float* as = ls + G;            // [G] rescale of this block

  const size_t qoff = (static_cast<size_t>(b) * Kv + kv) * G * hd;
  for (int i = tid; i < G * hd; i += kThreads) qs[i] = repro::to_float(q[qoff + i]);
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = repro::kNeg;
    ls[g] = 0.f;
  }
  float acc[kMaxPairs];
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) acc[j] = 0.f;

  const int len = length[b];
  const int sb = window > 0 ? max(len - window, 0) / bs : 0;
  const int lo = window > 0 ? len - window : 0;   // first visible pos
  const size_t row = static_cast<size_t>(Kv) * hd;      // pool position stride
  __syncthreads();

  for (int isb = 0; isb < ns; ++isb) {
    const int ilog = sb + isb;
    const int first = ilog * bs;
    if (first >= len) break;                 // every later key is masked
    // visible keys of this block: t in [t0, t1)
    const int t0 = max(lo - first, 0);
    const int t1 = min(len - first, bs);
    if (t0 >= t1) continue;
    const int iphys = window > 0 ? min(ilog, MB - 1) : ilog;
    const size_t base =
        static_cast<size_t>(table[b * MB + iphys]) * bs * row + kv * hd;
    repro::decode_tile<kThreads, kMaxHd, kMaxPairs>(
        qs, k_pool + base, v_pool + base, row, t0, t1, G, hd, bs, scale, ps,
        ms, ls, as, acc);
  }

#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) {
    const int idx = tid + j * kThreads;
    if (idx < G * hd) {
      const int g = idx / hd;
      out[qoff + idx] = repro::from_float<T>(acc[j] / fmaxf(ls[g], 1e-20f));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* table, const int* length, void* out, int B, int Kv,
           int G, int hd, int bs, int MB, int ns, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (G * hd + G * bs + 3 * G);
  paged_decode_attention_kernel<T><<<dim3(B, Kv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), table, length, static_cast<T*>(out), Kv,
      G, hd, bs, MB, ns, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Shapes as the Python wrapper checked
// them: q/out (B, Kv, G, hd), pools (NB, bs, Kv, hd), table (B, MB),
// length (B,).  Returns a cudaError_t as int.
REPRO_EXPORT int repro_paged_decode_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const int* table, const int* length, void* out, int B, int Kv, int G,
    int hd, int bs, int MB, int ns, int window, float scale, void* stream) {
  if (hd < 1 || hd > kMaxHd || G * hd > kThreads * kMaxPairs)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, table, length, out, B, Kv, G, hd,
                         bs, MB, ns, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, table, length, out, B, Kv,
                                 G, hd, bs, MB, ns, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
