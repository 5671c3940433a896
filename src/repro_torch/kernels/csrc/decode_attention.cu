// Dense GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (body _kernel): one query token per sequence against the
// sequence's own dense cache, q (B, Kv, G, hd) against k, v (B, Kv, S, hd),
// keys at positions < length[b] visible and, with a window, only the trailing
// `window` of them.  It serves the dense layout's decode ticks
// (--kv-layout dense) and the dense side lanes of tree and self speculation.
//
// Design: the paged decode kernel's loop without the block table.  One
// thread block per (sequence b, kv head) holds the G query rows in shared
// memory and walks only the visible positions [max(length - window, 0),
// min(length, S)) in 32-key tiles, each one step of repro::decode_tile
// (common.cuh): an f32 online softmax, masked keys never touched.  K and V
// are read in the cache's own layout through strides (the serving cache is
// (B, S, Kv, hd): no transpose or copy before the call), and any S is taken:
// the TPU kernel's S % block == 0 is a tiling limit of that machine.
//
// Bound on the H100: the bytes of the visible K/V rows it reads.  At the
// serving path's shapes (8 slots, 3 kv heads, at most ~80 positions, hd 64,
// bf16) that is under 1 MB, well under a microsecond at 3.35 TB/s, so the
// kernel is bound by its launch; it reads each visible K/V row once and
// keeps every intermediate on chip.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxHd = 256;                 // head dim, any up to 256
constexpr int kMaxPairs = 32;               // G * hd <= kThreads * kMaxPairs
constexpr int kTile = 32;                   // keys per decode_tile step

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ length, T* __restrict__ out, int Kv, int G,
    int hd, int S, long long sb, long long sh, long long ss, int window,
    float scale) {
  const int b = blockIdx.x, kv = blockIdx.y;
  const int tid = threadIdx.x;
  extern __shared__ float smem[];
  float* qs = smem;              // [G][hd] query rows
  float* ps = qs + G * hd;       // [G][kTile] scores, then probabilities
  float* ms = ps + G * kTile;    // [G] running max
  float* ls = ms + G;            // [G] running denominator
  float* as = ls + G;            // [G] rescale of this tile

  const size_t qoff = (static_cast<size_t>(b) * Kv + kv) * G * hd;
  for (int i = tid; i < G * hd; i += kThreads)
    qs[i] = repro::to_float(q[qoff + i]);
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = repro::kNeg;
    ls[g] = 0.f;
  }
  float acc[kMaxPairs];
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) acc[j] = 0.f;

  const int len = length[b];
  const int hi = min(len, S);                          // past the last key
  const int lo = window > 0 ? max(len - window, 0) : 0; // first visible key
  const size_t head = static_cast<size_t>(b) * sb + static_cast<size_t>(kv) * sh;
  const size_t row = static_cast<size_t>(ss);
  __syncthreads();

  for (int first = lo; first < hi; first += kTile) {
    const size_t off = head + static_cast<size_t>(first) * row;
    repro::decode_tile<kThreads, kMaxHd, kMaxPairs>(
        qs, k + off, v + off, row, 0, min(kTile, hi - first), G, hd, kTile,
        scale, ps, ms, ls, as, acc);
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
int launch(const void* q, const void* k, const void* v, const int* length,
           void* out, int B, int Kv, int G, int hd, int S, long long sb,
           long long sh, long long ss, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (G * hd + G * kTile + 3 * G);
  decode_attention_kernel<T><<<dim3(B, Kv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), length, static_cast<T*>(out), Kv, G, hd, S,
      sb, sh, ss, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out (B, Kv, G, hd) contiguous; k and
// v (B, Kv, S, hd) with element strides sb, sh, ss over (b, kv head,
// position) and the head dim contiguous, the same for both; length (B,).
// Returns a cudaError_t as int.
REPRO_EXPORT int repro_decode_attention(
    int dtype, const void* q, const void* k, const void* v, const int* length,
    void* out, int B, int Kv, int G, int hd, int S, long long sb,
    long long sh, long long ss, int window, float scale, void* stream) {
  if (hd < 1 || hd > kMaxHd || G * hd > kThreads * kMaxPairs)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, length, out, B, Kv, G, hd, S, sb, sh, ss,
                         window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, length, out, B, Kv, G, hd, S, sb,
                                 sh, ss, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
