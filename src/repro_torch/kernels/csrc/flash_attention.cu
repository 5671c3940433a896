// Tiled online-softmax (flash) attention for Hopper (sm_90a), the prefill
// path.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _kernel): q, k, v (B, H, S, hd) with the KV heads
// already expanded over GQA groups, a `causal` flag and a sliding `window`
// (key k is visible to query q when k <= q under causal and k > q - window
// under a window), scale 1/sqrt(hd).
//
// Design: one thread block per (q tile of 16 rows, head, batch).  The block
// stages its query tile once, then loops over 32-key tiles from the window's
// first key to the causal limit, each staged in shared memory (K rows padded
// by one float so a warp reading 32 different keys hits 32 banks).  Each
// warp owns 4 query rows: lane j scores key j of the tile, the warp reduces
// the tile's max and sum with shuffles, and every lane keeps hd/32 output
// columns of the running accumulator in registers.  The TPU kernel needs
// S % bq == 0; this one masks the ragged edge itself (keys past Sk, rows past
// Sq).  Masked keys contribute exact zeros: they are skipped.
//
// Bound on the H100: at prefill lengths of the serving path (S = 16, one
// prompt) it is launch-bound; at long prompts the QK^T and PV products bound
// it (4 * B * H * S^2 / 2 * hd operations under causality).  This first
// version runs them on the CUDA cores in float32 and reads each K/V tile
// once per 16 query rows, which is right and simple; tensor-core (wgmma)
// tiles are the work of a later change.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 16;                     // query rows per block
constexpr int kRows = kBQ / kWarps;         // query rows per warp
constexpr int kBK = 32;                     // keys per tile (one per lane)
constexpr int kMaxHd = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int H, int Sq, int Sk, int hd, int causal,
    int window, float scale) {
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ float smem[];
  float* qs = smem;                          // [kBQ][hd]
  float* ks = qs + kBQ * hd;                 // [kBK][hd + 1]
  float* vs = ks + kBK * (hd + 1);           // [kBK][hd]

  const size_t bh = static_cast<size_t>(b) * H + h;
  const T* qb = q + bh * Sq * hd;
  const T* kb = k + bh * Sk * hd;
  const T* vb = v + bh * Sk * hd;
  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd;
    qs[i] = q0 + r < Sq ? repro::to_float(qb[static_cast<size_t>(q0) * hd + i])
                        : 0.f;
  }

  // keys any row of this tile can see
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_begin = window > 0 ? max(q0 - window + 1, 0) : 0;
  const int k_end = causal ? min(q_last + 1, Sk) : Sk;
  const int nd = hd / 32;

  float m[kRows], l[kRows], acc[kRows][kMaxHd / 32];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = repro::kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxHd / 32; ++j) acc[r][j] = 0.f;
  }

  for (int kt = (k_begin / kBK) * kBK; kt < k_end; kt += kBK) {
    __syncthreads();                         // previous tile fully consumed
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int t = i / hd, d = i - (i / hd) * hd;
      const bool in = kt + t < Sk;
      const size_t src = static_cast<size_t>(kt + t) * hd + d;
      ks[t * (hd + 1) + d] = in ? repro::to_float(kb[src]) : 0.f;
      vs[t * hd + d] = in ? repro::to_float(vb[src]) : 0.f;
    }
    __syncthreads();

    const int kpos = kt + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int rr = warp * kRows + r;
      const int qpos = q0 + rr;
      if (qpos >= Sq) continue;              // warp-uniform
      bool vis = kpos < Sk;
      if (causal) vis = vis && kpos <= qpos;
      if (window > 0) vis = vis && kpos > qpos - window;
      if (!__any_sync(0xffffffffu, vis)) continue;
      float s = 0.f;
      if (vis) {
        const float* kr = ks + lane * (hd + 1);
        const float* qr = qs + rr * hd;
        for (int d = 0; d < hd; ++d) s += qr[d] * kr[d];
        s *= scale;
      }
      const float mx = repro::warp_max(vis ? s : repro::kNeg);
      const float m_new = fmaxf(m[r], mx);
      const float p = vis ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + repro::warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kMaxHd / 32; ++j) acc[r][j] *= alpha;
      for (int t = 0; t < kBK; ++t) {
        const float pt = __shfl_sync(0xffffffffu, p, t);
        if (pt == 0.f) continue;             // warp-uniform: same pt
#pragma unroll
        for (int j = 0; j < kMaxHd / 32; ++j)
          if (j < nd) acc[r][j] += pt * vs[t * hd + lane + 32 * j];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp * kRows + r;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-20f);
    T* orow = out + (bh * Sq + qpos) * hd;
#pragma unroll
    for (int j = 0; j < kMaxHd / 32; ++j)
      if (j < nd) orow[lane + 32 * j] = repro::from_float<T>(acc[r][j] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Sq, int Sk, int hd, int causal, int window, float scale,
           cudaStream_t stream) {
  const int smem = static_cast<int>(
      sizeof(float) * (kBQ * hd + kBK * (hd + 1) + kBK * hd));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Sq, Sk, hd, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out (B, H, Sq, hd), k/v (B, H, Sk,
// hd), all contiguous.  Returns a cudaError_t as int.
REPRO_EXPORT int repro_flash_attention(int dtype, const void* q,
                                       const void* k, const void* v, void* out,
                                       int B, int H, int Sq, int Sk, int hd,
                                       int causal, int window, float scale,
                                       void* stream) {
  if (hd % 32 != 0 || hd > kMaxHd) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, H, Sq, Sk, hd, causal, window,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, H, Sq, Sk, hd, causal,
                                 window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
