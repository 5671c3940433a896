// Token-tree verification attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/tree_attention.py::
// tree_verify_attention (body _kernel).  N tree-node queries per sequence,
// q (B, Kv, G, N, hd), attend the sequence's dense cache k, v (B, Kv, S, hd)
// whose rows [length - (C - N), length + N) hold the tree: with
// base = length - (C - N), a key at position p < base is committed prefix
// and visible to every node; a key in [base, base + C) is visible to node n
// when the ancestor mask (N, C) has mask[n][p - base] set; later keys are
// masked garbage.  With a window, node n sees only keys p > q_pos[n] - window
// (q_pos is the node's RoPE position, tree base + depth).  C > N is an
// incremental draft level: the mask's first C - N columns cover tree rows
// earlier levels already wrote.
//
// Design: one thread block per (sequence b, kv head, chunk of 64 query
// rows); for the serving path's trees (G = 3 or 4 query heads per kv head,
// N = 16 nodes) one chunk holds all G * N rows.  The block stages its query
// rows, the (N, C) mask and the per-node positions in shared memory, then
// walks the keys in 32-key tiles, K and V staged in shared memory (K rows
// padded by one float so a warp reading 32 keys hits 32 banks), with an f32
// online softmax.  Each of the 8 warps owns 8 query rows: lane j scores key
// j of the tile, the warp reduces the tile's max and sum with shuffles, and
// every lane keeps ceil(hd/32) output columns per row in registers (any hd
// up to 256, the tail lanes masked).  The key loop
// stops at base + C, because every later position is masked, and starts at
// the window's first key.  The mask column is read directly at p - base:
// the TPU kernel's one-hot matmul (a trick for its matrix unit) has no
// counterpart here.  The ragged tail (S not a multiple of the tile) is
// masked; nothing is padded.  Masked keys are skipped, never weighted.  K,
// V, q and the output are read and written through strides, so the caller
// passes its (B, S, Kv, hd) cache and (B, N, H, hd) projections as views.
//
// Bound on the H100: the bytes of K/V it reads, about (base + C) * Kv * hd
// * 2 per sequence (bf16).  At the serving path's shapes (8 slots, at most
// ~100 positions) that is under 2 MB, about half a microsecond at 3.35
// TB/s, so the kernel is bound by its launch.  Every query row of a kv head
// shares one staged K/V tile, and nothing of the (G * N, S) scores leaves
// the chip.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                    // query rows per warp
constexpr int kRowsPerBlock = kWarps * kRows;
constexpr int kBK = 32;                     // keys per tile (one per lane)
constexpr int kMaxHd = 256;

struct Strides4 {
  long long a, b, c, d;                     // element strides of 4 leading dims
};

template <typename T>
__global__ void __launch_bounds__(kThreads) tree_verify_attention_kernel(
    const T* __restrict__ q, Strides4 qs_, const T* __restrict__ k,
    const T* __restrict__ v, long long sb, long long sh, long long ss,
    const int* __restrict__ length, const unsigned char* __restrict__ mask,
    const int* __restrict__ q_pos, T* __restrict__ out, Strides4 os_, int G,
    int N, int C, int hd, int S, int window, float scale) {
  const int b = blockIdx.x, kv = blockIdx.y, r0 = blockIdx.z * kRowsPerBlock;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = min(G * N - r0, kRowsPerBlock);    // rows of this block
  extern __shared__ float smem[];
  float* qsm = smem;                                   // [kRowsPerBlock][hd]
  float* ks = qsm + kRowsPerBlock * hd;                // [kBK][hd + 1]
  float* vs = ks + kBK * (hd + 1);                     // [kBK][hd]
  int* qp = reinterpret_cast<int*>(vs + kBK * hd);     // [N] node positions
  unsigned char* msk = reinterpret_cast<unsigned char*>(qp + N);  // [N][C]

  for (int i = tid; i < rows * hd; i += kThreads) {
    const int r = r0 + i / hd, d = i - (i / hd) * hd;
    const int g = r / N, n = r - (r / N) * N;
    qsm[i] = repro::to_float(q[b * qs_.a + kv * qs_.b + g * qs_.c + n * qs_.d + d]);
  }
  for (int i = tid; i < N; i += kThreads) qp[i] = q_pos[b * N + i];
  for (int i = tid; i < N * C; i += kThreads) msk[i] = mask[i];
  __syncthreads();

  const int base = length[b] - (C - N);        // first tree row in the cache
  const int k_end = min(S, base + C);          // every later key is masked
  int k_begin = 0;
  if (window > 0) {
    int qmin = qp[0];
    for (int n = 1; n < N; ++n) qmin = min(qmin, qp[n]);
    k_begin = max(qmin - window + 1, 0);
  }
  const size_t head = static_cast<size_t>(b) * sb + static_cast<size_t>(kv) * sh;
  const T* kb = k + head;
  const T* vb = v + head;
  const int nd = (hd + 31) / 32;             // lane groups; the tail is masked

  float m[kRows], l[kRows], acc[kRows][kMaxHd / 32];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = repro::kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxHd / 32; ++j) acc[r][j] = 0.f;
  }

  for (int kt = (k_begin / kBK) * kBK; kt < k_end; kt += kBK) {
    __syncthreads();                           // previous tile fully consumed
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int t = i / hd, d = i - (i / hd) * hd;
      const bool in = kt + t < k_end;
      const size_t src = static_cast<size_t>(kt + t) * ss + d;
      ks[t * (hd + 1) + d] = in ? repro::to_float(kb[src]) : 0.f;
      vs[t * hd + d] = in ? repro::to_float(vb[src]) : 0.f;
    }
    __syncthreads();

    const int kpos = kt + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int rr = warp * kRows + r;
      if (rr >= rows) continue;                // warp-uniform
      const int n = (r0 + rr) % N;
      bool vis = kpos < k_end;
      if (vis && kpos >= base) vis = msk[n * C + (kpos - base)] != 0;
      if (window > 0) vis = vis && kpos > qp[n] - window;
      if (!__any_sync(0xffffffffu, vis)) continue;
      float s = 0.f;
      if (vis) {
        const float* kr = ks + lane * (hd + 1);
        const float* qr = qsm + rr * hd;
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
        if (pt == 0.f) continue;               // warp-uniform: same pt
#pragma unroll
        for (int j = 0; j < kMaxHd / 32; ++j)
          if (j < nd && lane + 32 * j < hd)
            acc[r][j] += pt * vs[t * hd + lane + 32 * j];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int rr = warp * kRows + r;
    if (rr >= rows) continue;
    const int g = (r0 + rr) / N, n = (r0 + rr) % N;
    const float inv = 1.f / fmaxf(l[r], 1e-20f);
    T* orow = out + b * os_.a + kv * os_.b + g * os_.c + n * os_.d;
#pragma unroll
    for (int j = 0; j < kMaxHd / 32; ++j)
      if (j < nd && lane + 32 * j < hd)
        orow[lane + 32 * j] = repro::from_float<T>(acc[r][j] * inv);
  }
}

template <typename T>
int launch(const void* q, Strides4 qs_, const void* k, const void* v,
           long long sb, long long sh, long long ss, const int* length,
           const unsigned char* mask, const int* q_pos, void* out,
           Strides4 os_, int B, int Kv, int G, int N, int C, int hd, int S,
           int window, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kRowsPerBlock * hd + kBK * (hd + 1) + kBK * hd) +
      sizeof(int) * N + static_cast<size_t>(N) * C;
  cudaError_t err = cudaFuncSetAttribute(
      tree_verify_attention_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, Kv, (G * N + kRowsPerBlock - 1) / kRowsPerBlock);
  tree_verify_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), qs_, static_cast<const T*>(k),
      static_cast<const T*>(v), sb, sh, ss, length, mask, q_pos,
      static_cast<T*>(out), os_, G, N, C, hd, S, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q and out (B, Kv, G, N, hd) with
// element strides q_s* / o_s* over (b, kv head, g, node) and the head dim
// contiguous; k and v (B, Kv, S, hd) with strides sb, sh, ss over (b, kv
// head, position), the same for both; length (B,) int32 valid entries
// before the N new rows; mask (N, C) one byte per entry, row-major; q_pos
// (B, N) int32 row-major.  Returns a cudaError_t as int.
REPRO_EXPORT int repro_tree_verify_attention(
    int dtype, const void* q, long long q_sb, long long q_skv, long long q_sg,
    long long q_sn, const void* k, const void* v, long long sb, long long sh,
    long long ss, const int* length, const unsigned char* mask,
    const int* q_pos, void* out, long long o_sb, long long o_skv,
    long long o_sg, long long o_sn, int B, int Kv, int G, int N, int C,
    int hd, int S, int window, float scale, void* stream) {
  if (hd < 1 || hd > kMaxHd || C < N || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides4 qs_{q_sb, q_skv, q_sg, q_sn}, os_{o_sb, o_skv, o_sg, o_sn};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, qs_, k, v, sb, sh, ss, length, mask, q_pos, out,
                         os_, B, Kv, G, N, C, hd, S, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, qs_, k, v, sb, sh, ss, length, mask,
                                 q_pos, out, os_, B, Kv, G, N, C, hd, S,
                                 window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
