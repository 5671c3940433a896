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
// earlier levels already wrote.  q, K, V and the output are read and
// written through strides (head dim contiguous), so the serving cache
// (B, S, Kv, hd) and projections (B, N, H, hd) go in as views.
//
// Bound on the H100: the bytes of K/V it reads, about (base + C) * Kv * hd
// * 2 per sequence (bf16), and at long caches the products, 4 * G * N * hd
// operations per visible key.  At the serving path's shapes (8 slots, at
// most ~100 positions, granite-8b's Kv 8 x G 4) that is under 2 MB and
// 0.2 GFLOP, about a microsecond, so the launch and the latency of one key
// tile bound it; with a 1000-token prefix, 8 slots read 33 MB (10 us at
// 3.35 TB/s).
//
// Design (bf16): the tensor-core tile of attn_tile.cuh.  One block of 128
// threads per (sequence, kv head, 64 query rows, key split); the rows are
// the kv head's G query heads times its N nodes (row r is node r % N of
// head r / N: 64 rows for granite-8b's 4 x 16, 48 for smollm-135m's 3 x 16,
// the 16 pad rows neither loaded nor written).  The (N, C) mask and the
// node positions sit in shared memory; each accumulator entry is masked
// from its (node, key), except on tiles inside the committed prefix (and
// the window), which every node sees whole.  S = Q K^T and O += P V are
// wgmma instructions (m64n64k16
// with Q and K in shared memory; m64n64k16 / m64n16k16 with P in registers
// and V in shared memory).  The key loop starts at the window's first key
// and stops at base + C (every later key is masked).  When B * Kv blocks
// leave most SMs idle and the cache is long, the wrapper's plan splits the
// key range into `splits` tile-aligned parts, one block each, which write
// their unnormalised (output, max, sum) to a scratch buffer; a second small
// kernel in the same call combines them.  At the serving shapes (S <= 80,
// 1-2 key tiles) nothing is split.
//
// float32 stays exact on the CUDA cores (no TF32): 256 threads per
// (sequence, kv head, 64 rows, split), 32-key f32 tiles in shared memory
// (K rows padded by one float), each warp 8 rows, one key per lane, the
// output columns in registers.  Masked keys are skipped, never weighted.
#include "attn_tile.cuh"

namespace {

using repro::attn::bf16;

template <typename T>
struct Args {
  const T* q;
  long long qb, qkv, qg, qn;      // q strides over (b, kv head, g, node)
  const T* k;
  const T* v;
  long long kb, kh, ks;           // k and v strides over (b, kv head, key)
  const int* length;
  const unsigned char* mask;
  const int* q_pos;
  T* out;
  long long ob, okv, og, on;      // output strides, as q's
  float* part;                    // splits > 1: [splits][B][Kv][G*N][hd+2]
  int B, Kv, G, N, C, hd, S, window, splits, vec;
  float scale;
};

// Shared part of both kernels: the block's tree geometry.
struct Geometry {
  int base, k_end, k_begin, q_max;
};

__device__ __forceinline__ Geometry geometry(int length, int C, int N, int S,
                                             int window, const int* qp) {
  Geometry g;
  g.base = length - (C - N);                   // first tree row in the cache
  g.k_end = min(S, g.base + C);                // every later key is masked
  g.k_begin = 0;
  g.q_max = qp[0];
  if (window > 0) {
    int qmin = qp[0];
    for (int n = 1; n < N; ++n) {
      qmin = min(qmin, qp[n]);
      g.q_max = max(g.q_max, qp[n]);
    }
    g.k_begin = max(qmin - window + 1, 0);
  }
  return g;
}

// The tiles [t0, t1) of n_all that split sp of `splits` walks.
__device__ __forceinline__ int2 split_tiles(int n_all, int sp, int splits) {
  return make_int2(n_all * sp / splits, n_all * (sp + 1) / splits);
}

// ------------------------------------------------------- bf16, tensor cores
template <int kD>
__global__ void __launch_bounds__(128) tree_tc_kernel(const Args<bf16> a) {
  using namespace repro::attn;
  using T = Tile<kD, 1>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* stages = qs + T::kQElems;
  int* qp = reinterpret_cast<int*>(stages + 4 * T::kKVElems);
  const int N = a.N, C = a.C, GN = a.G * a.N;
  unsigned char* msk = reinterpret_cast<unsigned char*>(qp + N);
  const int b = blockIdx.x, kv = blockIdx.y;
  const int r0 = (blockIdx.z / a.splits) * T::kRows;
  const int sp = blockIdx.z % a.splits;

  const bf16* qb = a.q + b * a.qb + kv * a.qkv;
  stage_rows<kD, T::kRows, T::kThreads>(qs, [&](int r) -> const bf16* {
    const int gr = r0 + r;
    return gr < GN ? qb + (gr / N) * a.qg + (gr % N) * a.qn : nullptr;
  }, a.hd, false, a.vec, a.q);
  for (int i = threadIdx.x; i < N; i += T::kThreads)
    qp[i] = a.q_pos[b * N + i];
  for (int i = threadIdx.x; i < N * C; i += T::kThreads) msk[i] = a.mask[i];
  __syncthreads();

  const Geometry geo = geometry(a.length[b], C, N, a.S, a.window, qp);
  const int k_first = (geo.k_begin / kKeys) * kKeys;
  const int n_all =
      geo.k_end > k_first ? (geo.k_end - k_first + kKeys - 1) / kKeys : 0;
  const int2 tiles = split_tiles(n_all, sp, a.splits);

  const unsigned char* mrow[2];                // this thread's two rows
  int lo[2];                                   // window: keys > lo visible
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = (r0 + frag_row(h)) % N;
    mrow[h] = msk + n * C;
    lo[h] = a.window > 0 ? qp[n] - a.window : -1;
  }
  const int base = geo.base, k_end = geo.k_end;
  auto visible = [&](int h, int key) {
    return key < k_end && key > lo[h] && (key < base || mrow[h][key - base]);
  };
  const int hi_lo = a.window > 0 ? geo.q_max - a.window : -1;
  auto full = [&](int k0) {              // inside the prefix and the window
    return k0 + kKeys <= base && k0 > hi_lo;
  };
  Acc<kD> acc;
  acc.init();
  const long long kvo = b * a.kb + kv * a.kh;
  attend<kD, 1>(acc, qs, stages, a.k + kvo, a.v + kvo, a.ks,
                k_first + tiles.x * kKeys, tiles.y - tiles.x, k_end, a.hd,
                a.vec, a.scale * kLog2e, visible, full);
  reduce_rows(acc);

  const int hd = a.hd;
  if (a.splits == 1) {
    bf16* orow[2];
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = r0 + frag_row(h);
      orow[h] = gr < GN ? a.out + b * a.ob + kv * a.okv + (gr / N) * a.og +
                              (gr % N) * a.on
                        : nullptr;
      inv[h] = 1.f / fmaxf(acc.l[h], 1e-20f);
    }
    const bool vec = a.vec;
    emit_rows<kD>(acc, inv, hd, [&](int h, int col, float x0, float x1) {
      if (orow[h] != nullptr) store_pair(orow[h] + col, col, hd, x0, x1, vec);
    });
    return;
  }
  float* prow[2];
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = r0 + frag_row(h);
    prow[h] = gr < GN ? a.part + ((static_cast<long long>(sp) * a.B + b) *
                                      a.Kv + kv) * GN * (hd + 2) +
                            static_cast<long long>(gr) * (hd + 2)
                      : nullptr;
    if (prow[h] != nullptr && (threadIdx.x & 3) == 0) {
      prow[h][hd] = acc.m[h] / kLog2e;  // natural-log units, as combined
      prow[h][hd + 1] = acc.l[h];
    }
  }
  emit_rows<kD>(acc, one, hd, [&](int h, int col, float x0, float x1) {
    if (prow[h] == nullptr) return;
    prow[h][col] = x0;
    if (col + 1 < hd) prow[h][col + 1] = x1;
  });
}

// -------------------------------------------------- float32, CUDA cores
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kBK = 32;                     // keys per tile (one per lane)
constexpr int kMaxHd = 256;

__global__ void __launch_bounds__(kThreads)
    tree_f32_kernel(const Args<float> a) {
  const int b = blockIdx.x, kv = blockIdx.y;
  const int r0 = (blockIdx.z / a.splits) * kRowsPerBlock;
  const int sp = blockIdx.z % a.splits;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, C = a.C, hd = a.hd, GN = a.G * a.N;
  const int rows = min(GN - r0, kRowsPerBlock);       // rows of this block
  extern __shared__ float smem[];
  float* qsm = smem;                                   // [kRowsPerBlock][hd]
  float* ks = qsm + kRowsPerBlock * hd;                // [kBK][hd + 1]
  float* vs = ks + kBK * (hd + 1);                     // [kBK][hd]
  int* qp = reinterpret_cast<int*>(vs + kBK * hd);     // [N] node positions
  unsigned char* msk = reinterpret_cast<unsigned char*>(qp + N);  // [N][C]

  const float* qb = a.q + b * a.qb + kv * a.qkv;
  for (int i = tid; i < rows * hd; i += kThreads) {
    const int r = r0 + i / hd, d = i - (i / hd) * hd;
    qsm[i] = qb[(r / N) * a.qg + (r % N) * a.qn + d];
  }
  for (int i = tid; i < N; i += kThreads) qp[i] = a.q_pos[b * N + i];
  for (int i = tid; i < N * C; i += kThreads) msk[i] = a.mask[i];
  __syncthreads();

  const Geometry geo = geometry(a.length[b], C, N, a.S, a.window, qp);
  const int base = geo.base, k_end = geo.k_end;
  const int k_first = (geo.k_begin / kBK) * kBK;
  const int n_all = k_end > k_first ? (k_end - k_first + kBK - 1) / kBK : 0;
  const int2 tiles = split_tiles(n_all, sp, a.splits);
  const long long kvo = b * a.kb + kv * a.kh;
  const float* kb = a.k + kvo;
  const float* vb = a.v + kvo;
  const int nd = (hd + 31) / 32;             // lane groups; the tail is masked

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxHd / 32];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = repro::kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxHd / 32; ++j) acc[r][j] = 0.f;
  }

  for (int it = tiles.x; it < tiles.y; ++it) {
    const int kt = k_first + it * kBK;
    __syncthreads();                           // previous tile fully consumed
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int t = i / hd, d = i - (i / hd) * hd;
      const bool in = kt + t < k_end;
      const long long src = (kt + t) * a.ks + d;
      ks[t * (hd + 1) + d] = in ? kb[src] : 0.f;
      vs[t * hd + d] = in ? vb[src] : 0.f;
    }
    __syncthreads();

    const int kpos = kt + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int rr = warp * kRowsPerWarp + r;
      if (rr >= rows) continue;                // warp-uniform
      const int n = (r0 + rr) % N;
      bool vis = kpos < k_end;
      if (vis && kpos >= base) vis = msk[n * C + (kpos - base)] != 0;
      if (a.window > 0) vis = vis && kpos > qp[n] - a.window;
      if (!__any_sync(0xffffffffu, vis)) continue;
      float s = 0.f;
      if (vis) {
        const float* kr = ks + lane * (hd + 1);
        const float* qr = qsm + rr * hd;
        for (int d = 0; d < hd; ++d) s += qr[d] * kr[d];
        s *= a.scale;
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
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int rr = warp * kRowsPerWarp + r;
    if (rr >= rows) continue;
    const int gr = r0 + rr;
    float* orow;
    float mul;
    if (a.splits == 1) {
      orow = a.out + b * a.ob + kv * a.okv + (gr / N) * a.og + (gr % N) * a.on;
      mul = 1.f / fmaxf(l[r], 1e-20f);
    } else {
      orow = a.part + ((static_cast<long long>(sp) * a.B + b) * a.Kv + kv) *
                          GN * (hd + 2) + static_cast<long long>(gr) * (hd + 2);
      mul = 1.f;
      if (lane == 0) {
        orow[hd] = m[r];
        orow[hd + 1] = l[r];
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxHd / 32; ++j)
      if (j < nd && lane + 32 * j < hd) orow[lane + 32 * j] = acc[r][j] * mul;
  }
}

// ------------------------------------------------- combine the key splits
// One block per (row, kv head, sequence): the rescaled sum of the splits'
// partial outputs over the rescaled sum of their row sums.
template <typename T>
__global__ void __launch_bounds__(128) tree_combine_kernel(const Args<T> a) {
  const int gr = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int hd = a.hd, GN = a.G * a.N, N = a.N;
  const long long row = hd + 2;
  const long long split = static_cast<long long>(a.B) * a.Kv * GN * row;
  const float* p = a.part + ((static_cast<long long>(b) * a.Kv + kv) * GN +
                             gr) * row;
  float M = repro::kNeg;
  for (int s = 0; s < a.splits; ++s) M = fmaxf(M, p[s * split + hd]);
  float L = 0.f;
  for (int s = 0; s < a.splits; ++s)
    L += p[s * split + hd + 1] * expf(p[s * split + hd] - M);
  const float inv = 1.f / fmaxf(L, 1e-20f);
  T* orow = a.out + b * a.ob + kv * a.okv + (gr / N) * a.og + (gr % N) * a.on;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < a.splits; ++s)
      o += p[s * split + d] * expf(p[s * split + hd] - M);
    orow[d] = repro::from_float<T>(o * inv);
  }
}

template <int kD>
int launch_tc(const Args<bf16>& a, dim3 grid, cudaStream_t stream) {
  namespace at = repro::attn;
  const cudaError_t err = at::allow_smem<tree_tc_kernel<kD>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = at::Tile<kD, 1>::kSmem + sizeof(int) * a.N +
                      static_cast<size_t>(a.N) * a.C;
  tree_tc_kernel<kD><<<grid, 128, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const Args<float>& a, dim3 grid, cudaStream_t stream) {
  const cudaError_t err = repro::attn::allow_smem<tree_f32_kernel>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      sizeof(float) * (kRowsPerBlock * a.hd + kBK * (a.hd + 1) + kBK * a.hd) +
      sizeof(int) * a.N + static_cast<size_t>(a.N) * a.C;
  tree_f32_kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args<T>& a, cudaStream_t stream) {
  const int GN = a.G * a.N;
  int err;
  if constexpr (sizeof(T) == 4) {
    const dim3 grid(a.B, a.Kv, (GN + kRowsPerBlock - 1) / kRowsPerBlock *
                                   a.splits);
    err = launch_f32(a, grid, stream);
  } else {
    const int tiles = (GN + 63) / 64;
    const dim3 grid(a.B, a.Kv, tiles * a.splits);
    if (a.hd <= 64) err = launch_tc<64>(a, grid, stream);
    else if (a.hd <= 80) err = launch_tc<80>(a, grid, stream);
    else if (a.hd <= 128) err = launch_tc<128>(a, grid, stream);
    else err = launch_tc<256>(a, grid, stream);
  }
  if (err != 0 || a.splits == 1) return err;
  tree_combine_kernel<T><<<dim3(GN, a.Kv, a.B), 128, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch arguments come packed as 29 int64 (one ctypes argument: the
// conversion of each ctypes argument costs host time on every call), in
// this order: dtype (0 = float32, 1 = bfloat16); q and its strides over
// (b, kv head, g, node); k, v and their shared strides over (b, kv head,
// position); length (B,) int32, the valid entries before the N new rows;
// mask (N, C) one byte per entry, row-major; q_pos (B, N) int32 row-major;
// out and its strides (as q's); part, float32 scratch of splits * B * Kv *
// G * N * (hd + 2) entries when splits > 1; B, Kv, G, N, C, hd, S, window,
// splits.  q and out are (B, Kv, G, N, hd), k and v (B, Kv, S, hd); every
// head dim is contiguous.  Returns a cudaError_t as int.
REPRO_EXPORT int repro_tree_verify_attention(const long long* p, float scale,
                                             void* stream) {
  auto ptr = [&](int i) { return reinterpret_cast<void*>(p[i]); };
  auto num = [&](int i) { return static_cast<int>(p[i]); };
  const int dtype = num(0);
  const int B = num(20), Kv = num(21), G = num(22), N = num(23), C = num(24),
            hd = num(25), S = num(26), window = num(27), splits = num(28);
  if (hd < 1 || hd > 256 || C < N || N < 1 || splits < 1 ||
      (splits > 1 && ptr(19) == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* length = static_cast<const int*>(ptr(11));
  const auto* mask = static_cast<const unsigned char*>(ptr(12));
  const auto* q_pos = static_cast<const int*>(ptr(13));
  auto* part = static_cast<float*>(ptr(19));
  if (dtype == 0)
    return launch(Args<float>{static_cast<const float*>(ptr(1)), p[2], p[3],
                              p[4], p[5], static_cast<const float*>(ptr(6)),
                              static_cast<const float*>(ptr(7)), p[8], p[9],
                              p[10], length, mask, q_pos,
                              static_cast<float*>(ptr(14)), p[15], p[16],
                              p[17], p[18], part, B, Kv, G, N, C, hd, S,
                              window, splits, 0, scale},
                  s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = repro::attn::rows16(
      {ptr(1), ptr(6), ptr(7), ptr(14)},
      {p[2], p[3], p[4], p[5], p[8], p[9], p[10], p[15], p[16], p[17],
       p[18]}, hd);
  return launch(Args<bf16>{static_cast<const bf16*>(ptr(1)), p[2], p[3],
                           p[4], p[5], static_cast<const bf16*>(ptr(6)),
                           static_cast<const bf16*>(ptr(7)), p[8], p[9],
                           p[10], length, mask, q_pos,
                           static_cast<bf16*>(ptr(14)), p[15], p[16], p[17],
                           p[18], part, B, Kv, G, N, C, hd, S, window,
                           splits, vec, scale},
                s);
}
