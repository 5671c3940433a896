// Tiled online-softmax (flash) attention for Hopper (sm_90a), the prefill
// path.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _kernel): q (B, H, S, hd) against k, v with a
// `causal` flag and a sliding `window` (key k is visible to query q when
// k <= q under causal and k > q - window under a window), scale 1/sqrt(hd).
// The TPU kernel takes K/V already expanded to H heads; this one also takes
// Kv heads with H % Kv == 0 (query head h reads kv head h / (H / Kv)), and
// reads q, k, v and writes the output through strides (head dim
// contiguous), so the model hands over its (B, S, heads, hd) projections as
// views and gets the output in (B, S, H, hd) with no copy.  Unlike the TPU
// kernel it needs no S % block == 0: the ragged edge is masked.
//
// Bound on the H100: at long prompts the QK^T and PV products, 4 * B * H *
// hd * S^2 / 2 operations under causality — 34 GFLOP at S = 2048 for
// granite-8b's 32 heads, 0.035 ms at the bf16 tensor-core rate; at the
// serving path's 16-token prefills the launch and the latency of one tile
// (the bound is 0.1 us; the kernel, like SDPA, takes about 8 us on the
// device, most of it copying the tile in and the first pass through its
// code).  So the products run on the tensor cores, and a launch does
// nothing it need not: no copies around it, no per-call attribute setting.
//
// Design (bf16): the tensor-core tile of attn_tile.cuh.  A block owns up
// to 64 * kWG rows of one (kv head, sequence), the rows packed over the kv
// head's G query heads: row r is position r / G of query head
// kv * G + r % G, so a K/V tile is read once for all G heads and a 16-token
// prefill of granite-8b (G = 4) is 64 rows.  S = Q K^T and O += P V are
// wgmma instructions (m64n64k16 with Q and K in shared memory; m64n64k16 /
// m64n16k16 with P in registers and V in shared memory); the causal limit
// and the window bound the key tiles, so a fully masked tile is never
// loaded, and the per-entry masks run only on tiles that cross the
// diagonal or the window's edge.  Rows per block follow the grid: more
// than 64 packed rows (a long prompt) take two warpgroups, 128 rows, so
// each K/V tile serves twice the rows; a short prefill whose grid fills at
// most a quarter of the SMs gives each block 16 rows, so four times the
// blocks share its latency-bound chain (the other rows are pads, neither
// loaded nor written).  The tiles nearest the end of a causal prompt
// run first (they have the most keys).  zamba2's attention (G = 1, 15-16
// tokens, 32 heads) gets 16 rows a block, all but one real.
//
// float32 stays exact on the CUDA cores (no TF32): one block per (16 query
// rows, head, sequence), 32-key tiles staged in shared memory as f32 (K
// rows padded by one float against bank conflicts), one key per lane, each
// warp 4 rows with the output columns in registers (any hd up to 256).
// Masked keys are skipped, never weighted.
//
// Both paths optionally write each row's log-sum-exp of its scaled scores
// (natural log, (B, H, Sq) float32) for the backward in
// flash_attention_bwd.cu; a null pointer (inference, tree verify) writes
// nothing.  The bf16 tile's row r of kv head kv is position r / G of head
// kv * G + r % G, so the LSE goes to that head and position; pad rows
// write nothing.  A row that sees no key (only under a window with
// Sk < Sq) has no LSE: -inf, and an output of 0.
#include "attn_tile.cuh"

namespace {

using repro::attn::bf16;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  long long qb, qh, qs;      // q strides over (sequence, head, position)
  long long kb, kh, ks;      // k and v strides over (sequence, kv head, key)
  long long ob, oh, os;      // output strides, as q's
  int G, Sq, Sk, hd, causal, window, vec;
  float scale;
  int rows;                  // bf16: packed rows per block (16, 64, 128)
  float* lse;                // (B, H, Sq) row log-sum-exp, or null
};

// ------------------------------------------------------- bf16, tensor cores
template <int kD, int kWG>
__global__ void __launch_bounds__(128 * kWG)
    flash_tc_kernel(const Args<bf16> a) {
  using namespace repro::attn;
  using T = Tile<kD, kWG>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* stages = qs + T::kQElems;
  const int tile = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int kv = blockIdx.y, b = blockIdx.z;
  const int G = a.G, R = a.rows, r0 = tile * R, n_rows = G * a.Sq;
  const bf16* qb = a.q + b * a.qb + static_cast<long long>(kv) * G * a.qh;
  stage_rows<kD, T::kRows, T::kThreads>(qs, [&](int r) -> const bf16* {
    const int gr = r0 + r;
    return r < R && gr < n_rows ? qb + (gr % G) * a.qh + (gr / G) * a.qs
                                : nullptr;
  }, a.hd, false, a.vec, a.q);

  // keys any row of the tile can see
  const int p_first = r0 / G, p_last = (min(r0 + R, n_rows) - 1) / G;
  const int k_begin = a.window > 0 ? max(p_first - a.window + 1, 0) : 0;
  const int k_end = a.causal ? min(p_last + 1, a.Sk) : a.Sk;
  const int k_first = (k_begin / kKeys) * kKeys;
  const int n_tiles =
      k_end > k_first ? (k_end - k_first + kKeys - 1) / kKeys : 0;

  int pos[2];                                     // this thread's two rows
#pragma unroll
  for (int h = 0; h < 2; ++h) pos[h] = (r0 + frag_row(h)) / G;
  const int Sk = a.Sk, causal = a.causal, window = a.window;
  auto visible = [&](int h, int key) {
    return key < Sk && (!causal || key <= pos[h]) &&
           (window <= 0 || key > pos[h] - window);
  };
  auto full = [&](int k0) {                       // every row sees [k0, +64)
    return k0 + kKeys <= Sk && (!causal || k0 + kKeys - 1 <= p_first) &&
           (window <= 0 || k0 > p_last - window);
  };
  Acc<kD> acc;
  acc.init();
  const long long kvo = b * a.kb + kv * a.kh;
  attend<kD, kWG>(acc, qs, stages, a.k + kvo, a.v + kvo, a.ks, k_first,
                  n_tiles, k_end, a.hd, a.vec, a.scale * kLog2e, visible,
                  full);
  reduce_rows(acc);

  bf16* orow[2];
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = frag_row(h), gr = r0 + r;
    orow[h] = r < R && gr < n_rows
                  ? a.out + b * a.ob +
                        (static_cast<long long>(kv) * G + gr % G) * a.oh +
                        (gr / G) * a.os
                  : nullptr;
    inv[h] = 1.f / fmaxf(acc.l[h], 1e-20f);
    // the 4 lanes of a row hold its max (log2 units) and, reduced, its sum
    if (a.lse != nullptr && orow[h] != nullptr && (threadIdx.x & 3) == 0)
      a.lse[(static_cast<long long>(b) * gridDim.y * G + kv * G + gr % G) *
                a.Sq + gr / G] = (acc.m[h] + log2f(acc.l[h])) * kLn2;
  }
  const int hd = a.hd;
  const bool vec = a.vec;
  emit_rows<kD>(acc, inv, hd, [&](int h, int col, float x0, float x1) {
    if (orow[h] != nullptr) store_pair(orow[h] + col, col, hd, x0, x1, vec);
  });
}

// Rows per block: a prompt of more than 64 packed rows takes two
// warpgroups per block (each K/V tile then serves 128 rows, half the
// copies of one); a grid of at most a quarter of the SMs gives each block
// only 16 of its 64 rows, so that four times the blocks share the
// latency-bound work of a short prefill (the rest are pad rows).
template <int kD>
int launch_tc(Args<bf16> a, int B, int Kv, cudaStream_t stream) {
  namespace at = repro::attn;
  const int n_rows = a.G * a.Sq;
  const int blocks = (n_rows + 63) / 64 * Kv * B;
  a.rows = n_rows > 64 ? 128 : 4 * blocks <= at::sm_count() ? 16 : 64;
  const bool two = a.rows == 128;
  const cudaError_t err = two ? at::allow_smem<flash_tc_kernel<kD, 2>>()
                              : at::allow_smem<flash_tc_kernel<kD, 1>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_rows + a.rows - 1) / a.rows, Kv, B);
  if (two)
    flash_tc_kernel<kD, 2><<<grid, at::Tile<kD, 2>::kThreads,
                             at::Tile<kD, 2>::kSmem, stream>>>(a);
  else
    flash_tc_kernel<kD, 1><<<grid, at::Tile<kD, 1>::kThreads,
                             at::Tile<kD, 1>::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------- float32, CUDA cores
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 16;                     // query rows per block
constexpr int kRowsPerWarp = kBQ / kWarps;
constexpr int kBK = 32;                     // keys per tile (one per lane)
constexpr int kMaxHd = 256;

__global__ void __launch_bounds__(kThreads)
    flash_f32_kernel(const Args<float> a) {
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hd = a.hd, Sq = a.Sq, Sk = a.Sk;
  extern __shared__ float smem[];
  float* qs = smem;                          // [kBQ][hd]
  float* ks = qs + kBQ * hd;                 // [kBK][hd + 1]
  float* vs = ks + kBK * (hd + 1);           // [kBK][hd]

  const float* qb = a.q + b * a.qb + h * a.qh;
  const long long kvo = b * a.kb + (h / a.G) * a.kh;
  const float* kb = a.k + kvo;
  const float* vb = a.v + kvo;
  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    qs[i] = q0 + r < Sq ? qb[(q0 + r) * a.qs + d] : 0.f;
  }

  // keys any row of this tile can see
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_begin = a.window > 0 ? max(q0 - a.window + 1, 0) : 0;
  const int k_end = a.causal ? min(q_last + 1, Sk) : Sk;
  const int nd = (hd + 31) / 32;             // lane groups; the tail is masked

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxHd / 32];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = repro::kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxHd / 32; ++j) acc[r][j] = 0.f;
  }

  for (int kt = (k_begin / kBK) * kBK; kt < k_end; kt += kBK) {
    __syncthreads();                         // previous tile fully consumed
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int t = i / hd, d = i - t * hd;
      const bool in = kt + t < Sk;
      const long long src = (kt + t) * a.ks + d;
      ks[t * (hd + 1) + d] = in ? kb[src] : 0.f;
      vs[t * hd + d] = in ? vb[src] : 0.f;
    }
    __syncthreads();

    const int kpos = kt + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int rr = warp * kRowsPerWarp + r;
      const int qpos = q0 + rr;
      if (qpos >= Sq) continue;              // warp-uniform
      bool vis = kpos < Sk;
      if (a.causal) vis = vis && kpos <= qpos;
      if (a.window > 0) vis = vis && kpos > qpos - a.window;
      if (!__any_sync(0xffffffffu, vis)) continue;
      float s = 0.f;
      if (vis) {
        const float* kr = ks + lane * (hd + 1);
        const float* qr = qs + rr * hd;
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
        if (pt == 0.f) continue;             // warp-uniform: same pt
#pragma unroll
        for (int j = 0; j < kMaxHd / 32; ++j)
          if (j < nd && lane + 32 * j < hd)
            acc[r][j] += pt * vs[t * hd + lane + 32 * j];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qpos = q0 + warp * kRowsPerWarp + r;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-20f);
    if (a.lse != nullptr && lane == 0)
      a.lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + qpos] =
          m[r] + logf(l[r]);
    float* orow = a.out + b * a.ob + h * a.oh + qpos * a.os;
#pragma unroll
    for (int j = 0; j < kMaxHd / 32; ++j)
      if (j < nd && lane + 32 * j < hd) orow[lane + 32 * j] = acc[r][j] * inv;
  }
}

int launch_f32(const Args<float>& a, int B, int H, cudaStream_t stream) {
  const cudaError_t err = repro::attn::allow_smem<flash_f32_kernel>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = static_cast<int>(
      sizeof(float) * (kBQ * a.hd + kBK * (a.hd + 1) + kBK * a.hd));
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, H, B);
  flash_f32_kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Args<T> make_args(const void* q, const void* k, const void* v, void* out,
                  const long long (&st)[9], int G, int Sq, int Sk, int hd,
                  int causal, int window, int vec, float scale, float* lse) {
  return Args<T>{static_cast<const T*>(q), static_cast<const T*>(k),
                 static_cast<const T*>(v), static_cast<T*>(out),
                 st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                 st[8], G, Sq, Sk, hd, causal, window, vec, scale, 64, lse};
}

}  // namespace

// The launch arguments come packed as 23 int64 (one ctypes argument: the
// conversion of each ctypes argument costs host time on every call), in
// this order: dtype (0 = float32, 1 = bfloat16), q, its strides
// over (b, head, position), k, v, their shared strides over (b, kv head,
// key), out, its strides, B, H, Kv, Sq, Sk, hd, causal, window, lse (a
// contiguous (B, H, Sq) float32 buffer, or 0 for none).  q and out are
// (B, H, Sq, hd), k and v (B, Kv, Sk, hd) with H % Kv == 0; every head dim
// is contiguous.  Returns a cudaError_t as int.
REPRO_EXPORT int repro_flash_attention(const long long* p, float scale,
                                       void* stream) {
  const int dtype = static_cast<int>(p[0]);
  const void* q = reinterpret_cast<const void*>(p[1]);
  const void* k = reinterpret_cast<const void*>(p[5]);
  const void* v = reinterpret_cast<const void*>(p[6]);
  void* out = reinterpret_cast<void*>(p[10]);
  const long long st[9] = {p[2], p[3], p[4], p[7], p[8], p[9],
                           p[11], p[12], p[13]};
  const int B = static_cast<int>(p[14]), H = static_cast<int>(p[15]),
            Kv = static_cast<int>(p[16]), Sq = static_cast<int>(p[17]),
            Sk = static_cast<int>(p[18]), hd = static_cast<int>(p[19]),
            causal = static_cast<int>(p[20]), window = static_cast<int>(p[21]);
  float* lse = reinterpret_cast<float*>(p[22]);
  if (hd < 1 || hd > 256 || Kv < 1 || H % Kv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int G = H / Kv;
  if (dtype == 0)
    return launch_f32(make_args<float>(q, k, v, out, st, G, Sq, Sk, hd,
                                       causal, window, 0, scale, lse),
                      B, H, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = repro::attn::rows16({q, k, v, out}, {st[0], st[1], st[2],
                                       st[3], st[4], st[5], st[6], st[7],
                                       st[8]}, hd);
  const Args<bf16> a = make_args<bf16>(q, k, v, out, st, G, Sq, Sk, hd,
                                       causal, window, vec, scale, lse);
  if (hd <= 64) return launch_tc<64>(a, B, Kv, s);
  if (hd <= 80) return launch_tc<80>(a, B, Kv, s);
  if (hd <= 128) return launch_tc<128>(a, B, Kv, s);
  return launch_tc<256>(a, B, Kv, s);
}
