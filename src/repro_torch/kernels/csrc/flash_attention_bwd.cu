// The gradient of tiled (flash) attention for Hopper (sm_90a): dQ, dK and
// dV of causal, windowed, prefix-LM or full GQA attention, bf16 or float32.
// The masks are the forward's (flash_attention.cu): key j is visible to
// row i when (j <= i or j < prefix) under causal and j > i - window under
// a window; non-causal calls take Sq != Sk (cross attention).
//
// No TPU kernel stands behind it: the JAX package trains through jnp
// attention (src/repro/models/layers.py::mha), which XLA differentiates.
// The port runs its flash kernel (flash_attention.cu, which replaces
// src/repro/kernels/flash_attention.py::flash_attention) at every length,
// so a loss taken on the card needs this backward; it computes what
// autograd of kernels/flash_attention.py::flash_attention_plain computes.
// q, out, dout (B, H, Sq, hd) and k, v (B, Kv, Sk, hd) with H % Kv == 0
// are read through strides (head dim contiguous), as the model hands
// (B, S, heads, hd) views; dQ, dK and dV are written through their own
// strides, laid out like q, k and v.  The forward's per-row log-sum-exp
// (B, H, Sq) lets every block recompute P = exp(scale * Q K^T - LSE)
// without a second softmax pass.
//
// Bound on the H100: the operations.  The gradient needs five products
// (S = Q K^T recomputed, dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K),
// 5 x 2 x B x H x Sq x Sk x hd operations, halved under causality, against
// a few bytes per element of q, k, v, out and dout; the smollm-135m
// training step (B 8, S 256, H 9, hd 64) needs 1.5 GFLOP per layer, 0.0015
// ms at the bf16 tensor-core rate, granite-8b's heads over S 2048 87 GFLOP,
// 0.087 ms.  So the bf16 products run on the tensor cores.
//
// Three routes, chosen by the wrapper from the dtype and the head dim alone
// (kernels/flash_attention.py::flash_bwd_plan) and passed in; a route that
// does not take the call is an error, never a fallback:
//
//   wgmma (bf16, hd <= 128: every attention family the port trains):
//   two launches on the caller's stream, on the forward's tile primitives
//   (attn_tile.cuh), rows packed over the kv head's G query heads as the
//   forward packs them (row r of kv head kv is position r / G of head
//   kv * G + r % G, the division a multiply-shift), so every K/V tile
//   serves all G heads and GQA sums inside a block:
//   1. delta: D = rowsum(dO o O) per (sequence, head, row) into a float32
//      scratch, 8 lanes a row with 16-byte loads (one warp a row when the
//      rows are not 16-byte aligned).
//   2. one grid of two-warpgroup blocks per (kv head, sequence): first the
//      dK/dV blocks, one per 64-key tile (tile 0, which the most rows see
//      under causality, first), then the dQ blocks, one per 128 packed
//      rows (the last, which see the most keys, first).  The two sets are
//      independent, so they fill the SMs side by side.
//      dK/dV: K and V are staged once; the block walks the 64-row packed
//      query tiles that can see a key of the tile (the causal limit and
//      the window bound them), the two warpgroups taking alternate tiles
//      (the longest chain halves), each with its own two-stage cp.async
//      ring of Q, dO, LSE and D and its own barrier, so that one's
//      products overlap the other's arithmetic.  Per query tile and
//      warpgroup:
//        S^T = K Q^T, dP^T = V dO^T   wgmma m64n64k16, both operands in
//                                     shared memory, K-major, issued
//                                     together (the first k-step
//                                     overwrites the accumulator)
//        P^T = 2^(S^T scale log2e - LSE log2e), dS^T = P^T o (dP^T - D)
//                                     on the accumulator fragments (LSE
//                                     and D per column, from shared
//                                     memory); the per-entry mask only on
//                                     tiles that cross the diagonal or the
//                                     window's edge
//        dV += P^T dO, dK += dS^T Q   wgmma m64n64k16 / m64n16k16 with
//                                     P^T, dS^T as bf16 A fragments in
//                                     registers, dO and Q MN-major from
//                                     the same staged tiles
//      The warpgroups' partial dK and dV are summed in shared memory in a
//      fixed order; warpgroup 0 stores dK (scaled by 1/sqrt(hd)), 1 dV.
//      dQ: each warpgroup owns 64 of the 128 rows; the block walks the
//      visible 64-key tiles (K, V through the ring, each staged once for
//      both warpgroups):
//        S = Q K^T, dP = dO V^T        wgmma, shared memory, K-major
//        dS = P o (dP - D)             LSE and D per row, in registers
//        dQ += dS K                    dS as A fragments, K MN-major
//   P and dS are single bf16 A fragments (the gradients round to bf16
//   once; the forward's head + remainder split of P is for outputs that
//   a one-step move of a few keys would change).  Q/dO rows past the last
//   packed row and K/V rows past the walked keys are zero-filled, and
//   every masked entry is an exact zero by selection, so no stale shared
//   memory reaches a result.
//
//   wgmma256 (bf16, 128 < hd <= 256: paligemma-3b's hd 256): the same
//   delta kernel and one grid of both block kinds, on the same packed rows
//   and walks, at a head dim padded to 256.  The wgmma route's layout does
//   not fit there: 10 operand tiles of 64 x 256 are 320 KB of shared
//   memory (a block has 227 KB), and dK and dV of 64 keys over 256
//   columns are 256 float32 registers a thread of one warpgroup.  So the
//   two warpgroups split the head dim of every accumulator (warpgroup w
//   holds columns [128 w, 128 w + 128) of dK and dV, or of dQ: 128
//   registers) and the rows of the score products, and exchange the
//   scores through shared memory:
//   2. dK/dV: one block per 64-key tile; K and V (64 KB) stay in shared
//      memory while the block walks the 64-row packed query tiles that
//      see a key of it, Q, dO (two stages, 128 KB), LSE and D.  Per query
//      tile, warpgroup w forms
//      query rows [32 w, 32 w + 32) of
//        S^T = K Q^T, dP^T = V dO^T   wgmma m64n32k16, shared memory,
//                                     K-major, over all 256 columns
//        P^T, dS^T                    on its fragments (LSE and D per
//                                     column), written as bf16 to two
//                                     64 x 64 exchange tiles (16 KB)
//      and after a barrier, with both halves of the exchange tiles as the
//      A operand from shared memory,
//        dV[:, w] += P^T dO[:, w], dK[:, w] += dS^T Q[:, w]
//                                     wgmma m64n64k16, dO and Q MN-major
//      Each warpgroup stores its own columns of dK (scaled) and dV: no
//      partial sums to add.
//   3. dQ: one block per 64 packed rows (Q, dO: 64 KB) walking the visible
//      key tiles through two stages (K, V: 128 KB); warpgroup w forms keys
//      [32 w, 32 w + 32) of S and dP, writes its half of dS (8 KB), and
//      after a barrier adds dS K[:, w] to its dQ columns.
//   Why an exchange and not both warpgroups computing the whole 64 x 64
//   S^T and dP^T (no barrier): that is 6 products of a 64 x 64 x 256 tile
//   a step instead of 4 and 64 more registers a thread beside the 128 of
//   the accumulators; the exchange costs one barrier and 16 KB.
//   Operand tiles are 128-byte swizzled (four 64-column blocks of 64 rows
//   x 128 bytes, the 16-byte chunks of row r permuted by r % 8), the
//   layout that the Tensor Memory Accelerator writes and that wgmma reads
//   both K-major and MN-major, so one tile serves S^T = K Q^T and
//   dK += dS^T Q alike.  What bounds the route is moving the tiles, 64 KB
//   of operands per (key tile, query tile) pair in both block kinds (about
//   390 MB a call at paligemma's training shape, against 0.027 ms of
//   products).  Copied with cp.async by the block's threads, a dK/dV
//   chain took 3.6 us a 64 KB tile on an H100 (700 W), about 18 GB/s an
//   SM, the same with half the blocks running or with all of them reading
//   one sequence's rows from L2: the limit is per SM (0.32 ms a call, the
//   loads alone 0.23).  So one thread hands each tile to TMA, four boxes
//   of 64 columns x 64 rows from a 5-d map of the packed rows (column,
//   head within the kv head, position, kv head, sequence) or a 4-d map of
//   the keys, completing on an mbarrier (the loads alone 0.12 ms, the call
//   0.20; scripts/flash_bwd_variants.py).  A call whose rows TMA
//   cannot take (not 16-byte aligned, G not dividing 64, a driver without
//   cuTensorMapEncodeTiled) stages the same layout with cp.async or
//   element copies; the arithmetic, and so the result, is the same.  A
//   block takes 210 KB of shared memory, one block an SM; an mbarrier
//   wait that never completes traps rather than hanging the card.
//
//   CUDA cores (float32, the exact parity path):
//   float32 products on the CUDA cores (S and dP computed twice, seven
//   products), operands staged in shared memory as float32.  The limit is
//   shared memory, one 128-byte wavefront a cycle per SM against 128
//   FMAs: every product reads its operands as 16-byte quads, each thread
//   reusing what it loads over 4 rows or 4 columns.
//   1. delta, as above.
//   2. dK/dV: one block per (32-key tile, kv head, sequence).  The block
//      keeps its K and V tile in shared memory and walks the query tiles
//      of all G heads of its kv head that can see a key of the tile.
//      Per 32-row query tile: lane = key, each warp 4 rows, it forms
//      P = exp(scale S - LSE) and dS = P o (dP - D) (zero where masked);
//      then lane = key, warp = every 8th column quad, it accumulates
//      dV += P^T dO and dK += dS^T Q in registers.
//   3. dQ: one block per (32-row query tile, head, sequence) walks the
//      visible key tiles, recomputes dS and accumulates dQ += dS K, each
//      row on 8 lanes of every 8th column quad.
//   Shared-memory rows hold the head dim padded to a quad plus one quad
//   (zeros), so 16-byte loads stay aligned and a lane reading its own key
//   row hits its own banks.
//
// Every route writes every gradient once, with no atomics, and runs every
// sum in a fixed order, so results are the same from run to run.
#include <cuda.h>

#include "attn_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 32;                        // query rows / keys per tile
constexpr int kRows = kT / kWarps;            // query rows per warp
constexpr int kSP = kT + 1;                   // padded row of P and dS

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const T* g;                 // dout
  T* dq;
  T* dk;
  T* dv;
  const float* lse;           // (B, H, Sq), contiguous
  float* delta;               // (B, H, Sq) scratch, contiguous
  long long st[8][3];         // strides over (sequence, head, position) of
                              // q, k, v, o, g, dq, dk, dv
  int H, G, Sq, Sk, hd, causal, window;
  int prefix;                 // keys every row sees under causal (0: none)
  float scale;
  int vec;                    // wgmma route: 16-byte copies and 4-byte
                              // stores (attn::rows16 of every tensor)
  unsigned g_mul, g_shift;    // wgmma route: n / G as a multiply-shift
};

enum { Q = 0, K = 1, V = 2, O = 3, G_ = 4, DQ = 5, DK = 6, DV = 7 };

__device__ __forceinline__ bool visible(int i, int j, int Sq, int Sk,
                                        int causal, int window, int prefix) {
  return i < Sq && j < Sk && (!causal || j <= i || j < prefix) &&
         (window <= 0 || j > i - window);
}

__device__ __forceinline__ int quads(int hd) { return (hd + 3) / 4; }
// shared-memory row pitch in floats: the quad-padded head dim + one quad
__device__ __forceinline__ int pitch(int hd) { return 4 * quads(hd) + 4; }

__device__ __forceinline__ float dot4(const float4 a, const float4 b,
                                      float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ void axpy4(float4& y, float a, const float4 x) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

// Stage kT rows of a (.., position, hd) operand as float32, one warp a
// row: row t from base + (p0 + t) * stride, rows at or past n and the
// head-dim padding zero-filled.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* base,
                                      long long stride, int p0, int n,
                                      int hd) {
  const int P = pitch(hd), lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < kT; t += kWarps) {
    const T* src = base + (p0 + t) * stride;
    const bool in = p0 + t < n;
    for (int d = lane; d < P - 4; d += 32)
      dst[t * P + d] = in && d < hd ? repro::to_float(src[d]) : 0.f;
  }
}

// ------------------------------------------------------------ 1. delta
template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(const Args<T> a,
                                                         long long rows) {
  const long long r = static_cast<long long>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int i = static_cast<int>(r % a.Sq);
  const int h = static_cast<int>((r / a.Sq) % a.H);
  const long long b = r / (static_cast<long long>(a.Sq) * a.H);
  const T* o = a.o + b * a.st[O][0] + h * a.st[O][1] + i * a.st[O][2];
  const T* g = a.g + b * a.st[G_][0] + h * a.st[G_][1] + i * a.st[G_][2];
  float s = 0.f;
  for (int d = lane; d < a.hd; d += 32)
    s += repro::to_float(o[d]) * repro::to_float(g[d]);
  s = repro::warp_sum(s);
  if (lane == 0) a.delta[r] = s;
}

// D of bf16 rows whose copies can be 16 bytes (attn::rows16): 8 lanes a
// row, each multiplying 8 entries of O and dO per load
__global__ void __launch_bounds__(kThreads)
    delta_rows16_kernel(const Args<__nv_bfloat16> a, long long rows) {
  const long long r = static_cast<long long>(blockIdx.x) * (kThreads / 8) +
                      (threadIdx.x >> 3);
  const int l = threadIdx.x & 7;
  float s = 0.f;
  if (r < rows) {
    const int i = static_cast<int>(r % a.Sq);
    const int h = static_cast<int>((r / a.Sq) % a.H);
    const long long b = r / (static_cast<long long>(a.Sq) * a.H);
    const __nv_bfloat16* o =
        a.o + b * a.st[O][0] + h * a.st[O][1] + i * a.st[O][2];
    const __nv_bfloat16* g =
        a.g + b * a.st[G_][0] + h * a.st[G_][1] + i * a.st[G_][2];
    for (int c = 8 * l; c < a.hd; c += 64) {
      const uint4 x = *reinterpret_cast<const uint4*>(o + c);
      const uint4 y = *reinterpret_cast<const uint4*>(g + c);
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fx = __bfloat1622float2(x2[e]);
        const float2 fy = __bfloat1622float2(y2[e]);
        s = fmaf(fx.x, fy.x, fmaf(fx.y, fy.y, s));
      }
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  if (r < rows && l == 0) a.delta[r] = s;
}

// Recompute this warp's P and dS entries of one (query tile, key tile):
// lane = key k0 + lane, rows kRows * warp + r.  qs, gs: the query tile's
// Q and dO rows; ks, vs: the key tile's K and V rows; lse_s, dl_s: the
// query rows' LSE and D.  Masked entries are exact zeros; a warp none of
// whose entries is visible skips the products.
template <bool kWantP>
__device__ __forceinline__ void scores(const float* qs, const float* gs,
                                       const float* ks, const float* vs,
                                       const float* lse_s, const float* dl_s,
                                       float* ps, float* dss, int q0, int k0,
                                       int Sq, int Sk, int hd, int causal,
                                       int window, int prefix, float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int P = pitch(hd), nq = quads(hd);
  const int j = k0 + lane;
  bool vis[kRows], any = false;
  float s[kRows], dp[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    vis[r] = visible(q0 + warp * kRows + r, j, Sq, Sk, causal, window,
                     prefix);
    any = any || vis[r];
    s[r] = dp[r] = 0.f;
  }
  if (__any_sync(0xffffffffu, any)) {
    const float4* kr = reinterpret_cast<const float4*>(ks + lane * P);
    const float4* vr = reinterpret_cast<const float4*>(vs + lane * P);
    for (int c = 0; c < nq; ++c) {
      const float4 k4 = kr[c], v4 = vr[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int ti = warp * kRows + r;
        s[r] = dot4(reinterpret_cast<const float4*>(qs + ti * P)[c], k4,
                    s[r]);
        dp[r] = dot4(reinterpret_cast<const float4*>(gs + ti * P)[c], v4,
                     dp[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ti = warp * kRows + r;
    const float p = vis[r] ? expf(s[r] * scale - lse_s[ti]) : 0.f;
    if (kWantP) ps[ti * kSP + lane] = p;
    dss[ti * kSP + lane] = p * (dp[r] - dl_s[ti]);
  }
}

// ------------------------------------------------------------ 2. dK, dV
// kQ: column quads per thread (warp w holds quads w, w + 8, ...),
// quads(hd) <= 8 kQ
template <typename T, int kQ>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float sm[];
  const int hd = a.hd, P = pitch(hd), nq = quads(hd);
  float* ks = sm;
  float* vs = ks + kT * P;
  float* qs = vs + kT * P;
  float* gs = qs + kT * P;
  float* ps = gs + kT * P;
  float* dss = ps + kT * kSP;
  float* lse_s = dss + kT * kSP;
  float* dl_s = lse_s + kT;
  const int k0 = blockIdx.x * kT, kv = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  stage(ks, a.k + b * a.st[K][0] + kv * a.st[K][1], a.st[K][2], k0, a.Sk,
        hd);
  stage(vs, a.v + b * a.st[V][0] + kv * a.st[V][1], a.st[V][2], k0, a.Sk,
        hd);
  float4 dk[kQ], dv[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i)
    dk[i] = dv[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // query rows that can see a key of this tile
  const int k_last = min(k0 + kT, a.Sk) - 1;
  const int q_begin = a.causal && k0 >= a.prefix ? k0 : 0;
  const int q_end = a.window > 0 ? min(k_last + a.window, a.Sq) : a.Sq;
  for (int g = 0; g < a.G; ++g) {
    const int h = kv * a.G + g;
    const T* qb = a.q + b * a.st[Q][0] + h * a.st[Q][1];
    const T* gb = a.g + b * a.st[G_][0] + h * a.st[G_][1];
    const long long row0 = (static_cast<long long>(b) * a.H + h) * a.Sq;
    for (int q0 = (q_begin / kT) * kT; q0 < q_end; q0 += kT) {
      __syncthreads();                     // the previous tile is consumed
      stage(qs, qb, a.st[Q][2], q0, a.Sq, hd);
      stage(gs, gb, a.st[G_][2], q0, a.Sq, hd);
      if (threadIdx.x < kT) {
        const bool in = q0 + threadIdx.x < a.Sq;
        lse_s[threadIdx.x] = in ? a.lse[row0 + q0 + threadIdx.x] : 0.f;
        dl_s[threadIdx.x] = in ? a.delta[row0 + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      scores<true>(qs, gs, ks, vs, lse_s, dl_s, ps, dss, q0, k0, a.Sq, a.Sk,
                   hd, a.causal, a.window, a.prefix, a.scale);
      __syncthreads();
      for (int t = 0; t < kT; ++t) {
        const float p = ps[t * kSP + lane], ds = dss[t * kSP + lane];
        const float4* gr = reinterpret_cast<const float4*>(gs + t * P);
        const float4* qr = reinterpret_cast<const float4*>(qs + t * P);
#pragma unroll
        for (int i = 0; i < kQ; ++i) {
          const int c = warp + kWarps * i;
          if (c < nq) {
            axpy4(dv[i], p, gr[c]);
            axpy4(dk[i], ds, qr[c]);
          }
        }
      }
    }
  }
  if (k0 + lane >= a.Sk) return;
  T* dkr = a.dk + b * a.st[DK][0] + kv * a.st[DK][1] +
           (k0 + lane) * a.st[DK][2];
  T* dvr = a.dv + b * a.st[DV][0] + kv * a.st[DV][1] +
           (k0 + lane) * a.st[DV][2];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int c = warp + kWarps * i;
    const float kx[4] = {dk[i].x, dk[i].y, dk[i].z, dk[i].w};
    const float vx[4] = {dv[i].x, dv[i].y, dv[i].z, dv[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * c + e;
      if (c < nq && d < hd) {
        dkr[d] = repro::from_float<T>(kx[e] * a.scale);
        dvr[d] = repro::from_float<T>(vx[e]);
      }
    }
  }
}

// ------------------------------------------------------------ 3. dQ
// kQ: column quads per thread (lane l holds quads l % 8, l % 8 + 8, ...
// of row 4 warp + l / 8), quads(hd) <= 8 kQ
template <typename T, int kQ>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float sm[];
  const int hd = a.hd, P = pitch(hd), nq = quads(hd);
  float* qs = sm;
  float* gs = qs + kT * P;
  float* ks = gs + kT * P;
  float* vs = ks + kT * P;
  float* dss = vs + kT * P;
  float* lse_s = dss + kT * kSP;
  float* dl_s = lse_s + kT;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int kv = h / a.G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = warp * kRows + (lane >> 3), cq = lane & 7;
  stage(qs, a.q + b * a.st[Q][0] + h * a.st[Q][1], a.st[Q][2], q0, a.Sq, hd);
  stage(gs, a.g + b * a.st[G_][0] + h * a.st[G_][1], a.st[G_][2], q0, a.Sq,
        hd);
  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.Sq;
  if (threadIdx.x < kT) {
    const bool in = q0 + threadIdx.x < a.Sq;
    lse_s[threadIdx.x] = in ? a.lse[row0 + q0 + threadIdx.x] : 0.f;
    dl_s[threadIdx.x] = in ? a.delta[row0 + q0 + threadIdx.x] : 0.f;
  }
  float4 acc[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // keys any row of this tile can see
  const int q_last = min(q0 + kT, a.Sq) - 1;
  const int k_begin = a.window > 0 ? max(q0 - a.window + 1, 0) : 0;
  const int k_end =
      a.causal ? max(min(q_last + 1, a.Sk), min(a.prefix, a.Sk)) : a.Sk;
  const T* kb = a.k + b * a.st[K][0] + kv * a.st[K][1];
  const T* vb = a.v + b * a.st[V][0] + kv * a.st[V][1];
  for (int k0 = (k_begin / kT) * kT; k0 < k_end; k0 += kT) {
    __syncthreads();                       // the previous tile is consumed
    stage(ks, kb, a.st[K][2], k0, a.Sk, hd);
    stage(vs, vb, a.st[V][2], k0, a.Sk, hd);
    __syncthreads();
    scores<false>(qs, gs, ks, vs, lse_s, dl_s, nullptr, dss, q0, k0, a.Sq,
                  a.Sk, hd, a.causal, a.window, a.prefix, a.scale);
    __syncthreads();
    for (int t = 0; t < kT; ++t) {
      const float ds = dss[row * kSP + t];
      const float4* kr = reinterpret_cast<const float4*>(ks + t * P);
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        const int c = cq + 8 * i;
        if (c < nq) axpy4(acc[i], ds, kr[c]);
      }
    }
  }
  if (q0 + row >= a.Sq) return;
  T* dqr = a.dq + b * a.st[DQ][0] + h * a.st[DQ][1] + (q0 + row) * a.st[DQ][2];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int c = cq + 8 * i;
    const float x[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * c + e;
      if (c < nq && d < hd) dqr[d] = repro::from_float<T>(x[e] * a.scale);
    }
  }
}

// kD: the head dim rounded up to 64, 128 or 256 (kD / 32 quads a thread)
template <typename T, int kD>
int launch(const Args<T>& a, int B, int Kv, cudaStream_t s) {
  auto dkv = dkv_kernel<T, kD / 32>;
  auto dq = dq_kernel<T, kD / 32>;
  cudaError_t err = repro::attn::allow_smem<dkv_kernel<T, kD / 32>>();
  if (err == cudaSuccess)
    err = repro::attn::allow_smem<dq_kernel<T, kD / 32>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(B) * a.H * a.Sq;
  delta_kernel<T><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
                    kThreads, 0, s>>>(a, rows);
  const int P = 4 * ((a.hd + 3) / 4) + 4;
  const int smem = static_cast<int>(
      sizeof(float) * (4 * kT * P + 2 * kT * kSP + 2 * kT));
  dkv<<<dim3((a.Sk + kT - 1) / kT, Kv, B), kThreads, smem, s>>>(a);
  dq<<<dim3((a.Sq + kT - 1) / kT, a.H, B), kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args<T>& a, int B, int Kv, cudaStream_t s) {
  if (a.hd <= 64) return launch<T, 64>(a, B, Kv, s);
  if (a.hd <= 128) return launch<T, 128>(a, B, Kv, s);
  return launch<T, 256>(a, B, Kv, s);
}

template <typename T>
Args<T> make_args(const long long* p, float scale, int G) {
  Args<T> a;
  // pointers at p[1 + 4 n] for n = 0..7 (q, k, v, o, g, dq, dk, dv), each
  // followed by its three strides
  const void* ptr[8];
  for (int n = 0; n < 8; ++n) {
    ptr[n] = reinterpret_cast<const void*>(p[1 + 4 * n]);
    for (int c = 0; c < 3; ++c) a.st[n][c] = p[2 + 4 * n + c];
  }
  a.q = static_cast<const T*>(ptr[Q]);
  a.k = static_cast<const T*>(ptr[K]);
  a.v = static_cast<const T*>(ptr[V]);
  a.o = static_cast<const T*>(ptr[O]);
  a.g = static_cast<const T*>(ptr[G_]);
  a.dq = static_cast<T*>(const_cast<void*>(ptr[DQ]));
  a.dk = static_cast<T*>(const_cast<void*>(ptr[DK]));
  a.dv = static_cast<T*>(const_cast<void*>(ptr[DV]));
  a.lse = reinterpret_cast<const float*>(p[33]);
  a.delta = reinterpret_cast<float*>(p[34]);
  a.H = static_cast<int>(p[36]);
  a.G = G;
  a.Sq = static_cast<int>(p[38]);
  a.Sk = static_cast<int>(p[39]);
  a.hd = static_cast<int>(p[40]);
  a.causal = static_cast<int>(p[41]);
  a.window = static_cast<int>(p[42]);
  a.prefix = a.causal ? static_cast<int>(p[44]) : 0;
  a.scale = scale;
  a.vec = 0;
  a.g_mul = a.g_shift = 0;
  return a;
}

// ------------------------------------------------- wgmma route (bf16)
namespace tc {

using repro::attn::bf16;
constexpr int kTile = 64;     // packed query rows / keys per warpgroup tile
constexpr int kBlock = 256;   // threads a block: two warpgroups

// Shared memory of a block.  dK/dV: its 64 keys' K and V tiles, two stages
// of two query tiles' Q and dO (one per warpgroup) and of their LSE and D
// (64 floats each).  dQ: its 128 rows' Q and dO, two stages of a key
// tile's K and V.
template <int kD>
struct Smem {
  static constexpr int kE = kTile * kD;               // one 64-row tile
  static constexpr int kDkv = 10 * kE * 2 + 8 * kTile * 4;
  static constexpr int kDq = 8 * kE * 2;
  static constexpr int kBytes = kDkv > kDq ? kDkv : kDq;
  // the dK/dV exchange (one accumulator of each warpgroup) fits the stages
  static_assert(2 * (kD / 2) * 128 * 4 <= 8 * kE * 2, "exchange");
};

// Packed row gr of a kv head: (query head within the kv head, position) =
// (gr % G, gr / G), the division a multiply-shift (0 <= gr < 2^31)
struct Packed {
  unsigned G, mul, shift;
  __device__ __forceinline__ int pos(int gr) const {
    return static_cast<int>((__umulhi(static_cast<unsigned>(gr), mul) +
                             static_cast<unsigned>(gr)) >> shift);
  }
  // offset of packed row gr in a tensor with head stride sh, position
  // stride sp
  __device__ __forceinline__ long long off(int gr, long long sh,
                                           long long sp) const {
    const int p = pos(gr);
    return (gr - p * static_cast<int>(G)) * sh + p * sp;
  }
};

// Stage the 64-row tiles of packed rows r0 + r of Q (at qs) and dO (at
// gs), the padding and rows at or past n_rows zero-filled: one decode of
// a row's (head, position) serves both copies.  qb, gb: the kv head's
// first query head; sq, sg: the strides of Q and dO.
template <int kD, int kN = kBlock>
__device__ __forceinline__ void stage_qg(bf16* qs, bf16* gs, const bf16* qb,
                                         const bf16* gb, const long long* sq,
                                         const long long* sg, int r0,
                                         int n_rows, const Packed& pk,
                                         int hd, bool vec) {
  // kN threads: the block (kBlock) or one warpgroup (128, thread = x % 128)
  const int tid = threadIdx.x % kN;
  if (!vec) {                      // any alignment: element copies
    for (int i = tid; i < kTile * hd; i += kN) {
      const int r = i / hd, d = i - r * hd, gr = r0 + r;
      const long long at =
          ((r / 8) * (kD / 8) + d / 8) * 64 + (r % 8) * 8 + d % 8;
      const bool in = gr < n_rows;
      qs[at] = in ? qb[pk.off(gr, sq[1], sq[2]) + d] : __float2bfloat16(0.f);
      gs[at] = in ? gb[pk.off(gr, sg[1], sg[2]) + d] : __float2bfloat16(0.f);
    }
    for (int i = tid; i < kTile * (kD - hd); i += kN) {   // padding
      const int r = i / (kD - hd), d = hd + i % (kD - hd);
      const long long at =
          ((r / 8) * (kD / 8) + d / 8) * 64 + (r % 8) * 8 + d % 8;
      qs[at] = gs[at] = __float2bfloat16(0.f);
    }
    return;
  }
  constexpr int kCh = kD / 8;      // chunk i as in attn::stage_rows
#pragma unroll
  for (int n = 0; n < (kTile * kCh + kN - 1) / kN; ++n) {
    const int i = tid + n * kN;
    if (i < kTile * kCh) {
      const int gr = r0 + (i / (8 * kCh)) * 8 + (i & 7);
      const int c = (i >> 3) % kCh;
      const int pos = pk.pos(gr), h = gr - pos * static_cast<int>(pk.G);
      const bool in = gr < n_rows && c * 8 < hd;
      repro::attn::cp_async16(qs + i * 8,
                              in ? qb + h * sq[1] + pos * sq[2] + c * 8 : qb,
                              in ? 16 : 0);
      repro::attn::cp_async16(gs + i * 8,
                              in ? gb + h * sg[1] + pos * sg[2] + c * 8 : gb,
                              in ? 16 : 0);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   repro::attn::smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// P = 2^(s scale log2e - LSE log2e) and dS = P o (dP - D) of one 64 x 64
// tile, from the products s and dp (accumulator fragments), as bf16 A
// fragments pf and df (entry [j][e] feeds fragment [j / 2][(j & 1) * 2 +
// e / 2]).  lse2(h, c) and dl(h, c): LSE log2e and D of the entry in row
// half h, column c; kMask: evaluate visible(h, c), else every entry is
// visible.  A masked entry is an exact zero in both.
template <bool kMask, typename Lse, typename Dl, typename Visible>
__device__ __forceinline__ void grads(const float (&s)[8][4],
                                      const float (&dp)[8][4],
                                      float scale_log2, const Lse& lse2,
                                      const Dl& dl, const Visible& visible,
                                      uint32_t (&pf)[1][4][4],
                                      uint32_t (&df)[1][4][4]) {
  const int c0 = repro::attn::frag_col();
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + c0 + e;
        const bool vis = !kMask || visible(h, c);
        const float x = repro::attn::ex2(
            fmaf(s[j][2 * h + e], scale_log2, -lse2(h, c)));
        p[e] = vis ? x : 0.f;
        ds[e] = vis ? x * (dp[j][2 * h + e] - dl(h, c)) : 0.f;
      }
      pf[0][j >> 1][(j & 1) * 2 + h] = pack_bf16(p[0], p[1]);
      df[0][j >> 1][(j & 1) * 2 + h] = pack_bf16(ds[0], ds[1]);
    }
}

// ------------------------------------------------------------ 2. dK, dV
// Key tile kt: both warpgroups own its 64 keys and split the query tiles
// that see them (tile t to warpgroup t % 2), which halves the chain of the
// tiles the most rows see; their partial dK and dV are summed in shared
// memory at the end, in a fixed order.
template <int kD>
__device__ __forceinline__ void dkv_block(const Args<bf16>& a, int kt) {
  using namespace repro::attn;
  constexpr int kE = Smem<kD>::kE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kE;
  bf16* stages = vs + kE;        // stage i, warpgroup w: Q at stages +
                                 // 2 (2 i + w) kE, dO + kE
  float* rowv = reinterpret_cast<float*>(stages + 8 * kE);
                                 // stage i, warpgroup w: LSE at rowv +
                                 // 128 (2 i + w), D + 64
  const int kv = blockIdx.x, b = blockIdx.y, k0 = kt * kTile;
  const int wg = threadIdx.x >> 7;
  const int G = a.G, Sq = a.Sq, Sk = a.Sk, hd = a.hd, n_rows = G * a.Sq;
  const Packed pk{static_cast<unsigned>(G), a.g_mul, a.g_shift};
  const bool vec = a.vec;
  const long long kvo = b * a.st[K][0] + kv * a.st[K][1];
  const long long vvo = b * a.st[V][0] + kv * a.st[V][1];
  stage_rows<kD, kTile, kBlock>(ks, [&](int r) -> const bf16* {
    return k0 + r < Sk ? a.k + kvo + (k0 + r) * a.st[K][2] : nullptr;
  }, hd, true, vec, a.k);
  stage_rows<kD, kTile, kBlock>(vs, [&](int r) -> const bf16* {
    return k0 + r < Sk ? a.v + vvo + (k0 + r) * a.st[V][2] : nullptr;
  }, hd, true, vec, a.v);

  // packed query tiles that can see a key of the block
  const int k_last = min(k0 + kTile, Sk) - 1;
  const int p_begin = a.causal && k0 >= a.prefix ? k0 : 0;
  const int p_end = a.window > 0 ? min(k_last + a.window, Sq) : Sq;
  const int t_first = p_begin * G / kTile;
  const int n_tiles =
      p_end > p_begin ? (p_end * G + kTile - 1) / kTile - t_first : 0;

  const bf16* qb = a.q + b * a.st[Q][0] +
                   static_cast<long long>(kv) * G * a.st[Q][1];
  const bf16* gb = a.g + b * a.st[G_][0] +
                   static_cast<long long>(kv) * G * a.st[G_][1];
  const long long lrow = (static_cast<long long>(b) * a.H + kv * G) * Sq;
  // Each warpgroup runs its own ring: at its step i it stages its tile
  // 2 i + wg into its slot of stage i & 1 and syncs on a barrier of its
  // own, so the two drift apart and one's products overlap the other's
  // arithmetic.
  const int my_steps = (n_tiles - wg + 1) / 2;
  auto issue = [&](int i) {
    const int r0 = (t_first + 2 * i + wg) * kTile;
    bf16* qs = stages + 2 * (2 * (i & 1) + wg) * kE;
    stage_qg<kD, 128>(qs, qs + kE, qb, gb, a.st[Q], a.st[G_], r0, n_rows,
                      pk, hd, vec);
    // threads 0-63 of the warpgroup copy the LSE, 64-127 the D
    const int tl = threadIdx.x & 127, c = tl & (kTile - 1), gr = r0 + c;
    const float* src = tl < kTile ? a.lse : a.delta;
    const bool in = gr < n_rows;
    cp_async4(rowv + 2 * kTile * (2 * (i & 1) + wg) + tl,
              in ? src + lrow + pk.off(gr, Sq, 1) : src, in ? 4 : 0);
  };
  auto wg_sync = [&] {                  // this warpgroup's 128 threads
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  };

  Acc<kD> dk, dv;
  dk.init();
  dv.init();
  int key[2];                                     // this thread's two keys
#pragma unroll
  for (int h = 0; h < 2; ++h) key[h] = k0 + (frag_row(h) & (kTile - 1));
  const int causal = a.causal, window = a.window, prefix = a.prefix;
  const float scale_log2 = a.scale * kLog2e;
  if (my_steps > 0) issue(0);
  cp_async_commit();
  if (my_steps > 1) issue(1);
  cp_async_commit();
  cp_async_wait<1>();                   // K, V (both warpgroups' copies)
  fence_async_smem();                   // and this warpgroup's step 0
  __syncthreads();
  for (int i = 0; i < my_steps; ++i) {
    if (i > 0) {                        // step 1 was issued with step 0
      if (i + 1 < my_steps) issue(i + 1);
      cp_async_commit();
      cp_async_wait<1>();               // step i has landed
      fence_async_smem();
      wg_sync();
    }
    const bf16* qs = stages + 2 * (2 * (i & 1) + wg) * kE;
    const bf16* gs = qs + kE;
    const float* ls = rowv + 2 * kTile * (2 * (i & 1) + wg);
    const int r0 = (t_first + 2 * i + wg) * kTile;
    float st[8][4], dpt[8][4];          // S^T, dP^T: rows keys, cols rows
    wg_fence();
    qk_issue<kD>(st, ks, qs);
    qk_issue<kD>(dpt, vs, gs);
    wg_commit();
    wg_wait0();
    fence_regs(st);
    fence_regs(dpt);
    auto lse2 = [&](int, int c) { return ls[c] * kLog2e; };
    auto dl = [&](int, int c) { return ls[kTile + c]; };
    auto visible = [&](int h, int c) {   // branch-free
      const int gr = r0 + c, pos = pk.pos(gr);
      return (gr < n_rows) & (key[h] < Sk) &
             (!causal | (key[h] <= pos) | (key[h] < prefix)) &
             ((window <= 0) | (key[h] > pos - window));
    };
    // every key of the block visible to every row of the query tile
    const bool full = r0 + kTile <= n_rows && k0 + kTile <= Sk &&
                      (!causal || k0 + kTile - 1 <= pk.pos(r0) ||
                       k0 + kTile <= prefix) &&
                      (window <= 0 || k0 > pk.pos(r0 + kTile - 1) - window);
    uint32_t pf[1][4][4], df[1][4][4];
    if (full)
      grads<false>(st, dpt, scale_log2, lse2, dl, visible, pf, df);
    else
      grads<true>(st, dpt, scale_log2, lse2, dl, visible, pf, df);
    wg_fence();
    pv_issue<kD, 1>(dv.o, pf, gs);      // dV += P^T dO
    pv_issue<kD, 1>(dk.o, df, qs);      // dK += dS^T Q
    wg_commit();
    wg_wait0();
    fence_regs(dv.o);
    fence_regs(dk.o);
    wg_sync();                          // this slot is free again
  }
  cp_async_wait<0>();
  __syncthreads();                      // both warpgroups are done

  // warpgroup 0 hands its dV to 1 and 1 its dK to 0 through the stages
  // (entry n of thread t of a warpgroup at n * 128 + t); each adds the
  // other's part to its own, so dK and dV are each one fixed sum
  float* part = reinterpret_cast<float*>(stages);
  constexpr int kN = kD / 8 * 4;
  const int tl = threadIdx.x & 127;
  if (wg == 0) {
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(kN + 4 * j + e) * 128 + tl] = dv.o[j][e];
  } else {
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[(4 * j + e) * 128 + tl] = dk.o[j][e];
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk.o[j][e] += part[(4 * j + e) * 128 + tl];
  } else {
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dv.o[j][e] += part[(kN + 4 * j + e) * 128 + tl];
  }
  // warpgroup 0 stores dK (scaled by 1/sqrt(hd)), warpgroup 1 dV
  auto store = [&](const Acc<kD>& acc, bf16* base, const long long* st,
                   float m) {
    bf16* row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      row[h] = key[h] < Sk ? base + b * st[0] + kv * st[1] + key[h] * st[2]
                           : nullptr;
    const float mm[2] = {m, m};
    emit_rows<kD>(acc, mm, hd, [&](int h, int col, float x0, float x1) {
      if (row[h] != nullptr) store_pair(row[h] + col, col, hd, x0, x1, vec);
    });
  };
  if (wg == 0)
    store(dk, a.dk, a.st[DK], a.scale);
  else
    store(dv, a.dv, a.st[DV], 1.f);
}

// ------------------------------------------------------------ 3. dQ
// Packed rows [r0, r0 + 128): each warpgroup its own 64 against shared
// key tiles, so each K/V tile is staged once for 128 rows.
template <int kD>
__device__ __forceinline__ void dq_block(const Args<bf16>& a, int r0) {
  using namespace repro::attn;
  constexpr int kE = Smem<kD>::kE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + 2 * kE;
  bf16* stages = gs + 2 * kE;    // stage i: K at stages + 2 i kE, V + kE
  const int kv = blockIdx.x, b = blockIdx.y, wg = threadIdx.x >> 7;
  const int G = a.G, Sq = a.Sq, Sk = a.Sk, hd = a.hd, n_rows = G * a.Sq;
  const Packed pk{static_cast<unsigned>(G), a.g_mul, a.g_shift};
  const bool vec = a.vec;
  const bf16* qb = a.q + b * a.st[Q][0] +
                   static_cast<long long>(kv) * G * a.st[Q][1];
  const bf16* gb = a.g + b * a.st[G_][0] +
                   static_cast<long long>(kv) * G * a.st[G_][1];
#pragma unroll
  for (int w = 0; w < 2; ++w)
    stage_qg<kD>(qs + w * kE, gs + w * kE, qb, gb, a.st[Q], a.st[G_],
                 r0 + w * kTile, n_rows, pk, hd, vec);

  // keys any row of the block can see (the forward's bounds)
  const int p_first = pk.pos(r0);
  const int p_last = pk.pos(min(r0 + 2 * kTile, n_rows) - 1);
  const int k_begin = a.window > 0 ? max(p_first - a.window + 1, 0) : 0;
  const int k_end =
      a.causal ? max(min(p_last + 1, Sk), min(a.prefix, Sk)) : Sk;
  const int k_first = (k_begin / kTile) * kTile;
  const int n_tiles =
      k_end > k_first ? (k_end - k_first + kTile - 1) / kTile : 0;

  // this thread's two rows: position, LSE log2e and D
  int pos[2];
  float lse2[2], dl[2];
  bf16* qrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = r0 + frag_row(h);
    const bool in = gr < n_rows;
    pos[h] = pk.pos(gr);
    const long long idx = (static_cast<long long>(b) * a.H + kv * G) * Sq +
                          pk.off(gr, Sq, 1);
    lse2[h] = in ? a.lse[idx] * kLog2e : 0.f;
    dl[h] = in ? a.delta[idx] : 0.f;
    qrow[h] = in ? a.dq + b * a.st[DQ][0] +
                       static_cast<long long>(kv) * G * a.st[DQ][1] +
                       pk.off(gr, a.st[DQ][1], a.st[DQ][2])
                 : nullptr;
  }
  const long long kvo = b * a.st[K][0] + kv * a.st[K][1];
  const long long vvo = b * a.st[V][0] + kv * a.st[V][1];
  auto issue = [&](int i) {
    bf16* kt = stages + (i & 1) * 2 * kE;
    const int k0 = k_first + i * kTile;
    stage_rows<kD, kTile, kBlock>(kt, [&](int r) -> const bf16* {
      return k0 + r < k_end ? a.k + kvo + (k0 + r) * a.st[K][2] : nullptr;
    }, hd, true, vec, a.k);
    stage_rows<kD, kTile, kBlock>(kt + kE, [&](int r) -> const bf16* {
      return k0 + r < k_end ? a.v + vvo + (k0 + r) * a.st[V][2] : nullptr;
    }, hd, true, vec, a.v);
  };

  Acc<kD> dq;
  dq.init();
  const int causal = a.causal, window = a.window, prefix = a.prefix;
  const float scale_log2 = a.scale * kLog2e;
  if (n_tiles > 0) issue(0);
  cp_async_commit();                              // with Q and dO
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();                 // Q, dO and tile i have landed
    fence_async_smem();
    __syncthreads();
    const bf16* kt = stages + (i & 1) * 2 * kE;
    const int k0 = k_first + i * kTile;
    float s[8][4], dp[8][4];
    wg_fence();
    qk_issue<kD>(s, qs + wg * kE, kt);      // own rows
    qk_issue<kD>(dp, gs + wg * kE, kt + kE);
    wg_commit();
    wg_wait0();
    fence_regs(s);
    fence_regs(dp);
    auto l2 = [&](int h, int) { return lse2[h]; };
    auto d = [&](int h, int) { return dl[h]; };
    auto visible = [&](int h, int c) {       // branch-free
      const int key = k0 + c;
      return (key < k_end) &
             (!causal | (key <= pos[h]) | (key < prefix)) &
             ((window <= 0) | (key > pos[h] - window));
    };
    const bool full = k0 + kTile <= k_end &&
                      (!causal || k0 + kTile - 1 <= p_first ||
                       k0 + kTile <= prefix) &&
                      (window <= 0 || k0 > p_last - window);
    uint32_t pf[1][4][4], df[1][4][4];
    if (full)
      grads<false>(s, dp, scale_log2, l2, d, visible, pf, df);
    else
      grads<true>(s, dp, scale_log2, l2, d, visible, pf, df);
    wg_fence();
    pv_issue<kD, 1>(dq.o, df, kt);      // dQ += dS K
    wg_commit();
    wg_wait0();
    fence_regs(dq.o);
    __syncthreads();                    // stage i & 1 is free again
  }
  cp_async_wait<0>();
  const float sc[2] = {a.scale, a.scale};
  emit_rows<kD>(dq, sc, hd, [&](int h, int col, float x0, float x1) {
    if (qrow[h] != nullptr) store_pair(qrow[h] + col, col, hd, x0, x1, vec);
  });
}

// One launch for both: blocks z < n_kt are the dK/dV blocks of key tile z
// (tile 0, which the most rows see under causality, first), the rest the
// dQ blocks of 128 packed rows (the last rows, which see the most keys,
// first); the two sets read only q, k, v, dO, LSE and D, so they run side
// by side and fill the SMs together.
template <int kD>
__global__ void __launch_bounds__(kBlock, 1)
    grads_tc_kernel(const Args<bf16> a, int n_kt) {
  const int z = blockIdx.z;
  if (z < n_kt)
    dkv_block<kD>(a, z);
  else
    dq_block<kD>(a, (gridDim.z - 1 - z) * 2 * kTile);
}

template <int kD>
int launch(const Args<bf16>& a, int B, int Kv, cudaStream_t s) {
  const cudaError_t err =
      repro::attn::allow_smem<grads_tc_kernel<kD>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(B) * a.H * a.Sq;
  if (a.vec)
    delta_rows16_kernel<<<static_cast<unsigned>((rows + kThreads / 8 - 1) /
                                                (kThreads / 8)),
                          kThreads, 0, s>>>(a, rows);
  else
    delta_kernel<bf16><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
                         kThreads, 0, s>>>(a, rows);
  const int n_kt = (a.Sk + kTile - 1) / kTile;
  const int n_rt = (a.G * a.Sq + 2 * kTile - 1) / (2 * kTile);
  grads_tc_kernel<kD>
      <<<dim3(Kv, B, n_kt + n_rt), kBlock, Smem<kD>::kBytes, s>>>(a, n_kt);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core routes' launch arguments: 16-byte copies where every row
// allows them, and n / G as a multiply-shift
void prepare(Args<bf16>& a) {
  a.vec = repro::attn::rows16(
      {a.q, a.k, a.v, a.o, a.g, a.dq, a.dk, a.dv},
      {a.st[0][0], a.st[0][1], a.st[0][2], a.st[1][0], a.st[1][1],
       a.st[1][2], a.st[2][0], a.st[2][1], a.st[2][2], a.st[3][0],
       a.st[3][1], a.st[3][2], a.st[4][0], a.st[4][1], a.st[4][2],
       a.st[5][0], a.st[5][1], a.st[5][2], a.st[6][0], a.st[6][1],
       a.st[6][2], a.st[7][0], a.st[7][1], a.st[7][2]},
      a.hd);
  // n / G == (umulhi(n, mul) + n) >> shift for n < 2^31, shift =
  // ceil(log2 G), mul = floor(2^32 (2^shift - G) / G) + 1
  unsigned shift = 0;
  while ((1u << shift) < static_cast<unsigned>(a.G)) ++shift;
  a.g_shift = shift;
  a.g_mul = static_cast<unsigned>(
      ((1ull << 32) * ((1ull << shift) - a.G)) / a.G + 1);
}

int dispatch(Args<bf16> a, int B, int Kv, cudaStream_t s) {
  prepare(a);
  if (a.hd <= 64) return launch<64>(a, B, Kv, s);
  if (a.hd <= 80) return launch<80>(a, B, Kv, s);
  return launch<128>(a, B, Kv, s);
}

}  // namespace tc

// --------------------------------------- wgmma256 route (bf16, hd 129-256)
namespace tc256 {

using repro::attn::bf16;
using tc::Packed;
constexpr int kD = 256;       // the head dim, padded
constexpr int kTile = 64;     // packed query rows / keys per tile
constexpr int kBlock = 256;   // threads a block: two warpgroups
constexpr int kE = kTile * kD;          // elements of one 64 x 256 operand tile
constexpr int kCol = 8192;              // bytes of one of its 64-column blocks
constexpr int kX = kTile * kTile;       // elements of one 64 x 64 exchange tile

// The TMA descriptors of a call: Q and dO as packed rows (5-d: column, head
// within the kv head, position, kv head, sequence; a box of 64 columns x G
// heads x 64 / G positions is one 64-row column block), K and V as key
// rows (4-d: column, key, kv head, sequence; a box of 64 columns x 64 keys).
struct Maps {
  CUtensorMap q, g, k, v;
};

// Shared memory of a block (after rounding its base up to 1024 bytes).
// dK/dV: K, V, two stages of (Q, dO), the exchange tiles P^T and dS^T, two
// stages of (LSE, D), 3 mbarriers.  dQ: Q, dO, two stages of (K, V), the
// exchange tile dS, 3 mbarriers.
struct Smem {
  static constexpr int kDkv = 6 * kE * 2 + 2 * kX * 2 + 4 * kTile * 4 + 24;
  static constexpr int kDq = 6 * kE * 2 + kX * 2 + 24;
  static constexpr int kBytes = (kDkv > kDq ? kDkv : kDq) + 1024;
  static_assert(kBytes <= 232448, "one block an SM");
};

// ------------------------------------------------------- operand tiles
// A 64 x 256 operand tile is four 64-column blocks of 64 rows x 128 bytes,
// the 16-byte chunks of row r permuted by r % 8: the 128-byte swizzle that
// TMA writes and wgmma reads, K-major (rows the M or N index: S^T = K Q^T,
// S = Q K^T) and MN-major (rows the reduction: P^T dO, dS^T Q, dS K) alike.
// Byte offset of chunk c (0..31) of row r:
__device__ __forceinline__ int sw(int r, int c) {
  return (c >> 3) * kCol + r * 128 + (((c ^ r) & 7) << 4);
}

// Descriptor of a 128-byte-swizzled operand (layout type 1)
__device__ __forceinline__ uint64_t desc_sw(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  return repro::attn::desc(p, lbo, sbo) | (1ull << 62);
}

// Stage 64 rows with the block's threads (the copies TMA does not take):
// row r from row(r), elements [0, hd) of it, the rest and null rows zero;
// vec: 16-byte cp.async (``valid`` any readable address), else element
// copies.
template <typename RowFn>
__device__ __forceinline__ void stage_sw(bf16* dst, const RowFn& row, int hd,
                                         bool vec, const bf16* valid) {
  char* base = reinterpret_cast<char*>(dst);
  for (int i = threadIdx.x; i < kTile * (kD / 8); i += kBlock) {
    const int r = i >> 5, c = i & 31;
    const bf16* src = row(r);
    char* d = base + sw(r, c);
    if (vec) {
      const bool in = src != nullptr && c * 8 < hd;
      repro::attn::cp_async16(d, in ? src + c * 8 : valid, in ? 16 : 0);
    } else {
      bf16* e8 = reinterpret_cast<bf16*>(d);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int x = c * 8 + e;
        e8[e] = src != nullptr && x < hd ? src[x] : __float2bfloat16(0.f);
      }
    }
  }
}

// ------------------------------------------------------------------ TMA
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
// Wait for phase ``parity`` of the barrier; a copy that never lands traps
// (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (long long n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n > (1ll << 24)) __trap();
  }
}
__device__ __forceinline__ void tma4(void* dst, const CUtensorMap* m, int c0,
                                     int c1, int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          repro::attn::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma5(void* dst, const CUtensorMap* m, int c0,
                                     int c1, int c2, int c3, int c4,
                                     uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(
          repro::attn::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4), "r"(bar)
      : "memory");
}

// The block's shared memory, its base rounded up to 1024 bytes (the
// swizzle's alignment)
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ __align__(1024) unsigned char smem256[];
  const uint32_t s = repro::attn::smem_u32(smem256);
  return smem256 + (((s + 1023) & ~1023u) - s);
}

// With TMA: set up the block's 3 barriers (one arrival each) and, when the
// head dim leaves column blocks that no copy writes (hd <= 192), zero them
// in the n operand tiles at ``tiles``.  Ends with a block barrier.
__device__ __forceinline__ void tma_setup(uint32_t bars, bf16* tiles, int n,
                                          int nkb) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int kb = nkb; kb < kD / 64; ++kb)
    for (int i = threadIdx.x; i < n * kCol / 16; i += kBlock) {
      const int t = i / (kCol / 16), j = i % (kCol / 16);
      reinterpret_cast<uint4*>(reinterpret_cast<char*>(tiles + t * kE) +
                               kb * kCol)[j] = make_uint4(0, 0, 0, 0);
    }
  repro::attn::fence_async_smem();
  __syncthreads();
}

// Issue s = A B^T over the 256 columns without waiting: A the 64 rows at
// ``a``, B the 32 rows at ``b`` (row 0 or 32 of a tile), both K-major in
// operand tiles.  The caller fences before and commits after.
__device__ __forceinline__ void st_issue(float (&s)[4][4], const bf16* a,
                                         const bf16* b) {
  using namespace repro::attn;
  const char* pa = reinterpret_cast<const char*>(a);
  const char* pb = reinterpret_cast<const char*>(b);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int off = (kk >> 2) * kCol + (kk & 3) * 32;   // 16 columns
    const uint64_t da = desc_sw(pa + off, 16, 1024);
    const uint64_t db = desc_sw(pb + off, 16, 1024);
    if (kk == 0)
      wgmma_ss_n32<0>(s, da, db);
    else
      wgmma_ss_n32(s, da, db);
  }
}

// Issue o += X Y[:, 128 half, +128) without waiting: X the 64 x 64 exchange
// tile at ``x`` (K-major, no swizzle), Y the operand tile at ``y`` read
// MN-major (its rows are the reduction); o holds the warpgroup's 128
// columns as two 64-column accumulators.
__device__ __forceinline__ void xy_issue(float (&o)[16][4], const bf16* x,
                                         const bf16* y, int half) {
  using namespace repro::attn;
  const char* py = reinterpret_cast<const char*>(y);
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint64_t da = desc(x + kk * 128, 128, 8 * 128);
#pragma unroll
    for (int c = 0; c < 2; ++c)                      // rows 16 kk..
      wgmma_ss_n64_mn(*reinterpret_cast<float(*)[8][4]>(&o[8 * c]), da,
                      desc_sw(py + (2 * half + c) * kCol + kk * 2048, kCol,
                              1024));
  }
}

// Element (m, k) of a 64 x 64 K-major exchange tile (no swizzle).
__device__ __forceinline__ int xat(int m, int k) {
  return ((m >> 3) * 8 + (k >> 3)) * 64 + (m & 7) * 8 + (k & 7);
}

__device__ __forceinline__ void zero(float (&o)[16][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
}

// Store this warpgroup's 128 columns of a 64-row result, times m: row[h]
// is the destination row of fragment half h (null: not stored).
__device__ __forceinline__ void store_half(const float (&o)[16][4],
                                           bf16* const (&row)[2], int wg,
                                           int hd, float m, bool vec) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 128 * wg + 8 * j + repro::attn::frag_col();
      if (col < hd && row[h] != nullptr)
        repro::attn::store_pair(row[h] + col, col, hd, o[j][2 * h] * m,
                                o[j][2 * h + 1] * m, vec);
    }
}

// ------------------------------------------------------------ 2. dK, dV
// Key tile kt: the block walks the packed query tiles that see its keys,
// one tile at a time, the two warpgroups on the same tile.  Warpgroup w
// takes query rows [32 w, 32 w + 32) of S^T = K Q^T and dP^T = V dO^T
// (each over all 256 columns), forms those columns of P^T and dS^T and
// writes them as bf16 to the exchange tiles; after a barrier it adds
// P^T dO and dS^T Q to its dV and dK columns [128 w, 128 w + 128).
__device__ __forceinline__ void dkv_block(const Args<bf16>& a, const Maps& m,
                                          bool tma, int kt) {
  using namespace repro::attn;
  bf16* ks = reinterpret_cast<bf16*>(smem_base());
  bf16* vs = ks + kE;
  bf16* stages = vs + kE;        // stage i: Q at stages + 2 i kE, dO + kE
  bf16* pt = stages + 4 * kE;
  bf16* dst = pt + kX;
  float* rowv = reinterpret_cast<float*>(dst + kX);
                                 // stage i: LSE at rowv + 128 i, D + 64
  const uint32_t bars = smem_u32(rowv + 4 * kTile);   // K/V, stage 0, 1
  const int kv = blockIdx.x, b = blockIdx.y, k0 = kt * kTile;
  const int wg = threadIdx.x >> 7;
  const int G = a.G, Sq = a.Sq, Sk = a.Sk, hd = a.hd, n_rows = G * a.Sq;
  const int nkb = (hd + 63) / 64, tx = 2 * nkb * kCol;
  const Packed pk{static_cast<unsigned>(G), a.g_mul, a.g_shift};
  const bool vec = a.vec;

  // packed query tiles that can see a key of the block (BwdPlan.query_tiles)
  const int k_last = min(k0 + kTile, Sk) - 1;
  const int p_begin = a.causal && k0 >= a.prefix ? k0 : 0;
  const int p_end = a.window > 0 ? min(k_last + a.window, Sq) : Sq;
  const int t_first = p_begin * G / kTile;
  const int n_tiles =
      p_end > p_begin ? (p_end * G + kTile - 1) / kTile - t_first : 0;

  const long long kvo = b * a.st[K][0] + kv * a.st[K][1];
  const long long vvo = b * a.st[V][0] + kv * a.st[V][1];
  if (tma) {
    tma_setup(bars, ks, 6, nkb);
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect(bars, tx);
      for (int kb = 0; kb < nkb; ++kb) {
        tma4(ks + kb * kCol / 2, &m.k, 64 * kb, k0, kv, b, bars);
        tma4(vs + kb * kCol / 2, &m.v, 64 * kb, k0, kv, b, bars);
      }
    }
  } else {
    stage_sw(ks, [&](int r) -> const bf16* {
      return k0 + r < Sk ? a.k + kvo + (k0 + r) * a.st[K][2] : nullptr;
    }, hd, vec, a.k);
    stage_sw(vs, [&](int r) -> const bf16* {
      return k0 + r < Sk ? a.v + vvo + (k0 + r) * a.st[V][2] : nullptr;
    }, hd, vec, a.v);
  }

  const bf16* qb = a.q + b * a.st[Q][0] +
                   static_cast<long long>(kv) * G * a.st[Q][1];
  const bf16* gb = a.g + b * a.st[G_][0] +
                   static_cast<long long>(kv) * G * a.st[G_][1];
  const long long lrow = (static_cast<long long>(b) * a.H + kv * G) * Sq;
  auto issue = [&](int i) {
    const int r0 = (t_first + i) * kTile;
    bf16* qs = stages + 2 * (i & 1) * kE;
    if (tma) {
      if (threadIdx.x == 0) {
        const uint32_t bar = bars + 8 * (1 + (i & 1));
        mbar_expect(bar, tx);
        for (int kb = 0; kb < nkb; ++kb) {
          tma5(qs + kb * kCol / 2, &m.q, 64 * kb, 0, r0 / G, kv, b, bar);
          tma5(qs + kE + kb * kCol / 2, &m.g, 64 * kb, 0, r0 / G, kv, b,
               bar);
        }
      }
    } else {
      stage_sw(qs, [&](int r) -> const bf16* {
        const int gr = r0 + r;
        return gr < n_rows ? qb + pk.off(gr, a.st[Q][1], a.st[Q][2])
                           : nullptr;
      }, hd, vec, a.q);
      stage_sw(qs + kE, [&](int r) -> const bf16* {
        const int gr = r0 + r;
        return gr < n_rows ? gb + pk.off(gr, a.st[G_][1], a.st[G_][2])
                           : nullptr;
      }, hd, vec, a.g);
    }
    // threads 0-63 copy the LSE, 64-127 the D
    if (threadIdx.x < 2 * kTile) {
      const int c = threadIdx.x & (kTile - 1), gr = r0 + c;
      const float* src = threadIdx.x < kTile ? a.lse : a.delta;
      const bool in = gr < n_rows;
      tc::cp_async4(rowv + 2 * kTile * (i & 1) + threadIdx.x,
                    in ? src + lrow + pk.off(gr, Sq, 1) : src, in ? 4 : 0);
    }
  };

  float dk[16][4], dv[16][4];
  zero(dk);
  zero(dv);
  int key[2], xrow[2];                            // this thread's two keys
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    xrow[h] = frag_row(h) & (kTile - 1);
    key[h] = k0 + xrow[h];
  }
  const int c0 = 32 * wg + frag_col();            // this thread's columns
  const int causal = a.causal, window = a.window, prefix = a.prefix;
  const float scale_log2 = a.scale * kLog2e;
  if (n_tiles > 0) issue(0);
  cp_async_commit();                              // with K and V
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();                 // tile i has landed
    if (tma) {
      if (i == 0) mbar_wait(bars, 0);
      mbar_wait(bars + 8 * (1 + (i & 1)), (i >> 1) & 1);
    }
    fence_async_smem();
    __syncthreads();                    // and tile i - 1 is consumed
    if (i + 1 < n_tiles) issue(i + 1);
    cp_async_commit();
    const bf16* qs = stages + 2 * (i & 1) * kE;
    const bf16* gs = qs + kE;
    const float* ls = rowv + 2 * kTile * (i & 1);
    const int r0 = (t_first + i) * kTile;
    float st[4][4], dpt[4][4];          // S^T, dP^T: rows keys, 32 columns
    wg_fence();
    st_issue(st, ks, qs + 32 * wg * kTile);     // query rows 32 wg..
    st_issue(dpt, vs, gs + 32 * wg * kTile);
    wg_commit();
    wg_wait0();
    fence_regs(st);
    fence_regs(dpt);
    // every key of the block visible to every row of the query tile
    const bool full = r0 + kTile <= n_rows && k0 + kTile <= Sk &&
                      (!causal || k0 + kTile - 1 <= pk.pos(r0) ||
                       k0 + kTile <= prefix) &&
                      (window <= 0 || k0 > pk.pos(r0 + kTile - 1) - window);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * j + e, gr = r0 + c, pos = pk.pos(gr);
          const bool vis =
              full || ((gr < n_rows) & (key[h] < Sk) &
                       (!causal | (key[h] <= pos) | (key[h] < prefix)) &
                       ((window <= 0) | (key[h] > pos - window)));
          const float x = ex2(fmaf(st[j][2 * h + e], scale_log2,
                                   -ls[c] * kLog2e));
          p[e] = vis ? x : 0.f;
          ds[e] = vis ? x * (dpt[j][2 * h + e] - ls[kTile + c]) : 0.f;
        }
        const int at = xat(xrow[h], c0 + 8 * j);
        *reinterpret_cast<uint32_t*>(pt + at) = tc::pack_bf16(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(dst + at) = tc::pack_bf16(ds[0], ds[1]);
      }
    fence_async_smem();
    __syncthreads();                    // both halves of P^T, dS^T written
    wg_fence();
    xy_issue(dv, pt, gs, wg);           // dV += P^T dO
    xy_issue(dk, dst, qs, wg);          // dK += dS^T Q
    wg_commit();
    wg_wait0();
    fence_regs(dv);
    fence_regs(dk);
  }
  cp_async_wait<0>();
  bf16* krow[2];
  bf16* vrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = key[h] < Sk;
    krow[h] = in ? a.dk + b * a.st[DK][0] + kv * a.st[DK][1] +
                       key[h] * a.st[DK][2]
                 : nullptr;
    vrow[h] = in ? a.dv + b * a.st[DV][0] + kv * a.st[DV][1] +
                       key[h] * a.st[DV][2]
                 : nullptr;
  }
  store_half(dk, krow, wg, hd, a.scale, vec);
  store_half(dv, vrow, wg, hd, 1.f, vec);
}

// ------------------------------------------------------------ 3. dQ
// Packed rows [r0, r0 + 64) against the visible key tiles: warpgroup w
// takes keys [32 w, 32 w + 32) of each tile's S and dP, writes those
// columns of dS to the exchange tile, and after a barrier adds dS K to its
// dQ columns [128 w, 128 w + 128).
__device__ __forceinline__ void dq_block(const Args<bf16>& a, const Maps& m,
                                         bool tma, int r0) {
  using namespace repro::attn;
  bf16* qs = reinterpret_cast<bf16*>(smem_base());
  bf16* gs = qs + kE;
  bf16* stages = gs + kE;        // stage i: K at stages + 2 i kE, V + kE
  bf16* dsx = stages + 4 * kE;
  const uint32_t bars = smem_u32(dsx + kX);        // Q/dO, stage 0, 1
  const int kv = blockIdx.x, b = blockIdx.y, wg = threadIdx.x >> 7;
  const int G = a.G, Sq = a.Sq, Sk = a.Sk, hd = a.hd, n_rows = G * a.Sq;
  const int nkb = (hd + 63) / 64, tx = 2 * nkb * kCol;
  const Packed pk{static_cast<unsigned>(G), a.g_mul, a.g_shift};
  const bool vec = a.vec;
  const bf16* qb = a.q + b * a.st[Q][0] +
                   static_cast<long long>(kv) * G * a.st[Q][1];
  const bf16* gb = a.g + b * a.st[G_][0] +
                   static_cast<long long>(kv) * G * a.st[G_][1];

  // keys any row of the block can see (BwdPlan.key_tiles)
  const int p_first = pk.pos(r0);
  const int p_last = pk.pos(min(r0 + kTile, n_rows) - 1);
  const int k_begin = a.window > 0 ? max(p_first - a.window + 1, 0) : 0;
  const int k_end =
      a.causal ? max(min(p_last + 1, Sk), min(a.prefix, Sk)) : Sk;
  const int k_first = (k_begin / kTile) * kTile;
  const int n_tiles =
      k_end > k_first ? (k_end - k_first + kTile - 1) / kTile : 0;

  if (tma) {
    tma_setup(bars, qs, 6, nkb);
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect(bars, tx);
      for (int kb = 0; kb < nkb; ++kb) {
        tma5(qs + kb * kCol / 2, &m.q, 64 * kb, 0, r0 / G, kv, b, bars);
        tma5(gs + kb * kCol / 2, &m.g, 64 * kb, 0, r0 / G, kv, b, bars);
      }
    }
  } else {
    stage_sw(qs, [&](int r) -> const bf16* {
      const int gr = r0 + r;
      return gr < n_rows ? qb + pk.off(gr, a.st[Q][1], a.st[Q][2]) : nullptr;
    }, hd, vec, a.q);
    stage_sw(gs, [&](int r) -> const bf16* {
      const int gr = r0 + r;
      return gr < n_rows ? gb + pk.off(gr, a.st[G_][1], a.st[G_][2])
                         : nullptr;
    }, hd, vec, a.g);
  }

  // this thread's two rows: position, LSE log2e and D
  int pos[2], xrow[2];
  float lse2[2], dl[2];
  bf16* qrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    xrow[h] = frag_row(h) & (kTile - 1);
    const int gr = r0 + xrow[h];
    const bool in = gr < n_rows;
    pos[h] = pk.pos(gr);
    const long long idx = (static_cast<long long>(b) * a.H + kv * G) * Sq +
                          pk.off(gr, Sq, 1);
    lse2[h] = in ? a.lse[idx] * kLog2e : 0.f;
    dl[h] = in ? a.delta[idx] : 0.f;
    qrow[h] = in ? a.dq + b * a.st[DQ][0] +
                       static_cast<long long>(kv) * G * a.st[DQ][1] +
                       pk.off(gr, a.st[DQ][1], a.st[DQ][2])
                 : nullptr;
  }
  const long long kvo = b * a.st[K][0] + kv * a.st[K][1];
  const long long vvo = b * a.st[V][0] + kv * a.st[V][1];
  auto issue = [&](int i) {
    bf16* kt = stages + (i & 1) * 2 * kE;
    const int k0 = k_first + i * kTile;
    if (tma) {
      if (threadIdx.x == 0) {
        const uint32_t bar = bars + 8 * (1 + (i & 1));
        mbar_expect(bar, tx);
        for (int kb = 0; kb < nkb; ++kb) {
          tma4(kt + kb * kCol / 2, &m.k, 64 * kb, k0, kv, b, bar);
          tma4(kt + kE + kb * kCol / 2, &m.v, 64 * kb, k0, kv, b, bar);
        }
      }
    } else {
      stage_sw(kt, [&](int r) -> const bf16* {
        return k0 + r < k_end ? a.k + kvo + (k0 + r) * a.st[K][2] : nullptr;
      }, hd, vec, a.k);
      stage_sw(kt + kE, [&](int r) -> const bf16* {
        return k0 + r < k_end ? a.v + vvo + (k0 + r) * a.st[V][2] : nullptr;
      }, hd, vec, a.v);
    }
  };

  float dq[16][4];
  zero(dq);
  const int c0 = 32 * wg + frag_col();            // this thread's columns
  const int causal = a.causal, window = a.window, prefix = a.prefix;
  const float scale_log2 = a.scale * kLog2e;
  if (n_tiles > 0) issue(0);
  cp_async_commit();                              // with Q and dO
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();                 // tile i has landed
    if (tma) {
      if (i == 0) mbar_wait(bars, 0);
      mbar_wait(bars + 8 * (1 + (i & 1)), (i >> 1) & 1);
    }
    fence_async_smem();
    __syncthreads();                    // and tile i - 1 is consumed
    if (i + 1 < n_tiles) issue(i + 1);
    cp_async_commit();
    const bf16* kt = stages + (i & 1) * 2 * kE;
    const int k0 = k_first + i * kTile;
    float s[4][4], dp[4][4];            // S, dP: rows, 32 keys
    wg_fence();
    st_issue(s, qs, kt + 32 * wg * kTile);      // keys 32 wg..
    st_issue(dp, gs, kt + kE + 32 * wg * kTile);
    wg_commit();
    wg_wait0();
    fence_regs(s);
    fence_regs(dp);
    const bool full = k0 + kTile <= k_end &&
                      (!causal || k0 + kTile - 1 <= p_first ||
                       k0 + kTile <= prefix) &&
                      (window <= 0 || k0 > p_last - window);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + c0 + 8 * j + e;
          const bool vis =
              full || ((key < k_end) &
                       (!causal | (key <= pos[h]) | (key < prefix)) &
                       ((window <= 0) | (key > pos[h] - window)));
          const float x =
              ex2(fmaf(s[j][2 * h + e], scale_log2, -lse2[h]));
          ds[e] = vis ? x * (dp[j][2 * h + e] - dl[h]) : 0.f;
        }
        *reinterpret_cast<uint32_t*>(dsx + xat(xrow[h], c0 + 8 * j)) =
            tc::pack_bf16(ds[0], ds[1]);
      }
    fence_async_smem();
    __syncthreads();                    // both halves of dS written
    wg_fence();
    xy_issue(dq, dsx, kt, wg);          // dQ += dS K
    wg_commit();
    wg_wait0();
    fence_regs(dq);
  }
  cp_async_wait<0>();
  store_half(dq, qrow, wg, hd, a.scale, vec);
}

// One launch for both, as tc::grads_tc_kernel: blocks z < n_kt are the
// dK/dV blocks of key tile z (tile 0 first), the rest the dQ blocks of 64
// packed rows (the last rows first).
__global__ void __launch_bounds__(kBlock, 1)
    grads_kernel(const Args<bf16> a, const __grid_constant__ Maps m,
                 int n_kt, int tma) {
  const int z = blockIdx.z;
  if (z < n_kt)
    dkv_block(a, m, tma, z);
  else
    dq_block(a, m, tma, (gridDim.z - 1 - z) * kTile);
}

// ---------------------------------------------------------------- host
using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                            void*, const cuuint64_t*, const cuuint64_t*,
                            const cuuint32_t*, const cuuint32_t*,
                            CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once (null when the
// driver has none)
Encode encoder() {
  static const Encode fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(p)
               : static_cast<Encode>(nullptr);
  }();
  return fn;
}

// A map of rank n over the bf16 tensor at p: dims[0] the head dim
// (contiguous), strides of dims 1.. in elements, box {64, box[1], ...}
bool encode(CUtensorMap* m, const void* p, int n, const cuuint64_t* dims,
            const long long* strides, const cuuint32_t* box) {
  cuuint64_t st[4];
  for (int i = 0; i + 1 < n; ++i)
    st[i] = static_cast<cuuint64_t>(strides[i]) * sizeof(bf16);
  const cuuint32_t one[5] = {1, 1, 1, 1, 1};
  return encoder()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, n,
                   const_cast<void*>(p), dims, st, box, one,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The call's maps; false when TMA does not take it (rows that 16-byte
// copies cannot move, G not dividing the 64-row tile, a driver without the
// encoder, strides it refuses): the blocks then stage with cp.async.
bool make_maps(const Args<bf16>& a, int B, int Kv, Maps* m) {
  if (!a.vec || 64 % a.G != 0 || encoder() == nullptr) return false;
  const unsigned G = static_cast<unsigned>(a.G);
  const cuuint32_t pbox[5] = {64, G, 64 / G, 1, 1};
  const cuuint32_t kbox[4] = {64, 64, 1, 1};
  const cuuint64_t pdims[5] = {static_cast<cuuint64_t>(a.hd), G,
                               static_cast<cuuint64_t>(a.Sq),
                               static_cast<cuuint64_t>(Kv),
                               static_cast<cuuint64_t>(B)};
  const cuuint64_t kdims[4] = {static_cast<cuuint64_t>(a.hd),
                               static_cast<cuuint64_t>(a.Sk),
                               static_cast<cuuint64_t>(Kv),
                               static_cast<cuuint64_t>(B)};
  const long long qst[4] = {a.st[Q][1], a.st[Q][2], G * a.st[Q][1],
                            a.st[Q][0]};
  const long long gst[4] = {a.st[G_][1], a.st[G_][2], G * a.st[G_][1],
                            a.st[G_][0]};
  const long long kst[3] = {a.st[K][2], a.st[K][1], a.st[K][0]};
  const long long vst[3] = {a.st[V][2], a.st[V][1], a.st[V][0]};
  return encode(&m->q, a.q, 5, pdims, qst, pbox) &&
         encode(&m->g, a.g, 5, pdims, gst, pbox) &&
         encode(&m->k, a.k, 4, kdims, kst, kbox) &&
         encode(&m->v, a.v, 4, kdims, vst, kbox);
}

int dispatch(Args<bf16> a, int B, int Kv, cudaStream_t s) {
  tc::prepare(a);
  const cudaError_t err = repro::attn::allow_smem<grads_kernel>();
  if (err != cudaSuccess) return static_cast<int>(err);
  Maps m;
  const bool tma = make_maps(a, B, Kv, &m);
  const long long rows = static_cast<long long>(B) * a.H * a.Sq;
  if (a.vec)
    delta_rows16_kernel<<<static_cast<unsigned>((rows + kThreads / 8 - 1) /
                                                (kThreads / 8)),
                          kThreads, 0, s>>>(a, rows);
  else
    delta_kernel<bf16><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
                         kThreads, 0, s>>>(a, rows);
  const int n_kt = (a.Sk + kTile - 1) / kTile;
  const int n_qt = (a.G * a.Sq + kTile - 1) / kTile;
  grads_kernel<<<dim3(Kv, B, n_kt + n_qt), kBlock, Smem::kBytes, s>>>(
      a, m, n_kt, tma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc256

}  // namespace

// The launch arguments come packed as 45 int64, in this order: dtype (0 =
// float32, 1 = bfloat16); then q, k, v, out, dout, dq, dk, dv, each a
// pointer followed by its strides over (sequence, head, position); lse
// (the forward's (B, H, Sq) float32 log-sum-exp, contiguous); a (B, H, Sq)
// float32 scratch for D; B, H, Kv, Sq, Sk, hd, causal, window; the route
// (0 = CUDA cores, 1 = wgmma: bfloat16 with hd <= 128 only, 2 = wgmma256:
// bfloat16 with 128 < hd <= 256 only); prefix (>= 0, read only under
// causal).  q, out,
// dout and dq are (B, H, Sq, hd), k, v, dk and dv (B, Kv, Sk, hd), H % Kv
// == 0, every head dim contiguous.  Returns a cudaError_t as int.
REPRO_EXPORT int repro_flash_attention_bwd(const long long* p, float scale,
                                           void* stream) {
  const int dtype = static_cast<int>(p[0]);
  const int B = static_cast<int>(p[35]), H = static_cast<int>(p[36]),
            Kv = static_cast<int>(p[37]), Sq = static_cast<int>(p[38]),
            Sk = static_cast<int>(p[39]), hd = static_cast<int>(p[40]),
            route = static_cast<int>(p[43]);
  if (hd < 1 || hd > 256 || Kv < 1 || H % Kv != 0 || B > 65535 ||
      Kv > 65535 || p[44] < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    // grid z: the key tiles and the 128-row packed tiles of one kv head
    if (dtype != 1 || hd > 128 ||
        (Sk + 63) / 64 + (static_cast<long long>(H / Kv) * Sq + 127) / 128 >
            65535)
      return static_cast<int>(cudaErrorInvalidValue);
    return tc::dispatch(make_args<__nv_bfloat16>(p, scale, H / Kv), B, Kv,
                        s);
  }
  if (route == 2) {
    // grid z: the key tiles and the 64-row packed tiles of one kv head
    if (dtype != 1 || hd <= 128 ||
        (Sk + 63) / 64 + (static_cast<long long>(H / Kv) * Sq + 63) / 64 >
            65535)
      return static_cast<int>(cudaErrorInvalidValue);
    return tc256::dispatch(make_args<__nv_bfloat16>(p, scale, H / Kv), B,
                           Kv, s);
  }
  if (route != 0 || dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(make_args<float>(p, scale, H / Kv), B, Kv, s);
}
