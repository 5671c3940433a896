// The gradient of tiled (flash) attention for Hopper (sm_90a): dQ, dK and
// dV of causal or windowed GQA attention, bf16 or float32.
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
// ms at the bf16 tensor-core rate.  This design is simple and right, not
// fast: float32 products on the CUDA cores (S and dP computed twice, seven
// products), operands staged in shared memory.  Tensor cores and TMA are a
// later redesign's work.  On the CUDA cores the limit is shared memory,
// one 128-byte wavefront a cycle per SM against 128 FMAs: every product
// reads its operands as 16-byte quads, each thread reusing what it loads
// over 4 rows or 4 columns, so that about 85 FMAs are issued per
// wavefront (a scalar load per FMA would allow 32).
//
// Design, three kernels on the caller's stream, one C entry:
//   1. delta: D = rowsum(dO o O) per (sequence, head, row), one warp a row,
//      into a float32 scratch.
//   2. dK/dV: one block per (32-key tile, kv head, sequence).  The block
//      keeps its K and V tile in shared memory and walks the query tiles
//      of all G heads of its kv head that can see a key of the tile (the
//      causal limit and the window bound them: masked tiles are skipped).
//      Per 32-row query tile: lane = key, each warp 4 rows, it forms
//      P = exp(scale S - LSE) and dS = P o (dP - D) (zero where masked);
//      then lane = key, warp = every 8th column quad, it accumulates
//      dV += P^T dO and dK += dS^T Q in registers.  GQA sums in the block,
//      so dK and dV are written once, with no atomics.
//   3. dQ: one block per (32-row query tile, head, sequence) walks the
//      visible key tiles, recomputes dS and accumulates dQ += dS K, each
//      row on 8 lanes of every 8th column quad.
// Every sum runs in a fixed order, so results are the same from run to
// run.  Shared-memory rows hold the head dim padded to a quad plus one
// quad (zeros), so 16-byte loads stay aligned and a lane reading its own
// key row hits its own banks.
#include "common.cuh"

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
  float scale;
};

enum { Q = 0, K = 1, V = 2, O = 3, G_ = 4, DQ = 5, DK = 6, DV = 7 };

__device__ __forceinline__ bool visible(int i, int j, int Sq, int Sk,
                                        int causal, int window) {
  return i < Sq && j < Sk && (!causal || j <= i) &&
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
                                       int window, float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int P = pitch(hd), nq = quads(hd);
  const int j = k0 + lane;
  bool vis[kRows], any = false;
  float s[kRows], dp[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    vis[r] = visible(q0 + warp * kRows + r, j, Sq, Sk, causal, window);
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
  const int q_begin = a.causal ? k0 : 0;
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
                   hd, a.causal, a.window, a.scale);
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
  const int k_end = a.causal ? min(q_last + 1, a.Sk) : a.Sk;
  const T* kb = a.k + b * a.st[K][0] + kv * a.st[K][1];
  const T* vb = a.v + b * a.st[V][0] + kv * a.st[V][1];
  for (int k0 = (k_begin / kT) * kT; k0 < k_end; k0 += kT) {
    __syncthreads();                       // the previous tile is consumed
    stage(ks, kb, a.st[K][2], k0, a.Sk, hd);
    stage(vs, vb, a.st[V][2], k0, a.Sk, hd);
    __syncthreads();
    scores<false>(qs, gs, ks, vs, lse_s, dl_s, nullptr, dss, q0, k0, a.Sq,
                  a.Sk, hd, a.causal, a.window, a.scale);
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

// Once per kernel instantiation: allow the dynamic shared memory the
// device grants (the largest head dims need about 140 KB).
template <auto kernel>
cudaError_t allow_smem() {
  static const cudaError_t err = [] {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    return e;
  }();
  return err;
}

// kD: the head dim rounded up to 64, 128 or 256 (kD / 32 quads a thread)
template <typename T, int kD>
int launch(const Args<T>& a, int B, int Kv, cudaStream_t s) {
  auto dkv = dkv_kernel<T, kD / 32>;
  auto dq = dq_kernel<T, kD / 32>;
  cudaError_t err = allow_smem<dkv_kernel<T, kD / 32>>();
  if (err == cudaSuccess) err = allow_smem<dq_kernel<T, kD / 32>>();
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
  a.scale = scale;
  return a;
}

}  // namespace

// The launch arguments come packed as 43 int64, in this order: dtype (0 =
// float32, 1 = bfloat16); then q, k, v, out, dout, dq, dk, dv, each a
// pointer followed by its strides over (sequence, head, position); lse
// (the forward's (B, H, Sq) float32 log-sum-exp, contiguous); a (B, H, Sq)
// float32 scratch for D; B, H, Kv, Sq, Sk, hd, causal, window.  q, out,
// dout and dq are (B, H, Sq, hd), k, v, dk and dv (B, Kv, Sk, hd), H % Kv
// == 0, every head dim contiguous.  Returns a cudaError_t as int.
REPRO_EXPORT int repro_flash_attention_bwd(const long long* p, float scale,
                                           void* stream) {
  const int dtype = static_cast<int>(p[0]);
  const int B = static_cast<int>(p[35]), H = static_cast<int>(p[36]),
            Kv = static_cast<int>(p[37]), hd = static_cast<int>(p[40]);
  if (hd < 1 || hd > 256 || Kv < 1 || H % Kv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch(make_args<float>(p, scale, H / Kv), B, Kv, s);
  if (dtype == 1)
    return dispatch(make_args<__nv_bfloat16>(p, scale, H / Kv), B, Kv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
