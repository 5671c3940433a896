// Backward of the chunked gated-linear-attention (SSD / mLSTM) scan for
// Hopper (sm_90a): the gradients of q, k, v, log_a and log_i from those of
// y_num and den.
//
// No TPU kernel stands behind it: the JAX package differentiates the jnp
// models/ssm.py::gla_chunked.  The forward is ssd_scan.cu; this kernel
// computes what kernels/ssd_scan.py::ssd_chunk_scan_bwd_plain computes, in
// the same order of chunks.  The stabilisers (the row log-max m, the carried
// M) are constants here: both callers use the outputs only in forms that do
// not change with them (ssd_scan.py's SSDChunkScan says why), so the result
// is the exact gradient.  Per chunk (rows j, keys s <= j, decay factors
// C[j][s] = exp(La_j - La_s + log_i_s - m_j), carried-in coefficients
// co_j = exp(La_j + M - m_j), carry weights z_s = exp(La_Q-1 - La_s +
// log_i_s - m_new), scale = exp(La_Q-1 + M - m_new)), with dS / dn the
// gradient of the state the chunk carries out:
//   W = (q k^T) o C,  D = (dy v^T + dden) o C
//   dv_s = sum_j W[j][s] dy_j + z_s dS^T k_s
//   dk_s = sum_j D[j][s] q_j + z_s (dS v_s + dn)
//   dq_j = sum_s D[j][s] k_s + co_j (S~ dy_j + dden_j n~)
//   dlog_i_s = k_s . dk_s
//   dLa_j = q_j . dq_j - k_j . dk_j  (+ <dS, S~'> + <dn, n~'> at j = Q - 1)
//   dlog_a = the reverse cumsum of dLa inside the chunk
//   dS <- scale dS + sum_j co_j q_j dy_j^T,  dn <- scale dn + sum_j co_j
//   dden_j q_j
// S~, n~, M are the chunk's carried-in state, which the forward saved
// (ssd_scan.cu's Sc / ncs / Mcs); S~' the next chunk's.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16), at the trainers' shapes
// (batch 8, seq 256, from a zero state): by bytes.  Counted are the bytes
// the result needs (no saved state of a chunk that carries none in; n~ and
// dden only where the caller passes dden) and the carry products only
// where a state or a gradient is carried.  mamba2-370m moves 69.5 MB
// (0.0207 ms) for 8.6 G operations counted once (0.0087 ms); the
// tensor-core route runs 18.3 G with its split products counted (0.0185
// ms); zamba2-2.7b 140.1 MB (0.0418 ms) for 9.4 G once, 22.9 G split
// (0.0232 ms); xlstm-125m 69.5 MB (0.0207 ms) for 6.9 G once, 16.9 G
// split (0.0171 ms), before its six P tiles each recompute the scores.  At
// S 2048 the split products take longer than the bytes: mamba2 76.8 MB
// (0.0229 ms), 12.4 G once, 27.7 G split (0.0280 ms); xLSTM 86.0 MB
// (0.0257 ms), 11.1 G once, 27.5 G split (0.0278 ms) (chip_smoke.py's
// _ssd_bwd_cost, _ssd_bwd_split_ops).
//
// Two routes, chosen on the host from shapes alone (kernels/ssd_scan.py::
// ssd_bwd_plan) and passed in as the launch's kind:
//
// * bf16 on the tensor cores (ssd_bwd_mma_kernel): one block per (64-column
//   tile of P, head, batch) walking the chunks in reverse, with its (N, 64)
//   slice of dS (float32) and dn in shared memory.  Per chunk, dy is split
//   once into bf16 head and remainder rows that stay resident; then
//   - key tiles (R rows: 64 where N <= 128, else 32 up to N = 384): k_s and
//     v_s staged, dk_s and dv_s held in registers from their carry terms
//     (k dS, v dS^T) across the row tiles j >= s, whose q_j streams through
//     cp.async stages (two with 64-row tiles, the next in flight; one with
//     32-row tiles, whose N leaves no room for a second); per pair S^T = k q^T and dP^T = v dy^T, then W^T and D^T go
//     through shared memory as bf16 head and remainder, and dv += W^T dy,
//     dk += D^T q;
//   - row tiles: dq_j held in registers from its carried-in term co (dy S~)
//     (S~ read from L2 a fragment at a time), then per key tile s <= j,
//     whose k and v stream through the same stages, dP = dy v^T (recomputed), D,
//     and dq += D k; then q . dq, and the previous chunk's dS += q^T (co o
//     dy) and dn.
//   Every product is mma.sync m16n8k16 (bf16, f32 accumulators; ssd_mma.cuh,
//   shared with the forward) with operands by ldmatrix, .trans for the
//   transposed ones.  q, k, v are bf16: q k^T and the products with q, k or
//   v against a float32 operand split that operand (2 products); W^T dy,
//   dy S~ and q^T (co o dy) have two float32 operands and take 3 products
//   (head head, head rem, rem head).  Errors against the plain autograd
//   (bf16, relative to max(1, max |plain|)): 1.7e-3 to 3.6e-3 under 2e-2.
//   16 warps with 64-row tiles (four warps a 16-row strip, 128 registers),
//   8 with 32-row tiles.  One P tile writes dq, dk, dlog_i and dlog_a (the
//   reverse cumsum by warp 0) itself; several write float32 partials that
//   the finish kernel sums.
// * float32, and bf16 whose tiles fit nowhere, on the CUDA cores
//   (ssd_bwd_kernel): the same walk over row tiles of R = 32 (16 where N is
//   large) rows, bf16 widened to float32 as it is staged, every product as
//   float32 FMAs in register micro-tiles (R / 16 rows by 4 columns a
//   thread); dq's intra-chunk part read, modified and written in a float32
//   scratch per key tile, its carried-in term one warp a row; partials and
//   the finish kernel for every P-tile count.
//
// Every sum has one fixed order and there are no float atomics: two runs
// give the same bits.  Pad rows (the front pad of a ragged S) have q = k =
// v = dy = 0 and are masked out of C, co and z before any exp.
//
// Measured on an H100 (700 W, scripts/attention_ab.py --kernels ssdbwd):
// 8 warps a 64-row tile (255 registers, a few spilled) took 0.278 / 0.605
// ms at mamba2's / zamba2's trainer shapes against 16 warps' 0.239 /
// 0.493.  The finish kernel summed dq, dk with one block per (chunk, head,
// batch): xLSTM's backward took 1.19 ms in all; a grid over the elements
// takes 0.73.  Tried and measured slower: S~ staged as bf16 rows through
// the idle W, D buffers, and dS's update spread over column groups (both
// pushed the 128-register cap into more spills, slowing even mamba2,
// which runs neither).
#include <cstdint>

#include "ssd_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = repro::ssd::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kPT = 64;                      // value columns per block
constexpr int kLdP = kPT + 1;                // odd: column walks hit 32 banks

struct Strides3 {
  long long b, s, h;                         // element strides of (B, S, H)
};

// Byte offsets of the dynamic shared memory, the same on host and device.
struct Layout {
  int ldn, ldr;
  size_t dS, dn, qj, kt, dkt, vt, dyt, dvt, W, D, gates, bytes;
  __host__ __device__ Layout(int N, int Q, int R) {
    ldn = N | 1;                             // odd row stride
    ldr = R + 1;
    const size_t Nl = N, Rl = R;
    dS = 0;
    dn = dS + Nl * kLdP * 4;
    qj = dn + Nl * 4;
    kt = qj + Rl * ldn * 4;
    dkt = kt + Rl * ldn * 4;
    vt = dkt + Rl * ldn * 4;
    dyt = vt + Rl * kLdP * 4;
    dvt = dyt + Rl * kLdP * 4;
    W = dvt + Rl * kLdP * 4;
    D = W + Rl * ldr * 4;
    gates = D + Rl * ldr * 4;
    // La, log_i, m, co, z, dden, dLa [Q each], cumsum scratch, warp sums
    bytes = gates + (7 * static_cast<size_t>(Q) + Q / 8 + 32 + kWarps) * 4;
  }
};

// Rows [j0, j0 + R) of a strided (Q, width) operand of the chunk starting at
// position t0, widened to float32 into dst (row stride ld): rows past the
// chunk or in the front pad, and columns in [width, wpad), are zero.
template <typename T>
__device__ __forceinline__ void stage_f32(float* dst, int ld, int wpad, int R,
                                      const T* __restrict__ src, long long rs,
                                      int j0, int t0, int Q, int width) {
  for (int i = threadIdx.x; i < R * wpad; i += kThreads) {
    const int r = i / wpad, c = i - r * wpad;
    const int j = j0 + r, t = t0 + j;
    dst[r * ld + c] = j < Q && t >= 0 && c < width
        ? repro::to_float(src[t * rs + c]) : 0.f;
  }
}

// Sum of every thread's x, in one fixed order (warp butterflies, then the
// warps' sums in warp order); every thread gets it.  red: kW floats.
template <int kW = kWarps>
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = repro::warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kW; ++w) s += red[w];
  __syncthreads();
  return s;
}

// R: rows of a row / key tile (32, or 16 where N is large).  Thread (ty, tx)
// of the 16 x 16 grid owns the micro-tile rows ty + 16 i (i < R / 16) and
// columns tx + 16 c of every product, so each shared load feeds several
// FMAs.  Registers: R = 32 asks for two blocks an SM (128 registers, a
// few spilled), which zamba2's N = 64 fits in shared memory (on an H100,
// 1.47 ms at its training shape against 1.94 with one block of 184
// registers); R = 16 (N = 384) fits one block, so its registers are not
// capped (187, no spills: 5.03 ms at xLSTM's against 5.46 capped).
template <typename T, int R>
__global__ void __launch_bounds__(kThreads, R == 32 ? 2 : 1) ssd_bwd_kernel(
    const T* __restrict__ q, Strides3 qs, const T* __restrict__ k,
    Strides3 ks, const T* __restrict__ v, Strides3 vs,
    const float* __restrict__ la, Strides3 las, const float* __restrict__ li,
    Strides3 lis, const float* __restrict__ mo, const float* __restrict__ Sc,
    const float* __restrict__ ncs, const float* __restrict__ Mcs,
    const float* __restrict__ Mf, int fresh, const float* __restrict__ dy,
    const float* __restrict__ dden, T* __restrict__ dv,
    float* __restrict__ dq_part, float* __restrict__ dk_part,
    float* __restrict__ dLa_part, float* __restrict__ dli_part, int B, int S,
    int H, int N, int P, int Q, int pad) {
  constexpr int kM = R / 16;                 // micro-tile rows per thread
  const Layout L(N, Q, R);
  const int ldn = L.ldn, ldr = L.ldr;
  const int tile = blockIdx.x, p0 = tile * kPT, h = blockIdx.y, b = blockIdx.z;
  const int pw = min(P - p0, kPT);           // valid columns of the tile
  const bool first_tile = tile == 0;         // owns the dden / dn terms
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  extern __shared__ __align__(16) unsigned char smem[];
  float* dS = reinterpret_cast<float*>(smem + L.dS);     // [N][kLdP]
  float* dn = reinterpret_cast<float*>(smem + L.dn);     // [N]
  float* qj = reinterpret_cast<float*>(smem + L.qj);     // [R][ldn] rows
  float* kt = reinterpret_cast<float*>(smem + L.kt);     // [R][ldn] keys
  float* dkt = reinterpret_cast<float*>(smem + L.dkt);   // [R][ldn] dk acc
  float* vt = reinterpret_cast<float*>(smem + L.vt);     // [R][kLdP] values
  float* dyt = reinterpret_cast<float*>(smem + L.dyt);   // [R][kLdP] dy rows
  float* dvt = reinterpret_cast<float*>(smem + L.dvt);   // [R][kLdP] dv acc
  float* Wt = reinterpret_cast<float*>(smem + L.W);      // [R][ldr] W tile
  float* Dt = reinterpret_cast<float*>(smem + L.D);      // [R][ldr] D tile
  float* La = reinterpret_cast<float*>(smem + L.gates);  // [Q] cumsum
  float* lg = La + Q;                        // [Q] log_i
  float* mr = lg + Q;                        // [Q] the forward's row log-max
  float* co = mr + Q;                        // [Q] carried-in coefficients
  float* zc = co + Q;                        // [Q] carry weights
  float* ddv = zc + Q;                       // [Q] dden
  float* dLa = ddv + Q;                      // [Q] dLa of this P tile
  float* scratch = dLa + Q;                  // cumsum block totals
  float* red = scratch + Q / 8 + 32;         // [kWarps] block sums

  const size_t bh = static_cast<size_t>(b) * H + h;
  const long long qb = b * qs.b + h * qs.h, kb = b * ks.b + h * ks.h;
  const long long vb = b * vs.b + h * vs.h + p0;
  const long long lab = b * las.b + h * las.h, lib = b * lis.b + h * lis.h;
  const int nc = (S + pad) / Q;
  const size_t part = static_cast<size_t>(tile) * B;   // partials' tile base
  // row t of this (b, h) in the (ntiles, B, S, H[, N]) partials
  auto partN = [&](int t) {
    return (((part + b) * S + t) * H + h) * N;
  };
  auto part1 = [&](int t) { return ((part + b) * S + t) * H + h; };

  // the final state is not differentiable: dS = dn = 0 after the last chunk
  for (int i = tid; i < N * kLdP; i += kThreads) dS[i] = 0.f;
  for (int n = tid; n < N; n += kThreads) dn[n] = 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * Q - pad;              // real position of chunk row 0
    const bool carried = c > 0 || !fresh;    // a non-zero carried-in state
    __syncthreads();                         // the previous chunk is done
    for (int j = tid; j < Q; j += kThreads) {
      const int t = t0 + j;
      const bool in = t >= 0;
      La[j] = in ? la[lab + t * las.s] : 0.f;
      lg[j] = in ? li[lib + t * lis.s] : repro::kNeg;
      mr[j] = in ? mo[(static_cast<size_t>(b) * S + t) * H + h] : 0.f;
      ddv[j] = in && dden != nullptr
          ? dden[(static_cast<size_t>(b) * S + t) * H + h] : 0.f;
    }
    __syncthreads();
    repro::ssd::cumsum_blocked(La, Q, scratch);
    const float M = Mcs[bh * nc + c];
    const float m_new = c + 1 < nc ? Mcs[bh * nc + c + 1] : Mf[bh];
    const float la_sum = La[Q - 1];
    const float scale = expf(fminf(la_sum + M - m_new, 0.f));
    for (int j = tid; j < Q; j += kThreads) {
      const bool in = t0 + j >= 0;
      co[j] = in && carried ? expf(La[j] + M - mr[j]) : 0.f;
      zc[j] = in ? expf(la_sum - La[j] + lg[j] - m_new) : 0.f;
    }
    // d la_sum from the carry: <dS, S~'> + <dn, n~'> (S~' = the next
    // chunk's carried-in state; after the last chunk dS = 0)
    float acc = 0.f;
    if (c + 1 < nc) {
      const float* Sn = Sc + ((bh * nc + c + 1) * P + p0) * N;
      for (int i = tid; i < pw * N; i += kThreads) {
        const int p = i / N, n = i - p * N;
        acc += dS[n * kLdP + p] * Sn[i];
      }
      if (first_tile)
        for (int n = tid; n < N; n += kThreads)
          acc += dn[n] * ncs[(bh * nc + c + 1) * N + n];
    }
    const float dla_sum = block_sum(acc, red);   // also publishes the gates

    // ---- key tiles: dv, dk (complete per tile), dq's intra-chunk part
    for (int s0 = 0; s0 < Q; s0 += R) {
      const int nk = min(R, Q - s0);
      __syncthreads();                       // kt, vt, dkt, dvt free
      stage_f32<T>(kt, ldn, N, R, k + kb, ks.s, s0, t0, Q, N);
      stage_f32<T>(vt, kLdP, kPT, R, v + vb, vs.s, s0, t0, Q, pw);
      __syncthreads();
      for (int nb = 0; nb < N; nb += 64) {   // dk = z_s (dS v_s + dn)
        int nn[4];
        bool ok[4];
        float a[kM][4] = {};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          nn[u] = nb + tx + 16 * u;
          ok[u] = nn[u] < N;
        }
        for (int p = 0; p < pw; ++p) {
          float x[kM], y[4];
#pragma unroll
          for (int i = 0; i < kM; ++i) x[i] = vt[(ty + 16 * i) * kLdP + p];
#pragma unroll
          for (int u = 0; u < 4; ++u) y[u] = ok[u] ? dS[nn[u] * kLdP + p] : 0.f;
#pragma unroll
          for (int i = 0; i < kM; ++i)
#pragma unroll
            for (int u = 0; u < 4; ++u) a[i][u] += x[i] * y[u];
        }
#pragma unroll
        for (int i = 0; i < kM; ++i) {
          const int cc = ty + 16 * i;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (!ok[u]) continue;
            float d = 0.f;
            if (cc < nk) {
              d = a[i][u];
              if (first_tile) d += dn[nn[u]];
              d *= zc[s0 + cc];
            }
            dkt[cc * ldn + nn[u]] = d;
          }
        }
      }
      {                                      // dv = z_s dS^T k_s
        float a[kM][4] = {};
        for (int n = 0; n < N; ++n) {
          float x[kM], y[4];
#pragma unroll
          for (int i = 0; i < kM; ++i) x[i] = kt[(ty + 16 * i) * ldn + n];
#pragma unroll
          for (int u = 0; u < 4; ++u) y[u] = dS[n * kLdP + tx + 16 * u];
#pragma unroll
          for (int i = 0; i < kM; ++i)
#pragma unroll
            for (int u = 0; u < 4; ++u) a[i][u] += x[i] * y[u];
        }
#pragma unroll
        for (int i = 0; i < kM; ++i) {
          const int cc = ty + 16 * i;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int p = tx + 16 * u;
            dvt[cc * kLdP + p] = cc < nk && p < pw ? a[i][u] * zc[s0 + cc]
                                                   : 0.f;
          }
        }
      }
      for (int j0 = s0; j0 < Q; j0 += R) {
        const int nr = min(R, Q - j0);
        __syncthreads();                     // qj, dyt, Wt, Dt free
        stage_f32<T>(qj, ldn, N, R, q + qb, qs.s, j0, t0, Q, N);
        for (int i = tid; i < R * kPT; i += kThreads) {
          const int r = i / kPT, p = i - r * kPT;
          const int j = j0 + r, t = t0 + j;
          dyt[r * kLdP + p] = j < Q && t >= 0 && p < pw
              ? dy[(static_cast<size_t>(b) * S + t) * H * P +
                   static_cast<size_t>(h) * P + p0 + p] : 0.f;
        }
        __syncthreads();
        {                                    // W and D
          float sc[kM][kM] = {}, dp[kM][kM] = {};
          for (int n = 0; n < N; ++n) {
            float x[kM], y[kM];
#pragma unroll
            for (int i = 0; i < kM; ++i) {
              x[i] = qj[(ty + 16 * i) * ldn + n];
              y[i] = kt[(tx + 16 * i) * ldn + n];
            }
#pragma unroll
            for (int i = 0; i < kM; ++i)
#pragma unroll
              for (int u = 0; u < kM; ++u) sc[i][u] += x[i] * y[u];
          }
          for (int p = 0; p < pw; ++p) {
            float x[kM], y[kM];
#pragma unroll
            for (int i = 0; i < kM; ++i) {
              x[i] = dyt[(ty + 16 * i) * kLdP + p];
              y[i] = vt[(tx + 16 * i) * kLdP + p];
            }
#pragma unroll
            for (int i = 0; i < kM; ++i)
#pragma unroll
              for (int u = 0; u < kM; ++u) dp[i][u] += x[i] * y[u];
          }
#pragma unroll
          for (int i = 0; i < kM; ++i)
#pragma unroll
            for (int u = 0; u < kM; ++u) {
              const int r = ty + 16 * i, cc = tx + 16 * u;
              const int j = j0 + r, s = s0 + cc;
              float w = 0.f, d = 0.f;
              if (r < nr && cc < nk && s <= j && t0 + j >= 0) {
                const float C = expf(La[j] - La[s] + lg[s] - mr[j]);
                w = sc[i][u] * C;
                d = (dp[i][u] + (first_tile ? ddv[j] : 0.f)) * C;
              }
              Wt[r * ldr + cc] = w;
              Dt[r * ldr + cc] = d;
            }
        }
        __syncthreads();
        {                                    // dv += W^T dy
          float a[kM][4];
#pragma unroll
          for (int i = 0; i < kM; ++i)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              a[i][u] = dvt[(ty + 16 * i) * kLdP + tx + 16 * u];
          for (int r = 0; r < nr; ++r) {
            float x[kM], y[4];
#pragma unroll
            for (int i = 0; i < kM; ++i) x[i] = Wt[r * ldr + ty + 16 * i];
#pragma unroll
            for (int u = 0; u < 4; ++u) y[u] = dyt[r * kLdP + tx + 16 * u];
#pragma unroll
            for (int i = 0; i < kM; ++i)
#pragma unroll
              for (int u = 0; u < 4; ++u) a[i][u] += x[i] * y[u];
          }
#pragma unroll
          for (int i = 0; i < kM; ++i)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              dvt[(ty + 16 * i) * kLdP + tx + 16 * u] = a[i][u];
        }
        for (int nb = 0; nb < N; nb += 64) {   // dk += D^T q, dq (+)= D k
          int nn[4];
          bool ok[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            nn[u] = nb + tx + 16 * u;
            ok[u] = nn[u] < N;
          }
          float a[kM][4], e[kM][4] = {};
#pragma unroll
          for (int i = 0; i < kM; ++i)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              a[i][u] = ok[u] ? dkt[(ty + 16 * i) * ldn + nn[u]] : 0.f;
          for (int r = 0; r < nr; ++r) {
            float x[kM], y[4];
#pragma unroll
            for (int i = 0; i < kM; ++i) x[i] = Dt[r * ldr + ty + 16 * i];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              y[u] = ok[u] ? qj[r * ldn + nn[u]] : 0.f;
#pragma unroll
            for (int i = 0; i < kM; ++i)
#pragma unroll
              for (int u = 0; u < 4; ++u) a[i][u] += x[i] * y[u];
          }
          for (int cc = 0; cc < nk; ++cc) {
            float x[kM], y[4];
#pragma unroll
            for (int i = 0; i < kM; ++i) x[i] = Dt[(ty + 16 * i) * ldr + cc];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              y[u] = ok[u] ? kt[cc * ldn + nn[u]] : 0.f;
#pragma unroll
            for (int i = 0; i < kM; ++i)
#pragma unroll
              for (int u = 0; u < 4; ++u) e[i][u] += x[i] * y[u];
          }
#pragma unroll
          for (int i = 0; i < kM; ++i) {
            const int r = ty + 16 * i, t = t0 + j0 + r;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (!ok[u]) continue;
              dkt[r * ldn + nn[u]] = a[i][u];
              if (r < nr && t >= 0) {
                float* o = dq_part + partN(t) + nn[u];
                *o = s0 == 0 ? e[i][u] : *o + e[i][u];
              }
            }
          }
        }
      }
      __syncthreads();
      for (int i = tid; i < nk * kPT; i += kThreads) {
        const int cc = i / kPT, p = i - cc * kPT, t = t0 + s0 + cc;
        if (t >= 0 && p < pw)
          dv[(static_cast<size_t>(b) * S + t) * H * P +
             static_cast<size_t>(h) * P + p0 + p] =
              repro::from_float<T>(dvt[cc * kLdP + p]);
      }
      for (int i = tid; i < nk * N; i += kThreads) {
        const int cc = i / N, n = i - cc * N, t = t0 + s0 + cc;
        if (t >= 0) dk_part[partN(t) + n] = dkt[cc * ldn + n];
      }
      for (int cc = warp; cc < nk; cc += kWarps) {       // k . dk
        float a = 0.f;
        for (int n = lane; n < N; n += 32)
          a += kt[cc * ldn + n] * dkt[cc * ldn + n];
        a = repro::warp_sum(a);
        if (lane == 0) {
          const int t = t0 + s0 + cc;
          if (t >= 0) dli_part[part1(t)] = a;
          dLa[s0 + cc] = -a;
        }
      }
    }

    // ---- row tiles: dq's carried-in part, q . dq, then dS and dn
    for (int j0 = 0; j0 < Q; j0 += R) {
      const int nr = min(R, Q - j0);
      __syncthreads();                       // qj, dyt free; dq rows written
      stage_f32<T>(qj, ldn, N, R, q + qb, qs.s, j0, t0, Q, N);
      for (int i = tid; i < R * kPT; i += kThreads) {
        const int r = i / kPT, p = i - r * kPT;
        const int j = j0 + r, t = t0 + j;
        dyt[r * kLdP + p] = j < Q && t >= 0 && p < pw
            ? dy[(static_cast<size_t>(b) * S + t) * H * P +
                 static_cast<size_t>(h) * P + p0 + p] : 0.f;
      }
      __syncthreads();
      const float* St = Sc + ((bh * nc + c) * P + p0) * N;   // [p][n]
      const float* nt = ncs + (bh * nc + c) * N;
      for (int r = warp; r < nr; r += kWarps) {
        const int j = j0 + r, t = t0 + j;
        float dot = 0.f;
        if (t >= 0) {
          const float cj = co[j];
          for (int n = lane; n < N; n += 32) {
            float* o = dq_part + partN(t) + n;
            float a = *o;
            if (carried) {
              float u = first_tile ? ddv[j] * nt[n] : 0.f;
              for (int p = 0; p < pw; ++p)
                u += dyt[r * kLdP + p] * St[p * N + n];
              a += cj * u;
              *o = a;
            }
            dot += qj[r * ldn + n] * a;
          }
        }
        dot = repro::warp_sum(dot);
        if (lane == 0) dLa[j] += dot;
      }
      if (c > 0) {                           // the previous chunk's dS, dn
        const float sc = j0 == 0 ? scale : 1.f;
        for (int nb = 0; nb < N; nb += 32) {
          int nn[2];
          bool ok[2];
          float a[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            nn[i] = nb + ty + 16 * i;
            ok[i] = nn[i] < N;
#pragma unroll
            for (int u = 0; u < 4; ++u)
              a[i][u] = ok[i] ? dS[nn[i] * kLdP + tx + 16 * u] * sc : 0.f;
          }
          for (int r = 0; r < nr; ++r) {
            float x[2], y[4];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              x[i] = ok[i] ? qj[r * ldn + nn[i]] : 0.f;
#pragma unroll
            for (int u = 0; u < 4; ++u)
              y[u] = co[j0 + r] * dyt[r * kLdP + tx + 16 * u];
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int u = 0; u < 4; ++u) a[i][u] += x[i] * y[u];
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (ok[i]) dS[nn[i] * kLdP + tx + 16 * u] = a[i][u];
        }
        if (first_tile) {
          for (int n = tid; n < N; n += kThreads) {
            float a = dn[n] * sc;
            for (int r = 0; r < nr; ++r)
              a += qj[r * ldn + n] * (co[j0 + r] * ddv[j0 + r]);
            dn[n] = a;
          }
        }
      }
    }
    __syncthreads();
    for (int j = tid; j < Q; j += kThreads) {
      const int t = t0 + j;
      if (t >= 0) dLa_part[part1(t)] = dLa[j] + (j == Q - 1 ? dla_sum : 0.f);
    }
  }
}

// The P tiles' partials summed in tile order: dq, dk cast to the input type,
// dlog_i, and dlog_a as the reverse cumsum of dLa inside each chunk.  The
// first eblocks blocks sum dq and dk, four consecutive elements a thread;
// each block after them one (chunk, head, batch) of the gates (dynamic
// shared memory: Q floats).
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_finish_kernel(
    const float* __restrict__ dq_part, const float* __restrict__ dk_part,
    const float* __restrict__ dLa_part, const float* __restrict__ dli_part,
    T* __restrict__ dq, T* __restrict__ dk, float* __restrict__ dla,
    float* __restrict__ dli, int B, int S, int H, int N, int Q, int pad,
    int ntiles, int eblocks) {
  const size_t bshN = static_cast<size_t>(B) * S * H * N;
  const size_t bsh = static_cast<size_t>(B) * S * H;
  if (static_cast<int>(blockIdx.x) < eblocks) {
    const size_t o = (static_cast<size_t>(blockIdx.x) * kThreads +
                      threadIdx.x) * 4;
    if (o >= bshN) return;
    float sq[4] = {0.f, 0.f, 0.f, 0.f}, sk[4] = {0.f, 0.f, 0.f, 0.f};
    const int ne = static_cast<int>(min(static_cast<size_t>(4), bshN - o));
    for (int tl = 0; tl < ntiles; ++tl) {
      const size_t base = tl * bshN + o;
      if (ne == 4 && N % 4 == 0) {           // 16-byte aligned
        const float4 a = *reinterpret_cast<const float4*>(dq_part + base);
        const float4 c = *reinterpret_cast<const float4*>(dk_part + base);
        sq[0] += a.x; sq[1] += a.y; sq[2] += a.z; sq[3] += a.w;
        sk[0] += c.x; sk[1] += c.y; sk[2] += c.z; sk[3] += c.w;
      } else {
        for (int e = 0; e < ne; ++e) {
          sq[e] += dq_part[base + e];
          sk[e] += dk_part[base + e];
        }
      }
    }
    for (int e = 0; e < ne; ++e) {
      dq[o + e] = repro::from_float<T>(sq[e]);
      dk[o + e] = repro::from_float<T>(sk[e]);
    }
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  float* a = reinterpret_cast<float*>(smem);
  const int nc = (S + pad) / Q;
  const int idx = blockIdx.x - eblocks;
  const int c = idx % nc, h = (idx / nc) % H, b = idx / (nc * H);
  const int t0 = c * Q - pad;
  for (int j = threadIdx.x; j < Q; j += kThreads) {
    const int t = t0 + j;
    float s = 0.f;
    if (t >= 0) {
      const size_t o = (static_cast<size_t>(b) * S + t) * H + h;
      float u = 0.f;
      for (int tl = 0; tl < ntiles; ++tl) {
        s += dLa_part[tl * bsh + o];
        u += dli_part[tl * bsh + o];
      }
      dli[o] = u;
    }
    a[j] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int j = Q - 1; j >= 0; --j) {
      run += a[j];
      const int t = t0 + j;
      if (t >= 0) dla[(static_cast<size_t>(b) * S + t) * H + h] = run;
    }
  }
}

// Launches the finish kernel: the dq, dk sums and the gates of every
// (chunk, head, batch).
template <typename T>
int launch_finish(const float* dq_part, const float* dk_part,
                  const float* dLa_part, const float* dli_part, void* dq,
                  void* dk, float* dla, float* dli, int B, int S, int H,
                  int N, int Q, int pad, int ntiles, cudaStream_t stream) {
  const size_t bshN = static_cast<size_t>(B) * S * H * N;
  const int eblocks = static_cast<int>((bshN + 4 * kThreads - 1) /
                                       (4 * kThreads));
  const int nc = (S + pad) / Q;
  ssd_bwd_finish_kernel<T><<<eblocks + nc * H * B, kThreads,
                             Q * sizeof(float), stream>>>(
      dq_part, dk_part, dLa_part, dli_part, static_cast<T*>(dq),
      static_cast<T*>(dk), dla, dli, B, S, H, N, Q, pad, ntiles, eblocks);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- mma route
// The bf16 tensor-core route (see the header).  R: rows of a row / key
// tile, 64, or 32 where N is large (xLSTM's 384); kW warps, 16 or 8: a
// tile's R / 16 strips of 16 rows, kWps warps a strip, each warp one
// column group of every product of its strip.

constexpr int kLdS = kPT + 4;     // dS row stride (floats): fragment reads
                                  // of either orientation hit 32 banks
constexpr int kLdV = kPT + 8;     // bf16 rows 64 wide (v, dy): 144 bytes,
                                  // ldmatrix rows on distinct banks

template <int R, int kW>
struct Mma {
  static constexpr int kStrips = R / 16;         // 16-row strips of a tile
  static constexpr int kWps = kW / kStrips;      // warps per strip
  static constexpr int kSN = R / 8 / kWps;       // score n8 tiles a warp
  static constexpr int kNV = kPT / 8 / kWps;     // dv n8 tiles a warp
  static constexpr int kMaxN = R == 64 ? 128 : 384;
  static constexpr int kNT = kMaxN / 8 / kWps;   // most dk / dq n8 tiles
  static constexpr int kLdW = R + 8;             // W / D row stride (bf16)
};
// the warps of a block: 16 with 64-row tiles, 8 with 32-row tiles
template <int R>
constexpr int kMmaWarps = R == 64 ? 16 : 8;
// the stages of a tiling: two with 64-row tiles (N <= 128 leaves room for
// the next operand tile), one with 32-row tiles (N up to 384)
constexpr int mma_stages(int R) { return R == 64 ? 2 : 1; }

// Byte offsets of the route's dynamic shared memory, the same on host and
// device (kernels/ssd_scan.py::ssd_bwd_plan mirrors it).  stages: the
// buffers of the operand that streams through a tile loop (q in the key
// tiles' loop, k and v in the row tiles'), 2 (the next one in flight) or 1.
struct MmaLayout {
  int Np, ldq, nq;
  size_t dS, dn, dyh, dyl, nbuf, vbuf, W, gates, bytes;
  __host__ __device__ MmaLayout(int N, int Q, int R, int stages, int warps) {
    const int wps = warps / (R / 16);
    Np = (N + 16 * wps - 1) / (16 * wps) * (16 * wps);
    ldq = Np + 8;
    nq = (Q + R - 1) / R;
    size_t o = 0;
    dS = o;
    o += static_cast<size_t>(Np) * kLdS * 4;
    dn = o;
    o += static_cast<size_t>(Np) * 4;
    dyh = o;
    o += static_cast<size_t>(nq) * R * kLdV * 2;
    dyl = o;
    o += static_cast<size_t>(nq) * R * kLdV * 2;
    nbuf = o;
    o += static_cast<size_t>(stages + 1) * R * ldq * 2;
    vbuf = o;
    o += static_cast<size_t>(stages) * R * kLdV * 2;
    W = o;
    o += static_cast<size_t>(4) * R * (R + 8) * 2;
    gates = o;  // La, log_i, m, co, z, dden, dLa [Q each], cumsum scratch,
                // warp sums, row partials [R][wps]
    o += (7 * static_cast<size_t>(Q) + Q / 8 + 32 + warps +
          static_cast<size_t>(R) * wps) * 4;
    bytes = o;
  }
};

// x[2] to o as bf16 where room >= 2 (one 4-byte store when aligned), else
// x[0] alone
__device__ __forceinline__ void put_bf16(bf16* o, int room, float x0,
                                         float x1) {
  if (room >= 2 && (reinterpret_cast<uintptr_t>(o) & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(x0, x1);
  } else {
    o[0] = __float2bfloat16(x0);
    if (room >= 2) o[1] = __float2bfloat16(x1);
  }
}

// B fragments of kSN n8 tiles (columns c0 + 8 nt) over k16 [k0, k0 + 16)
// from row-major [column][k] bf16 rows of stride ld, multiplied into d with
// A = a: the score products, whose B operand is a tile of rows.
template <int kSN>
__device__ __forceinline__ void mma_rows(float (&d)[kSN][4],
                                         const uint32_t (&a)[4],
                                         const bf16* src, int ld, int c0,
                                         int k0) {
  const int lane = threadIdx.x & 31;
  if constexpr (kSN == 1) {
    uint32_t b[2];
    repro::ssd::ldsm_x2(b, src + (c0 + (lane & 7)) * ld + k0 +
                               ((lane >> 3) & 1) * 8);
    repro::ssd::mma(d[0], a, b[0], b[1]);
  } else {
#pragma unroll
    for (int nt = 0; nt < kSN; nt += 2) {
      uint32_t b[4];
      repro::ssd::ldsm_x4(b, src + (c0 + nt * 8 + (lane & 7) +
                                    ((lane >> 4) & 1) * 8) * ld + k0 +
                                 ((lane >> 3) & 1) * 8);
      repro::ssd::mma(d[nt], a, b[0], b[1]);
      repro::ssd::mma(d[nt + 1], a, b[2], b[3]);
    }
  }
}

template <int R, int kW>
__global__ void __launch_bounds__(kW * 32, 1) ssd_bwd_mma_kernel(
    const bf16* __restrict__ q, Strides3 qs, const bf16* __restrict__ k,
    Strides3 ks, const bf16* __restrict__ v, Strides3 vs,
    const float* __restrict__ la, Strides3 las, const float* __restrict__ li,
    Strides3 lis, const float* __restrict__ mo, const float* __restrict__ Sc,
    const float* __restrict__ ncs, const float* __restrict__ Mcs,
    const float* __restrict__ Mf, int fresh, const float* __restrict__ dy,
    const float* __restrict__ dden, bf16* __restrict__ dv,
    bf16* __restrict__ dq, bf16* __restrict__ dk, float* __restrict__ dla,
    float* __restrict__ dli, float* __restrict__ dq_part,
    float* __restrict__ dk_part, float* __restrict__ dLa_part,
    float* __restrict__ dli_part, int B, int S, int H, int N, int P, int Q,
    int pad, int stages, int vec_qk, int vec_v, int vec_dy) {
  using C = Mma<R, kW>;
  constexpr int kT = kW * 32;
  using repro::ssd::ldsm_x4;
  using repro::ssd::ldsm_x4_t;
  using repro::ssd::mma;
  using repro::ssd::split2;
  constexpr int kWps = C::kWps, kSN = C::kSN, kNV = C::kNV, kNT = C::kNT;
  constexpr int kLdW = C::kLdW;
  const MmaLayout L(N, Q, R, stages, kW);
  const int Np = L.Np, ldq = L.ldq, nq = L.nq;
  const int tile = blockIdx.x, p0 = tile * kPT, h = blockIdx.y, b = blockIdx.z;
  const int pw = min(P - p0, kPT);           // valid columns of the tile
  const bool first_tile = tile == 0;         // owns the dden / dn terms
  const bool direct = gridDim.x == 1;        // one P tile: no partials
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = (warp / kWps) * 16;         // the warp's strip of a tile
  const int wc = warp % kWps;                // its column group
  const int sc0 = wc * (R / kWps);           // its score columns
  const int nc0 = wc * (Np / kWps);          // its dk / dq columns
  const int nts = Np / kWps / 8;             // their n8 tiles (even)
  const int pc0 = wc * (kPT / kWps);         // its dv columns
  extern __shared__ __align__(16) unsigned char smem[];
  float* dS = reinterpret_cast<float*>(smem + L.dS);     // [Np][kLdS]
  float* dn = reinterpret_cast<float*>(smem + L.dn);     // [Np]
  bf16* dyh = reinterpret_cast<bf16*>(smem + L.dyh);     // [nq R][kLdV]
  bf16* dyl = reinterpret_cast<bf16*>(smem + L.dyl);     // its remainder
  bf16* nbuf = reinterpret_cast<bf16*>(smem + L.nbuf);   // [R][ldq] each
  bf16* vbuf = reinterpret_cast<bf16*>(smem + L.vbuf);   // [R][kLdV] each
  bf16* Wh = reinterpret_cast<bf16*>(smem + L.W);        // [R][kLdW] each
  bf16* Wl = Wh + R * kLdW;
  bf16* Dh = Wl + R * kLdW;
  bf16* Dl = Dh + R * kLdW;
  float* La = reinterpret_cast<float*>(smem + L.gates);  // [Q] cumsum
  float* lg = La + Q;                        // [Q] log_i
  float* mr = lg + Q;                        // [Q] the forward's row log-max
  float* co = mr + Q;                        // [Q] carried-in coefficients
  float* zc = co + Q;                        // [Q] carry weights
  float* ddv = zc + Q;                       // [Q] dden
  float* dLa = ddv + Q;                      // [Q] dLa of this P tile
  float* scratch = dLa + Q;                  // cumsum block totals
  float* red = scratch + Q / 8 + 32;         // [kW] block sums
  float* rowp = red + kW;                    // [R][kWps] row dot partials
  auto nb = [&](int i) { return nbuf + i * R * ldq; };
  auto vbi = [&](int i) { return vbuf + i * R * kLdV; };

  const size_t bh = static_cast<size_t>(b) * H + h;
  const long long qb = b * qs.b + h * qs.h, kb = b * ks.b + h * ks.h;
  const long long vb = b * vs.b + h * vs.h + p0;
  const long long lab = b * las.b + h * las.h, lib = b * lis.b + h * lis.h;
  const int nc = (S + pad) / Q;
  const size_t part = static_cast<size_t>(tile) * B;     // partials' base
  auto row1 = [&](int t) { return (static_cast<size_t>(b) * S + t) * H + h; };
  auto part1 = [&](int t) { return ((part + b) * S + t) * H + h; };

  // Row dot products of a (16-row strip) x (the warp's columns) accumulator
  // with the bf16 rows x (stride ldq): quad sums into rowp, one entry per
  // (row, column group); the caller synchronises and adds them in order.
  auto row_dots = [&](const float (&acc)[kNT][4], const bf16* x) {
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      if (nt < nts) {
        const int n = nc0 + nt * 8 + 2 * t4;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 xx = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  x + (r0 + g + hh * 8) * ldq + n));
          s[hh] += acc[nt][hh * 2] * xx.x + acc[nt][hh * 2 + 1] * xx.y;
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], 1);
      s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], 2);
      if (t4 == 0) rowp[(r0 + g + hh * 8) * kWps + wc] = s[hh];
    }
  };
  // An N-wide accumulator's rows (tile rows from chunk row j0) out: the
  // input type where there is one P tile, else float32 partials.
  auto store_n = [&](const float (&acc)[kNT][4], int j0, int t0, bf16* out,
                     float* out_part) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      if (nt < nts) {
        const int n = nc0 + nt * 8 + 2 * t4;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = j0 + r0 + g + hh * 8, t = t0 + j;
          if (j < Q && t >= 0 && n < N) {
            const float x0 = acc[nt][hh * 2], x1 = acc[nt][hh * 2 + 1];
            if (direct) {
              put_bf16(out + row1(t) * N + n, N - n, x0, x1);
            } else {
              float* o = out_part + ((part + b) * S + t) * H * N +
                         static_cast<size_t>(h) * N + n;
              o[0] = x0;
              if (n + 1 < N) o[1] = x1;
            }
          }
        }
      }
    }
  };

  // the final state is not differentiable: dS = dn = 0 after the last chunk
  for (int i = tid; i < Np * kLdS; i += kT) dS[i] = 0.f;
  for (int n = tid; n < Np; n += kT) dn[n] = 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * Q - pad;              // real position of chunk row 0
    const bool carried = c > 0 || !fresh;    // a non-zero carried-in state
    __syncthreads();                         // the previous chunk is done
    // dy of the chunk, split once into bf16 head and remainder rows (pad
    // rows, rows past Q and columns past the tile zero)
    for (int i = tid; i < nq * R * (kPT / 4); i += kT) {
      const int j = i / (kPT / 4), c4 = (i - j * (kPT / 4)) * 4;
      const int t = t0 + j;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < Q && t >= 0) {
        const float* src = dy + row1(t) * P + p0 + c4;
        if (vec_dy && c4 + 4 <= pw) {
          x = *reinterpret_cast<const float4*>(src);
        } else {
          x.x = c4 < pw ? src[0] : 0.f;
          x.y = c4 + 1 < pw ? src[1] : 0.f;
          x.z = c4 + 2 < pw ? src[2] : 0.f;
          x.w = c4 + 3 < pw ? src[3] : 0.f;
        }
      }
      uint2 hi, lo;
      hi.x = split2(x.x, x.y, lo.x);
      hi.y = split2(x.z, x.w, lo.y);
      *reinterpret_cast<uint2*>(dyh + j * kLdV + c4) = hi;
      *reinterpret_cast<uint2*>(dyl + j * kLdV + c4) = lo;
    }
    for (int j = tid; j < Q; j += kT) {
      const int t = t0 + j;
      const bool in = t >= 0;
      La[j] = in ? la[lab + t * las.s] : 0.f;
      lg[j] = in ? li[lib + t * lis.s] : repro::kNeg;
      mr[j] = in ? mo[row1(t)] : 0.f;
      ddv[j] = in && dden != nullptr ? dden[row1(t)] : 0.f;
    }
    __syncthreads();
    repro::ssd::cumsum_blocked<kT>(La, Q, scratch);
    const float M = Mcs[bh * nc + c];
    const float m_new = c + 1 < nc ? Mcs[bh * nc + c + 1] : Mf[bh];
    const float la_sum = La[Q - 1];
    const float scale = expf(fminf(la_sum + M - m_new, 0.f));
    for (int j = tid; j < Q; j += kT) {
      const bool in = t0 + j >= 0;
      co[j] = in && carried ? expf(La[j] + M - mr[j]) : 0.f;
      zc[j] = in ? expf(la_sum - La[j] + lg[j] - m_new) : 0.f;
    }
    // d la_sum from the carry: <dS, S~'> + <dn, n~'>
    float acc0 = 0.f;
    if (c + 1 < nc) {
      const float* Sn = Sc + ((bh * nc + c + 1) * P + p0) * N;
      for (int i = tid; i < pw * N; i += kT) {
        const int p = i / N, n = i - p * N;
        acc0 += dS[n * kLdS + p] * Sn[i];
      }
      if (first_tile)
        for (int n = tid; n < N; n += kT)
          acc0 += dn[n] * ncs[(bh * nc + c + 1) * N + n];
    }
    const float dla_sum = block_sum<kW>(acc0, red);  // publishes the gates

    // ---- key tiles: dk, dv in registers; W^T and D^T per row tile
    for (int ti = 0; ti < nq; ++ti) {
      const int s0 = ti * R;
      const bf16* kt = nb(0);
      const bf16* vt = vbi(0);
      __syncthreads();                       // every tile buffer free
      repro::ssd::stage<kT>(nb(0), ldq, Np, R, k + kb, ks.s, s0, t0, Q, N,
                            vec_qk != 0);
      repro::ssd::stage<kT>(vbi(0), kLdV, kPT, R, v + vb, vs.s, s0, t0, Q, pw,
                            vec_v != 0);
      repro::ssd::stage<kT>(nb(1), ldq, Np, R, q + qb, qs.s, s0, t0, Q, N,
                            vec_qk != 0);
      repro::attn::cp_async_commit();
      repro::attn::cp_async_wait<0>();
      __syncthreads();
      float dka[kNT][4], dva[kNV][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[nt][e] = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNV; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dva[nt][e] = 0.f;
      if (c + 1 < nc) {                      // the carry: k dS, v dS^T
        for (int k0 = 0; k0 < Np; k0 += 16) {
          uint32_t a[4];
          ldsm_x4(a, kt + (r0 + (lane & 15)) * ldq + k0 + (lane >> 4) * 8);
          const float* d0 = dS + (k0 + 2 * t4) * kLdS + pc0 + g;
#pragma unroll
          for (int nt = 0; nt < kNV; ++nt) {
            const float* d = d0 + nt * 8;
            uint32_t l0, l1;
            const uint32_t h0 = split2(d[0], d[kLdS], l0);
            const uint32_t h1 = split2(d[8 * kLdS], d[9 * kLdS], l1);
            mma(dva[nt], a, h0, h1);
            mma(dva[nt], a, l0, l1);
          }
        }
        for (int k0 = 0; k0 < kPT; k0 += 16) {
          uint32_t a[4];
          ldsm_x4(a, vt + (r0 + (lane & 15)) * kLdV + k0 + (lane >> 4) * 8);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            if (nt < nts) {
              const float* d = dS + (nc0 + nt * 8 + g) * kLdS + k0 + 2 * t4;
              const float2 x0 = *reinterpret_cast<const float2*>(d);
              const float2 x1 = *reinterpret_cast<const float2*>(d + 8);
              uint32_t l0, l1;
              const uint32_t h0 = split2(x0.x, x0.y, l0);
              const uint32_t h1 = split2(x1.x, x1.y, l1);
              mma(dka[nt], a, h0, h1);
              mma(dka[nt], a, l0, l1);
            }
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {       // z_s (.. + dn)
        const int s = s0 + r0 + g + hh * 8;
        const float z = s < Q ? zc[s] : 0.f;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = nc0 + nt * 8 + 2 * t4 + e;
            float& x = dka[nt][hh * 2 + e];
            x = (x + (first_tile && nt < nts ? dn[n] : 0.f)) * z;
          }
#pragma unroll
        for (int nt = 0; nt < kNV; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) dva[nt][hh * 2 + e] *= z;
      }

      for (int tj = ti; tj < nq; ++tj) {
        const int j0 = tj * R, u = tj - ti;
        const bf16* qt = nb(stages == 2 ? 1 + (u & 1) : 1);
        if (u > 0) {
          repro::attn::cp_async_wait<0>();
          __syncthreads();                   // q_j in; W, D free
        }
        if (stages == 2 && tj + 1 < nq) {
          repro::ssd::stage<kT>(nb(1 + ((u + 1) & 1)), ldq, Np, R, q + qb,
                                qs.s, j0 + R, t0, Q, N, vec_qk != 0);
          repro::attn::cp_async_commit();
        }
        {                                    // S^T = k q^T, dP^T = v dy^T
          float st[kSN][4], dp[kSN][4];
#pragma unroll
          for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) st[nt][e] = dp[nt][e] = 0.f;
          for (int k0 = 0; k0 < Np; k0 += 16) {
            uint32_t a[4];
            ldsm_x4(a, kt + (r0 + (lane & 15)) * ldq + k0 + (lane >> 4) * 8);
            mma_rows<kSN>(st, a, qt, ldq, sc0, k0);
          }
          for (int k0 = 0; k0 < kPT; k0 += 16) {
            uint32_t a[4];
            ldsm_x4(a, vt + (r0 + (lane & 15)) * kLdV + k0 + (lane >> 4) * 8);
            mma_rows<kSN>(dp, a, dyh + j0 * kLdV, kLdV, sc0, k0);
            mma_rows<kSN>(dp, a, dyl + j0 * kLdV, kLdV, sc0, k0);
          }
#pragma unroll
          for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int rl = r0 + g + hh * 8, s = s0 + rl;
              const int cl = sc0 + nt * 8 + 2 * t4;
              float w[2], d[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int j = j0 + cl + e;
                w[e] = d[e] = 0.f;
                if (s <= j && j < Q && t0 + j >= 0) {
                  const float Cf = expf(La[j] - La[s] + lg[s] - mr[j]);
                  w[e] = st[nt][hh * 2 + e] * Cf;
                  d[e] = (dp[nt][hh * 2 + e] + (first_tile ? ddv[j] : 0.f)) *
                         Cf;
                }
              }
              uint32_t lo;
              uint32_t hi = split2(w[0], w[1], lo);
              *reinterpret_cast<uint32_t*>(Wh + rl * kLdW + cl) = hi;
              *reinterpret_cast<uint32_t*>(Wl + rl * kLdW + cl) = lo;
              hi = split2(d[0], d[1], lo);
              *reinterpret_cast<uint32_t*>(Dh + rl * kLdW + cl) = hi;
              *reinterpret_cast<uint32_t*>(Dl + rl * kLdW + cl) = lo;
            }
        }
        __syncthreads();                     // W^T, D^T of the pair
        // dv += W^T dy (3 products), dk += D^T q (2), over the rows j; on
        // the diagonal the rows before the strip's first key are all zero
        const int kend = min(R, (Q - j0 + 15) / 16 * 16);
        for (int k0 = u == 0 ? r0 : 0; k0 < kend; k0 += 16) {
          uint32_t ah[4], al[4];
          ldsm_x4(ah, Wh + (r0 + (lane & 15)) * kLdW + k0 + (lane >> 4) * 8);
          ldsm_x4(al, Wl + (r0 + (lane & 15)) * kLdW + k0 + (lane >> 4) * 8);
          const int yo = (j0 + k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             kLdV + pc0 + (lane >> 4) * 8;
#pragma unroll
          for (int nt = 0; nt < kNV; nt += 2) {
            uint32_t bh[4], bl[4];
            ldsm_x4_t(bh, dyh + yo + nt * 8);
            ldsm_x4_t(bl, dyl + yo + nt * 8);
            mma(dva[nt], ah, bh[0], bh[1]);
            mma(dva[nt], ah, bl[0], bl[1]);
            mma(dva[nt], al, bh[0], bh[1]);
            mma(dva[nt + 1], ah, bh[2], bh[3]);
            mma(dva[nt + 1], ah, bl[2], bl[3]);
            mma(dva[nt + 1], al, bh[2], bh[3]);
          }
          ldsm_x4(ah, Dh + (r0 + (lane & 15)) * kLdW + k0 + (lane >> 4) * 8);
          ldsm_x4(al, Dl + (r0 + (lane & 15)) * kLdW + k0 + (lane >> 4) * 8);
          const bf16* qp = qt + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                    ldq + nc0 + (lane >> 4) * 8;
#pragma unroll
          for (int nt = 0; nt < kNT; nt += 2) {
            if (nt < nts) {
              uint32_t bq[4];
              ldsm_x4_t(bq, qp + nt * 8);
              mma(dka[nt], ah, bq[0], bq[1]);
              mma(dka[nt], al, bq[0], bq[1]);
              mma(dka[nt + 1], ah, bq[2], bq[3]);
              mma(dka[nt + 1], al, bq[2], bq[3]);
            }
          }
        }
        if (stages == 1 && tj + 1 < nq) {
          __syncthreads();                   // q_j read by every warp
          repro::ssd::stage<kT>(nb(1), ldq, Np, R, q + qb, qs.s, j0 + R, t0, Q,
                                N, vec_qk != 0);
          repro::attn::cp_async_commit();
        }
      }
      // the key tile's dk, dv out; k . dk gives dlog_i and -dLa
      row_dots(dka, kt);
      store_n(dka, s0, t0, dk, dk_part);
#pragma unroll
      for (int nt = 0; nt < kNV; ++nt) {
        const int p = pc0 + nt * 8 + 2 * t4;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int s = s0 + r0 + g + hh * 8, t = t0 + s;
          if (s < Q && t >= 0 && p < pw)
            put_bf16(dv + row1(t) * P + p0 + p, pw - p, dva[nt][hh * 2],
                     dva[nt][hh * 2 + 1]);
        }
      }
      __syncthreads();
      if (tid < R && s0 + tid < Q) {
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < kWps; ++w) a += rowp[tid * kWps + w];
        const int s = s0 + tid, t = t0 + s;
        dLa[s] = -a;
        if (t >= 0) {
          if (direct) dli[row1(t)] = a;
          else dli_part[part1(t)] = a;
        }
      }
    }

    // ---- row tiles: dq in registers (carried-in term, then D k per key
    // tile), q . dq, then the previous chunk's dS and dn
    const float* St = Sc + ((bh * nc + c) * P + p0) * N;   // [p][n]
    const float* nt_in = ncs + (bh * nc + c) * N;
    for (int tj = 0; tj < nq; ++tj) {
      const int j0 = tj * R;
      const bf16* qt = nb(0);
      __syncthreads();                       // every tile buffer free
      repro::ssd::stage<kT>(nb(0), ldq, Np, R, q + qb, qs.s, j0, t0, Q, N,
                            vec_qk != 0);
      repro::ssd::stage<kT>(nb(1), ldq, Np, R, k + kb, ks.s, 0, t0, Q, N,
                            vec_qk != 0);
      repro::ssd::stage<kT>(vbi(0), kLdV, kPT, R, v + vb, vs.s, 0, t0, Q, pw,
                            vec_v != 0);
      repro::attn::cp_async_commit();
      float dqa[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[nt][e] = 0.f;
      if (carried) {                         // co_j (dy_j S~ + dden_j n~)
        for (int k0 = 0; k0 < kPT; k0 += 16) {
          uint32_t ah[4], al[4];
          const int ao = (j0 + r0 + (lane & 15)) * kLdV + k0 + (lane >> 4) * 8;
          ldsm_x4(ah, dyh + ao);
          ldsm_x4(al, dyl + ao);
          const int pp = k0 + 2 * t4;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            if (nt < nts) {
              const int n = nc0 + nt * 8 + g;
              float x[4] = {0.f, 0.f, 0.f, 0.f};
              if (n < N) {
                const float* sp = St + n;
                x[0] = pp < pw ? sp[static_cast<size_t>(pp) * N] : 0.f;
                x[1] = pp + 1 < pw ? sp[static_cast<size_t>(pp + 1) * N] : 0.f;
                x[2] = pp + 8 < pw ? sp[static_cast<size_t>(pp + 8) * N] : 0.f;
                x[3] = pp + 9 < pw ? sp[static_cast<size_t>(pp + 9) * N] : 0.f;
              }
              uint32_t l0, l1;
              const uint32_t h0 = split2(x[0], x[1], l0);
              const uint32_t h1 = split2(x[2], x[3], l1);
              mma(dqa[nt], ah, h0, h1);
              mma(dqa[nt], ah, l0, l1);
              mma(dqa[nt], al, h0, h1);
            }
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = j0 + r0 + g + hh * 8;
          const float cj = j < Q ? co[j] : 0.f;
          const float dd = j < Q && first_tile ? ddv[j] : 0.f;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = nc0 + nt * 8 + 2 * t4 + e;
              float& x = dqa[nt][hh * 2 + e];
              x = cj * (x + (dd != 0.f && n < N ? dd * nt_in[n] : 0.f));
            }
        }
      }
      for (int ti = 0; ti <= tj; ++ti) {
        const int s0 = ti * R;
        const bf16* kt = nb(stages == 2 ? 1 + (ti & 1) : 1);
        const bf16* vt = vbi(stages == 2 ? (ti & 1) : 0);
        repro::attn::cp_async_wait<0>();
        __syncthreads();                     // k_s, v_s in; D free
        if (stages == 2 && ti < tj) {
          repro::ssd::stage<kT>(nb(1 + ((ti + 1) & 1)), ldq, Np, R, k + kb,
                                ks.s, s0 + R, t0, Q, N, vec_qk != 0);
          repro::ssd::stage<kT>(vbi((ti + 1) & 1), kLdV, kPT, R, v + vb,
                                vs.s, s0 + R, t0, Q, pw, vec_v != 0);
          repro::attn::cp_async_commit();
        }
        {                                    // dP = dy v^T, D
          float dp[kSN][4];
#pragma unroll
          for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) dp[nt][e] = 0.f;
          for (int k0 = 0; k0 < kPT; k0 += 16) {
            uint32_t ah[4], al[4];
            const int ao = (j0 + r0 + (lane & 15)) * kLdV + k0 +
                           (lane >> 4) * 8;
            ldsm_x4(ah, dyh + ao);
            ldsm_x4(al, dyl + ao);
            mma_rows<kSN>(dp, ah, vt, kLdV, sc0, k0);
            mma_rows<kSN>(dp, al, vt, kLdV, sc0, k0);
          }
#pragma unroll
          for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int rl = r0 + g + hh * 8, j = j0 + rl;
              const int cl = sc0 + nt * 8 + 2 * t4;
              float d[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int s = s0 + cl + e;
                d[e] = 0.f;
                if (s <= j && j < Q && t0 + j >= 0)
                  d[e] = (dp[nt][hh * 2 + e] + (first_tile ? ddv[j] : 0.f)) *
                         expf(La[j] - La[s] + lg[s] - mr[j]);
              }
              uint32_t lo;
              const uint32_t hi = split2(d[0], d[1], lo);
              *reinterpret_cast<uint32_t*>(Dh + rl * kLdW + cl) = hi;
              *reinterpret_cast<uint32_t*>(Dl + rl * kLdW + cl) = lo;
            }
        }
        __syncthreads();                     // D of the pair
        // dq += D k over the keys; on the diagonal none past the strip
        const int kend = min(ti == tj ? r0 + 16 : R, (Q - s0 + 15) / 16 * 16);
        for (int k0 = 0; k0 < kend; k0 += 16) {
          uint32_t ah[4], al[4];
          ldsm_x4(ah, Dh + (r0 + (lane & 15)) * kLdW + k0 + (lane >> 4) * 8);
          ldsm_x4(al, Dl + (r0 + (lane & 15)) * kLdW + k0 + (lane >> 4) * 8);
          const bf16* kp = kt + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                    ldq + nc0 + (lane >> 4) * 8;
#pragma unroll
          for (int nt = 0; nt < kNT; nt += 2) {
            if (nt < nts) {
              uint32_t bk[4];
              ldsm_x4_t(bk, kp + nt * 8);
              mma(dqa[nt], ah, bk[0], bk[1]);
              mma(dqa[nt], al, bk[0], bk[1]);
              mma(dqa[nt + 1], ah, bk[2], bk[3]);
              mma(dqa[nt + 1], al, bk[2], bk[3]);
            }
          }
        }
        if (stages == 1 && ti < tj) {
          __syncthreads();                   // k_s, v_s read by every warp
          repro::ssd::stage<kT>(nb(1), ldq, Np, R, k + kb, ks.s, s0 + R, t0, Q,
                                N, vec_qk != 0);
          repro::ssd::stage<kT>(vbi(0), kLdV, kPT, R, v + vb, vs.s, s0 + R, t0,
                                Q, pw, vec_v != 0);
          repro::attn::cp_async_commit();
        }
      }
      row_dots(dqa, qt);
      store_n(dqa, j0, t0, dq, dq_part);
      __syncthreads();
      if (tid < R && j0 + tid < Q) {
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < kWps; ++w) a += rowp[tid * kWps + w];
        dLa[j0 + tid] += a;
      }
      if (c > 0) {             // dS = scale dS + q^T (co o dy) (3 products)
        const float sc = tj == 0 ? scale : 1.f;
        const int kend = min(R, (Q - j0 + 15) / 16 * 16);
        for (int st = warp; st < Np / 16; st += kW) {
          float acc[kPT / 8][4];
#pragma unroll
          for (int nt = 0; nt < kPT / 8; ++nt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float2 x = *reinterpret_cast<const float2*>(
                  dS + (st * 16 + g + hh * 8) * kLdS + nt * 8 + 2 * t4);
              acc[nt][hh * 2] = x.x * sc;
              acc[nt][hh * 2 + 1] = x.y * sc;
            }
          for (int k0 = 0; k0 < kend; k0 += 16) {
            uint32_t a[4], ah[4], al[4];
            const int m = lane >> 3;
            ldsm_x4_t(a, qt + (k0 + (lane & 7) + (m >> 1) * 8) * ldq +
                             st * 16 + (m & 1) * 8);
            const int j = j0 + k0 + 2 * t4;
            const float c0 = j < Q ? co[j] : 0.f;
            const float c1 = j + 1 < Q ? co[j + 1] : 0.f;
            const float c2 = j + 8 < Q ? co[j + 8] : 0.f;
            const float c3 = j + 9 < Q ? co[j + 9] : 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i) {   // bf16 pair -> f32, exactly
              const float x = __uint_as_float(a[i] << 16);
              const float y = __uint_as_float(a[i] & 0xffff0000u);
              ah[i] = i < 2 ? split2(x * c0, y * c1, al[i])
                            : split2(x * c2, y * c3, al[i]);
            }
            const int yo = (j0 + k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               kLdV + (lane >> 4) * 8;
#pragma unroll
            for (int nt = 0; nt < kPT / 8; nt += 2) {
              uint32_t bh[4], bl[4];
              ldsm_x4_t(bh, dyh + yo + nt * 8);
              ldsm_x4_t(bl, dyl + yo + nt * 8);
              mma(acc[nt], ah, bh[0], bh[1]);
              mma(acc[nt], ah, bl[0], bl[1]);
              mma(acc[nt], al, bh[0], bh[1]);
              mma(acc[nt + 1], ah, bh[2], bh[3]);
              mma(acc[nt + 1], ah, bl[2], bl[3]);
              mma(acc[nt + 1], al, bh[2], bh[3]);
            }
          }
#pragma unroll
          for (int nt = 0; nt < kPT / 8; ++nt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              *reinterpret_cast<float2*>(
                  dS + (st * 16 + g + hh * 8) * kLdS + nt * 8 + 2 * t4) =
                  make_float2(acc[nt][hh * 2], acc[nt][hh * 2 + 1]);
        }
        if (first_tile) {
          const int nr = min(R, Q - j0);
          for (int n = tid; n < N; n += kT) {
            float a = dn[n] * sc;
            for (int r = 0; r < nr; ++r)
              a += __bfloat162float(qt[r * ldq + n]) *
                   (co[j0 + r] * ddv[j0 + r]);
            dn[n] = a;
          }
        }
      }
    }
    __syncthreads();                         // dLa of the chunk complete
    if (!direct) {
      for (int j = tid; j < Q; j += kT) {
        const int t = t0 + j;
        if (t >= 0)
          dLa_part[part1(t)] = dLa[j] + (j == Q - 1 ? dla_sum : 0.f);
      }
    } else if (warp == 0) {                  // dlog_a: dLa's reverse cumsum
      float run = 0.f;
      for (int top = Q - 1; top >= 0; top -= 32) {
        const int j = top - lane;
        float x = j >= 0 ? dLa[j] + (j == Q - 1 ? dla_sum : 0.f) : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float y = __shfl_up_sync(0xffffffffu, x, o);
          if (lane >= o) x += y;
        }
        x += run;
        if (j >= 0 && t0 + j >= 0) dla[row1(t0 + j)] = x;
        run = __shfl_sync(0xffffffffu, x, 31);
      }
    }
  }
}

template <typename T>
int launch_cuda_cores(const void* q, Strides3 qs, const void* k, Strides3 ks,
                      const void* v, Strides3 vs, const float* la,
                      Strides3 las, const float* li, Strides3 lis,
                      const float* m, const float* Sc, const float* ncs,
                      const float* Mcs, const float* Mf, int fresh,
                      const float* dy, const float* dden, void* dv,
                      float* dq_part, float* dk_part, float* dLa_part,
                      float* dli_part, void* dq, void* dk, float* dla,
                      float* dli, int B, int S, int H, int N, int P, int Q,
                      int pad, cudaStream_t stream) {
  cudaError_t err = repro::attn::allow_smem<ssd_bwd_kernel<T, 32>>();
  if (err == cudaSuccess)
    err = repro::attn::allow_smem<ssd_bwd_kernel<T, 16>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, optin = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the widest row tile whose shared memory fits
  const bool wide = Layout(N, Q, 32).bytes <= static_cast<size_t>(optin);
  const Layout L(N, Q, wide ? 32 : 16);
  if (L.bytes > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = (P + kPT - 1) / kPT;
  auto kernel = wide ? ssd_bwd_kernel<T, 32> : ssd_bwd_kernel<T, 16>;
  kernel<<<dim3(ntiles, H, B), kThreads, L.bytes, stream>>>(
      static_cast<const T*>(q), qs, static_cast<const T*>(k), ks,
      static_cast<const T*>(v), vs, la, las, li, lis, m, Sc, ncs, Mcs, Mf,
      fresh, dy, dden, static_cast<T*>(dv), dq_part, dk_part, dLa_part,
      dli_part, B, S, H, N, P, Q, pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_finish<T>(dq_part, dk_part, dLa_part, dli_part, dq, dk, dla,
                          dli, B, S, H, N, Q, pad, ntiles, stream);
}

// The mma route with R rows a tile (the host plan's): 64 rows with two
// stages, or 32 with one.
int launch_mma(int R, const void* q, Strides3 qs, const void* k,
               Strides3 ks, const void* v, Strides3 vs, const float* la,
               Strides3 las, const float* li, Strides3 lis, const float* m,
               const float* Sc, const float* ncs, const float* Mcs,
               const float* Mf, int fresh, const float* dy,
               const float* dden, void* dv, float* dq_part, float* dk_part,
               float* dLa_part, float* dli_part, void* dq, void* dk,
               float* dla, float* dli, int B, int S, int H, int N, int P,
               int Q, int pad, cudaStream_t stream) {
  constexpr int kW64 = kMmaWarps<64>, kW32 = kMmaWarps<32>;
  cudaError_t err = repro::attn::allow_smem<ssd_bwd_mma_kernel<64, kW64>>();
  if (err == cudaSuccess)
    err = repro::attn::allow_smem<ssd_bwd_mma_kernel<32, kW32>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, optin = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = R == 64 ? kW64 : kW32;
  const int stages = mma_stages(R);
  const MmaLayout L(N, Q, R, stages, warps);
  const int max_n = R == 64 ? Mma<64, kW64>::kMaxN : Mma<32, kW32>::kMaxN;
  if (N > max_n || L.bytes > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec_qk = al16(q) && al16(k) && N % 8 == 0 && qs.b % 8 == 0 &&
                      qs.s % 8 == 0 && qs.h % 8 == 0 && ks.b % 8 == 0 &&
                      ks.s % 8 == 0 && ks.h % 8 == 0;
  const bool vec_v = al16(v) && P % 8 == 0 && vs.b % 8 == 0 &&
                     vs.s % 8 == 0 && vs.h % 8 == 0;
  const bool vec_dy = al16(dy) && P % 4 == 0;
  const int ntiles = (P + kPT - 1) / kPT;
  auto kernel = R == 64 ? ssd_bwd_mma_kernel<64, kW64>
                         : ssd_bwd_mma_kernel<32, kW32>;
  kernel<<<dim3(ntiles, H, B), warps * 32, L.bytes, stream>>>(
      static_cast<const bf16*>(q), qs, static_cast<const bf16*>(k), ks,
      static_cast<const bf16*>(v), vs, la, las, li, lis, m, Sc, ncs, Mcs, Mf,
      fresh, dy, dden, static_cast<bf16*>(dv), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), dla, dli, dq_part, dk_part, dLa_part,
      dli_part, B, S, H, N, P, Q, pad, stages, vec_qk ? 1 : 0, vec_v ? 1 : 0,
      vec_dy ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess || ntiles == 1) return static_cast<int>(err);
  return launch_finish<bf16>(dq_part, dk_part, dLa_part, dli_part, dq, dk,
                             dla, dli, B, S, H, N, Q, pad, ntiles, stream);
}

}  // namespace

// kind: the route (kernels/ssd_scan.py::ssd_bwd_plan): 0 = float32 on the
// CUDA cores, 1 = bfloat16 on the CUDA cores, 2 / 3 = bfloat16 on the
// tensor cores with 64-row tiles and two stages / 32-row tiles and one.  q, k (B, S, H, N), v (B, S, H, P), log_a, log_i (B, S, H):
// the forward's inputs (float32 or, as kind says, bfloat16), element
// strides over (b, position, head), last dim contiguous.  m (B, S, H): the
// forward's row log-max; Sc (B, H, nc, P, N), ncs (B, H, nc, N), Mcs (B, H,
// nc): each chunk's carried-in state, saved by the forward
// (repro_ssd_chunk_scan); Mf (B, H) its final log-max; fresh: 1 if the
// forward started from a zero state.  dy (B, S, H, P) and dden (B, S, H, or
// null for zeros): contiguous float32 gradients of y_num and den.  Outputs,
// contiguous: dv, dq, dk in the input type, dla, dli float32 (B, S, H);
// scratch: dq_part, dk_part (ntiles, B, S, H, N), dLa_part, dli_part
// (ntiles, B, S, H) float32, ntiles = ceil(P / 64) (unused, and may be
// null, on the tensor-core route with one P tile).  Q is the chunk length
// and pad = (-S) mod Q the front padding.  Launches the kernels on the
// stream; returns a cudaError_t as int (cudaErrorInvalidValue also when
// the route's tiles do not fit in shared memory).
REPRO_EXPORT int repro_ssd_chunk_scan_bwd(
    int kind, const void* q, long long q_sb, long long q_ss, long long q_sh,
    const void* k, long long k_sb, long long k_ss, long long k_sh,
    const void* v, long long v_sb, long long v_ss, long long v_sh,
    const float* la, long long la_sb, long long la_ss, long long la_sh,
    const float* li, long long li_sb, long long li_ss, long long li_sh,
    const float* m, const float* Sc, const float* ncs, const float* Mcs,
    const float* Mf, int fresh, const float* dy, const float* dden, void* dv,
    float* dq_part, float* dk_part, float* dLa_part, float* dli_part,
    void* dq, void* dk, float* dla, float* dli, int B, int S, int H, int N,
    int P, int Q, int pad, void* stream) {
  if (Q < 1 || S < 1 || N < 1 || P < 1 || pad < 0 || (S + pad) % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides3 qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, las{la_sb, la_ss, la_sh}, lis{li_sb, li_ss, li_sh};
  auto s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return launch_cuda_cores<float>(q, qs, k, ks, v, vs, la, las, li, lis, m,
                                    Sc, ncs, Mcs, Mf, fresh, dy, dden, dv,
                                    dq_part, dk_part, dLa_part, dli_part, dq,
                                    dk, dla, dli, B, S, H, N, P, Q, pad, s);
  if (kind == 1)
    return launch_cuda_cores<bf16>(q, qs, k, ks, v, vs, la, las, li, lis, m,
                                   Sc, ncs, Mcs, Mf, fresh, dy, dden, dv,
                                   dq_part, dk_part, dLa_part, dli_part, dq,
                                   dk, dla, dli, B, S, H, N, P, Q, pad, s);
  if (kind == 2 || kind == 3)
    return launch_mma(kind == 2 ? 64 : 32, q, qs, k, ks, v, vs, la, las, li,
                      lis, m, Sc, ncs, Mcs, Mf, fresh, dy, dden, dv, dq_part,
                      dk_part, dLa_part, dli_part, dq, dk, dla, dli, B, S, H,
                      N, P, Q, pad, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory, in bytes, of the main kernel of route kind
// (as above) with rows-row tiles at state width N and chunk length Q: the
// layouts the launches use, which kernels/ssd_scan.py::ssd_bwd_plan
// mirrors on the host; -1 for a kind / rows pair no launch takes.
REPRO_EXPORT int repro_ssd_chunk_scan_bwd_smem(int kind, int rows, int N,
                                               int Q) {
  if ((kind == 0 || kind == 1) && (rows == 32 || rows == 16))
    return static_cast<int>(Layout(N, Q, rows).bytes);
  if ((kind == 2 && rows == 64) || (kind == 3 && rows == 32))
    return static_cast<int>(MmaLayout(N, Q, rows, mma_stages(rows),
                                      rows == 64 ? kMmaWarps<64>
                                                 : kMmaWarps<32>).bytes);
  return -1;
}
