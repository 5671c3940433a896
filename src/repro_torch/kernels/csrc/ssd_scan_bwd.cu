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
// Bound on the H100: the chunk products, about 2 B H S (Q (3 N + 2 P) + 4 N
// P) operations over float32, for the training shapes tens of GFLOP against
// tens of MB: operations bound.
//
// Design (a first kernel, right and simple; ROADMAP Queue B row 8): one
// block of 256 threads per (64-column tile of P, head, batch), like the
// forward, walking the chunks in reverse with its (N, 64) slice of dS and
// the normaliser's dn in shared memory.  bf16 inputs are widened to float32
// as they are staged, and every product runs as float32 FMAs on the CUDA
// cores over row tiles of R rows (32, or 16 where N is large: xLSTM's N =
// 384), each thread accumulating a register micro-tile (R / 16 rows by 4
// columns, 16 apart) so that a shared-memory load feeds several FMAs.
// Per chunk:
// * the gates (La recomputed in the forward's summation order, shared
//   ssd_gates.cuh), co, z, scale; <dS, S~'> for the last row's dLa;
// * per key tile (outer) its k and v rows; dk and dv start at their carry
//   terms; per row tile at or after it, W and D (R x R) once into shared
//   memory, then dv += W^T dy and dk += D^T q in shared memory, and
//   dq += D k straight into the block's own float32 rows of a scratch
//   buffer (the first key tile writes them): no float atomics;
// * per row tile, the carried-in term of dq (S~ read from the saved
//   P-major state), q . dq into dLa, and dS, dn rescaled and accumulated.
// dq, dk, dlog_i and dLa sum over the P tiles (xLSTM's P = 384 has six):
// each block writes its tile's partials, and a second kernel sums them in
// tile order, casts dq and dk to the input type and takes dLa's reverse
// cumsum per chunk.  Every sum has one fixed order: two runs give the same
// bits.  Pad rows (the front pad of a ragged S) have q = k = v = dy = 0 and
// are masked out of C, co and z, so no 0 * inf arises.
#include <cstdint>

#include "attn_tile.cuh"
#include "ssd_gates.cuh"

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
__device__ __forceinline__ void stage(float* dst, int ld, int wpad, int R,
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
// warps' sums in warp order); every thread gets it.  red: kWarps floats.
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = repro::warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
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
      stage<T>(kt, ldn, N, R, k + kb, ks.s, s0, t0, Q, N);
      stage<T>(vt, kLdP, kPT, R, v + vb, vs.s, s0, t0, Q, pw);
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
        stage<T>(qj, ldn, N, R, q + qb, qs.s, j0, t0, Q, N);
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
      stage<T>(qj, ldn, N, R, q + qb, qs.s, j0, t0, Q, N);
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
// dlog_i, and dlog_a as the reverse cumsum of dLa inside each chunk.  One
// block per (chunk, head, batch); dynamic shared memory: Q floats.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_finish_kernel(
    const float* __restrict__ dq_part, const float* __restrict__ dk_part,
    const float* __restrict__ dLa_part, const float* __restrict__ dli_part,
    T* __restrict__ dq, T* __restrict__ dk, float* __restrict__ dla,
    float* __restrict__ dli, int B, int S, int H, int N, int Q, int pad,
    int ntiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* a = reinterpret_cast<float*>(smem);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * Q - pad;
  const size_t bshN = static_cast<size_t>(B) * S * H * N;
  const size_t bsh = static_cast<size_t>(B) * S * H;
  for (int i = threadIdx.x; i < Q * N; i += kThreads) {
    const int j = i / N, n = i - j * N, t = t0 + j;
    if (t < 0) continue;
    const size_t o = ((static_cast<size_t>(b) * S + t) * H + h) * N + n;
    float sq = 0.f, sk = 0.f;
    for (int tl = 0; tl < ntiles; ++tl) {
      sq += dq_part[tl * bshN + o];
      sk += dk_part[tl * bshN + o];
    }
    dq[o] = repro::from_float<T>(sq);
    dk[o] = repro::from_float<T>(sk);
  }
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

template <typename T>
int launch(const void* q, Strides3 qs, const void* k, Strides3 ks,
           const void* v, Strides3 vs, const float* la, Strides3 las,
           const float* li, Strides3 lis, const float* m, const float* Sc,
           const float* ncs, const float* Mcs, const float* Mf, int fresh,
           const float* dy, const float* dden, void* dv, float* dq_part,
           float* dk_part, float* dLa_part, float* dli_part, void* dq,
           void* dk, float* dla, float* dli, int B, int S, int H, int N,
           int P, int Q, int pad, cudaStream_t stream) {
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
  const int nc = (S + pad) / Q;
  ssd_bwd_finish_kernel<T><<<dim3(nc, H, B), kThreads, Q * sizeof(float),
                             stream>>>(
      dq_part, dk_part, dLa_part, dli_part, static_cast<T*>(dq),
      static_cast<T*>(dk), dla, dli, B, S, H, N, Q, pad, ntiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and dq, dk, dv; everything else
// float32).  q, k (B, S, H, N), v (B, S, H, P), log_a, log_i (B, S, H): the
// forward's inputs, element strides over (b, position, head), last dim
// contiguous.  m (B, S, H): the forward's row log-max; Sc (B, H, nc, P, N),
// ncs (B, H, nc, N), Mcs (B, H, nc): each chunk's carried-in state, saved
// by the forward (repro_ssd_chunk_scan); Mf (B, H) its final log-max; fresh:
// 1 if the forward started from a zero state.  dy (B, S, H, P) and dden
// (B, S, H, or null for zeros): contiguous float32 gradients of y_num and
// den.  Outputs, contiguous: dv, dq, dk in the input type, dla, dli float32
// (B, S, H); scratch: dq_part, dk_part (ntiles, B, S, H, N), dLa_part,
// dli_part (ntiles, B, S, H) float32, ntiles = ceil(P / 64).  Q is the
// chunk length and pad = (-S) mod Q the front padding.  Launches the two
// kernels on the stream; returns a cudaError_t as int
// (cudaErrorInvalidValue also when N's tiles do not fit in shared memory).
REPRO_EXPORT int repro_ssd_chunk_scan_bwd(
    int dtype, const void* q, long long q_sb, long long q_ss, long long q_sh,
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
  if (dtype == 0)
    return launch<float>(q, qs, k, ks, v, vs, la, las, li, lis, m, Sc, ncs,
                         Mcs, Mf, fresh, dy, dden, dv, dq_part, dk_part,
                         dLa_part, dli_part, dq, dk, dla, dli, B, S, H, N, P,
                         Q, pad, s);
  if (dtype == 1)
    return launch<bf16>(q, qs, k, ks, v, vs, la, las, li, lis, m, Sc, ncs,
                        Mcs, Mf, fresh, dy, dden, dv, dq_part, dk_part,
                        dLa_part, dli_part, dq, dk, dla, dli, B, S, H, N, P,
                        Q, pad, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
