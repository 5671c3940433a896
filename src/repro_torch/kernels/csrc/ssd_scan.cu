// Chunked gated-linear-attention (SSD / mLSTM) scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::
// ssd_chunk_scan (body _kernel), with the contract of the JAX package's
// models/ssm.py::gla_chunked: per (batch b, head h) the recurrence
//     S_t = a_t S_{t-1} + i_t k_t v_t^T,   n_t = a_t n_{t-1} + i_t k_t
// in log space with a running log-max m, computed chunk by chunk (length
// Q): the intra-chunk term (q k^T o C) v with the decay mask
// C[j][s] = exp(La_j - La_s + li_s - m_j) for s <= j (La the inclusive
// cumsum of log_a inside the chunk), its row sums into den, the carried-in
// term q S exp(La + M - m), and the (S, n, M) update.  Outputs y_num, den
// and m (float32, stabilised by exp(-m)) and the final state.  A ragged S is
// front-padded to a multiple of Q in the indexing (pad rows have q = k = v =
// 0, log_a = 0, log_i = -1e30), so chunk boundaries and m are the JAX
// package's; the TPU kernel needs S % Q == 0 and writes no final state.
//
// Design: one thread block per (64-column tile of P, head, batch), walking
// the chunks in order (the TPU kernel's sequential grid axis) with its
// (N, 64) slice of the state and the normaliser n in shared memory.  Per
// chunk, one thread scans log_a / log_i into La, the per-row log-max and the
// carry weights; then the chunk is walked in 16-row tiles: a tile of query
// rows meets every key tile at or before it (scores q.k on the CUDA cores,
// masked and weighted by C, then times V), then the carried-in state; last
// the state is rescaled and takes the chunk's k (v z)^T.  Every block of a
// (b, h) recomputes the (Q, Q) scores, and only the first P tile writes den,
// m and the final n and M.  q and k are read through strides, so mamba2's
// one B/C projection shared by all heads goes in as a stride-0 view.  All
// arithmetic is float32 with expf (no fast math), in the JAX package's
// order of operations.
//
// Shared memory: the state slice N * 64 floats plus two (16, N + 1) tiles —
// about 150 KB at xLSTM's N = 384, 50 KB at mamba2's N = 128 — so no shape
// of the serving path needs the (Q, Q) decay tile or the whole (N, P) state
// in one block.
//
// Bound on the H100: at the serving path's prefill shapes (one prompt of
// 15 tokens, one chunk) the kernel is bound by its launch; at long prompts
// the chunk products bound it: about B H S (Q (N + P) + 4 N P) operations,
// here on the CUDA cores in float32 — tensor-core (wgmma) tiles and one
// block per (b, h) sharing the scores across P tiles are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 16;                       // chunk rows per tile
constexpr int kPT = 64;                      // value columns per block
constexpr int kYPer = kR * kPT / kThreads;   // y entries per thread
constexpr int kRowStep = kThreads / kPT;     // row step between them
static_assert(kR * kR == kThreads, "one score per thread");

struct Strides3 {
  long long b, s, h;                         // element strides of (B, S, H)
};

// Inclusive cumsum of a[0, n) in place, one thread, in the order the JAX
// package's cumsum takes on the CPU and the plain version mirrors
// (kernels/ssd_scan.py::cumsum_blocked): sequential 16-long blocks, then the
// block totals summed the same way and added back.  scratch: n / 8 floats.
__device__ void cumsum_blocked(float* a, int n, float* scratch) {
  constexpr int kB = 16;
  if (n <= kB) {
    for (int i = 1; i < n; ++i) a[i] += a[i - 1];
    return;
  }
  const int nb = (n + kB - 1) / kB;
  for (int b = 0; b < nb; ++b) {
    const int hi = min(b * kB + kB, n);
    for (int i = b * kB + 1; i < hi; ++i) a[i] += a[i - 1];
    scratch[b] = a[hi - 1];
  }
  cumsum_blocked(scratch, nb, scratch + nb);
  for (int i = kB; i < n; ++i) a[i] += scratch[i / kB - 1];
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_scan_kernel(
    const T* __restrict__ q, Strides3 qs, const T* __restrict__ k,
    Strides3 ks, const T* __restrict__ v, Strides3 vs,
    const float* __restrict__ la, Strides3 las, const float* __restrict__ li,
    Strides3 lis, const float* __restrict__ S0, const float* __restrict__ n0,
    const float* __restrict__ m0, float* __restrict__ y,
    float* __restrict__ den, float* __restrict__ mo,
    float* __restrict__ S_out, float* __restrict__ n_out,
    float* __restrict__ m_out, int S, int H, int N, int P, int Q, int pad) {
  const int p0 = blockIdx.x * kPT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool first_tile = blockIdx.x == 0;
  const int ldn = N + 1;                     // padded rows: no bank conflicts
  extern __shared__ float smem[];
  float* Ss = smem;                          // [N][kPT] state slice
  float* ns = Ss + N * kPT;                  // [N] normaliser
  float* La = ns + N;                        // [Q] inclusive cumsum of log_a
  float* lg = La + Q;                        // [Q] log_i
  float* mr = lg + Q;                        // [Q] per-row log-max
  float* zc = mr + Q;                        // [Q] carry weights
  float* co = zc + Q;                        // [Q] carried-in coefficients
  float* qt = co + Q;                        // [kR][N + 1] query rows
  float* kt = qt + kR * ldn;                 // [kR][N + 1] key rows
  float* vt = kt + kR * ldn;                 // [kR][kPT] value rows
  float* sc = vt + kR * kPT;                 // [kR][kR] weighted scores
  float* dacc = sc + kR * kR;                // [kR] den of the row tile
  __shared__ float sh_M, sh_mnew, sh_scale;

  const size_t bh = static_cast<size_t>(b) * H + h;
  const long long qb = b * qs.b + h * qs.h, kb = b * ks.b + h * ks.h;
  const long long vb = b * vs.b + h * vs.h + p0;
  const long long lab = b * las.b + h * las.h, lib = b * lis.b + h * lis.h;

  for (int i = tid; i < N * kPT; i += kThreads) {
    const int n = i / kPT, p = i - n * kPT;
    Ss[i] = S0 != nullptr && p0 + p < P ? S0[(bh * N + n) * P + p0 + p] : 0.f;
  }
  for (int n = tid; n < N; n += kThreads)
    ns[n] = n0 != nullptr ? n0[bh * N + n] : 0.f;
  if (tid == 0) sh_M = m0 != nullptr ? m0[bh] : repro::kNeg;

  const int nc = (S + pad) / Q;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * Q - pad;              // real position of chunk row 0
    // stage one row tile of a (Q, width) operand: rows past the chunk and
    // front-pad rows are zero
    auto stage = [&](float* dst, int ld, const T* src, long long base,
                     long long row_stride, int r0, int width, int limit) {
      for (int i = tid; i < kR * width; i += kThreads) {
        const int r = i / width, n = i - r * width;
        const int j = r0 + r, t = t0 + j;
        dst[r * ld + n] = j < Q && t >= 0 && n < limit
            ? repro::to_float(src[base + t * row_stride + n]) : 0.f;
      }
    };

    // ---- gates: La (inclusive cumsum), the row log-max m, carry weights
    __syncthreads();                         // previous chunk fully consumed
    for (int j = tid; j < Q; j += kThreads) {
      const int t = t0 + j;
      La[j] = t >= 0 ? la[lab + t * las.s] : 0.f;
      lg[j] = t >= 0 ? li[lib + t * lis.s] : repro::kNeg;
    }
    __syncthreads();
    if (tid == 0) {
      const float M = sh_M;
      cumsum_blocked(La, Q, zc);             // zc is free until below
      float w = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float d = lg[j] - La[j];
        w = j == 0 ? d : fmaxf(w, d);        // cummax(li - La)
        mr[j] = La[j] + fmaxf(M, w);
      }
      const float acc = La[Q - 1], m_new = acc + fmaxf(M, w);
      sh_mnew = m_new;
      sh_scale = expf(fminf(acc + M - m_new, 0.f));
    }
    __syncthreads();
    const float M = sh_M, m_new = sh_mnew, la_sum = La[Q - 1];
    for (int j = tid; j < Q; j += kThreads) {
      zc[j] = expf(la_sum - La[j] + lg[j] - m_new);
      co[j] = expf(La[j] + M - mr[j]);
    }

    // ---- outputs, one tile of 16 query rows at a time
    for (int j0 = 0; j0 < Q; j0 += kR) {
      __syncthreads();                       // previous tile's reads done
      stage(qt, ldn, q, qb, qs.s, j0, N, N);
      if (tid < kR) dacc[tid] = 0.f;
      float yacc[kYPer];
#pragma unroll
      for (int i = 0; i < kYPer; ++i) yacc[i] = 0.f;

      // intra-chunk: key tiles s0 <= j0 (the diagonal tile is masked)
      for (int s0 = 0; s0 <= j0; s0 += kR) {
        __syncthreads();                     // previous key tile consumed
        stage(kt, ldn, k, kb, ks.s, s0, N, N);
        stage(vt, kPT, v, vb, vs.s, s0, kPT, P - p0);
        __syncthreads();
        {
          const int r = tid / kR, s = tid - r * kR;
          const int j = j0 + r, js = s0 + s;
          float val = 0.f;
          if (j < Q && js <= j) {
            float dot = 0.f;
            for (int n = 0; n < N; ++n) dot += qt[r * ldn + n] * kt[s * ldn + n];
            val = dot * expf(La[j] - La[js] + lg[js] - mr[j]);
          }
          sc[r * kR + s] = val;
        }
        __syncthreads();
        if (tid < kR) {
          float a = 0.f;
          for (int s = 0; s < kR; ++s) a += sc[tid * kR + s];
          dacc[tid] += a;
        }
#pragma unroll
        for (int i = 0; i < kYPer; ++i) {
          const int r = tid / kPT + i * kRowStep, p = tid % kPT;
          float a = yacc[i];
          for (int s = 0; s < kR; ++s) a += sc[r * kR + s] * vt[s * kPT + p];
          yacc[i] = a;
        }
      }
      __syncthreads();

      // carried-in state: y += (q S) coef, den += (q n) coef
#pragma unroll
      for (int i = 0; i < kYPer; ++i) {
        const int r = tid / kPT + i * kRowStep, p = tid % kPT;
        if (j0 + r >= Q) continue;
        float a = 0.f;
        for (int n = 0; n < N; ++n) a += qt[r * ldn + n] * Ss[n * kPT + p];
        yacc[i] += a * co[j0 + r];
      }
      for (int r = warp; r < kR; r += kWarps) {
        float a = 0.f;
        for (int n = lane; n < N; n += 32) a += qt[r * ldn + n] * ns[n];
        a = repro::warp_sum(a);
        if (lane == 0 && j0 + r < Q) dacc[r] += a * co[j0 + r];
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < kYPer; ++i) {
        const int r = tid / kPT + i * kRowStep, p = tid % kPT;
        const int j = j0 + r, t = t0 + j;
        if (j < Q && t >= 0 && p0 + p < P)
          y[((static_cast<size_t>(b) * S + t) * H + h) * P + p0 + p] = yacc[i];
      }
      if (first_tile && tid < kR) {
        const int j = j0 + tid, t = t0 + j;
        if (j < Q && t >= 0) {
          const size_t o = (static_cast<size_t>(b) * S + t) * H + h;
          den[o] = dacc[tid];
          mo[o] = mr[j];
        }
      }
    }

    // ---- carry update: S = s_scale S + k^T (v z), n = s_scale n + k^T z
    __syncthreads();
    const float scale = sh_scale;
    for (int i = tid; i < N * kPT; i += kThreads) Ss[i] *= scale;
    for (int n = tid; n < N; n += kThreads) ns[n] *= scale;
    for (int s0 = 0; s0 < Q; s0 += kR) {
      __syncthreads();
      stage(kt, ldn, k, kb, ks.s, s0, N, N);
      stage(vt, kPT, v, vb, vs.s, s0, kPT, P - p0);
      __syncthreads();
      for (int i = tid; i < kR * kPT; i += kThreads) {
        const int r = i / kPT;
        if (s0 + r < Q) vt[i] *= zc[s0 + r];
      }
      __syncthreads();
      for (int i = tid; i < N * kPT; i += kThreads) {
        const int n = i / kPT, p = i - n * kPT;
        float a = Ss[i];
        for (int s = 0; s < kR; ++s) a += kt[s * ldn + n] * vt[s * kPT + p];
        Ss[i] = a;
      }
      for (int n = tid; n < N; n += kThreads) {
        float a = ns[n];
        for (int s = 0; s < kR && s0 + s < Q; ++s)
          a += kt[s * ldn + n] * zc[s0 + s];
        ns[n] = a;
      }
    }
    __syncthreads();
    if (tid == 0) sh_M = m_new;
  }

  __syncthreads();
  for (int i = tid; i < N * kPT; i += kThreads) {
    const int n = i / kPT, p = i - n * kPT;
    if (p0 + p < P) S_out[(bh * N + n) * P + p0 + p] = Ss[i];
  }
  if (first_tile) {
    for (int n = tid; n < N; n += kThreads) n_out[bh * N + n] = ns[n];
    if (tid == 0) m_out[bh] = sh_M;
  }
}

template <typename T>
int launch(const void* q, Strides3 qs, const void* k, Strides3 ks,
           const void* v, Strides3 vs, const float* la, Strides3 las,
           const float* li, Strides3 lis, const float* S0, const float* n0,
           const float* m0, float* y, float* den, float* m, float* S_out,
           float* n_out, float* m_out, int B, int S, int H, int N, int P,
           int Q, int pad, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(N) * kPT + N + 5 * Q + 2 * kR * (N + 1) +
       kR * kPT + kR * kR + kR);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + kPT - 1) / kPT, H, B);
  ssd_chunk_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), qs, static_cast<const T*>(k), ks,
      static_cast<const T*>(v), vs, la, las, li, lis, S0, n0, m0, y, den, m,
      S_out, n_out, m_out, S, H, N, P, Q, pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v; the gates and the state are
// float32).  q, k (B, S, H, N), v (B, S, H, P), log_a, log_i (B, S, H), each
// with element strides over (b, position, head) and the last dim contiguous.
// S0 / n0 / m0: the carried state (B, H, N, P), (B, H, N), (B, H), contiguous,
// or all null for a fresh one.  Outputs (contiguous float32): y (B, S, H, P),
// den and m (B, S, H), S_out, n_out, m_out shaped as the state.  Q is the
// chunk length and pad = (-S) mod Q the front padding.  Returns a cudaError_t
// as int.
REPRO_EXPORT int repro_ssd_chunk_scan(
    int dtype, const void* q, long long q_sb, long long q_ss, long long q_sh,
    const void* k, long long k_sb, long long k_ss, long long k_sh,
    const void* v, long long v_sb, long long v_ss, long long v_sh,
    const float* la, long long la_sb, long long la_ss, long long la_sh,
    const float* li, long long li_sb, long long li_ss, long long li_sh,
    const float* S0, const float* n0, const float* m0, float* y, float* den,
    float* m, float* S_out, float* n_out, float* m_out, int B, int S, int H,
    int N, int P, int Q, int pad, void* stream) {
  if (Q < 1 || S < 1 || N < 1 || P < 1 || pad < 0 || (S + pad) % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides3 qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, las{la_sb, la_ss, la_sh}, lis{li_sb, li_ss, li_sh};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, qs, k, ks, v, vs, la, las, li, lis, S0, n0, m0, y,
                         den, m, S_out, n_out, m_out, B, S, H, N, P, Q, pad,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, qs, k, ks, v, vs, la, las, li, lis, S0,
                                 n0, m0, y, den, m, S_out, n_out, m_out, B, S,
                                 H, N, P, Q, pad, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
