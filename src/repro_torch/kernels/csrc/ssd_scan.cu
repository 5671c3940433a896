// Chunked gated-linear-attention (SSD / mLSTM) scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::
// ssd_chunk_scan (body _kernel), with the contract of the JAX package's
// models/ssm.py::gla_chunked: per (batch b, head h) the recurrence
//     S_t = a_t S_{t-1} + i_t k_t v_t^T,   n_t = a_t n_{t-1} + i_t k_t
// in log space with a running log-max m, computed chunk by chunk (length
// Q): the intra-chunk term W v with W = (q k^T) o C and the decay mask
// C[j][s] = exp(La_j - La_s + li_s - m_j) for s <= j (La the inclusive
// cumsum of log_a inside the chunk), its row sums into den, the carried-in
// term q S exp(La + M - m), and the (S, n, M) update.  Outputs y_num, den
// and m (float32, stabilised by exp(-m)) and the final state.  A ragged S is
// front-padded to a multiple of Q in the indexing (pad rows have q = k = v =
// 0, log_a = 0, log_i = -1e30), so chunk boundaries and m are the JAX
// package's; the TPU kernel needs S % Q == 0 and writes no final state.
//
// Bound on the H100: at the serving path's prefill shapes (one prompt of
// 15 tokens, one chunk) its latency chain; at long prompts the chunk
// products, about B H S (Q (N + P) + 4 N P) operations.
//
// Design: one block of 256 threads per (64-column tile of P, head, batch),
// walking the chunks in order with its (N, 64) state slice and the
// normaliser n in shared memory.  Per chunk:
// * Gates, in parallel: the log-decay cumsum keeps the order of the JAX
//   package's cumsum on the CPU bit for bit (cumsum_blocked: sequential
//   inside 16-long blocks, one thread a block, then the block totals summed
//   the same way and added back); the cummax of log_i - La is a warp-shuffle
//   prefix max (exact in any order); the row log-max, the carry weights and
//   the carried-in coefficients are per element.
// * The chunk in row tiles of kR rows (64 for bf16, 32 for f32); per row
//   tile the q rows are staged once, the carried-in term q S is taken, then
//   every key tile at or before it is staged (k and v), its weighted scores
//   W (kR x kR) are computed once for all 64 value columns into shared
//   memory, and W v is accumulated in registers.  The last row tile's key
//   tiles cover the chunk, so they also carry the state update S = scale S
//   + k^T (v o z) while k and v are staged: k and v are read once per row
//   tile, and the state once per chunk.
// * bf16 inputs run every product on the tensor cores (mma.sync m16n8k16,
//   f32 accumulators; operands by ldmatrix from skewed shared-memory rows;
//   the helpers are ssd_mma.cuh's, shared with the backward).
//   q k^T is bf16 x bf16, exact products.  The products with an f32 operand
//   (W v, q S, k^T (v o z)) split it into a bf16 head and the bf16 of its
//   remainder and multiply both, which keeps about 16 bits of it.  f32
//   inputs are never rounded: the same tiles run as float32 FMAs on the CUDA
//   cores, in the JAX package's order of operations.  expf, no fast math.
// q and k are read through strides, so mamba2's one B/C projection shared by
// all heads goes in as a stride-0 view (the head lives in the base address).
// Only the first P tile writes den, m and the final n and M.  For training,
// an optional output receives each chunk's carried-in state (S~, n~, M) as
// the chunk starts, which the backward (ssd_scan_bwd.cu) reads instead of
// recomputing the forward; the serving path passes null and skips it.
//
// The first row and key tiles of a chunk are copied by cp.async while the
// gates are computed; a chunk of at most 32 rows (every serving prefill)
// has its gates computed by one warp with no block barrier (on an H100,
// 0.0011-0.0014 ms less than the block-wide path at the 15-token
// prefills, 12-15%); a fresh state
// skips the carried-in products of the first chunk; tiles stage only the
// chunk's rows (rounded up to 16).
//
// Not done (ROADMAP D.3): chunk-parallel passes for single long prompts
// (one block per (b, h, P tile) walks the chunks: 32 blocks for a
// 2048-token mamba2 prompt on 132 SMs).  Tried and measured slower on an
// H100: xLSTM's six P tiles as one cluster sharing W through distributed
// shared memory, each block computing a sixth of W's 16 x 8 units, two
// cluster barriers per key tile (S 2048: 0.89 -> 0.92 ms; the 15-token
// prefill: 0.0166 -> 0.0180 ms).  A warp's score chain is its k-steps over
// N however many key columns it holds, so the split cut issued work, not
// time.
#include <cstdint>
#include <type_traits>

#include "ssd_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::ssd::ldsm_x4;
using repro::ssd::ldsm_x4_t;
using repro::ssd::mma;
using repro::ssd::split2;
using repro::ssd::stage;

constexpr int kThreads = repro::ssd::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kPT = 64;                      // value columns per block

template <typename T>
struct Cfg {
  static constexpr bool kTC = std::is_same<T, bf16>::value;
  static constexpr int kR = kTC ? 64 : 32;   // rows of a row / key tile
  static constexpr int kSkew = 16 / sizeof(T);   // row padding (elements)
  static constexpr int kStrips = kR / 16;        // 16-row strips of a tile
  static constexpr int kWps = kWarps / kStrips;  // warps per strip
  static constexpr int kNTs = kR / 8 / kWps;     // score n8 tiles a warp
  static constexpr int kNTy = kPT / 8 / kWps;    // output n8 tiles a warp
  static constexpr int kLdW = kR + 4;            // W row stride (floats)
};

struct Strides3 {
  long long b, s, h;                         // element strides of (B, S, H)
};

// Byte offsets of the dynamic shared memory, the same on host and device.
struct Layout {
  int Np, ldq, ldv;
  size_t qt, kt, vt, W, S, n, gates, bytes;
  __host__ __device__ Layout(int N, int Q, int esize, int kR, int skew) {
    Np = (N + 15) / 16 * 16;                 // N padded to the k-step
    ldq = Np + skew;
    ldv = kPT + skew;
    size_t o = 0;
    qt = o;
    o += static_cast<size_t>(kR) * ldq * esize;
    kt = o;
    o += static_cast<size_t>(kR) * ldq * esize;
    vt = o;
    o += static_cast<size_t>(kR) * ldv * esize;
    o = (o + 15) / 16 * 16;
    W = o;
    o += static_cast<size_t>(kR) * (kR + 4) * 4;
    S = o;
    o += static_cast<size_t>(Np) * kPT * 4;
    n = o;
    o += static_cast<size_t>(Np) * 4;
    gates = o;                 // 6 x [Q], dacc, warp totals, cumsum scratch
    o += static_cast<size_t>(6 * Q + kR + kWarps + Q / 8 + 32) * 4;
    bytes = o;
  }
};

// State slice element (n, p): rows of 64 floats, the column xor-swizzled by
// bits 1-2 of the row so that the B fragments of q S (rows 2t, 2t + 1 of
// four lanes) fall in distinct banks.
__device__ __forceinline__ int sidx(int n, int p) {
  return n * kPT + (p ^ ((n << 2) & 24));
}

// w[j] = max over i <= j of (lg[i] - La[i]): a warp-shuffle prefix max per
// 256 entries, the warps' totals from shared memory.  max is exact, so any
// order gives the sequential scan's values.  Ends with a barrier.
__device__ void prefix_max(const float* lg, const float* La, float* w, int n,
                           float* wtot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float ninf = __int_as_float(0xff800000);
  float carry = ninf;
  for (int base = 0; base < n; base += kThreads) {
    const int j = base + threadIdx.x;
    float d = j < n ? lg[j] - La[j] : ninf;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, d, o);
      if (lane >= o) d = fmaxf(d, u);
    }
    if (lane == 31) wtot[warp] = d;
    __syncthreads();
    float pre = carry;
    for (int i = 0; i < warp; ++i) pre = fmaxf(pre, wtot[i]);
    if (j < n) w[j] = fmaxf(d, pre);
    for (int i = warp; i < kWarps; ++i) pre = fmaxf(pre, wtot[i]);
    carry = pre;
    __syncthreads();
  }
}

// The gates of a chunk of Q <= 32 rows, by warp 0 alone (no block
// barrier): lane j loads log_a and log_i of row j (pad rows 0 and -1e30),
// La is cumsum_blocked's order (one or two 16-long blocks, thread-serial),
// the cummax a shuffle prefix max, then mr, zc and co per lane.  Writes La,
// lg, wmx, mr, zc, co; the caller's next barrier publishes them.
__device__ __forceinline__ void gates_warp(
    const float* __restrict__ la, long long lab, long long las,
    const float* __restrict__ li, long long lib, long long lis, int t0,
    int Q, float M, float* La, float* lg, float* wmx, float* mr, float* zc,
    float* co) {
  const int j = threadIdx.x, t = t0 + j;
  const bool in = j < Q && t >= 0;
  const float l = in ? li[lib + t * lis] : repro::kNeg;
  if (j < Q) {
    La[j] = in ? la[lab + t * las] : 0.f;
    lg[j] = l;
  }
  __syncwarp();
  if (j < 2 && j * 16 < Q) repro::ssd::scan16(La, j * 16, min(j * 16 + 16, Q));
  __syncwarp();
  float a = j < Q ? La[j] : 0.f;
  if (j >= 16 && j < Q) a += La[15];         // block 0's total, added back
  const float ninf = __int_as_float(0xff800000);
  float w = j < Q ? l - a : ninf;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, w, o);
    if (j >= o) w = fmaxf(w, u);
  }
  const float la_sum = __shfl_sync(0xffffffffu, a, Q - 1);
  const float m_new = la_sum + fmaxf(M, __shfl_sync(0xffffffffu, w, Q - 1));
  __syncwarp();
  if (j < Q) {
    const float mj = a + fmaxf(M, w);
    La[j] = a;
    wmx[j] = w;
    mr[j] = mj;
    zc[j] = expf(la_sum - a + l - m_new);
    co[j] = expf(a + M - mj);
  }
}

// ---- the four products, each for one warp in the mma fragment layout:
// thread (g = lane / 4, t = lane % 4) holds rows g and g + 8 of its 16-row
// strip, columns 8 nt + 2t and 8 nt + 2t + 1 of each n8 tile nt.

// sc = q_strip k_tile^T over the (padded) state dim: 16 rows x 8 kNTs
// keys, of which only the first nts n8 tiles are computed (the rest are
// past every row of the strip).
template <typename T>
__device__ __forceinline__ void scores(float (&sc)[Cfg<T>::kNTs][4],
                                       const T* qa, const T* kb, int ldq,
                                       int Np, int N, int nts) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < Cfg<T>::kNTs; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
  if constexpr (Cfg<T>::kTC) {
    const int m = lane >> 3;
    for (int k0 = 0; k0 < Np; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, qa + (lane & 15) * ldq + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < Cfg<T>::kNTs; nt += 2) {
        if (nt >= nts) break;
        uint32_t b[4];
        ldsm_x4(b, kb + (nt * 8 + (lane & 7) + (m >> 1) * 8) * ldq + k0 +
                       (m & 1) * 8);
        mma(sc[nt], a, b[0], b[1]);
        mma(sc[nt + 1], a, b[2], b[3]);
      }
    }
  } else {
    for (int n = 0; n < N; ++n) {
      const float a0 = qa[g * ldq + n], a1 = qa[(g + 8) * ldq + n];
#pragma unroll
      for (int nt = 0; nt < Cfg<T>::kNTs; ++nt) {
        if (nt >= nts) break;
        const float b0 = kb[(nt * 8 + 2 * t) * ldq + n];
        const float b1 = kb[(nt * 8 + 2 * t + 1) * ldq + n];
        sc[nt][0] += a0 * b0;
        sc[nt][1] += a0 * b1;
        sc[nt][2] += a1 * b0;
        sc[nt][3] += a1 * b1;
      }
    }
  }
}

// y += W_strip v_tile[:nk] over columns [pc, pc + 8 kNTy).
template <typename T>
__device__ __forceinline__ void w_times_v(float (&y)[Cfg<T>::kNTy][4],
                                          const float* Wr, const T* vt,
                                          int ldv, int pc, int nk) {
  constexpr int kLdW = Cfg<T>::kLdW;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (Cfg<T>::kTC) {
    for (int k0 = 0; k0 < nk; k0 += 16) {
      uint32_t ah[4], al[4];
      const float* w = Wr + g * kLdW + k0 + 2 * t;
      const float2 w00 = *reinterpret_cast<const float2*>(w);
      const float2 w10 = *reinterpret_cast<const float2*>(w + 8 * kLdW);
      const float2 w01 = *reinterpret_cast<const float2*>(w + 8);
      const float2 w11 = *reinterpret_cast<const float2*>(w + 8 * kLdW + 8);
      ah[0] = split2(w00.x, w00.y, al[0]);
      ah[1] = split2(w10.x, w10.y, al[1]);
      ah[2] = split2(w01.x, w01.y, al[2]);
      ah[3] = split2(w11.x, w11.y, al[3]);
#pragma unroll
      for (int nt = 0; nt < Cfg<T>::kNTy; nt += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, vt + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldv +
                         pc + nt * 8 + (lane >> 4) * 8);
        mma(y[nt], ah, b[0], b[1]);
        mma(y[nt], al, b[0], b[1]);
        mma(y[nt + 1], ah, b[2], b[3]);
        mma(y[nt + 1], al, b[2], b[3]);
      }
    }
  } else {
    for (int s = 0; s < nk; ++s) {
      const float a0 = Wr[g * kLdW + s], a1 = Wr[(g + 8) * kLdW + s];
#pragma unroll
      for (int nt = 0; nt < Cfg<T>::kNTy; ++nt) {
        const float b0 = vt[s * ldv + pc + nt * 8 + 2 * t];
        const float b1 = vt[s * ldv + pc + nt * 8 + 2 * t + 1];
        y[nt][0] += a0 * b0;
        y[nt][1] += a0 * b1;
        y[nt][2] += a1 * b0;
        y[nt][3] += a1 * b1;
      }
    }
  }
}

// y = q_strip S over columns [pc, pc + 8 kNTy).
template <typename T>
__device__ __forceinline__ void q_times_s(float (&y)[Cfg<T>::kNTy][4],
                                          const T* qa, int ldq,
                                          const float* Ss, int Np, int N,
                                          int pc) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < Cfg<T>::kNTy; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[nt][e] = 0.f;
  if constexpr (Cfg<T>::kTC) {
    for (int k0 = 0; k0 < Np; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, qa + (lane & 15) * ldq + k0 + (lane >> 4) * 8);
      const int n = k0 + 2 * t;
#pragma unroll
      for (int nt = 0; nt < Cfg<T>::kNTy; ++nt) {
        const int p = pc + nt * 8 + g;
        uint32_t l0, l1;
        const uint32_t h0 = split2(Ss[sidx(n, p)], Ss[sidx(n + 1, p)], l0);
        const uint32_t h1 =
            split2(Ss[sidx(n + 8, p)], Ss[sidx(n + 9, p)], l1);
        mma(y[nt], a, h0, h1);
        mma(y[nt], a, l0, l1);
      }
    }
  } else {
    for (int n = 0; n < N; ++n) {
      const float a0 = qa[g * ldq + n], a1 = qa[(g + 8) * ldq + n];
#pragma unroll
      for (int nt = 0; nt < Cfg<T>::kNTy; ++nt) {
        const int p = pc + nt * 8 + 2 * t;
        const float b0 = Ss[sidx(n, p)], b1 = Ss[sidx(n, p + 1)];
        y[nt][0] += a0 * b0;
        y[nt][1] += a0 * b1;
        y[nt][2] += a1 * b0;
        y[nt][3] += a1 * b1;
      }
    }
  }
}

// State rows [16 st, 16 st + 16) x all 64 columns: S = S * sc + k_tile^T
// (v_tile o z) over the tile's nk keys (sc = 1 after the first key tile).
template <typename T>
__device__ __forceinline__ void update_strip(float* Ss, int st, const T* kt,
                                             int ldq, const T* vt, int ldv,
                                             const float* z, int nk,
                                             float sc) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = st * 16 + g;
  float acc[kPT / 8][4];
#pragma unroll
  for (int nt = 0; nt < kPT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[nt][e] = Ss[sidx(r0 + (e >> 1) * 8, nt * 8 + 2 * t + (e & 1))] * sc;
  if constexpr (Cfg<T>::kTC) {
    const int m = lane >> 3;
    for (int k0 = 0; k0 < nk; k0 += 16) {
      uint32_t a[4];
      ldsm_x4_t(a, kt + (k0 + (lane & 7) + (m >> 1) * 8) * ldq + st * 16 +
                       (m & 1) * 8);
      const int s = k0 + 2 * t;
      const float z0 = s < nk ? z[s] : 0.f, z1 = s + 1 < nk ? z[s + 1] : 0.f;
      const float z2 = s + 8 < nk ? z[s + 8] : 0.f;
      const float z3 = s + 9 < nk ? z[s + 9] : 0.f;
#pragma unroll
      for (int nt = 0; nt < kPT / 8; ++nt) {
        const T* vp = vt + s * ldv + nt * 8 + g;
        uint32_t l0, l1;
        const uint32_t h0 = split2(repro::to_float(vp[0]) * z0,
                                   repro::to_float(vp[ldv]) * z1, l0);
        const uint32_t h1 = split2(repro::to_float(vp[8 * ldv]) * z2,
                                   repro::to_float(vp[9 * ldv]) * z3, l1);
        mma(acc[nt], a, h0, h1);
        mma(acc[nt], a, l0, l1);
      }
    }
  } else {
    for (int s = 0; s < nk; ++s) {
      const float a0 = kt[s * ldq + r0], a1 = kt[s * ldq + r0 + 8];
      const float zs = z[s];
#pragma unroll
      for (int nt = 0; nt < kPT / 8; ++nt) {
        const float b0 = vt[s * ldv + nt * 8 + 2 * t] * zs;
        const float b1 = vt[s * ldv + nt * 8 + 2 * t + 1] * zs;
        acc[nt][0] += a0 * b0;
        acc[nt][1] += a0 * b1;
        acc[nt][2] += a1 * b0;
        acc[nt][3] += a1 * b1;
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < kPT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      Ss[sidx(r0 + (e >> 1) * 8, nt * 8 + 2 * t + (e & 1))] = acc[nt][e];
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
    float* __restrict__ m_out, float* __restrict__ Sc, float* __restrict__ ncs,
    float* __restrict__ Mcs, int S, int H, int N, int P, int Q, int pad,
    int vec_qk, int vec_v) {
  using C = Cfg<T>;
  constexpr int kR = C::kR, kLdW = C::kLdW;
  const Layout L(N, Q, sizeof(T), kR, C::kSkew);
  const int Np = L.Np, ldq = L.ldq, ldv = L.ldv;
  const int p0 = blockIdx.x * kPT, h = blockIdx.y, b = blockIdx.z;
  const int pw = min(P - p0, kPT);           // valid columns of the tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const bool first_tile = blockIdx.x == 0;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qt = reinterpret_cast<T*>(smem + L.qt);     // [kR][ldq] query rows
  T* kt = reinterpret_cast<T*>(smem + L.kt);     // [kR][ldq] key rows
  T* vt = reinterpret_cast<T*>(smem + L.vt);     // [kR][ldv] value rows
  float* Wb = reinterpret_cast<float*>(smem + L.W);   // [kR][kLdW]
  float* Ss = reinterpret_cast<float*>(smem + L.S);   // [Np][64] swizzled
  float* ns = reinterpret_cast<float*>(smem + L.n);   // [Np] normaliser
  float* La = reinterpret_cast<float*>(smem + L.gates);   // [Q] cumsum
  float* lg = La + Q;                        // [Q] log_i
  float* mr = lg + Q;                        // [Q] per-row log-max
  float* wmx = mr + Q;                       // [Q] cummax(log_i - La)
  float* zc = wmx + Q;                       // [Q] carry weights
  float* co = zc + Q;                        // [Q] carried-in coefficients
  float* dacc = co + Q;                      // [kR] den of the row tile
  float* wtot = dacc + kR;                   // [kWarps] prefix-max totals
  float* scratch = wtot + kWarps;            // cumsum block totals

  const size_t bh = static_cast<size_t>(b) * H + h;
  const long long qb = b * qs.b + h * qs.h, kb = b * ks.b + h * ks.h;
  const long long vb = b * vs.b + h * vs.h + p0;
  const long long lab = b * las.b + h * las.h, lib = b * lis.b + h * lis.h;

  for (int i = tid; i < Np * kPT; i += kThreads) {
    const int n = i / kPT, p = i - n * kPT;
    Ss[sidx(n, p)] = S0 != nullptr && n < N && p < pw
        ? S0[(bh * N + n) * P + p0 + p] : 0.f;
  }
  for (int n = tid; n < Np; n += kThreads)
    ns[n] = n0 != nullptr && n < N ? n0[bh * N + n] : 0.f;
  float M = m0 != nullptr ? m0[bh] : repro::kNeg;

  // this warp's strip of a row tile and its output columns
  const int sr = warp / C::kWps;
  const int pc = (warp % C::kWps) * C::kNTy * 8;
  const int kc = (warp % C::kWps) * C::kNTs * 8;
  const int ntile = (Q + kR - 1) / kR;
  const int nc = (S + pad) / Q;
  // rows of a tile starting at chunk row j0 that a product can read: the
  // chunk's rows rounded up to the 16-row k-step (zero-filled past Q);
  // rows beyond are never read
  auto rows16 = [&](int j0) { return min(kR, (Q - j0 + 15) / 16 * 16); };
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * Q - pad;              // real position of chunk row 0
    // a fresh state is zero in the first chunk: no carried-in term
    const bool carried = c > 0 || S0 != nullptr;
    __syncthreads();                         // previous chunk fully consumed
    if (Sc != nullptr) {         // the carried-in state, for the backward
      float* dst = Sc + ((bh * nc + c) * P + p0) * N;       // [p][n]
      for (int i = tid; i < pw * N; i += kThreads) {
        const int p = i / N, n = i - p * N;
        dst[i] = Ss[sidx(n, p)];
      }
      if (first_tile) {
        for (int n = tid; n < N; n += kThreads)
          ncs[(bh * nc + c) * N + n] = ns[n];
        if (tid == 0) Mcs[bh * nc + c] = M;
      }
    }
    // row tile 0's q and key tile 0's k, v in flight beside the gates
    stage(qt, ldq, Np, rows16(0), q + qb, qs.s, 0, t0, Q, N, vec_qk);
    stage(kt, ldq, Np, rows16(0), k + kb, ks.s, 0, t0, Q, N, vec_qk);
    stage(vt, ldv, kPT, rows16(0), v + vb, vs.s, 0, t0, Q, pw, vec_v);
    repro::attn::cp_async_commit();
    // ---- gates: La, the cummax, the row log-max, the carry weights
    if (Q <= 32) {
      if (warp == 0)
        gates_warp(la, lab, las.s, li, lib, lis.s, t0, Q, M, La, lg, wmx, mr,
                   zc, co);
    } else {
      for (int j = tid; j < Q; j += kThreads) {
        const int t = t0 + j;
        La[j] = t >= 0 ? la[lab + t * las.s] : 0.f;
        lg[j] = t >= 0 ? li[lib + t * lis.s] : repro::kNeg;
      }
      __syncthreads();
      repro::ssd::cumsum_blocked(La, Q, scratch);
      prefix_max(lg, La, wmx, Q, wtot);
      const float la_sum = La[Q - 1];
      const float m_new = la_sum + fmaxf(M, wmx[Q - 1]);
      for (int j = tid; j < Q; j += kThreads) {
        const float mj = La[j] + fmaxf(M, wmx[j]);
        mr[j] = mj;
        zc[j] = expf(la_sum - La[j] + lg[j] - m_new);
        co[j] = expf(La[j] + M - mj);
      }
    }
    repro::attn::cp_async_wait<0>();
    __syncthreads();                         // gates and first tiles ready
    const float la_sum = La[Q - 1];
    const float m_new = la_sum + fmaxf(M, wmx[Q - 1]);
    const float scale = expf(fminf(la_sum + M - m_new, 0.f));

    for (int it = 0; it < ntile; ++it) {
      const int j0 = it * kR;
      const bool last = it == ntile - 1;
      const bool strip_live = j0 + sr * 16 < Q;
      if (it > 0) {
        __syncthreads();                     // qt free
        stage(qt, ldq, Np, rows16(j0), q + qb, qs.s, j0, t0, Q, N, vec_qk);
        repro::attn::cp_async_commit();
        repro::attn::cp_async_wait<0>();
        __syncthreads();
      }
      // ---- carried-in state: y = (q S) co, den = (q n) co
      float yacc[C::kNTy][4];
#pragma unroll
      for (int nt = 0; nt < C::kNTy; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[nt][e] = 0.f;
      if (strip_live && carried) {
        q_times_s<T>(yacc, qt + sr * 16 * ldq, ldq, Ss, Np, N, pc);
#pragma unroll
        for (int nt = 0; nt < C::kNTy; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + sr * 16 + g + (e >> 1) * 8;
            yacc[nt][e] *= j < Q ? co[j] : 0.f;
          }
      }
      if (first_tile && carried) {
        for (int r = warp; r < rows16(j0); r += kWarps) {
          float a = 0.f;
          for (int n = lane; n < N; n += 32)
            a += repro::to_float(qt[r * ldq + n]) * ns[n];
          a = repro::warp_sum(a);
          if (lane == 0) dacc[r] = j0 + r < Q ? a * co[j0 + r] : 0.f;
        }
      }
      if (first_tile && (!carried || tid >= rows16(j0)) && tid < kR)
        dacc[tid] = 0.f;

      // ---- intra-chunk: key tiles s0 <= j0 (the diagonal one masked)
      for (int s0 = 0; s0 <= j0; s0 += kR) {
        if (it > 0) {                        // row tile 0: prefetched
          __syncthreads();                   // kt, vt, Wb free
          stage(kt, ldq, Np, rows16(s0), k + kb, ks.s, s0, t0, Q, N,
                vec_qk);
          stage(vt, ldv, kPT, rows16(s0), v + vb, vs.s, s0, t0, Q, pw, vec_v);
          repro::attn::cp_async_commit();
          repro::attn::cp_async_wait<0>();
          __syncthreads();
        }
        {                                    // W = (q k^T) o C, once
          float sc[C::kNTs][4];
          const int r0 = sr * 16;
          // n8 tiles holding a key <= the strip's last row
          const int nts = (min(j0 + r0 + 16, Q) - (s0 + kc) + 7) / 8;
          const bool live = strip_live && nts > 0;
          if (live)
            scores<T>(sc, qt + r0 * ldq, kt + kc * ldq, ldq, Np, N, nts);
#pragma unroll
          for (int nt = 0; nt < C::kNTs; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = r0 + g + (e >> 1) * 8;
              const int cc = kc + nt * 8 + 2 * t4 + (e & 1);
              const int j = j0 + r, s = s0 + cc;
              float w = 0.f;
              if (live && s <= j && j < Q)
                w = sc[nt][e] * expf(La[j] - La[s] + lg[s] - mr[j]);
              Wb[r * kLdW + cc] = w;
            }
        }
        __syncthreads();
        const int nk = min(kR, Q - s0);      // real keys of the tile
        if (first_tile && tid < kR) {
          float a = dacc[tid];
          for (int s = 0; s < nk; ++s) a += Wb[tid * kLdW + s];
          dacc[tid] = a;
        }
        if (strip_live) {
          int nkw = min(nk, j0 + sr * 16 + 16 - s0);   // keys W can see
          if constexpr (C::kTC) nkw = (nkw + 15) / 16 * 16;
          w_times_v<T>(yacc, Wb + sr * 16 * kLdW, vt, ldv, pc, nkw);
        }
        if (last) {                          // k, v cover the chunk here
          const float sc = s0 == 0 ? scale : 1.f;
          for (int st = warp; st < Np / 16; st += kWarps)
            update_strip<T>(Ss, st, kt, ldq, vt, ldv, zc + s0, nk, sc);
          if (first_tile) {
            for (int n = tid; n < N; n += kThreads) {
              float a = ns[n] * sc;
              for (int s = 0; s < nk; ++s)
                a += repro::to_float(kt[s * ldq + n]) * zc[s0 + s];
              ns[n] = a;
            }
          }
        }
      }

      // ---- outputs of the row tile
      if (strip_live) {
#pragma unroll
        for (int nt = 0; nt < C::kNTy; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + sr * 16 + g + (e >> 1) * 8, t = t0 + j;
            const int p = pc + nt * 8 + 2 * t4 + (e & 1);
            if (j < Q && t >= 0 && p < pw)
              y[((static_cast<size_t>(b) * S + t) * H + h) * P + p0 + p] =
                  yacc[nt][e];
          }
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
    M = m_new;
  }

  __syncthreads();
  for (int i = tid; i < N * kPT; i += kThreads) {
    const int n = i / kPT, p = i - n * kPT;
    if (p < pw) S_out[(bh * N + n) * P + p0 + p] = Ss[sidx(n, p)];
  }
  if (first_tile) {
    for (int n = tid; n < N; n += kThreads) n_out[bh * N + n] = ns[n];
    if (tid == 0) m_out[bh] = M;
  }
}

template <typename T>
int launch(const void* q, Strides3 qs, const void* k, Strides3 ks,
           const void* v, Strides3 vs, const float* la, Strides3 las,
           const float* li, Strides3 lis, const float* S0, const float* n0,
           const float* m0, float* y, float* den, float* m, float* S_out,
           float* n_out, float* m_out, float* Sc, float* ncs, float* Mcs,
           int B, int S, int H, int N, int P, int Q, int pad,
           cudaStream_t stream) {
  using C = Cfg<T>;
  constexpr int kE = 16 / sizeof(T);
  const Layout L(N, Q, sizeof(T), C::kR, C::kSkew);
  const cudaError_t err =
      repro::attn::allow_smem<ssd_chunk_scan_kernel<T>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec_qk = al16(q) && al16(k) && N % kE == 0 && qs.b % kE == 0 &&
                      qs.s % kE == 0 && qs.h % kE == 0 && ks.b % kE == 0 &&
                      ks.s % kE == 0 && ks.h % kE == 0;
  const bool vec_v = al16(v) && P % kE == 0 && vs.b % kE == 0 &&
                     vs.s % kE == 0 && vs.h % kE == 0;
  const dim3 grid((P + kPT - 1) / kPT, H, B);
  ssd_chunk_scan_kernel<T><<<grid, kThreads, L.bytes, stream>>>(
      static_cast<const T*>(q), qs, static_cast<const T*>(k), ks,
      static_cast<const T*>(v), vs, la, las, li, lis, S0, n0, m0, y, den, m,
      S_out, n_out, m_out, Sc, ncs, Mcs, S, H, N, P, Q, pad, vec_qk ? 1 : 0,
      vec_v ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v; the gates and the state are
// float32).  q, k (B, S, H, N), v (B, S, H, P), log_a, log_i (B, S, H), each
// with element strides over (b, position, head) and the last dim contiguous.
// S0 / n0 / m0: the carried state (B, H, N, P), (B, H, N), (B, H), contiguous,
// or all null for a fresh one.  Outputs (contiguous float32): y (B, S, H, P),
// den and m (B, S, H), S_out, n_out, m_out shaped as the state.  Sc / ncs /
// Mcs: null, or each chunk's carried-in state, saved for the backward
// (ssd_scan_bwd.cu): Sc (B, H, nc, P, N) — transposed, P-major —, ncs
// (B, H, nc, N) and Mcs (B, H, nc), nc = (S + pad) / Q.  Q is the
// chunk length and pad = (-S) mod Q the front padding.  Returns a cudaError_t
// as int (cudaErrorInvalidValue also when the tiles of N do not fit in a
// block's shared memory).
REPRO_EXPORT int repro_ssd_chunk_scan(
    int dtype, const void* q, long long q_sb, long long q_ss, long long q_sh,
    const void* k, long long k_sb, long long k_ss, long long k_sh,
    const void* v, long long v_sb, long long v_ss, long long v_sh,
    const float* la, long long la_sb, long long la_ss, long long la_sh,
    const float* li, long long li_sb, long long li_ss, long long li_sh,
    const float* S0, const float* n0, const float* m0, float* y, float* den,
    float* m, float* S_out, float* n_out, float* m_out, float* Sc, float* ncs,
    float* Mcs, int B, int S, int H, int N, int P, int Q, int pad,
    void* stream) {
  if (Q < 1 || S < 1 || N < 1 || P < 1 || pad < 0 || (S + pad) % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides3 qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, las{la_sb, la_ss, la_sh}, lis{li_sb, li_ss, li_sh};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, qs, k, ks, v, vs, la, las, li, lis, S0, n0, m0, y,
                         den, m, S_out, n_out, m_out, Sc, ncs, Mcs, B, S, H, N,
                         P, Q, pad, s);
  if (dtype == 1)
    return launch<bf16>(q, qs, k, ks, v, vs, la, las, li, lis, S0, n0, m0, y,
                        den, m, S_out, n_out, m_out, Sc, ncs, Mcs, B, S, H, N,
                        P, Q, pad, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
