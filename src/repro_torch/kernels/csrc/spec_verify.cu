// Fused speculative verification (modified rejection sampling) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/spec_verify.py::
// spec_verify (body _kernel) and its grouped form spec_verify_batched.  For
// every row i of group g (gamma draft rows plus the bonus row) it takes
// p = softmax(target / T) and q = softmax(draft / T) (tie-split one-hots at
// T = 0; the bonus row's draft is the zero row), the accept flag
// u_acc < min(p[tok] / q[tok], 1) and, at T > 0, the inverse-CDF sample of
// the residual clip(p - q, 0) normalised (p itself on the bonus row or when
// the residual is empty): the number of cdf entries below u_res, clamped to
// V - 1.  At T = 0 the emitted token is the row's first target argmax and
// no residual is computed.  The last row of a group to finish writes the
// group's n_acc (accepted prefix) and next token.  The uniforms come in
// from the caller.
//
// Bound on the H100: reading the logits once, (2 gamma + 1) * V * 4 bytes
// a group.  At the serving shape (8 groups, gamma 4, V 49152) that is
// 14 MB, 4.2 us at 3.35 TB/s.  A block a row (40 blocks on 132 SMs) cannot
// pull that: its loads and its serial block reductions over 49152 entries
// are one long chain.  The design:
//
// * The vocabulary of a row is split over a thread-block cluster (at most
//   8 blocks, portable), so rows x splits covers about two blocks per SM
//   (the wrapper picks the split count from shapes only).  Grid
//   (split, row), cluster (split, 1, 1).
// * Each block copies its chunk of both rows into shared memory once, with
//   16-byte cp.async copies (each thread copies exactly the pieces it later
//   reads, so no block barrier guards them), and never reads device memory
//   again.  A chunk too large for shared memory (vocabularies above 8 x
//   12288) is read from device memory instead, by the same code.
// * Phase 1: each thread, then each warp and the block, reduces its
//   entries to (max, first argmax, tie count at T = 0 or the sum of
//   exp(x / T - max / T)); the block pushes that partial into the shared
//   memory of every block of its cluster (at T = 0: of block 0 only), and
//   after one cluster barrier each block merges the partials in chunk
//   order: the global max, the lowest index among equal maxima, the
//   normalisers rescaled to the global max.  At T = 0 that ends the row.
// * Phase 2 (T > 0): each chunk's residual mass sum max(p - q, 0) and p
//   mass, pushed the same way: after a barrier every block knows the total
//   and its chunk's offset.
// * Phase 3 (T > 0): each warp walks its entries in order with a
//   shuffle scan and counts those whose cdf (offset + prefix) is below
//   u_res (times the total: the cdf is kept unnormalised); block 0 sums
//   the counts after a third barrier.
// * Block 0's thread 0 writes the row's result and bumps its group's
//   arrival counter (a device array, reset by the last arriver so that
//   every launch, and every CUDA-graph replay, starts from 0); the last
//   row of the group to arrive writes n_acc and the next token, so the
//   wrapper launches nothing after the kernel.  Launches that overlap on
//   one device (two streams) would share the counters: the port verifies
//   on one stream.
#include <cooperative_groups.h>

#include <cstdint>

#include "attn_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplit = 8;                 // portable cluster size
constexpr int kStageMax = 12288;             // chunk entries staged (96 KB)
constexpr int kMaxGroups = 4096;

// per-group count of rows done; the group's last row resets it to 0
__device__ unsigned int g_arrivals[kMaxGroups];

// a reduction of logits: max, first index of the max, and the tie count
// (T = 0) or sum of exp(x / T - max / T) (T > 0).  T > 0 enters as its
// reciprocal it (0 at T = 0): a product in place of each division, which
// moves p by an ulp, far inside the 1e-6 near-tie margin of the contract.
struct Part {
  float m;
  int i;
  float z;
};

__device__ __forceinline__ Part merge(const Part& a, const Part& b,
                                      float it) {
  const float M = fmaxf(a.m, b.m);
  Part r;
  r.m = M;
  r.i = a.m > b.m ? a.i : b.m > a.m ? b.i : min(a.i, b.i);
  if (it == 0.f) {
    r.z = (a.m == M ? a.z : 0.f) + (b.m == M ? b.z : 0.f);
  } else {                                   // an empty side adds nothing
    const float mt = M * it;
    r.z = (a.z > 0.f ? a.z * expf(a.m * it - mt) : 0.f) +
          (b.z > 0.f ? b.z * expf(b.m * it - mt) : 0.f);
  }
  return r;
}

__device__ __forceinline__ Part warp_merge(Part p, float it) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Part other;
    other.m = __shfl_xor_sync(0xffffffffu, p.m, o);
    other.i = __shfl_xor_sync(0xffffffffu, p.i, o);
    other.z = __shfl_xor_sync(0xffffffffu, p.z, o);
    p = merge(p, other, it);
  }
  return p;
}

__device__ __forceinline__ float4 ld4(const float4* row, int f) {
  return row[f];
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
// wait has acquire and arrive release semantics by default
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// kStaged: the chunk is copied into shared memory (else read from device
// memory); kGreedy: T = 0.
template <bool kStaged, bool kGreedy>
__global__ void __launch_bounds__(kThreads) spec_verify_kernel(
    const float* __restrict__ target, const float* __restrict__ draft,
    const int* __restrict__ tokens, const float* __restrict__ u_acc,
    const float* __restrict__ u_res, int* __restrict__ row_res,
    int* __restrict__ n_acc, int* __restrict__ next_token, int gamma, int V,
    int chunk, float temperature) {
  __shared__ Part s_p[kMaxSplit], s_q[kMaxSplit], w_p[kWarps], w_q[kWarps];
  __shared__ float s_r[kMaxSplit], s_pm[kMaxSplit], w_r[kWarps], w_pm[kWarps];
  __shared__ int s_cnt[kMaxSplit], w_cnt[kWarps];
  extern __shared__ float4 stage[];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nsplit = static_cast<int>(cluster.num_blocks());
  cluster_arrive_relaxed();                  // "started", waited on below
  const int row = blockIdx.y;                // g * (gamma + 1) + i
  const int R = gamma + 1;
  const int g = row / R, i = row - g * R;
  const bool bonus = i == gamma;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* p_row = target + static_cast<size_t>(row) * V;
  const float* q_row =
      bonus ? p_row : draft + (static_cast<size_t>(g) * gamma + i) * V;

  // block 0's thread 0 fetches what the accept test needs ahead of time
  float x_tok = 0.f, y_tok = 0.f, ua = 0.f;
  if (rank == 0 && tid == 0 && !bonus) {
    const int tok = tokens[g * gamma + i];
    x_tok = p_row[tok];
    y_tok = q_row[tok];
    ua = u_acc[row];
  }
  const float ur = kGreedy ? 0.f : u_res[row];

  // this block's chunk [c0, c1) of each row, as 16-byte pieces from the
  // aligned address at or below c0: element v of the target row sits at
  // piece position v - c0 + mp, of the draft row at v - c0 + mq (the two
  // rows may be aligned differently when V is not a multiple of 4)
  const int c0 = min(rank * chunk, V), c1 = min(c0 + chunk, V);
  auto misalign = [&](const float* x) {
    return static_cast<int>((reinterpret_cast<uintptr_t>(x) / 4) % 4);
  };
  const int mp = misalign(p_row + c0), mq = misalign(q_row + c0);
  const int np = (mp + c1 - c0 + 3) / 4;       // pieces of each row
  const int nqd = bonus ? 0 : (mq + c1 - c0 + 3) / 4;
  const int nt = (max(np, nqd) + 31) / 32;   // 32-piece tiles
  const int tpw = (nt + kWarps - 1) / kWarps;
  const int t_lo = warp * tpw, t_hi = min(t_lo + tpw, nt);
  const float4* gp = reinterpret_cast<const float4*>(p_row + c0 - mp);
  const float4* gq = reinterpret_cast<const float4*>(q_row + c0 - mq);
  const int qstride = (np + 1) & ~1;         // keep both rows 32-byte apart
  const float4* xp = gp;
  const float4* xq = gq;
  if constexpr (kStaged) {
    for (int t = t_lo; t < t_hi; ++t) {
      const int f = t * 32 + lane;
      if (f < np) repro::attn::cp_async16(stage + f, gp + f, 16);
      if (f < nqd) repro::attn::cp_async16(stage + qstride + f, gq + f, 16);
    }
    repro::attn::cp_async_commit();
    xp = stage;
    xq = stage + qstride;
    repro::attn::cp_async_wait<0>();         // this thread's own pieces
  }
  // element e of piece f: its vocabulary index, or -1 outside the chunk
  auto index = [&](int f, int e, int m) {
    const int v = c0 - m + 4 * f + e;
    return v >= c0 && v < c1 ? v : -1;
  };
  // the draft logit of vocabulary entry v of the chunk (after phase 1's
  // block barrier: another thread may have copied it)
  const float* yq = reinterpret_cast<const float*>(xq) + mq;
  auto draft_at = [&](int v) { return bonus ? 0.f : yq[v - c0]; };

  // ---- phase 1: per-thread max / first argmax, then tie count or sum
  Part pp = {-INFINITY, 0x7fffffff, 0.f}, pq = {-INFINITY, 0x7fffffff, 0.f};
  for (int t = t_lo; t < t_hi; ++t) {
    const int f = t * 32 + lane;
    if (f < np) {
      const float4 a = ld4(xp, f);
      const float xa[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (index(f, e, mp) >= 0 && xa[e] > pp.m) {
          pp.m = xa[e];
          pp.i = index(f, e, mp);
        }
    }
    if (f < nqd) {
      const float4 b = ld4(xq, f);
      const float ya[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (index(f, e, mq) >= 0) pq.m = fmaxf(pq.m, ya[e]);
    }
  }
  const float it = kGreedy ? 0.f : 1.f / temperature;
  const float pmt = pp.m * it, qmt = pq.m * it;
  auto add = [&](Part& part, float x, float mt) {
    if (kGreedy)
      part.z += x >= part.m ? 1.f : 0.f;
    else if (part.m > -INFINITY)
      part.z += expf(x * it - mt);
  };
  for (int t = t_lo; t < t_hi; ++t) {
    const int f = t * 32 + lane;
    if (f < np) {
      const float4 a = ld4(xp, f);
      const float xa[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (index(f, e, mp) >= 0) add(pp, xa[e], pmt);
    }
    if (f < nqd) {
      const float4 b = ld4(xq, f);
      const float ya[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (index(f, e, mq) >= 0) add(pq, ya[e], qmt);
    }
  }
  pp = warp_merge(pp, it);
  pq = warp_merge(pq, it);
  if (lane == 0) {
    w_p[warp] = pp;
    w_q[warp] = pq;
  }
  __syncthreads();
  cluster_wait();                            // every block has started
  if (tid < (kGreedy ? 1 : nsplit)) {        // push to block tid
    Part bp = w_p[0], bq = w_q[0];
    for (int w = 1; w < kWarps; ++w) {
      bp = merge(bp, w_p[w], it);
      bq = merge(bq, w_q[w], it);
    }
    cluster.map_shared_rank(s_p, tid)[rank] = bp;
    cluster.map_shared_rank(s_q, tid)[rank] = bq;
  }
  cluster_sync();
  // the row's merged partials, in chunk order (identical in every block)
  Part P = s_p[0], Q = s_q[0];
  if (kGreedy) {
    if (rank != 0) return;
    if (tid == 0)
      for (int c = 1; c < nsplit; ++c) {
        P = merge(P, s_p[c], 0.f);
        Q = merge(Q, s_q[c], 0.f);
      }
  } else {
    for (int c = 1; c < nsplit; ++c) {
      P = merge(P, s_p[c], it);
      Q = merge(Q, s_q[c], it);
    }
  }

  int tok_out = P.i;                         // T = 0: the first argmax
  if (!kGreedy) {
    // ---- phase 2: the chunk's residual and p masses
    const float Pmt = P.m * it, Qmt = Q.m * it;
    const float ipz = 1.f / P.z, iqz = 1.f / Q.z;
    auto masses = [&](float x, float y, float& p, float& r) {
      p = expf(x * it - Pmt) * ipz;
      const float q = bonus ? 0.f : expf(y * it - Qmt) * iqz;
      r = fmaxf(p - q, 0.f);
    };
    float r_sum = 0.f, p_sum = 0.f;
    for (int t = t_lo; t < t_hi; ++t) {
      const int f = t * 32 + lane;
      if (f >= np) break;
      const float4 a = ld4(xp, f);
      const float xa[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = index(f, e, mp);
        if (v < 0) continue;
        float p, r;
        masses(xa[e], draft_at(v), p, r);
        r_sum += r;
        p_sum += p;
      }
    }
    r_sum = repro::warp_sum(r_sum);
    p_sum = repro::warp_sum(p_sum);
    if (lane == 0) {
      w_r[warp] = r_sum;
      w_pm[warp] = p_sum;
    }
    __syncthreads();
    if (tid < nsplit) {
      float br = 0.f, bp = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        br += w_r[w];
        bp += w_pm[w];
      }
      cluster.map_shared_rank(s_r, tid)[rank] = br;
      cluster.map_shared_rank(s_pm, tid)[rank] = bp;
    }
    cluster_sync();
    float tot = 0.f;
    for (int c = 0; c < nsplit; ++c) tot += s_r[c];
    const bool use_p = !(tot > 0.f);
    const float* s_mass = use_p ? s_pm : s_r;
    const float* w_mass = use_p ? w_pm : w_r;
    float run = 0.f;                         // mass before this warp
    for (int c = 0; c < rank; ++c) run += s_mass[c];
    for (int w = 0; w < warp; ++w) run += w_mass[w];
    const float thr = use_p ? ur : ur * tot;

    // ---- phase 3: count the entries whose cdf is below u_res
    int below = 0;
    for (int t = t_lo; t < t_hi; ++t) {
      const int f = t * 32 + lane;
      float a4[4] = {0.f, 0.f, 0.f, 0.f};
      bool ok[4] = {false, false, false, false};
      if (f < np) {
        const float4 a = ld4(xp, f);
        const float xa[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int v = index(f, e, mp);
          ok[e] = v >= 0;
          if (!ok[e]) continue;
          float p, r;
          masses(xa[e], draft_at(v), p, r);
          a4[e] = use_p ? p : r;
        }
      }
      a4[1] += a4[0];                        // inclusive prefix of 4
      a4[2] += a4[1];
      a4[3] += a4[2];
      float incl = a4[3];                    // warp inclusive scan
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float base = run + excl;
#pragma unroll
      for (int e = 0; e < 4; ++e) below += ok[e] && base + a4[e] < thr;
      run += __shfl_sync(0xffffffffu, incl, 31);
    }
    below = __reduce_add_sync(0xffffffffu, below);
    if (lane == 0) w_cnt[warp] = below;
    __syncthreads();
    if (tid == 0) {
      int bc = 0;
      for (int w = 0; w < kWarps; ++w) bc += w_cnt[w];
      cluster.map_shared_rank(s_cnt, 0)[rank] = bc;
    }
    cluster_sync();
    if (rank != 0) return;
    int n = 0;
    for (int c = 0; c < nsplit; ++c) n += s_cnt[c];
    tok_out = min(n, V - 1);
  }

  // ---- the row's result, and the group's once all its rows are in
  if (tid == 0) {
    bool accept = false;
    if (!bonus) {
      float p_tok, q_tok;
      if (kGreedy) {
        p_tok = x_tok >= P.m ? 1.f / P.z : 0.f;
        q_tok = y_tok >= Q.m ? 1.f / Q.z : 0.f;
      } else {
        p_tok = expf(x_tok * it - P.m * it) / P.z;
        q_tok = expf(y_tok * it - Q.m * it) / Q.z;
      }
      accept = ua < fminf(p_tok / fmaxf(q_tok, 1e-20f), 1.f);
    }
    row_res[row] = tok_out * 2 + (accept ? 1 : 0);
    __threadfence();
    if (atomicAdd(&g_arrivals[g], 1u) == static_cast<unsigned>(R - 1)) {
      __threadfence();
      const int* res = row_res + g * R;
      int n = 0;
      while (n < gamma && (__ldcg(res + n) & 1)) ++n;
      n_acc[g] = n;
      next_token[g] = __ldcg(res + n) >> 1;
      g_arrivals[g] = 0;
    }
  }
}

template <bool kStaged, bool kGreedy>
int launch(const float* target, const float* draft, const int* tokens,
           const float* u_acc, const float* u_res, int* row_res, int* n_acc,
           int* next_token, int G, int gamma, int V, int nsplit, int chunk,
           float temperature, cudaStream_t stream) {
  auto kernel = spec_verify_kernel<kStaged, kGreedy>;
  size_t smem = 0;
  if constexpr (kStaged) {
    const int np = (chunk + 3 + 3) / 4;      // pieces, misalignment included
    smem = sizeof(float4) * 2 * ((np + 1) & ~1);
    const cudaError_t err = repro::attn::allow_smem<
        spec_verify_kernel<kStaged, kGreedy>>();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, G * (gamma + 1));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, target, draft, tokens, u_acc, u_res, row_res, n_acc,
      next_token, gamma, V, chunk, temperature);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// target (G, gamma+1, V), draft (G, gamma, V) float32; tokens (G, gamma)
// int32; u_acc, u_res (G, gamma+1) float32, all contiguous.  The row split:
// nsplit (1-8) chunks of `chunk` entries (a multiple of 4, nsplit * chunk
// >= V).  Outputs: n_acc, next_token (G,) int32; row_res (G, gamma+1)
// int32 scratch.  Returns a cudaError_t as int.
REPRO_EXPORT int repro_spec_verify(const float* target, const float* draft,
                                   const int* tokens, const float* u_acc,
                                   const float* u_res, int* row_res,
                                   int* n_acc, int* next_token, int G,
                                   int gamma, int V, int nsplit, int chunk,
                                   float temperature, void* stream) {
  if (G < 1 || G > kMaxGroups || gamma < 1 || V < 1 || nsplit < 1 ||
      nsplit > kMaxSplit || chunk < 4 || chunk % 4 != 0 ||
      static_cast<long long>(nsplit) * chunk < V ||
      static_cast<long long>(G) * (gamma + 1) > 65535 ||
      !(temperature >= 0.f && temperature < INFINITY))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const bool staged = chunk <= kStageMax;
  if (temperature == 0.f)
    return staged ? launch<true, true>(target, draft, tokens, u_acc, u_res,
                                       row_res, n_acc, next_token, G, gamma,
                                       V, nsplit, chunk, temperature, s)
                  : launch<false, true>(target, draft, tokens, u_acc, u_res,
                                        row_res, n_acc, next_token, G, gamma,
                                        V, nsplit, chunk, temperature, s);
  return staged ? launch<true, false>(target, draft, tokens, u_acc, u_res,
                                      row_res, n_acc, next_token, G, gamma, V,
                                      nsplit, chunk, temperature, s)
                : launch<false, false>(target, draft, tokens, u_acc, u_res,
                                       row_res, n_acc, next_token, G, gamma,
                                       V, nsplit, chunk, temperature, s);
}
