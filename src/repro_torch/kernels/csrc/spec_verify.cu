// Fused speculative verification (modified rejection sampling) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/spec_verify.py::
// spec_verify (body _kernel) and its grouped form spec_verify_batched.  For
// every row i of group g (gamma draft rows plus the bonus row) it computes
// p = softmax(target / T) and q = softmax(draft / T) (tie-split one-hots at
// T = 0; the bonus row's draft is the zero row, so q is uniform), the accept
// flag u_acc < min(p[tok] / q[tok], 1), the residual clip(p - q, 0)
// normalised (p itself on the bonus row or when the residual is empty), and
// the inverse-CDF sample: the number of cdf entries below u_res, clamped to
// V - 1.  It also returns the row's first target argmax, which is the token
// the wrapper emits at T = 0.  The wrapper turns the flags into n_acc with a
// cumulative product.  The uniforms come in from the caller.
//
// Design: one thread block of 512 threads per (g, row) walks the V logits of
// both rows in coalesced strided passes: max/argmax, normaliser (tie count
// or sum of exponentials), residual total, and a tiled block-wide prefix sum
// that counts cdf < u_res.  Only scalars leave the block.
//
// Bound on the H100: reading the logits.  At the serving path's shapes
// (8 groups, gamma 4, V 49152, float32) that is about 14 MB, 4 us at
// 3.35 TB/s; the later passes re-read rows the first pass left in the 50 MB
// L2, so the kernel's device-memory traffic stays near that bound.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = repro::warp_sum(x);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float t = lane < kWarps ? red[lane] : 0.f;
  return repro::warp_sum(t);
}

__device__ float block_max(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = repro::warp_max(x);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float t = lane < kWarps ? red[lane] : repro::kNeg;
  return repro::warp_max(t);
}

// first index of the maximum: (value, index) with ties to the lower index
__device__ void block_argmax(float& val, int& idx, float* redv, int* redi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, val, o);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
    if (ov > val || (ov == val && oi < idx)) { val = ov; idx = oi; }
  }
  __syncthreads();
  if (lane == 0) { redv[warp] = val; redi[warp] = idx; }
  __syncthreads();
  val = lane < kWarps ? redv[lane] : -INFINITY;
  idx = lane < kWarps ? redi[lane] : 0x7fffffff;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, val, o);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
    if (ov > val || (ov == val && oi < idx)) { val = ov; idx = oi; }
  }
}

// probability of one logit under the row's normaliser: tie-split one-hot at
// T = 0 (norm = number of maxima), softmax(x / T) otherwise (norm = sum)
__device__ __forceinline__ float prob(float logit, float mx, float norm,
                                      float temperature) {
  if (temperature == 0.f) return logit >= mx ? 1.f / norm : 0.f;
  return expf(logit / temperature - mx) / norm;
}

__global__ void __launch_bounds__(kThreads) spec_verify_kernel(
    const float* __restrict__ target, const float* __restrict__ draft,
    const int* __restrict__ tokens, const float* __restrict__ u_acc,
    const float* __restrict__ u_res, int* __restrict__ accept,
    int* __restrict__ resid_tok, int* __restrict__ argmax_tok, int gamma,
    int V, float temperature) {
  __shared__ float red[kWarps];
  __shared__ int redi[kWarps];
  const int row = blockIdx.x;                 // g * (gamma + 1) + i
  const int R = gamma + 1;
  const int g = row / R, i = row - g * R;
  const bool bonus = i == gamma;
  const float* p_row = target + static_cast<size_t>(row) * V;
  const float* q_row =
      bonus ? nullptr : draft + (static_cast<size_t>(g) * gamma + i) * V;
  const int tid = threadIdx.x;

  // ---- pass 1: maxima (and the first target argmax)
  float pv = -INFINITY, qv = -INFINITY;
  int pi = 0x7fffffff;
  for (int v = tid; v < V; v += kThreads) {
    const float x = p_row[v];
    if (x > pv) { pv = x; pi = v; }           // strided: first index per thread
    if (!bonus) qv = fmaxf(qv, q_row[v]);
  }
  block_argmax(pv, pi, red, redi);
  const float pmax = pv;
  const float qmax = bonus ? 0.f : block_max(qv, red);

  // softmax(x / T) subtracts max(x / T) = max(x) / T (division is monotone)
  const float pm = temperature == 0.f ? pmax : pmax / temperature;
  const float qm = temperature == 0.f ? qmax : qmax / temperature;

  // ---- pass 2: normalisers
  float zp = 0.f, zq = 0.f;
  for (int v = tid; v < V; v += kThreads) {
    const float x = p_row[v];
    zp += temperature == 0.f ? (x >= pmax ? 1.f : 0.f)
                             : expf(x / temperature - pm);
    if (!bonus) {
      const float y = q_row[v];
      zq += temperature == 0.f ? (y >= qmax ? 1.f : 0.f)
                               : expf(y / temperature - qm);
    }
  }
  zp = block_sum(zp, red);
  zq = bonus ? static_cast<float>(V) : block_sum(zq, red);

  // ---- pass 3: residual total
  float tot = 0.f;
  for (int v = tid; v < V; v += kThreads) {
    const float p = prob(p_row[v], pm, zp, temperature);
    const float q = bonus ? 0.f : prob(q_row[v], qm, zq, temperature);
    tot += fmaxf(p - q, 0.f);
  }
  tot = block_sum(tot, red);
  const bool use_p = !(tot > 0.f);
  const float tot_c = fmaxf(tot, 1e-20f);

  // ---- pass 4: inverse CDF, tile by tile with a block prefix sum
  __shared__ float wsum[kWarps];
  const float u = u_res[row];
  const int lane = tid & 31, warp = tid >> 5;
  float run = 0.f;                           // cdf before this tile
  int below = 0;
  for (int base = 0; base < V; base += kThreads) {
    const int v = base + tid;
    float r = 0.f;
    if (v < V) {
      const float p = prob(p_row[v], pm, zp, temperature);
      const float q = bonus ? 0.f : prob(q_row[v], qm, zq, temperature);
      r = use_p ? p : fmaxf(p - q, 0.f) / tot_c;
    }
    float x = r;                             // warp inclusive scan
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    __syncthreads();
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      float w = lane < kWarps ? wsum[lane] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      if (lane < kWarps) wsum[lane] = w;     // inclusive warp prefix
    }
    __syncthreads();
    const float cdf = run + (warp > 0 ? wsum[warp - 1] : 0.f) + x;
    if (v < V && cdf < u) ++below;
    run += wsum[kWarps - 1];
  }
  const float nbelow = block_sum(static_cast<float>(below), red);

  if (tid == 0) {
    const int tok = bonus ? 0 : tokens[g * gamma + i];
    const float p_tok = prob(p_row[tok], pm, zp, temperature);
    const float q_tok =
        bonus ? 1.f / zq : prob(q_row[tok], qm, zq, temperature);
    const float ratio = p_tok / fmaxf(q_tok, 1e-20f);
    accept[row] = u_acc[row] < fminf(ratio, 1.f) ? 1 : 0;
    resid_tok[row] = min(static_cast<int>(nbelow), V - 1);
    argmax_tok[row] = pi;
  }
}

}  // namespace

// target (G, gamma+1, V), draft (G, gamma, V) float32; tokens (G, gamma)
// int32; u_acc, u_res (G, gamma+1) float32; outputs (G, gamma+1) int32.
// Returns a cudaError_t as int.
REPRO_EXPORT int repro_spec_verify(const float* target, const float* draft,
                                   const int* tokens, const float* u_acc,
                                   const float* u_res, int* accept,
                                   int* resid_tok, int* argmax_tok, int G,
                                   int gamma, int V, float temperature,
                                   void* stream) {
  spec_verify_kernel<<<G * (gamma + 1), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      target, draft, tokens, u_acc, u_res, accept, resid_tok, argmax_tok,
      gamma, V, temperature);
  return static_cast<int>(cudaGetLastError());
}
