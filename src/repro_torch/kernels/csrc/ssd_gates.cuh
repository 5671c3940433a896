// The log-decay cumsum of the chunked SSD / mLSTM scan, shared by its
// forward (ssd_scan.cu) and backward (ssd_scan_bwd.cu) kernels, so that the
// backward recomputes the forward's La bit for bit and its decay factors
// exp(La_j - La_s + log_i_s - m_j) are the forward's.
#pragma once

namespace repro {
namespace ssd {

constexpr int kThreads = 256;   // the kernels' block size (the backward's
                                // mma route: 256 or 512 threads, kT)

// a[lo, hi) (hi - lo <= 16) scanned in place by one thread, in order, the
// running sum in a register: a[i] = a[i - 1] + a[i], as the sequential
// scan adds.
__device__ __forceinline__ void scan16(float* a, int lo, int hi) {
  float v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = lo + i < hi ? a[lo + i] : 0.f;
#pragma unroll
  for (int i = 1; i < 16; ++i) {
    v[i] = v[i - 1] + v[i];
    if (lo + i < hi) a[lo + i] = v[i];
  }
}

// Inclusive cumsum of a[0, n) in place, in the order the JAX package's
// cumsum takes on the CPU and the plain version mirrors (kernels/
// ssd_scan.py::cumsum_blocked): sequential 16-long blocks (one thread each,
// in parallel), then the block totals summed the same way and added back.
// All kT threads of the block call it; it ends with a barrier.  scratch:
// n / 8 + 32 floats.
template <int kT = kThreads>
__device__ void cumsum_blocked(float* a, int n, float* scratch) {
  constexpr int kB = 16;
  if (n <= kB) {
    if (threadIdx.x == 0) scan16(a, 0, n);
    __syncthreads();
    return;
  }
  const int nb = (n + kB - 1) / kB;
  for (int b = threadIdx.x; b < nb; b += kT) {
    const int hi = min(b * kB + kB, n);
    scan16(a, b * kB, hi);
    scratch[b] = a[hi - 1];
  }
  __syncthreads();
  cumsum_blocked<kT>(scratch, nb, scratch + nb);
  for (int i = kB + threadIdx.x; i < n; i += kT)
    a[i] += scratch[i / kB - 1];
  __syncthreads();
}

}  // namespace ssd
}  // namespace repro
