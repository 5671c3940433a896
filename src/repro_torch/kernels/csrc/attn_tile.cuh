// The tensor-core attention tile shared by the bf16 flash-prefill and
// tree-verify kernels (sm_90a); the flash backward
// (flash_attention_bwd.cu) builds its products from the same copies and
// wgmma primitives (qk_issue, pv_issue; at hd 256 wgmma_ss_n32 and
// wgmma_ss_n64_mn, both operands in shared memory).
//
// A block of kWG warpgroups (128 threads each) owns a tile of 64 * kWG
// query rows: rows of one kv head, packed over its G query heads (GQA) and
// its query positions or tree nodes, so every K/V tile staged in shared
// memory serves all G heads and all kWG * 64 rows.  The block walks 64-key
// tiles of that kv head; each warpgroup multiplies its own 64 rows:
//
//   S = Q K^T   wgmma m64n64k16, A = Q and B = K from shared memory (K-major)
//   mask + online softmax on the f32 accumulator fragments
//   O += P V    wgmma m64nNk16, A = P from registers (bf16, as a head and
//               a remainder), B = V from shared memory (MN-major), N = 64,
//               then 16 for a head-dim tail
//
// Shared-memory operands are bf16 in 8 x 8 "core matrices" (8 rows of 16
// bytes, 128 contiguous bytes; the no-swizzle wgmma layout): element (r, c)
// of an R x D tile (D the head dim padded to a multiple of 16) sits at
//   ((r / 8) * (D / 8) + c / 8) * 64 + (r % 8) * 8 + c % 8.
// A wgmma reads a core matrix as one 128-byte line, and the copy writes it
// the same way: 16-byte chunk i of the tile (one core-matrix row) goes to
// element i * 8, so the 8 threads of a store phase fill one whole line and
// share no bank.  K/V tiles are copied with 16-byte cp.async in two stages,
// the next tile in flight while the current one is multiplied.  The
// head-dim padding and V rows past the last key are zero-filled; Q and K
// rows past the valid range are not loaded at all (a garbage Q row only
// makes a pad row that is never written, a garbage K column only a score
// that is masked).
//
// The accumulators of both products have the wgmma fragment layout: thread
// (warp w, lane l) holds rows 16w + l/4 and 16w + l/4 + 8, and entry [j][e]
// is column 8j + 2(l%4) + (e&1) of the first row (e < 2) or of the second;
// masks are evaluated per entry from that (row, key), and skipped on tiles
// every row sees whole (below a causal diagonal, inside a tree's prefix).
#pragma once

#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace repro {
namespace attn {

using bf16 = __nv_bfloat16;

constexpr int kKeys = 64;      // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

template <int kD, int kWG = 1>
struct Tile {
  static_assert(kD % 16 == 0 && kD <= 256, "padded head dim");
  static constexpr int kRows = 64 * kWG;      // query rows of a block
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kCh = kD / 8;          // 16-byte chunks (n8 blocks)
  static constexpr int kQElems = kRows * kD;  // the Q tile
  static constexpr int kKVElems = kKeys * kD; // one K or V tile
  // dynamic shared memory: the Q tile and two stages of K and V
  static constexpr int kSmem =
      (kQElems + 4 * kKVElems) * static_cast<int>(sizeof(bf16));
};

// Running state of the tile's rows, as this thread holds them (the row
// max in log2 units: scores are scaled by log2(e) / sqrt(hd)).
template <int kD>
struct Acc {
  float o[kD / 8][4];    // output accumulator fragments
  float m[2], l[2];      // row max; this thread's part of the row sum

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    m[0] = m[1] = kNeg;
    l[0] = l[1] = 0.f;
  }
};

__device__ __forceinline__ int frag_row(int h) {   // tile row of half h
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * h;
}
__device__ __forceinline__ int frag_col() {        // column of entry [0][0]
  return 2 * (threadIdx.x & 3);
}

// ------------------------------------------------------------ async copies
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes (cp.async, st.shared) made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Stage kN rows with kT threads: row r comes from row(r), elements [0, hd)
// of it, the padding zero; a row with row(r) == nullptr is zero-filled
// when ``fill``, else left as it is.  vec: every row pointer is 16-byte
// aligned and hd % 8 == 0, so 16-byte cp.async copies (``valid`` is any
// readable global address, the source of a zero-filling copy); otherwise
// element loads, for any alignment and any hd.
template <int kD, int kN, int kT, typename RowFn>
__device__ __forceinline__ void stage_rows(bf16* dst, const RowFn& row,
                                           int hd, bool fill, bool vec,
                                           const bf16* valid) {
  constexpr int kCh = kD / 8;
  for (int i = threadIdx.x; i < kN * kCh; i += kT) {
    const int r = (i / (8 * kCh)) * 8 + (i & 7);
    const int c = (i >> 3) % kCh;
    const bf16* src = row(r);
    if (src == nullptr && !fill) continue;
    if (vec) {
      const bool in = src != nullptr && c * 8 < hd;
      cp_async16(dst + i * 8, in ? src + c * 8 : valid, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int d = c * 8 + e;
        dst[i * 8 + e] = src != nullptr && d < hd ? src[d]
                                                  : __float2bfloat16(0.f);
      }
    }
  }
}

// ------------------------------------------------------------------ wgmma
// Shared-memory matrix descriptor, no swizzle: start address, leading
// byte offset (between core matrices along K for a K-major operand, along
// K as well for an MN-major one) and stride byte offset (between core
// matrices along M/N), each in 16-byte units.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the compiler must not move reads of the accumulators above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(a[j][e])::"memory");
}

#define REPRO_F4(a, j) "+f"(a[j][0]), "+f"(a[j][1]), "+f"(a[j][2]), \
    "+f"(a[j][3])
#define REPRO_F32(a) REPRO_F4(a, 0), REPRO_F4(a, 1), REPRO_F4(a, 2), \
    REPRO_F4(a, 3), REPRO_F4(a, 4), REPRO_F4(a, 5), REPRO_F4(a, 6), \
    REPRO_F4(a, 7)
#define REPRO_R32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"

// d[64 x 64] += A[64 x 16] B[16 x 64], A and B K-major in shared memory;
// kAcc = 0: d = A B (d's old values are not read)
template <int kAcc = 1>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_F32(d)
      : "l"(da), "l"(db), "n"(kAcc));
}
// d[64 x 32] += A[64 x 16] B[16 x 32], A and B K-major in shared memory;
// kAcc = 0: d = A B
template <int kAcc = 1>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : REPRO_F4(d, 0), REPRO_F4(d, 1), REPRO_F4(d, 2), REPRO_F4(d, 3)
      : "l"(da), "l"(db), "n"(kAcc));
}
// d[64 x 64] += A[64 x 16] B[16 x 64], A K-major and B MN-major, both in
// shared memory
__device__ __forceinline__ void wgmma_ss_n64_mn(float (&d)[8][4],
                                                uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_R32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : REPRO_F32(d)
      : "l"(da), "l"(db), "n"(1));
}
// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}
// d[64 x 16] += A[64 x 16] B[16 x 16], A in registers, B MN-major
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[2][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, "
      "p, 1, 1, 1;\n}\n"
      : REPRO_F4(d, 0), REPRO_F4(d, 1)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}
#undef REPRO_R32
#undef REPRO_F32
#undef REPRO_F4

// Issue s = A B^T over the head dim without waiting (the first k-step
// overwrites s, so it need not be zeroed; zeroing it in registers would
// make ptxas wait on a product issued just before): A the 64 rows at
// ``a``, B the 64 rows at ``b``, both K-major in shared memory.  The
// caller fences before and commits after.
template <int kD>
__device__ __forceinline__ void qk_issue(float (&s)[8][4], const bf16* a,
                                         const bf16* b) {
  constexpr uint32_t kSbo = Tile<kD>::kCh * 128;   // next 8 rows
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {            // two core columns each
    const uint64_t da = desc(a + kk * 128, 128, kSbo);
    const uint64_t db = desc(b + kk * 128, 128, kSbo);
    if (kk == 0)
      wgmma_ss_n64<0>(s, da, db);
    else
      wgmma_ss_n64(s, da, db);
  }
}

// s = Q K^T for one 64-key tile and this warpgroup's 64 rows of the Q
// tile.
template <int kD>
__device__ __forceinline__ void qk_product(float (&s)[8][4], const bf16* qs,
                                           const bf16* ks) {
  wg_fence();
  qk_issue<kD>(s, qs + (threadIdx.x >> 7) * 64 * kD, ks);  // own rows
  wg_commit();
  wg_wait0();
  fence_regs(s);
}

// Issue o += (p[0] + ... + p[kN - 1]) V for one 64-key tile without
// waiting; p[i][kk] is the A fragment of keys [16 kk, 16 kk + 16), V the
// 64 x kD tile at ``vs``, MN-major.  The caller fences before and commits
// after.
template <int kD, int kN>
__device__ __forceinline__ void pv_issue(float (&o)[kD / 8][4],
                                         const uint32_t (&p)[kN][4][4],
                                         const bf16* vs) {
  constexpr int kCh = Tile<kD>::kCh;
  constexpr uint32_t kLbo = kCh * 128;              // next 8 keys
#pragma unroll
  for (int i = 0; i < kN; ++i) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const bf16* vk = vs + 2 * kk * kCh * 64;      // key group 2 kk
#pragma unroll
      for (int c = 0; c < kD / 64; ++c)             // 64 dims
        wgmma_rs_n64(*reinterpret_cast<float(*)[8][4]>(&o[8 * c]), p[i][kk],
                     desc(vk + 8 * c * 64, kLbo, 128));
#pragma unroll
      for (int c = (kD / 64) * 4; c < kD / 16; ++c)  // 16-dim tail
        wgmma_rs_n16(*reinterpret_cast<float(*)[2][4]>(&o[2 * c]), p[i][kk],
                     desc(vk + 2 * c * 64, kLbo, 128));
    }
  }
}

// o += (p[0] + p[1]) V for one 64-key tile; p[i][kk] is the A fragment of
// keys [16 kk, 16 kk + 16).
template <int kD>
__device__ __forceinline__ void pv_product(float (&o)[kD / 8][4],
                                           const uint32_t (&p)[2][4][4],
                                           const bf16* vs) {
  wg_fence();
  pv_issue<kD, 2>(o, p, vs);
  wg_commit();
  wg_wait0();
  fence_regs(o);
}


// --------------------------------------------------------- online softmax
// 2^x on the special-function unit (2 ulp; -inf-like inputs give 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float max8(const float (&t)[8]) {
  return fmaxf(fmaxf(fmaxf(t[0], t[1]), fmaxf(t[2], t[3])),
               fmaxf(fmaxf(t[4], t[5]), fmaxf(t[6], t[7])));
}

// Mask, scale and fold one tile's scores (key k0 at column 0) into the
// running state; returns the probabilities as PV's A fragments, each split
// into a bf16 head p[0] and the bf16 of its remainder p[1]: P V is taken
// as p[0] V + p[1] V, which keeps P to about 16 bits (one bf16 P would
// move an output of a few keys by up to 2^-9 of its range, a whole bf16
// step once rounded).  kMask: evaluate visible(h, key) — is ``key``
// visible to this thread's row of half h (frag_row(h)) — else every key of
// the tile is visible.  Masked entries are exact zeros.  The output is
// rescaled only when a row's max moved (a vote per warp), which after the
// first tiles of a long row it rarely does.
template <int kD, bool kMask, typename Visible>
__device__ __forceinline__ void softmax_tile(Acc<kD>& a, float (&s)[8][4],
                                             uint32_t (&p)[2][4][4], int k0,
                                             float scale_log2,
                                             const Visible& visible) {
  const int c0 = k0 + frag_col();
  float t[2][8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[j][2 * h + e];
        x = !kMask || visible(h, c0 + 8 * j + e) ? x * scale_log2 : kNeg;
      }
      t[h][j] = fmaxf(s[j][2 * h], s[j][2 * h + 1]);
    }
  float alpha[2];
  bool same = true;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = max8(t[h]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(a.m[h], mx);
    alpha[h] = ex2(a.m[h] - m_new);
    // nothing accumulated yet (max still kNeg): no rescale either
    same = same && (m_new == a.m[h] || a.m[h] <= kNeg);
    a.m[h] = m_new;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x0 = s[j][2 * h], x1 = s[j][2 * h + 1];
      const float p0 = x0 <= kNeg ? 0.f : ex2(x0 - a.m[h]);
      const float p1 = x1 <= kNeg ? 0.f : ex2(x1 - a.m[h]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(
          p0 - __low2float(hi), p1 - __high2float(hi));
      sum[j] = p0 + p1;
      p[0][j >> 1][(j & 1) * 2 + h] = *reinterpret_cast<const uint32_t*>(&hi);
      p[1][j >> 1][(j & 1) * 2 + h] = *reinterpret_cast<const uint32_t*>(&lo);
    }
    a.l[h] = a.l[h] * alpha[h] + (((sum[0] + sum[1]) + (sum[2] + sum[3])) +
                                  ((sum[4] + sum[5]) + (sum[6] + sum[7])));
  }
  if (__all_sync(0xffffffffu, same)) return;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    a.o[j][0] *= alpha[0];
    a.o[j][1] *= alpha[0];
    a.o[j][2] *= alpha[1];
    a.o[j][3] *= alpha[1];
  }
}

// Walk n_tiles 64-key tiles from key k_first with a block of kWG
// warpgroups (keys at or past k_end are not loaded, their V rows zeroed:
// ``visible`` must mask them): K row p at kb + p * row, V row p at
// vb + p * row.  stages
// holds two (K, V) buffers.  full(k0): every row sees every key of the tile
// at k0 (its mask is skipped).  The Q tile's copies must have been issued
// (not committed) before the call: they complete with the first K/V tile.
template <int kD, int kWG, typename Visible, typename Full>
__device__ __forceinline__ void attend(Acc<kD>& a, const bf16* qs,
                                       bf16* stages, const bf16* kb,
                                       const bf16* vb, long long row,
                                       int k_first, int n_tiles, int k_end,
                                       int hd, bool vec, float scale_log2,
                                       const Visible& visible,
                                       const Full& full) {
  constexpr int kE = Tile<kD, kWG>::kKVElems;
  constexpr int kT = Tile<kD, kWG>::kThreads;
  auto issue = [&](int i) {
    bf16* ks = stages + (i & 1) * 2 * kE;
    const int k0 = k_first + i * kKeys;
    stage_rows<kD, kKeys, kT>(ks, [&](int r) -> const bf16* {
      return k0 + r < k_end ? kb + (k0 + r) * row : nullptr;
    }, hd, false, vec, kb);
    stage_rows<kD, kKeys, kT>(ks + kE, [&](int r) -> const bf16* {
      return k0 + r < k_end ? vb + (k0 + r) * row : nullptr;
    }, hd, true, vec, vb);
  };
  if (n_tiles > 0) issue(0);
  cp_async_commit();
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();                 // Q and tile i have landed
    fence_async_smem();
    __syncthreads();
    const bf16* ks = stages + (i & 1) * 2 * kE;
    const int k0 = k_first + i * kKeys;
    float s[8][4];
    uint32_t p[2][4][4];
    qk_product<kD>(s, qs, ks);
    if (full(k0))
      softmax_tile<kD, false>(a, s, p, k0, scale_log2, visible);
    else
      softmax_tile<kD, true>(a, s, p, k0, scale_log2, visible);
    pv_product<kD>(a.o, p, ks + kE);
    __syncthreads();                    // buffer i & 1 is free again
  }
  cp_async_wait<0>();
}

// Sum the row sums over the 4 lanes that share a row.
template <int kD>
__device__ __forceinline__ void reduce_rows(Acc<kD>& a) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a.l[h] += __shfl_xor_sync(0xffffffffu, a.l[h], 1);
    a.l[h] += __shfl_xor_sync(0xffffffffu, a.l[h], 2);
  }
}

// Hand every column pair of this thread's output to emit(h, col, x0, x1)
// (row half h, columns col and col + 1), multiplied by mul[h]; a pair
// starting at or past hd is never emitted, col + 1 == hd is (the emitter
// checks it).
template <int kD, typename Emit>
__device__ __forceinline__ void emit_rows(const Acc<kD>& a,
                                          const float (&mul)[2], int hd,
                                          const Emit& emit) {
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 8 * j + frag_col();
      if (col < hd)
        emit(h, col, a.o[j][2 * h] * mul[h], a.o[j][2 * h + 1] * mul[h]);
    }
}

// Store one row's pair of outputs at dst[0], dst[1] (dst[1] only when
// col + 1 < hd); a 4-byte store when the caller knows dst is aligned.
__device__ __forceinline__ void store_pair(bf16* dst, int col, int hd,
                                           float x0, float x1, bool vec) {
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
  } else {
    dst[0] = __float2bfloat16(x0);
    if (col + 1 < hd) dst[1] = __float2bfloat16(x1);
  }
}

// True when 16-byte copies can move every bf16 row: all base pointers
// 16-byte aligned, every row stride and hd a multiple of 8 elements.
__host__ inline bool rows16(std::initializer_list<const void*> ptrs,
                            std::initializer_list<long long> strides,
                            int hd) {
  bool ok = hd % 8 == 0;
  for (const void* p : ptrs)
    ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (long long s : strides) ok = ok && s % 8 == 0;
  return ok;
}

// Number of SMs of the current device, read once.
__host__ inline int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  }();
  return n;
}

// Once per kernel instantiation: allow the largest dynamic shared memory
// the device grants beside the kernel's static shared memory (the limit
// only caps a launch's request), so no launch pays for
// cudaFuncSetAttribute.  Thread-safe (a function-local static).
template <auto kernel>
__host__ inline cudaError_t allow_smem() {
  static const cudaError_t err = [] {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa = {};
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          optin - static_cast<int>(fa.sharedSizeBytes));
    return e;
  }();
  return err;
}

}  // namespace attn
}  // namespace repro
