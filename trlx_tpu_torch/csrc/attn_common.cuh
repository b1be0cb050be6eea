// Device code shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu) and the head-dim padding of every tensor-core attention
// kernel (those and paged_prefill.cu).
//
// Head-dim padding: a tensor-core kernel is compiled for a padded head dim
// DT in {16, 32, 64, 128} and takes the true D <= DT at run time. Rows land
// in shared memory DT wide (pitch DT + 8); columns past D are zero-filled,
// so they add nothing to q.k and give zero output columns, which are never
// stored. Global rows are read with their true stride (D elements), so no
// padded copy of any operand exists. Two copy paths, chosen by the launcher
// from the shape: `vec` when D % 8 == 0 and the operands are 16-byte
// aligned (16-byte cp.async segments, the segments past D zero-filled);
// otherwise element by element (a bf16 row of D = 12 is 24 bytes, 8-byte
// aligned), synchronous loads and 16-byte shared stores, which the rings'
// barriers order like the asynchronous copies.

#pragma once

#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace attn {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && (a < 0)) ? q - 1 : q;
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

struct Geometry {
  int Tq, S, H, KV, D, q_off, k_off, causal, window;
};

// The causal and window rules as one range test: a (query, key) pair is in
// the band when d = (q slot - k slot) lies in [lo, hi), lo = 0 if causal,
// hi = window if any; (unsigned)(d - lo) < hi - lo is one compare.
struct Band {
  int lo;
  unsigned span;
};

__device__ __forceinline__ Band make_band(const Geometry& g) {
  const int lo = g.causal ? 0 : INT_MIN;
  const int hi = g.window > 0 ? g.window : INT_MAX;
  return Band{lo, (unsigned)hi - (unsigned)lo};
}

// true when every (query, key) pair of the tiles [t0, t0 + nt) x [s0, s0 +
// ns) lies in the band
__device__ __forceinline__ bool band_covers(const Geometry& g, int t0, int nt, int s0, int ns) {
  const int qlo = g.q_off + t0, qhi = qlo + nt - 1;
  const int klo = g.k_off + s0, khi = klo + ns - 1;
  return (!g.causal || khi <= qlo) && (g.window <= 0 || qhi - klo < g.window);
}

// true when no (query, key) pair of those tiles lies in the band
__device__ __forceinline__ bool band_misses(const Geometry& g, int t0, int nt, int s0, int ns) {
  const int qlo = g.q_off + t0, qhi = qlo + nt - 1;
  const int klo = g.k_off + s0, khi = klo + ns - 1;
  return (g.causal && klo > qhi) || (g.window > 0 && qlo - khi >= g.window);
}

// 2^x (ex2.approx, flushing subnormals): p = 2^(s log2(e) - m)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// the padded head dim a tensor-core kernel is compiled for (D <= 128)
__host__ __forceinline__ int padded_dim(int D) {
  return D <= 16 ? 16 : (D <= 32 ? 32 : (D <= 64 ? 64 : 128));
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// elements [e0, e0 + 8) of a global row of D bf16 into 16 bytes of shared
// memory, zero where !valid or past D. `vec`: one 16-byte cp.async (D % 8
// == 0, aligned); otherwise element by element, synchronously.
__device__ __forceinline__ void copy_seg(bf16* dst, const bf16* row, int e0, int D, bool valid,
                                         bool vec) {
  if (vec) {
    const bool ok = valid && e0 < D;
    mma_bf16::cp_async_16(dst, ok ? row + e0 : row, ok);
    return;
  }
  const uint16_t* r16 = reinterpret_cast<const uint16_t*>(row);
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = e0 + 2 * j;
    const uint32_t lo = valid && e < D ? r16[e] : 0u;
    const uint32_t hi = valid && e + 1 < D ? r16[e + 1] : 0u;
    w[j] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// ROWS rows of D bf16 (row r at src + r * stride) into shared rows of DT
// columns at pitch DT + 8 by NT threads; rows >= valid and columns >= D are
// zero-filled
template <int DT, int ROWS, int NT>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, size_t stride, int valid,
                                          int D, bool vec, int tid) {
  constexpr int SEG = DT / 8;
#pragma unroll
  for (int i = tid; i < ROWS * SEG; i += NT) {
    const int r = i / SEG, sg = i % SEG;
    const bool ok = r < valid;
    copy_seg(dst + r * (DT + 8) + sg * 8, src + (ok ? r * stride : 0), sg * 8, D, ok, vec);
  }
}

// cp.async of n 4-byte words by NT threads; words >= valid are set to fill
template <int NT>
__device__ __forceinline__ void copy_words(void* dst, const void* src, int n, int valid,
                                           uint32_t fill, int tid) {
  uint32_t* d = static_cast<uint32_t*>(dst);
  for (int i = tid; i < n; i += NT) {
    if (i < valid)
      mma_bf16::cp_async_4(d + i, static_cast<const uint32_t*>(src) + i, true);
    else
      d[i] = fill;
  }
}

// bf16 elements e, e + 1 of a global row of D as one packed register (an
// A-fragment pair), zero past D
__device__ __forceinline__ uint32_t load_pair(const bf16* row, int e, int D, bool vec) {
  if (vec) return e < D ? *reinterpret_cast<const uint32_t*>(row + e) : 0u;
  const uint16_t* r = reinterpret_cast<const uint16_t*>(row);
  const uint32_t lo = e < D ? r[e] : 0u, hi = e + 1 < D ? r[e + 1] : 0u;
  return lo | (hi << 16);
}

// elements e, e + 1 of a global row of D, those past D not stored
__device__ __forceinline__ void store_pair(bf16* row, int e, int D, bool vec, float x, float y) {
  if (vec) {
    if (e < D) *reinterpret_cast<__nv_bfloat162*>(row + e) = __floats2bfloat162_rn(x, y);
    return;
  }
  if (e < D) row[e] = __float2bfloat16(x);
  if (e + 1 < D) row[e + 1] = __float2bfloat16(y);
}

}  // namespace attn
