// Flash-attention backward: dq, dk, dv by recomputation from the forward's
// logsumexp and delta = rowsum(do * out).
//
// Replaces: trlx_tpu/ops/flash_attention.py::_bwd_fused_call
//   (_bwd_fused_kernel, the pl.pallas_call at flash_attention.py:377;
//   also the kernel behind flash_attention_bwd_chunk).
//
// Math (that of the TPU kernel): with s = q . k * sm_scale (+ ALiBi) on
// visible pairs, p = exp(s - lse) * visible, dv = p^T do, dp = do v^T,
// ds = p * (dp - delta), dk = ds^T q * sm_scale, dq = ds k * sm_scale.
// Visibility is the forward's (key mask, causal slots with offsets, sliding
// window); rows and columns past T and S are masked, not padded.
//
// What bounds it on an H100: at the training shape (B=16, T=S=104, H=12,
// D=64, causal, left-padded) it reads q, k, v, do and writes dq, dk, dv,
// ~20 MB in bf16 (~6 us at 3.35 TB/s), and does ~0.6 GFLOP on the visible
// pairs (~0.6 us at the bf16 tensor-core peak); at the default config's
// length (B=4, T=S=1024) ~50 MB and ~16 GFLOP, both ~15 us. In practice
// the short rows are bound by latency: a block's first products wait for
// two dependent loads, and each tile pair is a chain of five products with
// a softmax step between. The first version ran every product as scalar
// f32 FMAs out of shared memory (CUDA cores, 67 TFLOP/s), 8x cuDNN's time.
//
// Design: the TPU kernel keeps dq resident across a k-block grid that runs
// in order; Hopper's blocks run in parallel in no order, so that does not
// carry over, and f32 atomics on dq would make results differ from run to
// run. This file keeps FA2's split instead, deterministic like the JAX
// kernel: two launches, both counted as this one kernel. The split costs a
// recomputation: the dq launch forms s, p and dp again, so a tile pair
// takes 7 products (s, dv, dp, dk; s, dp, dq) where the fused TPU kernel
// takes 5 (8 here in bf16, with p's low half below).
//
// bf16 (tensor cores: mma.sync m16n8k16, ldmatrix, cp.async rings; see
// mma_bf16.cuh). Four warps of 16 rows each:
//   1. dk/dv: one block per (64-key tile, kv head, row). The K and V tile
//      lands once in shared memory; the block loops over the q heads of
//      its GQA group and, for each, over the q tiles that can see the key
//      tile (the TPU kernel's lo/hi), so the group's partials sum inside
//      the block. Q and dO tiles with their lse and delta (and ALiBi
//      positions) come through a two-stage cp.async ring, the next tile in
//      flight while one computes, one barrier per tile. Per tile each warp
//      forms S^T = K Q^T (16 keys x the q tile), P^T in f32 registers,
//      dV += P^T dO with P^T fed back from registers as the A operand,
//      dP^T = V dO^T, dS^T = P^T (dP^T - delta) and dK += dS^T Q; dK and
//      dV stay in f32 registers to the end.
//   2. dq: one block per (64-query tile, head, row), Q and dO held as A
//      fragments in registers, K and V tiles with the key mask (and ALiBi
//      positions) through a two-stage ring over the visible key tiles:
//      S = Q K^T, P, dP = dO V^T, dS, dQ += dS K.
//   The other side's tile is 64 wide at D <= 64 and 32 at D = 128, where
//   the f32 dK/dV accumulators alone take 128 registers a thread.
//   sm_scale multiplies S in f32 after the product and dK and dQ once at
//   the end; Q is never pre-scaled into a bf16 tile, which would add a
//   rounding. exp runs as ex2.approx of log2(e)-scaled terms. The key mask
//   (and S's ragged end, whose rows are zero-filled) applies per key
//   everywhere; the causal and window rules per element only in tile
//   pairs that straddle the band's edge, as one unsigned compare; tiles
//   wholly outside the band are skipped. T's ragged end costs no test: in
//   dk/dv the missing queries' lse lands as +inf (p = 0), in dq the missing
//   rows are never stored (a row of dQ depends on its own row of dS alone).
//   ALiBi is a template parameter. At D <= 64 the compiler is held to three
//   blocks per SM (168 registers): the training shape's 384-block grids then
//   run in one wave, measured faster than two or four blocks per SM.
//   Rounding: the operands are bf16 and every product accumulates in f32.
//   P and dS must become bf16 to enter the second products (FA2's
//   rounding). dS rounds once. P enters dV as a bf16 high half plus a bf16
//   low half (p - hi), two mma: with one bf16 P the dv of chip_smoke.py's
//   GQA/D=128 check shape exceeded the bf16 gradient tolerance (2e-2 +
//   1e-2 rel) on 3 of 8 seeds of a CPU emulation of this rounding; with
//   the split none does (tests/test_torch_flash_attention.py runs the
//   emulation).
//   Head dims: the kernels are compiled for D in {16, 32, 64, 128} and take
//   any D up to 128 padded inside their loads (attn_common.cuh); bf16 above
//   128 runs the CUDA-core kernels below (at D = 256 the dk/dv accumulators
//   alone would take 256 f32 registers a lane), chosen by D in the C
//   dispatch before the launch; they split D above 256 into 256-column
//   chunks (any D).
//
// f32 keeps the first version's CUDA-core kernels (scalar FMA from shared
// memory, 32 x 32 tiles, q pre-scaled): the f32 parity runs hold the card
// to 1e-3 against the CPU, which bf16 (or TF32) tensor cores do not meet.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

#include "attn_common.cuh"
#include "mma_bf16.cuh"

namespace {

using attn::bf16;
using attn::clampi;
using attn::floordiv;
using attn::Geometry;

constexpr int QT = 32;  // query rows per tile (f32)
constexpr int KT = 32;  // key columns per tile (f32)
constexpr int NTH = 256;
constexpr int DCH = 256;  // head-dim chunk of the SPLIT kernels (D > 256)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* y) { *y = x; }
__device__ __forceinline__ void from_f(float x, bf16* y) { *y = __float2bfloat16(x); }

// visibility of (query row t, key column s) of one batch row
__device__ __forceinline__ bool visible(const Geometry& g, const float* kmask_row,
                                        int t, int s) {
  if (t >= g.Tq || s >= g.S || !(kmask_row[s] > 0.5f)) return false;
  const int qslot = g.q_off + t, kslot = g.k_off + s;
  if (g.causal && kslot > qslot) return false;
  if (g.window > 0 && qslot - kslot >= g.window) return false;
  return true;
}

// ---------------------------------------------------------------------------
// CUDA cores: f32, and bf16 at D > 128
// ---------------------------------------------------------------------------

// SPLIT (D > 256, any D), both kernels: grid x also counts ceil(D / DCH)
// output chunks. Per tile pair the scores s = q.k and dp = do.v stream over
// the head dim: q, do, K and V chunks of DCH columns land in the shared
// tiles in turn, the partial dots carried across them in shared memory,
// the chunks taken in the order that ends on the block's own output chunk,
// which then stays in the tiles for its products (dk, dv: q and do; dq: K).
// No tile grows past DCH columns; each output chunk recomputes s and dp.

// 1. dk / dv

template <typename T, bool SPLIT>
__global__ void __launch_bounds__(NTH) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ kmask, const int32_t* __restrict__ qpos,
    const int32_t* __restrict__ kpos, const float* __restrict__ slopes,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
    Geometry g, float scale) {
  const int nch = SPLIT ? (g.D + DCH - 1) / DCH : 1;  // head-dim chunks
  const int oc = SPLIT ? blockIdx.x % nch : 0;        // this block's output chunk
  const int s0 = (SPLIT ? blockIdx.x / nch : blockIdx.x) * KT;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int nk = min(KT, g.S - s0);
  const int D = g.D, DC = SPLIT ? DCH : D, DP = DC + 1;
  const int d0 = oc * DC, od = SPLIT ? min(DC, D - d0) : D;
  const int group = g.H / g.KV;
  const int tid = threadIdx.x;
  const float* kmask_row = kmask + (size_t)b * g.S;

  extern __shared__ float smem[];
  float* k_s = smem;             // KT * DP
  float* v_s = k_s + KT * DP;    // KT * DP
  float* dk_s = v_s + KT * DP;   // KT * DC
  float* dv_s = dk_s + KT * DC;  // KT * DC
  float* q_s = dv_s + KT * DC;   // QT * DC, pre-scaled
  float* do_s = q_s + QT * DC;   // QT * DC
  float* p_s = do_s + QT * DC;   // QT * KT
  float* ds_s = p_s + QT * KT;   // QT * KT
  float* lse_s = ds_s + QT * KT; // QT
  float* dl_s = lse_s + QT;      // QT
  float* qp_s = dl_s + QT;       // QT
  float* kp_s = qp_s + QT;       // KT

  for (int i = tid; i < KT * DC; i += NTH) {
    if (!SPLIT) {
      const int c = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (c < nk) {
        const size_t off = (((size_t)b * g.S + s0 + c) * g.KV + kvh) * D + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      k_s[c * DP + d] = kx;
      v_s[c * DP + d] = vx;
    }
    dk_s[i] = 0.f;
    dv_s[i] = 0.f;
  }
  for (int c = tid; c < KT; c += NTH)
    kp_s[c] = (slopes != nullptr && c < nk) ? (float)kpos[(size_t)b * g.S + s0 + c] : 0.f;
  __syncthreads();

  // q tiles that can see this k tile
  const int nqt = (g.Tq + QT - 1) / QT;
  int lo = 0, hi = nqt;
  if (g.causal) lo = clampi(floordiv(g.k_off + s0 - g.q_off, QT), 0, nqt);
  if (g.window > 0)
    hi = clampi(floordiv(g.k_off + s0 + nk - 1 + g.window - 1 - g.q_off, QT) + 1, lo, nqt);

  for (int j = 0; j < group; ++j) {
    const int h = kvh * group + j;
    const float slope = slopes != nullptr ? slopes[h] : 0.f;
    for (int iq = lo; iq < hi; ++iq) {
      const int t0 = iq * QT;
      const int nq = min(QT, g.Tq - t0);
      for (int i = tid; i < (SPLIT ? 0 : QT * D); i += NTH) {
        const int r = i / D, d = i % D;
        float qx = 0.f, dx = 0.f;
        if (r < nq) {
          const size_t off = (((size_t)b * g.Tq + t0 + r) * g.H + h) * D + d;
          qx = to_f(q[off]) * scale;
          dx = to_f(dout[off]);
        }
        q_s[i] = qx;
        do_s[i] = dx;
      }
      for (int r = tid; r < QT; r += NTH) {
        const size_t row = ((size_t)b * g.H + h) * g.Tq + t0 + r;
        lse_s[r] = r < nq ? lse[row] : 0.f;
        dl_s[r] = r < nq ? delta[row] : 0.f;
        qp_s[r] = (slopes != nullptr && r < nq) ? (float)qpos[(size_t)b * g.Tq + t0 + r] : 0.f;
      }
      if (SPLIT) {  // partial s (p_s) and dp (ds_s) over the chunks, own chunk last
        for (int n = 1; n <= nch; ++n) {
          const int cc = (oc + n) % nch, c0 = cc * DC, w = min(DC, D - c0);
          for (int i = tid; i < QT * DC; i += NTH) {
            const int r = i / DC, d = i % DC;
            float qx = 0.f, dx = 0.f;
            if (r < nq && d < w) {
              const size_t off = (((size_t)b * g.Tq + t0 + r) * g.H + h) * D + c0 + d;
              qx = to_f(q[off]) * scale;
              dx = to_f(dout[off]);
            }
            q_s[i] = qx;
            do_s[i] = dx;
          }
          for (int i = tid; i < KT * DC; i += NTH) {
            const int c = i / DC, d = i % DC;
            float kx = 0.f, vx = 0.f;
            if (c < nk && d < w) {
              const size_t off = (((size_t)b * g.S + s0 + c) * g.KV + kvh) * D + c0 + d;
              kx = to_f(k[off]);
              vx = to_f(v[off]);
            }
            k_s[c * DP + d] = kx;
            v_s[c * DP + d] = vx;
          }
          __syncthreads();
          for (int i = tid; i < QT * KT; i += NTH) {
            const int r = i / KT, c = i % KT;
            float s = n == 1 ? 0.f : p_s[i], dp = n == 1 ? 0.f : ds_s[i];
            for (int d = 0; d < w; ++d) {
              s += q_s[r * DC + d] * k_s[c * DP + d];
              dp += do_s[r * DC + d] * v_s[c * DP + d];
            }
            p_s[i] = s;
            ds_s[i] = dp;
          }
          if (n < nch) __syncthreads();
        }
      } else {
        __syncthreads();
      }
      for (int i = tid; i < QT * KT; i += NTH) {
        const int r = i / KT, c = i % KT;
        float p = 0.f, ds = 0.f;
        if (visible(g, kmask_row, t0 + r, s0 + c)) {
          float s = 0.f, dp = 0.f;
          if (SPLIT) {
            s = p_s[i];
            dp = ds_s[i];
          } else {
            for (int d = 0; d < D; ++d) {
              s += q_s[r * D + d] * k_s[c * DP + d];
              dp += do_s[r * D + d] * v_s[c * DP + d];
            }
          }
          if (slopes != nullptr) s += slope * (kp_s[c] - qp_s[r]);
          p = expf(s - lse_s[r]);
          ds = p * (dp - dl_s[r]);
        }
        p_s[i] = p;
        ds_s[i] = ds;
      }
      __syncthreads();
      for (int i = tid; i < KT * DC; i += NTH) {
        const int c = i / DC, d = i % DC;
        float a = dv_s[i], bk = dk_s[i];
        for (int r = 0; r < QT; ++r) {
          a += p_s[r * KT + c] * do_s[r * DC + d];
          bk += ds_s[r * KT + c] * q_s[r * DC + d];
        }
        dv_s[i] = a;
        dk_s[i] = bk;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < nk * DC; i += NTH) {
    const int c = i / DC, d = i % DC;
    if (d >= od) continue;
    const size_t off = (((size_t)b * g.S + s0 + c) * g.KV + kvh) * D + d0 + d;
    from_f(dk_s[i], &dk[off]);
    from_f(dv_s[i], &dv[off]);
  }
}

// ---------------------------------------------------------------------------
// 2. dq
// ---------------------------------------------------------------------------

template <typename T, bool SPLIT>
__global__ void __launch_bounds__(NTH) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ kmask, const int32_t* __restrict__ qpos,
    const int32_t* __restrict__ kpos, const float* __restrict__ slopes,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const T* __restrict__ dout, T* __restrict__ dq, Geometry g, float scale) {
  const int nch = SPLIT ? (g.D + DCH - 1) / DCH : 1;  // head-dim chunks
  const int oc = SPLIT ? blockIdx.x % nch : 0;        // this block's output chunk
  const int t0 = (SPLIT ? blockIdx.x / nch : blockIdx.x) * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nq = min(QT, g.Tq - t0);
  const int D = g.D, DC = SPLIT ? DCH : D, DP = DC + 1;
  const int d0 = oc * DC, od = SPLIT ? min(DC, D - d0) : D;
  const int kvh = h / (g.H / g.KV);
  const int tid = threadIdx.x;
  const float* kmask_row = kmask + (size_t)b * g.S;
  const float slope = slopes != nullptr ? slopes[h] : 0.f;

  extern __shared__ float smem[];
  float* q_s = smem;              // QT * DC, pre-scaled
  float* do_s = q_s + QT * DC;    // QT * DC
  float* dq_s = do_s + QT * DC;   // QT * DC
  float* k_s = dq_s + QT * DC;    // KT * DP
  float* v_s = k_s + KT * DP;     // KT * DP
  float* ds_s = v_s + KT * DP;    // QT * KT
  float* s_s = ds_s + QT * KT;    // QT * KT partial scores (SPLIT only)
  float* lse_s = s_s + (SPLIT ? QT * KT : 0);  // QT
  float* dl_s = lse_s + QT;       // QT
  float* qp_s = dl_s + QT;        // QT
  float* kp_s = qp_s + QT;        // KT

  for (int i = tid; i < QT * DC; i += NTH) {
    if (!SPLIT) {
      const int r = i / D, d = i % D;
      float qx = 0.f, dx = 0.f;
      if (r < nq) {
        const size_t off = (((size_t)b * g.Tq + t0 + r) * g.H + h) * D + d;
        qx = to_f(q[off]) * scale;
        dx = to_f(dout[off]);
      }
      q_s[i] = qx;
      do_s[i] = dx;
    }
    dq_s[i] = 0.f;
  }
  for (int r = tid; r < QT; r += NTH) {
    const size_t row = ((size_t)b * g.H + h) * g.Tq + t0 + r;
    lse_s[r] = r < nq ? lse[row] : 0.f;
    dl_s[r] = r < nq ? delta[row] : 0.f;
    qp_s[r] = (slopes != nullptr && r < nq) ? (float)qpos[(size_t)b * g.Tq + t0 + r] : 0.f;
  }
  __syncthreads();

  const int nkt = (g.S + KT - 1) / KT;
  int hi = nkt, lo = 0;
  if (g.causal) hi = clampi(floordiv(g.q_off + t0 + nq - 1 - g.k_off, KT) + 1, 0, nkt);
  if (g.window > 0) lo = clampi(floordiv(g.q_off + t0 - (g.window - 1) - g.k_off, KT), 0, hi);

  for (int ik = lo; ik < hi; ++ik) {
    const int s0 = ik * KT;
    const int nk = min(KT, g.S - s0);
    for (int i = tid; i < (SPLIT ? 0 : KT * D); i += NTH) {
      const int c = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (c < nk) {
        const size_t off = (((size_t)b * g.S + s0 + c) * g.KV + kvh) * D + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      k_s[c * DP + d] = kx;
      v_s[c * DP + d] = vx;
    }
    for (int c = tid; c < KT; c += NTH)
      kp_s[c] = (slopes != nullptr && c < nk) ? (float)kpos[(size_t)b * g.S + s0 + c] : 0.f;
    if (SPLIT) {  // partial s (s_s) and dp (ds_s) over the chunks, own chunk last
      for (int n = 1; n <= nch; ++n) {
        const int cc = (oc + n) % nch, c0 = cc * DC, w = min(DC, D - c0);
        for (int i = tid; i < QT * DC; i += NTH) {
          const int r = i / DC, d = i % DC;
          float qx = 0.f, dx = 0.f;
          if (r < nq && d < w) {
            const size_t off = (((size_t)b * g.Tq + t0 + r) * g.H + h) * D + c0 + d;
            qx = to_f(q[off]) * scale;
            dx = to_f(dout[off]);
          }
          q_s[i] = qx;
          do_s[i] = dx;
        }
        for (int i = tid; i < KT * DC; i += NTH) {
          const int c = i / DC, d = i % DC;
          float kx = 0.f, vx = 0.f;
          if (c < nk && d < w) {
            const size_t off = (((size_t)b * g.S + s0 + c) * g.KV + kvh) * D + c0 + d;
            kx = to_f(k[off]);
            vx = to_f(v[off]);
          }
          k_s[c * DP + d] = kx;
          v_s[c * DP + d] = vx;
        }
        __syncthreads();
        for (int i = tid; i < QT * KT; i += NTH) {
          const int r = i / KT, c = i % KT;
          float s = n == 1 ? 0.f : s_s[i], dp = n == 1 ? 0.f : ds_s[i];
          for (int d = 0; d < w; ++d) {
            s += q_s[r * DC + d] * k_s[c * DP + d];
            dp += do_s[r * DC + d] * v_s[c * DP + d];
          }
          s_s[i] = s;
          ds_s[i] = dp;
        }
        if (n < nch) __syncthreads();
      }
    } else {
      __syncthreads();
    }
    for (int i = tid; i < QT * KT; i += NTH) {
      const int r = i / KT, c = i % KT;
      float ds = 0.f;
      if (visible(g, kmask_row, t0 + r, s0 + c)) {
        float s = 0.f, dp = 0.f;
        if (SPLIT) {
          s = s_s[i];
          dp = ds_s[i];
        } else {
          for (int d = 0; d < D; ++d) {
            s += q_s[r * D + d] * k_s[c * DP + d];
            dp += do_s[r * D + d] * v_s[c * DP + d];
          }
        }
        if (slopes != nullptr) s += slope * (kp_s[c] - qp_s[r]);
        ds = expf(s - lse_s[r]) * (dp - dl_s[r]);
      }
      ds_s[i] = ds;
    }
    __syncthreads();
    for (int i = tid; i < QT * DC; i += NTH) {
      const int r = i / DC, d = i % DC;
      float a = dq_s[i];
      for (int c = 0; c < KT; ++c) a += ds_s[r * KT + c] * k_s[c * DP + d];
      dq_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < nq * DC; i += NTH) {
    const int r = i / DC, d = i % DC;
    if (d >= od) continue;
    from_f(dq_s[i] * scale, &dq[(((size_t)b * g.Tq + t0 + r) * g.H + h) * D + d0 + d]);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_ROWS = 16 * MMA_WARPS;  // a block's own tile: 64 keys (dk/dv) or queries (dq)

// width of the tiles a block walks: 64 at DT <= 64, 32 at DT = 128 (D is
// the padded head dim in these compile-time helpers)
template <int D>
__host__ __device__ constexpr int walk_tile() {
  return D >= 128 ? 32 : 64;
}

// shared bytes of the dk/dv kernel: K and V tiles, then a two-stage ring of
// {Q, dO} tiles and of {lse, delta, q positions}; rows padded to D + 8
// elements so that ldmatrix's eight row addresses fall in distinct banks
template <int D>
__host__ __device__ constexpr int dkdv_smem() {
  return 2 * MMA_ROWS * (D + 8) * 2 + 2 * (2 * walk_tile<D>() * (D + 8) * 2 + 3 * walk_tile<D>() * 4);
}

// shared bytes of the dq kernel: a two-stage ring of {K, V} tiles and of
// {key mask, key positions}
template <int D>
__host__ __device__ constexpr int dq_smem() {
  return 2 * (2 * walk_tile<D>() * (D + 8) * 2 + 2 * walk_tile<D>() * 4);
}

using attn::Band;
using attn::exp2_approx;
using attn::Flag;
using attn::LOG2E;

// blocks per SM the compiler must allow: 3 at D <= 64 (a one-wave grid at
// the training shape), 1 at D = 128 (whose dk/dv accumulators alone take
// 128 registers a thread)
template <int D>
__host__ __device__ constexpr int min_blocks() {
  return D >= 128 ? 1 : 3;
}

// 1. dk / dv: block (64-key tile, kv head, row); warp w owns keys w*16 ..
// w*16 + 15; lane (g, t) holds key rows g and g + 8 of the warp and, per
// n-tile of queries, query columns 2t and 2t + 1
template <int DT, bool ALIBI>
__global__ void __launch_bounds__(MMA_THREADS, min_blocks<DT>()) flash_bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ kmask, const int32_t* __restrict__ qpos,
    const int32_t* __restrict__ kpos, const float* __restrict__ slopes,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const bf16* __restrict__ dout, bf16* __restrict__ dk, bf16* __restrict__ dv,
    Geometry g, float scale, int vec) {
  using namespace mma_bf16;
  constexpr int WT = walk_tile<DT>();  // queries per ring stage
  constexpr int P = DT + 8;
  constexpr int KD = DT / 16;  // k-steps over D (padded)
  constexpr int NQ = WT / 8;   // n-tiles over the query tile
  constexpr int KQ = WT / 16;  // k-steps over the query tile
  constexpr int ND = DT / 8;   // n-tiles over D (padded)
  constexpr int STAGE = 2 * WT * P;  // {Q, dO} elements of one stage

  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(mma_smem);
  bf16* v_s = k_s + MMA_ROWS * P;
  bf16* ring = v_s + MMA_ROWS * P;
  float* vecs = reinterpret_cast<float*>(ring + 2 * STAGE);  // per stage: lse, delta, qpos

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3, mi = lane >> 3;
  const int s0 = blockIdx.x * MMA_ROWS, kvh = blockIdx.y, b = blockIdx.z;
  const int group = g.H / g.KV;
  constexpr bool alibi = ALIBI;
  const int D = g.D;
  const size_t kv_stride = (size_t)g.KV * D, q_stride = (size_t)g.H * D;
  const Band band = attn::make_band(g);
  const float scale_l2 = scale * LOG2E;
  // this lane's ldmatrix row offsets (elements): A fragments and transposed
  // B fragments take rows (mi & 1) * 8 + (lane & 7) and column half mi >> 1;
  // plain B fragments the other way round
  const int lane_a = ((mi & 1) * 8 + (lane & 7)) * P + (mi >> 1) * 8;
  const int lane_b = ((mi >> 1) * 8 + (lane & 7)) * P + (mi & 1) * 8;
  const uint32_t k_addr = smem_addr(k_s + warp * 16 * P + lane_a);
  const uint32_t v_addr = smem_addr(v_s + warp * 16 * P + lane_a);

  const size_t kv_off = (((size_t)b * g.S + s0) * g.KV + kvh) * D;
  attn::copy_rows<DT, MMA_ROWS, MMA_THREADS>(k_s, k + kv_off, kv_stride, g.S - s0, D, vec, tid);
  attn::copy_rows<DT, MMA_ROWS, MMA_THREADS>(v_s, v + kv_off, kv_stride, g.S - s0, D, vec, tid);

  // this lane's key rows: the key mask (and S's end), ALiBi positions
  bool kval[2];
  float kp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = s0 + warp * 16 + gq + 8 * r;
    kval[r] = s < g.S && kmask[(size_t)b * g.S + s] > 0.5f;
    kp[r] = alibi && s < g.S ? (float)kpos[(size_t)b * g.S + s] : 0.f;
  }

  // the q tiles that can see this key tile, for each head of the group
  const int nk = min(MMA_ROWS, g.S - s0);
  const int nqt = (g.Tq + WT - 1) / WT;
  int lo = 0, hi = nqt;
  if (g.causal) lo = clampi(floordiv(g.k_off + s0 - g.q_off, WT), 0, nqt);
  if (g.window > 0)
    hi = clampi(floordiv(g.k_off + s0 + nk - 1 + g.window - 1 - g.q_off, WT) + 1, lo, nqt);
  const int span = hi - lo, items = group * span;

  auto copy_item = [&](int i) {
    const int h = kvh * group + i / span, t0 = (lo + i % span) * WT;
    const int nt = g.Tq - t0;
    bf16* qd = ring + (i & 1) * STAGE;
    const size_t off = (((size_t)b * g.Tq + t0) * g.H + h) * D;
    attn::copy_rows<DT, WT, MMA_THREADS>(qd, q + off, q_stride, nt, D, vec, tid);
    attn::copy_rows<DT, WT, MMA_THREADS>(qd + WT * P, dout + off, q_stride, nt, D, vec, tid);
    float* vd = vecs + (i & 1) * 3 * WT;
    const size_t row = ((size_t)b * g.H + h) * g.Tq + t0;
    attn::copy_words<MMA_THREADS>(vd, lse + row, WT, nt, __float_as_uint(INFINITY), tid);  // p = 0 past T
    attn::copy_words<MMA_THREADS>(vd + WT, delta + row, WT, nt, 0u, tid);
    if (alibi)
      attn::copy_words<MMA_THREADS>(vd + 2 * WT, qpos + (size_t)b * g.Tq + t0, WT, nt, 0u, tid);
  };

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[n][j] = dv_acc[n][j] = 0.f;

  if (items > 0) copy_item(0);
  cp_async_commit();
  for (int i = 0; i < items; ++i) {
    cp_async_wait<0>();  // item i (and the K/V tile) landed for this thread
    __syncthreads();     // ... for every thread, and item i - 1 is done
    if (i + 1 < items) copy_item(i + 1);
    cp_async_commit();
    const int h = kvh * group + i / span, t0 = (lo + i % span) * WT;
    const float slope_l2 = alibi ? slopes[h] * LOG2E : 0.f;
    unsigned band_d[2];  // (q slot - k slot - band.lo) of column 2 tq, rows g, g + 8
#pragma unroll
    for (int r = 0; r < 2; ++r)
      band_d[r] = (unsigned)(g.q_off + t0 + 2 * tq - (g.k_off + s0 + warp * 16 + gq + 8 * r)) -
                  (unsigned)band.lo;
    const uint32_t q_addr = smem_addr(ring + (i & 1) * STAGE);  // the stage's Q tile
    const uint32_t o_addr = q_addr + WT * P * 2;                 // ... and dO tile
    const float* lse_s = vecs + (i & 1) * 3 * WT;
    const float* dl_s = lse_s + WT;
    const int* qp_s = reinterpret_cast<const int*>(lse_s + 2 * WT);
    const bool full = attn::band_covers(g, t0, WT, s0, MMA_ROWS);

    // S^T = K Q^T: the warp's 16 keys x WT queries
    float st[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[n][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4];
      ldmatrix_x4(ka, k_addr + kk * 32);
#pragma unroll
      for (int nb = 0; nb < KQ; ++nb) {
        uint32_t qb[4];  // queries nb*16 + 0-7 | 8-15, dims kk*16 + 0-7 | 8-15
        ldmatrix_x4(qb, q_addr + 2 * (lane_b + nb * 16 * P + kk * 16));
        mma_16816(st[2 * nb], ka, qb[0], qb[1]);
        mma_16816(st[2 * nb + 1], ka, qb[2], qb[3]);
      }
    }

    // P^T = exp(S^T sm_scale + ALiBi - lse) on visible pairs, in place: the
    // key mask per row everywhere, the band per element only where the
    // tile pair straddles its edge; columns past T have lse = +inf
    auto probs = [&](auto whole) {
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int c = n * 8 + 2 * tq;
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + c);
        const float qp0 = alibi ? (float)qp_s[c] : 0.f, qp1 = alibi ? (float)qp_s[c + 1] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = st[n][2 * r + e] * scale_l2 - (e ? ls.y : ls.x) * LOG2E;
            if (alibi) x += slope_l2 * (kp[r] - (e ? qp1 : qp0));
            bool vis = kval[r];
            if (!decltype(whole)::value) vis = vis && band_d[r] + (unsigned)(n * 8 + e) < band.span;
            st[n][2 * r + e] = vis ? exp2_approx(x) : 0.f;
          }
      }
    };
    if (full)
      probs(Flag<true>{});
    else
      probs(Flag<false>{});

    // dV += P^T dO, P^T as a bf16 high half and a bf16 low half
    uint32_t ph[NQ][2], pl[NQ][2];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ph[n][r] = pack_bf16(st[n][2 * r], st[n][2 * r + 1]);
        const float2 hf = unpack_bf16(ph[n][r]);
        pl[n][r] = pack_bf16(st[n][2 * r] - hf.x, st[n][2 * r + 1] - hf.y);
      }
#pragma unroll
    for (int ks = 0; ks < KQ; ++ks) {
      const uint32_t ah[4] = {ph[2 * ks][0], ph[2 * ks][1], ph[2 * ks + 1][0], ph[2 * ks + 1][1]};
      const uint32_t al[4] = {pl[2 * ks][0], pl[2 * ks][1], pl[2 * ks + 1][0], pl[2 * ks + 1][1]};
#pragma unroll
      for (int dp = 0; dp < DT / 16; ++dp) {
        uint32_t ob[4];  // queries ks*16 + 0-7 | 8-15, dims dp*16 + 0-7 | 8-15
        ldmatrix_x4_trans(ob, o_addr + 2 * (lane_a + ks * 16 * P + dp * 16));
        mma_16816(dv_acc[2 * dp], ah, ob[0], ob[1]);
        mma_16816(dv_acc[2 * dp + 1], ah, ob[2], ob[3]);
        mma_16816(dv_acc[2 * dp], al, ob[0], ob[1]);
        mma_16816(dv_acc[2 * dp + 1], al, ob[2], ob[3]);
      }
    }

    // dP^T = V dO^T
    float dpt[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) dpt[n][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t va[4];
      ldmatrix_x4(va, v_addr + kk * 32);
#pragma unroll
      for (int nb = 0; nb < KQ; ++nb) {
        uint32_t ob[4];
        ldmatrix_x4(ob, o_addr + 2 * (lane_b + nb * 16 * P + kk * 16));
        mma_16816(dpt[2 * nb], va, ob[0], ob[1]);
        mma_16816(dpt[2 * nb + 1], va, ob[2], ob[3]);
      }
    }

    // dS^T = P^T (dP^T - delta), rounded to bf16; dK += dS^T Q
    uint32_t dsa[NQ][2];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const float2 dl = *reinterpret_cast<const float2*>(dl_s + n * 8 + 2 * tq);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        dsa[n][r] = pack_bf16(st[n][2 * r] * (dpt[n][2 * r] - dl.x),
                              st[n][2 * r + 1] * (dpt[n][2 * r + 1] - dl.y));
    }
#pragma unroll
    for (int ks = 0; ks < KQ; ++ks) {
      const uint32_t a[4] = {dsa[2 * ks][0], dsa[2 * ks][1], dsa[2 * ks + 1][0], dsa[2 * ks + 1][1]};
#pragma unroll
      for (int dp = 0; dp < DT / 16; ++dp) {
        uint32_t qb[4];
        ldmatrix_x4_trans(qb, q_addr + 2 * (lane_a + ks * 16 * P + dp * 16));
        mma_16816(dk_acc[2 * dp], a, qb[0], qb[1]);
        mma_16816(dk_acc[2 * dp + 1], a, qb[2], qb[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = s0 + warp * 16 + gq + 8 * r;
    if (s >= g.S) continue;
    const size_t off = (((size_t)b * g.S + s) * g.KV + kvh) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      attn::store_pair(dk + off, n * 8 + 2 * tq, D, vec, dk_acc[n][2 * r] * scale,
                       dk_acc[n][2 * r + 1] * scale);
      attn::store_pair(dv + off, n * 8 + 2 * tq, D, vec, dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// 2. dq: block (64-query tile, head, row); warp w owns queries w*16 ..
// w*16 + 15; lane (g, t) holds query rows g and g + 8 and, per n-tile of
// keys, key columns 2t and 2t + 1
template <int DT, bool ALIBI>
__global__ void __launch_bounds__(MMA_THREADS, min_blocks<DT>()) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ kmask, const int32_t* __restrict__ qpos,
    const int32_t* __restrict__ kpos, const float* __restrict__ slopes,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const bf16* __restrict__ dout, bf16* __restrict__ dq, Geometry g, float scale, int vec) {
  using namespace mma_bf16;
  constexpr int WT = walk_tile<DT>();  // keys per ring stage
  constexpr int P = DT + 8;
  constexpr int KD = DT / 16;
  constexpr int NK = WT / 8;   // n-tiles over the key tile
  constexpr int KK = WT / 16;  // k-steps over the key tile
  constexpr int ND = DT / 8;
  constexpr int STAGE = 2 * WT * P;  // {K, V} elements of one stage

  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* ring = reinterpret_cast<bf16*>(mma_smem);
  float* vecs = reinterpret_cast<float*>(ring + 2 * STAGE);  // per stage: key mask, kpos

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3, mi = lane >> 3;
  const int t0 = blockIdx.x * MMA_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (g.H / g.KV);
  constexpr bool alibi = ALIBI;
  const float slope_l2 = alibi ? slopes[h] * LOG2E : 0.f;
  const int D = g.D;
  const size_t kv_stride = (size_t)g.KV * D;
  const Band band = attn::make_band(g);
  const float scale_l2 = scale * LOG2E;
  const int lane_a = ((mi & 1) * 8 + (lane & 7)) * P + (mi >> 1) * 8;  // as in dk/dv
  const int lane_b = ((mi >> 1) * 8 + (lane & 7)) * P + (mi & 1) * 8;

  // the visible key tiles
  const int nq = min(MMA_ROWS, g.Tq - t0);
  const int nkt = (g.S + WT - 1) / WT;
  int lo = 0, hi = nkt;
  if (g.causal) hi = clampi(floordiv(g.q_off + t0 + nq - 1 - g.k_off, WT) + 1, 0, nkt);
  if (g.window > 0) lo = clampi(floordiv(g.q_off + t0 - (g.window - 1) - g.k_off, WT), 0, hi);

  auto copy_tile = [&](int i) {
    const int s0 = (lo + i) * WT;
    bf16* kd = ring + (i & 1) * STAGE;
    const size_t off = (((size_t)b * g.S + s0) * g.KV + kvh) * D;
    attn::copy_rows<DT, WT, MMA_THREADS>(kd, k + off, kv_stride, g.S - s0, D, vec, tid);
    attn::copy_rows<DT, WT, MMA_THREADS>(kd + WT * P, v + off, kv_stride, g.S - s0, D, vec, tid);
    float* vd = vecs + (i & 1) * 2 * WT;
    attn::copy_words<MMA_THREADS>(vd, kmask + (size_t)b * g.S + s0, WT, g.S - s0, 0u,
                                  tid);  // masked past S
    if (alibi)
      attn::copy_words<MMA_THREADS>(vd + WT, kpos + (size_t)b * g.S + s0, WT, g.S - s0, 0u, tid);
  };
  if (hi > lo) copy_tile(0);
  cp_async_commit();

  // this lane's query rows: Q and dO as A fragments, lse (times log2(e)),
  // delta, position. Rows past T are computed and never stored: a row of
  // dQ depends on its own row of dS alone.
  uint32_t qf[KD][4], of[KD][4];
  bool qval[2];
  float ls[2], dl[2], qp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + warp * 16 + gq + 8 * r;
    qval[r] = t < g.Tq;
    const size_t off = (((size_t)b * g.Tq + (qval[r] ? t : t0)) * g.H + h) * D;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      qf[kk][r] = qval[r] ? attn::load_pair(q + off, kk * 16 + 2 * tq, D, vec) : 0u;
      qf[kk][2 + r] = qval[r] ? attn::load_pair(q + off, kk * 16 + 8 + 2 * tq, D, vec) : 0u;
      of[kk][r] = qval[r] ? attn::load_pair(dout + off, kk * 16 + 2 * tq, D, vec) : 0u;
      of[kk][2 + r] = qval[r] ? attn::load_pair(dout + off, kk * 16 + 8 + 2 * tq, D, vec) : 0u;
    }
    const size_t row = ((size_t)b * g.H + h) * g.Tq + (qval[r] ? t : t0);
    ls[r] = lse[row] * LOG2E;
    dl[r] = delta[row];
    qp[r] = alibi ? (float)qpos[(size_t)b * g.Tq + (qval[r] ? t : t0)] : 0.f;
  }

  float dq_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq_acc[n][j] = 0.f;

  for (int i = 0; i < hi - lo; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    if (lo + i + 1 < hi) copy_tile(i + 1);
    cp_async_commit();
    const int s0 = (lo + i) * WT;
    const uint32_t k_addr = smem_addr(ring + (i & 1) * STAGE);  // the stage's K tile
    const uint32_t v_addr = k_addr + WT * P * 2;                 // ... and V tile
    const float* km_s = vecs + (i & 1) * 2 * WT;
    const int* kp_s = reinterpret_cast<const int*>(km_s + WT);
    const bool full = attn::band_covers(g, t0, MMA_ROWS, s0, WT);

    // S = Q K^T and dP = dO V^T: the warp's 16 queries x WT keys
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = dp[n][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int kb = 0; kb < KK; ++kb) {
        uint32_t kf[4], vf[4];  // keys kb*16 + 0-7 | 8-15, dims kk*16 + 0-7 | 8-15
        ldmatrix_x4(kf, k_addr + 2 * (lane_b + kb * 16 * P + kk * 16));
        ldmatrix_x4(vf, v_addr + 2 * (lane_b + kb * 16 * P + kk * 16));
        mma_16816(s[2 * kb], qf[kk], kf[0], kf[1]);
        mma_16816(s[2 * kb + 1], qf[kk], kf[2], kf[3]);
        mma_16816(dp[2 * kb], of[kk], vf[0], vf[1]);
        mma_16816(dp[2 * kb + 1], of[kk], vf[2], vf[3]);
      }

    // P = exp(S sm_scale + ALiBi - lse) on visible pairs (the key mask per
    // column everywhere, the band per element only where the tile pair
    // straddles its edge); dS = P (dP - delta), rounded to bf16 pairs (row
    // g | g + 8) per n-tile
    unsigned band_d[2];  // (q slot - k slot - band.lo) of row g (g + 8), column 2 tq
#pragma unroll
    for (int r = 0; r < 2; ++r)
      band_d[r] = (unsigned)(g.q_off + t0 + warp * 16 + gq + 8 * r - (g.k_off + s0 + 2 * tq)) -
                  (unsigned)band.lo;
    uint32_t dsa[NK][2];
    auto grads = [&](auto whole) {
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const int c = n * 8 + 2 * tq;
        const float2 km = *reinterpret_cast<const float2*>(km_s + c);
        const float kp0 = alibi ? (float)kp_s[c] : 0.f, kp1 = alibi ? (float)kp_s[c + 1] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float d2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            bool vis = (e ? km.y : km.x) > 0.5f;
            if (!decltype(whole)::value)
              vis = vis && band_d[r] - (unsigned)(n * 8 + e) < band.span;
            float x = s[n][2 * r + e] * scale_l2 - ls[r];
            if (alibi) x += slope_l2 * ((e ? kp1 : kp0) - qp[r]);
            const float p = vis ? exp2_approx(x) : 0.f;
            d2[e] = p * (dp[n][2 * r + e] - dl[r]);
          }
          dsa[n][r] = pack_bf16(d2[0], d2[1]);
        }
      }
    };
    if (full)
      grads(Flag<true>{});
    else
      grads(Flag<false>{});

    // dQ += dS K
#pragma unroll
    for (int ks = 0; ks < KK; ++ks) {
      const uint32_t a[4] = {dsa[2 * ks][0], dsa[2 * ks][1], dsa[2 * ks + 1][0], dsa[2 * ks + 1][1]};
#pragma unroll
      for (int dd = 0; dd < DT / 16; ++dd) {
        uint32_t kf[4];  // keys ks*16 + 0-7 | 8-15, dims dd*16 + 0-7 | 8-15
        ldmatrix_x4_trans(kf, k_addr + 2 * (lane_a + ks * 16 * P + dd * 16));
        mma_16816(dq_acc[2 * dd], a, kf[0], kf[1]);
        mma_16816(dq_acc[2 * dd + 1], a, kf[2], kf[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!qval[r]) continue;
    const int t = t0 + warp * 16 + gq + 8 * r;
    bf16* row = dq + (((size_t)b * g.Tq + t) * g.H + h) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      attn::store_pair(row, n * 8 + 2 * tq, D, vec, dq_acc[n][2 * r] * scale,
                       dq_acc[n][2 * r + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T, bool SPLIT>
int launch_cc_split(const void* q, const void* k, const void* v, const void* kmask,
                    const void* qpos, const void* kpos, const void* slopes,
                    const void* lse, const void* delta, const void* dout, void* dq,
                    void* dk, void* dv, int B, const Geometry& g, float scale,
                    cudaStream_t stream) {
  const int DC = SPLIT ? DCH : g.D, nch = SPLIT ? (g.D + DCH - 1) / DCH : 1;
  const size_t smem_kv = sizeof(float) *
      ((size_t)2 * KT * (DC + 1) + (size_t)2 * KT * DC + (size_t)2 * QT * DC +
       2 * QT * KT + 3 * QT + KT);
  const size_t smem_q = sizeof(float) *
      ((size_t)3 * QT * DC + (size_t)2 * KT * (DC + 1) + (SPLIT ? 2 : 1) * QT * KT + 3 * QT +
       KT);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, SPLIT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, SPLIT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  dim3 grid_kv((g.S + KT - 1) / KT * nch, g.KV, B);
  flash_bwd_dkdv_kernel<T, SPLIT><<<grid_kv, NTH, smem_kv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)kmask,
      (const int32_t*)qpos, (const int32_t*)kpos, (const float*)slopes,
      (const float*)lse, (const float*)delta, (const T*)dout, (T*)dk, (T*)dv, g, scale);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  dim3 grid_q((g.Tq + QT - 1) / QT * nch, g.H, B);
  flash_bwd_dq_kernel<T, SPLIT><<<grid_q, NTH, smem_q, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)kmask,
      (const int32_t*)qpos, (const int32_t*)kpos, (const float*)slopes,
      (const float*)lse, (const float*)delta, (const T*)dout, (T*)dq, g, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cc(const void* q, const void* k, const void* v, const void* kmask,
              const void* qpos, const void* kpos, const void* slopes,
              const void* lse, const void* delta, const void* dout, void* dq,
              void* dk, void* dv, int B, const Geometry& g, float scale,
              cudaStream_t stream) {
  if (g.D > DCH)
    return launch_cc_split<T, true>(q, k, v, kmask, qpos, kpos, slopes, lse, delta, dout, dq,
                                    dk, dv, B, g, scale, stream);
  return launch_cc_split<T, false>(q, k, v, kmask, qpos, kpos, slopes, lse, delta, dout, dq,
                                   dk, dv, B, g, scale, stream);
}

template <int DT, bool ALIBI>
int launch_mma(const void* q, const void* k, const void* v, const void* kmask,
               const void* qpos, const void* kpos, const void* slopes, const void* lse,
               const void* delta, const void* dout, void* dq, void* dk, void* dv, int B,
               const Geometry& g, float scale, int vec, cudaStream_t stream) {
  constexpr int smem_kv = dkdv_smem<DT>(), smem_q = dq_smem<DT>();
  auto dkdv = flash_bwd_dkdv_mma_kernel<DT, ALIBI>;
  auto dqk = flash_bwd_dq_mma_kernel<DT, ALIBI>;
  cudaError_t e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (e != cudaSuccess) return (int)e;
  dkdv<<<dim3((g.S + MMA_ROWS - 1) / MMA_ROWS, g.KV, B), MMA_THREADS, smem_kv, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)kmask,
      (const int32_t*)qpos, (const int32_t*)kpos, (const float*)slopes, (const float*)lse,
      (const float*)delta, (const bf16*)dout, (bf16*)dk, (bf16*)dv, g, scale, vec);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  dqk<<<dim3((g.Tq + MMA_ROWS - 1) / MMA_ROWS, g.H, B), MMA_THREADS, smem_q, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)kmask,
      (const int32_t*)qpos, (const int32_t*)kpos, (const float*)slopes, (const float*)lse,
      (const float*)delta, (const bf16*)dout, (bf16*)dq, g, scale, vec);
  return (int)cudaGetLastError();
}

// ALiBi (slopes given) is a template parameter, so that the GPT-2 path
// carries none of its arithmetic
template <int DT>
int launch_bf16(const void* q, const void* k, const void* v, const void* kmask,
                const void* qpos, const void* kpos, const void* slopes,
                const void* lse, const void* delta, const void* dout, void* dq,
                void* dk, void* dv, int B, const Geometry& g, float scale, int vec,
                cudaStream_t stream) {
  if (slopes != nullptr)
    return launch_mma<DT, true>(q, k, v, kmask, qpos, kpos, slopes, lse, delta, dout, dq, dk,
                                dv, B, g, scale, vec, stream);
  return launch_mma<DT, false>(q, k, v, kmask, qpos, kpos, slopes, lse, delta, dout, dq, dk,
                               dv, B, g, scale, vec, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the three gradients
// share it). lse and delta are (B, H, T) f32; qpos, kpos and slopes are
// null without ALiBi. bf16 at D <= 128 runs on tensor cores (D padded to
// 16, 32, 64 or 128 inside the loads), f32 and bf16 at D > 128 on CUDA
// cores, any D (above 256 split over the head dim).
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* kmask, const void* qpos, const void* kpos,
                         const void* slopes, const void* lse, const void* delta,
                         const void* dout, void* dq, void* dk, void* dv, int B,
                         int Tq, int S, int H, int KV, int D, int q_off,
                         int k_off, int causal, int window, float scale,
                         int dtype, void* stream) {
  const Geometry g{Tq, S, H, KV, D, q_off, k_off, causal, window};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_cc<float>(q, k, v, kmask, qpos, kpos, slopes, lse, delta, dout, dq, dk, dv,
                            B, g, scale, st);
  if (D > 128)
    return launch_cc<bf16>(q, k, v, kmask, qpos, kpos, slopes, lse, delta, dout, dq, dk, dv,
                           B, g, scale, st);
  const int vec = D % 8 == 0 && attn::aligned16(q) && attn::aligned16(k) &&
                  attn::aligned16(v) && attn::aligned16(dout) && attn::aligned16(dq) &&
                  attn::aligned16(dk) && attn::aligned16(dv);
  switch (attn::padded_dim(D)) {
    case 16:
      return launch_bf16<16>(q, k, v, kmask, qpos, kpos, slopes, lse, delta, dout, dq, dk, dv,
                             B, g, scale, vec, st);
    case 32:
      return launch_bf16<32>(q, k, v, kmask, qpos, kpos, slopes, lse, delta, dout, dq, dk, dv,
                             B, g, scale, vec, st);
    case 64:
      return launch_bf16<64>(q, k, v, kmask, qpos, kpos, slopes, lse, delta, dout, dq, dk, dv,
                             B, g, scale, vec, st);
    default:
      return launch_bf16<128>(q, k, v, kmask, qpos, kpos, slopes, lse, delta, dout, dq, dk,
                              dv, B, g, scale, vec, st);
  }
}
