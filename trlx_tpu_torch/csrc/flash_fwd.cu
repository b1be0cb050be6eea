// Flash-attention forward: online-softmax attention over full (uncached)
// sequences, emitting the output and the per-row logsumexp.
//
// Replaces: trlx_tpu/ops/flash_attention.py::_flash_fwd_impl
//   (_fwd_kernel, the pl.pallas_call at flash_attention.py:318).
//
// Semantics (those of the TPU kernel): key slot s is visible to query slot
// t iff key_mask[b, s] > 0.5, and (causal) s + k_off <= t + q_off, and
// (window > 0) (t + q_off) - (s + k_off) < window. With ALiBi slopes the
// score gains slope[h] * (kpos[b, s] - qpos[b, t]). K/V are unrepeated
// (GQA: q head h reads kv head h / (H / KV)). Scores, softmax and the
// output accumulator are f32 whatever the input type. A row that sees no
// key writes out = 0 and lse = NEG_INF (-1e30), never NaN.
//
// Layout: the model's, not the TPU kernel's: q/out (B, T, H, D),
// k/v (B, S, KV, D), key_mask (B, S) f32, qpos (B, T) / kpos (B, S) i32,
// lse (B, H, T) f32. T and S need not be multiples of the tiles: the ragged
// edge is masked here instead of padded by the caller.
//
// What bounds it on an H100: the work is 4 x B x H x (visible pairs) x D
// operations against (2 x B x T x H + 2 x B x S x KV) x D elements. At the
// training shape (B=16, T=S=104, H=12, D=64, causal) that is ~3 us of bytes
// and well under 1 us of tensor-core work, so latency bounds it: the
// dependent loads before a block's first product and the chain of products
// and softmax steps per key tile. At T = S = 1024 it is ~10 us of either.
// The first kernel computed in f32 on CUDA cores (one lane per key column,
// q.k and p.v as scalar loops out of shared memory, four barriers per
// 32-column tile): 96 us at the training shape, 4.9x cuDNN's.
//
// bf16 design (tensor cores: mma.sync m16n8k16, ldmatrix, cp.async; see
// mma_bf16.cuh), the shape of flash_bwd.cu's dq pass: one block of four
// warps per (64-query tile, head, row), each warp 16 query rows whose Q
// fragments stay in registers for the block's life. The visible 64-column
// K/V tiles (tiles wholly outside the band are skipped, as the TPU kernel
// bounds lo/hi) come through a two-stage cp.async ring with their key mask
// (and ALiBi positions), the next tile in flight while one computes, one
// barrier per tile. Per tile each warp forms S = Q K^T in f32 registers,
// the online softmax in the log2 domain (scores times sm_scale log2(e),
// ex2.approx, row max and sums by quad shuffles), P rounded to bf16 and fed
// back from registers as the A operand of P V (V by ldmatrix.trans). The
// key mask (and S's ragged end, whose rows are zero-filled) applies per key
// everywhere; the causal and window rules per element only in tiles on the
// band's edge, as one unsigned compare; a warp skips a tile none of its
// rows sees, and a warp past T skips every tile. ALiBi is a template
// parameter. Rounding: P becomes bf16 to enter P V (FA2's rounding). The
// output divides by the sum of the rounded P, so the weights that multiply
// V sum to one (as paged_prefill.cu); lse takes the f32 sum of the
// unrounded P, which the backward recomputes P against. A CPU emulation of
// this rounding (tests/test_torch_flash_attention.py) chose both.
// Head dims: the tensor-core kernel is compiled for D in {16, 32, 64, 128}
// and takes any D up to 128 padded inside its loads (attn_common.cuh);
// bf16 above 128 runs the CUDA-core kernel below, chosen by D in the C
// dispatch before the launch, which splits D above 256 into 256-column
// chunks (any D).
//
// f32 keeps the first version's CUDA-core kernel (scalar FMA from shared
// memory): the f32 parity runs hold the card to 1e-4 against the CPU,
// which bf16 (or TF32) tensor cores do not meet.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"
#include "mma_bf16.cuh"

namespace {

using attn::bf16;
using attn::clampi;
using attn::floordiv;
using attn::Geometry;

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// CUDA cores: f32, and bf16 at D > 128
// ---------------------------------------------------------------------------

constexpr int QT = 32;   // query rows per thread block
constexpr int KT = 32;   // key columns per tile (one per lane)
constexpr int NTH = 256;
constexpr int NWARP = NTH / 32;
constexpr int DCH = 256;  // head-dim chunk of the SPLIT kernel (D > 256)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* y) { *y = x; }
__device__ __forceinline__ void from_f(float x, bf16* y) { *y = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// one thread block per (q tile of QT rows, head, row): the q tile
// (pre-scaled) in shared memory, the visible K/V tiles of KT columns staged
// once each, a warp per row with one lane per key column (row max and sum
// by shuffles); K's rows padded to D + 1 floats against bank conflicts.
// SPLIT (D > 256, any D): grid x also counts ceil(D / DCH) output chunks.
// Per key tile the scores stream over the head dim: the q and K chunks of
// DCH columns land in the shared tiles in turn, each score's partial dot
// carried across them in shared memory (the additions in the order of one
// pass over D); the tile's V chunk lands with the first, and the block
// accumulates its own DCH output columns. Every chunk's block computes the
// same softmax; chunk 0 writes lse. No tile grows past DCH columns.
template <typename T, bool SPLIT>
__global__ void __launch_bounds__(NTH) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ kmask, const int32_t* __restrict__ qpos,
    const int32_t* __restrict__ kpos, const float* __restrict__ slopes,
    T* __restrict__ out, float* __restrict__ lse, Geometry g, float scale) {
  const int Tq = g.Tq, S = g.S, H = g.H, KV = g.KV, D = g.D;
  const int nch = SPLIT ? (D + DCH - 1) / DCH : 1;  // head-dim chunks
  const int oc = SPLIT ? blockIdx.x % nch : 0;      // this block's output chunk
  const int DC = SPLIT ? DCH : D;                   // columns a shared tile holds
  const int d0 = oc * DC, od = SPLIT ? min(DC, D - d0) : D;
  const int t0 = (SPLIT ? blockIdx.x / nch : blockIdx.x) * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nq = min(QT, Tq - t0);
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int DP = DC + 1;

  extern __shared__ float smem[];
  float* q_s = smem;            // QT * DC, pre-scaled
  float* k_s = q_s + QT * DC;   // KT * DP
  float* v_s = k_s + KT * DP;   // KT * DC
  float* p_s = v_s + KT * DC;   // QT * KT scores, then probabilities
  float* acc = p_s + QT * KT;   // QT * DC
  float* m_s = acc + QT * DC;   // QT running max
  float* l_s = m_s + QT;        // QT running sum
  float* a_s = l_s + QT;        // QT rescale factor of this tile
  float* qp_s = a_s + QT;       // QT query positions (ALiBi)

  for (int i = tid; i < QT * DC; i += NTH) {
    if (!SPLIT) {
      const int r = i / D, d = i % D;
      q_s[i] = r < nq ? to_f(q[(((size_t)b * Tq + t0 + r) * H + h) * D + d]) * scale : 0.f;
    }
    acc[i] = 0.f;
  }
  for (int r = tid; r < QT; r += NTH) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
    qp_s[r] = (slopes != nullptr && r < nq) ? (float)qpos[(size_t)b * Tq + t0 + r] : 0.f;
  }
  const float slope = slopes != nullptr ? slopes[h] : 0.f;
  __syncthreads();

  // key tiles any query of this tile can see
  const int nkt = (S + KT - 1) / KT;
  int hi = nkt, lo = 0;
  if (g.causal) hi = clampi(floordiv(g.q_off + t0 + nq - 1 - g.k_off, KT) + 1, 0, nkt);
  if (g.window > 0) lo = clampi(floordiv(g.q_off + t0 - (g.window - 1) - g.k_off, KT), 0, hi);

  for (int ik = lo; ik < hi; ++ik) {
    const int s0 = ik * KT;
    const int nk = min(KT, S - s0);
    if (SPLIT) {  // partial dots over the head-dim chunks, into p_s
      for (int cc = 0; cc < nch; ++cc) {
        const int c0 = cc * DC, w = min(DC, D - c0);
        for (int i = tid; i < QT * DC; i += NTH) {
          const int r = i / DC, d = i % DC;
          q_s[i] = r < nq && d < w
                       ? to_f(q[(((size_t)b * Tq + t0 + r) * H + h) * D + c0 + d]) * scale
                       : 0.f;
        }
        for (int i = tid; i < KT * DC; i += NTH) {
          const int c = i / DC, d = i % DC;
          const size_t off = (((size_t)b * S + s0 + c) * KV + kvh) * D;
          k_s[c * DP + d] = c < nk && d < w ? to_f(k[off + c0 + d]) : 0.f;
          if (cc == 0) v_s[c * DC + d] = c < nk && d < od ? to_f(v[off + d0 + d]) : 0.f;
        }
        __syncthreads();
        for (int i = tid; i < QT * KT; i += NTH) {
          const int r = i / KT, c = i % KT;
          float dot = cc == 0 ? 0.f : p_s[i];
          for (int d = 0; d < w; ++d) dot += q_s[r * DC + d] * k_s[c * DP + d];
          p_s[i] = dot;
        }
        __syncthreads();
      }
    } else {
      for (int i = tid; i < KT * D; i += NTH) {
        const int c = i / D, d = i % D;
        float kx = 0.f, vx = 0.f;
        if (c < nk) {
          const size_t off = (((size_t)b * S + s0 + c) * KV + kvh) * D + d;
          kx = to_f(k[off]);
          vx = to_f(v[off]);
        }
        k_s[c * DP + d] = kx;
        v_s[c * D + d] = vx;
      }
      __syncthreads();
    }
    for (int i = tid; i < QT * KT; i += NTH) {
      const int r = i / KT, c = i % KT;
      const int col = s0 + c;
      bool vis = r < nq && c < nk && kmask[(size_t)b * S + col] > 0.5f;
      const int qslot = g.q_off + t0 + r, kslot = g.k_off + col;
      if (g.causal) vis = vis && kslot <= qslot;
      if (g.window > 0) vis = vis && (qslot - kslot < g.window);
      float s = -INFINITY;  // invisible: no mass, never raises the max
      if (vis) {
        float dot = 0.f;
        if (SPLIT) {
          dot = p_s[i];
        } else {
          for (int d = 0; d < D; ++d) dot += q_s[r * D + d] * k_s[c * DP + d];
        }
        if (slopes != nullptr) dot += slope * ((float)kpos[(size_t)b * S + col] - qp_s[r]);
        s = dot;
      }
      p_s[i] = s;
    }
    __syncthreads();
    for (int r = warp; r < QT; r += NWARP) {
      const float s = p_s[r * KT + lane];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = (s == -INFINITY) ? 0.f : expf(s - m_new);
      const float sum = warp_sum(p);
      p_s[r * KT + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < QT * DC; i += NTH) {
      const int r = i / DC, d = i % DC;
      float a = acc[i] * a_s[r];
      for (int c = 0; c < KT; ++c) a += p_s[r * KT + c] * v_s[c * DC + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < nq * DC; i += NTH) {
    const int r = i / DC, d = i % DC;
    if (d >= od) continue;
    const float l = l_s[r];
    from_f(l > 0.f ? acc[i] / l : 0.f, &out[(((size_t)b * Tq + t0 + r) * H + h) * D + d0 + d]);
  }
  if (oc != 0) return;
  for (int r = tid; r < nq; r += NTH) {
    const float l = l_s[r];
    lse[((size_t)b * H + h) * Tq + t0 + r] = l > 0.f ? m_s[r] + logf(l) : NEG_INF;
  }
}

template <typename T, bool SPLIT>
int launch_cc_split(const void* q, const void* k, const void* v, const void* kmask,
                    const void* qpos, const void* kpos, const void* slopes, void* out,
                    void* lse, int B, const Geometry& g, float scale, cudaStream_t stream) {
  const int DC = SPLIT ? DCH : g.D, nch = SPLIT ? (g.D + DCH - 1) / DCH : 1;
  const size_t smem = sizeof(float) *
      ((size_t)QT * DC * 2 + (size_t)KT * (DC + 1) + (size_t)KT * DC + QT * KT + 4 * QT);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((g.Tq + QT - 1) / QT * nch, g.H, B);
  flash_fwd_kernel<T, SPLIT><<<grid, NTH, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)kmask,
      (const int32_t*)qpos, (const int32_t*)kpos, (const float*)slopes, (T*)out,
      (float*)lse, g, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cc(const void* q, const void* k, const void* v, const void* kmask,
              const void* qpos, const void* kpos, const void* slopes, void* out,
              void* lse, int B, const Geometry& g, float scale, cudaStream_t stream) {
  if (g.D > DCH)
    return launch_cc_split<T, true>(q, k, v, kmask, qpos, kpos, slopes, out, lse, B, g, scale,
                                    stream);
  return launch_cc_split<T, false>(q, k, v, kmask, qpos, kpos, slopes, out, lse, B, g, scale,
                                   stream);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_ROWS = 16 * MMA_WARPS;  // queries per block
constexpr int WT = 64;                    // keys per ring stage

// shared bytes: a two-stage ring of {K, V} tiles (rows padded to DT + 8
// elements, so that ldmatrix's eight row addresses fall in distinct banks)
// and of {key mask, key positions}
template <int DT>
__host__ __device__ constexpr int fwd_smem() {
  return 2 * (2 * WT * (DT + 8) * 2 + 2 * WT * 4);
}

// blocks per SM the compiler must allow: 3 at DT <= 64 (the training
// shape's 384 blocks in one wave), 2 at DT = 128
template <int DT>
__host__ __device__ constexpr int fwd_min_blocks() {
  return DT >= 128 ? 2 : 3;
}

// block (64-query tile, head, row); warp w owns queries w*16 .. w*16 + 15;
// lane (g, t) holds query rows g and g + 8 and, per n-tile of keys, key
// columns 2t and 2t + 1
template <int DT, bool ALIBI>
__global__ void __launch_bounds__(MMA_THREADS, fwd_min_blocks<DT>()) flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ kmask, const int32_t* __restrict__ qpos,
    const int32_t* __restrict__ kpos, const float* __restrict__ slopes,
    bf16* __restrict__ out, float* __restrict__ lse, Geometry g, float scale, int vec) {
  using namespace mma_bf16;
  using attn::exp2_approx;
  using attn::LOG2E;
  constexpr int P = DT + 8;
  constexpr int KD = DT / 16;  // k-steps of Q K^T
  constexpr int NK = WT / 8;   // n-tiles over the key tile
  constexpr int KK = WT / 16;  // k-steps of P V
  constexpr int ND = DT / 8;   // n-tiles of P V
  constexpr int STAGE = 2 * WT * P;  // {K, V} elements of one stage

  extern __shared__ __align__(16) unsigned char fwd_smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(fwd_smem_raw);
  float* vecs = reinterpret_cast<float*>(ring + 2 * STAGE);  // per stage: key mask, kpos

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3, mi = lane >> 3;
  const int t0 = blockIdx.x * MMA_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (g.H / g.KV);
  const int D = g.D;
  constexpr bool alibi = ALIBI;
  const float slope_l2 = alibi ? slopes[h] * LOG2E : 0.f;
  const size_t kv_stride = (size_t)g.KV * D;
  const attn::Band band = attn::make_band(g);
  const float scale_l2 = scale * LOG2E;
  const int lane_a = ((mi & 1) * 8 + (lane & 7)) * P + (mi >> 1) * 8;
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
    attn::copy_words<MMA_THREADS>(vd, kmask + (size_t)b * g.S + s0, WT, g.S - s0, 0u, tid);
    if (alibi)
      attn::copy_words<MMA_THREADS>(vd + WT, kpos + (size_t)b * g.S + s0, WT, g.S - s0, 0u, tid);
  };
  if (hi > lo) copy_tile(0);
  cp_async_commit();

  // this lane's query rows as A fragments (zero past T and past D), and
  // their ALiBi positions
  uint32_t qf[KD][4];
  float qp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + warp * 16 + gq + 8 * r;
    const bool ok = t < g.Tq;
    const bf16* qrow = q + (((size_t)b * g.Tq + (ok ? t : t0)) * g.H + h) * D;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      qf[kk][r] = ok ? attn::load_pair(qrow, kk * 16 + 2 * tq, D, vec) : 0u;
      qf[kk][2 + r] = ok ? attn::load_pair(qrow, kk * 16 + 8 + 2 * tq, D, vec) : 0u;
    }
    qp[r] = alibi && ok ? (float)qpos[(size_t)b * g.Tq + t] : 0.f;
  }

  // running max (log2 units), f32 sum (lse), sum of the rounded P (out)
  float m[2] = {-INFINITY, -INFINITY}, lf[2] = {0.f, 0.f}, lb[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
  const int wt0 = t0 + warp * 16;
  const bool live = wt0 < g.Tq;

  for (int i = 0; i < hi - lo; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    if (lo + i + 1 < hi) copy_tile(i + 1);
    cp_async_commit();
    const int s0 = (lo + i) * WT;
    if (!live || attn::band_misses(g, wt0, 16, s0, WT)) continue;
    const uint32_t k_addr = smem_addr(ring + (i & 1) * STAGE);  // the stage's K tile
    const uint32_t v_addr = k_addr + WT * P * 2;                 // ... and V tile
    const float* km_s = vecs + (i & 1) * 2 * WT;
    const int* kp_s = reinterpret_cast<const int*>(km_s + WT);
    const bool full = attn::band_covers(g, wt0, 16, s0, WT);

    // S = Q K^T: the warp's 16 queries x WT keys
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int kb = 0; kb < KK; ++kb) {
        uint32_t kf[4];  // keys kb*16 + 0-7 | 8-15, dims kk*16 + 0-7 | 8-15
        ldmatrix_x4(kf, k_addr + 2 * (lane_b + kb * 16 * P + kk * 16));
        mma_16816(s[2 * kb], qf[kk], kf[0], kf[1]);
        mma_16816(s[2 * kb + 1], qf[kk], kf[2], kf[3]);
      }

    // scores in log2 units on visible pairs, -inf elsewhere: the key mask
    // per column everywhere, the band per element only where the warp's
    // rows straddle its edge
    unsigned band_d[2];  // (q slot - k slot - band.lo) of row g (g + 8), column 2 tq
#pragma unroll
    for (int r = 0; r < 2; ++r)
      band_d[r] = (unsigned)(g.q_off + wt0 + gq + 8 * r - (g.k_off + s0 + 2 * tq)) -
                  (unsigned)band.lo;
    auto scores = [&](auto whole) {
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const int c = n * 8 + 2 * tq;
        const float2 km = *reinterpret_cast<const float2*>(km_s + c);
        const float kp0 = alibi ? (float)kp_s[c] : 0.f, kp1 = alibi ? (float)kp_s[c + 1] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            bool vis = (e ? km.y : km.x) > 0.5f;
            if (!decltype(whole)::value) vis = vis && band_d[r] - (unsigned)(n * 8 + e) < band.span;
            float x = s[n][2 * r + e] * scale_l2;
            if (alibi) x += slope_l2 * ((e ? kp1 : kp0) - qp[r]);
            s[n][2 * r + e] = vis ? x : -INFINITY;
          }
      }
    };
    if (full)
      scores(attn::Flag<true>{});
    else
      scores(attn::Flag<false>{});

    // online softmax over rows g and g + 8; P rounded to bf16 pairs (row
    // g | g + 8) per n-tile
    uint32_t pp[NK][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NK; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mnew = fmaxf(m[r], mx);
      const float alpha = mnew == -INFINITY ? 1.f : exp2_approx(m[r] - mnew);
      float sf = 0.f, sb = 0.f;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const float p0 = s[n][2 * r] == -INFINITY ? 0.f : exp2_approx(s[n][2 * r] - mnew);
        const float p1 = s[n][2 * r + 1] == -INFINITY ? 0.f : exp2_approx(s[n][2 * r + 1] - mnew);
        pp[n][r] = pack_bf16(p0, p1);
        const float2 pr = unpack_bf16(pp[n][r]);
        sf += p0 + p1;
        sb += pr.x + pr.y;
      }
      m[r] = mnew;
      lf[r] = lf[r] * alpha + sf;
      lb[r] = lb[r] * alpha + sb;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        acc[nd][2 * r] *= alpha;
        acc[nd][2 * r + 1] *= alpha;
      }
    }

    // O += P V: two n-tiles of P are one A fragment per 16 keys
#pragma unroll
    for (int ks = 0; ks < KK; ++ks) {
      const uint32_t pa[4] = {pp[2 * ks][0], pp[2 * ks][1], pp[2 * ks + 1][0], pp[2 * ks + 1][1]};
#pragma unroll
      for (int dp = 0; dp < DT / 16; ++dp) {
        uint32_t vf[4];  // keys ks*16 + 0-7 | 8-15, dims dp*16 + 0-7 | 8-15
        ldmatrix_x4_trans(vf, v_addr + 2 * (lane_a + ks * 16 * P + dp * 16));
        mma_16816(acc[2 * dp], pa, vf[0], vf[1]);
        mma_16816(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lf[r] += __shfl_xor_sync(0xffffffffu, lf[r], 1);
    lf[r] += __shfl_xor_sync(0xffffffffu, lf[r], 2);
    lb[r] += __shfl_xor_sync(0xffffffffu, lb[r], 1);
    lb[r] += __shfl_xor_sync(0xffffffffu, lb[r], 2);
    const int t = wt0 + gq + 8 * r;
    if (t >= g.Tq) continue;
    const float inv = lb[r] > 0.f ? 1.f / lb[r] : 0.f;
    bf16* orow = out + (((size_t)b * g.Tq + t) * g.H + h) * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      attn::store_pair(orow, nd * 8 + 2 * tq, D, vec, acc[nd][2 * r] * inv,
                       acc[nd][2 * r + 1] * inv);
    if (tq == 0)
      lse[((size_t)b * g.H + h) * g.Tq + t] =
          lf[r] > 0.f ? (m[r] + log2f(lf[r])) * attn::LN2 : NEG_INF;
  }
}

template <int DT, bool ALIBI>
int launch_mma(const void* q, const void* k, const void* v, const void* kmask,
               const void* qpos, const void* kpos, const void* slopes, void* out,
               void* lse, int B, const Geometry& g, float scale, int vec,
               cudaStream_t stream) {
  constexpr int smem = fwd_smem<DT>();
  auto kernel = flash_fwd_mma_kernel<DT, ALIBI>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3((g.Tq + MMA_ROWS - 1) / MMA_ROWS, g.H, B), MMA_THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)kmask,
      (const int32_t*)qpos, (const int32_t*)kpos, (const float*)slopes, (bf16*)out,
      (float*)lse, g, scale, vec);
  return (int)cudaGetLastError();
}

// ALiBi (slopes given) is a template parameter, so that the GPT-2 path
// carries none of its arithmetic
template <int DT>
int launch_bf16(const void* q, const void* k, const void* v, const void* kmask,
                const void* qpos, const void* kpos, const void* slopes, void* out,
                void* lse, int B, const Geometry& g, float scale, int vec,
                cudaStream_t stream) {
  if (slopes != nullptr)
    return launch_mma<DT, true>(q, k, v, kmask, qpos, kpos, slopes, out, lse, B, g, scale,
                                vec, stream);
  return launch_mma<DT, false>(q, k, v, kmask, qpos, kpos, slopes, out, lse, B, g, scale,
                               vec, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). qpos, kpos
// and slopes are null without ALiBi. bf16 at D <= 128 runs on tensor cores
// (D padded to 16, 32, 64 or 128 inside the loads), f32 and bf16 at
// D > 128 on CUDA cores, any D (above 256 split over the head dim).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* kmask, const void* qpos, const void* kpos,
                         const void* slopes, void* out, void* lse, int B, int Tq,
                         int S, int H, int KV, int D, int q_off, int k_off,
                         int causal, int window, float scale, int dtype,
                         void* stream) {
  const Geometry g{Tq, S, H, KV, D, q_off, k_off, causal, window};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_cc<float>(q, k, v, kmask, qpos, kpos, slopes, out, lse, B, g, scale, st);
  if (D > 128)
    return launch_cc<bf16>(q, k, v, kmask, qpos, kpos, slopes, out, lse, B, g, scale, st);
  const int vec = D % 8 == 0 && attn::aligned16(q) && attn::aligned16(k) &&
                  attn::aligned16(v) && attn::aligned16(out);
  switch (attn::padded_dim(D)) {
    case 16:
      return launch_bf16<16>(q, k, v, kmask, qpos, kpos, slopes, out, lse, B, g, scale, vec, st);
    case 32:
      return launch_bf16<32>(q, k, v, kmask, qpos, kpos, slopes, out, lse, B, g, scale, vec, st);
    case 64:
      return launch_bf16<64>(q, k, v, kmask, qpos, kpos, slopes, out, lse, B, g, scale, vec, st);
    default:
      return launch_bf16<128>(q, k, v, kmask, qpos, kpos, slopes, out, lse, B, g, scale, vec,
                              st);
  }
}
