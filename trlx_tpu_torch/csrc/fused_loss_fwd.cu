// Fused PPO loss forward: reversed GAE, masked whitening, the clipped
// policy and value losses, every scalar stat of PPOConfig.loss and the four
// dist/* sketches, in one kernel. It also leaves the backward's residuals:
// the raw advantages and returns, the whitening mean and inverse std, and
// n = max(sum(mask), 1).
//
// Replaces: trlx_tpu/ops/fused_loss.py::_fwd_call
//   (_fused_loss_fwd_kernel, the pl.pallas_call at fused_loss.py:274).
//
// What bounds it on an H100: the operands are six or seven (B, R) f32
// arrays (B x R = 640 at the training shape, 4096 at 32 x 128), a few
// microseconds of bytes at most; what sets the time is latency: the launch,
// the dependent steps of the GAE recurrence, and the block reductions that
// the whitening and the stats need before anything can finish (they span
// the whole mask, so one block carries the batch). Inside the block the
// scarce unit is the SM's shuffle and vote path (one warp instruction a
// clock): a first redesign with a warp per row and a 5-step butterfly per
// reduced value read 8.9 us at the training shape and grew with the warp
// count (13.1 us at 32 x 40), so this one counts shuffles.
//
// The first version gave each row one thread that ran all R steps
// of GAE through global memory, read the operands in four passes, ran six
// block reductions of three barriers each and binned the sketches with
// shared-memory atomics on a handful of addresses (the KL values all land
// in bin 0): 21.5 us at the training shape. This design:
// - Ownership: a row belongs to a group of LPR lanes (8, 16 or 32, so that
//   a lane holds C = ceil(R / LPR) <= 4 columns up to R = 128); a warp holds
//   32 / LPR groups, the block at most 16 warps, and rows beyond the block's
//   groups take further passes. Every pass after the first works on the
//   thread's own elements, so no barrier separates them but the
//   reductions' own.
// - Each operand element is read from global memory once: the thread
//   copies its elements of every operand into shared memory, laid out
//   [operand][slot][thread] (conflict-free), up to STAGE_BYTES (B x R about
//   5,600 elements; the three measured shapes fit). Larger batches run the
//   same code reading global memory in every pass (a template parameter).
// - GAE as a segmented scan: A_t = delta_t + c A_{t+1} (c = gamma lam,
//   rounded once) is a first-order linear recurrence. Each lane runs it
//   backwards over its own chunk from A = 0, giving the pair (c^len,
//   A_first); a log2(LPR)-step Kogge-Stone shuffle scan inside the group
//   composes the pairs from the right ((a, b) o (a', b') = (a a', b + a
//   b')), and a fix-up adds c^(end - t) times the carry from the lanes to
//   the right: 2 C + log2(LPR) dependent steps instead of R. The
//   reassociation's rounding was checked on the CPU against the JAX GAE
//   (tests/test_torch_fused_loss.py emulates this scan).
// - Three block reductions, one barrier each, and only what every thread
//   needs folded by every warp: (1) mask sum and the first moments of adv,
//   v, ov and ret (the means every thread needs), with the masked minima
//   and maxima of v, ov and ret; (2) the centred second moments of all
//   four (the reference's two-pass variance); (3) the losses' and stats'
//   sums with the sketches. A warp folds N values over its lanes by
//   halving (N / 2 + N / 4 + ... shuffles, 2 N - 1 + 5 - log2 N in all,
//   not 5 N), and only the sums of (1) and the advantage variance of (2)
//   are folded across the warps by every warp after the barrier; at the
//   end warp 0 folds the losses' sums while warp 1 folds the extrema and
//   the other moments, each writing its own stats.
// - Sketches without atomics: for each element slot a warp's 32 values are
//   counted into lane-owned bins by ballots on the 5 bits of the bin index
//   (lane j keeps the popcount of the lanes whose index is j; one ballot of
//   the weights serves the four sketches), exact for the 0/1 masks the
//   trainer passes; other weights take a 32-step shuffle walk in lane
//   order. The warps' bins merge after the last barrier in warp order.
//   Counts are integers in f32, so bins equal the plain version's and are
//   the same bits from call to call. Bins truncate toward zero, then clip
//   into 32 (the JAX astype(int32)).
// Scalars are packed in the sorted key order the JAX package discovers
// (fused_loss.py::_stat_keys), the IW pair first; the wrapper drops the
// pair when the IW correction is off.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "fused_loss_common.cuh"

namespace {

using namespace fused_loss;

constexpr int BINS = 32;
constexpr int MAX_WARPS = 16;
constexpr unsigned FULL = 0xffffffffu;
// dynamic shared memory a staged launch may take (the static arrays hold
// ~9 KB of the 227 KB a block can have)
constexpr int STAGE_BYTES = 200 * 1024;

// scalar slots, in sorted key order
enum Stat {
  IW_RHO_CLIPFRAC, IW_RHO_MEAN,
  LOSS_POLICY, LOSS_TOTAL, LOSS_VALUE,
  OV_MAX, OV_MEAN, OV_MIN, OV_STD,
  PADDING,
  POLICY_APPROX_KL, POLICY_CLIPFRAC,
  RATIO,
  RET_MAX, RET_MEAN, RET_MIN, RET_STD,
  V_CLIPFRAC, V_MAX, V_MEAN, V_MIN, V_STD, V_ERROR,
  N_STATS
};
// sketch rows, in sorted key order (ranges: observability SKETCH_RANGES)
enum Sketch { H_ADV, H_KL, H_LOG_RATIO, H_VALUE_ERROR, N_SKETCH };
// operand slots: the inputs, then the raw advantages and returns
enum Op { LP, V, OLP, OV, RW, MASK, BLP, ADV, RET, N_OPS };
// the reduced values. Sums: (1) every warp needs S_MASK .. S_RET; (2) every
// warp needs Q_ADV, warp 0 the rest; (3) the losses' sums. Minima: of v, ov,
// ret and of their negatives (the maxima), for warp 0.
enum Sum1 { S_MASK, S_ADV, S_V, S_OV, S_RET, N_SUM1 };
enum Sum2 { Q_ADV, Q_V, Q_OV, Q_RET, N_SUM2 };
enum Sum3 { VF, VF_CF, KL, PG, PG_CF, RHO, RHO_CF, RAT, VERR, N_SUM3 };
enum Min1 { MIN_V, MIN_OV, MIN_RET, NMAX_V, NMAX_OV, NMAX_RET, N_MIN1 };

struct Ptrs {
  const float* in[BLP + 1];  // lp, v, olp, ov, rw, mask, blp (null without IW)
  float* adv;                // (B, R) raw advantages (residual)
  float* ret;                // (B, R) returns (residual)
  float* loss;               // 1
  float* stats;              // N_STATS
  float* hists;              // N_SKETCH x BINS
  float* moments;            // N_MOMENTS (residual)
};

template <bool MIN>
__device__ __forceinline__ float fold_op(float a, float b) {
  return MIN ? fminf(a, b) : a + b;
}

// The warp's fold of N values (N a power of 2, at most 32) over its 32
// lanes by halving: at the step of offset o the lanes with bit o set keep
// the upper half of their values and send the lower, so N / 2 + N / 4 +
// ... shuffles carry the N totals, then the remaining lane bits fold the
// one left. Lane l returns the total of value l >> (5 - log2 N); every lane
// holding one value holds the same bits (a + b == b + a).
template <int N, bool MIN>
__device__ __forceinline__ float warp_fold(float (&x)[N]) {
  constexpr int LOGN = N >= 32 ? 5 : N >= 16 ? 4 : N >= 8 ? 3 : N >= 4 ? 2 : N >= 2 ? 1 : 0;
  static_assert((1 << LOGN) == N, "N must be a power of 2 up to 32");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < LOGN; ++s) {
    const int o = 16 >> s, h = N >> (s + 1);
    // the halves picked by bit masks, not by a select of array elements
    // (which the compiler turns into an indexed load from local memory)
    const unsigned up = (lane & o) ? FULL : 0u;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const unsigned lo = __float_as_uint(x[i]), hi = __float_as_uint(x[i + h]);
      const float send = __uint_as_float((lo & up) | (hi & ~up));
      const float keep = __uint_as_float((hi & up) | (lo & ~up));
      x[i] = fold_op<MIN>(keep, __shfl_xor_sync(FULL, send, o));
    }
  }
  float y = x[0];
#pragma unroll
  for (int s = LOGN; s < 5; ++s) y = fold_op<MIN>(y, __shfl_xor_sync(FULL, y, 16 >> s));
  return y;
}

// First stage of a block reduction: the warp's totals of x[0, M) (padded
// to N) into red[j][warp].
template <int N, bool MIN, int M>
__device__ __forceinline__ void warp_totals(const float (&v)[M], float (*red)[MAX_WARPS]) {
  constexpr int SH = N >= 32 ? 0 : N >= 16 ? 1 : N >= 8 ? 2 : N >= 4 ? 3 : N >= 2 ? 4 : 5;
  float x[N];
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = j < M ? v[j] : (MIN ? INFINITY : 0.f);
  const float y = warp_fold<N, MIN>(x);
  const int lane = threadIdx.x & 31;
  if ((lane & ((1 << SH) - 1)) == 0 && (lane >> SH) < M) red[lane >> SH][threadIdx.x >> 5] = y;
}

// Second stage: the block totals of red[0, M) (nw warps' entries, padded
// to N), returned to every lane of the calling warp (out[j]).
template <int N, bool MIN, int M>
__device__ __forceinline__ void block_totals(float (&out)[M], float (*red)[MAX_WARPS], int nw) {
  constexpr int SH = N >= 32 ? 0 : N >= 16 ? 1 : N >= 8 ? 2 : N >= 4 ? 3 : N >= 2 ? 4 : 5;
  const int lane = threadIdx.x & 31;
  float x[N];
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = j < M && lane < nw ? red[j][lane] : (MIN ? INFINITY : 0.f);
  const float y = warp_fold<N, MIN>(x);
#pragma unroll
  for (int j = 0; j < M; ++j) out[j] = __shfl_sync(FULL, y, j << SH);
}

// 4 bytes global -> shared, asynchronously (cp.async; waited by wait_all)
__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ int bin_of(float x, float lo, float hi) {
  const float scale = (float)BINS / (hi - lo);
  const int idx = (int)((x - lo) * scale);  // truncates toward zero
  return idx < 0 ? 0 : (idx > BINS - 1 ? BINS - 1 : idx);
}

// The warp's 32 (bin, weight) pairs of each sketch added to lane-owned
// bins: lane j gains the weights of the lanes whose bin is j. When every
// weight is 0 or 1 (`binary`, warp-uniform) the counts go to `cnt`: `nz` is
// the ballot of the nonzero weights and `flip[k]` is all ones where bit k
// of the lane is 0, so AND-ing the five bit ballots (flipped) leaves the
// lanes whose bin is this lane's. Otherwise the weights go to `acc` in
// lane order.
__device__ __forceinline__ void warp_bins(int (&cnt)[4], float (&acc)[4], const int (&idx)[4],
                                          float w, bool binary, const unsigned (&flip)[5]) {
  const int lane = threadIdx.x & 31;
  if (binary) {
    const unsigned nz = __ballot_sync(FULL, w != 0.f);
    unsigned sel[4] = {nz, nz, nz, nz};
#pragma unroll
    for (int bit = 0; bit < 5; ++bit)
#pragma unroll
      for (int h = 0; h < 4; ++h) sel[h] &= __ballot_sync(FULL, (idx[h] >> bit) & 1) ^ flip[bit];
#pragma unroll
    for (int h = 0; h < 4; ++h) cnt[h] += __popc(sel[h]);
  } else {
#pragma unroll 1
    for (int j = 0; j < 32; ++j) {
      const float wj = __shfl_sync(FULL, w, j);
#pragma unroll
      for (int h = 0; h < 4; ++h)
        if (__shfl_sync(FULL, idx[h], j) == lane) acc[h] += wj;
    }
  }
}

template <bool STAGED>
__global__ void __launch_bounds__(32 * MAX_WARPS) fused_loss_fwd_kernel(
    Ptrs P, int B, int R, int LPR, int C, int passes, Params p) {
  extern __shared__ float sm[];  // STAGED: [N_OPS][passes * C][blockDim.x]
  __shared__ float red1[N_SUM1][MAX_WARPS], red2[N_SUM2][MAX_WARPS];
  __shared__ float red3[N_SUM3][MAX_WARPS], redm[N_MIN1][MAX_WARPS];
  __shared__ float hist_w[MAX_WARPS][N_SKETCH * BINS];
  __shared__ float fin[N_SUM3], ext[N_SUM2 - 1 + N_MIN1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NT = blockDim.x, nw = NT >> 5, E = passes * C;
  const int groups = NT / LPR;            // rows the block holds at once
  const int grp = tid / LPR, sl = lane % LPR;  // this lane's row group, lane in it
  const int t0 = sl * C;                  // this lane's first column
  const int Lc = max(0, min(C, R - t0));  // its columns in range

  // element (slot k = rr C + c) of operand `op`: global index i
  auto ld = [&](int op, int k, size_t i) -> float {
    if constexpr (STAGED) {
      return sm[(op * E + k) * NT + tid];
    } else {
      return op == ADV ? P.adv[i] : (op == RET ? P.ret[i] : P.in[op][i]);
    }
  };
  auto st = [&](int op, int k, size_t i, float x) {
    if constexpr (STAGED) {
      sm[(op * E + k) * NT + tid] = x;
    } else {
      (op == ADV ? P.adv : P.ret)[i] = x;
    }
  };
  // the row of pass rr, and this lane's columns in range there
  auto row = [&](int rr) { return grp + groups * rr; };
  auto cols = [&](int rr) { return row(rr) < B ? Lc : 0; };

  // 0. this thread's elements of every operand, read once: asynchronous
  // copies, all in flight together, one wait (each thread reads only its
  // own slots, so no barrier)
  if constexpr (STAGED) {
    const int nin = p.use_iw ? BLP + 1 : BLP;
#pragma unroll 1
    for (int rr = 0; rr < passes; ++rr) {
      const int L = cols(rr);
      const size_t i0 = (size_t)row(rr) * R + t0;
#pragma unroll 1
      for (int c = 0; c < L; ++c)
#pragma unroll
        for (int op = 0; op <= BLP; ++op)
          if (op < nin) copy4_async(&sm[(op * E + rr * C + c) * NT + tid], P.in[op] + i0 + c);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }

  // 1. GAE by rows, then the first moments and the extrema
  float s1[N_SUM1], mn[N_MIN1];
#pragma unroll
  for (int j = 0; j < N_SUM1; ++j) s1[j] = 0.f;
#pragma unroll
  for (int j = 0; j < N_MIN1; ++j) mn[j] = INFINITY;
  bool binary = true;  // every weight 0 or 1
#pragma unroll 1
  for (int rr = 0; rr < passes; ++rr) {  // every lane takes every pass (shuffles)
    const int L = cols(rr), k0 = rr * C;
    const size_t i0 = (size_t)row(rr) * R + t0;
    // V_{t+1} past the chunk's end: the next lane's first value (0 past R)
    float nv = __shfl_down_sync(FULL, L > 0 ? ld(OV, k0, i0) : 0.f, 1, LPR);
    if (sl == LPR - 1) nv = 0.f;
    // the chunk's own recurrence from A = 0, and c^L
    float A = 0.f, a = 1.f;
#pragma unroll 1
    for (int c = L - 1; c >= 0; --c) {
      const float ov = ld(OV, k0 + c, i0 + c);
      const float delta = (ld(RW, k0 + c, i0 + c) + p.gamma * nv) - ov;
      A = delta + p.gamma_lam * A;
      a *= p.gamma_lam;
      nv = ov;
      st(ADV, k0 + c, i0 + c, A);
    }
    // suffix scan over the group's lanes: (a, A) composed with every lane
    // to the right
#pragma unroll 1
    for (int o = 1; o < LPR; o <<= 1) {
      const float a2 = __shfl_down_sync(FULL, a, o, LPR);
      const float A2 = __shfl_down_sync(FULL, A, o, LPR);
      if (sl + o < LPR) {
        A = A + a * A2;
        a = a * a2;
      }
    }
    float carry = __shfl_down_sync(FULL, A, 1, LPR);  // A at the next lane's first column
    if (sl == LPR - 1) carry = 0.f;
    float pw = p.gamma_lam;
#pragma unroll 1
    for (int c = L - 1; c >= 0; --c) {
      const int k = k0 + c;
      const size_t i = i0 + c;
      const float adv = ld(ADV, k, i) + pw * carry;
      pw *= p.gamma_lam;
      const float ov = ld(OV, k, i), ret = adv + ov;
      if constexpr (STAGED) {
        st(ADV, k, i, adv);
        st(RET, k, i, ret);
      }
      P.adv[i] = adv;
      P.ret[i] = ret;
      const float m = ld(MASK, k, i), v = ld(V, k, i);
      binary = binary && (m == 0.f || m == 1.f);
      s1[S_MASK] += m;
      s1[S_ADV] += adv * m;
      s1[S_V] += v * m;
      s1[S_OV] += ov * m;
      s1[S_RET] += ret * m;
      if (m > 0.f) {
        mn[MIN_V] = fminf(mn[MIN_V], v);
        mn[MIN_OV] = fminf(mn[MIN_OV], ov);
        mn[MIN_RET] = fminf(mn[MIN_RET], ret);
        mn[NMAX_V] = fminf(mn[NMAX_V], -v);
        mn[NMAX_OV] = fminf(mn[NMAX_OV], -ov);
        mn[NMAX_RET] = fminf(mn[NMAX_RET], -ret);
      }
    }
  }
  binary = __all_sync(FULL, binary);
  warp_totals<8, false>(s1, red1);
  warp_totals<8, true>(mn, redm);
  __syncthreads();
  block_totals<8, false>(s1, red1, nw);
  const float msum = s1[S_MASK];
  const float n = fmaxf(msum, 1.f);
  const float adv_mean = s1[S_ADV] / n, v_mean = s1[S_V] / n;
  const float ov_mean = s1[S_OV] / n, ret_mean = s1[S_RET] / n;

  // 2. centred second moments
  float s2[N_SUM2] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int rr = 0; rr < passes; ++rr) {
    const int L = cols(rr);
    const size_t i0 = (size_t)row(rr) * R + t0;
#pragma unroll 1
    for (int c = 0; c < L; ++c) {
      const int k = rr * C + c;
      const size_t i = i0 + c;
      const float m = ld(MASK, k, i);
      const float da = ld(ADV, k, i) - adv_mean, dv = ld(V, k, i) - v_mean;
      const float dov = ld(OV, k, i) - ov_mean, dret = ld(RET, k, i) - ret_mean;
      s2[Q_ADV] += da * da * m;
      s2[Q_V] += dv * dv * m;
      s2[Q_OV] += dov * dov * m;
      s2[Q_RET] += dret * dret * m;
    }
  }
  warp_totals<4, false>(s2, red2);
  __syncthreads();
  float q_adv[1];
  block_totals<1, false>(q_adv, red2, nw);
  const float var = q_adv[0] / n * (msum / fmaxf(msum - 1.f, 1.f));
  const float adv_inv = 1.f / sqrtf(var + 1e-8f);

  // 3. losses, stats and sketches
  float s3[N_SUM3];
#pragma unroll
  for (int j = 0; j < N_SUM3; ++j) s3[j] = 0.f;
  float hacc[N_SKETCH] = {0.f, 0.f, 0.f, 0.f};
  int hcnt[N_SKETCH] = {0, 0, 0, 0};
  unsigned flip[5];
#pragma unroll
  for (int bit = 0; bit < 5; ++bit) flip[bit] = ((lane >> bit) & 1) ? 0u : FULL;
#pragma unroll 1
  for (int rr = 0; rr < passes; ++rr) {
    const int L = cols(rr);
    const size_t i0 = (size_t)row(rr) * R + t0;
#pragma unroll 1
    for (int c = 0; c < C; ++c) {  // every lane takes C steps: the ballots need all 32
      const int k = rr * C + c;
      const size_t i = i0 + c;
      float m = 0.f, a = 0.f, k3 = 0.f, lr = 0.f, e1 = 0.f;
      if (c < L) {
        m = ld(MASK, k, i);
        const float v = ld(V, k, i), ov = ld(OV, k, i), ret = ld(RET, k, i);
        a = (ld(ADV, k, i) - adv_mean) * adv_inv;  // whitened advantage
        // clipped value loss
        const float vc = fminf(fmaxf(v, ov - p.cliprange_value), ov + p.cliprange_value);
        e1 = v - ret;
        const float e2 = vc - ret;
        const float l1 = e1 * e1, l2 = e2 * e2;
        s3[VF] += fmaxf(l1, l2) * m;
        s3[VF_CF] += (l2 > l1 ? 1.f : 0.f) * m;
        // clipped policy loss
        const float olp = ld(OLP, k, i);
        lr = (ld(LP, k, i) - olp) * m;
        const float ratio = expf(lr);
        k3 = (ratio - 1.f) - lr;
        s3[KL] += k3;
        float pg1 = -a * ratio;
        float pg2 = -a * fminf(fmaxf(ratio, p.clip_lo), p.clip_hi);
        if (p.use_iw) {
          const float raw = expf((olp - ld(BLP, k, i)) * m);
          const float rho = fminf(raw, p.iw_clip);
          pg1 *= rho;
          pg2 *= rho;
          s3[RHO] += rho * m;
          s3[RHO_CF] += (raw > p.iw_clip ? 1.f : 0.f) * m;
        }
        s3[PG] += fmaxf(pg1, pg2) * m;
        s3[PG_CF] += (pg2 > pg1 ? 1.f : 0.f) * m;
        s3[RAT] += ratio * m;
        const float em = e1 * m;
        s3[VERR] += em * em;
      }
      if (p.sketches) {
        int idx[N_SKETCH];
        idx[H_ADV] = bin_of(a, -5.f, 5.f);
        idx[H_KL] = bin_of(k3, 0.f, 1.f);
        idx[H_LOG_RATIO] = bin_of(lr, -1.f, 1.f);
        idx[H_VALUE_ERROR] = bin_of(e1, -5.f, 5.f);
        warp_bins(hcnt, hacc, idx, m, binary, flip);
      }
    }
  }
  warp_totals<16, false>(s3, red3);
  if (p.sketches) {
#pragma unroll
    for (int h = 0; h < N_SKETCH; ++h) hist_w[warp][h * BINS + lane] = hacc[h] + (float)hcnt[h];
  }
  __syncthreads();
  // warp 0 folds the losses' sums and writes their stats; warp 1 (warp 0
  // when it is alone) the extrema and the other moments; the rest merge
  // the sketches when there are enough of them
  const int wx = nw > 1 ? 1 : 0;
  if (p.sketches) {
    const int first = nw >= 6 ? 64 : 0;
    for (int i = tid - first; i >= 0 && i < N_SKETCH * BINS; i += NT - first) {
      float x = 0.f;
      for (int w = 0; w < nw; ++w) x += hist_w[w][i];
      P.hists[i] = x;
    }
  }
  if (warp > wx) return;
  const float inv_n = 1.f / n;  // one division; the stats multiply by it
  float* out = P.stats;
  if (warp == 0) {
    float x[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) x[j] = j < N_SUM3 && lane < nw ? red3[j][lane] : 0.f;
    const float y = warp_fold<16, false>(x);
    if ((lane & 1) == 0 && (lane >> 1) < N_SUM3) fin[lane >> 1] = y;
    __syncwarp();
    if (lane == 0) {
      const float n_el = (float)B * (float)R;
      const float pg_loss = fin[PG] * inv_n;
      const float vf_loss = 0.5f * fin[VF] * inv_n;
      const float loss = pg_loss + p.vf_coef * vf_loss;
      P.loss[0] = loss;
      out[IW_RHO_CLIPFRAC] = fin[RHO_CF] * inv_n;
      out[IW_RHO_MEAN] = fin[RHO] * inv_n;
      out[LOSS_POLICY] = pg_loss;
      out[LOSS_TOTAL] = loss;
      out[LOSS_VALUE] = vf_loss;
      out[POLICY_APPROX_KL] = fin[KL] / n_el;
      out[POLICY_CLIPFRAC] = fin[PG_CF] * inv_n;
      out[RATIO] = fin[RAT] * inv_n;
      out[V_CLIPFRAC] = fin[VF_CF] * inv_n;
      out[V_ERROR] = fin[VERR] * inv_n;
    }
  }
  if (warp == wx) {
    float q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = j < N_SUM2 - 1 && lane < nw ? red2[j + 1][lane] : 0.f;
    const float yq = warp_fold<4, false>(q);
    if ((lane & 7) == 0 && (lane >> 3) < N_SUM2 - 1) ext[lane >> 3] = yq;
    float z[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) z[j] = j < N_MIN1 && lane < nw ? redm[j][lane] : INFINITY;
    const float w = warp_fold<8, true>(z);
    if ((lane & 3) == 0 && (lane >> 2) < N_MIN1) ext[N_SUM2 - 1 + (lane >> 2)] = w;
    __syncwarp();
    if (lane == 0) {
      const float* q2 = ext;                // Q_V .. Q_RET at [0, 3)
      const float* mn2 = ext + N_SUM2 - 1;  // the minima, Min1 order
      out[OV_MAX] = -mn2[NMAX_OV];
      out[OV_MEAN] = ov_mean;
      out[OV_MIN] = mn2[MIN_OV];
      out[OV_STD] = sqrtf(q2[Q_OV - 1] * inv_n);
      out[PADDING] = 1.f - n / ((float)B * (float)R);
      out[RET_MAX] = -mn2[NMAX_RET];
      out[RET_MEAN] = ret_mean;
      out[RET_MIN] = mn2[MIN_RET];
      out[RET_STD] = sqrtf(q2[Q_RET - 1] * inv_n);
      out[V_MAX] = -mn2[NMAX_V];
      out[V_MEAN] = v_mean;
      out[V_MIN] = mn2[MIN_V];
      out[V_STD] = sqrtf(q2[Q_V - 1] * inv_n);
      P.moments[M_MEAN] = adv_mean;
      P.moments[M_INV] = adv_inv;
      P.moments[M_N] = n;
    }
  }
}

}  // namespace

// Operands are (B, R) f32, contiguous; blp is null without the IW
// correction. `out` is one f32 buffer of 2 B R + N_MOMENTS + 1 + N_STATS +
// N_SKETCH x BINS floats: the residuals (the raw advantages (B, R), the
// returns (B, R) and the moments, fused_loss_common.cuh), then the loss,
// the stats (sorted key order, the IW pair first) and the sketches (4 x 32).
extern "C" int fused_loss_fwd(const void* lp, const void* v, const void* olp,
                              const void* ov, const void* rw, const void* mask,
                              const void* blp, void* out, int B, int R, float gamma,
                              float gamma_lam, float clip_lo, float clip_hi,
                              float cliprange_value, float vf_coef, float iw_clip,
                              int sketches, void* stream) {
  Params p{gamma, gamma_lam, clip_lo, clip_hi, cliprange_value, vf_coef, iw_clip,
           blp != nullptr ? 1 : 0, sketches};
  const size_t n = (size_t)B * R;
  float* o = (float*)out;
  Ptrs P{{(const float*)lp, (const float*)v, (const float*)olp, (const float*)ov,
          (const float*)rw, (const float*)mask, (const float*)blp},
         o, o + n, o + 2 * n + N_MOMENTS, o + 2 * n + N_MOMENTS + 1,
         o + 2 * n + N_MOMENTS + 1 + N_STATS, o + 2 * n};
  // lanes per row: a lane holds at most 4 columns up to R = 128
  const int LPR = R > 64 ? 32 : (R > 32 ? 16 : 8);
  const int C = R < 1 ? 1 : (R + LPR - 1) / LPR;
  const int per_warp = 32 / LPR;  // rows a warp holds at once
  const int want = B < 1 ? 1 : (B + per_warp - 1) / per_warp;
  const int nw = want < MAX_WARPS ? want : MAX_WARPS;
  const int passes = B < 1 ? 1 : (B + nw * per_warp - 1) / (nw * per_warp);
  const size_t stage = sizeof(float) * N_OPS * (size_t)passes * C * 32 * nw;
  cudaStream_t st = (cudaStream_t)stream;
  if (stage <= (size_t)STAGE_BYTES) {
    // the opt-in above 48 KB, once per device
    static bool opted[64];
    int dev = 0;
    cudaGetDevice(&dev);
    if (!opted[dev & 63]) {
      const cudaError_t e = cudaFuncSetAttribute(
          fused_loss_fwd_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, STAGE_BYTES);
      if (e != cudaSuccess) return (int)e;
      opted[dev & 63] = true;
    }
    fused_loss_fwd_kernel<true><<<1, 32 * nw, stage, st>>>(P, B, R, LPR, C, passes, p);
  } else {
    fused_loss_fwd_kernel<false><<<1, 32 * nw, 0, st>>>(P, B, R, LPR, C, passes, p);
  }
  return (int)cudaGetLastError();
}
