// Fused PPO loss forward: reversed GAE, masked whitening, the clipped
// policy and value losses, every scalar stat of PPOConfig.loss and the four
// dist/* sketches, in one kernel.
//
// Replaces: trlx_tpu/ops/fused_loss.py::_fwd_call
//   (_fused_loss_fwd_kernel, the pl.pallas_call at fused_loss.py:274).
//
// What bounds it on an H100: the operands are six or seven (B, R) f32
// arrays (B x R = 640 at the training shape, at most 32 x 1024 at the
// default config's), read about three times; the ideal time is well under a
// microsecond either way, so launch latency and the serial GAE recurrence
// (R dependent steps per row) bound it.
//
// Design: one thread block of 1024 threads over the whole batch, because
// the chain's reductions are global over (B, R): the GAE scan is
// sequential in R (one thread per row runs it in reverse), and the
// whitening moments and every stat span the whole mask, so no row can
// finish before all rows are done. Passes, each ended by a block
// reduction (warp shuffles, then one shared row per warp): GAE into global
// scratch; mask, advantage and stat sums; centred second moments; then the
// per-element losses, stats, masked min/max (+-inf outside the mask) and
// the sketches. Sketch bins truncate toward zero then clip into 32 bins
// (the JAX astype(int32)), accumulated with shared-memory atomics.
// Scalars are packed in the sorted key order the JAX package discovers
// (fused_loss.py::_stat_keys), the IW pair first; the wrapper drops the
// pair when the IW correction is off.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "fused_loss_common.cuh"

namespace {

using namespace fused_loss;

constexpr int BINS = 32;

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

__device__ __forceinline__ void bin(float* hist, float x, float lo, float hi, float w) {
  const float scale = (float)BINS / (hi - lo);
  int idx = (int)((x - lo) * scale);  // truncates toward zero
  idx = idx < 0 ? 0 : (idx > BINS - 1 ? BINS - 1 : idx);
  atomicAdd(&hist[idx], w);
}

__global__ void __launch_bounds__(NTH) fused_loss_fwd_kernel(
    const float* __restrict__ lp, const float* __restrict__ v,
    const float* __restrict__ olp, const float* __restrict__ ov,
    const float* __restrict__ rw, const float* __restrict__ mask,
    const float* __restrict__ blp, float* __restrict__ adv,
    float* __restrict__ ret, float* __restrict__ loss_out,
    float* __restrict__ stats, float* __restrict__ hists, int B, int R,
    Params p) {
  __shared__ float red[NWARP * 16 + 16];
  __shared__ float hist[N_SKETCH * BINS];
  const int n_el = B * R;
  for (int i = threadIdx.x; i < N_SKETCH * BINS; i += NTH) hist[i] = 0.f;

  gae(ov, rw, adv, ret, B, R, p);
  float adv_mean, adv_inv;
  const float msum = whiten_moments(adv, mask, n_el, red, &adv_mean, &adv_inv);
  const float n = fmaxf(msum, 1.f);

  // means of the stat tensors
  float m1[3] = {0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < n_el; i += NTH) {
    m1[0] += v[i] * mask[i];
    m1[1] += ov[i] * mask[i];
    m1[2] += ret[i] * mask[i];
  }
  block_sum<3>(m1, red);
  const float v_mean = m1[0] / n, ov_mean = m1[1] / n, ret_mean = m1[2] / n;

  enum { VF, VF_CF, KL, PG, PG_CF, RHO, RHO_CF, RAT, VERR, V2, OV2, RET2, NSUM };
  float s[NSUM];
#pragma unroll
  for (int j = 0; j < NSUM; ++j) s[j] = 0.f;
  float mn[3] = {INFINITY, INFINITY, INFINITY};
  float mx[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int i = threadIdx.x; i < n_el; i += NTH) {
    const float m = mask[i];
    const float a = (adv[i] - adv_mean) * adv_inv;  // whitened advantage
    // clipped value loss
    const float vc = fminf(fmaxf(v[i], ov[i] - p.cliprange_value), ov[i] + p.cliprange_value);
    const float e1 = v[i] - ret[i], e2 = vc - ret[i];
    const float l1 = e1 * e1, l2 = e2 * e2;
    s[VF] += fmaxf(l1, l2) * m;
    s[VF_CF] += (l2 > l1 ? 1.f : 0.f) * m;
    // clipped policy loss
    const float lr = (lp[i] - olp[i]) * m;
    const float ratio = expf(lr);
    const float k3 = (ratio - 1.f) - lr;
    s[KL] += k3;
    float pg1 = -a * ratio;
    float pg2 = -a * fminf(fmaxf(ratio, p.clip_lo), p.clip_hi);
    if (p.use_iw) {
      const float raw = expf((olp[i] - blp[i]) * m);
      const float rho = fminf(raw, p.iw_clip);
      pg1 *= rho;
      pg2 *= rho;
      s[RHO] += rho * m;
      s[RHO_CF] += (raw > p.iw_clip ? 1.f : 0.f) * m;
    }
    s[PG] += fmaxf(pg1, pg2) * m;
    s[PG_CF] += (pg2 > pg1 ? 1.f : 0.f) * m;
    s[RAT] += ratio * m;
    const float em = e1 * m;
    s[VERR] += em * em;
    const float dv = v[i] - v_mean, dov = ov[i] - ov_mean, dret = ret[i] - ret_mean;
    s[V2] += dv * dv * m;
    s[OV2] += dov * dov * m;
    s[RET2] += dret * dret * m;
    if (m > 0.f) {
      mn[0] = fminf(mn[0], v[i]); mx[0] = fmaxf(mx[0], v[i]);
      mn[1] = fminf(mn[1], ov[i]); mx[1] = fmaxf(mx[1], ov[i]);
      mn[2] = fminf(mn[2], ret[i]); mx[2] = fmaxf(mx[2], ret[i]);
    }
    if (p.sketches) {
      bin(&hist[H_LOG_RATIO * BINS], lr, -1.f, 1.f, m);
      bin(&hist[H_KL * BINS], k3, 0.f, 1.f, m);
      bin(&hist[H_ADV * BINS], a, -5.f, 5.f, m);
      bin(&hist[H_VALUE_ERROR * BINS], e1, -5.f, 5.f, m);
    }
  }
  block_sum<NSUM>(s, red);
  block_minmax<3>(mn, false, red);
  block_minmax<3>(mx, true, red);

  if (threadIdx.x == 0) {
    const float pg_loss = s[PG] / n;
    const float vf_loss = 0.5f * s[VF] / n;
    const float loss = pg_loss + p.vf_coef * vf_loss;
    loss_out[0] = loss;
    stats[IW_RHO_CLIPFRAC] = s[RHO_CF] / n;
    stats[IW_RHO_MEAN] = s[RHO] / n;
    stats[LOSS_POLICY] = pg_loss;
    stats[LOSS_TOTAL] = loss;
    stats[LOSS_VALUE] = vf_loss;
    stats[OV_MAX] = mx[1];
    stats[OV_MEAN] = ov_mean;
    stats[OV_MIN] = mn[1];
    stats[OV_STD] = sqrtf(s[OV2] / fmaxf(n, 1.f));
    stats[PADDING] = 1.f - n / (float)n_el;
    stats[POLICY_APPROX_KL] = s[KL] / (float)n_el;
    stats[POLICY_CLIPFRAC] = s[PG_CF] / n;
    stats[RATIO] = s[RAT] / n;
    stats[RET_MAX] = mx[2];
    stats[RET_MEAN] = ret_mean;
    stats[RET_MIN] = mn[2];
    stats[RET_STD] = sqrtf(s[RET2] / fmaxf(n, 1.f));
    stats[V_CLIPFRAC] = s[VF_CF] / n;
    stats[V_MAX] = mx[0];
    stats[V_MEAN] = v_mean;
    stats[V_MIN] = mn[0];
    stats[V_STD] = sqrtf(s[V2] / fmaxf(n, 1.f));
    stats[V_ERROR] = s[VERR] / n;
  }
  // the sketches' atomics finished before the block reductions' barriers
  for (int i = threadIdx.x; i < N_SKETCH * BINS; i += NTH) hists[i] = hist[i];
}

}  // namespace

// Operands are (B, R) f32, contiguous; blp is null without the IW
// correction. adv and ret are (B, R) f32 scratch. Writes loss (1), stats
// (23, sorted key order, the IW pair first) and hists (4 x 32).
extern "C" int fused_loss_fwd(const void* lp, const void* v, const void* olp,
                              const void* ov, const void* rw, const void* mask,
                              const void* blp, void* adv, void* ret, void* loss,
                              void* stats, void* hists, int B, int R, float gamma,
                              float gamma_lam, float clip_lo, float clip_hi,
                              float cliprange_value, float vf_coef, float iw_clip,
                              int sketches, void* stream) {
  Params p{gamma, gamma_lam, clip_lo, clip_hi, cliprange_value, vf_coef, iw_clip,
           blp != nullptr ? 1 : 0, sketches};
  fused_loss_fwd_kernel<<<1, NTH, 0, (cudaStream_t)stream>>>(
      (const float*)lp, (const float*)v, (const float*)olp, (const float*)ov,
      (const float*)rw, (const float*)mask, (const float*)blp, (float*)adv,
      (float*)ret, (float*)loss, (float*)stats, (float*)hists, B, R, p);
  return (int)cudaGetLastError();
}
