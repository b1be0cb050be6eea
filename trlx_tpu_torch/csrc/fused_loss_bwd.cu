// Fused PPO loss backward: the gradient of the loss with respect to the
// new logprobs and the new values (the only operands a parameter reaches).
//
// Replaces: trlx_tpu/ops/fused_loss.py::_bwd_call
//   (_fused_loss_bwd_kernel, the pl.pallas_call at fused_loss.py:309).
//
// What bounds it on an H100: like the forward, a few (B, R) f32 arrays read
// two or three times and two written once; launch latency and the serial
// GAE recurrence bound it, not bytes or operations.
//
// Design: the forward's single block recomputes the advantages, returns
// and whitening moments (recompute over residuals, as the TPU kernel
// re-runs the forward trace under jax.vjp), then writes each element's two
// gradients from the derivative worked out by hand. The tie rules are
// JAX's, since the reference gradient is jax.grad: jnp.maximum sends half
// the cotangent to each side of a tie, and jnp.clip is
// minimum(maximum(x, lo), hi), so a clipped value at a bound passes half.
// Exact ties are the common case, not an accident: inside the clip range
// the clipped and unclipped terms are bit-equal, and at every masked
// position both sides are 0.
//
//   n = max(sum(mask), 1), a = whitened advantage (a constant),
//   value:  vc = clip(v, ov - c, ov + c), l1 = (v - ret)^2, l2 = (vc - ret)^2
//           dL/dv = g vf_coef 0.5/n m [w1 2(v - ret) + w2 2(vc - ret) vc']
//   policy: lr = (lp - olp) m, r = e^lr, pg1 = -a r rho, pg2 = -a clip(r) rho
//           dL/dlp = g m/n [u1 (-a rho) + u2 (-a rho) clip'(r)] r m
// where (w1, w2) and (u1, u2) split the max by the tie rule and rho is the
// (stop-gradient) truncated IW weight, 1 without the correction.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "fused_loss_common.cuh"

namespace {

using namespace fused_loss;

// d maximum(x, lo) / dx and d minimum(y, hi) / dy under JAX's tie rule
__device__ __forceinline__ float dmax(float x, float lo) {
  return x > lo ? 1.f : (x == lo ? 0.5f : 0.f);
}
__device__ __forceinline__ float dmin(float y, float hi) {
  return y < hi ? 1.f : (y == hi ? 0.5f : 0.f);
}
// share of the cotangent of maximum(x1, x2) that goes to x1
__device__ __forceinline__ float max_share(float x1, float x2) {
  return x1 > x2 ? 1.f : (x1 == x2 ? 0.5f : 0.f);
}

__global__ void __launch_bounds__(NTH) fused_loss_bwd_kernel(
    const float* __restrict__ lp, const float* __restrict__ v,
    const float* __restrict__ olp, const float* __restrict__ ov,
    const float* __restrict__ rw, const float* __restrict__ mask,
    const float* __restrict__ blp, const float* __restrict__ g_loss,
    float* __restrict__ adv, float* __restrict__ ret, float* __restrict__ dlp,
    float* __restrict__ dv, int B, int R, Params p) {
  __shared__ float red[NWARP * 4 + 4];
  const int n_el = B * R;
  gae(ov, rw, adv, ret, B, R, p);
  float adv_mean, adv_inv;
  const float msum = whiten_moments(adv, mask, n_el, red, &adv_mean, &adv_inv);
  const float n = fmaxf(msum, 1.f);
  const float g = g_loss[0];

  for (int i = threadIdx.x; i < n_el; i += NTH) {
    const float m = mask[i];
    const float a = (adv[i] - adv_mean) * adv_inv;
    // value term
    const float lo_v = ov[i] - p.cliprange_value, hi_v = ov[i] + p.cliprange_value;
    const float y = fmaxf(v[i], lo_v);
    const float vc = fminf(y, hi_v);
    const float e1 = v[i] - ret[i], e2 = vc - ret[i];
    const float l1 = e1 * e1, l2 = e2 * e2;
    const float w1 = max_share(l1, l2), w2 = 1.f - w1;
    const float dvc = dmax(v[i], lo_v) * dmin(y, hi_v);
    const float dvf = 0.5f * m / n * (w1 * 2.f * e1 + w2 * 2.f * e2 * dvc);
    dv[i] = g * p.vf_coef * dvf;
    // policy term
    const float lr = (lp[i] - olp[i]) * m;
    const float r = expf(lr);
    const float rc_in = fmaxf(r, p.clip_lo);
    const float rc = fminf(rc_in, p.clip_hi);
    float rho = 1.f;
    if (p.use_iw) rho = fminf(expf((olp[i] - blp[i]) * m), p.iw_clip);
    const float pg1 = -a * r * rho, pg2 = -a * rc * rho;
    const float u1 = max_share(pg1, pg2), u2 = 1.f - u1;
    const float dclip = dmax(r, p.clip_lo) * dmin(rc_in, p.clip_hi);
    const float dpg = m / n * (u1 * (-a * rho) + u2 * (-a * rho) * dclip) * r * m;
    dlp[i] = g * dpg;
  }
}

}  // namespace

// Operands as fused_loss_fwd's; g_loss is the loss cotangent (one f32 on
// the device). Writes dlp and dv, (B, R) f32.
extern "C" int fused_loss_bwd(const void* lp, const void* v, const void* olp,
                              const void* ov, const void* rw, const void* mask,
                              const void* blp, const void* g_loss, void* adv,
                              void* ret, void* dlp, void* dv, int B, int R,
                              float gamma, float gamma_lam, float clip_lo,
                              float clip_hi, float cliprange_value, float vf_coef,
                              float iw_clip, void* stream) {
  Params p{gamma, gamma_lam, clip_lo, clip_hi, cliprange_value, vf_coef, iw_clip,
           blp != nullptr ? 1 : 0, 0};
  fused_loss_bwd_kernel<<<1, NTH, 0, (cudaStream_t)stream>>>(
      (const float*)lp, (const float*)v, (const float*)olp, (const float*)ov,
      (const float*)rw, (const float*)mask, (const float*)blp,
      (const float*)g_loss, (float*)adv, (float*)ret, (float*)dlp, (float*)dv, B,
      R, p);
  return (int)cudaGetLastError();
}
