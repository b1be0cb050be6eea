// Fused PPO loss backward: the gradient of the loss with respect to the
// new logprobs and the new values (the only operands a parameter reaches).
//
// Replaces: trlx_tpu/ops/fused_loss.py::_bwd_call
//   (_fused_loss_bwd_kernel, the pl.pallas_call at fused_loss.py:309).
//
// What bounds it on an H100: eight (B, R) f32 arrays read once and two
// written once, ~25 KB at the training shape (B x R = 640): well under a
// microsecond of bytes, so the launch sets the time.
//
// Design: the forward leaves its residuals (the raw advantages and
// returns, the whitening mean and inverse std, n = max(sum(mask), 1);
// fused_loss_common.cuh), so this is one elementwise pass: a grid of
// 256-thread blocks, one thread per element, each operand element read
// once. The TPU kernel re-runs the forward trace under jax.vjp, GAE and
// moments included; the first version of this kernel did the same
// in one block. The gradient is derived by hand; the tie rules are JAX's,
// since the reference gradient is jax.grad: jnp.maximum sends half the
// cotangent to each side of a tie, and jnp.clip is minimum(maximum(x, lo),
// hi), so a clipped value at a bound passes half. Exact ties are the common
// case, not an accident: inside the clip range the clipped and unclipped
// terms are bit-equal, and at every masked position both sides are 0.
//
//   n = max(sum(mask), 1), a = (adv - mean) inv (whitened; a constant),
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

constexpr int NTH = 256;

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
    const float* __restrict__ mask, const float* __restrict__ blp,
    const float* __restrict__ adv, const float* __restrict__ ret,
    const float* __restrict__ moments, const float* __restrict__ g_loss,
    float* __restrict__ dlp, float* __restrict__ dv, int n_el, Params p) {
  const int i = blockIdx.x * NTH + threadIdx.x;
  if (i >= n_el) return;
  const float m = mask[i], vi = v[i], ovi = ov[i], reti = ret[i], olpi = olp[i];
  const float a = (adv[i] - moments[M_MEAN]) * moments[M_INV];
  const float n = moments[M_N];
  const float g = g_loss[0];
  // value term
  const float lo_v = ovi - p.cliprange_value, hi_v = ovi + p.cliprange_value;
  const float y = fmaxf(vi, lo_v);
  const float vc = fminf(y, hi_v);
  const float e1 = vi - reti, e2 = vc - reti;
  const float l1 = e1 * e1, l2 = e2 * e2;
  const float w1 = max_share(l1, l2), w2 = 1.f - w1;
  const float dvc = dmax(vi, lo_v) * dmin(y, hi_v);
  const float dvf = 0.5f * m / n * (w1 * 2.f * e1 + w2 * 2.f * e2 * dvc);
  dv[i] = g * p.vf_coef * dvf;
  // policy term
  const float lr = (lp[i] - olpi) * m;
  const float r = expf(lr);
  const float rc_in = fmaxf(r, p.clip_lo);
  const float rc = fminf(rc_in, p.clip_hi);
  float rho = 1.f;
  if (p.use_iw) rho = fminf(expf((olpi - blp[i]) * m), p.iw_clip);
  const float pg1 = -a * r * rho, pg2 = -a * rc * rho;
  const float u1 = max_share(pg1, pg2), u2 = 1.f - u1;
  const float dclip = dmax(r, p.clip_lo) * dmin(rc_in, p.clip_hi);
  const float dpg = m / n * (u1 * (-a * rho) + u2 * (-a * rho) * dclip) * r * m;
  dlp[i] = g * dpg;
}

}  // namespace

// Operands as fused_loss_fwd's (the rewards are not read); res is the
// forward's residuals (the raw advantages (B, R), the returns (B, R) and the
// moments, as fused_loss_fwd lays them out) and g_loss the loss cotangent
// (one f32 on the device). `out` is (2, B, R) f32: dlp, then dv.
extern "C" int fused_loss_bwd(const void* lp, const void* v, const void* olp,
                              const void* ov, const void* mask, const void* blp,
                              const void* res, const void* g_loss, void* out, int B, int R,
                              float clip_lo, float clip_hi, float cliprange_value,
                              float vf_coef, float iw_clip, void* stream) {
  Params p{0.f, 0.f, clip_lo, clip_hi, cliprange_value, vf_coef, iw_clip,
           blp != nullptr ? 1 : 0, 0};
  const int n = B * R;
  if (n == 0) return 0;
  float* o = (float*)out;
  const float* r = (const float*)res;
  fused_loss_bwd_kernel<<<(n + NTH - 1) / NTH, NTH, 0, (cudaStream_t)stream>>>(
      (const float*)lp, (const float*)v, (const float*)olp, (const float*)ov,
      (const float*)mask, (const float*)blp, r, r + n, r + 2 * n, (const float*)g_loss, o,
      o + n, n, p);
  return (int)cudaGetLastError();
}
