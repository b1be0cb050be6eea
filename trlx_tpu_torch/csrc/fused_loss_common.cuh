// Shared device code of the fused PPO loss kernels (fused_loss_fwd.cu and
// fused_loss_bwd.cu): block reductions and the GAE + whitening prologue
// both kernels run. Each kernel is one thread block of NTH threads over
// the whole (B, R) batch; see the kernels' notes for why.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace fused_loss {

constexpr int NTH = 1024;
constexpr int NWARP = NTH / 32;

struct Params {
  float gamma;        // discount
  float gamma_lam;    // gamma * lam, rounded once (as the JAX program does)
  float clip_lo;      // 1 - cliprange
  float clip_hi;      // 1 + cliprange
  float cliprange_value;
  float vf_coef;
  float iw_clip;
  int use_iw;         // behavior logprobs given and iw_correction != "off"
  int sketches;       // dist_sketches
};

// In-place block sum of NV values per thread; every thread gets the totals.
// `red` is shared scratch of at least NWARP * NV + NV floats.
template <int NV>
__device__ void block_sum(float (&x)[NV], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float v = x[j];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp * NV + j] = v;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = 0.f;
    for (int w = 0; w < NWARP; ++w) s += red[w * NV + threadIdx.x];
    red[NWARP * NV + threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NV; ++j) x[j] = red[NWARP * NV + j];
  __syncthreads();
}

// In-place block min (lo) or max over NV values per thread.
template <int NV>
__device__ void block_minmax(float (&x)[NV], bool take_max, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float v = x[j];
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, v, o);
      v = take_max ? fmaxf(v, u) : fminf(v, u);
    }
    if (lane == 0) red[warp * NV + j] = v;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = red[threadIdx.x];
    for (int w = 1; w < NWARP; ++w) {
      const float u = red[w * NV + threadIdx.x];
      s = take_max ? fmaxf(s, u) : fminf(s, u);
    }
    red[NWARP * NV + threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NV; ++j) x[j] = red[NWARP * NV + j];
  __syncthreads();
}

// The reversed GAE recurrence, one thread per batch row (PPOConfig.
// get_advantages_and_returns): delta_t = r_t + gamma V_{t+1} - V_t,
// A_t = delta_t + gamma lam A_{t+1}; returns = A + V. Writes the raw
// advantages and the returns to global scratch; the block synchronises
// before returning.
__device__ void gae(const float* __restrict__ ov, const float* __restrict__ rw,
                    float* __restrict__ adv, float* __restrict__ ret, int B,
                    int R, const Params& p) {
  for (int b = threadIdx.x; b < B; b += NTH) {
    float last = 0.f;
    for (int t = R - 1; t >= 0; --t) {
      const size_t i = (size_t)b * R + t;
      const float nv = t + 1 < R ? ov[i + 1] : 0.f;
      const float delta = (rw[i] + p.gamma * nv) - ov[i];
      last = delta + p.gamma_lam * last;
      adv[i] = last;
      ret[i] = last + ov[i];
    }
  }
  __syncthreads();
}

// Masked whitening moments of the raw advantages (utils/stats.py::whiten,
// ddof 1): returns the mask sum and writes the mean and 1/sqrt(var + 1e-8).
__device__ float whiten_moments(const float* __restrict__ adv,
                                const float* __restrict__ mask, int n_el,
                                float* red, float* mean_out, float* inv_out) {
  float s[2] = {0.f, 0.f};
  for (int i = threadIdx.x; i < n_el; i += NTH) {
    s[0] += mask[i];
    s[1] += adv[i] * mask[i];
  }
  block_sum<2>(s, red);
  const float msum = s[0];
  const float mean = s[1] / fmaxf(msum, 1.f);
  float v[1] = {0.f};
  for (int i = threadIdx.x; i < n_el; i += NTH) {
    const float d = adv[i] - mean;
    v[0] += d * d * mask[i];
  }
  block_sum<1>(v, red);
  const float var = v[0] / fmaxf(msum, 1.f) * (msum / fmaxf(msum - 1.f, 1.f));
  *mean_out = mean;
  *inv_out = 1.f / sqrtf(var + 1e-8f);
  return msum;
}

}  // namespace fused_loss
