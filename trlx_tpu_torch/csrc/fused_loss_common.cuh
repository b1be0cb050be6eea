// Shared device code of the fused PPO loss kernels (fused_loss_fwd.cu and
// fused_loss_bwd.cu): the scalar parameters and the residual slots the
// forward writes for the backward.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace fused_loss {

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

// The forward's residuals beside the raw advantages and returns: the
// whitening mean, 1 / sqrt(var + 1e-8) (ddof 1) and n = max(sum(mask), 1).
enum Moment { M_MEAN, M_INV, M_N, N_MOMENTS };

}  // namespace fused_loss
