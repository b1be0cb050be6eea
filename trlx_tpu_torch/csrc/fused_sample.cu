// Fused sampling: temperature / top-k / top-p filter, the Gumbel-argmax
// draw (plain argmax when greedy) and the behaviour log-probability, one
// thread block per row.
//
// Replaces: trlx_tpu/ops/paged_attention.py::fused_sample
//   (_fused_sample_kernel, the pl.pallas_call at paged_attention.py:373).
//
// Semantics (trlx_tpu/ops/sampling.py::process_logits):
//   x = logits / max(temperature, 1e-6)             (when temperature != 1)
//   top-k: keep x >= the k-th largest value (ties at the threshold kept)
//   top-p: sort descending, keep the prefix whose EXCLUSIVE cumulative
//          probability is < p; the threshold is the smallest kept value and
//          everything >= it stays (ties kept)
//   token = first index of argmax(gumbel + filtered)  (argmax(filtered) greedy)
//   logprob = log_softmax(raw logits)[token]
// No sort: the k-th largest value is found by a 32-pass radix bisection over
// the order-preserving integer image of the float (count of keys >= c per
// pass), which reproduces jax.lax.top_k's threshold, ties included. Top-p
// bisects the same way for the largest key whose strictly-greater mass is
// still >= p, and the threshold is the smallest present key above it. The
// probability masses are summed in another order than jnp.cumsum, so a row
// whose mass lands within rounding of p may keep one token more or fewer
// than the JAX path; everywhere else the kept set is identical.
//
// What bounds it on an H100: memory and latency. A row of V=50257 f32 logits
// (plus the noise) is ~400 KB; the bisections re-read the row ~70 times, so
// the row is staged once in shared memory (201 KB for V=50257, under the
// 227 KB a block may take) and every pass reads it from there. One block
// per row with 1024 threads; reductions are warp shuffles plus one shared
// word per warp.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ uint32_t fkey(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  float r = lane < WARPS ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
  return r;
}

__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  float r = lane < WARPS ? red[lane] : -INFINITY;
  for (int o = 16; o > 0; o >>= 1) r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, o));
  return r;
}

__device__ int block_count(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  int r = lane < WARPS ? red[lane] : 0;
  for (int o = 16; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
  return r;
}

__device__ uint32_t block_min_u(uint32_t v, uint32_t* red) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  uint32_t r = lane < WARPS ? red[lane] : 0xffffffffu;
  for (int o = 16; o > 0; o >>= 1) r = min(r, __shfl_xor_sync(0xffffffffu, r, o));
  return r;
}

// (value, index) argmax; index -1 = none yet; ties go to the smaller index
__device__ __forceinline__ void am_merge(float& v, int& i, float v2, int i2) {
  if (i2 < 0) return;
  if (i < 0 || v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

__device__ int block_argmax(float v, int i, float* redf, int* redi) {
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    am_merge(v, i, v2, i2);
  }
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) { redf[w] = v; redi[w] = i; }
  __syncthreads();
  float rv = lane < WARPS ? redf[lane] : -INFINITY;
  int ri = lane < WARPS ? redi[lane] : -1;
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, rv, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, ri, o);
    am_merge(rv, ri, v2, i2);
  }
  return ri < 0 ? 0 : ri;
}

__global__ void __launch_bounds__(THREADS) fused_sample_kernel(
    const float* __restrict__ logits,  // (B, V) raw (adjusted, eos-blocked)
    const float* __restrict__ gumbel,  // (B, V) noise, or null when greedy
    int32_t* __restrict__ tok,         // (B,)
    float* __restrict__ lp,            // (B,)
    int V, int scale_temp, float tdiv, int top_k, float top_p, int use_smem) {
  extern __shared__ float row_s[];
  __shared__ float redf[WARPS];
  __shared__ int redi[WARPS];
  __shared__ uint32_t redu[WARPS];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* src = logits + (size_t)b * V;

  if (use_smem) {
    for (int i = tid; i < V; i += THREADS) {
      const float l = src[i];
      row_s[i] = scale_temp ? l / tdiv : l;
    }
    __syncthreads();
  }
  auto xval = [&](int i) -> float {
    if (use_smem) return row_s[i];
    const float l = src[i];
    return scale_temp ? l / tdiv : l;
  };

  // top-k threshold key: the largest c with count(key >= c) >= k
  const bool do_k = top_k > 0 && top_k < V;
  uint32_t kth = 0;
  if (do_k) {
    for (int bit = 31; bit >= 0; --bit) {
      const uint32_t cand = kth | (1u << bit);
      int c = 0;
      for (int i = tid; i < V; i += THREADS) c += fkey(xval(i)) >= cand;
      if (block_count(c, redi) >= top_k) kth = cand;
    }
  }
  auto kval = [&](int i) -> float {
    const float x = xval(i);
    return (do_k && fkey(x) < kth) ? -INFINITY : x;
  };

  // top-p threshold key: smallest present key t with mass(key > t) < p
  const bool do_p = top_p < 1.f;
  uint32_t tp = 0;
  if (do_p) {
    float m = -INFINITY;
    for (int i = tid; i < V; i += THREADS) m = fmaxf(m, kval(i));
    const float mx = block_max(m, redf);
    float z = 0.f;
    for (int i = tid; i < V; i += THREADS) {
      const float x = kval(i);
      z += x == -INFINITY ? 0.f : expf(x - mx);
    }
    const float target = top_p * block_sum(z, redf);
    uint32_t ans = 0;
    for (int bit = 31; bit >= 0; --bit) {
      const uint32_t cand = ans | (1u << bit);
      float s = 0.f;
      for (int i = tid; i < V; i += THREADS) {
        const float x = kval(i);
        if (x != -INFINITY && fkey(x) > cand) s += expf(x - mx);
      }
      if (block_sum(s, redf) >= target) ans = cand;
    }
    const uint32_t lo = ans == 0xffffffffu ? ans : ans + 1;
    uint32_t t = 0xffffffffu;
    for (int i = tid; i < V; i += THREADS) {
      const uint32_t k = fkey(kval(i));
      if (k >= lo) t = min(t, k);
    }
    tp = block_min_u(t, redu);
  }

  // draw: first-index argmax of noise + filtered
  float best = -INFINITY;
  int bi = -1;
  const float* g = gumbel ? gumbel + (size_t)b * V : nullptr;
  for (int i = tid; i < V; i += THREADS) {
    float x = kval(i);
    if (do_p && fkey(x) < tp) x = -INFINITY;
    const float v = g ? g[i] + x : x;
    am_merge(best, bi, v, i);
  }
  const int choice = block_argmax(best, bi, redf, redi);

  // behaviour logprob: log_softmax of the raw row at the chosen token
  float m = -INFINITY;
  for (int i = tid; i < V; i += THREADS) m = fmaxf(m, src[i]);
  const float lmax = block_max(m, redf);
  float z = 0.f;
  for (int i = tid; i < V; i += THREADS) z += expf(src[i] - lmax);
  const float zs = block_sum(z, redf);
  if (tid == 0) {
    tok[b] = choice;
    lp[b] = (src[choice] - lmax) - logf(zs);
  }
}

}  // namespace

// Largest row a block stages in shared memory (bytes); wider rows are read
// from global memory on every pass.
constexpr size_t kMaxRowSmem = 220 * 1024;

extern "C" int fused_sample(const void* logits, const void* gumbel, void* tok,
                            void* lp, int B, int V, float temperature,
                            int top_k, float top_p, void* stream) {
  const size_t row_bytes = sizeof(float) * (size_t)V;
  const int use_smem = row_bytes <= kMaxRowSmem;
  const size_t smem = use_smem ? row_bytes : 0;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(fused_sample_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  const int scale_temp = temperature != 1.f;
  const float tdiv = fmaxf(temperature, 1e-6f);
  fused_sample_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)logits, (const float*)gumbel, (int32_t*)tok, (float*)lp, V,
      scale_temp, tdiv, top_k, top_p, use_smem);
  return (int)cudaGetLastError();
}
