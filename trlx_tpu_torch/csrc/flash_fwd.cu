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
// key writes out = 0 and lse = NEG_INF (-1e30): the `visible` factor is
// applied after the exponential, so such a row is exactly 0, never NaN.
//
// Layout: the model's, not the TPU kernel's: q/out (B, T, H, D),
// k/v (B, S, KV, D), key_mask (B, S) f32, qpos (B, T) / kpos (B, S) i32,
// lse (B, H, T) f32. T and S need not be multiples of the tiles: the ragged
// edge is masked here instead of padded by the caller.
//
// What bounds it on an H100: the work is 4 x B x H x (visible pairs) x D
// operations against (2 x B x T x H + 2 x B x S x KV) x D elements, so at
// the training shapes (T = S = 104) it is a few microseconds of either and
// launch latency dominates; at T = S = 1024 it is compute-bound. This first
// kernel computes on CUDA cores in f32 (no mma/wgmma), so it runs far below
// the tensor-core bound; making it fast is later work.
//
// Design: one thread block per (q tile of QT rows, head, row). The block
// stages its q tile (pre-scaled by sm_scale) in shared memory, then walks
// the K/V tiles of KT columns that any of its queries can see (tiles wholly
// past the causal edge or before the window are skipped, as the TPU kernel
// bounds lo/hi), staging each K/V tile in shared memory once. Each warp
// owns rows of the tile with one lane per key column, so the row max and
// sum of the online softmax are warp shuffles. K is stored with a padded
// row stride so the q.k dot products are free of bank conflicts.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QT = 32;   // query rows per thread block
constexpr int KT = 32;   // key columns per tile (one per lane)
constexpr int NTH = 256;
constexpr int NWARP = NTH / 32;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* y) { *y = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* y) { *y = __float2bfloat16(x); }

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && (a < 0)) ? q - 1 : q;
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(NTH) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ kmask, const int32_t* __restrict__ qpos,
    const int32_t* __restrict__ kpos, const float* __restrict__ slopes,
    T* __restrict__ out, float* __restrict__ lse, int Tq, int S, int H,
    int KV, int D, int q_off, int k_off, int causal, int window, float scale) {
  const int t0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nq = min(QT, Tq - t0);
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int DP = D + 1;

  extern __shared__ float smem[];
  float* q_s = smem;            // QT * D, pre-scaled
  float* k_s = q_s + QT * D;    // KT * DP
  float* v_s = k_s + KT * DP;   // KT * D
  float* p_s = v_s + KT * D;    // QT * KT scores, then probabilities
  float* acc = p_s + QT * KT;   // QT * D
  float* m_s = acc + QT * D;    // QT running max
  float* l_s = m_s + QT;        // QT running sum
  float* a_s = l_s + QT;        // QT rescale factor of this tile
  float* qp_s = a_s + QT;       // QT query positions (ALiBi)

  for (int i = tid; i < QT * D; i += NTH) {
    const int r = i / D, d = i % D;
    q_s[i] = r < nq ? to_f(q[(((size_t)b * Tq + t0 + r) * H + h) * D + d]) * scale : 0.f;
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
  if (causal) hi = clampi(floordiv(q_off + t0 + nq - 1 - k_off, KT) + 1, 0, nkt);
  if (window > 0) lo = clampi(floordiv(q_off + t0 - (window - 1) - k_off, KT), 0, hi);

  for (int ik = lo; ik < hi; ++ik) {
    const int s0 = ik * KT;
    const int nk = min(KT, S - s0);
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
    for (int i = tid; i < QT * KT; i += NTH) {
      const int r = i / KT, c = i % KT;
      const int col = s0 + c;
      bool vis = r < nq && c < nk && kmask[(size_t)b * S + col] > 0.5f;
      const int qslot = q_off + t0 + r, kslot = k_off + col;
      if (causal) vis = vis && kslot <= qslot;
      if (window > 0) vis = vis && (qslot - kslot < window);
      float s = -INFINITY;  // invisible: no mass, never raises the max
      if (vis) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += q_s[r * D + d] * k_s[c * DP + d];
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
    for (int i = tid; i < QT * D; i += NTH) {
      const int r = i / D, d = i % D;
      float a = acc[i] * a_s[r];
      for (int c = 0; c < KT; ++c) a += p_s[r * KT + c] * v_s[c * D + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < nq * D; i += NTH) {
    const int r = i / D, d = i % D;
    const float l = l_s[r];
    from_f(l > 0.f ? acc[i] / l : 0.f, &out[(((size_t)b * Tq + t0 + r) * H + h) * D + d]);
  }
  for (int r = tid; r < nq; r += NTH) {
    const float l = l_s[r];
    lse[((size_t)b * H + h) * Tq + t0 + r] = l > 0.f ? m_s[r] + logf(l) : NEG_INF;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kmask,
           const void* qpos, const void* kpos, const void* slopes, void* out,
           void* lse, int B, int Tq, int S, int H, int KV, int D, int q_off,
           int k_off, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)QT * D * 2 + (size_t)KT * (D + 1) + (size_t)KT * D + QT * KT + 4 * QT);
  cudaFuncSetAttribute(flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((Tq + QT - 1) / QT, H, B);
  flash_fwd_kernel<T><<<grid, NTH, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)kmask,
      (const int32_t*)qpos, (const int32_t*)kpos, (const float*)slopes, (T*)out,
      (float*)lse, Tq, S, H, KV, D, q_off, k_off, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). qpos, kpos
// and slopes are null without ALiBi.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* kmask, const void* qpos, const void* kpos,
                         const void* slopes, void* out, void* lse, int B, int Tq,
                         int S, int H, int KV, int D, int q_off, int k_off,
                         int causal, int window, float scale, int dtype,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, kmask, qpos, kpos, slopes, out, lse, B, Tq, S, H,
                         KV, D, q_off, k_off, causal, window, scale, st);
  return launch<__nv_bfloat16>(q, k, v, kmask, qpos, kpos, slopes, out, lse, B, Tq,
                               S, H, KV, D, q_off, k_off, causal, window, scale, st);
}
