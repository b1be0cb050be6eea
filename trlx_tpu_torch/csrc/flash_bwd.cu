// Flash-attention backward: dq, dk, dv by recomputation from the forward's
// logsumexp and delta = rowsum(do * out).
//
// Replaces: trlx_tpu/ops/flash_attention.py::_bwd_fused_call
//   (_bwd_fused_kernel, the pl.pallas_call at flash_attention.py:377;
//   also the kernel behind flash_attention_bwd_chunk).
//
// Math (that of the TPU kernel): with s = (q * sm_scale) . k (+ ALiBi) on
// visible pairs, p = exp(s - lse) * visible, dv = p^T do, dp = do v^T,
// ds = p * (dp - delta), dk = ds^T (q * sm_scale), dq = (ds k) * sm_scale.
// Visibility is the forward's (key mask, causal slots with offsets, sliding
// window); rows and columns past T and S are masked, not padded.
//
// What bounds it on an H100: about 2.5x the forward's operations (five
// products per tile pair) against the forward's bytes plus do, delta, lse
// and three gradients; compute-bound at long sequences. Like the forward
// it runs on CUDA cores in f32, far below the tensor-core bound.
//
// Design: the TPU kernel keeps dq resident across a k-block grid that runs
// in order; Hopper's blocks run in parallel in no order, so that does not
// carry over. This file uses FA2's split instead of f32 atomics, which
// keeps the result deterministic: two launches, both counted as this one
// kernel.
//   1. dk/dv: one block per (k tile, kv head, row). It stages its K and V
//      tiles once, then loops over the q heads of its GQA group and over
//      the q tiles that can see the k tile (bounds as the TPU kernel's
//      lo/hi), accumulating dk and dv in shared memory. Looping the group
//      inside the block sums the GQA partials without a per-q-head buffer.
//   2. dq: one block per (q tile, head, row), looping over the visible k
//      tiles and accumulating dq in shared memory; sm_scale is applied once
//      at the end. dq is written in q's type, dk/dv in k's.
// K and V tiles use a padded row stride so the dot products are free of
// shared-memory bank conflicts.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QT = 32;  // query rows per tile
constexpr int KT = 32;  // key columns per tile
constexpr int NTH = 256;

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

struct Geometry {
  int Tq, S, H, KV, D, q_off, k_off, causal, window;
};

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
// 1. dk / dv
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NTH) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ kmask, const int32_t* __restrict__ qpos,
    const int32_t* __restrict__ kpos, const float* __restrict__ slopes,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
    Geometry g, float scale) {
  const int s0 = blockIdx.x * KT;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int nk = min(KT, g.S - s0);
  const int D = g.D, DP = D + 1;
  const int group = g.H / g.KV;
  const int tid = threadIdx.x;
  const float* kmask_row = kmask + (size_t)b * g.S;

  extern __shared__ float smem[];
  float* k_s = smem;             // KT * DP
  float* v_s = k_s + KT * DP;    // KT * DP
  float* dk_s = v_s + KT * DP;   // KT * D
  float* dv_s = dk_s + KT * D;   // KT * D
  float* q_s = dv_s + KT * D;    // QT * D, pre-scaled
  float* do_s = q_s + QT * D;    // QT * D
  float* p_s = do_s + QT * D;    // QT * KT
  float* ds_s = p_s + QT * KT;   // QT * KT
  float* lse_s = ds_s + QT * KT; // QT
  float* dl_s = lse_s + QT;      // QT
  float* qp_s = dl_s + QT;       // QT
  float* kp_s = qp_s + QT;       // KT

  for (int i = tid; i < KT * D; i += NTH) {
    const int c = i / D, d = i % D;
    float kx = 0.f, vx = 0.f;
    if (c < nk) {
      const size_t off = (((size_t)b * g.S + s0 + c) * g.KV + kvh) * D + d;
      kx = to_f(k[off]);
      vx = to_f(v[off]);
    }
    k_s[c * DP + d] = kx;
    v_s[c * DP + d] = vx;
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
      for (int i = tid; i < QT * D; i += NTH) {
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
      __syncthreads();
      for (int i = tid; i < QT * KT; i += NTH) {
        const int r = i / KT, c = i % KT;
        float p = 0.f, ds = 0.f;
        if (visible(g, kmask_row, t0 + r, s0 + c)) {
          float s = 0.f, dp = 0.f;
          for (int d = 0; d < D; ++d) {
            s += q_s[r * D + d] * k_s[c * DP + d];
            dp += do_s[r * D + d] * v_s[c * DP + d];
          }
          if (slopes != nullptr) s += slope * (kp_s[c] - qp_s[r]);
          p = expf(s - lse_s[r]);
          ds = p * (dp - dl_s[r]);
        }
        p_s[i] = p;
        ds_s[i] = ds;
      }
      __syncthreads();
      for (int i = tid; i < KT * D; i += NTH) {
        const int c = i / D, d = i % D;
        float a = dv_s[i], bk = dk_s[i];
        for (int r = 0; r < QT; ++r) {
          a += p_s[r * KT + c] * do_s[r * D + d];
          bk += ds_s[r * KT + c] * q_s[r * D + d];
        }
        dv_s[i] = a;
        dk_s[i] = bk;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < nk * D; i += NTH) {
    const int c = i / D, d = i % D;
    const size_t off = (((size_t)b * g.S + s0 + c) * g.KV + kvh) * D + d;
    from_f(dk_s[i], &dk[off]);
    from_f(dv_s[i], &dv[off]);
  }
}

// ---------------------------------------------------------------------------
// 2. dq
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NTH) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ kmask, const int32_t* __restrict__ qpos,
    const int32_t* __restrict__ kpos, const float* __restrict__ slopes,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const T* __restrict__ dout, T* __restrict__ dq, Geometry g, float scale) {
  const int t0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nq = min(QT, g.Tq - t0);
  const int D = g.D, DP = D + 1;
  const int kvh = h / (g.H / g.KV);
  const int tid = threadIdx.x;
  const float* kmask_row = kmask + (size_t)b * g.S;
  const float slope = slopes != nullptr ? slopes[h] : 0.f;

  extern __shared__ float smem[];
  float* q_s = smem;              // QT * D, pre-scaled
  float* do_s = q_s + QT * D;     // QT * D
  float* dq_s = do_s + QT * D;    // QT * D
  float* k_s = dq_s + QT * D;     // KT * DP
  float* v_s = k_s + KT * DP;     // KT * DP
  float* ds_s = v_s + KT * DP;    // QT * KT
  float* lse_s = ds_s + QT * KT;  // QT
  float* dl_s = lse_s + QT;       // QT
  float* qp_s = dl_s + QT;        // QT
  float* kp_s = qp_s + QT;        // KT

  for (int i = tid; i < QT * D; i += NTH) {
    const int r = i / D, d = i % D;
    float qx = 0.f, dx = 0.f;
    if (r < nq) {
      const size_t off = (((size_t)b * g.Tq + t0 + r) * g.H + h) * D + d;
      qx = to_f(q[off]) * scale;
      dx = to_f(dout[off]);
    }
    q_s[i] = qx;
    do_s[i] = dx;
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
    for (int i = tid; i < KT * D; i += NTH) {
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
    __syncthreads();
    for (int i = tid; i < QT * KT; i += NTH) {
      const int r = i / KT, c = i % KT;
      float ds = 0.f;
      if (visible(g, kmask_row, t0 + r, s0 + c)) {
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s += q_s[r * D + d] * k_s[c * DP + d];
          dp += do_s[r * D + d] * v_s[c * DP + d];
        }
        if (slopes != nullptr) s += slope * (kp_s[c] - qp_s[r]);
        ds = expf(s - lse_s[r]) * (dp - dl_s[r]);
      }
      ds_s[i] = ds;
    }
    __syncthreads();
    for (int i = tid; i < QT * D; i += NTH) {
      const int r = i / D, d = i % D;
      float a = dq_s[i];
      for (int c = 0; c < KT; ++c) a += ds_s[r * KT + c] * k_s[c * DP + d];
      dq_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < nq * D; i += NTH) {
    const int r = i / D, d = i % D;
    from_f(dq_s[i] * scale, &dq[(((size_t)b * g.Tq + t0 + r) * g.H + h) * D + d]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kmask,
           const void* qpos, const void* kpos, const void* slopes,
           const void* lse, const void* delta, const void* dout, void* dq,
           void* dk, void* dv, int B, const Geometry& g, float scale,
           cudaStream_t stream) {
  const int D = g.D;
  const size_t smem_kv = sizeof(float) *
      ((size_t)2 * KT * (D + 1) + (size_t)2 * KT * D + (size_t)2 * QT * D +
       2 * QT * KT + 3 * QT + KT);
  const size_t smem_q = sizeof(float) *
      ((size_t)3 * QT * D + (size_t)2 * KT * (D + 1) + QT * KT + 3 * QT + KT);
  cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  cudaFuncSetAttribute(flash_bwd_dq_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  dim3 grid_kv((g.S + KT - 1) / KT, g.KV, B);
  flash_bwd_dkdv_kernel<T><<<grid_kv, NTH, smem_kv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)kmask,
      (const int32_t*)qpos, (const int32_t*)kpos, (const float*)slopes,
      (const float*)lse, (const float*)delta, (const T*)dout, (T*)dk, (T*)dv, g,
      scale);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  dim3 grid_q((g.Tq + QT - 1) / QT, g.H, B);
  flash_bwd_dq_kernel<T><<<grid_q, NTH, smem_q, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)kmask,
      (const int32_t*)qpos, (const int32_t*)kpos, (const float*)slopes,
      (const float*)lse, (const float*)delta, (const T*)dout, (T*)dq, g, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the three gradients
// share it). lse and delta are (B, H, T) f32; qpos, kpos and slopes are
// null without ALiBi.
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
    return launch<float>(q, k, v, kmask, qpos, kpos, slopes, lse, delta, dout, dq,
                         dk, dv, B, g, scale, st);
  return launch<__nv_bfloat16>(q, k, v, kmask, qpos, kpos, slopes, lse, delta, dout,
                               dq, dk, dv, B, g, scale, st);
}
