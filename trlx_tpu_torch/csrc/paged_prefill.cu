// Paged prefill attention: a chunk of T queries per row attends over the
// row's full S-wide key row, read in place from the block pool through the
// row's block table. The chunk's own K/V is committed by the caller first.
//
// Replaces: trlx_tpu/ops/paged_prefill.py::paged_prefill_attention
//   (_paged_prefill_kernel, the pl.pallas_call at paged_prefill.py:212).
//
// What bounds it on an H100: at the serving shapes (B=8, T=64, S~104,
// H=12, D=64) the work is about 4 x B x H x T x S x D ~ 160 MFLOP against
// a few MB of K/V, bias and queries, so the ideal time is a few
// microseconds either way and launch latency dominates. For long prompts
// it turns compute-bound; this first kernel uses CUDA cores, not wgmma.
//
// Design: one thread block per (q tile of QT rows, head, row). The block
// loads its row's block-table entries itself (ids >= NB clamp to NB-1, as
// in clamp_block_table), walks the row one pool block at a time, lands
// the block's bs x D K and V tiles in shared memory once per tile of QT
// queries, and keeps an online softmax (running max and sum in f32) with
// the output accumulator in shared memory. The bias (B, HB, T, S) is read
// as given and added before the max, so masked -1e9 columns contribute
// exactly 0 and stale recycled blocks never leak. Columns past S in the
// last table block are excluded outright.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QT = 16;  // query rows per thread block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* y) { *y = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* y) { *y = __float2bfloat16(x); }

template <typename T>
__global__ void paged_prefill_kernel(
    const T* __restrict__ q,          // (B, T, H, D)
    const T* __restrict__ k_pool,     // (NB, bs, KV, D)
    const T* __restrict__ v_pool,     // (NB, bs, KV, D)
    const int32_t* __restrict__ table,  // (B, TB)
    const float* __restrict__ bias,   // (B, HB, T, S)
    T* __restrict__ out,              // (B, T, H, D)
    int Tq, int H, int KV, int D, int NB, int bs, int TB, int HB, int S,
    float scale) {
  const int t0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int hb = HB == 1 ? 0 : h;
  const int nq = min(QT, Tq - t0);
  const int tid = threadIdx.x;
  const int nth = blockDim.x;

  extern __shared__ float smem[];
  float* q_s = smem;              // QT * D
  float* k_s = q_s + QT * D;      // bs * D
  float* v_s = k_s + bs * D;      // bs * D
  float* sc = v_s + bs * D;       // QT * bs
  float* acc = sc + QT * bs;      // QT * D
  float* m_s = acc + QT * D;      // QT
  float* l_s = m_s + QT;          // QT
  float* a_s = l_s + QT;          // QT

  for (int i = tid; i < QT * D; i += nth) {
    const int r = i / D, d = i % D;
    q_s[i] = r < nq ? to_f(q[(((size_t)b * Tq + t0 + r) * H + h) * D + d]) : 0.f;
    acc[i] = 0.f;
  }
  for (int r = tid; r < QT; r += nth) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  __syncthreads();

  for (int j = 0; j < TB; ++j) {
    const int col0 = j * bs;
    if (col0 >= S) break;
    int blk = table[(size_t)b * TB + j];
    blk = blk < 0 ? 0 : (blk >= NB ? NB - 1 : blk);
    for (int i = tid; i < bs * D; i += nth) {
      const int r = i / D, d = i % D;
      const size_t off = (((size_t)blk * bs + r) * KV + kvh) * D + d;
      k_s[i] = to_f(k_pool[off]);
      v_s[i] = to_f(v_pool[off]);
    }
    __syncthreads();
    for (int i = tid; i < QT * bs; i += nth) {
      const int r = i / bs, c = i % bs;
      const int col = col0 + c;
      float s = -INFINITY;
      if (r < nq && col < S) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += q_s[r * D + d] * k_s[c * D + d];
        s = dot * scale + bias[(((size_t)b * HB + hb) * Tq + t0 + r) * S + col];
      }
      sc[i] = s;
    }
    __syncthreads();
    for (int r = tid; r < QT; r += nth) {
      float mx = m_s[r];
      for (int c = 0; c < bs; ++c) mx = fmaxf(mx, sc[r * bs + c]);
      const float alpha = (mx == -INFINITY) ? 1.f : expf(m_s[r] - mx);
      float sum = 0.f;
      for (int c = 0; c < bs; ++c) {
        const float s = sc[r * bs + c];
        const float p = (s == -INFINITY) ? 0.f : expf(s - mx);
        sc[r * bs + c] = p;
        sum += p;
      }
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = mx;
      a_s[r] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < QT * D; i += nth) {
      const int r = i / D, d = i % D;
      float a = acc[i] * a_s[r];
      for (int c = 0; c < bs; ++c) a += sc[r * bs + c] * v_s[c * D + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < nq * D; i += nth) {
    const int r = i / D, d = i % D;
    const float l = l_s[r];
    from_f(l > 0.f ? acc[i] / l : 0.f,
           &out[(((size_t)b * Tq + t0 + r) * H + h) * D + d]);
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* bias, void* out, int B, int Tq,
           int H, int KV, int D, int NB, int bs, int TB, int HB, int S,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)QT * D * 2 + (size_t)bs * D * 2 + (size_t)QT * bs + 3 * QT);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(paged_prefill_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  dim3 grid((Tq + QT - 1) / QT, H, B);
  paged_prefill_kernel<T><<<grid, 128, smem, stream>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, (const int32_t*)table,
      (const float*)bias, (T*)out, Tq, H, KV, D, NB, bs, TB, HB, S,
      1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).
extern "C" int paged_prefill(const void* q, const void* k_pool,
                             const void* v_pool, const void* table,
                             const void* bias, void* out, int B, int Tq, int H,
                             int KV, int D, int NB, int bs, int TB, int HB,
                             int S, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, table, bias, out, B, Tq, H, KV, D,
                         NB, bs, TB, HB, S, st);
  return launch<__nv_bfloat16>(q, k_pool, v_pool, table, bias, out, B, Tq, H,
                               KV, D, NB, bs, TB, HB, S, st);
}
