// Paged-attention decode: one query per row attends to its K/V read in
// place from the block pool through the row's block table.
//
// Replaces: trlx_tpu/ops/paged_attention.py::paged_attention_decode
//   (_paged_decode_kernel, the pl.pallas_call at paged_attention.py:226).
//
// What bounds it on an H100: bytes. Each step reads every live row's K and
// V columns once (B x S x KV x D x 2 x 2 bytes in bf16) and does about
// 4 x H x D flops per column, far below the ~295 flops/byte the card needs
// to be compute-bound. At the serving shapes (B=8, S~104, D=64) it moves
// only a few hundred KB, so launch latency dominates.
//
// Design: one thread block per (row, kv head). The block loads its row's
// block-table entries itself, clamping ids >= NB to NB-1 (the Pallas
// kernel's clamp_block_table), walks the row one pool block at a time,
// lands the block's bs x D K and V tiles in shared memory once and serves
// all H/KV query heads of the GQA group from that tile load. Softmax is
// online (running max / sum in f32), which the port's tolerance contract
// allows (the TPU kernel kept one full-row softmax for bit parity). The
// additive bias is added before the max, so masked -1e9 columns contribute
// exactly 0 and stale values in recycled blocks never leak. Columns past S
// in the last table block are excluded outright.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* y) { *y = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* y) { *y = __float2bfloat16(x); }

template <typename T>
__global__ void paged_decode_kernel(
    const T* __restrict__ q,          // (B, H, D)
    const T* __restrict__ k_pool,     // (NB, bs, KV, D)
    const T* __restrict__ v_pool,     // (NB, bs, KV, D)
    const int32_t* __restrict__ table,  // (B, TB)
    const float* __restrict__ bias,   // (B, HB, S)
    T* __restrict__ out,              // (B, H, D)
    int H, int KV, int D, int NB, int bs, int TB, int HB, int S,
    float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;

  extern __shared__ float smem[];
  float* q_s = smem;              // G * D
  float* k_s = q_s + G * D;       // bs * D
  float* v_s = k_s + bs * D;      // bs * D
  float* sc = v_s + bs * D;       // G * bs
  float* acc = sc + G * bs;       // G * D
  float* m_s = acc + G * D;       // G running max
  float* l_s = m_s + G;           // G running sum
  float* a_s = l_s + G;           // G rescale factor of this tile

  for (int i = tid; i < G * D; i += nth) {
    const int g = i / D, d = i % D;
    q_s[i] = to_f(q[((size_t)b * H + kvh * G + g) * D + d]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += nth) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
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
    for (int i = tid; i < G * bs; i += nth) {
      const int g = i / bs, r = i % bs;
      const int col = col0 + r;
      float s = -INFINITY;
      if (col < S) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += q_s[g * D + d] * k_s[r * D + d];
        const int hb = HB == 1 ? 0 : kvh * G + g;
        s = dot * scale + bias[((size_t)b * HB + hb) * S + col];
      }
      sc[i] = s;
    }
    __syncthreads();
    for (int g = tid; g < G; g += nth) {
      float mx = m_s[g];
      for (int r = 0; r < bs; ++r) mx = fmaxf(mx, sc[g * bs + r]);
      const float alpha = (mx == -INFINITY) ? 1.f : expf(m_s[g] - mx);
      float sum = 0.f;
      for (int r = 0; r < bs; ++r) {
        const float s = sc[g * bs + r];
        const float p = (s == -INFINITY) ? 0.f : expf(s - mx);
        sc[g * bs + r] = p;
        sum += p;
      }
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = mx;
      a_s[g] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += nth) {
      const int g = i / D, d = i % D;
      float a = acc[i] * a_s[g];
      for (int r = 0; r < bs; ++r) a += sc[g * bs + r] * v_s[r * D + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += nth) {
    const int g = i / D, d = i % D;
    const float l = l_s[g];
    from_f(l > 0.f ? acc[i] / l : 0.f,
           &out[((size_t)b * H + kvh * G + g) * D + d]);
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* bias, void* out, int B, int H,
           int KV, int D, int NB, int bs, int TB, int HB, int S,
           cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem =
      sizeof(float) * ((size_t)G * D * 2 + (size_t)bs * D * 2 + (size_t)G * bs + 3 * G);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(paged_decode_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  dim3 grid(KV, B);
  paged_decode_kernel<T><<<grid, 128, smem, stream>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, (const int32_t*)table,
      (const float*)bias, (T*)out, H, KV, D, NB, bs, TB, HB, S,
      1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* table,
                            const void* bias, void* out, int B, int H, int KV,
                            int D, int NB, int bs, int TB, int HB, int S,
                            int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, table, bias, out, B, H, KV, D, NB,
                         bs, TB, HB, S, st);
  return launch<__nv_bfloat16>(q, k_pool, v_pool, table, bias, out, B, H, KV,
                               D, NB, bs, TB, HB, S, st);
}
