// Paged-attention decode: one query per row attends to its K/V read in
// place from the block pool through the row's block table.
//
// Replaces: trlx_tpu/ops/paged_attention.py::paged_attention_decode
//   (_paged_decode_kernel, the pl.pallas_call at paged_attention.py:226).
//
// What bounds it on an H100: at long rows, bytes: each step reads every
// live row's K and V columns once (B x S x KV x D x 2 x 2 bytes in bf16)
// and does about 4 x G x D flops per column (G = H / KV query heads per kv
// head), far below the ~295 flops/byte the card needs to be compute-bound,
// so tensor cores buy nothing and the kernel stays on CUDA cores. At the
// serving shape (B=8, H=KV=12, D=64, bs=16, S=104) it moves ~1.2 MB
// (~0.4 us at 3.35 TB/s): there the bound is latency, the number of
// dependent global round trips a row costs. The first version gave each
// (row, kv head) one 128-thread block that walked the row one pool block
// at a time (load the block's K and V into shared memory, scores on
// G x bs threads, a softmax on G threads, then P V, four barriers per
// block): seven dependent rounds at S = 104, 6x cuDNN's time.
//
// Design: all of a row's loads in flight at once, no serial softmax.
// - A block of 8 warps serves one (row, kv head, column span) and up to GM
//   of the group's query heads (GM in {1, 2, 4, 8} by G; a larger group
//   takes several blocks). It first lands the span's block-table entries
//   in shared memory (ids clamped into [0, NB - 1], as clamp_block_table
//   does) and its queries in registers.
// - The warps split the span's columns into contiguous sub-spans. Column c
//   is row c % bs of pool block table[c / bs], so every block size works.
//   Lanes work in groups of D / VEC (VEC = 16 bytes of the type): each
//   lane loads 16 bytes of a K row and of the V row, and the group sums
//   the dot product by __shfl_xor_sync. Each lane group streams its own
//   columns with its own online softmax (running max and sum in f32, the
//   additive bias added before the max) and its own accumulator slice, U
//   columns' loads issued before any is used. There is no barrier inside
//   the walk: at S = 104 each warp holds about 13 columns, so the row
//   costs one table round trip and one K/V round trip.
// - The lane groups merge their (max, sum, acc) by shuffles, the warps
//   through shared memory once at the end, in a fixed order.
// - Long rows: the columns split over a third grid dimension in spans of
//   SPAN_COLS (256, so S = 1000 gives 4 spans; the wrapper's
//   DECODE_SPAN_COLS sizes the scratch and must equal it); each
//   span writes its (max, sum, acc) to scratch and a second launch, counted
//   as this kernel, merges the spans in order. Both are deterministic.
// - Rules kept from the plain version: masked -1e9 columns contribute
//   exactly 0 (the bias is added before the max) and stale values in
//   recycled blocks never leak; a row whose every column is masked
//   averages them as the plain softmax does; columns past S are never read.
// One design for f32 and bf16, templated on the type and on D in {16, 32,
// 64, 128}; the wrapper rejects any other D before launching.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;                 // warps per block
constexpr int SPAN_COLS = 256;        // columns a block spans (its table slice)

// 16 bytes of T as floats
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void raw(const float* p, uint4& u) { u = *reinterpret_cast<const uint4*>(p); }
  __device__ static void unpack(const uint4& u, float (&x)[4]) {
    x[0] = __uint_as_float(u.x); x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z); x[3] = __uint_as_float(u.w);
  }
  __device__ static float store(float x) { return x; }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void raw(const __nv_bfloat16* p, uint4& u) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ static void unpack(const uint4& u, float (&x)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16(x); }
};

// (m, l, acc) <- the merge of two online-softmax states; -inf maxima
// (states that saw no column) weigh 0
template <int N>
__device__ __forceinline__ void merge_state(float& m, float& l, float (&acc)[N], float m2,
                                            float l2, const float (&acc2)[N]) {
  const float mx = fmaxf(m, m2);
  const float a = m == -INFINITY ? 0.f : __expf(m - mx);
  const float c = m2 == -INFINITY ? 0.f : __expf(m2 - mx);
  l = l * a + l2 * c;
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = acc[e] * a + acc2[e] * c;
  m = mx;
}

// Grid: x = kv head x head chunk, y = row, z = column span. With one span
// the block writes the output; with several it writes its span's partial
// state to part[(b, h, span)] = (acc[0 .. D), m, l).
template <typename T, int D, int GM>
__global__ void __launch_bounds__(32 * NW) paged_decode_kernel(
    const T* __restrict__ q,            // (B, H, D)
    const T* __restrict__ k_pool,       // (NB, bs, KV, D)
    const T* __restrict__ v_pool,       // (NB, bs, KV, D)
    const int32_t* __restrict__ table,  // (B, TB)
    const float* __restrict__ bias,     // (B, HB, S)
    T* __restrict__ out,                // (B, H, D)
    float* __restrict__ part,           // (B, H, spans, D + 2) when spans > 1
    int H, int KV, int NB, int bs, int TB, int HB, int S, float scale) {
  using V = Vec<T>;
  constexpr int VEC = V::N;
  constexpr int LPR = D / VEC;     // lanes per key row
  constexpr int RPW = 32 / LPR;    // key rows a warp serves at once
  constexpr int U = GM >= 8 ? 2 : 4;  // columns per lane group in flight
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "D must be 16, 32, 64 or 128");

  __shared__ int tbl_s[SPAN_COLS + 1];
  __shared__ float ml_s[NW][GM][2];
  __shared__ float acc_s[NW][GM][D];

  const int G = H / KV;
  const int chunks = (G + GM - 1) / GM;
  const int kvh = blockIdx.x / chunks, hc = blockIdx.x % chunks;
  const int h0 = kvh * G + hc * GM, ng = min(GM, G - hc * GM);
  const int b = blockIdx.y, span = blockIdx.z, spans = gridDim.z;
  const int c0 = span * SPAN_COLS, c1 = min(S, c0 + SPAN_COLS);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane / LPR, li = lane % LPR;

  // the span's table slice
  const int j0 = c0 / bs, nj = (c1 - 1) / bs - j0 + 1;
  for (int j = tid; j < nj; j += 32 * NW) {
    const int id = table[(size_t)b * TB + j0 + j];
    tbl_s[j] = id < 0 ? 0 : (id >= NB ? NB - 1 : id);
  }
  // this lane's slice of the queries
  float qv[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (g < ng) V::raw(q + ((size_t)b * H + h0 + g) * D + li * VEC, u);
    V::unpack(u, qv[g]);
  }
  __syncthreads();

  float m[GM], l[GM], acc[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  // the warp's contiguous sub-span of columns
  const int per = (c1 - c0 + NW - 1) / NW;
  const int w0 = c0 + warp * per, w1 = min(c1, w0 + per);
  const size_t row_stride = (size_t)KV * D;
  const int hb0 = HB == 1 ? 0 : h0;
  // every lane of the warp takes the same trips (the shuffles need all 32)
  for (int base = w0; base < w1; base += RPW * U) {
    uint4 kr[U], vr[U];
    float bb[U][GM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int col = base + grp + u * RPW;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int g = 0; g < GM; ++g) bb[u][g] = 0.f;
      if (col < w1) {
        const int j = col / bs;
        const size_t off = ((size_t)tbl_s[j - j0] * bs + (col - j * bs)) * row_stride +
                           (size_t)kvh * D + li * VEC;
        V::raw(k_pool + off, kr[u]);
        V::raw(v_pool + off, vr[u]);
        const float* brow = bias + ((size_t)b * HB + hb0) * S + col;
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < ng && (HB > 1 || g == 0)) bb[u][g] = brow[g * (size_t)S];
      }
    }
    float sc[U][GM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
      V::unpack(kr[u], kf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d += qv[g][e] * kf[e];
#pragma unroll
        for (int o = 1; o < LPR; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        const float bg = HB > 1 ? bb[u][g] : bb[u][0];
        sc[u][g] = base + grp + u * RPW < w1 ? d * scale + bg : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, sc[u][g]);
      if (mx == -INFINITY) continue;  // no column in this batch
      const float alpha = __expf(m[g] - mx);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = sc[u][g] == -INFINITY ? 0.f : __expf(sc[u][g] - mx);
        float vf[VEC];
        V::unpack(vr[u], vf);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] += p * vf[e];
      }
      m[g] = mx;
    }
  }

  // merge the warp's lane groups (lanes li, li + LPR, ... hold the same dims)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float acc2[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc2[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], o);
      merge_state(m[g], l[g], acc[g], m2, l2, acc2);
    }
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (li == 0) {
        ml_s[warp][g][0] = m[g];
        ml_s[warp][g][1] = l[g];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc_s[warp][g][li * VEC + e] = acc[g][e];
    }
  }
  __syncthreads();

  // merge the warps in order: thread (g, d)
  for (int i = tid; i < ng * D; i += 32 * NW) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, ml_s[w][g][0]);
    float x = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float mw = ml_s[w][g][0];
      const float c = mw == -INFINITY ? 0.f : __expf(mw - mx);
      x += c * acc_s[w][g][d];
      den += c * ml_s[w][g][1];
    }
    const size_t bh = (size_t)b * H + h0 + g;
    if (spans == 1) {
      out[bh * D + d] = V::store(den > 0.f ? x / den : 0.f);
    } else {
      float* p = part + (bh * spans + span) * (D + 2);
      p[d] = x;
      if (d == 0) {
        p[D] = mx;
        p[D + 1] = den;
      }
    }
  }
}

// the spans' partial states merged in order: block (row x head), thread d
template <typename T>
__global__ void paged_decode_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                                          int D, int spans) {
  const size_t bh = blockIdx.x;
  const float* p = part + bh * spans * (D + 2);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float mx = -INFINITY;
    for (int s = 0; s < spans; ++s) mx = fmaxf(mx, p[s * (D + 2) + D]);
    float x = 0.f, den = 0.f;
    for (int s = 0; s < spans; ++s) {
      const float* ps = p + s * (D + 2);
      const float c = ps[D] == -INFINITY ? 0.f : __expf(ps[D] - mx);
      x += c * ps[d];
      den += c * ps[D + 1];
    }
    out[bh * D + d] = Vec<T>::store(den > 0.f ? x / den : 0.f);
  }
}

template <typename T, int D, int GM>
int launch_gm(const void* q, const void* k_pool, const void* v_pool, const void* table,
              const void* bias, void* out, void* part, int B, int H, int KV, int NB, int bs,
              int TB, int HB, int S, cudaStream_t stream) {
  const int G = H / KV;
  const int spans = (S + SPAN_COLS - 1) / SPAN_COLS;
  dim3 grid(KV * ((G + GM - 1) / GM), B, spans);
  paged_decode_kernel<T, D, GM><<<grid, 32 * NW, 0, stream>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, (const int32_t*)table,
      (const float*)bias, (T*)out, (float*)part, H, KV, NB, bs, TB, HB, S,
      1.f / sqrtf((float)D));
  int rc = (int)cudaGetLastError();
  if (rc != 0 || spans == 1) return rc;
  paged_decode_merge_kernel<T><<<B * H, D, 0, stream>>>((const float*)part, (T*)out, D, spans);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_d(const void* q, const void* k_pool, const void* v_pool, const void* table,
             const void* bias, void* out, void* part, int B, int H, int KV, int NB, int bs,
             int TB, int HB, int S, cudaStream_t stream) {
  const int G = H / KV;
  if (G <= 1)
    return launch_gm<T, D, 1>(q, k_pool, v_pool, table, bias, out, part, B, H, KV, NB, bs,
                              TB, HB, S, stream);
  if (G <= 2)
    return launch_gm<T, D, 2>(q, k_pool, v_pool, table, bias, out, part, B, H, KV, NB, bs,
                              TB, HB, S, stream);
  if (G <= 4)
    return launch_gm<T, D, 4>(q, k_pool, v_pool, table, bias, out, part, B, H, KV, NB, bs,
                              TB, HB, S, stream);
  return launch_gm<T, D, 8>(q, k_pool, v_pool, table, bias, out, part, B, H, KV, NB, bs, TB,
                            HB, S, stream);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* table,
           const void* bias, void* out, void* part, int B, int H, int KV, int D, int NB,
           int bs, int TB, int HB, int S, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_d<T, 16>(q, k_pool, v_pool, table, bias, out, part, B, H, KV, NB, bs, TB,
                             HB, S, stream);
    case 32:
      return launch_d<T, 32>(q, k_pool, v_pool, table, bias, out, part, B, H, KV, NB, bs, TB,
                             HB, S, stream);
    case 64:
      return launch_d<T, 64>(q, k_pool, v_pool, table, bias, out, part, B, H, KV, NB, bs, TB,
                             HB, S, stream);
    case 128:
      return launch_d<T, 128>(q, k_pool, v_pool, table, bias, out, part, B, H, KV, NB, bs,
                              TB, HB, S, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it). D in {16,
// 32, 64, 128}, q and the pools 16-byte aligned (the wrapper checks). The
// columns split into spans of SPAN_COLS (256); with more than one span,
// part is f32 scratch of (B, H, spans, D + 2).
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* table,
                            const void* bias, void* out, void* part, int B, int H,
                            int KV, int D, int NB, int bs, int TB, int HB, int S,
                            int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, table, bias, out, part, B, H, KV, D, NB, bs, TB,
                         HB, S, st);
  return launch<__nv_bfloat16>(q, k_pool, v_pool, table, bias, out, part, B, H, KV, D, NB,
                               bs, TB, HB, S, st);
}
