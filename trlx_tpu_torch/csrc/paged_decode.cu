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
// One design for f32 and bf16, templated on the type and on a padded head
// dim DT in {16, 32, 64, 128, 256}, which takes any D up to DT at run time:
// a lane's slice of a row past D is zero (queries) or never read (K/V),
// and only D columns are stored. Rows are read with their true stride, so
// no padded copy of the pool exists. Loads are 16 bytes when D is a
// multiple of 16 bytes' worth of the type and the operands are 16-byte
// aligned, else element by element (a bf16 row of D = 12 is 24 bytes): a
// template parameter the launcher picks. At DT = 256 a lane holds 8
// elements (two 16-byte vectors in f32) and a block serves at most 4 heads
// of a group. D above 256 (any D, as the JAX kernel takes) runs the DT = 256
// kernel split over the head dim: a grid dimension of ceil(D / 256) output
// chunks, each block streaming q.k over every chunk (q and K slices loaded
// chunk by chunk into the same registers) and accumulating its own chunk of
// P V, so no register array or shared tile grows past DT = 256's; the
// scores are recomputed once per output chunk.
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
  // elements [e0, e0 + 4) of a row of D, zero past D
  __device__ static void partial(const float* row, int e0, int D, uint4& u) {
    u.x = e0 < D ? __float_as_uint(row[e0]) : 0u;
    u.y = e0 + 1 < D ? __float_as_uint(row[e0 + 1]) : 0u;
    u.z = e0 + 2 < D ? __float_as_uint(row[e0 + 2]) : 0u;
    u.w = e0 + 3 < D ? __float_as_uint(row[e0 + 3]) : 0u;
  }
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
  // elements [e0, e0 + 8) of a row of D, zero past D
  __device__ static void partial(const __nv_bfloat16* row, int e0, int D, uint4& u) {
    const uint16_t* r = reinterpret_cast<const uint16_t*>(row);
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + 2 * j;
      w[j] = (e < D ? (uint32_t)r[e] : 0u) | ((e + 1 < D ? (uint32_t)r[e + 1] : 0u) << 16);
    }
    u = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// 16 bytes of row (elements [e0, e0 + N)), zero past D: one vector load when
// `vec` (D a multiple of N, aligned operands), else element by element
template <typename T>
__device__ __forceinline__ void load_vec(const T* row, int e0, int D, bool vec, uint4& u) {
  if (vec) {
    u = make_uint4(0u, 0u, 0u, 0u);
    if (e0 < D) Vec<T>::raw(row + e0, u);
  } else {
    Vec<T>::partial(row, e0, D, u);
  }
}

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

// Grid: x = kv head x head chunk (x output chunk of DT columns with SPLIT),
// y = row, z = column span. With one span the block writes the output; with
// several it writes its span's partial state to part[(b, h, span)] =
// (acc[0 .. D), m, l). SPLIT (DT = 256, D > 256): q.k streams over the
// head dim in chunks of DT (q and K slices loaded chunk by chunk, the
// lane's partial dot carried across chunks) and the block accumulates only
// its own output chunk of P V; every chunk's block computes the same
// scores, and chunk 0 writes the span's (m, l).
template <typename T, int DT, int GM, bool WIDE, bool SPLIT>
__global__ void __launch_bounds__(32 * NW) paged_decode_kernel(
    const T* __restrict__ q,            // (B, H, D)
    const T* __restrict__ k_pool,       // (NB, bs, KV, D)
    const T* __restrict__ v_pool,       // (NB, bs, KV, D)
    const int32_t* __restrict__ table,  // (B, TB)
    const float* __restrict__ bias,     // (B, HB, S)
    T* __restrict__ out,                // (B, H, D)
    float* __restrict__ part,           // (B, H, spans, D + 2) when spans > 1
    int H, int KV, int D, int NB, int bs, int TB, int HB, int S, float scale) {
  using V = Vec<T>;
  constexpr bool vec = WIDE;
  constexpr int VEC = V::N;
  constexpr int LPR = DT / VEC > 32 ? 32 : DT / VEC;  // lanes per key row
  constexpr int NV = DT / (VEC * LPR);                // 16-byte vectors per lane
  constexpr int EPL = NV * VEC;                       // elements per lane
  constexpr int RPW = 32 / LPR;                       // key rows a warp serves at once
  constexpr int U = (GM >= 8 || NV > 1) ? 2 : 4;      // columns per lane group in flight
  static_assert(LPR >= 1 && 32 % LPR == 0 && LPR * EPL == DT, "DT must be 16 .. 256");

  __shared__ int tbl_s[SPAN_COLS + 1];
  __shared__ float ml_s[NW][GM][2];
  __shared__ float acc_s[NW][GM][DT];

  const int G = H / KV;
  const int chunks = (G + GM - 1) / GM;
  const int nch = SPLIT ? (D + DT - 1) / DT : 1;   // head-dim chunks
  const int oc = SPLIT ? blockIdx.x % nch : 0;     // this block's output chunk
  const int d0 = oc * DT, od = SPLIT ? min(DT, D - d0) : D;
  const int hx = SPLIT ? blockIdx.x / nch : blockIdx.x;
  const int kvh = hx / chunks, hc = hx % chunks;
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
  // this lane's slice of the queries (zero past D), chunk cc of DT columns
  float qv[GM][EPL];
  auto load_q = [&](int cc) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (g < ng)
          load_vec(q + ((size_t)b * H + h0 + g) * D + cc * DT, li * EPL + j * VEC, D - cc * DT,
                   vec, u);
        float x[VEC];
        V::unpack(u, x);
#pragma unroll
        for (int e = 0; e < VEC; ++e) qv[g][j * VEC + e] = x[e];
      }
  };
  if (!SPLIT) load_q(0);
  __syncthreads();

  float m[GM], l[GM], acc[GM][EPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  // the warp's contiguous sub-span of columns
  const int per = (c1 - c0 + NW - 1) / NW;
  const int w0 = c0 + warp * per, w1 = min(c1, w0 + per);
  const size_t row_stride = (size_t)KV * D;
  const int hb0 = HB == 1 ? 0 : h0;
  // every lane of the warp takes the same trips (the shuffles need all 32)
  for (int base = w0; base < w1; base += RPW * U) {
    uint4 kr[U][NV], vr[U][NV];
    float bb[U][GM];
    size_t offs[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int col = base + grp + u * RPW;
#pragma unroll
      for (int j = 0; j < NV; ++j) kr[u][j] = vr[u][j] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int g = 0; g < GM; ++g) bb[u][g] = 0.f;
      if (col < w1) {
        const int jb = col / bs;
        const size_t off = ((size_t)tbl_s[jb - j0] * bs + (col - jb * bs)) * row_stride +
                           (size_t)kvh * D;
        offs[u] = off;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          if (!SPLIT) load_vec(k_pool + off, li * EPL + j * VEC, D, vec, kr[u][j]);
          load_vec(v_pool + off + d0, li * EPL + j * VEC, D - d0, vec, vr[u][j]);
        }
        const float* brow = bias + ((size_t)b * HB + hb0) * S + col;
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < ng && (HB > 1 || g == 0)) bb[u][g] = brow[g * (size_t)S];
      }
    }
    // the lane's partial q.k of each column, over one chunk (or D)
    float dd[U][GM];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < GM; ++g) dd[u][g] = 0.f;
    auto partial_dots = [&]() {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[EPL];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          float x[VEC];
          V::unpack(kr[u][j], x);
#pragma unroll
          for (int e = 0; e < VEC; ++e) kf[j * VEC + e] = x[e];
        }
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int e = 0; e < EPL; ++e) dd[u][g] += qv[g][e] * kf[e];
      }
    };
    if (SPLIT) {
      for (int cc = 0; cc < nch; ++cc) {
        load_q(cc);
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            kr[u][j] = make_uint4(0u, 0u, 0u, 0u);
            if (base + grp + u * RPW < w1)
              load_vec(k_pool + offs[u] + cc * DT, li * EPL + j * VEC, D - cc * DT, vec,
                       kr[u][j]);
          }
        partial_dots();
      }
    } else {
      partial_dots();
    }
    float sc[U][GM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float d = dd[u][g];
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
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = sc[u][g] == -INFINITY ? 0.f : __expf(sc[u][g] - mx);
        l[g] += p;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          float vf[VEC];
          V::unpack(vr[u][j], vf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][j * VEC + e] += p * vf[e];
        }
      }
      m[g] = mx;
    }
  }

  // merge the warp's lane groups (lanes li, li + LPR, ... hold the same dims)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float acc2[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc2[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
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
      for (int e = 0; e < EPL; ++e) acc_s[warp][g][li * EPL + e] = acc[g][e];
    }
  }
  __syncthreads();

  // merge the warps in order: thread (g, d), d < od (this block's columns)
  for (int i = tid; i < ng * DT; i += 32 * NW) {
    const int g = i / DT, d = i % DT;
    if (d >= od) continue;
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
      out[bh * D + d0 + d] = V::store(den > 0.f ? x / den : 0.f);
    } else {
      float* p = part + (bh * spans + span) * (D + 2);
      p[d0 + d] = x;
      if (d0 + d == 0) {
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

template <typename T, int DT, int GM, bool SPLIT>
int launch_gm(const void* q, const void* k_pool, const void* v_pool, const void* table,
              const void* bias, void* out, void* part, int B, int H, int KV, int D, int NB,
              int bs, int TB, int HB, int S, int vec, cudaStream_t stream) {
  const int G = H / KV;
  const int spans = (S + SPAN_COLS - 1) / SPAN_COLS;
  const int nch = SPLIT ? (D + DT - 1) / DT : 1;
  dim3 grid(KV * ((G + GM - 1) / GM) * nch, B, spans);
  // the load path by the shape: 16-byte loads, or element by element
  auto kernel = vec ? paged_decode_kernel<T, DT, GM, true, SPLIT>
                    : paged_decode_kernel<T, DT, GM, false, SPLIT>;
  kernel<<<grid, 32 * NW, 0, stream>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, (const int32_t*)table,
      (const float*)bias, (T*)out, (float*)part, H, KV, D, NB, bs, TB, HB, S,
      1.f / sqrtf((float)D));
  int rc = (int)cudaGetLastError();
  if (rc != 0 || spans == 1) return rc;
  paged_decode_merge_kernel<T><<<B * H, D < 1024 ? D : 1024, 0, stream>>>((const float*)part,
                                                                          (T*)out, D, spans);
  return (int)cudaGetLastError();
}

// heads per block by the group size G; at DT = 256 at most 4 (the warps'
// partial accumulators must fit in static shared memory)
template <typename T, int DT, bool SPLIT = false>
int launch_d(const void* q, const void* k_pool, const void* v_pool, const void* table,
             const void* bias, void* out, void* part, int B, int H, int KV, int D, int NB,
             int bs, int TB, int HB, int S, int vec, cudaStream_t stream) {
  const int G = H / KV;
  if (G <= 1)
    return launch_gm<T, DT, 1, SPLIT>(q, k_pool, v_pool, table, bias, out, part, B, H, KV, D,
                                      NB, bs, TB, HB, S, vec, stream);
  if (G <= 2)
    return launch_gm<T, DT, 2, SPLIT>(q, k_pool, v_pool, table, bias, out, part, B, H, KV, D,
                                      NB, bs, TB, HB, S, vec, stream);
  if (G <= 4 || DT >= 256)
    return launch_gm<T, DT, 4, SPLIT>(q, k_pool, v_pool, table, bias, out, part, B, H, KV, D,
                                      NB, bs, TB, HB, S, vec, stream);
  return launch_gm<T, DT, DT >= 256 ? 4 : 8, SPLIT>(q, k_pool, v_pool, table, bias, out, part, B,
                                                    H, KV, D, NB, bs, TB, HB, S, vec, stream);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* table,
           const void* bias, void* out, void* part, int B, int H, int KV, int D, int NB,
           int bs, int TB, int HB, int S, cudaStream_t stream) {
  const int vec = D % Vec<T>::N == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k_pool) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v_pool) % 16 == 0;
  if (D <= 16)
    return launch_d<T, 16>(q, k_pool, v_pool, table, bias, out, part, B, H, KV, D, NB, bs, TB,
                           HB, S, vec, stream);
  if (D <= 32)
    return launch_d<T, 32>(q, k_pool, v_pool, table, bias, out, part, B, H, KV, D, NB, bs, TB,
                           HB, S, vec, stream);
  if (D <= 64)
    return launch_d<T, 64>(q, k_pool, v_pool, table, bias, out, part, B, H, KV, D, NB, bs, TB,
                           HB, S, vec, stream);
  if (D <= 128)
    return launch_d<T, 128>(q, k_pool, v_pool, table, bias, out, part, B, H, KV, D, NB, bs,
                            TB, HB, S, vec, stream);
  if (D <= 256)
    return launch_d<T, 256>(q, k_pool, v_pool, table, bias, out, part, B, H, KV, D, NB, bs,
                            TB, HB, S, vec, stream);
  return launch_d<T, 256, true>(q, k_pool, v_pool, table, bias, out, part, B, H, KV, D, NB,
                                bs, TB, HB, S, vec, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it). Any D:
// up to 256 padded inside the loads to 16, 32, 64, 128 or 256, above 256 in
// chunks of 256 (SPLIT). The columns split into spans of SPAN_COLS (256); with
// more than one span, part is f32 scratch of (B, H, spans, D + 2).
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
