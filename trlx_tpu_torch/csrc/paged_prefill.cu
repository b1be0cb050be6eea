// Paged span attention: a span of T queries per row attends over the row's
// full S-wide key row, read in place from the block pool through the row's
// block table. The span's own K/V is committed by the caller first.
//
// Replaces: trlx_tpu/ops/paged_prefill.py::paged_prefill_attention
//   (_paged_prefill_kernel, the pl.pallas_call at paged_prefill.py:212),
//   and with it trlx_tpu/ops/paged_attention.py::paged_verify_attention
//   (paged_attention.py:269), the speculative verify, which the JAX
//   package runs through the same pallas_call at T = G + 1 probe queries
//   per row.
//
// What bounds it on an H100: bytes, and in practice the latency of the
// walk over a row's keys. The prefill at the serving shapes (B=8, T=64,
// S=104, H=12, D=64) does ~160 MFLOP (0.2 us at the bf16 tensor-core peak)
// on ~3.8 MB of queries, K/V, bias and output (~1.1 us at 3.35 TB/s); the
// verify (B=32, T=5, S=108) moves ~8 MB (~2.5 us). Both are a few
// microseconds of work spread over a serial walk of a row's keys per
// (row, head), with one or two warps per SM scheduler: what matters is
// how few dependent steps each warp takes and that the next chunk's loads
// are in flight while the current one computes.
//
// Design of the bf16 kernel (tensor cores, mma.sync m16n8k16; not wgmma,
// whose 64-row tile would waste 59 of 64 rows at the verify's T = 5):
// - Each warp owns a 16-row query tile held in registers as A fragments.
//   Keys are walked in chunks of KC columns (16 or 32) whatever the block
//   size bs: each key row's block id is table[b, col / bs] (clamped into
//   [0, NB-1], as clamp_block_table does) and its row col % bs; one row of
//   one kv head is D x 2 contiguous bytes, copied by 16-byte cp.async into
//   a ring of stages in shared memory (rows padded to D + 8 so that
//   ldmatrix is conflict-free), the next chunk in flight while one
//   computes. Each stage also lands the chunk's f32 bias tile for the
//   group's query rows (16-byte copies when S % 4 == 0, else 4-byte), so
//   inside the walk no load is waited on but the ring's own. Table ids are
//   read one copy ahead into registers; col / bs is a multiply-high.
// - S = Q K^T by mma (K fragments by ldmatrix), the f32 bias added to the
//   score fragments in registers before the running max, online softmax in
//   f32 with quad-shuffle row reductions, the probabilities rounded to bf16
//   (as the plain version rounds them before p.v) and fed straight back as
//   the A operand of P V (V fragments by ldmatrix.trans). The running sum
//   adds the rounded probabilities, so the weights that multiply V sum to
//   one and the rounding's error scales with how far each v lies from the
//   output, not with |v|: at outputs of 2-4 (few visible keys) an f32 sum
//   put the bf16 error above the output's own rounding.
// - Two layouts, chosen by T in the launcher. T > 16 (prefill): a block of
//   2 warps holds 32 queries of one (row, head), both warps sharing each
//   32-column chunk of a three-stage ring; the serving shape gives
//   2 x 12 x 8 = 192 blocks. T <= 16 (verify): one 16-row tile per (row,
//   head) and a block of 4 warps, each walking every fourth 16-column
//   chunk with its own double-buffered ring and its own (max, sum, acc);
//   the four partial states merge through shared memory (m* = max m_i,
//   each weighted by exp(m_i - m*), -inf guarded), so the serial walk is
//   ~2 chunks per warp instead of 7, and the tile's dead rows cost only
//   tensor-core slots. The launcher's choices were measured against other
//   warp splits, stage counts and chunk widths on an H100 (PERF.md).
// - Rules kept from the plain version: columns >= S are excluded outright
//   (-inf, their K/V rows zero-filled), never bias-masked columns; a row
//   whose every column is bias-masked averages its columns as the plain
//   softmax does; padding query rows are never stored; -inf - -inf never
//   reaches exp.
// Head dims: the kernel is compiled for D in {16, 32, 64, 128} and takes any
// D up to 128 padded inside its loads (attn_common.cuh); bf16 above 128
// runs the CUDA-core kernel below, chosen by D in the C dispatch before the
// launch, which splits D above 256 into 256-column chunks (any D).
//
// The f32 kernel stays on CUDA cores (scalar FMA from shared memory): it
// serves the f32 parity runs, held to 1e-4, which TF32 mma would not meet.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"
#include "mma_bf16.cuh"

namespace {

using attn::bf16;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// n / d for 0 <= n < 2^31 by a multiply-high (d's magic numbers are made
// once on the host): the table walk divides every key column by bs
struct FastDiv {
  int d;
  unsigned mul, shr;
};

FastDiv make_fast_div(int d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    unsigned l = 0;
    while ((1u << l) < (unsigned)d) ++l;  // ceil(log2 d)
    const unsigned p = 31 + l;
    f.mul = (unsigned)(((1ull << p) + (unsigned)d - 1) / (unsigned)d);
    f.shr = p - 32;
  }
  return f;
}

__device__ __forceinline__ int fast_div(int n, FastDiv f) {
  return f.d == 1 ? n : (int)(__umulhi((unsigned)n, f.mul) >> f.shr);
}

// the barrier of the warps that share one ring: one warp, or the block
template <int NQW>
__device__ __forceinline__ void ring_sync() {
  if constexpr (NQW == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// bytes of one stage of a ring: KC keys of K and of V (bf16, rows padded
// to DT + 8) and the bias tile of the group's 16 NQW query rows (f32, rows
// padded to KC + 8)
template <int DT, int NQW, int KC>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * KC * (DT + 8) * 2 + 16 * NQW * (KC + 8) * 4;
}

// the dynamic shared memory: the groups' rings, then for a split walk each
// group's partial (max, sum) per query row
template <int DT, int NQW, int NSPLIT, int STAGES, int KC>
__host__ __device__ constexpr int smem_bytes() {
  return NSPLIT * STAGES * stage_bytes<DT, NQW, KC>() + (NSPLIT > 1 ? NSPLIT * 16 * NQW * 8 : 0);
}

// NQW warps of 16 query rows each walk the row's keys KC columns at a time
// through a shared ring of STAGES chunks; NSPLIT such groups split the
// row's chunks between them and merge at the end. DT is the padded head
// dim, D the true one; VEC selects the 16-byte copy path (attn_common.cuh).
template <int DT, int NQW, int NSPLIT, int STAGES, int KC, bool VEC>
__global__ void __launch_bounds__(32 * NQW * NSPLIT) paged_prefill_mma_kernel(
    const bf16* __restrict__ q,          // (B, T, H, D)
    const bf16* __restrict__ k_pool,     // (NB, bs, KV, D)
    const bf16* __restrict__ v_pool,     // (NB, bs, KV, D)
    const int32_t* __restrict__ table,   // (B, TB)
    const float* __restrict__ bias,      // (B, HB, T, S)
    bf16* __restrict__ out,              // (B, T, H, D)
    int Tq, int H, int KV, int D, int NB, int bs, FastDiv bs_div, int TB, int HB, int S,
    int bias_vec, float scale) {
  constexpr bool vec = VEC;
  using namespace mma_bf16;
  constexpr int SEG = DT / 8;            // 16-byte copies per key row
  constexpr int PITCH = DT + 8;          // K/V shared row pitch in elements
  constexpr int TILE = KC * PITCH;       // one K or V chunk
  constexpr int BP = KC + 8;             // bias shared row pitch in floats
  constexpr int NT = 32 * NQW;           // threads sharing a ring
  constexpr int SLOTS = KC * SEG;        // 16-byte K (or V) copies per chunk
  constexpr int CPT = (SLOTS + NT - 1) / NT;
  constexpr int QROWS = 16 * NQW;        // query rows of a group (and block)
  constexpr int BV = KC / 4;             // 16-byte copies per bias tile row
  constexpr int KD = DT / 16;            // k-steps of Q K^T
  constexpr int ND = DT / 8;             // n-tiles of P V
  constexpr int NN = KC / 8;             // n-tiles of Q K^T
  constexpr int KS = KC / 16;            // k-steps of P V
  constexpr int STAGE = stage_bytes<DT, NQW, KC>();
  static_assert(KC % 16 == 0 && NT % SEG == 0 && NT % KC == 0, "copy slots must tile a chunk");
  static_assert(NQW == 1 || NSPLIT == 1, "a ring is one warp's or the whole block's");
  static_assert(QROWS * PITCH * 4 <= STAGES * STAGE, "the merge slice must fit a ring");

  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qw = warp % NQW, split = warp / NQW;
  const int gtid = qw * 32 + lane;
  const int g = lane >> 2, tq = lane & 3, mi = lane >> 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int hb = HB == 1 ? 0 : h;
  const int t0 = blockIdx.x * QROWS;
  unsigned char* ring = smem + (size_t)split * STAGES * STAGE;

  // the warp's query tile as A fragments; padding rows are zero
  uint32_t qf[KD][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + qw * 16 + g + 8 * r;
    const bf16* qrow = q + (((size_t)b * Tq + (t < Tq ? t : 0)) * H + h) * D;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      qf[kk][r] = t < Tq ? attn::load_pair(qrow, kk * 16 + 2 * tq, D, vec) : 0u;
      qf[kk][2 + r] = t < Tq ? attn::load_pair(qrow, kk * 16 + 8 + 2 * tq, D, vec) : 0u;
    }
  }

  // this thread's copy slots: K/V rows r0 + k NT / SEG at segment seg
  const int r0 = gtid / SEG, seg = gtid % SEG;
  const size_t kv_off = (size_t)kvh * D;
  const float* bias_rows = bias + (((size_t)b * HB + hb) * Tq) * S;
  const int* trow = table + (size_t)b * TB;

  // table ids (and in-block rows) of this thread's K/V rows of chunk c
  auto load_ids = [&](int c, int (&ids)[CPT], int (&rin)[CPT]) {
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int col = c * KC + r0 + k * (NT / SEG);
      const int j = fast_div(col, bs_div);
      rin[k] = col - j * bs;
      ids[k] = (k * NT + gtid < SLOTS && col < S) ? trow[j] : 0;
    }
  };
  // cp.async of chunk c's K/V rows and bias tile into a stage; columns >= S
  // and padding query rows are zero-filled. The bias goes 16 bytes at a
  // time when its rows allow (S % 4 == 0, aligned base), else 4.
  auto copy_chunk = [&](int c, int stage, const int (&ids)[CPT], const int (&rin)[CPT]) {
    bf16* kt = reinterpret_cast<bf16*>(ring + (size_t)stage * STAGE);
    bf16* vt = kt + TILE;
    float* bt = reinterpret_cast<float*>(vt + TILE);
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      if (SLOTS % NT == 0 || k * NT + gtid < SLOTS) {
        const int r = r0 + k * (NT / SEG);
        const bool valid = c * KC + r < S;
        const int blk = min(max(ids[k], 0), NB - 1);
        const size_t off = (size_t)(blk * bs + (valid ? rin[k] : 0)) * KV * D + kv_off;
        attn::copy_seg(kt + r * PITCH + seg * 8, k_pool + off, seg * 8, D, valid, vec);
        attn::copy_seg(vt + r * PITCH + seg * 8, v_pool + off, seg * 8, D, valid, vec);
      }
    }
    if (bias_vec) {
      const int col = 4 * (gtid % BV);
#pragma unroll
      for (int k = 0; k < QROWS * BV / NT; ++k) {
        const int row = gtid / BV + k * (NT / BV);
        const bool valid = c * KC + col < S && t0 + row < Tq;
        cp_async_16(bt + row * BP + col,
                    valid ? bias_rows + (size_t)(t0 + row) * S + c * KC + col : bias, valid);
      }
    } else {
      const int col = gtid % KC;
#pragma unroll
      for (int k = 0; k < QROWS * KC / NT; ++k) {
        const int row = gtid / KC + k * (NT / KC);
        const bool valid = c * KC + col < S && t0 + row < Tq;
        cp_async_4(bt + row * BP + col,
                   valid ? bias_rows + (size_t)(t0 + row) * S + c * KC + col : bias, valid);
      }
    }
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nd][j] = 0.f;

  const int nc = (S + KC - 1) / KC;
  const int mine = split < nc ? (nc - 1 - split) / NSPLIT + 1 : 0;
  if (mine > 0) {
    // the group's i-th chunk is chunk split + i NSPLIT; chunks 0 ..
    // STAGES-2 are put in flight up front and one more after each landing,
    // with the table ids read one copy ahead (ids past the row read as 0)
    int pre[STAGES][CPT], prin[STAGES][CPT];
#pragma unroll
    for (int j = 0; j < STAGES; ++j) load_ids(split + j * NSPLIT, pre[j], prin[j]);
#pragma unroll
    for (int j = 0; j + 1 < STAGES; ++j) {
      if (j < mine) copy_chunk(split + j * NSPLIT, j, pre[j], prin[j]);
      cp_async_commit();
    }
    int ids[CPT], rin[CPT];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      ids[k] = pre[STAGES - 1][k];
      rin[k] = prin[STAGES - 1][k];
    }
    for (int i = 0; i < mine; ++i) {
      const int c = split + i * NSPLIT;
      cp_async_wait<STAGES - 2>();    // the group's chunks 0 .. i have landed
      ring_sync<NQW>();  // ... for every warp, and chunk i-1 is done
      if (i + STAGES - 1 < mine) {
        copy_chunk(c + (STAGES - 1) * NSPLIT, (i + STAGES - 1) % STAGES, ids, rin);
        if (i + STAGES < mine) load_ids(c + STAGES * NSPLIT, ids, rin);
      }
      cp_async_commit();
      const bf16* kt = reinterpret_cast<const bf16*>(ring + (size_t)(i % STAGES) * STAGE);
      const bf16* vt = kt + TILE;
      const float* bt = reinterpret_cast<const float*>(vt + TILE) + (qw * 16 + g) * BP;

      // scores: 16 query rows x KC key columns in NN n-tiles
      float s[NN][4];
#pragma unroll
      for (int nt = 0; nt < NN; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int kb = 0; kb < KS; ++kb) {
          uint32_t kf[4];  // keys kb*16 + 0-7 | 8-15, dims kk*16 + 0-7 | 8-15
          ldmatrix_x4(kf, kt + (kb * 16 + (mi >> 1) * 8 + (lane & 7)) * PITCH + kk * 16 +
                              (mi & 1) * 8);
          mma_16816(s[2 * kb], qf[kk], kf[0], kf[1]);
          mma_16816(s[2 * kb + 1], qf[kk], kf[2], kf[3]);
        }

      // online softmax over the rows g and g + 8 this lane holds
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NN; ++nt) {
          const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * r * BP + nt * 8 + 2 * tq);
          const int col = c * KC + nt * 8 + 2 * tq;
          float& x0 = s[nt][2 * r];
          float& x1 = s[nt][2 * r + 1];
          x0 = col < S ? x0 * scale + bb.x : -INFINITY;
          x1 = col + 1 < S ? x1 * scale + bb.y : -INFINITY;
          mx = fmaxf(mx, fmaxf(x0, x1));
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mnew = fmaxf(m[r], mx);
        alpha[r] = mnew == -INFINITY ? 1.f : __expf(m[r] - mnew);
#pragma unroll
        for (int nt = 0; nt < NN; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[nt][2 * r + e];
            x = x == -INFINITY ? 0.f : __expf(x - mnew);
          }
        m[r] = mnew;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          acc[nd][2 * r] *= alpha[r];
          acc[nd][2 * r + 1] *= alpha[r];
        }
      }

      // P rounded to bf16 pairs, (row g | g + 8) per n-tile; the running
      // sums add the rounded values, so the weights that multiply V sum to
      // one
      uint32_t pp[NN][2];
#pragma unroll
      for (int nt = 0; nt < NN; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) pp[nt][r] = pack_bf16(s[nt][2 * r], s[nt][2 * r + 1]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < NN; ++nt) {
          const float2 pr = unpack_bf16(pp[nt][r]);
          sum += pr.x + pr.y;
        }
        l[r] = l[r] * alpha[r] + sum;
      }

      // P V: two n-tiles of P are one A fragment per 16 keys
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t pa[4] = {pp[2 * ks][0], pp[2 * ks][1], pp[2 * ks + 1][0],
                                pp[2 * ks + 1][1]};
#pragma unroll
        for (int dp = 0; dp < DT / 16; ++dp) {
          uint32_t vf[4];  // keys ks*16 + 0-7 | 8-15, dims dp*16 + 0-7 | 8-15
          ldmatrix_x4_trans(vf, vt + (ks * 16 + (mi & 1) * 8 + (lane & 7)) * PITCH + dp * 16 +
                                    (mi >> 1) * 8);
          mma_16816(acc[2 * dp], pa, vf[0], vf[1]);
          mma_16816(acc[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  if constexpr (NSPLIT == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + qw * 16 + g + 8 * r;
      if (t >= Tq) continue;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
      bf16* orow = out + (((size_t)b * Tq + t) * H + h) * D;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        attn::store_pair(orow, nd * 8 + 2 * tq, D, vec, acc[nd][2 * r] * inv,
                         acc[nd][2 * r + 1] * inv);
    }
  } else {
    // merge the splits' partial states: each group parks (m, l) and its
    // unnormalised acc over its own drained ring, then every thread sums
    // its output pairs with weights exp(m_j - m*), m* = max_j m_j
    float2* ml = reinterpret_cast<float2*>(smem + (size_t)NSPLIT * STAGES * STAGE);
    cp_async_wait<0>();
    ring_sync<NQW>();  // the group is done reading its ring
    float* slice = reinterpret_cast<float*>(ring);  // [QROWS][PITCH] f32
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qw * 16 + g + 8 * r;
      if (tq == 0) ml[split * QROWS + row] = make_float2(m[r], l[r]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        *reinterpret_cast<float2*>(slice + row * PITCH + nd * 8 + 2 * tq) =
            make_float2(acc[nd][2 * r], acc[nd][2 * r + 1]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < QROWS * DT / 2; e += blockDim.x) {
      const int row = (2 * e) / DT, d = (2 * e) % DT;
      const int t = t0 + row;
      if (t >= Tq) continue;
      float mst = -INFINITY;
#pragma unroll
      for (int j = 0; j < NSPLIT; ++j) mst = fmaxf(mst, ml[j * QROWS + row].x);
      float x = 0.f, y = 0.f, den = 0.f;
#pragma unroll
      for (int j = 0; j < NSPLIT; ++j) {
        const float2 st = ml[j * QROWS + row];
        if (st.x == -INFINITY) continue;  // a split with no chunk
        const float w = __expf(st.x - mst);
        const float2 v = *reinterpret_cast<const float2*>(
            reinterpret_cast<const float*>(smem + (size_t)j * STAGES * STAGE) + row * PITCH + d);
        x += w * v.x;
        y += w * v.y;
        den += w * st.y;
      }
      const float inv = den > 0.f ? 1.f / den : 0.f;
      attn::store_pair(out + (((size_t)b * Tq + t) * H + h) * D, d, D, vec, x * inv, y * inv);
    }
  }
}

template <int DT, int NQW, int NSPLIT, int STAGES, int KC, bool VEC>
int launch_mma(const void* q, const void* k_pool, const void* v_pool,
               const void* table, const void* bias, void* out, int B, int Tq,
               int H, int KV, int D, int NB, int bs, int TB, int HB, int S,
               cudaStream_t stream) {
  constexpr int smem = smem_bytes<DT, NQW, NSPLIT, STAGES, KC>();
  auto kernel = paged_prefill_mma_kernel<DT, NQW, NSPLIT, STAGES, KC, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int bias_vec = S % 4 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  dim3 grid((Tq + 16 * NQW - 1) / (16 * NQW), H, B);
  kernel<<<grid, 32 * NQW * NSPLIT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k_pool, (const bf16*)v_pool, (const int32_t*)table,
      (const float*)bias, (bf16*)out, Tq, H, KV, D, NB, bs, make_fast_div(bs), TB, HB, S,
      bias_vec, 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// the layout by T. A verify-sized span (T <= 16): one 16-row tile, the
// row's 16-column chunks split over 4 warps, double-buffered. A prefill
// span: 2 warps of 16 queries over shared 32-column chunks, three stages
// (two chunks in flight; two stages at DT = 128 bound the ring).
template <int DT, bool VEC>
int launch_layout(const void* q, const void* k_pool, const void* v_pool,
                  const void* table, const void* bias, void* out, int B, int Tq,
                  int H, int KV, int D, int NB, int bs, int TB, int HB, int S,
                  cudaStream_t stream) {
  if (Tq <= 16)
    return launch_mma<DT, 1, 4, 2, 16, VEC>(q, k_pool, v_pool, table, bias, out, B, Tq, H, KV,
                                            D, NB, bs, TB, HB, S, stream);
  constexpr int STAGES = DT >= 128 ? 2 : 3;
  return launch_mma<DT, 2, 1, STAGES, 32, VEC>(q, k_pool, v_pool, table, bias, out, B, Tq, H,
                                               KV, D, NB, bs, TB, HB, S, stream);
}

// the copy path by the shape: 16-byte copies when D % 8 == 0 and the
// operands are 16-byte aligned, element by element otherwise
template <int DT>
int launch_bf16(const void* q, const void* k_pool, const void* v_pool,
                const void* table, const void* bias, void* out, int B, int Tq,
                int H, int KV, int D, int NB, int bs, int TB, int HB, int S, int vec,
                cudaStream_t stream) {
  if (vec)
    return launch_layout<DT, true>(q, k_pool, v_pool, table, bias, out, B, Tq, H, KV, D, NB,
                                   bs, TB, HB, S, stream);
  return launch_layout<DT, false>(q, k_pool, v_pool, table, bias, out, B, Tq, H, KV, D, NB,
                                  bs, TB, HB, S, stream);
}

// ---------------------------------------------------------------------------
// CUDA cores: f32, and bf16 at D > 128
// ---------------------------------------------------------------------------

constexpr int QT = 16;  // query rows per thread block
constexpr int DCH = 256;  // head-dim chunk of the SPLIT kernel (D > 256)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* y) { *y = x; }
__device__ __forceinline__ void from_f(float x, bf16* y) { *y = __float2bfloat16(x); }

// one thread block per (q tile of QT rows, head, row): the row's blocks
// are walked one pool block at a time, each block's bs x D K and V tiles
// landed in shared memory once per tile of QT queries, with an online
// softmax (running max and sum in f32) and the output accumulator in
// shared memory.
// SPLIT (D > 256, any D): grid x also counts ceil(D / DCH) output chunks.
// For each pool block the scores stream over the head dim: the q and K
// chunks of DCH columns land in the shared tiles in turn and each score's
// partial dot carries across them in shared memory (the same order of
// additions as one pass over D); the block's V chunk lands with the first,
// and the block accumulates its own DCH output columns. No tile grows past
// DCH columns; each output chunk recomputes the scores.
template <typename T, bool SPLIT>
__global__ void paged_prefill_cc_kernel(
    const T* __restrict__ q,            // (B, T, H, D)
    const T* __restrict__ k_pool,       // (NB, bs, KV, D)
    const T* __restrict__ v_pool,       // (NB, bs, KV, D)
    const int32_t* __restrict__ table,  // (B, TB)
    const float* __restrict__ bias,     // (B, HB, T, S)
    T* __restrict__ out,                // (B, T, H, D)
    int Tq, int H, int KV, int D, int NB, int bs, int TB, int HB, int S,
    float scale) {
  const int nch = SPLIT ? (D + DCH - 1) / DCH : 1;  // head-dim chunks
  const int oc = SPLIT ? blockIdx.x % nch : 0;      // this block's output chunk
  const int DC = SPLIT ? DCH : D;                   // columns a shared tile holds
  const int d0 = oc * DC, od = SPLIT ? min(DC, D - d0) : D;
  const int t0 = (SPLIT ? blockIdx.x / nch : blockIdx.x) * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int hb = HB == 1 ? 0 : h;
  const int nq = min(QT, Tq - t0);
  const int tid = threadIdx.x;
  const int nth = blockDim.x;

  extern __shared__ float fsmem[];
  float* q_s = fsmem;             // QT * DC
  float* k_s = q_s + QT * DC;     // bs * DC
  float* v_s = k_s + bs * DC;     // bs * DC
  float* sc = v_s + bs * DC;      // QT * bs
  float* acc = sc + QT * bs;      // QT * DC
  float* m_s = acc + QT * DC;     // QT
  float* l_s = m_s + QT;          // QT
  float* a_s = l_s + QT;          // QT

  for (int i = tid; i < QT * DC; i += nth) {
    if (!SPLIT) {
      const int r = i / D, d = i % D;
      q_s[i] = r < nq ? to_f(q[(((size_t)b * Tq + t0 + r) * H + h) * D + d]) : 0.f;
    }
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
    if (!SPLIT) {
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
    } else {
      for (int cc = 0; cc < nch; ++cc) {
        const int c0 = cc * DC, w = min(DC, D - c0);
        for (int i = tid; i < QT * DC; i += nth) {
          const int r = i / DC, d = i % DC;
          q_s[i] = r < nq && d < w ? to_f(q[(((size_t)b * Tq + t0 + r) * H + h) * D + c0 + d])
                                   : 0.f;
        }
        for (int i = tid; i < bs * DC; i += nth) {
          const int r = i / DC, d = i % DC;
          const size_t off = (((size_t)blk * bs + r) * KV + kvh) * D;
          k_s[i] = d < w ? to_f(k_pool[off + c0 + d]) : 0.f;
          if (cc == 0) v_s[i] = d < od ? to_f(v_pool[off + d0 + d]) : 0.f;
        }
        __syncthreads();
        for (int i = tid; i < QT * bs; i += nth) {
          const int r = i / bs, c = i % bs;
          float dot = cc == 0 ? 0.f : sc[i];
          for (int d = 0; d < w; ++d) dot += q_s[r * DC + d] * k_s[c * DC + d];
          sc[i] = dot;
        }
        __syncthreads();
      }
      for (int i = tid; i < QT * bs; i += nth) {
        const int r = i / bs, c = i % bs;
        const int col = col0 + c;
        sc[i] = r < nq && col < S
                    ? sc[i] * scale + bias[(((size_t)b * HB + hb) * Tq + t0 + r) * S + col]
                    : -INFINITY;
      }
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
    for (int i = tid; i < QT * DC; i += nth) {
      const int r = i / DC, d = i % DC;
      float a = acc[i] * a_s[r];
      for (int c = 0; c < bs; ++c) a += sc[r * bs + c] * v_s[c * DC + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < nq * DC; i += nth) {
    const int r = i / DC, d = i % DC;
    if (d >= od) continue;
    const float l = l_s[r];
    from_f(l > 0.f ? acc[i] / l : 0.f, &out[(((size_t)b * Tq + t0 + r) * H + h) * D + d0 + d]);
  }
}

template <typename T, bool SPLIT>
int launch_cc_split(const void* q, const void* k_pool, const void* v_pool,
                    const void* table, const void* bias, void* out, int B, int Tq,
                    int H, int KV, int D, int NB, int bs, int TB, int HB, int S,
                    cudaStream_t stream) {
  const int DC = SPLIT ? DCH : D, nch = SPLIT ? (D + DCH - 1) / DCH : 1;
  const size_t smem = sizeof(float) *
      ((size_t)QT * DC * 2 + (size_t)bs * DC * 2 + (size_t)QT * bs + 3 * QT);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_cc_kernel<T, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Tq + QT - 1) / QT * nch, H, B);
  paged_prefill_cc_kernel<T, SPLIT><<<grid, 128, smem, stream>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, (const int32_t*)table,
      (const float*)bias, (T*)out, Tq, H, KV, D, NB, bs, TB, HB, S, 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cc(const void* q, const void* k_pool, const void* v_pool,
              const void* table, const void* bias, void* out, int B, int Tq,
              int H, int KV, int D, int NB, int bs, int TB, int HB, int S,
              cudaStream_t stream) {
  if (D > DCH)
    return launch_cc_split<T, true>(q, k_pool, v_pool, table, bias, out, B, Tq, H, KV, D, NB,
                                    bs, TB, HB, S, stream);
  return launch_cc_split<T, false>(q, k_pool, v_pool, table, bias, out, B, Tq, H, KV, D, NB,
                                   bs, TB, HB, S, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it). bf16 at
// D <= 128 runs on tensor cores (D padded to 16, 32, 64 or 128 inside the
// loads), f32 and bf16 at D > 128 on CUDA cores, any D (above 256 split
// over the head dim).
extern "C" int paged_prefill(const void* q, const void* k_pool,
                             const void* v_pool, const void* table,
                             const void* bias, void* out, int B, int Tq, int H,
                             int KV, int D, int NB, int bs, int TB, int HB,
                             int S, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_cc<float>(q, k_pool, v_pool, table, bias, out, B, Tq, H, KV, D, NB, bs,
                            TB, HB, S, st);
  if (D > 128)
    return launch_cc<bf16>(q, k_pool, v_pool, table, bias, out, B, Tq, H, KV, D, NB, bs, TB,
                           HB, S, st);
  const int vec = D % 8 == 0 && attn::aligned16(q) && attn::aligned16(k_pool) &&
                  attn::aligned16(v_pool) && attn::aligned16(out);
  switch (attn::padded_dim(D)) {
    case 16:
      return launch_bf16<16>(q, k_pool, v_pool, table, bias, out, B, Tq, H, KV, D, NB, bs, TB,
                             HB, S, vec, st);
    case 32:
      return launch_bf16<32>(q, k_pool, v_pool, table, bias, out, B, Tq, H, KV, D, NB, bs, TB,
                             HB, S, vec, st);
    case 64:
      return launch_bf16<64>(q, k_pool, v_pool, table, bias, out, B, Tq, H, KV, D, NB, bs, TB,
                             HB, S, vec, st);
    default:
      return launch_bf16<128>(q, k_pool, v_pool, table, bias, out, B, Tq, H, KV, D, NB, bs,
                              TB, HB, S, vec, st);
  }
}
