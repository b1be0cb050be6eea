// Fused sampling: temperature / top-k / top-p filter, the Gumbel-argmax
// draw (plain argmax when greedy) and the behaviour log-probability, one
// thread-block cluster per row.
//
// Replaces: trlx_tpu/ops/paged_attention.py::fused_sample
//   (_fused_sample_kernel, the pl.pallas_call at paged_attention.py:373).
//
// Semantics (trlx_tpu/ops/sampling.py::process_logits):
//   x = logits / max(temperature, 1e-6)             (when temperature != 1)
//   top-k: keep x >= the k-th largest value (ties at the threshold kept)
//   top-p: over the top-k-filtered row, sort descending, keep the prefix
//          whose EXCLUSIVE cumulative probability is < p; the threshold is
//          the smallest kept value and everything >= it stays (ties kept)
//   token = first index of argmax(gumbel + filtered)  (argmax(filtered) greedy)
//   logprob = log_softmax(raw logits)[token]
// No sort. Both thresholds are keys of the order-preserving integer image
// of the float (fkey): the top-k key is the largest c with count(key >= c)
// >= k; the top-p key is the smallest present c whose strictly-greater mass
// G(c) = sum over key > c of exp(x - max) is < p Z (Z the survivors' mass),
// i.e. the value at which the descending cumulative mass first reaches
// p Z. Masses are exp(x - max) as f32 turned into 2^-31 fixed point and
// summed as integers, so every sum is exact and independent of order; the
// JAX path sums f32 probabilities by jnp.cumsum, so a row whose mass lands
// within that f32 rounding of p may keep one token more or fewer there
// (ROADMAP Queue 3); elsewhere the kept set is identical. The row's max
// value always survives both filters, so a greedy row is the first-index
// argmax of x, and a row without filters the argmax of noise + x: both are
// folded into the one read of the row.
//
// What bounds it on an H100: bytes and latency. A row of V = 50257 f32
// logits and its noise is ~400 KB; at B = 8 the byte bound is ~1 us. The
// first version gave each row one 1024-thread block (8 blocks on 132 SMs)
// that re-read the row from shared memory ~70 times (32 bisection passes
// per threshold, each top-p pass with an expf per element): 174 us. On this
// card a launch costs ~2 us and a cluster barrier ~0.7 us, so the design
// counts barriers.
//
// Design: a cluster of CLUSTER (8) blocks per row (cudaLaunchKernelEx with a
// cluster dimension), block r owning the r-th contiguous slice of V, so B =
// 8 is 64 blocks and B = 32 is 256. Each block reads its slice of logits
// (and noise) once, 16 bytes a load and VBATCH loads in flight per thread,
// keeping x and the noise in shared memory (50 KB at V = 50257) and
// folding into that read x's
// max and min, the raw row's online (max, sum), and the first-index argmax
// of x (greedy) or noise + x. Cluster merges go through distributed shared
// memory: each block publishes its partial in its own shared memory, one
// cluster barrier, then lanes read the CLUSTER partials together and merge
// them in a fixed order (no float atomics: the same inputs give the same
// bits). Then, by the row's settings:
// - greedy, or sampled without filters: one barrier, done.
// - with a filter, a second barrier publishes per-block histograms over NB
//   buckets of (max - x): with top-k counts over the row's finite range,
//   top-p alone fixed-point masses over the 22.2 nats within which a mass
//   is not 0. Every block sums them and finds the bucket in which the
//   cumulative count reaches k (or the mass p Z). Each block lists its
//   elements of the buckets up to that one, from the bucket ids the counting
//   pass left in shared memory (top-k: the survivors and that
//   bucket's others) or of that bucket alone (top-p: the buckets above it
//   are kept whatever the key, and their part of the draw is taken in the
//   same pass); lists are written in one pass without atomics (by ballot
//   into per-warp slots, then packed). After a third barrier block 0 gathers the lists and
//   decides each entry by rank, from how many keys and how much mass lie
//   above it (fewer than k; less mass than p Z), so no threshold is ever
//   searched for. Then the draw over the kept entries (noise read at their
//   indices).
// - When a list would exceed CAP, or all of them THREADS (ties, a flat
//   row), the thresholds are
//   found over the whole row by cluster-wide radix select instead: four
//   rounds of 256-bin histograms (counts, or masses as two 16-bit halves),
//   one barrier each; lanes with equal digits are grouped by
//   __match_any_sync and summed by __reduce_add_sync, so one 32-bit shared
//   atomic per half and group lands; the draw then runs over the row.
// Block reductions use REDUX on the order-preserving keys of the values.
// Every path is chosen from data the whole cluster sees, the same in every
// block. A slice wider than SMEM_SLICE elements is re-read from global
// memory on every pass instead (past ~159k vocabulary entries); the wrapper
// rejects a row wider than CLUSTER x MAX_SLICE (~524k).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_SLICE = 19968;  // elements of x (noise, bucket ids) kept in shared memory
constexpr int VBATCH = 4;          // 16-byte global loads a thread keeps in flight
constexpr int NB = 512;            // value buckets of the row
constexpr int CAP = 256;           // a block's candidate list
constexpr int WCAP = CAP / WARPS;  // a warp's share of it
constexpr int UCAP = THREADS;      // the gathered union: one entry a thread
constexpr unsigned FULL = 0xffffffffu;
constexpr float MASS_ONE = 2147483648.f;  // 2^31: a mass of 1 in fixed point
constexpr float MASS_RANGE = 22.18f;      // ln(2^32): a mass further below the max rounds to 0
// a slice's masses are summed as two u32 halves of 16 bits (32-bit
// shared-memory atomics): a slice of MAX_SLICE elements cannot overflow
// either half
constexpr int MAX_SLICE = 65535;

typedef unsigned long long u64;

__device__ __forceinline__ uint32_t fkey(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the float whose fkey is k
__device__ __forceinline__ float unkey(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// fixed-point mass of x against the row max (<= 2^31)
__device__ __forceinline__ unsigned mass_of(float x, float xmax) {
  return __float2uint_rn(__expf(x - xmax) * MASS_ONE);
}

// (value, index) argmax; index -1 = none yet; ties go to the smaller index
__device__ __forceinline__ void am_merge(float& v, int& i, float v2, int i2) {
  if (i2 < 0) return;
  if (i < 0 || v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// online (max, sum of exp(x - max)) merge; a -inf max carries no mass
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    s = s2;
    return;
  }
  const float mx = fmaxf(m, m2);
  s = s * __expf(m - mx) + s2 * __expf(m2 - mx);
  m = mx;
}

// a block's partials, read by the other blocks of the cluster
struct Partial {
  float xmax;  // max of x
  float xmin;  // min of the finite x
  float rmax;  // raw row: max
  float rsum;  //          sum of exp(raw - rmax)
  float bv;    // argmax: value (x, or noise + x)
  int bi;      //         its first index
};

__device__ __forceinline__ void merge(Partial& a, const Partial& b) {
  a.xmax = fmaxf(a.xmax, b.xmax);
  a.xmin = fminf(a.xmin, b.xmin);
  lse_merge(a.rmax, a.rsum, b.rmax, b.rsum);
  am_merge(a.bv, a.bi, b.bv, b.bi);
}

__device__ __forceinline__ Partial shfl_xor(const Partial& p, int o) {
  Partial q;
  q.xmax = __shfl_xor_sync(FULL, p.xmax, o);
  q.xmin = __shfl_xor_sync(FULL, p.xmin, o);
  q.rmax = __shfl_xor_sync(FULL, p.rmax, o);
  q.rsum = __shfl_xor_sync(FULL, p.rsum, o);
  q.bv = __shfl_xor_sync(FULL, p.bv, o);
  q.bi = __shfl_xor_sync(FULL, p.bi, o);
  return q;
}

// merge of the first LANES lanes' partials by a fixed butterfly (each of
// them ends with the same value)
template <int LANES>
__device__ __forceinline__ void warp_merge(Partial& p) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) merge(p, shfl_xor(p, o));
}

__device__ __forceinline__ Partial neutral() {
  return Partial{-INFINITY, INFINITY, -INFINITY, 0.f, -INFINITY, -1};
}

// the warp's first-index argmax of (v, i) by REDUX on the order-preserving
// key of v, then on the index among the lanes holding that key; every lane
// gets it (index -1: none)
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  const uint32_t kv = __reduce_max_sync(FULL, i < 0 ? 0u : fkey(v));
  const unsigned ki = __reduce_min_sync(FULL, i >= 0 && fkey(v) == kv ? (unsigned)i : 0xffffffffu);
  v = unkey(kv);
  i = ki == 0xffffffffu ? -1 : (int)ki;
}

// the block's phase-1 partial: maxima and minima by REDUX on the
// order-preserving keys, the raw sum rescaled to the block's raw max and
// summed in a fixed order; *out written by thread 0 (the caller
// synchronises before reading it)
__device__ __forceinline__ void block_stats(Partial p, Partial* red, Partial* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Partial w;
  w.xmax = unkey(__reduce_max_sync(FULL, fkey(p.xmax)));
  w.xmin = unkey(__reduce_min_sync(FULL, fkey(p.xmin)));
  w.rmax = unkey(__reduce_max_sync(FULL, fkey(p.rmax)));
  w.bv = p.bv;
  w.bi = p.bi;
  warp_argmax(w.bv, w.bi);
  if (lane == 0) red[warp] = w;
  __syncthreads();
  float rmax = red[0].rmax;
  for (int q = 1; q < WARPS; ++q) rmax = fmaxf(rmax, red[q].rmax);
  float s = p.rmax == -INFINITY ? 0.f : p.rsum * __expf(p.rmax - rmax);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  __syncthreads();  // red read by every thread
  if (lane == 0) red[warp].rsum = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    Partial q = neutral();
    q.rmax = rmax;
    q.rsum = 0.f;
    for (int k = 0; k < WARPS; ++k) {
      q.xmax = fmaxf(q.xmax, red[k].xmax);
      q.xmin = fminf(q.xmin, red[k].xmin);
      q.rsum += red[k].rsum;
      am_merge(q.bv, q.bi, red[k].bv, red[k].bi);
    }
    if (rmax == -INFINITY) q.rsum = 0.f;
    *out = q;
  }
}

// the block's argmax (bv, bi) alone, as block_merge
__device__ __forceinline__ void block_argmax(float v, int i, Partial* red, Partial* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  warp_argmax(v, i);
  if (lane == 0) {
    red[warp].bv = v;
    red[warp].bi = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? red[lane].bv : -INFINITY;
    i = lane < WARPS ? red[lane].bi : -1;
    warp_argmax(v, i);
    if (lane == 0) {
      *out = neutral();
      out->bv = v;
      out->bi = i;
    }
  }
}

// the cluster's partial: lanes 0 .. CLUSTER-1 of warp 0 read the blocks'
// published partials together, merged by the fixed butterfly; *out is
// written by thread 0 (the caller synchronises before reading it)
__device__ __forceinline__ void cluster_merge(cg::cluster_group& cluster, Partial* pub, Partial* out) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    Partial q = lane < CLUSTER ? *cluster.map_shared_rank(pub, lane) : neutral();
    warp_merge<CLUSTER>(q);
    if (lane == 0) *out = q;
  }
}

// One warp: the first bin (ascending index) of tot[0 .. N) whose inclusive
// cumulative sum reaches `need`, and `need` less the sum before that bin
// (lane j holds bins j N / 32 ..); idx -1 when none does.
template <int N, typename U>
__device__ __forceinline__ void scan_select(const U* tot, U& need, int& idx) {
  constexpr int PER = N / 32;
  const int lane = threadIdx.x & 31;
  U bins[PER];
  U own = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    bins[k] = tot[lane * PER + k];
    own += bins[k];
  }
  U incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const U y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  U run = incl - own;
  int found = -1;
  U before = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    if (found < 0 && run + bins[k] >= need) {
      found = lane * PER + k;
      before = run;
    }
    run += bins[k];
  }
  const unsigned hit = __ballot_sync(FULL, found >= 0);
  if (hit == 0) {
    idx = -1;
    return;
  }
  const int src = __ffs(hit) - 1;
  idx = __shfl_sync(FULL, found, src);
  need -= __shfl_sync(FULL, before, src);
}

// one warp: the sum of tot[0 .. N)
template <int N>
__device__ __forceinline__ u64 warp_total(const u64* tot) {
  const int lane = threadIdx.x & 31;
  u64 z = 0;
  for (int d = lane; d < N; d += 32) z += tot[d];
  for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(FULL, z, o);
  return z;
}

// shared scratch of the selects
struct Scratch {
  unsigned hh[4][256], hl[4][256];  // radix rounds: the weights' high and low 16 bits
  unsigned bh[NB], bl[NB];          // value buckets: the same (counts in bl)
  u64 tot[NB];                      // a histogram's merged bins
  u64 need;                         // broadcasts from warp 0
  uint32_t key;
  int idx;
  int counts[CLUSTER + 1];          // the blocks' list offsets
  int wcount[WARPS];                // the warps' list counts
};

// warp 0 picks round r's digit from sc.tot (256 bins, digit d at bin 255 -
// d); with p_total > 0, need is first p times the bins' total
__device__ __forceinline__ void pick_digit(Scratch& sc, uint32_t prefix, int shift, u64 need, float p_total) {
  if (threadIdx.x < 32) {
    u64 want = need;
    if (p_total > 0.f) want = (u64)ceil((double)p_total * (double)warp_total<256>(sc.tot));
    int idx;
    scan_select<256, u64>(sc.tot, want, idx);
    if (threadIdx.x == 0) {
      sc.key = prefix | ((uint32_t)(255 - max(idx, 0)) << shift);
      sc.need = want;
    }
  }
}

// For a gathered list of m <= THREADS keys, thread i's entry: how many keys
// lie above its own and their summed weight w_of (fixed-point masses). An
// entry is kept by a count threshold k iff fewer than k keys lie above it,
// and by a mass threshold iff the mass above it is < need: the threshold
// itself is never needed. Sums are integers, so the order does not matter.
// The lists are padded to a multiple of 4 with key 0 and mass 0 (never
// above a present key) and read 16 bytes at a time, branch-free.
__device__ __forceinline__ void rank_of(const uint32_t* key, const unsigned* mass, int m,
                                        int& above, u64& mass_above) {
  above = 0;
  mass_above = 0;
  const int i = threadIdx.x;
  const uint32_t k = i < m ? key[i] : 0xffffffffu;
  const uint4* k4 = reinterpret_cast<const uint4*>(key);
  const uint4* w4 = reinterpret_cast<const uint4*>(mass);
  const int m4 = (m + 3) / 4;
#pragma unroll 4
  for (int j = 0; j < m4; ++j) {
    const uint4 kk = k4[j], ww = w4[j];
    above += (kk.x > k) + (kk.y > k) + (kk.z > k) + (kk.w > k);
    mass_above += (u64)((kk.x > k) ? ww.x : 0u) + ((kk.y > k) ? ww.y : 0u) +
                  (u64)((kk.z > k) ? ww.z : 0u) + ((kk.w > k) ? ww.w : 0u);
  }
}

// the block's sum of v (< 2^37 a thread) as 16-bit halves; every thread
// gets it
__device__ __forceinline__ u64 block_sum(u64 v, Scratch& sc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const u64 hi = __reduce_add_sync(FULL, (unsigned)(v >> 16));
  const u64 lo = __reduce_add_sync(FULL, (unsigned)(v & 0xffffu));
  if (lane == 0) sc.tot[256 + warp] = (hi << 16) + lo;
  __syncthreads();
  u64 t = 0;
  for (int q = 0; q < WARPS; ++q) t += sc.tot[256 + q];
  __syncthreads();
  return t;
}

// Cluster-wide radix select over the block's slice (the path when a list
// overflows): the key at which the descending cumulative weight of the
// candidates (cand(x, key)) first reaches need: counts, or with MASS the
// fixed-point masses; with p_total > 0, need is p times the candidates'
// total mass (Z). One cluster barrier per round.
template <bool MASS, typename XF, typename CandF>
__device__ __forceinline__ uint32_t cluster_select(cg::cluster_group& cluster, int n, u64 need, float p_total,
                                   float xmax, XF xval, CandF cand, Scratch& sc) {
  const int tid = threadIdx.x, lane = tid & 31;
  uint32_t prefix = 0;
  for (int r = 0; r < 4; ++r) {
    const int shift = 24 - 8 * r;
    // round r's buffers were last read remotely before the barrier that
    // ended round r + 1 of an earlier select, which every block has passed
    for (int i = tid; i < 256; i += THREADS) sc.hh[r][i] = sc.hl[r][i] = 0u;
    __syncthreads();
    for (int base = 0; base < n; base += THREADS) {
      const int i = base + tid;
      const float x = i < n ? xval(i) : -INFINITY;
      const uint32_t key = fkey(x);
      const bool c = i < n && cand(x, key) &&
                     (r == 0 || (key >> (shift + 8)) == (prefix >> (shift + 8)));
      if (!__any_sync(FULL, c)) continue;
      const int d = c ? 255 - (int)((key >> shift) & 255u) : 256;
      const unsigned peers = __match_any_sync(FULL, d);
      if (MASS) {
        const unsigned w = c ? mass_of(x, xmax) : 0u;
        const unsigned hi = __reduce_add_sync(peers, w >> 16);
        const unsigned lo = __reduce_add_sync(peers, w & 0xffffu);
        if (c && lane == __ffs(peers) - 1) {
          atomicAdd(&sc.hh[r][d], hi);
          atomicAdd(&sc.hl[r][d], lo);
        }
      } else if (c && lane == __ffs(peers) - 1) {
        atomicAdd(&sc.hl[r][d], (unsigned)__popc(peers));
      }
    }
    cluster.sync();
    if (tid < 256) {
      unsigned vh[CLUSTER], vl[CLUSTER];
#pragma unroll
      for (int q = 0; q < CLUSTER; ++q) {
        vh[q] = cluster.map_shared_rank(&sc.hh[r][0], q)[tid];
        vl[q] = cluster.map_shared_rank(&sc.hl[r][0], q)[tid];
      }
      u64 t = 0;
#pragma unroll
      for (int q = 0; q < CLUSTER; ++q) t += ((u64)vh[q] << 16) + vl[q];
      sc.tot[tid] = t;
    }
    __syncthreads();
    pick_digit(sc, prefix, shift, need, r == 0 ? p_total : 0.f);
    __syncthreads();
    prefix = sc.key;
    need = sc.need;
    __syncthreads();
  }
  return prefix;
}

// the union of the blocks' lists gathered into ukey / uidx / umass (the
// key of x, the index, the fixed-point mass against xmax); returns its size
__device__ __forceinline__ int gather_union(cg::cluster_group& cluster, float* lx, int* lidx, uint32_t* ukey,
                            int* uidx, unsigned* umass, float xmax, const Scratch& sc) {
  const int m = sc.counts[CLUSTER];
  for (int i = threadIdx.x; i < m; i += THREADS) {
    int r = 0;
    while (i >= sc.counts[r + 1]) ++r;
    const float x = cluster.map_shared_rank(lx, r)[i - sc.counts[r]];
    ukey[i] = fkey(x);
    uidx[i] = cluster.map_shared_rank(lidx, r)[i - sc.counts[r]];
    umass[i] = mass_of(x, xmax);
  }
  for (int i = m + threadIdx.x; i < ((m + 3) & ~3); i += THREADS) {
    ukey[i] = 0u;
    umass[i] = 0u;
  }
  __syncthreads();
  return m;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(THREADS, 2) fused_sample_kernel(
    const float* __restrict__ logits,  // (B, V) raw (adjusted, eos-blocked)
    const float* __restrict__ gumbel,  // (B, V) noise, or null when greedy
    int32_t* __restrict__ tok,         // (B,)
    float* __restrict__ lp,            // (B,)
    int V, int scale_temp, float tdiv, int top_k, float top_p) {
  extern __shared__ float dyn[];  // this block's slice of x, then of the noise (when they fit)
  __shared__ Scratch sc;
  __shared__ Partial red[WARPS], pub, row_s, blk_s, pub2, best_s;
  __shared__ float lx[CAP], wx[CAP];  // this block's candidate list (x, index), per warp first
  __shared__ int lidx[CAP], widx[CAP];
  __shared__ int lcount;
  __shared__ __align__(16) uint32_t ukey[UCAP];  // the gathered union of the lists: key, index, mass
  __shared__ int uidx[UCAP];
  __shared__ __align__(16) unsigned umass[UCAP];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per = (V + CLUSTER - 1) / CLUSTER;
  const int lo = min(V, rank * per);
  const int n = min(V, lo + per) - lo;
  const bool in_smem = per <= SMEM_SLICE;
  const bool sampled = gumbel != nullptr;
  const float* src = logits + (size_t)b * V + lo;
  const float* gsrc = sampled ? gumbel + (size_t)b * V + lo : nullptr;
  float* xs = dyn;
  float* gs = dyn + per;
  // each element's bucket (the filters' passes), after the noise
  uint16_t* bid = reinterpret_cast<uint16_t*>(dyn + 2 * per);
  const bool vec_rows = reinterpret_cast<uintptr_t>(logits) % 16 == 0 &&
                        (!sampled || reinterpret_cast<uintptr_t>(gumbel) % 16 == 0);
  const bool do_k = top_k > 0 && top_k < V;
  const bool do_p = top_p < 1.f;
  const bool none_kept = do_p && !(top_p > 0.f);  // exclusive mass < p never holds
  const bool filtered = sampled && !none_kept && (do_k || do_p);

  auto xval = [=](int i) -> float {
    if (in_smem) return xs[i];
    const float l = src[i];
    return scale_temp ? l / tdiv : l;
  };
  auto gval = [=](int i) -> float { return in_smem ? gs[i] : gsrc[i]; };

  if (tid == 0) lcount = 0;
  for (int i = tid; i < 4 * 256; i += THREADS) (&sc.hh[0][0])[i] = (&sc.hl[0][0])[i] = 0u;

  // 1. one read: x (and the noise) into shared memory; x's max and finite
  //    min, the raw row's online (max, sum), argmax of x or of noise + x
  Partial p = neutral();
  auto take_in = [&](int i, float l, float gn) {
    const float x = scale_temp ? l / tdiv : l;
    if (in_smem) {
      xs[i] = x;
      if (sampled) gs[i] = gn;
    }
    p.xmax = fmaxf(p.xmax, x);
    if (x != -INFINITY) p.xmin = fminf(p.xmin, x);
    am_merge(p.bv, p.bi, sampled ? gn + x : x, lo + i);
  };
  // the slice in 16-byte loads from its first 16-byte-aligned element (both
  // rows share their alignment when the tensors start 16-byte aligned), the
  // few elements before and after it one by one; VBATCH vectors in flight
  const int head = vec_rows ? min(n, (int)((4u - (unsigned)(((size_t)b * V + lo) & 3u)) & 3u)) : n;
  const int nv = (n - head) / 4;
  auto one = [&](int i) {
    const float l = src[i];
    take_in(i, l, sampled ? gsrc[i] : 0.f);
    lse_merge(p.rmax, p.rsum, l, 1.f);
  };
  for (int i = tid; i < head; i += THREADS) one(i);
  for (int i = head + 4 * nv + tid; i < n; i += THREADS) one(i);
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  const float4* g4 = reinterpret_cast<const float4*>(sampled ? gsrc + head : src + head);
  for (int base = tid; base < nv; base += THREADS * VBATCH) {
    float4 l[VBATCH], gn[VBATCH];
#pragma unroll
    for (int j = 0; j < VBATCH; ++j) {
      const int q = base + j * THREADS;
      l[j] = q < nv ? s4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
      gn[j] = sampled && q < nv ? g4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < VBATCH; ++j) {
      const int q = base + j * THREADS;
      if (q >= nv) break;
      const int i = head + 4 * q;
      take_in(i, l[j].x, gn[j].x);
      take_in(i + 1, l[j].y, gn[j].y);
      take_in(i + 2, l[j].z, gn[j].z);
      take_in(i + 3, l[j].w, gn[j].w);
      const float bm = fmaxf(fmaxf(l[j].x, l[j].y), fmaxf(l[j].z, l[j].w));
      if (bm != -INFINITY)
        lse_merge(p.rmax, p.rsum, bm,
                  __expf(l[j].x - bm) + __expf(l[j].y - bm) + __expf(l[j].z - bm) +
                      __expf(l[j].w - bm));
    }
  }
  block_stats(p, red, &blk_s);
  __syncthreads();

  if (tid == 0) pub = blk_s;
  cluster.sync();  // S1
  cluster_merge(cluster, &pub, &row_s);
  __syncthreads();
  const Partial row = row_s;

  int choice = 0;
  uint32_t thr = 0;  // the kept keys: key >= thr (distributed draw)
  bool draw = false;
  if (none_kept) {
    choice = 0;  // every value filtered: argmax of -inf is the first index
    cluster_arrive();
  } else if (!filtered) {
    choice = row.bi < 0 ? 0 : row.bi;  // greedy, or noise + x with no filter
    cluster_arrive();
  } else {
    // 2. NB buckets of (max - x): with top-k over the row's finite range,
    //    counted; top-p alone over the MASS_RANGE nats below the max, summed
    //    as fixed-point masses. The bucket in which the cumulative count
    //    reaches k (or the mass p Z) holds the threshold.
    const float xmax = row.xmax;
    const float span = do_k ? xmax - row.xmin : fminf(MASS_RANGE, xmax - row.xmin);
    const float cb = span > 0.f ? (float)NB / span : 0.f;
    auto bucket = [=](float x) -> int {
      return x == -INFINITY ? NB - 1 : (int)fminf((xmax - x) * cb, (float)(NB - 1));
    };
    for (int i = tid; i < NB; i += THREADS) sc.bh[i] = sc.bl[i] = 0u;
    __syncthreads();
    for (int i = tid; i < n; i += THREADS) {
      const float x = xval(i);
      const int d = bucket(x);
      if (in_smem) bid[i] = (uint16_t)d;
      if (do_k) {
        // the last bucket (-inf, masked entries) is not counted: when the
        // others fall short of k, the threshold is in it
        if (d < NB - 1) atomicAdd(&sc.bl[d], 1u);
      } else {
        const unsigned w = mass_of(x, xmax);
        if (w != 0u) {
          atomicAdd(&sc.bh[d], w >> 16);
          atomicAdd(&sc.bl[d], w & 0xffffu);
        }
      }
    }
    cluster.sync();  // S2
    {
      // thread d: bucket d's total over the cluster; one block scan finds
      // the bucket in which the cumulative count (mass) reaches k (p Z)
      static_assert(NB == THREADS, "one bucket a thread");
      unsigned vh[CLUSTER], vl[CLUSTER];
#pragma unroll
      for (int q = 0; q < CLUSTER; ++q) {
        vh[q] = cluster.map_shared_rank(sc.bh, q)[tid];
        vl[q] = cluster.map_shared_rank(sc.bl, q)[tid];
      }
      u64 t = 0;
#pragma unroll
      for (int q = 0; q < CLUSTER; ++q) t += ((u64)vh[q] << 16) + vl[q];
      u64 incl = t;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const u64 y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) sc.tot[warp] = incl;
      __syncthreads();
      u64 before = 0, total = 0;
      for (int q = 0; q < WARPS; ++q) {
        before += q < warp ? sc.tot[q] : 0;
        total += sc.tot[q];
      }
      const u64 want = do_k ? (u64)top_k : (u64)ceil((double)top_p * (double)total);
      const u64 excl = before + incl - t;
      if ((excl < want && excl + t >= want) || (tid == NB - 1 && excl + t < want)) {
        sc.idx = tid;
        sc.need = want - excl;  // top-p: the mass still needed inside the bucket
      }
      __syncthreads();
    }
    const int bstar = sc.idx;
    const u64 need = sc.need;

    // 3. the list, in one pass: with top-k every element of the buckets up
    //    to the threshold's (the survivors, and that bucket's others); top-p
    //    alone, the threshold bucket's elements, the buckets above it being
    //    kept whatever the key (their part of the draw is taken here). Each
    //    warp writes its takers into its own WCAP slots by ballot; the slots
    //    are packed after one barrier.
    {
      int mine = 0;
      float dv = -INFINITY;
      int di = -1;
      for (int base = 0; base < n; base += THREADS) {
        const int i = base + tid;
        const int bk = i >= n ? NB : (in_smem ? (int)bid[i] : bucket(xval(i)));
        const bool take0 = do_k ? bk <= bstar : bk == bstar;
        const float x = take0 || (!do_k && bk < bstar) ? xval(i) : -INFINITY;
        if (!do_k && bk < bstar) am_merge(dv, di, gval(i) + x, lo + i);
        const bool take = take0 && (do_k || mass_of(x, xmax) > 0u);
        const unsigned ball = __ballot_sync(FULL, take);
        if (take) {
          const int slot = mine + __popc(ball & ((1u << lane) - 1u));
          if (slot < WCAP) {
            wx[warp * WCAP + slot] = x;
            widx[warp * WCAP + slot] = lo + i;
          }
        }
        mine += __popc(ball);
      }
      warp_argmax(dv, di);
      if (lane == 0) {
        sc.wcount[warp] = mine;
        red[warp].bv = dv;
        red[warp].bi = di;
      }
      __syncthreads();
      if (tid < CAP) {
        const int w = tid / WCAP, j = tid % WCAP;
        int off = 0;
        for (int q = 0; q < w; ++q) off += min(sc.wcount[q], WCAP);
        if (j < sc.wcount[w]) {
          lx[off + j] = wx[tid];
          lidx[off + j] = widx[tid];
        }
      }
      if (warp == 0) {
        float v = lane < WARPS ? red[lane].bv : -INFINITY;
        int i = lane < WARPS ? red[lane].bi : -1;
        warp_argmax(v, i);
        const int c = lane < WARPS ? sc.wcount[lane] : 0;
        const int total = __reduce_add_sync(FULL, (unsigned)c);
        const bool over = __any_sync(FULL, c > WCAP);
        if (lane == 0) {
          pub2.bv = v;
          pub2.bi = i;
          lcount = over ? max(total, CAP + 1) : total;
        }
      }
    }
    cluster.sync();  // S3
    // the lists' offsets, and whether one overflowed (every block reads the
    // same counts, so all take the same path)
    if (warp == 0) {
      const int c = lane < CLUSTER ? *cluster.map_shared_rank(&lcount, lane) : 0;
      int incl = min(c, CAP);
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      const int before = __shfl_up_sync(FULL, incl, 1);
      if (lane <= CLUSTER) sc.counts[lane] = lane == 0 ? 0 : before;
      const bool over = __any_sync(FULL, c > CAP) || __shfl_sync(FULL, incl, CLUSTER - 1) > UCAP;
      // block 0: the buckets above's draw, merged over the cluster
      float v = -INFINITY;
      int i = -1;
      if (rank == 0 && lane < CLUSTER) {
        const Partial q = *cluster.map_shared_rank(&pub2, lane);
        v = q.bv;
        i = q.bi;
      }
      warp_argmax(v, i);
      if (lane == 0) {
        sc.idx = over;
        best_s.bv = v;
        best_s.bi = i;
      }
    }
    __syncthreads();
    if (!sc.idx) {
      // 4. block 0 gathers the lists (at most UCAP entries, one a thread)
      //    and decides each entry by rank: how many keys, and how much mass,
      //    lie above it; then the draw over the kept entries, merged with
      //    the buckets above
      if (rank == 0) {
        const int m = gather_union(cluster, lx, lidx, ukey, uidx, umass, xmax, sc);
        cluster_arrive();
        float v = -INFINITY;
        int i = -1;
        auto draw_entry = [&](int j) {
          am_merge(v, i, gumbel[(size_t)b * V + uidx[j]] + unkey(ukey[j]), uidx[j]);
        };
        int above;
        u64 mass_above;
        rank_of(ukey, umass, m, above, mass_above);
        bool kept;
        if (do_k) {
          const bool surv = tid < m && above < top_k;
          kept = surv;
          if (do_p) {  // the mass above a survivor is the survivors' mass above it
            const u64 z = block_sum(surv ? umass[tid] : 0u, sc);
            kept = surv && mass_above < (u64)ceil((double)top_p * (double)z);
          }
        } else {
          kept = tid < m && mass_above < need;
        }
        if (kept) draw_entry(tid);
        warp_argmax(v, i);
        if (lane == 0) {
          red[warp].bv = v;
          red[warp].bi = i;
        }
        __syncthreads();
        if (warp == 0) {  // thread 0 ends with the choice and writes it below
          v = lane < WARPS ? red[lane].bv : -INFINITY;
          i = lane < WARPS ? red[lane].bi : -1;
          warp_argmax(v, i);
          am_merge(v, i, best_s.bv, best_s.bi);
          choice = i < 0 ? 0 : i;
        }
      } else {
        cluster_arrive();
      }
    } else if (do_k) {
      // a list overflowed (ties, a flat row): the thresholds over the whole
      // row by cluster-wide radix select
      const uint32_t kth = cluster_select<false>(
          cluster, n, (u64)top_k, 0.f, xmax, xval, [](float, uint32_t) { return true; }, sc);
      thr = kth;
      if (do_p)
        thr = max(kth, cluster_select<true>(cluster, n, 0, top_p, xmax, xval,
                                            [=](float, uint32_t key) { return key >= kth; },
                                            sc));
      draw = true;
    } else {
      thr = cluster_select<true>(
          cluster, n, need, 0.f, xmax, xval,
          [=](float x, uint32_t) { return bucket(x) == bstar && mass_of(x, xmax) > 0u; }, sc);
      draw = true;
    }
  }

  if (draw) {
    // 4. the draw over the row: first-index argmax of noise + kept x
    Partial d = neutral();
    for (int i = tid; i < n; i += THREADS) {
      const float x = xval(i);
      am_merge(d.bv, d.bi, gval(i) + (fkey(x) >= thr ? x : -INFINITY), lo + i);
    }
    block_argmax(d.bv, d.bi, red, &pub2);
    cluster.sync();  // S4
    cluster_merge(cluster, &pub2, &best_s);
    __syncthreads();
    cluster_arrive();
    choice = best_s.bi < 0 ? 0 : best_s.bi;
  }

  if (rank == 0 && tid == 0) {
    tok[b] = choice;
    lp[b] = (logits[(size_t)b * V + choice] - row.rmax) - logf(row.rsum);
  }
  cluster_wait();  // no block leaves while another may still read its shared memory
}

}  // namespace

// One cluster of CLUSTER blocks per row. Logits and noise are f32 (B, V);
// gumbel is null when greedy. V <= CLUSTER * MAX_SLICE (the wrapper checks).
extern "C" int fused_sample(const void* logits, const void* gumbel, void* tok,
                            void* lp, int B, int V, float temperature,
                            int top_k, float top_p, void* stream) {
  const int per = (V + CLUSTER - 1) / CLUSTER;
  if (per > MAX_SLICE) return (int)cudaErrorInvalidValue;
  // the slice of x; when sampled, of the noise and of the bucket ids too
  const size_t smem =
      per <= SMEM_SLICE ? (size_t)per * (gumbel != nullptr ? 2 * sizeof(float) + 2 : sizeof(float))
                        : 0;
  // the static scratch (~35 KB) and the slice together pass the 48 KB a
  // launch gets without asking
  const cudaError_t ea = cudaFuncSetAttribute(
      fused_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ea != cudaSuccess) return (int)ea;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int scale_temp = temperature != 1.f;
  const float tdiv = fmaxf(temperature, 1e-6f);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, fused_sample_kernel, (const float*)logits, (const float*)gumbel, (int32_t*)tok,
      (float*)lp, V, scale_temp, tdiv, top_k, top_p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
