// Exact top-k of each query's keys, by a radix select on the keys'
// order-preserving uint32 images: the selection half of the big-k scan
// (flat_topk.cu, k > 32), which replaces the round-by-round segment maxima
// and bitonic merges of tpu_vector_db/ops/pallas_scan.py::_scan_kernel_bigk.
//
// Input: a (Q, ld) f32 key scratch that the scoring kernels wrote, n keys
// per query, for rows row_base .. row_base + n - 1 (-inf for dropped
// rows). Output: per query the min(k, live) best (key, id), sorted key
// descending then id ascending, then -inf with id 0.
//
// Passes, each over `sb` blocks per query (so that Q = 1 fills the card),
// each block walking its own contiguous range of keys:
//   sel_hist<0>: per-block shared-memory histograms of the leading 12 bits
//     (sign, exponent, 3 mantissa bits: 4096 bins), added into a global
//     (Q, 4096) histogram. -inf keys are not counted.
//   sel_hist<1>, sel_hist<2>: the next 12 and the last 8 bits, counting
//     only keys whose leading bits equal the bin found so far. Each block
//     finds that bin itself in its prologue (find_bin over the global
//     histograms: the largest bin whose keys and those above reach k), so
//     no step between the passes needs a launch of its own.
//   sel_output: the prologue finds the exact k-th key T and how many keys
//     lie above it. Every key > T is written to the query's survivor area.
//     Of the keys == T, the lowest ids are taken: sel_hist<2> also stored
//     each block's count of every last-digit bin, so a block knows how many
//     ties lie in the blocks before it, and inside the block an exclusive
//     scan in row order ranks its own. The result does not depend on the
//     order in which atomics run: histogram counts are integers and the
//     ranks of ties follow row ids. When every tie is taken (the common
//     case: one key == T) the scan is skipped.
//   sel_sort: one block per query sorts its k survivors (bitonic), in
//     shared memory up to MERGE_SMEM_MAX_LEN slots, in place in the
//     survivor area (device memory) past that.
// -0.0 is mapped to +0.0 before the transform, so the two tie and are
// ordered by id, as before() orders them.
//
// Bound: each pass reads the key scratch once (4 bytes a key) and the
// first histogram does one shared-memory atomic per live key; the other
// passes do atomics only for the few keys inside the chosen bin. At Q = 1
// the scratch is 4 bytes a row against the row's 3 KB (f32, d = 768), so
// the scan's bytes bound the call; at Q = 64 four reads of the scratch
// (plus its write) come to about 1.3 GB, 0.38 ms at 3.35 TB/s.

#pragma once

#include "topk_common.cuh"

#define SEL_BINS 4096          // bins of the first two digits (12 bits)
#define SEL_BINS3 256          // bins of the last digit (8 bits)
#define SEL_MIN_KEYS 8192      // least keys a select block walks
#define SEL_TARGET_BLOCKS 528  // blocks a select pass aims for, 4 a SM
#define SORT_THREADS 1024
#define ORD_NEG_INF 0x007fffffu  // ord_key(-inf)

struct SelArgs {
  const float* keys;  // (Q, ld) key scratch
  int Q, ld, n, row_base, k;
  int sb, per;        // blocks per query, keys per block (a multiple of 4)
  int* h1;            // (Q, SEL_BINS), zeroed before the passes
  int* h2;            // (Q, SEL_BINS), zeroed
  int* h3;            // (Q, SEL_BINS3), zeroed
  int* cnt;           // (Q) survivors written, zeroed
  int* bh;            // (Q, sb, SEL_BINS3) per-block counts of the last digit
  float* surv_keys;   // (Q, surv_ld) survivors, in no order
  int* surv_ids;
  int surv_ld;
};

// Larger key, larger image; -0.0 and +0.0 share one image.
__device__ __forceinline__ uint32_t ord_key(float f) {
  uint32_t b = __float_as_uint(f);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

template <int LEVEL>
__device__ __forceinline__ bool in_prefix(uint32_t u, uint32_t prefix) {
  return LEVEL == 0 || (LEVEL == 1 ? (u >> 20) == prefix : (u >> 8) == prefix);
}

template <int LEVEL>
__device__ __forceinline__ int digit(uint32_t u) {
  return LEVEL == 0 ? (int)(u >> 20) : LEVEL == 1 ? (int)((u >> 8) & 0xfffu) : (int)(u & 0xffu);
}

// Exclusive scan of v over the block in thread order; total of all v.
__device__ __forceinline__ void block_excl_scan(int v, int& excl, int& total) {
  __shared__ int wsum[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; w++) {
    const int s = wsum[w];
    before += w < warp ? s : 0;
    total += s;
  }
  excl = before + x - v;
  __syncthreads();
}

// The bin of the need-th largest counted key (need >= 1): the largest b
// with sum(h[b..]) >= need, above = sum(h[b + 1..]), cnt = h[b]. bin = -1
// and above = sum(h) when fewer than need keys were counted. Every thread
// of the block calls it and gets the result.
__device__ void find_bin(const int* h, int nb, int need, int& bin, int& above, int& cnt) {
  __shared__ int suf[THREADS];
  __shared__ int res[3];
  const int per = nb / THREADS, t = threadIdx.x;
  int s = 0;
  for (int j = 0; j < per; j++) s += h[t * per + j];
  __syncthreads();  // the previous call's readers are done
  suf[t] = s;
  if (t == 0) { res[0] = -1; res[1] = 0; res[2] = 0; }
  __syncthreads();
  if (t < 32) {  // suffix sums of the THREADS partial sums, 8 a lane
    int v[8], loc = 0;
#pragma unroll
    for (int j = 7; j >= 0; j--) { loc += suf[8 * t + j]; v[j] = loc; }
    int x = loc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_down_sync(FULL, x, o);
      if (t + o < 32) x += y;
    }
#pragma unroll
    for (int j = 0; j < 8; j++) suf[8 * t + j] = v[j] + x - loc;
  }
  __syncthreads();
  const int incl = suf[t], next = t + 1 < THREADS ? suf[t + 1] : 0;
  if (t == 0 && incl < need) res[1] = incl;
  if (incl >= need && next < need) {  // one thread holds the crossing
    int acc = next;
    for (int b = t * per + per - 1; b >= t * per; b--) {
      const int c = h[b];
      if (acc + c >= need) { res[0] = b; res[1] = acc; res[2] = c; break; }
      acc += c;
    }
  }
  __syncthreads();
  bin = res[0];
  above = res[1];
  cnt = res[2];
}

// A query's state after `levels` digits: the known leading bits (prefix),
// the keys above the prefix's range (above), the keys inside it (count),
// or all: fewer than k live keys, every one of them is taken.
struct Level {
  uint32_t prefix;
  int above, count;
  bool all;
};

__device__ Level resolve(const SelArgs& a, int q, int levels) {
  Level L{0u, 0, 0, false};
  for (int l = 0; l < levels; l++) {
    const int* h = l == 0 ? a.h1 + (size_t)q * SEL_BINS
                 : l == 1 ? a.h2 + (size_t)q * SEL_BINS
                          : a.h3 + (size_t)q * SEL_BINS3;
    int bin, above, cnt;
    find_bin(h, l == 2 ? SEL_BINS3 : SEL_BINS, a.k - L.above, bin, above, cnt);
    L.above += above;
    if (bin < 0) { L.all = true; return L; }
    L.prefix = l == 0 ? (uint32_t)bin : l == 1 ? (L.prefix << 12) | bin : (L.prefix << 8) | bin;
    L.count = cnt;
  }
  return L;
}

// Keys i .. i + 3 of a query's row (lo and ld multiples of 4), -inf past hi.
__device__ __forceinline__ void load4(const float* row, int i, int hi, float (&x)[4]) {
  if (i + 4 <= hi) {
    const float4 v = *reinterpret_cast<const float4*>(row + i);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; e++) x[e] = i + e < hi ? row[i + e] : neg_inf();
  }
}

template <int LEVEL>
__global__ void __launch_bounds__(THREADS) sel_hist(SelArgs a) {
  constexpr int NB = LEVEL == 2 ? SEL_BINS3 : SEL_BINS;
  __shared__ int hs[NB];
  const int q = blockIdx.y;
  uint32_t prefix = 0u;
  if (LEVEL > 0) {
    const Level L = resolve(a, q, LEVEL);
    if (L.all) return;  // block-uniform
    prefix = L.prefix;
  }
  for (int b = threadIdx.x; b < NB; b += THREADS) hs[b] = 0;
  __syncthreads();
  const int lo = min(a.n, blockIdx.x * a.per), hi = min(a.n, lo + a.per);
  const float* row = a.keys + (size_t)q * a.ld;
  for (int i = lo + 4 * threadIdx.x; i < hi; i += 4 * THREADS) {
    float x[4];
    load4(row, i, hi, x);
#pragma unroll
    for (int e = 0; e < 4; e++) {
      const uint32_t u = ord_key(x[e]);
      if (u > ORD_NEG_INF && in_prefix<LEVEL>(u, prefix)) atomicAdd(&hs[digit<LEVEL>(u)], 1);
    }
  }
  __syncthreads();
  int* h = (LEVEL == 0 ? a.h1 : LEVEL == 1 ? a.h2 : a.h3) + (size_t)q * NB;
  for (int b = threadIdx.x; b < NB; b += THREADS) {
    const int c = hs[b];
    if (c) atomicAdd(h + b, c);
    if (LEVEL == 2) a.bh[((size_t)q * gridDim.x + blockIdx.x) * SEL_BINS3 + b] = c;
  }
}

__global__ void __launch_bounds__(THREADS) sel_output(SelArgs a) {
  const int q = blockIdx.y, lane = threadIdx.x & 31;
  const Level L = resolve(a, q, 3);
  const int need = a.k - L.above;  // keys == T to take (unless all)
  const bool rank_ties = !L.all && L.count > need;
  int off = 0;  // keys == T in this query's earlier blocks
  if (rank_ties) {
    int s = 0, unused;
    for (int b = threadIdx.x; b < (int)blockIdx.x; b += THREADS)
      s += a.bh[((size_t)q * gridDim.x + b) * SEL_BINS3 + (L.prefix & 0xffu)];
    block_excl_scan(s, unused, off);
  }
  const int lo = min(a.n, blockIdx.x * a.per), hi = min(a.n, lo + a.per);
  const float* row = a.keys + (size_t)q * a.ld;
  for (int base = lo; base < hi; base += 4 * THREADS) {  // block-uniform
    const int i = base + 4 * threadIdx.x;
    float x[4];
    load4(row, i, hi, x);
    bool take[4], tie[4];
    int n_tie = 0;
#pragma unroll
    for (int e = 0; e < 4; e++) {
      const uint32_t u = ord_key(x[e]);
      tie[e] = !L.all && u == L.prefix;
      take[e] = L.all ? u > ORD_NEG_INF : u > L.prefix;
      n_tie += tie[e];
    }
    if (rank_ties) {
      int excl, total;
      block_excl_scan(n_tie, excl, total);
      int r = off + excl;
#pragma unroll
      for (int e = 0; e < 4; e++)
        if (tie[e]) { take[e] = r < need; r++; }
      off += total;
    } else {
#pragma unroll
      for (int e = 0; e < 4; e++) take[e] |= tie[e];
    }
    int n_take = 0;
#pragma unroll
    for (int e = 0; e < 4; e++) n_take += take[e];
    int incl = n_take;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    int slot = 0;
    if (lane == 31 && incl) slot = atomicAdd(a.cnt + q, incl);
    slot = __shfl_sync(FULL, slot, 31) + incl - n_take;
    float* sk = a.surv_keys + (size_t)q * a.surv_ld;
    int* si = a.surv_ids + (size_t)q * a.surv_ld;
#pragma unroll
    for (int e = 0; e < 4; e++)
      if (take[e]) { sk[slot] = x[e]; si[slot] = a.row_base + i + e; slot++; }
  }
}

// One block per query: the m = cnt[q] survivors sorted, then -inf with id
// 0 up to k, into out (row stride out_ld).
__global__ void __launch_bounds__(SORT_THREADS) sel_sort(SelArgs a, int in_smem,
                                                          float* out_keys, int* out_ids,
                                                          int out_ld) {
  extern __shared__ float smem[];
  const int q = blockIdx.x, k = a.k, m = a.cnt[q];
  const int L = next_pow2(m > 0 ? m : 1);
  float* K = a.surv_keys + (size_t)q * a.surv_ld;
  int* I = a.surv_ids + (size_t)q * a.surv_ld;
  if (in_smem) {
    float* sk = smem;
    int* si = reinterpret_cast<int*>(smem + L);
    for (int i = threadIdx.x; i < m; i += SORT_THREADS) { sk[i] = K[i]; si[i] = I[i]; }
    K = sk;
    I = si;
  }
  for (int i = m + threadIdx.x; i < L; i += SORT_THREADS) { K[i] = neg_inf(); I[i] = NO_ID; }
  __syncthreads();
  bitonic_sort(K, I, 1, L);
  for (int j = threadIdx.x; j < k; j += SORT_THREADS) {
    out_keys[(size_t)q * out_ld + j] = j < m ? K[j] : neg_inf();
    out_ids[(size_t)q * out_ld + j] = j < m ? I[j] : 0;
  }
}

// The survivors are sorted in shared memory while their area fits.
inline bool sort_in_smem(int k) { return next_pow2(k) <= MERGE_SMEM_MAX_LEN; }
inline int surv_ld(int k) { return sort_in_smem(k) ? k : next_pow2(k); }

// Blocks per query of the select passes over n keys a query.
inline int sel_blocks(int Q, int n) {
  const int want = (SEL_TARGET_BLOCKS + Q - 1) / Q;
  const int most = (n + SEL_MIN_KEYS - 1) / SEL_MIN_KEYS;
  const int sb = want < most ? want : most;
  return sb > 1 ? sb : 1;
}

// The select of a.n keys a query into out; a.h1 .. a.cnt already zeroed.
static cudaError_t launch_select(SelArgs a, float* out_keys, int* out_ids, int out_ld,
                                 cudaStream_t st) {
  const int per = (a.n + a.sb - 1) / a.sb;
  a.per = (per + 3) & ~3;
  const dim3 grid(a.sb, a.Q);
  sel_hist<0><<<grid, THREADS, 0, st>>>(a);
  sel_hist<1><<<grid, THREADS, 0, st>>>(a);
  sel_hist<2><<<grid, THREADS, 0, st>>>(a);
  sel_output<<<grid, THREADS, 0, st>>>(a);
  const int in_smem = sort_in_smem(a.k);
  const int smem = in_smem ? next_pow2(a.k) * 8 : 0;
  cudaFuncSetAttribute(sel_sort, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  sel_sort<<<a.Q, SORT_THREADS, smem, st>>>(a, in_smem, out_keys, out_ids, out_ld);
  return cudaGetLastError();
}
