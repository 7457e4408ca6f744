// Device code shared by flat_topk.cu and ivf_topk.cu: the (key, id) order,
// the warp's dot product of one stored row against queries held in shared
// memory, the PTX wrappers of cp.async, ldmatrix and mma.sync, a
// block-wide bitonic sort and the two per-query merges of candidate lists:
// merge_small_k (k <= 32, warp lists) and merge_topk_kernel (any k: the
// k > 32 chunk merge and the merge of the tile's lists at k <= 64).
//
// Order everywhere is key descending, then id ascending. Slots that hold no
// row carry key -inf and id INT_MAX while they are being sorted.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS 8
#define THREADS (WARPS * 32)
#define MAXC 8                 // 16-byte chunks in flight per lane
#define MERGE_THREADS 512
#define MERGE_MIN_LEN 4096     // least working area of the merge, in slots
#define MAX_SMEM 232448
#define FULL 0xffffffffu
#define NO_ID 0x7fffffff

enum { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2, DT_I4 = 3 };

__device__ __forceinline__ bool before(float ka, int ia, float kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 q, float a, float b, float c,
                                      float d, float acc) {
  acc = fmaf(q.x, a, acc);
  acc = fmaf(q.y, b, acc);
  acc = fmaf(q.z, c, acc);
  return fmaf(q.w, d, acc);
}

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float i8_at(uint32_t w, int j) {
  return (float)(int8_t)((w >> (8 * j)) & 0xffu);
}

// Accumulate one 16-byte chunk `v` (chunk index c of the row) against the
// QT queries in shared memory.
template <int DT, int QT>
__device__ __forceinline__ void chunk_dot(uint4 v, int c, const float* qs,
                                          int d_pad, float (&acc)[QT]) {
  if (DT == DT_F32) {
    const float x0 = __uint_as_float(v.x), x1 = __uint_as_float(v.y);
    const float x2 = __uint_as_float(v.z), x3 = __uint_as_float(v.w);
#pragma unroll
    for (int t = 0; t < QT; t++)
      acc[t] = dot4(lds4(qs + t * d_pad + c * 4), x0, x1, x2, x3, acc[t]);
  } else if (DT == DT_BF16) {
#pragma unroll
    for (int t = 0; t < QT; t++) {
      const float* qp = qs + t * d_pad + c * 8;
      float a = dot4(lds4(qp), bf_lo(v.x), bf_hi(v.x), bf_lo(v.y), bf_hi(v.y), acc[t]);
      acc[t] = dot4(lds4(qp + 4), bf_lo(v.z), bf_hi(v.z), bf_lo(v.w), bf_hi(v.w), a);
    }
  } else if (DT == DT_I8) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int t = 0; t < QT; t++) {
      const float* qp = qs + t * d_pad + c * 16;
      float a = acc[t];
#pragma unroll
      for (int g = 0; g < 4; g++)
        a = dot4(lds4(qp + 4 * g), i8_at(w[g], 0), i8_at(w[g], 1),
                 i8_at(w[g], 2), i8_at(w[g], 3), a);
      acc[t] = a;
    }
  } else {  // int4: byte j = (component j in the low nibble, j + d/2 high)
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const int half = d_pad / 2;
#pragma unroll
    for (int t = 0; t < QT; t++) {
      const float* lo = qs + t * d_pad + c * 16;
      const float* hi = lo + half;
      float a = acc[t];
#pragma unroll
      for (int g = 0; g < 4; g++) {
        const uint32_t x = w[g];
        a = dot4(lds4(lo + 4 * g), (float)(x & 15u), (float)((x >> 8) & 15u),
                 (float)((x >> 16) & 15u), (float)((x >> 24) & 15u), a);
        a = dot4(lds4(hi + 4 * g), (float)((x >> 4) & 15u), (float)((x >> 12) & 15u),
                 (float)((x >> 20) & 15u), (float)(x >> 28), a);
      }
      acc[t] = a;
    }
  }
}

// The QT keys of one row, identical in every lane of the warp.
template <int DT, int QT>
__device__ __forceinline__ void row_keys(const uint4* __restrict__ row, int n_chunks,
                                         const float* qs, const float* qsum8,
                                         int d_pad, int lane, float scale,
                                         float sqnorm, int euclid, float (&acc)[QT]) {
#pragma unroll
  for (int t = 0; t < QT; t++) acc[t] = 0.f;
  for (int c0 = 0; c0 < n_chunks; c0 += 32 * MAXC) {
    uint4 v[MAXC];
#pragma unroll
    for (int u = 0; u < MAXC; u++) {
      const int c = c0 + u * 32 + lane;
      if (c < n_chunks) v[u] = __ldg(row + c);
    }
#pragma unroll
    for (int u = 0; u < MAXC; u++) {
      const int c = c0 + u * 32 + lane;
      if (c < n_chunks) chunk_dot<DT, QT>(v[u], c, qs, d_pad, acc);
    }
  }
#pragma unroll
  for (int t = 0; t < QT; t++) {
    float s = acc[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (DT == DT_I4) s = (s - qsum8[t]) * scale;  // offset 8 folded out
    if (euclid) s = 2.f * s - sqnorm;             // rank-equivalent L2 key
    acc[t] = s;
  }
}

// ---- Hopper data movement and tensor-core helpers (PTX) ----

// 16-byte copy device -> shared memory that does not stall the thread; with
// ok false nothing is read and the 16 bytes are zero-filled. The hint has
// L2 fetch the 256 bytes around src, so that the next chunks of a stored
// row come from L2.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses (16 bytes each) of matrix i, which lands in r[i] as the mma
// fragment layout wants it (lane l: row l/4, columns 2(l%4), +1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, column-major).
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats that are exact in bf16 (small integers) as a bf16 pair, lo in
// the low half: truncation drops only zero bits.
__device__ __forceinline__ uint32_t bf16x2_exact(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}

// Insert (s, sid) into a warp's sorted list (lane j holds the j-th best of
// k <= 32). The caller has checked that it beats the k-th entry.
__device__ __forceinline__ void warp_insert(float& val, int& id, float s, int sid,
                                            int k, int lane) {
  const int pos = __popc(__ballot_sync(FULL, lane < k && before(val, id, s, sid)));
  const float up_v = __shfl_up_sync(FULL, val, 1);
  const int up_i = __shfl_up_sync(FULL, id, 1);
  if (lane == pos) { val = s; id = sid; }
  else if (lane > pos && lane < k) { val = up_v; id = up_i; }
}

// The same for a list of E entries a lane: lane j holds entries j and, with
// E = 2 (32 < k <= 64), 32 + j. The place is the sum of the two halves'
// ballots; the shift rotates each half by one lane, so lane 0 of the
// second half takes entry 31 from the first.
template <int E>
__device__ __forceinline__ void warp_insert(float (&val)[E], int (&id)[E], float s, int sid,
                                            int k, int lane) {
  static_assert(E == 1 || E == 2, "one or two entries a lane");
  if constexpr (E == 1) {
    warp_insert(val[0], id[0], s, sid, k, lane);
  } else {
    const int pos = __popc(__ballot_sync(FULL, before(val[0], id[0], s, sid))) +
                    __popc(__ballot_sync(FULL, 32 + lane < k && before(val[1], id[1], s, sid)));
    const int from = (lane + 31) & 31;
    const float r0 = __shfl_sync(FULL, val[0], from), r1 = __shfl_sync(FULL, val[1], from);
    const int i0 = __shfl_sync(FULL, id[0], from), i1 = __shfl_sync(FULL, id[1], from);
    if (lane == pos) { val[0] = s; id[0] = sid; }
    else if (lane > pos) { val[0] = r0; id[0] = i0; }
    const int g = 32 + lane;
    if (g == pos) { val[1] = s; id[1] = sid; }
    else if (g > pos && g < k) { val[1] = lane ? r1 : r0; id[1] = lane ? i1 : i0; }
  }
}

// Entry k - 1 of a list of E entries a lane (the threshold of an insert).
template <int E>
__device__ __forceinline__ float kth_key(const float (&val)[E], int k) {
  return __shfl_sync(FULL, val[E - 1], k - 1 - 32 * (E - 1));
}

// Bitonic sort, key descending then id ascending, of n_regions regions of
// length L (a power of two) laid out back to back, in shared or device
// memory. All threads of the block take part; ends synchronized.
__device__ void bitonic_sort(float* K, int* I, int n_regions, int L) {
  const int half = L / 2;
  for (int size = 2; size <= L; size <<= 1) {
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n_regions * half; i += blockDim.x) {
        const int t = i / half, j = i - t * half;
        const int lo = (j / stride) * 2 * stride + (j % stride);
        const size_t a = (size_t)t * L + lo, b = a + stride;
        const bool desc = (lo & size) == 0;
        const float ka = K[a], kb = K[b];
        const int ia = I[a], ib = I[b];
        if (desc ? before(kb, ib, ka, ia) : before(ka, ia, kb, ib)) {
          K[a] = kb; K[b] = ka; I[a] = ib; I[b] = ia;
        }
      }
      __syncthreads();
    }
  }
}

__host__ __device__ inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Working area of merge_topk_kernel for a given k, in (key, id) slots: the
// sorted best next_pow2(k) and room for at least as many candidates.
inline int merge_len(int k) {
  const int kp2 = 2 * next_pow2(k);
  return kp2 > MERGE_MIN_LEN ? kp2 : MERGE_MIN_LEN;
}

// Largest merge area kept in shared memory (128 KB); past it the area is
// device-memory scratch that the caller passes.
#define MERGE_SMEM_MAX_LEN 16384

// One block per query: the best k of its n_cand candidates (the k > 32
// merges of flat_topk.cu). Candidates
// that cannot beat the running k-th best are dropped on load; the rest
// collect in the working area of ml slots (dynamic shared memory, or
// scratch + blockIdx.x * ml in device memory when scratch is given) and
// are bitonic-sorted with the running best. Slots left at -inf get id
// empty_id.
__global__ void __launch_bounds__(MERGE_THREADS) merge_topk_kernel(
    const float* __restrict__ cand_keys, const int* __restrict__ cand_ids,
    int n_cand, int k, int kp, int ml, float* scratch_keys, int* scratch_ids,
    float* __restrict__ out_keys, int* __restrict__ out_ids, int empty_id) {
  extern __shared__ float smem[];
  float* K;
  int* I;
  if (scratch_keys) {
    K = scratch_keys + (size_t)blockIdx.x * ml;
    I = scratch_ids + (size_t)blockIdx.x * ml;
  } else {
    K = smem;
    I = reinterpret_cast<int*>(smem + ml);
  }
  __shared__ int cnt;
  __shared__ float thr_k;
  __shared__ int thr_i;
  const size_t base = (size_t)blockIdx.x * n_cand;
  for (int i = threadIdx.x; i < kp; i += MERGE_THREADS) { K[i] = neg_inf(); I[i] = NO_ID; }
  if (threadIdx.x == 0) { cnt = 0; thr_k = neg_inf(); thr_i = NO_ID; }
  __syncthreads();
  for (int start = 0; start < n_cand; start += MERGE_THREADS) {
    const int j = start + threadIdx.x;
    if (j < n_cand) {
      const float key = __ldg(cand_keys + base + j);
      const int id = __ldg(cand_ids + base + j);
      if (before(key, id, thr_k, thr_i)) {
        const int p = atomicAdd(&cnt, 1);
        K[kp + p] = key;
        I[kp + p] = id;
      }
    }
    __syncthreads();
    const int c = cnt;
    const bool flush = c > ml - kp - MERGE_THREADS ||
                       (start + MERGE_THREADS >= n_cand && c > 0);
    __syncthreads();
    if (flush) {
      const int L = next_pow2(kp + c);  // <= ml: c <= ml - kp
      for (int i = kp + c + threadIdx.x; i < L; i += MERGE_THREADS) {
        K[i] = neg_inf();
        I[i] = NO_ID;
      }
      __syncthreads();
      bitonic_sort(K, I, 1, L);
      if (threadIdx.x == 0) { cnt = 0; thr_k = K[k - 1]; thr_i = I[k - 1]; }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < k; j += MERGE_THREADS) {
    const float key = K[j];
    out_keys[(size_t)blockIdx.x * k + j] = key;
    out_ids[(size_t)blockIdx.x * k + j] = (key == neg_inf()) ? empty_id : I[j];
  }
}

// Launch merge_topk_kernel for Q queries of n_cand candidates each.
// scratch: Q * merge_len(k) (key, id) slots of device memory when
// merge_len(k) > MERGE_SMEM_MAX_LEN, else unused (may be null).
static cudaError_t launch_merge(const float* cand_keys, const int* cand_ids, int Q,
                                int n_cand, int k, float* scratch_keys,
                                int* scratch_ids, float* out_keys, int* out_ids,
                                int empty_id, cudaStream_t st) {
  const int ml = merge_len(k);
  const bool global = ml > MERGE_SMEM_MAX_LEN;
  if (global && (!scratch_keys || !scratch_ids)) return cudaErrorInvalidValue;
  const int smem = global ? 0 : ml * 8;
  cudaFuncSetAttribute(merge_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  merge_topk_kernel<<<Q, MERGE_THREADS, smem, st>>>(
      cand_keys, cand_ids, n_cand, k, next_pow2(k), ml,
      global ? scratch_keys : nullptr, global ? scratch_ids : nullptr,
      out_keys, out_ids, empty_id);
  return cudaGetLastError();
}

// ---- k <= 32: the warp-level merge ----
//
// Merges the candidate lists of both k <= 32 kernels: the split lists of
// the flat scan (scan_small_k, scan_small_k_tile) and the (probe, split)
// lists of the IVF probe (ivf_scan_kernel), which stand in for the top-k
// that the TPU kernels _scan_kernel and _ivf_kernel carry from grid step to
// grid step.
//
// What bounds it on this card. A query's candidates are few bytes (5120 of
// them, 41 KB, for an IVF probe at nprobe 32; 42240, 338 KB, for a flat
// batch-1 scan), just written by the scan and read once from L2: latency,
// and the serial steps of the selection, bound it, not bytes. The earlier
// merge (merge_topk_kernel) bitonic-sorts at least 4096 slots a flush, about
// 78 stages each ending in a block-wide barrier.
//
// What the design does about it:
//  * One block of MERGE_SMALL_WARPS (16) warps a query (16 timed faster
//    than 32 at every shape the scans give it). Each warp walks a
//    contiguous slice of the query's candidates, MERGE_LOADS coalesced 128-byte loads of keys a
//    step, the next step's in flight while one is walked, and keeps a
//    sorted top-k in registers (lane j holds the j-th best, warp_insert),
//    as ivf_scan_kernel does. The ids of a step's surviving candidates are
//    loaded together, so a step waits on L2 once, not once a group of 32.
//  * A block-wide bound: each warp publishes its k-th key to shared memory
//    (atomicMax of an order-preserving int image). No candidate strictly
//    below the largest published key can be in the top k, so it is dropped
//    on its key alone and its id is never read; a key equal to the bound
//    stays, since ties go by id. -inf keys never enter (a slot that stays
//    -inf comes out with empty_id).
//  * The 16 warp lists meet in shared memory and go through 4 rounds of
//    pairwise merges: each lane finds its entry's place in the other list
//    by a binary search over shuffles (this timed faster than warp 0
//    inserting each list in turn).
//  * The result is the exact top k in (key desc, id asc) order, the same as
//    merge_topk_kernel's for candidates whose ids are distinct in a query
//    (as every scan writes them): no arithmetic happens here.

#define MERGE_LOADS 8          // candidates in flight per lane
#define MERGE_SMALL_WARPS 16   // warps of a block (one block a query)

// Order-preserving int image of a float under signed compare; its own
// inverse. -0.0 and +0.0 get two images, but the bound is compared as a
// float, where they are equal.
__device__ __forceinline__ int key_image(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float image_key(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// Entries of the sorted list (x, xi) (lane j holds the j-th of k) that come
// before (a, ai), or with or_equal before or equal to it: a binary search
// over shuffles, 6 halvings of [0, k].
__device__ __forceinline__ int count_before(float x, int xi, float a, int ai, int k,
                                            bool or_equal) {
  int lo = 0, hi = k;
#pragma unroll
  for (int step = 0; step < 6; step++) {
    const int mid = (lo + hi) >> 1;
    const float xm = __shfl_sync(FULL, x, mid);
    const int xim = __shfl_sync(FULL, xi, mid);
    if (lo < hi) {
      if (or_equal ? !before(a, ai, xm, xim) : before(xm, xim, a, ai)) lo = mid + 1;
      else hi = mid;
    }
  }
  return lo;
}

// One block an SM is enough (one block a query).
__global__ void __launch_bounds__(MERGE_SMALL_WARPS * 32, 1) merge_small_k(
    const float* __restrict__ cand_keys, const int* __restrict__ cand_ids, int n_cand, int k,
    float* __restrict__ out_keys, int* __restrict__ out_ids, int empty_id) {
  constexpr int W = MERGE_SMALL_WARPS;
  __shared__ float lk[W][32];
  __shared__ int li[W][32];
  __shared__ int bound;  // key_image of the largest k-th key a warp holds
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) bound = key_image(neg_inf());
  __syncthreads();
  const float* keys = cand_keys + (size_t)blockIdx.x * n_cand;
  const int* ids = cand_ids + (size_t)blockIdx.x * n_cand;
  const int per = ((n_cand + W - 1) / W + 31) & ~31;  // a warp's slice, whole steps
  const int j1 = min(n_cand, (warp + 1) * per);
  float val = neg_inf(), thr_v = neg_inf();
  int id = NO_ID, thr_i = NO_ID;
  float kv[MERGE_LOADS], next[MERGE_LOADS];
  const auto load = [&](float (&dst)[MERGE_LOADS], int at) {
#pragma unroll
    for (int u = 0; u < MERGE_LOADS; u++) {
      const int j = at + u * 32 + lane;
      dst[u] = j < j1 ? __ldg(keys + j) : neg_inf();
    }
  };
  load(kv, warp * per);
  for (int base = warp * per; base < j1; base += 32 * MERGE_LOADS) {
    load(next, base + 32 * MERGE_LOADS);  // in flight while kv is walked
    const float lo = image_key(*reinterpret_cast<volatile int*>(&bound));
    const float held = thr_v;
    // below the bound or the warp's k-th: out, its id never read; -inf (and
    // NaN) never enter. The ids of the rest load together, one wait a step.
    int iv[MERGE_LOADS];
#pragma unroll
    for (int u = 0; u < MERGE_LOADS; u++) {
      if (!(kv[u] > neg_inf() && kv[u] >= lo && kv[u] >= thr_v)) kv[u] = neg_inf();
      iv[u] = kv[u] > neg_inf() ? __ldg(ids + base + u * 32 + lane) : NO_ID;
    }
#pragma unroll
    for (int u = 0; u < MERGE_LOADS; u++) {
      unsigned m = __ballot_sync(FULL, kv[u] > neg_inf() && kv[u] >= thr_v);
      while (m) {  // warp-uniform
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const float s = __shfl_sync(FULL, kv[u], src);
        const int sid = __shfl_sync(FULL, iv[u], src);
        if (before(s, sid, thr_v, thr_i)) {
          warp_insert(val, id, s, sid, k, lane);
          thr_v = __shfl_sync(FULL, val, k - 1);
          thr_i = __shfl_sync(FULL, id, k - 1);
        }
      }
    }
    if (lane == 0 && thr_v > held) atomicMax(&bound, key_image(thr_v));
#pragma unroll
    for (int u = 0; u < MERGE_LOADS; u++) kv[u] = next[u];
  }

  // the W lists -> one, in lk[0] / li[0] (lanes >= k hold -inf / NO_ID)
  lk[warp][lane] = val;
  li[warp][lane] = id;
  for (int s = 1; s < W; s <<= 1) {
    __syncthreads();
    if ((warp & (2 * s - 1)) == 0) {
      const float a = lk[warp][lane], b = lk[warp + s][lane];
      const int ai = li[warp][lane], bi = li[warp + s][lane];
      // places in the merged list; equal entries: this warp's first
      const int pa = lane + count_before(b, bi, a, ai, k, false);
      const int pb = lane + count_before(a, ai, b, bi, k, true);
      __syncwarp();
      if (lane < k && pa < k) { lk[warp][pa] = a; li[warp][pa] = ai; }
      if (lane < k && pb < k) { lk[warp][pb] = b; li[warp][pb] = bi; }
    }
  }
  __syncwarp();
  if (warp == 0 && lane < k) {
    const float key = lk[0][lane];
    out_keys[(size_t)blockIdx.x * k + lane] = key;
    out_ids[(size_t)blockIdx.x * k + lane] = key == neg_inf() ? empty_id : li[0][lane];
  }
}

// Launch merge_small_k for Q queries of n_cand candidates each, k <= 32.
static cudaError_t launch_merge_small(const float* cand_keys, const int* cand_ids, int Q,
                                      int n_cand, int k, float* out_keys, int* out_ids,
                                      int empty_id, cudaStream_t st) {
  if (k < 1 || k > 32 || Q < 1 || n_cand < 1) return cudaErrorInvalidValue;
  merge_small_k<<<Q, MERGE_SMALL_WARPS * 32, 0, st>>>(cand_keys, cand_ids, n_cand, k, out_keys,
                                                      out_ids, empty_id);
  return cudaGetLastError();
}
