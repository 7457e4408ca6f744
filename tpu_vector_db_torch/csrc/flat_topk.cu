// Exact flat top-k scan for Hopper (sm_90a): scores computed in the kernel
// body, a running top-k per query, and a merge pass.
//
// Replaces the two TPU kernels behind one Pallas call site,
// tpu_vector_db/ops/pallas_scan.py:
//   _scan_kernel       (k <= 32)        -> scan_small_k + merge_topk_kernel
//   _scan_kernel_bigk  (32 < k <= 1024) -> scan_big_k   + merge_topk_kernel
//
// What bounds it on this card. At batch 1 every stored byte is read once
// for 2*d flops per row: far below the card's ratio of flops to bytes, so
// the scan is bound by device-memory bytes (1M x 768 f32 = 3.1 GB, about
// 0.94 ms at 3.35 TB/s). At batch 64 the f32 case needs 2*64*N*d flops on
// the CUDA cores (67 TFLOP/s), about as long as the bytes; bf16/int8/int4
// rows would be bytes-bound again on tensor cores, which this first
// version does not use.
//
// What the design does about it:
//  * The TPU walks row blocks in sequence and carries its top-k across grid
//    steps. Here blocks run in parallel with no carry: a grid of
//    (query tile x row split), each block scanning its own contiguous row
//    range, then a second launch merges the splits' candidates.
//  * One warp scores one row at a time: each lane loads 16-byte chunks of
//    the row (coalesced across the warp, up to 8 loads in flight per lane),
//    widens f32/bf16/int8/int4 to f32 and accumulates the dot products with
//    up to QT queries held in shared memory; a butterfly of shuffles gives
//    every lane the row's QT scores. Rows past `count` are never read, and
//    rows the filter mask drops are skipped before their bytes are loaded.
//  * The TPU kernel's threshold skip is kept: a row that does not beat a
//    query's current k-th best is dropped at once, so after the first rows
//    almost no row costs more than its dot product.
//  * k <= 32: each warp keeps one sorted list per query in registers (lane
//    j holds the j-th best), updated by a ballot + shuffle insert.
//  * 32 < k <= 1024: each query has a shared-memory region of 2*KB slots:
//    the sorted best KB and a candidate area that rows above the threshold
//    append to. When the area may overflow, a bitonic sort of the region
//    restores the sorted best and raises the threshold.
//  * Order is key descending, then id ascending, everywhere. The TPU
//    kernel's first-occurrence rule gives exactly this because its ids rise
//    in scan order; with the explicit rule the result does not depend on
//    the split count.
//
// C interface, loaded with ctypes: vdb_flat_topk returns cudaGetLastError()
// after its launches (or cudaErrorInvalidValue for arguments it refuses).
// It allocates nothing: the caller passes outputs and candidate scratch.

#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS 8
#define THREADS (WARPS * 32)
#define MAXC 8                 // 16-byte chunks in flight per lane
#define CHUNK_ROWS 256         // big-k: rows between threshold checks
#define MIN_KB 1024            // big-k: least width of the sorted best
#define MERGE_THREADS 512
#define MERGE_LEN 4096
#define MAX_SMEM 232448
#define FULL 0xffffffffu

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

// The QT keys of row r, identical in every lane of the warp.
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

struct ScanArgs {
  const float* q;
  int Q, d_pad;
  const uint8_t* db;
  int row_bytes, count;
  const float* sq;
  const float* mask;
  const float* scales;
  int euclid, k, kb, rows_per_split;
  float* cand_keys;
  int* cand_ids;
};

// Queries of this block's tile into shared memory (zeros past Q), and for
// int4 the per-query 8 * sum(q) that folds the nibble offset out.
template <int DT, int QT>
__device__ void load_queries(const ScanArgs& a, int q0, float* qs, float* qsum8) {
  for (int i = threadIdx.x; i < QT * a.d_pad; i += THREADS) {
    const int t = i / a.d_pad;
    qs[i] = (q0 + t < a.Q) ? a.q[(size_t)(q0 + t) * a.d_pad + (i - t * a.d_pad)] : 0.f;
  }
  __syncthreads();
  if (DT == DT_I4) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int t = warp; t < QT; t += WARPS) {
      float s = 0.f;
      for (int c = lane; c < a.d_pad; c += 32) s += qs[t * a.d_pad + c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
      if (lane == 0) qsum8[t] = 8.f * s;
    }
  }
  __syncthreads();
}

// k <= 32: per-warp sorted lists in registers. Candidates out:
// (Q, splits * WARPS, k).
template <int DT, int QT>
__global__ void __launch_bounds__(THREADS) scan_small_k(ScanArgs a) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* qsum8 = smem + QT * a.d_pad;
  const int q0 = blockIdx.x * QT;
  load_queries<DT, QT>(a, q0, qs, qsum8);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = a.k;
  float val[QT], thr[QT];
  int id[QT];
#pragma unroll
  for (int t = 0; t < QT; t++) { val[t] = neg_inf(); thr[t] = neg_inf(); id[t] = 0; }

  const int r0 = blockIdx.y * a.rows_per_split;
  const int r1 = min(a.count, r0 + a.rows_per_split);
  const int n_chunks = a.row_bytes / 16;
  for (int r = r0 + warp; r < r1; r += WARPS) {
    if (a.mask && __ldg(a.mask + r) <= 0.5f) continue;
    const float scale = (DT == DT_I4) ? __ldg(a.scales + r) : 1.f;
    const float sqn = a.euclid ? __ldg(a.sq + r) : 0.f;
    float s[QT];
    row_keys<DT, QT>(reinterpret_cast<const uint4*>(a.db + (size_t)r * a.row_bytes),
                     n_chunks, qs, qsum8, a.d_pad, lane, scale, sqn, a.euclid, s);
#pragma unroll
    for (int t = 0; t < QT; t++) {
      if (s[t] > thr[t]) {  // warp-uniform: every lane holds s[t] and thr[t]
        // rows arrive in rising id order, so equal keys already held stay ahead
        const int pos = __popc(__ballot_sync(FULL, lane < k && val[t] >= s[t]));
        const float up_v = __shfl_up_sync(FULL, val[t], 1);
        const int up_i = __shfl_up_sync(FULL, id[t], 1);
        if (lane == pos) { val[t] = s[t]; id[t] = r; }
        else if (lane > pos && lane < k) { val[t] = up_v; id[t] = up_i; }
        thr[t] = __shfl_sync(FULL, val[t], k - 1);
      }
    }
  }
  const int n_lists = gridDim.y * WARPS;
  const int slot = blockIdx.y * WARPS + warp;
#pragma unroll
  for (int t = 0; t < QT; t++) {
    if (q0 + t < a.Q && lane < k) {
      const size_t o = ((size_t)(q0 + t) * n_lists + slot) * k + lane;
      a.cand_keys[o] = val[t];
      a.cand_ids[o] = id[t];
    }
  }
}

// Bitonic sort, key descending then id ascending, of n_regions regions of
// length L (a power of two) laid out back to back. All threads of the
// block take part; ends synchronized.
__device__ void bitonic_sort(float* K, int* I, int n_regions, int L) {
  const int half = L / 2;
  for (int size = 2; size <= L; size <<= 1) {
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n_regions * half; i += blockDim.x) {
        const int t = i / half, j = i - t * half;
        const int lo = (j / stride) * 2 * stride + (j % stride);
        const int a = t * L + lo, b = a + stride;
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

// 32 < k <= 1024: per query a region of 2*KB (key, id) slots in shared
// memory, KB = max(next_pow2(k), MIN_KB): [0, KB) the sorted best,
// [KB, 2*KB) candidates above the threshold, sorted in once more than
// KB - CHUNK_ROWS have collected. Candidates out: (Q, splits, k).
template <int DT, int QT>
__global__ void __launch_bounds__(THREADS) scan_big_k(ScanArgs a) {
  extern __shared__ float smem[];
  const int KB = a.kb, L = 2 * a.kb;
  float* qs = smem;
  float* qsum8 = qs + QT * a.d_pad;
  float* thr = qsum8 + QT;
  int* cnt = reinterpret_cast<int*>(thr + QT);
  float* K = reinterpret_cast<float*>(cnt + QT);
  int* I = reinterpret_cast<int*>(K + QT * L);
  const int q0 = blockIdx.x * QT;
  for (int i = threadIdx.x; i < QT * L; i += THREADS) { K[i] = neg_inf(); I[i] = 0x7fffffff; }
  if (threadIdx.x < QT) { thr[threadIdx.x] = neg_inf(); cnt[threadIdx.x] = 0; }
  load_queries<DT, QT>(a, q0, qs, qsum8);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * a.rows_per_split;
  const int r1 = min(a.count, r0 + a.rows_per_split);
  const int n_chunks = a.row_bytes / 16;
  for (int base = r0; base < r1; base += CHUNK_ROWS) {
    const int end = min(base + CHUNK_ROWS, r1);
    for (int r = base + warp; r < end; r += WARPS) {
      if (a.mask && __ldg(a.mask + r) <= 0.5f) continue;
      const float scale = (DT == DT_I4) ? __ldg(a.scales + r) : 1.f;
      const float sqn = a.euclid ? __ldg(a.sq + r) : 0.f;
      float s[QT];
      row_keys<DT, QT>(reinterpret_cast<const uint4*>(a.db + (size_t)r * a.row_bytes),
                       n_chunks, qs, qsum8, a.d_pad, lane, scale, sqn, a.euclid, s);
      float mine = s[0];  // lane t appends for query t
#pragma unroll
      for (int t = 1; t < QT; t++) if (lane == t) mine = s[t];
      if (lane < QT && mine > thr[lane]) {
        const int p = atomicAdd(&cnt[lane], 1);
        K[lane * L + KB + p] = mine;
        I[lane * L + KB + p] = r;
      }
    }
    __syncthreads();
    bool full = false;
    for (int t = 0; t < QT; t++) full |= cnt[t] > KB - CHUNK_ROWS;
    const bool last = end >= r1;
    bool any = false;
    for (int t = 0; t < QT; t++) any |= cnt[t] > 0;
    __syncthreads();
    if (full || (last && any)) {
      bitonic_sort(K, I, QT, L);
      for (int i = threadIdx.x; i < QT * KB; i += THREADS) {
        const int t = i / KB, j = i - t * KB;
        K[t * L + KB + j] = neg_inf();
        I[t * L + KB + j] = 0x7fffffff;
      }
      if (threadIdx.x < QT) {
        cnt[threadIdx.x] = 0;
        thr[threadIdx.x] = K[threadIdx.x * L + a.k - 1];
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < QT * a.k; i += THREADS) {
    const int t = i / a.k, j = i - t * a.k;
    if (q0 + t < a.Q) {
      const size_t o = ((size_t)(q0 + t) * gridDim.y + blockIdx.y) * a.k + j;
      a.cand_keys[o] = K[t * L + j];
      a.cand_ids[o] = I[t * L + j];
    }
  }
}

// One block per query: the best k of its n_cand candidates. Candidates
// that cannot beat the running k-th best are dropped on load; the rest
// collect in shared memory and are bitonic-sorted with the running best.
// Slots left at -inf get id 0, as the TPU kernel leaves them.
__global__ void __launch_bounds__(MERGE_THREADS) merge_topk_kernel(
    const float* __restrict__ cand_keys, const int* __restrict__ cand_ids,
    int n_cand, int k, int kp, float* __restrict__ out_keys, int* __restrict__ out_ids) {
  __shared__ float K[MERGE_LEN];
  __shared__ int I[MERGE_LEN];
  __shared__ int cnt;
  __shared__ float thr_k;
  __shared__ int thr_i;
  const size_t base = (size_t)blockIdx.x * n_cand;
  for (int i = threadIdx.x; i < kp; i += MERGE_THREADS) { K[i] = neg_inf(); I[i] = 0x7fffffff; }
  if (threadIdx.x == 0) { cnt = 0; thr_k = neg_inf(); thr_i = 0x7fffffff; }
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
    const bool flush = c > MERGE_LEN - kp - MERGE_THREADS ||
                       (start + MERGE_THREADS >= n_cand && c > 0);
    __syncthreads();
    if (flush) {
      int L = 1;
      while (L < kp + c) L <<= 1;
      for (int i = kp + c + threadIdx.x; i < L; i += MERGE_THREADS) {
        K[i] = neg_inf();
        I[i] = 0x7fffffff;
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
    out_ids[(size_t)blockIdx.x * k + j] = (key == neg_inf()) ? 0 : I[j];
  }
}

static size_t scan_smem_bytes(int qt, int d_pad, int big, int kb) {
  size_t b = (size_t)qt * d_pad * 4 + (size_t)qt * 4;
  if (big) b += (size_t)qt * 8 + (size_t)qt * 2 * kb * 8;
  return b;
}

template <int DT, int QT>
static cudaError_t launch_scan(const ScanArgs& a, int splits, int big, cudaStream_t st) {
  const size_t smem = scan_smem_bytes(QT, a.d_pad, big, a.kb);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const dim3 grid((a.Q + QT - 1) / QT, splits);
  if (big) {
    cudaFuncSetAttribute(scan_big_k<DT, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    scan_big_k<DT, QT><<<grid, THREADS, smem, st>>>(a);
  } else {
    cudaFuncSetAttribute(scan_small_k<DT, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    scan_small_k<DT, QT><<<grid, THREADS, smem, st>>>(a);
  }
  return cudaGetLastError();
}

template <int DT>
static cudaError_t launch_dt(const ScanArgs& a, int qt, int splits, int big, cudaStream_t st) {
  switch (qt) {
    case 1: return launch_scan<DT, 1>(a, splits, big, st);
    case 2: return launch_scan<DT, 2>(a, splits, big, st);
    case 4: return launch_scan<DT, 4>(a, splits, big, st);
    case 8: return launch_scan<DT, 8>(a, splits, big, st);
    default: return cudaErrorInvalidValue;
  }
}

static int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

extern "C" int vdb_scan_smem_bytes(int qt, int d_pad, int big, int k) {
  const int kb = next_pow2(k) > MIN_KB ? next_pow2(k) : MIN_KB;
  return (int)scan_smem_bytes(qt, d_pad, big, kb);
}

extern "C" int vdb_warps_per_block(void) { return WARPS; }

// q: (Q, d_pad) f32, already rounded to the storage type's query precision.
// db: (>= count, row_bytes) rows of dtype (0 f32, 1 bf16, 2 int8, 3 int4).
// sq / mask / scales: per-row f32 or null. cand_*: (Q, n_lists, k) scratch
// with n_lists = splits * WARPS when k <= 32, else splits. out_*: (Q, k).
extern "C" int vdb_flat_topk(const float* q, int Q, int d_pad, const void* db, int dtype,
                             int row_bytes, int count, const float* sq, const float* mask,
                             const float* scales, int euclid, int k, int qt, int splits,
                             int rows_per_split, float* cand_keys, int* cand_ids,
                             float* out_keys, int* out_ids, void* stream) {
  if (k < 1 || k > 1024 || Q < 1 || splits < 1 || row_bytes % 16 ||
      (euclid && !sq) || (dtype == DT_I4 && !scales))
    return cudaErrorInvalidValue;
  const int big = k > 32;
  ScanArgs a;
  a.q = q; a.Q = Q; a.d_pad = d_pad;
  a.db = static_cast<const uint8_t*>(db);
  a.row_bytes = row_bytes; a.count = count;
  a.sq = sq; a.mask = mask; a.scales = scales;
  a.euclid = euclid; a.k = k;
  a.kb = next_pow2(k) > MIN_KB ? next_pow2(k) : MIN_KB;
  a.rows_per_split = rows_per_split;
  a.cand_keys = cand_keys; a.cand_ids = cand_ids;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case DT_F32: err = launch_dt<DT_F32>(a, qt, splits, big, st); break;
    case DT_BF16: err = launch_dt<DT_BF16>(a, qt, splits, big, st); break;
    case DT_I8: err = launch_dt<DT_I8>(a, qt, splits, big, st); break;
    case DT_I4: err = launch_dt<DT_I4>(a, qt, splits, big, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int n_lists = big ? splits : splits * WARPS;
  merge_topk_kernel<<<Q, MERGE_THREADS, 0, st>>>(cand_keys, cand_ids, n_lists * k, k,
                                                 next_pow2(k), out_keys, out_ids);
  return cudaGetLastError();
}
