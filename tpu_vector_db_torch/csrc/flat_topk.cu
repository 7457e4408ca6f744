// Exact flat top-k scan for Hopper (sm_90a): scores computed in the kernel
// body, a running top-k per query, and a merge pass.
//
// Replaces the two TPU kernels behind one Pallas call site,
// tpu_vector_db/ops/pallas_scan.py:
//   _scan_kernel       (k <= 32) -> scan_small_k + merge_topk_kernel
//   _scan_kernel_bigk  (k > 32)  -> scan_big_k   + merge_topk_kernel
// The TPU big-k kernel stops at k = 1024; this one takes any k, so the
// store serves every k the JAX store serves (its XLA scan takes k > 1024).
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
//  * k > 32: each query has a region of 2*KB slots, KB = next_pow2(k) (at
//    least 1024): the sorted best KB and a candidate area that rows above
//    the threshold append to. When the area may overflow, a bitonic sort of
//    the region restores the sorted best and raises the threshold. Up to
//    KB = 8192 (128 KB a query) the region is in shared memory; past it, in
//    device-memory scratch the wrapper allocates, and the wrapper gives
//    each split at least 4*k rows so that few candidates reach the merge.
//  * The merge keeps the sorted best next_pow2(k) plus an equal candidate
//    area (at least 4096 slots), in shared memory up to 16384 slots and in
//    device-memory scratch past that (topk_common.cuh).
//  * Order is key descending, then id ascending, everywhere. The TPU
//    kernel's first-occurrence rule gives exactly this because its ids rise
//    in scan order; with the explicit rule the result does not depend on
//    the split count.
//
// C interface, loaded with ctypes: vdb_flat_topk returns cudaGetLastError()
// after its launches (or cudaErrorInvalidValue for arguments it refuses).
// It allocates nothing: the caller passes outputs and candidate scratch.

#include "topk_common.cuh"

#define CHUNK_ROWS 256         // big-k: rows between threshold checks
#define MIN_KB 1024            // big-k: least width of the sorted best
// big-k: widest sorted best kept in shared memory (2 x 8192 slots of 8
// bytes = 128 KB a query); past it each block's regions are device-memory
// scratch that the caller passes
#define SMEM_MAX_KB 8192

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
  float* scratch_keys;  // big-k regions in device memory, or null
  int* scratch_ids;
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

// k > 32: per query a region of L = 2*KB (key, id) slots, KB =
// max(next_pow2(k), MIN_KB): [0, KB) the sorted best, [KB, 2*KB)
// candidates above the threshold, sorted in once more than KB - CHUNK_ROWS
// have collected. The regions live in shared memory up to KB =
// SMEM_MAX_KB, else in the caller's device-memory scratch, QT regions per
// block. Candidates out: (Q, splits, k).
template <int DT, int QT>
__global__ void __launch_bounds__(THREADS) scan_big_k(ScanArgs a) {
  extern __shared__ float smem[];
  const int KB = a.kb, L = 2 * a.kb;
  float* qs = smem;
  float* qsum8 = qs + QT * a.d_pad;
  float* thr = qsum8 + QT;
  int* cnt = reinterpret_cast<int*>(thr + QT);
  float* K;
  int* I;
  if (a.scratch_keys) {
    const size_t block = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    K = a.scratch_keys + block * QT * L;
    I = a.scratch_ids + block * QT * L;
  } else {
    K = reinterpret_cast<float*>(cnt + QT);
    I = reinterpret_cast<int*>(K + QT * L);
  }
  const int q0 = blockIdx.x * QT;
  for (int i = threadIdx.x; i < QT * L; i += THREADS) { K[i] = neg_inf(); I[i] = NO_ID; }
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
        K[(size_t)lane * L + KB + p] = mine;
        I[(size_t)lane * L + KB + p] = r;
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
        K[(size_t)t * L + KB + j] = neg_inf();
        I[(size_t)t * L + KB + j] = NO_ID;
      }
      if (threadIdx.x < QT) {
        cnt[threadIdx.x] = 0;
        thr[threadIdx.x] = K[(size_t)threadIdx.x * L + a.k - 1];
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < QT * a.k; i += THREADS) {
    const int t = i / a.k, j = i - t * a.k;
    if (q0 + t < a.Q) {
      const size_t o = ((size_t)(q0 + t) * gridDim.y + blockIdx.y) * a.k + j;
      a.cand_keys[o] = K[(size_t)t * L + j];
      a.cand_ids[o] = I[(size_t)t * L + j];
    }
  }
}

static int big_kb(int k) { return next_pow2(k) > MIN_KB ? next_pow2(k) : MIN_KB; }

static size_t scan_smem_bytes(int qt, int d_pad, int big, int kb) {
  size_t b = (size_t)qt * d_pad * 4 + (size_t)qt * 4;
  if (big) {
    b += (size_t)qt * 8;
    if (kb <= SMEM_MAX_KB) b += (size_t)qt * 2 * kb * 8;
  }
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

extern "C" int vdb_scan_smem_bytes(int qt, int d_pad, int big, int k) {
  return (int)scan_smem_bytes(qt, d_pad, big, big_kb(k));
}

extern "C" int vdb_warps_per_block(void) { return WARPS; }

// (key, id) slots of device-memory scratch vdb_flat_topk needs: the big-k
// regions when they do not fit in shared memory, then the merge's working
// areas when they do not. 0 when everything fits.
static size_t scan_scratch_slots(int Q, int qt, int splits, int k) {
  const int kb = big_kb(k);
  if (k <= 32 || kb <= SMEM_MAX_KB) return 0;
  return (size_t)((Q + qt - 1) / qt) * splits * qt * 2 * kb;
}

static size_t merge_scratch_slots(int Q, int k) {
  return merge_len(k) > MERGE_SMEM_MAX_LEN ? (size_t)Q * merge_len(k) : 0;
}

extern "C" long long vdb_flat_scratch_slots(int Q, int qt, int splits, int k) {
  return (long long)(scan_scratch_slots(Q, qt, splits, k) + merge_scratch_slots(Q, k));
}

// q: (Q, d_pad) f32, already rounded to the storage type's query precision.
// db: (>= count, row_bytes) rows of dtype (0 f32, 1 bf16, 2 int8, 3 int4).
// sq / mask / scales: per-row f32 or null. cand_*: (Q, n_lists, k) scratch
// with n_lists = splits * WARPS when k <= 32, else splits. out_*: (Q, k).
// scratch_*: vdb_flat_scratch_slots(Q, qt, splits, k) slots, or null when
// that is 0.
extern "C" int vdb_flat_topk(const float* q, int Q, int d_pad, const void* db, int dtype,
                             int row_bytes, int count, const float* sq, const float* mask,
                             const float* scales, int euclid, int k, int qt, int splits,
                             int rows_per_split, float* cand_keys, int* cand_ids,
                             float* out_keys, int* out_ids, float* scratch_keys,
                             int* scratch_ids, void* stream) {
  if (k < 1 || Q < 1 || splits < 1 || row_bytes % 16 ||
      (euclid && !sq) || (dtype == DT_I4 && !scales) ||
      (vdb_flat_scratch_slots(Q, qt, splits, k) && (!scratch_keys || !scratch_ids)))
    return cudaErrorInvalidValue;
  const int big = k > 32;
  const size_t scan_slots = scan_scratch_slots(Q, qt, splits, k);
  ScanArgs a;
  a.q = q; a.Q = Q; a.d_pad = d_pad;
  a.db = static_cast<const uint8_t*>(db);
  a.row_bytes = row_bytes; a.count = count;
  a.sq = sq; a.mask = mask; a.scales = scales;
  a.euclid = euclid; a.k = k;
  a.kb = big_kb(k);
  a.rows_per_split = rows_per_split;
  a.cand_keys = cand_keys; a.cand_ids = cand_ids;
  a.scratch_keys = scan_slots ? scratch_keys : nullptr;
  a.scratch_ids = scan_slots ? scratch_ids : nullptr;
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
  return launch_merge(cand_keys, cand_ids, Q, n_lists * k, k,
                      scratch_keys ? scratch_keys + scan_slots : nullptr,
                      scratch_ids ? scratch_ids + scan_slots : nullptr,
                      out_keys, out_ids, 0, st);
}
