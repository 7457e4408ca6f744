// IVF probe scan for Hopper (sm_90a): the top-k of the rows in each
// query's probed buckets, scored in the kernel body, then a merge pass.
//
// Replaces the TPU kernel tpu_vector_db/ops/ivf_scan.py:_ivf_kernel
// (reached through ivf_probe_topk_pallas). The index lays its rows out
// cluster-major in fixed-size buckets (NB, Bc, d_pad); a query probes the
// nprobe buckets sel[q, :] that its centroid scores chose, and the rows of
// a bucket are live up to its fill count.
//
// What bounds it on this card. Each probed row is read once for 2*d flops:
// far below the card's ratio of flops to bytes, so the scan is bound by
// device-memory bytes. At batch 1, nprobe 32, Bc 1024, d 768 f32 a query
// reads at most 32 x 1024 x 3072 B = 101 MB, about 30 us at 3.35 TB/s:
// small, so the work must be spread over the whole card to come near it,
// and what follows the scan (the merge of a query's lists, and the
// launches) is a large share of the call. The merge moves few bytes (5120
// candidates, 41 KB, at batch 1 and nprobe 32): its latency and its serial
// steps bound it.
//
// What the design does about it:
//  * The TPU grid (Q, nprobe) walks a query's probes in order on one core
//    and carries its top-k from step to step. Here nothing carries between
//    blocks: a grid of (query x probe, row split) blocks, each scoring its
//    own slice of one bucket's live rows, so that even a batch-1 query
//    fills the 132 SMs; a second launch merges each query's lists
//    (merge_small_k, topk_common.cuh): one block of 16 warps a query, each
//    warp a sorted list in registers over its slice of the candidates, a
//    block-wide bound on the k-th key that drops a candidate on its key
//    alone, and a tree of pairwise merges of the warp lists, in place of a
//    one-block bitonic sort of at least 4096 slots.
//  * A block loads its own sel[q, p] and fills[b] (the TPU kernel's scalar
//    prefetch). Slots at or past the fill count are never read.
//  * One warp scores one row at a time with 16-byte loads, as the flat scan
//    does (row_keys, topk_common.cuh); queries are rounded to the bucket
//    type by the wrapper and every product accumulates in f32.
//  * Each warp keeps a sorted top-k (k <= 32) in registers; a row that
//    does not beat the warp's k-th best is dropped before its id is read.
//    The eight warp lists are merged in the block, so one list per block
//    reaches the merge pass.
//  * The kernel reads the row's global id from bucket_ids only for a row
//    that enters a list, and orders by key descending, then global id
//    ascending, in every stage: a full probe returns exactly what the flat
//    scan returns. Empty slots come back as key -inf, id -1.
//  * Euclidean keys (2 q.x - |x|^2, from the bucket's squared norms) are
//    scored in the same pass; the wrapper subtracts |q|^2.
//
// C interface, loaded with ctypes: vdb_ivf_topk returns cudaGetLastError()
// after its launches (or cudaErrorInvalidValue for arguments it refuses).
// It allocates nothing: the caller passes outputs and candidate scratch.
// vdb_merge_small_k runs the merge alone (the tests and chip_smoke.py
// hold it against its plain version). vdb_ivf_gather_topk is the probe of
// the gather layout (below).

#include "topk_common.cuh"

#define IVF_MAX_K 32            // the bucketized layout: one list entry a lane
#define GATHER_MAX_K 64         // the gather layout: up to two

struct IvfArgs {
  const float* q;           // (Q, d_pad) f32
  int Q, d_pad, nprobe, nb, bc, row_bytes, rows_per_split;
  const uint8_t* rows;      // bucketized: (nb, bc) rows; gather: (N_pad) rows by id
  const int* sel;           // (Q, nprobe)
  const int* fills;         // (nb,)
  const int* ids;           // (nb, bc), -1 in empty slots
  const float* sq;          // (nb, bc) squared norms, euclidean only
  const float* scales;      // (N_pad,) int4 per-row scales, gather only
  int euclid, k;
  float* cand_keys;         // (Q, nprobe * splits, k)
  int* cand_ids;
};

// The body of both layouts' probe kernels. Block (q * nprobe + p, s) of a
// (Q * nprobe, splits) grid scores slots [s * rows_per_split, (s + 1) *
// rows_per_split) of bucket sel[q, p], up to its fill count, and writes
// one sorted list of k candidates. E list entries a lane (k <= 32 E).
// GATHER: the row of a slot is read at its id in the store's flat matrix
// (an empty slot is skipped before its row is read); otherwise at the
// slot's place in the bucketized copy, and the id is read only for a row
// that enters a list.
template <int DT, int E, bool GATHER>
__device__ __forceinline__ void probe_bucket(const IvfArgs& a) {
  extern __shared__ float smem[];
  float* qs = smem;                         // the query, d_pad floats
  float* wk = qs + a.d_pad;                 // WARPS lists of 32 * E keys
  int* wi = reinterpret_cast<int*>(wk + WARPS * 32 * E);
  float* qsum8 = reinterpret_cast<float*>(wi + WARPS * 32 * E);  // int4
  const int qi = blockIdx.x / a.nprobe;
  const int p = blockIdx.x - qi * a.nprobe;
  for (int i = threadIdx.x; i < a.d_pad; i += THREADS)
    qs[i] = a.q[(size_t)qi * a.d_pad + i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (DT == DT_I4) {                        // 8 x sum(q): the nibble offset
    if (warp == 0) {
      float s = 0.f;
      for (int c = lane; c < a.d_pad; c += 32) s += qs[c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
      if (lane == 0) qsum8[0] = 8.f * s;
    }
    __syncthreads();
  }
  const int k = a.k;
  const int last = k - 1 - 32 * (E - 1);    // lane of entry k - 1
  const int b = __ldg(a.sel + (size_t)qi * a.nprobe + p);
  const int fill = (b >= 0 && b < a.nb) ? min(max(__ldg(a.fills + b), 0), a.bc) : 0;
  const int r0 = blockIdx.y * a.rows_per_split;
  const int r1 = min(fill, r0 + a.rows_per_split);
  const int n_chunks = a.row_bytes / 16;
  float val[E];
  int id[E];
#pragma unroll
  for (int e = 0; e < E; e++) { val[e] = neg_inf(); id[e] = NO_ID; }
  float thr_v = neg_inf();
  int thr_i = NO_ID;
  for (int slot = r0 + warp; slot < r1; slot += WARPS) {
    const size_t pos = (size_t)b * a.bc + slot;
    int rid = NO_ID;
    size_t at = pos;
    float scale = 1.f;
    if constexpr (GATHER) {
      rid = __ldg(a.ids + pos);
      if (rid < 0) continue;                // warp-uniform: one slot a warp
      at = (size_t)rid;
      if (DT == DT_I4) scale = __ldg(a.scales + rid);
    }
    const float sqn = a.euclid ? __ldg(a.sq + pos) : 0.f;
    float s[1];
    row_keys<DT, 1>(reinterpret_cast<const uint4*>(a.rows + at * a.row_bytes), n_chunks,
                    qs, qsum8, a.d_pad, lane, scale, sqn, a.euclid, s);
    if (s[0] >= thr_v) {  // warp-uniform: every lane holds s and the threshold
      if constexpr (!GATHER) rid = __ldg(a.ids + pos);
      if (rid >= 0 && before(s[0], rid, thr_v, thr_i)) {
        warp_insert<E>(val, id, s[0], rid, k, lane);
        thr_v = __shfl_sync(FULL, val[E - 1], last);
        thr_i = __shfl_sync(FULL, id[E - 1], last);
      }
    }
  }

  // the block's eight lists -> one, in warp 0
#pragma unroll
  for (int e = 0; e < E; e++) {
    wk[warp * 32 * E + e * 32 + lane] = val[e];
    wi[warp * 32 * E + e * 32 + lane] = id[e];
  }
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < WARPS; w++) {
    for (int j = 0; j < k; j++) {
      const float c = wk[w * 32 * E + j];
      const int ci = wi[w * 32 * E + j];
      if (!before(c, ci, thr_v, thr_i)) break;  // the list is sorted
      warp_insert<E>(val, id, c, ci, k, lane);
      thr_v = __shfl_sync(FULL, val[E - 1], last);
      thr_i = __shfl_sync(FULL, id[E - 1], last);
    }
  }
  const size_t o = ((size_t)qi * a.nprobe * gridDim.y + (size_t)p * gridDim.y +
                    blockIdx.y) * k;
#pragma unroll
  for (int e = 0; e < E; e++) {
    const int j = e * 32 + lane;
    if (j < k) {
      a.cand_keys[o + j] = val[e];
      a.cand_ids[o + j] = id[e];
    }
  }
}

// The bucketized layout's probe (f32 / bf16 buckets, k <= 32).
template <int DT>
__global__ void __launch_bounds__(THREADS) ivf_scan_kernel(IvfArgs a) {
  probe_bucket<DT, 1, false>(a);
}

// ---- The gather layout: rows gathered by id from the store's flat matrix ----
//
// Int8 and int4 (and bf16) stores keep no bucketized copy of their rows:
// the index holds only its (nb, bc) id table, and a probe reads each live
// row of a probed bucket from the store's (N_pad, row_bytes) matrix at
// its id. This replaces the plain probe
// (ops/ivf_scan.py::ivf_probe_topk_gather: per probe a torch gather of
// every slot, a widened f32 copy, a bmm and a sort-based merge, ~20
// launches a probe), which is launch-bound.
//
// What bounds it on this card. At batch 16, nprobe 32 and buckets of 2048
// slots about half full (8,388,608 int8 rows of 768 over 8,192 clusters) a
// call reads ~0.5M live rows of 768 B, 403 MB, ~0.12 ms at 3.35 TB/s: the
// bytes of the rows, each read once for every query that probes its
// bucket, bound it, and the rows lie scattered, 768 contiguous bytes each.
//
// What the design does about it: the bucketized probe's grid and lists
// (probe_bucket above), with the row's address taken from its id.
//  * A block's warps walk the bucket's slots below its fill count, read a
//    slot's id (one load the warp shares), skip an empty one, and score
//    the row with 16-byte loads (row_keys: int8 / int4 components widened
//    in registers against the query in shared memory, rounded to bf16 by
//    the wrapper; every product accumulates in f32; int8 keys stay raw
//    sums, the x127 scale being the caller's to divide; int4 keys take the
//    row's scale and fold the nibble offset of 8 out, as the flat scan).
//  * Lists in registers, key descending then id ascending: one entry a
//    lane for k <= 32, two (warp_insert<2>) for 32 < k <= 64 (a refine's
//    4k candidates at k <= 16).
//  * The (query, probe, split) lists merge in a second launch: merge_small_k
//    for k <= 32, merge_topk_kernel past it. Ids are distinct across a
//    query's probes (a row is in one bucket), as both merges ask.
template <int DT, int E>
__global__ void __launch_bounds__(THREADS) ivf_gather_kernel(IvfArgs a) {
  probe_bucket<DT, E, true>(a);
}

template <typename Kernel>
static cudaError_t launch_probe(Kernel kernel, const IvfArgs& a, int splits, size_t smem,
                                cudaStream_t st) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kernel<<<dim3((unsigned)a.Q * a.nprobe, splits), THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// Shared memory of a probe block: the query, the warps' lists, 8 x sum(q).
static size_t probe_smem(int d_pad, int E) {
  return (size_t)d_pad * 4 + (size_t)WARPS * 32 * E * 8 + 16;
}

static IvfArgs probe_args(const float* q, int Q, int d_pad, const void* rows, int row_bytes,
                          int nb, int bc, const int* sel, int nprobe, const int* fills,
                          const int* ids, int k, int splits, float* cand_keys,
                          int* cand_ids) {
  IvfArgs a;
  a.q = q; a.Q = Q; a.d_pad = d_pad; a.nprobe = nprobe; a.nb = nb; a.bc = bc;
  a.row_bytes = row_bytes;
  a.rows_per_split = (bc + splits - 1) / splits;
  a.rows = static_cast<const uint8_t*>(rows);
  a.sel = sel; a.fills = fills; a.ids = ids; a.sq = nullptr; a.scales = nullptr;
  a.euclid = 0; a.k = k;
  a.cand_keys = cand_keys; a.cand_ids = cand_ids;
  return a;
}

// q: (Q, d_pad) f32, already rounded to the bucket type. buckets: (nb, bc,
// d_pad) of dtype (0 f32, 1 bf16). sel (Q, nprobe), fills (nb,), ids (nb,
// bc) int32; sq (nb, bc) f32 when euclid, else null. cand_*: (Q, nprobe *
// splits, k) scratch. out_*: (Q, k), ids -1 where the key is -inf.
extern "C" int vdb_ivf_topk(const float* q, int Q, int d_pad, const void* buckets,
                            int dtype, int nb, int bc, const int* sel, int nprobe,
                            const int* fills, const int* ids, const float* sq,
                            int euclid, int k, int splits, float* cand_keys,
                            int* cand_ids, float* out_keys, int* out_ids, void* stream) {
  const int elem = dtype == DT_F32 ? 4 : 2;
  if (k < 1 || k > IVF_MAX_K || Q < 1 || nprobe < 1 || nb < 1 || bc < 1 ||
      splits < 1 || splits > 65535 || (d_pad * elem) % 16 || (euclid && !sq) ||
      (dtype != DT_F32 && dtype != DT_BF16))
    return cudaErrorInvalidValue;
  IvfArgs a = probe_args(q, Q, d_pad, buckets, d_pad * elem, nb, bc, sel, nprobe, fills, ids,
                         k, splits, cand_keys, cand_ids);
  a.sq = sq; a.euclid = euclid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = probe_smem(d_pad, 1);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = dtype == DT_F32
      ? launch_probe(ivf_scan_kernel<DT_F32>, a, splits, smem, st)
      : launch_probe(ivf_scan_kernel<DT_BF16>, a, splits, smem, st);
  if (err != cudaSuccess) return err;
  return launch_merge_small(cand_keys, cand_ids, Q, nprobe * splits * k, k, out_keys, out_ids,
                            -1, st);
}

template <int DT>
static cudaError_t launch_gather(const IvfArgs& a, int splits, size_t smem, cudaStream_t st) {
  return a.k > 32 ? launch_probe(ivf_gather_kernel<DT, 2>, a, splits, smem, st)
                  : launch_probe(ivf_gather_kernel<DT, 1>, a, splits, smem, st);
}

// q: (Q, d_pad) f32, rounded to bf16 by the caller (cosine / dot keys).
// db: (N_pad, row_bytes) rows of dtype (1 bf16, 2 int8, 3 int4: d_pad / 2
// bytes, two components a byte), 16-byte aligned; scales (N_pad,) f32 for
// int4, else null. sel (Q, nprobe), fills (nb,), ids (nb, bc) int32.
// cand_*: (Q, nprobe * splits, k) scratch. out_*: (Q, k), keys descending
// then ids ascending, ids -1 where the key is -inf. k <= 64; keys of int8
// rows are the raw sums.
extern "C" int vdb_ivf_gather_topk(const float* q, int Q, int d_pad, const void* db,
                                   int dtype, const float* scales, int nb, int bc,
                                   const int* sel, int nprobe, const int* fills,
                                   const int* ids, int k, int splits, float* cand_keys,
                                   int* cand_ids, float* out_keys, int* out_ids,
                                   void* stream) {
  const int row_bytes = dtype == DT_BF16 ? d_pad * 2 : dtype == DT_I8 ? d_pad : d_pad / 2;
  if (k < 1 || k > GATHER_MAX_K || Q < 1 || nprobe < 1 || nb < 1 || bc < 1 || splits < 1 ||
      splits > 65535 || d_pad % 2 || row_bytes % 16 ||
      (dtype != DT_BF16 && dtype != DT_I8 && dtype != DT_I4) || (dtype == DT_I4 && !scales))
    return cudaErrorInvalidValue;
  IvfArgs a = probe_args(q, Q, d_pad, db, row_bytes, nb, bc, sel, nprobe, fills, ids, k,
                         splits, cand_keys, cand_ids);
  a.scales = scales;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = probe_smem(d_pad, k > 32 ? 2 : 1);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = dtype == DT_I8    ? launch_gather<DT_I8>(a, splits, smem, st)
                    : dtype == DT_I4  ? launch_gather<DT_I4>(a, splits, smem, st)
                                      : launch_gather<DT_BF16>(a, splits, smem, st);
  if (err != cudaSuccess) return err;
  const int n_cand = nprobe * splits * k;
  if (k <= 32)
    return launch_merge_small(cand_keys, cand_ids, Q, n_cand, k, out_keys, out_ids, -1, st);
  return launch_merge(cand_keys, cand_ids, Q, n_cand, k, nullptr, nullptr, out_keys, out_ids,
                      -1, st);
}

// The merge alone: cand_*: (Q, n_cand) candidates, out_*: (Q, k), k <= 32;
// ids empty_id where the key is -inf.
extern "C" int vdb_merge_small_k(const float* cand_keys, const int* cand_ids, int Q, int n_cand,
                                 int k, float* out_keys, int* out_ids, int empty_id,
                                 void* stream) {
  return launch_merge_small(cand_keys, cand_ids, Q, n_cand, k, out_keys, out_ids, empty_id,
                            static_cast<cudaStream_t>(stream));
}
