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
// hold it against its plain version).

#include "topk_common.cuh"

#define IVF_MAX_K 32

struct IvfArgs {
  const float* q;           // (Q, d_pad) f32
  int Q, d_pad, nprobe, nb, bc, row_bytes, rows_per_split;
  const uint8_t* buckets;   // (nb, bc) rows of row_bytes
  const int* sel;           // (Q, nprobe)
  const int* fills;         // (nb,)
  const int* ids;           // (nb, bc), -1 in empty slots
  const float* sq;          // (nb, bc) squared norms, euclidean only
  int euclid, k;
  float* cand_keys;         // (Q, nprobe * splits, k)
  int* cand_ids;
};

// grid (Q * nprobe, splits): block (q * nprobe + p, s) scores rows
// [s * rows_per_split, (s + 1) * rows_per_split) of bucket sel[q, p], up to
// its fill count, and writes one sorted list of k candidates.
template <int DT>
__global__ void __launch_bounds__(THREADS) ivf_scan_kernel(IvfArgs a) {
  extern __shared__ float smem[];
  float* qs = smem;                         // the query, d_pad floats
  float* wk = qs + a.d_pad;                 // WARPS lists of 32 keys
  int* wi = reinterpret_cast<int*>(wk + WARPS * 32);
  const int qi = blockIdx.x / a.nprobe;
  const int p = blockIdx.x - qi * a.nprobe;
  for (int i = threadIdx.x; i < a.d_pad; i += THREADS)
    qs[i] = a.q[(size_t)qi * a.d_pad + i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = a.k;
  const int b = __ldg(a.sel + (size_t)qi * a.nprobe + p);
  const int fill = (b >= 0 && b < a.nb) ? min(max(__ldg(a.fills + b), 0), a.bc) : 0;
  const int r0 = blockIdx.y * a.rows_per_split;
  const int r1 = min(fill, r0 + a.rows_per_split);
  const int n_chunks = a.row_bytes / 16;
  float val = neg_inf(), thr_v = neg_inf();
  int id = NO_ID, thr_i = NO_ID;
  for (int slot = r0 + warp; slot < r1; slot += WARPS) {
    const size_t pos = (size_t)b * a.bc + slot;
    const float sqn = a.euclid ? __ldg(a.sq + pos) : 0.f;
    float s[1];
    row_keys<DT, 1>(reinterpret_cast<const uint4*>(a.buckets + pos * a.row_bytes),
                    n_chunks, qs, nullptr, a.d_pad, lane, 1.f, sqn, a.euclid, s);
    if (s[0] >= thr_v) {  // warp-uniform: every lane holds s and the threshold
      const int rid = __ldg(a.ids + pos);
      if (rid >= 0 && before(s[0], rid, thr_v, thr_i)) {
        warp_insert(val, id, s[0], rid, k, lane);
        thr_v = __shfl_sync(FULL, val, k - 1);
        thr_i = __shfl_sync(FULL, id, k - 1);
      }
    }
  }

  // the block's eight lists -> one, in warp 0
  wk[warp * 32 + lane] = val;
  wi[warp * 32 + lane] = id;
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < WARPS; w++) {
    for (int j = 0; j < k; j++) {
      const float c = wk[w * 32 + j];
      const int ci = wi[w * 32 + j];
      if (!before(c, ci, thr_v, thr_i)) break;  // the list is sorted
      warp_insert(val, id, c, ci, k, lane);
      thr_v = __shfl_sync(FULL, val, k - 1);
      thr_i = __shfl_sync(FULL, id, k - 1);
    }
  }
  if (lane < k) {
    const size_t o = ((size_t)qi * a.nprobe * gridDim.y + (size_t)p * gridDim.y +
                      blockIdx.y) * k + lane;
    a.cand_keys[o] = val;
    a.cand_ids[o] = id;
  }
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
  IvfArgs a;
  a.q = q; a.Q = Q; a.d_pad = d_pad; a.nprobe = nprobe; a.nb = nb; a.bc = bc;
  a.row_bytes = d_pad * elem;
  a.rows_per_split = (bc + splits - 1) / splits;
  a.buckets = static_cast<const uint8_t*>(buckets);
  a.sel = sel; a.fills = fills; a.ids = ids; a.sq = sq;
  a.euclid = euclid; a.k = k;
  a.cand_keys = cand_keys; a.cand_ids = cand_ids;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)d_pad * 4 + WARPS * 32 * 8;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)Q * nprobe, splits);
  if (dtype == DT_F32) {
    cudaFuncSetAttribute(ivf_scan_kernel<DT_F32>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    ivf_scan_kernel<DT_F32><<<grid, THREADS, smem, st>>>(a);
  } else {
    cudaFuncSetAttribute(ivf_scan_kernel<DT_BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    ivf_scan_kernel<DT_BF16><<<grid, THREADS, smem, st>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge_small(cand_keys, cand_ids, Q, nprobe * splits * k, k, out_keys, out_ids,
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
