// Exact flat top-k scan for Hopper (sm_90a): scores computed in the kernel
// body, then the top-k of each query.
//
// Replaces the two TPU kernels behind one Pallas call site,
// tpu_vector_db/ops/pallas_scan.py:
//   _scan_kernel       (k <= 32) -> scan_small_k (small Q) or
//                                   scan_small_k_tile (larger Q),
//                                   then merge_small_k
//   _scan_kernel_bigk  (k > 32)  -> up to k = 64 on the tile,
//                                   scan_small_k_tile with lists of two
//                                   entries a lane, then merge_topk_kernel;
//                                   else the same two scoring kernels with a
//                                   "store keys" epilogue, then the radix
//                                   select of radix_select.cuh
// The TPU big-k kernel stops at k = 1024; this one takes any k, so the
// store serves every k the JAX store serves (its XLA scan takes k > 1024).
// The wrapper (ops/cuda_scan.py::_launch_plan) picks the design from Q, k
// and the row type.
//
// What bounds it on this card, at 1M x 768 rows:
//  * Q = 1: every stored byte is read once for 2*d operations per row,
//    far below the card's ratio of operations to bytes: bytes bound every
//    type (f32 3.1 GB, about 0.92 ms at 3.35 TB/s; bf16 0.46 ms; int8
//    0.23 ms; int4 0.12 ms).
//  * Q = 64: f32 needs 2*64*N*d = 98 GFLOP on the CUDA cores (67 TFLOP/s):
//    1.47 ms, bound by operations, just above its 0.92 ms of bytes. bf16,
//    int8 and int4 take the same 98 GFLOP on the tensor cores (989
//    TFLOP/s, 0.1 ms) and stay bound by their bytes.
//  * k > 32 adds the key scratch: 4 bytes a (query, row), written once and
//    read by four passes of the select (256 MB a pass at Q = 64 and 1M
//    rows, about 0.08 ms each), and one shared-memory atomic a live key in
//    the first pass.
//
// What the design does about it:
//  * Blocks run in parallel with no carry (the TPU walks row blocks in
//    sequence and carries its top-k across grid steps): a grid of
//    (query tile x row split), each block scanning its own contiguous row
//    range; k <= 32 then merges the splits' candidates in a second launch.
//  * small Q (scan_small_k, bytes bound): one warp scores one row at a time
//    against up to 8 queries in shared memory. Each lane loads 16-byte
//    chunks of the row (coalesced, up to 8 in flight per lane) and widens
//    them to f32; a butterfly of shuffles gives every lane the row's keys.
//    Rows past `count` are never read, and rows the filter mask drops are
//    skipped before their bytes are loaded.
//  * larger Q (scan_small_k_tile): a block holds a tile of up to 64 queries
//    and walks its split in tiles of 256 rows, so each stored byte leaves
//    device memory once per 64 queries, not once per 8. Row and query
//    chunks (128 bytes of an f32 or bf16 row, 64 or 32 of an int8 or int4
//    one) are staged into shared memory by cp.async, 3 to 6 stages deep
//    across tile boundaries, rows padded by 16 bytes so that neither the
//    f32 loads nor ldmatrix meet bank conflicts; rows past the split are
//    zero-filled and never selected. The chunk is as wide as shared
//    memory allows: the copies cost a fixed time per stage (256 row
//    pieces), whatever their bytes, so fewer and wider stages run faster.
//      - f32: register-tiled FFMA. Each thread keeps 8 rows x up to 8
//        queries of f32 sums and reads both operands as float4 fragments,
//        so each shared-memory load feeds 8 to 32 FMAs (sums stay f32).
//      - bf16, int8, int4: mma.sync m16n8k16 bf16 -> f32 on the tensor
//        cores, rows on the M side and the bf16-rounded queries on the N
//        side, fragments by ldmatrix. int8 (-127..127) and int4 nibbles
//        (0..15) are exact in bf16: they stay packed in shared memory
//        (half or a quarter of the bytes) and are widened in registers
//        once per row, by the one warp that owns the row. int4 byte j
//        holds component j (low nibble) and j + d/2 (high), so a stage's
//        low nibbles meet q[:, :d/2] and its high nibbles q[:, d/2:].
//    After the last chunk of a row tile each thread writes its keys
//    (euclidean 2s - |x|^2, int4 (s - 8 sum q) * scale, -inf for masked
//    rows and rows past the split) to shared memory, and each warp walks
//    the tile's keys of its queries in rising row order, 32 at a time:
//    a ballot against the query's k-th best (the TPU kernel's threshold
//    skip) and an insert for each passing row. The lists stay in
//    registers across tiles; the block writes one list per query.
//  * 32 < k <= 64 on the tile: the same lists with two entries a lane
//    (lane j holds entries j and 32 + j), so the keys never leave the
//    block: a key scratch would be written once and read four times by
//    the select, 1.7x the stored rows' bytes for int8 rows at Q = 64.
//    merge_topk_kernel combines the splits' lists.
//  * any other k > 32: the same two scoring kernels, picked by the same
//    rule, with the epilogue templated: in place of the per-warp lists
//    each block writes its keys, transformed as above, to a (Q, chunk
//    rows) f32 key
//    scratch in device memory, 16-byte runs along rows (the row loop
//    stages a tile's keys in shared memory first). A radix select then
//    takes each query's exact top-k in a few passes over the keys, with
//    no sort of candidates; ties at the k-th key go to the lowest ids
//    (radix_select.cuh). The scratch stays within the wrapper's budget:
//    past it the rows are cut into chunks, each chunk's top-k is one
//    candidate list, and merge_topk_kernel combines the lists.
//  * k <= 32: merge_small_k merges the splits' lists, one block of warps a
//    query, each warp a register list over its slice of the candidates, a
//    block-wide bound on the k-th key and a merge tree of the warp lists
//    (topk_common.cuh). The tile's lists at k <= 64 and k > 32 chunks:
//    merge_topk_kernel keeps the sorted best next_pow2(k) plus an equal
//    candidate area (at least 4096 slots), in shared memory up to 16384
//    slots and in device-memory scratch past that.
//  * Order is key descending, then id ascending, everywhere. The TPU
//    kernel's first-occurrence rule gives exactly this because its ids rise
//    in scan order; with the explicit rule the result does not depend on
//    the split count, the chunking or the design.
//
// C interface, loaded with ctypes: vdb_flat_topk returns cudaGetLastError()
// after its launches (or cudaErrorInvalidValue for arguments it refuses).
// It allocates nothing: the caller passes outputs, candidate lists and
// the scratch vdb_flat_scratch_bytes asks for.

#include <type_traits>

#include "radix_select.cuh"

struct ScanArgs {
  const float* q;
  const uint16_t* q16;  // the same queries as bf16 (tile design, lossy rows)
  int Q, d_pad;
  const uint8_t* db;
  int row_bytes, count;
  const float* sq;
  const float* mask;
  const float* scales;
  int euclid, k, rows_per_split;
  int row_base;         // first row of the launch's range; `count` ends it
  float* cand_keys;     // k <= 32: candidate lists
  int* cand_ids;
  float* keys_out;      // k > 32: (Q, key_ld) key scratch, rows from row_base
  int key_ld;
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

#define TILE_ROWS 256
#define MAX_K_LISTS 64                // the tile's lists: two entries a lane
#define STAGE_ROW 144                 // bytes of a staged row: 128 + 16 of pad
#define KEY_STRIDE (TILE_ROWS + 4)    // floats of a query's keys in a tile

// k > 32: the keys of rows [row0, r1) of one row tile, QT queries x
// KEY_STRIDE floats in shared memory, into the key scratch in 16-byte runs
// along rows (threads 64j .. 64j + 63 on the tile's 64 four-row groups).
// RAW: K holds the tile's dot products, so tile_select's transforms come
// first (int4 offset and scale, euclidean 2s - |x|^2, -inf for masked rows).
template <int DT, int QT, bool RAW>
__device__ __forceinline__ void store_keys(const ScanArgs& a, const float* K,
                                           const float* qsum8, int q0, int row0, int r1) {
  const int row = row0 + 4 * (threadIdx.x & 63);
  if (row >= r1) return;
  float scl[4], sqn[4];
  bool live[4];
#pragma unroll
  for (int e = 0; e < 4; e++) {
    const int r = row + e;
    live[e] = r < r1 && (!RAW || !a.mask || __ldg(a.mask + r) > 0.5f);
    scl[e] = (RAW && DT == DT_I4 && live[e]) ? __ldg(a.scales + r) : 1.f;
    sqn[e] = (RAW && a.euclid && live[e]) ? __ldg(a.sq + r) : 0.f;
  }
  for (int t = threadIdx.x >> 6; t < QT && q0 + t < a.Q; t += THREADS / 64) {
    const float4 v = lds4(K + t * KEY_STRIDE + (row - row0));
    float x[4] = {v.x, v.y, v.z, v.w};
    if (RAW) {
      const float qs8 = DT == DT_I4 ? qsum8[t] : 0.f;
#pragma unroll
      for (int e = 0; e < 4; e++) {
        if (DT == DT_I4) x[e] = (x[e] - qs8) * scl[e];  // offset 8 folded out
        if (a.euclid) x[e] = 2.f * x[e] - sqn[e];       // rank-equivalent L2 key
        if (!live[e]) x[e] = neg_inf();
      }
    }
    float* dst = a.keys_out + (size_t)(q0 + t) * a.key_ld + (row - a.row_base);
    if (row + 4 <= r1) {
      *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; e++)
        if (row + e < r1) dst[e] = x[e];
    }
  }
}

// The row loop: each warp takes every WARPS-th row of the split (with
// STORE, of each tile of TILE_ROWS rows).
//  * STORE false (k <= 32): per-warp sorted lists in registers.
//    Candidates out: (Q, splits * WARPS, k).
//  * STORE true (k > 32): lane t keeps query t's key of each row in shared
//    memory (-inf for masked rows); after each tile the block writes the
//    tile's keys to the key scratch (store_keys).
// One query (batch 1, every row type) is bounded to LOOP_MIN_BLOCKS blocks
// an SM, at most 64 registers a thread: the wrapper's launch
// (cuda_scan._TARGET_BLOCKS) is then one wave of 4 blocks on each SM, not
// 1.33 waves of 3. More queries keep the registers they need.
#define LOOP_MIN_BLOCKS 4

template <int DT, int QT>
__device__ __forceinline__ void loop_row_keys(const ScanArgs& a, int r, int n_chunks,
                                              const float* qs, const float* qsum8, int lane,
                                              float (&s)[QT]) {
  const float scale = (DT == DT_I4) ? __ldg(a.scales + r) : 1.f;
  const float sqn = a.euclid ? __ldg(a.sq + r) : 0.f;
  row_keys<DT, QT>(reinterpret_cast<const uint4*>(a.db + (size_t)r * a.row_bytes),
                   n_chunks, qs, qsum8, a.d_pad, lane, scale, sqn, a.euclid, s);
}

template <int DT, int QT, bool STORE>
__global__ void __launch_bounds__(THREADS, QT == 1 ? LOOP_MIN_BLOCKS : 1) scan_small_k(ScanArgs a) {
  extern __shared__ __align__(16) float lsmem[];
  float* qs = lsmem;
  float* qsum8 = lsmem + QT * a.d_pad;
  float* Ks = qsum8 + 8;  // STORE: QT x KEY_STRIDE (16-byte aligned: d_pad % 4 == 0)
  const int q0 = blockIdx.x * QT;
  load_queries<DT, QT>(a, q0, qs, qsum8);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = a.row_base + blockIdx.y * a.rows_per_split;
  const int r1 = min(a.count, r0 + a.rows_per_split);
  const int n_chunks = a.row_bytes / 16;
  if constexpr (STORE) {
    for (int base = r0; base < r1; base += TILE_ROWS) {
      const int end = min(base + TILE_ROWS, r1);
      for (int r = base + warp; r < end; r += WARPS) {
        if (a.mask && __ldg(a.mask + r) <= 0.5f) {
          if (lane < QT) Ks[lane * KEY_STRIDE + r - base] = neg_inf();
          continue;
        }
        float s[QT];
        loop_row_keys<DT, QT>(a, r, n_chunks, qs, qsum8, lane, s);
        float mine = s[0];  // lane t keeps query t's key
#pragma unroll
        for (int t = 1; t < QT; t++) if (lane == t) mine = s[t];
        if (lane < QT) Ks[lane * KEY_STRIDE + r - base] = mine;
      }
      __syncthreads();
      store_keys<DT, QT, false>(a, Ks, qsum8, q0, base, end);
      __syncthreads();
    }
  } else {
    const int k = a.k;
    float val[QT], thr[QT];
    int id[QT];
#pragma unroll
    for (int t = 0; t < QT; t++) { val[t] = neg_inf(); thr[t] = neg_inf(); id[t] = 0; }
    for (int r = r0 + warp; r < r1; r += WARPS) {
      if (a.mask && __ldg(a.mask + r) <= 0.5f) continue;
      float s[QT];
      loop_row_keys<DT, QT>(a, r, n_chunks, qs, qsum8, lane, s);
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
}

// ---- larger Q: the tile design ----
//
// A block of 8 warps scores a tile of QT queries against its split's rows,
// TILE_ROWS at a time, in chunks of each row: 32 f32 or 64 bf16 components
// (128 bytes), 64 int8 bytes, or 32 int4 bytes (64 components). Shared
// memory: a ring of tile_stages slots of [QT query rows | TILE_ROWS stored
// rows], the tile's keys (QT x KEY_STRIDE f32) and per query 8 * sum(q)
// (int4).

// bytes of one stored row that one stage copies
template <int DT>
__host__ __device__ constexpr int stage_row_bytes() {
  return DT == DT_I8 ? 64 : DT == DT_I4 ? 32 : 128;
}
template <int DT>
__host__ __device__ constexpr bool widens() { return DT == DT_I8 || DT == DT_I4; }
// Row strides in a ring slot, padded by 16 bytes so that the 8 rows of an
// ldmatrix (or the 8 lanes of an f32 LDS.128) meet 8 distinct bank
// groups. Queries of the widened types have 160 so that a half-warp's
// 8-byte B-fragment loads (4 queries x 4 lanes) do too.
template <int DT>
__host__ __device__ constexpr int ring_row_bytes() { return stage_row_bytes<DT>() + 16; }
template <int DT>
__host__ __device__ constexpr int query_row_bytes() { return widens<DT>() ? 160 : STAGE_ROW; }
// stored components a stage covers (int4: 32 bytes = 32 low + 32 high)
template <int DT>
__host__ __device__ constexpr int stage_comps() { return DT == DT_F32 ? 32 : 64; }

template <int DT, int QT>
__host__ __device__ constexpr int slot_bytes() {
  return QT * query_row_bytes<DT>() + TILE_ROWS * ring_row_bytes<DT>();
}
// the tile's keys and 8 * sum(q)
template <int QT>
__host__ __device__ constexpr size_t key_bytes() { return (size_t)QT * (KEY_STRIDE + 1) * 4; }
// ring depth: as deep as shared memory allows beside the keys, up to 6
template <int DT, int QT>
__host__ __device__ constexpr int tile_stages() {
  return (MAX_SMEM - key_bytes<QT>()) / slot_bytes<DT, QT>() < 6
             ? (int)((MAX_SMEM - key_bytes<QT>()) / slot_bytes<DT, QT>())
             : 6;
}

template <int DT, int QT>
__host__ __device__ constexpr size_t tile_smem_bytes() {
  return (size_t)tile_stages<DT, QT>() * slot_bytes<DT, QT>() + key_bytes<QT>();
}

// Start the copies of pipeline step s (row tile s / n_chunks, chunk
// s % n_chunks) into a ring slot. Queries past Q and rows at or past r1
// are zero-filled without a read.
template <int DT, int QT>
__device__ __forceinline__ void tile_copy(const ScanArgs& a, int q0, int r0, int r1,
                                           int n_chunks, int s, uint8_t* slot) {
  const int t = s / n_chunks, c = s - t * n_chunks;
  for (int i = threadIdx.x; i < QT * 8; i += THREADS) {
    const int qi = i >> 3, part = i & 7;
    const bool ok = q0 + qi < a.Q;
    const size_t qrow = (size_t)(ok ? q0 + qi : 0) * a.d_pad;
    const void* src;
    if (DT == DT_F32) {
      src = a.q + qrow + c * 32 + part * 4;
    } else if (DT == DT_I4) {  // low components of the chunk, then high
      src = a.q16 + qrow + (part >> 2) * (a.d_pad >> 1) + c * 32 + (part & 3) * 8;
    } else {
      src = a.q16 + qrow + c * 64 + part * 8;
    }
    cp_async16(slot + qi * query_row_bytes<DT>() + part * 16, src, ok);
  }
  constexpr int PIECES = stage_row_bytes<DT>() / 16;
  uint8_t* xs = slot + QT * query_row_bytes<DT>();
  const int row0 = r0 + t * TILE_ROWS;
  for (int i = threadIdx.x; i < TILE_ROWS * PIECES; i += THREADS) {
    const int ri = i / PIECES, part = i - ri * PIECES;
    const bool ok = row0 + ri < r1;
    const uint8_t* src = a.db + (size_t)(ok ? row0 + ri : 0) * a.row_bytes +
                         c * stage_row_bytes<DT>() + part * 16;
    cp_async16(xs + ri * ring_row_bytes<DT>() + part * 16, src, ok);
  }
}

// Bytes j, j + 1 of w (int8) as an exact bf16 pair, byte j in the low half.
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t w, int j) {
  return __byte_perm(__float_as_uint((float)(int8_t)(w >> (8 * j))),
                     __float_as_uint((float)(int8_t)(w >> (8 * j + 8))), 0x7632);
}

// Two nibbles, at bits 0-3 and 16-19 of pair (all else zero), as an exact
// bf16 pair: 128 + n has the bf16 exponent of 128 and n in its mantissa,
// and an fma subtracts the 128 exactly.
__device__ __forceinline__ uint32_t nib2_bf16(uint32_t pair) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d) : "r"(pair | 0x43004300u), "r"(0x3f803f80u), "r"(0xc300c300u));
  return d;
}

// f32 rows: register-tiled FFMA. Warps are 2 (queries) x 4 (rows of 64);
// lane (lq, lr) = (lane / 8, lane % 8) sums queries lq + 4j (j < QT/8) of
// its warp's half against rows lr + 8i (i < 8) of its warp's 64.
template <int QT>
struct FmaTile {
  static constexpr int JQ = QT / 8;
  float acc[JQ][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < JQ; j++)
#pragma unroll
      for (int i = 0; i < 8; i++) acc[j][i] = 0.f;
  }

  __device__ __forceinline__ void step(const uint8_t* qs, const uint8_t* xs, int warp,
                                       int lane) {
    constexpr int RS = STAGE_ROW / 4;  // row stride in floats
    const float* Q = reinterpret_cast<const float*>(qs) + ((warp >> 2) * 4 * JQ + (lane >> 3)) * RS;
    const float* X = reinterpret_cast<const float*>(xs) + ((warp & 3) * 64 + (lane & 7)) * RS;
#pragma unroll
    for (int c4 = 0; c4 < 32; c4 += 4) {
      float4 qv[JQ];
#pragma unroll
      for (int j = 0; j < JQ; j++) qv[j] = lds4(Q + j * 4 * RS + c4);
#pragma unroll
      for (int i = 0; i < 8; i++) {
        const float4 xv = lds4(X + i * 8 * RS + c4);
#pragma unroll
        for (int j = 0; j < JQ; j++) acc[j][i] = dot4(qv[j], xv.x, xv.y, xv.z, xv.w, acc[j][i]);
      }
    }
  }

  __device__ __forceinline__ void store(float* K, int warp, int lane) const {
    float* base = K + ((warp >> 2) * 4 * JQ + (lane >> 3)) * KEY_STRIDE + (warp & 3) * 64 + (lane & 7);
#pragma unroll
    for (int j = 0; j < JQ; j++)
#pragma unroll
      for (int i = 0; i < 8; i++) base[j * 4 * KEY_STRIDE + i * 8] = acc[j][i];
  }
};

// bf16, int8, int4 rows: mma.sync m16n8k16 bf16 -> f32. Warp w takes rows
// 32w .. 32w + 31 (two m16 tiles) against all QT queries (QT/8 n8 tiles).
//  * bf16: A and B fragments by ldmatrix from the staged rows and queries.
//  * int8 / int4: ldmatrix on the stored bytes gives lane (g, t) bytes
//    4t .. 4t + 3 of rows g and g + 8 in each 16-byte column; they are
//    widened to bf16 in registers, once per row (each row has one warp).
//    The fragment's k order is then 4t, 4t + 1 (a0/a1), 4t + 2, 4t + 3
//    (a2/a3) in place of 2t, 2t + 1, 2t + 8, 2t + 9; the sum does not
//    depend on k order, so B is loaded in the same order: one 8-byte load
//    of query components 4t .. 4t + 3.
template <int DT, int QT>
struct MmaTile {
  static constexpr int NT = QT / 8;
  static constexpr int QS = query_row_bytes<DT>();
  static constexpr int XS = ring_row_bytes<DT>();
  float acc[2][NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < 2; m++)
#pragma unroll
      for (int n = 0; n < NT; n++)
#pragma unroll
        for (int e = 0; e < 4; e++) acc[m][n][e] = 0.f;
  }

  // One k16 group against every query: B by 8-byte loads at query
  // component kb (k order 4t .. 4t + 3).
  __device__ __forceinline__ void mma_group(const uint8_t* qs, int kb, int lane,
                                            const uint32_t (&a0)[4], const uint32_t (&a1)[4]) {
#pragma unroll
    for (int n = 0; n < NT; n++) {
      const uint2 b = *reinterpret_cast<const uint2*>(
          qs + (n * 8 + (lane >> 2)) * QS + kb * 2 + (lane & 3) * 8);
      mma_bf16_16816(acc[0][n], a0, b.x, b.y);
      mma_bf16_16816(acc[1][n], a1, b.x, b.y);
    }
  }

  __device__ __forceinline__ void step(const uint8_t* qs, const uint8_t* xs, int warp,
                                       int lane) {
    // A: lane l addresses row l % 16 of the m16 tile at 16-byte column l / 16
    const uint8_t* xa = xs + (warp * 32 + (lane & 15)) * XS + (lane >> 4) * 16;
    if constexpr (DT == DT_BF16) {
      // B: lanes 0-7 / 8-15 give queries 0-7 at k-halves 0 / 1, lanes
      // 16-23 / 24-31 queries 8-15 at k-halves 0 / 1
      const uint8_t* qb = qs + ((lane & 7) + ((lane >> 4) << 3)) * QS + ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int kk = 0; kk < 4; kk++) {  // four k16 steps of 32 bytes
        uint32_t a[2][4];
        ldmatrix_x4(a[0], xa + kk * 32);
        ldmatrix_x4(a[1], xa + 16 * XS + kk * 32);
#pragma unroll
        for (int nb = 0; nb < NT / 2; nb++) {
          uint32_t b[4];
          ldmatrix_x4(b, qb + nb * 16 * QS + kk * 32);
#pragma unroll
          for (int m = 0; m < 2; m++) {
            mma_bf16_16816(acc[m][2 * nb], a[m], b[0], b[1]);
            mma_bf16_16816(acc[m][2 * nb + 1], a[m], b[2], b[3]);
          }
        }
      }
    } else if constexpr (DT == DT_I8) {
#pragma unroll
      for (int h = 0; h < 2; h++) {  // 32 stored bytes = two k16 groups
        uint32_t r[2][4], a[2][2][4];
#pragma unroll
        for (int m = 0; m < 2; m++) {
          ldmatrix_x4(r[m], xa + m * 16 * XS + h * 32);
#pragma unroll
          for (int g = 0; g < 2; g++) {  // r[m][2g]: row g, r[m][2g + 1]: row g + 8
            a[g][m][0] = i8x2_bf16(r[m][2 * g], 0);
            a[g][m][1] = i8x2_bf16(r[m][2 * g + 1], 0);
            a[g][m][2] = i8x2_bf16(r[m][2 * g], 2);
            a[g][m][3] = i8x2_bf16(r[m][2 * g + 1], 2);
          }
        }
        mma_group(qs, h * 32, lane, a[0][0], a[0][1]);
        mma_group(qs, h * 32 + 16, lane, a[1][0], a[1][1]);
      }
    } else {  // int4: low nibbles meet query components 0-31, high 32-63
      uint32_t r[2][4], a[4][2][4];
#pragma unroll
      for (int m = 0; m < 2; m++) {
        ldmatrix_x4(r[m], xa + m * 16 * XS);
#pragma unroll
        for (int g = 0; g < 2; g++) {
          const uint32_t w0 = r[m][2 * g], w8 = r[m][2 * g + 1];  // rows g, g + 8
          // low nibbles of bytes (0, 1) and (2, 3), then the high ones
          a[g][m][0] = nib2_bf16((w0 & 0xfu) | ((w0 << 8) & 0xf0000u));
          a[g][m][1] = nib2_bf16((w8 & 0xfu) | ((w8 << 8) & 0xf0000u));
          a[g][m][2] = nib2_bf16(((w0 >> 16) & 0xfu) | ((w0 >> 8) & 0xf0000u));
          a[g][m][3] = nib2_bf16(((w8 >> 16) & 0xfu) | ((w8 >> 8) & 0xf0000u));
          a[2 + g][m][0] = nib2_bf16(((w0 >> 4) & 0xfu) | ((w0 << 4) & 0xf0000u));
          a[2 + g][m][1] = nib2_bf16(((w8 >> 4) & 0xfu) | ((w8 << 4) & 0xf0000u));
          a[2 + g][m][2] = nib2_bf16(((w0 >> 20) & 0xfu) | ((w0 >> 12) & 0xf0000u));
          a[2 + g][m][3] = nib2_bf16(((w8 >> 20) & 0xfu) | ((w8 >> 12) & 0xf0000u));
        }
      }
#pragma unroll
      for (int g = 0; g < 4; g++) mma_group(qs, g * 16, lane, a[g][0], a[g][1]);
    }
  }

  // C fragment: lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 of
  // each m16 tile at queries 2t and 2t + 1 of each n8 tile.
  __device__ __forceinline__ void store(float* K, int warp, int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < 2; m++)
#pragma unroll
      for (int n = 0; n < NT; n++) {
        float* p = K + (n * 8 + 2 * t) * KEY_STRIDE + warp * 32 + m * 16 + g;
        p[0] = acc[m][n][0];
        p[KEY_STRIDE] = acc[m][n][1];
        p[8] = acc[m][n][2];
        p[KEY_STRIDE + 8] = acc[m][n][3];
      }
  }
};

// The tile's keys of this warp's QW queries, in rising row order, into its
// sorted lists of E entries a lane (warp_insert): 32 rows at a time, a
// ballot against each query's k-th best, then an insert for each row that
// still beats it.
template <int DT, int QW, int E>
__device__ __forceinline__ void tile_select(const ScanArgs& a, const float* K,
                                            const float* qsum8, int row0, int r1, int warp,
                                            int lane, float (&val)[QW][E], int (&id)[QW][E]) {
  constexpr int C = TILE_ROWS / 32;
  float scl[C], sqn[C];
  bool live[C];
#pragma unroll
  for (int c = 0; c < C; c++) {
    const int r = row0 + c * 32 + lane;
    live[c] = r < r1 && (!a.mask || __ldg(a.mask + r) > 0.5f);
    scl[c] = (DT == DT_I4 && live[c]) ? __ldg(a.scales + r) : 1.f;
    sqn[c] = (a.euclid && live[c]) ? __ldg(a.sq + r) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < QW; j++) {
    const int qq = warp * QW + j;
    const float qs8 = DT == DT_I4 ? qsum8[qq] : 0.f;
    float thr = kth_key<E>(val[j], a.k);
    float key[C];
    bool pass = false;
#pragma unroll
    for (int c = 0; c < C; c++) {
      key[c] = K[qq * KEY_STRIDE + c * 32 + lane];
      if (DT == DT_I4) key[c] = (key[c] - qs8) * scl[c];  // offset 8 folded out
      if (a.euclid) key[c] = 2.f * key[c] - sqn[c];       // rank-equivalent L2 key
      if (!live[c]) key[c] = neg_inf();
      pass |= key[c] > thr;
    }
    // after the first tiles almost no row beats the k-th best: one ballot
    if (!__any_sync(FULL, pass)) continue;
#pragma unroll
    for (int c = 0; c < C; c++) {
      // rows arrive in rising id order, so a key equal to the k-th best
      // loses to it: strict > is the (key, id) order here
      unsigned m = __ballot_sync(FULL, key[c] > thr);
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const float sk = __shfl_sync(FULL, key[c], src);
        if (sk > thr) {
          warp_insert<E>(val[j], id[j], sk, row0 + c * 32 + src, a.k, lane);
          thr = kth_key<E>(val[j], a.k);
        }
      }
    }
  }
}

// STORE false: candidates out (Q, splits, k), one list per (block, query),
// of E entries a lane: 1 for k <= 32, 2 for 32 < k <= 64. STORE true (any
// other k > 32): each row tile's keys to the key scratch (store_keys).
template <int DT, int QT, bool STORE, int E = 1>
__global__ void __launch_bounds__(THREADS, 1) scan_small_k_tile(ScanArgs a) {
  extern __shared__ __align__(16) uint8_t tsmem[];
  constexpr int SLOT = slot_bytes<DT, QT>();
  constexpr int STAGES = tile_stages<DT, QT>();
  constexpr int QW = QT / WARPS;
  float* K = reinterpret_cast<float*>(tsmem + STAGES * SLOT);
  float* qsum8 = K + QT * KEY_STRIDE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * QT;
  const int r0 = a.row_base + blockIdx.y * a.rows_per_split;
  const int r1 = min(a.count, r0 + a.rows_per_split);
  const int n_tiles = r1 > r0 ? (r1 - r0 + TILE_ROWS - 1) / TILE_ROWS : 0;
  const int n_chunks = a.d_pad / stage_comps<DT>();
  const int total = n_tiles * n_chunks;

  if (DT == DT_I4) {  // read by the same warp's epilogue, after barriers
#pragma unroll
    for (int j = 0; j < QW; j++) {
      const int qq = warp * QW + j;
      float s = 0.f;
      if (q0 + qq < a.Q)
        for (int c = lane; c < a.d_pad; c += 32) s += a.q[(size_t)(q0 + qq) * a.d_pad + c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
      if (lane == 0) qsum8[qq] = 8.f * s;
    }
  }
  float val[QW][E];
  int id[QW][E];
#pragma unroll
  for (int j = 0; j < QW; j++)
#pragma unroll
    for (int e = 0; e < E; e++) { val[j][e] = neg_inf(); id[j][e] = 0; }

  typename std::conditional<DT == DT_F32, FmaTile<QT>, MmaTile<DT, QT>>::type tile;
#pragma unroll
  for (int s = 0; s < STAGES - 1; s++) {
    if (s < total) tile_copy<DT, QT>(a, q0, r0, r1, n_chunks, s, tsmem + s * SLOT);
    cp_async_commit();
  }
  for (int s = 0; s < total; s++) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s has landed; every warp is done with step s - 1
    const int next = s + STAGES - 1;
    if (next < total)
      tile_copy<DT, QT>(a, q0, r0, r1, n_chunks, next, tsmem + (next % STAGES) * SLOT);
    cp_async_commit();
    const int t = s / n_chunks, c = s - t * n_chunks;
    const uint8_t* slot = tsmem + (s % STAGES) * SLOT;
    if (c == 0) tile.zero();
    tile.step(slot, slot + QT * query_row_bytes<DT>(), warp, lane);
    if (c == n_chunks - 1) {
      tile.store(K, warp, lane);
      __syncthreads();
      if constexpr (STORE)
        store_keys<DT, QT, true>(a, K, qsum8, q0, r0 + t * TILE_ROWS, r1);
      else
        tile_select<DT, QW, E>(a, K, qsum8, r0 + t * TILE_ROWS, r1, warp, lane, val, id);
    }
  }
  if constexpr (!STORE) {
#pragma unroll
    for (int j = 0; j < QW; j++) {
      const int qq = q0 + warp * QW + j;
#pragma unroll
      for (int e = 0; e < E; e++) {
        const int g = 32 * e + lane;  // entry g of the list
        if (qq < a.Q && g < a.k) {
          const size_t o = ((size_t)qq * gridDim.y + blockIdx.y) * a.k + g;
          a.cand_keys[o] = val[j][e];
          a.cand_ids[o] = id[j][e];
        }
      }
    }
  }
}

template <int DT, int QT, bool STORE>
static cudaError_t launch_loop(const ScanArgs& a, int splits, cudaStream_t st) {
  const size_t smem = (size_t)QT * a.d_pad * 4 + 32 + (STORE ? (size_t)QT * KEY_STRIDE * 4 : 0);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const dim3 grid((a.Q + QT - 1) / QT, splits);
  cudaFuncSetAttribute(scan_small_k<DT, QT, STORE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  scan_small_k<DT, QT, STORE><<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <int DT, int QT, bool STORE, int E>
static cudaError_t launch_tile(const ScanArgs& a, int splits, cudaStream_t st) {
  constexpr size_t smem = tile_smem_bytes<DT, QT>();
  static_assert(smem <= MAX_SMEM, "tile does not fit in shared memory");
  if (a.d_pad % stage_comps<DT>() || (DT != DT_F32 && !a.q16)) return cudaErrorInvalidValue;
  const dim3 grid((a.Q + QT - 1) / QT, splits);
  cudaFuncSetAttribute(scan_small_k_tile<DT, QT, STORE, E>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  scan_small_k_tile<DT, QT, STORE, E><<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// The scoring launch: qt 1..8 the row loop scan_small_k; tile:
// scan_small_k_tile, f32 at qt 16, 32 or 64, the tensor-core types at 64.
// E: entries a lane of the lists (2 only on the tile).
template <int DT, bool STORE, int E>
static cudaError_t launch_dt(const ScanArgs& a, int qt, int splits, int tile, cudaStream_t st) {
  if (tile) {
    if constexpr (DT != DT_F32) {
      return qt == 64 ? launch_tile<DT, 64, STORE, E>(a, splits, st) : cudaErrorInvalidValue;
    } else {
      switch (qt) {
        case 16: return launch_tile<DT, 16, STORE, E>(a, splits, st);
        case 32: return launch_tile<DT, 32, STORE, E>(a, splits, st);
        case 64: return launch_tile<DT, 64, STORE, E>(a, splits, st);
        default: return cudaErrorInvalidValue;
      }
    }
  }
  if constexpr (E != 1) {
    return cudaErrorInvalidValue;
  } else {
    switch (qt) {
      case 1: return launch_loop<DT, 1, STORE>(a, splits, st);
      case 2: return launch_loop<DT, 2, STORE>(a, splits, st);
      case 4: return launch_loop<DT, 4, STORE>(a, splits, st);
      case 8: return launch_loop<DT, 8, STORE>(a, splits, st);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <bool STORE, int E = 1>
static cudaError_t launch_scoring(const ScanArgs& a, int dtype, int qt, int splits, int tile,
                                  cudaStream_t st) {
  switch (dtype) {
    case DT_F32: return launch_dt<DT_F32, STORE, E>(a, qt, splits, tile, st);
    case DT_BF16: return launch_dt<DT_BF16, STORE, E>(a, qt, splits, tile, st);
    case DT_I8: return launch_dt<DT_I8, STORE, E>(a, qt, splits, tile, st);
    case DT_I4: return launch_dt<DT_I4, STORE, E>(a, qt, splits, tile, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---- k > 32: scratch in device memory, one buffer the caller passes ----
//
// [key scratch (Q, chunk_rows) f32 | h1 h2 h3 cnt (zeroed per chunk) |
//  per-block last-digit counts | survivors (keys, ids) | merge areas when
//  there are several chunks and merge_len(k) > MERGE_SMEM_MAX_LEN], each
// part 256-byte aligned.
struct BigScratch {
  size_t keys, zero, zero_bytes, bh, surv_keys, surv_ids, merge_keys, merge_ids, total;
};

static size_t align256(size_t b) { return (b + 255) & ~(size_t)255; }

static int n_chunks_of(int count, int chunk_rows) {
  return count > chunk_rows ? (count + chunk_rows - 1) / chunk_rows : 1;
}

static BigScratch big_scratch(int Q, int k, int chunk_rows, int n_chunks) {
  BigScratch b;
  size_t o = 0;
  auto take = [&](size_t bytes) { const size_t at = o; o += align256(bytes); return at; };
  b.keys = take((size_t)Q * chunk_rows * 4);
  b.zero_bytes = (size_t)Q * (2 * SEL_BINS + SEL_BINS3 + 1) * 4;
  b.zero = take(b.zero_bytes);
  b.bh = take((size_t)Q * sel_blocks(Q, chunk_rows) * SEL_BINS3 * 4);
  b.surv_keys = take((size_t)Q * surv_ld(k) * 4);
  b.surv_ids = take((size_t)Q * surv_ld(k) * 4);
  const bool merge_global = n_chunks > 1 && merge_len(k) > MERGE_SMEM_MAX_LEN;
  b.merge_keys = take(merge_global ? (size_t)Q * merge_len(k) * 4 : 0);
  b.merge_ids = take(merge_global ? (size_t)Q * merge_len(k) * 4 : 0);
  b.total = o;
  return b;
}

// Bytes of scratch vdb_flat_topk needs: 0 for k <= 32 and for the tile's
// lists at k <= 64 (chunk_rows 0): their merges fit in shared memory.
extern "C" long long vdb_flat_scratch_bytes(int Q, int k, int count, int chunk_rows) {
  if (k <= 32 || Q < 1 || chunk_rows < 1) return 0;
  return (long long)big_scratch(Q, k, chunk_rows, n_chunks_of(count, chunk_rows)).total;
}

// q: (Q, d_pad) f32, already rounded to the storage type's query precision;
// q16: the same as bf16 (read by the tile design for bf16/int8/int4 rows,
// else may be null). db: (>= count, row_bytes) rows of dtype (0 f32, 1
// bf16, 2 int8, 3 int4). sq / mask / scales: per-row f32 or null. tile: 1
// for scan_small_k_tile. out_*: (Q, k).
//  * k <= 32: cand_*: (Q, n_lists, k); the launch is refused unless n_lists
//    is what the scan writes: splits * WARPS for the row loop, else splits.
//  * 32 < k <= MAX_K_LISTS on the tile, chunk_rows 0: the same, n_lists =
//    splits (lists of two entries a lane), merged by merge_topk_kernel.
//  * any other k > 32: the rows are scored and selected in chunks of
//    chunk_rows (a multiple of TILE_ROWS; rows_per_split a multiple of 4),
//    and n_lists must be the number of chunks; cand_* (Q, n_lists, k) hold
//    the chunks' lists when there are several (else may be null). scratch:
//    vdb_flat_scratch_bytes(Q, k, count, chunk_rows) bytes.
extern "C" int vdb_flat_topk(const float* q, const uint16_t* q16, int Q, int d_pad,
                             const void* db, int dtype, int row_bytes, int count,
                             const float* sq, const float* mask, const float* scales,
                             int euclid, int k, int qt, int tile, int splits,
                             int rows_per_split, int n_lists, int chunk_rows,
                             float* cand_keys, int* cand_ids, float* out_keys, int* out_ids,
                             void* scratch, void* stream) {
  const int big = k > 32;
  const int lists = big && chunk_rows == 0;  // the tile's lists, no key scratch
  if (count < 0) count = 0;
  if (k < 1 || Q < 1 || splits < 1 || row_bytes % 16 || (euclid && !sq) ||
      (dtype == DT_I4 && !scales))
    return cudaErrorInvalidValue;
  if (lists && (!tile || k > MAX_K_LISTS || !cand_keys || !cand_ids))
    return cudaErrorInvalidValue;
  if (big && !lists ? (chunk_rows < 1 || chunk_rows % TILE_ROWS || rows_per_split % 4 ||
             (long long)splits * rows_per_split < (count < chunk_rows ? count : chunk_rows) ||
             n_lists != n_chunks_of(count, chunk_rows) || !scratch ||
             (n_lists > 1 && (!cand_keys || !cand_ids)))
          : n_lists != (tile ? splits : splits * WARPS))
    return cudaErrorInvalidValue;
  ScanArgs a;
  a.q = q; a.q16 = q16; a.Q = Q; a.d_pad = d_pad;
  a.db = static_cast<const uint8_t*>(db);
  a.row_bytes = row_bytes; a.count = count;
  a.sq = sq; a.mask = mask; a.scales = scales;
  a.euclid = euclid; a.k = k;
  a.rows_per_split = rows_per_split;
  a.row_base = 0;
  a.cand_keys = cand_keys; a.cand_ids = cand_ids;
  a.keys_out = nullptr; a.key_ld = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!big) {
    err = launch_scoring<false>(a, dtype, qt, splits, tile, st);
    if (err != cudaSuccess) return err;
    return launch_merge_small(cand_keys, cand_ids, Q, n_lists * k, k, out_keys, out_ids, 0,
                              st);
  }
  if (lists) {  // merge_len(k) = MERGE_MIN_LEN: the merge's area is shared memory
    err = launch_scoring<false, 2>(a, dtype, qt, splits, tile, st);
    if (err != cudaSuccess) return err;
    return launch_merge(cand_keys, cand_ids, Q, n_lists * k, k, nullptr, nullptr, out_keys,
                        out_ids, 0, st);
  }
  const BigScratch b = big_scratch(Q, k, chunk_rows, n_lists);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  a.keys_out = reinterpret_cast<float*>(base + b.keys);
  a.key_ld = chunk_rows;
  SelArgs s;
  s.keys = a.keys_out; s.Q = Q; s.ld = chunk_rows; s.k = k;
  s.sb = sel_blocks(Q, chunk_rows);
  s.h1 = reinterpret_cast<int*>(base + b.zero);
  s.h2 = s.h1 + (size_t)Q * SEL_BINS;
  s.h3 = s.h2 + (size_t)Q * SEL_BINS;
  s.cnt = s.h3 + (size_t)Q * SEL_BINS3;
  s.bh = reinterpret_cast<int*>(base + b.bh);
  s.surv_keys = reinterpret_cast<float*>(base + b.surv_keys);
  s.surv_ids = reinterpret_cast<int*>(base + b.surv_ids);
  s.surv_ld = surv_ld(k);
  for (int c = 0; c < n_lists; c++) {
    a.row_base = c * chunk_rows;
    a.count = count < a.row_base + chunk_rows ? count : a.row_base + chunk_rows;
    s.row_base = a.row_base;
    s.n = a.count - a.row_base;
    err = cudaMemsetAsync(base + b.zero, 0, b.zero_bytes, st);
    if (err != cudaSuccess) return err;
    err = launch_scoring<true>(a, dtype, qt, splits, tile, st);
    if (err != cudaSuccess) return err;
    err = n_lists == 1 ? launch_select(s, out_keys, out_ids, k, st)
                       : launch_select(s, cand_keys + (size_t)c * k, cand_ids + (size_t)c * k,
                                       n_lists * k, st);
    if (err != cudaSuccess) return err;
  }
  if (n_lists == 1) return cudaSuccess;
  const bool merge_global = merge_len(k) > MERGE_SMEM_MAX_LEN;
  return launch_merge(cand_keys, cand_ids, Q, n_lists * k, k,
                      merge_global ? reinterpret_cast<float*>(base + b.merge_keys) : nullptr,
                      merge_global ? reinterpret_cast<int*>(base + b.merge_ids) : nullptr,
                      out_keys, out_ids, 0, st);
}
