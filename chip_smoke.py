#!/usr/bin/env python3
"""Drive tpu_vector_db_torch's main path on one NVIDIA H100.

Run from the root of the repository: ``python3 chip_smoke.py``. It

1. prints the card (``nvidia-smi``), the torch and CUDA versions, and
   builds the kernels of ``tpu_vector_db_torch/csrc`` with nvcc, one
   nvcc per source, all at once; each build line gives every kernel's
   registers and spills from the compiler's report, saved beside the
   library, also when the library was built before;
2. holds each flat-scan kernel against its plain torch version on the
   card at 1M x 768 rows (f32, bf16, int8, int4; top-10 at batch 1, 16,
   64 and 100, top-100 at batch 1 and 64; a filtered case, a case with
   count < N, a euclidean case; big-k cases past the TPU kernel's
   k = 1024, up to k = 20000 at batch 1 and 64, and k = 1025 at batch 64
   for every type) and times the kernel, the plain version and
   ``torch.matmul`` + ``torch.topk`` (a yardstick only: the port never
   calls it); each line names the scoring design that ran (the row loop
   or the tile; ``scan_kernel_bigk`` then runs the radix select); at
   batch 1 and in the headline cases also the device time of the call's
   kernels alone (``device_ms``, torch.profiler). Then
   both designs of ``scan_kernel`` at batch
   2-16 of every type, held and timed (the "crossover" lines the
   wrapper's ``TILE_MIN_Q`` is set from);
3. holds the IVF probe kernel against its plain version on 2048 buckets
   of 1024 x 768 rows (f32 and bf16; batch 1, 8, 64; nprobe 32, 64 and
   every bucket; k 1, 10 and 32; partly filled buckets; 24 copies of the
   query in 12 probed buckets, equal keys across the k-th; probed
   buckets with fewer live rows than k) and times the kernel (CUDA
   events and ``device_ms``), the plain version and ``index_select`` +
   ``bmm`` + ``topk`` (a composition used as a yardstick only); then the
   k <= 32 merge alone, held bit for bit against its plain version and
   timed, on the candidate shapes of the IVF and flat batch-1 paths (the
   "merge" lines); then the ``rownorm`` hold: the store's row reductions
   (``l2_normalize``, ``row_sqnorms``) give every row of tensors of 1-40
   and 4096 rows (d 128, 384, 768, 1536) the bits it gets alone, beside
   the row counts at which torch's own reductions do not;
4. drives the store through ``create_vector_store(..., device="cuda")`` on
   eight paths, the server on a ninth, the seven examples
   (``examples/torch_*.py``) on a tenth, the sharded store on an
   eleventh, multi-host serving on a twelfth, the embedding pipeline on
   a thirteenth and the capacity modes on a fourteenth,
   each with the launch counts set to 0 just before it and read just
   after: the main path, 1M x 768
   f32 cosine with metadata (batch 1 and 64, top-100, top-2000, filter,
   delete, self-query, recall@10 against an exact ground truth); BASELINE config #2, 1M x 128
   euclidean top-100 at batch 64; config #4, 1M x 1536 bf16 (batch 1 and
   64, rerank top-10 and top-300); config #1, a flush + reopen at 100K x
   384; ``ivf``, BASELINE config #3's regime: 1M x 768 f32 clustered rows
   with ``enable_ann=True`` (the IVF index built on add, extended with
   spills, rebuilt by ``optimize()``; batch 1 and 8 through the IVF
   kernel, recall@10 of 64 queries, a full probe equal to the flat scan,
   batch 64 and top-100 routed to the exact scan, and batches 32 and 64
   timed both through the exact scan and through the IVF kernel with
   ``index_type="ivf"``); ``ivf_small``, 200K x
   384 bf16 with ``enable_ann=True``, flushed and reopened, the index
   served from its sidecar without a rebuild; ``graph``, the JAX
   package's beam-graph regime (150K x 768 f32 cosine, the regime's 300K
   halved for time; 300 centres, unit noise) with
   ``index_type="beam_graph"``: added in 3 x 50K (a build,
   then two incremental extends), rebuilt by ``optimize()`` (its insert
   and refine passes timed), recall@10 of 1,000 held-out queries at ef
   100 and 200, batch 1/8/64 timed and profiled through the graph with no
   flat-scan launch (the store's ANN->exact fallback would hide a failing
   graph search), a 10K incremental add whose rows find themselves, a 10%
   filter through the graph and a 1% filter through the exact scan, 1%
   deleted, flush + reopen serving ``ann_graph.npz``; ``graph_native``,
   10K x 768 with ``build_backend="cpu"``: the native C++ builder
   (compiled by g++ at first use) builds the graph, the card searches
   it; and ``serve``, the REST
   server (``tpu_vector_db_torch.api.app.create_app`` on the card, on
   127.0.0.1 at a free port, spoken to over TCP with aiohttp): a 125K x
   768 f32 cosine store made by ``/admin/create_store`` and filled by 4
   ``/v1/batch/upload`` calls of 31,250 rows (followed on their SSE
   streams), 50 sequential ``/vectors/query`` requests, 256 concurrent
   ones (64 in flight) that the query coalescer folds into batched scans
   (the launches equal to its flushes, every answer equal to the store's
   own ``batch_query``), ``/vectors/batch_query`` at batch 64, top-10 and
   top-100, a filter, an add with self-queries, a delete, the request
   count in ``/monitoring/prometheus``, the card in ``/health`` and
   ``/system/info``, and the device's busy share of a burst of 64
   requests, and then (its own ``sdk`` launch line) the port's SDK: health,
   10 queries and a batch query equal to the store's own, and an
   ``index_type="hnsw"`` graph store created, filled and queried;
   ``examples``, each of ``examples/torch_*.py`` imported by its path
   and run in this process (``main(device="cuda", root=...)``, at the
   JAX examples' sizes), held to what it prints and asserts, its
   launches counted around the call and every kernel it launched held
   against its plain version on its own store; and
   ``sharded``, BASELINE config #5: 10M x 128 f32 cosine (rows N(0, I),
   metadata on every row, 10 x 1M adds) in a ``ShardedVectorStore`` over
   ``make_device_mesh()`` beside an unsharded store on the same rows
   (top-10 and top-100 at batch 1 and 64, a 1% filter, 0.1% deleted,
   recall@10; every answer equal to the unsharded store's), flushed and
   reopened at P = 4 co-located shards (``["cuda:0"] * 4``: four scans
   and one k·P merge a call, the same answers), a sharded IVF (2M x 128
   in the ``ivf`` path's regime, P = 2, recall@10 at nprobe 32 and 64, a
   full probe equal to the sharded flat scan), a sharded beam graph (50K
   x 128 of the graph regime, P = 2, native build, a 10K extend, recall@10
   at ef 100, flush + reopen from ``ann_sharded_graph.npz``) and the
   manager with ``sharded=True``; its holds cover every shard and the
   merge (and the multihost path's shards and merges, cut from the same
   rows); ``multihost``, config #5 from two processes of one serving
   group: first a pair of processes (``--multihost-pair``) times the
   cross-process merge alone (one gloo all-gather of (Q, k) winners)
   against its plain version, then two port servers
   (``--multihost-worker``: ``tpu_vector_db_torch.api.main`` with
   ``VECTOR_DB_COORDINATOR``, one shard a process on the card) open the
   sharded path's flushed store from hard-linked copies and take lockstep
   REST traffic (50 b1 top-10 queries, batch_query b64 top-10 and
   top-100, a filter, a 1,000-row add whose rows find themselves, a
   10-row delete), every answer equal on both hosts and to the
   single-process store's; then the sharded path's IVF (2M x 128) and
   graph (50K x 128) stores, written by one process, which each server
   rebuilds its own shard's index of (timed as their load), b1 top-10 x
   50 and b64 top-10 x 10 each, every answer equal on both hosts and to
   an in-process P = 2 store whose index was built over the same rows,
   recall@10 >= 0.95, no flat-scan launch, an IVF probe a call and two
   merges a call on each host (its launch counts read over an added
   ``/smoke/launches`` route), and each host's IVF kernel and shard merge
   held against their plain versions on its own shard (``/smoke/hold``);
   rank 1 is killed, rank 0 answers 503
   ``peer_lost`` (then fast, and on ``/health``), exits on SIGTERM and
   prints its launch counts; and ``pipeline``, the RAG pipeline on an
   encoder of BAAI/bge-base-en-v1.5's published shape (BERT, 12 x 768,
   vocab 30522,
   CLS pooling; random N(0, 0.02) weights and a vocab.txt made from the
   seed, written in HF layout under ``_smoke_tmp/models``, loaded by
   ``create_encoder("hf:<dir>")``): ~50K chunks of synthetic documents
   (``chunk_text(512, 50)``, ~100 tokens a chunk) indexed by
   ``PipelineFactory.create_rag_pipeline(..., device="cuda")`` and
   ``index_documents`` (batch 32, bf16), 200 ``retrieve_context(k=5)`` at
   batch 1 (``scan_kernel``) and 20 ``search_similar_texts(k=100)``
   (``scan_kernel_bigk``) timed, the batch-1 embeddings at cosine >=
   0.999 of their stored rows, encode rates at batch 32 and 128 (bf16,
   f32), the tokenizer's share and the busy share of an encode call, and
   the model's holds (bf16 / int8 / int4 against f32 on 1,024 texts at
   cosine >= 0.999 / 0.99 / 0.98, the card's f32 against the CPU's on 8
   texts), then the same holds and a small RAG corpus for
   all-mpnet-base-v2's shape (MPNet) and multilingual-e5-small's (XLM-R,
   a Unigram ``tokenizer.json`` of 250,002 pieces); and ``capacity``,
   the JAX package's capacity rows (16M x 768 int8, 32M x 768 int4)
   halved until the host holds a store's f32 rows twice over in 0.6 of
   MemAvailable and the disk its flush, int4 halved three more times for the
   script's time (each cut printed): the guard on the card's budget
   (configs past it refused, an over-budget add refused before it
   changes the store); an int8 cosine store of clustered rows with
   metadata and ``enable_ann=True``, grown from the default capacity in
   2^20-row adds (its IVF in the gather layout, built on add, rebuilt by
   ``optimize()``), exact top-10 at batch 1 and 64, top-100, a 1%
   filter, ``rerank=True`` at batch 1 and 64, IVF at batch 1 and 8 with
   no flat-scan launch, recall@10 of 64 queries against an f32 ground
   truth taken on the card (the rerank also held to rule (a): the f32
   re-score of the scan's own k x 4 candidates; the IVF to the exact
   int8 scan's answers, and a full probe to the exact scan), 0.1%
   deleted, flush and reopen (its ``ann_ivf.npz`` served, every answer
   equal); an int4 store of N(0, I) unit rows, exact, top-10 at batch 1
   and 64, top-100, rerank, flush and reopen, and reopened again as a
   ``ShardedVectorStore`` on two co-located shards answering alike; each
   store's kernels timed on its own rows (``device_ms``, bound, the
   library on the rows widened to bf16). After
   each path the kernels
   are held against their plain version once more on that store's own
   rows, buckets, masks, batch sizes and k, and the big-k calls of the
   main path (top-2000 b1) and config #2 (top-100 b64) are profiled
   (device time by kernel against the call's window: "profiled" lines,
   after the path's launch counts are read);
5. prints one JSON line of the kernels (launches from each kernel's
   headline path: ``main`` for the flat kernels, ``ivf`` for the IVF
   kernel, ``capacity`` for the gather layout's IVF kernel (held on the
   int8 capacity store's own rows, id table and selection at k 5, 10
   and 40, batches 1, 8 and 16), ``sharded`` for ``merge_small_k``
   alone, the k·P merge; and
   each path's count in ``launches_by_path``), the
   card's name and power limit, and last ``{"ok": true,
   "device": {...}}``.

Every phase that fails makes the script exit non-zero. Without a CUDA
device, or without the package beside it, it exits 2 and prints no
result. Data is made from ``--seed`` on the card; stores live in
``_smoke_tmp/`` under the repository and are removed at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
N = 1_000_000                      # rows of the kernel cases and 1M stores
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS = {"float32": 67e12,      # CUDA cores, f32
            "bfloat16": 989e12, "int8": 989e12, "int4": 989e12}
# f32 accumulation in another order: absolute on unit-row keys, relative
# to the key on euclidean keys, which grow with d and ||x||^2
KEY_TOL = 1e-4
SOURCE = {"scan_kernel": "tpu_vector_db_torch/csrc/flat_topk.cu",
          "scan_kernel_bigk": "tpu_vector_db_torch/csrc/flat_topk.cu",
          "ivf_kernel": "tpu_vector_db_torch/csrc/ivf_topk.cu",
          "ivf_gather_kernel": "tpu_vector_db_torch/csrc/ivf_topk.cu",
          "merge_small_k": "tpu_vector_db_torch/csrc/topk_common.cuh"}
# merge_small_k alone is the sharded paths' k·P merge, where the JAX
# package merges with lax.top_k (XLA, not a Pallas kernel); the gather
# probe is an XLA gather + einsum there too
REPLACES = {"scan_kernel": "tpu_vector_db/ops/pallas_scan.py:112",
            "scan_kernel_bigk": "tpu_vector_db/ops/pallas_scan.py:259",
            "ivf_kernel": "tpu_vector_db/ops/ivf_scan.py:40",
            "ivf_gather_kernel": "tpu_vector_db/ops/ivf_scan.py:152",
            "merge_small_k": "tpu_vector_db/parallel/sharded_scan.py:86"}
# the path whose launch counts stand in the kernels line, and the case its
# timings come from: the shape that path gives the kernel (flat top-10 at
# batch 64 and top-100 at batch 1 on the main path; an IVF top-10 query at
# batch 1 on the ivf path's own index, timed there)
HEADLINE_PATH = {"scan_kernel": "main", "scan_kernel_bigk": "main",
                 "ivf_kernel": "ivf", "ivf_gather_kernel": "capacity",
                 "merge_small_k": "sharded"}
HEADLINE = {"scan_kernel": ("float32", 64, 10),
            "scan_kernel_bigk": ("float32", 1, 100)}
LIBRARIES = ("flat_topk", "ivf_topk")
# the IVF yardstick: no single torch call computes the probe, so it is a
# composition, timed beside the kernel and never called by the port
IVF_YARDSTICK = "index_select + bmm + topk (composition)"
# the kernels a call launches once, for profile_device: a flat call's
# scoring kernel (and for k <= 32 its merge), an IVF probe's two kernels
EXPECT_IVF = ("ivf_scan_kernel", "merge_small_k")


def expect_gather(k: int) -> tuple[str, ...]:
    return ("ivf_gather_kernel",
            "merge_small_k" if k <= 32 else "merge_topk_kernel")
# device_ms: traces of one call taken at most, and how far (a share of
# their median) the three that are believed may lie apart
TRACES_MAX = 6
TRACE_MARGIN = 0.15
# an event longer than this many times its kernel's median event holds
# launches the profiler merged (device_ms does not scale such a kernel)
MERGED_EVENT = 1.5


def expect_flat(k: int) -> tuple[str, ...]:
    return ("scan_small_k", "merge_small_k") if k <= 32 else ("scan_small_k",)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------- phase 1

def ptxas_report(log: str, saved: Path) -> str | None:
    """The ptxas report of a library: a fresh build's ``log``, which is
    saved beside the library in place of what was there; else the report
    saved there when the library was built; None when there is neither
    (a verbose build then has to make one)."""
    if log:
        saved.write_text(log)
        return log
    text = saved.read_text() if saved.is_file() else ""
    return text or None


def verbose_build_log(name: str) -> str:
    """The ptxas report of ``csrc/<name>.cu``, from a build with the
    library's flags and ``-Xptxas -v`` into a scratch file that is removed
    again (the library itself was built before, without a report)."""
    from tpu_vector_db_torch.ops import _build
    out = _build.BUILD_DIR / f"ptxas_report_{name}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           str(out), str(_build.CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.unlink(missing_ok=True)
    check(proc.returncode == 0, f"nvcc -Xptxas -v failed for {name}.cu:\n"
          f"{proc.stderr[-4000:]}")
    return proc.stdout + proc.stderr


def kernel_label(mangled: str) -> str:
    """``scan_small_k<1,1,0>`` for ``_Z12scan_small_kILi1ELi1ELb0EEv8ScanArgs``:
    the name and integer template arguments of a mangled kernel name."""
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    name = mangled[m.end():m.end() + int(m.group(1))]
    rest = mangled[m.end() + len(name):]
    if not rest.startswith("I"):
        return name
    args = re.findall(r"L[ib](\d+)E", rest[:rest.find("EE") + 2])
    return f"{name}<{','.join(args)}>"


def parse_ptxas(report: str) -> dict[str, dict]:
    """Registers and spill bytes (stores plus loads) of each kernel in a
    ``-Xptxas -v`` report, by the kernel's label (``kernel_label``)."""
    kernels: dict[str, dict] = {}
    name = None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            name = kernel_label(m.group(1))
            kernels.setdefault(name, {"registers": None, "spill_bytes": 0})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            kernels[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            kernels[name]["registers"] = int(m.group(1))
    return kernels


def phase_build() -> None:
    """One nvcc per source, all started together. Each build line gives
    every kernel's registers and spills from the compiler's report, also
    when the library was built before."""
    from tpu_vector_db_torch.ops import _build

    def one(name):
        t0 = time.perf_counter()
        path, log = _build.build(name, extra_flags=("-Xptxas", "-v"))
        seconds = time.perf_counter() - t0
        report = ptxas_report(log, path.with_suffix(".ptxas.txt"))
        if report is None:
            report = ptxas_report(verbose_build_log(name),
                                  path.with_suffix(".ptxas.txt"))
        return name, path, seconds, bool(log), report

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        built = list(pool.map(one, LIBRARIES))
    total = time.perf_counter() - t0
    for name, path, seconds, fresh, report in built:
        kernels = parse_ptxas(report)
        regs = [v["registers"] for v in kernels.values()
                if v["registers"] is not None]
        check(bool(regs), f"no register counts in the ptxas report of "
              f"{name}.cu")
        spills = {n: v["spill_bytes"] for n, v in kernels.items()
                  if v["spill_bytes"]}
        emit({"phase": "build", "source": f"csrc/{name}.cu",
              "library": str(path.relative_to(REPO)), "seconds": seconds,
              "built_now": fresh, "all_sources_seconds": total,
              "max_registers": max(regs),
              "kernels_with_spills": len(spills), "spill_bytes": spills,
              "registers": {n: v["registers"] for n, v in kernels.items()}})


# --------------------------------------------------------------- phase 2

def bound(rows: int, row_bytes: int, q_n: int, d: int, k: int, dtype: str,
          side_streams: int) -> tuple[float, str]:
    """Least time for the work: bytes (rows read once, per-row side
    streams, queries, outputs) over the memory rate vs 2*Q*rows*d ops
    over the peak rate of the row type."""
    nbytes = rows * row_bytes + side_streams + q_n * d * 4 + q_n * k * 8
    ops = 2.0 * q_n * rows * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def compare(keys, ids, pkeys, pids, metric: str):
    """Kernel vs plain. Returns (max |key diff| over finite slots, whether
    every diff is within the tolerance, whether ids agree wherever the
    neighbouring keys are further apart than it). The tolerance is
    KEY_TOL, times max(1, |key|) for euclidean keys."""
    keys, pkeys = keys.cpu().numpy(), pkeys.cpu().numpy()
    ids, pids = ids.cpu().numpy(), pids.cpu().numpy()
    fin = np.isfinite(pkeys)
    if not np.array_equal(fin, np.isfinite(keys)):
        return float("inf"), False, False
    tol = np.full(pkeys.shape, KEY_TOL)
    if metric == "euclidean":
        tol *= np.maximum(1.0, np.abs(np.where(fin, pkeys, 0.0)))
    gap_prev = np.full(pkeys.shape, np.inf)
    gap_next = np.full(pkeys.shape, np.inf)
    with np.errstate(invalid="ignore"):   # -inf - -inf in dropped slots
        diff = np.where(fin, np.abs(keys - pkeys), 0.0)
        gap_prev[:, 1:] = np.nan_to_num(np.abs(np.diff(pkeys, axis=1)),
                                        nan=np.inf)
    gap_next[:, :-1] = gap_prev[:, 1:]
    err = float(np.max(diff, initial=0.0))
    clear = fin & (gap_prev > tol) & (gap_next > tol)
    return (err, bool(np.all(diff <= tol)),
            bool(np.all(ids[clear] == pids[clear])))


def phase_kernels(d: int, seed: int) -> tuple[dict, dict]:
    """Every kernel case at N x d. Returns (timings of each kernel's
    headline case, max |key diff| of each kernel)."""
    import torch
    from tpu_vector_db_torch.ops import cuda_scan
    from tpu_vector_db_torch.ops.launches import LAUNCHES
    from tpu_vector_db_torch.ops.quant4 import (pack_int4,
                                                quantize_unit_rows,
                                                unpack_int4)
    n = N
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=dev)
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
    packed, scales = pack_int4(x)
    dbs = {"float32": (x, None),
           "bfloat16": (x.to(torch.bfloat16), None),
           "int8": (quantize_unit_rows(x, "int8")[0], None),
           "int4": (packed, scales)}
    # yardstick operands: dense rows a library product can take
    dense = {"float32": x, "bfloat16": dbs["bfloat16"][0],
             "int8": dbs["int8"][0].to(torch.bfloat16),
             "int4": unpack_int4(packed, scales).to(torch.bfloat16)}
    sqn = torch.sum(x * x, dim=1)
    mask = (torch.rand(n, generator=g, device=dev) < 0.1).float()
    queries = torch.randn((100, d), generator=g, device=dev)
    queries /= torch.linalg.vector_norm(queries, dim=1, keepdim=True)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    cases = []
    for k in (10, 100):
        for dtype in ("float32", "bfloat16", "int8", "int4"):
            # batch 16 and 100: the smallest tile and a ragged second tile
            for q_n in ((1, 16, 64, 100) if k == 10 else (1, 64)):
                cases.append((dtype, q_n, k, "cosine", None, n))
        cases.append(("float32", 64, k, "cosine", "filtered", n))
        cases.append(("float32", 64, k, "cosine", None, n - 12345))
        cases.append(("float32", 64, k, "euclidean", None, n))
    # big-k past the TPU kernel's k = 1024: the select's survivors sorted
    # in shared memory up to k = 16384, in device memory past it
    for k, q_n in ((1025, 1), (1025, 64), (4000, 1), (4000, 64), (20000, 1),
                   (20000, 64)):
        cases.append(("float32", q_n, k, "cosine", None, n))
    for dtype in ("bfloat16", "int8", "int4"):
        cases.append((dtype, 64, 1025, "cosine", None, n))

    headline: dict[str, dict] = {}
    errs: dict[str, float] = {}
    for dtype, q_n, k, metric, flt, count in cases:
        db, scl = dbs[dtype]
        q = queries[:q_n]
        sq = sqn if metric == "euclidean" else None
        fm = mask if flt else None
        name = cuda_scan.kernel_name(k)
        d_pad = db.shape[1] * (2 if dtype == "int4" else 1)
        design = cuda_scan._launch_plan(q_n, db.dtype, d_pad, k, count,
                                        n_sm).design
        kwargs = dict(metric=metric, db_sqnorms=sq, filter_mask=fm,
                      db_scales=scl)
        before = LAUNCHES[name]
        keys, ids = cuda_scan.flat_topk(q, db, count, k, **kwargs)
        torch.cuda.synchronize()
        launches = LAUNCHES[name] - before
        pkeys, pids = cuda_scan.flat_topk_plain(q, db, count, k, **kwargs)
        err, keys_ok, ids_ok = compare(keys, ids, pkeys, pids, metric)
        kernel_ms = cuda_ms(
            lambda: cuda_scan.flat_topk(q, db, count, k, **kwargs), 10)
        plain_ms = cuda_ms(
            lambda: cuda_scan.flat_topk_plain(q, db, count, k, **kwargs),
            2)
        lib_db = dense[dtype][:count]
        lib_q = q.to(lib_db.dtype)
        library_ms = cuda_ms(
            lambda: torch.topk(torch.matmul(lib_q, lib_db.T), k, dim=1), 5)
        row_bytes = db.shape[1] * db.element_size()
        rows = int(mask[:count].sum().item()) if flt else count
        side = count * 4 * ((flt is not None) + (metric == "euclidean")
                            + (dtype == "int4"))
        bound_ms, bound_by = bound(rows, row_bytes, q_n, d, k, dtype, side)
        is_headline = (dtype, q_n, k) == HEADLINE[name] \
            and metric == "cosine" and flt is None and count == n
        # batch 1 and the headlines: the device part alone, by profiler
        dev = device_ms(lambda: cuda_scan.flat_topk(q, db, count, k,
                                                    **kwargs), 10,
                        expect_flat(k), bound_ms) \
            if q_n == 1 or is_headline else {}
        if k <= 32 and "merge_small_k_ran" in dev:
            check(dev["merge_small_k_ran"] and not
                  dev["merge_topk_kernel_ran"], f"{name} {dtype} Q={q_n} "
                  f"k={k} did not merge with merge_small_k alone")
        line = {"phase": "kernel", "kernel": name, "design": design,
                "dtype": dtype, "metric": metric, "filtered": bool(flt),
                "Q": q_n, "k": k,
                "N": n, "count": count, "d": d,
                "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "max_abs_err": err, "key_tol": KEY_TOL,
                "ids_ok": ids_ok, "launches": launches, **dev}
        emit(line)
        check(launches == 1, f"{name} launched {launches} times in one call")
        check(keys_ok, f"{name} {dtype} Q={q_n} k={k}: key error {err}")
        check(ids_ok, f"{name} {dtype} Q={q_n} k={k}: ids differ")
        errs[name] = max(errs.get(name, 0.0), err)
        if is_headline:
            headline[name] = dict(design=design, ms=kernel_ms,
                                  device_ms=dev["device_ms"],
                                  plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, library_ms=library_ms)
    crossover(dbs, queries, n, d, n_sm)
    del dbs, dense, x, packed, scales, sqn, mask
    gc.collect()
    torch.cuda.empty_cache()
    return headline, errs


def crossover(dbs: dict, queries, n: int, d: int, n_sm: int) -> None:
    """Both designs of scan_kernel at the batches around the wrapper's
    TILE_MIN_Q, top-10 over the N x d rows of every type: the
    measurement the crossovers are set from. Each design is held against
    the plain version once and timed in turns (loop, tile, tile, loop)."""
    from tpu_vector_db_torch.ops import cuda_scan
    for dtype, (db, scl) in dbs.items():
        d_pad = db.shape[1] * (2 if dtype == "int4" else 1)
        for q_n in (2, 4, 8, 12, 16):
            q = queries[:q_n]
            plain = cuda_scan.flat_topk_plain(q, db, n, 10, db_scales=scl)
            runs = {}
            for design in ("loop", "tile"):
                plan = cuda_scan._plan(design, q_n, db.dtype, d_pad, 10, n,
                                       n_sm)

                def run(plan=plan):
                    return cuda_scan._finish(*cuda_scan._launch(
                        q, db, d_pad, n, 10, "cosine", None, None, scl,
                        plan), q, "cosine")
                err, keys_ok, ids_ok = compare(*run(), *plain, "cosine")
                check(keys_ok and ids_ok, f"scan_kernel {design} {dtype} "
                      f"Q={q_n}: disagrees with its plain version ({err})")
                runs[design] = run
            ms = {name: [] for name in runs}
            for name in ("loop", "tile", "tile", "loop"):
                ms[name].append(cuda_ms(runs[name], 10))
            emit({"phase": "crossover", "kernel": "scan_kernel",
                  "dtype": dtype, "Q": q_n, "k": 10, "N": n, "d": d,
                  "loop_ms": min(ms["loop"]), "tile_ms": min(ms["tile"]),
                  "picked": cuda_scan._launch_plan(
                      q_n, db.dtype, d_pad, 10, n, n_sm).design})


def unit_(t):
    """Normalize the rows of t in place (last axis)."""
    import torch
    return t.div_(torch.linalg.vector_norm(t, dim=-1, keepdim=True))


def ivf_bound(fills, sel, row_bytes: int, d: int, k: int,
              dtype: str) -> tuple[float, str]:
    """Least time for an IVF probe: bytes (the live rows of the distinct
    probed buckets read once, sel, fills, queries, outputs) over the
    memory rate vs 2*d ops per live (query, row) pair over the peak rate
    of the bucket type."""
    import torch
    f = fills.long()
    distinct = torch.unique(sel)
    rows_read = int(f[distinct].sum())
    pairs = int(f[sel.long()].sum())
    q_n = sel.shape[0]
    nbytes = (rows_read * row_bytes + sel.numel() * 4 + distinct.numel() * 4
              + q_n * d * 4 + q_n * k * 8)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * d * pairs / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ivf_yardstick(q, buckets, fills, sel, k: int):
    """index_select + bmm + topk over the probed buckets: the same top-k
    keys as the kernel, as a composition of torch calls (a yardstick of
    speed only)."""
    import torch
    q_n, n_probe = sel.shape
    nb, bc, d = buckets.shape
    rows = buckets.index_select(0, sel.reshape(-1).long()).view(
        q_n, n_probe * bc, d)
    keys = torch.bmm(rows, q.to(buckets.dtype)[:, :, None])[:, :, 0].float()
    live = (torch.arange(bc, device=q.device)[None, None, :]
            < fills[sel.long()][:, :, None]).view(q_n, -1)
    keys = torch.where(live, keys, torch.full_like(keys, float("-inf")))
    return torch.topk(keys, min(k, keys.shape[1]), dim=1)


def hold_ivf(q, buckets, ids, fills, sel, k: int, what: dict,
             timed: bool = False, merge: bool = False) -> dict:
    """The IVF kernel against its plain version on these inputs; with
    ``timed``, kernel, plain and yardstick times and the bound; with
    ``merge``, also merge_small_k on the kernel's (Q, k) winners (what a
    sharded index's shard merge takes) against its plain version, bit
    for bit."""
    import torch
    from tpu_vector_db_torch.ops import ivf_scan
    from tpu_vector_db_torch.ops.launches import LAUNCHES
    args = (q, buckets, ids, fills, sel, k)
    before = LAUNCHES["ivf_kernel"]
    keys, got_ids = ivf_scan.ivf_probe_topk(*args)
    launches = LAUNCHES["ivf_kernel"] - before
    pkeys, pids = ivf_scan.ivf_probe_topk_plain(q, buckets, ids, sel, k,
                                                bucket_fills=fills)
    err, keys_ok, ids_ok = compare(keys, got_ids, pkeys, pids, "cosine")
    out = {"kernel": "ivf_kernel", **what, "Q": q.shape[0],
           "nprobe": sel.shape[1], "k": k, "NB": buckets.shape[0],
           "Bc": buckets.shape[1], "d": buckets.shape[2],
           "dtype": str(buckets.dtype).replace("torch.", ""),
           "max_abs_err": err, "key_tol": KEY_TOL, "keys_ok": keys_ok,
           "ids_ok": ids_ok, "launches": launches}
    if merge:
        mk, mi = ivf_scan.merge_small_k(keys, got_ids, k, -1)
        wk, wi = ivf_scan.merge_small_k_plain(keys, got_ids, k, -1)
        out["merge_small_k_bit_equal"] = (
            torch.equal(mk.view(torch.int32), wk.view(torch.int32))
            and torch.equal(mi, wi))
        check(out["merge_small_k_bit_equal"], "merge_small_k disagrees "
              f"with its plain version on the IVF winners ({what})")
    if timed:
        dtype = str(buckets.dtype).replace("torch.", "")
        out["kernel_ms"] = cuda_ms(lambda: ivf_scan.ivf_probe_topk(*args),
                                   10)
        out["plain_ms"] = cuda_ms(lambda: ivf_scan.ivf_probe_topk_plain(
            q, buckets, ids, sel, k, bucket_fills=fills), 2)
        out["yardstick_ms"] = cuda_ms(
            lambda: ivf_yardstick(q, buckets, fills, sel, k), 3)
        out["yardstick"] = IVF_YARDSTICK
        out["bound_ms"], out["bound_by"] = ivf_bound(
            fills, sel, buckets.shape[2] * buckets.element_size(),
            buckets.shape[2], k, dtype)
        out.update(device_ms(lambda: ivf_scan.ivf_probe_topk(*args), 10,
                             EXPECT_IVF, out["bound_ms"]))
    emit(out)
    if "merge_small_k_ran" in out:
        check(out["merge_small_k_ran"] and not out["merge_topk_kernel_ran"],
              f"ivf_kernel did not merge with merge_small_k alone ({what})")
    check(launches == 1, f"ivf_kernel launched {launches} times in one call")
    check(keys_ok and ids_ok, f"ivf_kernel disagrees with its plain version "
          f"({what}, Q={q.shape[0]} nprobe={sel.shape[1]} k={k}, key error "
          f"{err})")
    return out


def phase_ivf_kernels(seed: int) -> float:
    """Every IVF kernel case on 2048 buckets of 1024 x 768 unit rows,
    partly filled. Returns the largest |key diff|."""
    import torch
    from tpu_vector_db_torch.ops import ivf_scan
    nb, bc, d = 2048, 1024, 768
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    buckets = unit_(torch.randn((nb, bc, d), generator=g, device=dev))
    fills = torch.randint(bc // 2, bc + 1, (nb,), generator=g, device=dev,
                          dtype=torch.int32)
    fills[:8] = bc                       # some full buckets
    slot = torch.arange(bc, device=dev)
    ids = torch.where(slot[None, :] < fills[:, None],
                      torch.arange(nb * bc, device=dev,
                                   dtype=torch.int32).view(nb, bc), -1)
    by_dtype = {"float32": buckets, "bfloat16": buckets.to(torch.bfloat16)}
    queries = unit_(torch.randn((64, d), generator=g, device=dev))
    order = torch.rand((64, nb), generator=g, device=dev).argsort(dim=1)
    cases = [(dtype, q_n, n_probe, k)
             for dtype in ("float32", "bfloat16") for q_n in (1, 8, 64)
             for n_probe in (32, 64) for k in (10, 32)]
    cases += [("float32", 1, nb, 10), ("bfloat16", 1, nb, 32)]  # full probe
    cases += [("float32", q_n, 32, 1) for q_n in (1, 8)]     # k = 1
    err = 0.0
    for dtype, q_n, n_probe, k in cases:
        sel = order[:q_n, :n_probe].to(torch.int32).contiguous()
        out = hold_ivf(queries[:q_n], by_dtype[dtype], ids, fills, sel, k,
                       {"phase": "ivf_kernel_case"}, timed=True)
        err = max(err, out["max_abs_err"])
    sel = order[:1, :32].to(torch.int32).contiguous()
    err = max(err, ivf_tie_case(queries[:1], buckets, ids, fills, sel, 10))
    # the probed buckets hold 6 live rows in all, fewer than k
    few = fills.clone()
    few[sel[0, :4].long()] = torch.tensor([1, 2, 0, 3], dtype=torch.int32,
                                          device=dev)
    for k in (10, 32):
        out = hold_ivf(queries[:1], buckets, ids, few, sel[:, :4], k,
                       {"phase": "ivf_kernel_case", "case": "6 live rows"},
                       timed=True)
        err = max(err, out["max_abs_err"])
        keys, _ = ivf_scan.ivf_probe_topk(queries[:1], buckets, ids, few,
                                          sel[:, :4], k)
        check(int(torch.isfinite(keys).sum()) == 6,
              f"k={k} over 6 live rows gave {keys.tolist()}")
    del buckets, by_dtype, ids
    free_card()
    return err


def ivf_tie_case(q, buckets, ids, fills, sel, k: int) -> float:
    """Copies of the query in two live slots of each of 12 probed buckets
    (f32): 24 rows of one key, in 12 lists of the scan and in several
    warps' slices of the merge, straddle the k-th key. The top k must be
    the k lowest ids among the copies, all with that key; then the
    buckets are put back."""
    import torch
    from tpu_vector_db_torch.ops import ivf_scan
    probed = sel[0, :12].long()
    slots = torch.tensor([0, 5], device=q.device)
    saved = buckets[probed[:, None], slots[None, :]].clone()
    buckets[probed[:, None], slots[None, :]] = q[0]
    try:
        out = hold_ivf(q, buckets, ids, fills, sel, k,
                       {"phase": "ivf_kernel_case",
                        "case": "24 equal keys straddle the k-th"},
                       timed=True)
        keys, got = ivf_scan.ivf_probe_topk(q, buckets, ids, fills, sel, k)
        copies = ids[probed[:, None], slots[None, :]].flatten()
        want = torch.sort(copies).values[:k].to(torch.int32)
        check(bool((got[0] == want).all()) and bool((keys[0] ==
              keys[0, 0]).all()), f"tied copies: ids {got[0].tolist()}, "
              f"want {want.tolist()}")
    finally:
        buckets[probed[:, None], slots[None, :]] = saved
    return out["max_abs_err"]


def phase_merge(seed: int) -> None:
    """merge_small_k alone, held bit for bit against its plain version and
    timed (device time by profiler, the plain version by CUDA events) on
    random sorted candidate lists of the shapes the store paths give it:
    IVF nprobe 32 at batch 1 (512 lists, about half of them empty as on
    the ivf store's half-filled buckets) at k 10 and 32, flat f32 at batch
    1 (4224 lists of 10) and IVF at batch 64 (32 lists of 10)."""
    import torch
    from tpu_vector_db_torch.ops import ivf_scan
    rng = np.random.default_rng(seed + 11)
    shapes = [("ivf b1", 1, 512, 10, 0.5), ("ivf b1 k32", 1, 512, 32, 0.5),
              ("flat f32 b1", 1, 4224, 10, 0.0), ("ivf b64", 64, 32, 10, 0.5)]
    for label, q_n, n_lists, k, empty in shapes:
        keys = -np.sort(-rng.standard_normal((q_n, n_lists, k)).astype(
            np.float32), axis=2)
        keys[rng.random((q_n, n_lists)) < empty] = -np.inf
        ids = np.stack([rng.permutation(n_lists * k) for _ in range(q_n)])
        kt = torch.from_numpy(keys.reshape(q_n, -1)).cuda()
        it = torch.from_numpy(ids.astype(np.int32)).cuda()
        want_k, want_i = ivf_scan.merge_small_k_plain(kt, it, k, -1)
        got_k, got_i = ivf_scan.merge_small_k(kt, it, k, -1)
        check(torch.equal(got_k.view(torch.int32), want_k.view(torch.int32))
              and torch.equal(got_i, want_i),
              f"merge_small_k on {label} is not bit-equal to its plain "
              "version")
        dev = device_ms(lambda: ivf_scan.merge_small_k(kt, it, k, -1), 20,
                        ("merge_small_k",))
        emit({"phase": "merge", "case": label, "Q": q_n, "n_lists": n_lists,
              "k": k, "empty_share": empty, "bit_equal": True,
              "device_ms": dev["device_ms"],
              "device_ms_traces": dev["device_ms_traces"],
              "plain_ms": cuda_ms(lambda: ivf_scan.merge_small_k_plain(
                  kt, it, k, -1), 5)})


ROWNORM_DIMS = (128, 384, 768, 1536)
ROWNORM_COUNTS = tuple(range(1, 41)) + (4096,)


def phase_rownorm(seed: int) -> None:
    """The row reductions that prepare the store's rows and queries
    (``ops/distance.py``: ``l2_normalize``, ``row_sqnorms``) give a row
    the same bits in a tensor of any row count: for each d, every row of
    tensors of 1-40 and 4096 rows against the same row alone. Beside
    them, the row counts at which torch's own reductions (``vector_norm``,
    ``sum``) round a row otherwise than alone, the fault they repair."""
    import torch
    from tpu_vector_db_torch.ops import distance as D
    g = torch.Generator(device="cuda").manual_seed(seed + 13)
    fns = {"l2_normalize": D.l2_normalize, "row_sqnorms": D.row_sqnorms,
           "torch.linalg.vector_norm":
               lambda t: torch.linalg.vector_norm(t, dim=-1),
           "torch.sum": lambda t: torch.sum(t * t, dim=-1)}
    for d in ROWNORM_DIMS:
        x = torch.randn((max(ROWNORM_COUNTS), d), generator=g, device="cuda")
        differ = {}
        for name, fn in fns.items():
            alone = torch.cat([fn(row[None]) for row in x]).view(torch.int32)
            differ[name] = [n for n in ROWNORM_COUNTS if not torch.equal(
                fn(x[:n]).view(torch.int32), alone[:n])]
        emit({"phase": "hold", "path": "rownorm", "d": d,
              "row_counts": "1-40 and 4096",
              "counts_differing_from_one_row": differ,
              "bit_equal": not differ["l2_normalize"]
              and not differ["row_sqnorms"]})
        check(not differ["l2_normalize"] and not differ["row_sqnorms"],
              f"the row reductions depend on the row count at d={d}: "
              f"{differ}")


# --------------------------------------------------------------- phase 3

@contextlib.contextmanager
def counting(path: str, expect: tuple[str, ...], counts: dict):
    """Launch counts set to 0 just before a path and read just after;
    every kernel in ``expect`` must have launched in it."""
    import torch
    from tpu_vector_db_torch.ops.launches import (LAUNCHES,
                                                  reset_launch_counts)
    reset_launch_counts()
    yield
    torch.cuda.synchronize()
    counts[path] = dict(LAUNCHES)
    emit({"phase": "launches", "path": path, **counts[path]})
    for name in expect:
        check(counts[path][name] > 0,
              f"{name} was not launched on path {path}")


def hold_store(store, path: str, queries: np.ndarray, k: int, errs: dict,
               filter_metadata: dict | None = None) -> None:
    """Kernel against plain version on the store's own scan inputs (rows,
    sqnorms, scales, live or filter mask) at this path's batch and k."""
    import torch
    from tpu_vector_db_torch.ops import cuda_scan
    args = store._scan_inputs(queries, store._query_mask(filter_metadata))
    keys, ids = cuda_scan.flat_topk(k=k, **args)
    pkeys, pids = cuda_scan.flat_topk_plain(k=k, **args)
    err, keys_ok, ids_ok = compare(keys, ids, pkeys, pids, store.metric)
    name = cuda_scan.kernel_name(k)
    db = args["db"]
    design = cuda_scan._launch_plan(
        len(queries), db.dtype, args["queries"].shape[1], k, store._count,
        torch.cuda.get_device_properties(db.device).multi_processor_count
    ).design
    emit({"phase": "hold", "path": path, "kernel": name, "design": design,
          "dtype": store.config.storage_dtype, "metric": store.metric,
          "filtered": bool(filter_metadata), "Q": len(queries), "k": k,
          "count": store._count, "d": store.config.dimension,
          "max_abs_err": err, "keys_ok": keys_ok, "ids_ok": ids_ok})
    check(keys_ok and ids_ok, f"{path}: {name} disagrees with its plain "
          f"version at Q={len(queries)} k={k} (key error {err})")
    errs[name] = max(errs.get(name, 0.0), err)


def unit_rows(g, n, d):
    import torch
    x = torch.randn((n, d), generator=g, device="cuda")
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def fill_store(store, rows, batch: int, metadata) -> float:
    """add_vectors in batches; returns seconds."""
    t0 = time.perf_counter()
    n = rows.shape[0]
    for start in range(0, n, batch):
        stop = min(start + batch, n)
        meta = None if metadata is None else metadata[start:stop]
        store.add_vectors(rows[start:stop].cpu().numpy(), meta)
    return time.perf_counter() - t0


def timed_queries(store, queries: np.ndarray, k: int, reps: int,
                  **kw) -> dict:
    """QPS and p50 of batch_query on ``queries`` (host clock; each call
    ends in the device-to-host copy of its results)."""
    store.batch_query(queries, k=k, **kw)   # warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = store.batch_query(queries, k=k, **kw)
        times.append(time.perf_counter() - t0)
    check(len(res) == len(queries) and all(len(r[0]) == k for r in res),
          f"batch_query returned the wrong shape at Q={len(queries)}")
    p50 = float(np.median(times))
    return {"Q": len(queries), "k": k, "p50_ms": p50 * 1e3,
            "qps": len(queries) / p50, "reps": reps}


def profile_device(fn, reps: int, expect: tuple[str, ...] = (),
                   tries: int = 3, lengths: dict | None = None
                   ) -> tuple[float, dict[str, float], dict[str, int], bool]:
    """torch.profiler over ``reps`` calls of fn after one warm call:
    the window's milliseconds a call (host clock, ending in a
    synchronize), device milliseconds a call by event name (events that
    ran on the device: kernels and copies), the events seen of each name,
    and whether the trace is whole: each kernel named (in part) in
    ``expect``, which fn launches once a call, seen ``reps`` times. The
    profiler drops events now and then; a trace that is not whole is
    taken again, up to ``tries`` times in all. ``lengths``, when given,
    is filled with each device event's own milliseconds, by name, from
    the last trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3 / reps
        by_name: dict[str, float] = {}
        counts: dict[str, int] = {}
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA:
                by_name[evt.key] = (by_name.get(evt.key, 0.0)
                                    + evt.self_device_time_total / reps / 1e3)
                counts[evt.key] = counts.get(evt.key, 0) + evt.count
        whole = bool(by_name) and all(
            n >= reps for n in launches_seen(counts, expect).values())
        if whole:
            break
    if lengths is not None:
        lengths.clear()
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA:
                lengths.setdefault(evt.key, []).append(
                    evt.self_device_time_total / 1e3)
    return window_ms, by_name, counts, whole


def launches_seen(counts: dict[str, int], expect: tuple[str, ...]
                  ) -> dict[str, int]:
    """Events seen of each kernel named (in part) in ``expect``."""
    return {e: max((n for name, n in counts.items() if e in name),
                   default=0) for e in expect}


def top_kernels(by_name: dict[str, float], n: int = 10) -> dict:
    """The n longest device events, names cut to 60 characters."""
    return {name[:60]: ms for name, ms in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:n]}


def merged_events(lengths: list[float]) -> bool:
    """Whether some of a kernel's events last more than ``MERGED_EVENT``
    times their median: the profiler folded several launches into one
    event, so the events are fewer than the launches but their summed
    time is whole."""
    if not lengths:
        return False
    median = float(np.median(lengths))
    return any(x > MERGED_EVENT * median for x in lengths)


def event_stats(lengths: dict[str, list[float]], expect: tuple[str, ...]
                ) -> dict:
    """Each kernel in ``expect``: its events in one trace, their median,
    shortest and longest milliseconds and every event's own length
    (``prof.events()``), in the trace's order."""
    out = {}
    for e in expect:
        names = [n for n in lengths if e in n]
        if names:
            ev = max((lengths[n] for n in names), key=len)
            out[e] = {"events": len(ev), "median_ms": float(np.median(ev)),
                      "min_ms": min(ev), "max_ms": max(ev),
                      "lengths_ms": ev}
    return out


def per_call_ms(by_name: dict[str, float], counts: dict[str, int],
                lengths: dict[str, list[float]], expect: tuple[str, ...],
                reps: int) -> dict[str, float]:
    """Device milliseconds a call by event name. A kernel in ``expect``
    (launched once a call) seen fewer than ``reps`` times is scaled by
    ``reps / seen`` only when its launches were dropped: when its events
    are short of time, not when some of them hold merged launches
    (``merged_events``), whose summed time stands whole."""
    out = {}
    for name, ms in by_name.items():
        seen = min(counts[name], reps)
        dropped = (any(e in name for e in expect) and seen < reps
                   and not merged_events(lengths.get(name, [])))
        out[name] = ms * reps / seen if dropped else ms
    return out


def device_ms(fn, reps: int, expect: tuple[str, ...],
              floor_ms: float = 0.0) -> dict:
    """The device time of one call of a kernel wrapper: the sum of the
    kernels it ran, from torch.profiler (CUDA events around back-to-back
    calls time the host once the device part is shorter than the
    wrapper's host time). ``expect``: the kernels it launches once a
    call. The profiler drops a launch now and then (a trace that saw
    fewer than half of them is refused), and now and then folds launches
    into one event without losing their time: ``per_call_ms`` tells the
    two apart by each event's own length. It also reads a trace at about
    half its time now and then, so one trace is not believed alone:
    traces are taken, at most ``TRACES_MAX``, until three agree within
    ``TRACE_MARGIN`` of their median, and that median is the result
    (with several such triples, the slowest). A trace below ``floor_ms``
    (the call's bound: no card does the work in less) is refused. With
    no three agreeing it is "not measured". Every trace's sum is given
    (``device_ms_traces``)."""
    sums, kept, seen = [], [], {}
    agree = None
    lengths: dict[str, list[float]] = {}
    for _ in range(TRACES_MAX):
        _, by_name, counts, _ = profile_device(fn, reps, expect, tries=1,
                                               lengths=lengths)
        seen = launches_seen(counts, expect)
        if not by_name or any(2 * n < reps for n in seen.values()):
            continue
        per_call = per_call_ms(by_name, counts, lengths, expect, reps)
        total = sum(per_call.values())
        sums.append(total)
        if total >= floor_ms:
            kept.append((total, per_call, event_stats(lengths, expect)))
            agree = agreeing(kept)
            if agree:
                break
    if not agree:
        return {"device_ms": "not measured (no three traces agree)",
                "device_ms_traces": sums, "launches_seen": seen,
                "reps": reps}
    merges = [merge_kernels(t) for _, t, _ in agree]
    return {"device_ms": agree[1][0], "device_ms_traces": sums,
            "launches_seen": seen,
            "device_ms_by_kernel": top_kernels(agree[1][1]),
            "events_ms": agree[1][2],
            "merge_small_k_ran": all(m[0] for m in merges),
            "merge_topk_kernel_ran": any(m[1] for m in merges)}


def agreeing(traces: list[tuple]) -> list | None:
    """Three traces, by sum ascending, that lie within ``TRACE_MARGIN`` of
    the middle one's sum; the slowest such three, or None."""
    ordered = sorted(traces, key=lambda t: t[0])
    for i in range(len(ordered) - 3, -1, -1):
        three = ordered[i:i + 3]
        if three[2][0] - three[0][0] <= TRACE_MARGIN * three[1][0]:
            return three
    return None


def merge_kernels(by_name: dict[str, float]) -> tuple[bool, bool]:
    """Whether merge_small_k ran, and whether merge_topk_kernel ran."""
    return (any("merge_small_k" in n for n in by_name),
            any("merge_topk_kernel" in n for n in by_name))


def device_share(store, queries: np.ndarray, k: int, reps: int,
                 expect: tuple[str, ...], **kw) -> dict:
    """torch.profiler over ``reps`` batch_query calls: device time by
    kernel (events that ran on the device: kernels and copies) and the
    device's busy share of the window. The profiler slows the host, so the
    share is a lower bound of the unprofiled one. ``expect``: the kernels
    a call launches once (``profile_device``); ``kernel_device_ms`` is
    their time alone. For k <= 32 every merge must be merge_small_k.
    ``kw`` goes to batch_query. ``events_ms``: the expected kernels'
    own event lengths in the trace read (``event_stats``)."""
    lengths: dict[str, list[float]] = {}
    window_ms, by_name, seen, whole = profile_device(
        lambda: store.batch_query(queries, k=k, **kw), reps, expect,
        lengths=lengths)
    busy_ms = sum(by_name.values())
    out = {"Q": len(queries), "k": k, "reps": reps,
           "window_ms_per_call": window_ms,
           "events_ms": event_stats(lengths, expect)}
    small, old = merge_kernels(by_name)
    if k <= 32:
        check(not old and (small or not whole), f"a k <= 32 call at "
              f"Q={len(queries)} did not merge with merge_small_k alone "
              f"({sorted(by_name)})")
    if not whole:
        out["device_ms_per_call"] = "not measured (the profiler missed " \
            "events)"
        out["launches_seen"] = launches_seen(seen, expect)
        out["device_ms_per_call_by_events"] = events_per_call(
            by_name, lengths, expect)
        return out
    out.update(device_ms_per_call=busy_ms,
               device_busy_share=busy_ms / window_ms,
               kernel_device_ms=sum(ms for name, ms in by_name.items()
                                    if any(e in name for e in expect)),
               device_ms_by_kernel=top_kernels(by_name))
    return out


def events_per_call(by_name: dict[str, float],
                    lengths: dict[str, list[float]],
                    expect: tuple[str, ...]) -> float:
    """A call's device milliseconds from a trace that lost events of the
    kernels in ``expect`` (each launched once a call): each such kernel
    at its median event's length, every other event name at its summed
    time a call. It reads the events' own lengths, not their count."""
    return sum(float(np.median(lengths[name]))
               if any(e in name for e in expect) and lengths.get(name)
               else ms for name, ms in by_name.items())


def agreement(dev_ms, share: dict) -> dict:
    """Whether ``device_ms`` and the per-call device time of
    ``device_share``'s trace of the same call agree within
    ``TRACE_MARGIN`` of the latter, or why they cannot be held together.
    A share trace that lost events is read by its events' lengths
    (``events_per_call``)."""
    share_ms = share.get("device_ms_per_call", "not measured")
    out = {"device_share_ms": share_ms}
    if isinstance(share_ms, str) and "device_ms_per_call_by_events" in share:
        share_ms = share["device_ms_per_call_by_events"]
        out["device_share_ms_by_events"] = share_ms
    if isinstance(dev_ms, str) or isinstance(share_ms, str):
        out["agreement"] = "not compared: one of them was not measured"
    else:
        out["agreement"] = abs(dev_ms - share_ms) <= TRACE_MARGIN * share_ms
    return out


def exact_topk(db_rows, queries, k: int, metric: str):
    """Ground truth on the card: full f32 product + topk."""
    import torch
    q = torch.from_numpy(queries).cuda()
    if metric == "cosine":
        q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
        keys = q @ db_rows.T
    else:
        keys = 2 * q @ db_rows.T - torch.sum(db_rows * db_rows, dim=1)
    return torch.topk(keys, k, dim=1), keys


def tie_aware_recall(results, keys, gt_vals, k: int) -> float:
    """A returned id counts if its exact key reaches the exact k-th."""
    hits = 0
    keys = keys.cpu().numpy()
    kth = gt_vals[:, k - 1].cpu().numpy()
    for qi, (ids, _, _) in enumerate(results):
        tol = 1e-6 + 1e-5 * abs(kth[qi])   # f32 rounding of the key
        hits += int(np.sum(keys[qi, ids] >= kth[qi] - tol))
    return hits / (len(results) * k)


def counted(fn, expect: str, forbid: tuple[str, ...] = ()):
    """Run fn and require that kernel ``expect`` was launched by it and
    no kernel in ``forbid`` was."""
    from tpu_vector_db_torch.ops.launches import LAUNCHES
    before = dict(LAUNCHES)
    out = fn()
    check(LAUNCHES[expect] > before[expect],
          f"{expect} was not launched by this case")
    for name in forbid:
        check(LAUNCHES[name] == before[name],
              f"{name} was launched by a case routed to {expect}")
    return out


# an ANN-routed call (IVF or graph) launches no flat scan: an ANN failure
# that fell back to the exact scan would fail the run
FLAT_SCANS = ("scan_kernel", "scan_kernel_bigk")


def free_card() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def path_main(g, seed: int, tmp: Path, counts: dict, errs: dict) -> None:
    """1M x 768 f32 cosine: the default store, with metadata."""
    from tpu_vector_db_torch import create_vector_store
    d = 768
    rows = unit_rows(g, N, d)
    meta = [{"cat": i % 16} for i in range(N)]
    qs = rows[:64].cpu().numpy() + 0.05 * np.random.default_rng(
        seed).standard_normal((64, d)).astype(np.float32)
    with counting("main", ("scan_kernel", "scan_kernel_bigk"), counts):
        store = create_vector_store(tmp / "main", dimension=d,
                                    device="cuda", persist_mode="lazy")
        add_s = fill_store(store, rows, 131072, meta)
        stats = store.get_stats()
        check(stats["vector_count"] == N, "vector_count after add")
        emit({"phase": "main", "case": f"add {N}x768 f32", "seconds":
              add_s, "device_capacity": stats["device_capacity"]})
        for q_n, reps in ((1, 20), (64, 10)):
            r = counted(lambda: timed_queries(store, qs[:q_n], 10, reps),
                        "scan_kernel")
            emit({"phase": "main", "case": f"768D f32 top-10 b{q_n}", **r})
        r = counted(lambda: timed_queries(store, qs[:1], 100, 10),
                    "scan_kernel_bigk")
        emit({"phase": "main", "case": "768D f32 top-100 b1", **r})
        # past the TPU big-k kernel's k = 1024
        r = counted(lambda: timed_queries(store, qs[:1], 2000, 5),
                    "scan_kernel_bigk")
        emit({"phase": "main", "case": "768D f32 top-2000 b1", **r})
        for q_n, reps in ((1, 20), (64, 5)):
            r = counted(lambda: device_share(store, qs[:q_n], 10, reps,
                                            expect_flat(10)),
                        "scan_kernel")
            emit({"phase": "main", "case": f"768D f32 top-10 b{q_n} "
                  "profiled", **r})
        res = counted(lambda: store.query(
            qs[0], k=10, filter_metadata={"cat": 3}), "scan_kernel")
        check(len(res[0]) == 10 and all(m["cat"] == 3 for m in res[2]),
              "filtered query returned a non-matching row")
        # self-query: every stored row is its own nearest neighbour
        self_ids = [7, N // 2, N - 1]
        res = counted(lambda: store.batch_query(
            rows[self_ids].cpu().numpy(), k=1), "scan_kernel")
        for rid, (ids, scores, _) in zip(self_ids, res):
            check(ids[0] == rid and scores[0] > 0.999,
                  f"self-query of row {rid} returned {ids[0]} ({scores[0]})")
        # recall@10 of 16 queries against the exact f32 ground truth
        res = counted(lambda: store.batch_query(qs[:16], k=10),
                      "scan_kernel")
        (gt_vals, _), keys = exact_topk(store._db[:N], qs[:16], 10, "cosine")
        recall = tie_aware_recall(res, keys, gt_vals, 10)
        check(recall == 1.0, f"recall@10 = {recall}")
        emit({"phase": "main", "case": "recall@10 16q", "recall": recall})
        del keys
        # delete the top hit of query 0, then query again
        top = res[0][0][0]
        store.delete_vectors([top])
        res2 = counted(lambda: store.query(qs[0], k=10), "scan_kernel")
        check(top not in res2[0] and res2[0][:9] == res[0][0][1:10],
              "delete: the deleted row came back or the order changed")
        emit({"phase": "main", "case": "delete then query", "deleted": top,
              "ok": True})
    for q_n, k, flt in ((1, 10, None), (64, 10, None), (1, 100, None),
                        (1, 2000, None), (1, 10, {"cat": 3})):
        hold_store(store, "main", qs[:q_n], k, errs, flt)
    r = counted(lambda: device_share(store, qs[:1], 2000, 5,
                                    expect_flat(2000)),
                "scan_kernel_bigk")
    emit({"phase": "main", "case": "768D f32 top-2000 b1 profiled", **r})
    del store, rows, meta
    free_card()


def path_config2(g, tmp: Path, counts: dict, errs: dict) -> None:
    """BASELINE config #2: 1M x 128 euclidean, batch 64, top-100."""
    import torch
    from tpu_vector_db_torch import create_vector_store
    d = 128
    rows = torch.randn((N, d), generator=g, device="cuda")
    qs = torch.randn((64, d), generator=g, device="cuda").cpu().numpy()
    with counting("config2", ("scan_kernel_bigk",), counts):
        store = create_vector_store(tmp / "c2", dimension=d,
                                    metric="euclidean", device="cuda",
                                    persist_mode="off")
        add_s = fill_store(store, rows, 262144, None)
        r = counted(lambda: timed_queries(store, qs, 100, 10),
                    "scan_kernel_bigk")
        res = store.batch_query(qs[:8], k=100)
        (gt_vals, _), keys = exact_topk(rows, qs[:8], 100, "euclidean")
        recall = tie_aware_recall(res, keys, gt_vals, 100)
        check(recall == 1.0, f"config #2 recall@100 = {recall}")
        emit({"phase": "main", "case": f"config2 {N}x128 L2 top-100 b64",
              "add_seconds": add_s, "recall@100_8q": recall, **r})
    hold_store(store, "config2", qs, 100, errs)
    r = counted(lambda: device_share(store, qs, 100, 5, expect_flat(100)),
                "scan_kernel_bigk")
    emit({"phase": "main", "case": f"config2 {N}x128 L2 top-100 b64 "
          "profiled", **r})
    del store, rows, keys
    free_card()


def path_config4(g, seed: int, tmp: Path, counts: dict, errs: dict) -> None:
    """BASELINE config #4: 1M x 1536 bf16 cosine, top-10 at batch 1 and
    64, and the rerank oversample (k=10 -> 40, the big-k kernel)."""
    from tpu_vector_db_torch import create_vector_store
    d = 1536
    rows = unit_rows(g, N, d)
    qs = rows[:64].cpu().numpy() + 0.05 * np.random.default_rng(
        seed + 4).standard_normal((64, d)).astype(np.float32)
    with counting("config4", ("scan_kernel", "scan_kernel_bigk"), counts):
        store = create_vector_store(tmp / "c4", dimension=d, device="cuda",
                                    storage_dtype="bfloat16",
                                    persist_mode="off")
        add_s = fill_store(store, rows, 65536, None)
        for q_n, reps in ((1, 20), (64, 10)):
            r = counted(lambda: timed_queries(store, qs[:q_n], 10, reps),
                        "scan_kernel")
            emit({"phase": "main", "case": f"config4 {N}x1536 bf16 "
                  f"top-10 b{q_n}", **r})
        r = counted(lambda: timed_queries(store, qs[:1], 10, 10,
                                          rerank=True), "scan_kernel_bigk")
        res = store.batch_query(qs[:4], k=10, rerank=True)
        (gt_vals, _), keys = exact_topk(rows, qs[:4], 10, "cosine")
        recall = tie_aware_recall(res, keys, gt_vals, 10)
        check(recall == 1.0, f"config #4 rerank recall@10 = {recall}")
        emit({"phase": "main", "case": "config4 rerank top-10 b1",
              "add_seconds": add_s, "recall@10_4q": recall, **r})
        # rerank top-300: a scan of 1200 rows, past the TPU kernel's 1024
        r = counted(lambda: timed_queries(store, qs[:1], 300, 5,
                                          rerank=True), "scan_kernel_bigk")
        res = store.batch_query(qs[:2], k=300, rerank=True)
        (gt_vals, _), keys = exact_topk(rows, qs[:2], 300, "cosine")
        recall = tie_aware_recall(res, keys, gt_vals, 300)
        check(recall == 1.0, f"config #4 rerank recall@300 = {recall}")
        emit({"phase": "main", "case": "config4 rerank top-300 b1",
              "recall@300_2q": recall, **r})
    for q_n, k in ((1, 10), (64, 10), (1, 40), (1, 1200)):
        hold_store(store, "config4", qs[:q_n], k, errs)
    del store, rows, keys
    free_card()


def path_config1(g, seed: int, tmp: Path, counts: dict, errs: dict) -> None:
    """BASELINE config #1: 100K x 384, delete, flush + reopen."""
    import torch
    from tpu_vector_db_torch import TorchVectorStore, create_vector_store
    d, n1 = 384, 100_000
    rows = unit_rows(g, n1, d).cpu().numpy()
    qs = rows[:8] + 0.05 * np.random.default_rng(seed + 1).standard_normal(
        (8, d)).astype(np.float32)
    with counting("config1", ("scan_kernel",), counts):
        store = create_vector_store(tmp / "c1", dimension=d, device="cuda",
                                    persist_mode="lazy")
        fill_store(store, torch.from_numpy(rows), 50000,
                   [{"i": i} for i in range(n1)])
        store.delete_vectors([3, 5])
        before = counted(lambda: store.batch_query(qs, k=10),
                         "scan_kernel")
        r = counted(lambda: timed_queries(store, qs[:1], 10, 20),
                    "scan_kernel")
        t0 = time.perf_counter()
        store.flush()
        flush_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        reopened = TorchVectorStore(tmp / "c1", device="cuda")
        reopen_s = time.perf_counter() - t0
        after = counted(lambda: reopened.batch_query(qs, k=10),
                        "scan_kernel")
        check([a[0] for a in after] == [b[0] for b in before]
              and reopened.get_stats()["deleted_count"] == 2,
              "reopened store answers differently")
        emit({"phase": "main", "case": "config1 100Kx384 b1", **r,
              "flush_seconds": flush_s, "reopen_seconds": reopen_s})
    for s, q_n in ((store, 8), (store, 1), (reopened, 8)):
        hold_store(s, "config1", qs[:q_n], 10, errs)
    del store, reopened
    free_card()


# BASELINE config #3's regime, generated as bench.py's _clustered_db does:
# unit rows around 4096 normal centres with 0.2 normal noise per component
IVF_CENTERS, IVF_SPREAD = 4096, 0.2


def clustered_rows(g, centres, n: int):
    import torch
    pick = torch.randint(0, centres.shape[0], (n,), generator=g,
                         device="cuda")
    x = centres[pick] + IVF_SPREAD * torch.randn(
        (n, centres.shape[1]), generator=g, device="cuda")
    return unit_(x)


def hold_index(store, path: str, queries: np.ndarray, k: int, errs: dict,
               timed: bool = False, label: str = "built") -> dict:
    """The IVF kernel against its plain version on the store's own index:
    its buckets, ids and fills, and the buckets its centroids select for
    these queries at the store's nprobe. ``label`` names the store
    ("built" here, or "reopened" from its files)."""
    from tpu_vector_db_torch.index.ivf import _select_buckets
    ann = store._ann
    ann._ensure_device(store._db, store._sqnorms)  # current after an add
    dev = ann._dev
    nprobe = min(store.config.ann_params.get("nprobe") or ann.nprobe,
                 dev["ids"].shape[0])
    q = store._prepare_queries(queries)
    sel = _select_buckets(q, dev["centroids"], dev["bucket_cluster"], nprobe,
                          store.metric, dev["c_sqnorms"])
    out = hold_ivf(q, dev["buckets"], dev["ids"], dev["fills"], sel, k,
                   {"phase": "hold", "path": path, "store": label},
                   timed=timed)
    errs["ivf_kernel"] = max(errs.get("ivf_kernel", 0.0), out["max_abs_err"])
    return out


def hold_gather(store, path: str, queries: np.ndarray, k: int, errs: dict,
                timed: bool = False) -> dict:
    """The gather layout's IVF kernel (``ivf_gather_topk``) against its
    plain version (``ivf_probe_topk_gather``) on the store's own index:
    its rows (and int4 scales), id table and fills, and the buckets its
    centroids select for these queries at the store's nprobe. Keys are
    compared on the cosine scale (int8 raw keys over 127). With
    ``timed``, kernel and plain times, the device time and the bound."""
    import torch
    from tpu_vector_db_torch.index.ivf import _select_buckets
    from tpu_vector_db_torch.ops import ivf_scan
    from tpu_vector_db_torch.ops.launches import LAUNCHES
    ann = store._ann
    ann._ensure_device(store._db, store._sqnorms)  # current after an add
    dev = ann._dev
    nprobe = min(store.config.ann_params.get("nprobe") or ann.nprobe,
                 dev["ids"].shape[0])
    q = store._prepare_queries(queries)
    sel = _select_buckets(q, dev["centroids"], dev["bucket_cluster"], nprobe,
                          store.metric, dev["c_sqnorms"])
    db, scales = store._db, store._scales
    args = (q, db, dev["ids"], dev["fills"], sel, k)

    def kernel():
        return ivf_scan.ivf_gather_topk(*args, db_scales=scales)

    def plain():
        return ivf_scan.ivf_probe_topk_gather(q, db, dev["ids"], sel, k,
                                              db_scales=scales)
    before = LAUNCHES["ivf_gather_kernel"]
    keys, got_ids = kernel()
    launches = LAUNCHES["ivf_gather_kernel"] - before
    pkeys, pids = plain()
    unit = 1.0 / 127.0 if db.dtype == torch.int8 else 1.0
    err, keys_ok, ids_ok = compare(keys * unit, got_ids, pkeys * unit, pids,
                                   "cosine")
    dtype = {torch.int8: "int8", torch.uint8: "int4"}.get(
        db.dtype, str(db.dtype).replace("torch.", ""))
    out = {"kernel": "ivf_gather_kernel", "phase": "hold", "path": path,
           "Q": q.shape[0], "nprobe": sel.shape[1], "k": k,
           "NB": dev["ids"].shape[0], "Bc": dev["ids"].shape[1],
           "rows": store._count, "d": q.shape[1], "dtype": dtype,
           "max_abs_err": err, "key_tol": KEY_TOL, "keys_ok": keys_ok,
           "ids_ok": ids_ok, "launches": launches}
    if timed:
        out["kernel_ms"] = cuda_ms(kernel, 10)
        out["plain_ms"] = cuda_ms(plain, 2)
        out["bound_ms"], out["bound_by"] = ivf_bound(
            dev["fills"], sel, db.shape[1] * db.element_size(), q.shape[1],
            k, dtype)
        out.update(device_ms(kernel, 10, expect_gather(k), out["bound_ms"]))
    emit(out)
    errs["ivf_gather_kernel"] = max(errs.get("ivf_gather_kernel", 0.0), err)
    check(launches == 1,
          f"ivf_gather_kernel launched {launches} times in one call")
    check(keys_ok and ids_ok, f"ivf_gather_kernel disagrees with its plain "
          f"version ({path}, Q={q.shape[0]} nprobe={sel.shape[1]} k={k}, "
          f"key error {err})")
    return out


def path_ivf(g, tmp: Path, counts: dict, errs: dict) -> dict:
    """BASELINE config #3's regime: 1M x 768 f32 cosine clustered rows in
    the default store with enable_ann=True. Returns the IVF kernel's
    headline timings (batch 1, top-10, on this index)."""
    import torch
    from tpu_vector_db_torch import create_vector_store
    d, batch = 768, 125_000
    centres = torch.randn((IVF_CENTERS, d), generator=g, device="cuda")
    qs = clustered_rows(g, centres, 64).cpu().numpy()
    with counting("ivf", ("ivf_kernel",), counts):
        store = create_vector_store(tmp / "ivf", dimension=d, device="cuda",
                                    persist_mode="lazy", enable_ann=True)
        # the first batch (>= 100K rows) builds the index; the others
        # extend it, spilling into new buckets
        add_s = []
        for start in range(0, N, batch):
            rows = clustered_rows(g, centres, min(batch, N - start)).cpu()
            t0 = time.perf_counter()
            store.add_vectors(rows.numpy())
            add_s.append(time.perf_counter() - t0)
        check(store.get_stats()["index_type"] == "ivf",
              "the 1M store did not resolve to IVF")
        inc = store._ann.get_stats()
        emit({"phase": "ivf", "case": f"add {N}x768 f32 in {len(add_s)} "
              "batches", "first_add_with_build_seconds": add_s[0],
              "later_adds_seconds": sum(add_s[1:]), "add_seconds": add_s,
              "clusters": inc["clusters"], "buckets": inc["buckets"],
              "bucket_rows": inc["bucket_rows"],
              "nprobe": store._ann.nprobe,
              "ann_recall_estimate": store.get_stats()["ann_recall_estimate"]})
        t0 = time.perf_counter()
        store.optimize()
        opt_s = time.perf_counter() - t0
        ann = store._ann
        st = ann.get_stats()
        nb = st["buckets"]
        emit({"phase": "ivf", "case": "optimize (full rebuild)",
              "seconds": opt_s, "index_build_seconds": ann.build_time_s,
              "clusters": st["clusters"], "buckets": nb,
              "bucket_rows": st["bucket_rows"],
              "fill_ratio": st["fill_ratio"], "nprobe": ann.nprobe,
              "ann_recall_estimate": store.get_stats()["ann_recall_estimate"],
              "bucket_copy_mb": st["memory_mb"]})
        for q_n, reps in ((1, 20), (8, 10)):
            r = counted(lambda: timed_queries(store, qs[:q_n], 10, reps),
                        "ivf_kernel", FLAT_SCANS)
            emit({"phase": "ivf", "case": f"768D IVF top-10 b{q_n}",
                  "nprobe": ann.nprobe, **r})
        profiled = counted(lambda: device_share(store, qs[:1], 10, 20,
                                                EXPECT_IVF),
                           "ivf_kernel", FLAT_SCANS)
        emit({"phase": "ivf", "case": "768D IVF top-10 b1 profiled",
              **profiled})
        # recall@10 of 64 queries, in batches of 8 (auto mode sends
        # batches of 32 and more to the exact scan)
        res = []
        for i in range(0, 64, 8):
            res += counted(lambda: store.batch_query(qs[i:i + 8], k=10),
                           "ivf_kernel", FLAT_SCANS)
        (gt_vals, _), keys = exact_topk(store._db[:N], qs, 10, "cosine")
        recall = tie_aware_recall(res, keys, gt_vals, 10)
        emit({"phase": "ivf", "case": "recall@10 64q", "recall": recall,
              "nprobe": ann.nprobe})
        check(recall >= 0.95, f"IVF recall@10 = {recall} < 0.95")
        del keys
        # a full probe returns the flat scan's top-10
        prepared = store._prepare_queries(qs[:8])
        ids, keys = counted(lambda: ann.search(
            prepared, store._db, store._count, k=10, nprobe=nb),
            "ivf_kernel", FLAT_SCANS)
        fkeys, fids = store._flat_topk(qs[:8], 10, None)
        err, keys_ok, ids_ok = compare(
            torch.from_numpy(keys), torch.from_numpy(ids),
            torch.from_numpy(fkeys), torch.from_numpy(fids), "cosine")
        emit({"phase": "ivf", "case": "full probe vs flat top-10 8q",
              "nprobe": nb, "max_abs_err": err, "keys_ok": keys_ok,
              "ids_ok": ids_ok})
        check(keys_ok and ids_ok, "a full IVF probe differs from the flat "
              f"scan (key error {err})")
        # batch 64 (auto mode) and top-100 route to the exact scan
        counted(lambda: store.batch_query(qs, k=10), "scan_kernel",
                ("ivf_kernel",))
        counted(lambda: store.batch_query(qs[:1], k=100), "scan_kernel_bigk",
                ("ivf_kernel",))
        emit({"phase": "ivf", "case": "routing", "b64_top10": "scan_kernel",
              "b1_top100": "scan_kernel_bigk", "ok": True})
        # auto mode's batch crossover (32) comes from the JAX store: time
        # batches 32 and 64 both ways on this store, the exact scan (auto)
        # and the IVF kernel (index_type='ivf', which has no crossover)
        p = store.config.ann_params
        for q_n in (32, 64):
            exact = counted(lambda: timed_queries(store, qs[:q_n], 10, 10),
                            "scan_kernel", ("ivf_kernel",))
            p["index_type"] = "ivf"
            try:
                ivf = counted(lambda: timed_queries(store, qs[:q_n], 10, 10),
                              "ivf_kernel", FLAT_SCANS)
            finally:
                p["index_type"] = "auto"
            emit({"phase": "ivf", "case": f"crossover top-10 b{q_n}",
                  "exact_p50_ms": exact["p50_ms"],
                  "ivf_p50_ms": ivf["p50_ms"], "exact_qps": exact["qps"],
                  "ivf_qps": ivf["qps"], "nprobe": ann.nprobe})
    headline = None
    for q_n in (1, 8, 64):
        out = hold_index(store, "ivf", qs[:q_n], 10, errs, timed=q_n == 1)
        if q_n == 1:
            headline = dict(design="probe", ms=out["kernel_ms"],
                            device_ms=out["device_ms"],
                            plain_ms=out["plain_ms"],
                            bound_ms=out["bound_ms"],
                            bound_by=out["bound_by"], library_ms=None,
                            yardstick_ms=out["yardstick_ms"],
                            yardstick=IVF_YARDSTICK)
    del store, ann
    free_card()
    return headline


def path_ivf_small(g, tmp: Path, counts: dict, errs: dict) -> None:
    """200K x 384 bf16 cosine with enable_ann=True: flush, reopen, and the
    index served from its ann_ivf.npz without a rebuild."""
    import torch
    from tpu_vector_db_torch import TorchVectorStore, create_vector_store
    d, n = 384, 200_000
    centres = torch.randn((IVF_CENTERS, d), generator=g, device="cuda")
    qs = clustered_rows(g, centres, 8).cpu().numpy()
    rows = clustered_rows(g, centres, n).cpu().numpy()
    with counting("ivf_small", ("ivf_kernel",), counts):
        store = create_vector_store(tmp / "ivf_small", dimension=d,
                                    device="cuda", storage_dtype="bfloat16",
                                    persist_mode="lazy", enable_ann=True)
        t0 = time.perf_counter()
        store.add_vectors(rows[: n // 2])        # builds the index
        store.add_vectors(rows[n // 2:])         # extends it
        add_s = time.perf_counter() - t0
        check(store.get_stats()["index_type"] == "ivf"
              and store._ann.size == n, "the bf16 store has no full index")
        before = counted(lambda: store.batch_query(qs, k=10), "ivf_kernel",
                         FLAT_SCANS)
        r = counted(lambda: timed_queries(store, qs[:1], 10, 20),
                    "ivf_kernel", FLAT_SCANS)
        t0 = time.perf_counter()
        store.flush()
        flush_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        reopened = TorchVectorStore(tmp / "ivf_small", device="cuda")
        reopen_s = time.perf_counter() - t0
        served = (reopened._ann is not None and not reopened._ann_stale
                  and reopened._ann.size == n
                  and reopened._ann.build_time_s == 0.0)
        check(served, "the reopened store rebuilt its index instead of "
              "serving ann_ivf.npz")
        after = counted(lambda: reopened.batch_query(qs, k=10), "ivf_kernel",
                        FLAT_SCANS)
        check([a[0] for a in after] == [b[0] for b in before],
              "the reopened store answers differently")
        emit({"phase": "ivf_small", "case": f"{n}x{d} bf16 IVF top-10 b1",
              **r, "add_seconds": add_s, "flush_seconds": flush_s,
              "reopen_seconds": reopen_s, "sidecar_served": served,
              "same_answers": True, "nprobe": reopened._ann.nprobe,
              "buckets": reopened._ann.get_stats()["buckets"]})
    for s_, q_n, label in ((store, 1, "built"), (store, 8, "built"),
                           (reopened, 8, "reopened")):
        hold_index(s_, "ivf_small", qs[:q_n], 10, errs, label=label)
    del store, reopened
    free_card()


# ------------------------------------------------------- the graph paths

# The JAX package's graph regime, "realistic spread"
# (benchmarks/beam_ef_sweep.py:29-36,106): 300 centres drawn from N(0, I),
# each row its centre plus 1.0 N(0, I); the cosine store normalizes them.
# 150K rows (the regime's 300K halved for the script's time limit)
GRAPH_N, GRAPH_ADDS, GRAPH_CENTRES = 150_000, 3, 300
GRAPH_QUERIES, GRAPH_EXTRA = 1000, 10_000


def spread_rows(g, centres, n: int):
    import torch
    pick = torch.randint(0, centres.shape[0], (n,), generator=g,
                         device="cuda")
    return centres[pick] + torch.randn((n, centres.shape[1]), generator=g,
                                       device="cuda")


def ann_routed(fn):
    """Run fn; no flat-scan kernel may launch in it (the store's
    ANN->exact fallback would hide a failing graph search or gather-IVF
    probe, neither of which launches a kernel of ours)."""
    from tpu_vector_db_torch.ops.launches import LAUNCHES
    before = {name: LAUNCHES[name] for name in FLAT_SCANS}
    out = fn()
    launched = {name: LAUNCHES[name] - before[name] for name in FLAT_SCANS}
    check(not any(launched.values()), f"an ANN-routed call launched "
          f"{launched}: the store fell back to the exact scan")
    return out


@contextlib.contextmanager
def recording(cls, name: str, calls: list):
    """cls.name wrapped for the block: each call appends its result."""
    fn = getattr(cls, name)

    def spy(*a, **kw):
        calls.append(fn(*a, **kw))
        return calls[-1]

    setattr(cls, name, spy)
    try:
        yield calls
    finally:
        setattr(cls, name, fn)


@contextlib.contextmanager
def timed_passes(ann):
    """The index's insert pass and refine pass, each timed to the device's
    end for the block (instance attributes over the class's methods,
    removed after it); yields the seconds of each."""
    import torch
    seconds = {"insert": 0.0, "refine": 0.0}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            seconds[name] += time.perf_counter() - t0
            return out
        return run

    ann._insert_range = timed("insert", ann._insert_range)
    ann.refine = timed("refine", ann.refine)
    try:
        yield seconds
    finally:
        del ann._insert_range, ann.refine


def ann_profiled(store, queries: np.ndarray, k: int, reps: int) -> dict:
    """torch.profiler over ``reps`` ANN-routed batch_query calls: the
    window, the device's time by op and its busy share (the profiler
    slows the host, so the share is a lower bound)."""
    window_ms, by_name, _, _ = ann_routed(lambda: profile_device(
        lambda: store.batch_query(queries, k=k), reps))
    busy = sum(by_name.values())
    return {"Q": len(queries), "k": k, "reps": reps,
            "window_ms_per_call": window_ms, "device_ms_per_call": busy,
            "device_busy_share": busy / window_ms,
            "device_ms_by_op": top_kernels(by_name)}


def graph_recall(store, qs: np.ndarray, n: int, k: int = 10) -> float:
    """Tie-aware recall@k of graph-routed batches of 64 against the exact
    top-k of the store's own first n rows."""
    res = []
    for i in range(0, len(qs), 64):
        res += ann_routed(lambda: store.batch_query(qs[i:i + 64], k=k))
    db = store._db[:n, :store.config.dimension]
    (gt_vals, _), keys = exact_topk(db, qs, k, "cosine")
    return tie_aware_recall(res, keys, gt_vals, k)


def path_graph(g, seed: int, tmp: Path, counts: dict, errs: dict) -> dict:
    """150K x 768 f32 cosine in the JAX package's graph regime with
    enable_ann=True, index_type="beam_graph" and the graph's defaults:
    added in 3 x 50K (a build, then two incremental extends), rebuilt by
    optimize(); recall@10 at ef 100 and 200, batch 1/8/64 timed and
    profiled through the graph (no flat-scan launch), an incremental add,
    a 10% filter through the graph, a 1% filter through the exact scan,
    deletes, and a flush + reopen that serves ann_graph.npz."""
    import torch
    from tpu_vector_db_torch import TorchVectorStore, create_vector_store
    from tpu_vector_db_torch.index.beam_graph import BeamGraphIndex
    d, n = 768, GRAPH_N
    part = n // GRAPH_ADDS
    centres = torch.randn((GRAPH_CENTRES, d), generator=g, device="cuda")
    qs = spread_rows(g, centres, GRAPH_QUERIES).cpu().numpy()
    meta = [{"d10": i % 10, "d100": i % 100}
            for i in range(n + GRAPH_EXTRA)]
    out = {}
    with counting("graph", ("scan_kernel",), counts):
        store = create_vector_store(
            tmp / "graph", dimension=d, device="cuda", persist_mode="lazy",
            enable_ann=True, ann_params={"index_type": "beam_graph"})
        add_s = []
        for start in range(0, n, part):
            rows = spread_rows(g, centres, part).cpu().numpy()
            t0 = time.perf_counter()
            store.add_vectors(rows, meta[start:start + part])
            add_s.append(time.perf_counter() - t0)
        ann = store._ann
        check(isinstance(ann, BeamGraphIndex) and ann.size == n,
              "the graph does not cover the added rows")
        emit({"phase": "graph", "case": f"add {n}x{d} f32 in {GRAPH_ADDS} "
              "batches", "first_add_with_build_seconds": add_s[0],
              "incremental_add_seconds": add_s[1:],
              "ann_recall_estimate":
                  store.get_stats()["ann_recall_estimate"]})
        with timed_passes(ann) as passes:
            t0 = time.perf_counter()
            store.optimize()
            opt_s = time.perf_counter() - t0
        check(store._ann is ann, "optimize() replaced the graph index")
        st = ann.get_stats()
        out["build"] = {"optimize_seconds": opt_s,
                        "insert_pass_seconds": passes["insert"],
                        "refine_pass_seconds": passes["refine"],
                        "nodes": st["nodes"],
                        "avg_degree": st["avg_degree"],
                        "entries": len(ann._entries)}
        emit({"phase": "graph", "case": "optimize (full rebuild)",
              **out["build"], "build_time_s": ann.build_time_s,
              "M": st["M"], "ef_construction": st["ef_construction"],
              "alpha": st["alpha"], "graph_mb": st["memory_mb"]})
        p = store.config.ann_params
        for ef in (100, 200):
            p["ef_search"] = ef
            try:
                recall = graph_recall(store, qs, n)
            finally:
                p.pop("ef_search")
            out[f"recall_ef{ef}"] = recall
            emit({"phase": "graph", "case": f"recall@10 {GRAPH_QUERIES}q "
                  f"ef{ef}", "recall": recall})
        check(out["recall_ef100"] >= 0.95,
              f"graph recall@10 at ef 100 = {out['recall_ef100']} < 0.95")
        for q_n, reps in ((1, 20), (8, 10), (64, 10)):
            r = ann_routed(lambda: timed_queries(store, qs[:q_n], 10,
                                                   reps))
            out[f"b{q_n}"] = r
            emit({"phase": "graph", "case": f"768D graph top-10 b{q_n}",
                  **r})
            r = ann_profiled(store, qs[:q_n], 10, 5)
            emit({"phase": "graph", "case": f"768D graph top-10 b{q_n} "
                  "profiled", **r})
            out[f"b{q_n}_busy"] = r["device_busy_share"]

        # incremental add: the graph extends by insertion, no rebuild
        extra = spread_rows(g, centres, GRAPH_EXTRA).cpu().numpy()
        with recording(BeamGraphIndex, "build", []) as builds:
            t0 = time.perf_counter()
            store.add_vectors(extra, meta[n:])
            inc_s = time.perf_counter() - t0
        total = n + GRAPH_EXTRA
        check(not builds and store._ann is ann and ann.size == total,
              "the incremental add rebuilt the graph")
        res = ann_routed(lambda: store.batch_query(extra[:100], k=1))
        found = sum(r[0][0] == n + i for i, r in enumerate(res))
        check(found == 100, f"{100 - found} of 100 added rows did not "
              "return themselves first")
        emit({"phase": "graph", "case": f"incremental add {GRAPH_EXTRA}",
              "seconds": inc_s, "self_first": found, "nodes": ann.size})

        # a filter keeping 10% goes through the graph (post-filtered
        # oversample); one keeping 1% goes to the exact scan
        res = ann_routed(lambda: store.batch_query(
            qs[:64], k=10, filter_metadata={"d10": 3}))
        check(all(m["d10"] == 3 for r in res for m in r[2]),
              "the 10% filter returned a non-matching row")
        hits = [len(r[0]) for r in res]
        res = counted(lambda: store.batch_query(
            qs[:64], k=10, filter_metadata={"d100": 7}), "scan_kernel")
        check(all(len(r[0]) == 10 and all(m["d100"] == 7 for m in r[2])
                  for r in res), "the 1% filter's exact answer is wrong")
        emit({"phase": "graph", "case": "filters", "d10_route": "graph",
              "d10_mean_hits": float(np.mean(hits)), "d10_min_hits":
              min(hits), "d100_route": "scan_kernel"})

        # delete 1% of the rows: no deleted id comes back
        dead = np.random.default_rng(seed + 13).choice(
            total, total // 100, replace=False)
        store.delete_vectors(dead)
        res = ann_routed(lambda: store.batch_query(qs[:64], k=10))
        back = set(dead.tolist()) & {i for r in res for i in r[0]}
        check(not back and all(len(r[0]) == 10 for r in res),
              f"deleted ids came back: {sorted(back)[:5]}")
        emit({"phase": "graph", "case": "delete 1%", "deleted": len(dead),
              "returned_deleted": 0})

        # flush and reopen: the graph loads from ann_graph.npz, no build
        before = ann_routed(lambda: store.batch_query(qs[:64], k=10))
        t0 = time.perf_counter()
        store.flush()
        flush_s = time.perf_counter() - t0
        with recording(BeamGraphIndex, "build", builds):
            t0 = time.perf_counter()
            reopened = TorchVectorStore(tmp / "graph", device="cuda")
            reopen_s = time.perf_counter() - t0
        served = (not builds and isinstance(reopened._ann, BeamGraphIndex)
                  and not reopened._ann_stale
                  and reopened._ann.size == total
                  and reopened._ann.build_time_s == 0.0)
        check(served, "the reopened store rebuilt its graph instead of "
              "serving ann_graph.npz")
        after = ann_routed(lambda: reopened.batch_query(qs[:64], k=10))
        check([a[0] for a in after] == [b[0] for b in before],
              "the reopened store answers differently")
        emit({"phase": "graph", "case": "flush + reopen",
              "flush_seconds": flush_s, "reopen_seconds": reopen_s,
              "graph_served": served, "same_answers": True})
    hold_store(reopened, "graph", qs[:64], 10, errs, {"d100": 7})
    del store, reopened, ann
    free_card()
    return out


def path_graph_native(g, tmp: Path, counts: dict, errs: dict) -> dict:
    """10K x 768 f32 cosine with build_backend="cpu" on a CUDA store: the
    port's loader builds native/graph_builder.cpp at first use, the graph
    is built on the host and searched on the card."""
    import torch
    from tpu_vector_db_torch import create_vector_store
    from tpu_vector_db_torch.index import native
    from tpu_vector_db_torch.index.beam_graph import BeamGraphIndex
    d, n = 768, 10_000
    built_before = sorted(p.name for p in
                          (REPO / "native").glob("libvdbgraph-*.so"))
    centres = torch.randn((GRAPH_CENTRES, d), generator=g, device="cuda")
    rows = spread_rows(g, centres, n).cpu().numpy()
    qs = spread_rows(g, centres, 64).cpu().numpy()
    with counting("graph_native", (), counts):
        store = create_vector_store(
            tmp / "graph_native", dimension=d, device="cuda",
            persist_mode="off", enable_ann=True,
            ann_params={"index_type": "beam_graph", "build_backend": "cpu"})
        with recording(BeamGraphIndex, "build_cpu", []) as stats:
            t0 = time.perf_counter()
            store.add_vectors(rows)
            add_s = time.perf_counter() - t0
        check(native.available() and [s["backend"] for s in stats]
              == ["cpu-native"], f"the native builder did not build the "
              f"graph: {stats}")
        check(store._ann._graph_dev.device.type == "cuda",
              "the native graph is not on the card")
        recall = graph_recall(store, qs, n)
        out = {"native_build_seconds": stats[0]["build_time_s"],
               "add_seconds": add_s, "recall": recall,
               "compiled_here": not built_before}
        emit({"phase": "graph_native", "case": f"{n}x{d} f32 cpu-native "
              "build, card search", **out, "backend": stats[0]["backend"],
              "library": sorted(p.name for p in (REPO / "native").glob(
                  "libvdbgraph-*.so"))})
        check(recall >= 0.95, f"native graph recall@10 = {recall} < 0.95")
    hold_store(store, "graph_native", qs, 10, errs)
    del store
    free_card()
    return out


# ------------------------------------------------------- the serve path

# 125K rows: each 10K-row chunk of a `sync` upload rewrites the whole
# store, so its time grows as the rows squared (on the H100 1M rows took
# 314-381 s, 500K 75-110 s, 250K 27-35 s); 125K keep the script inside
# its time limit beside the paths added since
SERVE_N = N // 8
SERVE_PARTS = 4                 # /v1/batch/upload calls of 31,250 rows
SERVE_SEQUENTIAL = 50           # one client, one request at a time
SERVE_BURST, SERVE_IN_FLIGHT = 256, 64
SIM_TOL = 1e-5                  # f32 keys of two scan designs; 6 digits


class ServerThread:
    """The port's app on 127.0.0.1 at a free port, on its own event loop
    in a thread, so the client side (and torch.profiler) can run in this
    one. ``close`` runs the app's cleanup: the coalescer's aclose, then
    the manager's shutdown."""

    def __init__(self, app) -> None:
        import asyncio
        import threading
        from aiohttp import web
        self.loop = asyncio.new_event_loop()
        self.runner = web.AppRunner(app, access_log=None)
        self.loop.run_until_complete(self.runner.setup())
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        self.loop.run_until_complete(site.start())
        self.url = "http://127.0.0.1:%d" % self.runner.addresses[0][1]
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name="serve-loop", daemon=True)
        self.thread.start()

    def close(self) -> None:
        import asyncio
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(),
                                         self.loop).result(300)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(60)
        check(not self.thread.is_alive(), "the server loop did not stop")
        self.loop.close()


class Client:
    """An aiohttp session on its own event loop in this thread; each call
    runs to its end here. ``get``/``post`` return (status, JSON body)."""

    def __init__(self, url: str, key: str) -> None:
        import asyncio
        import aiohttp
        self.loop = asyncio.new_event_loop()
        self.url = url
        self.auth = {"Authorization": f"Bearer {key}"}
        self.session = self.run(self._open(aiohttp))

    async def _open(self, aiohttp):
        return aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=2 * SERVE_IN_FLIGHT),
            timeout=aiohttp.ClientTimeout(total=900))

    def run(self, coro):
        return self.loop.run_until_complete(coro)

    async def request(self, method: str, path: str, headers=None, **kw):
        async with self.session.request(
                method, self.url + path,
                headers={**self.auth, **(headers or {})}, **kw) as r:
            body = await (r.json() if r.content_type == "application/json"
                          else r.text())
            return r.status, body

    def get(self, path: str, **kw):
        return self.run(self.request("GET", path, **kw))

    def post(self, path: str, **kw):
        return self.run(self.request("POST", path, **kw))

    def close(self) -> None:
        self.run(self.session.close())
        self.loop.close()


def ok(reply, what: str, status: int = 200):
    check(reply[0] == status, f"{what}: HTTP {reply[0]} {reply[1]}")
    return reply[1]


def upload_part(client: Client, who: dict, rows: np.ndarray, start: int
                ) -> dict:
    """One /v1/batch/upload of rows (npz) and their {"cat": i % 16}
    metadata (jsonl), followed on its SSE stream to ``done``."""
    import io
    import aiohttp
    buf = io.BytesIO()
    np.savez(buf, vectors=rows)
    meta = "".join('{"cat": %d}\n' % (i % 16)
                   for i in range(start, start + len(rows)))
    form = aiohttp.FormData()
    form.add_field("user_id", who["user_id"])
    form.add_field("model_id", who["model_id"])
    form.add_field("vectors", buf.getvalue(), filename="vectors.npz",
                   content_type="application/octet-stream")
    form.add_field("metadata", meta.encode(), filename="metadata.jsonl",
                   content_type="application/jsonl")
    del buf
    body = ok(client.post("/v1/batch/upload", data=form), "upload", 202)
    events = client.get(body["stream"])[1]
    check("event: done" in events, "the upload's SSE stream did not end "
          "in done")
    op = ok(client.get(f"/v1/batch/operations/{body['op_id']}"),
            "operation status")
    check(op["status"] == "completed" and op["result"]["added"] == len(rows),
          f"upload at row {start}: {op['status']} {op['error']}")
    return op


def latencies(times: list[float]) -> dict:
    ms = np.asarray(times) * 1e3
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "requests": len(ms)}


async def burst(client: Client, who: dict, qs: np.ndarray, k: int,
                in_flight: int) -> tuple[list, list[float]]:
    """Every query of ``qs`` as its own /vectors/query, ``in_flight`` at a
    time; returns the result lists and each request's seconds."""
    import asyncio
    gate = asyncio.Semaphore(in_flight)
    bodies = [json.dumps({**who, "query": q.tolist(), "k": k})
              for q in qs]

    async def one(body):
        async with gate:
            t0 = time.perf_counter()
            status, out = await client.request(
                "POST", "/vectors/query", data=body,
                headers={"Content-Type": "application/json"})
            dt = time.perf_counter() - t0
        check(status == 200, f"burst query: HTTP {status} {out}")
        return out["results"], dt

    got = await asyncio.gather(*[one(b) for b in bodies])
    return [r for r, _ in got], [dt for _, dt in got]


def same_results(results: list[dict], ids, scores) -> bool:
    """REST results against the store's (ids, scores): similarities
    within SIM_TOL, ids equal where no other score is within 2 SIM_TOL."""
    got = np.array([r["similarity"] for r in results])
    scores = np.asarray(scores, np.float64)
    if len(got) != len(scores) or np.abs(got - scores).max() > SIM_TOL:
        return False
    for pos, r in enumerate(results):
        if np.sum(np.abs(scores - scores[pos]) <= 2 * SIM_TOL) == 1 \
                and r["index"] != ids[pos]:
            return False
    return True


def coalescer_stats(client: Client) -> dict:
    return ok(client.get("/performance/stats"), "performance stats")[
        "coalescer"]


SDK_GRAPH_ROWS = 4096            # rows of the SDK's hnsw store


def path_sdk(g, server, manager, who: dict, qs: np.ndarray,
             counts: dict, errs: dict) -> None:
    """The port's SDK (httpx, the sync client) against the serve path's
    server: health; 10 queries and one batch query on its store, each
    equal to the store's own batch_query; a graph store made through
    /admin/create_store with index_type="hnsw", filled through the batch
    API and queried (through the graph: no flat-scan launch)."""
    from tpu_vector_db_torch.sdk import create_client
    from tpu_vector_db_torch.security.auth import auth_config
    key = auth_config.admin_key
    user, model = who["user_id"], who["model_id"]
    store = manager.get_store(**who, create=False)
    d = store.config.dimension
    with counting("sdk", ("scan_kernel",), counts), create_client(
            base_url=server.url, api_key=key, admin_key=key,
            sync=True) as sdk:
        health = sdk.health_check()
        check(health["status"] in ("healthy", "degraded"),
              f"SDK health: {health}")
        direct = store.batch_query(qs[:10], k=10)
        for i, (ids, scores, _) in enumerate(direct):
            res = sdk.query_vectors(user, model, qs[i], k=10)
            check(same_results([vars(r) for r in res], ids, scores),
                  f"SDK query {i} differs from the store's batch_query")
        batch = sdk.batch_query_vectors(user, model, qs[:10], k=10)
        check(all(same_results([vars(r) for r in row], ids, scores)
                  for row, (ids, scores, _) in zip(batch, direct)),
              "the SDK's batch query differs from the store's")
        graph = {"user_id": user, "model_id": "sdk_hnsw"}
        sdk.create_store(**graph, dimension=d, index_type="hnsw")
        rows = unit_rows(g, SDK_GRAPH_ROWS, d).cpu().numpy()
        t0 = time.perf_counter()
        op = sdk.batch_add_vectors(**graph, vectors=rows, chunk_size=1024)
        fill_s = time.perf_counter() - t0
        check(op["status"] == "completed", f"SDK batch add: {op}")
        stats = sdk.get_store_stats(**graph)
        check(stats["index_type"] == "beam_graph"
              and stats["vector_count"] == SDK_GRAPH_ROWS,
              f"the hnsw store is not a filled graph store: {stats}")
        got = ann_routed(lambda: sdk.batch_query_vectors(
            **graph, queries=rows[:8], k=10))
        own = ann_routed(lambda: manager.get_store(
            **graph, create=False).batch_query(rows[:8], k=10))
        check([[r.index for r in row] for row in got]
              == [ids for ids, _, _ in own]
              and [row[0].index for row in got] == list(range(8)),
              "the SDK's graph query differs from the store's own")
        emit({"phase": "serve", "case": "sdk", "health": health["status"],
              "queries_same": 10, "batch_same": True,
              "hnsw_store": stats["index_type"],
              "hnsw_rows": SDK_GRAPH_ROWS, "hnsw_fill_seconds": fill_s,
              "hnsw_self_first": 8, "requests": sdk.get_stats()})
    hold_store(manager.get_store(**graph, create=False), "sdk", qs[:64], 10,
               errs)


def path_serve(g, seed: int, tmp: Path, counts: dict, errs: dict) -> None:
    """The port's REST server at 125K x 768 f32 cosine: the store made with
    /admin/create_store, filled through /v1/batch/upload, queried over
    HTTP one at a time and in a concurrent burst that the coalescer folds
    into batched scans, and by /vectors/batch_query at top-10 and
    top-100; then the filter, add, self-query and delete checks."""
    import os
    import torch
    # one INFO line a request would be most of this script's output
    os.environ.setdefault("LOG_LEVEL", "WARNING")
    from tpu_vector_db_torch.api.app import create_app
    from tpu_vector_db_torch.ops.launches import LAUNCHES
    from tpu_vector_db_torch.security.auth import auth_config
    from tpu_vector_db_torch.service.error_handler import ErrorHandler
    from tpu_vector_db_torch.service.manager import VectorStoreManager
    d = 768
    who = {"user_id": "smoke", "model_id": "serve"}
    rows = unit_rows(g, SERVE_N, d)
    qs = rows[:SERVE_BURST].cpu().numpy() + 0.05 * np.random.default_rng(
        seed + 7).standard_normal((SERVE_BURST, d)).astype(np.float32)
    manager = VectorStoreManager(base_path=tmp / "serve", device="cuda",
                                 errors=ErrorHandler(tmp / "serve_logs"))
    server = ServerThread(create_app(manager=manager))
    # the admin key passes every route, at the tier that allows 64
    # queries in flight
    client = Client(server.url, auth_config.admin_key)
    requests = 0
    try:
        with counting("serve", ("scan_kernel", "scan_kernel_bigk"), counts):
            health = ok(client.get("/health"), "health")
            dev = health["checks"]["device"]
            check(dev.get("device_name") == torch.cuda.get_device_name(0),
                  f"/health does not name the card: {dev}")
            ok(client.post("/admin/create_store", json={
                **who, "dimension": d, "metric": "cosine",
                "storage_dtype": "float32", "index_type": "flat",
                "expected_rows": SERVE_N}), "create_store", 201)
            part = SERVE_N // SERVE_PARTS
            t0 = time.perf_counter()
            part_s = []
            for start in range(0, SERVE_N, part):
                t1 = time.perf_counter()
                upload_part(client, who,
                            rows[start:start + part].cpu().numpy(), start)
                part_s.append(time.perf_counter() - t1)
            upload_s = time.perf_counter() - t0
            count = ok(client.get("/vectors/count", params=who),
                       "count")["count"]
            check(count == SERVE_N, f"/vectors/count is {count}")
            emit({"phase": "serve", "case": f"upload {SERVE_N}x{d} f32",
                  "parts": SERVE_PARTS, "seconds": upload_s,
                  "rows_per_s": SERVE_N / upload_s, "part_seconds": part_s})
            requests += 3 + 3 * SERVE_PARTS

            times = []
            for i in range(SERVE_SEQUENTIAL):
                t1 = time.perf_counter()
                ok(client.post("/vectors/query", json={
                    **who, "query": qs[i].tolist(), "k": 10}), "query")
                times.append(time.perf_counter() - t1)
            emit({"phase": "serve", "case": "sequential top-10 b1",
                  **latencies(times)})

            before_stats = coalescer_stats(client)
            before = LAUNCHES["scan_kernel"]
            t0 = time.perf_counter()
            results, times = client.run(burst(client, who, qs, 10,
                                              SERVE_IN_FLIGHT))
            wall = time.perf_counter() - t0
            launches = LAUNCHES["scan_kernel"] - before
            after_stats = coalescer_stats(client)
            flushes = after_stats["batches"] - before_stats["batches"]
            hist = {b: n - before_stats["batch_size_hist"].get(b, 0)
                    for b, n in after_stats["batch_size_hist"].items()}
            check(launches == flushes and launches < SERVE_BURST,
                  f"burst: {launches} scan_kernel launches for {flushes} "
                  f"flushes of {SERVE_BURST} requests")
            direct = manager.get_store(**who, create=False).batch_query(
                qs, k=10)
            same = [same_results(r, ids, sc)
                    for r, (ids, sc, _) in zip(results, direct)]
            check(all(same), f"{same.count(False)} coalesced answers differ "
                  "from the store's own batch_query")
            emit({"phase": "serve", "case": f"concurrent top-10 b1 x "
                  f"{SERVE_BURST}, {SERVE_IN_FLIGHT} in flight",
                  **latencies(times), "wall_s": wall,
                  "qps": SERVE_BURST / wall, "flushes": flushes,
                  "scan_kernel_launches": launches,
                  "flush_size_hist": {b: n for b, n in hist.items() if n},
                  "same_as_direct": True})
            requests += SERVE_SEQUENTIAL + SERVE_BURST + 2

            for k, kernel in ((10, "scan_kernel"), (100, "scan_kernel_bigk")):
                body = {**who, "queries": qs[:64].tolist(), "k": k}
                times = []
                before = LAUNCHES[kernel]
                for _ in range(6):
                    t1 = time.perf_counter()
                    out = ok(client.post("/vectors/batch_query", json=body),
                             "batch_query")
                    times.append(time.perf_counter() - t1)
                check(LAUNCHES[kernel] > before and len(out["results"]) == 64
                      and all(len(r) == k for r in out["results"]),
                      f"batch_query top-{k} did not run {kernel}")
                emit({"phase": "serve", "case": f"batch_query top-{k} b64",
                      "kernel": kernel, "p50_ms": float(np.median(
                          times[1:])) * 1e3, "reps": 5})
            requests += 12

            out = ok(client.post("/vectors/query", json={
                **who, "query": qs[0].tolist(), "k": 10,
                "filter_metadata": {"cat": 3}}), "filtered query")
            check(len(out["results"]) == 10 and all(
                r["metadata"]["cat"] == 3 for r in out["results"]),
                "the filtered query returned a non-matching row")
            new = unit_rows(g, 1024, d).cpu().numpy()
            out = ok(client.post("/vectors/add", json={
                **who, "vectors": new.tolist(),
                "metadata": [{"cat": 99} for _ in range(1024)]}), "add")
            check(out["total"] == SERVE_N + 1024,
                  f"add: total {out['total']}")
            for j in (0, 511, 1023):
                top = ok(client.post("/vectors/query", json={
                    **who, "query": new[j].tolist(), "k": 1}),
                    "self-query")["results"][0]
                check(top["index"] == SERVE_N + j
                      and top["similarity"] > 0.999,
                      f"self-query of added row {SERVE_N + j} returned "
                      f"{top}")
            first = ok(client.post("/vectors/query", json={
                **who, "query": qs[0].tolist(), "k": 10}), "query")
            hit = first["results"][0]["index"]
            ok(client.post("/vectors/delete", json={**who, "indices": [hit]}),
               "delete")
            again = ok(client.post("/vectors/query", json={
                **who, "query": qs[0].tolist(), "k": 10}), "query")
            ids = [r["index"] for r in again["results"]]
            check(hit not in ids and ids[:9] == [
                r["index"] for r in first["results"][1:]],
                "delete: the deleted row came back or the order changed")
            requests += 8
            prom = client.get("/monitoring/prometheus")[1]
            seen = [float(line.split()[-1]) for line in prom.splitlines()
                    if line.startswith("http_requests_total")]
            check(seen and seen[0] >= requests, f"prometheus counts "
                  f"{seen} requests, the run made at least {requests}")
            info = ok(client.get("/system/info"), "system info")
            check(info["accelerator"]["devices"][0]
                  == torch.cuda.get_device_name(0),
                  f"/system/info does not name the card: "
                  f"{info['accelerator']}")
            emit({"phase": "serve", "case": "checks", "filter": True,
                  "add_self_query": True, "delete": True,
                  "prometheus_requests": seen[0], "system_info_card":
                  info["accelerator"]["devices"][0]})

            # the device's busy share of one burst of 64 requests
            window_ms, by_name, seen_n, whole = profile_device(
                lambda: client.run(burst(client, who, qs[:64], 10,
                                         SERVE_IN_FLIGHT)), 3,
                ("scan_small_k",))
            busy = sum(by_name.values())
            emit({"phase": "serve", "case": "burst of 64 profiled",
                  "window_ms_per_burst": window_ms,
                  "device_ms_per_burst": busy if whole else
                  "not measured (the profiler missed events)",
                  "device_busy_share": busy / window_ms if whole else
                  "not measured", "device_ms_by_kernel":
                  top_kernels(by_name), "launches_seen": launches_seen(
                      seen_n, ("scan_small_k",))})
        store = manager.get_store(**who, create=False)
        path_sdk(g, server, manager, who, qs, counts, errs)
        for q_n, k, flt in ((1, 10, None), (64, 10, None), (1, 100, None),
                            (64, 100, None), (1, 10, {"cat": 3})):
            hold_store(store, "serve", qs[:q_n], k, errs, flt)
        del store
    finally:
        client.close()
        server.close()
    del rows, manager, server
    free_card()


# ------------------------------------------------------- the examples path

# examples/torch_<name>.py, each the port's version of examples/<name>.py
EXAMPLES = ("quickstart", "ann_index", "ivf_index", "capacity_mode",
            "rag_pipeline", "rest_and_sdk", "sharded_mesh")


def load_example(name: str):
    """examples/torch_<name>.py imported by its path."""
    import importlib.util
    path = REPO / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def example_asserts(name: str, out: dict) -> dict:
    """What the example prints, held: the values it asserts or shows."""
    if name == "quickstart":
        got = {"count": out["count"],
               "self_query_top1": out["self_query"][0][0],
               "filtered_langs": sorted(set(out["filtered"][2])),
               "batch_top1s": [r[0][0] for r in out["batch"]],
               "reload_parity": out["parity"]}
        ok = (got["count"] == 1000 and got["self_query_top1"] == 42
              and got["filtered_langs"] == ["de"]
              and got["batch_top1s"] == list(range(8)) and out["parity"])
    elif name == "ann_index":
        got = {"recall_vs_exact": out["recall"],
               "graph_nodes": out["graph_nodes"],
               "new_vector_reachable": out["reachable"]}
        ok = (out["recall"] >= 0.95 and out["reachable"]
              and out["graph_nodes"] == 21_000)
    elif name == "ivf_index":
        got = {"index_type": out["index_type"], "recall_vs_exact":
               out["recall"], "count": out["count"]}
        ok = (out["index_type"] == "ivf" and out["recall"] >= 0.95
              and out["count"] == 50_500)
    elif name == "capacity_mode":
        got = {dtype: {"ivf_top1": r["ivf"][0][0],
                       "ivf_score": r["ivf"][1][0],
                       "exact_top1": r["exact"][0][0],
                       "exact_score": r["exact"][1][0],
                       "layout": r["layout"]} for dtype, r in out.items()}
        ok = all(r["ivf_top1"] == r["exact_top1"] == 123
                 and r["ivf_score"] > 0.95 and r["layout"] == "gather"
                 for r in got.values())
    elif name == "rag_pipeline":
        got = {"chunks": len(out["chunks"]), "total_chars":
               out["total_chars"], "top_chunk_names_hbm":
               "HBM bandwidth" in out["chunks"][0]["text"]}
        ok = got["chunks"] == 2 and got["top_chunk_names_hbm"]
    elif name == "rest_and_sdk":
        got = {"count": out["count"], "top_hit": out["top_hit"],
               "batch_add": out["batch_add"],
               "semantic_hits": out["semantic_hits"]}
        ok = (out["count"] == 100 and out["top_hit"][0] == 7
              and out["top_hit"][1] > 0.999
              and out["batch_add"][0] == "completed"
              and out["batch_add"][1]["added"] == 400
              and out["semantic_hits"][:1] == [300])
    else:
        got = {"devices": len(out["devices"]),
               "sharded_equals_flat": out["agree"]}
        ok = out["agree"] and got["devices"] == 8
    check(ok, f"example {name}: {got}")
    return got


def hold_example(name: str, out: dict, errs: dict) -> set[str]:
    """Every kernel the example launches, held against its plain version
    on the example's own store (rows, mask, index) at the example's
    batch and k. Returns the kernels held."""
    from tpu_vector_db_torch.ops.cuda_scan import kernel_name
    if name == "capacity_mode":
        stores = [r["store"] for r in out.values()]
    else:
        stores = [out["store"]]
    held = set()
    for store in stores:
        rows = store._host_buf[:64]
        if name == "sharded_mesh":
            hold_sharded(store, "examples", out["queries"], 5, errs)
            held |= {kernel_name(5), "merge_small_k"}
            continue
        if name == "ivf_index":
            hold_index(store, "examples", out["queries"][:1], 10, errs)
            held.add("ivf_kernel")
        if name == "capacity_mode" and store._ann is not None \
                and store._ann.built:
            for q_n, k in ((1, 5), (16, 40)):
                hold_gather(store, "examples", rows[:q_n], k, errs)
            held.add("ivf_gather_kernel")
        if name == "quickstart":
            hold_store(store, "examples", rows[42:43], 3, errs,
                       {"lang": "de"})
            hold_store(store, "examples", rows[:8], 2, errs)
        # the exact b1 query every example makes (its k: 3, 5 or 10),
        # and the ANN stores' b64 sampled-recall self-check
        hold_store(store, "examples", rows[:1], 10, errs)
        hold_store(store, "examples", rows, 10, errs)
        held.add(kernel_name(10))
    return held


def path_examples(tmp: Path, counts: dict, errs: dict) -> None:
    """The seven examples (examples/torch_*.py) in this process on the
    card, each ``main(device="cuda", root=...)`` at its own sizes: one
    line each with its seconds, the launches around the call and what it
    asserts; then every kernel an example launched held against its
    plain version on that example's own store."""
    import torch
    from tpu_vector_db_torch.ops.launches import LAUNCHES
    free_card()
    runs = {}
    with counting("examples", ("scan_kernel", "ivf_kernel",
                               "merge_small_k"), counts):
        for name in EXAMPLES:
            module = load_example(name)
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            out = module.main(device="cuda", root=tmp / "examples" / name)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            emit({"phase": "examples", "name": name,
                  "file": f"examples/torch_{name}.py", "seconds": seconds,
                  "launches": launched,
                  "asserts": example_asserts(name, out)})
            runs[name] = (out, launched)
    for name, (out, launched) in runs.items():
        held = hold_example(name, out, errs)
        missing = {k for k, v in launched.items() if v} - held
        check(not missing, f"example {name} launched {sorted(missing)} "
              "with no hold")
    runs.clear()
    shutil.rmtree(tmp / "examples", ignore_errors=True)
    free_card()


# ------------------------------------------------------ the sharded path

# BASELINE config #5 (BASELINE.md:37,45): 10M x 128 f32 cosine, sharded;
# rows N(0, I) with metadata {"g": i % 100}, added in 10 x 1M batches
SHARD_N, SHARD_D, SHARD_BATCH = 10_000_000, 128, 1_000_000
SHARD_QUERIES, SHARD_REPS = 64, 50
SHARD_DELETED = SHARD_N // 1000               # 0.1% tombstoned
SHARD_P = 4                                   # the reopen's co-located mesh
# sharded IVF (the ivf path's regime) and sharded graph (the graph path's)
SHARD_IVF_N, SHARD_IVF_PARTS, SHARD_IVF_P = 2_000_000, 4, 2
# the graph at 50K rows (100K until PR 13): each multihost server also
# rebuilds its shard of it on one host thread, inside the 1,200 s
SHARD_GRAPH_N, SHARD_GRAPH_EXTRA, SHARD_GRAPH_P = 50_000, 10_000, 2
SHARD_MGR_N = 100_000
SHARD_TOL = 1e-6               # ids equal, keys within: same kernel rules


def same_answers(got: list, want: list, tol: float = SHARD_TOL) -> bool:
    """batch_query results equal: ids, and scores within ``tol``."""
    return len(got) == len(want) and all(
        g[0] == w[0] and np.allclose(g[1], w[1], atol=tol, rtol=0)
        for g, w in zip(got, want))


def shard_launches(fn) -> dict:
    """Run fn; the launches it made of each kernel."""
    from tpu_vector_db_torch.ops.launches import LAUNCHES
    before = dict(LAUNCHES)
    fn()
    return {name: LAUNCHES[name] - before[name] for name in LAUNCHES}


def hold_sharded(store, path: str, queries: np.ndarray, k: int, errs: dict,
                 filter_metadata: dict | None = None,
                 split: int | None = None) -> None:
    """Each shard's flat kernel against its plain version on that shard's
    own inputs (rows, mask, scales, local count; k > 32: the line gives
    the most key-scratch chunks a shard's call is cut into), then the k·P
    merge of the kernels' candidates against its plain version, bit for
    bit (k <= 32: merge_small_k; k > 32 the sort merge, plain torch).
    ``split``: the store's one shard cut into that many equal shards (the
    shards a group of ``split`` processes holds of the same rows; their
    candidates are what the cross-process merge merges)."""
    import torch
    from tpu_vector_db_torch.ops import cuda_scan, ivf_scan
    from tpu_vector_db_torch.parallel.mesh import local_count
    from tpu_vector_db_torch.parallel.sharded_scan import (
        gather_candidates, merge_candidates)
    args = store._scan_inputs(queries, store._query_mask(filter_metadata))
    rows, n = store._rows_per_shard, store._n_dev
    if split:
        check(n == 1, "only a one-shard store is split")
        rows, n = rows // split, split
        for key in ("db", "db_sqnorms", "filter_mask", "db_scales"):
            if args[key] is not None:
                args[key] = list(torch.split(args[key][0], rows))
    name = cuda_scan.kernel_name(k)
    keys_l, ids_l, err, ok, chunks = [], [], 0.0, True, 0
    for s in range(n):
        kw = dict(queries=args["queries"], db=args["db"][s],
                  count=local_count(store._count, rows, s),
                  metric=store.metric, k=k)
        plan = cuda_scan._launch_plan(len(queries), kw["db"].dtype,
                                      kw["queries"].shape[1], k, kw["count"])
        if plan.chunk_rows:
            chunks = max(chunks, -(-kw["count"] // plan.chunk_rows))
        for key in ("db_sqnorms", "filter_mask", "db_scales"):
            kw[key] = args[key][s] if args[key] is not None else None
        keys, ids = cuda_scan.flat_topk(**kw)
        pkeys, pids = cuda_scan.flat_topk_plain(**kw)
        e, keys_ok, ids_ok = compare(keys, ids, pkeys, pids, store.metric)
        err, ok = max(err, e), ok and keys_ok and ids_ok
        keys_l.append(keys)
        ids_l.append(ids)
    cand = gather_candidates(keys_l, ids_l, [s * rows for s in range(n)],
                             store.mesh.lead)
    merged = merge_candidates(*cand, k, empty_id=0)
    if k <= 32:
        want = ivf_scan.merge_small_k_plain(*cand, k, 0)
        merge_ok = (torch.equal(merged[0].view(torch.int32),
                                want[0].view(torch.int32))
                    and torch.equal(merged[1], want[1]))
    else:
        merge_ok = True   # plain torch: no kernel to hold
    emit({"phase": "hold", "path": path, "kernel": name, "shards": n,
          "dtype": store.config.storage_dtype, "metric": store.metric,
          "filtered": bool(filter_metadata), "Q": len(queries), "k": k,
          "count": store._count, "d": store.config.dimension,
          "chunks_per_shard": chunks, "max_abs_err": err, "shards_ok": ok,
          "merge_bit_equal": merge_ok})
    check(ok, f"{path}: {name} disagrees with its plain version on a shard "
          f"at Q={len(queries)} k={k} (key error {err})")
    check(merge_ok, f"{path}: the k·P merge disagrees with its plain "
          "version")
    if k <= 32:
        errs.setdefault("merge_small_k", 0.0)   # bit for bit
    errs[name] = max(errs.get(name, 0.0), err)


def hold_sharded_ivf(store, path: str, queries: np.ndarray, k: int,
                     errs: dict, timed: bool = False,
                     merge: bool = False) -> dict:
    """The IVF kernel against its plain version on every shard's buckets,
    ids and fills, at the buckets its centroids select for these queries
    (``merge``: and the shard merge on its winners, ``hold_ivf``);
    returns the first shard's line."""
    from tpu_vector_db_torch.index.ivf import _select_buckets
    ann = store._ann
    q = store._prepare_queries(queries)
    first = None
    for s, sub in enumerate(ann._subs):
        if not sub.built:
            continue
        dev = sub._dev
        nprobe = min(store.config.ann_params.get("nprobe", ann.nprobe),
                     dev["ids"].shape[0])
        sel = _select_buckets(q, dev["centroids"], dev["bucket_cluster"],
                              nprobe, store.metric, dev["c_sqnorms"])
        out = hold_ivf(q, dev["buckets"], dev["ids"], dev["fills"], sel, k,
                       {"phase": "hold", "path": path,
                        "shard": ann.first + s},
                       timed=timed and s == 0, merge=merge)
        errs["ivf_kernel"] = max(errs.get("ivf_kernel", 0.0),
                                 out["max_abs_err"])
        first = first or out
    return first


def merge_headline(store, queries: np.ndarray, k: int) -> dict:
    """The k·P merge alone at the shape the path gives it (the shards'
    candidates of a b64 top-10 call at P = 4): kernel and plain times by
    CUDA events, device time by profiler, torch.topk over the same keys
    (the library call), and the bound (candidates read once, results
    written once)."""
    import torch
    from tpu_vector_db_torch.ops import cuda_scan, ivf_scan
    from tpu_vector_db_torch.parallel.mesh import local_count
    from tpu_vector_db_torch.parallel.sharded_scan import gather_candidates
    args = store._scan_inputs(queries, None)
    rows, n = store._rows_per_shard, store._n_dev
    keys_l, ids_l = [], []
    for s in range(n):
        keys, ids = cuda_scan.flat_topk(
            args["queries"], args["db"][s], local_count(store._count, rows, s),
            k, store.metric)
        keys_l.append(keys)
        ids_l.append(ids)
    ck, ci = gather_candidates(keys_l, ids_l, [s * rows for s in range(n)],
                               store.mesh.lead)
    got = ivf_scan.merge_small_k(ck, ci, k, 0)
    want = ivf_scan.merge_small_k_plain(ck, ci, k, 0)
    check(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
          and torch.equal(got[1], want[1]),
          "merge_small_k disagrees with its plain version on the k·P merge")
    nbytes = ck.numel() * 8 + got[0].numel() * 8
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    dev = device_ms(lambda: ivf_scan.merge_small_k(ck, ci, k, 0), 20,
                    ("merge_small_k",), bound_ms)
    return {"design": f"k·P merge, {n} lists of {k}",
            "ms": cuda_ms(lambda: ivf_scan.merge_small_k(ck, ci, k, 0), 50),
            "device_ms": dev["device_ms"],
            "plain_ms": cuda_ms(lambda: ivf_scan.merge_small_k_plain(
                ck, ci, k, 0), 20),
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": cuda_ms(lambda: torch.topk(ck, k, dim=1), 50),
            "library": "torch.topk", "Q": ck.shape[0], "candidates":
            ck.shape[1], "k": k}


def sharded_recall(store, qs: np.ndarray, n: int, k: int = 10,
                   batch: int = 8) -> float:
    """Tie-aware recall@k of ANN-routed batches (no flat-scan launch)
    against the exact top-k of the store's first n rows."""
    import torch
    res = []
    for i in range(0, len(qs), batch):
        res += ann_routed(lambda: store.batch_query(qs[i:i + batch], k=k))
    db = torch.cat(store._db)[:n, :store.config.dimension]
    (gt_vals, _), keys = exact_topk(db, qs, k, "cosine")
    return tie_aware_recall(res, keys, gt_vals, k)


def p1_device(store, qs: np.ndarray, n: int, d: int, label: str) -> None:
    """P = 1's top-10 b1 and b64 device time, read twice from the same
    store in the same state: the busy share's trace (``device_share``)
    and ``device_ms``'s traces, with their agreement and the scan's own
    event lengths. The 0.1% delete adds a tombstone mask to every scan,
    so each state is compared only with itself."""
    for q_n in (1, 64):
        share = device_share(store, qs[:q_n], 10, 20, expect_flat(10))
        emit({"phase": "sharded", "case": f"P=1 {label}top-10 b{q_n} "
              "profiled", **share})
        floor, by = bound(n, d * 4, q_n, d, 10, "float32", 0)
        dev = device_ms(lambda: store.batch_query(qs[:q_n], k=10), 20,
                        expect_flat(10), floor)
        emit({"phase": "sharded", "case": f"P=1 {label}top-10 b{q_n} "
              "device", **dev, "bound_ms": floor, "bound_by": by,
              **agreement(dev["device_ms"], share)})


def rebuilt_copy(src: Path, dst: Path, mesh):
    """A ShardedVectorStore on ``mesh`` over ``src``'s files (hard links)
    but its index sidecars: it builds its index anew from the rows, as a
    server process whose layout differs from the writer's rebuilds its
    shards'."""
    import os
    from tpu_vector_db_torch.parallel import ShardedVectorStore
    dst.mkdir(parents=True)
    for f in src.iterdir():
        if f.is_file() and not f.name.startswith("ann_"):
            os.link(f, dst / f.name)
    return ShardedVectorStore(dst, mesh=mesh)


def mh_reference(store, qs: np.ndarray, n: int) -> dict:
    """What the multihost path holds a served sharded ANN store to: this
    store's ANN-routed answers to ``MH_ANN_CASES`` (b1 queries one at a
    time, then a batch) and the exact top-10 of its first n rows over
    the batch's queries (the ground truth of recall)."""
    import torch
    answers = {label: [ann_routed(lambda: store.batch_query(
        qs[i:i + 1], k=10))[0] for i in range(calls)] if q_n == 1
        else ann_routed(lambda: store.batch_query(qs[:q_n], k=10))
        for label, q_n, calls in MH_ANN_CASES}
    db = torch.cat(store._db)[:n, :store.config.dimension]
    (gt_vals, _), keys = exact_topk(db, qs[:MH_ANN_BATCH], 10, "cosine")
    recall = tie_aware_recall(answers[f"b{MH_ANN_BATCH} top-10"], keys,
                              gt_vals, 10)
    return {"queries": qs, "answers": answers, "count": n,
            "gt": (gt_vals.cpu(), keys.cpu()), "recall": recall}


def path_sharded(g, seed: int, tmp: Path, counts: dict, errs: dict,
                 record: dict) -> dict:
    """BASELINE config #5: 10M x 128 f32 cosine in a ShardedVectorStore
    over make_device_mesh() (every visible card: one shard on one card),
    answering as an unsharded TorchVectorStore on the same rows does;
    flushed and reopened at P = 4 co-located shards (["cuda:0"] * 4);
    then a sharded IVF (2M x 128 clustered, P = 2), a sharded beam graph
    (50K x 128 of the graph regime, P = 2, native build, extended by 10K,
    flushed and reopened from ann_sharded_graph.npz) and the manager with
    sharded=True. Returns the k·P merge's headline timings; ``record``
    gets the queries and the flushed store's answers that the multihost
    path is held to (``MH_CASES``), and for the sharded IVF (flushed) and
    the sharded graph (its files copied after its build) the answers of
    an in-process P = 2 store whose index was built over every row, as a
    server process builds its shard's (``MH_ANN_CASES``)."""
    import torch
    from tpu_vector_db_torch import TorchVectorStore, VectorStoreConfig
    from tpu_vector_db_torch.parallel import (ShardedVectorStore,
                                              make_device_mesh)
    from tpu_vector_db_torch.parallel.sharded_ann import ShardedBeamGraph
    from tpu_vector_db_torch.parallel.sharded_ivf import ShardedIVF
    from tpu_vector_db_torch.service.error_handler import ErrorHandler
    from tpu_vector_db_torch.service.manager import VectorStoreManager
    d, n = SHARD_D, SHARD_N
    meta = [{"g": i % 100} for i in range(n)]
    qs = torch.randn((SHARD_QUERIES, d), generator=g,
                     device="cuda").cpu().numpy()
    filt = {"g": 7}
    dead = np.random.default_rng(seed + 9).choice(n, SHARD_DELETED,
                                                  replace=False)
    cfg = VectorStoreConfig(dimension=d, persist_mode="lazy")
    keep = {}
    with counting("sharded", ("scan_kernel", "scan_kernel_bigk",
                              "ivf_kernel", "merge_small_k"), counts):
        # -- 10M x 128 at P = 1 beside an unsharded store
        mesh = make_device_mesh()
        check(mesh.size == torch.cuda.device_count(),
              "make_device_mesh() is not every visible card")
        store = ShardedVectorStore(tmp / "sharded", cfg, mesh=mesh)
        flat = TorchVectorStore(
            tmp / "sharded_flat", VectorStoreConfig(
                dimension=d, persist_mode="off"), device="cuda")
        add_s = flat_s = 0.0
        for start in range(0, n, SHARD_BATCH):
            rows = torch.randn((SHARD_BATCH, d), generator=g,
                               device="cuda").cpu().numpy()
            part = meta[start:start + SHARD_BATCH]
            t0 = time.perf_counter()
            store.add_vectors(rows, part)
            add_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            flat.add_vectors(rows, part)
            flat_s += time.perf_counter() - t0
        del rows
        st = store.get_stats()
        check(st["vector_count"] == n and st["sharded"]
              and st["n_devices"] == mesh.size, f"sharded stats {st}")
        emit({"phase": "sharded", "case": f"add {n}x{d} f32 in "
              f"{n // SHARD_BATCH} batches", "P": mesh.size,
              "seconds": add_s, "unsharded_seconds": flat_s,
              "rows_per_shard": st["rows_per_shard"],
              "device_capacity": st["device_capacity"],
              "devices": [str(x) for x in mesh.devices]})
        answers = {}
        for label, q_n, k, kw in (("top-10 b1", 1, 10, {}),
                                  ("top-10 b64", 64, 10, {}),
                                  ("top-100 b1", 1, 100, {}),
                                  ("top-100 b64", 64, 100, {}),
                                  ("1% filter top-10 b1", 1, 10,
                                   {"filter_metadata": filt}),
                                  ("1% filter top-10 b64", 64, 10,
                                   {"filter_metadata": filt})):
            reps = SHARD_REPS if q_n == 1 and not kw else 10
            r = timed_queries(store, qs[:q_n], k, reps, **kw)
            got = store.batch_query(qs[:q_n], k=k, **kw)
            want = flat.batch_query(qs[:q_n], k=k, **kw)
            check(same_answers(got, want), f"sharded {label} differs from "
                  "the unsharded store")
            if kw:
                check(all(m == filt for res in got for m in res[2]),
                      "a filtered answer breaks the filter")
            answers[label] = got
            emit({"phase": "sharded", "case": f"P=1 {label}", **r,
                  "flat_p50_ms": timed_queries(
                      flat, qs[:q_n], k, reps, **kw)["p50_ms"],
                  "equal_to_unsharded": True})
        p1_device(store, qs, n, d, "")
        (gt_vals, _), keys = exact_topk(store._db[0][:n], qs, 10, "cosine")
        recall = tie_aware_recall(answers["top-10 b64"], keys, gt_vals, 10)
        del keys, gt_vals
        emit({"phase": "sharded", "case": "recall@10 64q", "recall": recall})
        check(recall == 1.0, f"sharded flat recall@10 = {recall}")
        store.delete_vectors(dead)
        flat.delete_vectors(dead)
        for label, q_n, k in (("0.1% deleted top-10 b64", 64, 10),
                              ("0.1% deleted top-100 b1", 1, 100)):
            got = store.batch_query(qs[:q_n], k=k)
            check(same_answers(got, flat.batch_query(qs[:q_n], k=k)),
                  f"sharded {label} differs from the unsharded store")
            check(not set(dead.tolist()) & {i for r in got for i in r[0]},
                  "a deleted id was returned")
            answers[label] = got
        emit({"phase": "sharded", "case": "delete 0.1%", "deleted":
              SHARD_DELETED, "equal_to_unsharded": True})
        record["queries"] = qs
        record["answers"] = {label: [store.batch_query(
            qs[i:i + q_n], k=k, **kw)[0] for i in range(reps)]
            if q_n == 1 else store.batch_query(qs[:q_n], k=k, **kw)
            for label, q_n, k, reps, kw in MH_CASES}
        keep["flat"] = flat
        del flat
        # -- flush, reopen the same files at P = 4 on one card
        t0 = time.perf_counter()
        store.flush()
        flush_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh4 = make_device_mesh(devices=["cuda:0"] * SHARD_P)
        reopened = ShardedVectorStore(tmp / "sharded", mesh=mesh4)
        reopen_s = time.perf_counter() - t0
        st4 = reopened.get_stats()
        rows4 = st4["rows_per_shard"]
        local = [max(0, min(n - s * rows4, rows4)) for s in range(SHARD_P)]
        emit({"phase": "sharded", "case": f"flush + reopen at P={SHARD_P} "
              "on cuda:0", "flush_seconds": flush_s,
              "reopen_seconds": reopen_s, "rows_per_shard": rows4,
              "live_rows_by_shard": local,
              "deleted": st4["deleted_count"]})
        check(st4["n_devices"] == SHARD_P and st4["vector_count"]
              == n - SHARD_DELETED, f"reopened stats {st4}")
        for label, q_n, k in (("0.1% deleted top-10 b64", 64, 10),
                              ("0.1% deleted top-100 b1", 1, 100)):
            got = reopened.batch_query(qs[:q_n], k=k)
            check(same_answers(got, answers[label]),
                  f"P={SHARD_P} {label} differs from P=1")
        for q_n, k in ((1, 10), (64, 10), (1, 100)):
            made = shard_launches(
                lambda: reopened.batch_query(qs[:q_n], k=k))
            scan = "scan_kernel" if k <= 32 else "scan_kernel_bigk"
            check(made[scan] == SHARD_P and made["merge_small_k"] ==
                  (1 if k <= 32 else 0), f"P={SHARD_P} b{q_n} k{k} "
                  f"launched {made}")
            r = timed_queries(reopened, qs[:q_n], k,
                              SHARD_REPS if q_n == 1 else 10)
            emit({"phase": "sharded", "case": f"P={SHARD_P} top-{k} "
                  f"b{q_n}", **r, "launches_per_call": made,
                  "equal_to_p1": True})
        for q_n in (1, 64):
            r = device_share(reopened, qs[:q_n], 10, 20, expect_flat(10))
            emit({"phase": "sharded", "case": f"P={SHARD_P} top-10 "
                  f"b{q_n} profiled", **r})
        p1_device(store, qs, n, d, "0.1% deleted ")
        keep["store"], keep["reopened"] = store, reopened
        del store, reopened

        # -- sharded IVF: 2M x 128 clustered at P = 2 on the card
        centres = torch.randn((IVF_CENTERS, d), generator=g, device="cuda")
        iqs = clustered_rows(g, centres, 64).cpu().numpy()
        imesh = make_device_mesh(devices=["cuda:0"] * SHARD_IVF_P)
        ivf = ShardedVectorStore(
            tmp / "sharded_ivf", VectorStoreConfig(
                dimension=d, persist_mode="lazy", enable_ann=True,
                initial_capacity=SHARD_IVF_N,
                ann_params={"index_type": "ivf"}), mesh=imesh)
        part = SHARD_IVF_N // SHARD_IVF_PARTS
        ivf_add = []
        for _ in range(SHARD_IVF_PARTS):
            rows = clustered_rows(g, centres, part).cpu().numpy()
            t0 = time.perf_counter()
            ivf.add_vectors(rows)
            ivf_add.append(time.perf_counter() - t0)
        ann = ivf._ann
        check(isinstance(ann, ShardedIVF) and ann.size == SHARD_IVF_N,
              "the sharded IVF does not cover the added rows")
        ist = ann.get_stats()
        emit({"phase": "sharded", "case": f"IVF add {SHARD_IVF_N}x{d} in "
              f"{SHARD_IVF_PARTS} batches, P={SHARD_IVF_P}",
              "add_seconds": ivf_add, **ist})
        for nprobe in (32, 64):
            ivf.config.ann_params["nprobe"] = nprobe
            made = shard_launches(lambda: ann_routed(
                lambda: ivf.batch_query(iqs[:8], k=10)))
            check(made["ivf_kernel"] == SHARD_IVF_P
                  and made["merge_small_k"] == 1, f"an IVF call launched "
                  f"{made}")
            recall = sharded_recall(ivf, iqs, SHARD_IVF_N)
            r = counted(lambda: timed_queries(ivf, iqs[:1], 10, 20),
                        "ivf_kernel", FLAT_SCANS)
            emit({"phase": "sharded", "case": f"IVF nprobe {nprobe}",
                  "recall": recall, "launches_per_call": made, **r})
            check(recall >= 0.95, f"sharded IVF recall@10 = {recall} at "
                  f"nprobe {nprobe}")
        ivf.config.ann_params["nprobe"] = 32
        prepared = ivf._prepare_queries(iqs[:8])
        keys, ids = counted(lambda: ann.search(prepared, 10,
                                               nprobe=ann.n_buckets),
                            "ivf_kernel", FLAT_SCANS)
        fkeys, fids = ivf._exact_topk(k=10, **ivf._scan_inputs(iqs[:8],
                                                               None))
        err, keys_ok, ids_ok = compare(keys, ids, fkeys, fids, "cosine")
        emit({"phase": "sharded", "case": "IVF full probe vs flat top-10 "
              "8q", "nprobe": ann.n_buckets, "max_abs_err": err,
              "keys_ok": keys_ok, "ids_ok": ids_ok})
        check(keys_ok and ids_ok, "a full sharded IVF probe differs from "
              f"the sharded flat scan (key error {err})")
        # for the multihost path: the store's files, and the answers of
        # the same files opened here with the index rebuilt over all rows
        t0 = time.perf_counter()
        ivf.flush()
        flush_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = rebuilt_copy(tmp / "sharded_ivf", tmp / "sharded_ivf_ref",
                           imesh)
        open_s = time.perf_counter() - t0
        check(isinstance(ref._ann, ShardedIVF) and ref._ann.build_time_s
              > 0 and ref._ann.size == SHARD_IVF_N, "the reference IVF "
              "store did not rebuild its index")
        record["ann"] = {"ivf": mh_reference(ref, iqs, SHARD_IVF_N)}
        emit({"phase": "sharded", "case": "IVF flush + rebuilt reference",
              "flush_seconds": flush_s, "open_and_rebuild_seconds": open_s,
              "rebuild_seconds": ref._ann.build_time_s,
              "recall_b64": record["ann"]["ivf"]["recall"]})
        del ref
        keep["ivf"] = ivf
        del ivf, ann

        # -- sharded beam graph: 50K x 128 of the graph regime at P = 2
        gcentres = torch.randn((GRAPH_CENTRES, d), generator=g,
                               device="cuda")
        gqs = spread_rows(g, gcentres, GRAPH_QUERIES).cpu().numpy()
        gcfg = VectorStoreConfig(dimension=d, persist_mode="lazy",
                                 enable_ann=True,
                                 ann_params={"index_type": "beam_graph"})
        gmesh = make_device_mesh(devices=["cuda:0"] * SHARD_GRAPH_P)
        graph = ShardedVectorStore(tmp / "sharded_graph", gcfg, mesh=gmesh)
        rows = spread_rows(g, gcentres, SHARD_GRAPH_N).cpu().numpy()
        t0 = time.perf_counter()
        graph.add_vectors(rows)
        build_s = time.perf_counter() - t0
        check(isinstance(graph._ann, ShardedBeamGraph)
              and graph._ann.size == SHARD_GRAPH_N,
              "the sharded graph was not built (degraded to the flat scan)")
        # for the multihost path: the files as the build left them, and
        # this store's answers (its graph built over every row)
        graph.flush()
        shutil.copytree(tmp / "sharded_graph", tmp / "sharded_graph_mh")
        record["ann"]["graph"] = mh_reference(graph, gqs, SHARD_GRAPH_N)
        extra = spread_rows(g, gcentres, SHARD_GRAPH_EXTRA).cpu().numpy()
        builds = []
        with recording(ShardedBeamGraph, "build", builds):
            t0 = time.perf_counter()
            graph.add_vectors(extra)
            extend_s = time.perf_counter() - t0
        total = SHARD_GRAPH_N + SHARD_GRAPH_EXTRA
        check(not builds and graph._ann.size == total,
              "the 10K add rebuilt the sharded graph")
        own = [ann_routed(lambda: graph.query(extra[i], k=1))[0][0]
               for i in range(0, SHARD_GRAPH_EXTRA, 100)]
        found = sum(int(i == SHARD_GRAPH_N + j * 100)
                    for j, i in enumerate(own))
        recall = sharded_recall(graph, gqs, total, batch=64)
        made = shard_launches(lambda: ann_routed(
            lambda: graph.batch_query(gqs[:64], k=10)))
        r = {f"p50_ms_b{q_n}": ann_routed(lambda: timed_queries(
            graph, gqs[:q_n], 10, 10))["p50_ms"] for q_n in (1, 64)}
        emit({"phase": "sharded", "case": f"graph {SHARD_GRAPH_N}x{d} "
              f"P={SHARD_GRAPH_P}, +{SHARD_GRAPH_EXTRA}",
              "build_seconds": build_s, "extend_seconds": extend_s,
              "extended_rows_found_first": found, "of": len(own),
              "recall_ef100": recall, "launches_per_call": made, **r,
              **graph._ann.get_stats()})
        check(recall >= 0.95, f"sharded graph recall@10 = {recall}")
        check(made["merge_small_k"] == 1, f"a graph call launched {made}")
        before = graph.batch_query(gqs[:64], k=10)
        graph.flush()
        builds = []
        with recording(ShardedBeamGraph, "build", builds):
            t0 = time.perf_counter()
            greopen = ShardedVectorStore(tmp / "sharded_graph", mesh=gmesh)
            reopen_s = time.perf_counter() - t0
        served = (not builds and isinstance(greopen._ann, ShardedBeamGraph)
                  and greopen._ann.size == total
                  and greopen._ann.build_time_s == 0.0)
        check(served, "the reopened sharded store rebuilt its graph instead "
              "of serving ann_sharded_graph.npz")
        after = ann_routed(lambda: greopen.batch_query(gqs[:64], k=10))
        check([a[0] for a in after] == [b[0] for b in before],
              "the reopened sharded graph answers differently")
        emit({"phase": "sharded", "case": "graph flush + reopen",
              "reopen_seconds": reopen_s, "graph_served": served,
              "same_answers": True})
        keep["graph"] = greopen
        del graph, greopen

        # -- the manager with sharded=True
        manager = VectorStoreManager(base_path=tmp / "sharded_mgr",
                                     sharded=True, device="cuda",
                                     errors=ErrorHandler(tmp / "mgr_logs"))
        mstore = manager.create_store("smoke", "sharded",
                                      VectorStoreConfig(dimension=d))
        mrows = torch.randn((SHARD_MGR_N, d), generator=g,
                            device="cuda").cpu().numpy()
        mstore.add_vectors(mrows)
        mflat = TorchVectorStore(tmp / "sharded_mgr_flat", VectorStoreConfig(
            dimension=d, persist_mode="off"), device="cuda")
        mflat.add_vectors(mrows)
        got = [mstore.query(q, k=10) for q in qs[:10]]
        check(isinstance(mstore, ShardedVectorStore)
              and same_answers(got, [mflat.query(q, k=10)
                                     for q in qs[:10]]),
              "the sharded manager's store answers differently")
        emit({"phase": "sharded", "case": f"manager sharded=True "
              f"{SHARD_MGR_N}x{d}", "store": type(mstore).__name__,
              "n_devices": mstore.get_stats()["n_devices"],
              "equal_to_unsharded": True})
        manager.shutdown()
        keep["mgr"], keep["mgr_flat"] = mstore, mflat
        del mstore, mflat
    headline = merge_headline(keep["reopened"], qs, 10)
    # every shape the path's flat calls gave the kernels: b1 and b64,
    # top-10 and top-100 (b64 top-100 over 10M rows is the multi-chunk
    # plan, its chunks' lists merged), at P = 1 and at P = 4
    for q_n, k in ((1, 10), (64, 10), (1, 100), (64, 100)):
        hold_sharded(keep["store"], "sharded", qs[:q_n], k, errs)
        hold_sharded(keep["reopened"], "sharded", qs[:q_n], k, errs)
    # the multihost path's shapes: the same flushed rows in MH_HOSTS
    # shards (one a process), each scanned, and their candidates merged as
    # the cross-process merge merges them
    for label, q_n, k, _, kw in MH_CASES:
        hold_sharded(keep["store"], "multihost", qs[:q_n], k, errs,
                     kw.get("filter_metadata"), split=MH_HOSTS)
    hold_store(keep["flat"], "sharded", qs, 10, errs, filt)
    hold_sharded(keep["reopened"], "sharded", qs, 10, errs, filt)
    hold_sharded_ivf(keep["ivf"], "sharded", iqs[:8], 10, errs)
    hold_sharded(keep["ivf"], "sharded", iqs[:8], 10, errs)
    hold_sharded(keep["graph"], "sharded", gqs[:64], 10, errs)
    hold_sharded(keep["mgr"], "sharded", qs[:10], 10, errs)
    hold_store(keep["mgr_flat"], "sharded", qs[:10], 10, errs)
    keep.clear()
    free_card()
    return headline


# ------------------------------------------------------ the multihost path

# BASELINE config #5 served by two server processes of one serving group:
# the sharded path's flushed store, one shard a process (both on cuda:0
# on a one-card machine: P = 2), driven in lockstep over REST
MH_HOSTS = 2
MH_USER, MH_MODEL = "smoke", "config5"
MH_KEY, MH_ADMIN = "smoke-mh-api-key", "smoke-mh-admin-key"
MH_SEQUENTIAL = 50              # b1 top-10 queries, one at a time
MH_BATCH_REPS = 10              # each batch_query case
MH_ADD, MH_DELETE = 1000, 10
MH_FILTER = {"g": 7}
# (label, batch, k, calls, query options): what the sharded path records
# of its flushed store and the multihost path is held to; batch 1 cases
# take queries 0..calls-1 one at a time
MH_CASES = (("b1 top-10", 1, 10, MH_SEQUENTIAL, {}),
            ("b64 top-10", 64, 10, 1, {}),
            ("b64 top-100", 64, 100, 1, {}),
            ("b1 1% filter top-10", 1, 10, 1,
             {"filter_metadata": MH_FILTER}))
# the sharded path's two ANN stores, served beside config #5 (their
# sidecars were written by one process: each server rebuilds its shard's
# index); b1 queries 0..49 one at a time, then queries 0..63 as a batch
MH_ANN_MODELS = {"ivf": "ivf", "graph": "graph"}
MH_ANN_BATCH = 64
MH_ANN_CASES = (("b1 top-10", 1, MH_SEQUENTIAL),
                (f"b{MH_ANN_BATCH} top-10", MH_ANN_BATCH, 1))
MH_UP_S, MH_LOAD_S, MH_CALL_S, MH_EXIT_S = 240, 600, 120, 300
MH_DEAD_503_S, MH_FAST_FAIL_S = 45, 10
# the cross-process merge timed alone by a pair of processes
MH_MERGE_CASES = ((1, 10), (64, 10), (64, 100))
MH_MERGE_REPS = 50


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_hold(store, queries: np.ndarray, k: int) -> dict:
    """In a server process: its shard of a sharded IVF store, the IVF
    kernel and the shard merge on the kernel's winners held against
    their plain versions (``hold_sharded_ivf``); the line, with the
    launches the hold made (they are no traffic)."""
    from tpu_vector_db_torch.ops.launches import LAUNCHES
    before = dict(LAUNCHES)
    line = hold_sharded_ivf(store, "multihost", queries, k, {}, merge=True)
    return {**line, "hold_launches": {name: LAUNCHES[name] - before[name]
                                      for name in LAUNCHES}}


def multihost_worker(rank: int, coordinator: str, port: int,
                     data_dir: str) -> int:
    """``chip_smoke.py --multihost-worker RANK COORD HTTP_PORT DATA_DIR``:
    the port's REST server as process RANK of the serving group
    (``tpu_vector_db_torch.api.main``), sharded stores over the visible
    cards, the coalescer off (each process's batch window would form
    other batches, and the collectives would not match). Two routes are
    added for the smoke run: GET ``/smoke/launches`` (this process's
    launch counts) and POST ``/smoke/hold`` (``rank_hold`` on a model of
    ``MH_USER``). At a clean exit (SIGTERM) it prints its launch counts
    as one JSON line."""
    import asyncio
    import os
    os.environ.update({
        "VECTOR_DB_COORDINATOR": coordinator,
        "VECTOR_DB_NUM_PROCESSES": str(MH_HOSTS),
        "VECTOR_DB_PROCESS_ID": str(rank), "VECTOR_DB_SHARDED": "1",
        "VDB_COALESCE_MS": "off", "VECTOR_DB_DATA_DIR": data_dir,
        "VECTOR_DB_API_KEY": MH_KEY, "VECTOR_DB_ADMIN_KEY": MH_ADMIN,
        "HOST": "127.0.0.1", "PORT": str(port)})
    from aiohttp import web
    import tpu_vector_db_torch.api.main as api_main
    from tpu_vector_db_torch.ops.launches import LAUNCHES

    async def launches(request):
        return web.json_response({"rank": rank, "launches": dict(LAUNCHES)})

    async def hold(request):
        body = await request.json()
        store = request.app["manager"].get_store(
            MH_USER, body["model_id"], create=False)
        line = await asyncio.get_running_loop().run_in_executor(
            None, rank_hold, store, np.asarray(body["queries"], np.float32),
            int(body["k"]))
        return web.json_response(line)

    make_app = api_main.create_app

    def create_app(**kw):
        app = make_app(**kw)
        app.router.add_get("/smoke/launches", launches)
        app.router.add_post("/smoke/hold", hold)
        return app

    api_main.create_app = create_app
    api_main.main(["development"])
    emit({"phase": "multihost_worker", "rank": rank,
          "launches": dict(LAUNCHES), "jax_loaded": "jax" in sys.modules})
    return 0


def multihost_pair(rank: int, coordinator: str) -> int:
    """``chip_smoke.py --multihost-pair RANK COORD``: one of two processes
    that time ``merge_across_processes`` alone (host clock, ending in a
    synchronize) on (Q, k) winners on the card, and hold its answer
    against the plain merge of both processes' candidates."""
    import torch
    from tpu_vector_db_torch.ops.ivf_scan import merge_small_k_plain
    from tpu_vector_db_torch.ops.topk import sort_by_key_then_id
    from tpu_vector_db_torch.parallel.mesh import (bootstrap_distributed,
                                                   make_device_mesh)
    from tpu_vector_db_torch.parallel.sharded_scan import (
        merge_across_processes)
    bootstrap_distributed(coordinator, MH_HOSTS, rank, timeout_s=MH_UP_S)
    mesh = make_device_mesh(n_devices=1)

    def winners(r: int, q_n: int, k: int):
        g = torch.Generator(device="cuda").manual_seed(1000 * r + k + q_n)
        keys = torch.randn((q_n, k), generator=g, device="cuda")
        keys = keys.sort(dim=1, descending=True).values
        ids = (torch.arange(k, device="cuda", dtype=torch.int32) * 7
               + r).expand(q_n, k).contiguous()
        return keys, ids

    for q_n, k in MH_MERGE_CASES:
        keys, ids = winners(rank, q_n, k)
        got = merge_across_processes(keys, ids, k, mesh)
        cand = [winners(r, q_n, k) for r in range(MH_HOSTS)]
        ck = torch.cat([c[0] for c in cand], 1)
        ci = torch.cat([c[1] for c in cand], 1)
        if k <= 32:
            want = merge_small_k_plain(ck.cpu(), ci.cpu(), k)
        else:
            want = [t[:, :k] for t in sort_by_key_then_id(ck.cpu(),
                                                          ci.cpu())]
        ok = (torch.equal(got[0].cpu().view(torch.int32),
                          want[0].view(torch.int32))
              and torch.equal(got[1].cpu(), want[1].to(torch.int32)))
        times = []
        for _ in range(MH_MERGE_REPS):
            t0 = time.perf_counter()
            merge_across_processes(keys, ids, k, mesh)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        emit({"phase": "multihost_merge", "rank": rank, "Q": q_n, "k": k,
              "processes": MH_HOSTS, "equal_to_plain": ok,
              "host_ms_p50": float(np.median(times)) * 1e3,
              "host_ms_p99": float(np.percentile(times, 99)) * 1e3,
              "reps": MH_MERGE_REPS})
        if not ok:
            return 1
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


class Host:
    """One worker process of the multihost path: its command, its data
    dir (the store's files hard-linked in) and its output files."""

    def __init__(self, rank: int, cmd: list[str], root: Path) -> None:
        self.rank, self.root = rank, root
        self.out, self.err = root / "stdout.log", root / "stderr.log"
        with open(self.out, "w") as out, open(self.err, "w") as err:
            self.proc = subprocess.Popen(cmd, stdout=out, stderr=err,
                                         cwd=root)

    def tail(self, n: int = 3000) -> str:
        return "".join(f"--- rank {self.rank} {f.name}:\n"
                       f"{f.read_text(errors='replace')[-n:]}\n"
                       for f in (self.out, self.err) if f.exists())

    def lines(self) -> list[dict]:
        return [json.loads(x) for x in self.out.read_text().splitlines()
                if x.startswith("{")]

    def stop(self, timeout: float) -> int:
        """Wait for the process to end (kill it past ``timeout``)."""
        try:
            return self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(30)
            return -9


def mh_call(port: int, path: str, payload=None, timeout: float = MH_CALL_S,
            admin: bool = False):
    """(status, JSON body, seconds) of one request to a host."""
    import urllib.error
    import urllib.request
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        method="POST" if data else "GET",
        headers={"Content-Type": "application/json", "Authorization":
                 "Bearer " + (MH_ADMIN if admin else MH_KEY)})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as exc:
        status, body = exc.code, exc.read()
    return status, json.loads(body.decode()), time.perf_counter() - t0


def mh_both(pool, ports: list[int], path: str, payload=None,
            timeout: float = MH_CALL_S):
    """The request to every host at once (the fan-out tier's lockstep):
    the bodies, each 200, and the seconds until the last answered."""
    t0 = time.perf_counter()
    replies = list(pool.map(lambda p: mh_call(p, path, payload, timeout),
                            ports))
    dt = time.perf_counter() - t0
    for rank, (status, body, _) in enumerate(replies):
        check(status == 200, f"multihost rank {rank} {path}: HTTP {status} "
              f"{body}")
    bodies = [b for _, b, _ in replies]
    check(all(b.get("results") == bodies[0].get("results")
              for b in bodies), f"the hosts answer {path} differently")
    return bodies, dt


def mh_same(results: list[dict], want) -> bool:
    """A REST answer equal to a store answer: ids, and scores within
    SHARD_TOL (the REST similarity is rounded to 6 places)."""
    return ([r["index"] for r in results] == list(want[0])
            and np.allclose([r["similarity"] for r in results], want[1],
                            atol=SHARD_TOL, rtol=0))


def mh_launches(pool, ports: list[int]) -> list[dict]:
    """Every server's launch counts (GET /smoke/launches), by rank."""
    replies = list(pool.map(lambda p: mh_call(p, "/smoke/launches"),
                            ports))
    for rank, (status, body, _) in enumerate(replies):
        check(status == 200 and body["rank"] == rank,
              f"rank {rank}'s launch counts: HTTP {status} {body}")
    return [body["launches"] for _, body, _ in replies]


def mh_ann(pool, ports: list[int], tmp: Path, kind: str, model: str,
           ref: dict, timed, held_b1, held_batch) -> dict:
    """One sharded ANN store served by the pair. The first request opens
    it on each server, which rebuilds its own shard's index
    (``load_seconds``) and writes a sidecar of its layout and shard; then
    b1 top-10 x ``MH_SEQUENTIAL`` and b64 top-10 x ``MH_BATCH_REPS`` in
    lockstep (``timed``), every answer equal on both servers and to the
    in-process P = 2 store's (``held_*``); recall@10 of a served batch;
    on every rank no flat-scan launch, one IVF probe a call (IVF) and two
    merges a call (its shard's and the cross-process one). Returns the
    latencies."""
    from tpu_vector_db_torch.parallel.sharded_ann import ShardedBeamGraph
    from tpu_vector_db_torch.parallel.sharded_ivf import ShardedIVF
    sidecar = {"ivf": ShardedIVF.SHARDED_IVF_FILE,
               "graph": ShardedBeamGraph.SHARDED_GRAPH_FILE}[kind]
    who = {"user_id": MH_USER, "model_id": model}
    bodies, load_s = mh_both(pool, ports, f"/vectors/count?user_id="
                             f"{MH_USER}&model_id={model}",
                             timeout=MH_LOAD_S)
    check(all(b["count"] == ref["count"] for b in bodies),
          f"multihost {kind} counts {bodies}")
    layouts = []
    for r in range(MH_HOSTS):
        with np.load(tmp / f"mh_host{r}" / "data" / MH_USER / model
                     / sidecar) as z:
            layouts.append(z["layout"].tolist())
            shards = sorted(int(f[6:]) for f in z.files
                            if f.startswith("built_"))
        check(layouts[r] == [MH_HOSTS, r, 1]
              and shards == ([r] if kind == "ivf" else []),
              f"rank {r}'s {kind} sidecar: layout {layouts[r]}, shards "
              f"{shards}")
    qs = ref["queries"]
    before = mh_launches(pool, ports)
    lat = {f"{kind}_b1_top10": timed(
        f"{kind} b1 top-10 x{MH_SEQUENTIAL}", "/vectors/query",
        [{**who, "query": qs[i].tolist(), "k": 10}
         for i in range(MH_SEQUENTIAL)], held_b1)}
    batch = {**who, "queries": qs[:MH_ANN_BATCH].tolist(), "k": 10}
    lat[f"{kind}_b{MH_ANN_BATCH}_top10"] = timed(
        f"{kind} b{MH_ANN_BATCH} top-10", "/vectors/batch_query",
        [batch] * MH_BATCH_REPS, held_batch)
    bodies, _ = mh_both(pool, ports, "/vectors/batch_query", batch)
    after = mh_launches(pool, ports)
    # each timed case is warmed by one untimed call; then the recall batch
    calls = (MH_SEQUENTIAL + 1) + (MH_BATCH_REPS + 1) + 1
    want = {"scan_kernel": 0, "scan_kernel_bigk": 0,
            "ivf_kernel": calls if kind == "ivf" else 0,
            "merge_small_k": 2 * calls}
    made = [{name: a[name] - b[name] for name in a}
            for a, b in zip(after, before)]
    check(all(m == want for m in made), f"{kind} calls launched {made} "
          f"on the ranks, not {want} each")
    gt_vals, keys = ref["gt"]
    recall = tie_aware_recall(
        [([r["index"] for r in res], None, None)
         for res in bodies[0]["results"]], keys, gt_vals, 10)
    emit({"phase": "multihost", "case": f"{kind} served by {MH_HOSTS} "
          "processes", "model": model, "count": ref["count"],
          "load_seconds": load_s, "sidecar_layouts": layouts,
          "recall_at_10": recall, "in_process_recall_at_10": ref["recall"],
          "launches_per_rank": made, "ranks_agree": True,
          "equal_to_single_process": True})
    check(recall >= 0.95, f"served {kind} recall@10 = {recall}")
    return lat


def path_multihost(g, tmp: Path, counts: dict, record: dict) -> dict:
    """BASELINE config #5 from two port server processes of one serving
    group over REST, each holding one shard of the sharded path's flushed
    10M x 128 store: lockstep traffic, answers held to the single-process
    store's; then the sharded path's IVF and graph stores (``mh_ann``)
    and each rank's holds on its own IVF shard; then the peer-lost 503.
    Launches: rank 0's own, printed at its clean exit, less the hold's."""
    import os
    import signal
    from concurrent.futures import ThreadPoolExecutor as Pool

    import torch
    src = tmp / "sharded"
    free_card()
    qs, answers = record["queries"], record["answers"]
    want_count = SHARD_N - SHARD_DELETED
    me = str(REPO / "chip_smoke.py")
    # the cross-process merge alone, timed by a pair of processes
    coord = f"127.0.0.1:{free_port()}"
    pair = []
    for r in range(MH_HOSTS):
        (tmp / f"mh_pair{r}").mkdir(parents=True)
        pair.append(Host(r, [sys.executable, me, "--multihost-pair", str(r),
                             coord], tmp / f"mh_pair{r}"))
    rcs = [h.stop(MH_UP_S) for h in pair]
    check(rcs == [0] * MH_HOSTS, "the merge pair failed:\n"
          + "".join(h.tail() for h in pair))
    merge = [ln for ln in pair[0].lines()
             if ln.get("phase") == "multihost_merge"]
    for ln in merge:
        emit({**ln, "card": card_line()})
    check(len(merge) == len(MH_MERGE_CASES), "the merge pair printed "
          f"{len(merge)} lines")

    hosts = []
    coord, ports = f"127.0.0.1:{free_port()}", []
    stores = {MH_MODEL: src, MH_ANN_MODELS["ivf"]: tmp / "sharded_ivf",
              MH_ANN_MODELS["graph"]: tmp / "sharded_graph_mh"}
    for r in range(MH_HOSTS):
        root = tmp / f"mh_host{r}"
        for model, files in stores.items():
            store_dir = root / "data" / MH_USER / model
            store_dir.mkdir(parents=True)
            for f in files.iterdir():  # no write reaches another's files
                if f.is_file():
                    os.link(f, store_dir / f.name)
        ports.append(free_port())
    t_start = time.perf_counter()
    for r in range(MH_HOSTS):
        root = tmp / f"mh_host{r}"
        hosts.append(Host(r, [sys.executable, me, "--multihost-worker",
                              str(r), coord, str(ports[r]),
                              str(root / "data")], root))
    who = {"user_id": MH_USER, "model_id": MH_MODEL}
    pool = Pool(MH_HOSTS)
    try:
        up = [False] * MH_HOSTS
        while not all(up):
            check(time.perf_counter() - t_start < MH_UP_S,
                  "the multihost servers did not come up:\n"
                  + "".join(h.tail() for h in hosts))
            for r, h in enumerate(hosts):
                check(h.proc.poll() is None, f"multihost rank {r} died "
                      f"early:\n{h.tail()}")
                if not up[r]:
                    try:
                        up[r] = mh_call(ports[r], "/health", timeout=5)[0] \
                            == 200
                    except OSError:
                        pass
            time.sleep(0.5)
        startup_s = time.perf_counter() - t_start
        # the store opens on each host at its first request
        bodies, load_s = mh_both(
            pool, ports, f"/vectors/count?user_id={MH_USER}"
            f"&model_id={MH_MODEL}", timeout=MH_LOAD_S)
        check(all(b["count"] == want_count for b in bodies),
              f"multihost counts {bodies}")
        emit({"phase": "multihost", "case": "startup + load",
              "processes": MH_HOSTS, "startup_seconds": startup_s,
              "load_seconds": load_s, "count": want_count})

        def timed(label, path, payloads, check_each):
            """The payloads in lockstep, each answer held; a case of
            several calls is warmed by its first call, untimed."""
            if len(payloads) > 1:
                check_each(0, mh_both(pool, ports, path, payloads[0])[0][0])
            times = []
            for i, payload in enumerate(payloads):
                bodies, dt = mh_both(pool, ports, path, payload)
                check_each(i, bodies[0])
                times.append(dt)
            r = latencies(times)
            emit({"phase": "multihost", "case": label, **r,
                  "equal_to_single_process": True})
            return r

        def held(label, recorded=answers):
            """/vectors/query call i against the recorded answer i; a
            batch_query against the recorded batch."""
            want = recorded[label]

            def check_each(i, body):
                res = body["results"]
                same = (mh_same(res, want[i]) if "queries" not in body
                        else len(res) == len(want) and all(
                            mh_same(r, w) for r, w in zip(res, want)))
                check(same, f"multihost {label} (call {i}) differs from "
                      "the single-process store")
            return check_each

        lat = {}
        lat["b1_top10"] = timed(
            "b1 top-10 x50", "/vectors/query",
            [{**who, "query": qs[i].tolist(), "k": 10}
             for i in range(MH_SEQUENTIAL)], held("b1 top-10"))
        for label, k in (("b64 top-10", 10), ("b64 top-100", 100)):
            lat[f"b64_top{k}"] = timed(label, "/vectors/batch_query",
                               [{**who, "queries": qs.tolist(), "k": k}]
                               * MH_BATCH_REPS, held(label))
        timed("b1 1% filter top-10", "/vectors/query",
              [{**who, "query": qs[0].tolist(), "k": 10,
                "filter_metadata": MH_FILTER}], held("b1 1% filter top-10"))
        # an add whose rows find themselves; a delete they then lose
        rows = torch.randn((MH_ADD, SHARD_D), generator=g,
                           device="cuda").cpu().numpy()
        bodies, add_s = mh_both(pool, ports, "/vectors/add", {
            **who, "vectors": rows.tolist(),
            "metadata": [{"g": i % 100} for i in range(MH_ADD)]})
        check(all(b["total"] == SHARD_N + MH_ADD for b in bodies),
              f"multihost add {bodies}")
        bodies, _ = mh_both(pool, ports, "/vectors/batch_query", {
            **who, "queries": rows.tolist(), "k": 1})
        found = [res[0]["index"] for res in bodies[0]["results"]]
        check(found == list(range(SHARD_N, SHARD_N + MH_ADD)),
              "an added row does not find itself at top-1")
        gone = list(range(SHARD_N, SHARD_N + MH_DELETE))
        mh_both(pool, ports, "/vectors/delete", {**who, "indices": gone})
        bodies, _ = mh_both(pool, ports, "/vectors/batch_query", {
            **who, "queries": rows[:MH_DELETE].tolist(), "k": 10})
        check(not set(gone) & {r["index"] for res in bodies[0]["results"]
                               for r in res},
              "a deleted row was returned")
        emit({"phase": "multihost", "case": f"add {MH_ADD} + delete "
              f"{MH_DELETE}", "add_seconds": add_s,
              "found_first": MH_ADD, "deleted_returned": 0})
        # the sharded IVF and graph: each server rebuilds its shard's
        # index at the first request, then lockstep ANN traffic
        for kind, model in MH_ANN_MODELS.items():
            ref = record["ann"][kind]
            lat.update(mh_ann(pool, ports, tmp, kind, model, ref, timed,
                              held("b1 top-10", ref["answers"]),
                              held(f"b{MH_ANN_BATCH} top-10",
                                   ref["answers"])))
        after_ann = mh_launches(pool, ports)
        for rank, made in enumerate(after_ann):
            emit({"phase": "launches", "path": "multihost", "rank": rank,
                  "at": "after the ANN cases, before the holds", **made})
            for name in ("ivf_kernel", "merge_small_k"):
                check(made[name] > 0, f"{name} was not launched on rank "
                      f"{rank}")
        iqs = record["ann"]["ivf"]["queries"][:8]
        holds = [mh_call(p, "/smoke/hold", {
            "model_id": MH_ANN_MODELS["ivf"], "queries": iqs.tolist(),
            "k": 10}, timeout=MH_CALL_S) for p in ports]
        for rank, (status, line, _) in enumerate(holds):
            check(status == 200, f"rank {rank}'s hold: HTTP {status} "
                  f"{line}")
            emit({**line, "rank": rank})
        hold_made = holds[0][1]["hold_launches"]
        # peer death: rank 1 killed, rank 0 degrades to a latched 503
        hosts[1].proc.send_signal(signal.SIGKILL)
        hosts[1].stop(30)
        query = {**who, "query": qs[0].tolist(), "k": 10}
        status, body, first_s = mh_call(ports[0], "/vectors/query", query,
                                        timeout=2 * MH_DEAD_503_S)
        check(status == 503 and body.get("degraded") == "peer_lost"
              and first_s < MH_DEAD_503_S, f"after the peer's death: HTTP "
              f"{status} {body} in {first_s:.1f} s")
        status2, _, next_s = mh_call(ports[0], "/vectors/query", query,
                                     timeout=2 * MH_FAST_FAIL_S)
        hstatus, hbody, _ = mh_call(ports[0], "/health", timeout=30)
        check(status2 == 503 and next_s < MH_FAST_FAIL_S
              and hstatus == 503 and hbody.get("peer_lost"),
              f"not latched: query {status2} in {next_s:.1f} s, /health "
              f"{hstatus} {hbody}")
        emit({"phase": "multihost", "case": "rank 1 killed",
              "first_503_seconds": first_s, "next_503_seconds": next_s,
              "health": hstatus, "error": body["error"][:200]})
        t0 = time.perf_counter()
        hosts[0].proc.send_signal(signal.SIGTERM)
        rc = hosts[0].stop(MH_EXIT_S)
        exit_s = time.perf_counter() - t0
        ends = [ln for ln in hosts[0].lines()
                if ln.get("phase") == "multihost_worker"]
        check(rc == 0 and len(ends) == 1 and not ends[0]["jax_loaded"],
              f"rank 0 did not exit cleanly (rc {rc}):\n{hosts[0].tail()}")
    except BaseException:
        print("".join(h.tail() for h in hosts), file=sys.stderr)
        raise
    finally:
        pool.shutdown()
        for h in hosts:
            if h.proc.poll() is None:
                h.proc.kill()
                h.proc.wait(30)
    # rank 0's launches at its exit, the hold's taken out
    counts["multihost"] = {name: n - hold_made[name]
                           for name, n in ends[0]["launches"].items()}
    emit({"phase": "launches", "path": "multihost", "rank": 0,
          "at": "exit, less the hold's launches", **counts["multihost"]})
    for name in ("scan_kernel", "scan_kernel_bigk", "ivf_kernel",
                 "merge_small_k"):
        check(counts["multihost"][name] > 0,
              f"{name} was not launched on path multihost")
    out = {"card": card_line(), "sigterm_exit_seconds": exit_s,
           **{f"{key}_{m}_ms": lat[key][f"{m}_ms"]
              for key in lat for m in ("p50", "p99")}}
    emit({"phase": "multihost", "case": "summary", **out})
    return out


# --------------------------------------------------------- pipeline path

# BAAI/bge-base-en-v1.5's config.json (the registry's bge-base-768), and
# the registry's other two families at their published shapes:
# all-mpnet-base-v2 and multilingual-e5-small
PIPE_MODELS = {
    "bge-base": ({"model_type": "bert", "vocab_size": 30522,
                  "hidden_size": 768, "num_hidden_layers": 12,
                  "num_attention_heads": 12, "intermediate_size": 3072,
                  "max_position_embeddings": 512, "type_vocab_size": 2,
                  "layer_norm_eps": 1e-12, "hidden_act": "gelu",
                  "pad_token_id": 0}, "cls"),
    "mpnet-base": ({"model_type": "mpnet", "vocab_size": 30527,
                    "hidden_size": 768, "num_hidden_layers": 12,
                    "num_attention_heads": 12, "intermediate_size": 3072,
                    "max_position_embeddings": 514, "layer_norm_eps": 1e-5,
                    "hidden_act": "gelu",
                    "relative_attention_num_buckets": 32,
                    "pad_token_id": 1}, "mean"),
    "e5-small": ({"model_type": "xlm-roberta", "vocab_size": 250002,
                  "hidden_size": 384, "num_hidden_layers": 12,
                  "num_attention_heads": 12, "intermediate_size": 1536,
                  "max_position_embeddings": 514, "type_vocab_size": 1,
                  "layer_norm_eps": 1e-12, "hidden_act": "gelu",
                  "pad_token_id": 1}, "mean"),
}
PIPE_CHUNKS = 50_000            # chunks indexed (100K, a BEIR corpus's
#                                 size, until PR 13: cut for the 1,200 s)
PIPE_PROBES = 200               # retrieve_context(k=5) at batch 1
PIPE_BIGK = 20                  # search_similar_texts(k=100)
PIPE_HOLD_TEXTS = 1024          # texts of the dtype holds
PIPE_CPU_TEXTS = 8              # texts of the card-against-CPU hold
# dtype gates against the float32 forward (tests/test_bert.py's). int4
# is held against its own forward on the CPU instead (the CPU path equals
# the JAX package's, tests/test_torch_bert.py): through 12 layers of
# random N(0, 0.02) weights and a CLS pool its error against float32 is
# the quantizer's own and falls under the 2-layer test's 0.98
PIPE_GATES = {"bfloat16": 0.999, "int8": 0.99}
PIPE_PROBE_COS = 0.999          # a b1 query embedding vs its stored row
# f32 on the card vs the CPU: 12 layers of float32 sums in other orders
PIPE_CPU_TOL = 1e-4


def hf_state(cfg: dict, g) -> dict:
    """HF-keyed weights as transformers initialises them: Linear and
    Embedding N(0, 0.02) (padding rows 0), biases 0, LayerNorm 1 / 0;
    made on the card from ``g``."""
    import torch
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]

    def normal(*shape):
        return (0.02 * torch.randn(shape, generator=g, device="cuda")).cpu()

    sd = {}

    def dense(name, out_f, in_f):
        sd[f"{name}.weight"] = normal(out_f, in_f)
        sd[f"{name}.bias"] = torch.zeros(out_f)

    def ln(name):
        sd[f"{name}.weight"] = torch.ones(h)
        sd[f"{name}.bias"] = torch.zeros(h)

    mpnet = cfg["model_type"] == "mpnet"
    pad = cfg["pad_token_id"]
    sd["embeddings.word_embeddings.weight"] = normal(cfg["vocab_size"], h)
    sd["embeddings.word_embeddings.weight"][pad] = 0
    sd["embeddings.position_embeddings.weight"] = normal(
        cfg["max_position_embeddings"], h)
    if cfg["model_type"] != "bert":
        sd["embeddings.position_embeddings.weight"][pad] = 0
    if not mpnet:
        sd["embeddings.token_type_embeddings.weight"] = normal(
            cfg["type_vocab_size"], h)
    else:
        sd["encoder.relative_attention_bias.weight"] = normal(
            cfg["relative_attention_num_buckets"],
            cfg["num_attention_heads"])
    ln("embeddings.LayerNorm")
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}"
        if mpnet:
            for part in ("q", "k", "v", "o"):
                dense(f"{p}.attention.attn.{part}", h, h)
            ln(f"{p}.attention.LayerNorm")
        else:
            for part in ("query", "key", "value"):
                dense(f"{p}.attention.self.{part}", h, h)
            dense(f"{p}.attention.output.dense", h, h)
            ln(f"{p}.attention.output.LayerNorm")
        dense(f"{p}.intermediate.dense", inter, h)
        dense(f"{p}.output.dense", h, inter)
        ln(f"{p}.output.LayerNorm")
    return sd


def pipe_words(rng, n: int, letters: str) -> list[str]:
    """n distinct words of 3-6 letters."""
    out: set[str] = set()
    abc = np.array(list(letters))
    while len(out) < n:
        lens = rng.integers(3, 7, size=n)
        for ln_ in lens:
            out.add("".join(abc[rng.integers(0, len(abc), size=ln_)]))
            if len(out) == n:
                break
    return sorted(out)


def write_pipe_checkpoint(name: str, g, rng, root: Path) -> tuple[Path,
                                                                  list]:
    """``root/name``: config.json, pytorch_model.bin and the tokenizer
    (a vocab.txt of the config's vocab_size, or for XLM-R a Unigram
    tokenizer.json of vocab_size pieces), made from the seed. Returns the
    directory and the words the texts are made of."""
    import torch
    cfg, _ = PIPE_MODELS[name]
    d = root / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps(cfg))
    state = hf_state(cfg, g)
    if cfg["model_type"] == "xlm-roberta":
        state = {f"roberta.{k}": v for k, v in state.items()}
    torch.save(state, d / "pytorch_model.bin")
    del state
    vocab = cfg["vocab_size"]
    if cfg["model_type"] == "xlm-roberta":
        specials = ["<s>", "<pad>", "</s>", "<unk>"]
        # ASCII and accented words, each one "▁word" piece
        words = pipe_words(rng, vocab - len(specials) - 27,
                           "abcdefghijklmnopqrstuvwxyzäöüéèñç")
        scores = -8.0 - rng.random(len(words))
        pieces = ([[s, 0.0] for s in specials] + [["▁", -5.0]]
                  + [[c, -12.0] for c in "abcdefghijklmnopqrstuvwxyz"]
                  + [["▁" + w, float(s)] for w, s in zip(words, scores)])
        spec = {"model": {"type": "Unigram", "unk_id": 3, "vocab": pieces},
                "normalizer": {"type": "NFKC"},
                "pre_tokenizer": {"type": "Metaspace", "replacement": "▁",
                                  "prepend_scheme": "always",
                                  "split": True},
                "added_tokens": [{"id": i, "content": s, "special": True}
                                 for i, s in enumerate(specials)]}
        (d / "tokenizer.json").write_text(json.dumps(spec),
                                          encoding="utf-8")
        return d, words
    specials = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                if cfg["model_type"] == "bert"
                else ["<s>", "<pad>", "</s>", "[UNK]", "<mask>"])
    words = pipe_words(rng, vocab - len(specials) - 2,
                       "abcdefghijklmnopqrstuvwxyz")
    (d / "vocab.txt").write_text(
        "\n".join(specials + [".", ","] + words) + "\n", encoding="utf-8")
    return d, words


def pipe_documents(rng, words: list[str], chunks: int,
                   doc_words: int = 700) -> tuple[list[str], list[str]]:
    """Documents of sentences (6-14 of the vocabulary's words, then a
    period) until ``chunk_text(512, 50)`` cuts ``chunks`` or more; the
    documents and their chunks in index order."""
    from tpu_vector_db_torch.pipeline import chunk_text
    table = np.array(words, dtype=object)
    docs, pieces = [], []
    while len(pieces) < chunks:
        ids = rng.integers(0, len(table), size=doc_words)
        cuts = np.cumsum(rng.integers(6, 15, size=doc_words // 6))
        cuts = cuts[cuts < doc_words]
        sentences = np.split(table[ids], cuts)
        doc = " ".join(" ".join(s) + "." for s in sentences if len(s))
        docs.append(doc)
        pieces.extend(chunk_text(doc, 512, 50))
    return docs, pieces


def pipe_cos(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1)
                                    * np.linalg.norm(b, axis=1))


def hold_family(name: str, ckpt: Path, texts: list[str], ref=None) -> dict:
    """The dtype holds over ``texts`` (bf16 and int8 gated against
    float32 by cosine; int4 held against its own forward on the CPU), the
    card's float32 forward against the CPU's on ``PIPE_CPU_TEXTS`` texts,
    and the param bytes of each. ``ref``: the float32 encoder, when the
    caller has one."""
    from tpu_vector_db_torch.pipeline import bert, create_encoder
    _, pooling = PIPE_MODELS[name]

    def encoder(device, **kw):
        return create_encoder(f"hf:{ckpt}", device=device, pooling=pooling,
                              **kw)

    f32 = ref or encoder("cuda", dtype="float32")
    want = f32.encode(texts)
    few = texts[:PIPE_CPU_TEXTS]
    cpu_want = encoder("cpu", dtype="float32").encode(few)
    err = float(np.max(np.abs(cpu_want - want[:PIPE_CPU_TEXTS])))
    out = {"family": name, "texts": len(texts),
           "param_bytes": {"float32": bert.param_bytes(f32._model)},
           "card_vs_cpu_max_abs": {"float32": err}}
    check(err <= PIPE_CPU_TOL, f"{name}: float32 on the card is {err} from "
          f"the CPU's")
    for label, kw in (("bfloat16", {"dtype": "bfloat16"}),
                      ("int8", {"dtype": "float32", "quantize": "int8"}),
                      ("int4", {"dtype": "float32", "quantize": "int4"})):
        enc = encoder("cuda", **kw)
        got = enc.encode(texts)
        cos = pipe_cos(got, want)
        out[f"min_cos_{label}"] = float(cos.min())
        out[f"mean_cos_{label}"] = float(cos.mean())
        out["param_bytes"][label] = bert.param_bytes(enc._model)
        check(bool(np.all(np.isfinite(got))) and got.shape == want.shape,
              f"{name} {label}: non-finite or misshapen embeddings")
        if label in PIPE_GATES:
            check(cos.min() >= PIPE_GATES[label],
                  f"{name} {label}: cosine {cos.min()} against float32 "
                  f"below {PIPE_GATES[label]}")
        else:
            cpu_got = encoder("cpu", **kw).encode(few)
            err = float(np.max(np.abs(cpu_got - got[:PIPE_CPU_TEXTS])))
            out["card_vs_cpu_max_abs"][label] = err
            out[f"cpu_min_cos_{label}_{PIPE_CPU_TEXTS}"] = float(
                pipe_cos(cpu_got, cpu_want).min())
            out[f"card_min_cos_{label}_{PIPE_CPU_TEXTS}"] = float(
                cos[:PIPE_CPU_TEXTS].min())
            check(err <= PIPE_CPU_TOL, f"{name} {label}: the card is {err} "
                  f"from the CPU's {label} forward")
        del enc
        free_card()
    emit({"phase": "pipeline", "case": f"{name} holds", **out})
    return out


def encode_rates(enc, texts: list[str]) -> dict:
    """texts/s of ``enc.encode`` at batch 32 and 128 over ``texts``, and
    the tokenizer's share of a batch-32 call."""
    out = {}
    for b in (32, 128):
        enc.encode(texts[:b])   # warm
        t0 = time.perf_counter()
        for i in range(0, len(texts), b):
            enc.encode(texts[i:i + b])
        out[f"texts_per_s_b{b}"] = len(texts) / (time.perf_counter() - t0)
    tok = enc._tokenizer
    t0 = time.perf_counter()
    for i in range(0, len(texts), 32):
        for t in texts[i:i + 32]:
            tok.encode(t, max_length=512)
    tok_s = time.perf_counter() - t0
    out["tokenizer_share_b32"] = tok_s * out["texts_per_s_b32"] / len(texts)
    return out


def small_rag(name: str, ckpt: Path, texts: list[str], tmp: Path,
              counts: dict, errs: dict) -> None:
    """The family's own RAG pipeline on a small corpus: create, index,
    10 retrieve_context(k=5), launches counted."""
    from tpu_vector_db_torch.pipeline import PipelineFactory
    path = f"pipeline_{name}"
    with counting(path, ("scan_kernel",), counts):
        rag = PipelineFactory.create_rag_pipeline(
            tmp / path, model_name=f"hf:{ckpt}", device="cuda")
        rag.pipeline.encoder.pooling = PIPE_MODELS[name][1]
        idx = rag.index_documents(texts)
        top = [rag.retrieve_context(t, k=5).chunks[0]["index"]
               for t in texts[:10]]
    store = rag.pipeline.store
    emb = rag.pipeline.encoder.encode(texts[:1])
    hold_store(store, path, emb, 10, errs)
    emit({"phase": "pipeline", "case": f"{name} rag", "chunks":
          idx["chunks"], "chunks_per_s": idx["chunks_per_second"],
          "own_first": sum(int(t == i) for i, t in enumerate(top)) / 10})


def path_pipeline(g, seed: int, tmp: Path, counts: dict, errs: dict) -> None:
    """The RAG pipeline on a bge-base-shaped encoder: 50K chunks indexed
    by create_rag_pipeline + index_documents (batch 32, bf16), 200
    retrieve_context(k=5) at batch 1 (scan_kernel: it fetches 10) and 20
    search_similar_texts(k=100) (scan_kernel_bigk), each timed; encode
    rates, the tokenizer's share, the busy share of an encode call; the
    dtype and card-vs-CPU holds of all three families."""
    from tpu_vector_db_torch.pipeline import (
        PipelineFactory, create_encoder, fast_unigram, fast_wordpiece)
    rng = np.random.default_rng(seed + 11)
    t0 = time.perf_counter()
    bge, words = write_pipe_checkpoint("bge-base", g, rng, tmp / "models")
    docs, chunks = pipe_documents(rng, words, PIPE_CHUNKS)
    emit({"phase": "pipeline", "case": "set-up", "documents": len(docs),
          "chunks": len(chunks), "mean_chunk_chars":
          float(np.mean([len(c) for c in chunks])),
          "seconds": time.perf_counter() - t0})
    probes = rng.choice(len(chunks), PIPE_PROBES, replace=False)
    with counting("pipeline", FLAT_SCANS, counts):
        t0 = time.perf_counter()
        rag = PipelineFactory.create_rag_pipeline(
            tmp / "rag", model_name=f"hf:{bge}", device="cuda")
        enc = rag.pipeline.encoder
        enc.pooling = "cls"          # bge's pooling
        load_s = time.perf_counter() - t0
        idx = rag.index_documents(docs)
        check(idx["chunks"] == len(chunks) and rag.pipeline.store.get_stats()
              ["vector_count"] == len(chunks), "index_documents: chunks lost")
        encode_s = enc.get_stats()["total_time_s"]
        emit({"phase": "pipeline", "case": f"index {len(chunks)} chunks",
              "load_s": load_s, "seconds": idx["duration_s"],
              "chunks_per_s": idx["chunks_per_second"],
              "encode_s": encode_s, "native_tokenizer": enc._tokenizer.native,
              "native_available": fast_wordpiece.native_available()})
        retrieve_s, own_first = [], 0
        for pid in probes:
            t1 = time.perf_counter()
            ctx = rag.retrieve_context(chunks[pid], k=5)
            retrieve_s.append(time.perf_counter() - t1)
            check(len(ctx.chunks) > 0, "retrieve_context returned nothing")
            own_first += int(ctx.chunks[0]["index"] == pid)
        bigk_s = []
        for pid in probes[:PIPE_BIGK]:
            t1 = time.perf_counter()
            hits = rag.pipeline.search_similar_texts(chunks[pid], k=100)
            bigk_s.append(time.perf_counter() - t1)
            check(len(hits) == 100, "search_similar_texts(k=100) is short")
    emit({"phase": "pipeline", "case": "retrieve_context k=5 b1",
          **latencies(retrieve_s), "own_chunk_first": own_first /
          PIPE_PROBES})
    emit({"phase": "pipeline", "case": "search_similar_texts k=100 b1",
          **latencies(bigk_s)})
    # the probes' embeddings at batch 1 against their rows, stored at b32
    store = rag.pipeline.store
    q = np.concatenate([enc.encode([chunks[p]]) for p in probes])
    rows = store._db[probes, :store.config.dimension].float().cpu().numpy()
    cos = pipe_cos(q, rows)
    emit({"phase": "pipeline", "case": "b1 embedding vs stored row",
          "min_cos": float(cos.min()), "mean_cos": float(cos.mean())})
    check(cos.min() >= PIPE_PROBE_COS, f"a batch-1 query embedding lies at "
          f"cosine {cos.min()} from its own chunk's stored row")
    hold_store(store, "pipeline", q[:1], 10, errs)
    hold_store(store, "pipeline", q[1:2], 100, errs)
    # encode rates (bf16: the pipeline's encoder; float32: the hold's),
    # the tokenizer's share, the busy share of one b32 call
    texts = chunks[:PIPE_HOLD_TEXTS]
    rates = {"bfloat16": encode_rates(enc, texts)}
    f32 = create_encoder(f"hf:{bge}", device="cuda", dtype="float32",
                         pooling="cls")
    rates["float32"] = encode_rates(f32, texts)
    window_ms, by_name, _, _ = profile_device(
        lambda: enc.encode(texts[:32]), 5)
    busy = sum(by_name.values())
    emit({"phase": "pipeline", "case": "encode", **rates,
          "b32_window_ms": window_ms, "b32_device_ms": busy,
          "b32_device_busy_share": busy / window_ms if by_name else
          "not measured (no device events)",
          "top_device_ops": top_kernels(by_name, 6)})
    hold_family("bge-base", bge, texts, ref=f32)
    del rag, enc, f32, store
    free_card()
    for name in ("mpnet-base", "e5-small"):
        ckpt, words = write_pipe_checkpoint(name, g, rng, tmp / "models")
        _, texts = pipe_documents(rng, words, PIPE_HOLD_TEXTS,
                                  doc_words=60)
        texts = texts[:PIPE_HOLD_TEXTS]
        hold_family(name, ckpt, texts)
        small_rag(name, ckpt, texts, tmp, counts, errs)
        emit({"phase": "pipeline", "case": f"{name} tokenizer",
              "native": fast_unigram.native_available()
              if name == "e5-small" else fast_wordpiece.native_available()})
        free_card()
    shutil.rmtree(tmp / "models", ignore_errors=True)


# ------------------------------------------------------ the capacity path

# The JAX package's capacity rows (BENCHMARKS.md:34-36): 16M x 768 cosine
# int8 exact and through the gather-layout IVF at batch 1, 32M x 768
# cosine int4 exact
CAP_D = 768
CAP_ROWS = {"int8": 16 * 2**20, "int4": 32 * 2**20}
CAP_CHUNK = 2**20               # rows an add_vectors call
# a store keeps every row as f32 on the host and copies them once as it
# doubles: 2 x rows x d x 4 bytes must fit this share of MemAvailable
CAP_HOST_SHARE = 0.6
CAP_DISK_FACTOR = 1.3           # a flush needs 1.3 x rows x d x 4 bytes
# halvings for the script's time limit, int4's first; int8's never
# below CAP_MIN_INT8 rows (one halving since the examples and the
# multihost ANN stores joined the script: 8,388,608 -> 4,194,304 on a
# 96 GiB host)
CAP_TIME_HALVINGS = {"int4": 3, "int8": 1}
CAP_MIN_INT8 = 4 * 2**20
CAP_QUERIES = 64
CAP_FILTER = {"g": 7}           # rows carry g = id % 100: a 1% filter
CAP_DELETED = 1000              # one row in this many is deleted (0.1%)
CAP_SHARDS = 2                  # the int4 store's sharded reopen (cuda:0)
RERANK_TOL = 1e-5               # f32 re-scores: the host's against the card's


def mem_available() -> int:
    """The host's MemAvailable in bytes (/proc/meminfo)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise SmokeFailure("no MemAvailable in /proc/meminfo")


def capacity_sizes(tmp: Path) -> tuple[dict[str, int], dict]:
    """Rows of each capacity store: the JAX package's, halved until the
    host holds the store (CAP_HOST_SHARE), then until the disk holds its
    flush (CAP_DISK_FACTOR), then by CAP_TIME_HALVINGS. Returns the rows
    and the env line that prints them with every cut and its reason."""
    from tpu_vector_db_torch.store.config import VectorStoreConfig
    mem = mem_available()
    disk = shutil.disk_usage(tmp).free
    budget = VectorStoreConfig.device_budget_bytes("cuda")
    feasible = {dt: VectorStoreConfig(dimension=CAP_D, storage_dtype=dt)
                .max_feasible_rows(budget)
                for dt in ("float32", "bfloat16", "int8", "int4")}
    rows, cuts = {}, []
    for dtype in ("int4", "int8"):
        n = CAP_ROWS[dtype]
        f32_bytes = n * CAP_D * 4
        while 2 * f32_bytes > CAP_HOST_SHARE * mem:
            cuts.append({"store": dtype, "rows": n, "to": n // 2,
                         "why": "host: 2 x rows x d x 4 B > "
                         f"{CAP_HOST_SHARE} x MemAvailable"})
            n //= 2
            f32_bytes //= 2
        while CAP_DISK_FACTOR * f32_bytes > disk:
            cuts.append({"store": dtype, "rows": n, "to": n // 2,
                         "why": f"disk: {CAP_DISK_FACTOR} x rows x d x 4 B "
                         "> free disk"})
            n //= 2
            f32_bytes //= 2
        for _ in range(CAP_TIME_HALVINGS[dtype]):
            if dtype == "int8" and n // 2 < CAP_MIN_INT8:
                break
            cuts.append({"store": dtype, "rows": n, "to": n // 2,
                         "why": "time: the script's 1,200 s"})
            n //= 2
        rows[dtype] = n
    return rows, {"phase": "env", "case": "capacity sizes",
                  "mem_available_bytes": mem, "disk_free_bytes": disk,
                  "device_budget_bytes": budget,
                  "max_feasible_rows_768": feasible,
                  "jax_rows": CAP_ROWS, "rows": rows, "cuts": cuts}


@contextlib.contextmanager
def uncounted():
    """Launches in the block (a kernel held against its plain version,
    timed or profiled on its own) are taken back out of the path's
    counts."""
    from tpu_vector_db_torch.ops.launches import LAUNCHES
    before = dict(LAUNCHES)
    try:
        yield
    finally:
        LAUNCHES.update(before)


def capacity_guard(tmp: Path) -> None:
    """The device-budget guard on the card: the budget is the card's own
    memory times the usable fraction; a config past int8's capacity is
    refused with the int4 capacity in its message; an add that would grow
    an f32 store past the budget is refused before it changes the store
    (a 2^25-row growth unit: one row asks for 103 GB)."""
    import os
    import torch
    from tpu_vector_db_torch import create_vector_store
    from tpu_vector_db_torch.store.config import (_HBM_USABLE_FRACTION,
                                                  StoreCapacityError,
                                                  VectorStoreConfig)
    check("VDB_HBM_BYTES" not in os.environ, "VDB_HBM_BYTES is set: the "
          "budget would not come from the card")
    total = torch.cuda.get_device_properties(0).total_memory
    budget = VectorStoreConfig.device_budget_bytes("cuda")
    check(budget == int(total * _HBM_USABLE_FRACTION),
          f"device budget {budget} is not {_HBM_USABLE_FRACTION} x the "
          f"card's {total} bytes")
    int8_max = VectorStoreConfig(dimension=CAP_D, storage_dtype="int8"
                                 ).max_feasible_rows(budget)
    int4_max = VectorStoreConfig(
        dimension=CAP_D, storage_dtype="int4",
        ann_params={"index_type": "ivf"}, initial_capacity=1
    ).max_feasible_rows(budget)
    refused = {}
    for dtype in ("int8", "float32"):
        try:
            VectorStoreConfig(dimension=CAP_D, storage_dtype=dtype,
                              initial_capacity=int8_max + 1)
            refused[dtype] = None
        except StoreCapacityError as exc:
            refused[dtype] = str(exc)
    check(refused["int8"] is not None and refused["float32"] is not None,
          f"a config of {int8_max + 1} rows was not refused: {refused}")
    check(f"~{int4_max} rows at int4" in refused["float32"],
          f"the refusal does not name the int4 capacity {int4_max}: "
          f"{refused['float32']}")
    store = create_vector_store(tmp / "cap_guard", dimension=CAP_D,
                                device="cuda", persist_mode="off",
                                block_rows=2**25)
    allocated = torch.cuda.memory_allocated()
    try:
        store.add_vectors(np.ones((1, CAP_D), np.float32))
        add_refused = None
    except StoreCapacityError as exc:
        add_refused = str(exc)
    check(add_refused is not None and store._count == 0
          and store.vector_count == 0 and store._db is None
          and store._host_buf is None
          and torch.cuda.memory_allocated() == allocated,
          f"the over-budget add was not refused before it changed the store "
          f"({add_refused})")
    emit({"phase": "capacity", "case": "guard", "total_memory": total,
          "budget": budget, "usable_fraction": _HBM_USABLE_FRACTION,
          "int8_max_rows": int8_max, "int4_max_rows": int4_max,
          "refused_int8": refused["int8"],
          "refused_float32": refused["float32"], "refused_add": add_refused,
          "count_after": store._count})


def rule_a(reranked: list, cands: list, gt_host, k: int) -> dict:
    """Rule (a): each reranked answer is the f32 re-score of the exact
    scan's own k x 4 candidates (``cands``), read from the card's f32
    ground truth ``gt_host`` (Q, N): scores within RERANK_TOL, ids equal
    away from near-ties."""
    import torch
    err, ok = 0.0, True
    for qi, ((ids, scores, _), (cids, _, _)) in enumerate(zip(reranked,
                                                              cands)):
        cids = np.asarray(cids)
        keys = gt_host[qi][torch.from_numpy(cids)].numpy()
        order = np.argsort(-keys, kind="stable")[:k]
        want_ids, want = cids[order], keys[order]
        diff = np.abs(np.asarray(scores, np.float64) - want)
        err = max(err, float(diff.max(initial=0.0)))
        ok &= len(ids) == k and bool(np.all(diff <= RERANK_TOL))
        for r in range(k):
            near = ((r > 0 and want[r - 1] - want[r] <= RERANK_TOL) or
                    (r + 1 < k and want[r] - want[r + 1] <= RERANK_TOL))
            ok &= bool(near or ids[r] == int(want_ids[r]))
    return {"rule_a_ok": ok, "rule_a_max_err": err}


def recall_vs_exact(results: list, exact: list, k: int) -> float:
    """Recall@k of ANN answers against the store's own exact scan: an id
    counts if it is in the exact top-k or its key reaches the exact k-th
    within KEY_TOL (the quantized keys tie)."""
    hits = 0
    for (ids, scores, _), (eids, escores, _) in zip(results, exact):
        kth = escores[k - 1]
        hits += sum(1 for i, sc in zip(ids, scores)
                    if i in set(eids) or sc >= kth - KEY_TOL)
    return hits / (len(results) * k)


def widened_rows(db, scales, count: int):
    """The store's first ``count`` rows widened to bf16 (int8: the x127
    values; int4: dequantized) in blocks, for the library yardstick."""
    import torch
    from tpu_vector_db_torch.ops.quant4 import unpack_int4
    d_pad = db.shape[1] * (2 if db.dtype == torch.uint8 else 1)
    out = torch.empty((count, d_pad), dtype=torch.bfloat16, device=db.device)
    for a in range(0, count, CAP_CHUNK):
        b = min(a + CAP_CHUNK, count)
        out[a:b] = (unpack_int4(db[a:b], scales[a:b])
                    if db.dtype == torch.uint8 else db[a:b]).to(
            torch.bfloat16)
    return out


def capacity_kernels(store, qs: np.ndarray, label: str, errs: dict,
                     cases=((1, 10), (64, 10), (1, 100))) -> None:
    """Each flat kernel on the store's own scan inputs: held against its
    plain version and timed (CUDA events, ``device_ms`` with the bound as
    floor), beside the plain version and, when the rows widened to bf16
    fit on the card beside the store, matmul + topk on them."""
    import torch
    from tpu_vector_db_torch.ops import cuda_scan
    dtype = store.config.storage_dtype
    args0 = store._scan_inputs(qs[:1], None)
    db, count, scales = args0["db"], args0["count"], args0["db_scales"]
    d_pad = args0["queries"].shape[1]
    free, _ = torch.cuda.mem_get_info()
    dense = None
    # the bf16 rows with room to spare, and a b64 product's f32 output
    if count * d_pad * 2 * 1.5 + 64 * count * 4 < free:
        dense = widened_rows(db, scales, count)
    n_sm = torch.cuda.get_device_properties(db.device).multi_processor_count
    for q_n, k in cases:
        hold_store(store, "capacity", qs[:q_n], k, errs)
        args = store._scan_inputs(qs[:q_n], None)
        name = cuda_scan.kernel_name(k)
        row_bytes = db.shape[1] * db.element_size()
        floor, by = bound(count, row_bytes, q_n, CAP_D, k, dtype,
                          count * 4 if scales is not None else 0)
        line = {"phase": "capacity", "case": f"{label} kernel", "kernel":
                name, "design": cuda_scan._launch_plan(
                    q_n, db.dtype, d_pad, k, count, n_sm).design,
                "dtype": dtype, "Q": q_n, "k": k, "count": count,
                "kernel_ms": cuda_ms(
                    lambda: cuda_scan.flat_topk(k=k, **args), 10),
                "plain_ms": cuda_ms(
                    lambda: cuda_scan.flat_topk_plain(k=k, **args), 1, 0),
                "bound_ms": floor, "bound_by": by}
        if dense is None:
            line["library_ms"] = "not measured (memory)"
        else:
            lib_q = args["queries"].to(torch.bfloat16)
            line["library_ms"] = cuda_ms(lambda: torch.topk(
                torch.matmul(lib_q, dense.T), k, dim=1), 5)
        line.update(device_ms(lambda: cuda_scan.flat_topk(k=k, **args), 10,
                              expect_flat(k), floor))
        emit(line)
    del dense
    free_card()


def capacity_device(store, qs: np.ndarray, label: str) -> None:
    """The busy share and device time of exact b1 and b64 top-10 store
    calls, with their bound (the rows' bytes over the memory rate)."""
    from tpu_vector_db_torch.ops import cuda_scan
    args = store._scan_inputs(qs[:1], None)
    db, count = args["db"], args["count"]
    for q_n, reps in ((1, 20), (64, 10)):
        floor, by = bound(count, db.shape[1] * db.element_size(), q_n,
                          CAP_D, 10, store.config.storage_dtype,
                          count * 4 if args["db_scales"] is not None else 0)
        share = counted(lambda: device_share(store, qs[:q_n], 10, reps,
                                             expect_flat(10), use_ann=False),
                        "scan_kernel")
        dev = counted(lambda: device_ms(lambda: store.batch_query(
            qs[:q_n], k=10, use_ann=False), reps, expect_flat(10), floor),
            "scan_kernel")
        emit({"phase": "capacity", "case": f"{label} top-10 b{q_n} "
              "profiled", **share, "call_device_ms": dev["device_ms"],
              "call_device_ms_traces": dev["device_ms_traces"],
              "bound_ms": floor, "bound_by": by,
              "kernel": cuda_scan.kernel_name(10),
              **agreement(dev["device_ms"], share)})


def capacity_fill(store, g, n: int, make_rows, rng, meta) -> tuple:
    """Add n rows made on the card in CAP_CHUNK chunks (``make_rows(g,
    rows)``, unit rows; ``meta(start, stop)`` their metadata or None).
    The queries are the first chunk's first rows plus 0.05 N(0, I); their
    f32 cosine keys against every row (the ground truth) are taken on the
    card chunk by chunk. Returns (queries, ground truth (Q, n) on the
    card, seconds of each add)."""
    import torch
    gt = torch.empty((CAP_QUERIES, n), device="cuda")
    qs = qn = None
    add_s = []
    for start in range(0, n, CAP_CHUNK):
        stop = min(start + CAP_CHUNK, n)
        rows = make_rows(g, stop - start)
        if qs is None:
            qs = rows[:CAP_QUERIES].cpu().numpy() + 0.05 * \
                rng.standard_normal((CAP_QUERIES, CAP_D)).astype(np.float32)
            qn = unit_(torch.from_numpy(qs).cuda())
        gt[:, start:stop] = qn @ rows.T
        host = rows.cpu().numpy()
        del rows
        m = meta(start, stop) if meta else None
        t0 = time.perf_counter()
        store.add_vectors(host, m)
        add_s.append(time.perf_counter() - t0)
        del host, m
    return qs, gt, add_s


def capacity_int8(g, rng, tmp: Path, n: int, errs: dict) -> dict:
    """16M x 768 cosine int8 (or its cut) with enable_ann=True: the IVF
    in its gather layout, exact, reranked and IVF queries against an f32
    ground truth, a 1% filter, 0.1% deleted, flush and reopen. Returns
    the gather kernel's headline timings (b16, k = 40, on this store)."""
    import torch
    from tpu_vector_db_torch import TorchVectorStore, create_vector_store
    path = tmp / "cap_int8"
    centres = torch.randn((IVF_CENTERS, CAP_D), generator=g, device="cuda")
    store = create_vector_store(path, dimension=CAP_D, device="cuda",
                                storage_dtype="int8", persist_mode="lazy",
                                enable_ann=True)
    qs, gt, add_s = capacity_fill(
        store, g, n, lambda g_, m: clustered_rows(g_, centres, m), rng,
        lambda a, b: [{"g": i % 100} for i in range(a, b)])
    del centres
    st, ann = store.get_stats(), store._ann
    check(st["index_type"] == "ivf" and st["vector_count"] == n
          and ann.size == n, f"the int8 store is not an IVF over {n} rows")
    ist = ann.get_stats()
    emit({"phase": "capacity", "case": f"int8 add {n}x{CAP_D} in "
          f"{len(add_s)} chunks", "seconds": sum(add_s),
          "first_add_with_build_seconds": add_s[0], "add_seconds": add_s,
          "device_capacity": st["device_capacity"],
          "clusters": ist["clusters"], "buckets": ist["buckets"],
          "bucket_rows": ist["bucket_rows"], "nprobe": ann.nprobe,
          "ann_recall_estimate": st["ann_recall_estimate"],
          "mem_available_bytes": mem_available()})
    t0 = time.perf_counter()
    store.optimize()
    opt_s = time.perf_counter() - t0
    ann = store._ann
    ist = ann.get_stats()
    check(ist["layout"] == "gather", f"the int8 IVF is {ist['layout']}")
    emit({"phase": "capacity", "case": "int8 optimize (IVF rebuild)",
          "seconds": opt_s, "index_build_seconds": ann.build_time_s,
          "clusters": ist["clusters"], "buckets": ist["buckets"],
          "bucket_rows": ist["bucket_rows"], "layout": ist["layout"],
          "nprobe": ann.nprobe, "id_table_mb": ist["memory_mb"],
          "ann_recall_estimate": store.get_stats()["ann_recall_estimate"]})
    exact = dict(use_ann=False)
    for label, q_n, k, reps, kw, kernel in (
            ("exact top-10 b1", 1, 10, 20, exact, "scan_kernel"),
            ("exact top-10 b64", 64, 10, 10, exact, "scan_kernel"),
            ("exact top-100 b1", 1, 100, 10, exact, "scan_kernel_bigk"),
            ("exact 1% filter top-10 b1", 1, 10, 10,
             dict(exact, filter_metadata=CAP_FILTER), "scan_kernel"),
            ("rerank top-10 b1", 1, 10, 20, dict(exact, rerank=True),
             "scan_kernel_bigk"),
            ("rerank top-10 b64", 64, 10, 5, dict(exact, rerank=True),
             "scan_kernel_bigk")):
        r = counted(lambda: timed_queries(store, qs[:q_n], k, reps, **kw),
                    kernel)
        emit({"phase": "capacity", "case": f"int8 {label}", **r})
    res = store.query(qs[0], k=10, filter_metadata=CAP_FILTER,
                      use_ann=False)
    check(len(res[0]) == 10 and all(m == CAP_FILTER for m in res[2]),
          "the int8 1% filter returned a row outside it")
    for q_n, reps in ((1, 20), (8, 10)):
        r = ann_routed(lambda: timed_queries(store, qs[:q_n], 10, reps))
        emit({"phase": "capacity", "case": f"int8 IVF top-10 b{q_n}",
              "nprobe": ann.nprobe, **r})
    emit({"phase": "capacity", "case": "int8 IVF top-10 b8 profiled",
          "nprobe": ann.nprobe, **ann_profiled(store, qs[:8], 10, 10)})
    # recall@10 of the 64 queries against the f32 ground truth
    gt_host = gt.cpu()
    del gt
    gt_vals = torch.topk(gt_host, 10, dim=1).values
    answers = {"exact": store.batch_query(qs, k=10, use_ann=False),
               "rerank": store.batch_query(qs, k=10, rerank=True,
                                           use_ann=False),
               "ivf": [r for i in range(0, CAP_QUERIES, 8)
                       for r in ann_routed(lambda: store.batch_query(
                           qs[i:i + 8], k=10))]}
    recall = {name: tie_aware_recall(res, gt_host, gt_vals, 10)
              for name, res in answers.items()}
    ivf_vs_exact = recall_vs_exact(answers["ivf"], answers["exact"], 10)
    cands = store.batch_query(qs, k=40, use_ann=False)
    ra = rule_a(answers["rerank"], cands, gt_host, 10)
    # the recall gates against the f32 ground truth are measurements of
    # int8's resolution on these rows, not of the code: a gate not met is
    # printed as a finding; the index is held to the JAX self-check's bar
    # against the store's own exact scan, and rerank to rule (a)
    gates = {"rerank_vs_f32 == 1.0": recall["rerank"] == 1.0,
             "ivf_vs_f32 >= 0.95": recall["ivf"] >= 0.95}
    emit({"phase": "capacity", "case": "int8 recall@10 64q vs f32",
          **{f"recall_{k_}": v for k_, v in recall.items()},
          "ivf_recall_vs_exact_int8": ivf_vs_exact, **ra,
          "gates_met": gates, "nprobe": ann.nprobe})
    for gate, met in gates.items():
        if not met:
            emit({"phase": "capacity", "case": "finding: gate not met",
                  "gate": gate, "recall": recall})
    check(ra["rule_a_ok"], "int8 rerank is not the f32 re-score of its "
          f"candidates ({ra})")
    check(ivf_vs_exact >= 0.95, f"int8 gather-IVF recall@10 against the "
          f"exact int8 scan = {ivf_vs_exact} < 0.95")
    # a full probe returns the exact int8 scan's top-10
    nb = ann.get_stats()["buckets"]
    prepared = store._prepare_queries(qs[:8])
    ids, keys = ann_routed(lambda: ann.search(
        prepared, store._db, store._count, k=10, nprobe=nb,
        scales=store._scales))
    keys = np.where(np.isfinite(keys), keys * (1.0 / 127.0), keys)
    fkeys, fids = store._flat_topk(qs[:8], 10, None)
    err, keys_ok, ids_ok = compare(
        torch.from_numpy(keys), torch.from_numpy(ids),
        torch.from_numpy(fkeys), torch.from_numpy(fids), "cosine")
    emit({"phase": "capacity", "case": "int8 full probe vs exact 8q",
          "nprobe": nb, "max_abs_err": err, "keys_ok": keys_ok,
          "ids_ok": ids_ok})
    check(keys_ok and ids_ok, "a full gather-IVF probe differs from the "
          f"exact int8 scan (key error {err})")
    # the gather kernel against its plain version on this store; the
    # refine's 40 candidates at b16 (the benchmark's ivfsq8 call) timed
    with uncounted():
        for k in (5, 10, 40):
            for q_n in (1, 8, 16):
                out = hold_gather(store, "capacity", qs[:q_n], k, errs,
                                  timed=(q_n, k) == (16, 40))
                if (q_n, k) == (16, 40):
                    gather = dict(design="gather probe", ms=out["kernel_ms"],
                                  device_ms=out["device_ms"],
                                  plain_ms=out["plain_ms"],
                                  bound_ms=out["bound_ms"],
                                  bound_by=out["bound_by"], library_ms=None)
    capacity_device(store, qs, "int8")
    with uncounted():
        capacity_kernels(store, qs, "int8", errs,
                         ((1, 10), (64, 10), (1, 40), (64, 40), (1, 100)))
    # 0.1% deleted, the answers recorded, flush, reopen
    dead = np.sort(rng.choice(n, n // CAP_DELETED, replace=False))
    t0 = time.perf_counter()
    store.delete_vectors(dead)
    del_s = time.perf_counter() - t0
    dead_set = set(dead.tolist())
    before = {"exact b8": store.batch_query(qs[:8], k=10, use_ann=False),
              "exact b64": store.batch_query(qs, k=10, use_ann=False),
              "rerank b8": store.batch_query(qs[:8], k=10, rerank=True,
                                             use_ann=False),
              "filter b1": store.batch_query(qs[:1], k=10, use_ann=False,
                                             filter_metadata=CAP_FILTER)}
    check(not any(i in dead_set for res in before["exact b64"]
                  for i in res[0]), "a deleted row came back")
    ivf_before = store._ann_search(store._prepare_queries(qs[:8]), 10)
    t0 = time.perf_counter()
    store.flush()
    flush_s = time.perf_counter() - t0
    del store, ann, prepared
    free_card()
    t0 = time.perf_counter()
    store = TorchVectorStore(path, device="cuda")
    reopen_s = time.perf_counter() - t0
    served = (store._ann is not None and not store._ann_stale
              and store._ann.size == n and store._ann.build_time_s == 0.0)
    check(served, "the reopened int8 store rebuilt its IVF instead of "
          "serving ann_ivf.npz")
    after = {"exact b8": store.batch_query(qs[:8], k=10, use_ann=False),
             "exact b64": store.batch_query(qs, k=10, use_ann=False),
             "rerank b8": store.batch_query(qs[:8], k=10, rerank=True,
                                            use_ann=False),
             "filter b1": store.batch_query(qs[:1], k=10, use_ann=False,
                                            filter_metadata=CAP_FILTER)}
    ivf_after = store._ann_search(store._prepare_queries(qs[:8]), 10)
    same = {k_: same_answers(after[k_], before[k_], 0.0) for k_ in before}
    same["ivf b8"] = all(np.array_equal(a, b)
                         for a, b in zip(ivf_after, ivf_before))
    emit({"phase": "capacity", "case": "int8 delete, flush, reopen",
          "deleted": len(dead), "delete_seconds": del_s,
          "flush_seconds": flush_s, "reopen_seconds": reopen_s,
          "sidecar_served": served, "same_answers": same,
          "deleted_count": store.get_stats()["deleted_count"]})
    check(all(same.values()), f"the reopened int8 store answers "
          f"differently: {same}")
    with uncounted():
        hold_store(store, "capacity", qs, 10, errs)
    del store, gt_host
    free_card()
    return gather


def capacity_int4(g, rng, tmp: Path, n: int, errs: dict) -> None:
    """32M x 768 cosine int4 (or its cut), exact, N(0, I) unit rows:
    top-10 b1 / b64, top-100 b1, rerank b64, flush, reopen, and a
    sharded reopen on co-located shards (the sharded store's blocked
    upload, and the k·P merge) answering alike."""
    import torch
    from tpu_vector_db_torch import TorchVectorStore, create_vector_store
    from tpu_vector_db_torch.parallel import (ShardedVectorStore,
                                              make_device_mesh)
    path = tmp / "cap_int4"
    store = create_vector_store(path, dimension=CAP_D, device="cuda",
                                storage_dtype="int4", persist_mode="lazy")
    qs, gt, add_s = capacity_fill(store, g, n, lambda g_, m: unit_rows(
        g_, m, CAP_D), rng, None)
    st = store.get_stats()
    check(st["vector_count"] == n and st["index_type"] == "flat",
          f"the int4 store holds {st}")
    emit({"phase": "capacity", "case": f"int4 add {n}x{CAP_D} in "
          f"{len(add_s)} chunks", "seconds": sum(add_s),
          "add_seconds": add_s, "device_capacity": st["device_capacity"],
          "mem_available_bytes": mem_available()})
    for label, q_n, k, reps, kw, kernel in (
            ("top-10 b1", 1, 10, 20, {}, "scan_kernel"),
            ("top-10 b64", 64, 10, 10, {}, "scan_kernel"),
            ("top-100 b1", 1, 100, 10, {}, "scan_kernel_bigk"),
            ("rerank top-10 b64", 64, 10, 5, {"rerank": True},
             "scan_kernel_bigk")):
        r = counted(lambda: timed_queries(store, qs[:q_n], k, reps, **kw),
                    kernel)
        emit({"phase": "capacity", "case": f"int4 {label}", **r})
    gt_host = gt.cpu()
    del gt
    gt_vals = torch.topk(gt_host, 10, dim=1).values
    exact = store.batch_query(qs, k=10)
    reranked = store.batch_query(qs, k=10, rerank=True)
    cands = store.batch_query(qs, k=40)
    ra = rule_a(reranked, cands, gt_host, 10)
    emit({"phase": "capacity", "case": "int4 recall@10 64q vs f32",
          "recall_exact": tie_aware_recall(exact, gt_host, gt_vals, 10),
          "recall_rerank": tie_aware_recall(reranked, gt_host, gt_vals, 10),
          **ra})
    check(ra["rule_a_ok"], "int4 rerank is not the f32 re-score of its "
          f"candidates ({ra})")
    capacity_device(store, qs, "int4")
    with uncounted():
        capacity_kernels(store, qs, "int4", errs,
                         ((1, 10), (64, 10), (64, 40), (1, 100)))
    before = {"b1": store.batch_query(qs[:1], k=10),
              "b64": store.batch_query(qs, k=10),
              "top-100 b1": store.batch_query(qs[:1], k=100),
              "rerank b64": reranked}
    t0 = time.perf_counter()
    store.flush()
    flush_s = time.perf_counter() - t0
    del store, exact, cands
    free_card()
    t0 = time.perf_counter()
    store = TorchVectorStore(path, device="cuda")
    reopen_s = time.perf_counter() - t0
    after = {"b1": store.batch_query(qs[:1], k=10),
             "b64": store.batch_query(qs, k=10),
             "top-100 b1": store.batch_query(qs[:1], k=100),
             "rerank b64": store.batch_query(qs, k=10, rerank=True)}
    same = {k_: same_answers(after[k_], before[k_], 0.0) for k_ in before}
    emit({"phase": "capacity", "case": "int4 flush, reopen",
          "flush_seconds": flush_s, "reopen_seconds": reopen_s,
          "same_answers": same})
    check(all(same.values()), f"the reopened int4 store answers "
          f"differently: {same}")
    with uncounted():
        hold_store(store, "capacity", qs[:8], 10, errs)
    del store
    free_card()
    t0 = time.perf_counter()
    sharded = ShardedVectorStore(path, mesh=make_device_mesh(
        devices=["cuda:0"] * CAP_SHARDS))
    sharded_s = time.perf_counter() - t0
    got = {k_: sharded.batch_query(qs[:1] if "b1" in k_ else qs,
                                   k=100 if "100" in k_ else 10,
                                   rerank="rerank" in k_)
           for k_ in before}
    same = {k_: same_answers(got[k_], before[k_]) for k_ in before}
    r = timed_queries(sharded, qs[:1], 10, 20)
    emit({"phase": "capacity", "case": f"int4 sharded reopen P="
          f"{CAP_SHARDS} (cuda:0)", "reopen_seconds": sharded_s,
          "rows_per_shard": sharded.get_stats()["rows_per_shard"],
          "same_answers": same, "top-10 b1": r})
    check(all(same.values()), f"the sharded int4 reopen answers "
          f"differently: {same}")
    del sharded, gt_host
    free_card()


def path_capacity(g, seed: int, tmp: Path, counts: dict,
                  errs: dict) -> dict:
    """The capacity modes through the store: int8 (exact, rerank, the
    gather IVF) and int4 (exact, rerank) at the JAX package's rows or the
    cut the host, the disk or the script's time forces; the guard.
    Returns the gather kernel's headline timings."""
    t_path = time.perf_counter()
    tmp.mkdir(parents=True, exist_ok=True)
    free_card()
    rows, env = capacity_sizes(tmp)
    emit(env)
    rng = np.random.default_rng(seed + 12)
    with counting("capacity", FLAT_SCANS + ("merge_small_k",
                                            "ivf_gather_kernel"), counts):
        capacity_guard(tmp)
        t0 = time.perf_counter()
        headline = capacity_int8(g, rng, tmp, rows["int8"], errs)
        int8_s = time.perf_counter() - t0
        shutil.rmtree(tmp / "cap_int8", ignore_errors=True)
        t0 = time.perf_counter()
        capacity_int4(g, rng, tmp, rows["int4"], errs)
        int4_s = time.perf_counter() - t0
        shutil.rmtree(tmp / "cap_int4", ignore_errors=True)
    emit({"phase": "capacity", "case": "seconds", "int8_seconds": int8_s,
          "int4_seconds": int4_s,
          "path_seconds": time.perf_counter() - t_path})
    return headline


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multihost-worker", nargs=4,
                    metavar=("RANK", "COORD", "HTTP_PORT", "DATA_DIR"),
                    help="serve as one process of the multihost path")
    ap.add_argument("--multihost-pair", nargs=2, metavar=("RANK", "COORD"),
                    help="time the cross-process merge as one of two")
    args = ap.parse_args()

    if not (REPO / "tpu_vector_db_torch" / "csrc").is_dir():
        print("chip_smoke.py: tpu_vector_db_torch is not beside this "
              "script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.multihost_worker:
        rank, coord, port, data_dir = args.multihost_worker
        return multihost_worker(int(rank), coord, int(port), data_dir)
    if args.multihost_pair:
        return multihost_pair(int(args.multihost_pair[0]),
                              args.multihost_pair[1])
    card = card_line()
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "numpy": np.__version__, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    tmp = REPO / "_smoke_tmp"
    counts: dict[str, dict] = {}
    record: dict = {}
    seconds: dict[str, float] = {}
    t_script = time.perf_counter()

    def timed(fn, *a):
        """fn(*a), its seconds kept under its name (the script's time
        limit is shared by every phase)."""
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[fn.__name__] = time.perf_counter() - t0
        return out

    try:
        timed(phase_build)
        headline, errs = timed(phase_kernels, 768, args.seed)
        errs["ivf_kernel"] = timed(phase_ivf_kernels, args.seed)
        timed(phase_merge, args.seed)
        timed(phase_rownorm, args.seed)
        shutil.rmtree(tmp, ignore_errors=True)
        g = torch.Generator(device="cuda").manual_seed(args.seed + 1)
        timed(path_main, g, args.seed, tmp, counts, errs)
        timed(path_config2, g, tmp, counts, errs)
        timed(path_config4, g, args.seed, tmp, counts, errs)
        timed(path_config1, g, args.seed, tmp, counts, errs)
        headline["ivf_kernel"] = timed(path_ivf, g, tmp, counts, errs)
        timed(path_ivf_small, g, tmp, counts, errs)
        timed(path_graph, g, args.seed, tmp, counts, errs)
        timed(path_graph_native, g, tmp, counts, errs)
        timed(path_serve, g, args.seed, tmp, counts, errs)
        timed(path_examples, tmp, counts, errs)
        headline["merge_small_k"] = timed(path_sharded, g, args.seed, tmp,
                                          counts, errs, record)
        timed(path_multihost, g, tmp, counts, record)
        timed(path_pipeline, g, args.seed, tmp, counts, errs)
        headline["ivf_gather_kernel"] = timed(path_capacity, g, args.seed,
                                              tmp, counts, errs)
        emit({"phase": "seconds", "by_phase": seconds,
              "total": time.perf_counter() - t_script})
        kernels = [{"name": name, "route": "cuda", "source": SOURCE[name],
                    "replaces": REPLACES[name],
                    "launches": counts[HEADLINE_PATH[name]][name],
                    "launches_path": HEADLINE_PATH[name],
                    "launches_by_path": {path: c[name] for path, c in
                                         counts.items() if c.get(name)},
                    "max_abs_err": errs[name], **headline[name]}
                   for name in ("scan_kernel", "scan_kernel_bigk",
                                "ivf_kernel", "ivf_gather_kernel",
                                "merge_small_k")]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
