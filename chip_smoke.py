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
   "merge" lines);
4. drives the store through ``create_vector_store(..., device="cuda")`` on
   eight paths, and the server on a ninth, each with the launch counts
   set to 0 just before it and read just after: the main path, 1M x 768
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
   package's beam-graph regime (300K x 768 f32 cosine, 300 centres, unit
   noise) with ``index_type="beam_graph"``: added in 3 x 100K (a build,
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
   127.0.0.1 at a free port, spoken to over TCP with aiohttp): a 1M x
   768 f32 cosine store made by ``/admin/create_store`` and filled by 8
   ``/v1/batch/upload`` calls of 125K rows (followed on their SSE
   streams), 50 sequential ``/vectors/query`` requests, 256 concurrent
   ones (64 in flight) that the query coalescer folds into batched scans
   (the launches equal to its flushes, every answer equal to the store's
   own ``batch_query``), ``/vectors/batch_query`` at batch 64, top-10 and
   top-100, a filter, an add with self-queries, a delete, the request
   count in ``/monitoring/prometheus``, the card in ``/health`` and
   ``/system/info``, and the device's busy share of a burst of 64
   requests, and then (its own ``sdk`` launch line) the port's SDK: health,
   10 queries and a batch query equal to the store's own, and an
   ``index_type="hnsw"`` graph store created, filled and queried. After
   each path the kernels
   are held against their plain version once more on that store's own
   rows, buckets, masks, batch sizes and k, and the big-k calls of the
   main path (top-2000 b1) and config #2 (top-100 b64) are profiled
   (device time by kernel against the call's window: "profiled" lines,
   after the path's launch counts are read);
5. prints one JSON line of the kernels (launches from each kernel's
   headline path: ``main`` for the flat kernels, ``ivf`` for the IVF
   kernel), the card's name and power limit, and last ``{"ok": true,
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
          "ivf_kernel": "tpu_vector_db_torch/csrc/ivf_topk.cu"}
REPLACES = {"scan_kernel": "tpu_vector_db/ops/pallas_scan.py:112",
            "scan_kernel_bigk": "tpu_vector_db/ops/pallas_scan.py:259",
            "ivf_kernel": "tpu_vector_db/ops/ivf_scan.py:40"}
# the path whose launch counts stand in the kernels line, and the case its
# timings come from: the shape that path gives the kernel (flat top-10 at
# batch 64 and top-100 at batch 1 on the main path; an IVF top-10 query at
# batch 1 on the ivf path's own index, timed there)
HEADLINE_PATH = {"scan_kernel": "main", "scan_kernel_bigk": "main",
                 "ivf_kernel": "ivf"}
HEADLINE = {"scan_kernel": ("float32", 64, 10),
            "scan_kernel_bigk": ("float32", 1, 100)}
LIBRARIES = ("flat_topk", "ivf_topk")
# the IVF yardstick: no single torch call computes the probe, so it is a
# composition, timed beside the kernel and never called by the port
IVF_YARDSTICK = "index_select + bmm + topk (composition)"
# the kernels a call launches once, for profile_device: a flat call's
# scoring kernel (and for k <= 32 its merge), an IVF probe's two kernels
EXPECT_IVF = ("ivf_scan_kernel", "merge_small_k")
# device_ms: traces of one call taken at most, and how far (a share of
# their median) the three that are believed may lie apart
TRACES_MAX = 6
TRACE_MARGIN = 0.15


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
             timed: bool = False) -> dict:
    """The IVF kernel against its plain version on these inputs; with
    ``timed``, kernel, plain and yardstick times and the bound."""
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
                   tries: int = 3
                   ) -> tuple[float, dict[str, float], dict[str, int], bool]:
    """torch.profiler over ``reps`` calls of fn after one warm call:
    the window's milliseconds a call (host clock, ending in a
    synchronize), device milliseconds a call by event name (events that
    ran on the device: kernels and copies), the events seen of each name,
    and whether the trace is whole: each kernel named (in part) in
    ``expect``, which fn launches once a call, seen ``reps`` times. The
    profiler drops events now and then; a trace that is not whole is
    taken again, up to ``tries`` times in all."""
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


def device_ms(fn, reps: int, expect: tuple[str, ...],
              floor_ms: float = 0.0) -> dict:
    """The device time of one call of a kernel wrapper: the sum of the
    kernels it ran, from torch.profiler (CUDA events around back-to-back
    calls time the host once the device part is shorter than the
    wrapper's host time). ``expect``: the kernels it launches once a
    call; each counts at its mean launch, since the profiler drops a
    launch now and then (a trace that saw fewer than half of them is
    refused). It also reads a trace at about half its time now and then,
    so one trace is not believed alone: traces are taken, at most
    ``TRACES_MAX``, until three agree within ``TRACE_MARGIN`` of their
    median, and that median is the result (with several such triples,
    the slowest). A trace below ``floor_ms`` (the call's bound: no card
    does the work in less) is refused. With no three agreeing it is "not
    measured". Every trace's sum is given (``device_ms_traces``)."""
    sums, kept, seen = [], [], {}
    agree = None
    for _ in range(TRACES_MAX):
        _, by_name, counts, _ = profile_device(fn, reps, expect, tries=1)
        seen = launches_seen(counts, expect)
        if not by_name or any(2 * n < reps for n in seen.values()):
            continue
        per_call = {name: ms * reps / min(counts[name], reps)
                    if any(e in name for e in expect) else ms
                    for name, ms in by_name.items()}
        total = sum(per_call.values())
        sums.append(total)
        if total >= floor_ms:
            kept.append((total, per_call))
            agree = agreeing(kept)
            if agree:
                break
    if not agree:
        return {"device_ms": "not measured (no three traces agree)",
                "device_ms_traces": sums, "launches_seen": seen,
                "reps": reps}
    merges = [merge_kernels(t) for _, t in agree]
    return {"device_ms": agree[1][0], "device_ms_traces": sums,
            "device_ms_by_kernel": top_kernels(agree[1][1]),
            "merge_small_k_ran": all(m[0] for m in merges),
            "merge_topk_kernel_ran": any(m[1] for m in merges)}


def agreeing(traces: list[tuple[float, dict]]) -> list | None:
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
                 expect: tuple[str, ...]) -> dict:
    """torch.profiler over ``reps`` batch_query calls: device time by
    kernel (events that ran on the device: kernels and copies) and the
    device's busy share of the window. The profiler slows the host, so the
    share is a lower bound of the unprofiled one. ``expect``: the kernels
    a call launches once (``profile_device``); ``kernel_device_ms`` is
    their time alone. For k <= 32 every merge must be merge_small_k."""
    window_ms, by_name, _, whole = profile_device(
        lambda: store.batch_query(queries, k=k), reps, expect)
    busy_ms = sum(by_name.values())
    out = {"Q": len(queries), "k": k, "reps": reps,
           "window_ms_per_call": window_ms}
    small, old = merge_kernels(by_name)
    if k <= 32:
        check(not old and (small or not whole), f"a k <= 32 call at "
              f"Q={len(queries)} did not merge with merge_small_k alone "
              f"({sorted(by_name)})")
    if not whole:
        out["device_ms_per_call"] = "not measured (the profiler missed " \
            "events)"
        return out
    out.update(device_ms_per_call=busy_ms,
               device_busy_share=busy_ms / window_ms,
               kernel_device_ms=sum(ms for name, ms in by_name.items()
                                    if any(e in name for e in expect)),
               device_ms_by_kernel=top_kernels(by_name))
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
# each row its centre plus 1.0 N(0, I); the cosine store normalizes them
GRAPH_N, GRAPH_ADDS, GRAPH_CENTRES = 300_000, 3, 300
GRAPH_QUERIES, GRAPH_EXTRA = 1000, 10_000


def spread_rows(g, centres, n: int):
    import torch
    pick = torch.randint(0, centres.shape[0], (n,), generator=g,
                         device="cuda")
    return centres[pick] + torch.randn((n, centres.shape[1]), generator=g,
                                       device="cuda")


def graph_routed(fn):
    """Run fn; no flat-scan kernel may launch in it (the store's
    ANN->exact fallback would hide a failing graph search)."""
    from tpu_vector_db_torch.ops.launches import LAUNCHES
    before = {name: LAUNCHES[name] for name in FLAT_SCANS}
    out = fn()
    launched = {name: LAUNCHES[name] - before[name] for name in FLAT_SCANS}
    check(not any(launched.values()), f"a graph-routed call launched "
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


def graph_profiled(store, queries: np.ndarray, k: int, reps: int) -> dict:
    """torch.profiler over ``reps`` graph-routed batch_query calls: the
    window, the device's time by op and its busy share (the profiler
    slows the host, so the share is a lower bound)."""
    window_ms, by_name, _, _ = graph_routed(lambda: profile_device(
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
        res += graph_routed(lambda: store.batch_query(qs[i:i + 64], k=k))
    db = store._db[:n, :store.config.dimension]
    (gt_vals, _), keys = exact_topk(db, qs, k, "cosine")
    return tie_aware_recall(res, keys, gt_vals, k)


def path_graph(g, seed: int, tmp: Path, counts: dict, errs: dict) -> dict:
    """300K x 768 f32 cosine in the JAX package's graph regime with
    enable_ann=True, index_type="beam_graph" and the graph's defaults:
    added in 3 x 100K (a build, then two incremental extends), rebuilt by
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
            r = graph_routed(lambda: timed_queries(store, qs[:q_n], 10,
                                                   reps))
            out[f"b{q_n}"] = r
            emit({"phase": "graph", "case": f"768D graph top-10 b{q_n}",
                  **r})
            r = graph_profiled(store, qs[:q_n], 10, 5)
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
        res = graph_routed(lambda: store.batch_query(extra[:100], k=1))
        found = sum(r[0][0] == n + i for i, r in enumerate(res))
        check(found == 100, f"{100 - found} of 100 added rows did not "
              "return themselves first")
        emit({"phase": "graph", "case": f"incremental add {GRAPH_EXTRA}",
              "seconds": inc_s, "self_first": found, "nodes": ann.size})

        # a filter keeping 10% goes through the graph (post-filtered
        # oversample); one keeping 1% goes to the exact scan
        res = graph_routed(lambda: store.batch_query(
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
        res = graph_routed(lambda: store.batch_query(qs[:64], k=10))
        back = set(dead.tolist()) & {i for r in res for i in r[0]}
        check(not back and all(len(r[0]) == 10 for r in res),
              f"deleted ids came back: {sorted(back)[:5]}")
        emit({"phase": "graph", "case": "delete 1%", "deleted": len(dead),
              "returned_deleted": 0})

        # flush and reopen: the graph loads from ann_graph.npz, no build
        before = graph_routed(lambda: store.batch_query(qs[:64], k=10))
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
        after = graph_routed(lambda: reopened.batch_query(qs[:64], k=10))
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

SERVE_PARTS = 8                 # /v1/batch/upload calls of N / 8 rows each
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
        got = graph_routed(lambda: sdk.batch_query_vectors(
            **graph, queries=rows[:8], k=10))
        own = graph_routed(lambda: manager.get_store(
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
    """The port's REST server at 1M x 768 f32 cosine: the store made with
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
    rows = unit_rows(g, N, d)
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
                "expected_rows": N}), "create_store", 201)
            part = N // SERVE_PARTS
            t0 = time.perf_counter()
            part_s = []
            for start in range(0, N, part):
                t1 = time.perf_counter()
                upload_part(client, who,
                            rows[start:start + part].cpu().numpy(), start)
                part_s.append(time.perf_counter() - t1)
            upload_s = time.perf_counter() - t0
            count = ok(client.get("/vectors/count", params=who),
                       "count")["count"]
            check(count == N, f"/vectors/count is {count}")
            emit({"phase": "serve", "case": f"upload {N}x{d} f32",
                  "parts": SERVE_PARTS, "seconds": upload_s,
                  "rows_per_s": N / upload_s, "part_seconds": part_s})
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
            check(out["total"] == N + 1024, f"add: total {out['total']}")
            for j in (0, 511, 1023):
                top = ok(client.post("/vectors/query", json={
                    **who, "query": new[j].tolist(), "k": 1}),
                    "self-query")["results"][0]
                check(top["index"] == N + j and top["similarity"] > 0.999,
                      f"self-query of added row {N + j} returned {top}")
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



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
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
    card = card_line()
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    tmp = REPO / "_smoke_tmp"
    counts: dict[str, dict] = {}
    try:
        phase_build()
        headline, errs = phase_kernels(768, args.seed)
        errs["ivf_kernel"] = phase_ivf_kernels(args.seed)
        phase_merge(args.seed)
        shutil.rmtree(tmp, ignore_errors=True)
        g = torch.Generator(device="cuda").manual_seed(args.seed + 1)
        path_main(g, args.seed, tmp, counts, errs)
        path_config2(g, tmp, counts, errs)
        path_config4(g, args.seed, tmp, counts, errs)
        path_config1(g, args.seed, tmp, counts, errs)
        headline["ivf_kernel"] = path_ivf(g, tmp, counts, errs)
        path_ivf_small(g, tmp, counts, errs)
        path_graph(g, args.seed, tmp, counts, errs)
        path_graph_native(g, tmp, counts, errs)
        path_serve(g, args.seed, tmp, counts, errs)
        kernels = [{"name": name, "route": "cuda", "source": SOURCE[name],
                    "replaces": REPLACES[name],
                    "launches": counts[HEADLINE_PATH[name]][name],
                    "launches_path": HEADLINE_PATH[name],
                    "max_abs_err": errs[name], **headline[name]}
                   for name in ("scan_kernel", "scan_kernel_bigk",
                                "ivf_kernel")]
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
