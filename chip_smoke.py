#!/usr/bin/env python3
"""Drive tpu_vector_db_torch's main path on one NVIDIA H100.

Run from the root of the repository: ``python3 chip_smoke.py``. It

1. prints the card (``nvidia-smi``), the torch and CUDA versions, and
   builds the kernels of ``tpu_vector_db_torch/csrc`` with nvcc;
2. holds each flat-scan kernel against its plain torch version on the
   card at 1M x 768 rows (f32, bf16, int8, int4; batch 1 and 64; a
   filtered case, a case with count < N, a euclidean case) and times the
   kernel, the plain version and ``torch.matmul`` + ``torch.topk`` (a
   yardstick only: the port never calls it);
3. drives the exact flat store through ``create_vector_store(...,
   device="cuda")`` on four paths, each with the launch counts set to 0
   just before it and read just after: the main path, 1M x 768 f32 cosine
   with metadata (batch 1 and 64, top-100, filter, delete, self-query,
   recall@10 against an exact ground truth); BASELINE config #2, 1M x 128
   euclidean top-100 at batch 64; config #4, 1M x 1536 bf16 (batch 1 and
   64, rerank); config #1, a flush + reopen at 100K x 384. After each path
   the kernels are held against their plain version once more on that
   store's own rows, masks, batch sizes and k;
4. prints one JSON line of the kernels (launches from the main path), the
   card's name and power limit, and last ``{"ok": true, "device": {...}}``.

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
SOURCE = "tpu_vector_db_torch/csrc/flat_topk.cu"
REPLACES = {"scan_kernel": "tpu_vector_db/ops/pallas_scan.py:112",
            "scan_kernel_bigk": "tpu_vector_db/ops/pallas_scan.py:259"}
# the kernel case each kernel's timings in the kernels line come from: the
# shape the main path gives it (top-10 at batch 64, top-100 at batch 1)
HEADLINE = {"scan_kernel": ("float32", 64, 10),
            "scan_kernel_bigk": ("float32", 1, 100)}


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

def phase_build() -> None:
    from tpu_vector_db_torch.ops import _build
    t0 = time.perf_counter()
    path, log = _build.build("flat_topk", extra_flags=("-Xptxas", "-v"))
    seconds = time.perf_counter() - t0
    # the compiler's per-kernel report, beside the library it describes
    path.with_suffix(".ptxas.txt").write_text(log)
    regs = [int(w) for line in log.splitlines() if "registers" in line
            for w, nxt in zip(line.split(), line.split()[1:])
            if nxt.startswith("registers")]
    spills = [m for m in re.finditer(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
        if int(m.group(1)) or int(m.group(2))]
    info = {"phase": "build", "library": str(path.relative_to(REPO)),
            "seconds": seconds, "max_registers": max(regs, default=None),
            "kernels_with_spills": len(spills)}
    emit(info)


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
    queries = torch.randn((64, d), generator=g, device=dev)
    queries /= torch.linalg.vector_norm(queries, dim=1, keepdim=True)

    cases = []
    for k in (10, 100):
        for dtype in ("float32", "bfloat16", "int8", "int4"):
            for q_n in (1, 64):
                cases.append((dtype, q_n, k, "cosine", None, n))
        cases.append(("float32", 64, k, "cosine", "filtered", n))
        cases.append(("float32", 64, k, "cosine", None, n - 12345))
        cases.append(("float32", 64, k, "euclidean", None, n))

    headline: dict[str, dict] = {}
    errs: dict[str, float] = {}
    for dtype, q_n, k, metric, flt, count in cases:
        db, scl = dbs[dtype]
        q = queries[:q_n]
        sq = sqn if metric == "euclidean" else None
        fm = mask if flt else None
        name = cuda_scan.kernel_name(k)
        kwargs = dict(metric=metric, db_sqnorms=sq, filter_mask=fm,
                      db_scales=scl)
        before = cuda_scan.LAUNCHES[name]
        keys, ids = cuda_scan.flat_topk(q, db, count, k, **kwargs)
        torch.cuda.synchronize()
        launches = cuda_scan.LAUNCHES[name] - before
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
        line = {"phase": "kernel", "kernel": name, "dtype": dtype,
                "metric": metric, "filtered": bool(flt), "Q": q_n, "k": k,
                "N": n, "count": count, "d": d,
                "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "max_abs_err": err, "key_tol": KEY_TOL,
                "ids_ok": ids_ok, "launches": launches}
        emit(line)
        check(launches == 1, f"{name} launched {launches} times in one call")
        check(keys_ok, f"{name} {dtype} Q={q_n} k={k}: key error {err}")
        check(ids_ok, f"{name} {dtype} Q={q_n} k={k}: ids differ")
        errs[name] = max(errs.get(name, 0.0), err)
        if (dtype, q_n, k) == HEADLINE[name] and metric == "cosine" \
                and flt is None and count == n:
            headline[name] = dict(ms=kernel_ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by,
                                  library_ms=library_ms)
    del dbs, dense, x, packed, scales, sqn, mask
    gc.collect()
    torch.cuda.empty_cache()
    return headline, errs


# --------------------------------------------------------------- phase 3

@contextlib.contextmanager
def counting(path: str, expect: tuple[str, ...], counts: dict):
    """Launch counts set to 0 just before a path and read just after;
    every kernel in ``expect`` must have launched in it."""
    import torch
    from tpu_vector_db_torch.ops import cuda_scan
    cuda_scan.reset_launch_counts()
    yield
    torch.cuda.synchronize()
    counts[path] = dict(cuda_scan.LAUNCHES)
    emit({"phase": "launches", "path": path, **counts[path]})
    for name in expect:
        check(counts[path][name] > 0,
              f"{name} was not launched on path {path}")


def hold_store(store, path: str, queries: np.ndarray, k: int, errs: dict,
               filter_metadata: dict | None = None) -> None:
    """Kernel against plain version on the store's own scan inputs (rows,
    sqnorms, scales, live or filter mask) at this path's batch and k."""
    from tpu_vector_db_torch.ops import cuda_scan
    args = store._scan_inputs(queries, store._query_mask(filter_metadata))
    keys, ids = cuda_scan.flat_topk(k=k, **args)
    pkeys, pids = cuda_scan.flat_topk_plain(k=k, **args)
    err, keys_ok, ids_ok = compare(keys, ids, pkeys, pids, store.metric)
    name = cuda_scan.kernel_name(k)
    emit({"phase": "hold", "path": path, "kernel": name,
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


def device_share(store, queries: np.ndarray, k: int, reps: int) -> dict:
    """torch.profiler over ``reps`` batch_query calls: device time by
    kernel (events that ran on the device: kernels and copies) and the
    device's busy share of the window. The profiler slows the host, so the
    share is a lower bound of the unprofiled one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    store.batch_query(queries, k=k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            store.batch_query(queries, k=k)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.key[:60]] = evt.self_device_time_total / reps / 1e3
    busy_ms = sum(by_name.values())
    out = {"Q": len(queries), "k": k, "reps": reps,
           "window_ms_per_call": window_us / reps / 1e3}
    if busy_ms == 0:
        out["device_ms_per_call"] = "not measured (no device events)"
        return out
    out.update(device_ms_per_call=busy_ms,
               device_busy_share=busy_ms / (window_us / reps / 1e3),
               device_ms_by_kernel=dict(sorted(
                   by_name.items(), key=lambda kv: -kv[1])[:6]))
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


def counted(fn, expect: str):
    """Run fn and require that kernel ``expect`` was launched by it."""
    from tpu_vector_db_torch.ops import cuda_scan
    before = cuda_scan.LAUNCHES[expect]
    out = fn()
    check(cuda_scan.LAUNCHES[expect] > before,
          f"{expect} was not launched by this case")
    return out


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
        for q_n, reps in ((1, 20), (64, 5)):
            r = counted(lambda: device_share(store, qs[:q_n], 10, reps),
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
                        (1, 10, {"cat": 3})):
        hold_store(store, "main", qs[:q_n], k, errs, flt)
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
    for q_n, k in ((1, 10), (64, 10), (1, 40)):
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
        shutil.rmtree(tmp, ignore_errors=True)
        g = torch.Generator(device="cuda").manual_seed(args.seed + 1)
        path_main(g, args.seed, tmp, counts, errs)
        path_config2(g, tmp, counts, errs)
        path_config4(g, args.seed, tmp, counts, errs)
        path_config1(g, args.seed, tmp, counts, errs)
        kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                    "replaces": REPLACES[name],
                    "launches": counts["main"][name],
                    "max_abs_err": errs[name], **headline[name]}
                   for name in ("scan_kernel", "scan_kernel_bigk")]
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
