#!/usr/bin/env python3
"""Run one cell of the port's H100 benchmark once.

    python3 benchmark_h100/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout. The cell names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``) in
``BENCHMARK.json``; the mix names its generator (``traffic/<gen>.py``),
and per-layer metrics are read by ``metrics/<name>.py``. A run makes
its rows and query pool on the card from ``--seed``, builds the store,
warms the cell's shapes, lets the generator drive the window for
``--seconds``, compares every answer it judges with the plain
reference, and prints one JSON line as the last line of standard
output. ``--trace 1`` reports the per-layer metrics instead of
the end-to-end ones, from a torch.profiler slice of the window and the
program's counters. Without CUDA, or with fewer cards than the cell
asks for, or with JAX or the JAX package loaded, it prints no result and
exits with a code other than 0.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the checkout's root, not this folder, leads the path: the harness's
# modules go by their package name and shadow nothing
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from benchmark_h100.window import log  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_vector_db")


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_files(bench: dict, name: str, root: Path = ROOT):
    """(cell, configuration, traffic) of the cell ``name``."""
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "benchmark_h100" / "traffic" / f"{cell['traffic']}.json"
         ).read_text())
    return cell, config, traffic


def generator(traffic: dict, root: Path = ROOT):
    """The traffic file's generator, ``traffic/<generator>.py``. A file
    with a key its generator does not read, or without one it does, or
    with a value of the wrong type, is refused."""
    name = traffic.get("generator")
    path = root / "benchmark_h100" / "traffic" / f"{name}.py"
    if not isinstance(name, str) or not re.fullmatch(r"[A-Za-z0-9_]+", name) \
            or not path.is_file():
        raise ValueError(f"traffic names no generator in traffic/: {name!r}")
    spec = importlib.util.spec_from_file_location(
        "bench_traffic_" + name, path)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    keys = set(traffic) - {"generator"}
    if keys != set(gen.KEYS):
        raise ValueError(
            f"traffic for {name}: unread keys {sorted(keys - set(gen.KEYS))}"
            f", missing keys {sorted(set(gen.KEYS) - keys)}")
    for key, kind in gen.KEYS.items():
        ok = (int, float) if kind is float else (kind,)
        if not isinstance(traffic[key], ok) or isinstance(traffic[key], bool):
            raise ValueError(f"traffic for {name}: {key} is not {kind}")
    return gen


def metrics_of(bench: dict, kind: str, cell: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str, root: Path = ROOT):
    """``metrics/<name>.py``'s ``read``."""
    path = root / "benchmark_h100" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def percentile(values, p: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), p))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


class Tracer:
    """The traced run's instruments, all in the benchmark's own files: a
    span around ``TorchVectorStore.batch_query``, the shapes of the
    kernel launches (wrapping the store's ``flat_topk`` and the index's
    ``ivf_probe_topk``), the launch counts, and a torch.profiler slice
    (``devtrace.Profiled``)."""

    def __init__(self, store, device: str) -> None:
        import torch
        from benchmark_h100 import devtrace
        from tpu_vector_db_torch.index import ivf
        from tpu_vector_db_torch.store import vector_store
        # the row types' names in yardstick.PEAK_OPS (int4 rows are
        # packed two to a uint8)
        ROW_TYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                     torch.int8: "int8", torch.uint8: "int4"}
        self.cuda = device == "cuda"
        self.store_calls: list[float] = []
        self.flat: list[tuple] = []
        self.ivf: list[tuple] = []
        self.recording = False
        self.prof = devtrace.Profiled()
        if self.cuda:
            self.prof.warm()
        self._undo = []
        orig_bq = store.batch_query

        def batch_query(*a, **kw):
            t0 = time.perf_counter()
            with torch.profiler.record_function(devtrace.SPANS[0]):
                out = orig_bq(*a, **kw)
            self.store_calls.append(time.perf_counter() - t0)
            return out
        store.batch_query = batch_query
        self._undo.append(lambda: delattr(store, "batch_query"))

        orig_flat = vector_store.flat_topk

        def flat_topk(queries, db, count, k, metric="cosine",
                      db_sqnorms=None, filter_mask=None, db_scales=None):
            if self.recording:
                self.flat.append((int(queries.shape[0]), int(count),
                                  int(queries.shape[1]), int(k),
                                  ROW_TYPES[db.dtype],
                                  int(db.shape[1] * db.element_size()),
                                  filter_mask is not None,
                                  db_sqnorms is not None))
            return orig_flat(queries, db, count, k, metric, db_sqnorms,
                             filter_mask, db_scales)
        vector_store.flat_topk = flat_topk
        self._undo.append(lambda: setattr(vector_store, "flat_topk",
                                          orig_flat))

        orig_ivf = ivf.ivf_probe_topk

        def ivf_probe_topk(queries, db_buckets, bucket_ids, bucket_fills,
                           sel, k, metric="cosine", bucket_sqnorms=None):
            if self.recording:
                self.ivf.append((bucket_fills, sel, int(k),
                                 int(db_buckets.shape[2]),
                                 ROW_TYPES[db_buckets.dtype],
                                 int(db_buckets.shape[2]
                                     * db_buckets.element_size())))
            return orig_ivf(queries, db_buckets, bucket_ids, bucket_fills,
                            sel, k, metric, bucket_sqnorms)
        ivf.ivf_probe_topk = ivf_probe_topk
        self._undo.append(lambda: setattr(ivf, "ivf_probe_topk", orig_ivf))

    def start_slice(self) -> None:
        from tpu_vector_db_torch.ops.launches import LAUNCHES
        self._launches0 = dict(LAUNCHES)
        if self.cuda:
            self.prof.start()
        self.recording = True

    def stop_slice(self) -> None:
        from tpu_vector_db_torch.ops.launches import LAUNCHES
        self.recording = False
        if self.cuda:
            self.prof.stop()
        self.launches = {k: LAUNCHES[k] - self._launches0.get(k, 0)
                         for k in LAUNCHES}

    def bounds(self) -> dict[str, list[float]]:
        """Each recorded launch's least time (ms), by kernel."""
        from benchmark_h100 import yardstick
        out = {"scan_kernel": [], "scan_kernel_bigk": [], "ivf_kernel": []}
        for q_n, count, d, k, dtype, row_bytes, masked, sq in self.flat:
            side = count * 4 * (int(masked) + int(sq))
            ms, _ = yardstick.bound(count, row_bytes, q_n, d, k, dtype, side)
            out["scan_kernel" if k <= 32 else "scan_kernel_bigk"].append(ms)
        for fills, sel, k, d, dtype, row_bytes in self.ivf:
            ms, _ = yardstick.ivf_bound(fills, sel, row_bytes, d, k, dtype)
            out["ivf_kernel"].append(ms)
        return out

    def close(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo = []


def run_cell(bench: dict, cell: dict, config: dict, traffic: dict,
             seed: int, seconds: float, trace: bool, device: str = "cuda",
             sizes: dict | None = None, t_process: float = T_PROCESS,
             fault=None, root: Path = ROOT) -> dict:
    """One run of a cell; returns the result line's object (and
    ``_check_lines``). ``sizes`` ({"rows", "pool"}), ``device="cpu"``
    and ``fault(store)``, which breaks the program under the window, are
    for the tests; ``root`` is the checkout whose generator and metric
    readers run."""
    gen = generator(traffic, root)
    from benchmark_h100 import server as srv
    os.environ.update(srv.deployment_env(config))
    import torch
    from benchmark_h100 import datagen, reference, verdict
    import tpu_vector_db_torch  # noqa: F401
    t_import = time.monotonic()
    sizes = sizes or {}
    n_rows = int(sizes.get("rows", config["rows"]))
    n_pool = int(sizes.get("pool", config["pool"]))
    dim = int(config["dim"])
    cuda = device == "cuda"
    workdir = Path(tempfile.mkdtemp(prefix="vdb-bench-"))
    try:
        rows = np.empty((n_rows, dim), np.float32)
        for start, blk in datagen.row_blocks(config["data"], n_rows, dim,
                                             seed, device):
            rows[start:start + blk.shape[0]] = blk.cpu().numpy()
        t_rows = time.monotonic()
        pool = datagen.query_pool(config["data"], n_pool, dim, seed,
                                  device).cpu().numpy()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t_data = time.monotonic()
        manager, store = srv.build_store(config, rows, workdir, device)
        del rows
        if cuda:
            torch.cuda.synchronize()
        t_store = time.monotonic()
        k = int(traffic["k"])
        # warm the cell's own batch shapes, as its generator names them
        shapes = gen.warm_shapes(traffic, config)
        for q_n in shapes:
            store.batch_query(pool[:q_n], k=k)
        if fault is not None:
            fault(store)
        tracer = Tracer(store, device) if trace else None
        if cuda:
            torch.cuda.synchronize()
        t_warm = time.monotonic()
        log(f"setup: imports {t_import - t_process:.3f} s, rows "
            f"{t_rows - t_import:.3f} s, pool {t_data - t_rows:.3f} s, "
            f"store {t_store - t_data:.3f} s, warm {t_warm - t_store:.3f} s,"
            f" index "
            f"{store.get_stats()['index_type']}, nprobe "
            f"{store.config.ann_params.get('nprobe', '-')}, warm shapes "
            f"{shapes}")
        win = gen.drive(store=store, manager=manager, config=config,
                        traffic=traffic, pool=pool, seconds=seconds,
                        tracer=tracer, seed=seed)
        setup_s = win.t0 - t_process
        log(f"setup: from warm to the window {win.t0 - t_warm:.3f} s; "
            f"setup_s {setup_s:.3f}")
        memory_peak = (torch.cuda.max_memory_allocated() if cuda else 0)
        bounds = tracer.bounds() if tracer is not None else None
        if tracer is not None:
            tracer.close()
        n_store_rows = store.vector_count
        manager.shutdown()
        del store, manager
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        for note in win.notes:
            log(note)
        answers, lat_ms = win.answers, win.lat_ms
        if not lat_ms:
            raise RuntimeError("no request was sent in the window")

        # the reference, on the rows and pool made again from the seed
        t_ref = time.monotonic()
        ref_rows = datagen.rows(config["data"], n_rows, dim, seed, device)
        ref_pool = datagen.query_pool(config["data"], n_pool, dim, seed,
                                      device)
        ref = reference.Reference(ref_rows, ref_pool)
        try:
            checks, recall = verdict.judge(answers, ref, n_store_rows,
                                           config)
        finally:
            ref.close()
        del ref, ref_rows, ref_pool
        log(f"reference: {len(answers.qidx)} answers judged in "
            f"{time.monotonic() - t_ref:.3f} s")

        e2e = {"search_qps": win.done_ok / seconds,
               "search_p50_ms": percentile(lat_ms, 50),
               "search_p99_ms": percentile(lat_ms, 99),
               "recall_at_10": recall,
               "setup_s": setup_s}
        log(("end-to-end in the traced run: " if trace else "end-to-end: ")
            + json.dumps(e2e))
        wanted = metrics_of(bench, "end_to_end", cell["name"])
        if not trace:
            metrics = {m["name"]: {"value": e2e[m["name"]],
                                   "unit": m["unit"]} for m in wanted}
        else:
            ctx = dict(win.trace or {})
            ctx.update(window_s=seconds, store_calls_s=tracer.store_calls,
                       launches=tracer.launches, bounds_ms=bounds,
                       device=tracer.prof.read() if cuda else None)
            metrics = {}
            for m in metrics_of(bench, "per_layer", cell["name"]):
                value = reader(m["name"], root)(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": (torch.cuda.get_device_name(0) if cuda else "cpu"),
               "count": int(cell["chips"]),
               "memory_peak_bytes": int(memory_peak)}
        result = {"correct": verdict.all_ok(checks),
                  "attempted": win.attempted, "failed": win.failed,
                  "metrics": metrics, "device": dev}
        if trace and ctx.get("device") is not None:
            dev["busy_s"] = ctx["device"]["busy_s"]
            dev["window_s"] = ctx["device"]["window_s"]
            result["breakdown"] = {
                "device_ops": ctx["device"]["device_ops"],
                "idle_gaps": ctx["device"]["idle_gaps"]}
        result["checks"] = {n: {"value": c["value"], "limit": c["limit"]}
                            for n, c in checks.items()}
        result["_check_lines"] = verdict.lines(checks)
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_bench()
    cell, config, traffic = cell_files(bench, args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {card_line()}; peaks: HBM 3.35 TB/s, f32 67 TFLOP/s "
        f"(SXM, 700 W)")
    result = run_cell(bench, cell, config, traffic, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"loaded in this process: {', '.join(found)}; no result")
        return 3
    check_lines = result.pop("_check_lines")
    for line in check_lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
