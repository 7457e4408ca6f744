"""The harness end to end at a tiny size on the CPU store, for every
cell's traffic; the faults it must see; what a run may load."""

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from benchmark_h100 import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = run.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
C64 = "flat768.rest-c64-k10"
TINY = {"rows": 3000, "pool": 256}
SEED = 2**31 + 4242


def run_tiny(name, trace=False, fault=None, seconds=1.0, root=ROOT,
             bench=BENCH):
    cell, config, traffic = run.cell_files(bench, name, root)
    return run.run_cell(bench, cell, config, traffic, SEED, seconds, trace,
                        device="cpu", sizes=TINY,
                        t_process=time.monotonic(), fault=fault, root=root)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_runs_and_is_correct(name):
    res = run_tiny(name)
    lines = res.pop("_check_lines")
    assert res["correct"], lines
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in run.metrics_of(BENCH, "end_to_end",
                                              name)}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert m["value"] > 0
    json.dumps(res)
    assert run.forbidden_modules() == []


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_per_layer_metrics(name):
    res = run_tiny(name, trace=True)
    res.pop("_check_lines")
    assert res["correct"]
    allowed = {m["name"] for m in run.metrics_of(BENCH, "per_layer",
                                                 name)}
    # on the CPU nothing reads the device: its metrics stay out
    want = {m for m in allowed if not m.startswith(("device.", "scan_",
                                                    "ivf_"))}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert m["value"] > 0
    if name == C64:
        assert res["metrics"]["coalescer.queries_per_flush"]["value"] >= 1


def alter_an_answer(store):
    """An answer altered where it is produced: the scan returns another
    row's id in one slot."""
    orig = store._exact_topk

    def bad(**kw):
        keys, ids = orig(**kw)
        ids = ids.clone()
        ids[0, 1] = (ids[0, 1] + 7) % kw["count"]
        return keys, ids
    store._exact_topk = bad


def drop_half_the_batch(store):
    """Half of the batch left out: the second half of every call comes
    back empty."""
    orig = store.batch_query

    def bad(qs, *a, **kw):
        out = orig(qs, *a, **kw)
        half = (len(out) + 1) // 2
        return out[:half] + [([], [], []) for _ in out[half:]]
    store.batch_query = bad


@pytest.mark.parametrize("fault", [alter_an_answer, drop_half_the_batch])
@pytest.mark.parametrize("name", ["flat768.lib-b64-k100", C64])
def test_a_broken_timed_path_is_not_correct(name, fault):
    res = run_tiny(name, fault=fault)
    assert res["correct"] is False, res["checks"]


def test_an_altered_ivf_answer_is_not_correct():
    def alter(store):
        orig = store._ann_search

        def bad(q, k):
            ids, keys = orig(q, k)
            ids = ids.copy()
            ids[:, 0] = (ids[:, 0] + 11) % store._count
            return ids, keys
        store._ann_search = bad
    res = run_tiny("ivf768.rest-serial-k10", fault=alter)
    assert res["correct"] is False


def test_every_traffic_file_names_a_generator_that_reads_all_its_keys():
    for w in BENCH["workloads"]:
        _, _, traffic = run.cell_files(BENCH, w["name"])
        gen = run.generator(traffic)
        assert set(traffic) == {"generator"} | set(gen.KEYS)


@pytest.mark.parametrize("change, words", [
    ({"loop": "open"}, "unread keys ['loop']"),
    ({"clients": None}, "clients is not"),
    ({"generator": "rest_open"}, "no generator"),
    ({"generator": "../run"}, "no generator"),
])
def test_a_traffic_file_its_generator_cannot_read_is_refused(change, words):
    _, _, traffic = run.cell_files(BENCH, C64)
    traffic.update(change)
    if change.get("clients", 0) is None:
        traffic["clients"] = "64"
    with pytest.raises(ValueError, match=re.escape(words)):
        run.generator(traffic)


def test_a_missing_traffic_key_is_refused():
    _, _, traffic = run.cell_files(BENCH, "flat768.lib-b64-k100")
    del traffic["judge_share"]
    with pytest.raises(ValueError, match="missing keys"):
        run.generator(traffic)


def test_without_cuda_no_result_and_a_failing_exit():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "benchmark_h100" / "run.py"),
         "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in BENCH["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark_h100/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_vector_db_torch_x", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]


def test_the_client_process_imports_no_torch():
    code = ("import runpy, sys; sys.argv=['client.py']; "
            "import benchmark_h100.client as c; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'tpu_vector_db', 'tpu_vector_db_torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr
