"""A later change adds a configuration, a traffic mix, a traffic
generator and a per-layer metric as new files only: the harness finds
each by its name in BENCHMARK.json or in the traffic file, and no file
the benchmark has is edited."""

import hashlib
import json
import shutil
import time
from pathlib import Path

from benchmark_h100 import run

ROOT = Path(__file__).resolve().parents[2]


def digests(root: Path) -> dict[str, str]:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()
                                                      ).hexdigest()
            for p in sorted((root / "benchmark_h100").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_only(tmp_path):
    shutil.copytree(ROOT / "benchmark_h100", tmp_path / "benchmark_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = digests(tmp_path)
    b = tmp_path / "benchmark_h100"
    conf = json.loads((b / "configs" / "cohere768-1m-flat.json").read_text())
    conf.update(name="cohere384-small-flat", dim=384)
    (b / "configs" / "cohere384-small-flat.json").write_text(json.dumps(conf))
    (b / "traffic" / "rest-c8-k5.json").write_text(json.dumps(
        {"generator": "rest_closed", "clients": 8, "client_processes": 1,
         "k": 5, "lead_s": 0.2, "timeout_s": 30}))
    # a generator of its own: the library loop with its calls counted
    gen = (b / "traffic" / "lib_closed.py").read_text().replace(
        '"judge_share": float}', '"judge_share": float, "label": str}')
    (b / "traffic" / "lib_labelled.py").write_text(gen)
    (b / "traffic" / "lib-b8-k5.json").write_text(json.dumps(
        {"generator": "lib_labelled", "batch": 8, "k": 5, "lead_s": 0.2,
         "warm_calls": 1, "judge_share": 0.5, "label": "a test"}))
    (b / "metrics" / "api.requests_per_s.py").write_text(
        "def read(t):\n"
        "    http = t.get('http')\n"
        "    return http['count'] / t['window_s'] if http else None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "cohere384-small-flat", "source": "a test",
        "file": "benchmark_h100/configs/cohere384-small-flat.json",
        "reduced": [], "why": "a test"})
    bench["workloads"].append({
        "name": "flat384.rest-c8-k5", "config": "cohere384-small-flat",
        "traffic": "rest-c8-k5", "chips": 1, "why": "a test"})
    bench["workloads"].append({
        "name": "flat384.lib-b8-k5", "config": "cohere384-small-flat",
        "traffic": "lib-b8-k5", "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "api.requests_per_s", "unit": "requests/s",
        "better": "higher", "source": "program_counter",
        "layer": "api (aiohttp app, middleware, routes)",
        "moves": "search_qps", "workloads": ["flat384.rest-c8-k5"]})
    for m in bench["end_to_end"]:
        if m["name"] == "search_qps":
            m["workloads"].append("flat384.rest-c8-k5")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell, config, traffic = run.cell_files(bench, "flat384.rest-c8-k5",
                                           tmp_path)
    assert config["dim"] == 384 and traffic["clients"] == 8
    res = run.run_cell(bench, cell, config, traffic, 77, 1.0, True,
                       device="cpu", sizes={"rows": 2000, "pool": 64},
                       t_process=time.monotonic(), root=tmp_path)
    assert res["correct"]
    assert res["metrics"]["api.requests_per_s"]["value"] > 0
    cell, config, traffic = run.cell_files(bench, "flat384.lib-b8-k5",
                                           tmp_path)
    res = run.run_cell(bench, cell, config, traffic, 78, 1.0, False,
                       device="cpu", sizes={"rows": 2000, "pool": 64},
                       t_process=time.monotonic(), root=tmp_path)
    assert res["correct"] and res["attempted"] > 0
    assert set(res["metrics"]) == {"setup_s"}
    after = digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
