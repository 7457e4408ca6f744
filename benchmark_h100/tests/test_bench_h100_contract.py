"""BENCHMARK.json keeps to the benchmark's contract, and every file it
names is there."""

import json
import re
from pathlib import Path

from benchmark_h100 import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(text, most=200):
    return 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for word in BENCH["command"]:
        assert one_line(word) and not word.startswith("/")
        assert ".." not in word
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p)
        assert not p.endswith("_torch")


def test_configs_cells_and_metrics():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"]
    cells = BENCH["workloads"]
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert one_line(w["why"])
        assert (ROOT / "benchmark_h100" / "traffic"
                / f"{w['traffic']}.json").is_file()
    used = {w["config"] for w in cells}
    assert used == set(configs)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert one_line(m["layer"])
        layers.add(m["layer"])
        assert (ROOT / "benchmark_h100" / "metrics"
                / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        for c in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or c in moved["workloads"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in cells:
        got = [m["name"] for m in run.metrics_of(BENCH, "end_to_end",
                                                 w["name"])]
        assert "setup_s" in got and len(got) >= 2
        assert run.metrics_of(BENCH, "per_layer", w["name"])


def test_each_metric_reader_loads():
    for m in BENCH["per_layer"]:
        assert run.reader(m["name"])({}) is None
