"""On the card: the control fails at a size a test can hold, and every
cell's path runs correct there at a small size. Each test decides
inside itself whether there is a card."""

import json
import time
from pathlib import Path

import pytest

from benchmark_h100 import control, run

ROOT = Path(__file__).resolve().parents[2]
BENCH = run.load_bench()


def need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_the_tf32_control_is_not_correct_on_the_card(name):
    need_card()
    _, config, traffic = run.cell_files(BENCH, name)
    out = control.control_checks(config, int(traffic["k"]), 5, "cuda",
                                 run.generator(traffic).REST,
                                 rows_n=262144, pool_n=2000)
    assert out["correct"] is False, out


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_correct_on_the_card_at_a_small_size(name, trace):
    need_card()
    cell, config, traffic = run.cell_files(BENCH, name)
    res = run.run_cell(BENCH, cell, config, traffic, 2**31 + 77, 2.0,
                       trace, device="cuda",
                       sizes={"rows": 262144, "pool": 2000},
                       t_process=time.monotonic())
    lines = res.pop("_check_lines")
    assert res["correct"], lines
    if trace:
        assert res["device"]["busy_s"] > 0
        for m, v in res["metrics"].items():
            if m.endswith("_roofline"):
                assert 0 < v["value"] <= 105, (m, v)
    json.dumps(res)
