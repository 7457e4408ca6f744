#!/usr/bin/env python3
"""The control of ``correct``: the reference put in the program's place,
one precision below the configuration's float32 (TF32 products).

    python3 benchmark_h100/control.py --workload flat768.rest-c64-k10 \\
        --seeds 11 12 13

makes each seed's rows and pool as a run of the cell does (at its
configuration's size), answers every pool query at the cell's k with
TF32 products, rounds the similarities to the 6 decimals a REST answer
carries (a library answer keeps them whole), and prints the
numbers ``verdict.judge`` compares, each beside its limit, one JSON line
a seed. Every line must read ``correct`` false. The benchmark's own runs
never run it; ``tests/test_bench_h100_gpu.py`` runs it at a smaller size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)


def control_checks(config: dict, k: int, seed: int, device: str,
                   rest: bool, rows_n: int | None = None,
                   pool_n: int | None = None) -> dict:
    """The control's compared numbers for one seed."""
    import torch
    from benchmark_h100 import datagen, reference, verdict
    n = rows_n or int(config["rows"])
    p = pool_n or int(config["pool"])
    rows = datagen.rows(config["data"], n, int(config["dim"]), seed, device)
    pool = datagen.query_pool(config["data"], p, int(config["dim"]), seed,
                              device)
    ref = reference.Reference(rows, pool)
    try:
        keys, ids = ref.top(k, tf32=True)
        answers = verdict.Answers(k)
        for q in range(p):
            answers.add(q, ids[q].tolist(),
                        [round(float(x), 6) if rest else float(x)
                         for x in keys[q]])
        checks, recall = verdict.judge(answers, ref, n, config)
    finally:
        ref.close()
    del rows, pool, ref
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"seed": seed, "correct": verdict.all_ok(checks),
            "recall": recall,
            "checks": {name: {"value": c["value"], "limit": c["limit"]}
                       for name, c in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from benchmark_h100 import run
    _, config, traffic = run.cell_files(run.load_bench(), args.workload)
    k, rest = int(traffic["k"]), run.generator(traffic).REST
    for seed in args.seeds:
        t0 = time.monotonic()
        out = control_checks(config, k, seed, "cuda", rest)
        out.update(workload=args.workload, seconds=time.monotonic() - t0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
