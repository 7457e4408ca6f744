"""The reference's exact top-k, its tie-aware recall, and the comparison
that decides ``correct``, with its control one precision below."""

import json
from pathlib import Path

import numpy as np
import torch

from benchmark_h100 import datagen, reference, verdict

ROOT = Path(__file__).resolve().parents[2]
FLAT = json.loads((ROOT / "benchmark_h100" / "configs" /
                   "cohere768-1m-flat.json").read_text())
IVF = json.loads((ROOT / "benchmark_h100" / "configs" /
                  "cohere768-1m-ivf.json").read_text())
N, D, P, K = 5000, 768, 120, 10


def data(seed=3):
    rows = datagen.rows(FLAT["data"], N, D, seed, "cpu")
    pool = datagen.query_pool(FLAT["data"], P, D, seed, "cpu")
    return rows, pool


def brute(rows, pool, k):
    r = rows.double() / torch.linalg.vector_norm(rows.double(), dim=1,
                                                 keepdim=True)
    q = pool.double() / torch.linalg.vector_norm(pool.double(), dim=1,
                                                 keepdim=True)
    keys = q @ r.T
    vals, ids = torch.sort(keys, dim=1, descending=True, stable=True)
    return vals[:, :k].numpy(), ids[:, :k].numpy()


def answers_from(ids, sims, k=K, qidx=None):
    a = verdict.Answers(k)
    for i, (row_ids, row_sims) in enumerate(zip(ids, sims)):
        a.add(i if qidx is None else qidx[i], list(row_ids),
              [round(float(s), 6) for s in row_sims])
    return a


def test_exact_topk_matches_brute_force_in_float64():
    rows, pool = data()
    ref = reference.Reference(rows, pool)
    keys, ids = ref.top(K)
    bk, bi = brute(rows, pool, K)
    assert np.array_equal(ids, bi)
    assert np.abs(keys - bk).max() < 1e-12
    sub_keys, sub_ids = ref.top(K, queries=np.array([7, 3]))
    assert np.array_equal(sub_ids, bi[[7, 3]])
    ref.close()


def test_the_exact_answers_pass_and_recall_is_one():
    rows, pool = data()
    ref = reference.Reference(rows, pool)
    bk, bi = brute(rows, pool, K)
    checks, recall = verdict.judge(answers_from(bi, bk), ref, N, FLAT)
    assert verdict.all_ok(checks), checks
    assert recall == 1.0
    assert checks["sim_err"]["value"] <= 5.0000001e-7


def test_tie_aware_recall_counts_a_tied_id_as_a_hit():
    rows, pool = data()
    rows[17] = rows[bi_first(rows, pool)]          # a duplicate row
    ref = reference.Reference(rows, pool)
    bk, bi = brute(rows, pool, K)
    q = 0
    swap = bi.copy()
    twin = 17 if bi[q, 0] != 17 else bi_first(rows, pool)
    if twin not in swap[q]:
        swap[q, K - 1] = swap[q, 0]
        swap[q, 0] = twin
        order = np.argsort(-bk[q], kind="stable")
        swap[q] = swap[q][order]
    checks, recall = verdict.judge(answers_from(swap, bk), ref, N, IVF)
    assert recall >= 1.0 - 1.0 / (P * K)


def bi_first(rows, pool):
    return int(torch.argmax(pool[:1].double() @ rows.double().T))


def test_an_altered_answer_fails():
    rows, pool = data()
    ref = reference.Reference(rows, pool)
    bk, bi = brute(rows, pool, K)
    bad = bi.copy()
    bad[5, 3] = (bad[5, 3] + 1) % N if (bad[5, 3] + 1) % N not in bad[5] \
        else (bad[5, 3] + 2) % N
    checks, _ = verdict.judge(answers_from(bad, bk), ref, N, FLAT)
    assert not checks["sim_err"]["ok"]
    assert not checks["rank_gap"]["ok"]
    assert not verdict.all_ok(checks)


def test_missing_and_failed_answers_fail():
    rows, pool = data()
    ref = reference.Reference(rows, pool)
    bk, bi = brute(rows, pool, K)
    a = answers_from(bi[:, :K], bk[:, :K])
    a.ids[4] = a.ids[4][:K - 1]
    a.sims[4] = a.sims[4][:K - 1]
    checks, _ = verdict.judge(a, ref, N, FLAT)
    assert checks["short"]["value"] == 1 and not verdict.all_ok(checks)
    a = answers_from(bi, bk)
    a.failed = 1
    checks, _ = verdict.judge(a, ref, N, FLAT)
    assert not checks["failed"]["ok"]


def test_recall_below_the_guarantee_fails():
    rows, pool = data()
    ref = reference.Reference(rows, pool)
    far_keys, far_ids = ref.top(4 * K)
    ids, keys = far_ids[:, 3 * K:], far_keys[:, 3 * K:]
    checks, recall = verdict.judge(answers_from(ids, keys), ref, N, IVF)
    assert recall < 0.95 and not checks["recall"]["ok"]


def test_the_tf32_control_fails_at_the_cells_width():
    """The control: the reference put in the program's place one
    precision below the configuration's f32 (TF32 products; on the CPU,
    inputs rounded to TF32's mantissa) must fail a compared number."""
    rows, pool = data(seed=9)
    ref = reference.Reference(rows, pool)
    keys, ids = ref.top(K, tf32=True)
    for config in (FLAT, IVF):
        checks, _ = verdict.judge(answers_from(ids, keys), ref, N, config)
        assert not checks["sim_err"]["ok"], checks
        assert checks["sim_err"]["value"] > 3 * 5e-7


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-12, -3.3])
    r = reference.round_tf32(x)
    assert r[0] == 1.0 + 2**-10
    assert r[1] == 1.0            # a tie rounds to even
    assert r[2] == 1.0 + 2**-10
    bits = r.view(torch.int32)
    assert int((bits & 0x1FFF).abs().sum()) == 0
