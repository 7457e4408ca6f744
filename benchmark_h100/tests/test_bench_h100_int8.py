"""On the card: the int8 capacity cell's timed path at its full size
(8,388,608 x 768 int8 rows, ``batch_query(..., k=10, rerank=True)``
through the cell's own generator) against the plain reference
``reference_int8.py`` on the card. Prints one JSON line of what it
compared (run with ``-s`` to see it)."""

import json

import numpy as np
import pytest

from benchmark_h100 import datagen, loadgen, reference_int8, run
from benchmark_h100 import server as srv

BENCH = run.load_bench()
CELL = "int8cap.lib-b64-k10-rerank"
CALLS = 8               # calls of the cell's batch compared
SEED = 2**31 + 1818


def answer_arrays(out):
    return (np.array([ids for ids, _, _ in out], np.int64),
            np.array([sims for _, sims, _ in out], np.float64))


def cosine64(rows, pool, qidx, ids):
    """float64 cosine of pool query qidx[i] with row ids[i, j]."""
    import torch
    dev = rows.device
    r = rows[torch.as_tensor(ids, device=dev)].double()
    r = r / torch.linalg.vector_norm(r, dim=2, keepdim=True)
    q = pool[torch.as_tensor(qidx, device=dev)].double()
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    return torch.einsum("amd,ad->am", r, q).cpu().numpy()


@pytest.mark.gpu
def test_the_timed_path_matches_the_int8_reference_at_full_size(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell, config, traffic = run.cell_files(BENCH, CELL)
    gen = run.generator(traffic)
    n, dim, k = int(config["rows"]), int(config["dim"]), int(traffic["k"])
    over = 4                # the store's default rerank_oversample
    rows = datagen.rows(config["data"], n, dim, SEED, "cuda")
    pool = datagen.query_pool(config["data"], int(config["pool"]), dim,
                              SEED, "cuda")
    manager, store = srv.build_store(config, rows.cpu().numpy(), tmp_path,
                                     "cuda")
    assert store.config.ann_params.get("rerank_oversample", over) == over
    timed = gen.Reranking(store)
    batches = loadgen.lib_batches(pool.cpu().numpy(), int(traffic["batch"]))
    qidx, ids, sims, raw_ids, raw_sims = [], [], [], [], []
    for _ in range(CALLS):
        idx, qs = next(batches)
        i, s = answer_arrays(timed.batch_query(qs, k=k))
        qidx.append(idx)
        ids.append(i)
        sims.append(s)
        i, s = answer_arrays(store.batch_query(qs, k=k))
        raw_ids.append(i)
        raw_sims.append(s)
    manager.shutdown()
    del store, manager, timed
    torch.cuda.empty_cache()
    qidx, ids, sims = map(np.concatenate, (qidx, ids, sims))
    raw_ids, raw_sims = np.concatenate(raw_ids), np.concatenate(raw_sims)

    ref = reference_int8.Int8Reference(rows)
    try:
        ans = ref.search(pool[torch.as_tensor(qidx, device="cuda")], k,
                         over)
    finally:
        ref.close()
    agree = reference_int8.agreement(ids, sims, ans)
    sim_err = float(np.abs(sims - cosine64(rows, pool, qidx, ids)).max())
    raw_err = float(np.abs(raw_sims - cosine64(rows, pool, qidx,
                                               raw_ids)).max())
    print(json.dumps({
        "rows": n, "queries": len(qidx), "same": int(agree["same"].sum()),
        "near_tie": int(agree["near_tie"].sum()),
        "bad": int(agree["bad"].sum()),
        "score_err": float(agree["score_err"].max()),
        "sim_err": sim_err, "sim_err_without_refine": raw_err,
        "card": torch.cuda.get_device_name(0)}))
    assert not agree["bad"].any(), np.flatnonzero(agree["bad"])
    assert agree["score_err"].max() <= reference_int8.SCORE_TOL
    assert agree["same"].mean() >= 0.95
    assert sim_err <= config["limits"]["sim_err"]
    assert raw_err > config["limits"]["sim_err"]


def test_the_int8_roofline_counts_a_launch_once_across_its_chunks():
    """Two launches of four chunks each: eight scoring events, two
    merges; a launch's device time is the slice's over the merges."""
    read = run.reader("scan_kernel_bigk_int8_roofline")
    ms = {"void scan_small_k_tile<2, 64, true>(ScanArgs)": 12.0,
          "void sel_hist<0>(SelArgs)": 2.0, "sel_output(SelArgs)": 1.6,
          "sel_sort(SelArgs, int, float*, int*, int)": 0.2,
          "merge_topk_kernel(float const*, int const*, int, int)": 0.2}
    events = dict.fromkeys(ms, 8)
    events["merge_topk_kernel(float const*, int const*, int, int)"] = 2
    t = {"device": {"ms_by_name": ms, "events_by_name": events},
         "bounds_ms": {"scan_kernel_bigk": [1.6, 1.6]},
         "launches": {"scan_kernel_bigk": 2}}
    assert read(t) == pytest.approx(100.0 * 1.6 / 8.0)
    # one chunk a launch: no merge, one scoring event a launch
    del ms["merge_topk_kernel(float const*, int const*, int, int)"]
    events = dict.fromkeys(ms, 2)
    t["device"] = {"ms_by_name": ms, "events_by_name": events}
    assert read(t) == pytest.approx(100.0 * 1.6 / 7.9)
    assert read({}) is None


def test_the_rerank_reader_reads_the_generators_record():
    read = run.reader("store.rerank_ms")
    assert read({"store.rerank": {"count": 4, "total_s": 0.02}}) \
        == pytest.approx(5.0)
    assert read({"store.rerank": {"count": 0, "total_s": 0.0}}) is None
    assert read({"device": {"window_s": 1.0, "busy_s": 0.5}}) is None
