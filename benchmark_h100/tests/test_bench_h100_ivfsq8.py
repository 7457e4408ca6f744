"""The IVF_SQ8 + refine cell: on the card, its timed path at the full
size (8,388,608 x 768 int8 rows behind the store's gather-layout IVF,
``batch_query(..., k=10, rerank=True)`` through the cell's own
generator) against the plain reference ``reference_ivf_int8.py`` on the
card, printing one JSON line of what it compared (run with ``-s``); on
the CPU, the readers of the cell's per-layer metrics."""

import json

import numpy as np
import pytest

from benchmark_h100 import datagen, loadgen, reference_ivf_int8, run
from benchmark_h100 import server as srv

BENCH = run.load_bench()
CELL = "ivfsq8.lib-b16-k10-rerank"
CALLS = 8               # calls of the cell's batch compared
SEED = 2**31 + 2222


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
def test_the_timed_path_matches_the_ivf_reference_at_full_size(tmp_path):
    """Ids as the reference's except at stated near-ties (the 40th and
    41st int8 keys, two refined scores, or the last bucket probed and
    the next, within float32 rounding); every shared id's score within
    1e-6; every call through the index."""
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
    timed = gen.lib_rerank.Reranking(store)
    searches = {"n": 0}
    orig = store._ann_search

    def spy(q, kk):
        searches["n"] += 1
        return orig(q, kk)
    store._ann_search = spy
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
    index = store._ann
    layout = (index._centroids, index._ids, index._bucket_cluster,
              index.nprobe)
    stats = index.get_stats()
    manager.shutdown()
    del store, manager, timed, index
    torch.cuda.empty_cache()
    qidx, ids, sims = map(np.concatenate, (qidx, ids, sims))
    raw_ids, raw_sims = np.concatenate(raw_ids), np.concatenate(raw_sims)

    ref = reference_ivf_int8.IvfInt8Reference(rows, *layout)
    try:
        ans = ref.search(pool[torch.as_tensor(qidx, device="cuda")], k,
                         over)
    finally:
        ref.close()
    agree = reference_ivf_int8.agreement(ids, sims, ans, ref.bucket_margin)
    sim_err = float(np.abs(sims - cosine64(rows, pool, qidx, ids)).max())
    raw_err = float(np.abs(raw_sims - cosine64(rows, pool, qidx,
                                               raw_ids)).max())
    print(json.dumps({
        "rows": n, "queries": len(qidx), "searches": searches["n"],
        "clusters": stats["clusters"], "buckets": stats["buckets"],
        "bucket_rows": stats["bucket_rows"], "nprobe": stats["nprobe"],
        "same": int(agree["same"].sum()),
        "near_tie": int(agree["near_tie"].sum()),
        "bad": int(agree["bad"].sum()),
        "score_err": float(agree["score_err"].max()),
        "sim_err": sim_err, "sim_err_without_refine": raw_err,
        "card": torch.cuda.get_device_name(0)}))
    assert searches["n"] == 2 * CALLS
    assert not agree["bad"].any(), np.flatnonzero(agree["bad"])
    assert agree["score_err"].max() <= reference_ivf_int8.reference_int8 \
        .SCORE_TOL
    assert agree["same"].mean() >= 0.95
    assert sim_err <= config["limits"]["sim_err"]
    assert raw_err > config["limits"]["sim_err"]


def test_the_probe_readers_read_the_generators_record():
    """``index.search_ms.ivfsq8`` reads the span's mean; the roofline
    the gather launches' least times (``ivf_gather_bounds_ms``) over
    their device time a launch, the kernel and its merge."""
    search = run.reader("index.search_ms.ivfsq8")
    roof = run.reader("ivf_gather_roofline")
    device = {"window_s": 1.0, "busy_s": 0.5,
              "ms_by_name": {"void ivf_gather_kernel<2, 2>(IvfArgs)": 1.2,
                             "merge_topk_kernel(float const*)": 0.4,
                             "void scan_small_k<2>(ScanArgs)": 9.0},
              "events_by_name": {"void ivf_gather_kernel<2, 2>(IvfArgs)": 4,
                                 "merge_topk_kernel(float const*)": 4,
                                 "void scan_small_k<2>(ScanArgs)": 1}}
    t = {"index.search": {"count": 4, "total_s": 0.012, "rows": 0},
         "ivf_gather_bounds_ms": [0.1, 0.1, 0.12, 0.08],
         "launches": {"ivf_gather_kernel": 4}, "device": device}
    assert search(t) == pytest.approx(3.0)
    assert roof(t) == pytest.approx(100.0 * 0.1 / 0.4)
    # no card profiled, or a program without the kernel: no roofline
    assert roof({**t, "device": None}) is None
    assert roof({**t, "launches": {}}) is None
    assert roof({k: v for k, v in t.items()
                 if k != "ivf_gather_bounds_ms"}) is None
    # a program without the span, or a slice without a probe
    assert search({"device": device}) is None
    assert search({"index.search": {"count": 0, "total_s": 0.0,
                                    "rows": 0}}) is None
