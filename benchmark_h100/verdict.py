"""What decides ``correct``: the window's answers against the reference.

Each number compared has its limit in the configuration's ``limits`` and
``guarantees`` (PERF.md gives the readings each limit was set from):

* ``failed``   requests that got no 200 answer (limit 0);
* ``short``    answers that are not a list of k distinct row ids with
               similarities in descending order (limit 0);
* ``sim_err``  the largest gap between a similarity returned and the
               reference's float64 cosine of the id returned with it;
* ``rank_gap`` (exact configurations) the largest distance by which an
               id returned lies below the reference's k-th key;
* ``recall``   (configurations that state a recall) tie-aware recall@k of
               every answer, no less than the stated guarantee.
"""

from __future__ import annotations

import numpy as np


def tie_tol(kth: np.ndarray) -> np.ndarray:
    """An id counts as a hit if its key reaches the k-th within the f32
    rounding of a key (as PERF.md's tie-aware recall counts)."""
    return 1e-6 + 1e-5 * np.abs(kth)


class Answers:
    """The answers of the window, one row each: the pool query asked
    (``qidx``), the ids and similarities returned (padded with -1 /
    nan to k), and how many requests got no answer (``failed``)."""

    def __init__(self, k: int) -> None:
        self.k = k
        self.qidx: list[int] = []
        self.ids: list[list[int]] = []
        self.sims: list[list[float]] = []
        self.failed = 0

    def add(self, qidx: int, ids, sims) -> None:
        self.qidx.append(int(qidx))
        self.ids.append(list(ids))
        self.sims.append(list(sims))

    def arrays(self):
        a, k = len(self.qidx), self.k
        ids = np.full((a, k), -1, np.int64)
        sims = np.full((a, k), np.nan, np.float64)
        count = np.zeros(a, np.int64)
        for i, (row_ids, row_sims) in enumerate(zip(self.ids, self.sims)):
            m = min(len(row_ids), k)
            ids[i, :m] = row_ids[:m]
            sims[i, :m] = row_sims[:m]
            count[i] = len(row_ids)
        return np.asarray(self.qidx, np.int64), ids, sims, count


def malformed(ids: np.ndarray, sims: np.ndarray, count: np.ndarray,
              k: int, n_rows: int) -> np.ndarray:
    """(A,) bool: an answer that is not k distinct ids in [0, n_rows)
    with similarities that never rise."""
    bad = count != k
    bad |= ((ids < 0) | (ids >= n_rows)).any(axis=1)
    srt = np.sort(ids, axis=1)
    bad |= (srt[:, 1:] == srt[:, :-1]).any(axis=1)
    with np.errstate(invalid="ignore"):
        bad |= (np.diff(sims, axis=1) > 0).any(axis=1)
        bad |= ~np.isfinite(sims).all(axis=1)
    return bad


def judge(answers: Answers, ref, n_rows: int, config: dict):
    """(checks, recall): ``checks`` maps each number compared to
    {"value", "limit", "ok"}; ``recall`` is the tie-aware recall@k of
    every answer returned (also an end-to-end metric)."""
    k = answers.k
    qidx, ids, sims, count = answers.arrays()
    limits, guar = config["limits"], config["guarantees"]
    checks = {"failed": _check(answers.failed, 0, "max")}
    bad = malformed(ids, sims, count, k, n_rows)
    checks["short"] = _check(int(bad.sum()), 0, "max")
    if len(qidx) == 0:
        checks["answered"] = _check(0, 1, "min")
        return checks, 0.0
    uq, inv = np.unique(qidx, return_inverse=True)
    kth_keys, _ = ref.top(k, queries=uq)
    kth = kth_keys[inv, k - 1]
    keys = ref.keys_of(qidx, ids)
    live = ids >= 0
    err = np.where(live, np.abs(sims - keys), 0.0)
    err = np.where(np.isnan(err), np.inf, err)
    checks["sim_err"] = _check(float(err.max()), limits["sim_err"], "max")
    hits = np.where(live, keys >= (kth - tie_tol(kth))[:, None], False)
    recall = float(hits.sum()) / float(len(qidx) * k)
    if guar.get("exact"):
        low = np.where(live, keys, np.inf).min(axis=1)
        gap = float(np.max(np.maximum(kth - low, 0.0)))
        checks["rank_gap"] = _check(gap, limits["rank_gap"], "max")
    if guar.get("recall_at_k_min") is not None:
        checks["recall"] = _check(recall, guar["recall_at_k_min"], "min")
    return checks, recall


def _check(value, limit, kind: str) -> dict:
    ok = value <= limit if kind == "max" else value >= limit
    return {"value": value, "limit": limit, "ok": bool(ok)}


def all_ok(checks: dict) -> bool:
    return all(c["ok"] for c in checks.values())


def lines(checks: dict) -> list[str]:
    """One line a number: its name, value and limit."""
    return [f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['ok'] else 'FAIL'}" for name, c in checks.items()]
