"""Percentiles are taken over every request of the window, a failed one
counted beyond every limit; throughput counts what was answered."""

import numpy as np

from benchmark_h100 import run, window

K = 2


def rec(q, send, done, status=200):
    ok = status == 200
    return [q, send, done, status, [1, 2] if ok else [], [0.9, 0.8]
            if ok else []]


def test_failures_count_beyond_every_limit():
    records = [rec(i, 10.0 + i * 0.01, 10.0 + i * 0.01 + 0.005)
               for i in range(98)]
    records += [rec(98, 10.5, 10.6, 429), rec(99, 10.6, 10.61, -1)]
    answers, lat, done, attempted, failed = window.rest_window(
        records, 10.0, 12.0, K, 30000.0)
    assert attempted == 100 and failed == 2 and done == 98
    assert answers.failed == 2 and len(answers.qidx) == 98
    assert abs(run.percentile(lat, 50) - 5.0) < 1e-6
    # two of 100 at the timeout: the 99th percentile lies among them
    assert run.percentile(lat, 99) >= 30000.0 - 1e-9


def test_window_edges():
    records = [rec(0, 9.9, 10.05),      # sent before t0: answered, untimed
               rec(1, 10.0, 10.02),     # timed
               rec(2, 11.99, 12.03)]    # timed, answered after t_end
    answers, lat, done, attempted, failed = window.rest_window(
        records, 10.0, 12.0, K, 30000.0)
    assert attempted == 2 and done == 2 and failed == 0
    assert np.allclose(sorted(lat), [20.0, 40.0])
    assert len(answers.qidx) == 3      # every answer is judged


def test_library_window_counts_queries_and_calls():
    times = [(9.95, 10.01, 64), (10.01, 10.02, 64), (11.995, 12.01, 64)]
    kept = [(np.array([0, 1]), [([5], [0.5], [{}]), ([6], [0.4], [{}])]),
            (np.array([2]), None)]
    answers, lat, done, attempted, failed = window.library_window(
        times, kept, 1, 10.0, 12.0, 1)
    assert done == 128 and attempted == 2 and failed == 1
    assert answers.qidx == [0, 1]
