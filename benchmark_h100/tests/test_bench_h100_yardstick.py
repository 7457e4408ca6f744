"""The frozen roofline copies count the work as the earlier chip runs
did (PERF.md's table of kernels, 1M x 768 f32)."""

import torch

from benchmark_h100 import yardstick

N, D, ROW = 1_000_000, 768, 768 * 4


def test_flat_b64_top10_is_bound_by_operations():
    ms, by = yardstick.bound(N, ROW, 64, D, 10, "float32")
    assert by == "operations"
    assert ms == 1.467223880597015


def test_flat_b1_top100_is_bound_by_bytes():
    ms, by = yardstick.bound(N, ROW, 1, D, 100, "float32")
    assert by == "bytes"
    assert ms == 0.9170160811940299


def test_ivf_b1_bound_from_the_ivf_paths_fills():
    # the ivf path's b1 probe read 15,857 live rows over its 32 distinct
    # buckets: 0.014542122985074625 ms of bytes
    fills = torch.zeros(4096, dtype=torch.int32)
    sel = torch.arange(100, 132, dtype=torch.int32)[None, :]
    fills[100:132] = 495
    fills[100] += 15857 - 495 * 32
    ms, by = yardstick.ivf_bound(fills, sel, ROW, D, 10, "float32")
    assert by == "bytes"
    assert ms == 0.014542122985074625


def test_ivf_bound_reads_a_bucket_probed_twice_once():
    fills = torch.full((8,), 100, dtype=torch.int32)
    one, _ = yardstick.ivf_bound(fills, torch.tensor([[1, 2]]), ROW, D, 10,
                                 "float32")
    two, _ = yardstick.ivf_bound(fills, torch.tensor([[1, 2], [2, 1]]),
                                 ROW, D, 10, "float32")
    # the second query adds its sel, query and outputs, no rows
    extra = (2 * 4 + D * 4 + 10 * 8) / yardstick.HBM_BYTES_PER_S * 1e3
    assert abs(two - one - extra) < 1e-12
