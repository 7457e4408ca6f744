"""Rows, the query pool and the traffic walks repeat from the seed."""

import json
from pathlib import Path

import numpy as np
import torch

from benchmark_h100 import client, datagen, loadgen

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "benchmark_h100" / "configs" /
                   "cohere768-1m-flat.json").read_text())["data"]
BIG_SEED = 2**31 + 987654321          # more than 32 signed bits hold


def test_rows_and_pool_repeat_from_the_seed():
    a = datagen.rows(SPEC, 3000, 64, BIG_SEED, "cpu")
    b = datagen.rows(SPEC, 3000, 64, BIG_SEED, "cpu")
    assert torch.equal(a, b)
    assert torch.equal(datagen.query_pool(SPEC, 50, 64, BIG_SEED, "cpu"),
                       datagen.query_pool(SPEC, 50, 64, BIG_SEED, "cpu"))
    c = datagen.rows(SPEC, 3000, 64, BIG_SEED + 1, "cpu")
    assert not torch.equal(a, c)


def test_rows_over_several_blocks_are_unit_and_repeat():
    n = datagen.BLOCK_ROWS + 17
    full = datagen.rows(SPEC, n, 32, 5, "cpu")
    again = torch.cat([b for _, b in datagen.row_blocks(SPEC, n, 32, 5,
                                                         "cpu")])
    assert torch.equal(full, again)
    norms = torch.linalg.vector_norm(full, dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)


def test_pool_is_fresh_draws_not_rows():
    rows = datagen.rows(SPEC, 2000, 64, 11, "cpu")
    pool = datagen.query_pool(SPEC, 200, 64, 11, "cpu")
    best = (pool @ rows.T).max(dim=1).values
    assert float(best.max()) < 0.9999


def test_derive_seed_fits_a_generator():
    for seed in (0, 1, 2**31 - 1, BIG_SEED, 2**40):
        s = datagen.derive_seed(seed, "rows", 3)
        assert 0 <= s < 2**63
        torch.Generator().manual_seed(s)


def test_rest_users_walk_their_share_of_the_pool():
    seqs = [client.user_sequence(g, 64, 10000) for g in range(64)]
    flat = sorted(i for s in seqs for i in s)
    assert flat == list(range(10000))
    assert client.user_sequence(0, 1, 5) == [0, 1, 2, 3, 4]


def test_library_batches_walk_the_pool_and_wrap():
    pool = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    walk = loadgen.lib_batches(pool, 4)
    got = [next(walk) for _ in range(3)]
    assert [list(i) for i, _ in got] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                         [8, 9, 0, 1]]
    assert np.array_equal(got[2][1], pool[[8, 9, 0, 1]])
