"""Row reductions of ``tpu_vector_db_torch/ops/distance.py`` give a row
the same bits in a batch of any size.

torch's CUDA reduction over the last axis sums a row of a tensor of 2-15
rows in another order than one of 16 or more. ``l2_normalize`` and
``row_sqnorms`` pad such a tensor to 16 rows on the card, so a store
writes the same bytes for a row whether it came alone, in a small add or
in a reopen's block, and a query scores alike at any batch. On the CPU
they are the plain reductions, bit for bit, so the parity tests against
the JAX package see no change. The ``gpu`` case runs on the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpu_vector_db_torch.ops import distance as D

DIMS = (128, 384, 768, 1536)
COUNTS = tuple(range(1, 41)) + (4096,)


def rows(d: int, n: int, device="cpu") -> torch.Tensor:
    x = np.random.default_rng(d).standard_normal((n, d)).astype(np.float32)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("d", DIMS)
def test_cpu_reductions_unchanged(d):
    """On the CPU both are the plain torch reductions, bit for bit."""
    x = rows(d, 40)
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    want = x / torch.clamp(norm, min=D.EPS)
    assert torch.equal(D.l2_normalize(x).view(torch.int32),
                       want.view(torch.int32))
    assert torch.equal(D.row_sqnorms(x).view(torch.int32),
                       torch.sum(x * x, dim=-1).view(torch.int32))
    y = rows(d + 1, 40)[:, :d]
    assert torch.equal(D.row_dots(x, y).view(torch.int32),
                       torch.sum(x * y, dim=-1).view(torch.int32))
    q = x[:5]
    assert torch.equal(
        D.squared_l2_distances(q, x),
        torch.clamp(torch.sum(q * q, -1, keepdim=True) - 2.0 * (q @ x.T)
                    + torch.sum(x * x, -1)[None, :], min=0.0))


def test_shapes_kept():
    x = rows(16, 6)
    assert D.row_sqnorms(x).shape == (6,)
    assert D.row_sqnorms(x.view(2, 3, 16)).shape == (2, 3)
    assert D.l2_normalize(x.view(2, 3, 16)).shape == (2, 3, 16)
    assert D.row_sqnorms(x[:0]).shape == (0,)
    assert D.row_dots(x.view(2, 3, 16), x[:1]).shape == (2, 3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("d", DIMS)
def test_row_bits_independent_of_row_count_on_card(card, d):
    """For every row count 1-40 and 4096, each row's normalized bits,
    squared norm and inner product with its row of another tensor equal
    that row's one-row result."""
    x = rows(d, max(COUNTS), card)
    y = rows(d + 1, max(COUNTS), card)[:, :d]
    alone_norm = torch.cat([D.l2_normalize(r[None]) for r in x])
    alone_sq = torch.cat([D.row_sqnorms(r[None]) for r in x])
    alone_dot = torch.cat([D.row_dots(r[None], s[None])
                           for r, s in zip(x, y)])
    for n in COUNTS:
        assert torch.equal(D.row_dots(x[:n], y[:n]).view(torch.int32),
                           alone_dot[:n].view(torch.int32)), (d, n)
        assert torch.equal(D.l2_normalize(x[:n]).view(torch.int32),
                           alone_norm[:n].view(torch.int32)), (d, n)
        assert torch.equal(D.row_sqnorms(x[:n]).view(torch.int32),
                           alone_sq[:n].view(torch.int32)), (d, n)
