"""The port's beam-graph build against the JAX package's on the graph
regime that chip_smoke.py's ``graph`` path serves at 300K: 768-dim cosine
rows, each one of 300 N(0, I) centres plus 1.0 N(0, I)
(benchmarks/beam_ef_sweep.py's "realistic spread"), here 20,000 rows and
200 held-out queries made from a seed with numpy, with the graph's
defaults (M 16, ef_construction 200, alpha 1.2, batch 512), on the CPU.

At 768 dims the f32 sums of the two packages, taken in another order,
flip a few near-ties among the build's discrete choices, so the graphs
are not asserted equal here (tests/test_torch_beam_graph.py asserts them
equal at 3,000 x 32). What is held is the result: both builds reach
recall@10 >= 0.9, within 0.02 of each other. The two builds take about
five minutes of a whole CPU, so the test is marked ``slow``: run it with
``python -m pytest tests/test_torch_beam_graph_regime.py -m slow -s`` to
print the rows whose neighbour lists are equal and both recalls.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_vector_db.index import beam_graph as JB

from tpu_vector_db_torch.index.beam_graph import BeamGraphIndex

N, D, CENTRES, QUERIES, K = 20_000, 768, 300, 200, 10


def spread(rng, centres, m):
    x = centres[rng.integers(0, len(centres), m)] + rng.standard_normal(
        (m, centres.shape[1])).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def recall(found, truth):
    hits = sum(len(set(f.tolist()) & set(t.tolist()))
               for f, t in zip(np.asarray(found), truth))
    return hits / truth.size


@pytest.mark.slow
def test_build_recall_matches_jax_on_graph_regime():
    rng = np.random.default_rng(0)
    centres = rng.standard_normal((CENTRES, D)).astype(np.float32)
    db = spread(rng, centres, N)
    qs = spread(rng, centres, QUERIES)
    truth = np.argsort(-(qs @ db.T), axis=1)[:, :K]
    kw = dict(dim=D, metric="cosine")
    jidx = JB.BeamGraphIndex(**kw)
    jidx.build(jnp.asarray(db), N)
    tidx = BeamGraphIndex(**kw, device="cpu")
    tidx.build(torch.from_numpy(db), N)
    equal = int((np.asarray(tidx._graph[:N])
                 == np.asarray(jidx._graph[:N])).all(axis=1).sum())
    r_j = recall(jidx.search(jnp.asarray(qs), jnp.asarray(db), N, k=K)[0],
                 truth)
    r_t = recall(tidx.search(torch.from_numpy(qs), torch.from_numpy(db), N,
                             k=K)[0], truth)
    print(f"\n{N}x{D} graph regime: rows equal {equal}/{N}, "
          f"recall@{K} jax {r_j} port {r_t}")
    assert tidx.size == jidx.size == N
    assert r_t >= 0.9 and r_j >= 0.9
    assert abs(r_t - r_j) <= 0.02
