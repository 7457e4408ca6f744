"""The port's k-means (tpu_vector_db_torch/ops/kmeans.py) against the JAX
package's on the same inputs, made from a seed with numpy.

Both sides get the same rows and the same starting centroids. Tolerances:
f32 sums in another order agree to 1e-5 on unit-scale centroids and keys
(1e-4 after several Lloyd iterations, 1e-3 relative on euclidean keys of
un-normalized rows); cluster assignments agree exactly except where a
row's two best centroid scores lie within 1e-5 of each other (a near-tie
the summation order may flip). Empty-cluster re-seeding draws from
another generator in each package, so train_kmeans is compared on data
where no cluster empties.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_vector_db.ops import kmeans as jk
from tpu_vector_db.ops.quant4 import pack_int4 as jax_pack_int4

from tpu_vector_db_torch.ops import kmeans as tk

torch.set_num_threads(1)

ASSIGN_TOL = 1e-5


def clustered(seed, n, d, centers, spread, unit=True, ordered=False):
    """Rows around ``centers`` random centres; ``ordered`` lays them out
    centre by centre, so the strided init seeds one centroid in each."""
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal((centers, d)).astype(np.float32)
    pick = (np.arange(n) * centers // n if ordered
            else rng.integers(0, centers, n))
    x = mu[pick] + spread * rng.standard_normal((n, d)).astype(np.float32)
    if unit:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    d_pad = -(-d // 128) * 128
    return np.pad(x, ((0, 0), (0, d_pad - d))).astype(np.float32)


def stores(x, dtype):
    """(jax db, torch db, jax scales, torch scales) of prepared rows."""
    if dtype == "int8":
        q = np.clip(np.round(x * 127.0), -127, 127).astype(np.int8)
        return jnp.asarray(q), torch.from_numpy(q), None, None
    if dtype == "int4":
        packed, scales = jax_pack_int4(jnp.asarray(x))
        p, s = np.array(packed), np.array(scales)
        return (jnp.asarray(p), torch.from_numpy(p), jnp.asarray(s),
                torch.from_numpy(s))
    if dtype == "bfloat16":
        return (jnp.asarray(x).astype(jnp.bfloat16),
                torch.from_numpy(x).to(torch.bfloat16), None, None)
    return jnp.asarray(x), torch.from_numpy(x), None, None


def widened(x, dtype, scales=None):
    """The rows as both packages score them, f32 on the host."""
    jdb, tdb, js, ts = stores(x, dtype)
    return tk._widen_block(tdb, ts).float().numpy()


CASES = [("float32", "cosine"), ("float32", "euclidean"),
         ("bfloat16", "cosine"), ("int8", "cosine"), ("int4", "cosine")]


def assert_same_assignment(got, want, rows, cents, metric):
    """Equal, except at near-ties of the two chosen centroids' keys."""
    keys = rows @ cents.T
    if metric == "euclidean":
        keys = 2 * keys - np.sum(cents * cents, axis=1)[None, :]
    diff = np.nonzero(got != want)[0]
    for i in diff:
        scale = max(1.0, abs(keys[i, want[i]]))
        assert abs(keys[i, got[i]] - keys[i, want[i]]) <= ASSIGN_TOL * scale
    assert len(diff) <= 0.01 * len(got)


@pytest.mark.parametrize("dtype,metric", CASES)
def test_assign_clusters(dtype, metric):
    n, c = 1500, 24
    x = clustered(1, n, 64, 12, 0.3, unit=metric == "cosine")
    cents = clustered(2, c, 64, c, 0.0, unit=metric == "cosine")
    jdb, tdb, js, ts = stores(x, dtype)
    want = np.asarray(jk.assign_clusters(
        jdb, jnp.int32(n), jnp.asarray(cents), metric=metric,
        block_rows=512, db_scales=js))
    got = tk.assign_clusters(tdb, n, torch.from_numpy(cents), metric=metric,
                             block_rows=512, db_scales=ts).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    rows = widened(x, dtype)
    c_rows = (cents if dtype == "float32" else np.asarray(
        torch.from_numpy(cents).to(torch.bfloat16).float()))
    assert_same_assignment(got, want, rows, c_rows, metric)


@pytest.mark.parametrize("dtype,metric", CASES)
def test_lloyd_step(dtype, metric):
    """One Lloyd iteration from the same centroids: the same counts, and
    centroids and mean key within 1e-5 (1e-3 relative, euclidean)."""
    n, c = 1200, 16
    x = clustered(3, n, 64, 8, 0.2, unit=metric == "cosine")
    cents = x[:: n // c][:c].copy()
    jdb, tdb, js, ts = stores(x, dtype)
    count = n - 37                      # padding rows stay out
    wc, wn, wk = jk._lloyd_step(jdb, jnp.int32(count), jnp.asarray(cents),
                                metric, 256, db_scales=js)
    gc_, gn, gk = tk._lloyd_step(tdb, count, torch.from_numpy(cents),
                                 metric, 256, db_scales=ts)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    assert float(gn.sum()) == count
    rtol = 1e-3 if metric == "euclidean" else 0
    np.testing.assert_allclose(gc_.numpy(), np.asarray(wc), atol=1e-5,
                               rtol=rtol)
    np.testing.assert_allclose(float(gk), float(wk), atol=1e-5, rtol=rtol)


@pytest.mark.parametrize("dtype,metric", CASES)
def test_train_kmeans(dtype, metric):
    """Strided init (one centroid in each true cluster) and 6 iterations
    on well-separated clusters (no cluster empties, so no re-seed is
    drawn): the same counts, centroids within 1e-4."""
    n, c = 2000, 8
    x = clustered(4, n, 64, 8, 0.05, unit=metric == "cosine", ordered=True)
    jdb, tdb, js, ts = stores(x, dtype)
    wc, wn = jk.train_kmeans(jdb, n, c, metric=metric, iters=6,
                             block_rows=512, db_scales=js)
    gc_, gn = tk.train_kmeans(tdb, n, c, metric=metric, iters=6,
                              block_rows=512, db_scales=ts)
    assert np.all(np.asarray(wn) > 0)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    np.testing.assert_allclose(gc_.numpy(), np.asarray(wc), atol=1e-4,
                               rtol=1e-3 if metric == "euclidean" else 0)


@pytest.mark.parametrize("n", [129, 257, 1001])
def test_non_divisible_block_counts(n):
    """Row counts that do not divide into blocks: no tail row is dropped
    from training, the clamped-overlap assignment equals an unblocked one,
    and both equal the JAX package's."""
    x = clustered(5, n, 16, 4, 0.02, ordered=True)
    jdb, tdb, _, _ = stores(x, "float32")
    cents, counts = tk.train_kmeans(tdb, n, 4, metric="cosine", iters=8,
                                    block_rows=64)
    assert int(counts.sum()) == n
    got = tk.assign_clusters(tdb, n, cents, block_rows=64).numpy()
    full = tk.assign_clusters(tdb, n, cents, block_rows=n).numpy()
    want = np.asarray(jk.assign_clusters(jdb, jnp.int32(n),
                                         jnp.asarray(cents.numpy()),
                                         block_rows=64))
    assert got.shape == (n,)
    np.testing.assert_array_equal(got, full)
    np.testing.assert_array_equal(got, want)
    wc, wn = jk.train_kmeans(jdb, n, 4, metric="cosine", iters=8,
                             block_rows=64)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(wn))
    np.testing.assert_allclose(cents.numpy(), np.asarray(wc), atol=1e-4)


def test_reseed_fills_empty_clusters():
    """Half the rows are one point, so the strided init seeds several
    centroids on it and all but one win no row: those are re-seeded from
    live rows drawn from the seeded torch.Generator. The same seed
    repeats the run exactly, and the centroids stay unit-norm."""
    x = clustered(6, 512, 16, 2, 0.01)
    x[:256] = x[0]                      # half the rows are one point
    tdb = torch.from_numpy(x)
    cents, counts = tk.train_kmeans(tdb, 512, 8, iters=6, block_rows=128,
                                    seed=3)
    assert int(counts.sum()) == 512
    again, _ = tk.train_kmeans(tdb, 512, 8, iters=6, block_rows=128, seed=3)
    assert torch.equal(cents, again)    # a seed repeats the run exactly
    np.testing.assert_allclose(torch.linalg.vector_norm(cents, dim=1),
                               1.0, atol=1e-5)
