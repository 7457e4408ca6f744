"""The port's IVF probes and IVFIndex (tpu_vector_db_torch/ops/ivf_scan.py,
tpu_vector_db_torch/index/ivf.py) against the JAX package's, on the same
inputs made from a seed with numpy.

On the CPU ``ivf_probe_topk`` takes its plain version, which is held
against the Pallas kernel run in interpret mode (as tests/test_ivf.py runs
it) and against the JAX XLA and gather probes. The CUDA kernel itself is
held against the plain version by the card-only tests at the end (marked
``gpu``) and by chip_smoke.py.

Tolerances: keys to 1e-4 (f32 sums in another order; bf16 and int8
operands are widened exactly); 1e-4 relative on euclidean keys, which grow
with |x|^2. Ids equal wherever the neighbouring keys are more than the
tolerance apart. Index layouts (bucket ids, free slots, spill buckets,
placement triples) are compared exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_vector_db.index.ivf import IVFIndex as JaxIVF
from tpu_vector_db.ops.ivf_scan import (ivf_probe_topk_gather as jax_gather,
                                        ivf_probe_topk_pallas,
                                        ivf_probe_topk_xla)
from tpu_vector_db.ops.quant4 import pack_int4 as jax_pack_int4

from tpu_vector_db_torch.index.ivf import IVFIndex
from tpu_vector_db_torch.ops import cuda_scan
from tpu_vector_db_torch.ops.ivf_scan import (ivf_probe_topk,
                                              ivf_probe_topk_gather,
                                              ivf_probe_topk_plain)
from tpu_vector_db_torch.ops.launches import LAUNCHES

torch.set_num_threads(1)

KEY_TOL = 1e-4


def unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def probe_inputs(seed, nb, bc, d, q_n, n_probe, dead=True):
    """Unit buckets, ids with ragged dead tails, fills, and a distinct
    bucket selection per query."""
    rng = np.random.default_rng(seed)
    buckets = unit(rng.standard_normal((nb, bc, d)).astype(np.float32))
    ids = rng.permutation(nb * bc).astype(np.int32).reshape(nb, bc)
    if dead:
        fills = rng.integers(bc // 4, bc + 1, nb).astype(np.int32)
        fills[0] = bc
        ids[np.arange(bc)[None, :] >= fills[:, None]] = -1
    fills = (ids >= 0).sum(1).astype(np.int32)
    sel = np.stack([rng.permutation(nb)[:n_probe]
                    for _ in range(q_n)]).astype(np.int32)
    q = unit(rng.standard_normal((q_n, d)).astype(np.float32))
    return buckets, ids, fills, sel, q


def assert_close_topk(got, want, tol=KEY_TOL, rel=False):
    """Keys within tol (times max(1, |key|) when rel) on the same finite
    slots, -1 ids in the empty ones; ids equal away from near-ties."""
    gk, gi = (np.asarray(t) for t in got)
    wk, wi = (np.asarray(t) for t in want)
    fin = np.isfinite(wk)
    np.testing.assert_array_equal(np.isfinite(gk), fin)
    assert np.all(gi[~fin] == -1)
    t = tol * (np.maximum(1.0, np.abs(np.where(fin, wk, 0.0))) if rel
               else 1.0)
    with np.errstate(invalid="ignore"):      # -inf - -inf in empty slots
        assert np.all(np.abs(np.where(fin, gk - wk, 0.0)) <= t)
    gap = np.full(wk.shape, np.inf)
    gap[:, 1:] = np.abs(np.diff(np.where(fin, wk, 0.0), axis=1))
    gap_next = np.full(wk.shape, np.inf)
    gap_next[:, :-1] = gap[:, 1:]
    clear = fin & (gap > t) & (gap_next > t)
    np.testing.assert_array_equal(gi[clear], wi[clear])


def to_bf16_np(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


# --------------------------------------------------------------- probes

@pytest.mark.parametrize("dtype,k", [("float32", 10), ("bfloat16", 10),
                                     ("float32", 32)])
def test_probe_matches_pallas_interpret(dtype, k):
    """The kernel's contract on the CPU (``ivf_probe_topk`` -> its plain
    version) against ``ivf_probe_topk_pallas(interpret=True)``."""
    buckets, ids, fills, sel, q = probe_inputs(1, 8, 256, 128, 3, 4)
    bj = jnp.asarray(buckets)
    bt = torch.from_numpy(buckets)
    if dtype == "bfloat16":
        bj, bt = bj.astype(jnp.bfloat16), bt.to(torch.bfloat16)
    want = ivf_probe_topk_pallas(jnp.asarray(q), bj, jnp.asarray(ids),
                                 jnp.asarray(fills), jnp.asarray(sel), k,
                                 interpret=True)
    before = dict(LAUNCHES)
    got = ivf_probe_topk(torch.from_numpy(q), bt, torch.from_numpy(ids),
                         torch.from_numpy(fills), torch.from_numpy(sel), k)
    assert LAUNCHES == before      # no kernel on the CPU
    assert_close_topk([t.numpy() for t in got], want)
    # dead slots never surface
    assert not np.isin(ids[ids < 0], got[1].numpy()).any()
    dead = np.nonzero(np.arange(256)[None, :] >= fills[:, None])
    assert not np.isin(ids[dead], got[1].numpy()[got[1].numpy() >= 0]).any()


@pytest.mark.parametrize("metric,k", [("euclidean", 5), ("cosine", 100),
                                      ("dot_product", 7)])
def test_plain_probe_matches_xla(metric, k):
    """The plain probe (counterpart of ivf_probe_topk_xla): euclidean,
    k > 32, more k than probed rows (empty slots -1)."""
    buckets, ids, fills, sel, q = probe_inputs(2, 6, 64, 32, 4, 3)
    if metric != "cosine":
        buckets = buckets * np.random.default_rng(3).uniform(
            0.5, 2.0, buckets.shape[:2] + (1,)).astype(np.float32)
    sq = np.sum(buckets * buckets, -1)
    k = min(k, 3 * 64 + 10)
    want = ivf_probe_topk_xla(jnp.asarray(q), jnp.asarray(buckets),
                              jnp.asarray(ids), jnp.asarray(sel), k,
                              metric=metric, bucket_sqnorms=jnp.asarray(sq))
    got = ivf_probe_topk_plain(torch.from_numpy(q), torch.from_numpy(buckets),
                               torch.from_numpy(ids), torch.from_numpy(sel),
                               k, metric=metric,
                               bucket_sqnorms=torch.from_numpy(sq))
    assert_close_topk([t.numpy() for t in got], want,
                      rel=metric != "cosine")


def test_plain_probe_more_k_than_rows():
    buckets, ids, fills, sel, q = probe_inputs(4, 4, 64, 32, 2, 1)
    k = 100                                   # one probe holds <= 64 rows
    want = ivf_probe_topk_xla(jnp.asarray(q), jnp.asarray(buckets),
                              jnp.asarray(ids), jnp.asarray(sel), k)
    got = ivf_probe_topk(torch.from_numpy(q), torch.from_numpy(buckets),
                         torch.from_numpy(ids), torch.from_numpy(fills),
                         torch.from_numpy(sel), 30)
    got_big = ivf_probe_topk_plain(torch.from_numpy(q),
                                   torch.from_numpy(buckets),
                                   torch.from_numpy(ids),
                                   torch.from_numpy(sel), k)
    assert_close_topk([t.numpy() for t in got_big], want)
    assert_close_topk([t.numpy() for t in got],
                      [np.asarray(t)[:, :30] for t in want])
    assert got_big[0].shape == (2, k)
    assert int(np.isfinite(got_big[0].numpy()).sum()) == int(
        fills[sel].sum())


@pytest.mark.parametrize("dtype", ["int8", "int4", "bfloat16"])
def test_gather_probe_matches_jax(dtype):
    """Gather-layout probes over the store's flat rows (int8 keys in the
    raw x127 scale, int4 with per-row scales, bf16)."""
    rng = np.random.default_rng(5)
    n, d, bc, q_n, k = 600, 128, 64, 3, 8
    x = unit(rng.standard_normal((n, d)).astype(np.float32))
    q = unit(rng.standard_normal((q_n, d)).astype(np.float32))
    nb = -(-n // bc)
    ids = np.full((nb, bc), -1, np.int32)
    ids.reshape(-1)[:n] = rng.permutation(n)
    sel = np.stack([rng.permutation(nb)[:5] for _ in range(q_n)]).astype(
        np.int32)
    scales_j = scales_t = None
    if dtype == "int8":
        rows = np.clip(np.round(x * 127.0), -127, 127).astype(np.int8)
        dbj, dbt = jnp.asarray(rows), torch.from_numpy(rows)
    elif dtype == "int4":
        packed, scales = jax_pack_int4(jnp.asarray(x))
        p, s = np.array(packed), np.array(scales)
        dbj, dbt = jnp.asarray(p), torch.from_numpy(p)
        scales_j, scales_t = jnp.asarray(s), torch.from_numpy(s)
    else:
        dbj = jnp.asarray(x).astype(jnp.bfloat16)
        dbt = torch.from_numpy(x).to(torch.bfloat16)
    want = jax_gather(jnp.asarray(q), dbj, jnp.asarray(ids),
                      jnp.asarray(sel), k, db_scales=scales_j)
    got = ivf_probe_topk_gather(torch.from_numpy(q), dbt,
                                torch.from_numpy(ids), torch.from_numpy(sel),
                                k, db_scales=scales_t)
    tol = 127 * KEY_TOL if dtype == "int8" else KEY_TOL
    assert_close_topk([t.numpy() for t in got], want, tol=tol)
    with pytest.raises(ValueError, match="cosine"):
        ivf_probe_topk_gather(torch.from_numpy(q), dbt,
                              torch.from_numpy(ids), torch.from_numpy(sel),
                              k, metric="euclidean")


def test_probe_contract_errors():
    buckets, ids, fills, sel, q = probe_inputs(6, 4, 64, 128, 2, 2)
    args = [torch.from_numpy(a) for a in (q, buckets, ids, fills, sel)]
    with pytest.raises(ValueError, match="k <= 32"):
        ivf_probe_topk(*args, 33)
    with pytest.raises(ValueError, match="f32 or bf16"):
        ivf_probe_topk(args[0], args[1].to(torch.float16), *args[2:], 5)
    with pytest.raises(ValueError, match="queries"):
        ivf_probe_topk(args[0][:, :64], *args[1:], 5)
    with pytest.raises(ValueError, match="sqnorms"):
        ivf_probe_topk(*args, 5, metric="euclidean")


# ---------------------------------------------------------------- index

def clustered(seed, n, d, centers, spread=0.05):
    """Unit rows around ``centers`` centres, laid out centre by centre
    (so the strided k-means init seeds one centroid in each), padded to a
    multiple of 128."""
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal((centers, d)).astype(np.float32)
    x = mu[np.arange(n) * centers // n] + spread * rng.standard_normal(
        (n, d)).astype(np.float32)
    x = unit(x)
    return np.pad(x, ((0, 0), (0, -(-d // 128) * 128 - d)))


def layout_of(idx):
    return (np.asarray(idx._ids), np.asarray(idx._free),
            np.asarray(idx._bucket_cluster))


def assert_same_layout(a, b):
    for x, y in zip(layout_of(a), layout_of(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_index_build_matches_jax(metric):
    """build(): the same centroids (1e-4), the same buckets and spills;
    search at partial and full probe the same as the JAX index, and the
    full probe equal to the exact flat scan."""
    n, d = 3000, 32
    x = clustered(7, n, d, 16)
    if metric == "euclidean":
        x = x * np.random.default_rng(8).uniform(0.5, 2.0, (n, 1)).astype(
            np.float32)
    sq = np.sum(x * x, -1).astype(np.float32)
    kw = dict(dim=d, metric=metric, n_clusters=16, bucket_rows=128)
    jidx, tidx = JaxIVF(**kw), IVFIndex(**kw)
    jidx.build(jnp.asarray(x), n, sqnorms=jnp.asarray(sq))
    tidx.build(torch.from_numpy(x), n, sqnorms=torch.from_numpy(sq))
    np.testing.assert_allclose(tidx._centroids, jidx._centroids, atol=1e-4,
                               rtol=1e-4)
    assert_same_layout(tidx, jidx)
    assert len(tidx._bucket_cluster) > 16            # clusters spilled
    q = x[[3, 700, 2999]] + 0.01
    nb = tidx._ids.shape[0]
    for nprobe in (3, nb):
        wi, wk = jidx.search(jnp.asarray(q), jnp.asarray(x), n, k=10,
                             nprobe=nprobe, sqnorms=jnp.asarray(sq))
        gi, gk = tidx.search(q, torch.from_numpy(x), n, k=10,
                             nprobe=nprobe, sqnorms=torch.from_numpy(sq))
        assert_close_topk((gk, gi), (wk, wi), rel=metric == "euclidean")
    fk, fi = cuda_scan.flat_topk(torch.from_numpy(q), torch.from_numpy(x),
                                 n, 10, metric=metric,
                                 db_sqnorms=torch.from_numpy(sq))
    np.testing.assert_allclose(gk, fk.numpy(), atol=KEY_TOL, rtol=KEY_TOL)
    np.testing.assert_array_equal(gi, fi.numpy())


def test_index_add_and_spill_placement_matches_jax():
    """Incremental adds from the same state place rows triple for triple
    as the JAX index does (open buckets first, then spill buckets), keep
    the device copy in step, and stay exact under a full probe."""
    n, d = 4000, 16
    x = clustered(9, n, d, 6)
    kw = dict(dim=d, metric="cosine", n_clusters=8, bucket_rows=64)
    jidx, tidx = JaxIVF(**kw), IVFIndex(**kw)
    jidx.build(jnp.asarray(x), 500)
    tidx.build(torch.from_numpy(x), 500)
    assert_same_layout(tidx, jidx)
    db = torch.from_numpy(x)
    tidx.search(x[:1], db, 500, k=5)       # materialize: adds go in place
    pos = 500
    for step in [1, 7, 64, 128, 300, 1000, 999, 1001]:
        jidx.add(jnp.asarray(x), pos, pos + step)
        tidx.add(db, pos, pos + step)
        pos += step
        assert_same_layout(tidx, jidx)
    assert tidx.size == n
    live = tidx._ids[tidx._ids >= 0]
    assert len(np.unique(live)) == n
    # the same placement for the same assignment, spills included
    jstate = [a.copy() for a in layout_of(jidx)]
    assign = np.random.default_rng(10).integers(0, 8, 700).astype(np.int32)
    rows = np.arange(n, n + 700)
    for idx in (jidx, tidx):
        idx._ids, idx._free, idx._bucket_cluster = (a.copy() for a in jstate)
        idx._open = None
    assert tidx._place_rows(assign, rows) == jidx._place_rows(assign, rows)
    assert_same_layout(tidx, jidx)
    # full probe of the in-place-updated device copy == flat
    idx = IVFIndex(**kw)
    idx.build(db, 500)
    idx.search(x[:1], db, 500, k=5)
    idx.add(db, 500, n)
    assert idx._dev is None or idx._dev_rows == n
    q = x[[3, 777, 3999]]
    gi, gk = idx.search(q, db, n, k=10, nprobe=idx._ids.shape[0])
    fk, fi = cuda_scan.flat_topk(torch.from_numpy(q), db, n, 10)
    np.testing.assert_allclose(gk, fk.numpy(), atol=KEY_TOL)
    np.testing.assert_array_equal(gi, fi.numpy())


def test_index_in_place_add_keeps_device_copy():
    """An add that fits the open buckets updates the materialized bucket
    copy in place (index_copy_), and the new row is found exactly."""
    n, d = 3000, 32
    x = clustered(11, n, d, 16)
    db = torch.from_numpy(x)
    idx = IVFIndex(dim=d, n_clusters=16, bucket_rows=512)
    idx.build(db, 2000)
    idx.search(x[:1], db, 2000, k=5)
    buckets = idx._dev["buckets"]
    idx.add(db, 2000, 2010)
    assert idx._dev is not None and idx._dev["buckets"] is buckets
    ids, keys = idx.search(x[2005:2006], db, 2010, k=1,
                           nprobe=idx._ids.shape[0])
    assert ids[0][0] == 2005 and keys[0][0] > 0.9999


def test_index_search_past_kernel_k_on_cpu():
    """k > 32 on a CPU tensor: the plain probe, as the JAX index's XLA
    probe (a CUDA index refuses such a k; see the card-only test)."""
    n, d = 2000, 32
    x = clustered(16, n, d, 8)
    kw = dict(dim=d, metric="cosine", n_clusters=8, bucket_rows=256)
    jidx, tidx = JaxIVF(**kw), IVFIndex(**kw)
    jidx.build(jnp.asarray(x), n)
    tidx.build(torch.from_numpy(x), n)
    q = x[[9, 1200]] + 0.02
    wi, wk = jidx.search(jnp.asarray(q), jnp.asarray(x), n, k=40, nprobe=3)
    before = dict(LAUNCHES)
    gi, gk = tidx.search(q, torch.from_numpy(x), n, k=40, nprobe=3)
    assert LAUNCHES == before
    assert gk.shape == (2, 40)
    assert_close_topk((gk, gi), (wk, wi))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_index_file_opens_in_the_other_package(tmp_path, writer):
    """ann_ivf.npz: the same keys and meta layout; an index saved by one
    package loads in the other and serves the same results."""
    n, d = 2000, 32
    x = clustered(12, n, d, 8)
    kw = dict(dim=d, metric="cosine", n_clusters=8, bucket_rows=256)
    src = JaxIVF(**kw) if writer == "jax" else IVFIndex(**kw)
    src.build(jnp.asarray(x) if writer == "jax" else torch.from_numpy(x), n)
    src.save(tmp_path)
    with np.load(tmp_path / "ann_ivf.npz") as z:
        assert sorted(z.files) == ["bucket_cluster", "centroids", "free",
                                   "ids", "meta"]
        assert z["meta"].tolist() == [n, 32, d, 10]
    jidx, tidx = JaxIVF(dim=d), IVFIndex(dim=d)
    assert jidx.load(tmp_path) and tidx.load(tmp_path)
    assert tidx.size == jidx.size == n
    assert_same_layout(tidx, jidx)
    np.testing.assert_array_equal(tidx._centroids, jidx._centroids)
    q = x[[5, 1500]] + 0.02
    wi, wk = jidx.search(jnp.asarray(q), jnp.asarray(x), n, k=5, nprobe=2)
    gi, gk = tidx.search(q, torch.from_numpy(x), n, k=5, nprobe=2)
    assert_close_topk((gk, gi), (wk, wi))
    assert tidx.get_stats() == jidx.get_stats()


def test_index_gather_layout_for_quantized_rows():
    n, d = 1500, 64
    x = clustered(13, n, d, 8, spread=1.0)   # no near-duplicate rows
    rows = np.clip(np.round(x * 127.0), -127, 127).astype(np.int8)
    idx = IVFIndex(dim=d, n_clusters=8, bucket_rows=256, layout="bucketized")
    idx.build(torch.from_numpy(rows), n)
    ids, keys = idx.search(x[:2], torch.from_numpy(rows), n, k=3,
                           nprobe=idx._ids.shape[0])
    st = idx.get_stats()
    assert st["layout"] == "gather" and "buckets" not in idx._dev
    assert ids[:, 0].tolist() == [0, 1]
    np.testing.assert_allclose(keys[:, 0], 127.0, atol=1.5)   # raw x127


# ------------------------------------------------------- on the card only

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,metric,q_n,n_probe,k", [
    ("float32", "cosine", 1, 1, 1),          # one probe, k = 1
    ("float32", "cosine", 3, 24, 10),        # every bucket (full probe)
    ("bfloat16", "cosine", 5, 7, 32),        # the largest k
    ("float32", "dot_product", 64, 4, 10),
    ("float32", "euclidean", 2, 5, 10),
    ("float32", "cosine", 2, 1, 32),         # k > the probed live rows
])
def test_ivf_kernel_matches_plain_on_card(dtype, metric, q_n, n_probe, k):
    """The CUDA kernel against its plain version at its edge shapes:
    empty (fill 0), full and ragged buckets, -1 slots, bf16 buckets."""
    dev = _cuda()
    nb, bc, d = 24, 96, 256
    buckets, ids, fills, sel, q = probe_inputs(14, nb, bc, d, q_n, n_probe)
    ids[3] = -1                                    # an empty bucket
    fills = (ids >= 0).sum(1).astype(np.int32)
    if q_n == 2 and n_probe == 1:
        sel[:, 0] = 5
        ids[5, 20:] = -1
        fills[5] = 20
    b = torch.from_numpy(buckets).to(dev)
    if metric != "cosine":
        b = b * torch.rand((nb, bc, 1), device=dev) * 2
    if dtype == "bfloat16":
        b = b.to(torch.bfloat16)
    sq = torch.sum(b.float() ** 2, -1)
    args = (torch.from_numpy(q).to(dev), b, torch.from_numpy(ids).to(dev),
            torch.from_numpy(fills).to(dev), torch.from_numpy(sel).to(dev),
            k)
    before = LAUNCHES["ivf_kernel"]
    got = ivf_probe_topk(*args, metric=metric, bucket_sqnorms=sq)
    torch.cuda.synchronize()
    assert LAUNCHES["ivf_kernel"] == before + 1
    want = ivf_probe_topk_plain(args[0], b, args[2], args[4], k,
                                metric=metric, bucket_sqnorms=sq,
                                bucket_fills=args[3])
    assert_close_topk([t.cpu().numpy() for t in got],
                      [t.cpu().numpy() for t in want],
                      rel=metric != "cosine")


@pytest.mark.gpu
def test_index_search_past_kernel_k_raises_on_card():
    """A bucketized index on the card serves k <= 32 through the kernel
    and refuses a wider k rather than probe with plain torch ops."""
    dev = _cuda()
    n, d = 2000, 128
    db = torch.from_numpy(clustered(17, n, d, 8)).to(dev)
    idx = IVFIndex(dim=d, n_clusters=8, bucket_rows=256)
    idx.build(db, n)
    q = db[:2].cpu().numpy()
    before = LAUNCHES["ivf_kernel"]
    ids, _ = idx.search(q, db, n, k=32, nprobe=3)
    assert LAUNCHES["ivf_kernel"] == before + 1
    assert ids[:, 0].tolist() == [0, 1]
    with pytest.raises(ValueError, match="k <= 32"):
        idx.search(q, db, n, k=33, nprobe=3)
    assert LAUNCHES["ivf_kernel"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("k,q_n", [(1025, 3), (4096, 2), (8193, 1),
                                 (8193, 64), (20000, 1), (20000, 16)])
def test_big_k_past_1024_on_card(k, q_n):
    """scan_kernel_bigk past the TPU kernel's k = 1024: the survivors are
    sorted in shared memory up to k = 16384 and in device memory past it
    (k = 20000); batch 16 and 64 score with the tile."""
    dev = _cuda()
    rng = np.random.default_rng(15)
    n, d = 60000, 128
    x = unit(rng.standard_normal((n, d)).astype(np.float32))
    q = unit(rng.standard_normal((q_n, d)).astype(np.float32))
    db, qt = torch.from_numpy(x).to(dev), torch.from_numpy(q).to(dev)
    before = LAUNCHES["scan_kernel_bigk"]
    got = cuda_scan.flat_topk(qt, db, n - 7, k)
    torch.cuda.synchronize()
    assert LAUNCHES["scan_kernel_bigk"] == before + 1
    want = cuda_scan.flat_topk_plain(qt, db, n - 7, k)
    gk, gi = (t.cpu().numpy() for t in got)
    wk, wi = (t.cpu().numpy() for t in want)
    np.testing.assert_allclose(gk, wk, atol=KEY_TOL)
    gap = np.abs(np.diff(wk, axis=1))
    clear = np.ones(wk.shape, bool)
    clear[:, 1:] &= gap > KEY_TOL
    clear[:, :-1] &= gap > KEY_TOL
    np.testing.assert_array_equal(gi[clear], wi[clear])
