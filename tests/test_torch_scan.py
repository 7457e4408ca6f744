"""The port's flat top-k (tpu_vector_db_torch/ops/cuda_scan.py) against the
JAX package's fused Pallas scan, run in interpret mode as tests/test_ops.py
runs it.

On the CPU ``flat_topk`` takes its plain version; the CUDA kernel itself is
checked against the plain version by the card-only test at the end (marked
``gpu``) and by chip_smoke.py.

Tolerances: keys to 1e-4 (f32 sums in another order; bf16/int8/int4
operands are widened exactly, so only the order differs). Ids are compared
exactly where the neighbouring keys are more than 1e-4 apart; at near-ties
every selected row's f32 ground-truth score must reach the k-th best.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_vector_db.ops.pallas_scan import pallas_flat_topk
from tpu_vector_db.ops.quant4 import pack_int4 as jax_pack_int4

from tpu_vector_db_torch.ops import cuda_scan
from tpu_vector_db_torch.ops.cuda_scan import flat_topk, flat_topk_plain
from tpu_vector_db_torch.ops.launches import LAUNCHES
from tpu_vector_db_torch.ops.quant4 import pack_int4, unpack_int4

torch.set_num_threads(1)

KEY_TOL = 1e-4


def _inputs(seed, n, d, q_n, metric, dtype):
    """Prepared (db, queries, sqnorms, scales) as numpy, the way the
    stores prepare them: cosine rows and queries unit-norm, int8/int4
    rows quantized from unit rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((q_n, d)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    sq = np.sum(x * x, axis=1) if metric == "euclidean" else None
    scales = None
    if dtype == "int8":
        x = np.clip(np.round(x * 127.0), -127, 127).astype(np.int8)
    elif dtype == "int4":
        packed, scales = jax_pack_int4(jnp.asarray(x))
        x, scales = np.array(packed), np.array(scales)
    return x, q, sq, scales


def _jax(x, q, count, k, metric, dtype, sq, mask, scales):
    db = jnp.asarray(x)
    if dtype == "bfloat16":
        db = db.astype(jnp.bfloat16)
    vals, idx = pallas_flat_topk(
        jnp.asarray(q), db, np.int32(count), k, metric=metric,
        db_sqnorms=None if sq is None else jnp.asarray(sq),
        filter_mask=None if mask is None else jnp.asarray(mask),
        db_scales=None if scales is None else jnp.asarray(scales),
        block_rows=512, interpret=True)
    return np.asarray(vals), np.asarray(idx)


def _torch(x, q, count, k, metric, dtype, sq, mask, scales):
    db = torch.from_numpy(x)
    if dtype == "bfloat16":
        db = db.to(torch.bfloat16)
    keys, ids = flat_topk(
        torch.from_numpy(q), db, count, k, metric=metric,
        db_sqnorms=None if sq is None else torch.from_numpy(sq),
        filter_mask=None if mask is None else torch.from_numpy(mask),
        db_scales=None if scales is None else torch.from_numpy(scales))
    return keys.numpy(), ids.numpy()


def _ground_truth(x, q, dtype, scales, metric, count, mask, sq=None,
                  q_sq=None):
    """f32 keys of every row (dequantized for int8/int4), -inf where the
    row is not live. Euclidean keys use the given row sqnorms and query
    sqnorms, as the kernels do."""
    if dtype == "int4":
        rows = unpack_int4(torch.from_numpy(x), torch.from_numpy(scales))
        rows = rows.numpy()
    elif dtype == "int8":
        rows = x.astype(np.float32)
    else:
        rows = x.astype(np.float32)
    keys = q @ rows.T
    if metric == "euclidean":
        keys = 2 * keys - sq[None, :] - q_sq[:, None]
    live = np.arange(rows.shape[0]) < count
    if mask is not None:
        live &= mask > 0.5
    return np.where(live[None, :], keys, -np.inf)


def assert_close_topk(got, want, key_tol):
    """Keys within key_tol on the same finite slots; ids equal wherever
    both neighbouring keys are more than key_tol away."""
    gk, gi = got
    wk, wi = want
    fin = np.isfinite(wk)
    np.testing.assert_array_equal(np.isfinite(gk), fin)
    np.testing.assert_allclose(gk[fin], wk[fin], atol=key_tol, rtol=0)
    gap = np.full(wk.shape, np.inf)
    gap[:, 1:] = np.abs(np.diff(np.where(fin, wk, 0.0), axis=1))
    gap_next = np.full(wk.shape, np.inf)
    gap_next[:, :-1] = gap[:, 1:]
    clear = fin & (gap > key_tol) & (gap_next > key_tol)
    np.testing.assert_array_equal(gi[clear], wi[clear])


def assert_same_topk(got, want, gt, k, key_tol=KEY_TOL):
    """``assert_close_topk``, and every selected id reaches the
    ground-truth k-th best within key_tol."""
    assert_close_topk(got, want, key_tol)
    gi = got[1]
    fin = np.isfinite(want[0])
    kth = np.sort(gt, axis=1)[:, -k]
    for r in range(gt.shape[0]):
        sel = gt[r, gi[r][fin[r]]]
        assert np.all(sel >= kth[r] - key_tol), (sel.min(), kth[r])


CASES = [
    # (metric, dtype)
    ("cosine", "float32"),
    ("euclidean", "float32"),
    ("dot_product", "float32"),
    ("cosine", "bfloat16"),
    ("euclidean", "bfloat16"),
    ("dot_product", "bfloat16"),
    ("cosine", "int8"),
    ("cosine", "int4"),
]


@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric,dtype", CASES)
def test_plain_matches_pallas(metric, dtype, masked, k):
    n, q_n = 2048, 4
    d = 256 if dtype == "int4" else 64
    count = 1900   # count < N: the tail rows never appear
    x, q, sq, scales = _inputs(CASES.index((metric, dtype)), n, d, q_n,
                               metric, dtype)
    mask = None
    if masked:
        mask = (np.random.default_rng(1).random(n) < 0.3).astype(np.float32)
    args = (x, q, count, k, metric, dtype, sq, mask, scales)
    want = _jax(*args)
    got = _torch(*args)
    # the ground truth scores bf16-rounded queries where the kernels do
    q_gt = q if dtype == "float32" else np.asarray(
        torch.from_numpy(q).to(torch.bfloat16).float())
    x_gt = (np.asarray(torch.from_numpy(x).to(torch.bfloat16).float())
            if dtype == "bfloat16" else x)
    gt = _ground_truth(x_gt, q_gt, dtype, scales, metric, count, mask,
                       sq, np.sum(q * q, axis=1))
    # euclidean keys are O(d): the same relative f32 error is larger
    tol = KEY_TOL * (2 * d if metric != "cosine" and dtype != "float32"
                     else (d if metric != "cosine" else 1))
    assert_same_topk(got, want, gt, k, key_tol=tol)
    if masked:
        live = np.isfinite(got[0])
        assert np.all(mask[got[1][live]] > 0.5)
    assert np.all(got[1][np.isfinite(got[0])] < count)


def test_fewer_live_rows_than_k():
    """Slots past the live rows hold -inf with id 0, as the TPU kernel
    leaves them."""
    x, q, _, _ = _inputs(3, 1024, 128, 2, "cosine", "float32")
    keys, ids = _torch(x, q, 5, 10, "cosine", "float32", None, None, None)
    wk, wi = _jax(x, q, 5, 10, "cosine", "float32", None, None, None)
    assert np.isfinite(keys).sum(axis=1).tolist() == [5, 5]
    assert np.all(ids[~np.isfinite(keys)] == 0)
    np.testing.assert_array_equal(np.isfinite(keys), np.isfinite(wk))
    np.testing.assert_array_equal(ids[np.isfinite(keys)],
                                  wi[np.isfinite(wk)])


def test_ties_break_by_lower_id():
    """Identical rows tie exactly (small integers: every sum is exact in
    f32): the lower id comes first in both contracts (key descending,
    then id ascending). The JAX k <= 32 kernel gives the same order; its
    big-k kernel returns the same tied ids in another order inside one
    block (its bitonic network is not stable), so there only the set is
    compared."""
    rng = np.random.default_rng(4)
    x = rng.integers(-3, 4, (512, 64)).astype(np.float32)
    x[[40, 7, 300]] = x[100]
    q = x[100:101] * 3.0
    for k in (10, 40):
        keys, ids = flat_topk(torch.from_numpy(q), torch.from_numpy(x), 512,
                              k, metric="dot_product")
        assert ids[0, :4].tolist() == [7, 40, 100, 300]
        wk, wi = _jax(x, q, 512, k, "dot_product", "float32", None, None,
                      None)
        np.testing.assert_array_equal(keys.numpy(), wk)
        if k <= cuda_scan.MAX_K_SMALL:
            np.testing.assert_array_equal(ids.numpy(), wi)
        else:
            assert sorted(wi[0, :4].tolist()) == [7, 40, 100, 300]


def test_adversarial_order_big_k():
    """All true winners packed into one region in descending strength
    (tests/test_ops.py's adversarial case) through the big-k contract.

    Each euclidean key is ``2q.x - ||x||^2 - ||q||^2``: terms of the size
    of ||q||^2 (~119 here) that cancel, exactly so for row 256 + 99
    (which is q itself, true key 0). Summed in another order, f32 leaves
    noise of that scale behind, so keys are compared with an absolute
    tolerance of KEY_TOL * d, as ``test_plain_matches_pallas`` does for
    euclidean keys, and not relatively. Rows 256 + 99 +- m tie exactly and
    the 0.01-noise rows all sit near -||q||^2, so ids are compared away
    from near-ties and every selected row must reach the f32 ground
    truth's k-th best."""
    rng = np.random.default_rng(5)
    n, d, k = 2048, 128, 64
    x = rng.standard_normal((n, d)).astype(np.float32) * 0.01
    q = rng.standard_normal((1, d)).astype(np.float32)
    for j in range(128):
        x[256 + j] = q[0] * (100.0 - j)
    sq = np.sum(x * x, axis=1)
    want = _jax(x, q, n, k, "euclidean", "float32", sq, None, None)
    got = _torch(x, q, n, k, "euclidean", "float32", sq, None, None)
    gt = _ground_truth(x, q, "float32", None, "euclidean", n, None, sq,
                       np.sum(q * q, axis=1))
    assert_same_topk(got, want, gt, k, key_tol=KEY_TOL * d)
    # the winner, q itself, and its exact ties come first, in id order
    assert got[1][0, 0] == 256 + 99


def test_int4_plain_keys_are_dequantized_scores():
    """int4 keys == f32 scores of the dequantized rows against the
    bf16-rounded queries, packed bytes identical to the JAX packer."""
    x, q, _, _ = _inputs(6, 1024, 256, 3, "cosine", "float32")
    packed, scales = pack_int4(torch.from_numpy(x))
    jp, js = jax_pack_int4(jnp.asarray(x))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
    keys, ids = flat_topk_plain(torch.from_numpy(q), packed, 1024, 10,
                                db_scales=scales)
    deq = unpack_int4(packed, scales).numpy()
    qb = torch.from_numpy(q).to(torch.bfloat16).float().numpy()
    want = np.take_along_axis(qb @ deq.T, ids.numpy().astype(np.int64), 1)
    np.testing.assert_allclose(keys.numpy(), want, atol=KEY_TOL)


def test_wrapper_routes_cpu_tensors_to_plain():
    x, q, _, _ = _inputs(7, 2048, 64, 4, "cosine", "float32")
    before = dict(LAUNCHES)
    a = flat_topk(torch.from_numpy(q), torch.from_numpy(x), 2000, 10)
    b = flat_topk_plain(torch.from_numpy(q), torch.from_numpy(x), 2000, 10)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert LAUNCHES == before   # no kernel launched on the CPU


@pytest.mark.parametrize("block_rows", [100, 512, 4096])
def test_plain_is_independent_of_block(block_rows):
    x, q, sq, _ = _inputs(8, 2048, 64, 4, "euclidean", "float32")
    args = (torch.from_numpy(q), torch.from_numpy(x), 2000, 100,
            "euclidean", torch.from_numpy(sq))
    a = flat_topk_plain(*args, block_rows=block_rows)
    b = flat_topk_plain(*args, block_rows=2048)
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), atol=1e-5)
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())


def test_contract_errors():
    q = torch.zeros((1, 128))
    with pytest.raises(ValueError, match="k >= 1"):
        flat_topk(q, torch.zeros((512, 128)), 10, 0)
    with pytest.raises(ValueError, match="256"):
        flat_topk(q, torch.zeros((512, 64), dtype=torch.uint8), 10, 5,
                  db_scales=torch.ones(512))
    with pytest.raises(ValueError, match="scales"):
        flat_topk(torch.zeros((1, 256)), torch.zeros((512, 256)), 10, 5,
                  db_scales=torch.ones(512))
    with pytest.raises(ValueError, match="queries"):
        flat_topk(torch.zeros((1, 64)), torch.zeros((512, 128)), 10, 5)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_kernel_matches_plain_on_card(dtype, k):
    """The CUDA kernel against its plain version on the card (runs where
    a CUDA device is present; chip_smoke.py does the same at 1M rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    d = 256
    x, q, _, scales = _inputs(9, 20000, d, 5, "cosine", dtype)
    db = torch.from_numpy(x).cuda()
    if dtype == "bfloat16":
        db = db.to(torch.bfloat16)
    scl = None if scales is None else torch.from_numpy(scales).cuda()
    mask = torch.from_numpy(
        (np.random.default_rng(2).random(20000) < 0.5).astype(np.float32))
    # batch 1 takes the row loop for every type, batch 5 the tile for the
    # tensor-core types (TILE_MIN_Q)
    for fm, q_n in ((None, 5), (mask.cuda(), 5), (mask.cuda(), 1)):
        qt = torch.from_numpy(q[:q_n]).cuda()
        got = flat_topk(qt, db, 19000, k, db_scales=scl, filter_mask=fm)
        want = flat_topk_plain(qt, db, 19000, k, db_scales=scl,
                               filter_mask=fm)
        torch.cuda.synchronize()
        # ids equal away from near-ties: sums in another order can swap
        # two rows whose keys are within the tolerance
        assert_close_topk([t.cpu().numpy() for t in got],
                          [t.cpu().numpy() for t in want], KEY_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("metric,q_n,count,k", [
    ("cosine", 3, 5, 10),            # fewer live rows than k
    ("cosine", 1, 5, 100),
    ("cosine", 2, 0, 10),            # no live row
    ("euclidean", 17, 30000, 1),     # k = 1, a ragged query tile
    ("dot_product", 9, 30000, 1024),  # the largest k
    ("cosine", 64, 5, 10),           # tile: fewer live rows than k
    ("cosine", 16, 0, 10),           # tile: no live row
    ("cosine", 100, 30000, 32),      # tile: k = 32, two query tiles
])
def test_kernel_edge_shapes_on_card(metric, q_n, count, k):
    """Edge shapes of the CUDA kernel against its plain version: slots past
    the live rows hold -inf with id 0, ids agree away from near-ties."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    d = 128
    x, q, sq, _ = _inputs(10, 30000, d, q_n, metric, "float32")
    args = (torch.from_numpy(q).cuda(), torch.from_numpy(x).cuda(), count, k)
    kw = dict(metric=metric,
              db_sqnorms=None if sq is None else torch.from_numpy(sq).cuda())
    got = [t.cpu().numpy() for t in flat_topk(*args, **kw)]
    want = [t.cpu().numpy() for t in flat_topk_plain(*args, **kw)]
    fin = np.isfinite(want[0])
    assert fin.sum(axis=1).tolist() == [min(count, k)] * q_n
    assert np.all(got[1][~fin] == 0)
    # un-normalized rows: keys are O(d), so is their f32 rounding
    assert_close_topk(got, want, KEY_TOL * (1 if metric == "cosine" else d))


TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8, "int4": torch.uint8}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
@pytest.mark.parametrize("q_n", [1, 8, 16, 64, 100])
def test_launch_plan(q_n, dtype):
    """The wrapper's choice of design: the row loop below TILE_MIN_Q
    queries of the row type (batch 1 always), the tile from it (f32 in
    tiles of 16/32/64 queries, the tensor-core types in tiles of 64), each
    block of a tile launch writing one candidate list per query, and
    splits that cover the rows once."""
    tdt = TORCH_DTYPES[dtype]
    count, n_sm = 1_000_000, 132
    plan = cuda_scan._launch_plan(q_n, tdt, 768, 10, count, n_sm)
    tiles = -(-q_n // plan.qt)
    assert plan.splits * plan.rows_per_split >= count
    assert (plan.splits - 1) * plan.rows_per_split < count
    assert cuda_scan.TILE_MIN_Q[tdt] > 1
    if q_n < cuda_scan.TILE_MIN_Q[tdt]:
        assert plan.design == "loop"
        assert plan.qt == min(8, max(1, 1 << (2 * q_n - 1).bit_length() - 1))
        # each warp of a block keeps its own list per query
        assert plan.n_lists == plan.splits * 8
    else:
        assert plan.design == "tile"
        want_qt = (64 if dtype != "float32"
                   else {16: 16, 64: 64, 100: 64}[q_n])
        # the f32 tile takes over where the loop would read the rows twice
        assert dtype != "float32" or q_n > 8
        assert plan.qt == want_qt
        assert plan.rows_per_split % 256 == 0   # whole row tiles
        # one block per SM: the query tiles times the splits fill the card
        # (less the splits that rounding to whole row tiles takes away)
        assert n_sm - 2 * tiles < tiles * plan.splits <= n_sm
        assert plan.n_lists == plan.splits
    # k > 32 takes the big-k kernel at every batch
    assert cuda_scan._launch_plan(q_n, tdt, 768, 100, count,
                                  n_sm).design == "big"


@pytest.mark.parametrize("count", [0, 5, 300, 20000])
def test_launch_plan_small_counts(count):
    """Ragged and empty counts still launch at least one block whose
    splits cover the rows once."""
    plan = cuda_scan._launch_plan(64, torch.float32, 256, 10, count)
    assert plan.design == "tile" and plan.splits >= 1
    assert plan.splits * plan.rows_per_split >= count
    assert (plan.splits - 1) * plan.rows_per_split < max(count, 1)


def _card_db(x, dtype):
    db = torch.from_numpy(x).cuda()
    return db.to(torch.bfloat16) if dtype == "bfloat16" else db


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("q_n", [16, 64, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_tile_matches_plain_on_card(dtype, q_n, metric):
    """The tile design (scan_small_k_tile) against the plain version on
    the card, unmasked and masked, at a count that ends inside a row tile
    and a split. Unit rows and queries: keys are O(1), so KEY_TOL holds
    for f32 sums in another order (tensor cores sum bf16 products, exact
    in f32, in their own order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    n, d, count = 20000, 256, 19000 - 7
    x, q, _, scales = _inputs(11, n, d, q_n, "cosine", dtype)
    db = _card_db(x, dtype)
    assert cuda_scan._launch_plan(q_n, db.dtype, d, 10, count).design \
        == "tile"
    scl = None if scales is None else torch.from_numpy(scales).cuda()
    sq = None
    if metric == "euclidean":
        sq = torch.from_numpy(np.random.default_rng(3).uniform(
            0.5, 1.5, n).astype(np.float32)).cuda()
    mask = torch.from_numpy(
        (np.random.default_rng(2).random(n) < 0.5).astype(np.float32))
    qt = torch.from_numpy(q).cuda()
    for fm in (None, mask.cuda()):
        kw = dict(metric=metric, db_sqnorms=sq, filter_mask=fm,
                  db_scales=scl)
        got = flat_topk(qt, db, count, 10, **kw)
        want = flat_topk_plain(qt, db, count, 10, **kw)
        torch.cuda.synchronize()
        got = [t.cpu().numpy() for t in got]
        assert_close_topk(got, [t.cpu().numpy() for t in want], KEY_TOL)
        assert np.all(got[1] < count)
        if fm is not None:
            assert np.all(mask.numpy()[got[1]] > 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_tile_ties_across_tiles_and_splits_on_card(dtype):
    """Identical rows inside one row tile, across a row-tile boundary and
    across a split boundary come back lower id first. Small integers:
    every sum is exact in f32 and every value in bf16, so the ties are
    exact on every path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    n, d, q_n = n_sm * 512, 64, 16
    plan = cuda_scan._launch_plan(q_n, TORCH_DTYPES[dtype], d, 10, n, n_sm)
    rps = plan.rows_per_split
    assert plan.design == "tile" and rps % 256 == 0 and plan.splits > 1
    rng = np.random.default_rng(12)
    x = rng.integers(-3, 4, (n, d)).astype(np.float32)
    src = 1000
    ties = sorted({3, 4, 255, 256, rps - 1, rps, rps + 1, n - 1, src})
    x[ties] = x[src]
    x = x.astype(np.int8) if dtype == "int8" else x
    q = np.repeat(x[src:src + 1].astype(np.float32) * 2.0, q_n, axis=0)
    keys, ids = flat_topk(torch.from_numpy(q).cuda(), _card_db(x, dtype), n,
                          10, metric="dot_product")
    ids = ids.cpu().numpy()
    assert np.all(ids[:, :len(ties)] == np.array(ties)[None, :]), ids[0]
    assert np.all(keys.cpu().numpy()[:, :len(ties)]
                  == 2.0 * np.sum(x[src].astype(np.float32) ** 2))
