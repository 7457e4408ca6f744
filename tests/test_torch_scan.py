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
@pytest.mark.parametrize("k", [10, 40, 64, 100])
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
    # k > 32 takes the big-k kernel at every batch: the same scoring
    # design, and 1M rows fit one chunk of the key scratch at these batches
    big = cuda_scan._launch_plan(q_n, tdt, 768, 100, count, n_sm)
    assert cuda_scan.kernel_name(100) == "scan_kernel_bigk"
    assert big.design == plan.design and big.qt == plan.qt
    assert big.chunk_rows >= count and big.n_lists == 1


@pytest.mark.parametrize("count", [0, 5, 300, 20000])
def test_launch_plan_small_counts(count):
    """Ragged and empty counts still launch at least one block whose
    splits cover the rows once."""
    plan = cuda_scan._launch_plan(64, torch.float32, 256, 10, count)
    assert plan.design == "tile" and plan.splits >= 1
    assert plan.splits * plan.rows_per_split >= count
    assert (plan.splits - 1) * plan.rows_per_split < max(count, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
@pytest.mark.parametrize("q_n", [1, 2, 5, 8, 9, 64, 100])
def test_launch_plan_big_k_scoring(q_n, dtype):
    """k > 32 scores with the row loop below TILE_MIN_Q queries of the row
    type and with the tile from it, as k <= 32 does; the loop's splits are
    whole row tiles, so its keys go out in 16-byte runs."""
    tdt = TORCH_DTYPES[dtype]
    count = 1_000_000
    plan = cuda_scan._launch_plan(q_n, tdt, 768, 100, count)
    want = "tile" if q_n >= cuda_scan.TILE_MIN_Q[tdt] else "loop"
    assert plan.design == want
    assert plan.design == cuda_scan._launch_plan(q_n, tdt, 768, 10,
                                                 count).design
    assert plan.rows_per_split % 256 == 0
    assert plan.splits * plan.rows_per_split >= count
    assert (plan.splits - 1) * plan.rows_per_split < count
    assert plan.n_lists == 1 and plan.chunk_rows >= count


@pytest.mark.parametrize("budget", [1 << 20, 64 << 20,
                                    cuda_scan.KEY_SCRATCH_BYTES])
@pytest.mark.parametrize("q_n,count", [(1, 0), (1, 5), (3, 300_000),
                                       (64, 1_000_000), (100, 999_999),
                                       (1024, 1_000_000)])
def test_launch_plan_big_k_chunks(q_n, count, budget):
    """k > 32: chunks of whole row tiles cover the rows once, each chunk's
    key scratch (q_n x chunk_rows f32) stays within the budget, there is
    one candidate list per chunk, and one launch's splits cover a chunk."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = cuda_scan._launch_plan(q_n, dtype, 768, 1025, count,
                                      budget=budget)
        chunk = plan.chunk_rows
        assert chunk % 256 == 0 and chunk >= 256
        assert q_n * chunk * 4 <= max(budget, q_n * 256 * 4)
        n_chunks = max(1, -(-count // chunk))
        assert plan.n_lists == n_chunks
        assert (n_chunks - 1) * chunk < max(count, 1) <= n_chunks * chunk
        assert plan.splits * plan.rows_per_split >= min(count, chunk)
        assert plan.rows_per_split % 4 == 0
    # the budget the module states keeps 1M rows in one chunk at batch 64
    assert cuda_scan._launch_plan(64, torch.float32, 768, 100,
                                  1_000_000).n_lists == 1


@pytest.mark.parametrize("k", [33, 40, 64])
def test_launch_plan_lists_up_to_64_on_the_tile(k):
    """32 < k <= MAX_K_LISTS on the tile (the capacity cell's scan: 64
    queries, 8,388,608 int8 rows of 768): the scan keeps lists, one a
    block per query, in one launch over every row, with no key scratch;
    the launch is still counted as scan_kernel_bigk."""
    plan = cuda_scan._launch_plan(64, torch.int8, 768, k, 8_388_608)
    assert plan.design == "tile" and plan.chunk_rows == 0
    assert plan.n_lists == plan.splits == 132
    assert plan.splits * plan.rows_per_split >= 8_388_608
    assert cuda_scan.kernel_name(k) == "scan_kernel_bigk"
    assert cuda_scan.MAX_K_LISTS == 64


@pytest.mark.parametrize("q_n,k", [(64, 65), (64, 100), (1, 40)])
def test_launch_plan_key_scratch_past_the_lists(q_n, k):
    """Past MAX_K_LISTS on the tile, and any k > 32 on the row loop
    (batch 1), the keys go to the key scratch in chunks, as before: at
    8,388,608 int8 rows of 768 and batch 64, four chunks."""
    plan = cuda_scan._launch_plan(q_n, torch.int8, 768, k, 8_388_608)
    assert plan.design == ("tile" if q_n == 64 else "loop")
    assert plan.chunk_rows > 0
    assert q_n * plan.chunk_rows * 4 <= cuda_scan.KEY_SCRATCH_BYTES
    assert plan.n_lists == -(-8_388_608 // plan.chunk_rows)
    assert plan.n_lists == (4 if q_n == 64 else 1)
    assert cuda_scan.kernel_name(40) == "scan_kernel_bigk"


class _FakeLib:
    """Stands in for the built library: records the calls of the C
    interface, launches nothing."""

    def __init__(self):
        self.calls = []

    def vdb_flat_scratch_bytes(self, q_n, k, count, chunk_rows):
        # the key scratch path's; the lists' merges need none
        return 1024 if k > cuda_scan.MAX_K_SMALL and chunk_rows else 0

    def vdb_flat_topk(self, *args):
        self.calls.append(args)
        return 0


def _fake_card(monkeypatch):
    """The wrapper's calls into CUDA, stood in for: a ``_FakeLib`` as the
    built library, returned."""
    fake = _FakeLib()
    monkeypatch.setattr(cuda_scan.LIBRARY, "lib", fake)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d: (9, 0))
    monkeypatch.setattr(torch.cuda, "device", lambda d: __import__(
        "contextlib").nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())
    return fake


@pytest.mark.parametrize("k,budget", [(10, cuda_scan.KEY_SCRATCH_BYTES),
                                      (100, cuda_scan.KEY_SCRATCH_BYTES),
                                      (100, 4 * 4096 * 4),
                                      (40, cuda_scan.KEY_SCRATCH_BYTES)])
def test_launch_plan_one_launch_per_call(monkeypatch, k, budget):
    """One call of the C interface and one recorded launch per flat_topk
    call, whether k > 32 goes in one chunk or in several (a budget of 4096
    rows a query forces 3 chunks over 10000 rows) or in the tile's lists
    (k = 40 at batch 64); the call carries the plan's chunking and, with
    several chunks or lists, candidate lists for the merge."""
    fake = _fake_card(monkeypatch)
    lists = cuda_scan.MAX_K_SMALL < k <= cuda_scan.MAX_K_LISTS
    q_n = 64 if lists else 4    # the lists are the tile design's
    x, q, _, _ = _inputs(13, 10000, 64, q_n, "cosine", "float32")
    plan = cuda_scan._launch_plan(q_n, torch.float32, 64, k, 10000,
                                  budget=budget)
    name = cuda_scan.kernel_name(k)
    before = LAUNCHES[name]
    cuda_scan._launch(torch.from_numpy(q), torch.from_numpy(x), 64, 10000, k,
                      "cosine", None, None, None, plan)
    assert LAUNCHES[name] == before + 1
    assert len(fake.calls) == 1
    args = fake.calls[0]
    assert args[17:19] == (plan.n_lists, plan.chunk_rows)
    if lists:
        assert plan.design == "tile" and plan.chunk_rows == 0
        assert args[14] == 1 and plan.n_lists == plan.splits > 1
        assert args[19] is not None and args[20] is not None
        assert args[23] is None                             # no scratch
    elif k > cuda_scan.MAX_K_SMALL:
        assert plan.n_lists == (3 if budget < (1 << 20) else 1)
        assert (args[19] is None) == (plan.n_lists == 1)   # candidate lists
        assert args[23] is not None                         # scratch
    else:
        assert plan.chunk_rows == 0 and args[19] is not None


@pytest.mark.parametrize("k,select", [(40, "lists"), (100, "radix"),
                                      (10, None)])
def test_scan_span_carries_the_select(monkeypatch, k, select):
    """With the tracer on, a k > 32 launch says on the caller's span
    (``store.scan``) how it selected: ``lists`` for k = 40 at batch 64 (the
    tile's lists), ``radix`` for k = 100 (the key scratch); k <= 32 says
    nothing. ``chunks`` stays only where there are chunks."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_vector_db_torch.monitoring import tracing
    _fake_card(monkeypatch)
    x, q, _, _ = _inputs(14, 10000, 64, 64, "cosine", "float32")
    plan = cuda_scan._launch_plan(64, torch.float32, 64, k, 10000)
    tracing.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with tracing.span("store.scan", k=k):
                cuda_scan._launch(torch.from_numpy(q), torch.from_numpy(x),
                                  64, 10000, k, "cosine", None, None, None,
                                  plan)
        (scan,) = tracing.spans()
    finally:
        tracing.reset()
    assert scan["attrs"].get("select") == select
    assert scan["attrs"].get("chunks") == (1 if select == "radix" else None)


def _card_db(x, dtype):
    db = torch.from_numpy(x).cuda()
    return db.to(torch.bfloat16) if dtype == "bfloat16" else db


@pytest.mark.gpu
@pytest.mark.parametrize("k", [10, 40, 64])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("q_n", [16, 64, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_tile_matches_plain_on_card(dtype, q_n, metric, k):
    """The tile design (scan_small_k_tile) against the plain version on
    the card, unmasked and masked, at a count that ends inside a row tile
    and a split; its lists of one entry a lane (k = 10) and of two (k = 40,
    64). Unit rows and queries: keys are O(1), so KEY_TOL holds for f32
    sums in another order (tensor cores sum bf16 products, exact in f32,
    in their own order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    n, d, count = 20000, 256, 19000 - 7
    x, q, _, scales = _inputs(11, n, d, q_n, "cosine", dtype)
    db = _card_db(x, dtype)
    plan = cuda_scan._launch_plan(q_n, db.dtype, d, k, count)
    assert plan.design == "tile" and plan.chunk_rows == 0
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
        got = flat_topk(qt, db, count, k, **kw)
        want = flat_topk_plain(qt, db, count, k, **kw)
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


# ---- k > 32 on the card: tile or loop scoring + the radix select ----

def _on_card(fn, *args, **kw):
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return [t.cpu().numpy() for t in out]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("k", [33, 100, 1025])
@pytest.mark.parametrize("q_n", [1, 5, 64, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_big_k_matches_plain_on_card(dtype, q_n, k):
    """scan_kernel_bigk against the plain version: every type, batch 1 and
    5 (the row loop for f32, the tile for the tensor-core types from 2), 64
    and 100 (two query tiles), unmasked and masked, at a count that ends
    inside a row tile; one launch per call."""
    _need_card()
    n, d, count = 20000, 256, 19000 - 7
    x, q, _, scales = _inputs(16, n, d, q_n, "cosine", dtype)
    db = _card_db(x, dtype)
    scl = None if scales is None else torch.from_numpy(scales).cuda()
    mask = torch.from_numpy(
        (np.random.default_rng(2).random(n) < 0.5).astype(np.float32))
    qt = torch.from_numpy(q).cuda()
    for fm in (None, mask.cuda()):
        kw = dict(db_scales=scl, filter_mask=fm)
        before = LAUNCHES["scan_kernel_bigk"]
        got = _on_card(flat_topk, qt, db, count, k, **kw)
        assert LAUNCHES["scan_kernel_bigk"] == before + 1
        want = _on_card(flat_topk_plain, qt, db, count, k, **kw)
        assert_close_topk(got, want, KEY_TOL)
        assert np.all(got[1] < count)
        if fm is not None:
            assert np.all(mask.numpy()[got[1]] > 0.5)


def _chunked(q, db, count, k, budget, **kw):
    """flat_topk through a plan whose key-scratch budget forces chunks."""
    d_pad = q.shape[1]
    plan = cuda_scan._launch_plan(q.shape[0], db.dtype, d_pad, k, count,
                                  budget=budget)
    metric = kw.get("metric", "cosine")
    keys, ids = cuda_scan._launch(q, db, d_pad, count, k, metric,
                                  kw.get("db_sqnorms"), kw.get("filter_mask"),
                                  kw.get("db_scales"), plan)
    return cuda_scan._finish(keys, ids, q, metric), plan


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("q_n", [1, 16])
@pytest.mark.parametrize("chunks", [False, True])
def test_big_k_ties_straddle_kth_on_card(dtype, q_n, chunks):
    """3000 identical rows spread over every split (and, with ``chunks``,
    over 5 chunks of the key scratch), with the k-th key inside the block
    of ties: the keys above it come first, then the lowest tied ids in
    rising order. Small integers: every sum is exact in f32 and every
    value in bf16, so the ties are exact on every path."""
    _need_card()
    n, d = 40000, 64
    rng = np.random.default_rng(17)
    x = rng.integers(-3, 4, (n, d)).astype(np.float32)
    src = 12345
    ties = np.sort(rng.choice(n, 3000, replace=False))
    x[ties] = x[src]
    ties = np.union1d(ties, [src])
    q = np.repeat(x[src:src + 1] * 2.0, q_n, axis=0)
    exact = x.astype(np.float64) @ q[0].astype(np.float64)
    tie_key = exact[src]
    above = int(np.sum(exact > tie_key))
    tied = np.flatnonzero(exact == tie_key)       # ties plus any equal row
    k = above + 1500
    assert len(tied) > 1500
    db = _card_db(x.astype(np.int8) if dtype == "int8" else x, dtype)
    qt = torch.from_numpy(q).cuda()
    if chunks:
        got, plan = _chunked(qt, db, n, k, budget=q_n * 8192 * 4,
                             metric="dot_product")
        assert plan.n_lists == 5
        got = [t.cpu().numpy() for t in got]
    else:
        got = _on_card(flat_topk, qt, db, n, k, metric="dot_product")
    keys, ids = got
    assert np.all(keys[:, above:] == tie_key)
    assert np.all(ids[:, above:] == tied[None, :1500]), ids[0, above:above + 8]
    for r in range(q_n):
        assert set(ids[r, :above]) == set(np.flatnonzero(exact > tie_key))


@pytest.mark.gpu
@pytest.mark.parametrize("q_n", [1, 4])
def test_big_k_signed_zero_tie_on_card(q_n):
    """Keys -0.0 and +0.0 tie and are ordered by id: int4 rows whose
    nibbles are all 8 score (s - 8 sum q) * scale = +-0.0 by the sign of
    their scale. The k-th key lies among the zeros."""
    _need_card()
    n, d = 4096, 256
    rng = np.random.default_rng(18)
    nib = rng.integers(0, 16, (n, d))
    nib[1000:3000] = 8
    scales = rng.uniform(0.5, 1.5, n).astype(np.float32)
    scales[1000:3000] = np.where(np.arange(2000) % 2 == 0, 1.0, -1.0)
    packed = (nib[:, :d // 2] | (nib[:, d // 2:] << 4)).astype(np.uint8)
    q = np.repeat(rng.choice([-1.0, 1.0], (1, d)), q_n, axis=0).astype(
        np.float32)
    exact = ((nib - 8).astype(np.float64) @ q[0].astype(np.float64)) \
        * scales.astype(np.float64)
    above = int(np.sum(exact > 0))
    zeros = np.flatnonzero(exact == 0)
    k = above + 500
    keys, ids = _on_card(flat_topk, torch.from_numpy(q).cuda(),
                         torch.from_numpy(packed).cuda(), n, k,
                         db_scales=torch.from_numpy(scales).cuda())
    assert np.all(keys[:, above:] == 0.0)
    assert np.all(ids[:, above:] == zeros[None, :500]), ids[0, above:above + 8]


@pytest.mark.gpu
@pytest.mark.parametrize("q_n", [1, 16])
@pytest.mark.parametrize("case", ["count0", "count_lt_k", "mask_lt_k"])
def test_big_k_fewer_live_rows_than_k_on_card(case, q_n):
    """Fewer live rows than k (no live row, count < k, a mask that leaves
    fewer than k rows): the live rows first, in order, then -inf with id
    0, for the row loop (batch 1) and the tile (batch 16)."""
    _need_card()
    n, d, k = 30000, 128, 100
    x, q, _, _ = _inputs(19, n, d, q_n, "cosine", "float32")
    count, mask = n, None
    if case == "count0":
        count = 0
    elif case == "count_lt_k":
        count = 37
    else:
        m = np.zeros(n, np.float32)
        m[np.random.default_rng(3).choice(n, 60, replace=False)] = 1.0
        mask = torch.from_numpy(m).cuda()
    args = (torch.from_numpy(q).cuda(), torch.from_numpy(x).cuda(), count, k)
    got = _on_card(flat_topk, *args, filter_mask=mask)
    want = _on_card(flat_topk_plain, *args, filter_mask=mask)
    live = {"count0": 0, "count_lt_k": 37, "mask_lt_k": 60}[case]
    fin = np.isfinite(got[0])
    assert fin.sum(axis=1).tolist() == [live] * q_n
    assert np.all(fin[:, :live]) and np.all(got[1][~fin] == 0)
    assert_close_topk(got, want, KEY_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,metric,q_n,k", [
    ("float32", "cosine", 1, 100),
    ("float32", "euclidean", 64, 100),
    ("bfloat16", "cosine", 64, 1025),
    ("int4", "cosine", 3, 65),           # the tile past its lists
    ("float32", "cosine", 2, 8193),       # several chunks, merge in device memory
])
def test_big_k_several_chunks_on_card(dtype, metric, q_n, k):
    """A call whose key scratch is cut into chunks (through the plan's
    budget): each chunk's top-k becomes one list and merge_topk_kernel
    combines them; the result equals the plain version's."""
    _need_card()
    n, d = 30000, 256
    x, q, sq, scales = _inputs(20, n, d, q_n, metric, dtype)
    db = _card_db(x, dtype)
    kw = dict(metric=metric,
              db_sqnorms=None if sq is None else torch.from_numpy(sq).cuda(),
              db_scales=None if scales is None
              else torch.from_numpy(scales).cuda())
    qt = torch.from_numpy(q).cuda()
    before = LAUNCHES["scan_kernel_bigk"]
    got, plan = _chunked(qt, db, n - 3, k, budget=q_n * 7168 * 4, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["scan_kernel_bigk"] == before + 1
    assert plan.n_lists == 5
    got = [t.cpu().numpy() for t in got]
    want = _on_card(flat_topk_plain, qt, db, n - 3, k, **kw)
    # un-normalized euclidean rows: keys are O(d), so is their f32 rounding
    assert_close_topk(got, want, KEY_TOL * (d if metric == "euclidean"
                                            else 1))


@pytest.mark.gpu
@pytest.mark.parametrize("data", ["unit", "ints"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("dtype,q_n", [("float32", 16), ("float32", 32),
                                       ("float32", 64), ("bfloat16", 64),
                                       ("int8", 64), ("int4", 64)])
def test_lists_equal_the_key_scratch_on_card(dtype, q_n, metric, data):
    """The tile's lists (k = 33, 40, 64) against the key-scratch path at
    k = 100 as the oracle: the first k keys and ids equal, bit for bit,
    for every row type and query tile, cosine and euclidean, unmasked and
    masked, at a count that ends inside a row tile. Each query is a stored
    row planted 50 more times across the splits, so its ties straddle the
    k-th key; ``ints`` rows (small integers, every sum exact) tie
    everywhere besides."""
    _need_card()
    n, d = 60_000, 256
    count = n - 5
    rng = np.random.default_rng(21)
    if data == "unit":
        xf = rng.standard_normal((n, d)).astype(np.float32)
        xf /= np.linalg.norm(xf, axis=1, keepdims=True)
    else:
        xf = rng.integers(-3, 4, (n, d)).astype(np.float32)
    src = rng.choice(count, q_n, replace=False)
    for r in src:
        xf[rng.choice(count, 50, replace=False)] = xf[r]
    q = xf[src].copy()
    sq = np.sum(xf * xf, axis=1) if metric == "euclidean" else None
    scales = None
    if dtype == "int8":
        x = np.clip(np.round(xf * (127.0 if data == "unit" else 1.0)),
                    -127, 127).astype(np.int8)
    elif dtype == "int4":
        packed, scales = jax_pack_int4(jnp.asarray(xf))
        x, scales = np.array(packed), np.array(scales)
    else:
        x = xf
    db = _card_db(x, dtype)
    qt = torch.from_numpy(q).cuda()
    mask = torch.from_numpy(
        (rng.random(n) < 0.7).astype(np.float32)).cuda()
    kw = dict(metric=metric,
              db_sqnorms=None if sq is None else torch.from_numpy(sq).cuda(),
              db_scales=None if scales is None
              else torch.from_numpy(scales).cuda())
    assert cuda_scan._launch_plan(q_n, db.dtype, d, 100, count).chunk_rows
    for fm in (None, mask):
        want = _on_card(flat_topk, qt, db, count, 100, filter_mask=fm, **kw)
        for k in (33, 40, 64):
            plan = cuda_scan._launch_plan(q_n, db.dtype, d, k, count)
            assert plan.design == "tile" and plan.chunk_rows == 0
            before = LAUNCHES["scan_kernel_bigk"]
            keys, ids = _on_card(flat_topk, qt, db, count, k, filter_mask=fm,
                                 **kw)
            assert LAUNCHES["scan_kernel_bigk"] == before + 1
            np.testing.assert_array_equal(keys.view(np.int32),
                                          want[0][:, :k].view(np.int32))
            np.testing.assert_array_equal(ids, want[1][:, :k])
