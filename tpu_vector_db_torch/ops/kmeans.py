"""k-means (blocked Lloyd iterations): the IVF coarse quantizer.

Counterpart of ``tpu_vector_db/ops/kmeans.py``, function by function
(``_compute_dtype``, ``_widen_block``, ``_seed_rows``, ``_block_layout``,
``_scores``, ``assign_clusters``, ``_lloyd_step``, ``train_kmeans``).

Every step is a large matrix product outside any kernel, so it is
``torch.matmul`` here (in full f32 on the card while
``torch.backends.cuda.matmul.allow_tf32`` is False, its default):

* assignment: blockwise (B, d) x (d, C) scores + argmax (``torch.argmax``
  keeps the first maximum, as ``jnp.argmax`` does);
* update: per block a one-hot (B, C) product accumulates the centroid sums
  and counts, as in the JAX package (no scatter, no atomics, so a run
  repeats exactly).

Cosine uses spherical k-means (centroids re-normalized each iteration);
euclidean the ||x||^2 - 2 x.c + ||c||^2 expansion. Empty clusters are
re-seeded from random live rows drawn from a ``torch.Generator`` seeded
with ``seed``: its draws are not JAX's, so the tests feed both packages
data on which no cluster empties.
"""

from __future__ import annotations

import torch

from tpu_vector_db_torch.ops.quant4 import unpack_int4


def _compute_dtype(db_dtype):
    """Product dtype for a storage dtype: quantized rows widen to bf16."""
    if db_dtype in (torch.int8, torch.uint8):
        return torch.bfloat16
    return db_dtype


def _widen_block(block, scales_block):
    """Quantized capacity-mode blocks -> rows ready for the product.

    int8: plain widen (values <= 127 are exact in bf16; the uniform x127
    scale cancels in the cosine argmax and normalizes out of centroids).
    uint8 = packed int4: dequantize with the per-row scales, then round to
    bf16 as the JAX package does. Other dtypes pass through."""
    if block.dtype == torch.uint8:
        return unpack_int4(block, scales_block).to(torch.bfloat16)
    if block.dtype == torch.int8:
        return block.to(torch.bfloat16)
    return block


def _seed_rows(db, idx, db_scales):
    """Seed / re-seed centroid rows in f32 (dequantized for int4). int8
    rows divide their fixed x127 scale back out, so a re-seed has the
    unit norm of the centroids it joins."""
    if db.dtype == torch.uint8:
        return unpack_int4(db[idx], db_scales[idx])
    rows = db[idx].float()
    if db.dtype == torch.int8:
        rows = rows * (1.0 / 127.0)
    return rows


def _block_layout(n_pad: int, block_rows: int) -> tuple[int, int]:
    """(num_blocks, block_rows) covering ALL n_pad rows: the last block's
    start is clamped back to n_pad - block_rows, so it overlaps the
    previous block; callers drop the re-read overlap rows."""
    block_rows = min(block_rows, n_pad)
    return -(-n_pad // block_rows), block_rows


def _scores(block, centroids, metric, c_sqnorms):
    """(B, C) maximize-keys between a data block and the centroids; the
    operands are widened to f32 (exact for bf16), sums in f32."""
    cross = block.float() @ centroids.float().T
    if metric == "euclidean":
        return 2.0 * cross - c_sqnorms[None, :]
    return cross  # cosine (rows pre-normalized) and dot


def _blocks(db, db_scales, block_rows):
    """Yield (logical start, clamped start, widened block) over db."""
    n_pad = db.shape[0]
    num_blocks, block_rows = _block_layout(n_pad, block_rows)
    for idx in range(num_blocks):
        logical = idx * block_rows
        start = min(logical, n_pad - block_rows)
        stop = start + block_rows
        scl = db_scales[start:stop] if db_scales is not None else None
        yield logical, start, _widen_block(db[start:stop], scl)


def assign_clusters(db, count, centroids, metric: str = "cosine",
                    block_rows: int = 65536, db_scales=None):
    """(N_pad,) int32 cluster id per row, on db's device (padding rows
    score like any row). db_scales: per-row scales, required for
    uint8-packed int4."""
    n_pad = db.shape[0]
    cents32 = centroids.to(db.device).float()
    c_sq = torch.sum(cents32 ** 2, -1)
    cents = cents32.to(_compute_dtype(db.dtype))
    out = torch.empty(n_pad, dtype=torch.int32, device=db.device)
    for logical, start, block in _blocks(db, db_scales, block_rows):
        best = torch.argmax(_scores(block, cents, metric, c_sq), dim=-1)
        # the clamped last block re-reads `logical - start` rows: skip them
        skip = logical - start
        out[logical: start + block.shape[0]] = best[skip:].to(torch.int32)
    return out


def _lloyd_step(db, count, centroids, metric: str, block_rows: int,
                db_scales=None):
    """One Lloyd iteration: returns (new_centroids (C, d) f32, counts (C,)
    f32, mean_key f32 scalar)."""
    d = db.shape[1] * 2 if db.dtype == torch.uint8 else db.shape[1]
    c = centroids.shape[0]
    dev = db.device
    cents32 = centroids.to(dev).float()
    c_sq = torch.sum(cents32 ** 2, -1)
    cents = cents32.to(_compute_dtype(db.dtype))
    sums = torch.zeros((d, c), device=dev)
    counts = torch.zeros(c, device=dev)
    key_acc = torch.zeros((), device=dev)
    for logical, start, block in _blocks(db, db_scales, block_rows):
        s = _scores(block, cents, metric, c_sq)                # (B, C)
        row = start + torch.arange(block.shape[0], device=dev)
        # mask padding AND rows re-read in the clamped last block's overlap
        live = ((row < count) & (row >= logical)).float()
        key = torch.amax(s, dim=-1)
        best = torch.argmax(s, dim=-1)            # first maximum
        onehot = torch.zeros((block.shape[0], c), device=dev)
        onehot.scatter_(1, best[:, None], live[:, None])
        sums += block.float().T @ onehot
        counts += onehot.sum(dim=0)
        key_acc += torch.sum(key * live)
    new = (sums / torch.clamp(counts[None, :], min=1.0)).T     # (C, d)
    # empty clusters keep their old centroid (re-seeding happens outside)
    new = torch.where(counts[:, None] > 0, new, cents32)
    if metric == "cosine":
        norm = torch.linalg.vector_norm(new, dim=-1, keepdim=True)
        new = new / torch.clamp(norm, min=1e-8)
    mean_key = key_acc / max(float(count), 1.0)
    return new, counts, mean_key


def train_kmeans(db, count, n_clusters: int, metric: str = "cosine",
                 iters: int = 10, block_rows: int = 65536, seed: int = 0,
                 db_scales=None):
    """Train the coarse quantizer on the store's prepared device matrix.

    db: (N_pad, d_pad) prepared rows (cosine: normalized), padding zeroed;
    int8 rows (fixed x127 scale) and uint8-packed int4 rows (+ db_scales)
    train directly, widened block by block. Returns (centroids (C, d_pad)
    f32, counts (C,) f32 from the last iteration), on db's device."""
    count = int(count)
    dev = db.device
    # deterministic strided init over live rows
    idx = (torch.arange(n_clusters, device=dev)
           * max(count // n_clusters, 1)) % max(count, 1)
    centroids = _seed_rows(db, idx, db_scales)
    counts = None
    gen = torch.Generator(device=dev).manual_seed(seed)
    for i in range(iters):
        centroids, counts, _ = _lloyd_step(
            db, count, centroids, metric, block_rows, db_scales=db_scales)
        # re-seed empty clusters from random live rows, so the bucket
        # layout never carries dead buckets
        if i < iters - 1:
            rand_rows = torch.randint(0, max(count, 1), (n_clusters,),
                                      generator=gen, device=dev)
            reseed = _seed_rows(db, rand_rows, db_scales)
            centroids = torch.where((counts > 0)[:, None], centroids, reseed)
    return centroids, counts
