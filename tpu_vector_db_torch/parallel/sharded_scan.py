"""Sharded flat scan: a local top-k on every shard, one k·P merge.

Counterpart of ``tpu_vector_db/parallel/sharded_scan.py``. Where the JAX
package runs one ``shard_map`` program and all-gathers the (Q, k) winners
of every device, the port drives the shards from one process: each shard
is scanned on its own device by the store's engine
(``ops/cuda_scan.flat_topk``: the CUDA kernels on a CUDA tensor, their
plain version on a CPU tensor), its local ids are offset to global ids,
and the k·P candidates are copied to the lead device and merged once:

* k <= 32: ``ops/ivf_scan.merge_small_k``, the hand-written merge
  (``merge_small_k`` in ``csrc/topk_common.cuh``) on a CUDA tensor;
* k > 32: ``ops/topk.sort_by_key_then_id`` cut to k (the JAX merge is
  ``lax.top_k``, XLA, not a Pallas kernel).

Order is key descending, then global id ascending: what ``lax.top_k``
gives over the shards' winners gathered in shard order. Nothing waits on
the host between the shards: the launches queue on their devices'
streams and the copies to the lead device do not block.

A mesh that spans processes (``mesh.Mesh.multiprocess``) merges twice:
this process's shards on its lead device, then
``merge_across_processes``: one gloo all-gather of every process's
(Q, k) winners, in rank order, and the same merge once more on every
process. The order is total, so the two merges equal one merge over all
P shards, and every process returns the same answer. Every process runs
the same collectives in the same order, with the same shapes: a process
whose shards hold no live row sends -inf keys.

Queries are PREPARED as ``flat_topk`` takes them (cosine: unit rows,
padded to the stored width); the JAX function normalizes them itself.
Keys follow the port's kernels' scoring rules, the single-device store's
(ROADMAP queue C): equal to the JAX scan's for f32, within 5e-3 for
int8, int4 and bf16 euclidean.
"""

from __future__ import annotations

import torch

from tpu_vector_db_torch.ops.cuda_scan import flat_topk
from tpu_vector_db_torch.ops.ivf_scan import merge_small_k
from tpu_vector_db_torch.ops.topk import (MERGE_SMALL_MAX_K, NEG_INF,
                                          sort_by_key_then_id)
from tpu_vector_db_torch.parallel.mesh import Mesh, local_count


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; a copy between two cards does not block the
    host."""
    cuda = t.device.type == "cuda" and device.type == "cuda"
    return t.to(device, non_blocking=cuda)


def gather_candidates(keys: list, ids: list, offsets: list[int],
                      lead: torch.device):
    """The shards' (Q, k) winners, local ids, -> (Q, k·P) keys and global
    ids on ``lead``, in shard order. Slots with key -inf (past a shard's
    live rows, filtered, empty) get id -1: the merge never reads them, so
    the live candidates' ids are distinct within a query."""
    all_keys, all_ids = [], []
    for k_s, i_s, off in zip(keys, ids, offsets):
        gids = torch.where(k_s > NEG_INF, i_s.to(torch.int32) + off,
                           torch.full_like(i_s, -1, dtype=torch.int32))
        all_keys.append(_to(k_s.float(), lead))
        all_ids.append(_to(gids, lead))
    return torch.cat(all_keys, dim=1), torch.cat(all_ids, dim=1)


def merge_candidates(keys: torch.Tensor, ids: torch.Tensor, k: int,
                     empty_id: int = -1):
    """The global top-k of (Q, n) candidates, n >= k: key descending, then
    id ascending; ids ``empty_id`` wherever the key is -inf."""
    if k <= MERGE_SMALL_MAX_K:
        return merge_small_k(keys, ids, k, empty_id)
    vals, idx = sort_by_key_then_id(keys, ids)
    vals, idx = vals[:, :k], idx[:, :k]
    return vals, torch.where(vals > NEG_INF, idx,
                             torch.full_like(idx, empty_id))


def merge_across_processes(keys: torch.Tensor, ids: torch.Tensor, k: int,
                           mesh: Mesh, empty_id: int = -1):
    """The global top-k of every process's (Q, k) winners (keys f32,
    global ids, -1 wherever the key is -inf): one copy to the host (the
    keys viewed as int32 beside the ids), one gloo all-gather, the (Q,
    k·W) candidates in rank order back on this process's lead device and
    ``merge_candidates`` once more. Every process of the group must call
    it with the same shapes."""
    import torch.distributed as dist
    k_in = keys.shape[1]
    packed = torch.cat([keys.float().view(torch.int32),
                        ids.to(torch.int32)], dim=1).cpu()
    parts = [torch.empty_like(packed) for _ in range(mesh.process_count)]
    dist.all_gather(parts, packed)
    lead = mesh.lead
    all_keys = torch.cat([p[:, :k_in] for p in parts], dim=1)
    all_ids = torch.cat([p[:, k_in:] for p in parts], dim=1)
    return merge_candidates(all_keys.view(torch.float32).to(lead),
                            all_ids.to(lead), k, empty_id)


def merge_shards(keys: list, ids: list, offsets: list[int], k: int,
                 mesh: Mesh, empty_id: int = -1):
    """The global top-k of this process's shards' (Q, k) lists (local ids,
    ``offsets`` their shards' first global rows): merged on the lead
    device, then across the processes of a mesh that spans them."""
    cand = gather_candidates(keys, ids, offsets, mesh.lead)
    if mesh.multiprocess:
        return merge_across_processes(*merge_candidates(*cand, k), k, mesh,
                                      empty_id)
    return merge_candidates(*cand, k, empty_id)


def sharded_flat_topk(queries, db, count: int, k: int,
                      metric: str = "cosine", db_sqnorms=None,
                      filter_mask=None, db_scales=None,
                      mesh: Mesh | None = None):
    """``flat_topk`` over rows split into equal shards: ``db`` and the
    per-row inputs are lists, one tensor a shard on its device (rows of
    shard s are global rows ``[s·R, (s+1)·R)``, R its length); ``count``
    is the global live-row count. Returns (keys (Q, k), global ids
    (Q, k)) on the first shard's device; slots past the live rows hold
    -inf and id 0, as ``flat_topk``'s do. With a ``mesh`` that spans
    processes, ``db`` holds this process's shards, global shards
    ``mesh.first_shard`` on, and the answer is the whole group's."""
    rows = db[0].shape[0]
    lead = db[0].device
    n = len(db)
    first = mesh.first_shard if mesh is not None else 0
    sq = db_sqnorms or [None] * n
    mask = filter_mask or [None] * n
    scales = db_scales or [None] * n
    keys, ids = [], []
    for s in range(n):
        k_s, i_s = flat_topk(_to(queries, db[s].device), db[s],
                             local_count(count, rows, first + s), k, metric,
                             sq[s], mask[s], scales[s])
        keys.append(k_s)
        ids.append(i_s)
    offsets = [(first + s) * rows for s in range(n)]
    if mesh is not None:
        return merge_shards(keys, ids, offsets, k, mesh, empty_id=0)
    return merge_candidates(*gather_candidates(keys, ids, offsets, lead), k,
                            empty_id=0)


def make_sharded_query_fn(mesh: Mesh, k: int, metric: str = "cosine",
                          with_sqnorms: bool = False,
                          with_filter: bool = False,
                          with_scales: bool = False):
    """A callable (queries, db, count[, sqnorms][, mask][, scales]) ->
    (keys, global ids), and the mesh's device count.

    - queries: (Q, d_pad) prepared, on any device;
    - db: one (R, d_pad) tensor a shard of the mesh (of this process's
      shards, on a mesh that spans processes), on its device (int4:
      (R, d_pad//2) uint8-packed rows with scales), as ``shard_rows``
      places them;
    - count: the global live-row count;
    - sqnorms (euclidean), filter mask, int4 scales: lists like db.
    Results are on the mesh's lead device."""
    if len(mesh.shape) != 1:
        raise ValueError("make_sharded_query_fn takes a 1-D mesh")
    n_dev = mesh.size

    def fn(queries, db, count, *rest):
        if len(db) != n_dev:
            raise ValueError(f"{len(db)} shards for a mesh of {n_dev}")
        it = iter(rest)
        sq = next(it) if with_sqnorms else None
        mask = next(it) if with_filter else None
        scales = next(it) if with_scales else None
        return sharded_flat_topk(queries, db, count, k, metric, sq, mask,
                                 scales, mesh=mesh)

    return fn, n_dev


def make_serving_query_fn(mesh: Mesh, k: int, metric: str = "cosine"):
    """2-D data-parallel serving step over a (replica, shard) mesh: a
    callable (queries, db, count) -> (keys, global ids) on the mesh's
    lead device. queries (Q_total, d_pad), prepared, split evenly across
    the replica groups; db one list of shard tensors a group (all rows in
    every group, ``shard_rows`` of a 2-D mesh). Each group computes its
    queries' global top-k with the sharded scan on its own devices; no
    group reads another's rows."""
    if len(mesh.shape) != 2:
        raise ValueError("make_serving_query_fn takes a 2-D mesh")
    replicas = mesh.shape[0]

    def fn(queries, db, count):
        if queries.shape[0] % replicas:
            raise ValueError(f"{queries.shape[0]} queries do not split "
                             f"over {replicas} replica groups")
        parts = [sharded_flat_topk(q, shards, count, k, metric)
                 for q, shards in zip(queries.chunk(replicas), db)]
        return (torch.cat([_to(p[0], mesh.lead) for p in parts]),
                torch.cat([_to(p[1], mesh.lead) for p in parts]))

    return fn
