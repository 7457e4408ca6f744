"""A dry run of the sharded serving step on a mesh, at tiny shapes.

Counterpart of ``__graft_entry__.dryrun_multichip``: ingest (normalize
and place rows shard by shard) and query (a scan a shard, one k·P merge)
on the given mesh, asserting the JAX dry run's facts:

* the merged sharded top-k equals the single-device flat top-k;
* the 2-D (replica, shard) serving mesh equals it too (meshes of 4 or
  more devices, an even count);
* a sharded IVF probing every bucket returns the flat top-k's ids;
* int4 rows (packed, with per-row scales) sharded equal the packed flat
  scan;
* a gather-mode (int4) sharded IVF probing every bucket equals the packed
  flat scan, with ids whose true scores are the keys returned.

Run it with ``python -m tpu_vector_db_torch.parallel.dryrun`` (the
visible CUDA cards) or ``dryrun_multichip(make_device_mesh(devices=
["cpu"] * 8))``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_vector_db_torch.ops import distance as D
from tpu_vector_db_torch.ops.cuda_scan import flat_topk
from tpu_vector_db_torch.ops.quant4 import pack_int4, unpack_int4
from tpu_vector_db_torch.parallel.mesh import (Mesh, make_device_mesh,
                                               make_serving_mesh, shard_rows)
from tpu_vector_db_torch.parallel.sharded_ivf import ShardedIVF
from tpu_vector_db_torch.parallel.sharded_scan import (make_serving_query_fn,
                                                       make_sharded_query_fn)


def _equal(got, want, what: str, atol: float = 1e-5) -> None:
    keys, ids = (t.cpu() for t in got)
    want_keys, want_ids = (t.cpu() for t in want)
    if not torch.equal(ids, want_ids):
        raise AssertionError(f"{what}: ids {ids.tolist()} != "
                             f"{want_ids.tolist()}")
    torch.testing.assert_close(keys, want_keys, atol=atol, rtol=0)


def dryrun_multichip(mesh: Mesh) -> None:
    """Run and check one sharded serving step on ``mesh`` (1-D)."""
    n_dev = mesh.size
    lead = mesh.lead
    block, d, q_n, k = 8, 32, 4, 5
    rows_total = block * n_dev * 2
    n_live = rows_total - 3
    rng = np.random.default_rng(0)
    raw = torch.from_numpy(rng.standard_normal((rows_total, d)).astype(
        np.float32)).to(lead)
    queries = D.l2_normalize(torch.from_numpy(
        rng.standard_normal((q_n, d)).astype(np.float32)).to(lead))
    q = D.pad_dim(queries)

    # ingest: normalize the rows, place them shard by shard
    db = D.pad_dim(D.l2_normalize(raw))
    fn, _ = make_sharded_query_fn(mesh, k, metric="cosine")
    got = fn(q, shard_rows(mesh, db), n_live)
    ref = flat_topk(q, db, n_live, k, metric="cosine")
    _equal(got, ref, "sharded scan vs flat")

    # the 2-D serving mesh: the query batch split over 2 replica groups
    if n_dev >= 4 and n_dev % 2 == 0:
        mesh2 = make_serving_mesh(2, n_dev // 2, devices=mesh.devices)
        rows2 = block * (n_dev // 2) * 2
        db2 = D.pad_dim(D.l2_normalize(torch.from_numpy(
            rng.standard_normal((rows2, d)).astype(np.float32)).to(lead)))
        q2 = D.pad_dim(D.l2_normalize(torch.from_numpy(
            rng.standard_normal((4, d)).astype(np.float32)).to(lead)))
        got2 = make_serving_query_fn(mesh2, k)(q2, shard_rows(mesh2, db2),
                                               rows2)
        _equal(got2, flat_topk(q2, db2, rows2, k), "serving mesh vs flat")

    # sharded IVF, every bucket probed: the flat top-k's ids
    shards = shard_rows(mesh, db)
    ivf = ShardedIVF(dim=d, metric="cosine", mesh=mesh, nprobe=64,
                     n_clusters=2, bucket_rows=16)
    ivf.build(shards, n_live)
    _, ivf_ids = ivf.search(q, k, nprobe=ivf.n_buckets)
    for i in range(q_n):
        if set(ivf_ids[i].tolist()) != set(ref[1][i].tolist()):
            raise AssertionError(f"sharded IVF full probe != exact for "
                                 f"query {i}")

    # int4 capacity mode: packed rows and scales, both sharded
    d4 = 256
    raw4 = torch.from_numpy(rng.standard_normal((rows_total, d4)).astype(
        np.float32)).to(lead)
    packed, scales = pack_int4(D.l2_normalize(raw4))
    q4 = D.l2_normalize(torch.from_numpy(
        rng.standard_normal((q_n, d4)).astype(np.float32)).to(lead))
    fn4, _ = make_sharded_query_fn(mesh, k, metric="cosine",
                                   with_scales=True)
    got4 = fn4(q4, shard_rows(mesh, packed), n_live,
               shard_rows(mesh, scales))
    ref4 = flat_topk(q4, packed, n_live, k, db_scales=scales)
    _equal(got4, ref4, "sharded int4 vs packed flat")

    # gather-mode sharded IVF over the sharded packed rows, full probe
    ivf4 = ShardedIVF(dim=d4, metric="cosine", mesh=mesh, nprobe=64,
                      n_clusters=2, bucket_rows=16)
    packed_s, scales_s = shard_rows(mesh, packed), shard_rows(mesh, scales)
    ivf4.build(packed_s, n_live, scales=scales_s)
    if ivf4.quant != "int4" or any(sub._layout != "gather"
                                   for sub in ivf4._subs if sub.built):
        raise AssertionError("a quantized ShardedIVF must gather")
    k4g, i4g = ivf4.search(q4, k, nprobe=ivf4.n_buckets, db=packed_s,
                           scales=scales_s)
    torch.testing.assert_close(torch.sort(k4g.cpu(), dim=1)[0],
                               torch.sort(ref4[0].cpu(), dim=1)[0],
                               atol=5e-3, rtol=0)
    # the ids are real: each returned id's dequantized score is its key
    true = q4.cpu() @ unpack_int4(packed, scales).cpu().T
    sel = torch.take_along_dim(true, i4g.cpu().clamp(min=0).long(), dim=1)
    torch.testing.assert_close(k4g.cpu(), sel, atol=5e-3, rtol=0)


if __name__ == "__main__":
    m = make_device_mesh()
    dryrun_multichip(m)
    print(f"sharded dry run passed on {m.size} device(s): "
          f"{[str(d) for d in m.devices]}")
