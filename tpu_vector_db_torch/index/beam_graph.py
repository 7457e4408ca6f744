"""BeamGraphIndex: a flat navigable graph searched by batched beam search.

Counterpart of ``tpu_vector_db/index/beam_graph.py``, function for
function (``_score_ids``, ``beam_search``, ``_beam_search_packed``,
``alpha_prune``, ``_reverse_update``, the insert/refine step, which is the
body of the JAX ``_device_insert_scan``, ``_chunk_for`` and the
``BeamGraphIndex`` class), writing and reading the same ``ann_graph.npz``.
The JAX module reaches no Pallas kernel: its device work is XLA (einsum,
gathers, ``lax.top_k``, ``lax.scan``), and here it is ordinary torch code
on the store's device.

SEARCH: the graph is a dense (N, R) int32 neighbour table. Each iteration
expands the best ``beam_width`` unexpanded beam entries of every query at
once: one gather pulls their neighbour rows, one gather + batched product
scores the candidates, a broadcast compare drops candidates already in
the beam or earlier in the batch, and a top-k keeps the best ``ef``.
Shapes are static; the whole batch advances in lockstep.

BUILD: rows insert in batches. A batch beam-searches the current graph
for its ``ef_construction`` nearest, an alpha-prune (Vamana robust prune,
two phases) keeps up to R diverse neighbours, and every forward edge asks
its target to re-prune with the new backlink (grouped per target by sort
+ segment arithmetic). A full build is a cheap insert pass and a refine
pass that re-searches every row.

How the JAX code maps to torch:

* ``lax.top_k``: ``_top_k`` (a stable descending sort), so equal keys keep
  the lower index first and ``-inf`` slots follow in index order, as in
  ``lax.top_k``; ``torch.topk`` leaves ties in no stated order, and the
  build is a long chain of discrete choices that a tie order changes;
* ``einsum(..., preferred_element_type=f32)``: ``torch.bmm`` on operands
  widened to f32 (a bf16 ``bmm`` would round its result to bf16). On the
  card these f32 products rely on torch's default of no TF32 for
  matmuls (``torch.backends.cuda.matmul.allow_tf32`` False), which
  ``core/runtime.py`` also sets;
* ``.at[...].max(bool)``: a scatter of a logical or at distinct positions;
* ``.at[...].set(..., mode="drop")``: the dropped writes go to a slot or
  row that is then thrown away, so the real writes stay free of
  duplicate indices (``_reverse_update``);
* ``lax.scan`` over K batches: a Python loop of insert steps that never
  reads a device value on the host (no ``.item()``, no boolean-mask
  indexing, no ``nonzero``), and whose only host-to-device copies are the
  routing entries from pinned memory, so launches queue ahead of the card.
  The host mirror of the graph is materialized lazily (save, stats,
  capacity regrow), in one device-to-host copy.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

from tpu_vector_db_torch.utils.fs import atomic_save_npz

logger = logging.getLogger(__name__)

NEG_INF = float("-inf")
GRAPH_FILE = "ann_graph.npz"
_BIG_ID = 2 ** 31 - 1


def _top_k(keys: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: (values, int64 positions), key
    descending, ties to the lower position, ``-inf`` last in position
    order."""
    vals, pos = torch.sort(keys, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


# ----------------------------------------------------------------- scoring

def _score_ids(queries, db, ids, metric: str, sqnorms):
    """Keys (maximize convention) between each query and its candidate ids.

    queries: (Q, d) f32 or storage dtype, prepared (normalized for cosine,
             padded)
    db:      (N, d) storage dtype, prepared the same way
    ids:     (Q, C) int32, -1 = invalid (scored but masked by the caller)
    """
    safe = torch.clamp(ids, min=0).long()
    rows = db[safe].float()                                   # (Q, C, d)
    q = queries.float()
    cross = torch.bmm(rows, q.unsqueeze(-1)).squeeze(-1)      # (Q, C)
    if metric == "euclidean":
        q_sq = torch.sum(q ** 2, -1, keepdim=True)
        return -(q_sq - 2.0 * cross + sqnorms[safe])
    return cross


# ------------------------------------------------------------------ search

def _beam_search_packed(queries, db, graph, entries, count, k: int,
                        ef: int, beam_width: int, iters: int, metric: str,
                        sqnorms=None) -> np.ndarray:
    """beam_search and ONE device-to-host copy: the keys viewed as int32
    beside the ids, (Q, 2k) int32 on the host."""
    ids, keys = beam_search(queries, db, graph, entries, count, k=k, ef=ef,
                            beam_width=beam_width, iters=iters,
                            metric=metric, sqnorms=sqnorms)
    return torch.cat([ids.to(torch.int32), keys.float().view(torch.int32)],
                     dim=-1).cpu().numpy()


def beam_search(queries, db, graph, entries, count, k: int, ef: int,
                beam_width: int, iters: int, metric: str, sqnorms=None):
    """Batched best-first beam search. Returns (ids (Q,k) int32, keys
    (Q,k) f32); id -1 marks an empty slot (fewer than k reachable rows).
    ``count``: rows [0, count) may be returned (an int, or a 0-d tensor)."""
    q_n = queries.shape[0]
    r = graph.shape[1]
    c = beam_width * r
    dev = graph.device

    # ---- init beam from entry points
    init_ids = entries[None, :].expand(q_n, entries.shape[0])
    init_valid = (init_ids >= 0) & (init_ids < count)
    init_keys = _score_ids(queries, db, init_ids, metric, sqnorms)
    init_keys = torch.where(init_valid, init_keys, NEG_INF)
    pad = max(ef - init_ids.shape[1], 0)
    beam_ids = torch.cat(
        [init_ids, torch.full((q_n, pad), -1, dtype=torch.int32,
                              device=dev)], dim=1)
    beam_keys = torch.cat(
        [init_keys, torch.full((q_n, pad), NEG_INF, device=dev)], dim=1)
    beam_keys, order = _top_k(beam_keys, ef)
    beam_ids = torch.take_along_dim(beam_ids, order, dim=1)
    expanded = beam_keys == NEG_INF  # invalid slots never expand

    tril = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev),
                      diagonal=-1)
    for _ in range(iters):
        sel_keys = torch.where(expanded, NEG_INF, beam_keys)
        f_keys, f_pos = _top_k(sel_keys, beam_width)            # (Q, BW)
        frontier = torch.take_along_dim(beam_ids, f_pos, dim=1)
        f_valid = f_keys > NEG_INF
        # f_pos is distinct within a row: a scatter of the or is exact
        expanded = expanded.scatter(
            1, f_pos, torch.gather(expanded, 1, f_pos) | f_valid)

        neigh = graph[torch.clamp(frontier, min=0).long()]      # (Q, BW, R)
        neigh = torch.where(f_valid[:, :, None], neigh, -1)
        cand = neigh.reshape(q_n, c)
        valid = (cand >= 0) & (cand < count)
        keys = _score_ids(queries, db, cand, metric, sqnorms)
        # dedup: against the current beam, and earlier duplicates here
        dup_beam = (cand[:, :, None] == beam_ids[:, None, :]).any(-1)
        dup_self = ((cand[:, :, None] == cand[:, None, :])
                    & tril[None]).any(-1)
        keys = torch.where(valid & ~dup_beam & ~dup_self, keys, NEG_INF)

        all_keys = torch.cat([beam_keys, keys], dim=1)
        all_ids = torch.cat([beam_ids, cand], dim=1)
        all_exp = torch.cat([expanded, keys == NEG_INF], dim=1)
        beam_keys, pos = _top_k(all_keys, ef)
        beam_ids = torch.take_along_dim(all_ids, pos, dim=1)
        expanded = torch.take_along_dim(all_exp, pos, dim=1)
    ids = torch.where(beam_keys[:, :k] == NEG_INF, -1, beam_ids[:, :k])
    return ids, beam_keys[:, :k]


# ------------------------------------------------------------ alpha pruning

def alpha_prune(queries, db, cand_ids, cand_keys, R: int, metric: str,
                sqnorms=None, alpha: float = 1.0):
    """Greedy diversity pruning (Vamana robust-prune).

    Candidates are walked best-to-worst; one is kept unless an
    already-kept neighbour is closer to it than the base node is (scaled
    by alpha). Returns ((B, R) neighbour ids int32, (B, R) keys f32),
    -1/-inf padded. ``queries`` is unused, as in the JAX function (the
    base node's distances are the candidate keys)."""
    b, efc = cand_ids.shape
    # greedy order matters: best first
    cand_keys, order = _top_k(cand_keys, efc)
    cand_ids = torch.take_along_dim(cand_ids, order, dim=1)
    safe = torch.clamp(cand_ids, min=0).long()
    rows = db[safe].float()                                  # (B, efc, d)
    cross = torch.bmm(rows, rows.transpose(1, 2))            # (B, efc, efc)
    if metric == "euclidean":
        sq = sqnorms[safe]                                   # (B, efc)
        pdist = sq[:, :, None] - 2.0 * cross + sq[:, None, :]
        base_dist = -cand_keys                               # key = -dist^2
    elif metric == "cosine":
        pdist = 1.0 - cross
        base_dist = 1.0 - cand_keys
    else:  # dot
        pdist = -cross
        base_dist = -cand_keys

    width = cand_ids.shape[1]
    valid = cand_ids >= 0

    # Round-based greedy prune: each round keeps the best candidate that
    # no kept one dominates (ties to the lower sorted position, as the
    # column walk) and marks what it dominates from one row of pdist.
    # Domination is monotone in the kept set, so the rounds keep exactly
    # what a best-to-worst walk keeps, in R rounds.
    def prune_rounds(a, kept, dominated):
        for _ in range(R):
            cap = torch.sum(kept, dim=1) < R
            mask = valid & ~kept & ~dominated & cap[:, None]
            mkeys = torch.where(mask, cand_keys, NEG_INF)
            pick = torch.argmax(mkeys, dim=1, keepdim=True)  # first max
            ok = torch.gather(mkeys, 1, pick) > NEG_INF       # (B, 1)
            kept = kept.scatter(1, pick, torch.gather(kept, 1, pick) | ok)
            # what the new keep dominates: a * d(pick, i) <= d(base, i)
            prow = torch.gather(
                pdist, 1, pick[:, :, None].expand(b, 1, width))[:, 0]
            dominated = dominated | ((a * prow <= base_dist) & ok)
        return kept

    # two phases (Vamana/DiskANN): alpha = 1 builds the sparse skeleton,
    # then alpha > 1 fills the remaining slots with longer shortcuts
    zeros = torch.zeros((b, width), dtype=torch.bool, device=cand_ids.device)
    kept = prune_rounds(1.0, zeros, zeros)
    if alpha > 1.0:
        # phase 2 re-examines every candidate under the relaxed alpha
        dom2 = ((alpha * pdist <= base_dist[:, None, :])
                & kept[:, :, None]).any(dim=1)
        kept = prune_rounds(alpha, kept, dom2)

    sort_key = torch.where(kept, cand_keys, NEG_INF)
    top_keys, pos = _top_k(sort_key, R)
    top_ids = torch.take_along_dim(cand_ids, pos, dim=1)
    top_ids = torch.where(top_keys == NEG_INF, -1, top_ids)
    return top_ids, top_keys


# ------------------------------------------------------------------- build

def _reverse_update(graph, ekeys, db, ids, n_ids, n_keys, sqnorms, *,
                    M: int, R: int, metric: str, alpha: float,
                    rev_extra: int, rev_chunk: int):
    """Backlink resolution, in place on ``graph``/``ekeys``. Each forward
    edge u->v (top-M per node) asks v to reconsider its neighbourhood:
    edges are grouped per target v by a stable sort + segment arithmetic,
    then every touched row re-runs alpha_prune over its existing edges
    plus its first ``rev_extra`` new backlinks (in stable sort order). The
    forward search's keys double as backlink keys (symmetric metrics).

    The JAX scatters drop out-of-range writes (the pad slot ``e``, ranks
    >= rev_extra, pad targets ``cap``); here they go to a trash slot or,
    for the graph rows, repeat the first real write with its own value, so
    every write that counts has a distinct index."""
    b = ids.shape[0]
    e = b * M
    dev = graph.device
    us = ids[:, None].expand(b, M).reshape(-1)               # (E,)
    vs = n_ids[:, :M].reshape(-1)
    ks = n_keys[:, :M].reshape(-1).float()
    invalid = vs < 0
    order = torch.argsort(torch.where(invalid, _BIG_ID, vs),
                          stable=True)                       # invalid last
    vs_s, us_s, ks_s = vs[order], us[order], ks[order]
    inv_s = invalid[order]

    prev = torch.cat([torch.full((1,), -2, dtype=vs_s.dtype, device=dev),
                      vs_s[:-1]])
    is_first = (vs_s != prev) & ~inv_s                       # group leaders
    gidx = torch.cumsum(is_first.to(torch.int64), 0) - 1     # group per edge
    pos = torch.arange(e, device=dev)
    seg_start = torch.cummax(
        torch.where(is_first, pos, -1), dim=0).values
    rank = pos - seg_start                                   # rank in group

    # unique targets, -1 past the group count; slot e is the trash
    uv = torch.full((e + 1,), -1, dtype=torch.int32, device=dev)
    uv.scatter_(0, torch.where(is_first, gidx, e), vs_s)
    uv = uv[:e]
    keep = ~inv_s & (gidx >= 0) & (rank < rev_extra)
    slot = torch.where(keep, gidx * rev_extra + rank, e * rev_extra)
    extra_ids = torch.full((e * rev_extra + 1,), -1, dtype=torch.int32,
                           device=dev)
    extra_ids.scatter_(0, slot, us_s.to(torch.int32))
    extra_keys = torch.full((e * rev_extra + 1,), NEG_INF, device=dev)
    extra_keys.scatter_(0, slot, ks_s)
    extra_ids = extra_ids[:-1].view(e, rev_extra)
    extra_keys = extra_keys[:-1].view(e, rev_extra)

    uv_safe = torch.clamp(uv, min=0).long()
    # chunked: alpha_prune materializes (rows, width, d) gathers; every
    # chunk reads the graph as it was before this update, as in JAX
    new_ids, new_keys = [], []
    for s in range(0, e, rev_chunk):
        cuv = uv_safe[s:s + rev_chunk]
        cand = torch.cat([graph[cuv], extra_ids[s:s + rev_chunk]], dim=1)
        candk = torch.cat([ekeys[cuv], extra_keys[s:s + rev_chunk]], dim=1)
        out_ids, out_keys = alpha_prune(None, db, cand, candk, R, metric,
                                        sqnorms=sqnorms, alpha=alpha)
        new_ids.append(out_ids)
        new_keys.append(out_keys)
    new_ids = torch.cat(new_ids)
    new_keys = torch.cat(new_keys)
    # pad rows (uv -1) rewrite the first target with its own new row: the
    # same value whichever write lands, and when no edge is valid at all
    # row 0 with its current contents
    real = uv >= 0
    first_ids = torch.where(real[0], new_ids[0], graph[0])
    first_keys = torch.where(real[0], new_keys[0], ekeys[0])
    tgt = torch.where(real, uv_safe, uv_safe[0])
    graph[tgt] = torch.where(real[:, None], new_ids, first_ids)
    ekeys[tgt] = torch.where(real[:, None], new_keys, first_keys)
    return graph, ekeys


def _insert_step(graph, ekeys, db, start: int, count0: int, entries,
                 sqnorms, *, B: int, R: int, M: int, efc: int, iters: int,
                 metric: str, alpha: float, exclude_self: bool,
                 rev_extra: int, rev_chunk: int, insert_mode: bool,
                 bw: int = 4):
    """One insert (or refine) batch of rows [start, start + B), in place:
    the body of the JAX ``_device_insert_scan``. insert_mode: the
    searchable row count is the batch start (rows before this batch);
    refine searches the full count0."""
    count = start if insert_mode else count0
    ids = start + torch.arange(B, dtype=torch.int32, device=graph.device)
    # search in the storage dtype's rows: build scores only rank candidates
    queries = db[ids.long()]
    cand_ids, cand_keys = beam_search(
        queries, db, graph, entries, count, k=efc, ef=efc,
        beam_width=bw, iters=iters, metric=metric, sqnorms=sqnorms)
    if exclude_self:
        # refine: a node must not choose itself; union with its EXISTING
        # edges (reverse edges carry the long-range links that keep
        # distant clusters reachable)
        self_mask = cand_ids == ids[:, None]
        cand_keys = torch.where(self_mask, NEG_INF, cand_keys)
        cand_ids = torch.where(self_mask, -1, cand_ids)
        cur_ids = graph[start:start + B]
        cur_keys = ekeys[start:start + B]
        dup = (cur_ids[:, :, None] == cand_ids[:, None, :]).any(-1)
        cur_keys = torch.where(dup | (cur_ids < 0), NEG_INF, cur_keys)
        cur_ids = torch.where(dup, -1, cur_ids)
        cand_ids = torch.cat([cand_ids, cur_ids], dim=1)
        cand_keys = torch.cat([cand_keys, cur_keys], dim=1)
    n_ids, n_keys = alpha_prune(queries, db, cand_ids, cand_keys, R,
                                metric, sqnorms=sqnorms, alpha=alpha)
    graph[start:start + B] = n_ids
    ekeys[start:start + B] = n_keys
    return _reverse_update(
        graph, ekeys, db, ids, n_ids, n_keys, sqnorms, M=M, R=R,
        metric=metric, alpha=alpha, rev_extra=rev_extra,
        rev_chunk=rev_chunk)


def _chunk_for(e: int, limit: int = 4096) -> int:
    """Largest divisor of e not exceeding limit: the reverse re-prune's
    chunk of rows, which bounds its (chunk, width, d) gather."""
    c = min(e, limit)
    while e % c:
        c -= 1
    return c


# ------------------------------------------------------------------- index

class BeamGraphIndex:
    """Owns the GRAPH only; the vectors stay in the store's device matrix.
    The graph and its edge keys live on ``device`` (the store's), with a
    lazy host mirror for save, stats and the native builder."""

    def __init__(self, dim: int, metric: str = "cosine", M: int = 16,
                 ef_construction: int = 200, entry_count: int = 8,
                 alpha: float = 1.2, batch_size: int = 512,
                 entry_cap: int = 4096, seed: int = 0,
                 insert_budget_div: int | None = None,
                 refine_budget_div: int | None = None,
                 device: str | torch.device = "cuda") -> None:
        self.dim = dim
        self.metric = metric
        self.M = int(M)
        self.R = 2 * int(M)          # max degree, hnswlib level-0 convention
        self.ef_construction = int(ef_construction)
        self.entry_count = int(entry_count)
        self.alpha = float(alpha)
        self.batch_size = int(batch_size)
        # routing-set width of stores from 512K rows (ann_params entry_cap)
        self.entry_cap = max(int(entry_cap), 1024)
        # build-budget divisors: class attributes hold the defaults;
        # ann_params may set them per store
        if insert_budget_div is not None:
            self.insert_budget_div = max(int(insert_budget_div), 1)
        if refine_budget_div is not None:
            self.refine_budget_div = max(int(refine_budget_div), 1)
        self._seed = seed
        self.device = torch.device(device)

        self._n = 0                  # rows currently in the graph
        self._cap = 0
        self._graph: np.ndarray | None = None      # (cap, R) int32, host
        self._edge_keys: np.ndarray | None = None  # (cap, R) f32, host
        self._graph_dev: torch.Tensor | None = None
        self._ekeys_dev: torch.Tensor | None = None
        self._host_dirty = False     # device is source of truth during build
        self._entries: np.ndarray | None = None
        self._entries_dev: torch.Tensor | None = None  # padded, on device
        self._iters_div = 1          # insert_budget_div in a build's insert
        self.build_time_s = 0.0

    # ------------------------------------------------------------- plumbing

    @property
    def built(self) -> bool:
        return self._n > 0

    @property
    def size(self) -> int:
        return self._n

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A device copy of a host array (never a view of it)."""
        return torch.tensor(arr, device=self.device)

    def _ensure_cap(self, n: int) -> None:
        if self._graph is not None and self._cap >= n:
            return
        self._materialize_host()
        cap = max(1024, self._cap or 1024)
        while cap < n:
            cap *= 2
        graph = np.full((cap, self.R), -1, np.int32)
        keys = np.full((cap, self.R), NEG_INF, np.float32)
        if self._graph is not None:
            graph[: self._n] = self._graph[: self._n]
            keys[: self._n] = self._edge_keys[: self._n]
        self._graph, self._edge_keys, self._cap = graph, keys, cap
        self._graph_dev = self._upload(graph)
        self._ekeys_dev = self._upload(keys)

    def _materialize_host(self) -> None:
        """Pull the device graph back to the host mirror (one copy each;
        the build loop itself never syncs). Required before save, stats,
        native interop and any capacity regrow."""
        if not self._host_dirty:
            return
        self._graph = self._graph_dev.to("cpu", copy=True).numpy()
        self._edge_keys = self._ekeys_dev.to("cpu", copy=True).numpy()
        self._host_dirty = False

    def _entry_target(self) -> int:
        """Entry-point count, growing with N in powers of two: the entry
        set is this index's coarse routing level (the role of HNSW's upper
        layers); with few entries, well-separated clusters in high
        dimension become unreachable islands."""
        cap = 1024 if self._n < (1 << 19) else self.entry_cap
        target = max(self.entry_count, min(cap, self._n // 64))
        bucket = self.entry_count
        while bucket * 2 <= target:
            bucket *= 2
        return bucket

    def _entry_pad(self) -> int:
        """Width of the entry array (-1 padded; beam_search masks ids <
        0): 1024 below 512K rows, ``entry_cap`` from there."""
        return 1024 if self._n < (1 << 19) else self.entry_cap

    def _set_entries(self, entries: np.ndarray) -> None:
        self._entries = entries.astype(np.int32)
        self._entries_dev = None

    def _refresh_entries(self) -> None:
        n = max(self._n, 1)
        count = min(self._entry_target(), n)
        self._set_entries(np.unique(
            np.linspace(0, n - 1, count).astype(np.int32)))

    def _entries_padded(self) -> np.ndarray:
        pad = self._entry_pad()
        out = np.full((pad,), -1, np.int32)
        k = min(len(self._entries), pad)
        out[:k] = self._entries[:k]
        return out

    def _entries_device(self) -> torch.Tensor:
        """The padded entries on the device, uploaded once per change.
        From pinned memory on a CUDA device: a copy from pageable memory
        would wait for the work queued before it."""
        if self._entries_dev is None:
            host = torch.from_numpy(self._entries_padded())
            if self.device.type == "cuda":
                host = host.pin_memory()
            self._entries_dev = host.to(self.device, non_blocking=True)
        return self._entries_dev

    def _sync_dev_rows(self, row_ids: np.ndarray) -> None:
        """Mirror updated host rows (graph + edge keys) to the device."""
        if len(row_ids) == 0:
            return
        ids_dev = self._upload(row_ids.astype(np.int64))
        self._graph_dev[ids_dev] = self._upload(self._graph[row_ids])
        self._ekeys_dev[ids_dev] = self._upload(self._edge_keys[row_ids])

    # ----------------------------------------------------------------- build

    def build(self, db, count: int, sqnorms=None,
              refine_passes: int = 1) -> dict:
        """Full (re)build from the store's prepared device matrix."""
        t0 = time.perf_counter()
        self._n = 0
        self._graph = None
        self._cap = 0
        self._host_dirty = False
        self._ensure_cap(count)
        # two-phase budget: cheap insert pass, then the refine pass (see
        # insert_budget_div); only when a refine pass follows
        self._iters_div = self.insert_budget_div if refine_passes else 1
        try:
            self._insert_range(db, 0, count, sqnorms)
        finally:
            self._iters_div = 1
        if refine_passes:
            self.refine(db, sqnorms=sqnorms, passes=refine_passes)
        # one terminal device-to-host copy waits for the build, so
        # build_time_s covers the device work
        self._materialize_host()
        self.build_time_s = time.perf_counter() - t0
        logger.info("beam graph built: %d nodes in %.1fs (M=%d efc=%d)",
                    count, self.build_time_s, self.M, self.ef_construction)
        return {"nodes": count, "build_time_s": self.build_time_s}

    def build_cpu(self, host_vectors: np.ndarray, count: int) -> dict:
        """Full build on the host with the native C++ builder
        (native/graph_builder.cpp): the same graph format and pruning rule
        as the device build. host_vectors: RAW (count, d) float32,
        prepared here. The graph then goes to the index's device."""
        from tpu_vector_db_torch.index import native
        t0 = time.perf_counter()
        prepared = np.ascontiguousarray(host_vectors[:count], np.float32)
        if self.metric == "cosine":
            norms = np.linalg.norm(prepared, axis=1, keepdims=True)
            prepared = prepared / np.maximum(norms, 1e-8)
        graph, keys, entries = native.build_graph(
            prepared, self.metric, self.R, self.ef_construction, self.alpha,
            entry_count=self.entry_count)
        self.install_graph(graph, keys, entries)
        self.build_time_s = time.perf_counter() - t0
        logger.info("native graph build: %d nodes in %.1fs", count,
                    self.build_time_s)
        return {"nodes": count, "build_time_s": self.build_time_s,
                "backend": "cpu-native"}

    def install_graph(self, graph: np.ndarray, edge_keys: np.ndarray,
                      entries: np.ndarray | None = None) -> None:
        n = graph.shape[0]
        if graph.shape[1] != self.R:
            raise ValueError(f"graph degree {graph.shape[1]} != R {self.R}")
        self._n = 0
        self._graph = None
        self._cap = 0
        self._host_dirty = False
        self._ensure_cap(n)
        self._graph[:n] = graph
        self._edge_keys[:n] = edge_keys
        self._n = n
        # the routing set is always sized by _entry_target (a too-small
        # entry set fragments recall on clustered data); given entries are
        # kept only when at least as many
        if entries is not None and len(entries) >= self._entry_target():
            self._set_entries(entries)
        else:
            self._refresh_entries()
        self._graph_dev = self._upload(self._graph)
        self._ekeys_dev = self._upload(self._edge_keys)

    def add(self, db, old_count: int, new_count: int, sqnorms=None) -> dict:
        """Incremental insertion of rows [old_count, new_count)."""
        t0 = time.perf_counter()
        self._ensure_cap(new_count)
        self._insert_range(db, old_count, new_count, sqnorms)
        dt = time.perf_counter() - t0
        self.build_time_s += dt
        return {"nodes": new_count - old_count, "build_time_s": dt}

    def _insert_range(self, db, start: int, end: int, sqnorms) -> None:
        if start != self._n:
            raise ValueError(
                f"insert must continue from {self._n}, got {start}")
        if start == 0:
            boot = min(end, self.R + 1)
            ids = np.arange(boot)
            for i in range(boot):
                others = ids[ids != i][: self.R]
                self._graph[i, : len(others)] = others
                # bootstrap edges are arbitrary: key -inf makes them the
                # first to be replaced by real reverse edges
                self._edge_keys[i, : len(others)] = NEG_INF
            self._n = boot
            self._sync_dev_rows(ids)
            self._refresh_entries()
            start = boot

        # The batch schedule is the JAX package's, step for step: it
        # decides which rows see which graph, so both packages build the
        # same graph from the same rows.
        while start < end:
            # the batch ramps with the graph's size (512 rows inserted
            # against a 17-row graph would all get bootstrap neighbours);
            # a dispatch is one ramp-size batch, or _SCAN_K full ones that
            # share one entry set
            step = self._ramp_step()
            remaining = end - start
            if remaining >= step:
                kk = remaining // step
                if 2 * step <= self.batch_size and self._n < 2 * step:
                    kk = min(kk, max(1, (2 * step - self._n) // step))
                kk = self._SCAN_K if kk >= self._SCAN_K else 1
                starts = start + step * np.arange(kk)
                self._dispatch(db, starts, step, sqnorms,
                               exclude_self=False, count0=None)
                self._n = start + kk * step
            elif remaining < 32 <= end:
                # sub-32 tail: overlap-refine the last 32 rows; rows
                # already in the graph are re-pruned, the new rows insert
                # with self-exclusion
                self._n = end
                self._dispatch(db, np.array([end - 32]), 32, sqnorms,
                               exclude_self=True, count0=end)
            elif remaining < 32:
                # tiny graph (< 32 rows in all): one exact-size batch
                self._dispatch(db, np.array([start]), remaining, sqnorms,
                               exclude_self=False, count0=None)
                self._n = end
            else:
                # tail between 32 and step: the largest power-of-two chunk
                b = 32
                while b * 2 <= remaining:
                    b *= 2
                self._dispatch(db, np.array([start]), b, sqnorms,
                               exclude_self=False, count0=None)
                self._n = start + b
            self._refresh_entries()  # routing set must track graph growth
            start = self._n

    def _ramp_step(self) -> int:
        step = 32
        while step * 2 <= min(self.batch_size, self._n):
            step *= 2
        return step

    # full batches that share one entry set (one JAX dispatch)
    _SCAN_K = 16
    # build-time beam width: the expansion budget stays efc (iters=efc/bw)
    build_beam_width = 4
    # a full build's insert pass runs at 1/insert_budget_div of the beam
    # budget and the refine pass re-searches every node at
    # 1/refine_budget_div (Vamana-style two passes). add() (no refine
    # follows) always uses the full budget.
    insert_budget_div = 3
    refine_budget_div = 2
    # extra backlink slots considered per row per batch before re-pruning
    _REVERSE_EXTRA = 16

    def _dispatch(self, db, starts: np.ndarray, batch: int, sqnorms,
                  exclude_self: bool, count0: int | None) -> None:
        """len(starts) consecutive batches of ``batch`` rows, queued on
        the device with no copy back: the device graph is the source of
        truth until _materialize_host()."""
        bw = self.build_beam_width
        iters = max(self.ef_construction // bw // self._iters_div, 6)
        entries = self._entries_device()
        for start in starts:
            _insert_step(
                self._graph_dev, self._ekeys_dev, db, int(start),
                int(count0 or 0), entries, sqnorms,
                B=int(batch), R=self.R, M=self.M, efc=self.ef_construction,
                iters=iters, metric=self.metric, alpha=self.alpha,
                exclude_self=exclude_self, rev_extra=self._REVERSE_EXTRA,
                rev_chunk=_chunk_for(int(batch) * self.M),
                insert_mode=count0 is None, bw=bw)
        self._host_dirty = True

    def refine(self, db, sqnorms=None, passes: int = 1) -> None:
        """Vamana-style improvement passes: every node re-searches the
        FULL graph and re-prunes its neighbourhood. The tail window
        overlaps backwards (re-refining a few rows), as in JAX."""
        n = self._n
        if n < 2:
            return
        batch = 32
        while batch * 2 <= min(self.batch_size, n):
            batch *= 2
        if n < 32:  # tiny graph: one exact-size window
            batch = n
        self._iters_div = self.refine_budget_div
        try:
            self._refine_passes(db, sqnorms, passes, batch, n)
        finally:
            self._iters_div = 1

    def _refine_passes(self, db, sqnorms, passes, batch, n) -> None:
        for _ in range(passes):
            start = 0
            while start < n:
                if n - start >= batch * self._SCAN_K:
                    kk = self._SCAN_K
                    starts = start + batch * np.arange(kk)
                    self._dispatch(db, starts, batch, sqnorms,
                                   exclude_self=True, count0=n)
                    start += kk * batch
                else:
                    s = min(start, n - batch)  # overlap-clamp the tail
                    self._dispatch(db, np.array([s]), batch, sqnorms,
                                   exclude_self=True, count0=n)
                    start = s + batch

    # ---------------------------------------------------------------- search

    def search(self, queries, db, count: int, k: int,
               ef_search: int = 100, sqnorms=None):
        """(Q, k) global ids int32 + keys f32, on the host. queries must be
        PREPARED like db rows (the store normalizes and pads them). -1 ids
        mark unreachable slots."""
        if not self.built:
            raise RuntimeError("index not built")
        ef = max(ef_search, k)
        # 2*ef expansions of a beam 8 wide: the JAX index's search budget
        bw = 8
        iters = max(ef // bw * 2, 8)
        packed = _beam_search_packed(
            torch.as_tensor(queries, dtype=torch.float32,
                            device=self.device),
            db, self._graph_dev, self._entries_device(),
            min(self._n, count), k=k, ef=ef, beam_width=bw, iters=iters,
            metric=self.metric, sqnorms=sqnorms)
        ids = packed[:, :k]
        keys = np.ascontiguousarray(packed[:, k:]).view(np.float32)
        return ids, keys

    # ----------------------------------------------------------- persistence

    def save(self, directory: str | Path) -> None:
        if self._graph is None:
            return
        self._materialize_host()
        atomic_save_npz(
            Path(directory) / GRAPH_FILE,
            graph=self._graph[: self._n],
            edge_keys=self._edge_keys[: self._n],
            entries=self._entries,
            meta=np.array([self._n, self.M, self.ef_construction,
                           self.dim], np.int64))

    def load(self, directory: str | Path) -> bool:
        path = Path(directory) / GRAPH_FILE
        if not path.exists():
            return False
        try:
            with np.load(path) as z:
                graph = z["graph"]
                keys = z["edge_keys"]
                entries = z["entries"]
                n, m, efc, dim = z["meta"]
            if dim != self.dim or graph.shape[1] != 2 * m:
                raise ValueError("graph metadata mismatch")
            self.M = int(m)
            self.R = 2 * self.M
            self.ef_construction = int(efc)
            self._n = 0
            self._graph = None
            self._cap = 0
            self._host_dirty = False
            self._ensure_cap(int(n))
            self._graph[: n] = graph
            self._edge_keys[: n] = keys
            self._n = int(n)
            self._set_entries(entries)
            self._graph_dev = self._upload(self._graph)
            self._ekeys_dev = self._upload(self._edge_keys)
            return True
        except Exception:  # noqa: BLE001 — corrupt graph -> rebuild
            logger.exception("corrupt ANN graph at %s; will rebuild", path)
            return False

    def get_stats(self) -> dict:
        degrees = None
        if self._graph is not None and self._n:
            self._materialize_host()
            degrees = (self._graph[: self._n] >= 0).sum(axis=1)
        return {
            "type": "beam_graph",
            "nodes": self._n,
            "M": self.M,
            "R": self.R,
            "ef_construction": self.ef_construction,
            "alpha": self.alpha,
            "avg_degree": float(degrees.mean()) if degrees is not None else 0,
            "build_time_s": round(self.build_time_s, 3),
            "memory_mb": round((self._cap * self.R * 8) / 2**20, 2),
        }
