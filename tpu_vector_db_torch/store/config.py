"""Store configuration.

The same fields, validation and ``to_dict``/``from_dict`` as the JAX
package's ``VectorStoreConfig``, so a manifest written by either package
loads in the other. ``use_pallas`` and ``jit_compile`` are kept only so
those manifests round-trip: nothing in this package reads them.

The capacity guard sizes the device budget from the card the store runs
on (``torch.cuda.get_device_properties``); ``VDB_HBM_BYTES`` overrides it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, asdict

VALID_METRICS = ("cosine", "euclidean", "dot_product")
VALID_DTYPES = ("float32", "bfloat16", "int8", "int4")
VALID_PERSIST = ("sync", "lazy", "off")

# Budget for a CPU store, or with no CUDA device, when VDB_HBM_BYTES is
# unset. 15% headroom is left for the allocator, query buffers and the
# kernels' scratch.
_DEFAULT_HBM_BYTES = 16 * 1024 ** 3
_HBM_USABLE_FRACTION = 0.85

_ITEM_BYTES = {"float32": 4.0, "bfloat16": 2.0, "int8": 1.0, "int4": 0.5}


class StoreCapacityError(ValueError):
    """Requested row capacity cannot fit the device memory budget.

    Raised at store creation / capacity growth instead of an opaque
    out-of-memory error mid-append. The message names the max feasible
    rows and the int8/int4 capacity modes."""


def _device_memory_bytes(device) -> int:
    """Total memory of ``device`` when it is a CUDA device (None: the
    current CUDA device, if there is one), else the default budget."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            return _DEFAULT_HBM_BYTES
        device = "cuda"
    dev = torch.device(device)
    if dev.type != "cuda":
        return _DEFAULT_HBM_BYTES
    return int(torch.cuda.get_device_properties(dev).total_memory)


@dataclass
class VectorStoreConfig:
    dimension: int = 384
    metric: str = "cosine"
    # ANN index: IVF (index/ivf.py), which index_type "auto" picks from
    # 100K rows, or the beam graph (index/beam_graph.py, "beam_graph")
    enable_ann: bool = False
    ann_params: dict = field(default_factory=lambda: {
        "M": 16, "ef_construction": 200, "ef_search": 100,
    })
    # ann_params keys the store and its indexes read: index_type; IVF's
    # n_clusters, nprobe, bucket_rows, train_iters, ivf_layout; the
    # graph's M, ef_construction, ef_search, alpha, entry_cap,
    # insert_budget_div, refine_budget_div, build_backend;
    # rerank_oversample, the routing thresholds (auto_flat_rows,
    # ann_min_rows, auto_batch_flat_q/_rows, filter_exact_selectivity,
    # deleted_exact_live_frac) and the recall guard's (self_check,
    # remediate_target, auto_remediate, remediate_nprobe_max,
    # remediate_max_refines, recall_warn, recall_floor).
    # Storage dtype for the device-resident matrix. bf16 halves the bytes
    # the scan streams at ~1e-3 score error; int8/int4 are capacity modes.
    storage_dtype: str = "float32"
    # device capacity grows in units of block_rows
    block_rows: int = 8192
    initial_capacity: int = 8192
    # "sync": write-through on every add; "lazy": dirty-flag + explicit
    # flush()/close(); "off": in-memory only.
    persist_mode: str = "sync"
    jit_compile: bool = True  # manifest parity only
    use_pallas: bool = True   # manifest parity only

    def __post_init__(self) -> None:
        if self.metric not in VALID_METRICS:
            raise ValueError(
                f"metric must be one of {VALID_METRICS}, got {self.metric!r}")
        if self.storage_dtype not in VALID_DTYPES:
            raise ValueError(
                f"storage_dtype must be one of {VALID_DTYPES}, got "
                f"{self.storage_dtype!r}")
        if self.persist_mode not in VALID_PERSIST:
            raise ValueError(
                f"persist_mode must be one of {VALID_PERSIST}, got "
                f"{self.persist_mode!r}")
        if self.storage_dtype in ("int8", "int4"):
            # capacity modes: rows are unit-norm (int8: fixed 127 scale;
            # int4: per-row scale, two nibbles per byte), so cosine only
            if self.metric != "cosine":
                raise ValueError(
                    f"storage_dtype={self.storage_dtype!r} requires "
                    "metric='cosine' (rows must be unit-norm for the "
                    "quantizer)")
            itype = self.ann_params.get("index_type", "auto")
            if self.enable_ann and itype not in ("auto", "flat", "ivf"):
                raise ValueError(
                    f"storage_dtype={self.storage_dtype!r} supports "
                    "index_type auto|flat|ivf (gather-layout IVF); "
                    f"got {itype!r}")
        if self.dimension < 1 or self.dimension > 8192:
            raise ValueError(f"dimension out of range: {self.dimension}")
        itype = self.ann_params.get("index_type", "auto")
        if itype not in ("auto", "flat", "beam_graph", "ivf"):
            raise ValueError(
                f"index_type must be auto|flat|beam_graph|ivf, got {itype!r}")
        self.check_device_budget(self.initial_capacity)

    # ----------------------------------------------------- device budget

    def device_bytes_for(self, rows: int) -> int:
        """Estimated device bytes at a given row capacity: the padded row
        matrix, euclidean sqnorms, int4 per-row scales, and a per-row index
        overhead when ANN is on (same terms as the JAX package, so both
        packages refuse the same stores at the same budget)."""
        mult = 256 if self.storage_dtype == "int4" else 128
        d_pad = ((self.dimension + mult - 1) // mult) * mult
        per_row = _ITEM_BYTES[self.storage_dtype] * d_pad
        if self.metric == "euclidean":
            per_row += 4.0                      # f32 sqnorms
        if self.storage_dtype == "int4":
            per_row += 4.0                      # f32 per-row scales
        if self.enable_ann:
            itype = self.ann_params.get("index_type", "auto")
            if itype == "beam_graph":
                m = int(self.ann_params.get("M", 16))
                per_row += m * 2 * 8.0          # edges i32 + edge keys f32
            else:                               # IVF (auto routes here)
                per_row += 6.0                  # bucket id table + slack
        return int(rows * per_row)

    @staticmethod
    def device_budget_bytes(device=None) -> int:
        """Usable bytes: ``VDB_HBM_BYTES`` when set, else the memory of
        ``device`` (None: the current CUDA device; a CPU device or no CUDA:
        the default), times the usable fraction."""
        env = os.environ.get("VDB_HBM_BYTES")
        total = int(env) if env else _device_memory_bytes(device)
        return int(total * _HBM_USABLE_FRACTION)

    def max_feasible_rows(self, budget: int | None = None) -> int:
        budget = budget if budget is not None else self.device_budget_bytes()
        return int(budget // max(self.device_bytes_for(1), 1))

    def check_device_budget(self, rows: int, budget: int | None = None,
                            device=None) -> None:
        """Raise StoreCapacityError if ``rows`` cannot fit on the device."""
        if budget is None:
            budget = self.device_budget_bytes(device)
        need = self.device_bytes_for(rows)
        if need <= budget:
            return
        msg = (f"{rows} rows x {self.dimension}D ({self.storage_dtype}) "
               f"needs ~{need / 1024**3:.1f} GiB device memory; budget is "
               f"{budget / 1024**3:.1f} GiB (max ~{self.max_feasible_rows(budget)} "
               f"rows at this config)")
        if self.storage_dtype in ("float32", "bfloat16"):
            # initial_capacity=1: the alt config must not itself trip the
            # creation-time guard under a tiny budget
            alt = VectorStoreConfig(
                dimension=self.dimension, metric="cosine",
                storage_dtype="int4", enable_ann=self.enable_ann,
                ann_params={"index_type": "ivf"}, initial_capacity=1)
            msg += (". Capacity modes fit more: storage_dtype='int8' or "
                    f"'int4' (~{alt.max_feasible_rows(budget)} rows at "
                    "int4, cosine-only)")
        raise StoreCapacityError(msg)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "VectorStoreConfig":
        known = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        return cls(**known)
