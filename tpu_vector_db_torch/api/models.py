"""Pydantic request/response models.

Capability parity with reference service/models.py:23-213: metric/index
enums, VectorAddRequest with equal-length validation, VectorQuery with
k in [1, 1000], CreateStoreRequest with dimension in [1, 4096], plus
store-info / delete / optimize / benchmark / health / error / metrics /
server-config models.
"""

from __future__ import annotations

import time
from enum import Enum

from pydantic import BaseModel, Field, field_validator, model_validator


class MetricType(str, Enum):
    cosine = "cosine"
    euclidean = "euclidean"
    dot_product = "dot_product"


class IndexType(str, Enum):
    flat = "flat"
    beam_graph = "beam_graph"   # graph ANN index (index/beam_graph.py)
    hnsw = "hnsw"               # accepted alias for reference compatibility
    ivf = "ivf"                 # k-means + bucket-streamed probe scan
    auto = "auto"               # measured routing: flat below the exact-scan
    #                             crossover, IVF above it (vector_store.py
    #                             _auto_pick_kind)


class VectorAddRequest(BaseModel):
    user_id: str
    model_id: str
    vectors: list[list[float]]
    metadata: list[dict] | None = None

    @model_validator(mode="after")
    def _lengths_match(self):
        if self.metadata is not None and len(self.metadata) != len(self.vectors):
            raise ValueError("metadata length must equal vectors length")
        if not self.vectors:
            raise ValueError("vectors must be non-empty")
        return self


class VectorDeleteRequest(BaseModel):
    user_id: str
    model_id: str
    indices: list[int]

    @field_validator("indices")
    @classmethod
    def _non_empty_ids(cls, v):
        if not v:
            raise ValueError("indices must be non-empty")
        return v


class VectorQueryRequest(BaseModel):
    user_id: str
    model_id: str
    query: list[float]
    k: int = Field(default=10, ge=1, le=1000)
    filter_metadata: dict | None = None
    use_ann: bool = True
    # quantized stores: oversample k*4 on the quantized engine, re-score
    # against the original f32 rows host-side (exact ordering)
    rerank: bool = False


class BatchQueryRequest(BaseModel):
    user_id: str
    model_id: str
    queries: list[list[float]]
    k: int = Field(default=10, ge=1, le=1000)
    filter_metadata: dict | None = None
    use_ann: bool = True
    rerank: bool = False

    @field_validator("queries")
    @classmethod
    def _non_empty(cls, v):
        if not v:
            raise ValueError("queries must be non-empty")
        return v


class QueryResult(BaseModel):
    index: int
    similarity: float
    distance: float
    metadata: dict
    rank: int


class QueryResponse(BaseModel):
    results: list[QueryResult]
    query_time_ms: float
    store_count: int
    metric: MetricType


class BatchQueryResponse(BaseModel):
    results: list[list[QueryResult]]
    query_time_ms: float
    store_count: int
    metric: MetricType


class CreateStoreRequest(BaseModel):
    user_id: str
    model_id: str
    dimension: int = Field(default=384, ge=1, le=8192)
    metric: MetricType = MetricType.cosine
    index_type: IndexType = IndexType.flat
    # int8/int4 capacity modes are cosine-only; engines: exact scan +
    # gather-layout IVF (no beam graph). The store config cross-validates
    # (store/config.py) and the route surfaces its ValueError as a 400
    storage_dtype: str = Field(default="float32",
                               pattern="^(float32|bfloat16|int8|int4)$")
    ann_params: dict | None = None
    # planned row count: checked against the device-HBM budget at creation
    # (store/config.py check_device_budget) — over-budget requests get a
    # 413 naming the int8/int4 capacity modes and the max feasible rows
    expected_rows: int | None = Field(default=None, ge=1)


class DeleteStoreRequest(BaseModel):
    user_id: str
    model_id: str
    force: bool = False


class OptimizeStoreRequest(BaseModel):
    user_id: str
    model_id: str


class BenchmarkRequest(BaseModel):
    user_id: str = "bench"
    model_id: str = "bench"
    num_vectors: int = Field(default=1000, ge=10, le=1_000_000)
    dimension: int = Field(default=384, ge=8, le=4096)
    num_queries: int = Field(default=100, ge=1, le=10_000)
    k: int = Field(default=10, ge=1, le=1000)


class StoreStatsResponse(BaseModel):
    user_id: str
    model_id: str
    vector_count: int
    dimension: int
    metric: str
    index_type: str
    memory_usage_mb: float
    storage_dtype: str = "float32"


class HealthResponse(BaseModel):
    status: str
    timestamp: float = Field(default_factory=time.time)
    checks: dict = Field(default_factory=dict)


class ErrorResponse(BaseModel):
    error: str
    code: int
    timestamp: float = Field(default_factory=time.time)
    request_id: str | None = None


class ServerConfigResponse(BaseModel):
    environment: str
    backend: str
    device_count: int
    features: dict
    limits: dict
