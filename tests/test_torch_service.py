"""Service-layer unit tests of the torch port: circuit breaker, retry,
degradation, error handler, manager lifecycle, metrics registry (the
cases of tests/test_service.py), and the serving cases of
tests/test_hardening.py: manager reopen, tenant directory encoding, the
legacy-directory fallback and collision (on stores the JAX package
wrote), breaker classification, the rate limiter. Stores run on the CPU
(``device="cpu"``)."""

import time

import numpy as np
import pytest
import torch

from tpu_vector_db_torch.monitoring.metrics import (
    Counter, Gauge, Histogram, MetricsRegistry)
from tpu_vector_db_torch.service.errors import (
    ErrorCategory, ErrorContext, StorageCorruptionError, classify_exception)
from tpu_vector_db_torch.service.error_handler import ErrorHandler
from tpu_vector_db_torch.service.manager import VectorStoreManager
from tpu_vector_db_torch.service.resilience import (
    CircuitBreaker, CircuitBreakerConfig, CircuitBreakerOpenError,
    CircuitState, DegradationLevel, GracefulDegradationManager, RetryConfig,
    RetryHandler)
from tpu_vector_db_torch.store.config import VectorStoreConfig


def manager(tmp_path, **kw) -> VectorStoreManager:
    """A CPU manager whose error log lies under tmp_path."""
    return VectorStoreManager(base_path=tmp_path, device="cpu",
                              errors=ErrorHandler(tmp_path / "logs"), **kw)


class TestCircuitBreaker:
    def make(self, **kw):
        return CircuitBreaker("t", CircuitBreakerConfig(
            failure_threshold=3, recovery_timeout_s=0.05,
            success_threshold=2, **kw))

    def test_opens_after_threshold(self):
        cb = self.make()
        for _ in range(3):
            with pytest.raises(OSError):
                cb.call(lambda: (_ for _ in ()).throw(OSError("x")))
        assert cb.state == CircuitState.OPEN
        with pytest.raises(CircuitBreakerOpenError):
            cb.call(lambda: 1)

    def test_half_open_then_close(self):
        cb = self.make()
        for _ in range(3):
            with pytest.raises(OSError):
                cb.call(lambda: (_ for _ in ()).throw(OSError("x")))
        time.sleep(0.06)
        assert cb.state == CircuitState.HALF_OPEN
        assert cb.call(lambda: 42) == 42
        assert cb.call(lambda: 43) == 43
        assert cb.state == CircuitState.CLOSED

    def test_half_open_failure_reopens(self):
        cb = self.make()
        for _ in range(3):
            with pytest.raises(OSError):
                cb.call(lambda: (_ for _ in ()).throw(OSError("x")))
        time.sleep(0.06)
        with pytest.raises(OSError):
            cb.call(lambda: (_ for _ in ()).throw(OSError("y")))
        assert cb.state == CircuitState.OPEN

    def test_success_resets_failure_count(self):
        cb = self.make()
        for _ in range(2):
            with pytest.raises(OSError):
                cb.call(lambda: (_ for _ in ()).throw(OSError("x")))
        cb.call(lambda: 1)  # resets
        for _ in range(2):
            with pytest.raises(OSError):
                cb.call(lambda: (_ for _ in ()).throw(OSError("x")))
        assert cb.state == CircuitState.CLOSED


class TestRetry:
    def test_retries_then_succeeds(self):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        rh = RetryHandler({"storage": RetryConfig(
            max_attempts=5, base_delay_s=0.001)})
        assert rh.run("storage", flaky) == "ok"
        assert len(calls) == 3

    def test_exhausts_and_raises(self):
        rh = RetryHandler({"storage": RetryConfig(
            max_attempts=2, base_delay_s=0.001)})
        with pytest.raises(OSError):
            rh.run("storage", lambda: (_ for _ in ()).throw(OSError("x")))

    def test_non_retryable_raises_immediately(self):
        calls = []

        def bad():
            calls.append(1)
            raise ValueError("permanent")

        rh = RetryHandler()
        with pytest.raises(ValueError):
            rh.run("storage", bad)
        assert len(calls) == 1


class TestDegradation:
    def test_error_rate_raises_level(self):
        mgr = GracefulDegradationManager(
            memory_thresholds=(2.0, 2.0, 2.0),   # unreachable
            error_rate_thresholds=(0.1, 0.5, 0.9))
        for _ in range(20):
            mgr.record_request(failed=False)
        assert mgr.evaluate() == DegradationLevel.NORMAL
        for _ in range(10):
            mgr.record_request(failed=True)
        level = mgr.evaluate()
        assert level.value >= DegradationLevel.REDUCED.value
        assert mgr.feature_enabled("batching")

    def test_feature_gating(self):
        mgr = GracefulDegradationManager()
        assert mgr.feature_enabled("ann")
        assert mgr.feature_enabled("caching")

    def test_error_rate_uses_recent_window_not_lifetime(self):
        """A long healthy history must not mask a current error storm:
        the rate divides the 60s error count by the 60s request estimate,
        not the lifetime total (review finding)."""
        mgr = GracefulDegradationManager(
            memory_thresholds=(2.0, 2.0, 2.0),
            error_rate_thresholds=(0.1, 0.5, 0.9))
        for _ in range(10_000):           # long healthy lifetime
            mgr._requests += 1            # simulate old traffic directly
        for _ in range(10):
            mgr.record_request(failed=True)
        for _ in range(10):
            mgr.record_request(failed=False)
        # 10 errors / ~20 recent requests = 50% >> lifetime 10/10020
        assert mgr.evaluate().value >= DegradationLevel.REDUCED.value

    def test_level_recovers_when_errors_age_out(self, monkeypatch):
        import time as _time
        mgr = GracefulDegradationManager(
            memory_thresholds=(2.0, 2.0, 2.0),
            error_rate_thresholds=(0.1, 0.5, 0.9))
        for _ in range(10):
            mgr.record_request(failed=True)
        assert mgr.evaluate().value >= DegradationLevel.REDUCED.value
        real = _time.time
        monkeypatch.setattr(_time, "time", lambda: real() + 70.0)
        for _ in range(20):
            mgr.record_request(failed=False)
        assert mgr.evaluate() == DegradationLevel.NORMAL

    def test_per_tenant_breaker_isolation(self, tmp_path):
        """One tenant's failing store must not open every tenant's
        breaker (review finding)."""
        h = ErrorHandler(error_log_dir=tmp_path)
        bad = h.breaker("vector_query:a/m")
        good = h.breaker("vector_query:b/m")

        def boom():
            raise OSError("corrupt store")

        for _ in range(10):
            try:
                bad.call(boom)
            except Exception:  # noqa: BLE001
                pass
        assert bad.state.value == "open"
        assert good.state.value == "closed"
        assert good.call(lambda: 42) == 42


class TestErrorHandler:
    def test_context_classifies_and_records(self, tmp_path):
        h = ErrorHandler(error_log_dir=tmp_path)
        with pytest.raises(Exception):
            with h.error_context("test_op"):
                raise ValueError("bad input")
        stats = h.get_error_stats()
        assert stats["total_errors"] == 1
        assert stats["by_category"]["validation"] == 1

    def test_health_score(self, tmp_path):
        h = ErrorHandler(error_log_dir=tmp_path)
        health = h.health_check()
        assert health["score"] >= 80
        assert health["status"] == "healthy"

    def test_dump_history(self, tmp_path):
        h = ErrorHandler(error_log_dir=tmp_path)
        with pytest.raises(Exception):
            with h.error_context("op"):
                raise OSError("disk")
        h.dump_history()
        assert (tmp_path / "error_history.json").exists()

    def test_classification(self):
        assert classify_exception(MemoryError())[0] == ErrorCategory.MEMORY
        assert classify_exception(OSError())[0] == ErrorCategory.STORAGE
        assert classify_exception(TypeError())[0] == ErrorCategory.VALIDATION
        # TimeoutError IS an OSError subclass: must classify as TIMEOUT,
        # not STORAGE (review finding)
        assert classify_exception(TimeoutError())[0] == ErrorCategory.TIMEOUT
        exc = RuntimeError("RESOURCE_EXHAUSTED: out of memory on device")
        assert classify_exception(exc)[0] == ErrorCategory.MEMORY
        ctx = ErrorContext.from_exception(ValueError("x"), "op", "u", "m")
        assert ctx.user_id == "u" and ctx.category == ErrorCategory.VALIDATION
        assert isinstance(StorageCorruptionError("x"), Exception)

    def test_cuda_out_of_memory_is_memory_high(self, tmp_path):
        """torch's CUDA out-of-memory error (a RuntimeError) is MEMORY /
        HIGH, and its recovery runs without a card."""
        from tpu_vector_db_torch.service.errors import ErrorSeverity
        exc = torch.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 3.00 GiB")
        assert classify_exception(exc) == (ErrorCategory.MEMORY,
                                           ErrorSeverity.HIGH)
        h = ErrorHandler(error_log_dir=tmp_path)
        with pytest.raises(Exception):
            with h.error_context("query"):
                raise exc
        stats = h.get_error_stats()
        assert stats["by_category"] == {"memory": 1}
        assert stats["recovery_rate"] == 1.0


class TestManager:
    def test_lifecycle(self, tmp_path, rng):
        mgr = manager(tmp_path)
        store = mgr.create_store("u", "m", VectorStoreConfig(
            dimension=16, persist_mode="lazy"))
        with pytest.raises(FileExistsError):
            mgr.create_store("u", "m", VectorStoreConfig(dimension=16))
        store.add_vectors(rng.standard_normal((5, 16)).astype(np.float32))
        assert mgr.store_exists("u", "m")
        assert mgr.get_stats()["total_vectors"] == 5
        with pytest.raises(ValueError):
            mgr.delete_store("u", "m")          # non-empty
        mgr.delete_store("u", "m", force=True)
        assert not mgr.store_exists("u", "m")
        mgr.shutdown()

    def test_list_and_warmup(self, tmp_path, rng):
        mgr = manager(tmp_path)
        s = mgr.get_store("a", "m1", VectorStoreConfig(
            dimension=8, persist_mode="lazy"))
        s.add_vectors(rng.standard_normal((3, 8)).astype(np.float32))
        s.flush()
        listed = mgr.list_stores()
        assert any(e["user_id"] == "a" and e["model_id"] == "m1"
                   for e in listed)
        warmed = mgr.warmup_all_stores()
        assert warmed["a/m1"]["warmed"]
        mgr.shutdown()

    def test_sharded_and_multihost_manager(self, tmp_path, monkeypatch,
                                           rng):
        """sharded=True and VECTOR_DB_SHARDED=1 make ShardedVectorStores
        that answer as an unsharded store does. Under VECTOR_DB_COORDINATOR
        the manager has the collective watchdog on (its timeout from
        VECTOR_DB_COLLECTIVE_TIMEOUT_S, 120 s by default), unlatched."""
        from tpu_vector_db_torch.parallel import ShardedVectorStore
        x = rng.standard_normal((300, 16)).astype(np.float32)
        q = rng.standard_normal((5, 16)).astype(np.float32)
        plain = manager(tmp_path / "plain")
        want = plain.create_store("u", "m", VectorStoreConfig(dimension=16))
        want.add_vectors(x)
        for sub, kw in (("arg", {"sharded": True}), ("env", {})):
            if not kw:
                monkeypatch.setenv("VECTOR_DB_SHARDED", "1")
            mgr = manager(tmp_path / sub, **kw)
            store = mgr.create_store("u", "m",
                                     VectorStoreConfig(dimension=16))
            assert isinstance(store, ShardedVectorStore)
            assert store.get_stats()["sharded"]
            store.add_vectors(x)
            for got, exp in zip(store.batch_query(q, k=7),
                                want.batch_query(q, k=7)):
                assert got[0] == exp[0]
                np.testing.assert_allclose(got[1], exp[1], atol=1e-6)
            mgr.shutdown()
        plain.shutdown()
        monkeypatch.delenv("VECTOR_DB_SHARDED")
        assert not plain._multihost
        monkeypatch.setenv("VECTOR_DB_COORDINATOR", "localhost:1234")
        mgr = manager(tmp_path)
        assert mgr._multihost and mgr._collective_timeout_s == 120.0
        assert not mgr.peer_lost
        mgr.shutdown()
        monkeypatch.setenv("VECTOR_DB_COLLECTIVE_TIMEOUT_S", "7.5")
        mgr = manager(tmp_path)
        assert mgr._multihost and mgr._collective_timeout_s == 7.5
        mgr.shutdown()

    def test_cuda_store_raises_without_card(self, tmp_path, monkeypatch):
        """A manager asked for the card makes no store where there is
        none; it does not carry on on the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        mgr = VectorStoreManager(base_path=tmp_path,
                                 errors=ErrorHandler(tmp_path / "logs"))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mgr.create_store("u", "m", VectorStoreConfig(dimension=8))
        assert not mgr.store_exists("u", "m")
        mgr.shutdown()

    def test_path_sanitization(self, tmp_path):
        mgr = manager(tmp_path)
        p = mgr._store_path("../evil", "m/../../x")
        assert str(tmp_path) in str(p)
        assert ".." not in str(p.relative_to(tmp_path))
        mgr.shutdown()


class TestMetrics:
    def test_counter_gauge(self):
        c = Counter("c1")
        c.inc()
        c.inc(2)
        assert c.value == 3
        g = Gauge("g1")
        g.set(5)
        g.dec()
        assert g.value == 4

    def test_histogram_buckets_and_percentiles(self):
        h = Histogram("h1", buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05, 0.5, 5.0):
            h.observe(v)
        snap = h.snapshot()
        assert snap["count"] == 4
        assert snap["buckets"]["0.01"] == 1
        assert snap["buckets"]["+Inf"] == 4
        assert h.percentile(0.5) in (0.05, 0.5)

    def test_registry_exposition(self):
        reg = MetricsRegistry()
        reg.counter("http_requests_total").inc()
        text = reg.get_prometheus_format()
        assert "# TYPE http_requests_total counter" in text
        assert "http_requests_total 1.0" in text
        assert "# TYPE http_request_duration_seconds histogram" in text
        summary = reg.summary()
        assert summary["http_requests"] == 1


class TestCoalescerShutdown:
    def test_aclose_waits_for_inflight_flush(self):
        """aclose must not return until the flushed batch_query finishes —
        otherwise manager.shutdown() races the device sweep and every
        waiter gets a spurious shutdown error (review finding)."""
        import asyncio
        import types

        from tpu_vector_db_torch.service.batcher import QueryCoalescer

        class FakeManager:
            def __init__(self):
                self.calls = 0

            def get_store(self, u, m, create=True):
                return types.SimpleNamespace(
                    config=types.SimpleNamespace(dimension=4))

            async def batch_query_async(self, u, m, arr, k=10,
                                        use_ann=True, **kw):
                await asyncio.sleep(0.05)  # simulate the device sweep
                self.calls += 1
                return [([i], [1.0], [None]) for i in range(len(arr))]

        async def go():
            mgr = FakeManager()
            # window longer than the test: only aclose can flush
            coal = QueryCoalescer(mgr, window_ms=10_000, max_batch=64)
            task = asyncio.ensure_future(
                coal.query("u", "m", np.zeros(4, np.float32), 1))
            await asyncio.sleep(0.01)  # let the query join its lane
            await coal.aclose()
            # the in-flight sweep COMPLETED before aclose returned
            assert mgr.calls == 1
            ids, scores, meta = await asyncio.wait_for(task, 0.5)
            assert ids == [0]

        asyncio.run(go())


class TestManagerReopen:
    def test_manager_reopen_after_restart(self, tmp_path, rng):
        mgr = manager(tmp_path)
        cfg = VectorStoreConfig(dimension=768, metric="dot_product")
        mgr.create_store("u", "m", cfg)
        store = mgr.get_store("u", "m")
        store.add_vectors(rng.standard_normal((10, 768)).astype(np.float32))
        mgr.shutdown()

        mgr2 = manager(tmp_path)  # "restart"
        store2 = mgr2.get_store("u", "m", create=False)
        assert store2.config.dimension == 768
        assert store2.config.metric == "dot_product"
        assert len(store2) == 10
        mgr2.shutdown()


class TestBreakerWhitelist:
    def test_validation_errors_do_not_open(self):
        br = CircuitBreaker("t", CircuitBreakerConfig(failure_threshold=3))

        def bad_request():
            raise ValueError("dim mismatch")

        for _ in range(20):
            with pytest.raises(ValueError):
                br.call(bad_request)
        assert br.state == CircuitState.CLOSED
        assert br.call(lambda: 42) == 42

    def test_real_failures_still_open(self):
        br = CircuitBreaker("t", CircuitBreakerConfig(failure_threshold=3))

        def boom():
            raise OSError("disk gone")

        for _ in range(3):
            with pytest.raises(OSError):
                br.call(boom)
        assert br.state == CircuitState.OPEN
        with pytest.raises(CircuitBreakerOpenError):
            br.call(lambda: 42)

    def test_validation_error_does_not_close_half_open(self):
        br = CircuitBreaker("t", CircuitBreakerConfig(
            failure_threshold=1, recovery_timeout_s=0.0,
            success_threshold=1))
        with pytest.raises(OSError):
            br.call(lambda: (_ for _ in ()).throw(OSError()))
        assert br.state in (CircuitState.OPEN, CircuitState.HALF_OPEN)
        with pytest.raises(ValueError):
            br.call(lambda: (_ for _ in ()).throw(ValueError()))
        # a client error while HALF_OPEN is not a probe success
        assert br.state == CircuitState.HALF_OPEN


class TestTenantPathEncoding:
    def test_distinct_ids_distinct_dirs(self, tmp_path):
        mgr = manager(tmp_path)
        assert mgr._store_path("a.b", "m") != mgr._store_path("a_b", "m")
        assert mgr._store_path("a%2Eb", "m") != mgr._store_path("a.b", "m")
        mgr.shutdown()

    def test_roundtrip_through_list_stores(self, tmp_path, rng):
        mgr = manager(tmp_path)
        cfg = VectorStoreConfig(dimension=8)
        mgr.create_store("user.name", "model/v1", cfg)
        listed = mgr.list_stores()
        assert [(e["user_id"], e["model_id"]) for e in listed] == \
            [("user.name", "model/v1")]
        mgr.shutdown()

    def test_empty_id_rejected(self, tmp_path):
        mgr = manager(tmp_path)
        with pytest.raises(ValueError):
            mgr._store_path("", "m")
        mgr.shutdown()


class TestLimiterEviction:
    def test_idle_keys_evicted(self):
        from tpu_vector_db_torch.api.middleware.rate_limiting import (
            InMemoryRateLimiter, RateLimitConfig)
        lim = InMemoryRateLimiter(sweep_interval_s=0.0)
        cfg = RateLimitConfig(10, 100, 0, 4)
        for i in range(50):
            d = lim.check(f"key{i}", cfg)
            assert d.allowed
            lim.release(f"key{i}")
        # age every timestamp past the hour window, then trigger a sweep
        for dq in list(lim._hour.values()) + list(lim._minute.values()):
            for j in range(len(dq)):
                dq[j] -= 7200
        lim.check("fresh", cfg)
        assert len(lim._hour) <= 2  # only "fresh" (+ tolerance)

    def test_key_cap_sheds_new_keys(self):
        from tpu_vector_db_torch.api.middleware.rate_limiting import (
            InMemoryRateLimiter, RateLimitConfig)
        lim = InMemoryRateLimiter(max_keys=10, sweep_interval_s=3600.0)
        cfg = RateLimitConfig(10, 100, 0, 4)
        for i in range(10):
            assert lim.check(f"key{i}", cfg).allowed
        d = lim.check("key-new", cfg)
        assert not d.allowed and "capacity" in d.reason
        # existing keys still work
        assert lim.check("key0", cfg).allowed


class TestTierLookup:
    def test_substring_self_selection_is_gone(self):
        from tpu_vector_db_torch.api.middleware.rate_limiting import (
            UserTier, classify_tier)
        assert classify_tier("Bearer i-am-enterprise-premium-admin") == \
            UserTier.FREE
        assert classify_tier(None) == UserTier.FREE

    def test_validated_keys_map_to_tiers(self):
        from tpu_vector_db_torch.api.middleware.rate_limiting import (
            UserTier, classify_tier)
        from tpu_vector_db_torch.security.auth import auth_config
        assert classify_tier(f"Bearer {auth_config.api_key}") == \
            UserTier.PREMIUM
        assert classify_tier(f"Bearer {auth_config.admin_key}") == \
            UserTier.ENTERPRISE

    def test_tier_map_env(self, monkeypatch):
        import tpu_vector_db_torch.api.middleware.rate_limiting as rl
        monkeypatch.setenv("VECTOR_DB_TIER_KEYS",
                           "tvdb_cust_abc:enterprise, tvdb_cust_def:free")
        monkeypatch.setattr(rl, "_tier_map", None)
        assert rl.classify_tier("Bearer tvdb_cust_abc") == \
            rl.UserTier.ENTERPRISE
        assert rl.classify_tier("Bearer tvdb_cust_def") == rl.UserTier.FREE
        monkeypatch.setattr(rl, "_tier_map", None)


class _FakePipeline:
    def __init__(self, store):
        self._store = store
        self._ops = []

    def incr(self, key):
        self._ops.append(("incr", key))
        return self

    def decr(self, key):
        self._ops.append(("decr", key))
        return self

    def expire(self, key, ttl):
        self._ops.append(("expire", key))
        return self

    def execute(self):
        out = []
        for op, key in self._ops:
            if op == "incr":
                self._store[key] = self._store.get(key, 0) + 1
                out.append(self._store[key])
            elif op == "decr":
                self._store[key] = self._store.get(key, 0) - 1
                out.append(self._store[key])
            else:
                out.append(True)
        self._ops = []
        return out


class _FakeRedis:
    """Minimal command-level redis stand-in (no Lua scripting)."""

    def __init__(self):
        self.kv: dict[str, int] = {}

    def eval(self, *a, **k):
        raise RuntimeError("ERR unknown command 'EVAL'")

    def pipeline(self):
        return _FakePipeline(self.kv)

    def decr(self, key):
        self.kv[key] = self.kv.get(key, 0) - 1
        return self.kv[key]


class TestRedisLimiterSemantics:
    def test_rejected_requests_consume_no_quota(self):
        from tpu_vector_db_torch.api.middleware.rate_limiting import (
            RateLimitConfig, RedisRateLimiter)
        lim = RedisRateLimiter("redis://fake", client=_FakeRedis())
        cfg = RateLimitConfig(requests_per_minute=3, requests_per_hour=100,
                              burst_allowance=0, concurrent_requests=100)
        for _ in range(3):
            d = lim.check("k", cfg)
            assert d.allowed
            lim.release("k")
        # now at the minute limit: rejects must not extend the lockout
        for _ in range(25):
            d = lim.check("k", cfg)
            assert not d.allowed and d.reason == "per-minute limit"
        minute_key = lim._keys("k")[0]
        assert lim._client.kv[minute_key] == 3  # unchanged by 25 rejects

    def test_concurrency_rollback_releases_window_charge(self):
        from tpu_vector_db_torch.api.middleware.rate_limiting import (
            RateLimitConfig, RedisRateLimiter)
        lim = RedisRateLimiter("redis://fake", client=_FakeRedis())
        cfg = RateLimitConfig(requests_per_minute=100, requests_per_hour=100,
                              burst_allowance=0, concurrent_requests=1)
        assert lim.check("k", cfg).allowed  # holds the one slot
        d = lim.check("k", cfg)
        assert not d.allowed and d.reason == "concurrency limit"
        minute_key = lim._keys("k")[0]
        assert lim._client.kv[minute_key] == 1  # reject rolled back


def test_legacy_tenant_dir_fallback(tmp_path, rng):
    """Stores created under the round-1 lossy dir encoding stay reachable
    by their original tenant id after the reversible-encoding upgrade."""
    # the legacy directory is written by the JAX package's store: the
    # on-disk format is shared
    from tpu_vector_db.store import TPUVectorStore
    from tpu_vector_db.store import VectorStoreConfig as JaxConfig
    mgr = manager(tmp_path / "stores")
    legacy = tmp_path / "stores" / "a_b" / "m_1"  # 'a.b' under old scheme
    legacy.mkdir(parents=True)
    st = TPUVectorStore(legacy, JaxConfig(dimension=8))
    st.add_vectors(rng.standard_normal((5, 8)).astype(np.float32))
    st.flush()
    st.close()
    got = mgr.get_store("a.b", "m.1", create=False)
    assert got.vector_count == 5
    # access MIGRATES the legacy dir to the reversible-encoded path, so
    # the claim happens exactly once
    assert not (legacy / "manifest.json").exists()
    enc = tmp_path / "stores" / "a%2Eb" / "m%2E1"
    assert (enc / "manifest.json").exists()


def test_legacy_collision_does_not_leak_across_tenants(tmp_path, rng):
    """Distinct tenant ids whose LEGACY encodings collide ('a.b', 'a b',
    'a_b' all -> 'a_b') must not all resolve to the same pre-upgrade
    directory: the first claimant migrates it, later ids get fresh
    stores (review finding: cross-tenant data exposure)."""
    # the legacy directory is written by the JAX package's store: the
    # on-disk format is shared
    from tpu_vector_db.store import TPUVectorStore
    from tpu_vector_db.store import VectorStoreConfig as JaxConfig
    mgr = manager(tmp_path / "stores")
    legacy = tmp_path / "stores" / "a_b" / "m"
    legacy.mkdir(parents=True)
    st = TPUVectorStore(legacy, JaxConfig(dimension=8))
    st.add_vectors(rng.standard_normal((5, 8)).astype(np.float32))
    st.flush()
    st.close()
    first = mgr.get_store("a.b", "m", create=False)  # claims the legacy dir
    assert first.vector_count == 5
    # a DIFFERENT tenant with the same legacy encoding now gets a fresh
    # store, not tenant a.b's data
    assert not mgr.store_exists("a b", "m")
    other = mgr.create_store("a b", "m", VectorStoreConfig(dimension=8))
    assert other.vector_count == 0
    assert first.vector_count == 5


def test_worker_pool_stress(tmp_path):
    """More workers than cores, a short switch interval: concurrent
    coalesced queries, batch queries and adds through the manager lose
    no row and answer every self-query with its own row."""
    import asyncio
    import sys

    from tpu_vector_db_torch.service.batcher import QueryCoalescer

    g = np.random.default_rng(5)
    rows = g.standard_normal((600, 16)).astype(np.float32)
    mgr = manager(tmp_path, max_workers=16)
    mgr.create_store("u", "m", VectorStoreConfig(dimension=16,
                                                 persist_mode="lazy"))
    coal = QueryCoalescer(mgr, window_ms=2, max_batch=8)

    async def add(i):
        await mgr.add_vectors_async("u", "m", rows[i * 50:(i + 1) * 50],
                                    [{"i": j} for j in range(i * 50,
                                                             (i + 1) * 50)])

    async def query(i):
        await asyncio.sleep(0)
        ids, scores, _ = await coal.query("u", "m", rows[i], k=1)
        return ids[0] == i

    async def go():
        await add(0)
        jobs = [add(i) for i in range(1, 12)]
        jobs += [query(i) for i in range(50)]
        jobs += [mgr.batch_query_async("u", "m", rows[:50], k=1)
                 for _ in range(8)]
        out = await asyncio.wait_for(asyncio.gather(*jobs), timeout=120)
        await coal.aclose()
        return out

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        out = asyncio.run(go())
    finally:
        sys.setswitchinterval(old)
    assert all(out[11:61])
    for res in out[61:]:
        assert [ids[0] for ids, _, _ in res] == list(range(50))
    store = mgr.get_store("u", "m", create=False)
    assert len(store) == 600
    # the eleven concurrent adds land in whatever order the pool runs
    # them: every row keeps the metadata it was added with, none is lost
    meta = store.get_metadata(list(range(600)))
    assert sorted(m["i"] for m in meta) == list(range(600))
    found = store.batch_query(rows, k=1, use_ann=False)
    assert [meta[ids[0]]["i"] for ids, _, _ in found] == list(range(600))
    mgr.shutdown()
