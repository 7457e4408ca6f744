"""Tiered rate limiting.

Capability parity with reference api/middleware/rate_limiting.py:34-384:
UserTier x OperationType -> RateLimitConfig(requests_per_minute,
requests_per_hour, burst_allowance, concurrent_requests); an in-memory
backend; a Redis backend slot with automatic fallback (Redis is not in this
image, so the backend is gated and falls back cleanly — same behavior as the
reference's fallback path :278-288); middleware adds X-RateLimit-* headers,
429 + Retry-After, and releases concurrent slots in finally. Improvement
over the reference: sliding-window counters instead of fixed windows (no
2x burst at window boundaries).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from enum import Enum

logger = logging.getLogger(__name__)


class UserTier(Enum):
    FREE = "free"
    PREMIUM = "premium"
    ENTERPRISE = "enterprise"


class OperationType(Enum):
    QUERY = "query"
    ADD_VECTORS = "add_vectors"
    BATCH_QUERY = "batch_query"
    ADMIN = "admin"
    HEALTH = "health"


@dataclass(frozen=True)
class RateLimitConfig:
    requests_per_minute: int
    requests_per_hour: int
    burst_allowance: int
    concurrent_requests: int


# tier x operation policy table (parity with reference :44-79)
POLICIES: dict[tuple[UserTier, OperationType], RateLimitConfig] = {
    (UserTier.FREE, OperationType.QUERY): RateLimitConfig(60, 1000, 10, 4),
    (UserTier.FREE, OperationType.ADD_VECTORS): RateLimitConfig(30, 500, 5, 2),
    (UserTier.FREE, OperationType.BATCH_QUERY): RateLimitConfig(10, 100, 2, 1),
    (UserTier.FREE, OperationType.ADMIN): RateLimitConfig(10, 100, 2, 1),
    (UserTier.FREE, OperationType.HEALTH): RateLimitConfig(120, 2000, 20, 8),
    (UserTier.PREMIUM, OperationType.QUERY): RateLimitConfig(600, 20000, 50, 16),
    (UserTier.PREMIUM, OperationType.ADD_VECTORS): RateLimitConfig(300, 10000, 25, 8),
    (UserTier.PREMIUM, OperationType.BATCH_QUERY): RateLimitConfig(100, 2000, 10, 4),
    (UserTier.PREMIUM, OperationType.ADMIN): RateLimitConfig(60, 1000, 10, 2),
    (UserTier.PREMIUM, OperationType.HEALTH): RateLimitConfig(600, 20000, 50, 16),
    (UserTier.ENTERPRISE, OperationType.QUERY): RateLimitConfig(6000, 200000, 500, 64),
    (UserTier.ENTERPRISE, OperationType.ADD_VECTORS): RateLimitConfig(3000, 100000, 250, 32),
    (UserTier.ENTERPRISE, OperationType.BATCH_QUERY): RateLimitConfig(1000, 20000, 100, 16),
    (UserTier.ENTERPRISE, OperationType.ADMIN): RateLimitConfig(600, 10000, 50, 8),
    (UserTier.ENTERPRISE, OperationType.HEALTH): RateLimitConfig(6000, 200000, 500, 64),
}


@dataclass
class RateLimitDecision:
    allowed: bool
    limit: int
    remaining: int
    reset_after_s: float
    retry_after_s: float = 0.0
    reason: str = ""


class InMemoryRateLimiter:
    """Sliding-window counters + concurrent slot tracking under one lock.

    Keys are bounded: idle entries (empty windows, no concurrent slots) are
    evicted on a periodic sweep and the total tracked-key count is capped —
    an unauthenticated client rotating Authorization headers can't grow
    server memory without bound."""

    def __init__(self, max_keys: int = 100_000,
                 sweep_interval_s: float = 60.0) -> None:
        self._lock = threading.Lock()
        self._minute: dict[str, deque[float]] = {}
        self._hour: dict[str, deque[float]] = {}
        self._concurrent: dict[str, int] = {}
        self._max_keys = max_keys
        self._sweep_interval = sweep_interval_s
        self._last_sweep = time.time()

    def _sweep(self, now: float) -> None:
        """Drop idle keys (call with the lock held)."""
        self._last_sweep = now
        for key in list(self._hour):
            hour = self._hour[key]
            while hour and hour[0] <= now - 3600:
                hour.popleft()
            if not hour and not self._concurrent.get(key):
                self._hour.pop(key, None)
                self._minute.pop(key, None)
                self._concurrent.pop(key, None)

    def check(self, key: str, cfg: RateLimitConfig) -> RateLimitDecision:
        now = time.time()
        with self._lock:
            if (now - self._last_sweep >= self._sweep_interval or
                    len(self._hour) > self._max_keys):
                self._sweep(now)
            if key not in self._hour and len(self._hour) >= self._max_keys:
                # table full even after a sweep: shed the new key rather
                # than grow without bound
                return RateLimitDecision(
                    False, cfg.requests_per_minute, 0, 1.0,
                    retry_after_s=1.0, reason="limiter at capacity")
            minute = self._minute.setdefault(key, deque())
            hour = self._hour.setdefault(key, deque())
            while minute and minute[0] <= now - 60:
                minute.popleft()
            while hour and hour[0] <= now - 3600:
                hour.popleft()

            minute_limit = cfg.requests_per_minute + cfg.burst_allowance
            if len(minute) >= minute_limit:
                return RateLimitDecision(
                    False, cfg.requests_per_minute, 0,
                    60 - (now - minute[0]),
                    retry_after_s=max(60 - (now - minute[0]), 1.0),
                    reason="per-minute limit")
            if len(hour) >= cfg.requests_per_hour:
                return RateLimitDecision(
                    False, cfg.requests_per_hour, 0,
                    3600 - (now - hour[0]),
                    retry_after_s=max(3600 - (now - hour[0]), 1.0),
                    reason="per-hour limit")
            if self._concurrent.get(key, 0) >= cfg.concurrent_requests:
                return RateLimitDecision(
                    False, cfg.concurrent_requests, 0, 1.0,
                    retry_after_s=1.0, reason="concurrency limit")

            minute.append(now)
            hour.append(now)
            self._concurrent[key] = self._concurrent.get(key, 0) + 1
            # report the EFFECTIVE minute limit (incl. burst) so
            # remaining <= limit always holds in the headers
            return RateLimitDecision(
                True, minute_limit,
                max(minute_limit - len(minute), 0),
                60.0)

    def release(self, key: str) -> None:
        with self._lock:
            if key in self._concurrent:
                self._concurrent[key] = max(self._concurrent[key] - 1, 0)


# Atomic check-and-charge: rejects consume NO quota (the round-1 pipeline
# charged rejected requests against the minute/hour windows, so a limited
# client hammering the API extended its own lockout forever). Same shape as
# the reference's Lua approach (api/middleware/rate_limiting.py:160-260).
_REDIS_CHECK_LUA = """
local m = tonumber(redis.call('GET', KEYS[1]) or '0')
local h = tonumber(redis.call('GET', KEYS[2]) or '0')
local c = tonumber(redis.call('GET', KEYS[3]) or '0')
local minute_limit = tonumber(ARGV[1])
local hour_limit = tonumber(ARGV[2])
local conc_limit = tonumber(ARGV[3])
if m >= minute_limit then return {0, 1, minute_limit - m} end
if h >= hour_limit then return {0, 2, hour_limit - h} end
if c >= conc_limit then return {0, 3, conc_limit - c} end
m = redis.call('INCR', KEYS[1])
redis.call('EXPIRE', KEYS[1], 120)
redis.call('INCR', KEYS[2])
redis.call('EXPIRE', KEYS[2], 7200)
redis.call('INCR', KEYS[3])
redis.call('EXPIRE', KEYS[3], 30)
return {1, 0, minute_limit - m}
"""


class RedisRateLimiter:
    """Redis-backed variant. Primary path is an atomic Lua script (one
    round-trip, check-then-charge, rejects never consume quota); if the
    server rejects scripting (some proxies do), a GET+rollback pipeline
    fallback preserves the no-charge-on-reject semantics with a small
    over-reject-only race. Gated: raises at construction when the redis
    client isn't importable; ProductionRateLimiter then falls back to
    in-memory — same degradation path as the reference (:278-288)."""

    def __init__(self, url: str, client=None) -> None:
        if client is not None:
            self._client = client
        else:
            try:
                import redis as _redis
            except ImportError as exc:
                raise RuntimeError("redis client not available") from exc
            self._client = _redis.Redis.from_url(url, socket_timeout=0.5)
            self._client.ping()
        self._scripting = True

    def _keys(self, key: str) -> tuple[str, str, str]:
        now = int(time.time())
        return (f"rl:{key}:m:{now // 60}", f"rl:{key}:h:{now // 3600}",
                f"rl:{key}:c")

    @staticmethod
    def _reject(cfg: RateLimitConfig, reason: str) -> RateLimitDecision:
        retry = {"per-minute limit": 60.0, "per-hour limit": 3600.0,
                 "concurrency limit": 1.0}.get(reason, 60.0)
        return RateLimitDecision(False, cfg.requests_per_minute, 0, retry,
                                 retry_after_s=retry, reason=reason)

    def check(self, key: str, cfg: RateLimitConfig) -> RateLimitDecision:
        minute_key, hour_key, conc_key = self._keys(key)
        minute_limit = cfg.requests_per_minute + cfg.burst_allowance
        if self._scripting:
            try:
                allowed, which, headroom = self._client.eval(
                    _REDIS_CHECK_LUA, 3, minute_key, hour_key, conc_key,
                    minute_limit, cfg.requests_per_hour,
                    cfg.concurrent_requests)
                if int(allowed):
                    return RateLimitDecision(
                        True, minute_limit, max(int(headroom), 0), 60.0)
                reason = {1: "per-minute limit", 2: "per-hour limit",
                          3: "concurrency limit"}[int(which)]
                return self._reject(cfg, reason)
            except Exception as exc:  # noqa: BLE001 — scripting unsupported
                if "NOSCRIPT" in str(exc) or "unknown command" in str(exc).lower():
                    self._scripting = False
                else:
                    raise
        # fallback: optimistic check, charge, verify, roll back on reject.
        # Concurrent racers can transiently over-count and over-REJECT
        # (fail-safe); admission above the limit is impossible.
        pipe = self._client.pipeline()
        pipe.incr(minute_key)
        pipe.expire(minute_key, 120)
        pipe.incr(hour_key)
        pipe.expire(hour_key, 7200)
        pipe.incr(conc_key)
        pipe.expire(conc_key, 30)
        m, _, h, _, c, _ = pipe.execute()
        if m > minute_limit or h > cfg.requests_per_hour or \
                c > cfg.concurrent_requests:
            rollback = self._client.pipeline()
            rollback.decr(minute_key)
            rollback.decr(hour_key)
            rollback.decr(conc_key)
            rollback.execute()
            reason = ("per-minute limit" if m > minute_limit else
                      "per-hour limit" if h > cfg.requests_per_hour else
                      "concurrency limit")
            return self._reject(cfg, reason)
        return RateLimitDecision(True, minute_limit,
                                 max(minute_limit - int(m), 0), 60.0)

    def release(self, key: str) -> None:
        try:
            self._client.decr(self._keys(key)[2])
        except Exception:  # noqa: BLE001
            pass


_scale_cache: tuple[float, dict] | None = None


def _scaled(cfg: RateLimitConfig) -> RateLimitConfig:
    """Apply the deployment-wide policy multiplier VECTOR_DB_RATE_SCALE.

    The table above encodes the reference's multi-tenant SaaS posture
    (parity :44-79), but a dedicated/self-hosted deployment of a serving
    stack measured at 4-digit QPS needs proportionally higher ceilings
    without editing code. One float scales every limit in the table
    (requests/minute, /hour, burst, concurrency); default 1.0 = the
    reference posture. Read once per process (env changes need a
    restart, like the tier map)."""
    global _scale_cache
    scale = float(os.environ.get("VECTOR_DB_RATE_SCALE", "1.0"))
    if _scale_cache is None or _scale_cache[0] != scale:
        _scale_cache = (scale, {})
    if scale == 1.0:
        return cfg
    cache = _scale_cache[1]
    hit = cache.get(id(cfg))
    if hit is None:
        hit = RateLimitConfig(
            max(int(cfg.requests_per_minute * scale), 1),
            max(int(cfg.requests_per_hour * scale), 1),
            max(int(cfg.burst_allowance * scale), 1),
            max(int(cfg.concurrent_requests * scale), 1))
        cache[id(cfg)] = hit
    return hit


class ProductionRateLimiter:
    """Backend selection with automatic fallback (reference :262-301):
    Redis if REDIS_URL is set and reachable, else in-memory; a Redis failure
    at runtime fails open to in-memory."""

    def __init__(self, redis_url: str | None = None) -> None:
        self._memory = InMemoryRateLimiter()
        self._redis: RedisRateLimiter | None = None
        if redis_url:
            try:
                self._redis = RedisRateLimiter(redis_url)
                logger.info("rate limiter: redis backend at %s", redis_url)
            except Exception as exc:  # noqa: BLE001
                logger.warning("redis unavailable (%s); in-memory limiter", exc)

    def check(self, key: str, tier: UserTier,
              op: OperationType) -> RateLimitDecision:
        cfg = _scaled(POLICIES[(tier, op)])
        backend_key = f"{tier.value}:{op.value}:{key}"
        if self._redis is not None:
            try:
                return self._redis.check(backend_key, cfg)
            except Exception:  # noqa: BLE001 — fail over, then fail open
                logger.warning("redis limiter failed; using in-memory",
                               exc_info=True)
                self._redis = None
        return self._memory.check(backend_key, cfg)

    def release(self, key: str, tier: UserTier, op: OperationType) -> None:
        backend_key = f"{tier.value}:{op.value}:{key}"
        if self._redis is not None:
            try:
                self._redis.release(backend_key)
                return
            except Exception:  # noqa: BLE001
                self._redis = None
        self._memory.release(backend_key)


def classify_operation(path: str) -> OperationType:
    """URL path -> operation class (reference :308-333)."""
    if path.startswith("/admin"):
        return OperationType.ADMIN
    if "batch" in path or path.startswith("/v1/batch"):
        return OperationType.BATCH_QUERY
    if path.endswith("/add") or "upload" in path:
        return OperationType.ADD_VECTORS
    if "query" in path or "search" in path:
        return OperationType.QUERY
    return OperationType.HEALTH


def _load_tier_map() -> dict[str, UserTier]:
    """Extra key->tier assignments from VECTOR_DB_TIER_KEYS
    ("<key>:<tier>,<key>:<tier>"). Unknown tier names are skipped loudly."""

    out: dict[str, UserTier] = {}
    raw = os.environ.get("VECTOR_DB_TIER_KEYS", "")
    for entry in filter(None, (e.strip() for e in raw.split(","))):
        key, _, tier_name = entry.rpartition(":")
        try:
            out[key] = UserTier(tier_name.strip().lower())
        except ValueError:
            logger.warning("VECTOR_DB_TIER_KEYS: unknown tier %r", tier_name)
    return out


_tier_map: dict[str, UserTier] | None = None


def classify_tier(authorization: str | None) -> UserTier:
    """Auth header -> tier via VALIDATED key lookup (constant-time compares).

    The reference (:308-320) and round 1 classified by header substring,
    which let clients self-select PREMIUM/ENTERPRISE limits before auth ran.
    Here only credentials that actually verify earn a paid tier: the admin
    key is ENTERPRISE, the service key is PREMIUM (override with
    VECTOR_DB_API_TIER), additional keys map through VECTOR_DB_TIER_KEYS,
    and everything else — including unauthenticated traffic — is FREE."""

    from tpu_vector_db_torch.security.auth import (_extract_bearer, auth_config,
                                             ct_equal)

    token = _extract_bearer(authorization)
    if not token:
        return UserTier.FREE
    if ct_equal(token, auth_config.admin_key):
        return UserTier.ENTERPRISE
    if ct_equal(token, auth_config.api_key):
        try:
            return UserTier(os.environ.get("VECTOR_DB_API_TIER",
                                           "premium").lower())
        except ValueError:
            return UserTier.PREMIUM
    global _tier_map
    if _tier_map is None:
        _tier_map = _load_tier_map()
    for key, tier in _tier_map.items():
        if ct_equal(token, key):
            return tier
    return UserTier.FREE
