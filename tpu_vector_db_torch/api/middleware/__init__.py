from tpu_vector_db_torch.api.middleware.rate_limiting import (  # noqa: F401
    OperationType,
    ProductionRateLimiter,
    RateLimitConfig,
    UserTier,
)
