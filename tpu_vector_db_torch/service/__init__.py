"""Service layer: multi-tenant store managers + production hardening.

Counterpart of the reference's service tier (SURVEY.md §2.D):
VectorStoreManager (api/routes/vectors.py:37-144), ProductionVectorStoreManager
(service/production_integration.py:39-128), and the error-handling machinery
in service/service_handling.py (error taxonomy, circuit breakers, retries,
graceful degradation, recovery).
"""

from tpu_vector_db_torch.service.errors import (  # noqa: F401
    ErrorCategory,
    ErrorContext,
    ErrorSeverity,
    ComputationError,
    MemoryPressureError,
    StorageCorruptionError,
    ValidationError,
    VectorDBError,
)
from tpu_vector_db_torch.service.resilience import (  # noqa: F401
    CircuitBreaker,
    CircuitBreakerConfig,
    CircuitBreakerOpenError,
    CircuitState,
    DegradationLevel,
    GracefulDegradationManager,
    RetryConfig,
    RetryHandler,
)
from tpu_vector_db_torch.service.error_handler import ErrorHandler, with_error_handling  # noqa: F401
from tpu_vector_db_torch.service.manager import VectorStoreManager, store_manager  # noqa: F401
