"""API-key auth (counterpart of reference security/auth.py)."""

from tpu_vector_db_torch.security.auth import (  # noqa: F401
    AuthConfig,
    auth_config,
    generate_api_key,
    hash_api_key,
    validate_key_format,
    verify_api_key,
    verify_admin_key,
)
