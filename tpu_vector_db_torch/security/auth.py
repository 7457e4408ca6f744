"""Bearer-token auth with constant-time comparison.

Capability parity with reference security/auth.py:34-195: two keys from env
(VECTOR_DB_API_KEY / VECTOR_DB_ADMIN_KEY) with generated dev defaults,
secrets.compare_digest checks, admin accepting the service key policy made
EXPLICIT (the reference quietly allowed it, :98-103 — here it's an opt-in
flag), key generation/hash/format helpers, and framework-agnostic verify
functions the aiohttp middleware calls (the reference bound these to FastAPI
dependencies).
"""

from __future__ import annotations

import hashlib
import logging
import os
import secrets
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)

KEY_PREFIX = "tvdb_"
KEY_BYTES = 24


def generate_api_key(prefix: str = KEY_PREFIX) -> str:
    return prefix + secrets.token_urlsafe(KEY_BYTES)


def hash_api_key(key: str) -> str:
    return hashlib.sha256(key.encode()).hexdigest()


def validate_key_format(key: str) -> bool:
    return (isinstance(key, str) and key.startswith(KEY_PREFIX)
            and len(key) >= len(KEY_PREFIX) + 16)


@dataclass
class AuthConfig:
    api_key: str = ""
    admin_key: str = ""
    # whether the plain service key is accepted for admin routes
    admin_accepts_api_key: bool = False
    dev_mode: bool = False
    generated: bool = field(default=False, repr=False)

    @classmethod
    def from_env(cls) -> "AuthConfig":
        env = os.environ
        dev = env.get("ENVIRONMENT", "development") != "production"
        api_key = env.get("VECTOR_DB_API_KEY", "")
        admin_key = env.get("VECTOR_DB_ADMIN_KEY", "")
        generated = False
        if not api_key:
            if not dev:
                raise RuntimeError(
                    "VECTOR_DB_API_KEY must be set in production")
            api_key = generate_api_key()
            generated = True
            logger.warning("dev API key generated: %s", api_key)
        if not admin_key:
            if not dev:
                raise RuntimeError(
                    "VECTOR_DB_ADMIN_KEY must be set in production")
            admin_key = generate_api_key(KEY_PREFIX + "admin_")
            generated = True
            logger.warning("dev admin key generated: %s", admin_key)
        return cls(api_key=api_key, admin_key=admin_key,
                   admin_accepts_api_key=env.get(
                       "VECTOR_DB_ADMIN_ACCEPTS_API_KEY", "0") == "1",
                   dev_mode=dev, generated=generated)


auth_config = AuthConfig.from_env()


def reload_auth() -> AuthConfig:
    """Rebuild the module auth config from the CURRENT environment.

    The import-time build above runs before a ``python -m tpu_vector_db_torch
    production`` entrypoint has set ENVIRONMENT, which would silently run
    a production server on auto-generated dev keys (review finding) —
    api/main.py calls this after resolving the mode so the
    must-set-keys-in-production guard actually fires.

    The refresh MUTATES the existing AuthConfig in place: several modules
    bind ``auth_config`` via ``from ... import`` at import time (e.g.
    api/app.py's dev-key startup banner), so rebinding the global alone
    would leave them holding a stale object whose keys no longer
    authenticate (review finding, verified by execution)."""
    fresh = AuthConfig.from_env()
    for f in ("api_key", "admin_key", "admin_accepts_api_key",
              "dev_mode", "generated"):
        setattr(auth_config, f, getattr(fresh, f))
    return auth_config


def ct_equal(a: str, b: str) -> bool:
    """Constant-time string equality tolerant of arbitrary input:
    secrets.compare_digest raises TypeError on non-ASCII str (verified),
    which would turn a 401 for a key like 'ké' into a 500 (review
    finding). Comparing utf-8/surrogateescape bytes accepts anything
    aiohttp's header decoding can produce."""
    return secrets.compare_digest(
        a.encode("utf-8", "surrogateescape"),
        b.encode("utf-8", "surrogateescape"))


def _extract_bearer(header_value: str | None) -> str | None:
    if not header_value:
        return None
    parts = header_value.split(None, 1)
    if len(parts) == 2 and parts[0].lower() == "bearer":
        return parts[1].strip()
    return header_value.strip()  # raw key / X-API-Key style


# ------------------------------------------------------------------- JWT
# The reference carried a JWT placeholder (security/auth.py:113-125); this
# is a working HS256 implementation on stdlib only (no pyjwt in the image).

import base64  # noqa: E402
import hmac  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402


def _b64url(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def _b64url_decode(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


def create_jwt(payload: dict, secret: str | None = None,
               expires_in_s: float = 3600.0) -> str:
    """HS256 JWT; secret defaults to the admin key."""
    secret = secret or auth_config.admin_key
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    body = dict(payload)
    body.setdefault("exp", time.time() + expires_in_s)
    claims = _b64url(json.dumps(body).encode())
    signing_input = header + b"." + claims
    sig = _b64url(hmac.new(secret.encode(), signing_input,
                           "sha256").digest())
    return (signing_input + b"." + sig).decode()


def verify_jwt(token: str, secret: str | None = None) -> dict | None:
    """Returns the payload if the signature checks out and not expired."""
    secret = secret or auth_config.admin_key
    try:
        header_b64, claims_b64, sig_b64 = token.split(".")
        signing_input = f"{header_b64}.{claims_b64}".encode()
        expected = _b64url(hmac.new(secret.encode(), signing_input,
                                    "sha256").digest()).decode()
        if not ct_equal(expected, sig_b64):
            return None
        payload = json.loads(_b64url_decode(claims_b64))
        if payload.get("exp", float("inf")) < time.time():
            return None
        return payload
    except (ValueError, json.JSONDecodeError):
        return None


def verify_api_key(authorization: str | None,
                   config: AuthConfig | None = None) -> bool:
    """Constant-time check of the service key (admin key also accepted —
    higher privilege implies lower)."""
    cfg = config or auth_config
    token = _extract_bearer(authorization)
    if token is None:
        return False
    return ct_equal(token, cfg.api_key) or ct_equal(token, cfg.admin_key)


def verify_admin_key(authorization: str | None,
                     config: AuthConfig | None = None) -> bool:
    cfg = config or auth_config
    token = _extract_bearer(authorization)
    if token is None:
        return False
    if ct_equal(token, cfg.admin_key):
        return True
    return cfg.admin_accepts_api_key and ct_equal(token, cfg.api_key)
