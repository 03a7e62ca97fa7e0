"""Shared-secret bearer tokens + AuthContext.

Reference parity: the reference threads JWT claims through every service
via an AuthContext (``src/shared/services/authcontext/context.go:38``)
minted from a shared signing key (``utils/token_utils.go``). Here the analog is an HMAC-SHA256-signed
bearer token checked at the two trust boundaries: netbus connect
(``netbus.BusServer``) and broker API request handling
(``query_broker.QueryBroker.serve``). Services inside one process trust
their in-process bus, as the reference trusts intra-pod calls.

Token format: ``base64url(json payload) "." hex hmac`` — payload is
``{"sub": subject, "exp": unix_seconds, "claims": {...}}``. No external
JWT dependency; the signature covers the exact encoded payload.

A copy of the JAX package's ``services/auth.py``.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from dataclasses import dataclass, field

class AuthError(Exception):
    pass


@dataclass(frozen=True)
class AuthContext:
    """Verified identity attached to a connection/request
    (authcontext.AuthContext analog)."""

    subject: str
    expiry_s: float
    claims: dict = field(default_factory=dict)

    @property
    def authenticated(self) -> bool:
        return bool(self.subject)


#: Context for deployments with auth disabled (empty secret).
ANONYMOUS = AuthContext(subject="", expiry_s=float("inf"))


def sign_token(secret: str, subject: str, ttl_s: float = 3600.0,
               claims: dict | None = None) -> str:
    if not secret:
        raise AuthError("cannot sign tokens with an empty secret")
    payload = json.dumps(
        {"sub": subject, "exp": time.time() + ttl_s, "claims": claims or {}},
        separators=(",", ":"), sort_keys=True,
    ).encode()
    body = base64.urlsafe_b64encode(payload).decode().rstrip("=")
    sig = hmac.new(secret.encode(), body.encode(), hashlib.sha256).hexdigest()
    return f"{body}.{sig}"


def verify_token(secret: str, token: str) -> AuthContext:
    """Validate signature + expiry; raises AuthError on any failure."""
    if not secret:
        return ANONYMOUS  # auth disabled
    if not token or not isinstance(token, str) or "." not in token:
        raise AuthError("missing bearer token")
    body, _, sig = token.rpartition(".")
    want = hmac.new(secret.encode(), body.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, sig):
        raise AuthError("bad token signature")
    try:
        pad = "=" * (-len(body) % 4)
        payload = json.loads(base64.urlsafe_b64decode(body + pad))
    except Exception as e:
        raise AuthError(f"malformed token payload: {e}") from None
    exp = float(payload.get("exp", 0))
    if exp < time.time():
        raise AuthError("token expired")
    return AuthContext(
        subject=str(payload.get("sub", "")), expiry_s=exp,
        claims=dict(payload.get("claims") or {}),
    )
