"""Auth: ES256 self-contained JWTs + legacy API keys + RBAC.

Reference: pkg/auth — ES256 keypair persisted in KV (keys.go:36), token
claims {role, namespaces, jti} (jwt_provider.go:41), JWKS export (:80),
verification with jti denylist revocation (:114-146), roles
admin/write/read with namespace checks (rbac.go:16-126), method→role
middleware mapping (middleware.go:111-223), legacy SHA-256 API keys
(rbac.go:33-111).

Implemented with `cryptography` (no PyJWT in the image): compact JWS with
ES256 (P-256 + SHA-256, raw r||s signature per RFC 7518)."""

from __future__ import annotations

import base64
import hashlib
import json
import secrets
import time
import uuid
from typing import Any, Optional

from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.hazmat.primitives.asymmetric.utils import (
    decode_dss_signature, encode_dss_signature)

ROLES = ("admin", "write", "read")
_ROLE_RANK = {r: i for i, r in enumerate(ROLES)}  # admin strongest

KV_KEYPAIR = "auth:keypair"
KV_REVOKED_PREFIX = "auth:revoked:"
KV_APIKEY_PREFIX = "auth:key:"


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


class AuthService:
    def __init__(self, kv) -> None:
        self.kv = kv
        self._key = self._load_or_create()

    # -- keypair persisted in KV (keys.go:36) --------------------------------

    def _load_or_create(self) -> ec.EllipticCurvePrivateKey:
        raw = self.kv.get(KV_KEYPAIR)
        if raw:
            return serialization.load_pem_private_key(raw, password=None)
        key = ec.generate_private_key(ec.SECP256R1())
        pem = key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption())
        self.kv.set(KV_KEYPAIR, pem)
        return key

    # -- token issue/verify ---------------------------------------------------

    def generate_token(self, role: str, namespaces: Optional[list[str]] = None,
                       ttl: Optional[float] = None,
                       name: str = "") -> dict[str, Any]:
        """GenerateKey (jwt_provider.go:41): role + namespaces + jti."""
        if role not in ROLES:
            raise ValueError(f"unknown role: {role}")
        jti = uuid.uuid4().hex
        now = int(time.time())
        claims = {"role": role, "namespaces": namespaces or ["*"],
                  "jti": jti, "iat": now, "iss": "kektordb", "name": name}
        if ttl:
            claims["exp"] = now + int(ttl)
        header = {"alg": "ES256", "typ": "JWT"}
        signing = f"{_b64(json.dumps(header).encode())}." \
                  f"{_b64(json.dumps(claims).encode())}"
        der = self._key.sign(signing.encode(), ec.ECDSA(hashes.SHA256()))
        r, s = decode_dss_signature(der)
        sig = r.to_bytes(32, "big") + s.to_bytes(32, "big")
        return {"id": jti, "token": f"{signing}.{_b64(sig)}",
                "role": role, "namespaces": claims["namespaces"],
                "name": name}

    def verify_token(self, token: str) -> Optional[dict[str, Any]]:
        """Verify signature + expiry + jti denylist (jwt_provider.go:114-146).
        Returns claims or None."""
        try:
            h, c, s = token.split(".")
            sig = _unb64(s)
            r = int.from_bytes(sig[:32], "big")
            ss = int.from_bytes(sig[32:], "big")
            self._key.public_key().verify(
                encode_dss_signature(r, ss), f"{h}.{c}".encode(),
                ec.ECDSA(hashes.SHA256()))
            claims = json.loads(_unb64(c))
        except Exception:
            return None
        if claims.get("exp") and time.time() > claims["exp"]:
            return None
        if self.kv.get(KV_REVOKED_PREFIX + claims.get("jti", "")):
            return None
        return claims

    def revoke(self, jti: str) -> None:
        self.kv.set(KV_REVOKED_PREFIX + jti, b"1")

    def list_keys(self) -> list[dict[str, Any]]:
        out = []
        for k, v in self.kv.scan(KV_APIKEY_PREFIX):
            try:
                out.append(json.loads(v))
            except ValueError:
                pass
        return out

    def record_key(self, info: dict[str, Any]) -> None:
        rec = {k: v for k, v in info.items() if k != "token"}
        self.kv.set(KV_APIKEY_PREFIX + info["id"], json.dumps(rec))

    def jwks(self) -> dict[str, Any]:
        """JWKS export (jwt_provider.go:80)."""
        pub = self._key.public_key().public_numbers()
        return {"keys": [{
            "kty": "EC", "crv": "P-256", "use": "sig", "alg": "ES256",
            "x": _b64(pub.x.to_bytes(32, "big")),
            "y": _b64(pub.y.to_bytes(32, "big"))}]}

    # -- legacy shared-secret API key (rbac.go:33-111) -----------------------

    @staticmethod
    def hash_key(secret: str) -> str:
        return hashlib.sha256(secret.encode()).hexdigest()


def role_allows(have: str, need: str) -> bool:
    """admin ⊃ write ⊃ read (rbac.go:16-126)."""
    return _ROLE_RANK.get(have, 99) <= _ROLE_RANK.get(need, -1)


def required_role(method: str, path: str) -> str:
    """Method→role map (middleware.go:111-223): reads need read, mutations
    need write, auth/system administration needs admin."""
    if path.startswith("/auth/"):
        return "admin"
    if path.startswith("/system/") and path not in (
            "/system/stats", "/system/embedder/status",
            "/system/vectorizers", "/system/gardener"):
        return "admin"
    if method in ("GET", "HEAD", "OPTIONS"):
        return "read"
    if path in ("/vector/actions/search", "/vector/actions/search-with-scores",
                "/vector/actions/get-vectors", "/rag/retrieve",
                "/rag/retrieve-adaptive") or path.startswith(
                    "/graph/actions/get") or path in (
                    "/graph/actions/traverse", "/graph/actions/find-path",
                    "/graph/actions/extract-subgraph",
                    "/graph/actions/search-nodes"):
        return "read"
    return "write"


def namespace_of(path: str, body: Optional[dict]) -> Optional[str]:
    """Extract the index namespace a request touches
    (middleware.go:150-223)."""
    if body and isinstance(body, dict):
        ns = body.get("index_name")
        if ns:
            return str(ns)
    parts = path.split("/")
    if len(parts) >= 4 and parts[1] == "vector" and parts[2] == "indexes":
        return parts[3]
    return None


def namespace_allowed(claims: dict[str, Any], ns: Optional[str]) -> bool:
    if ns is None:
        return True
    spaces = claims.get("namespaces") or ["*"]
    return "*" in spaces or ns in spaces
