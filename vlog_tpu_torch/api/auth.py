"""Worker API-key auth: 256-bit keys, argon2id at rest, prefix-indexed (a
copy of ``vlog_tpu/api/auth.py``).

Reference parity: api/worker_auth.py:43-354 — keys are shown once at
registration, stored as argon2id hashes, looked up by a short indexed
prefix (so verification is one SELECT + one argon2 verify, not a table
scan), revocable, with last-used tracking. ``hash_version`` is kept in the
schema so a future hash migration can auto-rehash on use.

The hash is the port's own Argon2id (``native/argon2.c``, built at first
use) with the JAX package's parameters (t=2, m=65536 KiB, p=1, 16-byte
salt, 32-byte tag) in the PHC string format argon2-cffi writes
(``$argon2id$v=19$m=65536,t=2,p=1$<salt>$<tag>``, unpadded standard
base64), so a key minted by either package verifies in the other on one
database.
"""

from __future__ import annotations

import asyncio
import base64
import ctypes
import hashlib
import hmac
import secrets
import time
from dataclasses import dataclass

from vlog_tpu_torch.db.core import Database, now as db_now

KEY_PREFIX_LEN = 8
TIME_COST, MEMORY_COST_KIB, PARALLELISM = 2, 65536, 1
SALT_LEN, HASH_LEN = 16, 32
VERIFY_CACHE_TTL_S = 60.0
# sha256(full_key) -> (expires_monotonic, identity); bounds revocation lag
_VERIFIED_CACHE: dict[str, tuple[float, "WorkerIdentity"]] = {}


class AuthError(Exception):
    pass


@dataclass(frozen=True)
class WorkerIdentity:
    worker_name: str
    key_id: int


def argon2id(password: bytes, salt: bytes, *, t_cost: int = TIME_COST,
             m_cost_kib: int = MEMORY_COST_KIB,
             parallelism: int = PARALLELISM, hash_len: int = HASH_LEN,
             secret: bytes = b"", ad: bytes = b"") -> bytes:
    """Raw Argon2id tag (RFC 9106, version 0x13). Blocking: ~0.1 s of one
    core at the default cost (ctypes releases the GIL for the call)."""
    from vlog_tpu_torch.native.build import get_argon2_lib

    out = ctypes.create_string_buffer(hash_len)
    rc = get_argon2_lib().vt_argon2id(
        password, len(password), salt, len(salt), secret, len(secret),
        ad, len(ad), t_cost, m_cost_kib, parallelism, out, hash_len)
    if rc != 0:
        raise ValueError(f"argon2id failed (code {rc}): t={t_cost} "
                         f"m={m_cost_kib} p={parallelism}")
    return out.raw


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode().rstrip("=")


def _unb64(text: str) -> bytes:
    return base64.b64decode(text + "=" * (-len(text) % 4), validate=True)


def hash_secret(secret: str) -> str:
    """The PHC string of ``secret`` under a fresh random salt."""
    salt = secrets.token_bytes(SALT_LEN)
    tag = argon2id(secret.encode(), salt)
    return (f"$argon2id$v=19$m={MEMORY_COST_KIB},t={TIME_COST},"
            f"p={PARALLELISM}${_b64(salt)}${_b64(tag)}")


def verify_secret(phc: str, secret: str) -> bool:
    """Does ``secret`` match the PHC string (its own parameters)?"""
    try:
        _, algo, version, params, salt_b64, tag_b64 = phc.split("$")
        kv = dict(p.split("=", 1) for p in params.split(","))
        salt, tag = _unb64(salt_b64), _unb64(tag_b64)
        t, m, p = int(kv["t"]), int(kv["m"]), int(kv["p"])
    except (ValueError, KeyError):
        return False
    if algo != "argon2id" or version != "v=19":
        return False
    try:
        got = argon2id(secret.encode(), salt, t_cost=t, m_cost_kib=m,
                       parallelism=p, hash_len=len(tag))
    except ValueError:
        return False
    return hmac.compare_digest(got, tag)


def generate_key() -> tuple[str, str, str]:
    """Return (full_key, prefix, secret). Key format: vlwk_<prefix><secret>."""
    prefix = secrets.token_hex(KEY_PREFIX_LEN // 2)       # 8 hex chars
    secret = secrets.token_hex(32)                        # 256-bit secret
    return f"vlwk_{prefix}{secret}", prefix, secret


async def create_worker_key(db: Database, worker_name: str) -> str:
    """Mint a key for a worker; the full key is returned exactly once."""
    full, prefix, secret = generate_key()
    await db.execute(
        """
        INSERT INTO worker_api_keys (worker_name, key_prefix, key_hash,
                                     hash_version, created_at)
        VALUES (:w, :p, :h, 2, :t)
        """,
        {"w": worker_name, "p": prefix, "h": hash_secret(secret),
         "t": db_now()},
    )
    return full


def _split_key(full_key: str) -> tuple[str, str]:
    if not full_key.startswith("vlwk_") or len(full_key) < 5 + KEY_PREFIX_LEN + 8:
        raise AuthError("malformed API key")
    body = full_key[5:]
    return body[:KEY_PREFIX_LEN], body[KEY_PREFIX_LEN:]


async def verify_key(db: Database, full_key: str) -> WorkerIdentity:
    """Resolve a presented key to a worker, or raise AuthError.

    The argon2 verify runs off the event loop (it is deliberately ~100 ms
    of CPU), and successful verifications are cached for a short TTL so a
    worker streaming hundreds of segment uploads does not serialize the
    whole API behind repeated hashing. Revocation takes effect within the
    TTL window.
    """
    digest = hashlib.sha256(full_key.encode()).hexdigest()
    hit = _VERIFIED_CACHE.get(digest)
    now = time.monotonic()
    if hit is not None and now < hit[0]:
        return hit[1]
    prefix, secret = _split_key(full_key)
    rows = await db.fetch_all(
        "SELECT * FROM worker_api_keys WHERE key_prefix=:p AND revoked_at IS NULL",
        {"p": prefix},
    )
    for row in rows:
        if not await asyncio.to_thread(verify_secret, row["key_hash"],
                                       secret):
            continue
        await db.execute(
            "UPDATE worker_api_keys SET last_used_at=:t WHERE id=:id",
            {"t": db_now(), "id": row["id"]},
        )
        ident = WorkerIdentity(worker_name=row["worker_name"],
                               key_id=row["id"])
        if len(_VERIFIED_CACHE) > 1024:
            _VERIFIED_CACHE.clear()
        _VERIFIED_CACHE[digest] = (now + VERIFY_CACHE_TTL_S, ident)
        return ident
    raise AuthError("unknown or revoked API key")


def invalidate_verify_cache() -> None:
    _VERIFIED_CACHE.clear()


async def revoke_keys(db: Database, worker_name: str) -> int:
    """Revoke every active key of a worker (reference: workers revoke
    endpoint, worker_api.py:3006). In-process verify cache is dropped
    immediately; other processes converge within VERIFY_CACHE_TTL_S."""
    _VERIFIED_CACHE.clear()
    return await db.execute(
        """
        UPDATE worker_api_keys SET revoked_at=:t
        WHERE worker_name=:w AND revoked_at IS NULL
        """,
        {"t": db_now(), "w": worker_name},
    )


def check_admin_secret(presented: str | None, expected: str) -> bool:
    """Constant-time admin-secret check; empty expected = dev mode (open)."""
    if not expected:
        return True
    return bool(presented) and hmac.compare_digest(presented, expected)
