"""Transient-error retry tier for database operations (a copy of
``vlog_tpu/db/retry.py``).

Reference analog: api/db_retry.py (421 LoC) — exponential-backoff
retries around operations that can fail transiently under contention,
on both backends:

- sqlite: ``database is locked`` / ``database table is locked`` (busy
  writer past the busy_timeout, WAL checkpoint stalls);
- Postgres: deadlock (40P01), serialization failure (40001), lock
  not available (55P03), connection drops (08xxx / 57P03).

These become load-bearing exactly when a libpq driver (the JAX package's
db/pg.py; not ported) is
used under claim contention: two claim transactions can deadlock on
row-lock order, and Postgres resolves it by killing one — which must
retry, not 500. The wrapper is deliberately only applied to operations
that are safe to re-run: whole transactions that re-read their inputs
(the claim protocol's shape) or idempotent statements. Retryable
failures surface before COMMIT, so a retried transaction never
double-applies.
"""

from __future__ import annotations

import asyncio
import logging
import random
from typing import Any, Awaitable, Callable, TypeVar

log = logging.getLogger("vlog.db.retry")

T = TypeVar("T")

MAX_ATTEMPTS = 5
BASE_DELAY_S = 0.05
MAX_DELAY_S = 2.0

# sqlite message fragments (sqlite3 has no stable error codes at the
# message level; these are the documented busy/locked strings)
_SQLITE_RETRYABLE = (
    "database is locked",
    "database table is locked",
    "database schema is locked",
)

# Postgres SQLSTATEs that mean "try again" (PgError carries .sqlstate).
# Deliberately NOT here: connection-drop classes (08xxx, "server closed
# the connection") — a drop can land AFTER the server applied COMMIT,
# so re-running a non-idempotent transaction would double-apply it
# (e.g. a retried claim_job would claim a second job while the first
# sits claimed-by-nobody until lease expiry). The states below all
# surface BEFORE commit by construction: the server aborted the
# transaction itself (deadlock victim, serialization failure, lock
# unavailable) or never started it (57P03).
_PG_RETRYABLE_STATES = {
    "40001",   # serialization_failure
    "40P01",   # deadlock_detected
    "55P03",   # lock_not_available
    "57P03",   # cannot_connect_now (server starting; nothing ran)
}

_PG_RETRYABLE_FRAGMENTS = (
    "deadlock detected",
    "could not serialize access",
    "could not obtain lock",
)


# Connection-drop message shapes (libpq, sqlite-over-NFS, sockets).
# Deliberately broader than _PG_RETRYABLE_*: these are NOT safe for
# with_retries (a drop can land after COMMIT) but they ARE the signal
# the claim-loop brownout breaker paces itself on — the loop re-reads
# queue state every poll, so double-apply is not a concern there.
_CONNECTION_FRAGMENTS = (
    "connection refused",
    "connection reset",
    "connection timed out",
    "server closed the connection",
    "could not connect",
    "broken pipe",
    "connection is closed",
    "unavailable",
)


def is_transient_db_error(exc: BaseException) -> bool:
    """Is this the coordination plane flapping (vs a code/data bug)?

    Used by the worker claim loops' brownout breaker (worker/brownout.py)
    to decide between jittered backoff (transient: Postgres restarting,
    network partition, lock storms) and the generic crash-log path. Not
    used by :func:`with_retries` — see _CONNECTION_FRAGMENTS.

    Message fragments are only consulted on I/O and database-driver
    error families (same restraint as parallel/faults.py's
    RuntimeError-only matching): a code bug whose TEXT happens to say
    "unavailable" must not be routed into the brownout path, where its
    traceback would be suppressed and the worker pulled from rotation
    for the wrong reason.
    """
    if is_retryable(exc):
        return True
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return True
    if hasattr(exc, "sqlstate"):          # the PgError family
        sqlstate = exc.sqlstate
        if isinstance(sqlstate, str) and sqlstate[:2] in ("08", "57"):
            return True
    if isinstance(exc, RetriesExhausted):
        return True
    import sqlite3

    if not (isinstance(exc, (OSError, sqlite3.Error))
            or hasattr(exc, "sqlstate")):
        return False
    msg = str(exc).lower()
    return any(f in msg for f in _CONNECTION_FRAGMENTS)


class RetriesExhausted(RuntimeError):
    """All attempts failed with retryable errors; carries the last one."""

    def __init__(self, attempts: int, last: BaseException):
        super().__init__(
            f"database operation failed after {attempts} attempts: {last}")
        self.last = last


def is_retryable(exc: BaseException) -> bool:
    sqlstate = getattr(exc, "sqlstate", None)
    if sqlstate in _PG_RETRYABLE_STATES:
        return True
    msg = str(exc).lower()
    if any(f in msg for f in _SQLITE_RETRYABLE):
        return True
    return any(f in msg for f in _PG_RETRYABLE_FRAGMENTS)


async def with_retries(
    op: Callable[[], Awaitable[T]],
    *,
    max_attempts: int = MAX_ATTEMPTS,
    base_delay_s: float = BASE_DELAY_S,
    max_delay_s: float = MAX_DELAY_S,
    label: str = "db op",
) -> T:
    """Run ``op`` (a zero-arg coroutine factory — a fresh coroutine per
    attempt), retrying retryable database errors with jittered
    exponential backoff. Non-retryable errors propagate immediately."""
    last: BaseException | None = None
    for attempt in range(1, max_attempts + 1):
        try:
            return await op()
        except Exception as exc:   # noqa: BLE001 — filtered below
            # (CancelledError is BaseException and passes through)
            if not is_retryable(exc) or attempt == max_attempts:
                if last is not None and is_retryable(exc):
                    raise RetriesExhausted(attempt, exc) from exc
                raise
            last = exc
            delay = min(base_delay_s * (2 ** (attempt - 1)), max_delay_s)
            delay *= 0.5 + random.random()      # jitter: desync herds
            log.debug("%s: retryable failure (attempt %d/%d), %.0f ms: %s",
                      label, attempt, max_attempts, delay * 1000, exc)
            await asyncio.sleep(delay)
    raise AssertionError("unreachable")


def retryable(label: str | None = None, **cfg: Any):
    """Decorator form for async functions whose whole body is safe to
    re-run (transactions that re-read their inputs)."""
    def wrap(fn: Callable[..., Awaitable[T]]) -> Callable[..., Awaitable[T]]:
        async def inner(*args: Any, **kwargs: Any) -> T:
            return await with_retries(
                lambda: fn(*args, **kwargs),
                label=label or fn.__qualname__, **cfg)
        inner.__name__ = fn.__name__
        inner.__qualname__ = fn.__qualname__
        inner.__doc__ = fn.__doc__
        return inner
    return wrap
