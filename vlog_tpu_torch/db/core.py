"""Async database facade over sqlite3 (a copy of ``vlog_tpu/db/core.py``;
the Postgres facade is not ported).

The reference used `databases.Database` over asyncpg (api/database.py:11).
Here the same *shape* — ``fetch_one`` / ``fetch_all`` / ``execute`` /
``transaction()`` with named parameters — is provided by an in-house facade:

- One sqlite3 connection per :class:`Database`, guarded by an asyncio lock;
  blocking calls are pushed to a thread so the event loop never stalls.
- WAL journal mode + busy timeout make the file safe to share between the
  API processes and worker processes, mirroring how the reference shares
  Postgres across its services.
- ``BEGIN IMMEDIATE`` transactions give the claim protocol the same
  "row-locked claim" guarantee the reference gets from
  ``SELECT ... FOR UPDATE SKIP LOCKED`` (worker_api.py:1494-1556): sqlite has
  a single writer, so an immediate transaction *is* the lock.

Rows are returned as plain dicts.
"""

from __future__ import annotations

import asyncio
import sqlite3
import time
from collections.abc import AsyncIterator, Iterable, Mapping
from contextlib import asynccontextmanager
from pathlib import Path
from typing import Any

from vlog_tpu_torch.utils import failpoints

Row = dict[str, Any]
Params = Mapping[str, Any] | None


def now() -> float:
    """Canonical timestamp (unix epoch seconds) used across the schema."""
    return time.time()


def _connect_sqlite(path: str) -> sqlite3.Connection:
    conn = sqlite3.connect(
        path,
        timeout=30.0,
        check_same_thread=False,
        isolation_level=None,  # autocommit; we manage BEGIN/COMMIT explicitly
    )
    conn.row_factory = sqlite3.Row
    conn.execute("PRAGMA journal_mode=WAL")
    conn.execute("PRAGMA synchronous=NORMAL")
    conn.execute("PRAGMA foreign_keys=ON")
    conn.execute("PRAGMA busy_timeout=30000")
    return conn


def parse_database_url(url: str) -> str:
    """Extract a filesystem path from ``sqlite:///path`` (or pass paths through)."""
    if url.startswith("sqlite:///"):
        return url[len("sqlite:///"):]
    if url.startswith("sqlite://"):
        return url[len("sqlite://"):]
    return url


class Transaction:
    """Handle for an open transaction; obtained via :meth:`Database.transaction`."""

    def __init__(self, db: "Database"):
        self._db = db

    async def execute(self, sql: str, params: Params = None) -> int:
        return await self._db._tx_execute(sql, params)

    async def execute_many(self, sql: str, seq: Iterable[Mapping[str, Any]]) -> None:
        await self._db._tx_execute_many(sql, seq)

    async def fetch_one(self, sql: str, params: Params = None) -> Row | None:
        return await self._db._tx_fetch_one(sql, params)

    async def fetch_all(self, sql: str, params: Params = None) -> list[Row]:
        return await self._db._tx_fetch_all(sql, params)


def open_database(url: str):
    """Facade factory: a sqlite path/URL is served by :class:`Database`.

    ``postgres://`` / ``postgresql://`` URLs (and libpq keyword DSNs
    containing ``dbname=``), which the JAX package serves with its libpq
    facade, raise :class:`NotImplementedError`: the port's Postgres
    facade is not written (ROADMAP Queue A item 13b), and a Postgres URL
    must never quietly open a sqlite file of that name.
    """
    low = url.strip().lower()
    if (low.startswith(("postgres://", "postgresql://"))
            or ("dbname=" in low and not low.startswith("sqlite"))):
        raise NotImplementedError(
            f"database URL {url!r}: the port serves sqlite only; its "
            "Postgres facade is ROADMAP Queue A item 13b")
    return Database(url)


class Database:
    """Async sqlite facade; safe to share within one event loop."""

    dialect = "sqlite"
    # sqlite's single writer makes BEGIN IMMEDIATE the row lock; the PG
    # facade overrides this with " FOR UPDATE SKIP LOCKED".
    row_lock_suffix = ""

    @staticmethod
    def greatest(*exprs: str) -> str:
        # two-arg MAX is sqlite's scalar max; PG spells it GREATEST
        return f"MAX({', '.join(exprs)})"

    def __init__(self, url: str):
        self.path = parse_database_url(url)
        self._conn: sqlite3.Connection | None = None
        self._lock = asyncio.Lock()
        # Statements executed over this facade's lifetime. Serving-path
        # tests assert steady-state deltas of exactly zero (the delivery
        # plane's "a cached segment hit performs no DB queries").
        self.query_count = 0

    # -- lifecycle ---------------------------------------------------------

    async def connect(self) -> None:
        if self._conn is not None:
            return
        if self.path != ":memory:":
            Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self._conn = await asyncio.to_thread(_connect_sqlite, self.path)

    async def disconnect(self) -> None:
        if self._conn is not None:
            conn, self._conn = self._conn, None
            await asyncio.to_thread(conn.close)

    @property
    def connected(self) -> bool:
        return self._conn is not None

    def _require_conn(self) -> sqlite3.Connection:
        if self._conn is None:
            raise RuntimeError("Database is not connected; call connect() first")
        return self._conn

    # -- single-statement API (each statement is its own transaction) ------

    async def execute(self, sql: str, params: Params = None) -> int:
        """Run a write statement; returns lastrowid (or rowcount for UPDATE)."""
        async with self._lock:
            return await asyncio.to_thread(self._run_execute, sql, params)

    async def execute_many(self, sql: str, seq: Iterable[Mapping[str, Any]]) -> None:
        async with self._lock:
            await asyncio.to_thread(self._run_execute_many, sql, list(seq))

    async def fetch_one(self, sql: str, params: Params = None) -> Row | None:
        async with self._lock:
            return await asyncio.to_thread(self._run_fetch_one, sql, params)

    async def fetch_all(self, sql: str, params: Params = None) -> list[Row]:
        async with self._lock:
            return await asyncio.to_thread(self._run_fetch_all, sql, params)

    async def fetch_val(self, sql: str, params: Params = None) -> Any:
        row = await self.fetch_one(sql, params)
        if row is None:
            return None
        return next(iter(row.values()))

    # -- transactions ------------------------------------------------------

    @asynccontextmanager
    async def transaction(self, *, immediate: bool = True) -> AsyncIterator[Transaction]:
        """Open a transaction, holding the facade lock for its duration.

        ``immediate=True`` acquires sqlite's write lock up front, which is the
        claim-protocol serialization point (see module docstring).
        """
        async with self._lock:
            conn = self._require_conn()
            begin = "BEGIN IMMEDIATE" if immediate else "BEGIN"
            await asyncio.to_thread(conn.execute, begin)
            try:
                yield Transaction(self)
                failpoints.hit("db.commit")
            except BaseException:
                await asyncio.to_thread(conn.execute, "ROLLBACK")
                raise
            else:
                await asyncio.to_thread(conn.execute, "COMMIT")

    # -- internals (thread side) -------------------------------------------

    def _run_execute(self, sql: str, params: Params) -> int:
        conn = self._require_conn()
        self.query_count += 1
        cur = conn.execute(sql, dict(params or {}))
        verb = sql.lstrip().split(None, 1)[0].upper() if sql.strip() else ""
        return cur.lastrowid if verb == "INSERT" else cur.rowcount

    def _run_execute_many(self, sql: str, seq: list[Mapping[str, Any]]) -> None:
        self.query_count += 1
        self._require_conn().executemany(sql, [dict(p) for p in seq])

    def _run_fetch_one(self, sql: str, params: Params) -> Row | None:
        self.query_count += 1
        cur = self._require_conn().execute(sql, dict(params or {}))
        row = cur.fetchone()
        return dict(row) if row is not None else None

    def _run_fetch_all(self, sql: str, params: Params) -> list[Row]:
        self.query_count += 1
        cur = self._require_conn().execute(sql, dict(params or {}))
        return [dict(r) for r in cur.fetchall()]

    # transaction-scoped variants run on the already-locked connection
    async def _tx_execute(self, sql: str, params: Params) -> int:
        return await asyncio.to_thread(self._run_execute, sql, params)

    async def _tx_execute_many(self, sql: str, seq: Iterable[Mapping[str, Any]]) -> None:
        await asyncio.to_thread(self._run_execute_many, sql, list(seq))

    async def _tx_fetch_one(self, sql: str, params: Params) -> Row | None:
        return await asyncio.to_thread(self._run_fetch_one, sql, params)

    async def _tx_fetch_all(self, sql: str, params: Params) -> list[Row]:
        return await asyncio.to_thread(self._run_fetch_all, sql, params)
