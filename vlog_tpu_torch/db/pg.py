"""PostgreSQL backend for the async database facade (a copy of
``vlog_tpu/db/pg.py``: the same client, SQL rewrites and wire behavior,
so either package's facade reads and claims a database the other made).

The reference's source of truth is Postgres (`databases.Database` over
asyncpg, api/database.py:11), and its claim protocol is built on
``SELECT ... FOR UPDATE SKIP LOCKED`` row locking
(worker_api.py:1494-1556). This module provides the same facade API as
:class:`vlog_tpu_torch.db.core.Database` — ``fetch_one`` / ``fetch_all`` /
``execute`` / ``transaction()`` with ``:name`` parameters — against a
real Postgres server, so a multi-node fleet gets genuine concurrent
row-locked claims instead of sqlite's single-writer serialization.

No asyncpg/psycopg is available in this environment, so the client is
first-party: ctypes over the system ``libpq.so.5`` (text protocol via
``PQexecParams``), with blocking calls pushed to threads. A small
connection pool backs the facade; ``transaction()`` pins one connection
for its scope, so independent transactions run on independent
connections — which is precisely what makes ``FOR UPDATE SKIP LOCKED``
meaningful (two claimants contend on row locks, not on a Python mutex).

Dialect notes handled here so callers stay single-source:

- ``:name`` parameters are rewritten to ``$n`` positionals.
- sqlite DDL is rewritten on the fly: ``INTEGER PRIMARY KEY
  AUTOINCREMENT`` -> ``BIGSERIAL PRIMARY KEY``, ``REAL`` -> ``DOUBLE
  PRECISION`` (PG ``REAL`` is float4 — too coarse for epoch-seconds
  lease math), ``BLOB`` -> ``BYTEA``.
- ``execute()`` returns the inserted ``id`` for INSERTs (the sqlite
  facade's lastrowid contract) by appending ``RETURNING id`` when the
  target table has an ``id`` column (catalog-checked, cached).
- :data:`Database.row_lock_suffix` is ``" FOR UPDATE SKIP LOCKED"``
  here and ``""`` on sqlite; the claim query appends it.
- ``greatest()``: ``GREATEST`` here, two-arg ``MAX`` on sqlite.
"""

from __future__ import annotations

import asyncio
import ctypes
import ctypes.util
import re
import threading
from collections.abc import AsyncIterator, Iterable, Mapping
from contextlib import asynccontextmanager
from typing import Any

from vlog_tpu_torch.utils import failpoints

Row = dict[str, Any]
Params = Mapping[str, Any] | None

# -- libpq result / connection status codes (libpq-fe.h) -------------------
CONNECTION_OK = 0
PGRES_COMMAND_OK = 1
PGRES_TUPLES_OK = 2

# text-format OIDs we decode to Python types (pg_type.h)
_OID_BOOL = 16
_OID_BYTEA = 17
_OID_INT8 = 20
_OID_INT2 = 21
_OID_INT4 = 23
_OID_OID = 26
_OID_FLOAT4 = 700
_OID_FLOAT8 = 701
_OID_NUMERIC = 1700

_LIBPQ: ctypes.CDLL | None = None


def load_libpq() -> ctypes.CDLL:
    """Load and prototype the system libpq (cached)."""
    global _LIBPQ
    if _LIBPQ is not None:
        return _LIBPQ
    name = ctypes.util.find_library("pq") or "libpq.so.5"
    lib = ctypes.CDLL(name)
    c_char_pp = ctypes.POINTER(ctypes.c_char_p)
    c_int_p = ctypes.POINTER(ctypes.c_int)
    lib.PQconnectdb.restype = ctypes.c_void_p
    lib.PQconnectdb.argtypes = [ctypes.c_char_p]
    lib.PQstatus.restype = ctypes.c_int
    lib.PQstatus.argtypes = [ctypes.c_void_p]
    lib.PQfinish.restype = None
    lib.PQfinish.argtypes = [ctypes.c_void_p]
    lib.PQerrorMessage.restype = ctypes.c_char_p
    lib.PQerrorMessage.argtypes = [ctypes.c_void_p]
    lib.PQexecParams.restype = ctypes.c_void_p
    lib.PQexecParams.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_void_p,      # paramTypes (NULL: infer)
        c_char_pp,            # paramValues
        c_int_p,              # paramLengths
        c_int_p,              # paramFormats
        ctypes.c_int,         # resultFormat: 0 = text
    ]
    lib.PQresultStatus.restype = ctypes.c_int
    lib.PQresultStatus.argtypes = [ctypes.c_void_p]
    lib.PQresultErrorMessage.restype = ctypes.c_char_p
    lib.PQresultErrorMessage.argtypes = [ctypes.c_void_p]
    lib.PQresultErrorField.restype = ctypes.c_char_p
    lib.PQresultErrorField.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.PQclear.restype = None
    lib.PQclear.argtypes = [ctypes.c_void_p]
    lib.PQntuples.restype = ctypes.c_int
    lib.PQntuples.argtypes = [ctypes.c_void_p]
    lib.PQnfields.restype = ctypes.c_int
    lib.PQnfields.argtypes = [ctypes.c_void_p]
    lib.PQfname.restype = ctypes.c_char_p
    lib.PQfname.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.PQftype.restype = ctypes.c_uint
    lib.PQftype.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.PQgetvalue.restype = ctypes.c_char_p
    lib.PQgetvalue.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.PQgetisnull.restype = ctypes.c_int
    lib.PQgetisnull.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.PQgetlength.restype = ctypes.c_int
    lib.PQgetlength.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.PQcmdTuples.restype = ctypes.c_char_p
    lib.PQcmdTuples.argtypes = [ctypes.c_void_p]
    lib.PQlibVersion.restype = ctypes.c_int
    lib.PQlibVersion.argtypes = []
    # LISTEN/NOTIFY plumbing (jobs/events.py PgNotifyBus)
    lib.PQsocket.restype = ctypes.c_int
    lib.PQsocket.argtypes = [ctypes.c_void_p]
    lib.PQconsumeInput.restype = ctypes.c_int
    lib.PQconsumeInput.argtypes = [ctypes.c_void_p]
    lib.PQnotifies.restype = ctypes.POINTER(PGnotify)
    lib.PQnotifies.argtypes = [ctypes.c_void_p]
    lib.PQfreemem.restype = None
    lib.PQfreemem.argtypes = [ctypes.c_void_p]
    _LIBPQ = lib
    return lib


class PGnotify(ctypes.Structure):
    """libpq-fe.h pgNotify (public prefix; trailing private fields are
    never touched through this layout)."""
    _fields_ = [("relname", ctypes.c_char_p),
                ("be_pid", ctypes.c_int),
                ("extra", ctypes.c_char_p)]


class PgError(RuntimeError):
    def __init__(self, message: str, sqlstate: str | None = None):
        super().__init__(message)
        self.sqlstate = sqlstate


# -- SQL translation --------------------------------------------------------

# Alternation order matters: quoted regions (single-quoted literals with
# '' escapes, double-quoted identifiers, E'' strings with backslash
# escapes) match first and pass through verbatim, so a literal colon-word
# inside a string ('tag:foo', time formats) is never rewritten.
_PARAM_OR_QUOTE_RE = re.compile(
    r"""
    (?P<quote> (?<!\w)[eE]'(?:[^'\\]|''|\\.)*'   # E'' string (\ escapes;
                                          # \w guard: LIKE'x' is not E'')
             | '(?:[^']|'')*'             # standard literal ('' escapes)
             | "(?:[^"]|"")*" )           # quoted identifier
    | (?<![:\w]):(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)
    """, re.X)


def translate_params(sql: str) -> tuple[str, list[str]]:
    """Rewrite ``:name`` placeholders to ``$1..$n``; returns the ordered
    parameter-name list (repeated names reuse their positional).
    Quoted regions are skipped — ``::casts`` are already excluded by the
    lookbehind."""
    order: list[str] = []

    def sub(m: re.Match) -> str:
        if m.group("quote") is not None:
            return m.group("quote")
        name = m.group("name")
        if name not in order:
            order.append(name)
        return f"${order.index(name) + 1}"

    return _PARAM_OR_QUOTE_RE.sub(sub, sql), order


_DDL_REWRITES = [
    (re.compile(r"\bINTEGER\s+PRIMARY\s+KEY\s+AUTOINCREMENT\b", re.I),
     "BIGSERIAL PRIMARY KEY"),
    (re.compile(r"\bREAL\b", re.I), "DOUBLE PRECISION"),
    (re.compile(r"\bBLOB\b", re.I), "BYTEA"),
]


def translate_ddl(sql: str) -> str:
    """sqlite-flavored DDL -> Postgres DDL (see module docstring)."""
    head = sql.lstrip()[:30].upper()
    if not (head.startswith("CREATE TABLE")
            or head.startswith("CREATE INDEX")
            or head.startswith("ALTER TABLE")):
        return sql
    for pat, repl in _DDL_REWRITES:
        sql = pat.sub(repl, sql)
    return sql


_INSERT_TABLE_RE = re.compile(
    r"^\s*INSERT\s+INTO\s+([a-zA-Z_][a-zA-Z0-9_]*)", re.I)


def encode_value(v: Any) -> bytes | None:
    """Python value -> libpq text-format parameter (None = SQL NULL)."""
    if v is None:
        return None
    if isinstance(v, bool):
        return b"true" if v else b"false"
    if isinstance(v, bytes):
        return b"\\x" + v.hex().encode()      # bytea hex input form
    if isinstance(v, float):
        return repr(v).encode()
    return str(v).encode()


def decode_value(raw: bytes, oid: int) -> Any:
    """libpq text-format field -> Python value by type OID."""
    if oid == _OID_BOOL:
        return raw == b"t"
    if oid in (_OID_INT2, _OID_INT4, _OID_INT8, _OID_OID):
        return int(raw)
    if oid in (_OID_FLOAT4, _OID_FLOAT8, _OID_NUMERIC):
        return float(raw)
    if oid == _OID_BYTEA:
        if raw.startswith(b"\\x"):
            return bytes.fromhex(raw[2:].decode())
        return raw
    return raw.decode()


class _PgConn:
    """One libpq connection; used by one task/thread at a time."""

    def __init__(self, dsn: str):
        self.lib = load_libpq()
        self.ptr = self.lib.PQconnectdb(dsn.encode())
        if not self.ptr or self.lib.PQstatus(self.ptr) != CONNECTION_OK:
            msg = self.lib.PQerrorMessage(self.ptr) if self.ptr else b""
            if self.ptr:
                self.lib.PQfinish(self.ptr)
                self.ptr = None
            raise PgError(f"postgres connect failed: "
                          f"{(msg or b'').decode(errors='replace').strip()}")

    def close(self) -> None:
        if self.ptr:
            self.lib.PQfinish(self.ptr)
            self.ptr = None

    def _exec(self, sql: str, args: list[bytes | None]):
        n = len(args)
        values = (ctypes.c_char_p * n)(*args) if n else None
        res = self.lib.PQexecParams(
            self.ptr, sql.encode(), n, None, values, None, None, 0)
        status = self.lib.PQresultStatus(res)
        if status not in (PGRES_COMMAND_OK, PGRES_TUPLES_OK):
            msg = (self.lib.PQresultErrorMessage(res) or b"").decode(
                errors="replace").strip()
            state = self.lib.PQresultErrorField(res, ord("C"))  # sqlstate
            self.lib.PQclear(res)
            raise PgError(msg or "postgres query failed",
                          state.decode() if state else None)
        return res

    def query(self, sql: str, params: Params) -> tuple[list[Row], int]:
        """Run one statement; returns (rows, affected_rowcount)."""
        psql, order = translate_params(sql)
        src = dict(params or {})
        args = [encode_value(src[name]) for name in order]
        res = self._exec(psql, args)
        lib = self.lib
        try:
            rows: list[Row] = []
            nt = lib.PQntuples(res)
            nf = lib.PQnfields(res)
            if nt and nf:
                names = [lib.PQfname(res, f).decode() for f in range(nf)]
                oids = [lib.PQftype(res, f) for f in range(nf)]
                for r in range(nt):
                    row: Row = {}
                    for f in range(nf):
                        if lib.PQgetisnull(res, r, f):
                            row[names[f]] = None
                        else:
                            ln = lib.PQgetlength(res, r, f)
                            raw = ctypes.string_at(
                                lib.PQgetvalue(res, r, f), ln)
                            row[names[f]] = decode_value(raw, oids[f])
                    rows.append(row)
            cmd = lib.PQcmdTuples(res) or b""
            affected = int(cmd) if cmd.strip().isdigit() else 0
            return rows, affected
        finally:
            lib.PQclear(res)


class PgDatabase:
    """Async Postgres facade with the sqlite facade's exact API.

    ``url``: a libpq DSN or URI (``postgres://user:pw@host/db`` or
    ``host=... dbname=...``).
    """

    dialect = "postgres"
    row_lock_suffix = " FOR UPDATE SKIP LOCKED"

    def __init__(self, url: str, *, pool_size: int = 8):
        self.url = url
        self.pool_size = pool_size
        self._free: asyncio.Queue[_PgConn] | None = None
        self._opened = 0
        self._connected = False
        self._id_tables: set[str] | None = None
        self._grow_lock = asyncio.Lock()
        # Same counter contract as the sqlite facade: statements issued
        # over this facade's lifetime (serving-path zero-query asserts).
        self.query_count = 0

    @staticmethod
    def greatest(*exprs: str) -> str:
        return f"GREATEST({', '.join(exprs)})"

    # -- lifecycle ---------------------------------------------------------

    async def connect(self) -> None:
        if self._connected:
            return
        self._free = asyncio.Queue()
        conn = await asyncio.to_thread(_PgConn, self.url)
        self._free.put_nowait(conn)
        self._opened = 1
        self._connected = True

    async def disconnect(self) -> None:
        if not self._connected:
            return
        self._connected = False
        while self._free is not None and not self._free.empty():
            conn = self._free.get_nowait()
            await asyncio.to_thread(conn.close)
            self._opened -= 1
        self._free = None
        self._opened = 0

    @property
    def connected(self) -> bool:
        return self._connected

    async def _acquire(self) -> _PgConn:
        if not self._connected or self._free is None:
            raise RuntimeError("Database is not connected; call connect() first")
        if self._free.empty() and self._opened < self.pool_size:
            async with self._grow_lock:
                if self._free.empty() and self._opened < self.pool_size:
                    conn = await asyncio.to_thread(_PgConn, self.url)
                    self._opened += 1
                    return conn
        return await self._free.get()

    def _release(self, conn: _PgConn) -> None:
        if self._connected and self._free is not None:
            self._free.put_nowait(conn)
        else:
            conn.close()

    # -- INSERT id contract ------------------------------------------------

    async def _tables_with_id(self, conn: _PgConn) -> set[str]:
        if self._id_tables is None:
            rows, _ = await asyncio.to_thread(
                conn.query,
                "SELECT table_name FROM information_schema.columns "
                "WHERE column_name='id' AND table_schema='public'", None)
            self._id_tables = {r["table_name"] for r in rows}
        return self._id_tables

    async def _run(self, conn: _PgConn, sql: str, params: Params) -> Any:
        """Dispatch one statement, honoring the facade's return contract:
        INSERT -> new id (when the table has one), else affected count."""
        self.query_count += 1
        verb = sql.lstrip().split(None, 1)[0].upper() if sql.strip() else ""
        if verb == "CREATE" or verb == "ALTER":
            sql = translate_ddl(sql)
            self._id_tables = None          # schema changed
        m = _INSERT_TABLE_RE.match(sql)
        if (m and "RETURNING" not in sql.upper()
                and m.group(1).lower() in await self._tables_with_id(conn)):
            rows, _ = await asyncio.to_thread(
                conn.query, sql + " RETURNING id", params)
            return rows[0]["id"] if rows else 0
        rows, affected = await asyncio.to_thread(conn.query, sql, params)
        return affected

    # -- single-statement API ----------------------------------------------

    async def execute(self, sql: str, params: Params = None) -> int:
        conn = await self._acquire()
        try:
            return await self._run(conn, sql, params)
        finally:
            self._release(conn)

    async def execute_many(self, sql: str,
                           seq: Iterable[Mapping[str, Any]]) -> None:
        conn = await self._acquire()
        try:
            # one increment per call, not per row — the sqlite facade
            # counts executemany once, and exact-delta asserts must see
            # the same number on both backends
            self.query_count += 1
            for params in seq:
                await asyncio.to_thread(conn.query, sql, params)
        finally:
            self._release(conn)

    async def fetch_one(self, sql: str, params: Params = None) -> Row | None:
        conn = await self._acquire()
        try:
            self.query_count += 1
            rows, _ = await asyncio.to_thread(conn.query, sql, params)
            return rows[0] if rows else None
        finally:
            self._release(conn)

    async def fetch_all(self, sql: str, params: Params = None) -> list[Row]:
        conn = await self._acquire()
        try:
            self.query_count += 1
            rows, _ = await asyncio.to_thread(conn.query, sql, params)
            return rows
        finally:
            self._release(conn)

    async def fetch_val(self, sql: str, params: Params = None) -> Any:
        row = await self.fetch_one(sql, params)
        if row is None:
            return None
        return next(iter(row.values()))

    # -- transactions ------------------------------------------------------

    @asynccontextmanager
    async def transaction(self, *, immediate: bool = True
                          ) -> AsyncIterator["PgTransaction"]:
        """Open a transaction on a pinned pool connection.

        ``immediate`` is accepted for sqlite-facade compatibility; on
        Postgres every transaction takes row locks as it touches rows,
        and the claim queries add ``FOR UPDATE SKIP LOCKED`` explicitly.
        """
        conn = await self._acquire()
        try:
            await asyncio.to_thread(conn.query, "BEGIN", None)
            tx = PgTransaction(self, conn)
            try:
                yield tx
                failpoints.hit("db.commit")
            except BaseException:
                await asyncio.to_thread(conn.query, "ROLLBACK", None)
                raise
            else:
                await asyncio.to_thread(conn.query, "COMMIT", None)
        finally:
            self._release(conn)


class PgTransaction:
    """Statements bound to one in-transaction connection."""

    def __init__(self, db: PgDatabase, conn: _PgConn):
        self._db = db
        self._conn = conn

    async def execute(self, sql: str, params: Params = None) -> int:
        return await self._db._run(self._conn, sql, params)

    async def execute_many(self, sql: str,
                           seq: Iterable[Mapping[str, Any]]) -> None:
        self._db.query_count += 1   # per call, matching the sqlite facade
        for params in seq:
            await asyncio.to_thread(self._conn.query, sql, params)

    async def fetch_one(self, sql: str, params: Params = None) -> Row | None:
        self._db.query_count += 1
        rows, _ = await asyncio.to_thread(self._conn.query, sql, params)
        return rows[0] if rows else None

    async def fetch_all(self, sql: str, params: Params = None) -> list[Row]:
        self._db.query_count += 1
        rows, _ = await asyncio.to_thread(self._conn.query, sql, params)
        return rows


class PgListener:
    """Dedicated LISTEN connection feeding a callback from a daemon
    thread (select on PQsocket -> PQconsumeInput -> drain PQnotifies).

    The callback fires on the listener thread; PgNotifyBus marshals
    into the event loop. A dropped connection is retried with backoff —
    wakeups are hints, so a gap only costs poll latency."""

    def __init__(self, dsn: str, channels: tuple[str, ...],
                 callback) -> None:
        self.dsn = dsn
        self.channels = channels
        self.callback = callback
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self, ready_timeout: float = 10.0) -> None:
        """Spawn the listener and block until the LISTEN statements are
        in place — a notify published right after start() must not fall
        in the subscribe gap. Timing out (server down) is non-fatal:
        the thread keeps retrying and wakeups degrade to poll latency."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="vlog-pg-listen")
        self._thread.start()
        self._ready.wait(ready_timeout)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        import select as select_mod

        backoff = 0.5
        while not self._stop.is_set():
            conn = None
            try:
                conn = _PgConn(self.dsn)
                for ch in self.channels:
                    # identifiers can't be bound parameters; channels
                    # are compile-time constants (events.py CH_*)
                    conn.query(f'LISTEN "{ch}"', None)
                self._ready.set()
                sock = conn.lib.PQsocket(conn.ptr)
                backoff = 0.5
                while not self._stop.is_set():
                    r, _, _ = select_mod.select([sock], [], [], 0.25)
                    if not r:
                        continue
                    if not conn.lib.PQconsumeInput(conn.ptr):
                        raise PgError("listen connection lost")
                    while True:
                        note = conn.lib.PQnotifies(conn.ptr)
                        if not note:
                            break
                        try:
                            ch = (note.contents.relname or b"").decode()
                            extra = (note.contents.extra or b"").decode()
                        finally:
                            conn.lib.PQfreemem(note)
                        try:
                            self.callback(ch, extra)
                        except Exception:   # noqa: BLE001
                            pass
            except Exception:               # noqa: BLE001 — reconnect
                if self._stop.wait(backoff):
                    break
                backoff = min(backoff * 2, 10.0)
            finally:
                if conn is not None:
                    conn.close()
