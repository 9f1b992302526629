"""In-process Postgres wire-protocol (v3) server backed by sqlite (a copy
of ``vlog_tpu/db/pgfake.py``).

Purpose: the first-party libpq client (db/pg.py) must be exercisable
END TO END — connect, extended-protocol query, transactions, RETURNING
id, LISTEN/NOTIFY — in an image that ships no Postgres server. This
speaks enough of the v3 protocol for libpq's ``PQconnectdb`` +
``PQexecParams`` + notification delivery, executing statements against
a shared in-memory sqlite database (per-connection sqlite handles on a
shared cache, ``BEGIN`` mapped to ``BEGIN IMMEDIATE`` so concurrent
claim transactions serialize the same way the sqlite facade does).

It is a TEST DOUBLE: PG-specific SQL is translated sqlite-ward
(``FOR UPDATE SKIP LOCKED`` stripped, ``GREATEST``→``max``, BIGSERIAL
DDL reversed, ``information_schema.columns`` served from sqlite
introspection, ``pg_notify`` fanned out as NotificationResponse
messages to listening connections). Row-lock semantics are sqlite's
single-writer model, not Postgres row locks — the live-server tests
(VLOG_TEST_PG_DSN) remain the authority there. Everything the CLIENT
does (param translation, text-format encode/decode, OID mapping,
pooled transactions, the listener thread's select/consume/notify loop)
runs for real against real wire bytes.

Reference shape: the reference tests against a live Postgres
(tests/conftest.py fixtures over asyncpg); this image cannot, hence
the fake. Protocol per the PostgreSQL Frontend/Backend documentation.
"""

from __future__ import annotations

import re
import shutil
import socket
import socketserver
import sqlite3
import struct
import tempfile
import threading
from typing import Any

# type OIDs (mirrors db/pg.py's decode table)
_OID_INT8 = 20
_OID_FLOAT8 = 701
_OID_TEXT = 25
_OID_BYTEA = 17

_STRIP_LOCK_RE = re.compile(r"\s+FOR\s+UPDATE(\s+SKIP\s+LOCKED)?", re.I)
_GREATEST_RE = re.compile(r"\bGREATEST\s*\(", re.I)
_DDL_REWRITES = [
    (re.compile(r"\bBIGSERIAL\s+PRIMARY\s+KEY\b", re.I),
     "INTEGER PRIMARY KEY AUTOINCREMENT"),
    (re.compile(r"\bDOUBLE\s+PRECISION\b", re.I), "REAL"),
    (re.compile(r"\bBYTEA\b", re.I), "BLOB"),
]
_INFO_SCHEMA_RE = re.compile(r"\binformation_schema\.columns\b", re.I)
_PG_NOTIFY_RE = re.compile(
    r"^\s*SELECT\s+pg_notify\s*\(\s*\$1\s*,\s*\$2\s*\)\s*$", re.I)
# The facade's INSERT-id contract appends "RETURNING id"; sqlite only
# grew RETURNING in 3.35, so older runtimes strip it and synthesize the
# rows from rowid arithmetic instead (see _execute).
_RETURNING_ID_RE = re.compile(r"\s+RETURNING\s+id\s*;?\s*$", re.I)
_LISTEN_RE = re.compile(r'^\s*LISTEN\s+"?([A-Za-z_][\w]*)"?\s*$', re.I)
_PARAM_RE = re.compile(r"\$(\d+)")


def _to_sqlite(sql: str) -> str:
    sql = _STRIP_LOCK_RE.sub("", sql)
    sql = _GREATEST_RE.sub("max(", sql)
    for pat, repl in _DDL_REWRITES:
        sql = pat.sub(repl, sql)
    # positional params: $n -> ?n (sqlite numbered placeholders)
    sql = _PARAM_RE.sub(r"?\1", sql)
    head = sql.lstrip()[:12].upper()
    if head.startswith("BEGIN"):
        # serialize writers up front — the same guarantee the sqlite
        # facade's BEGIN IMMEDIATE gives the claim protocol
        return "BEGIN IMMEDIATE"
    return sql


class _Wire:
    """Framed read/write over the client socket. Reads buffer partial
    data across timeouts: a socket timeout mid-message leaves every
    byte in the buffer, so the next call resumes cleanly (the handler
    uses idle timeouts to flush notifications)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._buf = b""

    def _ensure(self, n: int) -> None:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)   # may raise socket.timeout
            if not chunk:
                raise ConnectionError("client closed")
            self._buf += chunk

    def read_startup(self) -> tuple[int, bytes]:
        self._ensure(4)
        (ln,) = struct.unpack("!i", self._buf[:4])
        self._ensure(ln)
        body = self._buf[4:ln]
        self._buf = self._buf[ln:]
        (code,) = struct.unpack("!i", body[:4])
        return code, body[4:]

    def read_message(self) -> tuple[bytes, bytes]:
        self._ensure(5)
        t = self._buf[0:1]
        (ln,) = struct.unpack("!i", self._buf[1:5])
        self._ensure(1 + ln)
        body = self._buf[5:1 + ln]
        self._buf = self._buf[1 + ln:]
        return t, body

    def send(self, t: bytes, body: bytes = b"") -> None:
        self.sock.sendall(t + struct.pack("!i", len(body) + 4) + body)


def _cstr(b: bytes, pos: int) -> tuple[bytes, int]:
    end = b.index(b"\x00", pos)
    return b[pos:end], end + 1


def _encode_field(v: Any) -> bytes | None:
    if v is None:
        return None
    if isinstance(v, bytes):
        return b"\\x" + v.hex().encode()
    if isinstance(v, float):
        return repr(v).encode()
    if isinstance(v, str):
        return v.encode()
    return str(v).encode()


def _oid_for(v: Any) -> int:
    if isinstance(v, bool) or isinstance(v, int):
        return _OID_INT8
    if isinstance(v, float):
        return _OID_FLOAT8
    if isinstance(v, bytes):
        return _OID_BYTEA
    return _OID_TEXT


class _Handler(socketserver.BaseRequestHandler):
    server: "FakePg"

    def handle(self) -> None:   # noqa: C901 — a protocol loop is a loop
        wire = _Wire(self.request)
        code, params = wire.read_startup()
        while code in (80877103, 80877104):   # SSL / GSSENC probe -> no
            self.request.sendall(b"N")
            code, params = wire.read_startup()
        if code == 80877102:            # CancelRequest — ignore politely
            return
        # AuthenticationOk + minimal parameters + ReadyForQuery
        wire.send(b"R", struct.pack("!i", 0))
        for k, v in (("server_version", "15.0 (vlog-fake)"),
                     ("client_encoding", "UTF8"),
                     ("standard_conforming_strings", "on")):
            wire.send(b"S", k.encode() + b"\x00" + v.encode() + b"\x00")
        wire.send(b"K", struct.pack("!ii", 7, 7))
        wire.send(b"Z", b"I")

        conn = self.server._sqlite_conn()
        listening: set[str] = set()
        notif_q: list[tuple[str, str]] = []
        self.server._register(listening, notif_q)
        self.request.settimeout(0.2)
        stmts: dict[bytes, str] = {}
        portals: dict[bytes, tuple[str, list[bytes | None]]] = {}
        pending_desc: list[tuple[str, str]] = []
        try:
            while True:
                # push queued notifications whenever the wire is idle
                try:
                    t, body = wire.read_message()
                except socket.timeout:
                    self._flush_notifs(wire, notif_q)
                    continue
                if t == b"X":
                    return
                if t == b"Q":           # simple query
                    self._run_and_respond(wire, conn, body[:-1].decode(),
                                          [], listening, describe=True)
                    self._flush_notifs(wire, notif_q)
                    wire.send(b"Z", b"I" if not conn.in_transaction
                              else b"T")
                elif t == b"P":         # Parse
                    name, pos = _cstr(body, 0)
                    q, pos = _cstr(body, pos)
                    stmts[name] = q.decode()
                    wire.send(b"1")
                elif t == b"B":         # Bind
                    portal, pos = _cstr(body, 0)
                    sname, pos = _cstr(body, pos)
                    (nfmt,) = struct.unpack("!h", body[pos:pos + 2])
                    pos += 2 + 2 * nfmt
                    (nparams,) = struct.unpack("!h", body[pos:pos + 2])
                    pos += 2
                    args: list[bytes | None] = []
                    for _ in range(nparams):
                        (ln,) = struct.unpack("!i", body[pos:pos + 4])
                        pos += 4
                        if ln < 0:
                            args.append(None)
                        else:
                            args.append(body[pos:pos + ln])
                            pos += ln
                    portals[portal] = (stmts.get(sname, ""), args)
                    wire.send(b"2")
                elif t == b"D":         # Describe — deferred to Execute
                    pass
                elif t == b"E":         # Execute
                    portal, _ = _cstr(body, 0)
                    q, args = portals.get(portal, ("", []))
                    self._run_and_respond(wire, conn, q, args, listening,
                                          describe=True)
                elif t == b"S":         # Sync
                    self._flush_notifs(wire, notif_q)
                    wire.send(b"Z", b"I" if not conn.in_transaction
                              else b"T")
                elif t in (b"C", b"H", b"F", b"d", b"c", b"f"):
                    pass                # close/flush/copy — unused
        except (ConnectionError, OSError):
            pass
        finally:
            self.server._unregister(listening, notif_q)
            conn.close()

    # -- execution ---------------------------------------------------------

    def _flush_notifs(self, wire: _Wire,
                      notif_q: list[tuple[str, str]]) -> None:
        while notif_q:
            ch, payload = notif_q.pop(0)
            wire.send(b"A", struct.pack("!i", 7) + ch.encode() + b"\x00"
                      + payload.encode() + b"\x00")

    def _run_and_respond(self, wire: _Wire, conn: sqlite3.Connection,
                         sql: str, args: list[bytes | None],
                         listening: set[str], *, describe: bool) -> None:
        try:
            rows, cols, tag = self._execute(conn, sql, args, listening)
        except Exception as exc:   # noqa: BLE001 — relay as ErrorResponse
            # no auto-rollback: the facade's transaction() issues its own
            # ROLLBACK after an error, and pre-empting it here would turn
            # that into "cannot rollback - no transaction is active",
            # masking the original error
            msg = str(exc)
            state = "40001" if "locked" in msg.lower() else "XX000"
            body = (b"S" + b"ERROR\x00" + b"C" + state.encode() + b"\x00"
                    + b"M" + msg.encode() + b"\x00\x00")
            wire.send(b"E", body)
            return
        if cols is not None:
            # RowDescription OIDs from the first NON-NULL value per
            # column (a NULL in row one must not demote later numeric
            # values to text on the client side)
            def col_oid(i: int) -> int:
                for r in rows:
                    if r[i] is not None:
                        return _oid_for(r[i])
                return _OID_TEXT
            parts = [struct.pack("!h", len(cols))]
            for i, c in enumerate(cols):
                parts.append(c.encode() + b"\x00" + struct.pack(
                    "!ihihih", 0, 0, col_oid(i), -1, -1, 0))
            wire.send(b"T", b"".join(parts))
            for r in rows:
                parts = [struct.pack("!h", len(r))]
                for v in r:
                    enc = _encode_field(v)
                    if enc is None:
                        parts.append(struct.pack("!i", -1))
                    else:
                        parts.append(struct.pack("!i", len(enc)) + enc)
                wire.send(b"D", b"".join(parts))
        elif describe:
            wire.send(b"n")             # NoData
        wire.send(b"C", tag.encode() + b"\x00")

    def _execute(self, conn: sqlite3.Connection, sql: str,
                 args: list[bytes | None], listening: set[str]):
        """Returns (rows, colnames | None, command_tag)."""
        m = _LISTEN_RE.match(sql)
        if m:
            listening.add(m.group(1))
            return [], None, "LISTEN"
        if _PG_NOTIFY_RE.match(sql):
            ch = (args[0] or b"").decode()
            payload = (args[1] or b"").decode()
            self.server.notify(ch, payload)
            return [[None]], ["pg_notify"], "SELECT 1"
        if _INFO_SCHEMA_RE.search(sql):
            # serve the facade's id-column introspection from sqlite
            rows = []
            cur = conn.execute(
                "SELECT name FROM sqlite_master WHERE type='table'")
            for (tname,) in cur.fetchall():
                cols = conn.execute(f"PRAGMA table_info({tname})")
                if any(c[1] == "id" for c in cols.fetchall()):
                    rows.append([tname])
            return rows, ["table_name"], f"SELECT {len(rows)}"
        ssql = _to_sqlite(sql)
        verb0 = (ssql.lstrip().split(None, 1) or ["?"])[0].upper()
        if verb0 == "ROLLBACK" and not conn.in_transaction:
            return [], None, "ROLLBACK"   # PG tolerates; sqlite errors
        params = [None if a is None else a.decode() for a in args]
        synth_returning = False
        if verb0 == "INSERT" and sqlite3.sqlite_version_info < (3, 35, 0):
            stripped = _RETURNING_ID_RE.sub("", ssql)
            if stripped != ssql:
                ssql = stripped
                synth_returning = True
        cur = conn.execute(ssql, params)
        if synth_returning:
            # one statement's rowids are allocated in order, so the new
            # ids are the last n: [lastrowid-n+1 .. lastrowid]
            n = max(cur.rowcount, 0)
            last = cur.lastrowid or 0
            rows = ([[last - n + 1 + i] for i in range(n)]
                    if n and last else [])
            return rows, ["id"], f"INSERT 0 {len(rows)}"
        verb = (ssql.lstrip().split(None, 1) or ["?"])[0].upper()
        if cur.description is not None:
            cols = [d[0] for d in cur.description]
            rows = [list(r) for r in cur.fetchall()]
            if verb == "INSERT":        # INSERT ... RETURNING
                return rows, cols, f"INSERT 0 {len(rows)}"
            return rows, cols, f"SELECT {len(rows)}"
        n = max(cur.rowcount, 0)
        if verb in ("UPDATE", "DELETE"):
            tag = f"{verb} {n}"
        elif verb == "INSERT":
            tag = f"INSERT 0 {n}"
        elif verb in ("BEGIN",):
            tag = "BEGIN"
        elif verb == "COMMIT":
            tag = "COMMIT"
        elif verb == "ROLLBACK":
            tag = "ROLLBACK"
        else:
            tag = verb
        return [], None, tag


class FakePg(socketserver.ThreadingTCPServer):
    """Threaded fake server; one sqlite handle per client connection on
    a shared in-memory cache (the anchor handle keeps it alive)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self) -> None:
        super().__init__(("127.0.0.1", 0), _Handler)
        # File-backed WAL store (not :memory: shared cache): shared-cache
        # table locks return SQLITE_LOCKED immediately — the busy
        # handler does not apply — so concurrent BEGIN IMMEDIATE claim
        # transactions would error instead of serializing. WAL + busy
        # timeout gives the same writer-serialization semantics the
        # production sqlite facade has.
        self._tmpdir = tempfile.mkdtemp(prefix="vlog-fakepg-")
        self._dbpath = f"{self._tmpdir}/fake.db"
        self._anchor = self._sqlite_conn()
        self._listeners_lock = threading.Lock()
        self._listeners: list[tuple[set[str], list]] = []
        self._thread = threading.Thread(
            target=self.serve_forever, daemon=True, name="vlog-fakepg")

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FakePg":
        self._thread.start()
        return self

    def stop(self) -> None:
        self.shutdown()
        self.server_close()
        self._anchor.close()
        shutil.rmtree(self._tmpdir, ignore_errors=True)

    @property
    def dsn(self) -> str:
        host, port = self.server_address
        # sslmode=disable skips the SSLRequest round-trip; gssencmode
        # likewise (newer libpq probes GSS first otherwise)
        return (f"host={host} port={port} dbname=fake user=fake "
                f"sslmode=disable gssencmode=disable")

    # -- shared sqlite -----------------------------------------------------

    def _sqlite_conn(self) -> sqlite3.Connection:
        conn = sqlite3.connect(
            self._dbpath, timeout=10.0, check_same_thread=False,
            isolation_level=None)
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=NORMAL")
        conn.execute("PRAGMA busy_timeout=10000")
        return conn

    # -- notifications -----------------------------------------------------

    def _register(self, listening, q) -> None:
        with self._listeners_lock:
            self._listeners.append((listening, q))

    def _unregister(self, listening, q) -> None:
        with self._listeners_lock:
            try:
                self._listeners.remove((listening, q))
            except ValueError:
                pass

    def notify(self, channel: str, payload: str) -> None:
        """Queue for listening connections; their handler threads flush
        on the next idle tick (<=0.2 s — the recv timeout)."""
        with self._listeners_lock:
            for listening, q in self._listeners:
                if channel in listening:
                    q.append((channel, payload))
