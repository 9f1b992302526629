"""The port's Postgres facade (``vlog_tpu_torch.db.pg``), its wire-protocol
test double (``vlog_tpu_torch.db.pgfake``) and the LISTEN/NOTIFY bus
(``vlog_tpu_torch.jobs.events.PgNotifyBus``) against the JAX package's.

- The SQL rewrites (``translate_params``, ``translate_ddl``) give the
  reference's output on a corpus of quoting cases and on every statement
  the port's ``schema.create_all`` and its claim protocol send over the
  wire (recorded at the libpq connection).
- Across packages, on each pair (port facade on the port's ``FakePg``,
  port facade on the reference's, reference facade on the port's):
  ``create_all``, ``RETURNING id``, a rolled-back transaction, and a
  wakeup through ``PgNotifyBus``; a database one package's facade made is
  read and claimed by the other's job plane.
- The job-plane script of ``tests/test_torch_jobs.py`` run over each
  package's facade and fake leaves equal rows.

No Postgres server exists here: ``FakePg`` speaks the v3 protocol to the
system ``libpq.so.5`` over loopback. Every test that starts one runs
under an ``asyncio.timeout`` of its own.
"""

from __future__ import annotations

import asyncio
import importlib
import random
import time

import pytest

from tests.test_torch_jobs import JAX, PORT, TABLES, Clock, _dump, _pkg, \
    _script
from vlog_tpu.db import pg as ref_pg
from vlog_tpu_torch.db import pg as port_pg
from vlog_tpu_torch.db.core import open_database

TIMEOUT_S = 60.0


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture
def fakes():
    """One started ``FakePg`` per package, stopped after the test."""
    servers = {pkg: _mod(pkg, "db.pgfake").FakePg().start()
               for pkg in (JAX, PORT)}
    yield servers
    for srv in servers.values():
        srv.stop()


def _url(fake) -> str:
    """The fake's address as a ``postgresql://`` URL (what an operator
    passes as ``VLOG_DATABASE_URL``)."""
    host, port = fake.server_address
    return (f"postgresql://fake@{host}:{port}/fake"
            "?sslmode=disable&gssencmode=disable")


# --------------------------------------------------------------------------
# the SQL rewrites
# --------------------------------------------------------------------------

QUOTING = (
    "UPDATE jobs SET a=:t, b=:x, c=:t WHERE id=:id",
    "SELECT x::text FROM t WHERE a=:a",
    "SELECT 1",
    "SELECT * FROM t WHERE tag=':notaparam' AND id=:id",
    "UPDATE t SET s='it''s :x o''clock' WHERE a=:a",
    'SELECT ":notcol" FROM t WHERE b=:b',
    r"SELECT E'a\':x' WHERE c=:c",
    "SELECT * FROM t WHERE name LIKE'x:y' AND d=:d",
    "CREATE TABLE IF NOT EXISTS t (id INTEGER PRIMARY KEY AUTOINCREMENT, "
    "ts REAL NOT NULL, data BLOB)",
    "CREATE INDEX IF NOT EXISTS ix ON t(ts)",
    "ALTER TABLE t ADD COLUMN r REAL",
    "SELECT * FROM t WHERE note='REAL BLOB'",
)


async def _record(fake, monkeypatch) -> dict[str, list[str]]:
    """Every statement the port's facade sends while ``create_all`` runs,
    and while the claim protocol enqueues, claims, reports, fails,
    releases, sweeps and completes: each DDL statement before and after
    its rewrite, every statement as it reaches the connection."""
    from vlog_tpu_torch.db.schema import create_all
    from vlog_tpu_torch.enums import JobKind
    from vlog_tpu_torch.jobs import claims, videos as vids

    sent: list[str] = []
    query, ddl = port_pg._PgConn.query, port_pg.translate_ddl

    def spy(self, sql, params):
        sent.append(sql)
        return query(self, sql, params)

    def ddl_spy(sql):           # the DDL as the schema module wrote it
        sent.append(sql)
        return ddl(sql)

    monkeypatch.setattr(port_pg._PgConn, "query", spy)
    monkeypatch.setattr(port_pg, "translate_ddl", ddl_spy)
    db = open_database(_url(fake))
    await db.connect()
    try:
        await create_all(db)
        schema = list(sent)
        sent.clear()
        v = [await vids.create_video(db, f"c{i}") for i in range(3)]
        j0 = await claims.enqueue_job(db, v[0]["id"])
        await claims.enqueue_job(db, v[1]["id"], JobKind.SPRITE)
        await claims.enqueue_job(db, v[2]["id"], tenant="studio")
        job = await claims.claim_job(db, "w1")
        await claims.update_progress(db, job["id"], "w1", progress=10.0,
                                     current_step="ladder")
        await claims.upsert_quality_progress(db, job["id"], "360p",
                                             status="in_progress",
                                             progress=10.0)
        await claims.fail_job(db, job["id"], "w1", "boom")
        job = await claims.claim_job(db, "w2", lease_s=1.0)
        await claims.release_job(db, job["id"], "w2")
        await claims.claim_jobs(db, "w3", kinds=tuple(JobKind), max_jobs=2,
                                 lease_s=0.01)
        await claims.sweep_expired_claims(db)
        job = await claims.claim_job(db, "w4")
        if job is not None:
            await claims.complete_job(db, job["id"], "w4")
        await claims.get_failure_history(db, j0)
        return {"schema": schema, "claims": list(sent)}
    finally:
        await db.disconnect()


@pytest.fixture(scope="module")
def recorded():
    fake = _mod(PORT, "db.pgfake").FakePg().start()
    loop = asyncio.new_event_loop()
    try:
        with pytest.MonkeyPatch.context() as mp:
            return loop.run_until_complete(
                asyncio.wait_for(_record(fake, mp), TIMEOUT_S))
    finally:
        loop.close()
        fake.stop()


@pytest.mark.parametrize("corpus", ["quoting", "schema", "claims"])
def test_rewrites_equal_the_reference(corpus, request):
    ddl = port_pg.translate_ddl
    if corpus == "quoting":
        statements = list(QUOTING)
    else:
        statements = request.getfixturevalue("recorded")[corpus]
    assert len(statements) >= (10 if corpus == "quoting" else 20)
    if corpus == "schema":
        assert any("AUTOINCREMENT" in s for s in statements)
    if corpus == "claims":
        assert any(port_pg.PgDatabase.row_lock_suffix in s
                   for s in statements)
        assert any(s.endswith(" RETURNING id") for s in statements)
    for sql in statements:
        assert port_pg.translate_params(sql) == ref_pg.translate_params(sql)
        assert ddl(sql) == ref_pg.translate_ddl(sql)


def test_value_codecs_equal_the_reference():
    values = (None, True, False, b"\x00\xff", 1.5, 0.1 + 0.2, 42, -7,
              "it's :x", 1_800_000_000.123456)
    for v in values:
        assert port_pg.encode_value(v) == ref_pg.encode_value(v)
    raws = ((b"t", 16), (b"f", 16), (b"123", 20), (b"-4", 23), (b"7", 21),
            (b"1.25", 701), (b"2.5", 700), (b"3", 1700),
            (b"\\x00ff", 17), (b"text", 25))
    for raw, oid in raws:
        assert port_pg.decode_value(raw, oid) == ref_pg.decode_value(raw, oid)


def test_dialect_hooks_equal_the_reference():
    for cls in (port_pg.PgDatabase, ref_pg.PgDatabase):
        assert cls.dialect == "postgres"
        assert cls.row_lock_suffix == " FOR UPDATE SKIP LOCKED"
        assert cls.greatest("a", ":w") == "GREATEST(a, :w)"
    assert port_pg.load_libpq().PQlibVersion() >= 90000


# --------------------------------------------------------------------------
# facade x fake, across packages
# --------------------------------------------------------------------------

PAIRS = [(PORT, PORT), (PORT, JAX), (JAX, PORT)]    # (facade, fake)
CHECKS = ["create_all", "returning_id", "rollback", "notify"]


async def _check(check: str, facade: str, url: str) -> None:
    db = _mod(facade, "db.pg").PgDatabase(url)
    await db.connect()
    try:
        if check == "create_all":
            await _mod(facade, "db.schema").create_all(db)
            tables = {r["table_name"] for r in await db.fetch_all(
                "SELECT table_name FROM information_schema.columns "
                "WHERE column_name='id' AND table_schema='public'")}
            assert {"videos", "jobs", "playback_sessions"} <= tables
            assert await db.fetch_val(
                "SELECT COUNT(*) FROM schema_migrations") >= 1
        elif check == "returning_id":
            await db.execute("CREATE TABLE t (id INTEGER PRIMARY KEY "
                             "AUTOINCREMENT, name TEXT, score REAL)")
            ids = [await db.execute(
                "INSERT INTO t (name, score) VALUES (:n, :s)",
                {"n": n, "s": s}) for n, s in (("a", 1.5), ("it's :x", 2.25))]
            assert ids == [1, 2]
            assert await db.fetch_all("SELECT * FROM t ORDER BY id") == [
                {"id": 1, "name": "a", "score": 1.5},
                {"id": 2, "name": "it's :x", "score": 2.25}]
            assert await db.execute("UPDATE t SET score=:s WHERE id>:i",
                                    {"s": 0.0, "i": 0}) == 2
        elif check == "rollback":
            await db.execute("CREATE TABLE tx (id INTEGER PRIMARY KEY "
                             "AUTOINCREMENT, v TEXT)")
            async with db.transaction() as tx:
                await tx.execute("INSERT INTO tx (v) VALUES (:v)", {"v": "a"})
            with pytest.raises(RuntimeError, match="boom"):
                async with db.transaction() as tx:
                    await tx.execute("INSERT INTO tx (v) VALUES (:v)",
                                     {"v": "b"})
                    raise RuntimeError("boom")
            assert await db.fetch_all("SELECT v FROM tx ORDER BY id") == [
                {"v": "a"}]
        else:
            events = _mod(facade, "jobs.events")
            bus = events.bus_for(db)
            assert type(bus).__name__ == "PgNotifyBus"
            await bus.start()
            try:
                sub = bus.subscribe(events.CH_JOBS)
                bus.publish(events.CH_JOBS, {"job_id": 42})
                assert await sub.get(timeout=10.0) == {"job_id": 42}
            finally:
                await bus.close()
    finally:
        await db.disconnect()


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("facade,fake", PAIRS,
                         ids=[f"{a}-on-{b}" for a, b in PAIRS])
def test_facade_on_fake(facade, fake, check, fakes, run):
    run(asyncio.wait_for(_check(check, facade, _url(fakes[fake])),
                         TIMEOUT_S))


@pytest.mark.parametrize("maker,claimer", [(PORT, JAX), (JAX, PORT)])
def test_database_made_by_one_facade_is_claimed_by_the_other(
        maker, claimer, fakes, run):
    """``create_all`` and the enqueue through one package's facade and job
    plane; the claim, progress and completion through the other's."""
    url = _url(fakes[PORT])

    async def go():
        a = _pkg(maker)
        db = _mod(maker, "db.pg").PgDatabase(url)
        await db.connect()
        await _mod(maker, "db.schema").create_all(db)
        video = await a.vids.create_video(db, "cross", source_path="/s.mp4")
        job_id = await a.claims.enqueue_job(db, video["id"])
        await db.disconnect()

        b = _pkg(claimer)
        db = _mod(claimer, "db.pg").PgDatabase(url)
        await db.connect()
        try:
            await _mod(claimer, "db.schema").create_all(db)   # idempotent
            job = await b.claims.claim_job(db, "w-other")
            assert job is not None and job["id"] == job_id
            assert await b.claims.claim_job(db, "w-late") is None
            await b.claims.update_progress(db, job_id, "w-other",
                                           progress=50.0)
            await b.claims.complete_job(db, job_id, "w-other")
            row = await db.fetch_one("SELECT * FROM jobs WHERE id=:i",
                                     {"i": job_id})
            assert row["completed_at"] is not None
            assert row["claimed_by"] is None
            assert (await b.vids.get_video(db, video["id"]))["title"] == \
                "cross"
        finally:
            await db.disconnect()

    run(asyncio.wait_for(go(), TIMEOUT_S))


# --------------------------------------------------------------------------
# the job plane over the facade
# --------------------------------------------------------------------------

def test_one_script_over_postgres_leaves_equal_rows(run, fakes, tmp_path,
                                                    monkeypatch):
    """``tests/test_torch_jobs.py``'s script (enqueues, claims, progress,
    failures of every class, release, sweep, finalize, commands, a
    worker's startup), each package's job plane over its own facade and
    its own ``FakePg``, the clock and the jitter seeded alike."""
    clock = Clock()
    monkeypatch.setattr(time, "time", clock)
    results, dumps = {}, {}
    for name in (JAX, PORT):
        P = _pkg(name)
        monkeypatch.setattr(P.config, "RETRY_BACKOFF_BASE_S", 30.0)
        # the claim plan's cache lapses on the real monotonic clock; a
        # statement over the wire takes milliseconds, so pin the cache
        # (the plan is still dirtied by the enqueues that change it) or
        # the claim order follows the machine's speed
        monkeypatch.setattr(P.qos, "PLAN_TTL_S", float("inf"))
        clock.t = 1_800_000_000.0
        random.seed(1234)

        async def go(P=P, name=name):
            db = _mod(name, "db.pg").PgDatabase(_url(fakes[name]))
            await db.connect()
            try:
                await P.db.create_all(db)
                res = await _script(P, db, clock, tmp_path / name)
                return res, await _dump(db)
            finally:
                await db.disconnect()

        results[name], dumps[name] = run(asyncio.wait_for(go(), TIMEOUT_S))
    assert results[PORT] == results[JAX]
    ref, port = dumps[JAX], dumps[PORT]
    assert ref["jobs"] and any(r["completed_at"] for r in ref["jobs"])
    for t in TABLES:
        assert port[t] == ref[t], t
