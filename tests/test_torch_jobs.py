"""The port's job plane (``vlog_tpu_torch.{db,jobs,enums}``) against the
JAX package's (``vlog_tpu.{db,jobs,enums}``).

- ``create_all`` gives the same schema (``sqlite_master`` SQL, table by
  table and index by index) and the same migration record.
- The enums hold the same members with the same values (the port's
  worker shares its database with the reference's API servers, which
  parse these values).
- One script of enqueues, claims, progress, failures of every class
  (transient with backoff, permanent, device fault, preempted), releases
  with and without refund, an expired-lease sweep, tenant settings,
  commands, finalizes and a worker's startup, run on each package
  against its own database with the clock and the jitter seeded alike,
  leaves equal rows in every table it touches (the span table aside:
  span ids are random).
- Across packages on one sqlite file: jobs the reference enqueues, the
  port claims and finalizes, and the other way round.
"""

from __future__ import annotations

import enum
import random
import time
from types import SimpleNamespace

import pytest

TABLES = ("videos", "jobs", "job_failures", "workers", "video_qualities",
          "quality_progress", "transcriptions", "worker_commands",
          "settings")


def _pkg(name: str) -> SimpleNamespace:
    """One package's job plane as a namespace."""
    import importlib

    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return SimpleNamespace(
        name=name, config=mod("config"), enums=mod("enums"),
        db=mod("db"), claims=mod("jobs.claims"), vids=mod("jobs.videos"),
        qos=mod("jobs.qos"), cmds=mod("jobs.commands"),
        finalize=mod("jobs.finalize"), daemon=mod("worker.daemon"))


JAX, PORT = "vlog_tpu", "vlog_tpu_torch"


async def _open(pkg, path):
    db = pkg.db.Database(f"sqlite:///{path}")
    await db.connect()
    await pkg.db.create_all(db)
    return db


async def _dump(db, tables=TABLES) -> dict:
    return {t: await db.fetch_all(f"SELECT * FROM {t} ORDER BY 1")
            for t in tables}


# --------------------------------------------------------------------------
# schema and enums
# --------------------------------------------------------------------------

def test_create_all_gives_the_same_schema(run, tmp_path):
    async def schema(pkg, path):
        db = await _open(pkg, path)
        rows = await db.fetch_all(
            "SELECT type, name, tbl_name, sql FROM sqlite_master "
            "ORDER BY type, name")
        migrations = await db.fetch_all(
            "SELECT version FROM schema_migrations ORDER BY version")
        await db.disconnect()
        return rows, migrations

    ref = run(schema(_pkg(JAX), tmp_path / "ref.db"))
    port = run(schema(_pkg(PORT), tmp_path / "port.db"))
    assert len(ref[0]) > 20
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert _pkg(PORT).db.SCHEMA_VERSION == _pkg(JAX).db.SCHEMA_VERSION


def _enum_classes():
    from vlog_tpu import enums

    return sorted(n for n, v in vars(enums).items()
                  if isinstance(v, type) and issubclass(v, enum.Enum)
                  and v.__module__ == enums.__name__)


@pytest.mark.parametrize("name", _enum_classes())
def test_enum_values_equal(name):
    from vlog_tpu import enums as ref
    from vlog_tpu_torch import enums as port

    assert ([(m.name, m.value) for m in getattr(port, name)]
            == [(m.name, m.value) for m in getattr(ref, name)])


def test_open_database_refuses_postgres(tmp_path, monkeypatch):
    """A Postgres URL opens the port's libpq facade and is never taken
    for a sqlite path: no file appears, even after connecting fails."""
    import asyncio

    from vlog_tpu_torch.db.core import Database, open_database
    from vlog_tpu_torch.db.pg import PgDatabase, PgError

    monkeypatch.chdir(tmp_path)
    for url in ("postgres://u@h/db", "postgresql://h/db",
                "host=h dbname=vlog"):
        db = open_database(url)
        assert isinstance(db, PgDatabase) and db.dialect == "postgres"
        assert db.url == url
    refused = open_database("postgresql://u@127.0.0.1:1/vlog"
                            "?connect_timeout=2")
    with pytest.raises(PgError, match="connect failed"):
        asyncio.run(refused.connect())
    assert list(tmp_path.iterdir()) == []
    assert isinstance(open_database(f"sqlite:///{tmp_path / 'a.db'}"),
                      Database)


# --------------------------------------------------------------------------
# one script, both packages
# --------------------------------------------------------------------------

class Clock:
    def __init__(self, t0: float = 1_800_000_000.0):
        self.t = t0

    def __call__(self) -> float:
        return self.t

    def tick(self, dt: float = 1.0) -> None:
        self.t += dt


async def _script(P, db, clock, video_dir):
    """Every job-plane path the daemon drives, in a fixed order."""
    E, claims, vids = P.enums, P.claims, P.vids
    v = [await vids.create_video(db, f"Clip {i}", source_path=f"/src/{i}.mp4",
                                 size_bytes=100 + i) for i in range(5)]
    await P.qos.settings_for(db).set("qos.tenant.studio.weight", 2.0)
    j_transient = await claims.enqueue_job(db, v[0]["id"])
    j_device = await claims.enqueue_job(db, v[1]["id"], max_attempts=2)
    j_perm = await claims.enqueue_job(db, v[2]["id"], tenant="studio",
                                      payload={"codec": "h265"})
    j_sprite = await claims.enqueue_job(db, v[3]["id"], E.JobKind.SPRITE,
                                        priority=3)
    j_crash = await claims.enqueue_job(db, v[4]["id"], E.JobKind.REENCODE)
    clock.tick()
    kinds = tuple(E.JobKind)
    out = []

    # transient failure with backoff, then the backoff lapses
    job = await claims.claim_job(db, "w1", kinds=kinds)
    out.append(job["id"])
    await claims.update_progress(db, job["id"], "w1", progress=40.0,
                                 current_step="ladder")
    await claims.upsert_quality_progress(db, job["id"], "360p",
                                         status="in_progress", progress=40.0)
    clock.tick()
    await claims.fail_job(db, job["id"], "w1", "RuntimeError: boom")
    # device fault (refunded), preempted (refunded), then permanent
    for fc in (E.FailureClass.DEVICE_FAULT, E.FailureClass.PREEMPTED, None):
        clock.tick()
        job = await claims.claim_job(db, "w2", kinds=kinds)
        out.append(job["id"])
        if fc is None:
            await claims.fail_job(db, job["id"], "w2", "bad payload",
                                  permanent=True)
        else:
            await claims.fail_job(db, job["id"], "w2", f"{fc.value}",
                                  failure_class=fc)
    # release with refund, claim again, then an expired lease swept
    clock.tick()
    job = await claims.claim_job(db, "w3", kinds=kinds, lease_s=5.0)
    out.append(job["id"])
    await claims.release_job(db, job["id"], "w3")
    job = await claims.claim_job(db, "w3", kinds=kinds, lease_s=5.0)
    out.append(job["id"])
    clock.tick(10.0)
    out.append(await claims.sweep_expired_claims(db))
    # a worker's startup releases its dead incarnation's claim unrefunded
    job = await claims.claim_job(db, "w4", kinds=kinds)
    out.append(job["id"])
    kw = {"device": "cpu"} if P.name == PORT else {}
    daemon = P.daemon.WorkerDaemon(db, name="w4", video_dir=video_dir, **kw)
    await daemon.startup()
    # drain what is claimable; finalize each job of its kind
    for _ in range(8):
        clock.tick(3600.0)
        job = await claims.claim_job(db, "w5", kinds=kinds)
        if job is None:
            break
        out.append(job["id"])
        video = await vids.get_video(db, job["video_id"])
        if job["kind"] == "transcode":
            await P.finalize.finalize_transcode(
                db, job, video,
                probe={"duration_s": 2.0, "width": 128, "height": 96,
                       "fps": 24.0, "audio_codec": "aac"},
                qualities=[{"quality": "360p", "width": 128, "height": 96,
                            "bitrate": 600_000,
                            "playlist_path": "/v/360p/playlist.m3u8"}],
                thumbnail_path="/v/thumbnail.jpg")
        elif job["kind"] == "transcription":
            await P.finalize.finalize_transcription(
                db, video["id"], language="en", model="tiny",
                vtt_path=None, text="hello")
        await claims.complete_job(db, job["id"], "w5")
    # the command channel
    cid = await P.cmds.send_command(db, "w4", "ping")
    await P.cmds.drain_for_worker(db, "w4", daemon.handle_command)
    out.append((await P.cmds.get_command(db, cid))["response"])
    out.append([h["failure_class"] for j in (j_transient, j_device, j_perm,
                                             j_sprite, j_crash)
                for h in await claims.get_failure_history(db, j)])
    return out


def test_one_script_leaves_equal_rows(run, tmp_path, monkeypatch):
    clock = Clock()
    monkeypatch.setattr(time, "time", clock)
    results, dumps = {}, {}
    for name in (JAX, PORT):
        P = _pkg(name)
        monkeypatch.setattr(P.config, "RETRY_BACKOFF_BASE_S", 30.0)
        clock.t = 1_800_000_000.0
        random.seed(1234)

        async def go(P=P, name=name):
            db = await _open(P, tmp_path / f"{name}.db")
            try:
                res = await _script(P, db, clock, tmp_path / name)
                return res, await _dump(db)
            finally:
                await db.disconnect()

        results[name], dumps[name] = run(go())
    assert results[PORT] == results[JAX]
    ref, port = dumps[JAX], dumps[PORT]
    # the script reached every table it means to
    for t in ("videos", "jobs", "job_failures", "workers", "video_qualities",
              "quality_progress", "transcriptions", "worker_commands",
              "settings"):
        assert ref[t], t
    classes = {r["failure_class"] for r in ref["job_failures"]}
    assert {"transient", "device_fault", "preempted", "permanent",
            "worker_crash"} <= classes
    assert any(r["next_retry_at"] for r in ref["jobs"]) or any(
        r["completed_at"] for r in ref["jobs"])
    for t in TABLES:
        assert port[t] == ref[t], t


# --------------------------------------------------------------------------
# one sqlite file, both packages
# --------------------------------------------------------------------------

def test_reference_enqueues_port_claims_and_finalizes(run, tmp_path):
    J, P = _pkg(JAX), _pkg(PORT)
    path = tmp_path / "shared.db"

    async def go():
        jdb, pdb = await _open(J, path), await _open(P, path)
        try:
            video = await J.vids.create_video(jdb, "Shared",
                                              source_path="/src/a.mp4")
            jid = await J.claims.enqueue_job(jdb, video["id"])
            job = await P.claims.claim_job(
                pdb, "port-w", accelerator=P.enums.AcceleratorKind.TPU)
            assert job["id"] == jid and job["attempt"] == 1
            await P.claims.update_progress(pdb, jid, "port-w", progress=50.0)
            await P.finalize.finalize_transcode(
                pdb, job, await P.vids.get_video(pdb, video["id"]),
                probe={"duration_s": 1.0, "width": 64, "height": 48,
                       "fps": 24.0, "audio_codec": "aac"},
                qualities=[{"quality": "360p", "width": 64, "height": 48,
                            "bitrate": 600_000, "playlist_path": "/p"}],
                thumbnail_path=None)
            await P.claims.complete_job(pdb, jid, "port-w")
            # the reference reads what the port wrote
            row = await J.vids.get_video(jdb, video["id"])
            assert row["status"] == "ready" and row["width"] == 64
            jrow = await jdb.fetch_one("SELECT * FROM jobs WHERE id=:i",
                                       {"i": jid})
            assert jrow["completed_at"] is not None
            assert jrow["progress"] == 100.0
            kinds = {r["kind"] for r in await jdb.fetch_all(
                "SELECT kind FROM jobs WHERE video_id=:v",
                {"v": video["id"]})}
            assert kinds == {"transcode", "sprite", "transcription"}
            # and claims the port's downstream enqueue
            nxt = await J.claims.claim_job(
                jdb, "jax-w", kinds=(J.enums.JobKind.SPRITE,))
            assert nxt["kind"] == "sprite"
            await J.claims.complete_job(jdb, nxt["id"], "jax-w")
        finally:
            await jdb.disconnect()
            await pdb.disconnect()

    run(go())


def test_port_enqueues_reference_claims_and_fails(run, tmp_path):
    J, P = _pkg(JAX), _pkg(PORT)
    path = tmp_path / "shared.db"

    async def go():
        jdb, pdb = await _open(J, path), await _open(P, path)
        try:
            video = await P.vids.create_video(pdb, "Other",
                                              source_path="/src/b.mp4")
            jid = await P.claims.enqueue_job(
                pdb, video["id"], P.enums.JobKind.REENCODE,
                payload={"codec": "h265", "streaming_format": "cmaf"},
                max_attempts=2)
            job = await J.claims.claim_job(
                jdb, "jax-w", kinds=(J.enums.JobKind.REENCODE,))
            assert job["id"] == jid and job["payload"] == (
                '{"codec": "h265", "streaming_format": "cmaf"}')
            row = await J.claims.fail_job(
                jdb, jid, "jax-w", "device lost",
                failure_class=J.enums.FailureClass.DEVICE_FAULT)
            assert row["attempt"] == 0
            # the port sees the refunded job claimable and completes it
            again = await P.claims.claim_job(
                pdb, "port-w", kinds=(P.enums.JobKind.REENCODE,))
            assert again["id"] == jid and again["attempt"] == 1
            await P.claims.complete_job(pdb, jid, "port-w")
            hist = await J.claims.get_failure_history(jdb, jid)
            assert [h["failure_class"] for h in hist] == ["device_fault"]
            done = await jdb.fetch_one("SELECT * FROM jobs WHERE id=:i",
                                       {"i": jid})
            assert done["completed_at"] is not None
        finally:
            await jdb.disconnect()
            await pdb.disconnect()

    run(go())
