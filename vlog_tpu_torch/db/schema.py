"""Schema DDL + migrations (a copy of
``vlog_tpu/db/schema.py``).

Reference parity: api/database.py:137-942 (core tables) and migrations/
(27 Alembic revisions). Here the schema is expressed as ordered DDL
migrations applied through a ``schema_migrations`` ledger, so later rounds
can evolve the schema the way the reference's Alembic history did.

Timestamps are unix-epoch REAL seconds (``vlog_tpu_torch.db.core.now``).
JSON-valued columns are TEXT holding canonical JSON.
"""

from __future__ import annotations

from vlog_tpu_torch.db.core import Database, now

SCHEMA_VERSION = 6

# Each entry: (version, [statements]). Append-only.
MIGRATIONS: list[tuple[int, list[str]]] = [
    (
        1,
        [
            # -- videos (reference: database.py videos table) --------------
            """
            CREATE TABLE IF NOT EXISTS videos (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                slug TEXT NOT NULL UNIQUE,
                title TEXT NOT NULL,
                description TEXT NOT NULL DEFAULT '',
                original_filename TEXT,
                source_path TEXT,
                duration_s REAL,
                width INTEGER,
                height INTEGER,
                fps REAL,
                size_bytes INTEGER,
                status TEXT NOT NULL DEFAULT 'pending',
                streaming_format TEXT NOT NULL DEFAULT 'cmaf',
                codec TEXT NOT NULL DEFAULT 'h264',
                error TEXT,
                thumbnail_path TEXT,
                transcription_status TEXT NOT NULL DEFAULT 'pending',
                category TEXT,
                tags TEXT NOT NULL DEFAULT '[]',
                created_at REAL NOT NULL,
                updated_at REAL NOT NULL,
                deleted_at REAL,
                CHECK (status IN ('pending','processing','ready','failed','deleted'))
            )
            """,
            "CREATE INDEX IF NOT EXISTS idx_videos_status ON videos(status)",
            "CREATE INDEX IF NOT EXISTS idx_videos_created ON videos(created_at)",
            # -- per-rung outputs (reference: video_qualities) --------------
            """
            CREATE TABLE IF NOT EXISTS video_qualities (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                video_id INTEGER NOT NULL REFERENCES videos(id) ON DELETE CASCADE,
                name TEXT NOT NULL,
                width INTEGER NOT NULL,
                height INTEGER NOT NULL,
                video_bitrate INTEGER,
                audio_bitrate INTEGER,
                codec TEXT NOT NULL DEFAULT 'h264',
                playlist_path TEXT,
                created_at REAL NOT NULL,
                UNIQUE (video_id, name, codec)
            )
            """,
            # -- unified job queue ------------------------------------------
            # The reference spread transcode/sprite/reencode over separate
            # tables+queues; one table with `kind` covers all of them and the
            # claim protocol (job_state.py analog) applies uniformly.
            """
            CREATE TABLE IF NOT EXISTS jobs (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                video_id INTEGER NOT NULL REFERENCES videos(id) ON DELETE CASCADE,
                kind TEXT NOT NULL DEFAULT 'transcode',
                priority INTEGER NOT NULL DEFAULT 0,
                payload TEXT NOT NULL DEFAULT '{}',
                claimed_by TEXT,
                claimed_at REAL,
                claim_expires_at REAL,
                started_at REAL,
                completed_at REAL,
                failed_at REAL,
                error TEXT,
                attempt INTEGER NOT NULL DEFAULT 0,
                max_attempts INTEGER NOT NULL DEFAULT 3,
                current_step TEXT,
                last_checkpoint TEXT NOT NULL DEFAULT '{}',
                progress REAL NOT NULL DEFAULT 0.0,
                required_accelerator TEXT,
                min_code_version TEXT,
                created_at REAL NOT NULL,
                updated_at REAL NOT NULL,
                UNIQUE (video_id, kind),
                CHECK (attempt >= 0),
                CHECK (progress >= 0.0 AND progress <= 100.0)
            )
            """,
            "CREATE INDEX IF NOT EXISTS idx_jobs_claim ON jobs(kind, completed_at, failed_at, claim_expires_at)",
            # -- per-quality checkpoint rows (reference: quality_progress) --
            """
            CREATE TABLE IF NOT EXISTS quality_progress (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                job_id INTEGER NOT NULL REFERENCES jobs(id) ON DELETE CASCADE,
                quality TEXT NOT NULL,
                status TEXT NOT NULL DEFAULT 'pending',
                progress REAL NOT NULL DEFAULT 0.0,
                updated_at REAL NOT NULL,
                UNIQUE (job_id, quality),
                CHECK (status IN ('pending','in_progress','completed','failed'))
            )
            """,
            # -- transcriptions ---------------------------------------------
            """
            CREATE TABLE IF NOT EXISTS transcriptions (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                video_id INTEGER NOT NULL UNIQUE REFERENCES videos(id) ON DELETE CASCADE,
                language TEXT,
                model TEXT,
                vtt_path TEXT,
                full_text TEXT,
                status TEXT NOT NULL DEFAULT 'pending',
                error TEXT,
                created_at REAL NOT NULL,
                completed_at REAL
            )
            """,
            # -- worker fleet -----------------------------------------------
            """
            CREATE TABLE IF NOT EXISTS workers (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                name TEXT NOT NULL UNIQUE,
                kind TEXT NOT NULL DEFAULT 'remote',
                accelerator TEXT NOT NULL DEFAULT 'cpu',
                capabilities TEXT NOT NULL DEFAULT '{}',
                code_version TEXT,
                last_heartbeat_at REAL,
                status TEXT NOT NULL DEFAULT 'active',
                created_at REAL NOT NULL
            )
            """,
            """
            CREATE TABLE IF NOT EXISTS worker_api_keys (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                worker_name TEXT NOT NULL,
                key_prefix TEXT NOT NULL,
                key_hash TEXT NOT NULL,
                hash_version INTEGER NOT NULL DEFAULT 2,
                created_at REAL NOT NULL,
                last_used_at REAL,
                revoked_at REAL
            )
            """,
            "CREATE INDEX IF NOT EXISTS idx_api_keys_prefix ON worker_api_keys(key_prefix)",
            # -- settings (reference: settings table, settings_service) -----
            """
            CREATE TABLE IF NOT EXISTS settings (
                key TEXT PRIMARY KEY,
                value TEXT,
                value_type TEXT NOT NULL DEFAULT 'str',
                updated_at REAL NOT NULL
            )
            """,
            # -- webhooks ---------------------------------------------------
            """
            CREATE TABLE IF NOT EXISTS webhooks (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                url TEXT NOT NULL,
                secret TEXT,
                events TEXT NOT NULL DEFAULT '[]',
                active INTEGER NOT NULL DEFAULT 1,
                created_at REAL NOT NULL
            )
            """,
            """
            CREATE TABLE IF NOT EXISTS webhook_deliveries (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                webhook_id INTEGER NOT NULL REFERENCES webhooks(id) ON DELETE CASCADE,
                event TEXT NOT NULL,
                payload TEXT NOT NULL,
                status TEXT NOT NULL DEFAULT 'pending',
                attempts INTEGER NOT NULL DEFAULT 0,
                next_attempt_at REAL,
                response_code INTEGER,
                created_at REAL NOT NULL,
                delivered_at REAL
            )
            """,
            "CREATE INDEX IF NOT EXISTS idx_deliveries_pending ON webhook_deliveries(status, next_attempt_at)",
            # -- playback analytics (reference: playback_sessions) ----------
            """
            CREATE TABLE IF NOT EXISTS playback_sessions (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                video_id INTEGER NOT NULL REFERENCES videos(id) ON DELETE CASCADE,
                session_token TEXT NOT NULL UNIQUE,
                started_at REAL NOT NULL,
                last_heartbeat_at REAL NOT NULL,
                ended_at REAL,
                watch_time_s REAL NOT NULL DEFAULT 0.0
            )
            """,
            "CREATE INDEX IF NOT EXISTS idx_sessions_video ON playback_sessions(video_id, started_at)",
        ],
    ),
    (
        2,
        [
            # -- chapters (reference: chapter_detection.py + admin chapters
            #    routes, admin.py:8057-8624) --------------------------------
            """
            CREATE TABLE IF NOT EXISTS chapters (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                video_id INTEGER NOT NULL REFERENCES videos(id) ON DELETE CASCADE,
                start_s REAL NOT NULL,
                title TEXT NOT NULL,
                source TEXT NOT NULL DEFAULT 'manual',
                created_at REAL NOT NULL,
                UNIQUE (video_id, start_s),
                CHECK (source IN ('manual','container','transcript'))
            )
            """,
            "CREATE INDEX IF NOT EXISTS idx_chapters_video ON chapters(video_id, start_s)",
        ],
    ),
    (
        3,
        [
            # -- worker command channel (reference: command_listener.py over
            #    Redis pub/sub; here the shared DB is the bus — workers poll
            #    with their heartbeat) --------------------------------------
            """
            CREATE TABLE IF NOT EXISTS worker_commands (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                worker_name TEXT NOT NULL,
                command TEXT NOT NULL,
                args TEXT NOT NULL DEFAULT '{}',
                created_at REAL NOT NULL,
                picked_up_at REAL,
                completed_at REAL,
                response TEXT
            )
            """,
            "CREATE INDEX IF NOT EXISTS idx_commands_pending ON worker_commands(worker_name, picked_up_at)",
        ],
    ),
    (
        4,
        [
            # -- playlists (reference: admin.py:7534-8056 + public
            #    playlist browsing, public.py:1636-1991) ----------------
            """
            CREATE TABLE IF NOT EXISTS playlists (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                slug TEXT NOT NULL UNIQUE,
                title TEXT NOT NULL,
                description TEXT NOT NULL DEFAULT '',
                visibility TEXT NOT NULL DEFAULT 'public',
                created_at REAL NOT NULL,
                updated_at REAL NOT NULL,
                CHECK (visibility IN ('public','unlisted','private'))
            )
            """,
            """
            CREATE TABLE IF NOT EXISTS playlist_items (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                playlist_id INTEGER NOT NULL
                    REFERENCES playlists(id) ON DELETE CASCADE,
                video_id INTEGER NOT NULL
                    REFERENCES videos(id) ON DELETE CASCADE,
                position INTEGER NOT NULL,
                added_at REAL NOT NULL,
                UNIQUE (playlist_id, video_id)
            )
            """,
            "CREATE INDEX IF NOT EXISTS idx_playlist_items ON playlist_items(playlist_id, position)",
            # -- custom metadata fields (reference: admin.py:6688-7533) --
            """
            CREATE TABLE IF NOT EXISTS custom_fields (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                name TEXT NOT NULL UNIQUE,
                label TEXT NOT NULL,
                field_type TEXT NOT NULL DEFAULT 'text',
                required INTEGER NOT NULL DEFAULT 0,
                options TEXT NOT NULL DEFAULT '[]',
                position INTEGER NOT NULL DEFAULT 0,
                created_at REAL NOT NULL,
                CHECK (field_type IN
                       ('text','number','boolean','select','date','url'))
            )
            """,
            """
            CREATE TABLE IF NOT EXISTS video_custom_values (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                video_id INTEGER NOT NULL
                    REFERENCES videos(id) ON DELETE CASCADE,
                field_id INTEGER NOT NULL
                    REFERENCES custom_fields(id) ON DELETE CASCADE,
                value TEXT,
                updated_at REAL NOT NULL,
                UNIQUE (video_id, field_id)
            )
            """,
            # -- cookie sessions for the admin UI (reference:
            #    admin.py:1088-1234 session auth + CSRF) ----------------
            """
            CREATE TABLE IF NOT EXISTS admin_sessions (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                token_hash TEXT NOT NULL UNIQUE,
                csrf_token TEXT NOT NULL,
                created_at REAL NOT NULL,
                expires_at REAL NOT NULL,
                last_used_at REAL
            )
            """,
        ],
    ),
    (
        5,
        [
            # -- failure plane (jobs/claims.py) ------------------------------
            # next_retry_at: jittered-exponential-backoff gate written by
            # fail_job; a job whose timestamp is in the future derives the
            # BACKOFF state and is skipped by SQL_CLAIMABLE, so a crashing
            # job can no longer burn its whole retry budget in seconds.
            "ALTER TABLE jobs ADD COLUMN next_retry_at REAL",
            "CREATE INDEX IF NOT EXISTS idx_jobs_next_retry"
            " ON jobs(next_retry_at)",
            # Per-attempt failure history with classification, written by
            # fail_job (transient/permanent/stalled), the expired-claim
            # sweep and daemon startup recovery (worker_crash). Surfaced in
            # the dead-letter admin view; rows outlive the retry loop so a
            # dead-lettered job carries its full post-mortem.
            """
            CREATE TABLE IF NOT EXISTS job_failures (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                job_id INTEGER NOT NULL REFERENCES jobs(id) ON DELETE CASCADE,
                attempt INTEGER NOT NULL,
                worker TEXT,
                error TEXT,
                failure_class TEXT NOT NULL DEFAULT 'transient',
                created_at REAL NOT NULL,
                CHECK (failure_class IN
                       ('transient','permanent','worker_crash','stalled'))
            )
            """,
            "CREATE INDEX IF NOT EXISTS idx_job_failures_job"
            " ON job_failures(job_id, id)",
        ],
    ),
    (
        6,
        [
            # -- trace plane (obs/) ------------------------------------------
            # One trace per job life: the root row (parent_id IS NULL,
            # name 'job') is minted at enqueue; claim/complete markers
            # (jobs/claims.py) and worker attempt/stage/rung spans
            # (worker daemon directly, remote workers via
            # POST /api/worker/jobs/{id}/spans) parent under it. Rows
            # are deleted with the other per-life tables on job
            # reset/requeue, so a fresh life gets a fresh trace.
            """
            CREATE TABLE IF NOT EXISTS job_spans (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                job_id INTEGER NOT NULL REFERENCES jobs(id) ON DELETE CASCADE,
                trace_id TEXT NOT NULL,
                span_id TEXT NOT NULL,
                parent_id TEXT,
                name TEXT NOT NULL,
                origin TEXT NOT NULL DEFAULT 'server',
                started_at REAL NOT NULL,
                duration_s REAL,
                status TEXT NOT NULL DEFAULT 'ok',
                attributes TEXT NOT NULL DEFAULT '{}',
                created_at REAL NOT NULL,
                UNIQUE (job_id, span_id),
                CHECK (origin IN ('server','worker')),
                CHECK (status IN ('ok','error'))
            )
            """,
            "CREATE INDEX IF NOT EXISTS idx_job_spans_job"
            " ON job_spans(job_id, started_at)",
            "CREATE INDEX IF NOT EXISTS idx_job_spans_trace"
            " ON job_spans(trace_id)",
            # exactly one root per job: concurrent ensure_root callers
            # (enqueue post-commit racing a fast claim) collapse onto
            # one row instead of forking the trace
            "CREATE UNIQUE INDEX IF NOT EXISTS idx_job_spans_root"
            " ON job_spans(job_id) WHERE parent_id IS NULL",
        ],
    ),
    (
        7,
        [
            # -- fault-domain isolation plane --------------------------------
            # device_fault joins the failure taxonomy (enums.FailureClass):
            # the accelerator — not the input — failed the attempt, the
            # attempt is refunded and the scheduler quarantines the slot's
            # devices. The CHECK constraint can't be altered in place on
            # sqlite, so the table rebuilds (portable on Postgres too:
            # RENAME + recreate + copy + drop). The copy deliberately does
            # NOT carry explicit ids: on Postgres the recreated BIGSERIAL
            # sequence starts at 1 and explicit-id rows would leave it
            # behind the data (the next insert would collide); re-keying
            # in ORDER BY id keeps both backends' sequences consistent and
            # preserves the only ordering anything reads (per-job history
            # is ORDER BY id; ids are never stored elsewhere).
            "ALTER TABLE job_failures RENAME TO job_failures_old",
            "DROP INDEX IF EXISTS idx_job_failures_job",
            """
            CREATE TABLE IF NOT EXISTS job_failures (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                job_id INTEGER NOT NULL REFERENCES jobs(id) ON DELETE CASCADE,
                attempt INTEGER NOT NULL,
                worker TEXT,
                error TEXT,
                failure_class TEXT NOT NULL DEFAULT 'transient',
                created_at REAL NOT NULL,
                CHECK (failure_class IN
                       ('transient','permanent','worker_crash','stalled',
                        'device_fault'))
            )
            """,
            "INSERT INTO job_failures (job_id, attempt, worker, error,"
            " failure_class, created_at)"
            " SELECT job_id, attempt, worker, error, failure_class,"
            " created_at FROM job_failures_old ORDER BY id",
            "DROP TABLE job_failures_old",
            "CREATE INDEX IF NOT EXISTS idx_job_failures_job"
            " ON job_failures(job_id, id)",
        ],
    ),
    (
        8,
        [
            # -- preemption-tolerant drain plane -----------------------------
            # preempted joins the failure taxonomy (enums.FailureClass):
            # the HOST was evicted (preemption notice / SIGTERM) and the
            # drain grace lapsed mid-attempt — refunded like device_fault,
            # no backoff, a successor resumes the uploaded partial tree.
            # Same rebuild ritual as migration 7 (CHECKs can't be altered
            # in place on sqlite; re-keying keeps Postgres sequences
            # ahead of the data).
            "ALTER TABLE job_failures RENAME TO job_failures_old",
            "DROP INDEX IF EXISTS idx_job_failures_job",
            """
            CREATE TABLE IF NOT EXISTS job_failures (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                job_id INTEGER NOT NULL REFERENCES jobs(id) ON DELETE CASCADE,
                attempt INTEGER NOT NULL,
                worker TEXT,
                error TEXT,
                failure_class TEXT NOT NULL DEFAULT 'transient',
                created_at REAL NOT NULL,
                CHECK (failure_class IN
                       ('transient','permanent','worker_crash','stalled',
                        'device_fault','preempted'))
            )
            """,
            "INSERT INTO job_failures (job_id, attempt, worker, error,"
            " failure_class, created_at)"
            " SELECT job_id, attempt, worker, error, failure_class,"
            " created_at FROM job_failures_old ORDER BY id",
            "DROP TABLE job_failures_old",
            "CREATE INDEX IF NOT EXISTS idx_job_failures_job"
            " ON job_failures(job_id, id)",
        ],
    ),
    (
        9,
        [
            # -- multi-tenant QoS plane --------------------------------------
            # Tenant identity on every job: admission control (jobs/qos.py)
            # caps per-tenant queue depth at enqueue, and the claim query
            # (jobs/claims.py) runs weighted deficit-round-robin ACROSS
            # tenants while preserving priority-then-FIFO WITHIN one.
            # Every pre-migration row (and any writer that never names a
            # tenant) lands in the 'default' tenant, so single-tenant
            # deployments keep the exact pre-QoS ordering.
            "ALTER TABLE jobs ADD COLUMN tenant TEXT NOT NULL"
            " DEFAULT 'default'",
            # Optional per-job deadline: jobs carrying one get a
            # deadline-aware boost in the fair-share order once the
            # tenant's deadline budget window opens. NULL = no deadline.
            "ALTER TABLE jobs ADD COLUMN deadline_at REAL",
            # tenant-scoped scans: admission counts, the fair-share
            # per-tenant ranking, the queue browser's tenant filter, and
            # the per-tenant /metrics gauges all GROUP/filter by tenant
            "CREATE INDEX IF NOT EXISTS idx_jobs_tenant"
            " ON jobs(tenant, completed_at, failed_at)",
        ],
    ),
]


async def create_all(db: Database) -> None:
    """Apply all pending migrations (idempotent)."""
    await db.execute(
        """
        CREATE TABLE IF NOT EXISTS schema_migrations (
            version INTEGER PRIMARY KEY,
            applied_at REAL NOT NULL
        )
        """
    )
    applied = {
        r["version"]
        for r in await db.fetch_all("SELECT version FROM schema_migrations")
    }
    for version, statements in MIGRATIONS:
        if version in applied:
            continue
        async with db.transaction() as tx:
            for stmt in statements:
                await tx.execute(stmt)
            await tx.execute(
                "INSERT INTO schema_migrations (version, applied_at) VALUES (:v, :t)",
                {"v": version, "t": now()},
            )
