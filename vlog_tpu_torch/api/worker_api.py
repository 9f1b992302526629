"""Worker coordination API (:9002) — the distributed control + data plane
(a copy of ``vlog_tpu/api/worker_api.py`` over the port's job plane).

Reference parity: api/worker_api.py:1106-3396. Endpoints map 1:1 onto the
claim protocol in vlog_tpu_torch.jobs.claims (register/heartbeat/claim/progress/
complete/fail), plus the bulk data plane remote workers need: source
download, path-addressed output upload with atomic publish and resume
status, health, and Prometheus metrics. A progress update extends the
claim lease; a lost claim surfaces as HTTP 409, which remote workers treat
as an abort signal (reference remote_transcoder.py:277-300).

The server does no device work (it verifies and finalizes what remote
workers upload), so unlike the port's workers it takes no ``device``.

Run it: ``python -m vlog_tpu_torch.api.worker_api``.
"""

from __future__ import annotations

import asyncio
import errno
import hashlib
import json
import logging
import random
import time
from pathlib import Path

from aiohttp import web

from vlog_tpu_torch import config
from vlog_tpu_torch.api import auth as authmod
from vlog_tpu_torch.db.core import Database, Row, now as db_now, open_database
from vlog_tpu_torch.db.retry import with_retries
from vlog_tpu_torch.enums import AcceleratorKind, FailureClass, JobKind
from vlog_tpu_torch.jobs import claims, qos, state as js, videos as vids
from vlog_tpu_torch.jobs.events import CH_JOBS, bus_for
from vlog_tpu_torch.jobs.finalize import finalize_transcode, finalize_transcription
from vlog_tpu_torch.obs import store as obs_store
from vlog_tpu_torch.obs.metrics import Metrics, runtime as obs_runtime
from vlog_tpu_torch.storage import integrity

log = logging.getLogger("vlog_tpu_torch.worker_api")

MAX_UPLOAD_PART = 8 * 1024**3         # one rendition file cap
_COPY_CHUNK = 1 << 20

# request-scoped keys
IDENTITY = web.AppKey("identity", authmod.WorkerIdentity)
DB = web.AppKey("db", Database)
VIDEO_DIR = web.AppKey("video_dir", Path)
METRICS = web.AppKey("metrics", object)
# optional async (event_name, payload) hook — wired to webhook delivery
EVENTS = web.AppKey("events", object)
# per-app coordination-plane state (parked waiters, sweeper, coalescer)
COORD = web.AppKey("coord", object)


class _HeartbeatCoalescer:
    """Write-behind heartbeat buffer for the worker API.

    At fleet scale every worker's heartbeat is one UPDATE on the shared
    DB every ``VLOG_HEARTBEAT_INTERVAL``; this folds them: non-drain
    heartbeats land in a per-worker dict (latest wins) and flush as ONE
    ``executemany`` per ``VLOG_HEARTBEAT_FLUSH_S`` window. Heartbeats
    are liveness hints with an offline threshold orders of magnitude
    above the flush window, so a window of staleness is invisible —
    but drain transitions write through synchronously (the caller skips
    ``offer``): a draining worker must stop receiving work NOW.
    Disabled (``offer`` refuses, callers write through) at flush 0.
    """

    def __init__(self, db: Database, flush_s: float):
        self._db = db
        self.flush_s = flush_s
        self._pending: dict[str, dict] = {}
        self._stop = asyncio.Event()
        self._task: asyncio.Task | None = None
        self.flushes = 0               # observability for tests/admin

    def offer(self, name: str, *, caps_json: str | None,
              code_version: str | None) -> bool:
        """Buffer one heartbeat; False means "write through yourself"."""
        if self.flush_s <= 0:
            return False
        self._pending[name] = {"t": db_now(), "n": name, "st": "active",
                               "c": caps_json, "v": code_version}
        return True

    async def flush(self) -> int:
        batch = list(self._pending.values())
        self._pending = {}
        if not batch:
            return 0
        try:
            await self._db.execute_many(
                """
                UPDATE workers SET last_heartbeat_at=:t, status=:st,
                       capabilities=COALESCE(:c, capabilities),
                       code_version=COALESCE(:v, code_version)
                WHERE name=:n
                """, batch)
        except Exception:
            # put the batch back (without clobbering anything newer) so
            # a DB brownout delays heartbeats instead of losing them
            for row in batch:
                self._pending.setdefault(row["n"], row)
            raise
        self.flushes += 1
        return len(batch)

    async def _run(self) -> None:
        while not self._stop.is_set():
            try:
                await asyncio.wait_for(self._stop.wait(), self.flush_s)
                return
            except asyncio.TimeoutError:
                pass
            try:
                await self.flush()
            except Exception:  # noqa: BLE001 — retried next window
                log.warning("heartbeat flush failed; retrying next window",
                            exc_info=True)

    def start(self) -> None:
        if self.flush_s > 0 and self._task is None:
            self._task = asyncio.create_task(self._run(),
                                             name="vlog-hb-coalescer")

    async def close(self) -> None:
        self._stop.set()
        if self._task is not None:
            await asyncio.gather(self._task, return_exceptions=True)
            self._task = None
        try:
            await self.flush()          # nothing buffered stays lost
        except Exception:  # noqa: BLE001 — shutdown best-effort
            log.warning("final heartbeat flush failed", exc_info=True)


class CoordState:
    """Per-app coordination-plane state: parked-waiter accounting for
    long-poll claims, the periodic lease sweeper, and the heartbeat
    coalescer. Wired through ``build_worker_app``'s startup/cleanup so
    embedders and tests get the lifecycle for free."""

    def __init__(self, db: Database):
        self.db = db
        self.waiters = 0               # parked long-poll claim handlers
        self.shed = 0                  # parks refused at CLAIM_MAX_WAITERS
        self.hb = _HeartbeatCoalescer(db, config.HEARTBEAT_FLUSH_S)
        self._stop = asyncio.Event()
        self._sweeper: asyncio.Task | None = None

    def start(self) -> None:
        self.hb.start()
        if config.SWEEP_INTERVAL_S > 0 and self._sweeper is None:
            self._sweeper = asyncio.create_task(
                claims.sweep_loop(self.db, self._stop),
                name="vlog-lease-sweep")

    async def close(self) -> None:
        self._stop.set()
        if self._sweeper is not None:
            await asyncio.gather(self._sweeper, return_exceptions=True)
            self._sweeper = None
        await self.hb.close()


def _json_error(status: int, message: str) -> web.Response:
    return web.json_response({"error": message}, status=status)


def _claim_epoch(request: web.Request) -> int | None:
    """The ``X-Claim-Epoch`` fencing token (the claim's attempt number).

    Every claim-gated write carries it so a partitioned worker whose
    lease was swept and re-claimed — even under the same worker name —
    gets 409 instead of corrupting the successor attempt's tree/trace
    (``jobs.state.guard_epoch``). Absent header = pre-fencing client,
    ownership guards only; garbage is a 400 client bug.
    """
    raw = request.headers.get("X-Claim-Epoch")
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError:
        raise web.HTTPBadRequest(
            text=json.dumps({"error": f"bad X-Claim-Epoch {raw!r}"}),
            content_type="application/json") from None


def _job_payload(row: Row) -> dict:
    # last_checkpoint is decoded opaquely: the wire shape is whatever the
    # job kind wrote (e.g. transcription's {"asr": {...}} resume state from
    # jobs.claims.update_progress), so remote workers resume byte-identically
    # without this API layer knowing any kind-specific schema.
    out = dict(row)
    out["payload"] = json.loads(out.get("payload") or "{}")
    out["last_checkpoint"] = json.loads(out.get("last_checkpoint") or "{}")
    return out


@web.middleware
async def auth_middleware(request: web.Request, handler):
    # scale-hint is exempt like /metrics: autoscalers are fleet infra,
    # not registered workers, and the payload is the same aggregate
    # queue-depth data /metrics already exports per tenant
    if request.path in ("/healthz", "/metrics", "/api/worker/register",
                        "/api/fleet/scale-hint", "/api/slo"):
        return await handler(request)
    hdr = request.headers.get("Authorization", "")
    if not hdr.startswith("Bearer "):
        return _json_error(401, "missing bearer API key")
    try:
        ident = await authmod.verify_key(request.app[DB], hdr[7:])
    except authmod.AuthError as exc:
        return _json_error(401, str(exc))
    request[IDENTITY] = ident
    return await handler(request)


@web.middleware
async def metrics_middleware(request: web.Request, handler):
    m = request.app[METRICS]
    status = 500                      # unhandled exception -> counted 500
    try:
        resp = await handler(request)
        status = resp.status
        return resp
    except web.HTTPException as exc:
        status = exc.status
        raise
    finally:
        m.http_requests.labels(request.method, _route_label(request),
                               str(status)).inc()


def _route_label(request: web.Request) -> str:
    # Unmatched requests collapse to ONE label: labeling http_requests
    # with the raw path would let any client mint unbounded metric
    # series (classic cardinality bomb) — and the raw path is useless
    # for dashboards anyway.
    info = request.match_info.route.resource
    return info.canonical if info is not None else "unmatched"


# --------------------------------------------------------------------------
# Handlers
# --------------------------------------------------------------------------

async def register(request: web.Request) -> web.Response:
    """Admin-secret-gated worker registration; mints the API key (shown
    once). Reference: worker_api.py:1106-1218."""
    if not authmod.check_admin_secret(request.headers.get("X-Admin-Secret"),
                                      config.ADMIN_SECRET):
        return _json_error(403, "bad admin secret")
    body = await request.json()
    name = (body.get("name") or "").strip()
    if not name or len(name) > 128:
        return _json_error(400, "worker name required")
    db = request.app[DB]
    t = db_now()
    await db.execute(
        """
        INSERT INTO workers (name, kind, accelerator, capabilities,
                             code_version, created_at)
        VALUES (:n, 'remote', :a, :c, :v, :t)
        ON CONFLICT (name) DO UPDATE SET accelerator=:a, capabilities=:c,
            code_version=:v, status='active'
        """,
        {"n": name, "a": body.get("accelerator", "cpu"),
         "c": json.dumps(body.get("capabilities") or {}),
         "v": body.get("code_version", config.CODE_VERSION), "t": t})
    key = await authmod.create_worker_key(db, name)
    return web.json_response({"worker": name, "api_key": key}, status=201)


async def heartbeat(request: web.Request) -> web.Response:
    body = await request.json() if request.can_read_body else {}
    db = request.app[DB]
    ident = request[IDENTITY]
    caps_json = (json.dumps(body["capabilities"])
                 if body.get("capabilities") else None)
    draining = bool(body.get("draining"))
    coord = request.app.get(COORD)
    # Write-behind coalescing for plain liveness beats; drain transitions
    # always write through — a draining worker must become visibly
    # non-claimable immediately, not a flush window later.
    if not draining and coord is not None and coord.hb.offer(
            ident.worker_name, caps_json=caps_json,
            code_version=body.get("code_version")):
        return web.json_response({"ok": True, "coalesced": True})
    await db.execute(
        """
        UPDATE workers SET last_heartbeat_at=:t, status=:st,
               capabilities=COALESCE(:c, capabilities),
               code_version=COALESCE(:v, code_version)
        WHERE name=:n
        """,
        {"t": db_now(), "n": ident.worker_name,
         # a draining worker is online-but-not-claimable: a distinct
         # fleet state the workers table / admin UI must show
         "st": "draining" if draining else "active",
         "c": caps_json,
         "v": body.get("code_version")})
    return web.json_response({"ok": True})


async def _parked_claim(request: web.Request, wait_s: float,
                        claim_once) -> list[Row]:
    """Park this claim request on the CH_JOBS wakeup channel until a job
    becomes claimable or the wait budget lapses.

    Bounded: past ``VLOG_CLAIM_MAX_WAITERS`` concurrent parks the
    request is shed to an immediate empty answer (the client falls back
    to its poll interval). Wakeups are advisory — a woken waiter re-runs
    the real claim query, and losing a claim race just parks it again —
    and a jittered re-check (``VLOG_CLAIM_RECHECK_S``) re-runs the query
    even with every notify lost, so a dead listener degrades dispatch
    latency to the re-check period, never to a hung request or a lost
    job."""
    coord = request.app.get(COORD)
    if coord is None:
        return []
    if coord.waiters >= config.CLAIM_MAX_WAITERS:
        coord.shed += 1
        return []
    bus = bus_for(request.app[DB])
    await bus.start()                  # idempotent; adopts this loop
    coord.waiters += 1
    sub = bus.subscribe(CH_JOBS)
    try:
        deadline = time.monotonic() + wait_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return []
            await sub.get(timeout=min(
                remaining, config.CLAIM_RECHECK_S * (0.5 + random.random())))
            rows = await claim_once()
            if rows:
                return rows
    finally:
        sub.close()
        coord.waiters -= 1


async def claim(request: web.Request) -> web.Response:
    body = await request.json() if request.can_read_body else {}
    kinds = tuple(JobKind(k) for k in body.get("kinds")
                  or [k.value for k in JobKind])
    accel = AcceleratorKind(body.get("accelerator", "cpu"))
    db = request.app[DB]
    worker = request[IDENTITY].worker_name
    code_version = body.get("code_version", config.CODE_VERSION)
    try:
        max_jobs = max(1, min(int(body.get("max_jobs") or 1),
                              config.CLAIM_BATCH_MAX))
        wait_s = min(float(body.get("wait_s") or 0.0), config.CLAIM_WAIT_MAX_S)
    except (TypeError, ValueError):
        return _json_error(400, "bad max_jobs/wait_s")
    batched = "max_jobs" in body       # response shape follows the ask

    # the claim transaction is the fleet's contention point: on Postgres
    # two claimants can deadlock on row-lock order (resolved by killing
    # one), on sqlite a busy writer surfaces as "database is locked" —
    # both are retry-then-succeed, and claim_jobs re-reads its inputs
    async def claim_once() -> list[Row]:
        return await with_retries(
            lambda: claims.claim_jobs(
                db, worker, kinds=kinds, accelerator=accel,
                code_version=code_version, max_jobs=max_jobs),
            label="claim")

    rows = await claim_once()
    if not rows and wait_s > 0:
        rows = await _parked_claim(request, wait_s, claim_once)
    if not rows:
        return web.Response(status=204)
    entries = []
    for row in rows:
        request.app[METRICS].jobs_claimed.labels(row["kind"]).inc()
        video = await vids.get_video(db, row["video_id"])
        # hand the worker the trace to join: its spans (shipped back via
        # POST .../spans) parent under the job's root span. claim_jobs
        # stashed the context on the row when it wrote the claim markers;
        # re-derive only if that write failed. Best effort: the claim is
        # already committed — a failing trace read must not turn this
        # response into a 500 (the worker would re-claim a second job
        # while this one idles to lease expiry).
        trace_ctx = row.pop("_trace", None)
        if trace_ctx is None and config.TRACE_ENABLED:
            try:
                trace_id, root, _ = await obs_store.ensure_root(
                    db, row["id"], created_at=row["created_at"])
                trace_ctx = {"trace_id": trace_id, "parent_span_id": root}
            except Exception:  # noqa: BLE001 — telemetry never fails claims
                log.warning("trace context for job %s unavailable",
                            row["id"], exc_info=True)
        entries.append({
            "job": _job_payload(row),
            "video": {k: video[k] for k in
                      ("id", "slug", "title", "duration_s", "width",
                       "height")}
            if video else None,
            "trace": trace_ctx,
        })
    if not batched:
        # legacy single-claim shape for clients that never asked for a
        # batch (pre-batch workers keep working against a new server)
        return web.json_response(entries[0])
    return web.json_response({"jobs": entries})


async def progress(request: web.Request) -> web.Response:
    body = await request.json()
    db = request.app[DB]
    job_id = int(request.match_info["job_id"])
    try:
        row = await with_retries(
            lambda: claims.update_progress(
                db, job_id, request[IDENTITY].worker_name,
                progress=body.get("progress"),
                current_step=body.get("current_step"),
                checkpoint=body.get("checkpoint"),
                epoch=_claim_epoch(request)),
            label="progress")
    except js.JobStateError as exc:
        return _json_error(409, str(exc))
    for quality, qp in (body.get("qualities") or {}).items():
        await claims.upsert_quality_progress(
            db, job_id, quality, status=qp.get("status", "in_progress"),
            progress=float(qp.get("progress", 0.0)))
    return web.json_response({
        "ok": True, "claim_expires_at": row["claim_expires_at"]})


async def complete(request: web.Request) -> web.Response:
    import time as _time

    t_req, t0 = db_now(), _time.monotonic()
    body = await request.json()
    db = request.app[DB]
    job_id = int(request.match_info["job_id"])
    worker = request[IDENTITY].worker_name
    job = await db.fetch_one("SELECT * FROM jobs WHERE id=:id", {"id": job_id})
    if job is None:
        return _json_error(404, "no such job")
    # Ownership + epoch gate BEFORE any finalize side effect: a worker
    # whose lease lapsed (and whose job was reclaimed) must not overwrite
    # the current owner's published state — it gets the 409 abort signal
    # up front.
    epoch = _claim_epoch(request)
    try:
        js.guard_epoch(job, epoch)
        js.guard_complete(job, worker, now=db_now())
    except js.JobStateError as exc:
        return _json_error(409, str(exc))
    video = await vids.get_video(db, job["video_id"])
    if video is None:
        return _json_error(404, "video row vanished")
    kind = JobKind(job["kind"])
    result = body.get("result") or {}
    events: list[tuple[str, dict]] = []
    # Worker-supplied result paths get the same sanitization as uploads.
    thumb = result.get("thumbnail")
    vtt = result.get("vtt")
    if (thumb and _safe_relpath(thumb) is None) or \
            (vtt and _safe_relpath(vtt) is None):
        return _json_error(400, "bad result path")
    out_dir = request.app[VIDEO_DIR] / video["slug"]
    if kind in (JobKind.TRANSCODE, JobKind.REENCODE):
        # Manifest verification FIRST (existence + size + sha256 of every
        # file the worker claims to have published): structural playlist
        # validation can only prove the playlists parse, not that the
        # segments they reference carry the bytes the worker encoded. A
        # tree uploaded before the integrity plane has no manifest and
        # skips this gate; a present-but-corrupt manifest fails it.
        try:
            manifest = await asyncio.to_thread(
                integrity.load_manifest, out_dir)
            # use_cache: every file arrived through upload() above, which
            # hashed the received bytes and seeded the digest cache — a
            # full sequential re-read of a multi-GB tree here would run
            # inside the claim lease with no progress posts extending it.
            problems = ([] if manifest is None else await asyncio.to_thread(
                lambda: integrity.verify_tree(out_dir, manifest,
                                              use_cache=True)))
        except integrity.ManifestError as exc:
            problems = [str(exc)]
        if problems:
            request.app[METRICS].manifest_rejects.inc()
            log.warning("job %s rejected by manifest verification: %s",
                        job_id, "; ".join(problems[:10]))
            # 422 like the per-file digest gate: the worker's bytes did
            # not survive the wire — retryable, not a client bug (400).
            return _json_error(
                422, "uploaded tree failed manifest verification: "
                     + "; ".join(problems[:5]))
    if kind is JobKind.TRANSCODE:
        # server-side verification pass (reference transcoder.py:2565)
        from vlog_tpu_torch.media import hls

        try:
            hls.validate_master_playlist(out_dir / "master.m3u8")
        except (hls.PlaylistValidationError, OSError) as exc:
            return _json_error(400, f"uploaded tree failed validation: {exc}")
    try:
        # Terminal-state transition FIRST: complete_job atomically re-checks
        # ownership AND the epoch inside its transaction, so a stale worker
        # that lost the claim gets its 409 before any published state
        # changes.
        await with_retries(
            lambda: claims.complete_job(db, job_id, worker, epoch=epoch),
            label="complete")
        if kind in (JobKind.TRANSCODE, JobKind.REENCODE):
            reenc = kind is JobKind.REENCODE
            qualities = [
                {**q, "playlist_path":
                 str(out_dir / q["quality"] / "playlist.m3u8")}
                for q in result.get("qualities") or []
            ]
            await finalize_transcode(
                db, job, video, probe=result.get("probe") or {},
                qualities=qualities,
                thumbnail_path=str(out_dir / thumb) if thumb else None,
                streaming_format=result.get("streaming_format")
                if reenc else None,
                codec=result.get("codec") if reenc else None,
                enqueue_downstream=not reenc)
            events.append(("video.reencoded" if reenc else "video.ready", {
                "video_id": video["id"], "slug": video["slug"],
                "qualities": [q["quality"] for q in qualities]}))
        elif kind is JobKind.TRANSCRIPTION:
            await finalize_transcription(
                db, video["id"], language=result.get("language"),
                model=result.get("model"),
                vtt_path=str(out_dir / vtt) if vtt else None,
                text=result.get("text"))
            events.append(("video.transcribed", {
                "video_id": video["id"], "slug": video["slug"],
                "language": result.get("language")}))
        elif kind is JobKind.SPRITE:
            events.append(("video.sprites_ready", {
                "video_id": video["id"], "slug": video["slug"]}))
    except js.JobStateError as exc:
        return _json_error(409, str(exc))
    request.app[METRICS].jobs_completed.labels(job["kind"]).inc()
    emit = request.app.get(EVENTS)
    if emit is not None:
        for name, payload in events:
            try:
                await emit(name, payload)
            except Exception:
                log.exception("event hook failed for %s", name)
    if config.TRACE_ENABLED:
        # the HTTP-plane view of completion: manifest verification +
        # playlist validation + finalize, measured end to end. Parents
        # under the worker's span when the request carried trace
        # headers, else directly under the job root. Best effort: the
        # completion is committed — a failing span write must not 500
        # this response (the worker's retry would land 409 and report
        # a successful job as lost).
        try:
            trace_id, root, _ = await obs_store.ensure_root(
                db, job_id, created_at=job["created_at"])
            await obs_store.record(
                db, job_id, trace_id=trace_id,
                parent_id=request.get("parent_span_id") or root,
                name="server.complete", started_at=t_req,
                duration_s=_time.monotonic() - t0,
                attrs={"worker": worker, "kind": job["kind"],
                       "request_id": request.get("request_id")})
        except Exception:  # noqa: BLE001 — telemetry must not fail
            # completions
            log.warning("server.complete span for job %s dropped", job_id,
                        exc_info=True)
    return web.json_response({"ok": True})


async def fail(request: web.Request) -> web.Response:
    body = await request.json()
    db = request.app[DB]
    job_id = int(request.match_info["job_id"])
    fc_raw = body.get("failure_class")
    try:
        # only absent/null means "use the default" — an empty string is
        # a caller bug and gets the same 400 as any other unknown class
        fc = FailureClass(fc_raw) if fc_raw is not None else None
    except ValueError:
        return _json_error(400, f"unknown failure_class {fc_raw!r}")
    try:
        row = await with_retries(
            lambda: claims.fail_job(
                db, job_id, request[IDENTITY].worker_name,
                str(body.get("error") or "unspecified"),
                permanent=bool(body.get("permanent")),
                failure_class=fc, epoch=_claim_epoch(request)),
            label="fail")
    except js.JobStateError as exc:
        return _json_error(409, str(exc))
    terminal = row["failed_at"] is not None
    if terminal and JobKind(row["kind"]) is JobKind.TRANSCODE:
        from vlog_tpu_torch.enums import VideoStatus

        await vids.set_status(db, row["video_id"], VideoStatus.FAILED,
                              error=str(body.get("error") or "")[:500])
    request.app[METRICS].jobs_failed.labels(row["kind"]).inc()
    return web.json_response({"ok": True, "terminal": terminal})


async def release(request: web.Request) -> web.Response:
    """Graceful worker shutdown hands the claim back (daemon parity)."""
    db = request.app[DB]
    job_id = int(request.match_info["job_id"])
    try:
        await claims.release_job(db, job_id, request[IDENTITY].worker_name,
                                 epoch=_claim_epoch(request))
    except js.JobStateError as exc:
        return _json_error(409, str(exc))
    return web.json_response({"ok": True})


async def download_source(request: web.Request) -> web.StreamResponse:
    """Bulk source download (reference worker_api.py:2193).

    Gated to the claim holder: a worker may read exactly the sources of
    videos whose jobs it is actively leasing — an API key must not be a
    skeleton key to the whole library."""
    db = request.app[DB]
    ident = request[IDENTITY]
    video_id = int(request.match_info["video_id"])
    # Same ownership predicate as upload/complete (SQL_ACTIVELY_CLAIMED):
    # the previous hand-rolled SQL admitted failed-but-claimed jobs and
    # rejected NULL-expiry claims, drifting from every other gate.
    if not await _worker_holds_claim(db, ident.worker_name, video_id):
        return _json_error(403, "no active claim on this video")
    video = await vids.get_video(db, video_id)
    if video is None or not video["source_path"]:
        return _json_error(404, "no source")
    path = Path(video["source_path"])
    if not path.exists():
        return _json_error(410, "source file gone")
    return web.FileResponse(path, headers={
        "X-Source-Name": path.name,
        "Content-Disposition": f'attachment; filename="{path.name}"'})


async def download_output(request: web.Request) -> web.StreamResponse:
    """Partial-output download for cross-worker resume.

    A successor claiming a preempted job prefetches the predecessor's
    uploaded, digest-verified segments (plus the rate-control journal)
    so the ladder continues instead of restarting. Gated exactly like
    the source download: only the active claim holder may read, and the
    path gets the upload-side sanitization."""
    db = request.app[DB]
    ident = request[IDENTITY]
    video_id = int(request.match_info["video_id"])
    if not await _worker_holds_claim(db, ident.worker_name, video_id):
        return _json_error(403, "no active claim on this video")
    video = await vids.get_video(db, video_id)
    if video is None:
        return _json_error(404, "no such video")
    rel = _safe_relpath(request.match_info["tail"])
    if rel is None:
        return _json_error(400, "bad output path")
    path = request.app[VIDEO_DIR] / video["slug"] / rel
    if not path.is_file():
        return _json_error(404, "no such output file")
    return web.FileResponse(path)


def _safe_relpath(tail: str) -> Path | None:
    """Reject traversal/absolute paths in upload targets (tar-bomb parity,
    reference remote_transcoder.py:149-221)."""
    p = Path(tail)
    if p.is_absolute() or not tail or len(tail) > 512:
        return None
    parts = p.parts
    if any(part in ("..", "") or part.startswith("/") for part in parts):
        return None
    if len(parts) > 4:
        return None
    return p


async def _active_claim_row(db: Database, worker: str,
                            video_id: int) -> Row | None:
    """The job row backing the worker's active claim on this video (or
    None) — the row the upload path fences its epoch check against."""
    return await db.fetch_one(
        f"""
        SELECT * FROM jobs WHERE video_id=:v AND claimed_by=:w
          AND {js.SQL_ACTIVELY_CLAIMED}
        ORDER BY claimed_at DESC LIMIT 1
        """,
        {"v": video_id, "w": worker, "now": db_now()})


async def _worker_holds_claim(db: Database, worker: str, video_id: int) -> bool:
    return await _active_claim_row(db, worker, video_id) is not None


async def upload(request: web.Request) -> web.Response:
    """Streaming path-addressed output upload with atomic publish.

    PUT /api/worker/upload/{video_id}/{tail}. The uploader must hold an
    active claim on the video (reference segment upload,
    worker_api.py:2492-2933). Integrity: the server hashes the received
    bytes and compares against the caller's ``X-Content-SHA256`` — a
    mismatch discards the ``.part`` and answers 422 (the client retries
    it as transient), so a corrupting hop can never publish. Admission:
    507 under disk pressure, before a byte is written.
    """
    db = request.app[DB]
    video_id = int(request.match_info["video_id"])
    worker = request[IDENTITY].worker_name
    video = await vids.get_video(db, video_id)
    if video is None:
        return _json_error(404, "no such video")
    claim_row = await _active_claim_row(db, worker, video_id)
    if claim_row is None:
        return _json_error(409, "no active claim on this video")
    try:
        # epoch fence BEFORE a byte lands: a swept-and-reclaimed job's
        # previous incarnation must not overwrite the successor's tree
        js.guard_epoch(claim_row, _claim_epoch(request))
    except js.JobStateError as exc:
        return _json_error(409, str(exc))
    rel = _safe_relpath(request.match_info["tail"])
    if rel is None:
        return _json_error(400, "bad upload path")
    if integrity.under_pressure(request.app[VIDEO_DIR]):
        request.app[METRICS].upload_disk_rejected.inc()
        return _json_error(507, "insufficient free disk space")
    claimed_digest = (request.headers.get("X-Content-SHA256") or "") \
        .strip().lower()
    dest = request.app[VIDEO_DIR] / video["slug"] / rel
    try:
        dest.parent.mkdir(parents=True, exist_ok=True)
    except OSError:
        # A tail component collides with an existing FILE ("a" uploaded,
        # then "a/b") — a caller-path problem, not a server fault.
        return _json_error(400, "bad upload path")
    tmp = dest.with_name(dest.name + ".part")
    size = 0
    hasher = hashlib.sha256()
    try:
        try:
            # File ops hop to threads: a synchronous write on a slow or
            # saturated volume would stall every other request on this
            # event loop — heartbeats, claims, playback — for its
            # duration (asyncblock lint).
            fp = await asyncio.to_thread(open, tmp, "wb")
            try:
                async for chunk in request.content.iter_chunked(_COPY_CHUNK):
                    size += len(chunk)
                    if size > MAX_UPLOAD_PART:
                        raise web.HTTPRequestEntityTooLarge(
                            max_size=MAX_UPLOAD_PART, actual_size=size)
                    hasher.update(chunk)
                    await asyncio.to_thread(fp.write, chunk)
            finally:
                await asyncio.to_thread(fp.close)
        except OSError as exc:
            tmp.unlink(missing_ok=True)
            if exc.errno in (errno.ENOSPC, getattr(errno, "EDQUOT", -1)):
                # The volume filled between the admission check and the
                # write — same retryable verdict the check would give.
                request.app[METRICS].upload_disk_rejected.inc()
                return _json_error(507, "insufficient free disk space")
            if exc.errno in (errno.ENAMETOOLONG, errno.ENOTDIR,
                             errno.EISDIR):
                return _json_error(400, "bad upload path")
            raise   # EIO and friends: a real server fault, count as 500
        digest = hasher.hexdigest()
        if claimed_digest and digest != claimed_digest:
            request.app[METRICS].upload_digest_mismatch.inc()
            tmp.unlink(missing_ok=True)
            log.warning("upload %s/%s digest mismatch: got %s, claimed %s",
                        video["slug"], rel, digest[:12], claimed_digest[:12])
            return _json_error(
                422, f"content digest mismatch: received {digest}, "
                     f"caller claimed {claimed_digest}")
        try:
            # metadata op, but it follows a multi-GB write the volume
            # may still be flushing — off the loop with the rest
            await asyncio.to_thread(tmp.rename, dest)
        except OSError:
            # rename onto an existing directory — the bad-path family,
            # like the mkdir collision above.
            tmp.unlink(missing_ok=True)
            return _json_error(400, "bad upload path")
        # seed the inventory digest cache with the digest this request
        # just computed — upload_status then stats instead of re-hashing
        integrity.note_digest(dest, digest)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    request.app[METRICS].bytes_uploaded.inc(size)
    return web.json_response({"ok": True, "path": str(rel), "bytes": size,
                              "sha256": digest})


async def upload_status(request: web.Request) -> web.Response:
    """Uploaded-file inventory for resume (reference get_segments_status,
    http_client.py:1065). Entries carry size AND sha256 so resume can
    re-upload a corrupt same-size partial instead of skipping it — size
    equality alone cannot distinguish a clean file from a bit-flipped
    one."""
    db = request.app[DB]
    video = await vids.get_video(db, int(request.match_info["video_id"]))
    if video is None:
        return _json_error(404, "no such video")
    root = request.app[VIDEO_DIR] / video["slug"]
    # build_manifest IS the inventory semantics (temps excluded, the
    # manifest itself excluded — resume rewrites it on drain anyway).
    # use_cache: files uploaded through this API were hashed in the
    # request path and noted, so steady state is a stat-only walk.
    files = await asyncio.to_thread(
        lambda: integrity.build_manifest(root, use_cache=True))
    return web.json_response({"files": files})


_SPAN_ID_MAX = 64


def _clean_span(raw: dict) -> dict | None:
    """Validate one worker-reported span; None rejects it silently
    (a malformed span must not fail the whole report — the rest of the
    trace is still valuable)."""
    import math

    if not isinstance(raw, dict):
        return None
    name = str(raw.get("name") or "")[:obs_store.MAX_NAME_LEN]
    try:
        started = float(raw.get("started_at"))
    except (TypeError, ValueError):
        return None
    if not math.isfinite(started):
        # json.loads admits bare Infinity/NaN — one such value would
        # poison histogram sums and break the waterfall's time axis
        return None
    dur = raw.get("duration_s")
    try:
        dur = None if dur is None else max(0.0, float(dur))
    except (TypeError, ValueError):
        dur = None
    if dur is not None and not math.isfinite(dur):
        dur = None
    span_id = str(raw.get("span_id") or "")[:_SPAN_ID_MAX]
    parent_id = raw.get("parent_id")
    parent_id = (str(parent_id)[:_SPAN_ID_MAX] if parent_id else None)
    attrs = raw.get("attrs")
    if not name or not span_id or not isinstance(attrs, (dict, type(None))):
        return None
    return {"name": name, "started_at": started, "duration_s": dur,
            "span_id": span_id, "parent_id": parent_id,
            "status": "error" if raw.get("status") == "error" else "ok",
            "attrs": attrs or {}}


async def post_spans(request: web.Request) -> web.Response:
    """Worker-reported spans for a claimed job (the remote workers'
    half of the trace; local daemons write job_spans directly).

    Claim-gated like progress: only the current claim holder may attach
    spans, and the server overrides the trace id with the job's own —
    a confused worker cannot graft spans onto another trace. Stage
    spans feed the server's stage-duration histograms, so the server
    ``/metrics`` sees fleet-wide stage timings without a second scrape
    hop to every worker.
    """
    db = request.app[DB]
    job_id = int(request.match_info["job_id"])
    job = await db.fetch_one("SELECT * FROM jobs WHERE id=:id",
                             {"id": job_id})
    if job is None:
        return _json_error(404, "no such job")
    try:
        js.guard_epoch(job, _claim_epoch(request))
        js.guard_progress(job, request[IDENTITY].worker_name, now=db_now())
    except js.JobStateError as exc:
        return _json_error(409, str(exc))
    body = await request.json()
    raw_spans = body.get("spans")
    if not isinstance(raw_spans, list):
        return _json_error(400, "spans must be a list")
    spans = [s for s in map(_clean_span,
                            raw_spans[:obs_store.MAX_SPANS_PER_REPORT])
             if s is not None]
    if not config.TRACE_ENABLED or not spans:
        # With tracing off there is no stored-span dedupe, so a retried
        # report could double-observe histograms — skip ingestion whole.
        # Only the server's vlog_fleet_* view dims: each worker's own
        # vlog_stage_*/vlog_rung_* histograms (health-port /metrics) are
        # observed locally and never depend on span shipping.
        return web.json_response({"ok": True, "stored": 0})
    from vlog_tpu_torch.obs.trace import STAGE_KEYS, Span

    trace_id, _root, _ = await obs_store.ensure_root(
        db, job_id, created_at=job["created_at"])
    inserted = await obs_store.record_spans(
        db, job_id, [Span(trace_id=trace_id, **sp) for sp in spans],
        origin="worker", trace_id=trace_id)
    fresh = set(inserted)
    # Histograms: only genuinely-new spans (a retried report whose first
    # response was lost must not double-observe), and labels come from
    # CLOSED sets, never worker-chosen names — a hostile/buggy claim
    # holder embedding per-job ids in span names must not mint unbounded
    # series in the process registry (same cardinality rule as
    # _route_label).
    stage_ok = {k[:-2] for k in STAGE_KEYS}
    rung_ok = set(config.LADDER_BY_NAME)
    m = obs_runtime()
    for sp in spans:
        if sp["duration_s"] is None or sp["span_id"] not in fresh:
            continue
        fresh.discard(sp["span_id"])   # same id twice in one report
        if sp["name"].startswith("stage.") and sp["name"][6:] in stage_ok:
            m.fleet_stage_seconds.labels(
                sp["name"][6:]).observe(sp["duration_s"])
        elif sp["name"].startswith("rung.") and sp["name"][5:] in rung_ok:
            m.fleet_rung_seconds.labels(
                sp["name"][5:]).observe(sp["duration_s"])
    return web.json_response({"ok": True, "stored": len(inserted)})


async def poll_commands(request: web.Request) -> web.Response:
    """Remote workers pick up their management commands with the same
    cadence local daemons do (reference command_listener over pub/sub)."""
    from vlog_tpu_torch.jobs import commands as cmds

    rows = await cmds.claim_pending(request.app[DB],
                                    request[IDENTITY].worker_name)
    return web.json_response({"commands": [
        {"id": r["id"], "command": r["command"], "args": r["args"]}
        for r in rows]})


async def respond_command(request: web.Request) -> web.Response:
    from vlog_tpu_torch.jobs import commands as cmds

    db = request.app[DB]
    cmd_id = int(request.match_info["command_id"])
    row = await cmds.get_command(db, cmd_id)
    if row is None or row["worker_name"] != request[IDENTITY].worker_name:
        return _json_error(404, "no such command")
    body = await request.json()
    await cmds.respond(db, cmd_id, body.get("response") or {})
    return web.json_response({"ok": True})


async def healthz(request: web.Request) -> web.Response:
    return web.json_response({"ok": True, "db": request.app[DB].connected})


async def metrics_endpoint(request: web.Request) -> web.Response:
    text = await request.app[METRICS].render(request.app[DB])
    return web.Response(text=text, content_type="text/plain")


async def list_workers(request: web.Request) -> web.Response:
    db = request.app[DB]
    rows = await db.fetch_all("SELECT * FROM workers ORDER BY name")
    cut = db_now() - config.WORKER_OFFLINE_THRESHOLD_S
    for r in rows:
        r["online"] = bool(r["last_heartbeat_at"]
                           and r["last_heartbeat_at"] > cut)
        r["capabilities"] = json.loads(r["capabilities"] or "{}")
    return web.json_response({"workers": rows})


async def scale_hint(request: web.Request) -> web.Response:
    """Autoscale signal: per-tenant queue state + suggested worker delta.

    One call into :func:`vlog_tpu_torch.jobs.qos.fleet_snapshot` — the same
    helper the worker ``stats`` command renders, so an autoscaler
    polling this endpoint and an operator reading the CLI see the same
    numbers.
    """
    return web.json_response(await qos.fleet_snapshot(request.app[DB]))


async def slo_report(request: web.Request) -> web.Response:
    """Live SLO burn-rate report (obs/slo.py) — same body the admin API
    serves, exposed here so autoscalers polling scale-hint can read the
    burn rates behind it from the same port."""
    from vlog_tpu_torch.obs import slo as slomod

    return web.json_response(
        await slomod.plane().evaluate(request.app[DB]))


# --------------------------------------------------------------------------
# App assembly
# --------------------------------------------------------------------------

def build_worker_app(db: Database, video_dir: Path | None = None) -> web.Application:
    from vlog_tpu_torch.api.errors import request_id_middleware

    app = web.Application(middlewares=[request_id_middleware,
                                       metrics_middleware, auth_middleware],
                          client_max_size=MAX_UPLOAD_PART)
    app[DB] = db
    app[VIDEO_DIR] = Path(video_dir or config.VIDEO_DIR)
    app[METRICS] = Metrics()
    app[COORD] = CoordState(db)

    async def _coord_startup(app: web.Application) -> None:
        app[COORD].start()

    async def _coord_cleanup(app: web.Application) -> None:
        await app[COORD].close()

    app.on_startup.append(_coord_startup)
    app.on_cleanup.append(_coord_cleanup)
    app.router.add_post("/api/worker/register", register)
    app.router.add_post("/api/worker/heartbeat", heartbeat)
    app.router.add_post("/api/worker/claim", claim)
    app.router.add_post("/api/worker/jobs/{job_id:\\d+}/progress", progress)
    app.router.add_post("/api/worker/jobs/{job_id:\\d+}/complete", complete)
    app.router.add_post("/api/worker/jobs/{job_id:\\d+}/fail", fail)
    app.router.add_post("/api/worker/jobs/{job_id:\\d+}/release", release)
    app.router.add_post("/api/worker/jobs/{job_id:\\d+}/spans", post_spans)
    app.router.add_get("/api/worker/source/{video_id:\\d+}", download_source)
    app.router.add_get("/api/worker/output/{video_id:\\d+}/{tail:.+}",
                       download_output)
    app.router.add_put("/api/worker/upload/{video_id:\\d+}/{tail:.+}", upload)
    app.router.add_get("/api/worker/upload/{video_id:\\d+}/status",
                       upload_status)
    app.router.add_get("/api/worker/workers", list_workers)
    app.router.add_get("/api/fleet/scale-hint", scale_hint)
    app.router.add_get("/api/slo", slo_report)
    app.router.add_get("/api/worker/commands", poll_commands)
    app.router.add_post("/api/worker/commands/{command_id:\\d+}/response",
                        respond_command)
    app.router.add_get("/healthz", healthz)
    app.router.add_get("/metrics", metrics_endpoint)
    return app


async def serve(port: int | None = None, db_url: str | None = None,
                host: str | None = None) -> None:
    from vlog_tpu_torch.db.schema import create_all

    config.ensure_dirs()
    db = open_database(db_url or config.DATABASE_URL)
    await db.connect()
    await create_all(db)
    from vlog_tpu_torch.jobs.webhooks import make_event_hook

    app = build_worker_app(db)
    app[EVENTS] = make_event_hook(db)
    if host is None:
        host = "0.0.0.0" if config.ADMIN_SECRET else "127.0.0.1"
    if not config.ADMIN_SECRET and host not in ("127.0.0.1", "::1",
                                                "localhost"):
        # Open registration mints keys that can read sources and publish
        # renditions — never expose it beyond loopback without a secret.
        raise SystemExit(
            "refusing to bind worker API to a non-loopback address with no "
            "VLOG_ADMIN_SECRET set (registration would be open)")
    if not config.ADMIN_SECRET:
        log.warning("VLOG_ADMIN_SECRET unset: dev mode, loopback only")
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, host, port or config.WORKER_API_PORT)
    await site.start()
    log.info("worker API listening on %s:%d", host,
             port or config.WORKER_API_PORT)
    try:
        await asyncio.Event().wait()
    finally:
        await runner.cleanup()
        await db.disconnect()


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    asyncio.run(serve())


if __name__ == "__main__":
    main()
