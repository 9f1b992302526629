"""Admin API (:9001): upload, video management, live progress, settings,
webhooks (a copy of ``vlog_tpu/api/admin_api.py`` over the port's job
plane, storage, delivery and observability planes; the same route table,
with ``api/catalog.py`` mounted as there).

Reference parity: api/admin.py (9.7k LoC — the long tail of management
routes). This service covers the load-bearing surface: size-capped upload
that probes and enqueues (admin.py:1706-1890 + create_or_reset 719-832),
video list/detail/retranscode/soft-delete, job + quality progress
introspection, Server-Sent-Events live progress (admin.py:5291 — DB-poll
fan-out here instead of Redis pub/sub, since sqlite is the shared truth),
settings CRUD backed by the SettingsService, webhook CRUD, workers list,
and Prometheus metrics. Auth: X-Admin-Secret on every mutating route.

The one device step is the catalog's thumbnail grab
(``POST /api/videos/{id}/thumbnail/from-time``), which resizes through
the port's ``TorchBackend`` on the app's ``device`` (default ``"cuda"``,
so the fused resize kernel); every other route runs on the host, so an
admin host without a card keeps serving them.

Run it: ``python -m vlog_tpu_torch.api.admin_api``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
import uuid
from pathlib import Path

from aiohttp import web

from vlog_tpu_torch import config
from vlog_tpu_torch.codecs import validate_codec_format
from vlog_tpu_torch.api import auth as authmod
from vlog_tpu_torch.api.settings import SettingsService, SettingsError
from vlog_tpu_torch.db.core import Database, now as db_now, open_database
from vlog_tpu_torch.enums import JobKind, VideoStatus
from vlog_tpu_torch.jobs import alerts as alertsmod, claims, qos, state as js, videos as vids
from vlog_tpu_torch.media.probe import ProbeError, get_video_info

log = logging.getLogger("vlog_tpu_torch.admin_api")

DB = web.AppKey("db", Database)
UPLOAD_DIR = web.AppKey("upload_dir", Path)
VIDEO_DIR = web.AppKey("video_dir", Path)
SETTINGS = web.AppKey("settings", SettingsService)

_COPY_CHUNK = 1 << 20


def _json_error(status: int, message: str) -> web.Response:
    return web.json_response({"error": message}, status=status)


def _admission_429(exc: qos.AdmissionError) -> web.Response:
    """Per-tenant admission refusal: 429 + Retry-After, never a drop."""
    return web.json_response(
        {"error": str(exc), "tenant": exc.tenant,
         "retry_after_s": exc.retry_after_s},
        status=429,
        headers={"Retry-After": str(max(1, round(exc.retry_after_s)))})


def _qnum(query, name: str, default, *, lo=None, hi=None, cast=int):
    """Parse a numeric query param; malformed input is a 400, not a 500."""
    raw = query.get(name)
    if raw is None:
        return default
    try:
        val = cast(raw)
    except (TypeError, ValueError):
        raise web.HTTPBadRequest(text=f"bad {name!r} parameter") from None
    if lo is not None:
        val = max(val, lo)
    if hi is not None:
        val = min(val, hi)
    return val


AUDIT = web.AppKey("audit", object)
# the catalog's thumbnail grabber (api/catalog.py::Thumbnailer): the
# app's device, and the backend built on it at the first grab
THUMBNAILER = web.AppKey("thumbnailer", object)


def _path_id(request: web.Request, key: str) -> int:
    """Parse a ``{name:\\d+}`` path id.  The regex admits digit strings
    larger than sqlite's INTEGER (2^63) — binding those raises
    OverflowError deep in the driver and surfaces as a 500; any id that
    big simply doesn't exist, so it is a 404."""
    val = int(request.match_info[key])
    if val > (1 << 62):
        raise web.HTTPNotFound(text=json.dumps(
            {"error": f"no such {key.removesuffix('_id')}"}),
            content_type="application/json")
    return val

# --------------------------------------------------------------------------
# Cookie sessions + CSRF (reference admin.py:1088-1234): the admin SPA
# logs in once with the secret and holds an HttpOnly session cookie;
# state-changing requests must echo the session's CSRF token in a header
# (cookies ride along on cross-site requests, custom headers cannot).
# Header-secret auth (X-Admin-Secret) stays for API clients/automation.
# --------------------------------------------------------------------------

SESSION_COOKIE = "vlog_admin_session"
SESSION_TTL_S = 12 * 3600


def _hash_token(token: str) -> str:
    import hashlib

    return hashlib.sha256(token.encode()).hexdigest()


async def _session_for(request: web.Request) -> dict | None:
    token = request.cookies.get(SESSION_COOKIE)
    if not token:
        return None
    db = request.app[DB]
    row = await db.fetch_one(
        "SELECT * FROM admin_sessions WHERE token_hash=:h AND "
        "expires_at > :now", {"h": _hash_token(token), "now": db_now()})
    if row is not None:
        await db.execute(
            "UPDATE admin_sessions SET last_used_at=:t WHERE id=:i",
            {"t": db_now(), "i": row["id"]})
    return row


# Online-guessing throttle: per-IP exponential backoff after repeated
# failed logins (in-process state — one admin API process owns the
# port; the reference throttles at the same tier). Successful login
# resets. Known trade-off of keying on the peer address: clients behind
# one NAT share a bucket, so a hostile neighbor can deny logins from
# that address for up to the 300s cap per wrong guess — accepted, since
# the alternative (no throttle) leaves the secret open to unbounded
# online guessing. Deployments that front this with a proxy must
# preserve client addresses (or disable via a long ADMIN_SECRET).
_LOGIN_FAILS: dict[str, tuple[int, float]] = {}
_LOGIN_FREE_ATTEMPTS = 5
_LOGIN_LOCK_CAP_S = 300.0
_LOGIN_STALE_S = 3600.0

# Indirection so tests can shift this module's clock without freezing
# the process-wide time.monotonic the asyncio loop runs on.
_now = time.monotonic


def _login_throttled(ip: str) -> float:
    """Seconds the caller must still wait, 0 if allowed."""
    count, last = _LOGIN_FAILS.get(ip, (0, 0.0))
    if count < _LOGIN_FREE_ATTEMPTS:
        return 0.0
    # exponent clamped BEFORE **: an attacker feeding one failure per
    # window for weeks would otherwise push 2.0**n past float range
    # (OverflowError -> unhandled 500 ahead of the credential check)
    lock = min(2.0 ** min(count - _LOGIN_FREE_ATTEMPTS, 9),
               _LOGIN_LOCK_CAP_S)
    return max(0.0, last + lock - _now())


def _login_failed(ip: str) -> None:
    t = _now()
    if len(_LOGIN_FAILS) > 10_000:
        # Bound memory under address churn (e.g. an IPv6 /64 spraying
        # junk failures) WITHOUT wiping hot entries — clearing
        # everything would let a locked-out attacker reset their own
        # backoff by flooding from throwaway addresses.
        stale = [k for k, (_, ts) in _LOGIN_FAILS.items()
                 if t - ts > _LOGIN_STALE_S]
        for k in stale:
            del _LOGIN_FAILS[k]
        if len(_LOGIN_FAILS) > 10_000:   # all hot: drop the oldest half
            for k in sorted(_LOGIN_FAILS,
                            key=lambda k: _LOGIN_FAILS[k][1])[:5_000]:
                del _LOGIN_FAILS[k]
    count, _ = _LOGIN_FAILS.get(ip, (0, 0.0))
    _LOGIN_FAILS[ip] = (count + 1, t)


async def login(request: web.Request) -> web.Response:
    """POST {secret} -> session cookie + CSRF token."""
    import secrets as pysecrets

    ip = request.remote or "?"
    wait = _login_throttled(ip)
    if wait > 0:
        # keep the audit trail alive during an active brute-force: the
        # operator must see throttled attempts, not silence
        audit = request.app.get(AUDIT)
        if audit is not None:
            audit.record("auth.login_throttled", remote=ip)
        return _json_error(429, f"too many failed logins; retry in "
                                f"{wait:.0f}s")
    body = await request.json()
    if not authmod.check_admin_secret(str(body.get("secret") or ""),
                                      config.ADMIN_SECRET):
        _login_failed(ip)
        audit = request.app.get(AUDIT)
        if audit is not None:
            audit.record("auth.login_failed", remote=request.remote)
        return _json_error(403, "bad admin secret")
    _LOGIN_FAILS.pop(ip, None)
    token = pysecrets.token_urlsafe(32)
    csrf = pysecrets.token_urlsafe(32)
    t = db_now()
    db = request.app[DB]
    await db.execute(
        """
        INSERT INTO admin_sessions (token_hash, csrf_token, created_at,
                                    expires_at)
        VALUES (:h, :c, :t, :exp)
        """, {"h": _hash_token(token), "c": csrf, "t": t,
              "exp": t + SESSION_TTL_S})
    # opportunistic GC of expired sessions
    await db.execute("DELETE FROM admin_sessions WHERE expires_at <= :t",
                     {"t": t})
    resp = web.json_response({"ok": True, "csrf_token": csrf,
                              "expires_in_s": SESSION_TTL_S})
    resp.set_cookie(SESSION_COOKIE, token, httponly=True, samesite="Lax",
                    secure=config.ADMIN_COOKIE_SECURE,
                    max_age=SESSION_TTL_S, path="/")
    return resp


async def logout(request: web.Request) -> web.Response:
    token = request.cookies.get(SESSION_COOKIE)
    if token:
        await request.app[DB].execute(
            "DELETE FROM admin_sessions WHERE token_hash=:h",
            {"h": _hash_token(token)})
    resp = web.json_response({"ok": True})
    resp.del_cookie(SESSION_COOKIE, path="/")
    return resp


async def session_info(request: web.Request) -> web.Response:
    row = await _session_for(request)
    if row is None:
        return _json_error(401, "no live session")
    return web.json_response({
        "ok": True, "csrf_token": row["csrf_token"],
        "expires_at": row["expires_at"]})


@web.middleware
async def admin_auth_middleware(request: web.Request, handler):
    from vlog_tpu_torch.web import is_ui_path

    # The static UI shell (login page + assets) must load without the
    # secret; every /api route below still requires it. /api/auth/login
    # and /api/auth/session are how a session starts/renews.
    if (request.path == "/healthz" or is_ui_path(request.path)
            or request.path in ("/api/auth/login", "/api/auth/session")):
        return await handler(request)
    authed = authmod.check_admin_secret(
        request.headers.get("X-Admin-Secret"), config.ADMIN_SECRET)
    if not authed:
        session = await _session_for(request)
        if session is not None:
            if request.method in ("GET", "HEAD", "OPTIONS"):
                authed = True
            else:
                # cookie-authed mutation: CSRF header must match
                # (constant-time — the token IS the protection here)
                import hmac

                authed = hmac.compare_digest(
                    request.headers.get("X-CSRF-Token") or "",
                    session["csrf_token"])
    if not authed:
        audit = request.app.get(AUDIT)
        if audit is not None:
            audit.record("auth.denied", method=request.method,
                         path=request.path, remote=request.remote)
        return _json_error(403, "bad admin secret")
    resp = await handler(request)
    # security log: every MUTATING admin request (reference api/audit.py)
    if request.method not in ("GET", "HEAD", "OPTIONS"):
        audit = request.app.get(AUDIT)
        if audit is not None:
            audit.record("admin.request", method=request.method,
                         path=request.path, status=resp.status,
                         remote=request.remote)
    return resp


# --------------------------------------------------------------------------
# Upload
# --------------------------------------------------------------------------

async def upload_video(request: web.Request) -> web.Response:
    """Multipart upload -> size-capped save -> probe -> row + job enqueue.

    Reference: admin.py:1706-1890 (save_upload_with_size_limit at 613).
    """
    db = request.app[DB]
    from vlog_tpu_torch.storage import integrity

    # Disk admission before the first byte lands: a 50 GB upload that
    # dies at 90% from ENOSPC wastes the transfer AND leaves a temp.
    if integrity.under_pressure(request.app[UPLOAD_DIR]):
        return _json_error(507, "insufficient free disk space for upload")
    reader = await request.multipart()
    title = None
    description = ""
    category = None
    saved: Path | None = None
    original_name = None
    size = 0
    async for part in reader:
        if part.name == "title":
            title = (await part.text()).strip()
        elif part.name == "description":
            description = await part.text()
        elif part.name == "category":
            category = (await part.text()).strip() or None
        elif part.name == "file":
            if saved is not None:
                # A second file part supersedes the first: without this,
                # the earlier temp leaked forever and ``size`` kept
                # accumulating across parts (a 2-part upload could trip
                # the size cap while neither file did).
                saved.unlink(missing_ok=True)
                saved = None
                size = 0
            original_name = Path(part.filename or "upload.bin").name
            suffix = Path(original_name).suffix.lower() or ".bin"
            tmp = request.app[UPLOAD_DIR] / \
                f".upload-{uuid.uuid4().hex}{suffix}"
            tmp.parent.mkdir(parents=True, exist_ok=True)
            try:
                # open/write hop to threads: a blocking write on the
                # upload volume would stall the whole admin event loop
                # (asyncblock lint).
                fp = await asyncio.to_thread(open, tmp, "wb")
                try:
                    while True:
                        chunk = await part.read_chunk(_COPY_CHUNK)
                        if not chunk:
                            break
                        size += len(chunk)
                        if size > config.MAX_UPLOAD_SIZE_BYTES:
                            raise web.HTTPRequestEntityTooLarge(
                                max_size=config.MAX_UPLOAD_SIZE_BYTES,
                                actual_size=size)
                        await asyncio.to_thread(fp.write, chunk)
                finally:
                    await asyncio.to_thread(fp.close)
            except BaseException:
                tmp.unlink(missing_ok=True)
                raise
            saved = tmp
    if saved is None or size == 0:
        return _json_error(400, "no file part in upload")
    if not title:
        title = Path(original_name or "video").stem.replace("_", " ")

    # probe before accepting (reference rejects unparseable uploads)
    try:
        info = await asyncio.to_thread(get_video_info, saved)
    except (ProbeError, Exception) as exc:  # noqa: BLE001 — any parse error
        saved.unlink(missing_ok=True)
        return _json_error(400, f"unsupported upload: {exc}")

    video = await vids.create_video(
        db, title, source_path=str(saved), original_filename=original_name,
        size_bytes=size, description=description, category=category)
    # final resting place keyed by video id (stable across retitle)
    dest = request.app[UPLOAD_DIR] / f"{video['id']}{saved.suffix}"
    await asyncio.to_thread(saved.rename, dest)
    await db.execute(
        "UPDATE videos SET source_path=:p, duration_s=:d, width=:w, "
        "height=:h, fps=:f, updated_at=:t WHERE id=:id",
        {"p": str(dest), "d": info.duration_s, "w": info.width,
         "h": info.height, "f": info.fps, "t": db_now(), "id": video["id"]})
    tenant = qos.normalize_tenant(request.headers.get("X-Vlog-Tenant"))
    try:
        job_id = await claims.enqueue_job(db, video["id"], JobKind.TRANSCODE,
                                          tenant=tenant)
    except qos.AdmissionError as exc:
        # the video row stays (source is saved and probed); only the
        # transcode is refused — the caller retries the enqueue via
        # retranscode after Retry-After
        return _admission_429(exc)
    video = await vids.get_video(db, video["id"])
    return web.json_response(
        {"video": video, "job_id": job_id}, status=201)


# --------------------------------------------------------------------------
# Video management
# --------------------------------------------------------------------------

async def list_videos(request: web.Request) -> web.Response:
    db = request.app[DB]
    q = request.query
    limit = _qnum(q, "limit", 50, lo=1, hi=500)
    offset = _qnum(q, "offset", 0, lo=0)
    # include_deleted=1 surfaces soft-deleted rows so they can be restored
    where = (["1=1"] if q.get("include_deleted") in ("1", "true", "yes")
             else ["deleted_at IS NULL"])
    params: dict = {"limit": limit, "offset": offset}
    if q.get("status"):
        where.append("status=:status")
        params["status"] = q["status"]
    if q.get("q"):
        # title/slug substring search (reference admin search box);
        # escape LIKE wildcards so a literal % can't scan everything
        esc = (q["q"].replace("\\", "\\\\")
               .replace("%", "\\%").replace("_", "\\_"))
        where.append(r"(title LIKE :q ESCAPE '\' "
                     r"OR slug LIKE :q ESCAPE '\')")
        params["q"] = f"%{esc}%"
    base_where, base_params = list(where), {
        k: v for k, v in params.items() if k not in ("limit", "offset")}
    if q.get("cursor"):
        # keyset page (api/pagination.py); ignores offset
        from vlog_tpu_torch.api.pagination import (CursorError, decode_cursor,
                                             keyset_clause)

        try:
            cur_ts, cur_id = decode_cursor(q["cursor"])
        except CursorError as exc:
            return _json_error(400, str(exc))
        where.append(keyset_clause("created_at", "id"))
        params.update({"cur_ts": cur_ts, "cur_id": cur_id, "offset": 0})
    rows = await db.fetch_all(
        f"""
        SELECT * FROM videos WHERE {' AND '.join(where)}
        ORDER BY created_at DESC, id DESC LIMIT :limit OFFSET :offset
        """, params)
    total = await db.fetch_val(
        f"SELECT COUNT(*) FROM videos WHERE {' AND '.join(base_where)}",
        base_params)
    from vlog_tpu_torch.api.pagination import next_cursor_from

    return web.json_response({"videos": rows, "total": total,
                              "limit": limit, "offset": offset,
                              "next_cursor": next_cursor_from(rows, limit)})


async def video_detail(request: web.Request) -> web.Response:
    db = request.app[DB]
    video = await vids.get_video(db, _path_id(request, "video_id"))
    if video is None:
        return _json_error(404, "no such video")
    quals = await db.fetch_all(
        "SELECT * FROM video_qualities WHERE video_id=:v ORDER BY height DESC",
        {"v": video["id"]})
    jobs = await db.fetch_all(
        "SELECT * FROM jobs WHERE video_id=:v", {"v": video["id"]})
    t = db_now()
    for j in jobs:
        j["state"] = js.derive_state(j, now=t).value
        j["quality_progress"] = {
            k: dict(v) for k, v in
            (await claims.get_quality_progress(db, j["id"])).items()}
    tr = await db.fetch_one(
        "SELECT * FROM transcriptions WHERE video_id=:v", {"v": video["id"]})
    return web.json_response({"video": video, "qualities": quals,
                              "jobs": jobs, "transcription": tr})


async def retranscode(request: web.Request) -> web.Response:
    """Force re-enqueue (reference admin.py retranscode, 2883)."""
    db = request.app[DB]
    video = await vids.get_video(db, _path_id(request, "video_id"))
    if video is None:
        return _json_error(404, "no such video")
    body = await request.json() if request.can_read_body else {}
    tenant = qos.normalize_tenant(
        body.get("tenant") or request.headers.get("X-Vlog-Tenant"))
    try:
        job_id = await claims.enqueue_job(db, video["id"], JobKind.TRANSCODE,
                                          force=bool(body.get("force")),
                                          tenant=tenant)
    except js.JobStateError as exc:
        return _json_error(409, str(exc))
    except qos.AdmissionError as exc:
        return _admission_429(exc)
    await vids.set_status(db, video["id"], VideoStatus.PENDING)
    return web.json_response({"job_id": job_id})


async def reencode(request: web.Request) -> web.Response:
    """Queue a format/codec conversion (reference reencode queue,
    admin.py:6297-6687)."""
    db = request.app[DB]
    video = await vids.get_video(db, _path_id(request, "video_id"))
    if video is None:
        return _json_error(404, "no such video")
    body = await request.json() if request.can_read_body else {}
    fmt = body.get("streaming_format", "cmaf")
    codec = body.get("codec", "h264")
    if fmt not in ("cmaf", "hls_ts"):
        return _json_error(400, f"unknown streaming_format {fmt!r}")
    cerr = validate_codec_format(codec, fmt)
    if cerr is not None:
        return _json_error(400, cerr)
    tenant = qos.normalize_tenant(
        body.get("tenant") or request.headers.get("X-Vlog-Tenant"))
    try:
        job_id = await claims.enqueue_job(
            db, video["id"], JobKind.REENCODE,
            payload={"streaming_format": fmt, "codec": codec},
            force=bool(body.get("force")), tenant=tenant)
    except js.JobStateError as exc:
        return _json_error(409, str(exc))
    except qos.AdmissionError as exc:
        return _admission_429(exc)
    return web.json_response({"job_id": job_id})


async def _attach_failure_history(db: Database, rows: list[dict]) -> None:
    """Bulk-load job_failures for ``rows`` (adds a ``failures`` key)."""
    by_job: dict[int, list[dict]] = {r["id"]: [] for r in rows}
    if by_job:
        marks = ",".join(f":f{i}" for i in range(len(by_job)))
        hist = await db.fetch_all(
            f"SELECT * FROM job_failures WHERE job_id IN ({marks}) "
            "ORDER BY id",
            {f"f{i}": jid for i, jid in enumerate(by_job)})
        for h in hist:
            by_job[h["job_id"]].append(h)
    for r in rows:
        r["failures"] = by_job.get(r["id"], [])


async def failed_jobs(request: web.Request) -> web.Response:
    """The dead-letter view: terminally failed jobs with their errors and
    the full classified per-attempt failure history (job_failures rows —
    which worker, which class, which error, per attempt). Reference
    dead-letter admin, admin.py:8934-9228."""
    db = request.app[DB]
    rows = await db.fetch_all(
        """
        SELECT j.*, v.slug, v.title FROM jobs j
        JOIN videos v ON v.id = j.video_id
        WHERE j.failed_at IS NOT NULL
        ORDER BY j.failed_at DESC LIMIT 200
        """)
    await _attach_failure_history(db, rows)
    return web.json_response({"jobs": rows})


async def job_failure_history(request: web.Request) -> web.Response:
    """Per-attempt failure records for one job (oldest first)."""
    db = request.app[DB]
    job_id = _path_id(request, "job_id")
    job = await db.fetch_one("SELECT id FROM jobs WHERE id=:id",
                             {"id": job_id})
    if job is None:
        return _json_error(404, "no such job")
    return web.json_response(
        {"failures": await claims.get_failure_history(db, job_id)})


async def job_trace(request: web.Request) -> web.Response:
    """The job's span tree (obs/store.py): enqueue -> queue wait ->
    claim -> worker attempt (download / transcode / per-stage and
    per-rung leaves / upload) -> completion, one trace id across
    server and worker origins. Feeds the admin waterfall."""
    from vlog_tpu_torch.obs import store as obs_store

    db = request.app[DB]
    job_id = _path_id(request, "job_id")
    job = await db.fetch_one("SELECT id FROM jobs WHERE id=:id",
                             {"id": job_id})
    if job is None:
        return _json_error(404, "no such job")
    out = await obs_store.fetch_trace(db, job_id)
    return web.json_response({"job_id": job_id, **out})


# The derived-state rules of jobs/state.py as one SQL CASE: counts and
# per-state pages come from the database, so the queue browser scales to
# the full history instead of the newest N rows (states are not stored —
# db/schema.py jobs contract). One definition (jobs/state.py) also
# serves the /metrics job-state gauges.
_STATE_CASE = js.sql_state_case("j.")


async def list_jobs(request: web.Request) -> web.Response:
    """Queue browser: every job with its DERIVED state (the reference's
    jobs admin, admin.py job listing routes). ?state= filters; pages are
    true id-cursor keyset (?cursor= is the last id of the previous page;
    the response's ``next_cursor`` feeds the next request), so deep pages
    stay O(limit). The per-state counts aggregate over the whole table
    and are therefore computed only on the FIRST page (no cursor) —
    paging deeper never rescans the table for them."""
    db = request.app[DB]
    q = request.query
    want = q.get("state", "").strip()
    want_tenant = q.get("tenant", "").strip()
    limit = _qnum(q, "limit", 100, lo=1, hi=500)
    cursor = _qnum(q, "cursor", None, lo=1)
    t = db_now()
    where = []
    params: dict = {"now": t, "limit": limit}
    if want:
        where.append(f"{_STATE_CASE} = :want")
        params["want"] = want
    if want_tenant:
        where.append("j.tenant = :tenant")
        params["tenant"] = want_tenant
    if cursor is not None:
        where.append("j.id < :cursor")
        params["cursor"] = cursor
    where_sql = f"WHERE {' AND '.join(where)}" if where else ""
    rows = await db.fetch_all(
        f"""
        SELECT j.*, v.slug, v.title, {_STATE_CASE} AS state FROM jobs j
        JOIN videos v ON v.id = j.video_id
        {where_sql}
        ORDER BY j.id DESC LIMIT :limit
        """, params)
    out = [{"id": r["id"], "kind": r["kind"], "state": r["state"],
            "tenant": r["tenant"],
            "slug": r["slug"], "title": r["title"],
            "attempt": r["attempt"], "progress": r["progress"],
            "current_step": r["current_step"],
            "claimed_by": r["claimed_by"],
            "created_at": r["created_at"],
            "updated_at": r["updated_at"],
            "next_retry_at": r["next_retry_at"],
            "error": r["error"]} for r in rows]
    next_cursor = rows[-1]["id"] if len(rows) == limit else None
    resp = {"jobs": out, "next_cursor": next_cursor}
    if cursor is None:
        # first page only, like the state counts — a tenant filter
        # scopes them so the queue tab's numbers match the rows shown
        tenant_sql = "WHERE j.tenant = :tenant" if want_tenant else ""
        count_rows = await db.fetch_all(
            f"SELECT {_STATE_CASE} AS state, COUNT(*) AS n FROM jobs j "
            f"{tenant_sql} GROUP BY state",
            {"now": t, **({"tenant": want_tenant} if want_tenant else {})})
        counts = {r["state"]: r["n"] for r in count_rows}
        resp["counts"] = counts
        resp["total"] = (counts.get(want, 0) if want
                         else sum(counts.values()))
    return web.json_response(resp)


async def audit_tail(request: web.Request) -> web.Response:
    """Tail the audit JSONL (api/audit.py rotations included) newest
    first; ?action= prefix filter, ?q= substring filter (reference:
    the admin audit browser)."""
    audit = request.app.get(AUDIT)
    if audit is None:
        return web.json_response({"entries": []})
    limit = _qnum(request.query, "limit", 200, lo=1, hi=1000)
    action = request.query.get("action", "").strip()
    needle = request.query.get("q", "").strip().lower()
    # Bounded work: read at most the trailing 4 MB of each file (the
    # current log caps at 10 MB before rotating), iterate newest-first,
    # stop as soon as ``limit`` matches are collected.  Keeps a filter
    # click O(tail), not O(full log + rotation).
    cap_bytes = 4 * 1024 * 1024
    entries: list[dict] = []
    from vlog_tpu_torch.api.audit import KEEP_ROTATIONS

    files = [audit.path] + [audit.path.with_suffix(f".{i}.log")
                            for i in range(1, KEEP_ROTATIONS + 1)]
    def _read_tail(path) -> tuple[int, str] | None:
        """Blocking tail read — runs in a thread so a cold/slow log
        volume can't stall the admin event loop (asyncblock lint)."""
        try:
            with open(path, "rb") as fp:
                fp.seek(0, 2)
                size = fp.tell()
                fp.seek(max(0, size - cap_bytes))
                return size, fp.read().decode(errors="replace")
        except OSError:
            return None

    for p in files:
        if len(entries) >= limit:
            break
        got = await asyncio.to_thread(_read_tail, p)
        if got is None:
            continue
        size, data = got
        lines = data.splitlines()
        if size > cap_bytes and lines:
            lines = lines[1:]               # drop the torn first line
        for line in reversed(lines):
            if len(entries) >= limit:
                break
            try:
                e = json.loads(line)
            except ValueError:
                continue
            if action and not str(e.get("action", "")).startswith(action):
                continue
            if needle and needle not in line.lower():
                continue
            entries.append(e)
    return web.json_response({"entries": entries})


async def analytics_daily(request: web.Request) -> web.Response:
    """Per-day session counts + watch time for the dashboard charts
    (reference analytics timeseries, condensed)."""
    db = request.app[DB]
    days = _qnum(request.query, "days", 30, lo=1, hi=120)
    cut = db_now() - days * 86400.0
    rows = await db.fetch_all(
        """
        SELECT CAST((started_at / 86400) AS INTEGER) AS day,
               COUNT(*) AS sessions,
               COALESCE(SUM(watch_time_s), 0) AS watch_time_s
        FROM playback_sessions WHERE started_at >= :cut
        GROUP BY day ORDER BY day
        """, {"cut": cut})
    return web.json_response({"days": [
        {"epoch_day": r["day"], "sessions": r["sessions"],
         "watch_time_s": r["watch_time_s"]} for r in rows]})


async def regenerate_manifests(request: web.Request) -> web.Response:
    """Rebuild master.m3u8 + manifest.mpd from the database qualities
    and on-disk rung trees (reference CLI ``manifests-regenerate``):
    the repair path when a master is lost/corrupted or rungs were moved.
    Codec strings come from each rung's init.mp4 (media/codecstr.py) —
    the DB only stores short names."""
    db = request.app[DB]
    vid = _path_id(request, "video_id")
    video = await vids.get_video(db, vid)
    if video is None:
        return _json_error(404, "no such video")
    out_dir = request.app[VIDEO_DIR] / video["slug"]
    quals = await db.fetch_all(
        "SELECT * FROM video_qualities WHERE video_id=:v ORDER BY height",
        {"v": vid})
    # the whole rebuild reads every segment of every rung (deep
    # validation BEFORE anything is overwritten) — off the event loop
    result = await asyncio.to_thread(
        _regenerate_manifests_sync, out_dir, video, quals)
    if "error" in result:
        return _json_error(result.pop("status", 409), result["error"])
    audit = request.app.get(AUDIT)
    if audit is not None:
        audit.record("video.manifests_regenerated", video_id=vid,
                     variants=result["variants"],
                     skipped=result["skipped"])
    # the master/mpd (and outputs.json) just changed on disk
    from vlog_tpu_torch import delivery

    delivery.invalidate_slug(video["slug"])
    return web.json_response({"ok": True, **result})


def _regenerate_manifests_sync(out_dir: Path, video, quals) -> dict:
    from vlog_tpu_torch.media import hls
    from vlog_tpu_torch.media.codecstr import (codec_string_from_init,
                                         codec_string_from_ts)
    from vlog_tpu_torch.utils.fsio import atomic_write_text

    variants: list[hls.VariantRef] = []
    skipped: list[str] = []
    cmaf = True
    for q in quals:
        rdir = out_dir / q["name"]
        playlist = rdir / "playlist.m3u8"
        init = rdir / "init.mp4"
        if not playlist.is_file():
            skipped.append(q["name"])
            continue
        # deep-validate the rung (segments read + moof checks) BEFORE a
        # new master could reference a half-broken tree
        try:
            hls.validate_media_playlist(playlist)
        except hls.PlaylistValidationError:
            skipped.append(q["name"])
            continue
        if init.is_file():
            codecs = codec_string_from_init(init.read_bytes())
        else:
            # legacy hls_ts rung: SPS bytes live in the TS segments
            cmaf = False
            seg = next(iter(sorted(rdir.glob("segment_*.ts"))), None)
            codecs = (codec_string_from_ts(seg.read_bytes())
                      if seg is not None else None)
        if codecs is None:
            skipped.append(q["name"])
            continue
        abps = q["audio_bitrate"]
        variants.append(hls.VariantRef(
            name=q["name"], uri=f"{q['name']}/playlist.m3u8",
            bandwidth=int(q["video_bitrate"] or 100_000),
            width=q["width"], height=q["height"], codecs=codecs,
            frame_rate=float(video["fps"] or 0.0),
            audio_group=f"aud{abps // 1000}" if abps else ""))
    if not variants:
        return {"error": "no intact rungs to reference", "status": 409}
    audio_refs: list[hls.AudioRendition] = []
    for adir in sorted(out_dir.glob("audio_*k")):
        if not (adir / "playlist.m3u8").is_file():
            continue
        try:
            kbps = int(adir.name[len("audio_"):-1])
        except ValueError:
            continue
        audio_refs.append(hls.AudioRendition(
            name=adir.name, uri=f"{adir.name}/playlist.m3u8",
            group_id=f"aud{kbps}", bitrate=kbps * 1000))
    seg_s = config.SEGMENT_DURATION_S
    try:
        meta = hls.validate_media_playlist(
            out_dir / variants[0].name / "playlist.m3u8")
        if meta.get("segments"):
            seg_s = meta["duration_s"] / meta["segments"]
    except Exception:  # noqa: BLE001 — fall back to config default
        pass
    atomic_write_text(out_dir / "master.m3u8",
                      hls.master_playlist(variants, audio=audio_refs))
    if cmaf:
        # TS mode has no DASH representation (same rule as the encode
        # path: jax_backend writes the MPD only for CMAF trees)
        atomic_write_text(out_dir / "manifest.mpd", hls.dash_manifest(
            variants, duration_s=float(video["duration_s"] or 0.0),
            segment_duration_s=seg_s, audio=audio_refs))
    hls.validate_master_playlist(out_dir / "master.m3u8")
    # The stored integrity manifest recorded the OLD master/MPD digests;
    # refresh those entries so admin verify doesn't flag the repair.
    from vlog_tpu_torch.storage import integrity

    try:
        files = integrity.load_manifest(out_dir)
    except integrity.ManifestError:
        files = None
    if files is not None:
        for name in ("master.m3u8", "manifest.mpd"):
            p = out_dir / name
            if p.is_file():
                files[name] = {"size": p.stat().st_size,
                               "sha256": integrity.sha256_file(p)}
            else:
                files.pop(name, None)
        integrity.write_manifest(out_dir, files)
    return {"variants": [v.name for v in variants],
            "audio": [a.name for a in audio_refs],
            "skipped": skipped}


async def requeue_job(request: web.Request) -> web.Response:
    """Return a dead-lettered job to the claimable pool with a fresh
    retry budget."""
    db = request.app[DB]
    job_id = _path_id(request, "job_id")
    job = await db.fetch_one("SELECT * FROM jobs WHERE id=:id",
                             {"id": job_id})
    if job is None:
        return _json_error(404, "no such job")
    if job["failed_at"] is None:
        return _json_error(409, "job is not dead-lettered")
    # one transaction: a half-applied requeue would either resurrect the
    # previous life's post-mortem or delete a fresh failure row (same
    # atomicity contract as the enqueue_job reset path)
    async with db.transaction() as tx:
        await tx.execute(
            """
            UPDATE jobs SET failed_at=NULL, error=NULL, attempt=0,
                   progress=0.0, current_step=NULL, next_retry_at=NULL,
                   updated_at=:t
            WHERE id=:id
            """, {"t": db_now(), "id": job_id})
        # fresh retry budget -> fresh post-mortem (and a fresh trace:
        # the old life's spans would graft onto the new waterfall)
        await tx.execute("DELETE FROM job_failures WHERE job_id=:id",
                         {"id": job_id})
        await tx.execute("DELETE FROM job_spans WHERE job_id=:id",
                         {"id": job_id})
    if JobKind(job["kind"]) is JobKind.TRANSCODE:
        await vids.set_status(db, job["video_id"], VideoStatus.PENDING)
    return web.json_response({"ok": True})


async def delete_video(request: web.Request) -> web.Response:
    """Soft delete (reference admin.py:2500: restorable)."""
    from vlog_tpu_torch import delivery

    db = request.app[DB]
    video = await vids.get_video(db, _path_id(request, "video_id"))
    if video is None:
        return _json_error(404, "no such video")
    await db.execute(
        "UPDATE videos SET status='deleted', deleted_at=:t, updated_at=:t "
        "WHERE id=:id", {"t": db_now(), "id": video["id"]})
    # a deleted video must stop serving NOW, not at publish-state TTL
    delivery.invalidate_slug(video["slug"])
    return web.json_response({"ok": True})


# --------------------------------------------------------------------------
# Storage integrity + GC plane (storage/integrity.py, storage/gc.py)
# --------------------------------------------------------------------------

async def storage_status(request: web.Request) -> web.Response:
    """Disk admission view: free space vs the VLOG_MIN_FREE_DISK_GB
    floor for each storage volume."""
    from vlog_tpu_torch.storage import integrity

    dirs = {"upload": request.app[UPLOAD_DIR],
            "video": request.app[VIDEO_DIR],
            "tmp": config.TMP_DIR}
    out = {}
    for name, path in dirs.items():
        free = await asyncio.to_thread(integrity.free_bytes, path)
        # under_pressure owns the admission predicate — the status tab
        # must never disagree with what the upload endpoints enforce
        pressure = await asyncio.to_thread(integrity.under_pressure, path)
        out[name] = {"path": str(path), "free_bytes": free,
                     "min_free_bytes": config.MIN_FREE_DISK_BYTES,
                     "pressure": pressure}
    return web.json_response({"volumes": out})


async def run_storage_gc(request: web.Request) -> web.Response:
    """Trigger an orphan-GC sweep now; body {dry_run, temp_max_age_s,
    deleted_retention_s} all optional. Returns the full report."""
    from vlog_tpu_torch.storage import gc as storage_gc
    from vlog_tpu_torch.utils import failpoints

    body = await request.json() if request.can_read_body else {}
    try:
        temp_age = (float(body["temp_max_age_s"])
                    if body.get("temp_max_age_s") is not None else None)
        retention = (float(body["deleted_retention_s"])
                     if body.get("deleted_retention_s") is not None else None)
    except (TypeError, ValueError):
        return _json_error(400, "bad age threshold")
    try:
        report = await storage_gc.run_gc(
            request.app[DB], video_dir=request.app[VIDEO_DIR],
            upload_dir=request.app[UPLOAD_DIR],
            temp_max_age_s=temp_age, deleted_retention_s=retention,
            dry_run=bool(body.get("dry_run")))
    except storage_gc.GCBusyError as exc:
        return _json_error(409, str(exc))
    except failpoints.FailpointError as exc:
        return _json_error(503, f"gc sweep aborted: {exc}")
    audit = request.app.get(AUDIT)
    if audit is not None:
        audit.record("storage.gc", dry_run=report.dry_run,
                     removed=len(report.removed),
                     bytes_reclaimed=report.bytes_reclaimed)
    return web.json_response({"report": report.to_dict()})


async def storage_gc_report(request: web.Request) -> web.Response:
    """Last sweep's report + cumulative process totals."""
    from vlog_tpu_torch.storage import gc as storage_gc

    return web.json_response(storage_gc.snapshot())


async def verify_video(request: web.Request) -> web.Response:
    """Re-verify a published video's output tree against its stored
    ``outputs.json`` manifest — existence, size, sha256 of every file.
    The on-demand answer to \"did this tree rot since publish?\"."""
    from vlog_tpu_torch.storage import integrity

    db = request.app[DB]
    video = await vids.get_video(db, _path_id(request, "video_id"))
    if video is None:
        return _json_error(404, "no such video")
    root = request.app[VIDEO_DIR] / video["slug"]
    if not root.is_dir():
        return _json_error(404, "no output tree on disk")
    try:
        manifest = await asyncio.to_thread(integrity.load_manifest, root)
        if manifest is None:
            return _json_error(
                409, "no stored manifest (tree published before the "
                     "integrity plane; re-transcode to get one)")
        problems = await asyncio.to_thread(
            integrity.verify_tree, root, manifest)
    except integrity.ManifestError as exc:
        manifest, problems = {}, [str(exc)]
    audit = request.app.get(AUDIT)
    if audit is not None:
        audit.record("video.verified", video_id=video["id"],
                     ok=not problems, problems=len(problems))
    # a verify run re-read the tree's ground truth: drop cached buffers
    # so nothing keeps serving bytes the verification just disowned
    from vlog_tpu_torch import delivery

    delivery.invalidate_slug(video["slug"])
    return web.json_response({
        "ok": not problems, "video_id": video["id"],
        "files_checked": len(manifest), "problems": problems})


async def restore_video(request: web.Request) -> web.Response:
    from vlog_tpu_torch import delivery

    db = request.app[DB]
    video = await vids.get_video(db, _path_id(request, "video_id"))
    if video is None or video["deleted_at"] is None:
        return _json_error(404, "not deleted")
    has_master = (request.app[VIDEO_DIR] / video["slug"] / "master.m3u8").exists()
    await db.execute(
        "UPDATE videos SET status=:s, deleted_at=NULL, updated_at=:t "
        "WHERE id=:id",
        {"s": "ready" if has_master else "pending", "t": db_now(),
         "id": video["id"]})
    delivery.invalidate_slug(video["slug"])
    return web.json_response({"ok": True})


# --------------------------------------------------------------------------
# Live progress (SSE)
# --------------------------------------------------------------------------

async def sse_progress(request: web.Request) -> web.StreamResponse:
    """Server-Sent-Events stream of job progress (admin.py:5291 analog).

    The DB is the shared truth between API and worker processes, so this
    reads it and pushes deltas — same contract as the reference's
    Redis-pub/sub-backed stream, minus the Redis dependency. Wakeups
    ride the event plane (jobs/events.py: LISTEN/NOTIFY on Postgres,
    in-process bus on sqlite), so deltas flush the moment a worker
    reports; the ``poll`` interval is the safety net for deployments
    where events can't cross processes.
    """
    from vlog_tpu_torch.jobs.events import CH_PROGRESS, bus_for

    db = request.app[DB]
    resp = web.StreamResponse(headers={
        "Content-Type": "text/event-stream",
        "Cache-Control": "no-cache",
        "X-Accel-Buffering": "no"})
    await resp.prepare(request)
    last: dict[int, tuple] = {}
    poll_s = _qnum(request.query, "poll", 1.0, lo=0.1, hi=30.0, cast=float)
    bus = bus_for(db)
    await bus.start()
    sub = bus.subscribe(CH_PROGRESS)
    try:
        while True:
            t = db_now()
            rows = await db.fetch_all(
                f"SELECT * FROM jobs WHERE {js.SQL_NOT_TERMINAL} "
                "OR updated_at > :cut", {"cut": t - 10.0})
            for r in rows:
                key = (round(r["progress"], 1), r["current_step"],
                       js.derive_state(r, now=t).value)
                if last.get(r["id"]) == key:
                    continue
                last[r["id"]] = key
                payload = {"job_id": r["id"], "video_id": r["video_id"],
                           "kind": r["kind"], "progress": r["progress"],
                           "current_step": r["current_step"],
                           "worker": r["claimed_by"],
                           "state": key[2]}
                await resp.write(
                    f"event: progress\ndata: {json.dumps(payload)}\n\n"
                    .encode())
            # wake on the next progress event; re-read the DB either way
            # (events are hints, the rows are the truth). The floor
            # coalesces event bursts so a chatty worker can't drive
            # this client into back-to-back full-table reads.
            await asyncio.sleep(0.1)
            await sub.get(timeout=poll_s)
            sub.drain()
    except (ConnectionResetError, asyncio.CancelledError):
        pass
    finally:
        sub.close()
    return resp


# --------------------------------------------------------------------------
# Settings + webhooks + workers
# --------------------------------------------------------------------------

async def get_settings(request: web.Request) -> web.Response:
    return web.json_response({"settings": await request.app[SETTINGS].all()})


async def put_setting(request: web.Request) -> web.Response:
    body = await request.json()
    try:
        await request.app[SETTINGS].set(
            request.match_info["key"], body.get("value"),
            value_type=body.get("type"))
    except (SettingsError, ValueError, TypeError) as exc:
        return _json_error(400, str(exc))
    return web.json_response({"ok": True})


async def delete_setting(request: web.Request) -> web.Response:
    found = await request.app[SETTINGS].delete(request.match_info["key"])
    return web.json_response({"ok": True, "deleted": found})


async def list_webhooks(request: web.Request) -> web.Response:
    rows = await request.app[DB].fetch_all(
        "SELECT id, url, events, active, created_at FROM webhooks")
    for r in rows:
        r["events"] = json.loads(r["events"] or "[]")
    return web.json_response({"webhooks": rows})


async def webhook_deliveries(request: web.Request) -> web.Response:
    """Recent delivery attempts for one webhook (reference webhook
    admin's delivery log): status, attempts, response code, timing."""
    db = request.app[DB]
    wid = _path_id(request, "webhook_id")
    if await db.fetch_one("SELECT id FROM webhooks WHERE id=:i",
                          {"i": wid}) is None:
        return _json_error(404, "no such webhook")
    limit = _qnum(request.query, "limit", 50, lo=1, hi=500)
    rows = await db.fetch_all(
        """
        SELECT id, event, status, attempts, response_code, created_at,
               next_attempt_at, delivered_at
        FROM webhook_deliveries WHERE webhook_id=:i
        ORDER BY id DESC LIMIT :n
        """, {"i": wid, "n": limit})
    return web.json_response({"deliveries": rows})


async def create_webhook(request: web.Request) -> web.Response:
    from vlog_tpu_torch.jobs.webhooks import url_allowed

    body = await request.json()
    url = (body.get("url") or "").strip()
    if not url_allowed(url):
        return _json_error(
            400, "url must be http(s) without credentials, and not target "
                 "a private network (VLOG_WEBHOOK_ALLOW_PRIVATE overrides)")
    wid = await request.app[DB].execute(
        """
        INSERT INTO webhooks (url, secret, events, active, created_at)
        VALUES (:u, :s, :e, 1, :t)
        """,
        {"u": url, "s": body.get("secret"),
         "e": json.dumps(body.get("events") or []), "t": db_now()})
    return web.json_response({"id": wid}, status=201)


async def delete_webhook(request: web.Request) -> web.Response:
    n = await request.app[DB].execute(
        "DELETE FROM webhooks WHERE id=:id",
        {"id": _path_id(request, "webhook_id")})
    return web.json_response({"ok": True, "deleted": bool(n)})


async def list_workers(request: web.Request) -> web.Response:
    db = request.app[DB]
    rows = await db.fetch_all("SELECT * FROM workers ORDER BY name")
    cut = db_now() - config.WORKER_OFFLINE_THRESHOLD_S
    for r in rows:
        r["online"] = bool(r["last_heartbeat_at"]
                           and r["last_heartbeat_at"] > cut)
        r["capabilities"] = json.loads(r["capabilities"] or "{}")
    return web.json_response({"workers": rows})


async def fleet_scale_hint(request: web.Request) -> web.Response:
    """Autoscale signal for the admin Queue tab — same
    :func:`vlog_tpu_torch.jobs.qos.fleet_snapshot` the worker API endpoint
    and the ``stats`` worker command serve."""
    return web.json_response(await qos.fleet_snapshot(request.app[DB]))


async def slo_report(request: web.Request) -> web.Response:
    """Live SLO burn-rate report (obs/slo.py): every objective windowed
    fast/slow, plus bounded exemplars whose trace_ids resolve through
    GET /api/jobs/{id}/trace. Evaluates on demand so the report is
    always current even when the background eval loop is disabled."""
    from vlog_tpu_torch.obs import slo as slomod

    return web.json_response(
        await slomod.plane().evaluate(request.app[DB]))


async def send_worker_command(request: web.Request) -> web.Response:
    """Queue a management command; the worker answers on its next
    heartbeat tick (reference admin.py:5164-5290 remote worker RPC)."""
    from vlog_tpu_torch.jobs import commands as cmds

    body = await request.json()
    try:
        cmd_id = await cmds.send_command(
            request.app[DB], request.match_info["name"],
            str(body.get("command") or ""), body.get("args") or {})
    except ValueError as exc:
        return _json_error(400, str(exc))
    return web.json_response({"command_id": cmd_id}, status=201)


async def list_worker_commands(request: web.Request) -> web.Response:
    from vlog_tpu_torch.jobs import commands as cmds

    rows = await cmds.list_commands(request.app[DB],
                                    request.match_info["name"])
    return web.json_response({"commands": rows})


async def drain_worker(request: web.Request) -> web.Response:
    """Queue a grace-budgeted drain: the worker stops claiming, finishes
    or checkpoints in-flight work, releases its claims, and exits —
    operators evacuate a host without shelling into it. Sugar over the
    command channel (jobs/commands): the worker's next heartbeat tick
    picks the ``drain`` command up via ``drain_for_worker``."""
    from vlog_tpu_torch.jobs import commands as cmds

    try:
        cmd_id = await cmds.send_command(
            request.app[DB], request.match_info["name"], "drain", {})
    except ValueError as exc:
        return _json_error(400, str(exc))
    return web.json_response({"command_id": cmd_id, "command": "drain"},
                             status=201)


async def profile_worker(request: web.Request) -> web.Response:
    """Queue an on-demand device-profiling session on a worker. Sugar
    over the command channel like :func:`drain_worker`: the worker's
    next heartbeat tick dispatches to ``mgmt.profile`` →
    obs/profiler.py (duration-bounded, exclusive, artifacts under
    VLOG_PROFILE_DIR). Body: ``{action?: start|stop|status,
    duration_s?, label?}``; the session result lands on the command row
    (GET /api/workers/{name}/commands)."""
    from vlog_tpu_torch.jobs import commands as cmds

    try:
        body = await request.json()
    except Exception:   # noqa: BLE001 — empty body = default start
        body = {}
    args = {"action": str(body.get("action", "start") or "start")}
    if body.get("duration_s") is not None:
        args["duration_s"] = body["duration_s"]
    if body.get("label"):
        args["label"] = str(body["label"])
    try:
        cmd_id = await cmds.send_command(
            request.app[DB], request.match_info["name"], "profile", args)
    except ValueError as exc:
        return _json_error(400, str(exc))
    return web.json_response(
        {"command_id": cmd_id, "command": "profile", "args": args},
        status=201)


async def revoke_worker(request: web.Request) -> web.Response:
    db = request.app[DB]
    name = request.match_info["name"]
    n = await authmod.revoke_keys(db, name)
    await db.execute("UPDATE workers SET status='revoked' WHERE name=:n",
                     {"n": name})
    return web.json_response({"ok": True, "keys_revoked": n})


async def get_chapters(request: web.Request) -> web.Response:
    db = request.app[DB]
    rows = await db.fetch_all(
        "SELECT start_s, title, source FROM chapters WHERE video_id=:v "
        "ORDER BY start_s", {"v": _path_id(request, "video_id")})
    return web.json_response({"chapters": rows})


async def put_chapters(request: web.Request) -> web.Response:
    """Replace a video's chapter list (reference admin.py chapters CRUD)."""
    db = request.app[DB]
    video = await vids.get_video(db, _path_id(request, "video_id"))
    if video is None:
        return _json_error(404, "no such video")
    body = await request.json()
    chapters = body.get("chapters") or []
    for ch in chapters:
        if not isinstance(ch.get("title"), str) or \
                not isinstance(ch.get("start_s"), (int, float)) or \
                ch["start_s"] < 0:
            return _json_error(400, "each chapter needs title + start_s>=0")
    t = db_now()
    async with db.transaction() as tx:
        await tx.execute("DELETE FROM chapters WHERE video_id=:v",
                         {"v": video["id"]})
        for ch in chapters:
            await tx.execute(
                """
                INSERT INTO chapters (video_id, start_s, title, source,
                                      created_at)
                VALUES (:v, :s, :title, :src, :t)
                """,
                {"v": video["id"], "s": float(ch["start_s"]),
                 "title": ch["title"][:200],
                 "src": ch.get("source", "manual"), "t": t})
    return web.json_response({"ok": True, "count": len(chapters)})


async def detect_chapters(request: web.Request) -> web.Response:
    """Auto-detect: container chapter atoms first, else transcript
    silence heuristics (reference admin.py:8391 auto-detect)."""
    from vlog_tpu_torch.media.chapters import (parse_mp4_chapters,
                                         suggest_from_transcript)

    db = request.app[DB]
    video = await vids.get_video(db, _path_id(request, "video_id"))
    if video is None:
        return _json_error(404, "no such video")
    found = []
    src = video["source_path"]
    if src and Path(src).exists() and Path(src).suffix.lower() == ".mp4":
        try:
            found = await asyncio.to_thread(parse_mp4_chapters, src)
        except Exception:  # noqa: BLE001 — malformed atoms just mean none
            found = []
    if not found:
        tr = await db.fetch_one(
            "SELECT vtt_path FROM transcriptions WHERE video_id=:v "
            "AND status='completed'", {"v": video["id"]})
        if tr and tr["vtt_path"] and Path(tr["vtt_path"]).exists():
            text = await asyncio.to_thread(Path(tr["vtt_path"]).read_text)
            found = suggest_from_transcript(_parse_vtt_cues(text))
    return web.json_response({"chapters": [
        {"start_s": round(c.start_s, 3), "title": c.title,
         "source": c.source} for c in found]})


def _parse_vtt_cues(text: str) -> list[dict]:
    cues = []
    for block in text.split("\n\n"):
        lines = [ln for ln in block.strip().splitlines() if ln]
        if len(lines) < 2 or "-->" not in lines[0]:
            continue
        start, _, end = lines[0].partition("-->")

        def secs(ts: str) -> float:
            parts = ts.strip().split(":")
            out = 0.0
            for p in parts:
                out = out * 60 + float(p)
            return out

        cues.append({"start_s": secs(start), "end_s": secs(end),
                     "text": " ".join(lines[1:])})
    return cues


async def analytics_summary(request: web.Request) -> web.Response:
    """Per-video playback totals (reference analytics routes,
    admin.py:3751-4159 condensed to the load-bearing numbers)."""
    db = request.app[DB]
    rows = await db.fetch_all(
        """
        SELECT v.id, v.slug, v.title,
               COUNT(s.id) AS sessions,
               COALESCE(SUM(s.watch_time_s), 0) AS watch_time_s,
               COUNT(CASE WHEN s.ended_at IS NULL
                          AND s.last_heartbeat_at > :live_cut
                     THEN 1 END) AS live_now
        FROM videos v
        LEFT JOIN playback_sessions s ON s.video_id = v.id
        WHERE v.deleted_at IS NULL
        GROUP BY v.id ORDER BY watch_time_s DESC LIMIT 200
        """, {"live_cut": db_now() - 120.0})
    return web.json_response({"videos": rows})


async def analytics_months(request: web.Request) -> web.Response:
    """Per-month session volume (jobs/sessions.py month_stats — the
    reference's partition-stats analog) plus maintenance knobs."""
    from vlog_tpu_torch.jobs import sessions as sess

    months = _qnum(request.query, "months", 12, lo=1, hi=36)
    stats = await sess.month_stats(request.app[DB], months=months)
    return web.json_response({
        "months": stats,
        "retention_days": sess.RETENTION_DAYS,
    })


async def analytics_prune(request: web.Request) -> web.Response:
    """POST: run session maintenance now (close stale + prune)."""
    from vlog_tpu_torch.jobs import sessions as sess

    db = request.app[DB]
    closed = await sess.close_stale_sessions(db)
    pruned = await sess.prune_sessions(db)
    return web.json_response({"ok": True, "closed": closed,
                              "pruned": pruned})


async def healthz(request: web.Request) -> web.Response:
    return web.json_response({"ok": True, "db": request.app[DB].connected})


# --------------------------------------------------------------------------
# Delivery plane (delivery/): cache stats + operator invalidation.
# Planes register per process, so these see every plane co-hosted with
# this admin app (the single-process dev/test topology). In a split
# deployment the public process exposes its own counters on
# :9000/metrics and converges via the TTL windows — publish state and
# manifests always; segment bodies only when the operator sets
# VLOG_DELIVERY_SEGMENT_TTL (they are pinned by default).
# --------------------------------------------------------------------------

async def delivery_stats(request: web.Request) -> web.Response:
    from vlog_tpu_torch import delivery

    return web.json_response(delivery.stats_snapshot())


async def delivery_invalidate(request: web.Request) -> web.Response:
    """Evict delivery caches: body ``{"slug": "..."}`` for one video,
    ``{"all": true}`` for everything (post-restore-from-backup, rsync'd
    trees, any mutation the hooks can't see)."""
    from vlog_tpu_torch import delivery

    body = await request.json() if request.can_read_body else {}
    slug = (body.get("slug") or "").strip()
    if not slug and not body.get("all"):
        return _json_error(400, "need slug or all:true")
    if body.get("all"):
        dropped = delivery.invalidate_all()
        target = "*"
    else:
        dropped = delivery.invalidate_slug(slug)
        target = slug
    audit = request.app.get(AUDIT)
    if audit is not None:
        audit.record("delivery.invalidated", target=target,
                     entries_dropped=dropped)
    return web.json_response({"ok": True, "target": target,
                              "entries_dropped": dropped})


# --------------------------------------------------------------------------
# App assembly
# --------------------------------------------------------------------------

@web.middleware
async def admin_error_middleware(request: web.Request, handler):
    """An authed operator gets real 4xx validation text, but an
    unexpected 500's repr must still not leak paths into a browser
    (api/errors.py; reference sanitizes at the same tier)."""
    from vlog_tpu_torch.api.errors import sanitize_error

    try:
        return await handler(request)
    except web.HTTPException:
        raise
    except Exception as exc:   # noqa: BLE001 — boundary sanitizer
        log.exception("unhandled admin error rid=%s on %s %s",
                      request.get("request_id", "-"), request.method,
                      request.path)
        return _json_error(500, sanitize_error(exc))


def build_admin_app(db: Database, *, upload_dir: Path | None = None,
                    video_dir: Path | None = None,
                    audit_path: Path | str | None = None,
                    device: str = "cuda") -> web.Application:
    """The admin app. ``device`` is where the thumbnail grab resizes
    (``"cuda"``: the card, or a 422 naming the CUDA error where there is
    none; only tests pass ``"cpu"``)."""
    from vlog_tpu_torch.api.errors import request_id_middleware

    app = web.Application(middlewares=[request_id_middleware,
                                       admin_error_middleware,
                                       admin_auth_middleware],
                          client_max_size=config.MAX_UPLOAD_SIZE_BYTES)
    app[DB] = db
    app[UPLOAD_DIR] = Path(upload_dir or config.UPLOAD_DIR)
    app[VIDEO_DIR] = Path(video_dir or config.VIDEO_DIR)
    app[SETTINGS] = SettingsService(db)
    r = app.router
    r.add_post("/api/videos", upload_video)
    r.add_get("/api/videos", list_videos)
    r.add_get("/api/videos/{video_id:\\d+}", video_detail)
    r.add_post("/api/videos/{video_id:\\d+}/retranscode", retranscode)
    r.add_post("/api/videos/{video_id:\\d+}/reencode", reencode)
    r.add_post("/api/videos/{video_id:\\d+}/manifests/regenerate",
               regenerate_manifests)
    r.add_get("/api/jobs", list_jobs)
    r.add_get("/api/jobs/failed", failed_jobs)
    r.add_get("/api/jobs/{job_id:\\d+}/failures", job_failure_history)
    r.add_get("/api/jobs/{job_id:\\d+}/trace", job_trace)
    r.add_post("/api/jobs/{job_id:\\d+}/requeue", requeue_job)
    r.add_get("/api/audit", audit_tail)
    r.add_get("/api/analytics/daily", analytics_daily)
    r.add_delete("/api/videos/{video_id:\\d+}", delete_video)
    r.add_post("/api/videos/{video_id:\\d+}/restore", restore_video)
    r.add_post("/api/videos/{video_id:\\d+}/verify", verify_video)
    r.add_get("/api/storage/status", storage_status)
    r.add_get("/api/storage/gc", storage_gc_report)
    r.add_post("/api/storage/gc", run_storage_gc)
    r.add_get("/api/delivery/stats", delivery_stats)
    r.add_post("/api/delivery/invalidate", delivery_invalidate)
    r.add_get("/api/events/progress", sse_progress)
    r.add_get("/api/settings", get_settings)
    r.add_put("/api/settings/{key}", put_setting)
    r.add_delete("/api/settings/{key}", delete_setting)
    r.add_get("/api/webhooks", list_webhooks)
    r.add_post("/api/webhooks", create_webhook)
    r.add_get("/api/webhooks/{webhook_id:\\d+}/deliveries",
              webhook_deliveries)
    r.add_delete("/api/webhooks/{webhook_id:\\d+}", delete_webhook)
    r.add_get("/api/workers", list_workers)
    r.add_get("/api/fleet/scale-hint", fleet_scale_hint)
    r.add_get("/api/slo", slo_report)
    r.add_post("/api/workers/{name}/revoke", revoke_worker)
    r.add_post("/api/workers/{name}/drain", drain_worker)
    r.add_post("/api/workers/{name}/profile", profile_worker)
    r.add_post("/api/workers/{name}/command", send_worker_command)
    r.add_get("/api/workers/{name}/commands", list_worker_commands)
    r.add_get("/api/videos/{video_id:\\d+}/chapters", get_chapters)
    r.add_put("/api/videos/{video_id:\\d+}/chapters", put_chapters)
    r.add_post("/api/videos/{video_id:\\d+}/chapters/detect",
               detect_chapters)
    r.add_get("/api/analytics/summary", analytics_summary)
    r.add_get("/api/analytics/sessions/months", analytics_months)
    r.add_post("/api/analytics/sessions/prune", analytics_prune)
    r.add_post("/api/auth/login", login)
    r.add_post("/api/auth/logout", logout)
    r.add_get("/api/auth/session", session_info)
    r.add_get("/healthz", healthz)
    # catalog long tail: playlists, custom fields, thumbnails,
    # transcripts, bulk ops (api/catalog.py)
    from vlog_tpu_torch.api.catalog import Thumbnailer, mount as mount_catalog

    mount_catalog(r)
    app[THUMBNAILER] = Thumbnailer(device)
    from vlog_tpu_torch.web import attach_ui

    attach_ui(app, "admin")
    if audit_path is not None:
        from vlog_tpu_torch.api.audit import AuditLog

        app[AUDIT] = AuditLog(audit_path)
    return app


async def serve(port: int | None = None, db_url: str | None = None,
                host: str | None = None) -> None:
    from vlog_tpu_torch.db.schema import create_all

    config.ensure_dirs()
    db = open_database(db_url or config.DATABASE_URL)
    await db.connect()
    await create_all(db)
    app = build_admin_app(
        db, audit_path=Path(config.BASE_DIR) / "audit" / "admin.log")
    if host is None:
        host = "0.0.0.0" if config.ADMIN_SECRET else "127.0.0.1"
    if not config.ADMIN_SECRET and host not in ("127.0.0.1", "::1",
                                                "localhost"):
        raise SystemExit(
            "refusing to bind admin API beyond loopback with no "
            "VLOG_ADMIN_SECRET set")
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, host, port or config.ADMIN_PORT)
    await site.start()
    log.info("admin API listening on %s:%d", host, port or config.ADMIN_PORT)
    # The admin process hosts the webhook delivery worker (reference
    # webhook_service.py:809: background task in the API process).
    from vlog_tpu_torch.jobs.webhooks import WebhookDeliverer

    deliverer = WebhookDeliverer(db)
    delivery_task = asyncio.create_task(deliverer.run())
    maintenance_task = asyncio.create_task(_session_maintenance_loop(db))
    gc_task = asyncio.create_task(_gc_loop(
        db, video_dir=app[VIDEO_DIR], upload_dir=app[UPLOAD_DIR]))
    # tenant-aware queue-depth alerting (VLOG_QOS_ALERT_QUEUED=0
    # disables inside the check itself; the loop stays cheap)
    alert_task = asyncio.create_task(alertsmod.queue_depth_loop(
        db, alertsmod.AlertSink()))
    # SLO burn-rate evaluation + alerting (VLOG_SLO_EVAL_S=0 disables;
    # GET /api/slo still evaluates on demand)
    from vlog_tpu_torch.obs import slo as slomod

    slo_task = asyncio.create_task(slomod.eval_loop(
        db, alertsmod.AlertSink()))
    try:
        await asyncio.Event().wait()
    finally:
        deliverer.request_stop()
        delivery_task.cancel()
        maintenance_task.cancel()
        gc_task.cancel()
        alert_task.cancel()
        slo_task.cancel()
        await asyncio.gather(delivery_task, maintenance_task, gc_task,
                             alert_task, slo_task, return_exceptions=True)
        await runner.cleanup()
        await db.disconnect()


async def _gc_loop(db: Database, *, video_dir: Path, upload_dir: Path,
                   interval_s: float | None = None) -> None:
    """Periodic orphan-GC sweep (storage/gc.py) in the admin process —
    the one process that always runs and owns the storage tree. The
    dirs come from the app (serve passes app[VIDEO_DIR]/[UPLOAD_DIR]),
    not config globals, so an embedder's overrides are honored.
    VLOG_GC_INTERVAL=0 disables (the admin trigger endpoint remains)."""
    from vlog_tpu_torch.storage import gc as storage_gc

    interval = config.GC_INTERVAL_S if interval_s is None else interval_s
    if interval <= 0:
        return
    while True:
        await asyncio.sleep(interval)
        try:
            await storage_gc.run_gc(db, video_dir=video_dir,
                                    upload_dir=upload_dir)
        except Exception:   # noqa: BLE001 — next pass retries
            log.exception("gc sweep failed")


async def _session_maintenance_loop(db: Database,
                                    interval_s: float = 3600.0) -> None:
    """Hourly analytics upkeep (reference partition_manager's cron
    analog): close heartbeat-dead sessions, prune past retention."""
    from vlog_tpu_torch.jobs import sessions as sess

    while True:
        try:
            await sess.close_stale_sessions(db)
            await sess.prune_sessions(db)
        except Exception:   # noqa: BLE001 — next pass retries
            log.exception("session maintenance pass failed")
        await asyncio.sleep(interval_s)


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    asyncio.run(serve())


if __name__ == "__main__":
    main()
