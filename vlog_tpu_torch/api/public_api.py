"""Public API (:9000): browse, playback, captions, analytics (a copy of
``vlog_tpu/api/public_api.py`` over the port's job plane and delivery
plane; the same 18 routes).

Reference parity: api/public.py — video list/search/detail (916-1331),
transcript (1399), playback analytics session/heartbeat/end (2521-2660),
and the custom static file serving with HLS/DASH MIME types
(docs/ARCHITECTURE.md:59-62 ``HLSStaticFiles``). Read-only over the same
database the admin/worker planes write; only ready, non-deleted videos
are visible.

Run it: ``python -m vlog_tpu_torch.api.public_api``.
"""

from __future__ import annotations

import asyncio
import logging
import secrets
from pathlib import Path

from aiohttp import web

from vlog_tpu_torch import config
from vlog_tpu_torch.db.core import Database, now as db_now, open_database
from vlog_tpu_torch.jobs import videos as vids

log = logging.getLogger("vlog_tpu_torch.public_api")

DB = web.AppKey("db", Database)
VIDEO_DIR = web.AppKey("video_dir", Path)
DELIVERY = web.AppKey("delivery", object)

_PUBLIC_VIDEO_FIELDS = ("id", "slug", "title", "description", "duration_s",
                        "width", "height", "fps", "status", "category",
                        "tags", "created_at")


def _json_error(status: int, message: str) -> web.Response:
    return web.json_response({"error": message}, status=status)


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


def _public_video(row: dict) -> dict:
    import json as _json

    out = {k: row[k] for k in _PUBLIC_VIDEO_FIELDS}
    out["tags"] = _json.loads(row["tags"] or "[]")
    out["stream_url"] = f"/videos/{row['slug']}/master.m3u8"
    out["dash_url"] = f"/videos/{row['slug']}/manifest.mpd"
    out["thumbnail_url"] = (f"/videos/{row['slug']}/thumbnail.jpg"
                            if row["thumbnail_path"] else None)
    out["sprites_url"] = f"/videos/{row['slug']}/sprites/sprites.vtt"
    out["captions_url"] = f"/videos/{row['slug']}/captions.vtt"
    return out


READY = "status='ready' AND deleted_at IS NULL"


async def list_videos(request: web.Request) -> web.Response:
    """Browse listing. Two pagination modes (reference pagination.py):
    classic limit/offset, and keyset via ``cursor`` (the token from a
    previous page's ``next_cursor``) — O(page) however deep, stable
    under concurrent publishes. Cursor mode ignores ``offset``."""
    from vlog_tpu_torch.api.pagination import (
        CursorError,
        decode_cursor,
        keyset_clause,
        next_cursor_from,
    )

    db = request.app[DB]
    q = request.query
    limit = _qnum(q, "limit", 24, lo=1, hi=100)
    offset = _qnum(q, "offset", 0, lo=0)
    where = [READY]
    params: dict = {"limit": limit, "offset": offset}
    if q.get("q"):
        where.append("(title LIKE :pat OR description LIKE :pat)")
        params["pat"] = f"%{q['q']}%"
    if q.get("category"):
        where.append("category=:cat")
        params["cat"] = q["category"]
    base_where = list(where)        # total counts the whole listing,
    base_params = {k: v for k, v in params.items()
                   if k not in ("limit", "offset")}
    if q.get("cursor"):             # ...the cursor only scopes the page
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
    return web.json_response({
        "videos": [_public_video(r) for r in rows],
        "total": total, "limit": limit, "offset": offset,
        "next_cursor": next_cursor_from(rows, limit)})


async def video_detail(request: web.Request) -> web.Response:
    db = request.app[DB]
    row = await vids.get_video_by_slug(db, request.match_info["slug"])
    if row is None or row["status"] != "ready" or row["deleted_at"]:
        return _json_error(404, "no such video")
    quals = await db.fetch_all(
        "SELECT name, width, height, video_bitrate, audio_bitrate, codec "
        "FROM video_qualities WHERE video_id=:v ORDER BY height DESC",
        {"v": row["id"]})
    chapters = await db.fetch_all(
        "SELECT start_s, title FROM chapters WHERE video_id=:v "
        "ORDER BY start_s", {"v": row["id"]})
    out = _public_video(row)
    out["qualities"] = quals
    out["chapters"] = chapters
    return web.json_response({"video": out})


async def transcript(request: web.Request) -> web.Response:
    db = request.app[DB]
    row = await vids.get_video_by_slug(db, request.match_info["slug"])
    if row is None or row["deleted_at"]:
        return _json_error(404, "no such video")
    tr = await db.fetch_one(
        "SELECT language, model, full_text, status, vtt_path "
        "FROM transcriptions WHERE video_id=:v", {"v": row["id"]})
    if tr is None or tr["status"] != "completed":
        return _json_error(404, "no transcript")
    return web.json_response({
        "language": tr["language"], "model": tr["model"],
        "text": tr["full_text"],
        "vtt_url": f"/videos/{row['slug']}/captions.vtt"})


async def categories(request: web.Request) -> web.Response:
    rows = await request.app[DB].fetch_all(
        f"""
        SELECT category, COUNT(*) AS n FROM videos
        WHERE {READY} AND category IS NOT NULL
        GROUP BY category ORDER BY n DESC
        """)
    return web.json_response({"categories": rows})


# --------------------------------------------------------------------------
# Playback analytics (public.py:2521-2660)
# --------------------------------------------------------------------------

async def start_session(request: web.Request) -> web.Response:
    db = request.app[DB]
    row = await vids.get_video_by_slug(db, request.match_info["slug"])
    if row is None:
        return _json_error(404, "no such video")
    token = secrets.token_urlsafe(24)
    t = db_now()
    await db.execute(
        """
        INSERT INTO playback_sessions (video_id, session_token, started_at,
                                       last_heartbeat_at)
        VALUES (:v, :tok, :t, :t)
        """, {"v": row["id"], "tok": token, "t": t})
    return web.json_response({"session": token}, status=201)


async def session_heartbeat(request: web.Request) -> web.Response:
    body = await request.json()
    n = await request.app[DB].execute(
        """
        UPDATE playback_sessions
        SET last_heartbeat_at=:t, watch_time_s=:w
        WHERE session_token=:tok AND ended_at IS NULL
        """,
        {"t": db_now(), "tok": str(body.get("session") or ""),
         "w": float(body.get("watch_time_s") or 0.0)})
    if not n:
        return _json_error(404, "no live session")
    return web.json_response({"ok": True})


async def end_session(request: web.Request) -> web.Response:
    body = await request.json()
    db = request.app[DB]
    n = await db.execute(
        f"""
        UPDATE playback_sessions
        SET ended_at=:t, watch_time_s={db.greatest('watch_time_s', ':w')}
        WHERE session_token=:tok AND ended_at IS NULL
        """,
        {"t": db_now(), "tok": str(body.get("session") or ""),
         "w": float(body.get("watch_time_s") or 0.0)})
    return web.json_response({"ok": True, "ended": bool(n)})


# --------------------------------------------------------------------------
# Discovery: related videos, tags, playlists (public.py:1498-1991)
# --------------------------------------------------------------------------

async def related_videos(request: web.Request) -> web.Response:
    """Same-category + shared-tag scoring, newest first within score
    (reference public.py:1498 related_videos)."""
    import json as _json

    db = request.app[DB]
    row = await vids.get_video_by_slug(db, request.match_info["slug"])
    if row is None or row["status"] != "ready" or row["deleted_at"]:
        return _json_error(404, "no such video")
    limit = _qnum(request.query, "limit", 12, lo=1, hi=50)
    tags = set(_json.loads(row["tags"] or "[]"))
    candidates = await db.fetch_all(
        f"""
        SELECT * FROM videos
        WHERE {READY} AND id != :id
        ORDER BY created_at DESC LIMIT 500
        """, {"id": row["id"]})
    scored = []
    for c in candidates:
        score = 0
        if row["category"] and c["category"] == row["category"]:
            score += 2
        score += len(tags & set(_json.loads(c["tags"] or "[]")))
        if score:
            scored.append((score, c["created_at"], c))
    scored.sort(key=lambda s: (-s[0], -s[1]))
    out = [_public_video(c) for _, _, c in scored[:limit]]
    if len(out) < limit:
        # back-fill with recency so the rail is never empty
        seen = {v["id"] for v in out} | {row["id"]}
        for c in candidates:
            if c["id"] not in seen:
                out.append(_public_video(c))
                if len(out) >= limit:
                    break
    return web.json_response({"videos": out})


async def tags(request: web.Request) -> web.Response:
    """Tag cloud: every tag on a ready video with its count
    (public.py:1636 tags browsing). Scans only the tags column of the
    newest 5000 videos — bounded work per unauthenticated request."""
    import json as _json
    from collections import Counter

    rows = await request.app[DB].fetch_all(
        f"SELECT tags FROM videos WHERE {READY} "
        "ORDER BY created_at DESC LIMIT 5000")
    counts = Counter(t for r in rows
                     for t in _json.loads(r["tags"] or "[]"))
    return web.json_response({"tags": [
        {"tag": t, "count": n} for t, n in counts.most_common(200)]})


async def videos_by_tag(request: web.Request) -> web.Response:
    import json as _json

    tag = request.match_info["tag"]
    limit = _qnum(request.query, "limit", 24, lo=1, hi=100)
    offset = _qnum(request.query, "offset", 0, lo=0)
    # SQL prefilter on the JSON text (tags are a JSON string array), then
    # exact membership in Python over a bounded candidate set
    rows = await request.app[DB].fetch_all(
        f"""
        SELECT * FROM videos WHERE {READY} AND tags LIKE :pat
        ORDER BY created_at DESC LIMIT 500
        """, {"pat": f'%"{tag}"%'})
    hits = [r for r in rows if tag in _json.loads(r["tags"] or "[]")]
    page = hits[offset:offset + limit]
    return web.json_response({
        "videos": [_public_video(r) for r in page],
        "total": len(hits), "limit": limit, "offset": offset})


async def public_playlists(request: web.Request) -> web.Response:
    rows = await request.app[DB].fetch_all(
        """
        SELECT p.slug, p.title, p.description, p.updated_at,
               COUNT(v.id) AS video_count
        FROM playlists p
        LEFT JOIN playlist_items i ON i.playlist_id = p.id
        LEFT JOIN videos v ON v.id = i.video_id
             AND v.status = 'ready' AND v.deleted_at IS NULL
        WHERE p.visibility = 'public'
        GROUP BY p.id ORDER BY p.updated_at DESC LIMIT 100
        """)
    return web.json_response({"playlists": rows})


async def public_playlist_detail(request: web.Request) -> web.Response:
    db = request.app[DB]
    row = await db.fetch_one(
        "SELECT * FROM playlists WHERE slug=:s AND visibility IN "
        "('public','unlisted')", {"s": request.match_info["plslug"]})
    if row is None:
        return _json_error(404, "no such playlist")
    items = await db.fetch_all(
        f"""
        SELECT v.* FROM playlist_items i
        JOIN videos v ON v.id = i.video_id
        WHERE i.playlist_id = :p AND {READY.replace('status', 'v.status')
                                      .replace('deleted_at', 'v.deleted_at')}
        ORDER BY i.position
        """, {"p": row["id"]})
    return web.json_response({
        "playlist": {k: row[k] for k in
                     ("slug", "title", "description", "updated_at")},
        "videos": [_public_video(v) for v in items]})


async def display_config(request: web.Request) -> web.Response:
    """Player/display knobs the SPA reads at boot (public.py:1992-2258:
    watermark + display config, served from the settings table)."""
    svc = request.app.get(SETTINGS_SVC)
    cfg = {
        "site_title": "vlog",
        "watermark": {"enabled": False, "text": "", "position":
                      "bottom-right", "opacity": 0.5},
        "player": {"autoplay": False, "default_quality": "auto",
                   "downloads_enabled": config.DOWNLOADS_ENABLED},
        "theme": {"accent": "#3b82f6"},
    }
    if svc is not None:
        for key in ("site_title",):
            v = await svc.get(f"display.{key}")
            if v is not None:
                cfg[key] = v
        for section in ("watermark", "player", "theme"):
            for k in list(cfg[section]):
                v = await svc.get(f"display.{section}.{k}")
                if v is not None:
                    cfg[section][k] = v
    return web.json_response(cfg)


SETTINGS_SVC = web.AppKey("settings_svc", object)


# --------------------------------------------------------------------------
# Media serving through the delivery plane (delivery/): publish-state
# cache + byte-bounded segment cache + single-flight + admission, with
# conditional/range/CORS semantics built from cached buffers. A steady-
# state hit performs zero DB queries and zero disk opens.
# --------------------------------------------------------------------------

def _media_error(status: int, message: str) -> web.Response:
    """Media-route errors carry CORS too: a cross-origin player must be
    able to SEE the 403/404/503, not get an opaque CORS failure."""
    from vlog_tpu_torch.delivery.http import CORS_HEADERS

    return web.json_response({"error": message}, status=status,
                             headers=CORS_HEADERS)


async def media_preflight(request: web.Request) -> web.Response:
    from vlog_tpu_torch.delivery import http as delivery_http

    return delivery_http.preflight_response()


async def serve_media(request: web.Request) -> web.StreamResponse:
    from vlog_tpu_torch import delivery
    from vlog_tpu_torch.delivery import http as delivery_http

    slug = request.match_info["slug"]
    tail = request.match_info["tail"]
    plane: delivery.DeliveryPlane = request.app[DELIVERY]
    rel = Path(tail)
    if rel.is_absolute() or ".." in rel.parts or len(rel.parts) > 4:
        return _media_error(400, "bad path")
    # Only published videos serve media: a mid-transcode tree (status
    # pending/processing) must not leak through guessable slugs. The
    # publish-state cache answers this without touching the DB.
    state = await plane.serving_state(slug)
    if state.status != "ready":
        return _media_error(404, "no such video")
    if rel.parts and rel.parts[0].startswith("original"):
        # downloads of the source are gated (reference config.py:602-616)
        if not config.DOWNLOADS_ENABLED:
            return _media_error(403, "downloads disabled")
    # a request already carrying the peer-fill header IS a peer fill
    # from another origin: answer from local tiers only, never re-enter
    # the ring (a misconfigured ring must not chase ownership in a loop)
    allow_peer = delivery.PEER_FILL_HEADER not in request.headers
    # the fill-token correlates this request with a fill already in
    # flight fleet-wide: passing it through lets the plane count the
    # coalesce (flash crowd -> one origin disk read)
    fill_token = request.headers.get(delivery.FILL_TOKEN_HEADER)
    try:
        got = await plane.fetch(slug, tail, allow_peer=allow_peer,
                                fill_token=fill_token)
    except delivery.LoadShedError as exc:
        resp = _media_error(503, "origin overloaded, retry shortly")
        resp.headers["Retry-After"] = str(exc.retry_after_s)
        return resp
    except (FileNotFoundError, delivery.MediaEscapeError):
        # a symlink escape reports like any missing file: revealing
        # "exists but refused" would leak tree shape
        return _media_error(404, "not found")
    # CacheEntry buffers from RAM; FileEntry (large-object bypass, big
    # L2 hits) streams zero-copy — one state machine for both, so all
    # four serve paths emit identical validators and bytes
    return delivery_http.entry_response(request, got)


async def delivery_gossip(request: web.Request) -> web.Response:
    """The gossip heartbeat endpoint: answering 200 from the same app
    that serves media makes 'the heartbeat answers' and 'the origin can
    serve' one fact. The response is this origin's membership snapshot
    (version + per-peer state), which the prober merges; the sender
    header marks the caller alive here in the same exchange."""
    from vlog_tpu_torch import delivery

    plane: delivery.DeliveryPlane = request.app[DELIVERY]
    sender = request.headers.get(delivery.GOSSIP_FROM_HEADER)
    if sender:
        plane.membership.heard_from(sender)
    return web.json_response(plane.membership.snapshot())


async def metrics_endpoint(request: web.Request) -> web.Response:
    """Prometheus view of this serving process (the delivery counters
    live here, not in the admin process — scrape :9000/metrics)."""
    from vlog_tpu_torch.obs.metrics import runtime

    return web.Response(text=runtime().render_text(),
                        content_type="text/plain")


async def healthz(request: web.Request) -> web.Response:
    return web.json_response({"ok": True, "db": request.app[DB].connected})


@web.middleware
async def error_middleware(request: web.Request, handler):
    """Unexpected exceptions become sanitized 500s (api/errors.py):
    the truth goes to the log, the client gets no paths/database detail.
    HTTPException subclasses (the framework's own 404s etc.) pass."""
    from vlog_tpu_torch.api.errors import sanitize_error

    try:
        return await handler(request)
    except web.HTTPException:
        raise
    except Exception as exc:   # noqa: BLE001 — boundary sanitizer
        log.exception("unhandled error rid=%s on %s %s",
                      request.get("request_id", "-"), request.method,
                      request.path)
        return _json_error(500, sanitize_error(exc))


def build_public_app(db: Database, *, video_dir: Path | None = None
                     ) -> web.Application:
    from vlog_tpu_torch.api.settings import SettingsService
    from vlog_tpu_torch.delivery import DeliveryPlane

    from vlog_tpu_torch.api.errors import request_id_middleware

    app = web.Application(middlewares=[request_id_middleware,
                                       error_middleware])
    app[DB] = db
    app[VIDEO_DIR] = Path(video_dir or config.VIDEO_DIR)
    app[DELIVERY] = DeliveryPlane(db, app[VIDEO_DIR])
    app[SETTINGS_SVC] = SettingsService(db)

    async def _start_gossip(app: web.Application) -> None:
        app[DELIVERY].start_gossip()

    async def _close_delivery(app: web.Application) -> None:
        await app[DELIVERY].close()

    app.on_startup.append(_start_gossip)
    app.on_cleanup.append(_close_delivery)
    r = app.router
    r.add_get("/api/videos", list_videos)
    r.add_get("/api/videos/{slug}", video_detail)
    r.add_get("/api/videos/{slug}/transcript", transcript)
    r.add_get("/api/videos/{slug}/related", related_videos)
    r.add_get("/api/categories", categories)
    r.add_get("/api/tags", tags)
    r.add_get("/api/tags/{tag}/videos", videos_by_tag)
    r.add_get("/api/playlists", public_playlists)
    r.add_get("/api/playlists/{plslug}", public_playlist_detail)
    r.add_get("/api/config", display_config)
    r.add_post("/api/videos/{slug}/session", start_session)
    r.add_post("/api/sessions/heartbeat", session_heartbeat)
    r.add_post("/api/sessions/end", end_session)
    r.add_get("/videos/{slug}/{tail:.+}", serve_media)   # GET + HEAD
    r.add_route("OPTIONS", "/videos/{slug}/{tail:.+}", media_preflight)
    r.add_get("/api/delivery/gossip", delivery_gossip)
    r.add_get("/metrics", metrics_endpoint)
    r.add_get("/healthz", healthz)
    from vlog_tpu_torch.web import attach_ui

    attach_ui(app, "public")
    return app


async def serve(port: int | None = None, db_url: str | None = None,
                host: str = "0.0.0.0") -> None:
    from vlog_tpu_torch.db.schema import create_all

    config.ensure_dirs()
    db = open_database(db_url or config.DATABASE_URL)
    await db.connect()
    await create_all(db)
    app = build_public_app(db)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, host, port or config.PUBLIC_PORT)
    await site.start()
    log.info("public API listening on %s:%d", host,
             port or config.PUBLIC_PORT)
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
