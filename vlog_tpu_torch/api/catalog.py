"""Catalog management: playlists, custom fields, thumbnails, transcripts
(a copy of ``vlog_tpu/api/catalog.py``; the thumbnail grab resizes
through the port's ``TorchBackend`` on the admin app's device).

Reference parity for the admin long tail VERDICT round-3 called out:

- playlists CRUD + membership/ordering (admin.py:7534-8056)
- custom metadata fields + per-video values (admin.py:6688-7533)
- thumbnail management: pick a frame time or upload an image
  (admin.py:2173-2498)
- transcript CRUD: read/replace/delete the stored transcription
  (admin.py:3568-3750)

Handlers are mounted into the admin app by
``vlog_tpu_torch.api.admin_api.build_admin_app``; the public read side
(playlist browsing, related videos, tags) lives in public_api.py.
"""

from __future__ import annotations

import asyncio
import json
import re
import threading
from pathlib import Path

from aiohttp import web

from vlog_tpu_torch.db.core import Database, now as db_now  # noqa: F401
# AppKeys are identity-keyed: reuse admin_api's instances (admin_api only
# imports this module inside build_admin_app, so there is no cycle)
from vlog_tpu_torch.api.admin_api import DB, THUMBNAILER, VIDEO_DIR, _path_id
from vlog_tpu_torch.enums import JobKind, VideoStatus
from vlog_tpu_torch.jobs import claims, qos, state as js, videos as vids


def _json_error(status: int, message: str) -> web.Response:
    return web.json_response({"error": message}, status=status)


def _slugify(title: str) -> str:
    s = re.sub(r"[^a-z0-9]+", "-", title.lower()).strip("-")
    return s or "untitled"


async def _unique_playlist_slug(db: Database, title: str) -> str:
    base = _slugify(title)
    slug, n = base, 2
    while await db.fetch_one(
            "SELECT id FROM playlists WHERE slug=:s", {"s": slug}):
        slug = f"{base}-{n}"
        n += 1
    return slug


# --------------------------------------------------------------------------
# Playlists
# --------------------------------------------------------------------------

async def list_playlists(request: web.Request) -> web.Response:
    rows = await request.app[DB].fetch_all(
        """
        SELECT p.*, COUNT(i.id) AS video_count
        FROM playlists p LEFT JOIN playlist_items i ON i.playlist_id = p.id
        GROUP BY p.id ORDER BY p.updated_at DESC
        """)
    return web.json_response({"playlists": rows})


async def create_playlist(request: web.Request) -> web.Response:
    db = request.app[DB]
    body = await request.json()
    title = str(body.get("title") or "").strip()
    if not title:
        return _json_error(400, "title required")
    visibility = body.get("visibility", "public")
    if visibility not in ("public", "unlisted", "private"):
        return _json_error(400, "bad visibility")
    t = db_now()
    pid = await db.execute(
        """
        INSERT INTO playlists (slug, title, description, visibility,
                               created_at, updated_at)
        VALUES (:s, :t, :d, :v, :now, :now)
        """,
        {"s": await _unique_playlist_slug(db, title), "t": title,
         "d": str(body.get("description") or ""), "v": visibility,
         "now": t})
    row = await db.fetch_one("SELECT * FROM playlists WHERE id=:i",
                             {"i": pid})
    return web.json_response({"playlist": row}, status=201)


async def playlist_detail(request: web.Request) -> web.Response:
    db = request.app[DB]
    pid = _path_id(request, "playlist_id")
    row = await db.fetch_one("SELECT * FROM playlists WHERE id=:i",
                             {"i": pid})
    if row is None:
        return _json_error(404, "no such playlist")
    items = await db.fetch_all(
        """
        SELECT i.position, i.added_at, v.id, v.slug, v.title, v.status,
               v.duration_s
        FROM playlist_items i JOIN videos v ON v.id = i.video_id
        WHERE i.playlist_id = :p ORDER BY i.position
        """, {"p": pid})
    return web.json_response({"playlist": row, "videos": items})


async def update_playlist(request: web.Request) -> web.Response:
    db = request.app[DB]
    pid = _path_id(request, "playlist_id")
    body = await request.json()
    sets, params = ["updated_at=:t"], {"t": db_now(), "i": pid}
    if "title" in body:
        title = str(body["title"]).strip()
        if not title:
            return _json_error(400, "title cannot be empty")
        sets.append("title=:ti")
        params["ti"] = title
    if "description" in body:
        sets.append("description=:d")
        params["d"] = str(body["description"])
    if "visibility" in body:
        if body["visibility"] not in ("public", "unlisted", "private"):
            return _json_error(400, "bad visibility")
        sets.append("visibility=:v")
        params["v"] = body["visibility"]
    n = await db.execute(
        f"UPDATE playlists SET {', '.join(sets)} WHERE id=:i", params)
    if not n:
        return _json_error(404, "no such playlist")
    return web.json_response(
        {"playlist": await db.fetch_one(
            "SELECT * FROM playlists WHERE id=:i", {"i": pid})})


async def delete_playlist(request: web.Request) -> web.Response:
    n = await request.app[DB].execute(
        "DELETE FROM playlists WHERE id=:i",
        {"i": _path_id(request, "playlist_id")})
    if not n:
        return _json_error(404, "no such playlist")
    return web.json_response({"ok": True})


async def playlist_add_video(request: web.Request) -> web.Response:
    db = request.app[DB]
    pid = _path_id(request, "playlist_id")
    body = await request.json()
    vid = body.get("video_id")
    if not isinstance(vid, int):
        return _json_error(400, "video_id (int) required")
    if await db.fetch_one("SELECT id FROM playlists WHERE id=:i",
                          {"i": pid}) is None:
        return _json_error(404, "no such playlist")
    if await db.fetch_one(
            "SELECT id FROM videos WHERE id=:v AND deleted_at IS NULL",
            {"v": vid}) is None:
        return _json_error(404, "no such video")
    t = db_now()
    async with db.transaction() as tx:
        tail = await tx.fetch_one(
            "SELECT COALESCE(MAX(position), -1) AS p FROM playlist_items "
            "WHERE playlist_id=:i", {"i": pid})
        try:
            await tx.execute(
                """
                INSERT INTO playlist_items (playlist_id, video_id,
                                            position, added_at)
                VALUES (:p, :v, :pos, :t)
                """,
                {"p": pid, "v": vid, "pos": tail["p"] + 1, "t": t})
        except Exception:  # noqa: BLE001 — UNIQUE(playlist, video)
            return _json_error(409, "video already in playlist")
        await tx.execute("UPDATE playlists SET updated_at=:t WHERE id=:i",
                         {"t": t, "i": pid})
    return web.json_response({"ok": True}, status=201)


async def playlist_remove_video(request: web.Request) -> web.Response:
    db = request.app[DB]
    pid = _path_id(request, "playlist_id")
    vid = _path_id(request, "video_id")
    n = await db.execute(
        "DELETE FROM playlist_items WHERE playlist_id=:p AND video_id=:v",
        {"p": pid, "v": vid})
    if not n:
        return _json_error(404, "video not in playlist")
    await db.execute("UPDATE playlists SET updated_at=:t WHERE id=:i",
                     {"t": db_now(), "i": pid})
    return web.json_response({"ok": True})


async def playlist_reorder(request: web.Request) -> web.Response:
    """PUT an explicit video-id order; positions are rewritten 0..n-1
    (reference admin.py reorder semantics)."""
    db = request.app[DB]
    pid = _path_id(request, "playlist_id")
    body = await request.json()
    order = body.get("video_ids")
    if (not isinstance(order, list)
            or not all(isinstance(v, int) for v in order)):
        return _json_error(400, "video_ids (list of int) required")
    if await db.fetch_one("SELECT id FROM playlists WHERE id=:i",
                          {"i": pid}) is None:
        return _json_error(404, "no such playlist")
    rows = await db.fetch_all(
        "SELECT video_id FROM playlist_items WHERE playlist_id=:p",
        {"p": pid})
    members = {r["video_id"] for r in rows}
    if members != set(order) or len(order) != len(set(order)):
        return _json_error(400, "video_ids must be a permutation of the "
                                "playlist's current members")
    async with db.transaction() as tx:
        for pos, vid in enumerate(order):
            await tx.execute(
                "UPDATE playlist_items SET position=:pos "
                "WHERE playlist_id=:p AND video_id=:v",
                {"pos": pos, "p": pid, "v": vid})
        await tx.execute("UPDATE playlists SET updated_at=:t WHERE id=:i",
                         {"t": db_now(), "i": pid})
    return web.json_response({"ok": True})


# --------------------------------------------------------------------------
# Custom fields
# --------------------------------------------------------------------------

_FIELD_TYPES = ("text", "number", "boolean", "select", "date", "url")
_NAME_RE = re.compile(r"^[a-z][a-z0-9_]{0,63}$")


async def list_custom_fields(request: web.Request) -> web.Response:
    rows = await request.app[DB].fetch_all(
        "SELECT * FROM custom_fields ORDER BY position, id")
    for r in rows:
        r["options"] = json.loads(r["options"] or "[]")
    return web.json_response({"fields": rows})


async def create_custom_field(request: web.Request) -> web.Response:
    db = request.app[DB]
    body = await request.json()
    name = str(body.get("name") or "")
    if not _NAME_RE.match(name):
        return _json_error(400, "name must be snake_case")
    ftype = body.get("field_type", "text")
    if ftype not in _FIELD_TYPES:
        return _json_error(400, f"field_type must be one of {_FIELD_TYPES}")
    options = body.get("options") or []
    if ftype == "select" and not (
            isinstance(options, list) and options
            and all(isinstance(o, str) for o in options)):
        return _json_error(400, "select fields need a non-empty string "
                                "options list")
    if await db.fetch_one("SELECT id FROM custom_fields WHERE name=:n",
                          {"n": name}):
        return _json_error(409, "field name exists")
    fid = await db.execute(
        """
        INSERT INTO custom_fields (name, label, field_type, required,
                                   options, position, created_at)
        VALUES (:n, :l, :t, :r, :o, :p, :now)
        """,
        {"n": name, "l": str(body.get("label") or name), "t": ftype,
         "r": 1 if body.get("required") else 0,
         "o": json.dumps(options), "p": int(body.get("position") or 0),
         "now": db_now()})
    return web.json_response(
        {"field": await db.fetch_one(
            "SELECT * FROM custom_fields WHERE id=:i", {"i": fid})},
        status=201)


async def delete_custom_field(request: web.Request) -> web.Response:
    n = await request.app[DB].execute(
        "DELETE FROM custom_fields WHERE id=:i",
        {"i": _path_id(request, "field_id")})
    if not n:
        return _json_error(404, "no such field")
    return web.json_response({"ok": True})


def _validate_value(ftype: str, options: list, value) -> str | None:
    """Returns an error message, or None when the value is acceptable."""
    if value is None:
        return None
    if ftype == "number":
        try:
            float(value)
        except (TypeError, ValueError):
            return "not a number"
    elif ftype == "boolean":
        if not isinstance(value, bool) and str(value).lower() not in (
                "true", "false", "0", "1"):
            return "not a boolean"
    elif ftype == "select":
        if value not in options:
            return f"must be one of {options}"
    elif ftype == "date":
        if not re.match(r"^\d{4}-\d{2}-\d{2}$", str(value)):
            return "must be YYYY-MM-DD"
    elif ftype == "url":
        if not str(value).startswith(("http://", "https://")):
            return "must be an http(s) URL"
    return None


async def get_video_custom_values(request: web.Request) -> web.Response:
    db = request.app[DB]
    vid = _path_id(request, "video_id")
    rows = await db.fetch_all(
        """
        SELECT f.name, f.label, f.field_type, cv.value
        FROM custom_fields f
        LEFT JOIN video_custom_values cv
               ON cv.field_id = f.id AND cv.video_id = :v
        ORDER BY f.position, f.id
        """, {"v": vid})
    return web.json_response({"values": rows})


async def put_video_custom_values(request: web.Request) -> web.Response:
    """Upsert a {field_name: value} map for one video."""
    db = request.app[DB]
    vid = _path_id(request, "video_id")
    if await db.fetch_one("SELECT id FROM videos WHERE id=:v", {"v": vid}) \
            is None:
        return _json_error(404, "no such video")
    body = await request.json()
    if not isinstance(body, dict):
        return _json_error(400, "expected a {field: value} object")
    fields = {f["name"]: f for f in await db.fetch_all(
        "SELECT * FROM custom_fields")}
    errors = {}
    for name, value in body.items():
        f = fields.get(name)
        if f is None:
            errors[name] = "unknown field"
            continue
        err = _validate_value(f["field_type"],
                              json.loads(f["options"] or "[]"), value)
        if err:
            errors[name] = err
    if errors:
        return web.json_response({"errors": errors}, status=400)
    t = db_now()
    async with db.transaction() as tx:
        for name, value in body.items():
            f = fields[name]
            if value is None:
                await tx.execute(
                    "DELETE FROM video_custom_values "
                    "WHERE video_id=:v AND field_id=:f",
                    {"v": vid, "f": f["id"]})
                continue
            await tx.execute(
                """
                INSERT INTO video_custom_values (video_id, field_id,
                                                 value, updated_at)
                VALUES (:v, :f, :val, :t)
                ON CONFLICT (video_id, field_id)
                DO UPDATE SET value=:val, updated_at=:t
                """,
                {"v": vid, "f": f["id"], "val": json.dumps(value), "t": t})
    return web.json_response({"ok": True})


# --------------------------------------------------------------------------
# Thumbnail management (admin.py:2173-2498)
# --------------------------------------------------------------------------

class Thumbnailer:
    """The admin app's thumbnail grabs: the source decodes and the frame
    resizes (``TorchBackend._write_thumbnail``: the fused resize kernel
    on CUDA) on ``device``. The backend is built at the first grab, so an
    admin host without a card serves every other route; there a grab
    raises the CUDA error, which the route answers as a 422."""

    def __init__(self, device: str = "cuda"):
        self.device = device
        self._backend = None
        self._lock = threading.Lock()             # lock-order: 5

    def backend(self):
        from vlog_tpu_torch.backends.torch_backend import TorchBackend

        with self._lock:
            if self._backend is None:
                self._backend = TorchBackend(device=self.device)
            return self._backend

    def grab(self, src: Path, at_s: float, dst: Path) -> None:
        """Write ``dst`` from the source's frame at ``at_s`` seconds."""
        from vlog_tpu_torch.backends.source import open_source

        backend = self.backend()
        s = open_source(src, backend.device)
        try:
            fps = (s.fps_num / s.fps_den
                   if getattr(s, "fps_den", 0) else 30.0)
            idx = max(0, min(int(at_s * fps),
                             max((s.frame_count or 1) - 1, 0)))
            for y, u, v in s.read_batches(1, idx):
                backend._write_thumbnail(y[0], u[0], v[0], str(dst))
                return
            raise ValueError(f"no frame at {at_s}s")
        finally:
            s.close()


async def set_thumbnail_from_time(request: web.Request) -> web.Response:
    """Re-grab the thumbnail from a timestamp of the stored source."""
    db = request.app[DB]
    vid = _path_id(request, "video_id")
    row = await db.fetch_one("SELECT * FROM videos WHERE id=:v", {"v": vid})
    if row is None or not row["source_path"]:
        return _json_error(404, "no such video (or source dropped)")
    body = await request.json()
    try:
        at_s = float(body.get("time_s", 0.0))
    except (TypeError, ValueError):
        return _json_error(400, "bad time_s")
    src = Path(row["source_path"])
    if not src.exists():
        return _json_error(409, "source file no longer on disk")

    out_dir = request.app[VIDEO_DIR] / row["slug"]
    out_dir.mkdir(parents=True, exist_ok=True)
    dst = out_dir / "thumbnail.jpg"
    try:
        await asyncio.to_thread(request.app[THUMBNAILER].grab, src, at_s,
                                dst)
    except Exception as exc:  # noqa: BLE001 — surfaced as a 422
        return _json_error(422, f"thumbnail grab failed: {exc}")
    await db.execute(
        "UPDATE videos SET thumbnail_path=:p, updated_at=:t WHERE id=:v",
        {"p": str(dst), "t": db_now(), "v": vid})
    return web.json_response({"ok": True, "thumbnail": str(dst)})


async def get_thumbnail(request: web.Request) -> web.Response:
    """Serve the current thumbnail to the admin UI (the public plane
    serves it from the media tree; the admin plane is a different
    origin/port, so it needs its own authenticated route)."""
    db = request.app[DB]
    vid = _path_id(request, "video_id")
    row = await db.fetch_one("SELECT * FROM videos WHERE id=:v", {"v": vid})
    if row is None or not row["thumbnail_path"]:
        return _json_error(404, "no thumbnail")
    p = Path(row["thumbnail_path"])
    if not p.is_file():
        return _json_error(404, "thumbnail file missing")
    return web.FileResponse(p, headers={
        "Content-Type": "image/jpeg", "Cache-Control": "no-cache"})


async def upload_thumbnail(request: web.Request) -> web.Response:
    """Accept a custom JPEG thumbnail body (content-type image/jpeg)."""
    db = request.app[DB]
    vid = _path_id(request, "video_id")
    row = await db.fetch_one("SELECT * FROM videos WHERE id=:v", {"v": vid})
    if row is None:
        return _json_error(404, "no such video")
    cap = 5 * 1024 * 1024
    # reject before buffering: the app-wide client_max_size is sized for
    # video uploads, far beyond a thumbnail
    if request.content_length is not None and request.content_length > cap:
        return _json_error(413, "thumbnail too large (5 MB cap)")
    data = await request.content.read(cap + 1)
    if len(data) > cap:
        return _json_error(413, "thumbnail too large (5 MB cap)")
    if len(data) < 4 or data[:3] != b"\xff\xd8\xff":
        return _json_error(400, "body must be a JPEG image")
    from vlog_tpu_torch.utils.fsio import atomic_write_bytes

    out_dir = request.app[VIDEO_DIR] / row["slug"]
    out_dir.mkdir(parents=True, exist_ok=True)
    dst = out_dir / "thumbnail.jpg"
    atomic_write_bytes(dst, data)
    await db.execute(
        "UPDATE videos SET thumbnail_path=:p, updated_at=:t WHERE id=:v",
        {"p": str(dst), "t": db_now(), "v": vid})
    return web.json_response({"ok": True, "thumbnail": str(dst)})


# --------------------------------------------------------------------------
# Transcript CRUD (admin.py:3568-3750)
# --------------------------------------------------------------------------

async def get_transcript_admin(request: web.Request) -> web.Response:
    db = request.app[DB]
    vid = _path_id(request, "video_id")
    tr = await db.fetch_one(
        "SELECT * FROM transcriptions WHERE video_id=:v", {"v": vid})
    if tr is None:
        return _json_error(404, "no transcript")
    vtt = None
    if tr["vtt_path"] and Path(tr["vtt_path"]).exists():
        vtt = await asyncio.to_thread(Path(tr["vtt_path"]).read_text)
    return web.json_response({"transcript": tr, "vtt": vtt})


async def put_transcript(request: web.Request) -> web.Response:
    """Replace the transcript text/VTT (manual correction flow)."""
    db = request.app[DB]
    vid = _path_id(request, "video_id")
    row = await db.fetch_one("SELECT * FROM videos WHERE id=:v", {"v": vid})
    if row is None:
        return _json_error(404, "no such video")
    body = await request.json()
    text = body.get("text")
    vtt = body.get("vtt")
    if not isinstance(text, str) or not text.strip():
        return _json_error(400, "text required")
    if vtt is not None and not str(vtt).startswith("WEBVTT"):
        return _json_error(400, "vtt must start with WEBVTT")
    vtt_path = None
    if vtt is not None:
        from vlog_tpu_torch.utils.fsio import atomic_write_text

        out_dir = request.app[VIDEO_DIR] / row["slug"]
        out_dir.mkdir(parents=True, exist_ok=True)
        vtt_path = out_dir / "captions.vtt"
        atomic_write_text(vtt_path, str(vtt))
    t = db_now()
    await db.execute(
        """
        INSERT INTO transcriptions (video_id, language, model, vtt_path,
                                    full_text, status, created_at,
                                    completed_at)
        VALUES (:v, :lang, 'manual', :p, :txt, 'completed', :t, :t)
        ON CONFLICT (video_id) DO UPDATE SET
            full_text=:txt, status='completed', model='manual',
            vtt_path=COALESCE(:p, vtt_path), completed_at=:t, error=NULL
        """,
        {"v": vid, "lang": body.get("language"),
         "p": str(vtt_path) if vtt_path else None, "txt": text, "t": t})
    await db.execute(
        "UPDATE videos SET transcription_status='completed', updated_at=:t "
        "WHERE id=:v", {"t": t, "v": vid})
    return web.json_response({"ok": True})


async def delete_transcript(request: web.Request) -> web.Response:
    db = request.app[DB]
    vid = _path_id(request, "video_id")
    n = await db.execute("DELETE FROM transcriptions WHERE video_id=:v",
                         {"v": vid})
    if not n:
        return _json_error(404, "no transcript")
    await db.execute(
        "UPDATE videos SET transcription_status='pending', updated_at=:t "
        "WHERE id=:v", {"t": db_now(), "v": vid})
    return web.json_response({"ok": True})


# --------------------------------------------------------------------------
# Bulk operations (admin.py:2883+)
# --------------------------------------------------------------------------

async def bulk_videos(request: web.Request) -> web.Response:
    """POST {action, video_ids, ...}: delete | restore | set_category."""
    db = request.app[DB]
    body = await request.json()
    ids = body.get("video_ids")
    action = body.get("action")
    if (not isinstance(ids, list) or not ids
            or not all(isinstance(i, int) for i in ids) or len(ids) > 500):
        return _json_error(400, "video_ids (1..500 ints) required")
    if action not in ("delete", "restore", "set_category", "retranscode"):
        return _json_error(400, "action must be delete | restore | "
                                "set_category | retranscode")
    t = db_now()
    done, missing = [], []
    for vid in ids:
        row = await db.fetch_one("SELECT id FROM videos WHERE id=:v",
                                 {"v": vid})
        if row is None:
            missing.append(vid)
            continue
        if action == "delete":
            await db.execute(
                "UPDATE videos SET deleted_at=:t, updated_at=:t "
                "WHERE id=:v AND deleted_at IS NULL", {"t": t, "v": vid})
        elif action == "restore":
            await db.execute(
                "UPDATE videos SET deleted_at=NULL, updated_at=:t "
                "WHERE id=:v", {"t": t, "v": vid})
        elif action == "set_category":
            await db.execute(
                "UPDATE videos SET category=:c, updated_at=:t WHERE id=:v",
                {"c": body.get("category"), "t": t, "v": vid})
        elif action == "retranscode":
            tenant = qos.normalize_tenant(body.get("tenant"))
            try:
                await claims.enqueue_job(db, vid, JobKind.TRANSCODE,
                                         force=bool(body.get("force")),
                                         tenant=tenant)
            except js.JobStateError:
                missing.append(vid)   # already queued/claimed: report it
                continue
            except qos.AdmissionError:
                # admission-capped, not lost: reported so the caller
                # retries these ids after the tenant's backlog drains
                missing.append(vid)
                continue
            await vids.set_status(db, vid, VideoStatus.PENDING)
        done.append(vid)
    return web.json_response({"ok": True, "done": done, "missing": missing})


async def get_sprites(request: web.Request) -> web.Response:
    """Sprite index for the admin preview strip: parse the WebVTT the
    sprite worker wrote (worker/sprites.py; reference sprite admin
    routes) into cue dicts the UI can lay out without a VTT parser."""
    db = request.app[DB]
    vid = _path_id(request, "video_id")
    row = await db.fetch_one("SELECT * FROM videos WHERE id=:v", {"v": vid})
    if row is None:
        return _json_error(404, "no such video")
    vtt = (request.app[VIDEO_DIR] / row["slug"] / "sprites"
           / "sprites.vtt")
    if not vtt.is_file():
        return _json_error(404, "no sprites generated")
    cues = []
    block: list[str] = []
    text = await asyncio.to_thread(vtt.read_text)
    for line in text.splitlines() + [""]:
        if line.strip():
            block.append(line.strip())
            continue
        if len(block) >= 2 and "-->" in block[0]:
            times, target = block[0], block[1]
            a, b = [t.strip() for t in times.split("-->")]

            def secs(t):
                parts = t.split(":")
                s = float(parts[-1])
                if len(parts) > 1:
                    s += 60 * int(parts[-2])
                if len(parts) > 2:
                    s += 3600 * int(parts[-3])
                return s

            sheet, _, frag = target.partition("#xywh=")
            x, y, w, h = (int(v) for v in frag.split(",")) \
                if frag else (0, 0, 0, 0)
            cues.append({"start_s": secs(a), "end_s": secs(b),
                         "sheet": sheet, "x": x, "y": y, "w": w, "h": h})
        block = []
    return web.json_response({"cues": cues})


async def get_sprite_sheet(request: web.Request) -> web.Response:
    """Serve one sprite sheet JPEG to the admin UI (different origin
    from the public media tree, same reason as get_thumbnail)."""
    db = request.app[DB]
    vid = _path_id(request, "video_id")
    row = await db.fetch_one("SELECT * FROM videos WHERE id=:v", {"v": vid})
    if row is None:
        return _json_error(404, "no such video")
    name = request.match_info["name"]
    sdir = (request.app[VIDEO_DIR] / row["slug"] / "sprites").resolve()
    p = (sdir / name).resolve()
    # Path-boundary containment: a plain startswith() admits sibling
    # directories sharing the prefix (".../sprites-evil/x.jpg"); sheets
    # live directly in sdir, so the parent must BE sdir.
    if p.parent != sdir or p.suffix != ".jpg" or not p.is_file():
        return _json_error(404, "no such sheet")
    return web.FileResponse(p, headers={
        "Content-Type": "image/jpeg", "Cache-Control": "no-cache"})


def mount(r: web.UrlDispatcher) -> None:
    """Attach every catalog route (called by build_admin_app)."""
    r.add_get("/api/playlists", list_playlists)
    r.add_post("/api/playlists", create_playlist)
    r.add_get("/api/playlists/{playlist_id:\\d+}", playlist_detail)
    r.add_patch("/api/playlists/{playlist_id:\\d+}", update_playlist)
    r.add_delete("/api/playlists/{playlist_id:\\d+}", delete_playlist)
    r.add_post("/api/playlists/{playlist_id:\\d+}/videos",
               playlist_add_video)
    r.add_delete("/api/playlists/{playlist_id:\\d+}/videos/{video_id:\\d+}",
                 playlist_remove_video)
    r.add_put("/api/playlists/{playlist_id:\\d+}/order", playlist_reorder)
    r.add_get("/api/custom-fields", list_custom_fields)
    r.add_post("/api/custom-fields", create_custom_field)
    r.add_delete("/api/custom-fields/{field_id:\\d+}", delete_custom_field)
    r.add_get("/api/videos/{video_id:\\d+}/custom-fields",
              get_video_custom_values)
    r.add_put("/api/videos/{video_id:\\d+}/custom-fields",
              put_video_custom_values)
    r.add_post("/api/videos/{video_id:\\d+}/thumbnail/from-time",
               set_thumbnail_from_time)
    r.add_get("/api/videos/{video_id:\\d+}/thumbnail", get_thumbnail)
    r.add_put("/api/videos/{video_id:\\d+}/thumbnail", upload_thumbnail)
    r.add_get("/api/videos/{video_id:\\d+}/transcript",
              get_transcript_admin)
    r.add_put("/api/videos/{video_id:\\d+}/transcript", put_transcript)
    r.add_delete("/api/videos/{video_id:\\d+}/transcript",
                 delete_transcript)
    r.add_post("/api/videos/bulk", bulk_videos)
    r.add_get("/api/videos/{video_id:\\d+}/sprites", get_sprites)
    r.add_get("/api/videos/{video_id:\\d+}/sprites/{name}",
              get_sprite_sheet)
